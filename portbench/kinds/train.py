"""Driver of the training cells: ``keraslm-rate train``.

A configured ``Rater`` of the port is trained by the port's own
``training.train_rater`` (``Rater.train``), as ``keraslm-rate train -w
WIDTH -d DEPTH -l LENGTH -b BATCH`` trains it: its epoch loop with the
data generator behind the ``Prefetcher``, the carry reset at a file's
start, its train steps, the validation pass, the best-only checkpoint
and the NaN checks.  The configuration gives the model's sizes, the
batch, the window length and the degradations; the traffic file gives
the corpus (one training and one validation file of German-like lines)
and the check's limits.  The weights are drawn on the card from the
seed (``reference/lm.py`` ``init_weights``) and handed to the rater;
numpy's and Python's global generators, from which the trainer draws
its dropout and data seeds, are seeded from the seed too.

Set-up writes the corpus, configures the rater and runs the shapes of
the epoch end once (a validation step and a checkpoint write); then
``train_rater`` starts, and its first four steps (the three the check
follows and one more) still count as set-up.  A wrapper around
``training.train_step`` records what the check needs (the dropout
generator's state before the first step, Adam's first moment after it,
the weights after the third) and opens the window after the fourth.
Once ``--seconds`` have passed, it stops the trainer as a user does,
with SIGINT: the trainer finishes its step, runs the validation pass,
writes the checkpoint if the loss improved and returns, which closes
the window.  ``train_chars_per_s`` is the unmasked training characters
stepped in the window over its wall time, validation and checkpoints
included.

The check follows the first three steps with the reference
(``reference/train.py``), from the same weights, the same corpus and
the same seeds: each leaf's first gradient as Adam took it (its first
moment after one step, over 1 - beta1) and each leaf's change after
the three steps.
"""
from __future__ import annotations

import copy
import gc
import logging
import os
import random
import signal
import time
import unicodedata

import numpy as np

from portbench import inputs, roofline
from portbench.reference import lm as rlm
from portbench.reference import train as rtrain

# train steps of set-up: the three the check follows and one more
SETUP_STEPS = 4


class Job:
    attempted = 0
    failed = 0
    trace = None
    setup_end = None


def _seeds(seed):
    """Weights and global-generator seeds of a run."""
    ss = np.random.SeedSequence(int(seed)).generate_state(2)
    return int(ss[0]), int(ss[1])


def _charset(files):
    """The corpus's chars, as the reference maps them."""
    chars = set()
    for path in files:
        with open(path, encoding='utf-8') as fh:
            chars |= set(unicodedata.normalize('NFC', fh.read()))
    return sorted(chars)


def setup(cell, seed, work, device):
    import torch
    from ocrd_keraslm_torch import data, training
    from ocrd_keraslm_torch.rater import Rater
    from ocrd_keraslm_torch.utils import h5io
    from ocrd_keraslm_torch.models.lstm_lm import zero_carry
    logging.getLogger('ocrd_keraslm_torch').setLevel(logging.WARNING)
    cfg, traffic = cell.config, cell.traffic
    job = Job()
    job.cell, job.device = cell, device
    job.w_seed, g_seed = _seeds(seed)
    rng = np.random.default_rng(seed)
    corpus = traffic['corpus']
    job.files = inputs.write_corpus(os.path.join(work, 'corpus'), rng, {
        corpus['train']: corpus['train_chars'],
        corpus['validation']: corpus['validation_chars']})
    rater = Rater(device=device)
    rater.width, rater.depth = cfg['width'], cfg['depth']
    rater.length, rater.batch_size = cfg['length'], cfg['batch']
    rater.stateful, rater.train_streams = True, True
    rater.contexts = tuple(tuple(c) for c in cfg['contexts'])
    rater.char_degradation = cfg['char_degradation']
    rater.context_degradation = cfg['context_degradation']
    rater.ckpt_dir = os.path.join(work, 'ckpt')
    rater.vocab.assign(_charset(job.files))
    rater.voc_size = rater.vocab.size
    job.init = rlm.init_weights(job.w_seed, rater.voc_size, cfg['width'],
                                cfg['depth'], rater.contexts, device)
    rater.params = job.init
    rater.configure()
    if rater.cfg.dropout != cfg['dropout']:
        raise ValueError('the port trains with dropout %g, the '
                         'configuration states %g'
                         % (rater.cfg.dropout, cfg['dropout']))
    job.rater = rater
    # the shapes of the epoch end: a validation step and a checkpoint
    val = next(data.gen_stateful_streams(
        job.files[1:], rater.vocab, length=cfg['length'],
        batch_size=cfg['batch'], n_contexts=len(cfg['contexts']),
        train=False))
    x, zs, y, mask, x_mask = training.batch_tensors(val, device)
    training.eval_step(job.init, rater.cfg, x, zs, y, mask,
                       zero_carry(rater.cfg, cfg['batch'], device), x_mask)
    h5io.save_weights(os.path.join(work, 'warmup.h5'), job.init, rater.cfg)
    # the trainer draws its dropout and data seeds from these
    np.random.seed(g_seed)
    random.seed(g_seed)
    job.chars = torch.zeros((), dtype=torch.float64, device=device)
    job.train_steps = job.eval_steps = job.steps = 0
    job.losses = []
    if device == 'cuda':
        torch.cuda.synchronize()
    return job


class _Trainer:
    """``training.train_step``, ``eval_step`` and ``gen_stateful_streams``
    wrapped for one run of ``train_rater``: they record what the check
    needs, open the window after the set-up's steps, count the window's
    work, and stop the trainer by SIGINT once its time is up."""

    def __init__(self, job, seconds, tracer):
        from ocrd_keraslm_torch import training
        self.training, self.job = training, job
        self.seconds, self.tracer, self.range = seconds, tracer, None
        self.deadline = None
        self.stopped = False
        self.saved = {n: getattr(training, n) for n in (
            'train_step', 'eval_step', 'gen_stateful_streams')}
        training.train_step = self.train_step
        training.eval_step = self.eval_step
        training.gen_stateful_streams = self.gen_stateful_streams

    def remove(self):
        for name, fn in self.saved.items():
            setattr(self.training, name, fn)

    def gen_stateful_streams(self, *a, **kw):
        job = self.job
        if kw.get('train') and not hasattr(job, 'data_state'):
            job.data_state = copy.deepcopy(kw['rng'].bit_generator.state)
        return self.saved['gen_stateful_streams'](*a, **kw)

    def eval_step(self, *a, **kw):
        if self.deadline is not None:
            self.job.eval_steps += 1
        return self.saved['eval_step'](*a, **kw)

    def train_step(self, params, optimizer, cfg, x, zs, y, mask, carry,
                   rng, x_mask=None):
        import torch
        job, training = self.job, self.training
        if job.steps == 0:
            job.dropout_state = rng.get_state().clone()
        out = self.saved['train_step'](params, optimizer, cfg, x, zs, y,
                                       mask, carry, rng, x_mask)
        job.steps += 1
        if job.steps <= 3:
            job.losses.append(float(out[1]))
        if job.steps == 1:
            job.moment1 = [optimizer.state[p]['exp_avg'].detach().clone()
                           for p in training.param_leaves(params)]
        if job.steps == 3:
            job.after3 = [p.detach().clone()
                          for p in training.param_leaves(params)]
        if job.steps == SETUP_STEPS:
            if job.device == 'cuda':
                torch.cuda.synchronize()
            job.setup_end = time.perf_counter()
            if self.tracer is not None:
                self.range = self.tracer.window()
                self.range.__enter__()
            job.t0 = time.perf_counter()
            self.deadline = job.t0 + self.seconds
        elif self.deadline is not None:
            job.chars += mask.sum()
            job.train_steps += 1
            if not self.stopped and time.perf_counter() >= self.deadline:
                # the trainer's own stop: finish the step, validate, save
                self.stopped = True
                os.kill(os.getpid(), signal.SIGINT)
        return out


def window(job, seconds, tracer):
    import torch
    trainer = _Trainer(job, seconds, tracer)
    try:
        job.rater.train(job.files[:1], job.files[1:])
        if job.device == 'cuda':
            torch.cuda.synchronize()
        job.window_s = time.perf_counter() - job.t0
    finally:
        trainer.remove()
        if trainer.range is not None:
            trainer.range.__exit__(None, None, None)
    job.train_chars = float(job.chars)
    if not trainer.stopped:
        # the trainer ended by itself (early stopping) before the time
        logging.getLogger('portbench').warning(
            'the trainer ended %.1f s into a window of %g s',
            job.window_s, seconds)
    cfg = job.cell.config
    B, T, W, D = cfg['batch'], cfg['length'], cfg['width'], cfg['depth']
    V = job.rater.voc_size
    in0 = W + sum(d for _, d in cfg['contexts'])
    row = roofline.lstm_row_flops(D, W, in0, V)
    job.attempted = job.train_steps
    job.failed = 0 if job.rater.status == 2 else job.train_steps
    job.model_flops = B * T * row * (3 * job.train_steps + job.eval_steps)
    scan_t = roofline.lstm_scan(B, T, W, True)
    scan_e = roofline.lstm_scan(B, T, W, False)
    bwd = roofline.lstm_bwd(B, T, W)
    job.bound_s = {
        'lstm_scan': D * (job.train_steps * roofline.least_seconds(*scan_t)
                          + job.eval_steps * roofline.least_seconds(*scan_e)),
        'lstm_bwd': D * job.train_steps * roofline.least_seconds(*bwd)}


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def release(job):
    import torch
    job.rater = None
    gc.collect()
    if job.device == 'cuda':
        torch.cuda.empty_cache()


def end_to_end(job):
    return {'train_chars_per_s': job.train_chars / job.window_s}


def _batches(job):
    """The reference's first three training batches, built again from
    the corpus files."""
    cfg = job.cell.config
    table = {c: i for i, c in enumerate(_charset(job.files), 1)}
    with open(job.files[0], encoding='utf-8') as fh:
        text = unicodedata.normalize('NFC', fh.read())
    ids = np.array([table[c] for c in text], np.int64)
    # the first epoch's data generator, in the state the trainer drew
    state = job.data_state
    bits = getattr(np.random, state['bit_generator'])()
    bits.state = state
    batches = []
    for b in rtrain.stream_batches(
            ids, cfg['batch'], cfg['length'], np.random.Generator(bits),
            cfg['char_degradation'], cfg['context_degradation'],
            rtrain.context_of(job.files[0])):
        batches.append(b)
        if len(batches) == 3:
            return batches
    return batches


def _reference_steps(job, dtype='float32'):
    if job.device == 'cuda':
        rlm.strict_float32()
    lm = rlm.LM(job.init, job.device, dtype)
    return rtrain.train_steps(lm, job.init, _batches(job),
                              job.cell.config['dropout'], job.dropout_state)


def _judge(job, losses, grads, after, ref):
    """The numbers compared: by the worst leaf the gap of the first
    gradient's norm and of the change's norm after three steps (leaves
    whose reference gradient is under a thousandth of the median leaf's
    left out of the change).  The steps' losses are read
    (``job.loss_gap``) and not compared: from the seeded weights every
    first loss is the uniform one to a few ulps, and neither the control
    nor a planted fault moves them far enough to hold a limit."""
    import torch
    names = [n for n, _ in rlm.leaves(job.init)]
    init = dict(rlm.leaves(job.init))
    moved = {n: after[n] - init[n] for n in names}
    moved_ref = {n: ref['weights'][n] - init[n] for n in names}
    gnorm = {n: float(torch.linalg.vector_norm(g.double()))
             for n, g in ref['grads'].items()}
    med = float(np.median(list(gnorm.values())))
    still = [n for n in names if gnorm[n] < 1e-3 * med]
    job.left_out = still
    job.loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref['losses']))
    lim = job.cell.traffic['check']['limits']
    return [
        {'name': 'grad_gap', 'value': max(
            rtrain.leaf_gaps(grads, ref['grads']).values()),
         'limit': lim['grad_gap']},
        {'name': 'update_gap', 'value': max(
            rtrain.leaf_gaps(moved, moved_ref, skip=still).values()),
         'limit': lim['update_gap']}]


def check(job, seed):
    import torch
    ref = _reference_steps(job)
    names = [n for n, _ in rlm.leaves(job.init)]
    # Adam's first moment after one step is (1 - beta1) times the
    # gradient it took
    grads = {n: m / 0.1 for n, m in zip(names, job.moment1)}
    numbers = _judge(job, job.losses, grads, dict(zip(names, job.after3)),
                     ref)
    if job.device == 'cuda':
        torch.cuda.empty_cache()
    return numbers


def control(job, seed):
    """The check's numbers for the reference's steps put in the program's
    place in bfloat16."""
    low = _reference_steps(job, 'bfloat16')
    return _judge(job, low['losses'], low['grads'], low['weights'],
                  _reference_steps(job))
