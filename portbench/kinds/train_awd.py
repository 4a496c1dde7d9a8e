"""Driver of the AWD-LSTM training cells: ``keraslm-rate train`` of a model
of several widths, a tied softmax with a bias, weight drop and locked
dropout (``keraslm-rate train --widths ... --head-bias --weight-drop ...
--dropout-input ... --dropout-hidden ... --dropout-output ...
--no-contexts``).

The protocol of the ``train`` kind (``kinds/train.py``): the port's own
``Rater.train`` over a seeded corpus (one training and one validation
file), the shapes of the epoch end warmed up in set-up (a validation step
and a checkpoint write), four training steps of set-up (the three the
check follows and one more), then the window, stopped by SIGINT at its
end (the trainer finishes its step, validates and writes its best
checkpoint inside the window).  The configuration gives the layer widths
(the last one the char embedding's, for the tied softmax), the head
bias, the weight drop and the three dropout rates; the weights are drawn on the card from the seed with
AWD's initialisation (``reference/awd_lstm.py`` ``init_weights``).

The check follows the first three steps with the plain reference
(``reference/awd_lstm.py``) from the same weights, the same batches and
the same masks: the weight drop's and the locked dropouts', replayed
from the state the trainer's dropout generator had before its first
step in the order the trainer draws them (``trainer_masks``).  The
numbers compared are the train kind's: by the worst leaf, the gap of
the first gradient's norm (Adam's first moment after one step over 1 -
beta1) and of the change's norm after three steps.

Per-layer readings beside the train kind's: the wide layout's launches
of a training step (the port's counters ``lstm_scan.wide`` and
``lstm_bwd.wide``, read around each training step of the window) and the
device-time bounds of the layers the wide layout runs (widths over 512)
and of the others (``lstm_scan``, ``lstm_bwd``).
"""
from __future__ import annotations

import logging
import os
import random
import time

import numpy as np

from portbench import faults, inputs, roofline
from portbench.kinds import train as base
from portbench.reference import awd_lstm as awd
from portbench.reference import train as rtrain

# the train kind's faults of faults.py reach this path too
faults.FAULTS.setdefault('train_awd', faults.FAULTS['train'])

# the wide layout of the port's LSTM kernels takes widths over this
WIDE_ABOVE = 512


def _rates(cfg):
    return (cfg['weight_drop'], cfg['dropout_input'], cfg['dropout_hidden'],
            cfg['dropout_output'])


def setup(cell, seed, work, device):
    from ocrd_keraslm_torch import data, training
    from ocrd_keraslm_torch.models.lstm_lm import zero_carry
    from ocrd_keraslm_torch.rater import Rater
    from ocrd_keraslm_torch.utils import h5io
    logging.getLogger('ocrd_keraslm_torch').setLevel(logging.WARNING)
    cfg, traffic = cell.config, cell.traffic
    job = base.Job()
    job.cell, job.device = cell, device
    job.w_seed, g_seed = base._seeds(seed)
    rng = np.random.default_rng(seed)
    corpus = traffic['corpus']
    job.files = inputs.write_corpus(os.path.join(work, 'corpus'), rng, {
        corpus['train']: corpus['train_chars'],
        corpus['validation']: corpus['validation_chars']})
    widths = tuple(cfg['widths'])
    rater = Rater(device=device)
    # the tied softmax: the char embedding has the last layer's width
    rater.width, rater.depth = widths[-1], len(widths)
    rater.widths, rater.head_bias = widths, cfg['head_bias']
    (rater.weight_drop, rater.dropout_input, rater.dropout_hidden,
     rater.dropout_output) = _rates(cfg)
    rater.length, rater.batch_size = cfg['length'], cfg['batch']
    rater.stateful, rater.train_streams = True, True
    rater.contexts = tuple(tuple(c) for c in cfg['contexts'])
    rater.char_degradation = cfg['char_degradation']
    rater.context_degradation = cfg['context_degradation']
    rater.ckpt_dir = os.path.join(work, 'ckpt')
    rater.vocab.assign(base._charset(job.files))
    rater.voc_size = rater.vocab.size
    job.init = awd.init_weights(job.w_seed, rater.voc_size, widths, device)
    rater.params = {'char_embedding': job.init['char_embedding'],
                    'context_embeddings': [], 'lstm': job.init['lstm'],
                    'head_bias': job.init['head_bias']}
    rater.configure()
    got = rater.cfg
    if (got.layer_widths, got.width, got.head_bias, got.weight_drop,
            got.dropout_input, got.dropout_hidden, got.dropout_output) != (
                widths, widths[-1], cfg['head_bias'],
                *_rates(cfg)):
        raise ValueError('the port configures %s, the configuration states '
                         'widths %s, embedding %d, head bias %s, rates %s'
                         % (got, widths, widths[-1],
                            cfg['head_bias'], _rates(cfg)))
    job.rater = rater
    # the shapes of the epoch end: a validation step and a checkpoint
    val = next(data.gen_stateful_streams(
        job.files[1:], rater.vocab, length=cfg['length'],
        batch_size=cfg['batch'], n_contexts=len(cfg['contexts']),
        train=False))
    x, zs, y, mask, x_mask = training.batch_tensors(val, device)
    training.eval_step(rater.params, got, x, zs, y, mask,
                       zero_carry(got, cfg['batch'], device), x_mask)
    h5io.save_weights(os.path.join(work, 'warmup.h5'), rater.params, got)
    # the trainer draws its dropout and data seeds from these
    np.random.seed(g_seed)
    random.seed(g_seed)
    import torch
    job.chars = torch.zeros((), dtype=torch.float64, device=device)
    job.train_steps = job.eval_steps = job.steps = 0
    job.losses = []
    job.wide_launches = 0
    if device == 'cuda':
        torch.cuda.synchronize()
    return job


class _Trainer(base._Trainer):
    """The train kind's wrappers, and the wide layout's launches of each
    training step of the window."""

    def train_step(self, *a, **kw):
        from ocrd_keraslm_torch.ops import lstm_cell
        in_window = self.deadline is not None

        def wide():
            return lstm_cell.lstm_scan.wide + lstm_cell.lstm_bwd.wide
        before = wide()
        out = super().train_step(*a, **kw)
        if in_window:
            self.job.wide_launches += wide() - before
        return out


def window(job, seconds, tracer):
    import torch
    # the weight drop's reader links kernels to its spans in the
    # profiler's own events
    job.tracer = tracer
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
        logging.getLogger('portbench').warning(
            'the trainer ended %.1f s into a window of %g s',
            job.window_s, seconds)
    cfg = job.cell.config
    B, T = cfg['batch'], cfg['length']
    widths = list(cfg['widths'])
    E = widths[-1]
    V = job.rater.voc_size
    # a char's forward FLOPs: every layer's input and recurrent products
    # and the tied logits
    ins = [E] + widths[:-1]
    row = 2 * (sum(i * 4 * w + w * 4 * w for i, w in zip(ins, widths))
               + E * V)
    job.attempted = job.train_steps
    job.failed = 0 if job.rater.status == 2 else job.train_steps
    job.model_flops = B * T * row * (3 * job.train_steps + job.eval_steps)

    def bounds(ws):
        scan = sum(job.train_steps * roofline.least_seconds(
            *roofline.lstm_scan(B, T, w, True)) + job.eval_steps *
            roofline.least_seconds(*roofline.lstm_scan(B, T, w, False))
            for w in ws)
        bwd = sum(job.train_steps * roofline.least_seconds(
            *roofline.lstm_bwd(B, T, w)) for w in ws)
        return scan, bwd
    wide = [w for w in widths if w > WIDE_ABOVE]
    rest = [w for w in widths if w <= WIDE_ABOVE]
    job.bound_s = {}
    job.bound_s['lstm_scan_wide'], job.bound_s['lstm_bwd_wide'] = \
        bounds(wide)
    job.bound_s['lstm_scan'], job.bound_s['lstm_bwd'] = bounds(rest)


release = base.release


def end_to_end(job):
    return {'train_chars_per_s': job.train_chars / job.window_s}


def _batches(job):
    """The reference's first three training batches (x, y, mask, reset),
    built again from the corpus files."""
    cfg = job.cell.config
    table = {c: i for i, c in enumerate(base._charset(job.files), 1)}
    import unicodedata
    with open(job.files[0], encoding='utf-8') as fh:
        text = unicodedata.normalize('NFC', fh.read())
    ids = np.array([table[c] for c in text], np.int64)
    state = job.data_state
    bits = getattr(np.random, state['bit_generator'])()
    bits.state = state
    out = []
    for x, _, y, mask, reset in rtrain.stream_batches(
            ids, cfg['batch'], cfg['length'], np.random.Generator(bits),
            cfg['char_degradation'], cfg['context_degradation'], 0):
        out.append((x, y, mask, reset))
        if len(out) == 3:
            break
    return out


def _reference_steps(job, bf16=False):
    cfg = job.cell.config
    if job.device == 'cuda':
        awd.strict_float32()
    masks = awd.trainer_masks(
        job.dropout_state, 3, cfg['batch'], cfg['widths'][-1],
        cfg['widths'], *_rates(cfg), job.device)
    return awd.train_steps(job.init, _batches(job), masks, job.device,
                           bf16=bf16)


def _judge(job, losses, grads, after, ref):
    """The train kind's numbers (``kinds/train.py`` ``_judge``) over this
    model's leaves."""
    import torch
    names = [n for n, _ in awd.leaves(job.init)]
    init = dict(awd.leaves(job.init))
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
    names = [n for n, _ in awd.leaves(job.init)]
    grads = {n: m / 0.1 for n, m in zip(names, job.moment1)}
    numbers = _judge(job, job.losses, grads, dict(zip(names, job.after3)),
                     ref)
    if job.device == 'cuda':
        torch.cuda.empty_cache()
    return numbers


def control(job, seed):
    """The check's numbers for the reference's steps put in the program's
    place in bfloat16."""
    low = _reference_steps(job, bf16=True)
    return _judge(job, low['losses'], low['grads'], low['weights'],
                  _reference_steps(job))
