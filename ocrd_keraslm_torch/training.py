"""Training loop: the update step and the host-side control.

Counterpart of ``ocrd_keraslm_tpu/training.py``: up to 100 epochs with
early stopping (patience 3, restore best weights), best-only weight
checkpointing (``ckpt.{epoch:02d}-{val_loss:.2f}.h5``), NaN termination
with best-weight recovery, graceful SIGINT stop (second SIGINT exits),
huge-loss warnings, and stateful carry resets at file boundaries and
before validation.

One device: the step runs eagerly on the rater's device; each layer's
recurrence and its gradient go through the two LSTM kernels
(``ops/lstm_cell.py``) on CUDA.  The optimizer is Adam behind an
elementwise gradient clip at 1.0 (Keras ``Adam(clipvalue=1.0)``); the
train-phase-only embedding regularizers are added inside the loss, so
the evaluation loss stays pure cross-entropy.

With ``rater.resume_dir`` (or ``KERASLM_RESUME_DIR``) set, every epoch
boundary snapshots the whole training state (``utils/orbaxio.py``
``TrainCheckpointer``: params, best params, Adam's state, the dropout
generator, history, early-stopping counters, data seed and split), and
a killed run resumes from the last completed epoch with the trajectory
of an uninterrupted run.

Not ported yet, raising ``NotImplementedError``: training over a device
mesh (``rater.mesh``; ROADMAP.md Queue 1 #16, "Distributed").
"""
from __future__ import annotations

import logging
import os
import signal
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data import (Batch, Prefetcher, SplitPlan, gen_stateful_parity,
                   gen_stateful_streams, gen_stateless, split_data)
from .models.lstm_lm import (Carry, LMConfig, Params, forward_seq,
                             host_to_device, param_leaves,
                             regularization_loss, sequence_xent, zero_carry)
from .utils import h5io, orbaxio
from .utils.vocab import Vocab

LOG = logging.getLogger(__name__)

EPOCHS = 100
PATIENCE = 3
# early stopping is not armed before this many optimizer steps: the
# parallel-streams layout compresses an epoch to tens of steps, and
# epoch-based patience alone would stop during the initial plateau of
# the low-init embeddings (~100-300 steps)
MIN_STEPS_BEFORE_STOP = 500


def make_optimizer(params: Params, learning_rate: float = 1e-3
                   ) -> torch.optim.Optimizer:
    """Adam over the tree's tensors (Keras 2.3 epsilon default 1e-7);
    :func:`train_step` clips the gradient elementwise at 1.0 before each
    update (Keras ``Adam(clipvalue=1.0)``)."""
    return torch.optim.Adam(param_leaves(params), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-7)


def load_optimizer_state(optimizer: torch.optim.Optimizer, count: int,
                         mu: Sequence[np.ndarray],
                         nu: Sequence[np.ndarray]) -> None:
    """Set Adam's step count and first and second moments from numpy
    arrays in :func:`param_leaves` order (optax's ``ScaleByAdamState``
    holds the same three), so that a trajectory can start in the
    middle."""
    leaves = optimizer.param_groups[0]['params']
    for p, m, v in zip(leaves, mu, nu):
        optimizer.state[p] = {
            'step': torch.tensor(float(count)),
            'exp_avg': torch.tensor(np.asarray(m, np.float32),
                                    device=p.device),
            'exp_avg_sq': torch.tensor(np.asarray(v, np.float32),
                                       device=p.device)}


def batch_tensors(batch: Batch, device) -> tuple:
    """A :class:`Batch` on ``device``: (x, zs, y, mask, x_mask)."""
    def t(a, dtype=None):
        return host_to_device(torch.as_tensor(a, dtype=dtype), device)
    return (t(batch.x, torch.long), [t(z, torch.long) for z in batch.zs],
            t(batch.y, torch.long), t(batch.mask),
            None if batch.x_mask is None else t(batch.x_mask))


def _loss_fn(params: Params, cfg: LMConfig, x, zs, y, mask, carry, rng,
             train: bool, x_mask=None):
    logits, carry = forward_seq(params, cfg, x, list(zs), carry,
                                train=train, rng=rng, x_mask=x_mask)
    if y.dim() == 1:  # stateless windowed: predict only the next char
        logits = logits[:, -1, :]
    nll, acc = sequence_xent(logits, y, mask)
    loss = nll
    if train:
        loss = loss + regularization_loss(params)
    return loss, (nll, acc, carry)


def train_step(params: Params, optimizer: torch.optim.Optimizer,
               cfg: LMConfig, x, zs, y, mask, carry: Carry,
               rng: Optional[torch.Generator], x_mask=None
               ) -> Tuple[Carry, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update of ``params`` (leaf tensors that require grad) in
    place.  ``rng`` is the dropout generator (on the CPU).  Returns
    (carry, loss, nll, acc), all detached: the carry is an output, not
    differentiated through from the next step."""
    optimizer.zero_grad(set_to_none=True)
    loss, (nll, acc, carry) = _loss_fn(params, cfg, x, zs, y, mask, carry,
                                       rng, True, x_mask)
    loss.backward()
    torch.nn.utils.clip_grad_value_(param_leaves(params), 1.0)
    optimizer.step()
    return ((carry[0].detach(), carry[1].detach()), loss.detach(),
            nll.detach(), acc.detach())


def eval_step(params: Params, cfg: LMConfig, x, zs, y, mask, carry: Carry,
              x_mask=None) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
    with torch.no_grad():
        _, (nll, acc, carry) = _loss_fn(params, cfg, x, zs, y, mask, carry,
                                        None, False, x_mask)
    return nll, acc, carry


class StopSignal:
    """Graceful SIGINT stop: first signal finishes the batch and stops
    training; a second one exits immediately."""

    def __init__(self, sig=signal.SIGINT, logger=None):
        self.received = False
        self.sig = sig
        self.logger = logger or LOG
        try:
            self.prev = signal.signal(sig, self._handler)
        except ValueError:  # not in main thread
            self.prev = None

    def _handler(self, sig, _frame):
        if self.received:
            self.logger.critical('interrupting')
            sys.exit(0)
        self.logger.critical('stopping training')
        self.received = True

    def restore(self):
        if self.prev is not None:
            signal.signal(self.sig, self.prev)


def train_rater(rater, data, val_data=None) -> None:
    """Train ``rater`` on text files (handles or paths)."""
    if rater.status < 1:
        raise RuntimeError('train needs configure() first')
    if rater.incremental:
        raise RuntimeError('an incremental Rater cannot be trained')
    if rater.mesh is not None:
        raise NotImplementedError(
            'training over a device mesh is not ported yet (ROADMAP.md '
            'Queue 1 #16, "Distributed")')

    # handles without a re-openable path (StringIO, pipes, stdin)
    # spool to temp files: the generators re-read inputs by name every
    # epoch, so keeping the handle would silently train on nothing
    # after the first read
    spooled: List[str] = []

    def as_path(f):
        name = getattr(f, 'name', None)
        if hasattr(f, 'read') and not (isinstance(name, str)
                                       and os.path.isfile(name)):
            tmp = tempfile.NamedTemporaryFile(
                'w', suffix='.txt', delete=False, encoding='utf-8')
            tmp.write(f.read())
            tmp.close()
            spooled.append(tmp.name)
            return tmp.name
        return name if hasattr(f, 'read') else f

    files = [as_path(f) for f in data]
    val_files = [as_path(f) for f in val_data] if val_data else None
    try:
        _train_rater(rater, files, val_files)
    finally:
        for name in spooled:
            try:
                os.unlink(name)
            except OSError:
                pass


def _topology(rater) -> dict:
    """What a snapshot must share with the run that resumes it: the
    parameter shapes and the data layout."""
    return {'width': rater.width, 'depth': rater.depth,
            'length': rater.length, 'stateful': bool(rater.stateful),
            'train_streams': bool(rater.train_streams),
            'batch_size': rater.batch_size,
            'contexts': [list(c) for c in rater.contexts],
            'variable_length': bool(rater.variable_length)}


def _load_resume(rater, resume_dir):
    """The newest snapshot in ``resume_dir`` that this run can continue,
    or None (none there, or one of another configuration: warned)."""
    resume = orbaxio.load_train_state(resume_dir)
    if resume is None:
        return None
    topo = resume['meta'].get('topology') or {}
    want = _topology(rater)
    if topo and topo != want:
        rater.logger.warning(
            'ignoring train-state snapshot in %s: it was written by a '
            'different configuration (%s vs %s)', resume_dir, topo, want)
        return None
    return resume


def _train_rater(rater, files, val_files) -> None:
    resume_dir = rater.resume_dir or os.environ.get('KERASLM_RESUME_DIR')
    resume = ckpt_mgr = None
    if resume_dir:
        resume = _load_resume(rater, resume_dir)
        ckpt_mgr = orbaxio.TrainCheckpointer(resume_dir)
    if resume is not None:
        # the snapshot pins the split and the vocabulary: no corpus read
        meta = resume['meta']
        rater.vocab = Vocab.from_codepoints(
            np.asarray(meta['mapping'], dtype=np.uint32))
        plan = SplitPlan(
            training_files=list(meta['training_files']),
            validation_files=list(meta['validation_files']),
            window_split=(np.asarray(meta['window_split'])
                          if meta.get('window_split') is not None
                          else None),
            total_chars=0, step=rater.length if rater.stateful else 3)
        rater.logger.info('resuming training from %s (epoch %d)',
                          resume_dir, meta['epoch_done'] + 1)
    else:
        plan = split_data(
            files, stateful=rater.stateful, length=rater.length,
            validation_split=rater.validation_split, val_files=val_files,
            known_chars=set(rater.vocab.c2i.keys()))
        rater.logger.info(
            'training on %d files / %d character tokens for %d character '
            'types', len(plan.training_files), plan.total_chars,
            len(plan.charset) + 1)
        # grow vocabulary (index 0 reserved):
        if rater.vocab.i2c:
            rater.vocab.grow(plan.charset)
        else:
            rater.vocab.assign(plan.charset)
    rater.voc_size = rater.vocab.size
    rater.reconfigure_for_mapping()
    cfg = rater.cfg
    device = rater.device
    # the trained tensors are fresh leaves: rater.params stays as it is
    # until training ends
    params = copy_params(rater.params if resume is None else
                         _on_device(resume['state']['params'], device),
                         requires_grad=True)
    optimizer = make_optimizer(params)
    # dropout masks come from a CPU generator, so a seed gives the same
    # run on any device; the data-stream generator is seeded per epoch.
    # A resumed run draws both too, as JAX's does, then takes the
    # snapshot's; the global stream after these draws is an
    # uninterrupted run's only when no window split was drawn (a resumed
    # run skips split_data, whose stateless validation split draws one).
    rng = torch.Generator().manual_seed(
        int(np.random.randint(0, 2 ** 31 - 1)))
    data_seed = int(np.random.randint(0, 2 ** 31 - 1))
    if resume is not None:
        optimizer.load_state_dict(resume['state']['opt'])
        rng.set_state(torch.tensor(meta['rng'], dtype=torch.uint8))
        data_seed = int(meta['data_seed'])
    stopper = StopSignal(logger=rater.logger)
    batch_dim = (1 if (rater.stateful and not rater.train_streams)
                 else rater.batch_size)

    def make_gen(file_list, train, data_rng=None):
        n_ctx = len(rater.contexts)
        if rater.stateful and rater.train_streams:
            return gen_stateful_streams(
                file_list, rater.vocab, length=rater.length,
                batch_size=rater.batch_size, n_contexts=n_ctx,
                train=train, rng=data_rng,
                char_degradation=rater.char_degradation,
                context_degradation=rater.context_degradation)
        if rater.stateful:
            return gen_stateful_parity(
                file_list, rater.vocab, length=rater.length,
                n_contexts=n_ctx, train=train, rng=data_rng,
                char_degradation=rater.char_degradation,
                context_degradation=rater.context_degradation)
        return gen_stateless(
            file_list, rater.vocab, length=rater.length,
            batch_size=rater.batch_size, step=plan.step, train=train,
            window_split=plan.window_split,
            validation_split=rater.validation_split,
            char_degradation=rater.char_degradation,
            context_degradation=rater.context_degradation,
            first_window=rater.first_window, n_contexts=n_ctx,
            variable_length=rater.variable_length, rng=data_rng)

    def run_epoch(file_list, train, data_rng=None):
        """One pass over ``file_list``; returns (sum of NLL and of
        accuracy weighted by each batch's mask, the mask's sum, the
        last step's loss or None, whether SIGINT cut the pass).  The
        sums stay on the device: one fetch per pass, not per step."""
        nonlocal steps_done, first_step_logged
        carry = zero_carry(cfg, batch_dim, device)
        acc_nll = torch.zeros((), device=device)
        acc_acc = torch.zeros((), device=device)
        acc_n = 0.0
        last_loss = None
        for batch in Prefetcher(make_gen(file_list, train, data_rng)):
            if batch.reset_carry or not rater.stateful:
                # stateless windows are independent: each batch starts
                # from zero state, as inference scores them
                carry = zero_carry(cfg, batch_dim, device)
            x, zs, y, mask, x_mask = batch_tensors(batch, device)
            if train:
                step_t0 = time.perf_counter()
                carry, last_loss, nll, acc = train_step(
                    params, optimizer, cfg, x, zs, y, mask, carry, rng,
                    x_mask)
                if not first_step_logged:
                    float(last_loss)
                    rater.logger.info(
                        'first train step (incl. kernel build): %.2fs',
                        time.perf_counter() - step_t0)
                    first_step_logged = True
                steps_done += 1
            else:
                nll, acc, carry = eval_step(params, cfg, x, zs, y, mask,
                                            carry, x_mask)
            w = float(np.sum(batch.mask))
            acc_nll = acc_nll + nll * w
            acc_acc = acc_acc + acc * w
            acc_n += w
            if train and stopper.received:
                return acc_nll, acc_acc, acc_n, last_loss, True
        return acc_nll, acc_acc, acc_n, last_loss, False

    history: Dict[str, List[float]] = {
        'loss': [], 'accuracy': [], 'val_loss': [], 'val_accuracy': []}
    best_val = np.inf
    best_params = None
    best_epoch = -1
    bad_epochs = 0
    nan_seen = False
    steps_done = 0
    start_epoch = 0
    first_step_logged = False
    if resume is not None:
        history = {k: list(v) for k, v in meta['history'].items()}
        best_val = (float(meta['best_val'])
                    if meta['best_val'] is not None else np.inf)
        best_params = _on_device(resume['state']['best_params'], device)
        best_epoch = int(meta['best_epoch'])
        bad_epochs = int(meta['bad_epochs'])
        steps_done = int(meta['steps_done'])
        start_epoch = int(meta['epoch_done'])

    def snapshot(epoch_done):
        """The state after ``epoch_done`` completed epochs, committed in
        the background (the tensors are copied before this returns)."""
        if ckpt_mgr is None:
            return
        ckpt_mgr.save(epoch_done, {
            'params': params,
            'best_params': best_params if best_params is not None
            else params,
            'opt': optimizer.state_dict()}, {
            'epoch_done': epoch_done,
            'steps_done': steps_done,
            'history': history,
            'best_val': None if not np.isfinite(best_val)
            else float(best_val),
            'best_epoch': best_epoch,
            'bad_epochs': bad_epochs,
            'rng': rng.get_state().tolist(),
            'data_seed': data_seed,
            'training_files': plan.training_files,
            'validation_files': plan.validation_files,
            'window_split': (plan.window_split.tolist()
                             if plan.window_split is not None else None),
            'mapping': rater.vocab.to_codepoints().tolist(),
            'topology': _topology(rater)})

    try:
        for epoch in range(start_epoch, EPOCHS):
            # ---- training pass ----
            epoch_t0 = time.perf_counter()
            tr_nll, tr_acc, tr_n, last_loss, interrupted = run_epoch(
                plan.training_files, True,
                np.random.default_rng([data_seed, epoch]))
            tr_loss, tr_acc = float(tr_nll), float(tr_acc)
            if last_loss is not None:
                loss_f = float(last_loss)
                if np.isnan(tr_loss) or np.isnan(loss_f):
                    rater.logger.critical('NaN loss during epoch %d',
                                          epoch + 1)
                    nan_seen = True
                elif loss_f > 25:
                    rater.logger.warning('huge loss (%.1f) at end of '
                                         'epoch %d', loss_f, epoch + 1)
            if tr_n == 0:
                rater.logger.critical('training failed (no data)')
                rater.status = 1
                return
            # ---- validation pass (carry reset before) ----
            va_nll, va_acc, va_n, _, _ = run_epoch(plan.validation_files,
                                                   False)
            va_loss, va_acc = float(va_nll), float(va_acc)
            if va_n <= 0:
                # an empty validation pass would otherwise score 0.0
                # and win best-model selection forever
                rater.logger.critical(
                    'validation yielded no data (files shorter than '
                    'the window, or empty split)')
                va_loss = va_acc = float('nan')
                va_n = 1.0
            ep_vloss = va_loss / va_n
            history['loss'].append(tr_loss / tr_n)
            history['accuracy'].append(tr_acc / tr_n)
            history['val_loss'].append(ep_vloss)
            history['val_accuracy'].append(va_acc / va_n)
            rater.logger.info(
                'epoch %d: loss %.4f acc %.4f val_loss %.4f '
                'val_acc %.4f (%.0f chars/s)',
                epoch + 1, tr_loss / tr_n, tr_acc / tr_n, ep_vloss,
                va_acc / va_n,
                tr_n / max(time.perf_counter() - epoch_t0, 1e-9))

            if nan_seen or np.isnan(ep_vloss):
                break
            if ep_vloss < best_val:
                best_val = ep_vloss
                best_params = copy_params(params)
                best_epoch = epoch
                bad_epochs = 0
                # best-only weight checkpoint; directory configurable
                # via rater.ckpt_dir or KERASLM_CKPT_DIR (default: CWD)
                ckpt_dir = (rater.ckpt_dir
                            or os.environ.get('KERASLM_CKPT_DIR') or '.')
                os.makedirs(ckpt_dir, exist_ok=True)
                ckpt = os.path.join(
                    ckpt_dir, 'ckpt.%02d-%.2f.h5' % (epoch + 1, ep_vloss))
                try:
                    h5io.save_weights(ckpt, params, cfg)
                    rater.logger.info('saved checkpoint %s', ckpt)
                except OSError as err:
                    rater.logger.warning(
                        'cannot save checkpoint: %s', err)
            else:
                bad_epochs += 1
                # Keras EarlyStopping semantics: stop once `patience`
                # epochs pass without improvement, but never before
                # MIN_STEPS_BEFORE_STOP optimizer steps
                if bad_epochs >= PATIENCE and \
                        steps_done >= MIN_STEPS_BEFORE_STOP and \
                        not interrupted:
                    snapshot(epoch + 1)
                    rater.logger.info('early stopping (best epoch %d)',
                                      best_epoch + 1)
                    break
            if interrupted:
                # SIGINT cut the epoch: keep the last completed epoch's
                # snapshot (a resume must not skip the unseen data)
                break
            snapshot(epoch + 1)
            if stopper.received:
                break
    finally:
        stopper.restore()
        if ckpt_mgr is not None:
            ckpt_mgr.close()  # wait for and commit the last snapshot

    rater.params = best_params if (
        best_epoch >= 0 and best_params is not None) \
        else copy_params(params)
    rater._params_changed()  # drop the device weight caches
    rater.history = history
    if best_epoch >= 0:
        rater.logger.info('training finished with val_loss %f', best_val)
        rater.status = 2
    else:
        # no finite best epoch: NaN on epoch 1, empty data, or immediate
        # SIGINT: the weights are not usable; do NOT report success (the
        # caller would save a NaN/garbage model)
        rater.logger.critical('training failed (no usable epoch)')
        rater.status = 1


def copy_params(params: Params, requires_grad: bool = False) -> Params:
    """A detached copy of the tree (leaves that require grad when
    asked)."""
    def copy(t):
        return t.detach().clone().requires_grad_(requires_grad)
    return {'char_embedding': copy(params['char_embedding']),
            'context_embeddings': [copy(e) for e in
                                   params['context_embeddings']],
            'lstm': [{k: copy(v) for k, v in lp.items()}
                     for lp in params['lstm']]}


def _on_device(params: Params, device) -> Params:
    """A parameter tree of CPU tensors (a snapshot's) on ``device``."""
    return {'char_embedding': params['char_embedding'].to(device),
            'context_embeddings': [e.to(device) for e in
                                   params['context_embeddings']],
            'lstm': [{k: v.to(device) for k, v in lp.items()}
                     for lp in params['lstm']]}
