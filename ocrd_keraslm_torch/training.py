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

Over a rank mesh (``rater.mesh``, ``parallel/``): every rank runs this
loop on the same full batches (rank 0's seed is broadcast before any
draw) and feeds its own rows to the sharded step, ``parallel/train.py``
(data and vocabulary parallel) or ``parallel/pipeline.py`` (pipeline
stages); validation runs through the sharded evaluation step.
Checkpoints and snapshots hold the canonical state, gathered on every
rank and written by rank 0; a resumed mesh run takes its shard of the
snapshot.  A world over several hosts refuses pipeline meshes and
snapshots, as the JAX package's multihost training does.
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
from .models.lstm_lm import (Carry, LMConfig, Params, detach_carry,
                             forward_seq, host_to_device, map_params,
                             param_leaves, regularization_loss,
                             sequence_xent, zero_carry)
from .parallel import multihost
from .parallel.mesh import (gather_adam_state, gather_params, shard_adam_state,
                            shard_batch, shard_params)
from .utils import h5io, orbaxio
from .utils.devtrace import span
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
    place.  ``rng`` is the dropout generator (on the CPU; the weight
    drop's device generator is seeded from it).  Returns (carry, loss,
    nll, acc), all detached: the carry is an output, not differentiated
    through from the next step."""
    optimizer.zero_grad(set_to_none=True)
    loss, (nll, acc, carry) = _loss_fn(params, cfg, x, zs, y, mask, carry,
                                       rng, True, x_mask)
    loss.backward()
    torch.nn.utils.clip_grad_value_(param_leaves(params), 1.0)
    optimizer.step()
    return (detach_carry(carry), loss.detach(), nll.detach(),
            acc.detach())


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
    # several ranks: the file split, the window split, the data seeds
    # and the dropout seed all flow from numpy's global generator, and
    # every rank must draw alike (each then feeds only its own rows)
    multihost.align_seed()

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
    parameter shapes and the data layout (the layer widths and the head
    bias where the model has them)."""
    topo = {'width': rater.width, 'depth': rater.depth,
            'length': rater.length, 'stateful': bool(rater.stateful),
            'train_streams': bool(rater.train_streams),
            'batch_size': rater.batch_size,
            'contexts': [list(c) for c in rater.contexts],
            'variable_length': bool(rater.variable_length)}
    if rater.widths:
        topo['widths'] = list(rater.widths)
    if rater.head_bias:
        topo['head_bias'] = True
    return topo


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
    if resume_dir and multihost.is_multihost():
        # every rank would write the same snapshot directory
        raise ValueError(
            'resume_dir under multihost training is not supported: '
            'snapshot/restore is single-controller.  Run without '
            '--resume-dir (epoch h5 checkpoints still write from '
            'process 0) or train single-host.')
    if resume_dir:
        resume = _load_resume(rater, resume_dir)
        if h5io._is_writer():
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
    mesh = rater.mesh
    batch_dim = (1 if (rater.stateful and not rater.train_streams)
                 else rater.batch_size)
    # the trained tensors are fresh leaves: rater.params stays as it is
    # until training ends
    canonical = rater.params if resume is None else \
        _on_device(resume['state']['params'], device)
    if mesh is not None and not (cfg.uniform and cfg.weight_drop == 0
                                 and not cfg.locked_dropout):
        raise ValueError(
            'a rank mesh trains models of one width, without a head bias, '
            'weight drop or locked dropout; train this model on one device')
    if mesh is None:
        params = copy_params(canonical, requires_grad=True)
        optimizer = make_optimizer(params)

        def step_fn(p, opt, x, zs, y, mask, carry, rng, x_mask):
            return train_step(p, opt, cfg, x, zs, y, mask, carry, rng,
                              x_mask)

        def eval_fn(p, x, zs, y, mask, carry, x_mask):
            return eval_step(p, cfg, x, zs, y, mask, carry, x_mask)
    else:
        step_fn, eval_fn, params, optimizer = _mesh_steps(
            rater, mesh, cfg, canonical, batch_dim)
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
        opt_state = resume['state']['opt']
        optimizer.load_state_dict(opt_state if mesh is None else
                                  shard_adam_state(mesh, opt_state))
        rng.set_state(torch.tensor(meta['rng'], dtype=torch.uint8))
        data_seed = int(meta['data_seed'])
    stopper = StopSignal(logger=rater.logger)
    n_data = 1 if mesh is None else mesh.shape['data']

    def canonical_of(p):
        """The canonical tree of this rank's ``p`` (collective over the
        model axis of a mesh)."""
        return p if mesh is None else gather_params(mesh, p)

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
        carry = zero_carry(cfg, batch_dim // n_data, device)
        acc_nll = torch.zeros((), device=device)
        acc_acc = torch.zeros((), device=device)
        acc_n = 0.0
        last_loss = None
        for batch in Prefetcher(make_gen(file_list, train, data_rng)):
            if batch.reset_carry or not rater.stateful:
                # stateless windows are independent: each batch starts
                # from zero state, as inference scores them
                carry = zero_carry(cfg, batch_dim // n_data, device)
            x, zs, y, mask, x_mask = batch_tensors(
                batch if mesh is None else shard_batch(mesh, batch), device)
            if train:
                step_t0 = time.perf_counter()
                with span('train.step', 'step=%d' % (steps_done + 1)):
                    carry, last_loss, nll, acc = step_fn(
                        params, optimizer, x, zs, y, mask, carry, rng,
                        x_mask)
                if not first_step_logged:
                    float(last_loss)
                    rater.logger.info(
                        'first train step (incl. kernel build): %.2fs',
                        time.perf_counter() - step_t0)
                    first_step_logged = True
                steps_done += 1
            else:
                nll, acc, carry = eval_fn(params, x, zs, y, mask, carry,
                                          x_mask)
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
        if mesh is not None:
            best_params = shard_params(mesh, best_params)
        best_epoch = int(meta['best_epoch'])
        bad_epochs = int(meta['bad_epochs'])
        steps_done = int(meta['steps_done'])
        start_epoch = int(meta['epoch_done'])

    def snapshot(epoch_done):
        """The state after ``epoch_done`` completed epochs, committed in
        the background (the tensors are copied before this returns).
        Over a mesh every rank gathers the canonical state and rank 0
        writes it."""
        if not resume_dir:
            return
        with span('train.checkpoint', 'epoch=%d' % epoch_done):
            state = {
                'params': canonical_of(params),
                'best_params': canonical_of(best_params if best_params
                                            is not None else params),
                'opt': optimizer.state_dict() if mesh is None
                else gather_adam_state(mesh, optimizer)}
            if ckpt_mgr is None:
                return
            ckpt_mgr.save(epoch_done, state, {
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
            with span('train.validate', 'epoch=%d' % (epoch + 1)):
                va_nll, va_acc, va_n, _, _ = run_epoch(
                    plan.validation_files, False)
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
                # every rank gathers (collective); rank 0 writes
                try:
                    with span('train.checkpoint', 'epoch=%d' % (epoch + 1)):
                        h5io.save_weights(ckpt, params, cfg, mesh=mesh)
                    if h5io._is_writer():
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

    rater.params = copy_params(canonical_of(
        best_params if (best_epoch >= 0 and best_params is not None)
        else params))
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


def _mesh_steps(rater, mesh, cfg: LMConfig, canonical: Params,
                batch_dim: int):
    """(step, eval step, this rank's parameters, their optimizer) over
    ``mesh``, with the JAX package's refusals."""
    from .parallel.train import (make_sharded_eval_step,
                                 make_sharded_train_step)
    n_data = mesh.shape.get('data', 1)
    if batch_dim % n_data != 0:
        raise ValueError('batch_size %d not divisible by mesh data axis %d'
                         % (batch_dim, n_data))
    if 'pipe' in mesh.axis_names:
        from .parallel.pipeline import make_pipeline_train_step_canonical
        if mesh.multihost:
            raise ValueError(
                'multihost pipeline training is not wired into the '
                'training loop (the (data, pipe) step itself composes '
                'across processes); use a dp/tp mesh for multihost '
                'training')
        if not (rater.stateful and rater.train_streams):
            raise ValueError(
                'pipeline training requires the stateful parallel-streams '
                'layout (stateful=True, train_streams=True); stateless '
                'windowed and parity layouts use a dp/tp mesh')
        n_stages = int(mesh.shape['pipe'])
        b_loc = batch_dim // n_data
        n_micro = int(getattr(rater, 'pipe_microbatches', 0) or n_stages)
        if b_loc % n_micro != 0:
            raise ValueError(
                'per-device batch %d not divisible by %d pipeline '
                'microbatches (set rater.pipe_microbatches or adjust '
                'batch_size)' % (b_loc, n_micro))
        step, shard_fn = make_pipeline_train_step_canonical(
            mesh, cfg, n_micro=n_micro)
    else:
        step, shard_fn = make_sharded_train_step(mesh, cfg)
    params, optimizer = shard_fn(canonical)
    rater.logger.info('training over mesh %s (%s)', dict(mesh.shape),
                      mesh.backend)
    return step, make_sharded_eval_step(mesh, cfg), params, optimizer


def copy_params(params: Params, requires_grad: bool = False) -> Params:
    """A detached copy of the tree (leaves that require grad when
    asked)."""
    return map_params(params, lambda t: t.detach().clone().requires_grad_(
        requires_grad))


def _on_device(params: Params, device) -> Params:
    """A parameter tree of CPU tensors (a snapshot's) on ``device``."""
    return map_params(params, lambda t: t.to(device))
