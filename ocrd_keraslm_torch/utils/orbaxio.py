"""The model directory format and full train-state snapshots.

Counterpart of ``ocrd_keraslm_tpu/utils/orbaxio.py``, kept under its
name so the two are found side by side; it uses no Orbax (nor
tensorstore): the tensors are written with ``torch.save`` as CPU
tensors and read with ``torch.load(weights_only=True)``.

**Model directories.**  ``Rater.save``, ``load_config`` and
``load_weights`` take this format where the path is a directory or
ends in ``.orbax`` (or ``/``).  A directory holds

* ``config.json``: the configuration, the vocabulary's codepoints and
  the history, with the JAX package's fields and values;
* ``params.pt``: the parameter tree (``char_embedding``,
  ``context_embeddings``, ``lstm``) as float32 CPU tensors.

The JAX package writes its weights as an Orbax tree (``params/``),
which this package cannot read: such a directory raises a
``ValueError`` naming h5, the format both packages read and write.

**Train-state snapshots.**  With ``rater.resume_dir`` (or
``KERASLM_RESUME_DIR``) set, training snapshots its whole state at
every epoch boundary, so that a killed run resumes from the last
completed epoch and replays what an uninterrupted run computes::

    <dir>/ep_NNNN/state.pt    params, best_params and the optimizer's
                              state_dict (Adam's step and moments)
    <dir>/ep_NNNN/meta.json   counters, history, the dropout generator's
                              state (``rng``), the data seed, the split's
                              file lists and window split, the mapping
                              and the run's topology

A snapshot is written into ``ep_NNNN.tmp`` and committed by one
``os.rename`` in a background thread, after which older snapshots are
pruned: a kill at any moment leaves the committed snapshot or the one
before it, never a torn one.  The tensors are copied to the host
before :meth:`TrainCheckpointer.save` returns, since the next training
step updates them in place.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.lstm_lm import LMConfig, Params, map_params
from .h5io import _AWD_KEYS, NumpyJSONEncoder, _is_writer
from .vocab import Vocab

PARAMS_FILE = 'params.pt'
STATE_FILE = 'state.pt'


def is_orbax_path(path: str) -> bool:
    """Whether ``path`` names a model directory (not an h5 file)."""
    path = str(path)
    return (path.endswith('.orbax') or path.endswith('/') or
            os.path.isdir(path))


def to_host(tree):
    """A copy of a tree of tensors (dicts, lists, tuples) as detached
    CPU tensors; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def save_model(path: str, params: Params, cfg: LMConfig, vocab: Vocab,
               history: Optional[Dict[str, Any]] = None) -> None:
    """Write a model directory (rank 0 of a job of several ranks)."""
    if not _is_writer():
        return
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(to_host(params), os.path.join(path, PARAMS_FILE))
    meta = {
        'width': cfg.width, 'depth': cfg.depth, 'length': cfg.length,
        'voc_size': cfg.voc_size,
        'contexts': [list(c) for c in cfg.contexts],
        'stateful': cfg.stateful,
        'variable_length': cfg.variable_length,
        'mapping': vocab.to_codepoints().tolist(),
        'history': history or {},
    }
    for key in _AWD_KEYS:  # where they differ from the defaults
        if getattr(cfg, key) != getattr(LMConfig, key):
            meta[key] = getattr(cfg, key)
    with open(os.path.join(path, 'config.json'), 'w',
              encoding='utf-8') as fh:
        json.dump(meta, fh, cls=NumpyJSONEncoder)


def load_config(path: str) -> Tuple[LMConfig, Vocab, Dict[str, Any]]:
    with open(os.path.join(path, 'config.json'), encoding='utf-8') as fh:
        meta = json.load(fh)
    vocab = Vocab.from_codepoints(
        np.asarray(meta['mapping'], dtype=np.uint32))
    cfg = LMConfig(
        width=int(meta['width']), depth=int(meta['depth']),
        length=int(meta['length']),
        # the stored voc_size where it exceeds the mapping (a model may
        # carry more embedding rows than mapped chars)
        voc_size=max(int(meta.get('voc_size', 0)), vocab.size),
        contexts=tuple(tuple(c) for c in meta['contexts']),
        stateful=bool(meta['stateful']),
        variable_length=bool(meta['variable_length']),
        **{key: tuple(meta[key]) if key == 'widths' else meta[key]
           for key in _AWD_KEYS if key in meta})
    return cfg, vocab, meta.get('history', {})


def load_weights(path: str, cfg: LMConfig) -> Params:
    """The parameter tree of a model directory as float32 CPU
    tensors."""
    path = os.path.abspath(path)
    weights = os.path.join(path, PARAMS_FILE)
    if not os.path.isfile(weights):
        if os.path.isdir(os.path.join(path, 'params')):
            raise ValueError(
                '%s holds the JAX package\'s Orbax weights (params/), '
                'which this package cannot read; save the model as an h5 '
                'file, the format both packages read and write' % path)
        raise FileNotFoundError('no %s in the model directory %s'
                                % (PARAMS_FILE, path))
    tree = torch.load(weights, map_location='cpu', weights_only=True)
    return map_params(tree, lambda t: t)


def load_model(path: str
               ) -> Tuple[Params, LMConfig, Vocab, Dict[str, Any]]:
    """``(params, cfg, vocab, history)`` of a model directory
    (:func:`load_config`, then :func:`load_weights`); ``cfg.voc_size``
    follows the embedding's rows."""
    cfg, vocab, history = load_config(path)
    params = load_weights(path, cfg)
    rows = params['char_embedding'].shape[0]
    if rows != cfg.voc_size:
        cfg = cfg.replace(voc_size=rows)
    return params, cfg, vocab, history


def _snapshots(path: str):
    return sorted(e for e in os.listdir(path)
                  if e.startswith('ep_') and not e.endswith('.tmp')
                  and os.path.isdir(os.path.join(path, e)))


def _refuse_jax_snapshots(path: str) -> None:
    """Raise where ``path`` holds the JAX package's snapshots (an Orbax
    ``state/`` tree and no state file of this package): taking the
    directory as empty would start afresh and prune them."""
    for tag in _snapshots(path):
        snap = os.path.join(path, tag)
        if not os.path.isfile(os.path.join(snap, STATE_FILE)) and \
                os.path.isdir(os.path.join(snap, 'state')):
            raise ValueError(
                '%s holds a train-state snapshot of the JAX package (%s '
                'with an Orbax state/ tree), which this package cannot '
                'resume; pass another --resume-dir' % (path, tag))


class TrainCheckpointer:
    """Atomic, versioned train-state snapshots, committed in the
    background.

    ``save`` copies the state to the host and writes ``meta.json``,
    then returns; a thread writes the tensors and commits the snapshot
    by one rename, while the training loop runs the next epoch.  A
    commit failure is raised at the next :meth:`finalize` (or the next
    ``save``), once.  ``last`` holds the newest snapshot's sizes and
    times: ``bytes``, ``copy_s`` (the synchronous copy in ``save``) and
    ``commit_s`` (the thread's write and rename)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)
        _refuse_jax_snapshots(self.path)
        self._committer: Optional[threading.Thread] = None
        self._commit_error: Optional[BaseException] = None
        self.last: Dict[str, float] = {}

    def save(self, epoch_done: int, state: Dict[str, Any],
             meta: Dict[str, Any]) -> None:
        """Snapshot after epoch ``epoch_done`` (1-based) completed."""
        self.finalize()
        tag = 'ep_%04d' % epoch_done
        tmp = os.path.join(self.path, tag + '.tmp')
        final = os.path.join(self.path, tag)
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(final, ignore_errors=True)
        t0 = time.perf_counter()
        state = to_host(state)
        self.last = {'copy_s': time.perf_counter() - t0}
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, 'meta.json'), 'w',
                  encoding='utf-8') as fh:
            json.dump(meta, fh, cls=NumpyJSONEncoder)
        self._committer = threading.Thread(
            target=self._write_and_commit, args=(state, tmp, final),
            daemon=True)
        self._committer.start()

    def _write_and_commit(self, state, tmp: str, final: str) -> None:
        """Write the tensors, rename ``tmp`` to ``final`` and prune every
        other snapshot.  A failure (disk full, permissions) is recorded
        and raised at the next :meth:`finalize`: training must not go on
        believing its epochs are saved."""
        t0 = time.perf_counter()
        try:
            torch.save(state, os.path.join(tmp, STATE_FILE))
            os.rename(tmp, final)
        except BaseException as err:  # noqa: BLE001 - raised in finalize
            self._commit_error = err
            return
        self.last['commit_s'] = time.perf_counter() - t0
        self.last['bytes'] = sum(
            os.path.getsize(os.path.join(final, name))
            for name in os.listdir(final))
        for entry in sorted(os.listdir(self.path)):
            full = os.path.join(self.path, entry)
            if full != final and entry.startswith('ep_'):
                shutil.rmtree(full, ignore_errors=True)

    def finalize(self) -> None:
        """Block until the in-flight snapshot (if any) is committed.
        Raises the commit's failure, if it had one."""
        if self._committer is not None:
            self._committer.join()
            self._committer = None
        if self._commit_error is not None:
            err, self._commit_error = self._commit_error, None
            raise RuntimeError('checkpoint snapshot commit failed: %s'
                               % err) from err

    def close(self) -> None:
        self.finalize()


def load_train_state(path: str) -> Optional[Dict[str, Any]]:
    """The newest complete snapshot as ``{'state': ..., 'meta': ...}``
    (the tensors on the CPU), or None where there is none.  Raises on a
    directory that holds the JAX package's snapshots."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    _refuse_jax_snapshots(path)
    tags = _snapshots(path)
    if not tags:
        return None
    snap = os.path.join(path, tags[-1])
    with open(os.path.join(snap, 'meta.json'), encoding='utf-8') as fh:
        meta = json.load(fh)
    state = torch.load(os.path.join(snap, STATE_FILE), map_location='cpu',
                       weights_only=True)
    return {'state': state, 'meta': meta}
