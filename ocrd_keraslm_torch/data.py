"""Data pipeline: file splitting, windowing, augmentation, vectorization.

The port's own copy of ``ocrd_keraslm_tpu/data.py`` (pure numpy and
``random``; the same seeds give the same split and the same batches in
both packages), with the background ``Prefetcher`` of the JAX package's
``native.py``: file-wise split in stateful mode / random-window split
in stateless mode, window generation with configurable step, and the
three training augmentations (char degradation 1%, context degradation
10%, first-window subsampling 10%).

Batches are (int32 indices, int32 targets, float32 mask) with fixed
shapes (remainders are padded and masked, never shape-changing).  In
stateful mode, beside the reference-parity single-stream layout
(batch_size=1, windows in file order), there is the **parallel-streams**
layout: each file is cut into ``batch_size`` contiguous streams which
advance in lockstep, one (h, c) carry per stream: truncated BPTT at
batch 128 instead of 1, with the recurrence kept within each stream.
"""
from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass, field
from math import ceil
from random import shuffle
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .utils.vocab import Vocab, read_normalized

LOG = logging.getLogger(__name__)


def context_from_filename(name: str, limit: int = 200) -> List[int]:
    """Context variables from an ``author_title_year`` filename: the
    year bucketed as ceil(year/10).  Buckets beyond the context table
    (default 200 rows, i.e. years >= 2000) map to the underspecified 0
    with a warning; names without a year map to 0."""
    base = name.rsplit('/', 1)[-1].split('.')[0].split('_')
    if len(base) == 3 and base[2].isdigit():
        bucket = ceil(int(base[2]) / 10)
        if bucket >= limit:
            LOG.warning('year context %s out of range for the %d-row '
                        'context table: using underspecified 0',
                        base[2], limit)
            return [0]
        return [bucket]
    return [0]


def _context_arrays(context: List[int], n_contexts: int,
                    batch: int) -> List[np.ndarray]:
    """(B,)-shaped int32 arrays for each context variable, zero-padded
    to ``n_contexts`` (shared by all three batch generators)."""
    zs = [np.full((batch,), c, np.int32)
          for c in context[:n_contexts]]
    while len(zs) < n_contexts:
        zs.append(np.zeros((batch,), np.int32))
    return zs


@dataclass
class Batch:
    """One step's worth of data (static shapes)."""
    x: np.ndarray          # (B, T) int32 inputs
    zs: List[np.ndarray]   # context indices, each (B,) int32
    y: np.ndarray          # (B, T) or (B,) int32 targets
    mask: np.ndarray       # same shape as y, float32
    reset_carry: bool = False   # stateful: zero the carry before this batch
    file_name: str = ''
    # variable-length mode: (B, T) input-validity mask (left-padded
    # short windows; masked positions leave the LSTM state untouched)
    x_mask: Optional[np.ndarray] = None


@dataclass
class SplitPlan:
    training_files: List[str]
    validation_files: List[str]
    window_split: Optional[np.ndarray]  # stateless shared-file split
    total_chars: int
    step: int
    charset: List[str] = field(default_factory=list)


def split_data(files: Sequence[str], *, stateful: bool, length: int,
               validation_split: float = 0.2,
               val_files: Optional[Sequence[str]] = None,
               known_chars: Optional[set] = None) -> SplitPlan:
    """Read all files once: build the charset and decide the
    training/validation split (file-wise if stateful, random-window
    if stateless).  ``random.shuffle`` orders the files and the global
    ``np.random`` draws the window split, as in the JAX package, so the
    same seeds give the same plan.  No epoch step counts are precomputed: the
    epoch loop (training.py) drains the generators, so counts could
    only drift from the real batch streams."""
    files = list(files)
    shuffle(files)
    chars = set(known_chars or ())
    # ONE read per file: drop non-text inputs (e.g. stray model
    # binaries in a data directory), and record lengths + charset
    # (re-reading multi-GB corpora doubled startup)
    lens: Dict[str, int] = {}

    def probe(names, what):
        ok = []
        for name in names:
            try:
                text = read_normalized(name)
            except (UnicodeDecodeError, IsADirectoryError) as err:
                LOG.warning('skipping unreadable %s %s (%s)', what,
                            name, err)
                continue
            ok.append(name)
            lens[name] = len(text)
            chars.update(text)
        return ok

    files = probe(files, 'input')
    if val_files:
        val_files = probe(val_files, 'validation input')
    total = 0
    if stateful:
        step = length
        if val_files:
            training, validation = files, list(val_files)
        elif validation_split <= 0:
            # no held-out split requested: validate on the training
            # files (cut=0 would slice training to [] instead)
            training, validation = files, list(files)
        else:
            cut = ceil(len(files) * validation_split)
            if len(files) < 2:
                raise ValueError(
                    'stateful mode needs >= 2 files to split '
                    '(or explicit validation files)')
            # ceil can otherwise claim EVERY file for validation at
            # validation_split >= (n-1)/n, silently training on nothing
            cut = min(cut, len(files) - 1)
            training, validation = files[:-cut], files[-cut:]
        for name in training:
            total += lens[name]
        for name in validation:
            total += lens[name]
        split = None
    else:
        step = 3
        max_size = 0
        for name in files:
            # every char from position `step` on is a window target
            # (short windows near the file start are included as
            # left-padded masked rows); log-line bookkeeping only
            total += max(lens[name] - 1, 0)
            max_size = max(max_size, lens[name])
        if val_files:
            training, validation = files, list(val_files)
            split = None
        elif validation_split <= 0:
            # no held-out split requested: validate on the training
            # windows (a window_split with threshold 0 would instead
            # skip EVERY validation window — gen_stateless partitions
            # by '(r < validation_split) == train'); mirrors the
            # stateful branch's validate-on-training behavior
            training = validation = files
            split = None
        else:
            training = validation = files
            split = np.random.uniform(0, 1, (ceil(max_size / step),))
    return SplitPlan(training_files=list(training),
                     validation_files=list(validation),
                     window_split=split,
                     total_chars=total,
                     step=step,
                     charset=sorted(chars))


# ----------------------------------------------------------------------
# stateless windowed batches
# ----------------------------------------------------------------------

def gen_stateless(files: Sequence[str], vocab: Vocab, *, length: int,
                  batch_size: int, step: int = 3, train: bool = False,
                  window_split: Optional[np.ndarray] = None,
                  validation_split: float = 0.2,
                  char_degradation: float = 0.01,
                  context_degradation: float = 0.1,
                  first_window: float = 0.1,
                  repeat: bool = False,
                  n_contexts: int = 1,
                  variable_length: bool = False,
                  rng: Optional[np.random.Generator] = None
                  ) -> Iterator[Batch]:
    """Yield fixed-shape windowed batches: x (B, L), y (B,) next char.

    Includes the three augmentations; the remainder batch is padded,
    not shrunk.

    Short windows near the file start (i < length) are included in
    BOTH modes as left-padded rows with an ``x_mask`` marking the
    valid region — without them a file shorter than ``length`` yields
    no batches at all, and the first ``length`` characters of every
    file are never prediction targets.  The masked left-padded row
    is exactly the short window.  (The empty i=0 window, predicting
    char 0 from nothing, is skipped: the zero state yields zero
    gradient through the tied softmax.)

    With ``variable_length``, the first-window augmentation shortens
    windows via the mask instead of zero-erasing their left part.
    """
    rng = rng or np.random.default_rng()

    def _contexts(context):
        return _context_arrays(context, n_contexts, batch_size)

    while True:
        for name in files:
            text = read_normalized(name)
            context = context_from_filename(name)
            ids = vocab.encode(text)
            size = len(ids)
            buf_x: List[np.ndarray] = []
            buf_y: List[int] = []
            start = step
            for i in range(start, size, step):
                if window_split is not None:
                    r = window_split[i // step]
                    if (r < validation_split) == train:
                        continue
                    rand = (r - validation_split) / (1 - validation_split)
                else:
                    rand = rng.uniform()
                buf_x.append(ids[max(i - length, 0):i])
                buf_y.append(int(ids[i]))
                if len(buf_x) == batch_size:
                    x = np.zeros((batch_size, length), np.int32)
                    xm = np.zeros((batch_size, length), np.float32)
                    for bi, w in enumerate(buf_x):  # right-aligned
                        x[bi, length - len(w):] = w
                        xm[bi, length - len(w):] = 1.0
                    y = np.asarray(buf_y, np.int32)
                    zs = _contexts(context)
                    mask = np.ones((batch_size,), np.float32)
                    # fixed-length mode only ships the mask when a
                    # partial window needs it (the masked scan is the
                    # slower lane, outside the kernels)
                    need_mask = variable_length or any(
                        len(w) < length for w in buf_x)
                    yield Batch(x, zs, y, mask, file_name=name,
                                x_mask=xm if need_mask else None)
                    buf_x, buf_y = [], []
                    if train:
                        yield from _augment(
                            x, zs, y, mask, rand, char_degradation,
                            context_degradation, first_window, length,
                            rng, name,
                            xm if need_mask else None)
            if buf_x:  # padded remainder
                n = len(buf_x)
                x = np.zeros((batch_size, length), np.int32)
                xm = np.zeros((batch_size, length), np.float32)
                for bi, w in enumerate(buf_x):
                    x[bi, length - len(w):] = w
                    xm[bi, length - len(w):] = 1.0
                y = np.zeros((batch_size,), np.int32)
                y[:n] = buf_y
                zs = _contexts(context)
                mask = np.zeros((batch_size,), np.float32)
                mask[:n] = 1.0
                need_mask = variable_length or any(
                    len(w) < length for w in buf_x)
                yield Batch(x, zs, y, mask, file_name=name,
                            x_mask=xm if need_mask else None)
        if not repeat:
            break


def _degrade(x, zs, y, mask, rand, char_deg, ctx_deg, length, name,
             x_mask=None):
    """Shared char/context degradation core: occasionally yields an
    extra degraded duplicate batch per stage; returns the leftover
    rescaled random number for further stages (retrieve via ``yield
    from``)."""
    if 0 < rand < char_deg:
        j = int((length - 1) * rand / char_deg)
        xa = x.copy()
        xa[:, j] = 0
        yield Batch(xa, [z.copy() for z in zs], y, mask, file_name=name,
                    x_mask=x_mask)
    rand = (rand - char_deg) / (1 - char_deg)
    if 0 < rand < ctx_deg and zs:
        # covers ALL contexts; (len(zs)-1)*q missed the last one for
        # n>=2
        j = int(len(zs) * rand / ctx_deg)
        za = [z.copy() for z in zs]
        za[j][:] = 0
        yield Batch(x.copy(), za, y, mask, file_name=name,
                    x_mask=x_mask)
    return (rand - ctx_deg) / (1 - ctx_deg)


def _augment(x, zs, y, mask, rand, char_deg, ctx_deg, first_window,
             length, rng, name, x_mask=None) -> Iterator[Batch]:
    """The 3 train-time degradations, each occasionally yielding one
    extra modified batch."""
    rand = yield from _degrade(x, zs, y, mask, rand, char_deg,
                               ctx_deg, length, name, x_mask)
    if 0 < rand < first_window:
        j = int((length - 1) * rand / first_window) + 1
        if x_mask is not None:
            # variable-length: genuinely shorten the window via the
            # mask
            xa = x.copy()
            xma = x_mask.copy()
            xa[:, 0:length - j] = 0
            xma[:, 0:length - j] = 0.0
            yield Batch(xa, [z.copy() for z in zs], y, mask,
                        file_name=name, x_mask=xma)
        else:
            xa = x.copy()
            xa[:, 0:j] = 0  # simulate zero-padded run-in
            yield Batch(xa, [z.copy() for z in zs], y, mask,
                        file_name=name)


# ----------------------------------------------------------------------
# stateful batches
# ----------------------------------------------------------------------

def _stateful_augment(x, zs, y, mask, rand, char_deg, ctx_deg, length,
                      name) -> Iterator[Batch]:
    """Train-time degradations for the stateful layouts, with
    EXTRA-batch semantics: the clean window is kept and an occasional
    degraded duplicate follows it (the carry then legitimately advances
    through both).  ``first_window`` does not apply: stateful mode
    forces it to 0."""
    yield from _degrade(x, zs, y, mask, rand, char_deg, ctx_deg,
                        length, name)


def gen_stateful_parity(files: Sequence[str], vocab: Vocab, *,
                        length: int, repeat: bool = False,
                        n_contexts: int = 1, train: bool = False,
                        char_degradation: float = 0.01,
                        context_degradation: float = 0.1,
                        rng: Optional[np.random.Generator] = None
                        ) -> Iterator[Batch]:
    """Reference-parity stateful layout: batch_size=1, ``length``-char
    windows stepping by ``length``, x=text[i-L:i], y=text[i-L+1:i+1],
    carry reset at file boundaries.  With ``train``, the char/context
    degradations occasionally append an extra degraded duplicate
    window."""
    rng = rng or np.random.default_rng()
    while True:
        for name in files:
            text = read_normalized(name)
            context = context_from_filename(name)
            ids = vocab.encode(text)
            size = len(ids)
            first = True
            for i in range(length, size, length):
                x = ids[i - length:i][None, :].astype(np.int32)
                y = ids[i - length + 1:i + 1][None, :].astype(np.int32)
                zs = _context_arrays(context, n_contexts, 1)
                mask = np.ones_like(y, np.float32)
                yield Batch(x, zs, y, mask, reset_carry=first,
                            file_name=name)
                first = False
                if train:
                    yield from _stateful_augment(
                        x, zs, y, mask, rng.uniform(),
                        char_degradation, context_degradation,
                        length, name)
            # remainder window (padded & masked, unlike the reference's
            # shape-changing final batch); starts at the end of the
            # last FULL window — 0 for a file shorter than length,
            # which otherwise contributed nothing at all
            i = ((size - 1) // length) * length
            if i < size - 1:
                rem = size - 1 - i
                x = np.zeros((1, length), np.int32)
                y = np.zeros((1, length), np.int32)
                x[0, :rem] = ids[i:size - 1]
                y[0, :rem] = ids[i + 1:size]
                zs = _context_arrays(context, n_contexts, 1)
                mask = np.zeros((1, length), np.float32)
                mask[0, :rem] = 1.0
                yield Batch(x, zs, y, mask, reset_carry=first,
                            file_name=name)
        if not repeat:
            break


def gen_stateful_streams(files: Sequence[str], vocab: Vocab, *,
                         length: int, batch_size: int,
                         repeat: bool = False, n_contexts: int = 1,
                         train: bool = False,
                         char_degradation: float = 0.01,
                         context_degradation: float = 0.1,
                         rng: Optional[np.random.Generator] = None
                         ) -> Iterator[Batch]:
    """Parallel-streams stateful layout: cut each file into
    ``batch_size`` contiguous streams advancing in lockstep; batch t
    holds window t of every stream, carry reset at file boundaries.
    Dense batches with per-stream recurrence (truncated BPTT).
    Train-time degradation follows the per-window extra-batch semantics
    batch-wide, as the batched stateless path does."""
    rng = rng or np.random.default_rng()
    while True:
        for name in files:
            text = read_normalized(name)
            context = context_from_filename(name)
            ids = vocab.encode(text)
            size = len(ids)
            first = True
            for x, y, mask in _stream_windows_numpy(ids, size, batch_size,
                                                    length):
                x = np.ascontiguousarray(x)
                zs = _context_arrays(context, n_contexts, batch_size)
                yield Batch(x, zs, y, mask, reset_carry=first,
                            file_name=name)
                first = False
                if train:
                    yield from _stateful_augment(
                        x, zs, y, mask, rng.uniform(),
                        char_degradation, context_degradation,
                        length, name)
        if not repeat:
            break


def _stream_windows_numpy(ids, size, batch_size, length):
    """Window t of every stream of one file: (x, y, mask), each
    (batch_size, length)."""
    B = max(1, min(batch_size, (size - 1) // (length + 1)))
    stream_len = (size - 1) // B
    # the LAST stream absorbs the (size-1) % B tiling remainder (equal
    # tiling silently dropped up to B-1 trailing chars per file); CEIL
    # includes the masked final partial window
    last_len = (size - 1) - (B - 1) * stream_len
    n_windows = max(-(-last_len // length), 1)
    for w in range(n_windows):
        x = np.zeros((batch_size, length), np.int32)
        y = np.zeros((batch_size, length), np.int32)
        mask = np.zeros((batch_size, length), np.float32)
        for b in range(B):
            end = size - 1 if b == B - 1 else (b + 1) * stream_len
            lo = b * stream_len + w * length
            hi = min(lo + length, end)
            n = hi - lo
            if n <= 0:
                continue
            x[b, :n] = ids[lo:hi]
            y[b, :n] = ids[lo + 1:hi + 1]
            mask[b, :n] = 1.0
        yield x, y, mask


class Prefetcher:
    """Background-thread batch prefetch (double buffering): the host
    builds batch t+1..t+depth while the device runs step t."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._queue: 'queue.Queue' = queue.Queue(maxsize=depth)
        self._error = None
        self._closed = False

        def worker():
            try:
                for item in iterator:
                    while not self._closed:
                        try:
                            self._queue.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._closed:
                        return
            except BaseException as err:  # propagate to consumer
                self._error = err
            finally:
                # the sentinel MUST land (a dropped sentinel deadlocks
                # the consumer in get()); keep trying until the
                # consumer drains a slot or closes
                while not self._closed:
                    try:
                        self._queue.put(self._SENTINEL, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self):
        """Release the worker thread (and the underlying generator)
        when the consumer stops iterating early — without this, a
        break out of the loop left the worker blocked in put()
        forever, pinning the generator for the rest of the process."""
        self._closed = True

    def __iter__(self):
        try:
            while True:
                item = self._queue.get()
                if item is self._SENTINEL:
                    if self._error is not None:
                        raise self._error
                    return
                yield item
        finally:
            self.close()
