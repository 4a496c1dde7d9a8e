"""The LM engine of the port: model loading and saving, training,
scoring, generation and lattice decoding.

Counterpart of the training, scoring and decode parts of
``ocrd_keraslm_tpu/rater.py``.  A ``Rater`` loads an h5 model onto one
device, or trains one there (:meth:`Rater.train`, ``training.py``) and
saves it (:meth:`Rater.save`), and

* scores whole texts (``rate``, ``rate2``, ``rate_batch``, ``test``):
  each text is one stream of a batch, cut into chunks of
  ``SCORE_CHUNK`` steps with the ``(h, c)`` carry threaded from chunk
  to chunk; on CUDA each chunk is one launch of the fused scoring
  kernel (:func:`ocrd_keraslm_torch.ops.score_kernel.score_scan`), or,
  with ``fused_score`` off, one LSTM-scan launch per layer
  (:func:`ocrd_keraslm_torch.models.lstm_lm.forward_seq`);
* generates continuations of prompts by beam search (``generate*``):
  one launch of the beam-step kernel and one of the traceback kernel
  per call (:mod:`ocrd_keraslm_torch.ops.beam_device`), for one prompt
  or a batch, or the generation engine where no layout of the
  kernel takes the model or ``fused_generate`` is off; an empty prompt,
  ``device_beam`` off or a dead fringe take the host engine
  (:mod:`ocrd_keraslm_torch.host_beam`);
* beam-decodes linear lattices of OCR alternatives with the fused
  single-document kernel
  (:func:`ocrd_keraslm_torch.ops.decode_kernel.decode_lattice`): the
  host merges runs of single-alternative edges, fills fixed-size edge
  arrays (in C++, :mod:`ocrd_keraslm_torch.native`, unless
  ``KERASLM_NATIVE=0``), launches one kernel per block of at most 1024
  edges, and walks the returned backpointers; pre-filled array
  lattices (the native page lane) take one launch a page or one for a
  group of consecutive pages.  The beam carries from page to page as
  device tensors ``(packed state (K, S), cost (1, 128))``; each
  result's copy into pinned host memory starts at its launch.  Beam
  widths over 32, alternatives over 64 chars, models that no layout of
  the kernel takes and ``fused_decode`` off decode through the unbounded
  engine (:func:`ops.beam_device.decode_lattice_device`, plain PyTorch
  on the device, the carry ``(h, c, x, cost)``); a document may mix the
  two engines from page to page.

With ``rater.mesh`` set (``ocrd_keraslm_torch.parallel``), training
shards its step over the mesh, and ``rate_batch``, ``rate_best_batch``
and ``generate_batch`` split their rows, documents and streams over its
``data`` axis, every rank of the mesh making the same calls.

The device follows ``KERASLM_PLATFORM`` unless the caller names one:
``cpu`` runs on the CPU (the kernels' plain PyTorch versions), unset,
``gpu`` or ``cuda`` runs on CUDA and raises when there is none.
"""
from __future__ import annotations

import gc
import itertools
import logging
import os
import threading
from collections import OrderedDict
from functools import wraps
from math import exp, log
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.lstm_lm import (DEFAULT_CONTEXTS, LMConfig, embed_inputs,
                             forward_seq, forward_step, host_to_device,
                             init_params, params_from_numpy,
                             require_uniform, zero_carry)
from .ops.beam_device import NEG_INF as ENGINE_BIG
from .ops.beam_device import _copy_to_host, _fetch
from . import native
from .ops.decode_kernel import (BIG, LANE, decode_lattice,
                                decode_lattice_batch, decode_smem_fits,
                                walk_records_batch)
from .ops.score_kernel import pack_score_weights, score_scan
from .utils import h5io, orbaxio
from .utils.buckets import bucket as _bucket
from .utils.buckets import bucket_unbounded as _bucket_unbounded
from .utils.devtrace import span
from .utils.vocab import Vocab, nfc, read_normalized

LOG = logging.getLogger(__name__)

# chunk length of whole-text scoring: a text becomes (n_chunks, CHUNK)
# steps, scored chunk by chunk with the carry threaded between chunks
SCORE_CHUNK = 4096
# chunk-count buckets: texts up to CHUNK * the largest bucket chars go in
# one call, longer ones chain super-blocks through the carry
CHUNK_COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# batch-size buckets of scoring streams and of rolling windows
STEP_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
# scoring batches above this many padded elements split in half
SCORE_SPLIT_LIMIT = 1 << 26

# max chars per merged single-alternative decode run: keeps the shared
# L bucket small
DECODE_MERGE_MAX = 8
# the decode kernel's limits: beam K <= 32 (the K buckets), alternatives
# of at most 64 chars (the L buckets)
FUSED_MAX_BEAM = 32
FUSED_MAX_ALT_LEN = 64
# edge-block buckets: long pages chain blocks of <= 1024 edges through
# the device-resident beam carry
E_BUCKETS = (64, 256, 1024)
L_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# the processor's default beam_width 10 buckets to K = 16
K_BUCKETS = (8, 16, 32)

# process-wide device-resident decode weights, keyed by the loaded model
# file's (path, size, mtime_ns) fingerprint, the device, the context and
# the dtype: a serving loop that builds a new processor (and Rater) for
# every job reuses the weights already staged on the device (see
# Rater._decode_weights).  At most DECODE_WCACHE_SIZE entries, the least
# recently used out first; the lock serialises concurrent Raters.
_DECODE_WCACHE: 'OrderedDict[tuple, dict]' = OrderedDict()
_DECODE_WCACHE_LOCK = threading.Lock()
DECODE_WCACHE_SIZE = 4
# generation requests of the process, numbered for their trace spans
_REQUESTS = itertools.count(1)


def resolve_device(device=None) -> torch.device:
    """The device a ``Rater`` runs on: ``device`` when given, else
    ``KERASLM_PLATFORM`` (``cpu``; unset, ``gpu`` or ``cuda`` mean
    CUDA).  Raises when CUDA is asked for and absent."""
    if device is None:
        platform = (os.environ.get('KERASLM_PLATFORM') or 'cuda').lower()
        if platform == 'cpu':
            return torch.device('cpu')
        if platform not in ('gpu', 'cuda'):
            raise ValueError('KERASLM_PLATFORM=%r: expected cpu, gpu or '
                             'cuda' % platform)
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA was asked for but no CUDA device is '
                           'available; set KERASLM_PLATFORM=cpu (or pass '
                           "device='cpu') to run on the CPU")
    return device


def _gc_paused(fn):
    """Pause the cyclic GC across a hot decode call: lattice prep
    allocates thousands of container objects per page, and every gen-0
    collection would rescan the caller's whole lattice.  Nothing here
    creates reference cycles.  Restores the collector's prior state."""
    @wraps(fn)
    def wrapper(*args, **kwargs):
        if not gc.isenabled():
            return fn(*args, **kwargs)
        gc.disable()
        try:
            return fn(*args, **kwargs)
        finally:
            gc.enable()
    return wrapper


class NonLinearLatticeError(ValueError):
    """A branching (general-DAG) lattice reached a device engine, which
    decodes chains only (one beam round per edge).  The host engine
    (``Rater.rate_best``) takes any DAG; the processor catches this to
    decode such a page there."""


def _spread_labels(points, iters=40):
    """De-overlap 2-D label positions by iterative pairwise repulsion
    (the reference's optional adjustText): labels closer than 2% of the
    plot span push each other apart; the anchor points stay put."""
    pts = np.asarray(points, np.float64).copy()
    if len(pts) < 2:
        return pts
    span = max(float(np.ptp(pts[:, 0])), float(np.ptp(pts[:, 1])),
               1e-9)
    min_d = 0.02 * span
    for _ in range(iters):
        diff = pts[:, None, :] - pts[None, :, :]      # (N, N, 2)
        dist = np.sqrt((diff ** 2).sum(-1))
        np.fill_diagonal(dist, np.inf)
        close = dist < min_d
        if not close.any():
            break
        # unit push away from every too-close neighbour; exactly
        # coincident pairs separate along per-index directions
        with np.errstate(invalid='ignore', divide='ignore'):
            unit = diff / dist[..., None]
        ang = np.linspace(0, 2 * np.pi, len(pts), endpoint=False)
        fallback = np.stack([np.cos(ang), np.sin(ang)], axis=1)
        unit = np.where(np.isfinite(unit), unit,
                        fallback[:, None, :])
        push = (unit * close[..., None]).sum(axis=1)
        norm = np.sqrt((push ** 2).sum(-1, keepdims=True))
        push = np.where(norm > 0, push / np.maximum(norm, 1e-12), 0.0)
        pts = pts + push * (min_d * 0.25)
    return pts


def _pyplot():
    """matplotlib's ``pyplot`` and ``cm``, imported at the plot's call
    (the ``plotting`` extra, not needed anywhere else)."""
    logging.getLogger('matplotlib').setLevel(logging.WARNING)
    try:
        from matplotlib import cm
        from matplotlib import pyplot as plt
    except ImportError as err:
        raise ImportError('the plot commands need matplotlib and '
                          'scikit-learn (the "plotting" extra): %s'
                          % err) from err
    return plt, cm


def _linear_edges(graph):
    """Edge data dicts of a LINEAR lattice (networkx DiGraph) in chain
    order, by a successor-map walk (order does not depend on node
    labels).  Raises :class:`NonLinearLatticeError` for anything but a
    single chain."""
    succ = {}
    tails = set()
    for u, v, d in graph.edges(data=True):
        if u in succ or u == v:
            raise NonLinearLatticeError(
                'device decoding requires a linear lattice, but node %r '
                'has multiple outgoing edges; use rate_best() for general '
                'DAG lattices' % (u,))
        succ[u] = (v, d)
        tails.add(v)
    if not succ:
        return []
    starts = [u for u in succ if u not in tails]
    if len(starts) != 1:
        raise NonLinearLatticeError(
            'device decoding requires a linear lattice (single chain), '
            'but found %d start nodes; use rate_best() for general DAG '
            'lattices' % len(starts))
    node = starts[0]
    out = []
    for _ in range(len(succ)):
        if node not in succ:
            raise NonLinearLatticeError(
                'device decoding requires a linear lattice, but the chain '
                'from %r ends after %d of %d edges (merge node or '
                'disconnected component); use rate_best() for general DAG '
                'lattices' % (starts[0], len(out), len(succ)))
        node, d = succ[node]
        out.append(d)
    return out


def _decode_scan(edges, merge: bool, merge_max: int):
    """(prepared edges, longest alternative in chars, at least 1) of a
    chain of lattice edges after run merging, without building the
    prepared edges: the count :meth:`Rater._prepare_decode_edges` would
    give, over the first 4 alternatives of each edge (those the decode
    arrays keep).  The JAX package's native ``decode_scan``."""
    n_prep, maxlen, run = 0, 1, -1   # run: chars of the open run, -1 none
    for edge in edges:
        alts = edge['alternatives']
        if merge and len(alts) == 1:
            n = len(alts[0].Unicode or '')
            if run >= 0 and run + n <= merge_max:
                run += n
            else:
                n_prep += run >= 0
                run = n
            maxlen = max(maxlen, run)
        else:
            n_prep += (run >= 0) + 1
            run = -1
            for te in alts[:4]:
                maxlen = max(maxlen, len(te.Unicode or ''))
    return n_prep + (run >= 0), maxlen


class _Pinned:
    """A result on the device whose copy into pinned host memory was
    started at its launch (a CPU result is its own host copy)."""
    __slots__ = ('host', 'event')

    def __init__(self, t):
        self.host, self.event = _copy_to_host(t)

    def ready(self) -> bool:
        """Whether reading the copy would not block."""
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        return _fetch(self.host, self.event)


def _host(a) -> np.ndarray:
    """A pending's result on the host (waits for its copy)."""
    return a.numpy() if isinstance(a, _Pinned) else np.asarray(a)


def _scan(edges, merge: bool, merge_max: int):
    """(prepared edges, longest alternative) of an edge chain: the C++
    scan, or with ``KERASLM_NATIVE=0`` :func:`_decode_scan`."""
    out = native.decode_scan(edges, merge, merge_max)
    return tuple(out) if out is not None else \
        _decode_scan(edges, merge, merge_max)


def _longest(edges) -> int:
    """The longest alternative of prepared decode edges, in chars."""
    return max(max((len(ids) for ids in pe['alt_ids']), default=1)
               for pe in edges)


def _alt_steps(alt_mask):
    """Per-edge char-step bound: the longest real alternative at each
    edge.  Exact — steps beyond it are fully masked no-ops.
    ``alt_mask``: (E, A, L) -> (E, 1) int32."""
    return alt_mask.sum(axis=2).max(axis=1).astype(np.int32)[:, None]


# ----------------------------------------------------------------------
# whole-text scoring on the device
# ----------------------------------------------------------------------

def _score_stream(params, cfg: LMConfig, xflat, zs, lens, last, carry,
                  n_chunks: int, packed):
    """Score B streams given in the compact layout: char ids
    ``xflat`` (B, C*T), per-stream lengths ``lens`` (B,) and final
    targets ``last`` (B,), all on the device; the shifted
    teacher-forcing targets and the validity mask are derived here.
    ``zs``: context ids (B,) each; ``packed``: the fused kernel's
    weights (:func:`pack_score_weights`), None for the layered path.
    Returns (probs (C, B, T) float16, NLL sums (B,) float32 in nats,
    final carry)."""
    B, N = xflat.shape
    T = N // n_chunks
    x = xflat.long()
    lens = lens.long()
    y = torch.cat([x[:, 1:], torch.zeros((B, 1), dtype=torch.long,
                                         device=x.device)], dim=1)
    y[torch.arange(B, device=x.device), (lens - 1).clamp(min=0)] = \
        torch.where(lens > 0, last.long(), y[:, 0])
    mask = (torch.arange(N, device=x.device)[None, :] < lens[:, None]) \
        .float()
    return _score_chunks_scan(params, cfg, x.reshape(B, n_chunks, T), zs,
                              y.reshape(B, n_chunks, T),
                              mask.reshape(B, n_chunks, T), carry, packed)


def _score_chunks_scan(params, cfg: LMConfig, xc, zs, yc, maskc, carry,
                       packed):
    """Teacher-forced scoring of C sequential chunks of B streams
    (``xc``, ``yc``, ``maskc``: (B, C, T)), the carry threaded from
    chunk to chunk.  Fused (``packed`` given): one :func:`score_scan`
    launch per chunk after the layer-0 input projection; layered
    (``packed`` None): :func:`forward_seq` (one LSTM scan per layer) and
    a log-softmax.  Per-char probs leave as float16, as in the JAX
    package; NLL sums stay float32."""
    probs, nlls = [], []
    if packed is not None:
        rec1, kcat, ucat, bias, embT, v_real = packed
        lp0 = params['lstm'][0]
        for c in range(xc.shape[1]):
            xp1 = embed_inputs(params, xc[:, c], zs) @ lp0['kernel'] \
                + lp0['bias']
            p, nll, carry = score_scan(
                xp1.contiguous(), yc[:, c].int().contiguous(),
                maskc[:, c].contiguous(), carry[0].contiguous(),
                carry[1].contiguous(), rec1, kcat, ucat, bias, embT,
                v_real)
            probs.append(p.half())
            nlls.append(nll)
    else:
        for c in range(xc.shape[1]):
            logits, carry = forward_seq(params, cfg, xc[:, c], zs, carry)
            tgt = torch.log_softmax(logits, dim=-1).gather(
                -1, yc[:, c, :, None])[..., 0]
            m = maskc[:, c]
            nlls.append(-(tgt * m).sum(dim=-1))
            probs.append(tgt.exp().half() * m.half())
    return torch.stack(probs), torch.stack(nlls).sum(dim=0), carry


def _predict_step(params, cfg: LMConfig, x, zs, h, c):
    """One step of the LSTM stack for a batch of hypotheses on the
    params' device: x (B,) ids, zs context ids (B,) each, h and c
    (D, B, W), all numpy.  Returns numpy (probs (B, V), h2, c2)."""
    dev = params['char_embedding'].device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    with torch.no_grad():
        probs, (h2, c2) = forward_step(
            params, cfg, t(x).long(), [t(z).long() for z in zs],
            (t(h), t(c)))
    return probs.cpu().numpy(), h2.cpu().numpy(), c2.cpu().numpy()


def _window_probs(params, cfg: LMConfig, x, zs):
    """Stateless windowed next-char distribution: x (B, L) -> (B, V)."""
    logits, _ = forward_seq(params, cfg, x, zs, None)
    return torch.softmax(logits[:, -1, :], dim=-1)


class Rater:
    """A character-level LSTM language model for rating text and
    decoding OCR lattices."""

    def __init__(self, logger=None, device=None):
        self.device = resolve_device(device)
        self.width = 0
        self.depth = 0
        self.length = 0
        # AWD-LSTM's keys of LMConfig (models/lstm_lm.py): each layer's
        # width where they differ (then ``width`` is the embedding's),
        # the head bias, the weight drop and the three locked dropouts
        self.widths: Tuple[int, ...] = ()
        self.head_bias = False
        self.weight_drop = 0.0
        self.dropout_input = 0.0
        self.dropout_hidden = 0.0
        self.dropout_output = 0.0
        self.variable_length = True
        self.first_window = 0.1
        self.char_degradation = 0.01
        self.context_degradation = 0.1
        self.stateful = True
        self.incremental = False
        self.contexts: Tuple[Tuple[int, int], ...] = DEFAULT_CONTEXTS
        self.vocab = Vocab()
        self.voc_size = 0
        self.history: Dict[str, Any] = {}
        self.batch_size = 128
        self.validation_split = 0.2
        self.train_streams = True  # parallel-streams stateful training
        self.compute_dtype = 'float32'  # or 'bfloat16' (training)
        # where training writes its best-only checkpoints (also
        # KERASLM_CKPT_DIR; default: the working directory)
        self.ckpt_dir = None
        # a rank mesh (parallel.make_mesh, or the pipeline's
        # make_pipe_mesh): training shards its step over it, and scoring,
        # batch decoding and batch generation split their rows,
        # documents and streams over its data axis (every rank of the
        # mesh makes the same calls)
        self.mesh = None
        # train-state snapshots of every epoch, and the resume from the
        # newest (also KERASLM_RESUME_DIR)
        self.resume_dir = None
        # fused scoring kernel (all layers + tied softmax per chunk) on
        # CUDA, as the JAX package's default on its accelerator; the
        # layered path otherwise (and always above width 384)
        self.fused_score = self.device.type == 'cuda'
        self.merge_runs = True     # merge single-alternative edge runs
        self.device_beam = True    # generation on the device (1 launch)
        # the kernels where they take the shape (the JAX package's
        # defaults on its accelerator), else the unbounded engines of
        # ops/beam_device.py; False: always the engines ('force' also
        # takes gen_beam where no layout of it takes the model)
        self.fused_decode = True
        self.fused_generate = True
        # the JAX package's bf16 decode mode (bf16 emb, embT and wcat in
        # the decode kernels): None, its default, is "on the TPU only", so
        # off here; True or False decide (:meth:`_decode_bf16`)
        self.decode_bf16 = None
        self.logger = logger or LOG
        self.cfg: Optional[LMConfig] = None
        self.params = None
        self.status = 0
        self._decode_cache: Dict[Any, Any] = {}
        # params generation (bumped by _params_changed), and the loaded
        # model file's fingerprint with the generation it holds for: the
        # process-wide decode weights serve only unchanged loaded params
        self._params_epoch = 0
        self._weights_fp: Optional[tuple] = None
        self._fp_epoch = -1
        # (params, their packed score_scan weights)
        self._score_pack: Optional[Tuple[Any, tuple]] = None

    # -- configuration and persistence ---------------------------------

    @property
    def mapping(self):
        return (self.vocab.c2i, self.vocab.i2c)

    @mapping.setter
    def mapping(self, value):
        self.vocab.c2i, self.vocab.i2c = dict(value[0]), dict(value[1])
        self.vocab._mapping_changed()

    def configure(self):
        """Pin the model configuration, and initialise the parameters
        when there are none and the vocabulary is known (weights
        otherwise come from :meth:`load_weights`)."""
        if self.stateful:
            self.variable_length = False
            self.first_window = 0
        self.logger.info('configuring model of depth %d width %d size %d '
                         '(device %s)', self.depth, self.width,
                         self.voc_size, self.device)
        self.cfg = LMConfig(
            width=self.width, depth=self.depth, length=self.length,
            voc_size=max(self.voc_size, 1), contexts=self.contexts,
            stateful=self.stateful, variable_length=self.variable_length,
            compute_dtype=self.compute_dtype, widths=tuple(self.widths),
            head_bias=bool(self.head_bias),
            weight_drop=float(self.weight_drop),
            dropout_input=float(self.dropout_input),
            dropout_hidden=float(self.dropout_hidden),
            dropout_output=float(self.dropout_output))
        if self.params is None and self.voc_size > 0:
            self.params = init_params(
                self.cfg, torch.Generator().manual_seed(42), self.device)
        if self.status < 1:
            self.status = 1

    def reconfigure_for_mapping(self):
        """Rebuild the parameters after the vocabulary grew, keeping the
        old embedding rows and all other weights of a loaded model."""
        if self.status < 1:
            raise RuntimeError('reconfigure_for_mapping needs configure() '
                               'first')
        old_params = self.params
        old_voc = (old_params['char_embedding'].shape[0]
                   if old_params is not None else 0)
        if old_voc >= self.voc_size:
            return
        self.params = None
        self.configure()
        if self.status >= 2 and old_voc > 0:
            self.logger.warning(
                'transferring weights from previous model with only '
                '%d character types', old_voc)
            emb = self.params['char_embedding'].clone()
            emb[:old_voc] = old_params['char_embedding']
            self.params = dict(old_params, char_embedding=emb)
            if 'head_bias' in old_params:
                bias = torch.zeros_like(self.params['char_embedding'][:, 0])
                bias[:old_voc] = old_params['head_bias']
                self.params['head_bias'] = bias
        self._params_changed()

    def _one_width(self, what: str) -> None:
        """Raise ValueError unless the model has the shape ``what`` packs:
        one width for the char embedding and every layer and no head bias
        (the (2D+1)W state of decoding and generation)."""
        if self.cfg is not None:
            require_uniform(self.cfg, what)

    def _params_changed(self):
        """Drop the device-resident weight sets derived from
        ``self.params`` (after a load, vocabulary growth, pruning or
        training)."""
        self._params_epoch += 1
        self._decode_cache.clear()
        self._score_pack = None

    def underspecify_contexts(self) -> List[int]:
        """Default (zero = underspecified) context variable input."""
        self.logger.info('using underspecification (zero) for %d context '
                         'variables', len(self.contexts))
        return [0] * len(self.contexts)

    def load_config(self, filename):
        if self.status != 0:
            raise RuntimeError('load_config needs a fresh Rater')
        if orbaxio.is_orbax_path(filename):
            cfg, vocab, history = orbaxio.load_config(filename)
        else:
            cfg, vocab, history = h5io.load_config(filename)
        self.width = cfg.width
        self.depth = cfg.depth
        self.length = cfg.length
        self.stateful = cfg.stateful
        self.variable_length = cfg.variable_length
        self.contexts = cfg.contexts
        self.widths = cfg.widths
        self.head_bias = cfg.head_bias
        self.weight_drop = cfg.weight_drop
        self.dropout_input = cfg.dropout_input
        self.dropout_hidden = cfg.dropout_hidden
        self.dropout_output = cfg.dropout_output
        self.vocab = vocab
        self.voc_size = vocab.size
        self.history = history

    def load_weights(self, filename):
        if self.status < 1:
            raise RuntimeError('load_weights needs configure() first')
        if orbaxio.is_orbax_path(filename):
            self.params = params_from_numpy(
                orbaxio.load_weights(filename, self.cfg), self.device)
            self._weights_fp = None
        else:
            self.params = params_from_numpy(
                h5io.load_weights(filename, self.cfg), self.device)
            # the h5 file's fingerprint: a new Rater over the same
            # unchanged file reuses the process-wide decode weights
            # (only while its params are untouched since this load)
            try:
                st = os.stat(filename)
                self._weights_fp = (os.path.abspath(filename),
                                    st.st_size, st.st_mtime_ns)
                self._fp_epoch = self._params_epoch + 1
            except OSError:
                self._weights_fp = None
        self.voc_size = self.params['char_embedding'].shape[0]
        self._params_changed()
        self.cfg = self.cfg.replace(voc_size=self.voc_size)
        self.status = 2

    def save(self, filename):
        """Save weights and config: one h5 file, or a model directory
        (``utils/orbaxio.py``) where ``filename`` is a directory or ends
        in ``.orbax``."""
        if self.status < 2:
            raise RuntimeError('save needs trained or loaded weights')
        if orbaxio.is_orbax_path(filename):
            orbaxio.save_model(filename, self.params, self.cfg, self.vocab,
                               self.history)
        else:
            h5io.save_model(filename, self.params, self.cfg, self.vocab,
                            self.history)

    def remove_from_mapping(self, char=None, idx=None) -> bool:
        """Remove one char from the mapping, deleting its embedding row
        (all higher indices move down by one)."""
        if self.status < 2 or self.voc_size <= 0:
            raise RuntimeError('remove_from_mapping needs loaded weights')
        removed = None
        if char is not None and char in self.vocab.c2i:
            removed = self.vocab.c2i[char]
        elif idx is not None and idx in self.vocab.i2c:
            removed = idx
        if removed is None:
            self.vocab.remove(char, idx)  # logs the unmapped error
            return False
        emb = self.params['char_embedding']
        self.logger.warning('pruning character "%s" [%d] with norm %f',
                            char or self.vocab.i2c.get(removed), removed,
                            float(torch.linalg.vector_norm(emb[removed])))
        self.vocab.remove(char, idx)
        self.voc_size -= 1
        self.params = dict(self.params, char_embedding=torch.cat(
            [emb[:removed], emb[removed + 1:]]).contiguous())
        if 'head_bias' in self.params:
            bias = self.params['head_bias']
            self.params['head_bias'] = torch.cat(
                [bias[:removed], bias[removed + 1:]]).contiguous()
        self.cfg = self.cfg.replace(voc_size=self.voc_size)
        self._params_changed()
        return True

    def train(self, data, val_data=None):
        """Train on text files (paths or handles); see
        :func:`ocrd_keraslm_torch.training.train_rater`."""
        from .training import train_rater
        train_rater(self, data, val_data)

    def print_history(self):
        for k, v in self.history.items():
            print(f"{k}: {v}")

    def print_charset(self):
        self.vocab.print_charset()

    # -- whole-text scoring --------------------------------------------

    def _context_arrays(self, context, batch: int) -> Tuple[np.ndarray, ...]:
        """Per-variable context ids (batch,) each; zero (underspecified)
        for variables the context does not give."""
        if not context:
            context = self.underspecify_contexts()
        return tuple(np.full((batch,), context[i] if i < len(context)
                             else 0, np.int32)
                     for i in range(len(self.contexts)))

    def _score_batch(self, ids_list: List[np.ndarray],
                     contexts: List[Any], *, carry=None,
                     want_probs: bool = True
                     ) -> Tuple[List[np.ndarray], List[float], Any]:
        """Score a batch of encoded texts as parallel streams, chunk by
        chunk with the carry threaded between chunks.

        Returns (per-text probs (N_i-1,), per-text NLL sums, carry)."""
        B = len(ids_list)
        Bp = _bucket_unbounded(B, STEP_BUCKETS)
        lens = [max(len(ids) - 1, 0) for ids in ids_list]
        Nmax = max(lens + [1])
        BLOCK = SCORE_CHUNK * CHUNK_COUNT_BUCKETS[-1]
        if Nmax > BLOCK:
            # book-length texts: chain fixed-size super-blocks through
            # the carry (each block slice overlaps one char so targets
            # line up across the boundary)
            parts: List[List[np.ndarray]] = [[] for _ in range(B)]
            nll_tot = [0.0] * B
            cur = carry
            for o in range(0, Nmax, BLOCK):
                sub = [ids[o:o + BLOCK + 1] for ids in ids_list]
                p, n_, cur = self._score_batch(
                    sub, contexts, carry=cur, want_probs=want_probs)
                for i in range(B):
                    nll_tot[i] += n_[i]
                    if want_probs:
                        parts[i].append(p[i])
            return ([np.concatenate(parts[i]) if want_probs else None
                     for i in range(B)], nll_tot, cur)
        C = _bucket((Nmax + SCORE_CHUNK - 1) // SCORE_CHUNK,
                    CHUNK_COUNT_BUCKETS)
        if B > 1 and C * Bp * SCORE_CHUNK > SCORE_SPLIT_LIMIT:
            # bound activation and fetch memory: halve the batch (each
            # half gets its carry rows and hands its final rows back;
            # the carry is reassembled even when the caller passed
            # none, since super-block chaining threads it on)
            mid = B // 2

            def _rows(lo, hi):
                if carry is None:
                    return None
                return carry[0][:, lo:hi], carry[1][:, lo:hi]

            p1, n1, c1 = self._score_batch(
                ids_list[:mid], contexts[:mid], carry=_rows(0, mid),
                want_probs=want_probs)
            p2, n2, c2 = self._score_batch(
                ids_list[mid:], contexts[mid:], carry=_rows(mid, B),
                want_probs=want_probs)
            return p1 + p2, n1 + n2, tuple(
                torch.cat([a[:, :mid], b[:, :B - mid]], dim=1)
                for a, b in zip(c1, c2))
        T = SCORE_CHUNK
        x = np.zeros((Bp, C * T), np.int32)
        lens_a = np.zeros((Bp,), np.int32)
        last = np.zeros((Bp,), np.int32)
        for i, ids in enumerate(ids_list):
            n = lens[i]
            if n <= 0:
                continue
            x[i, :n] = ids[:-1]
            lens_a[i] = n
            last[i] = ids[n]
        zs = []
        under = None
        for k in range(len(self.contexts)):
            zrow = np.zeros((Bp,), np.int32)
            for i, ctx in enumerate(contexts):
                if not ctx:
                    if under is None:  # one log line, one list
                        under = self.underspecify_contexts()
                    ctx = under
                zrow[i] = ctx[k] if k < len(ctx) else 0
            zs.append(zrow)
        dev = self.device
        if carry is None:
            carry = zero_carry(self.cfg, Bp, dev)
        elif carry[0].shape[1] != Bp:
            # batch-row normalization (splitting and chaining callers)
            if carry[0].shape[1] > Bp:
                carry = (carry[0][:, :Bp], carry[1][:, :Bp])
            else:
                pad = torch.zeros((self.depth, Bp - carry[0].shape[1],
                                   self.width), dtype=torch.float32,
                                  device=dev)
                carry = (torch.cat([carry[0], pad], 1),
                         torch.cat([carry[1], pad], 1))
        # the fused kernel is f32-only; at large widths the layered path
        # (hoisted whole-chunk products per layer) is the JAX package's
        # choice too
        fused = (self.fused_score and self.cfg.compute_dtype == 'float32'
                 and self.cfg.width <= 384 and self.cfg.uniform)
        score = _score_stream
        mesh = self.mesh
        if mesh is not None and mesh.shape.get('data', 1) > 1 \
                and Bp % mesh.shape['data'] == 0:
            # the rows split over the mesh's data axis, then gathered
            from .parallel.score import make_sharded_score_step
            score = make_sharded_score_step(mesh)
        probs_d, nll_d, carry = score(
            self.params, self.cfg, torch.from_numpy(x).to(dev),
            [torch.from_numpy(z).to(dev) for z in zs],
            torch.from_numpy(lens_a).to(dev),
            torch.from_numpy(last).to(dev), carry, C,
            self._packed_score_weights() if fused else None)
        nlls = nll_d.cpu().numpy()
        out_probs: List[Any] = [None] * B
        if want_probs:
            probs = probs_d.cpu().numpy().astype(np.float32)  # (C, Bp, T)
            for i in range(B):
                out_probs[i] = probs[:, i, :].reshape(-1)[:lens[i]]
        return out_probs, [float(nlls[i]) for i in range(B)], carry

    def _packed_score_weights(self) -> tuple:
        """The fused scoring kernel's weights, packed once per params
        object (a new ``load_weights`` or a replaced ``params`` packs
        again)."""
        if self._score_pack is None or self._score_pack[0] is not self.params:
            self._score_pack = (self.params,
                                tuple(pack_score_weights(self.params,
                                                         self.cfg)))
        return self._score_pack[1]

    def _score_text(self, ids: np.ndarray, context, *,
                    carry=None) -> Tuple[np.ndarray, float, Any]:
        """Score one encoded text: per-position probability of the true
        next char and total NLL (nats)."""
        if len(ids) < 2:
            return np.zeros((0,), np.float32), 0.0, carry
        probs, nlls, carry = self._score_batch([ids], [context],
                                               carry=carry)
        return probs[0], nlls[0], carry

    def test(self, test_data) -> float:
        """Perplexity = exp(mean NLL) over text files, each file one
        stream with its own carry (reset per file), its context from the
        ``author_title_year`` file name."""
        if self.status < 2:
            raise RuntimeError('test needs loaded weights')
        from .data import context_from_filename
        ids_list, contexts = [], []
        for file in test_data:
            text = read_normalized(file)
            name = getattr(file, 'name', file if isinstance(file, str)
                           else '')
            ids_list.append(self.vocab.encode(text))
            contexts.append(context_from_filename(name or ''))
        if not ids_list:
            return 1.0
        if not self.stateful and not self.variable_length:
            # stateless fixed-window semantics: every char (position 0
            # too, from an all-padding window) is a window target
            nll = 0.0
            count = 0
            for ids, ctx in zip(ids_list, contexts):
                if not len(ids):
                    continue
                probs = self._rolling_window_probs(
                    ids, ctx, include_first=True)
                nll -= float(np.sum(np.log(np.maximum(probs, 1e-30))))
                count += len(probs)
            return exp(nll / max(count, 1))
        nll = 0.0
        count = 0
        for s in range(0, len(ids_list), self.batch_size):
            chunk = ids_list[s:s + self.batch_size]
            _, nlls, _ = self._score_batch(
                chunk, contexts[s:s + self.batch_size], want_probs=False)
            nll += sum(nlls)
            count += sum(max(len(i) - 1, 0) for i in chunk)
        return exp(nll / max(count, 1))

    def rate_batch(self, texts: List[str], contexts=None
                   ) -> List[List[float]]:
        """Per-character probabilities of several texts, scored as the
        parallel streams of one batch; an empty text rates to []."""
        if self.status < 2:
            raise RuntimeError('rate_batch needs loaded weights')
        if contexts is None:
            contexts = [None] * len(texts)
        ids_list = [self.vocab.encode(nfc(t), log_unmapped=True)
                    for t in texts]
        if not self.stateful and not self.variable_length:
            return [([1.0] + [float(p) for p in
                              self._rolling_window_probs(ids, ctx)])
                    if len(ids) else []
                    for ids, ctx in zip(ids_list, contexts)]
        probs, _, _ = self._score_batch(ids_list, list(contexts))
        return [([1.0] + [float(p) for p in pr]) if len(ids) else []
                for pr, ids in zip(probs, ids_list)]

    def rate(self, text: str, context=None) -> List[float]:
        """Probability of each character given its predecessors (the
        first is 1.0).  Stateless fixed-length models score each char
        from its (at most) ``length``-char zero-padded window; stateful
        and variable-length models scan the whole text."""
        if self.status < 2:
            raise RuntimeError('rate needs loaded weights')
        text = nfc(text)
        if not text:
            return []
        ids = self.vocab.encode(text, log_unmapped=True)
        if not self.stateful and not self.variable_length:
            probs = self._rolling_window_probs(ids, context)
        else:
            probs, _, _ = self._score_text(ids, context)
        return [1.0] + [float(p) for p in probs]

    def rate2(self, text: str, context=None
              ) -> Tuple[List[Tuple[str, float]], float]:
        """Per-character probabilities and the base-2 perplexity; for
        stateful and variable-length models the entropy comes from the
        f32 NLL sum (the float16 probs only feed the per-char values)."""
        if self.status < 2:
            raise RuntimeError('rate2 needs loaded weights')
        text = nfc(text)
        if not text:
            return [], 1.0
        ids = self.vocab.encode(text, log_unmapped=True)
        result = [(text[0], 1.0)]
        if self.stateful or self.variable_length:
            probs, nll, _ = self._score_text(ids, context)
            entropy = nll * 1.4426950408889634
            for i in range(1, len(text)):
                result.append((text[i], float(probs[i - 1])))
            return result, pow(2.0, entropy / len(text))
        probs = self._rolling_window_probs(ids, context)
        entropy = 0.0
        for i in range(1, len(text)):
            p = float(probs[i - 1])
            entropy -= log(max(p, 1e-99), 2)
            result.append((text[i], p))
        return result, pow(2.0, entropy / len(text))

    def _rolling_window_probs(self, ids: np.ndarray, context, *,
                              include_first: bool = False) -> np.ndarray:
        """Next-char probs of a stateless fixed-length model from
        zero-left-padded rolling windows of ``length`` chars, with the
        context ids zero at the padded positions.  ``include_first``
        also scores position 0 from an all-padding window."""
        N = len(ids)
        L = self.length
        first = 0 if include_first else 1
        M = N - first
        windows = np.zeros((M, L), np.int32)
        valid = np.zeros((M, L), np.int32)
        for i in range(first, N):
            lo = max(0, i - L)
            windows[i - first, L - (i - lo):] = ids[lo:i]
            valid[i - first, L - (i - lo):] = 1
        if not context:
            context = self.underspecify_contexts()
        out = np.zeros((M,), np.float32)
        B = self.batch_size
        dev = self.device
        for s in range(0, M, B):
            n = min(B, M - s)
            nb = _bucket(n, STEP_BUCKETS)
            x = np.zeros((nb, L), np.int64)
            x[:n] = windows[s:s + n]
            v = np.zeros((nb, L), np.int64)
            v[:n] = valid[s:s + n]
            zs = [torch.from_numpy(
                v * (int(context[k]) if k < len(context) else 0)).to(dev)
                for k in range(len(self.contexts))]
            probs = _window_probs(self.params, self.cfg,
                                  torch.from_numpy(x).to(dev), zs)
            out[s:s + n] = probs.cpu().numpy()[
                np.arange(n), ids[first + s:first + s + n]]
        return out

    # -- generation -----------------------------------------------------

    def generate(self, prefix: str, length: int, context=None,
                 variants: int = 1) -> List[str]:
        """The ``variants`` most probable continuations of ``prefix`` by
        ``length`` chars, each with prefix[-1] in front (reference
        rating.py:642-709): beam search with per-step top-10 candidates,
        absolute probability threshold 0.004, fringe capped at 256.  On
        the device in one launch unless ``device_beam`` is off or the
        prefix is empty; a dead device fringe retries on the host."""
        self._one_width('generation')
        if self.status < 2:
            raise RuntimeError('generate needs loaded weights')
        with span('gen.request', 'request=%d' % next(_REQUESTS)):
            if self.device_beam and prefix:
                from .ops.beam_device import generate_beam
                result = generate_beam(self, prefix, length, context,
                                       variants)
                if result:
                    return result
            return self._generate_host(prefix, length, context, variants)

    def generate_begin(self, prefix: str, length: int, context=None,
                       variants: int = 1):
        """Queue a generation; :meth:`generate_finish` later waits for
        it and builds the strings, so a serving loop can queue the next
        prompt first.  begin + finish = :meth:`generate`."""
        self._one_width('generation')
        if self.status < 2:
            raise RuntimeError('generate needs loaded weights')
        if self.device_beam and prefix:
            from .ops.beam_device import generate_beam_begin
            return generate_beam_begin(self, prefix, length, context,
                                       variants)
        return ('gen-host', (self, prefix, length, context, variants))

    def generate_finish(self, pending) -> List[str]:
        """The strings of a :meth:`generate_begin` request."""
        if pending[0] != 'gen-host':
            from .ops.beam_device import generate_beam_finish
            result = generate_beam_finish(pending)
            if result:
                return result
            _, prefix, length, variants, ctx = pending[-1]
            return self._generate_host(prefix, length, ctx, variants)
        _, (_, prefix, length, context, variants) = pending
        return self._generate_host(prefix, length, context, variants)

    def generate_batch(self, prefixes: List[str], length: int,
                       context=None) -> List[str]:
        """The best continuation of each prefix, all streams in ONE
        launch of the beam-step kernel; each equals ``generate(prefix,
        length)[0]``.  A stream whose device fringe died retries on the
        host ('' when it dies there too)."""
        return self.generate_batch_finish(
            self.generate_batch_begin(prefixes, length, context))

    def generate_batch_begin(self, prefixes: List[str], length: int,
                             context=None):
        """Queue a prompt batch; :meth:`generate_batch_finish` later
        waits for it and builds the strings."""
        self._one_width('generation')
        if self.status < 2:
            raise RuntimeError('generate needs loaded weights')
        if self.device_beam and all(prefixes):
            from .ops.beam_device import generate_streams_begin
            return generate_streams_begin(self, prefixes, length, context)
        return ('gen-host-batch', (prefixes, length, context))

    def generate_batch_finish(self, pending) -> List[str]:
        """The strings of a :meth:`generate_batch_begin` request; the
        streams that came back empty take the host engine."""
        if pending[0] == 'gen-host-batch':
            _, (prefixes, length, context) = pending
            result = None
        else:
            from .ops.beam_device import generate_streams_finish
            result = generate_streams_finish(pending)
            _rater, prefixes, length, context = pending[-1]
            if result and all(result):
                return result
        out = []
        for s, p in enumerate(prefixes):
            if result and result[s]:
                out.append(result[s])
                continue
            r = self._generate_host(p, length, context, 1)
            out.append(r[0] if r else '')
        return out

    def _generate_host(self, prefix: str, length: int, context=None,
                       variants: int = 1) -> List[str]:
        """Generation on the host (:func:`host_beam.generate_host`)."""
        self._one_width('generation')
        if self.status < 2:
            raise RuntimeError('generate needs loaded weights')
        from .host_beam import generate_host
        return generate_host(self, prefix, length, context, variants)

    # -- incremental engine ---------------------------------------------

    def predict(self, candidates, initial_states, context=None
                ) -> Tuple[List[np.ndarray], List[List[np.ndarray]]]:
        """One-character step for N parallel hypotheses with explicit
        per-layer (h1, c1, h2, c2, ...) states in and out (the
        reference's ``predict``): all hypotheses run as ONE
        :func:`_predict_step` on the rater's device, the batch padded to
        a ``STEP_BUCKETS`` bucket (unbounded: more than 512 hypotheses
        are not cut)."""
        self._one_width('the decode step')
        if self.status < 2:
            raise RuntimeError('predict needs loaded weights')
        if len(candidates) != len(initial_states):
            raise ValueError('number of inputs (%d) and number of states '
                             '(%d) inconsistent' % (len(candidates),
                                                    len(initial_states)))
        if not context:
            context = self.underspecify_contexts()
        n = len(candidates)
        nb = _bucket_unbounded(n, STEP_BUCKETS)
        D, W = self.depth, self.width
        x = np.zeros((nb,), np.int32)
        for i, char in enumerate(candidates):
            x[i] = self.vocab.get(char)
        h = np.zeros((D, nb, W), np.float32)
        c = np.zeros((D, nb, W), np.float32)
        for i, state in enumerate(initial_states):
            if not state:
                continue
            for layer in range(D):
                h[layer, i] = np.asarray(state[2 * layer]).reshape(W)
                c[layer, i] = np.asarray(state[2 * layer + 1]).reshape(W)
        zs = self._context_arrays(context, nb)
        probs, h2, c2 = _predict_step(self.params, self.cfg, x, zs, h, c)
        preds = [probs[i] for i in range(n)]
        final_states = [
            [h2[layer, i:i + 1] if kind == 0 else c2[layer, i:i + 1]
             for layer in range(D) for kind in (0, 1)]
            for i in range(n)]
        return preds, final_states

    # -- lattice decoding on the host -----------------------------------

    @_gc_paused
    def rate_best(self, graph, start_node, end_node, start_traceback=None,
                  context=None, lm_weight=0.5, beam_width=10,
                  beam_clustering_dist=0):
        """Best-path beam decode over a lattice of string alternatives,
        any DAG with one source and one sink, by the host engine
        (:func:`host_beam.decode_lattice_host`): hypothesis batches run as
        single device steps, the beam's bookkeeping on the host.  The
        processor's engine for ``device_decoding=false`` and for
        branching pages.  Returns ``([(element, textequiv, score), ...],
        entropy, traceback)``: the path locked in by this call (one page
        behind, see :meth:`next_path`)."""
        self._one_width('lattice decoding')
        if self.status < 2:
            raise RuntimeError('rate_best needs loaded weights')
        from .host_beam import decode_lattice_host
        return decode_lattice_host(
            self, graph, start_node, end_node,
            start_traceback=start_traceback, context=context,
            lm_weight=lm_weight, beam_width=beam_width,
            clustering_dist=beam_clustering_dist)

    def next_path(self, beam, traceback):
        """Lock into the previous page's best path and advance the
        traceback (:func:`host_beam.advance_traceback`); with an empty
        previous beam, the best hypothesis is flushed completely (the
        document's end)."""
        from .host_beam import advance_traceback
        return advance_traceback(beam, traceback)

    # -- decode weights and beam carry ---------------------------------

    def _decode_bf16(self) -> bool:
        """Whether the decode kernels take bf16 weights (the JAX
        package's ``decode_bf16`` mode: emb, embT and wcat in bf16, the
        state and every cost in f32).  ``None`` (the default) means what
        it means in the JAX package, on by default on the TPU only, where
        it gives the f32 mode's bits: so off here.  On the card the mode
        changes results (real f32 products against bf16 ones), so it is
        opt-in: ``rater.decode_bf16 = True``.  Generation is f32
        whatever the flag says."""
        return bool(self.decode_bf16)

    def _decode_weights(self, context, bf16=False):
        """Decode weight set on the device: vocab-padded embedding and
        its transpose, per-layer fused ``[kernel; recurrent]`` (D, 2W, 4W)
        and biases (D, 1, 4W) with the page-constant context embedding
        folded into layer 0.  ``bf16`` (the bf16 decode mode) casts emb,
        embT and wcat to bfloat16; the biases stay f32.  Cached per
        context and dtype (at most 4 sets a Rater), and process-wide
        (``_DECODE_WCACHE``) while the params are those loaded from an
        unchanged h5 file."""
        ctx = tuple(context or self.underspecify_contexts())
        key = (ctx, bool(bf16))
        cached = self._decode_cache.get(key)
        if cached is not None:
            return cached
        mkey = None
        if self._weights_fp is not None and \
                self._params_epoch == self._fp_epoch:
            mkey = (self._weights_fp, self.device.type, self.device.index,
                    ctx, bool(bf16))
            with _DECODE_WCACHE_LOCK:
                hit = _DECODE_WCACHE.get(mkey)
                if hit is not None:
                    _DECODE_WCACHE.move_to_end(mkey)
            if hit is not None:
                self._cache_decode_weights(key, hit)
                return hit
        W, D, V = self.width, self.depth, self.voc_size
        V_pad = max(128, -(-V // 128) * 128)
        params = self.params
        emb = torch.zeros((V_pad, W), dtype=torch.float32,
                          device=self.device)
        emb[:V] = params['char_embedding']
        # an index beyond a context table reads its last row, as the
        # JAX package's gather does
        tables = params['context_embeddings']
        ctx_vec = torch.cat(
            [tables[i][min(ctx[i] if i < len(ctx) else 0,
                           len(tables[i]) - 1)]
             for i in range(len(self.contexts))]) if self.contexts \
            else torch.zeros((0,), device=self.device)
        wcats, biases = [], []
        for d in range(D):
            lp = params['lstm'][d]
            kernel, bias = lp['kernel'], lp['bias']
            if d == 0 and kernel.shape[0] > W:
                bias = bias + ctx_vec @ kernel[W:]
                kernel = kernel[:W]
            wcats.append(torch.cat([kernel, lp['recurrent']], 0))
            biases.append(bias)
        wdt = torch.bfloat16 if bf16 else torch.float32
        weights = dict(emb=emb.to(wdt), embT=emb.T.contiguous().to(wdt),
                       wcat=torch.stack(wcats).contiguous().to(wdt),
                       bias=torch.stack(biases)[:, None, :].contiguous(),
                       v_pad=V_pad, v_real=V)
        self._cache_decode_weights(key, weights)
        if mkey is not None:
            with _DECODE_WCACHE_LOCK:
                _DECODE_WCACHE[mkey] = weights
                _DECODE_WCACHE.move_to_end(mkey)
                while len(_DECODE_WCACHE) > DECODE_WCACHE_SIZE:
                    _DECODE_WCACHE.popitem(last=False)
        return weights

    def _cache_decode_weights(self, key, weights):
        """Keep a decode weight set in this Rater's cache of 4 (the
        oldest out first)."""
        while len(self._decode_cache) >= 4:
            del self._decode_cache[next(iter(self._decode_cache))]
        self._decode_cache[key] = weights

    def _fused_traceback(self, tb, K, emb):
        """The beam carry for a page decoded at beam ``K``: a fresh beam
        (all rows at the newline embedding, only slot 0 alive) when
        ``tb`` is None, else the previous page's ``(state, cost)`` with
        the beam narrowed (best K slots kept — the carry is rank
        ordered) or widened (dead zero rows appended).  The engine's
        carry ``(h, c, x, cost)`` is packed first (its best ``LANE``
        slots where it holds more).  The packed state is f32 whatever the
        weights' dtype: a bf16 ``emb`` (the bf16 decode mode) is widened
        exactly."""
        D, W = self.depth, self.width
        emb = emb.float()
        if tb is None:
            state = torch.zeros((K, (2 * D + 1) * W), dtype=torch.float32,
                                device=self.device)
            state[:, :W] = emb[self.vocab.get('\n')]
            cost = torch.full((1, LANE), BIG, dtype=torch.float32,
                              device=self.device)
            cost[0, 0] = 0.0
            return state, cost
        if len(tb) == 4:
            h, c, x, cost4 = (a[:, :LANE] if a.dim() == 3 else a[:LANE]
                              for a in tb)
            K0 = h.shape[1]
            state = torch.cat([emb[x.long()]] + [h[d] for d in range(D)]
                              + [c[d] for d in range(D)], 1).float()
            cost = torch.full((1, LANE), BIG, dtype=torch.float32,
                              device=state.device)
            cost[0, :K0] = torch.where(cost4 >= 1.0e37, BIG, cost4)
            tb = (state, cost)
        state, cost = tb
        K0 = state.shape[0]
        if K0 == K:
            return state, cost
        if K0 > K:
            lane = torch.arange(LANE, device=cost.device)
            return (state[:K].contiguous(),
                    torch.where(lane[None, :] < K, cost,
                                torch.full_like(cost, BIG)))
        pad = torch.zeros((K - K0, state.shape[1]), dtype=state.dtype,
                          device=state.device)
        return torch.cat([state, pad]), cost

    # -- lattice decoding ----------------------------------------------

    def rate_best_device(self, graph, start_node, end_node,
                         device_traceback=None, context=None,
                         lm_weight=0.5, beam_width=10):
        """Synchronous decode of one linear lattice: dispatch + fetch +
        emit.  Returns (path [(element, textequiv, score)], entropy,
        new device traceback)."""
        pending, tb = self.rate_best_device_begin(
            graph, start_node, end_node,
            device_traceback=device_traceback, context=context,
            lm_weight=lm_weight, beam_width=beam_width)
        path, entropy = self.rate_best_device_finish(pending)
        return path, entropy, tb

    @_gc_paused
    def rate_best_device_begin(self, graph, start_node, end_node,
                               device_traceback=None, context=None,
                               lm_weight=0.5, beam_width=10,
                               defer_walk=False):
        """Prepare and launch the decode of a linear lattice (an edge
        list in chain order, or a networkx DiGraph that is one chain);
        returns ``(pending, new device traceback)``.  Fetch and path
        emission happen in :meth:`rate_best_device_finish`, so a
        document loop can launch every page before it waits for any.

        With ``defer_walk`` a single-block page also returns its
        per-slot records (pending kind ``'blocks'``) instead of the
        kernel's own rank-0 walk: lookahead write-back walks the pages
        later, in reverse, from chained entry slots."""
        self._one_width('lattice decoding')
        edges_raw = graph if isinstance(graph, list) \
            else _linear_edges(graph)
        if not edges_raw:
            return ('done', [], 0.0), device_traceback
        if not self.fused_decode or beam_width > FUSED_MAX_BEAM:
            return self._rate_best_engine(edges_raw, device_traceback,
                                          context, lm_weight, beam_width,
                                          defer_walk=defer_walk)
        return self._rate_best_kernel(edges_raw, device_traceback,
                                      context, lm_weight, beam_width,
                                      defer_walk=defer_walk)

    def _rate_best_kernel(self, edges_raw, device_traceback, context,
                          lm_weight, beam_width, defer_walk=False):
        """Kernel decode dispatch (the counterpart of the JAX
        ``_rate_best_pallas``): run merging, array fill and one kernel
        launch per block of at most 1024 edges, the carry chaining on
        the device.  The prep runs in C++ (``native.decode_scan`` and
        ``decode_fill``: the whole document filled once, sliced per
        block), or with ``KERASLM_NATIVE=0`` in Python
        (:meth:`_prepare_decode_edges`, :meth:`_fill_decode_arrays` per
        block).  Single-block pages walk their backpointers inside the
        kernel and return (E+1, 2) unless ``defer_walk``; longer pages
        return per-block records, walked on the host at finish.  Every
        result's copy to pinned host memory starts at its launch.
        Alternatives over 64 chars, and shapes that no layout of the
        kernel lays out in a block's shared memory
        (:func:`ops.decode_kernel.decode_smem_fits`), take the engine
        (:meth:`_rate_best_engine`)."""
        K = _bucket(min(beam_width, FUSED_MAX_BEAM), K_BUCKETS)
        A = 4
        E_MAX = E_BUCKETS[-1]
        scan = native.decode_scan(edges_raw, self.merge_runs,
                                  DECODE_MERGE_MAX)
        edges = None
        if scan is None:
            edges = self._prepare_decode_edges(edges_raw)
            nE = len(edges)
            maxlen = _longest(edges)
        else:
            nE, maxlen = scan
        L = _bucket(max(maxlen, 1), L_BUCKETS)
        if not self._kernel_fits(maxlen, L, K):
            self.logger.info(
                'decode kernel unavailable (alternative of %d chars > %d, '
                'or no layout of the model fits a block): using the '
                'unbounded engine', maxlen, FUSED_MAX_ALT_LEN)
            return self._rate_best_engine(edges_raw, device_traceback,
                                          context, lm_weight, beam_width,
                                          defer_walk=defer_walk,
                                          edges=edges)
        full = None
        if scan is not None:
            # a document of several blocks pads to a multiple of E_MAX,
            # so every block slices to E_MAX rows (padding: free edges)
            E_full = (_bucket(nE, E_BUCKETS) if nE <= E_MAX
                      else -(-nE // E_MAX) * E_MAX)
            edges, *full = native.decode_fill(
                edges_raw, self.merge_runs, DECODE_MERGE_MAX, E_full, A, L,
                self.vocab._table())
        wts = self._decode_weights(context, bf16=self._decode_bf16())
        state, cost = self._fused_traceback(device_traceback, K,
                                            wts['emb'])
        single = nE <= E_MAX and not defer_walk
        packed_blocks = []
        for lo in range(0, nE, E_MAX):
            n_blk = min(E_MAX, nE - lo)
            if full is not None:
                E = E_full if nE <= E_MAX else E_MAX
                arrays = [a[lo:lo + E] for a in full]
            else:
                arrays = self._fill_decode_arrays(
                    edges[lo:lo + E_MAX], _bucket(n_blk, E_BUCKETS), A, L)
            packed, state, cost = self._launch_decode(
                wts, arrays, state, cost, lm_weight, single, n_blk)
            packed_blocks.append(_Pinned(packed))
        return (('single' if single else 'blocks'), edges, packed_blocks,
                K), (state, cost)

    def _kernel_fits(self, maxlen, L, K):
        """Whether ``decode_lattice`` takes alternatives of ``maxlen``
        chars (bucket ``L``) at beam ``K`` for this model: at most 64
        chars, and a layout within a block's shared memory."""
        Vp = max(128, -(-self.voc_size // 128) * 128)
        return maxlen <= FUSED_MAX_ALT_LEN and decode_smem_fits(
            4, L, K, self.depth, self.width, Vp, self.voc_size)

    def _rate_best_engine(self, edges_raw, device_traceback, context,
                          lm_weight, beam_width, defer_walk=False,
                          edges=None):
        """Engine decode dispatch (the counterpart of the JAX package's
        XLA path): :func:`ops.beam_device.decode_lattice_device` per
        block of at most 1024 edges, at K = the beam width's bucket (up
        to 512) and alternatives of any length, the carry ``(h, c, x,
        cost)`` chaining on the device.  A single block walks on the
        device (``'single'``) unless ``defer_walk``; longer pages and
        lookahead keep per-block records (``'blocks'``).  Blocks hold
        exactly their edges (no padding edges: they would leave the live
        slots as they are)."""
        if edges is None:
            edges = self._prepare_decode_edges(edges_raw)
        K = _bucket(beam_width, STEP_BUCKETS)
        A = 4
        E_MAX = E_BUCKETS[-1]
        L = _bucket_unbounded(max(_longest(edges), 1), L_BUCKETS)
        h, c, x, cost = self._engine_traceback(device_traceback, K)
        nE = len(edges)
        single = nE <= E_MAX and not defer_walk
        packed_blocks = []
        for lo in range(0, nE, E_MAX):
            block = edges[lo:lo + E_MAX]
            packed, h, c, x, cost = self._launch_engine(
                self._fill_decode_arrays(block, len(block), A, L), context,
                (h, c, x, cost), lm_weight, single)
            packed_blocks.append(_Pinned(packed))
        return (('single' if single else 'blocks'), edges, packed_blocks,
                K), (h, c, x, cost)

    def _launch_engine(self, arrays, context, carry, lm_weight,
                       device_walk):
        """One :func:`ops.beam_device.decode_lattice_device` call over
        host arrays ``(chars, mask, conf, valid)``, with or without a
        leading document axis (uploaded through pinned memory); returns
        (packed, h, c, x, cost)."""
        from .ops.beam_device import decode_lattice_device
        mask = arrays[1]
        # the most char steps of an edge over the documents
        steps = _alt_steps(mask.reshape((-1,) + mask.shape[-3:])
                           .max(axis=0))[:, 0].tolist()
        dev = self.device
        return decode_lattice_device(
            self.params, self.cfg,
            *(host_to_device(torch.from_numpy(np.ascontiguousarray(a)), dev)
              for a in arrays),
            self._context_arrays(context, 1), *carry, float(lm_weight),
            device_walk=device_walk, steps=steps)

    def _engine_traceback(self, tb, K):
        """The beam carry in the engine's format ``(h (D, K, W), c, x
        (K,), cost (K,))`` with empty slots at 3e38: a fresh beam (only
        slot 0 alive, every x the newline) when ``tb`` is None; the
        kernel's ``(state, cost)`` unpacked (the JAX package's
        ``_xla_traceback``: x is the char whose embedding row the state's
        xemb is, exactly, found by the nearest row in float64); the beam
        narrowed (best K slots kept, the carry is rank ordered) or widened
        (dead slots appended).  Under the bf16 decode mode the kernel
        wrote bf16 embedding values, so x is found against the table
        rounded to bf16 (the distance is then exactly 0 at the true row),
        as in the JAX package; the engine itself stays f32."""
        D, W = self.depth, self.width
        dev = self.device
        if tb is None:
            h = torch.zeros((D, K, W), dtype=torch.float32, device=dev)
            x = torch.full((K,), self.vocab.get('\n'), dtype=torch.int32,
                           device=dev)
            cost = torch.full((K,), ENGINE_BIG, dtype=torch.float32,
                              device=dev)
            cost[0] = 0.0
            return h, h.clone(), x, cost
        if len(tb) == 2:
            state, cost_l = tb
            K0 = state.shape[0]
            h = torch.stack([state[:, (1 + d) * W:(2 + d) * W]
                             for d in range(D)])
            c = torch.stack([state[:, (1 + D + d) * W:(2 + D + d) * W]
                             for d in range(D)])
            emb = self.params['char_embedding']
            if self._decode_bf16():
                emb = emb.to(torch.bfloat16)
            emb = emb.double()
            xemb = state[:, :W].double()
            d2 = (emb * emb).sum(1)[None, :] - 2.0 * (xemb @ emb.T)
            x = torch.argmin(d2, dim=1).int()
            cost = cost_l[0, :K0]
            tb = (h, c, x, torch.where(cost >= 1.0e29, ENGINE_BIG, cost))
        h, c, x, cost = tb
        K0 = h.shape[1]
        if K0 >= K:
            return h[:, :K], c[:, :K], x[:K], cost[:K]
        pad = K - K0
        zeros = torch.zeros((D, pad, W), dtype=h.dtype, device=h.device)
        return (torch.cat([h, zeros], 1), torch.cat([c, zeros], 1),
                torch.cat([x, torch.zeros((pad,), dtype=x.dtype,
                                          device=x.device)]),
                torch.cat([cost, torch.full((pad,), ENGINE_BIG,
                                            dtype=cost.dtype,
                                            device=cost.device)]))

    def _launch_decode(self, wts, arrays, state, cost, lm_weight,
                       device_walk, n_real):
        """One ``decode_lattice`` launch over host arrays ``(chars,
        mask, conf, valid)`` of one block (uploaded through pinned
        memory, without blocking); returns (packed, state, cost)."""
        chars, mask, conf, valid = arrays
        L = chars.shape[2]
        dev = self.device
        steps = _alt_steps(mask)[:, 0] if L > 1 else None
        return decode_lattice(
            wts['emb'], wts['embT'], wts['wcat'], wts['bias'],
            *(host_to_device(torch.from_numpy(np.ascontiguousarray(a)), dev)
              for a in (chars, mask, conf, valid)),
            state, cost, lm_weight=float(lm_weight), v_real=wts['v_real'],
            device_walk=device_walk,
            alt_steps=(None if steps is None else
                       host_to_device(torch.from_numpy(steps), dev)),
            n_real=int(n_real))

    @_gc_paused
    def fetch_pendings(self, pendings, prefetched=False):
        """Pendings with every result on the host (numpy): each
        result's copy into pinned memory started at its launch, so this
        waits on each copy's event in turn.  ``prefetched`` is accepted
        for the JAX package's signature; it changes nothing here."""
        out = []
        for p in pendings:
            if p[0] == 'done':
                out.append(p)
                continue
            p = list(p)
            p[2] = [_host(a) for a in p[2]]
            out.append(tuple(p))
        return out

    @_gc_paused
    def rate_best_device_finish(self, pending, start_slot=0,
                                return_entry=False):
        """Fetch + backpointer walk + path emission for a pending decode
        (see :meth:`rate_best_device_begin`).  Returns (path, entropy).

        ``start_slot``/``return_entry`` serve lookahead write-back
        (pages walked in reverse with chained entry slots): the walk
        starts at final slot ``start_slot`` and, with ``return_entry``,
        the result is ``((path, entropy), entry slot)``.  They need the
        records (``defer_walk=True`` at begin)."""
        if pending[0] == 'done':
            out = pending[1], pending[2]
            return (out, int(start_slot)) if return_entry else out
        kind, edges, packed_blocks, K = pending
        nE = len(edges)
        if kind == 'single':
            if start_slot != 0 or return_entry:
                raise ValueError(
                    'device-walked pending has no per-slot records: '
                    'dispatch with defer_walk=True for lookahead')
            packed = _host(packed_blocks[0])
            return self._emit_path(edges, packed[1:nE + 1, 0]
                                   .astype(np.int32),
                                   packed[1:nE + 1, 1],
                                   float(packed[0, 0]))
        all_rows = []
        start_cost = start_costs = None
        for packed in packed_blocks:
            packed = _host(packed)
            if start_cost is None:
                start_cost = float(packed[0, 0])
                # per-slot initial-beam costs (header's cost third): the
                # walk anchors at the slot it entered through
                start_costs = np.asarray(packed[0, 2 * K:3 * K],
                                         np.float64)
            all_rows.append(packed[1:])
        return self._walk_traceback(edges, all_rows, K, E_BUCKETS[-1],
                                    start_cost, start_slot=start_slot,
                                    return_entry=return_entry,
                                    start_costs=start_costs)

    # -- array lattices: the native page lane and page groups ----------

    def fused_gate_arrays(self, n_prep, maxlen, beam_width):
        """(E, L) buckets when one ``decode_lattice`` launch can serve
        an array lattice of ``n_prep`` prepared edges whose longest
        alternative has ``maxlen`` chars, else None (the processor then
        takes the record lane).  The card's gate: one block of edges,
        the kernel's beam and alternative limits, and a layout whose
        shared memory fits a block's
        (:func:`ops.decode_kernel.decode_smem_fits`)."""
        if n_prep <= 0 or not self.fused_decode or \
                beam_width > FUSED_MAX_BEAM or n_prep > E_BUCKETS[-1]:
            return None
        L = _bucket(max(maxlen, 1), L_BUCKETS)
        K = _bucket(min(beam_width, FUSED_MAX_BEAM), K_BUCKETS)
        if not self._kernel_fits(maxlen, L, K):
            return None
        return _bucket(n_prep, E_BUCKETS), L

    @_gc_paused
    def rate_best_device_begin_arrays(self, n_prep, E, L, alt_chars,
                                      alt_mask, alt_conf, alt_valid,
                                      device_traceback=None, context=None,
                                      lm_weight=0.5, beam_width=10):
        """One ``decode_lattice`` launch over a pre-filled array lattice
        (the native page lane, ``wrapper/page_native.py``), walked on
        the device; same carry and pending protocol as
        :meth:`rate_best_device_begin`.  The caller reads choices and
        costs with :meth:`rate_best_device_finish_arrays`."""
        self._one_width('lattice decoding')
        K = _bucket(min(beam_width, FUSED_MAX_BEAM), K_BUCKETS)
        wts = self._decode_weights(context, bf16=self._decode_bf16())
        state, cost = self._fused_traceback(device_traceback, K,
                                            wts['emb'])
        packed, state, cost = self._launch_decode(
            wts, (alt_chars, alt_mask, alt_conf, alt_valid), state, cost,
            lm_weight, True, n_prep)
        return ('arrays', n_prep, [_Pinned(packed)], K), (state, cost)

    @staticmethod
    def rate_best_device_finish_arrays(pending):
        """(choices, costs, start_cost) of an ``'arrays'`` pending."""
        _, n_prep, packed_blocks, _ = pending
        packed = _host(packed_blocks[0])
        return (packed[1:n_prep + 1, 0].astype(np.int64),
                np.asarray(packed[1:n_prep + 1, 1], np.float64),
                float(packed[0, 0]))

    @_gc_paused
    def rate_best_device_begin_arrays_group(self, segs,
                                            device_traceback=None,
                                            context=None, lm_weight=0.5,
                                            beam_width=10):
        """Decode several consecutive pages in ONE ``decode_lattice``
        launch: the pages of a document form one linear lattice.

        ``segs``: per page ``(n_prep, chars, mask, conf, valid)`` with
        arrays of at least ``n_prep`` rows at a common A and L (the
        caller sizes the group to one block, :meth:`fused_group_fits`).
        The launch takes the concatenated real edges with
        ``device_walk=False`` and ``n_real`` set to their count.
        Returns ``(group pending, traceback)``; per-page results come
        from :meth:`rate_best_device_finish_group`.

        Bit-identical to per-page launches: the kernel's per-edge work
        does not depend on the E bucket (pad edges are skipped), the
        beam carry flows through the concatenated edges as it would
        across per-page launches, and each page is walked from its own
        last edge's rank-0 slot, anchored at its entry slot's carried
        cost."""
        self._one_width('lattice decoding')
        A = 4
        bounds = np.cumsum([0] + [s[0] for s in segs])
        n_group = int(bounds[-1])
        L = segs[0][1].shape[2]
        E = _bucket(n_group, E_BUCKETS)
        chars = np.zeros((E, A, L), np.int32)
        mask = np.zeros((E, A, L), np.float32)
        conf = np.zeros((E, A, L), np.float32)
        valid = np.zeros((E, A), np.float32)
        for (n_i, ch_i, m_i, cf_i, v_i), lo in zip(segs, bounds):
            chars[lo:lo + n_i] = ch_i[:n_i]
            mask[lo:lo + n_i] = m_i[:n_i]
            conf[lo:lo + n_i] = cf_i[:n_i]
            valid[lo:lo + n_i] = v_i[:n_i]
        valid[n_group:, 0] = 1.0   # pad edges: a free alternative
        K = _bucket(min(beam_width, FUSED_MAX_BEAM), K_BUCKETS)
        wts = self._decode_weights(context, bf16=self._decode_bf16())
        state, cost = self._fused_traceback(device_traceback, K,
                                            wts['emb'])
        packed, state, cost = self._launch_decode(
            wts, (chars, mask, conf, valid), state, cost, lm_weight, False,
            n_group)
        return ('group', bounds, [_Pinned(packed)], K, {}), (state, cost)

    def fused_group_fits(self, n_group, maxlen, beam_width):
        """Whether a page group of ``n_group`` prepared edges with
        alternatives of up to ``maxlen`` chars still fits one launch
        (the gate of :meth:`fused_gate_arrays`)."""
        return self.fused_gate_arrays(n_group, maxlen,
                                      beam_width) is not None

    @staticmethod
    def rate_best_device_finish_group(pending, i):
        """(choices, costs, start_cost) of page ``i`` of a group
        pending.  The records reach the host once a group (cached in
        the pending); page ``i`` is walked back from its own last edge's
        rank-0 slot through its own edge range and anchored at the entry
        slot's carried cost: the previous page's last edge's cost there,
        or the header's initial cost for the group's first page."""
        _, bounds, packed_blocks, K, cache = pending
        if 'bp' not in cache:
            packed = _host(packed_blocks[0])
            rows = packed[1:]
            cache['bp'] = rows[:, :K].astype(np.int32).tolist()
            cache['alt'] = rows[:, K:2 * K].astype(np.int64).tolist()
            cache['cost'] = np.asarray(rows[:, 2 * K:3 * K],
                                       np.float64).tolist()
            cache['cost0'] = np.asarray(packed[0, 2 * K:3 * K], np.float64)
        bp, alt, co = cache['bp'], cache['alt'], cache['cost']
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        choices = np.empty(hi - lo, np.int64)
        costs = np.empty(hi - lo, np.float64)
        k = 0
        for j in range(hi - 1, lo - 1, -1):
            choices[j - lo] = alt[j][k]
            costs[j - lo] = co[j][k]
            k = bp[j][k]
        start_cost = float(cache['cost0'][k]) if lo == 0 \
            else co[lo - 1][k]
        return choices, costs, start_cost

    def _prepare_decode_edges(self, edges, merge=None):
        """Convert lattice edges into decode-edge dicts, merging runs of
        consecutive single-alternative edges into one long edge (at most
        ``DECODE_MERGE_MAX`` chars).

        Merging is EXACT for the search: all hypotheses extend by the
        same string, so per-edge top-k between merged boundaries is a
        no-op; per-char confidences are preserved.  Only the score
        attribution within a merged run becomes uniform per char."""
        MERGE_MAX = DECODE_MERGE_MAX
        prepared = []
        run = None  # accumulating merged run

        def flush():
            nonlocal run
            if run is not None:
                prepared.append(run)
                run = None

        encode = self.vocab.encode_cached
        bits_cache: Dict[float, float] = {}
        bits_get = bits_cache.get
        if merge is None:
            merge = self.merge_runs
        pappend = prepared.append

        def conf_bits(te):
            conf = te.conf if te.conf is not None else 1.0
            bits = bits_get(conf)
            if bits is None:
                bits = -log(max(conf, 1e-99), 2)
                bits_cache[conf] = bits
            return bits

        for edge in edges:
            alternatives = edge['alternatives']
            if merge and len(alternatives) == 1:
                te = alternatives[0]
                ids = encode(te.Unicode)
                bits = conf_bits(te)
                part = (edge['element'], te, max(len(ids), 1))
                if run is not None and \
                        run['n_chars'] + len(ids) <= MERGE_MAX:
                    run['pieces'].append((ids, bits))
                    run['n_chars'] += len(ids)
                    run['parts'].append(part)
                else:
                    flush()
                    run = {
                        'pieces': [(ids, bits)],
                        'n_chars': len(ids),
                        'alts': alternatives,
                        'parts': [part],
                    }
            else:
                flush()
                alt_ids, alt_conf = [], []
                for te in alternatives[:4]:
                    alt_ids.append(encode(te.Unicode))
                    alt_conf.append(conf_bits(te))
                pappend({'alt_ids': alt_ids, 'alt_conf': alt_conf,
                         'alts': alternatives, 'parts': None,
                         'element': edge['element']})
        flush()
        # materialize merged runs
        for pe in prepared:
            if 'pieces' in pe:
                pe['alt_ids'] = [np.concatenate(
                    [ids for ids, _ in pe['pieces']])
                    if len(pe['pieces']) > 1 else pe['pieces'][0][0]]
                pe['alt_conf'] = [np.concatenate(
                    [np.full(len(ids), b, np.float32)
                     for ids, b in pe['pieces']])]
                del pe['pieces']
                del pe['n_chars']
        return prepared

    @staticmethod
    def _fill_decode_arrays(block, E, A, L):
        """(E, A, L) char/mask/conf + (E, A) valid arrays for a block
        of prepared decode edges (padding edges = identity)."""
        alt_chars = np.zeros((E, A, L), np.int32)
        alt_mask = np.zeros((E, A, L), np.float32)
        alt_conf = np.zeros((E, A, L), np.float32)
        alt_valid = np.zeros((E, A), np.float32)
        # single-char alternatives fill via ONE fancy-index write each
        f_ei, f_ai, f_ch, f_cf = [], [], [], []
        for ei, pe in enumerate(block):
            confs = pe['alt_conf']
            for ai, ids in enumerate(pe['alt_ids'][:A]):
                cb = confs[ai]
                if len(ids) == 1 and not isinstance(cb, np.ndarray):
                    f_ei.append(ei)
                    f_ai.append(ai)
                    f_ch.append(ids[0])
                    f_cf.append(cb)
                    continue
                n = min(len(ids), L)
                alt_chars[ei, ai, :n] = ids[:n]
                alt_mask[ei, ai, :n] = 1.0
                # scalar (per-alternative) or per-char array (merged)
                alt_conf[ei, ai, :n] = cb[:n] \
                    if isinstance(cb, np.ndarray) else cb
                alt_valid[ei, ai] = 1.0
        if f_ei:
            alt_chars[f_ei, f_ai, 0] = f_ch
            alt_mask[f_ei, f_ai, 0] = 1.0
            alt_conf[f_ei, f_ai, 0] = f_cf
            alt_valid[f_ei, f_ai] = 1.0
        for ei in range(len(block), E):
            alt_valid[ei, 0] = 1.0  # zero-length free alternative
        return alt_chars, alt_mask, alt_conf, alt_valid

    def _walk_traceback(self, edges, all_rows, K, E_MAX, start_cost,
                        start_slot=0, return_entry=False,
                        start_costs=None):
        """Host backpointer walk over fetched [bp|alt|cost] rows (exact
        across chained blocks; slot 0 is the best final hypothesis),
        then path emission anchored at the entry slot's initial cost.

        ``start_slot`` selects the final-beam hypothesis the walk starts
        from (rank order): lookahead write-back walks page N from the
        slot page N+1's walk entered through.  With ``return_entry`` the
        result is ``((path, entropy), entry slot)``, the entry slot
        being the slot in the previous page's final beam (the carry
        keeps slot order)."""
        nE = len(edges)
        rows = np.concatenate(all_rows, axis=0)
        bp = rows[:, :K].astype(np.int32)
        alts_m = rows[:, K:2 * K].astype(np.int32)
        costs_m = rows[:, 2 * K:]
        k = int(start_slot)
        rev_choices = []
        rev_costs = []
        for ei in range(len(rows) - 1, -1, -1):
            rev_choices.append(alts_m[ei, k])
            rev_costs.append(costs_m[ei, k])
            k = int(bp[ei, k])
        rev_choices.reverse()
        rev_costs.reverse()
        choices = []
        path_costs = []
        # per-block row counts come from the fetched blocks themselves
        pos = 0
        for rows_blk, lo in zip(all_rows, range(0, nE, E_MAX)):
            block_len = min(E_MAX, nE - lo)
            choices.extend(rev_choices[pos:pos + block_len])
            path_costs.extend(rev_costs[pos:pos + block_len])
            pos += len(rows_blk)
        if start_costs is not None and len(start_costs) > k:
            # anchor at the ENTRY slot's initial cost: the walked path
            # may continue from a non-best previous-page hypothesis
            start_cost = float(start_costs[k])
        out = self._emit_path(edges, choices, path_costs, start_cost)
        return (out, k) if return_entry else out

    def _emit_path(self, edges, choices, path_costs, start_cost):
        """Build the (element, textequiv, score) path from per-edge
        choices + cumulative costs, expanding merged runs (uniform
        per-char score within a run).  Returns (path, entropy).  Runs
        in C++ (``native.decode_emit``) unless ``KERASLM_NATIVE=0``."""
        out = native.decode_emit(edges, choices, path_costs, start_cost)
        if out is not None:
            return out
        costs = np.asarray(path_costs[:len(edges)], np.float64).tolist()
        chs = np.asarray(choices[:len(edges)], np.int64).tolist()
        path = []
        append = path.append
        prev = start_cost
        for pe, cum, ai in zip(edges, costs, chs):
            diff = cum - prev
            parts = pe['parts']
            if parts is not None:
                total_chars = sum(n for _, _, n in parts)
                score = 2.0 ** (-diff / (total_chars or 1))
                if score > 1.0:
                    score = 1.0
                for element, te, _n in parts:
                    append((element, te, score))
            else:
                alts = pe['alts']
                te = alts[ai] if ai < len(alts) else alts[-1]
                score = 2.0 ** (-diff / (len(te.Unicode) or 1))
                append((pe.get('element'), te,
                        score if score < 1.0 else 1.0))
            prev = cum
        entropy = costs[-1] - start_cost
        return path, entropy

    # -- batched serving decode ----------------------------------------

    @staticmethod
    def concat_graphs(graphs):
        """Concatenate linear lattice graphs (e.g. one per page of a
        document) into ONE lattice whose decode chains the beam across
        the former boundaries, the batched analogue of the per-page
        ``device_traceback`` carry.  Use with :meth:`rate_best_batch` to
        decode independent multi-page documents together; path entries
        keep their ``element``, so callers split results back into pages
        by element."""
        import networkx as nx
        out = nx.DiGraph()
        out.add_node(0)
        node = 0
        for g in graphs:
            for data in _linear_edges(g):
                out.add_edge(node, node + 1, **data)
                node += 1
        return out

    @_gc_paused
    def rate_best_batch(self, graphs, context=None, lm_weight=0.5,
                        beam_width=10):
        """Beam-decode N independent linear lattices (documents) in one
        launch of the batched decode kernel per block of at most 1024
        edges.  Every document starts from a fresh beam (concatenate a
        document's pages with :meth:`concat_graphs`).  Returns a list of
        (path, entropy) like :meth:`rate_best_device_finish`."""
        return self.rate_best_batch_finish(self.rate_best_batch_begin(
            graphs, context=context, lm_weight=lm_weight,
            beam_width=beam_width))

    @_gc_paused
    def rate_best_batch_finish(self, pending):
        """Wait for a :meth:`rate_best_batch_begin` batch and emit its
        paths; returns the results list."""
        kind = pending[0]
        if kind == 'done':
            return pending[1]
        if kind == 'sharded':
            from .parallel.decode import finish
            return finish(self, pending)
        if kind == 'xlab':
            edges, live, results = pending[1], pending[2], pending[5]
        else:
            edges, live, results = pending[2], pending[1][0], pending[3]
        for i, walk in zip(live, self._batch_walks(pending)):
            results[i] = self._emit_path(edges[i], *walk)
        return results

    def _batch_walks(self, pending):
        """Wait for a launched batch (pending ``'xlab'`` or ``'fusedb'``)
        and return each of its documents' walk, in launch order:
        (choices, cumulative costs, start cost), what
        :meth:`_emit_path` takes."""
        if pending[0] == 'xlab':
            _, edges_list, live, packed, _K, _ = pending
            packed = _host(packed)
            out = []
            for row, i in enumerate(live):
                nE = len(edges_list[i])
                out.append((packed[row, 1:nE + 1, 0].astype(np.int32),
                            packed[row, 1:nE + 1, 1],
                            float(packed[row, 0, 0])))
            return out
        _, (live, E_blk, block_edges, fetch), prepared, _ = pending
        flat = _fetch(*fetch)
        N = len(live)
        walks, off = [], 0
        for E in block_edges:
            walks.append(flat[off:off + N * E * 2].reshape(N, E, 2))
            off += N * E * 2
        out = []
        for di, i in enumerate(live):
            n = len(prepared[i])
            choices: List[int] = []
            costs: List[float] = []
            for bi, walk in enumerate(walks):
                real = min(max(n - bi * E_blk, 0), E_blk)
                choices.extend(walk[di, :real, 0].astype(np.int64))
                costs.extend(walk[di, :real, 1])
            out.append((choices, costs, 0.0))
        return out

    @_gc_paused
    def rate_best_batch_begin(self, graphs, context=None, lm_weight=0.5,
                              beam_width=10):
        """Launch the decode of a document batch; fetch and path emission
        happen in :meth:`rate_best_batch_finish`, so a serving loop can
        launch batch B before it finishes batch A (results equal the
        synchronous :meth:`rate_best_batch`).  Empty batches, all-empty
        documents and a single live document resolve inside begin.
        Branching lattices raise :class:`NonLinearLatticeError`.

        The batched kernel takes the batch where it takes the shape (beam
        <= 32, alternatives <= 64 chars, a layout that fits a block);
        else one engine call decodes every live document side by side
        (:func:`ops.beam_device.decode_lattice_device` with a leading
        document axis, pending ``'xlab'``), and documents over 1024
        prepared edges decode one by one (:meth:`rate_best_device`)."""
        self._one_width('lattice decoding')
        if self.status < 2:
            raise RuntimeError('rate_best_batch needs loaded weights')
        raw_list = [_linear_edges(g) for g in graphs]
        merge, scans = self._batch_scans(raw_list, beam_width)
        sizes = [n for n, _ in scans]
        live = [i for i, n in enumerate(sizes) if n]
        results: List[Any] = [([], 0.0)] * len(graphs)
        if not live:
            return ('done', results)
        maxlen = max(scans[i][1] for i in live)
        kernel = self.fused_decode and beam_width <= FUSED_MAX_BEAM and \
            self._kernel_fits(maxlen, _bucket(max(maxlen, 1), L_BUCKETS),
                              _bucket(beam_width, K_BUCKETS))
        if len(live) == 1 or (not kernel and
                              max(sizes) > E_BUCKETS[-1]):
            # a single live document takes the single-document decode
            # (merged prep), as in the JAX package; so do documents too
            # long for one engine block
            for i in live:
                path, ent, _ = self.rate_best_device(
                    raw_list[i], 0, 0, context=context,
                    lm_weight=lm_weight, beam_width=beam_width)
                results[i] = (path, ent)
            return ('done', results)
        if self.mesh is not None:
            # the documents split over the mesh's data axis; the walks
            # are gathered at the finish
            from .parallel.decode import (make_batch_decode,
                                          make_fused_batch_decode)
            if not kernel:
                return make_batch_decode(self.mesh)(
                    self, raw_list, live, results, context, lm_weight,
                    beam_width)
            return make_fused_batch_decode(self.mesh)(
                self, raw_list, merge, sizes, live, maxlen, results,
                context, lm_weight, beam_width)
        if not kernel:
            return self._rate_best_batch_engine(
                raw_list, live, results, context, lm_weight, beam_width)
        prepared: List[Any] = [None] * len(raw_list)
        gpending = self._rate_best_batch_fused_begin(
            raw_list, merge, sizes, prepared, live, maxlen, context,
            lm_weight, beam_width)
        return ('fusedb', gpending, prepared, results)

    def _rate_best_batch_engine(self, raw_list, live, results, context,
                                lm_weight, beam_width):
        """One engine call over the live documents (merged prep, fresh
        beams at K = the beam width's bucket), each walked on the
        device; the shorter documents take free edges up to the longest
        (they leave the live slots as they are).  Returns the
        ``'xlab'`` pending."""
        edges_list = [self._prepare_decode_edges(raw) if raw else []
                      for raw in raw_list]
        K = _bucket(beam_width, STEP_BUCKETS)
        A = 4
        E = max(len(edges_list[i]) for i in live)
        L = _bucket_unbounded(max(_longest(edges_list[i]) for i in live),
                              L_BUCKETS)
        arrays = [np.stack(a) for a in zip(*(
            self._fill_decode_arrays(edges_list[i], E, A, L)
            for i in live))]
        N = len(live)
        h, c, x, cost = self._engine_traceback(None, K)
        packed = self._launch_engine(
            arrays, context, tuple(a.expand((N,) + a.shape).contiguous()
                                   for a in (h, c, x, cost)),
            lm_weight, True)[0]
        return ('xlab', edges_list, live, _Pinned(packed), K, results)

    def _batch_scans(self, raw_list, beam_width):
        """The prep of a batch of edge chains: (merge flag, per document
        (prepared edges, longest alternative; (0, 0) when empty)).
        Unmerged-L1 preference: when every real alternative of every
        document is a single char (glyph lattices: run merging is the
        only source of L > 1) and the batched kernel takes the batch at
        L=1, the batch preps without merging, so that every edge takes
        one char step (on the parent rows) instead of an L=8 bucket;
        paths equal the merged decode's, per-char scores are exact (a
        merged run's are uniform)."""
        scans = [_scan(raw, self.merge_runs, DECODE_MERGE_MAX)
                 if raw else (0, 0) for raw in raw_list]
        if self.merge_runs and self.fused_decode and \
                beam_width <= FUSED_MAX_BEAM and \
                max((m for _, m in scans), default=1) > 1 and \
                self._kernel_fits(1, 1, _bucket(beam_width, K_BUCKETS)):
            scans_u = [_scan(raw, False, 1) if raw else (0, 0)
                       for raw in raw_list]
            if max((m for n, m in scans_u if n), default=1) <= 1:
                return False, [(n, min(m, 1)) for n, m in scans_u]
        return self.merge_runs, scans

    def _batch_beam_init(self, emb, N, K):
        """N fresh beams on the device, (N*K, S) and (N*K, 1): every row
        at the newline embedding, slot 0 of each document at cost 0, the
        other slots dead (``BIG``)."""
        D, W = self.depth, self.width
        state = torch.zeros((N * K, (2 * D + 1) * W), dtype=torch.float32,
                            device=emb.device)
        state[:, :W] = emb[self.vocab.get('\n')]
        cost = torch.full((N * K, 1), BIG, dtype=torch.float32,
                          device=emb.device)
        cost[::K] = 0.0
        return state, cost

    def _rate_best_batch_fused_begin(self, raw_list, merge, all_sizes,
                                     prepared, live, maxlen, context,
                                     lm_weight, beam_width):
        """Launch the batched decode of the ``live`` documents (one group:
        one block of the kernel per document) in blocks of
        ``E_BUCKETS[-1]`` edges (``fused_batch_E_blk`` overrides), the
        beams chained on the device from block to block, then the
        backpointer walk kernel once per block, last block first; starts
        one copy of all walks into pinned host memory and returns
        ``(live, E_blk, per-block walk sizes, (host walks, event))``
        without waiting.  Each live document's arrays are filled once
        (in C++, ``native.decode_fill``, or with ``KERASLM_NATIVE=0`` by
        :meth:`_prepare_decode_edges` and :meth:`_fill_decode_arrays`)
        and sliced per block; its emission metadata go into
        ``prepared[i]``."""
        K = _bucket(min(beam_width, FUSED_MAX_BEAM), K_BUCKETS)
        A = 4
        N = len(live)
        L = _bucket(max(maxlen, 1), L_BUCKETS)
        dev = self.device
        wts = self._decode_weights(context, bf16=self._decode_bf16())
        E_blk = getattr(self, 'fused_batch_E_blk', None) or E_BUCKETS[-1]
        sizes = [all_sizes[i] for i in live]
        nE = max(sizes)
        table = self.vocab._table()
        full = []
        for i, n in zip(live, sizes):
            E_doc = _bucket_unbounded(n, E_BUCKETS)
            filled = native.decode_fill(raw_list[i], merge, DECODE_MERGE_MAX,
                                        E_doc, A, L, table)
            if filled is None:
                prepared[i] = self._prepare_decode_edges(raw_list[i],
                                                         merge=merge)
                full.append(self._fill_decode_arrays(prepared[i], E_doc, A,
                                                     L))
            else:
                prepared[i] = filled[0]
                full.append(filled[1:])
        state, cost = self._batch_beam_init(wts['emb'], N, K)
        recs = []
        for lo in range(0, nE, E_blk):
            n_real = max(min(max(n - lo, 0), E_blk) for n in sizes)
            E = _bucket(n_real, E_BUCKETS)
            per = []
            for fa in full:
                blk = []
                for ai, a in enumerate(fa):
                    # a block covers at most E_blk real edges, padded to
                    # its E bucket with free edges
                    part = a[lo:lo + min(E, E_blk)]
                    if len(part) < E:
                        pad = np.zeros((E - len(part),) + a.shape[1:],
                                       a.dtype)
                        if ai == 3:   # valid: free alternative 0
                            pad[:, 0] = 1.0
                        part = np.concatenate([part, pad])
                    blk.append(part)
                per.append(blk)
            chars, mask, conf = (
                np.stack([p[j] for p in per], axis=1).reshape(E, N * A, L)
                for j in range(3))
            valid = np.stack([p[3] for p in per], axis=1) \
                .reshape(E, N * A, 1)
            steps = _alt_steps(mask) if L > 1 else None
            rec, state, cost = decode_lattice_batch(
                wts['emb'], wts['embT'], wts['wcat'], wts['bias'],
                *(host_to_device(torch.from_numpy(a), dev)
                  for a in (chars, mask, conf, valid)),
                state, cost, n_docs=N, lm_weight=float(lm_weight),
                v_real=wts['v_real'],
                alt_steps=(None if steps is None else
                           host_to_device(torch.from_numpy(steps), dev)),
                n_real=n_real)
            recs.append(rec)
        k = torch.zeros((N,), dtype=torch.int32, device=dev)
        walks = []
        for rec in reversed(recs):
            k, walk = walk_records_batch(rec, k, n_docs=N, beam=K)
            walks.append(walk)
        walks.reverse()
        flat = torch.cat([w.reshape(-1) for w in walks])
        return (live, E_blk, [w.shape[1] for w in walks],
                _copy_to_host(flat))

    # -- embedding analysis and plots ------------------------------------

    def _host_weights(self, name, n=1):
        if self.status != 2:
            raise RuntimeError('plots need loaded weights')
        if name == 'char_embedding':
            wgt = self.params[name]
        else:
            wgt = self.params['context_embeddings'][n - 1]
        return wgt.detach().to('cpu', torch.float32).numpy()

    def plot_char_embeddings_similarity(self, filename):
        """Heat map of the char embeddings' autocorrelation."""
        plt, cm = _pyplot()
        wgt = self._host_weights('char_embedding')
        plt.imsave(filename, np.abs(np.dot(wgt, wgt.T)), cmap=cm.gray)

    def plot_context_embeddings_similarity(self, filename, n=1):
        """Heat map of context variable ``n``'s embeddings'
        autocorrelation."""
        plt, cm = _pyplot()
        wgt = self._host_weights('context_embeddings', n)
        plt.imsave(filename, np.abs(np.dot(wgt, wgt.T)), cmap=cm.gray)

    def plot_context_embeddings_projection(self, filename, n=1):
        """2-D PCA projection of context variable ``n``'s embeddings,
        each point labelled by its decade."""
        plt, _ = _pyplot()
        try:
            from sklearn.decomposition import PCA
        except ImportError as err:
            raise ImportError('the plot commands need matplotlib and '
                              'scikit-learn (the "plotting" extra): %s'
                              % err) from err
        wgt = self._host_weights('context_embeddings', n)
        prj = PCA(n_components=2).fit_transform(wgt)
        plt.figure(figsize=(11.7, 8.3))
        plt.plot(prj[:, 0], prj[:, 1], 'bo', markersize=2)
        for year, xy in enumerate(_spread_labels(prj)):
            plt.text(xy[0], xy[1], str(year) + 'x', c='b', size='xx-small')
        plt.tick_params(left=False, right=False, bottom=False,
                        labelleft=False, labelbottom=False)
        plt.savefig(filename)
