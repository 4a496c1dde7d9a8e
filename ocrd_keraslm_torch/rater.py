"""The LM engine of the port: model loading and saving, training,
scoring and lattice decoding.

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
* beam-decodes linear lattices of OCR alternatives with the fused
  single-document kernel
  (:func:`ocrd_keraslm_torch.ops.decode_kernel.decode_lattice`): the
  host merges runs of single-alternative edges, fills fixed-size edge
  arrays, launches one kernel per block of at most 1024 edges, and
  walks the returned backpointers.  The beam carries from page to page
  as device tensors ``(packed state (K, S), cost (1, 128))``.

The device follows ``KERASLM_PLATFORM`` unless the caller names one:
``cpu`` runs on the CPU (the kernels' plain PyTorch versions), unset,
``gpu`` or ``cuda`` runs on CUDA and raises when there is none.
"""
from __future__ import annotations

import gc
import logging
import os
from functools import wraps
from math import exp, log
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.lstm_lm import (DEFAULT_CONTEXTS, LMConfig, embed_inputs,
                             forward_seq, init_params, params_from_numpy,
                             zero_carry)
from .ops.decode_kernel import BIG, LANE, decode_lattice
from .ops.score_kernel import pack_score_weights, score_scan
from .utils import h5io
from .utils.buckets import bucket as _bucket
from .utils.buckets import bucket_unbounded as _bucket_unbounded
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
    """A branching (general-DAG) lattice reached the device engine,
    which decodes chains only (one beam round per edge)."""


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
                'has multiple outgoing edges' % (u,))
        succ[u] = (v, d)
        tails.add(v)
    if not succ:
        return []
    starts = [u for u in succ if u not in tails]
    if len(starts) != 1:
        raise NonLinearLatticeError(
            'device decoding requires a linear lattice (single chain), '
            'but found %d start nodes' % len(starts))
    node = starts[0]
    out = []
    for _ in range(len(succ)):
        if node not in succ:
            raise NonLinearLatticeError(
                'device decoding requires a linear lattice, but the chain '
                'from %r ends after %d of %d edges'
                % (starts[0], len(out), len(succ)))
        node, d = succ[node]
        out.append(d)
    return out


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
        # not ported yet: training raises when either is set
        self.mesh = None
        self.resume_dir = None
        # fused scoring kernel (all layers + tied softmax per chunk) on
        # CUDA, as the JAX package's default on its accelerator; the
        # layered path otherwise (and always above width 384)
        self.fused_score = self.device.type == 'cuda'
        self.merge_runs = True     # merge single-alternative edge runs
        self.decode_bf16 = False   # the JAX package's opt-in bf16 mode
        self.logger = logger or LOG
        self.cfg: Optional[LMConfig] = None
        self.params = None
        self.status = 0
        self._decode_cache: Dict[Any, Any] = {}
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
            compute_dtype=self.compute_dtype)
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
        self._params_changed()

    def _params_changed(self):
        """Drop the device-resident weight sets derived from
        ``self.params`` (after a load, vocabulary growth or training)."""
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
        cfg, vocab, history = h5io.load_config(filename)
        self.width = cfg.width
        self.depth = cfg.depth
        self.length = cfg.length
        self.stateful = cfg.stateful
        self.variable_length = cfg.variable_length
        self.contexts = cfg.contexts
        self.vocab = vocab
        self.voc_size = vocab.size
        self.history = history

    def load_weights(self, filename):
        if self.status < 1:
            raise RuntimeError('load_weights needs configure() first')
        self.params = params_from_numpy(
            h5io.load_weights(filename, self.cfg), self.device)
        self.voc_size = self.params['char_embedding'].shape[0]
        self._params_changed()
        self.cfg = self.cfg.replace(voc_size=self.voc_size)
        self.status = 2

    def save(self, filename):
        """Save weights and config as one h5 file."""
        if self.status < 2:
            raise RuntimeError('save needs trained or loaded weights')
        if str(filename).endswith(('.orbax', '/')) or \
                os.path.isdir(filename):
            raise NotImplementedError(
                'the Orbax directory format is not ported yet (ROADMAP.md '
                'Queue 1 #12, "Resume snapshots"): save to an .h5 file')
        h5io.save_model(filename, self.params, self.cfg, self.vocab,
                        self.history)

    def train(self, data, val_data=None):
        """Train on text files (paths or handles); see
        :func:`ocrd_keraslm_torch.training.train_rater`."""
        from .training import train_rater
        train_rater(self, data, val_data)

    def print_history(self):
        for k, v in self.history.items():
            print(f"{k}: {v}")

    # -- whole-text scoring --------------------------------------------

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
                 and self.cfg.width <= 384)
        probs_d, nll_d, carry = _score_stream(
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

    # -- decode weights and beam carry ---------------------------------

    def _decode_weights(self, context):
        """Decode weight set on the device: vocab-padded embedding and
        its transpose, per-layer fused ``[kernel; recurrent]`` (D, 2W, 4W)
        and biases (D, 1, 4W) with the page-constant context embedding
        folded into layer 0.  Cached per context."""
        ctx = tuple(context or self.underspecify_contexts())
        cached = self._decode_cache.get(ctx)
        if cached is not None:
            return cached
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
        weights = dict(emb=emb, embT=emb.T.contiguous(),
                       wcat=torch.stack(wcats).contiguous(),
                       bias=torch.stack(biases)[:, None, :].contiguous(),
                       v_pad=V_pad, v_real=V)
        while len(self._decode_cache) >= 4:
            del self._decode_cache[next(iter(self._decode_cache))]
        self._decode_cache[ctx] = weights
        return weights

    def _fused_traceback(self, tb, K, emb):
        """The beam carry for a page decoded at beam ``K``: a fresh beam
        (all rows at the newline embedding, only slot 0 alive) when
        ``tb`` is None, else the previous page's ``(state, cost)`` with
        the beam narrowed (best K slots kept — the carry is rank
        ordered) or widened (dead zero rows appended)."""
        D, W = self.depth, self.width
        if tb is None:
            state = torch.zeros((K, (2 * D + 1) * W), dtype=torch.float32,
                                device=self.device)
            state[:, :W] = emb[self.vocab.get('\n')]
            cost = torch.full((1, LANE), BIG, dtype=torch.float32,
                              device=self.device)
            cost[0, 0] = 0.0
            return state, cost
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
                               lm_weight=0.5, beam_width=10):
        """Prepare and launch the decode of a linear lattice (an edge
        list in chain order, or a networkx DiGraph that is one chain);
        returns ``(pending, new device traceback)``.  Fetch and path
        emission happen in :meth:`rate_best_device_finish`, so a
        document loop can launch every page before it waits for any."""
        try:
            edges_raw = graph if isinstance(graph, list) \
                else _linear_edges(graph)
        except NonLinearLatticeError as err:
            raise NotImplementedError(
                '%s: branching lattices need the host decode engine, '
                'which is not ported yet (ROADMAP.md Queue 1, "Host '
                'decode engine")' % err) from err
        if not edges_raw:
            return ('done', [], 0.0), device_traceback
        if self.decode_bf16:
            raise NotImplementedError(
                'decode_bf16 is not ported yet (ROADMAP.md Queue 1, '
                '"bf16 decode")')
        if beam_width > FUSED_MAX_BEAM:
            raise NotImplementedError(
                'beam_width %d > %d needs the unbounded decode engine, '
                'which is not ported yet (ROADMAP.md Queue 1, '
                '"Wide-beam decode engine")'
                % (beam_width, FUSED_MAX_BEAM))
        return self._rate_best_kernel(edges_raw, device_traceback,
                                      context, lm_weight, beam_width)

    def _rate_best_kernel(self, edges_raw, device_traceback, context,
                          lm_weight, beam_width):
        """Kernel decode dispatch (the counterpart of the JAX
        ``_rate_best_pallas``): run merging, per-block array fill and
        one kernel launch per block of at most 1024 edges, the carry
        chaining on the device.  Single-block pages walk their
        backpointers inside the kernel and return (E+1, 2); longer pages
        return per-block records, walked on the host at finish."""
        K = _bucket(min(beam_width, FUSED_MAX_BEAM), K_BUCKETS)
        A = 4
        E_MAX = E_BUCKETS[-1]
        edges = self._prepare_decode_edges(edges_raw)
        maxlen = max(max((len(ids) for ids in pe['alt_ids']), default=1)
                     for pe in edges)
        if maxlen > FUSED_MAX_ALT_LEN:
            raise NotImplementedError(
                'an alternative of %d chars exceeds the decode kernel\'s '
                '%d; the unbounded decode engine is not ported yet '
                '(ROADMAP.md Queue 1, "Wide-beam decode engine")'
                % (maxlen, FUSED_MAX_ALT_LEN))
        L = _bucket(max(maxlen, 1), L_BUCKETS)
        wts = self._decode_weights(context)
        state, cost = self._fused_traceback(device_traceback, K,
                                            wts['emb'])
        nE = len(edges)
        single = nE <= E_MAX
        dev = self.device
        packed_blocks = []
        for lo in range(0, nE, E_MAX):
            block = edges[lo:lo + E_MAX]
            E = _bucket(len(block), E_BUCKETS)
            chars, mask, conf, valid = self._fill_decode_arrays(
                block, E, A, L)
            steps = _alt_steps(mask)[:, 0] if L > 1 else None
            packed, state, cost = decode_lattice(
                wts['emb'], wts['embT'], wts['wcat'], wts['bias'],
                torch.from_numpy(chars).to(dev),
                torch.from_numpy(mask).to(dev),
                torch.from_numpy(conf).to(dev),
                torch.from_numpy(valid).to(dev),
                state, cost, lm_weight=float(lm_weight),
                v_real=wts['v_real'], device_walk=single,
                alt_steps=(None if steps is None
                           else torch.from_numpy(steps).to(dev)),
                n_real=len(block))
            packed_blocks.append(packed)
        return (('single' if single else 'blocks'), edges, packed_blocks,
                K), (state, cost)

    @_gc_paused
    def rate_best_device_finish(self, pending):
        """Fetch + backpointer walk + path emission for a pending decode
        (see :meth:`rate_best_device_begin`).  Returns (path, entropy)."""
        if pending[0] == 'done':
            return pending[1], pending[2]
        kind, edges, packed_blocks, K = pending
        nE = len(edges)
        if kind == 'single':
            packed = packed_blocks[0].cpu().numpy()
            return self._emit_path(edges, packed[1:nE + 1, 0]
                                   .astype(np.int32),
                                   packed[1:nE + 1, 1],
                                   float(packed[0, 0]))
        all_rows = []
        start_cost = start_costs = None
        for packed in packed_blocks:
            packed = packed.cpu().numpy()
            if start_cost is None:
                start_cost = float(packed[0, 0])
                # per-slot initial-beam costs (header's cost third): the
                # walk anchors at the slot it entered through
                start_costs = np.asarray(packed[0, 2 * K:3 * K],
                                         np.float64)
            all_rows.append(packed[1:])
        return self._walk_traceback(edges, all_rows, K, E_BUCKETS[-1],
                                    start_cost, start_costs)

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
                        start_costs=None):
        """Host backpointer walk over fetched [bp|alt|cost] rows (exact
        across chained blocks; slot 0 is the best final hypothesis),
        then path emission anchored at the entry slot's initial cost."""
        nE = len(edges)
        rows = np.concatenate(all_rows, axis=0)
        bp = rows[:, :K].astype(np.int32)
        alts_m = rows[:, K:2 * K].astype(np.int32)
        costs_m = rows[:, 2 * K:]
        k = 0
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
        return self._emit_path(edges, choices, path_costs, start_cost)

    def _emit_path(self, edges, choices, path_costs, start_cost):
        """Build the (element, textequiv, score) path from per-edge
        choices + cumulative costs, expanding merged runs (uniform
        per-char score within a run).  Returns (path, entropy)."""
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
