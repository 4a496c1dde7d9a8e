#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure exits non-zero):

1. card: name and power limit (``nvidia-smi``), torch device name/count;
   no CUDA device is a failure, never a fallback;
2. build: ``nvcc`` builds the seven kernel sources of
   ``ocrd_keraslm_torch/csrc/`` (``decode_lattice.cu``, ``score_scan.cu``,
   ``lstm_scan.cu``, ``lstm_bwd.cu``, ``gen_beam.cu``,
   ``gen_traceback.cu``, ``decode_lattice_batch.cu``) for sm_90a, all at
   once, and beside them ``g++`` the three host C++ libraries of
   ``ocrd_keraslm_torch/native_src/`` (the decode prep, the PAGE
   scanner, the training windows; with the CPython headers' path);
   prints seconds, ``-Xptxas -v`` registers and spills (the decode
   kernels' bf16 instantiations among them), each block's dynamic shared
   memory, and the ``HMMA`` instructions in each bf16 decode cluster
   kernel's SASS (``cuobjdump -sass``; none may be missing, and no f32
   kernel may have one);
3. parity at full width (``pretrained/model_german.h5``), each kernel
   against its plain PyTorch version, and both versions' error against
   the plain version run in float64:
   ``decode_lattice``'s outputs over seeded 1024-edge blocks, by sha256,
   equal to those of the kernel before its device code moved into
   ``csrc/decode_common.cuh``, in the cluster layout at every size the
   shape takes and in the one-block layout; ``lstm_bwd``'s, equal to
   those of commit cdb1b2b in every layout the chooser could take;
   the decode kernel (K=16, A=4, L in {1, 8}) over a seeded lattice of
   E=1024 edges and a chained tail block with n_real < E; the batched
   decode kernel over a 64-edge block of 8 documents of different
   lengths (L in {1, 8}), each document's records and final beam equal
   bit for bit to a single-document launch, and its walk kernel; the scoring
   kernel over 4096-step chunks at B in {1, 4} and at D=1, from a seeded
   nonzero carry with a partial mask; the LSTM-scan kernel at B=4,
   T=4096, with and without ``c_all``; at the training shape (B=128,
   T=256, W=128) the LSTM-scan kernel with f32 and bf16 U and the
   LSTM backward kernel with both, ``dU`` equal from launch to launch;
   at AWD-LSTM's enwik8 width (``wide1840_phase``: W=1840, B=128,
   T=200, layers 1 and 2 of the benchmark cell ``awd1840.train``) the
   LSTM-scan kernel with ``c_all`` and the LSTM backward kernel in the
   wide layout, bit for bit equal to the one-block layout and held to
   their plain versions, their wide launches counted from zero, their
   times beside the one-block layout's, the plain versions', cuDNN's
   and the bound (rows ``lstm_scan_w1840`` and ``lstm_bwd_w1840``);
   the generation beam-step kernel over 64 steps from a seeded prompt
   (K=256, TOPK=10) in every unit layout the card takes, every step
   against the plain version (near-ties resumed from the kernel's
   fringe), its records and final fringe by sha256 in every layout the
   chooser can take, equal to those of the kernel of commit 2399e92
   (``GEN_DIGESTS``: the seeded prompt, the 16 prompts of the batch row,
   a one-layer model of width 64), and the traceback kernel on the
   beam step's records and on seeded records of every segment plan
   (``TB_CASES``: the main path's 3 cursors from step 999 of 1024, 16
   streams, T*K beyond a block's shared memory, 1024 cursors, one
   segment, a forced plan), each equal to the plain version;
   under the german model's bf16 decode weights, ``decode_lattice`` in
   the cluster layout at every size the shape takes and in the one-block
   layout, pinned by ``DECODE_BF16_DIGESTS``, and ``decode_lattice_batch``
   on the 64-edge block of 8 documents (each document equal to a single
   bf16 launch bit for bit), both held to their plain bf16 versions
   edge by edge from the kernel's beam (``parity_stepwise``: two bf16
   runs part from the first h that rounds to the other bf16 value), with
   both versions' state error against float64;
   at K=32 (``beam_width`` 17-32, the cluster layout's sharded plan at
   the german model's width, ``k32_parity``): ``decode_lattice``'s
   digests in the 16-block cluster and the one-block layout, pinned by
   ``DECODE_K32_DIGESTS`` (the parent commit's one-block kernel), the
   kernel and the batched kernel against their plain versions over the
   seeded blocks above, and under bf16 weights every edge of a seeded
   block per L against the plain version from the kernel's beam;
4. decode path: a seeded synthetic METS/PAGE workspace (4 pages of ~1800
   glyphs, 2-4 alternatives on ~15% of them) through
   ``ocrd_keraslm_torch.wrapper.cli`` at glyph level, beam_width 10, in
   the processor's default lanes; every glyph must end with one
   TextEquiv, every page must be written, the native page lane must
   have served every page, the kernel must have launched once per page
   group (a page a group at these sizes), and a small workspace must
   decode the same on the card and on the CPU; the same pages in the
   native and the record lane alternately (same output), and once more
   with the host clock split;
5. scoring path: the same 4 pages with ``-P alternative_decoding
   false`` (one ``score_scan`` launch per 4096-char chunk of the one
   ``rate_batch``), a small workspace scored on the card and on the
   CPU; the same pages once more with ``fused_score`` off through the
   ``Rater`` API (``lstm_scan`` once per layer and chunk); then
   ``keraslm-rate test`` and ``apply``
   (``python -m ocrd_keraslm_torch.scripts.run``), card against CPU;
6. training path: a seeded synthetic German corpus of three
   ``author_title_year.txt`` files (each fills 128 streams of six
   256-char windows) through ``keraslm-rate train -w 128 -d 2 -l 256
   -b 128 -e 2`` (``python -m ocrd_keraslm_torch.scripts.run``, in this
   process): ``lstm_bwd`` must launch once per layer and step,
   ``lstm_scan`` once per layer and training or validation step, the
   loss must start near ln(V) and fall, a checkpoint and the model must
   be written, and the model must load and rate (``keraslm-rate test``,
   card against CPU); the same with ``--bf16`` for one epoch of a
   smaller corpus; then five ``train_step``s at full width from one
   initialisation, the same batches and dropout seed on the card and on
   the CPU; generation path: ``keraslm-rate generate -n 1000 -v 3 "Die
   Vernunft "`` (one ``gen_beam`` and one ``gen_traceback`` launch), the
   same at ``-n 64`` on the card and on the CPU with equal lines, and
   ``Rater.generate_batch`` of 16 seeded prompts at ``-n 256`` in one
   launch of each kernel, equal to 16 single calls; page lanes: the
   native, record and object lanes give the same content, page groups
   on and off (``KERASLM_FUSE_PAGES``) byte-identical files over 16
   short pages, and ``-P lookahead_writeback true`` over the 4 pages of
   phase 4 the choices of the pages decoded as one lattice on the card
   and the CPU's lookahead (``lane_path``); host decode engine:
   page 1 of the seeded workspace through the CLI with ``-P
   device_decoding false``, and a branching page (the lattice builder
   returns a DAG) through the default device lane, which bails into the
   host engine, each on the card and on the CPU: no kernel launched,
   the same number of ``_predict_step`` calls, the same choices (a
   near-tie passes where both choices' path costs, decoded on the CPU,
   lie within ``HOST_TIE_BITS``) and confs within 1e-4; batched serving path:
   ``Rater.rate_best_batch`` of 32 one-page documents of a seeded
   workspace and of 8 documents of 4 pages joined with
   ``Rater.concat_graphs`` (one ``decode_lattice_batch`` and one
   ``walk_records_batch`` launch per block of <= 1024 edges for the whole
   batch), every document's path equal to its own ``rate_best_device``
   decode on the card, a double-buffered pair (begin B before finish A)
   equal to the batch, 4 documents card against CPU, the begin (host
   prep) with the C++ prep and with ``KERASLM_NATIVE=0``;
   unbounded engines (the decode and generation engines of
   ``ops/beam_device.py``, plain PyTorch on the card): (a) ``-P
   beam_width 40`` over pages 1-2 of phase 4's workspace through the
   CLI, no kernel launched, card against CPU (a near-tie passes where
   both documents' path costs, decoded on the CPU, lie within
   ``HOST_TIE_BITS``), beside the same pages at beam 32 through
   ``decode_lattice`` (the blocks a document each launch took, seconds a
   page), and the engine alone on page 1 (seconds per edge
   and char step, CUDA launches per edge from ``torch.profiler``); (b)
   ``-P textequiv_level line`` over 3 pages whose page 2 has lines over
   64 chars: two ``decode_lattice`` launches (pages 1 and 3), page 2
   through the engine, card against CPU, 3 of 3 pages written with
   ``OCRD_MISSING_OUTPUT`` unset; (c) ``rate_best_batch`` of 4 documents
   at beam 40 in one engine call, each equal to its own
   ``rate_best_device``; (d) a seeded D=2, W=512 model: decode and a
   2-document batch with no kernel launch, ``generate -n 256`` with no
   ``gen_beam`` launch and ``-n 32`` card against CPU, three
   ``train_step``s with ``lstm_scan`` and ``lstm_bwd`` in their grid
   layouts (the layouts printed), card against CPU, both kernels there
   against their plain versions and pinned by ``WIDE_SCAN_DIGEST`` and
   ``WIDE_BWD_DIGEST``, each digest taken through the one-block layout
   first and then through the chosen one, and the one-block layout at
   8, 4 and 2 streams a block bit-equal at W=256; bf16 decode
   mode (``rater.decode_bf16 = True``): phase 4's pages through the
   processor's Python entry point (every page written, the native lane
   serving every page, one bf16 ``decode_lattice`` launch a page group
   and no f32 one; the glyph choices that differ from the f32 default's
   counted), a one-page workspace card against CPU (near-ties by the
   bf16 path costs on the CPU within ``BF16_TIE_BITS``), a bf16 kernel
   page, a page at beam 40 through the engine and a kernel page again,
   card against CPU, the 32 one-page documents through
   ``rate_best_batch``, each equal to its own bf16 ``rate_best_device``,
   and ``generate -n 64`` equal with the flag set and unset;
   K=32 paths (``k32_path``): the 32 one-page documents through
   ``rate_best_batch`` at ``beam_width`` 32, each equal to its own
   ``rate_best_device`` decode, the first edges of the first block held
   against the plain version, and phase 4's pages in the bf16 decode
   mode at beam 32;
   serving roles (``serving_path``): the HTTP processing server
   (``wrapper/cli.make_processing_server`` in a thread on an ephemeral
   port): ``GET /health``, then 3 ``POST /process`` jobs on fresh copies
   of phase 4's workspace, every page equal to phase 4's CLI output and
   one ``decode_lattice`` launch a page group; ``worker --once`` over 2
   spool jobs, the same; a METS server in a spawned process
   (``wrapper/mets_server.serve``) serving a scoring run with ``-U`` and
   ``OCRD_MAX_PARALLEL_PAGES=4``, every page equal to phase 5's local
   run, the server stopped by its client; 8 threads decoding phase 4's
   pages on 4 raters, two a page, equal bit for bit to the serial
   decodes, the decode weights shared through the process-wide cache;
   resume snapshots (``resume_path``): ``keraslm-rate train -w 128 -d 2
   -l 256 -b 128 -e 3`` on a seeded corpus uninterrupted, killed during
   epoch 2 with ``--resume-dir`` (the snapshot of epoch 1 kept), and
   resumed: every history key within rtol 1e-5, the resumed run's
   ``lstm_bwd`` launches those of epochs 2-3, the snapshot's bytes and
   the seconds of its copy and commit; pruning (``prune_path``):
   ``prune-charset`` of 'J' (V=69), page 1 decoded and its text scored
   through the kernels, each kernel held against its plain version at
   V=69, a small page's decode and the scoring card against CPU; device
   trace (``trace_path``): the decoding CLI with ``--jax-trace``, whose
   Chrome trace must name the ``decode_lattice`` kernel among its CUDA
   kernel events;
7. numbers: wall per page (by page lane, and its host split), edges/s
   and scored chars/s, the page groups' and lookahead's walls, the
   device's busy and idle share of the paths (``torch.profiler``), wall
   per training
   step and chars/s, wall per generation and generated chars/s, wall of
   a 32-document batch, documents/s and edges/s against 32 sequential
   ``rate_best_device`` calls, and per kernel at the main path's
   shapes: its time and the plain version's (CUDA events; the
   traceback's as device time, its calls queued behind a sleep kernel,
   since a call's host work outlasts its kernels; the batched
   decode's plain version on the parity block only), its bound, and a
   library yardstick where there is one (for the batched decode: one
   ``decode_lattice`` launch per document, one after another); for the
   decode kernels and ``lstm_bwd`` also the one-block layout's time (the
   first port's kernel; ``lstm_bwd``'s chain reads z from its z kernel)
   and the layout taken; the
   bf16 decode kernels at rows 1 and 2's shapes beside the f32 kernels
   in the same call (rows ``decode_lattice_bf16`` and
   ``decode_lattice_batch_bf16``, their bound at the bf16 tensor-core
   rate); at W=512 (``wide_numbers``) rows 3w (``score_scan`` with the
   seeded D=2, W=512 model on the scoring chunk, timing only), 4w
   (``lstm_scan``) and 5w (``lstm_bwd``) at part (d)'s training shape,
   4w and 5w in the chosen grid layout and the one-block layout side by
   side, each beside its plain version, its bound and cuDNN; the K=32
   rows ``decode_lattice_k32`` (page 1 at beam 32), ``_bf16_k32`` and
   ``decode_lattice_batch_k32`` (block 1 of the 32-document batch at
   beam 32) beside the one-block layout.

Every kernel count is set to 0 just before a path runs and read just
after.  The last two lines are the kernel table and
``{"ok": true, "device": {...}}`` as JSON.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, 'pretrained', 'model_german.h5')
BIG = 1.0e30
# card peaks for the bound (NVIDIA H100 SXM data sheet): f32 on CUDA
# cores, bf16 on tensor cores (dense) and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the training main path: keraslm-rate train's defaults
TRAIN_W, TRAIN_D, TRAIN_T, TRAIN_B = 128, 2, 256, 128
GERMAN_WORDS = (
    'der die und in den von zu das mit sich des auf für ist im dem nicht '
    'ein Die eine als auch es an werden aus er hat daß sie nach wird bei '
    'einer Der um am sind noch wie einem über einen Das so zum war haben '
    'nur oder aber vor zur bis mehr durch man sein wurde sei In Prozent '
    'hatte kann gegen vom können schon wenn habe seine Mark ihre dann '
    'unter wir soll ich eines Es Jahr zwei Jahren diese dieser wieder '
    'keine Uhr seiner worden Und will zwischen Im immer Millionen Ein was '
    'sagte Er gibt alle DM diesem seit muß wurden beim doch jetzt waren '
    'drei Jahre Mit neue neuen damit bereits da Auf ihr seinen müssen ab '
    'ihrer Nach ohne sondern selbst ersten nun etwa Bei heute ihren weil '
    'ihm Menschen Deutschland anderen werde Ich sagt Sie Frau Herr Kinder '
    'Vernunft Aufklärung Mensch Natur Geist Zeit Welt Leben Stadt König '
    'Kirche Schule Arbeit Recht Wahrheit Freiheit Glück Liebe Gott').split()


# ---------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------

def random_lattice(rng, E, n_real, A, L, v_real):
    """Edge arrays of a lattice like the main path's: real edges mix
    multi-alternative glyph edges (1-3 chars, 2-4 alternatives) with
    single-alternative merged runs (up to L chars); edges >= n_real are
    the pad edges the host fill emits (one free zero-length
    alternative).  Returns chars, mask, conf bits, valid, steps."""
    chars = np.zeros((E, A, L), np.int32)
    mask = np.zeros((E, A, L), np.float32)
    conf = np.zeros((E, A, L), np.float32)
    valid = np.zeros((E, A), np.float32)
    for t in range(n_real):
        if rng.random() < 0.5:
            n_alt, lens = 1, [int(rng.integers(1, L + 1))]
        else:
            n_alt = int(rng.integers(2, A + 1))
            lens = [int(rng.integers(1, min(L, 3) + 1))
                    for _ in range(n_alt)]
        for a, n in enumerate(lens):
            chars[t, a, :n] = rng.integers(1, v_real, n)
            mask[t, a, :n] = 1.0
            conf[t, a, :n] = -np.log2(rng.uniform(0.6, 1.0))
            valid[t, a] = 1.0
    valid[n_real:, 0] = 1.0
    steps = mask.sum(axis=2).max(axis=1).astype(np.int32)
    return chars, mask, conf, valid, steps


def walk_records(packed, K):
    """The device-walk output ``(E+1, 2)`` computed on the host from a
    records output ``(E+1, 3K)``: the best final slot walked back."""
    out = np.zeros((len(packed), 2), np.float32)
    k = 0
    for t in range(len(packed) - 1, 0, -1):
        out[t] = packed[t, K + k], packed[t, 2 * K + k]
        k = int(packed[t, k])
    out[0, 0] = packed[0, 2 * K + k]
    return out


def compare_decode(got, want, K, width, gap=1e-3, state_atol=1e-5,
                   c_rtol=2e-5, cost_rtol=1e-5, cost_atol=1e-4, stats=None):
    """Hold one decode output ``(packed, stateF, costF)`` (numpy)
    against another; returns ``(max abs error, edges compared, edge
    where the two diverged at a near-tie or None)``.

    Costs agree within ``cost_rtol``/``cost_atol``.  Backpointers and
    alternative indices are equal; ranks whose reference costs lie
    within ``max(gap, cost_rtol * |cost|)`` of each other form a tie
    group (the BIG region of dead slots is one), inside which they may
    come in another order, tracked to the next edge.  When the tie
    group that holds the last rank K-1 differs in membership, a
    candidate beyond the reference's top K tied with its K-th: the two
    f32 runs legitimately take different hypotheses from there on, so
    the comparison stops at that edge and skips the final state
    (:func:`parity_block` resumes both runs after it).  Dead slots
    (cost ``BIG``) tie exactly and are ordered by candidate index, so
    there the records are equal as they stand.  The
    final state's xemb and h agree within ``state_atol``; the cell
    state c within ``state_atol + c_rtol * |c|`` (on long pages |c|
    grows to ~10^3, where one f32 ulp exceeds 1e-5).  A device-walk
    output (E+1, 2) is compared whole: choices equal, costs close.
    ``stats`` (a dict) gets the largest difference of the finite costs
    (``cost``), of the final xemb and h (``h``) and of c relative to
    max(1, |c|) (``c_rel``) seen, each over the values it already
    holds."""
    g_pk, g_st, g_co = got
    w_pk, w_st, w_co = want
    assert g_pk.shape == w_pk.shape, (g_pk.shape, w_pk.shape)
    err = 0.0

    def close(name, a, b):
        nonlocal err
        fin = np.abs(b) < 1e29
        if fin.any() and stats is not None:
            stats['cost'] = max(stats.get('cost', 0.0),
                                float(np.abs(a - b)[fin].max()))
        np.testing.assert_allclose(a, b, rtol=cost_rtol, atol=cost_atol,
                                   err_msg=name)
        if fin.any():
            err = max(err, float(np.abs(a - b)[fin].max()))

    perm = np.arange(K)  # reference rank -> rank in `got`, previous edge
    n_edges = len(w_pk) - 1
    if g_pk.shape[1] == 2:
        close('walk costs', g_pk[:, 1], w_pk[:, 1])
        np.testing.assert_array_equal(g_pk[1:, 0], w_pk[1:, 0],
                                      err_msg='walk choices')
        close('walk header', g_pk[0], w_pk[0])
    else:
        close('header', g_pk[0], w_pk[0])
        for t in range(1, n_edges + 1):
            wb, wa, wc = (w_pk[t, :K].astype(int),
                          w_pk[t, K:2 * K].astype(int), w_pk[t, 2 * K:])
            gb, ga, gc = (g_pk[t, :K].astype(int),
                          g_pk[t, K:2 * K].astype(int), g_pk[t, 2 * K:])
            close('edge %d costs' % (t - 1), gc, wc)
            dead = wc >= BIG
            np.testing.assert_array_equal(
                np.stack([gb[dead], ga[dead]]),
                np.stack([wb[dead], wa[dead]]),
                err_msg='edge %d dead slots' % (t - 1))
            new = np.empty(K, int)
            lo = 0
            while lo < K:
                hi = lo
                while hi + 1 < K and abs(wc[hi + 1] - wc[hi]) <= max(
                        gap, cost_rtol * abs(wc[hi])):
                    hi += 1
                group = range(lo, hi + 1)
                for k in group:
                    key = (perm[wb[k]], wa[k])
                    match = [m for m in group if (gb[m], ga[m]) == key]
                    if not match and hi == K - 1:
                        return err, t - 1, t - 1
                    assert match, ('edge %d rank %d: (bp, alt) %s not '
                                   'found in %s' % (t - 1, k, key,
                                                    list(zip(gb, ga))))
                    new[k] = match[0]
                lo = hi + 1
            perm = new
    D = (w_st.shape[1] // width - 1) // 2
    split = (1 + D) * width   # [xemb | h..] | [c..]
    d = np.abs(g_st[perm] - w_st)
    if stats is not None:
        stats['h'] = max(stats.get('h', 0.0), float(d[:, :split].max()))
        stats['c_rel'] = max(stats.get('c_rel', 0.0), float(
            (d[:, split:] / np.maximum(1.0, np.abs(w_st[:, split:]))).max()))
    assert d[:, :split].max() <= state_atol, \
        ('stateF xemb/h', float(d[:, :split].max()))
    c_tol = state_atol + c_rtol * np.abs(w_st[:, split:])
    assert (d[:, split:] <= c_tol).all(), \
        ('stateF c', float((d[:, split:] - c_tol).max()))
    err = max(err, float(d.max()))
    close('costF', g_co, w_co)
    return err, n_edges, None


def parity_block(run, kernel, plain, arrays, n_real, state, cost, K,
                 width, tol=None):
    """Hold ``kernel`` against ``plain`` over one block of edges, both
    from the same ``state``/``cost``, records and device walk, with
    :func:`compare_decode` (its tolerances, or ``tol``: keyword arguments
    of :func:`compare_decode`, e.g. :data:`BF16_DECODE_TOL`).  ``run(fn, arrays, n_real, state, cost,
    walk)`` returns a decode output as tensors.  Each version's device
    walk equals the host walk of its own records.  Where the runs part
    at a near-tie at the K-th rank (edge t), the kernel decodes the
    block once more with ``n_real = t + 1`` (the later edges become
    identity pads), which gives the state after edge t, and both
    versions go on from it over the edges after t: so every edge is
    compared.  Returns ``(max abs error, near-tie edges, state and
    cost after the block)``."""
    E = len(arrays[0])
    start, err, ties = 0, 0.0, []
    while start < E:
        part = tuple(a[start:] for a in arrays)
        n = max(0, n_real - start)
        outs = {}
        for name, fn in (('kernel', kernel), ('plain', plain)):
            res = [run(fn, part, n, state, cost, walk)
                   for walk in (False, True)]
            if name == 'kernel':
                carry = res[0][1:]
            outs[name] = [[x.cpu().numpy() for x in r] for r in res]
            np.testing.assert_array_equal(
                outs[name][1][0], walk_records(outs[name][0][0], K),
                err_msg='%s device walk' % name)
        got, want = outs['kernel'], outs['plain']
        tol = tol or {}
        e, _, div = compare_decode(got[0], want[0], K, width, **tol)
        err = max(err, e)
        if div is None:
            final = want[0][0][-1, 2 * K:]
            if final[1] - final[0] > max(tol.get('gap', 1e-3),
                                         1e-5 * abs(final[0])):
                # the best final slot is one hypothesis in both runs
                err = max(err, compare_decode(got[1], want[1], K, width,
                                              **tol)[0])
            return (err, ties) + tuple(carry)
        ties.append(start + div)
        _, state, cost = run(kernel, part, div + 1, state, cost, False)
        start += div + 1
    return err, ties, state, cost


def batch_lattice(rng, N, n_reals, E, A, L, v_real):
    """Document-major edge arrays of N documents like
    :func:`random_lattice`'s, document ``n`` real up to ``n_reals[n]``
    and free pad edges after it: chars, mask, conf (E, N*A, L), valid
    (E, N*A, 1), steps (E, 1) the maximum over the documents."""
    docs = [random_lattice(rng, E, n, A, L, v_real) for n in n_reals]
    out = [np.stack([d[i] for d in docs], axis=1).reshape(
        (E, N * A) + docs[0][i].shape[2:]) for i in range(4)]
    out[3] = out[3][..., None]
    steps = np.max([d[4] for d in docs], axis=0).astype(np.int32)
    return out + [steps[:, None]]


def batch_doc(records, stateF, costF, n, K):
    """Document ``n``'s part of a batched decode output (numpy) in the
    single-document packed layout ``(E+1, 3K)`` (header row zero), for
    :func:`compare_decode`."""
    rec = records[:, :, n * K:(n + 1) * K].reshape(len(records), 3 * K)
    packed = np.concatenate([np.zeros((1, 3 * K), np.float32), rec])
    return packed, stateF[n * K:(n + 1) * K], costF[n * K:(n + 1) * K]


# final-state tolerances of the batched decode against its plain version
# on the card: each f32 version lies up to ~1e-5 from the exact state
# (the plain version 9.3e-6 from float64 on the 64-edge parity block of
# 8 documents, the kernel 5.8e-6; NVIDIA H100), so the two may lie twice
# that apart; records and costs keep compare_decode's tolerances
BATCH_STATE_ATOL, BATCH_C_RTOL = 2e-5, 4e-5


# the bf16 decode mode (Rater.decode_bf16): two runs whose f32 h differ
# in the last bit (sums in another order, another tanh) round some h to
# neighbouring bf16 values, a step of 2^-8 relative (as BF16_FWD_ATOL),
# which moves that candidate's cost by up to ~1e-3 bits and the state
# after it by up to a bf16 step of h; ranks whose costs lie within 4e-3
# bits may then come in another order.  Held at the CPU tests' small
# widths (W=16, 16-edge blocks), where few h flip
BF16_DECODE_TOL = dict(gap=4e-3, state_atol=4e-3, cost_atol=4e-3)


def parity_batch(run, kernel, plain, arrays, n_real, state, cost, N, K,
                 width, tol=None):
    """:func:`parity_block` for the batched decode: every document of
    ``kernel``'s output held against ``plain``'s with
    :func:`compare_decode` (final states within ``BATCH_STATE_ATOL``,
    cell states also ``BATCH_C_RTOL``, or the tolerances ``tol``, e.g.
    :data:`BF16_DECODE_TOL`); ``run(fn, arrays, n_real, state,
    cost)`` returns a batched output as tensors.  Where a document's runs
    part at a near-tie at the K-th rank (edge t, the first over the
    documents), the kernel decodes the block once more with ``n_real = t
    + 1``, and both versions go on from its state over the edges after
    t.  Returns ``(max abs error, near-tie edges, the kernel's state and
    cost after the block)``."""
    E = len(arrays[0])
    start, err, ties = 0, 0.0, []
    while start < E:
        part = tuple(a[start:] for a in arrays)
        n = max(0, n_real - start)
        res = run(kernel, part, n, state, cost)
        got = [x.cpu().numpy() for x in res]
        want = [x.cpu().numpy() for x in run(plain, part, n, state, cost)]
        divs = []
        for d in range(N):
            e, _, div = compare_decode(
                batch_doc(*got, d, K), batch_doc(*want, d, K), K, width,
                **(tol or dict(state_atol=BATCH_STATE_ATOL,
                               c_rtol=BATCH_C_RTOL)))
            err = max(err, e)
            if div is not None:
                divs.append(div)
        if not divs:
            return err, ties, res[1], res[2]
        div = min(divs)
        ties.append(start + div)
        _, state, cost = run(kernel, part, div + 1, state, cost)
        start += div + 1
    return err, ties, state, cost


def chain_graph(edges):
    """The networkx chain of a linear lattice's edge list (edge ``i``
    spans nodes ``i`` and ``i + 1``), as ``Rater.rate_best_batch``
    takes it."""
    import networkx as nx
    graph = nx.DiGraph()
    graph.add_node(0)
    for i, edge in enumerate(edges):
        graph.add_edge(i, i + 1, **edge)
    return graph


def compare_gen(got, want, cost_rtol=1e-5, cost_atol=1e-6):
    """Hold the generation records ``got`` (T, 3, K) of one stream
    (numpy) against ``want``; returns ``(max abs error of the live costs,
    step where the two runs parted at a near-tie or None)``.

    At every step chars and backpointers are equal and live costs (<
    1e38) agree within ``cost_rtol``/``cost_atol``.  Two f32 runs may
    select another candidate where two candidates' costs (or two logits
    of a row) lie within rounding of each other; there the records
    differ, but the sorted costs of the two selections still agree within
    the tolerance, which this checks before it stops at that step
    (:func:`gen_parity` resumes both runs after it)."""
    err = 0.0
    for t in range(len(want)):
        g, w = got[t], want[t]
        live = w[2] < 1e38
        if (np.array_equal(g[:2], w[:2])
                and np.array_equal(g[2] < 1e38, live)):
            np.testing.assert_allclose(g[2][live], w[2][live],
                                       rtol=cost_rtol, atol=cost_atol,
                                       err_msg='step %d costs' % t)
            if live.any():
                err = max(err, float(np.abs(g[2] - w[2])[live].max()))
            continue
        np.testing.assert_allclose(
            np.sort(g[2]), np.sort(w[2]), rtol=cost_rtol, atol=cost_atol,
            err_msg='step %d: the selections differ by more than a '
                    'near-tie' % t)
        return err, t
    return err, None


def gen_parity(kernel, plain, weights, state, cost, length, v_real,
               **kw):
    """Hold ``kernel`` against ``plain`` (``gen_beam`` signatures) over
    ``length`` steps of one stream from ``state`` (1, K, S) and ``cost``
    (1, K) with :func:`compare_gen`; where the two part at a near-tie
    (step t), the kernel runs t + 1 steps once more for its fringe after
    step t, and both go on from it, so every step is compared.  Returns
    ``(max abs cost error, near-tie steps)``."""
    import torch
    start, err, ties = 0, 0.0, []
    while start < length:
        outs = [fn(*weights, state, cost, length=length - start,
                   v_real=v_real, **kw)[0].cpu().numpy()
                for fn in (kernel, plain)]
        torch.cuda.synchronize()
        e, div = compare_gen(*outs)
        err = max(err, e)
        if div is None:
            break
        ties.append(start + div)
        rec, state = kernel(*weights, state, cost, length=div + 1,
                            v_real=v_real, final_state=True, **kw)
        state, cost = state.contiguous(), rec[:, -1, 2].contiguous()
        start += div + 1
    return err, ties


def as_float64(fn):
    """``fn`` (a decode function) run in float64 on the same inputs,
    outputs back in float32.  The cost carry's dead lanes map to BIG
    exactly, so dead slots still tie as in float32.  bf16 weights stay
    bf16 (the plain version widens them and rounds its operands to bf16
    in the state's dtype)."""
    import torch

    def run64(*args, **kwargs):
        args = [a.double() if a.is_floating_point()
                and a.dtype != torch.bfloat16 else a for a in args]
        args[9] = torch.where(args[9] >= 1e29, torch.full_like(args[9], BIG),
                              args[9])
        return [x.float() for x in fn(*args, **kwargs)]
    return run64


def state_error_vs_f64(run, kernel, plain, arrays, n_real, state, cost,
                       width):
    """Max |h| error of the final beam state, kernel and plain version
    (float32) each against the plain version in float64, all from one
    start: says whether the kernel's sums lose more than the plain
    version's.  The states are compared after the first ``n`` edges,
    where every run made the same choices (the edge after them is a
    near-tie that sends some run down other hypotheses).  Returns
    ``(n, kernel error, plain error)``."""
    K = state.shape[0]
    D = (state.shape[1] // width - 1) // 2
    fns = (kernel, plain, as_float64(plain))

    def decode(n):
        return [[x.cpu().numpy() for x in run(fn, arrays, n, state, cost,
                                              False)] for fn in fns]

    outs = decode(n_real)
    n = n_real
    for out in outs[:2]:
        rows = np.nonzero((out[0][1:, :2 * K] !=
                           outs[2][0][1:, :2 * K]).any(axis=1))[0]
        if len(rows):
            n = min(n, int(rows[0]))
    if n < n_real:
        outs = decode(n)
    return (n,) + tuple(
        float(np.abs(out[1] - outs[2][1])[:, width:(1 + D) * width].max())
        for out in outs[:2])


def _charset(vocab):
    return {c for c in vocab.c2i}


def build_workspace(directory, rng, n_pages, n_lines, vocab,
                    alt_share=0.15, identifier='urn:smoke/kant_1784',
                    line_words=((8, 13),)):
    """A METS/PAGE workspace of German-like text from ``vocab``'s
    charset: one region per page, ``n_lines`` lines of ~10 words (page p:
    ``line_words[p % len(line_words)]`` gives the range, upper bound
    excluded), one Glyph per char; ``alt_share`` of the glyphs carry 2-4
    alternatives (the true char among them, confs within 0.1 of the
    first)."""
    from ocrd_keraslm_torch.wrapper.mets import Mets, MetsFile, mets_to_xml
    from ocrd_keraslm_torch.wrapper.page import (Glyph, PcGts, TextEquivType,
                                                 TextLine, TextRegion, Word,
                                                 to_xml)
    charset = _charset(vocab)
    words = [w for w in GERMAN_WORDS if set(w) <= charset]
    letters = sorted(c for c in charset if c.isalpha())
    grp = 'OCR-D-OCR'
    os.makedirs(os.path.join(directory, grp), exist_ok=True)
    mets = Mets(unique_identifier=identifier)
    mets.file_groups[grp] = []
    n_glyphs = 0
    for p in range(n_pages):
        page_id = 'phys_%04d' % (p + 1)
        pcgts = PcGts()
        pcgts.pcGtsId = page_id
        region = TextRegion('%s_r1' % page_id)
        for li in range(n_lines):
            line = TextLine('%s_l%d' % (page_id, li))
            texts = []
            for wi in range(int(rng.integers(
                    *line_words[p % len(line_words)]))):
                text = words[int(rng.integers(len(words)))]
                if rng.random() < 0.1:
                    text += ',' if ',' in charset else ''
                word = Word('%s_l%d_w%d' % (page_id, li, wi))
                for gi, char in enumerate(text):
                    glyph = Glyph('%s_l%d_w%d_g%d' % (page_id, li, wi, gi))
                    if rng.random() < alt_share:
                        n_alt = int(rng.integers(2, 5))
                        cands = [char] + [letters[int(i)] for i in
                                          rng.choice(len(letters),
                                                     n_alt - 1,
                                                     replace=False)]
                        order = rng.permutation(n_alt)
                        confs = np.sort(rng.uniform(0.75, 0.84, n_alt))[::-1]
                        for idx, (o, c) in enumerate(zip(order, confs)):
                            glyph.add_TextEquiv(TextEquivType(
                                Unicode=cands[o], conf=float(round(c, 4)),
                                index=idx))
                    else:
                        glyph.add_TextEquiv(TextEquivType(
                            Unicode=char, conf=0.95, index=0))
                    word.add_Glyph(glyph)
                    n_glyphs += 1
                word.add_TextEquiv(TextEquivType(Unicode=text, conf=0.9))
                line.add_Word(word)
                texts.append(text)
            line.add_TextEquiv(TextEquivType(Unicode=' '.join(texts),
                                             conf=0.9))
            region.add_TextLine(line)
        region.add_TextEquiv(TextEquivType(
            Unicode='\n'.join(ln.text_equivs[0].Unicode
                              for ln in region.lines), conf=0.9))
        pcgts.page.add_TextRegion(region)
        fid = '%s_%s' % (grp, page_id)
        fname = os.path.join(grp, fid + '.xml')
        with open(os.path.join(directory, fname), 'w',
                  encoding='utf-8') as fh:
            fh.write(to_xml(pcgts))
        mets.file_groups[grp].append(MetsFile(
            ID=fid, fileGrp=grp, local_filename=fname, pageId=page_id))
        mets.page_ids.append(page_id)
    with open(os.path.join(directory, 'mets.xml'), 'w',
              encoding='utf-8') as fh:
        fh.write(mets_to_xml(mets))
    return n_glyphs


def output_glyphs(directory, grp='OCR-D-LM'):
    """{glyph id: [(Unicode, conf), ...]} over every page of ``grp``."""
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.page import parse_page
    ws = Workspace(directory)
    out, files = {}, list(ws.mets.find_files(fileGrp=grp))
    for f in files:
        pcgts = parse_page(os.path.join(directory, f.local_filename))
        for region in pcgts.get_Page().get_TextRegion():
            for line in region.get_TextLine():
                for word in line.get_Word():
                    for g in word.get_Glyph():
                        out[g.id] = [(te.Unicode, te.conf)
                                     for te in g.get_TextEquiv()]
    return out, files


def run_cli(directory, platform, beam_width=10, scoring=False,
            host=False, lookahead=False, level='glyph'):
    """The processor through its CLI entry point, in this process: beam
    decoding (with ``host`` ``-P device_decoding false``: the host
    engine; with ``lookahead`` ``-P lookahead_writeback true``), or with
    ``scoring`` ``-P alternative_decoding false``; at ``textequiv_level``
    ``level``."""
    from ocrd_keraslm_torch.wrapper.cli import ocrd_keraslm_rate
    args = ['-m', os.path.join(directory, 'mets.xml'),
            '-I', 'OCR-D-OCR', '-O', 'OCR-D-LM', '-l', 'WARNING',
            '-P', 'model_file', MODEL, '-P', 'textequiv_level', level,
            '-P', 'beam_width', str(beam_width)]
    if scoring:
        args += ['-P', 'alternative_decoding', 'false']
    if host:
        args += ['-P', 'device_decoding', 'false']
    if lookahead:
        args += ['-P', 'lookahead_writeback', 'true']
    with platform_env(platform):
        ocrd_keraslm_rate.main(args=args, standalone_mode=False)


@contextlib.contextmanager
def env_vars(**values):
    """The environment variables ``values`` set inside the block (None
    unsets one)."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def platform_env(platform):
    """``KERASLM_PLATFORM`` set to ``platform`` inside the block."""
    return env_vars(KERASLM_PLATFORM=platform)


# the page lanes, by the environment variables that choose them
LANES = {'native': dict(KERASLM_NATIVE_PAGE='1', KERASLM_FAST_PAGE='1'),
         'records': dict(KERASLM_NATIVE_PAGE='0', KERASLM_FAST_PAGE='1'),
         'object': dict(KERASLM_NATIVE_PAGE='0', KERASLM_FAST_PAGE='0')}


KERNELS = ('decode_lattice', 'score_scan', 'lstm_scan', 'lstm_bwd',
           'gen_beam', 'gen_traceback', 'decode_lattice_batch',
           'walk_records_batch')
# the decode kernels count their launches with bf16 weights apart (the
# bf16 decode mode, Rater.decode_bf16)
BF16_COUNTERS = ('decode_lattice', 'decode_lattice_batch')
NO_LAUNCHES = dict({name: 0 for name in KERNELS},
                   **{name + '_bf16': 0 for name in BF16_COUNTERS})
# device kernels by name, for the profiler's sums: an activity counts for
# the first name it contains, so the batched decode comes before
# decode_lattice (lstm_bwd launches three: the recurrence, the dU partial
# products and their sum; score_scan three: the recurrence, the tied
# softmax and the NLL sums)
DEVICE_KERNELS = KERNELS[6:] + KERNELS[:6] + ('lstm_du', 'score_softmax',
                                              'score_nll')


def profile_main_path(directory, scoring=False):
    """The processor over ``directory`` on the card under
    ``torch.profiler``; returns ``(host wall s, {kernel name: device
    ms, 'other': device ms})`` from the device activities the profiler
    saw (an empty dict where it saw none)."""
    return profiled(lambda: run_cli(directory, 'cuda', scoring=scoring))


def profiled(fn):
    """``fn()`` on the card under ``torch.profiler``; returns ``(host
    wall s, {kernel name: device ms, 'other': device ms})``; the device
    activities that are none of the port's kernels are also summed by
    name into ``profiled.others`` (for :func:`print_others`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    busy, others = {}, {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            key = next((k for k in DEVICE_KERNELS if k in evt.name),
                       'other')
            ms = evt.time_range.elapsed_us() / 1e3
            busy[key] = busy.get(key, 0.0) + ms
            if key == 'other':
                others[evt.name] = others.get(evt.name, 0.0) + ms
    profiled.others = others
    return wall, busy


def print_others(what, top=8):
    """The largest of the last trace's device activities outside the
    port's kernels (PyTorch's own kernels and copies), by name."""
    rows = sorted(profiled.others.items(), key=lambda kv: -kv[1])[:top]
    print('%s traced, device time outside the port\'s kernels, largest '
          'first: %s' % (what, '; '.join(
              '%.2f ms %s' % (ms, name[:70]) for name, ms in rows)))


def print_profile(what, wall, busy, card, over='same 4 pages'):
    if busy:
        device_ms = sum(busy.values())
        print('%s traced (torch.profiler, %s): wall %.3f s; '
              'device busy %s; device idle %.1f%% of the wall [%s]'
              % (what, over, wall,
                 ', '.join('%.1f ms in %s' % (ms, k)
                           for k, ms in sorted(busy.items())),
                 100 * (1 - device_ms / 1e3 / wall), card))
    else:
        print('%s traced: device time not measured (the profiler saw no '
              'device activity); wall %.3f s [%s]' % (what, wall, card))


def native_docs(directory):
    """The native page lane's document of every input page, in page
    order."""
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.page_native import NativePageDoc
    ws = Workspace(directory)
    return [NativePageDoc(os.path.join(directory, f.local_filename))
            for f in ws.mets.find_files(fileGrp='OCR-D-OCR')]


def page_groups(directory, rater, beam_width=10):
    """(prepared edges of each page's glyph lattice, the page groups the
    processor launches as lists of page indices): consecutive pages
    while the group fits one launch (``Rater.fused_group_fits``)."""
    from ocrd_keraslm_torch.rater import DECODE_MERGE_MAX
    sizes, maxlens, groups = [], [], []
    for i, doc in enumerate(native_docs(directory)):
        assert doc.bail is None, doc.bail
        _, n_prep, maxlen = doc.lattice('glyph', rater.merge_runs,
                                        DECODE_MERGE_MAX)
        if groups and rater.fused_group_fits(
                sum(sizes[j] for j in groups[-1]) + n_prep,
                max([maxlens[j] for j in groups[-1]] + [maxlen]),
                beam_width):
            groups[-1].append(i)
        else:
            groups.append([i])
        sizes.append(n_prep)
        maxlens.append(maxlen)
    return sizes, groups


def decode_bound(mask, steps, n_real, K, D, W, v_real, nbytes):
    """Least time the card needs for one launch: the larger of its f32
    FLOPs over the f32 peak and its bytes over the memory rate.  FLOPs
    per char step are 2*rows*(D*2W*4W + W*v_real) with rows = K at step
    0 (the parents) and, at later steps, the candidates whose
    alternative still has a char there — the work these inputs need
    (the logits of the vocabulary's padding are masked, not needed)."""
    per_row = 2 * (D * 2 * W * 4 * W + W * v_real)
    flops = 0
    for t in range(n_real):
        if steps[t] >= 1:
            flops += K * per_row
        for s in range(1, int(steps[t])):
            flops += K * int((mask[t, :, s] > 0).sum()) * per_row
    return bound(flops, nbytes)


def bound(flops, nbytes, bf16_flops=0):
    """(least ms, 'operations' or 'bytes', flops): the larger of the
    operations over their peak (``bf16_flops`` of the ``flops`` have bf16
    operands and are held to the tensor cores' bf16 peak, the rest to
    the f32 peak) and the bytes over the memory rate."""
    t_ops = (flops - bf16_flops) / PEAK_F32_FLOPS \
        + bf16_flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', flops)


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# ---------------------------------------------------------------------
# scoring and LSTM-scan kernels
# ---------------------------------------------------------------------

def german_rater(device):
    from ocrd_keraslm_torch.rater import Rater
    rater = Rater(device=device)
    rater.load_config(MODEL)
    rater.configure()
    rater.load_weights(MODEL)
    return rater


def score_inputs(rng, case, device, rater=None):
    """``score_scan``'s arguments for a named case: ``d<D>w<W>[b<B>][t<T>]``
    (seeded weights of depth D, width W, V=40 padded to 128, B streams
    (default 5), T steps (default 100); e.g. ``d2w32b9``) or ``german_b1``, ``german_b4``,
    ``german_d1`` (``model_german.h5``'s weights, its layer 0 alone for
    ``d1``, B=1 or 4, one 4096-step chunk, the layer-0 projection of
    seeded chars under context 179); a seeded nonzero carry, targets
    below ``v_real`` and a mask that ends stream 0 at 2/3 of the chunk."""
    import torch
    from ocrd_keraslm_torch.models.lstm_lm import embed_inputs
    from ocrd_keraslm_torch.ops.score_kernel import pack_score_weights

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if case.startswith('german'):
        rater = rater or german_rater(device)
        D = 1 if case == 'german_d1' else rater.depth
        B, T, W = (1 if case == 'german_b1' else 4), 4096, rater.width
        params = dict(rater.params, lstm=rater.params['lstm'][:D])
        packed = pack_score_weights(params, rater.cfg.replace(depth=D))
        v_real = packed[-1]
        x = t(rng.integers(1, v_real, (B, T)))
        lp0 = params['lstm'][0]
        xp1 = (embed_inputs(params, x, [t(np.full((B,), 179))])
               @ lp0['kernel'] + lp0['bias']).contiguous()
    else:
        D, W, B, T = re.fullmatch(r'd(\d+)w(\d+)(?:b(\d+))?(?:t(\d+))?',
                                  case).groups()
        D, W, B, T, v_real = int(D), int(W), int(B or 5), int(T or 100), 40
        Dw = max(D - 1, 1)
        embT = np.zeros((W, 128), np.float32)
        embT[:, :v_real] = rng.normal(0, 1, (W, v_real))
        packed = [t(rng.normal(0, 1 / np.sqrt(W), (W, 4 * W))),
                  t(rng.normal(0, 1 / np.sqrt(W), (Dw, W, 4 * W))),
                  t(rng.normal(0, 1 / np.sqrt(W), (Dw, W, 4 * W))),
                  t(rng.normal(0, 0.1, (Dw, 1, 4 * W))), t(embT), v_real]
        packed[:4] = [a.float() for a in packed[:4]]
        xp1 = t(rng.normal(0, 1, (B, T, 4 * W)).astype(np.float32))
    mask = np.ones((B, T), np.float32)
    mask[0, 2 * T // 3:] = 0.0
    return (xp1, t(rng.integers(0, v_real, (B, T)).astype(np.int32)),
            t(mask), t(rng.normal(0, 0.5, (D, B, W)).astype(np.float32)),
            t(rng.normal(0, 0.5, (D, B, W)).astype(np.float32))) \
        + tuple(packed)


# the cell state c of model_german.h5 grows to ~3.6e3 over a 4096-step
# chunk, where one f32 ulp is 2.4e-4: both f32 runs drift from a float64
# run by ~1.3e-5*|c| (the plain version, measured on the CPU), so c is
# held relative to its size, the bounded outputs (probs, h) absolutely
C_RTOL = 5e-5


def compare_score(got, want, atol=1e-5, nll_rtol=1e-5):
    """Hold one ``score_scan`` output ``(probs, nll, (h, c))`` against
    another: probs and h within ``atol``, c within ``atol + C_RTOL*|c|``,
    NLL sums within ``nll_rtol`` (the kernel sums in double, the plain
    version in f32).  Returns ``(max abs error of probs and h, max
    relative error of c, probs whose float16 rounding differs)``."""
    import torch
    (p, n, (h, c)), (wp, wn, (wh, wc)) = got, want
    torch.testing.assert_close(p, wp, rtol=0, atol=atol)
    torch.testing.assert_close(n, wn, rtol=nll_rtol, atol=atol)
    torch.testing.assert_close(h, wh, rtol=0, atol=atol)
    torch.testing.assert_close(c, wc, rtol=C_RTOL, atol=atol)
    return (max(float((p - wp).abs().max()), float((h - wh).abs().max())),
            rel_error(c, wc), int((p.half() != wp.half()).sum()))


def compare_lstm(got, want, atol=1e-5):
    """Hold one ``lstm_scan`` output ``(h_all, c_all or None, hT, cT)``
    against another: h within ``atol``, c within ``atol + C_RTOL*|c|``.
    Returns ``(max abs error of h, max relative error of c)``."""
    import torch
    h_err = c_err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None)
        if w is None:
            continue
        if i % 2:   # c_all, cT
            torch.testing.assert_close(g, w, rtol=C_RTOL, atol=atol)
            c_err = max(c_err, rel_error(g, w))
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=atol)
            h_err = max(h_err, float((g - w).abs().max()))
    return h_err, c_err


def rel_error(got, want):
    """max |got - want| / max(1, |want|): the absolute error for values
    of size <= 1, the relative one above."""
    return float(((got.double() - want.double()).abs()
                  / want.double().abs().clamp(min=1.0)).max())


def f64_errors(kernel, plain, args, outputs):
    """:func:`rel_error` of the kernel's and the plain version's outputs
    (``outputs`` picks the float tensors to compare) against the plain
    version run in float64 on the same inputs (a bfloat16 weight stays
    bfloat16: it says where the function rounds)."""
    import torch
    args64 = [a.double() if torch.is_tensor(a) and a.dtype == torch.float32
              else a for a in args]
    want = outputs(plain(*args64))
    return tuple(max(rel_error(g, w) for g, w in zip(outputs(fn(*args)),
                                                      want))
                 for fn in (kernel, plain))


def page_texts(directory):
    """The text each input page is scored as in scoring mode: the first
    alternative of every glyph, with the space and newline edges."""
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.page_fast import parse_page_fast
    from ocrd_keraslm_torch.wrapper.rate import page_get_linear_lattice_at
    ws = Workspace(directory)
    return [''.join(e['alternatives'][0].Unicode for e in
                    page_get_linear_lattice_at('glyph', parse_page_fast(
                        os.path.join(directory, f.local_filename))))
            for f in ws.mets.find_files(fileGrp='OCR-D-OCR')]


def score_chunks(texts):
    """Chunks of the one ``rate_batch`` of ``texts``: launches of
    ``score_scan`` (and, per layer, of ``lstm_scan``)."""
    from ocrd_keraslm_torch.rater import (CHUNK_COUNT_BUCKETS,
                                          SCORE_CHUNK)
    from ocrd_keraslm_torch.utils.buckets import bucket
    n_max = max(max(len(t) - 1 for t in texts), 1)
    return bucket(-(-n_max // SCORE_CHUNK), CHUNK_COUNT_BUCKETS)


def score_main_inputs(rater, texts, context):
    """The main path's first chunk of ``texts`` as ``Rater._score_batch``
    lays it out (streams padded to the batch bucket, T = SCORE_CHUNK,
    zero carry): ``(score_scan's arguments, the embedded input
    (B, T, W + context dims))``."""
    import torch
    from ocrd_keraslm_torch.models.lstm_lm import embed_inputs, zero_carry
    from ocrd_keraslm_torch.ops.score_kernel import pack_score_weights
    from ocrd_keraslm_torch.rater import SCORE_CHUNK, STEP_BUCKETS
    from ocrd_keraslm_torch.utils.buckets import bucket_unbounded
    T = SCORE_CHUNK
    B = bucket_unbounded(len(texts), STEP_BUCKETS)
    x = np.zeros((B, T), np.int64)
    y = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), np.float32)
    for i, text in enumerate(texts):
        ids = rater.vocab.encode(text)[:T + 1]
        n = len(ids) - 1
        x[i, :n], y[i, :n], mask[i, :n] = ids[:-1], ids[1:], 1.0
    dev = rater.device
    params = rater.params
    inp = embed_inputs(params, torch.from_numpy(x).to(dev),
                       [torch.full((B,), context[0], device=dev)])
    lp0 = params['lstm'][0]
    xp1 = (inp @ lp0['kernel'] + lp0['bias']).contiguous()
    h0, c0 = zero_carry(rater.cfg, B, dev)
    return ((xp1, torch.from_numpy(y).to(dev),
             torch.from_numpy(mask).to(dev), h0, c0)
            + tuple(pack_score_weights(params, rater.cfg)), inp)


def cudnn_lstm(rater, depth, inp):
    """A ``torch.nn.LSTM`` (cuDNN) of the model's first ``depth``
    layers, weights mapped (transposed, ``bias_hh`` zero), as a
    function of nothing over the embedded input ``inp``: the library
    yardstick, never called by the port."""
    import torch
    lstm = torch.nn.LSTM(inp.shape[-1], rater.width, num_layers=depth,
                         batch_first=True).to(rater.device)
    state = {}
    for d in range(depth):
        lp = rater.params['lstm'][d]
        state['weight_ih_l%d' % d] = lp['kernel'].T
        state['weight_hh_l%d' % d] = lp['recurrent'].T
        state['bias_ih_l%d' % d] = lp['bias']
        state['bias_hh_l%d' % d] = torch.zeros_like(lp['bias'])
    lstm.load_state_dict(state)

    def run():
        with torch.no_grad():
            return lstm(inp)
    return run


def cuda_ms(fn, reps):
    """Mean ms of ``reps`` launches of ``fn()`` after one warm-up (CUDA
    events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Mean device ms of ``reps`` launches of ``fn()`` back to back: the
    launches queue behind a sleep kernel, so the events time the
    device's work and not the host's enqueue of a kernel shorter than
    the wrapper's own host time (CUDA events, after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))  # ~10 ms at the boost clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def score_bound(args):
    """Bound of one ``score_scan`` launch: FLOPs 2*B*T*(W*4W
    + (D-1)*2W*4W + W*v_real) (every step of the chunk runs, as the carry
    runs on through the padding steps; only the v_real real logits enter
    the logsumexp); bytes of the inputs the function needs read once
    (embT's v_real real columns, no layer->=1 weights at D=1) and every
    output (probs, NLL sums, carry) written once."""
    xp1, y, mask, h0, c0, rec1, kcat, ucat, bias, embT, v_real = args
    B, T, G = xp1.shape
    D, _, W = h0.shape
    flops = 2 * B * T * (W * G + (D - 1) * 2 * W * G + W * v_real)
    ins = tensor_bytes(xp1, y, mask, h0, c0, rec1) + W * v_real * 4
    if D > 1:
        ins += tensor_bytes(kcat, ucat, bias)
    out = (B * T + B + 2 * D * B * W) * 4
    return bound(flops, ins + out)


def lstm_bound(args, want_c_all):
    """Bound of one ``lstm_scan`` launch: FLOPs 2*B*T*W*4W; bytes of
    x_proj, the carry and U read once, h_all (and c_all) and the final
    carry written once."""
    x_proj = args[0]
    B, T, G = x_proj.shape
    W = G // 4
    out = (B * T * W * (2 if want_c_all else 1) + 2 * B * W) * 4
    return bound(2 * B * T * W * G, tensor_bytes(*args) + out)


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def build_kernels():
    """Build the seven kernel sources at once (one ``nvcc`` each, in
    threads); print seconds and ``ptxas`` lines."""
    from concurrent.futures import ThreadPoolExecutor
    from ocrd_keraslm_torch.ops import _build
    from ocrd_keraslm_torch.ops import (decode_kernel, gen_kernel, lstm_cell,
                                        score_kernel)
    sources = [m.SOURCE for m in (decode_kernel, score_kernel, lstm_cell)] \
        + [lstm_cell.BWD_SOURCE, gen_kernel.SOURCE, gen_kernel.TB_SOURCE,
           decode_kernel.BATCH_SOURCE]

    def one(src):
        t0 = time.time()
        path, log = _build.build(src)
        return path, log, time.time() - t0
    t0 = time.time()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host = pool.submit(build_native)
        built = list(pool.map(one, sources))
        host = host.result()
    for src, (path, log, secs) in zip(sources, built):
        name = os.path.splitext(os.path.basename(src))[0]
        print('build %s: nvcc %s -> %s in %.2f s'
              % (name, ' '.join(_build.NVCC_FLAGS),
                 os.path.relpath(path, HERE), secs))
        for line in log.splitlines():
            if any(w in line for w in ('registers', 'spill', 'smem',
                                       'Compiling entry')):
                print('ptxas:', line.strip())
    print('build: %d kernel sources in %.2f s (parallel nvcc)'
          % (len(sources), time.time() - t0))
    for line in host:
        print(line)


def build_native():
    """Build the three host C++ libraries of ``native_src/`` (one
    ``g++`` each, at once) and load them; returns the lines to print:
    each build's seconds and the CPython headers it compiled against."""
    from ocrd_keraslm_torch import native
    inc = native.python_include()
    lines = ['build native: CPython headers %s (Python.h %s)'
             % (inc, 'present' if os.path.isfile(os.path.join(
                 inc, 'Python.h')) else 'MISSING')]
    t0 = time.time()
    for name, path, secs in native.build_all():
        lines.append('build native %s: g++ %s -> %s in %.2f s'
                     % (name, ' '.join(native.CXX_FLAGS),
                        os.path.relpath(path, HERE), secs))
    assert native.load_decode_prep() is not None
    assert native.load_page_scan() is not None
    assert native.load_library() is not None
    lines.append('build native: 3 host C++ libraries in %.2f s (parallel '
                 'g++, beside nvcc), loaded' % (time.time() - t0))
    return lines


def decode_parity(rater, dev, K=16):
    """Phase 3, decode kernel at K (16, or 32: the sharded plan; the
    float64 accuracy lines at K=16 only); returns its max abs error."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    wts = rater._decode_weights(None)
    W, A = rater.width, 4
    weights = (wts['emb'], wts['embT'], wts['wcat'], wts['bias'])

    def run(fn, arrays, n_real, state, cost, walk):
        import torch
        chars, mask, conf, valid, steps = (torch.from_numpy(a).to(dev)
                                           for a in arrays)
        out = fn(*weights, chars, mask, conf, valid, state, cost,
                 lm_weight=0.5, v_real=wts['v_real'], device_walk=walk,
                 alt_steps=steps, n_real=n_real)
        torch.cuda.synchronize()
        return out

    # two chained blocks per L: the carry from the first block's kernel
    # run feeds both versions in the second
    rng = np.random.default_rng(20261016)
    max_err = 0.0
    for L in (1, 8):
        state, cost = rater._fused_traceback(None, K, wts['emb'])
        for b, (E, n) in enumerate(((1024, 1024), (256, 200))):
            arr = random_lattice(rng, E, n, A, L, wts['v_real'])
            t0 = time.time()
            if b == 0 and K == 16:
                print('accuracy L=%d: max |h - h_float64| of the beam '
                      'state after the first %d edges (all runs chose '
                      'alike there): kernel %.3g, plain version %.3g'
                      % ((L,) + state_error_vs_f64(
                          run, dk.decode_lattice, dk.decode_lattice_ref,
                          arr, n, state, cost, W)))
            err, ties, state, cost = parity_block(
                run, dk.decode_lattice, dk.decode_lattice_ref, arr, n,
                state, cost, K, W)
            max_err = max(max_err, err)
            print('parity L=%d block %d (E=%d, n_real=%d, K=%d, A=%d, %d '
                  'blocks a document): every edge compared, max |kernel - '
                  'plain| %.3g, near-ties at the K-th rank resumed from the '
                  'kernel\'s state at edges %s; device walk = host walk of '
                  'the records (tolerances: costs rtol 1e-5 atol 1e-4, '
                  'stateF atol 1e-5, c also rtol 2e-5) in %.1f s'
                  % (L, b, E, n, K, A, dk.cluster_blocks(
                      dev, False, 1, K, A, L, rater.depth, W, wts['v_pad'],
                      wts['v_real']), err, ties or 'none',
                     time.time() - t0))
    return max_err


# sha256 of decode_lattice's outputs in decode_digests, as the kernel
# gave them before its device code moved into csrc/decode_common.cuh
# (commit db47096, NVIDIA H100 80GB HBM3): the move, and the cluster
# layout of decode_edges_cluster at every cluster size, must keep them
# bit for bit
DECODE_DIGESTS = {
    1: 'c1063acb6fb354605e8d0af26495f4564b278c430952fa74e3527b225925a151',
    8: 'bce90cb8e310cd156fdf66ac599e81f291945e8f555904581d883363d1d274d7'}


def decode_digests(rater, dev, bf16=False, K=16):
    """{L: sha256 of ``decode_lattice``'s records, stateF and costF and
    of its device walk} over a seeded 1024-edge block of the german model
    at K (16 or 32), A=4, from a fresh beam; with ``bf16`` the model's
    bf16 decode weights."""
    import hashlib
    import torch
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    wts = rater._decode_weights(None, bf16=bf16)
    out = {}
    for L in (1, 8):
        arrays = random_lattice(np.random.default_rng(20261018 + L), 1024,
                                1024, 4, L, wts['v_real'])
        ins = [torch.from_numpy(a).to(dev) for a in arrays]
        state, cost = rater._fused_traceback(None, K, wts['emb'])
        digest = hashlib.sha256()
        for walk in (False, True):
            res = dk.decode_lattice(
                wts['emb'], wts['embT'], wts['wcat'], wts['bias'], *ins[:4],
                state, cost, lm_weight=0.5, v_real=wts['v_real'],
                device_walk=walk, alt_steps=ins[4], n_real=1024)
            for x in res:
                digest.update(x.cpu().numpy().tobytes())
        out[L] = digest.hexdigest()
    return out


# sha256 of the LSTM recurrences' outputs in score_digests and
# lstm_digests, as the kernels of commit cdb1b2b gave them (one block of
# <= 8 streams, weights read from L2 at every step; NVIDIA H100 80GB
# HBM3): the cluster layouts that replaced them keep every bit
SCORE_DIGESTS = {
    'german_b1':
        '9cbc5fab9f8b3b3d87318becb29d1380f863176f6a8abc3c012574d4934155d7',
    'german_b4':
        '7594335507890e684692e9678c20a70f1e213063af7f0bb0b6edb10db794c91e',
    'german_d1':
        '41b5a2f9f4cef39abf2b214c8a27da385aa76a8ee055b8fc8e3c654a1f8411f8'}
LSTM_DIGESTS = {
    'lstm_scan b4t4096 f32 c_all off':
        '20d0d6ff185e0cf72c516b406d8e772e3f46772436a3c65f2fc142cf2b6250ba',
    'lstm_scan b4t4096 f32 c_all on':
        '13b2fb7768665f079af33fd75c0d5cf365f9fc5afdb4795ac6e7177f56a54d72',
    'lstm_scan b4t4096 bf16 c_all off':
        '04b46b66c297777f672e0e75da81765ea23e8b60b00dcba85369de46ddeeb6a1',
    'lstm_scan b4t4096 bf16 c_all on':
        'a704c4622f2caf2dd51bc5ce6e24543c7fa5501fe39c4f6d13770a1d7dcd762c',
    'lstm_scan train f32 c_all off':
        '8b0f61f4f89120c820572eb7c064b486deeab30c021bc853f4ce4f7cf14a3a0e',
    'lstm_scan train f32 c_all on':
        'f5515055227a98781d67568840b0bfa5b73c916c381e25f47cafcc29c29da1f7',
    'lstm_bwd f32':
        'a9ed409b4b25669808a4904680443fd5dcd8e4638208e7258f7e4a89d7de65b1',
    'lstm_scan train bf16 c_all off':
        '2692185cfa2898d5228d957ec024a0766c4ed4cb69d1397ad86ede6dc24dc4b2',
    'lstm_scan train bf16 c_all on':
        '158e2799ae494e042173a14df6d3e03eb05aecd4487093596677c4ec9b906014',
    'lstm_bwd bf16':
        '905b90bc23bd5e00c9dd6f1946408969ba3e3f3b99b727de2cd2f773049f61d8'}


def _digest(tensors):
    import hashlib
    digest = hashlib.sha256()
    for x in tensors:
        if x is not None:
            digest.update(x.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


def score_digests(rater, dev):
    """{case: sha256 of ``score_scan``'s probs, NLL sums and carry} for
    the three full-width cases of :func:`score_inputs`, each from its
    own seed."""
    from ocrd_keraslm_torch.ops import score_kernel as sk
    out = {}
    for i, case in enumerate(('german_b1', 'german_b4', 'german_d1')):
        args = score_inputs(np.random.default_rng(20261101 + i), case, dev,
                            rater)
        probs, nll, (hT, cT) = sk.score_scan(*args)
        out[case] = _digest((probs, nll, hT, cT))
    return out


def lstm_digests(dev):
    """{name: sha256} of ``lstm_scan``'s outputs (f32 and bf16 U,
    ``c_all`` on and off, at B=4/T=4096 and at the training shape) and of
    ``lstm_bwd``'s (f32 and bf16 U, training shape, from the forward's
    saved states), each from its own seed."""
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    out = {}
    for shape, (B, T) in (('b4t4096', (4, 4096)),
                          ('train', (TRAIN_B, TRAIN_T))):
        for bf16 in (False, True):
            kind = 'bf16' if bf16 else 'f32'
            rng = np.random.default_rng([20261102, B, T, int(bf16)])
            fwd, cot = lstm_train_inputs(rng, dev, bf16, B=B, T=T,
                                         W=TRAIN_W)
            for want_c_all in (False, True):
                got = lc.lstm_scan(*fwd, want_c_all=want_c_all)
                out['lstm_scan %s %s c_all %s' % (
                    shape, kind, 'on' if want_c_all else 'off')] = \
                    _digest(got)
            if shape == 'train':
                out['lstm_bwd %s' % kind] = _digest(lc.lstm_bwd(
                    *lstm_bwd_args(fwd, cot, got[:2])))
    return out


def bwd_digests(dev, layouts):
    """{(layout, 'lstm_bwd f32' or 'bf16'): sha256} of ``lstm_bwd``'s
    outputs in each of ``layouts`` (``(rb, cl, reg)`` as
    :func:`scan_layouts` gives them) on :func:`lstm_digests`' inputs at
    the training shape (the same seeds)."""
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    out = {}
    for bf16 in (False, True):
        rng = np.random.default_rng([20261102, TRAIN_B, TRAIN_T, int(bf16)])
        fwd, cot = lstm_train_inputs(rng, dev, bf16)
        args = lstm_bwd_args(fwd, cot, lc.lstm_scan(*fwd, want_c_all=True)[:2])
        for rb, cl, reg in layouts:
            with scan_layout(rb, cl, reg):
                out[(rb, cl, reg), 'lstm_bwd %s' % (
                    'bf16' if bf16 else 'f32')] = _digest(lc.lstm_bwd(*args))
    return out


BATCH_PARITY_N, BATCH_PARITY_E = 8, 64


def batch_error_vs_f64(run, kernel, plain, arrays, n_real, state, cost, N,
                       K, width):
    """:func:`state_error_vs_f64` for the batched decode: max |h| error
    of the final beams, kernel and plain version each against the plain
    version in float64, over the documents whose three runs made the same
    choices on every edge.  Returns ``(documents compared, documents,
    kernel error, plain error)``."""
    outs = [[x.cpu().numpy() for x in run(fn, arrays, n_real, state, cost)]
            for fn in (kernel, plain, as_float64(plain))]
    D = (outs[0][1].shape[1] // width - 1) // 2
    hs = slice(width, (1 + D) * width)
    alike = [n for n in range(N) if all(np.array_equal(
        out[0][:, :2, n * K:(n + 1) * K], outs[2][0][:, :2, n * K:(n + 1) * K])
        for out in outs[:2])]
    rows = np.concatenate([np.arange(n * K, (n + 1) * K) for n in alike]) \
        if alike else np.zeros(0, int)
    return (len(alike), N) + tuple(
        float(np.abs(out[1][rows] - outs[2][1][rows])[:, hs].max(initial=0))
        for out in outs[:2])


def batch_parity(rater, dev, K=16):
    """Phase 3, the batched decode kernel and its walk at full width and
    K (16, or 32: the sharded plan): kernel against plain version over a
    64-edge block of 8 documents (L in {1, 8}), every document's records
    and final beam equal to a single-document ``decode_lattice`` launch
    bit for bit, the walk kernel equal to its plain version.  Returns
    (max abs error, the kernel's and the plain version's ms on the L=8
    block)."""
    import torch
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    wts = rater._decode_weights(None)
    W, A = rater.width, 4
    N, E = BATCH_PARITY_N, BATCH_PARITY_E
    weights = (wts['emb'], wts['embT'], wts['wcat'], wts['bias'])

    def run(fn, arrays, n_real, state, cost):
        chars, mask, conf, valid, steps = (torch.from_numpy(
            np.ascontiguousarray(a)).to(dev) for a in arrays)
        out = fn(*weights, chars, mask, conf, valid, state, cost, n_docs=N,
                 lm_weight=0.5, v_real=wts['v_real'], alt_steps=steps,
                 n_real=n_real)
        torch.cuda.synchronize()
        return out

    rng = np.random.default_rng(20261019)
    max_err, times = 0.0, None
    for L in (1, 8):
        n_reals = [E] + [int(rng.integers(8, E + 1)) for _ in range(N - 1)]
        arrays = batch_lattice(rng, N, n_reals, E, A, L, wts['v_real'])
        state, cost = rater._batch_beam_init(wts['emb'], N, K)
        t0 = time.time()
        if K == 16:
            print('accuracy decode_lattice_batch L=%d: max |h - h_float64| '
                  'of the final beams of the %d of %d documents whose three '
                  'runs chose alike: kernel %.3g, plain version %.3g'
                  % ((L,) + batch_error_vs_f64(
                      run, dk.decode_lattice_batch,
                      dk.decode_lattice_batch_ref, arrays, E, state, cost,
                      N, K, W)))
        err, ties, _, _ = parity_batch(
            run, dk.decode_lattice_batch, dk.decode_lattice_batch_ref,
            arrays, E, state, cost, N, K, W)
        max_err = max(max_err, err)
        rec, stateF, costF = run(dk.decode_lattice_batch, arrays, E, state,
                                 cost)
        for n in range(N):
            one = [np.ascontiguousarray(a[:, n * A:(n + 1) * A])
                   for a in arrays[:4]]
            one[3] = one[3][..., 0]
            cost_n = torch.full((1, 128), BIG, device=dev)
            cost_n[0, :K] = cost[n * K:(n + 1) * K, 0]
            single = dk.decode_lattice(
                *weights, *(torch.from_numpy(a).to(dev) for a in one),
                state[n * K:(n + 1) * K].contiguous(), cost_n,
                lm_weight=0.5, v_real=wts['v_real'],
                alt_steps=torch.from_numpy(arrays[4][:, 0].copy()).to(dev),
                n_real=E)
            assert torch.equal(single[0][1:].reshape(E, 3, K),
                               rec[:, :, n * K:(n + 1) * K]), n
            assert torch.equal(single[1], stateF[n * K:(n + 1) * K]), n
            assert torch.equal(single[2][0, :K], costF[n * K:(n + 1) * K, 0])
        with decode_cluster(1):
            one_block = run(dk.decode_lattice_batch, arrays, E, state, cost)
        assert all(torch.equal(a, b) for a, b in zip(one_block,
                                                     (rec, stateF, costF)))
        k_in = torch.from_numpy(rng.integers(0, K, N).astype(np.int32)) \
            .to(dev)
        walk = dk.walk_records_batch(rec, k_in, n_docs=N, beam=K)
        walk_ref = dk.walk_records_batch_ref(rec, k_in, n_docs=N, beam=K)
        assert all(torch.equal(a, b) for a, b in zip(walk, walk_ref))
        print('parity decode_lattice_batch L=%d (%d documents, E=%d, '
              'n_real per document %s, K=%d, A=%d): every edge of every '
              'document compared, max |kernel - plain| %.3g, near-ties at '
              'the K-th rank resumed from the kernel\'s state at edges %s '
              '(tolerances: costs rtol 1e-5 atol 1e-4, stateF atol %g, c '
              'also rtol %g); every document\'s records and final beam '
              'equal to a single-document decode_lattice launch bit for '
              'bit (%d blocks a document in the batch, %d in a single '
              'launch) and to the batch in the one-block layout; '
              'walk_records_batch equal to its plain version in %.1f s'
              % (L, N, E, n_reals, K, A, err, ties or 'none',
                 BATCH_STATE_ATOL, BATCH_C_RTOL,
                 dk.cluster_blocks(dev, True, N, K, A, L, rater.depth, W,
                                   wts['v_pad'], wts['v_real']),
                 dk.cluster_blocks(dev, False, 1, K, A, L, rater.depth, W,
                                   wts['v_pad'], wts['v_real']),
                 time.time() - t0))
        if L == 8:
            ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in arrays]

            def call(fn):
                return fn(*weights, *ins[:4], state, cost, n_docs=N,
                          lm_weight=0.5, v_real=wts['v_real'],
                          alt_steps=ins[4], n_real=E)
            times = (cuda_ms(lambda: call(dk.decode_lattice_batch), 3),
                     cuda_ms(lambda: call(dk.decode_lattice_batch_ref), 1))
    return max_err, times


# bf16 decode: the tolerances of one edge, kernel against plain version
# from the same beam (parity_stepwise).  Within an edge of up to 8 char
# steps the two runs' h round to other bf16 values and the differences
# grow from step to step; over every edge of phase 3's blocks (NVIDIA
# H100 80GB HBM3) they reached 0.0127 bits of cost, 0.0347 of xemb and h
# and 0.0331 of c relative to max(1, |c|); held to about twice that.  A
# kernel fault moves h by O(1) and parts the records
BF16_EDGE_TOL = dict(gap=0.03, cost_atol=0.03, state_atol=0.08, c_rtol=0.07)
# sha256 of decode_lattice's outputs under bf16 weights in decode_digests,
# by layout, as the kernel gave them when it was written (NVIDIA H100
# 80GB HBM3): every cluster size gives the cluster layout's bits
DECODE_BF16_DIGESTS = {
    'cluster': {
        1: '8024b429651f8345bb3d8a16bfd4301b5c1bdb5a4e236a9f620c1b7c6b6a34c6',
        8: '4b1824093f5bdbb23212650c6266b0712fca1497151b330bc55b9ee8ffc57cd0'},
    'one-block': {
        1: 'c3fdced38089df686732333f13ce2be212f53a816abc78c76fe18191e6b6373c',
        8: '96215942f991c62a5925cfcb873dca95b10f89572bca46ef7a43175d5df73f09'}}


def parity_stepwise(step, compare, arrays, n_real, state, cost):
    """Hold a kernel against its plain version one edge at a time: at
    every edge ``t`` both decode edge t alone (``step(edge arrays,
    n_real 1 or 0, state, cost)`` returns ``(kernel output, plain
    output)`` as tensors) from the kernel's beam after edge t-1, and
    ``compare(got, want)`` returns ``(max abs error, edge where they
    parted at a near-tie at the K-th rank or None)``.  Under bf16 weights
    two runs that differ in the last bit of an f32 h round it to another
    bf16 value, and the difference grows from edge to edge (each run
    lies as far from a float64 run as from the other): so the runs are
    held to each other edge by edge, not over a block.  A kernel's
    per-edge work does not depend on the block it runs in, so the chained
    one-edge launches give the block launch's bits (the caller checks
    this).  Returns ``(max abs error, near-tie edges, the kernel's
    records of every edge, final state, final cost)``."""
    err, ties, recs = 0.0, [], []
    for t in range(len(arrays[0])):
        part = tuple(a[t:t + 1] for a in arrays)
        got, want = step(part, int(t < n_real), state, cost)
        e, div = compare([x.cpu().numpy() for x in got],
                         [x.cpu().numpy() for x in want])
        err = max(err, e)
        if div is not None:
            ties.append(t)
        recs.append(got[0])
        state, cost = got[1], got[2]
    return err, ties, recs, state, cost


def stepwise_error_vs_f64(run, kernel, plain, arrays, n_real, state, cost,
                         width):
    """:func:`state_error_vs_f64` one edge at a time, as
    :func:`parity_stepwise` holds the bf16 kernel: at every edge kernel,
    plain version and the plain version in float64 decode that edge from
    the kernel's beam; over the edges where the three chose alike, the
    largest cost and xemb/h error of each f32 version against the float64
    run.  Returns ``(edges compared, edges, (kernel cost error, kernel h
    error), (plain cost error, plain h error))``."""
    K = state.shape[0]
    D = (state.shape[1] // width - 1) // 2
    fns = (kernel, plain, as_float64(plain))
    errs = [[0.0, 0.0], [0.0, 0.0]]
    alike = 0
    for t in range(len(arrays[0])):
        part = tuple(a[t:t + 1] for a in arrays)
        outs = [[x.cpu().numpy() for x in run(fn, part, int(t < n_real),
                                              state, cost, False)]
                for fn in fns]
        if all(np.array_equal(o[0][:, :2 * K], outs[2][0][:, :2 * K])
               for o in outs[:2]):
            alike += 1
            fin = outs[2][0][1:, 2 * K:] < 1e29
            for e, o in zip(errs, outs[:2]):
                if fin.any():
                    e[0] = max(e[0], float(np.abs(
                        o[0][1:, 2 * K:] - outs[2][0][1:, 2 * K:])[fin].max()))
                e[1] = max(e[1], float(np.abs(
                    o[1] - outs[2][1])[:, :(1 + D) * width].max()))
        state = run(kernel, part, int(t < n_real), state, cost, False)
        state, cost = state[1], state[2]
    return (alike, len(arrays[0])) + tuple(tuple(e) for e in errs)


def decode_parity_bf16(rater, dev):
    """Phase 3, ``decode_lattice`` under the german model's bf16 decode
    weights, in the cluster layout at every size the shape takes and in
    the one-block layout: its digests (``DECODE_BF16_DIGESTS``), both
    versions' state error against float64, every edge of two chained
    seeded blocks per L in {1, 8} against the plain version
    (:func:`parity_stepwise`, ``BF16_EDGE_TOL``), the chained one-edge
    launches bit-equal to the block's launch, whose device walk equals the
    host walk of its records.  Returns the max abs error."""
    import torch
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    wts = rater._decode_weights(None, bf16=True)
    W, K, A, D = rater.width, 16, 4, rater.depth
    weights = (wts['emb'], wts['embT'], wts['wcat'], wts['bias'])

    def run(fn, arrays, n_real, state, cost, walk):
        chars, mask, conf, valid, steps = (torch.from_numpy(
            np.ascontiguousarray(a)).to(dev) for a in arrays)
        out = fn(*weights, chars, mask, conf, valid, state, cost,
                 lm_weight=0.5, v_real=wts['v_real'], device_walk=walk,
                 alt_steps=steps, n_real=n_real)
        torch.cuda.synchronize()
        return out

    def step(part, n, state, cost):
        return (run(dk.decode_lattice, part, n, state, cost, False),
                run(dk.decode_lattice_ref, part, n, state, cost, False))

    stats = {}

    def compare(got, want):
        e, _, div = compare_decode(got, want, K, W, stats=stats,
                                   **BF16_EDGE_TOL)
        return e, div

    sizes = set(dk.cluster_sizes(K, A, 8, D, W, wts['v_pad'],
                                 wts['v_real'])) & set(
        dk.cluster_sizes(K, A, 1, D, W, wts['v_pad'], wts['v_real']))
    max_err = 0.0
    for cl in sorted(sizes, reverse=True) + [1]:
        layout = 'cluster' if cl > 1 else 'one-block'
        with decode_cluster(cl):
            digests = decode_digests(rater, dev, bf16=True)
            print('decode_lattice bf16 output digests, %s (sha256 of '
                  'records, stateF, costF and the device walk over a seeded '
                  '1024-edge block, K=16): %s; pinned: %s'
                  % ('%d blocks a document' % cl if cl > 1 else
                     'the one-block layout', digests,
                     DECODE_BF16_DIGESTS.get(layout)))
            assert digests == DECODE_BF16_DIGESTS[layout], \
                ('decode_lattice bf16 outputs changed', cl)
            rng = np.random.default_rng(20261016)
            for L in (1, 8):
                state, cost = rater._fused_traceback(None, K, wts['emb'])
                for b, (E, n) in enumerate(((1024, 1024), (256, 200))):
                    arr = random_lattice(rng, E, n, A, L, wts['v_real'])
                    t0 = time.time()
                    if b == 0:
                        print('accuracy bf16 L=%d, %s: max |h - h_float64| '
                              'of the beam state after the first %d edges '
                              '(all runs chose alike there; the float64 '
                              'run rounds its operands to bf16 too): '
                              'kernel %.3g, plain version %.3g'
                              % ((L, layout) + state_error_vs_f64(
                                  run, dk.decode_lattice,
                                  dk.decode_lattice_ref, arr, n, state,
                                  cost, W)))
                    if b == 0:
                        acc = stepwise_error_vs_f64(
                            run, dk.decode_lattice, dk.decode_lattice_ref,
                            tuple(a[:256] for a in arr), n, state, cost, W)
                        print('accuracy bf16 L=%d, %s, edge by edge from '
                              'the kernel\'s beam over the first 256 edges '
                              '(%d where kernel, plain version and float64 '
                              'run chose alike): max |cost - cost_float64| '
                              'and |h - h_float64|: kernel %.3g, %.3g; plain '
                              'version %.3g, %.3g'
                              % ((L, layout, acc[0]) + acc[2] + acc[3]))
                    block = run(dk.decode_lattice, arr, n, state, cost, False)
                    walk = run(dk.decode_lattice, arr, n, state, cost, True)
                    np.testing.assert_array_equal(
                        walk[0].cpu().numpy(),
                        walk_records(block[0].cpu().numpy(), K))
                    stats.clear()
                    err, ties, recs, state_k, cost_k = parity_stepwise(
                        step, compare, arr, n, state, cost)
                    assert torch.equal(torch.cat([r[1:] for r in recs]),
                                       block[0][1:]), 'records'
                    assert torch.equal(state_k, block[1]) and \
                        torch.equal(cost_k, block[2]), 'final beam'
                    max_err = max(max_err, err)
                    print('parity bf16 L=%d block %d (E=%d, n_real=%d, K=%d, '
                          'A=%d), %s: every edge compared from the kernel\'s '
                          'beam, max |kernel - plain| %.3g (costs %.3g, xemb '
                          'and h %.3g, c relative to max(1, |c|) %.3g), '
                          'near-ties at the '
                          'K-th rank at edges %s; the %d one-edge launches '
                          'equal the block launch bit for bit, its device '
                          'walk = host walk of its records (tolerances: '
                          'costs rtol 1e-5 atol %g, ties within %g, stateF '
                          'atol %g, c also rtol %g) in %.1f s'
                          % (L, b, E, n, K, A, layout, err,
                             stats.get('cost', 0.0), stats.get('h', 0.0),
                             stats.get('c_rel', 0.0), ties or 'none', E,
                             BF16_EDGE_TOL['cost_atol'], BF16_EDGE_TOL['gap'],
                             BF16_EDGE_TOL['state_atol'],
                             BF16_EDGE_TOL['c_rtol'], time.time() - t0))
                    state, cost = state_k, cost_k
    return max_err


# sha256 of decode_lattice's outputs in decode_digests at K=32, as the
# parent commit's kernels gave them (d0c0205, the one-block layout, the
# only one K=32 took there; NVIDIA H100 80GB HBM3): the cluster layout's
# sharded plan must keep them bit for bit
DECODE_K32_DIGESTS = {
    1: '2526cc75bed17a6ba959d2aaf86bf5c451b929949a54748c8717988a39d200ff',
    8: 'eeedec42989d130713937a78a54b22daf7d5bb64238465177eab03272f40f0e9'}
# edges of each seeded block of the bf16 K=32 check (edge by edge: two
# launches an edge)
K32_BF16_E = 256


def k32_parity(rater, dev):
    """Phase 3 at K=32 (beam_width 17-32: the cluster layout's sharded
    plan at the german model's width): ``decode_lattice``'s digests in the
    16-block cluster and in the one-block layout against
    ``DECODE_K32_DIGESTS``; the kernel against its plain version over the
    seeded blocks of :func:`decode_parity` (f32) and of
    :func:`batch_parity`; under the bf16 decode weights every edge of a
    seeded block per L against the plain version from the kernel's beam
    (:func:`parity_stepwise`, ``BF16_EDGE_TOL``), the one-edge launches
    bit-equal to the block's.  Returns (f32 error, batch error, the
    batch's parity-block times, bf16 error)."""
    import torch
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    D, W, K, A = rater.depth, rater.width, 32, 4
    t0 = time.time()
    for cl in (16, 1):
        with decode_cluster(cl):
            digests = decode_digests(rater, dev, K=K)
        print('decode_lattice output digests at K=32, %s (sha256 of '
              'records, stateF, costF and the device walk over the seeded '
              '1024-edge blocks of K=16\'s digests): %s; the parent\'s '
              'one-block kernel: %s'
              % ('%d blocks a document, the sharded plan' % cl if cl > 1
                 else 'the one-block layout', digests, DECODE_K32_DIGESTS))
        assert digests == DECODE_K32_DIGESTS, ('K=32 outputs changed', cl)
    print('K=32 digests in %.1f s' % (time.time() - t0))
    err = decode_parity(rater, dev, K)
    batch_err, batch_times = batch_parity(rater, dev, K)
    wts = rater._decode_weights(None, bf16=True)
    weights = (wts['emb'], wts['embT'], wts['wcat'], wts['bias'])

    def run(fn, arrays, n_real, state, cost, walk):
        chars, mask, conf, valid, steps = (torch.from_numpy(
            np.ascontiguousarray(a)).to(dev) for a in arrays)
        out = fn(*weights, chars, mask, conf, valid, state, cost,
                 lm_weight=0.5, v_real=wts['v_real'], device_walk=walk,
                 alt_steps=steps, n_real=n_real)
        torch.cuda.synchronize()
        return out

    def step(part, n, state, cost):
        return (run(dk.decode_lattice, part, n, state, cost, False),
                run(dk.decode_lattice_ref, part, n, state, cost, False))

    stats = {}

    def compare(got, want):
        e, _, div = compare_decode(got, want, K, W, stats=stats,
                                   **BF16_EDGE_TOL)
        return e, div

    rng = np.random.default_rng(20261117)
    bf16_err = 0.0
    for L in (1, 8):
        t0 = time.time()
        state, cost = rater._fused_traceback(None, K, wts['emb'])
        E = n = K32_BF16_E
        arr = random_lattice(rng, E, n, A, L, wts['v_real'])
        block = run(dk.decode_lattice, arr, n, state, cost, False)
        stats.clear()
        e, ties, recs, state_k, cost_k = parity_stepwise(
            step, compare, arr, n, state, cost)
        assert torch.equal(torch.cat([r[1:] for r in recs]),
                           block[0][1:]), 'records'
        assert torch.equal(state_k, block[1]) and \
            torch.equal(cost_k, block[2]), 'final beam'
        bf16_err = max(bf16_err, e)
        print('parity bf16 at K=32, L=%d (E=%d, A=%d, %d blocks a '
              'document): every edge compared from the kernel\'s beam, max '
              '|kernel - plain| %.3g (costs %.3g, xemb and h %.3g, c '
              'relative to max(1, |c|) %.3g), near-ties at the K-th rank at '
              'edges %s; the %d one-edge launches equal the block launch '
              'bit for bit (tolerances: BF16_EDGE_TOL %s) in %.1f s'
              % (L, E, A, dk.cluster_blocks(dev, False, 1, K, A, L, D, W,
                                            wts['v_pad'], wts['v_real'],
                                            True),
                 e, stats.get('cost', 0.0), stats.get('h', 0.0),
                 stats.get('c_rel', 0.0), ties or 'none', E, BF16_EDGE_TOL,
                 time.time() - t0))
    return err, batch_err, batch_times, bf16_err


def batch_parity_bf16(rater, dev):
    """Phase 3, ``decode_lattice_batch`` under bf16 decode weights on the
    64-edge block of 8 documents (L in {1, 8}): every document's records
    and final beam equal to a single-document bf16 ``decode_lattice``
    launch bit for bit, and to the batch in the one-block layout where
    the single launches take it too; every edge of every document against
    the plain version from the kernel's beams (:func:`parity_stepwise`).
    Returns (max abs error, the kernel's and the plain version's ms on
    the L=8 block)."""
    import torch
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    wts = rater._decode_weights(None, bf16=True)
    W, K, A = rater.width, 16, 4
    N, E = BATCH_PARITY_N, BATCH_PARITY_E
    weights = (wts['emb'], wts['embT'], wts['wcat'], wts['bias'])

    def run(fn, arrays, n_real, state, cost):
        chars, mask, conf, valid, steps = (torch.from_numpy(
            np.ascontiguousarray(a)).to(dev) for a in arrays)
        out = fn(*weights, chars, mask, conf, valid, state, cost, n_docs=N,
                 lm_weight=0.5, v_real=wts['v_real'], alt_steps=steps,
                 n_real=n_real)
        torch.cuda.synchronize()
        return out

    def step(part, n, state, cost):
        return (run(dk.decode_lattice_batch, part, n, state, cost),
                run(dk.decode_lattice_batch_ref, part, n, state, cost))

    def compare(got, want):
        err, div = 0.0, None
        for d in range(N):
            e, _, dv = compare_decode(batch_doc(*got, d, K),
                                      batch_doc(*want, d, K), K, W,
                                      stats=stats, **BF16_EDGE_TOL)
            err = max(err, e)
            div = dv if div is None else div
        return err, div

    stats = {}
    rng = np.random.default_rng(20261019)
    max_err, times = 0.0, None
    for L in (1, 8):
        n_reals = [E] + [int(rng.integers(8, E + 1)) for _ in range(N - 1)]
        arrays = batch_lattice(rng, N, n_reals, E, A, L, wts['v_real'])
        state, cost = rater._batch_beam_init(wts['emb'], N, K)
        t0 = time.time()
        rec, stateF, costF = run(dk.decode_lattice_batch, arrays, E, state,
                                 cost)
        stats.clear()
        err, ties, recs, state_k, cost_k = parity_stepwise(
            step, compare, arrays, E, state, cost)
        assert torch.equal(torch.cat(recs), rec) and \
            torch.equal(state_k, stateF) and torch.equal(cost_k, costF)
        max_err = max(max_err, err)
        for n in range(N):
            one = [np.ascontiguousarray(a[:, n * A:(n + 1) * A])
                   for a in arrays[:4]]
            one[3] = one[3][..., 0]
            cost_n = torch.full((1, 128), BIG, device=dev)
            cost_n[0, :K] = cost[n * K:(n + 1) * K, 0]
            single = dk.decode_lattice(
                *weights, *(torch.from_numpy(a).to(dev) for a in one),
                state[n * K:(n + 1) * K].contiguous(), cost_n,
                lm_weight=0.5, v_real=wts['v_real'],
                alt_steps=torch.from_numpy(arrays[4][:, 0].copy()).to(dev),
                n_real=E)
            assert torch.equal(single[0][1:].reshape(E, 3, K),
                               rec[:, :, n * K:(n + 1) * K]), n
            assert torch.equal(single[1], stateF[n * K:(n + 1) * K]), n
            assert torch.equal(single[2][0, :K], costF[n * K:(n + 1) * K, 0])
        print('parity decode_lattice_batch bf16 L=%d (%d documents, E=%d, '
              'n_real per document %s, K=%d, A=%d): every edge of every '
              'document compared from the kernel\'s beams, max |kernel - '
              'plain| %.3g (costs %.3g, xemb and h %.3g, c relative %.3g), '
              'near-ties at the K-th rank at edges %s '
              '(tolerances as decode_lattice bf16\'s); the %d one-edge '
              'launches equal the block launch and every document\'s '
              'records and final beam equal a single-document bf16 '
              'decode_lattice launch bit for bit (%d blocks a document in '
              'the batch, %d in a single launch) in %.1f s'
              % (L, N, E, n_reals, K, A, err, stats.get('cost', 0.0),
                 stats.get('h', 0.0), stats.get('c_rel', 0.0),
                 ties or 'none', E,
                 dk.cluster_blocks(dev, True, N, K, A, L, rater.depth, W,
                                   wts['v_pad'], wts['v_real'], True),
                 dk.cluster_blocks(dev, False, 1, K, A, L, rater.depth, W,
                                   wts['v_pad'], wts['v_real'], True),
                 time.time() - t0))
        if L == 8:
            ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in arrays]

            def call(fn):
                return fn(*weights, *ins[:4], state, cost, n_docs=N,
                          lm_weight=0.5, v_real=wts['v_real'],
                          alt_steps=ins[4], n_real=E)
            times = (cuda_ms(lambda: call(dk.decode_lattice_batch), 3),
                     cuda_ms(lambda: call(dk.decode_lattice_batch_ref), 1))
    return max_err, times


def sass_hmma():
    """{function name: HMMA instructions in its SASS} of the two decode
    libraries as built (``cuobjdump -sass``)."""
    import subprocess as sp
    from ocrd_keraslm_torch.ops import _build
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    counts = {}
    for src in (dk.SOURCE, dk.BATCH_SOURCE):
        path = _build.build(src)[0]
        tool = os.path.join(os.path.dirname(_build._nvcc(src)), 'cuobjdump')
        sass = sp.run([tool, '-sass', path], capture_output=True, text=True,
                      check=True).stdout
        fn = None
        for line in sass.splitlines():
            if 'Function :' in line:
                fn = line.split('Function :')[1].strip()
                counts[fn] = 0
            elif fn is not None and 'HMMA' in line:
                counts[fn] += 1
    return counts


def score_parity(rater, dev):
    """Phase 3, scoring and LSTM-scan kernels at full width; returns
    their max abs errors."""
    import torch
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import score_kernel as sk
    rng = np.random.default_rng(20261017)
    score_err = 0.0
    for case in ('german_b1', 'german_b4', 'german_d1'):
        args = score_inputs(rng, case, dev, rater)
        t0 = time.time()
        got = sk.score_scan(*args)
        torch.cuda.synchronize()
        err, c_err, flips = compare_score(got, sk.score_scan_ref(*args))
        score_err = max(score_err, err)
        print('parity score_scan %s (B=%d, T=%d, D=%d, W=%d, Vp=%d, '
              'v_real=%d, nonzero carry, stream 0 masked from step %d): '
              'max |kernel - plain| %.3g over probs and h, relative %.3g '
              'over c (max |c| %.4g), %d of %d probs round to another '
              'float16 (tolerances: probs and h atol 1e-5, c atol 1e-5 + '
              'rtol %g, NLL sums rtol 1e-5) in %.1f s'
              % (case, args[0].shape[0], args[0].shape[1],
                 args[3].shape[0], args[3].shape[2], args[9].shape[1],
                 args[10], 2 * args[0].shape[1] // 3, err, c_err,
                 float(got[2][1].abs().max()), flips,
                 args[0].shape[0] * args[0].shape[1], C_RTOL,
                 time.time() - t0))
        if case == 'german_b4':
            print('accuracy score_scan %s: max |x - x_float64| / max(1, '
                  '|x_float64|) over probs, h and c: kernel %.3g, plain '
                  'version %.3g' % ((case,) + f64_errors(
                      sk.score_scan, sk.score_scan_ref, args,
                      lambda out: (out[0], out[2][0], out[2][1]))))
    W = rater.width
    x_proj = score_inputs(rng, 'german_b4', dev, rater)[0]
    lstm_args = (x_proj,
                 torch.from_numpy(rng.normal(0, 0.5, (4, W)).astype(
                     np.float32)).to(dev),
                 torch.from_numpy(rng.normal(0, 0.5, (4, W)).astype(
                     np.float32)).to(dev),
                 rater.params['lstm'][0]['recurrent'])
    lstm_err = 0.0
    for want_c_all in (False, True):
        got = lc.lstm_scan(*lstm_args, want_c_all=want_c_all)
        torch.cuda.synchronize()
        err, c_err = compare_lstm(got, lc.lstm_scan_ref(
            *lstm_args, want_c_all=want_c_all))
        lstm_err = max(lstm_err, err)
        print('parity lstm_scan (B=4, T=4096, W=%d, german layer 0, '
              'nonzero carry, c_all %s): max |kernel - plain| %.3g over '
              'h_all and hT, relative %.3g over %scT (tolerances: h atol '
              '1e-5, c atol 1e-5 + rtol %g)'
              % (W, 'on' if want_c_all else 'off', err, c_err,
                 'c_all and ' if want_c_all else '', C_RTOL))
    print('accuracy lstm_scan: max |x - x_float64| / max(1, |x_float64|) '
          'over h_all, hT and cT: kernel %.3g, plain version %.3g'
          % f64_errors(lc.lstm_scan, lc.lstm_scan_ref, lstm_args,
                       lambda out: (out[0], out[2], out[3])))
    return score_err, lstm_err


def _wrappers():
    from ocrd_keraslm_torch.ops import (decode_kernel, gen_kernel, lstm_cell,
                                        score_kernel)
    return {'decode_lattice': decode_kernel.decode_lattice,
            'score_scan': score_kernel.score_scan,
            'lstm_scan': lstm_cell.lstm_scan,
            'lstm_bwd': lstm_cell.lstm_bwd,
            'gen_beam': gen_kernel.gen_beam,
            'gen_traceback': gen_kernel.traceback,
            'decode_lattice_batch': decode_kernel.decode_lattice_batch,
            'walk_records_batch': decode_kernel.walk_records_batch}


LANE_COUNTERS = ('pages', 'groups', 'bails')


def zero_counts():
    from ocrd_keraslm_torch.wrapper import page_native
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for name in BF16_COUNTERS:
        wrappers[name].launches_bf16 = 0
    for name in LANE_COUNTERS:
        setattr(page_native, name, 0)


def read_counts():
    """Launches of each kernel wrapper, the decode kernels' bf16 launches
    apart (``<name>_bf16``)."""
    wrappers = _wrappers()
    return dict({name: fn.launches for name, fn in wrappers.items()},
                **{name + '_bf16': wrappers[name].launches_bf16
                   for name in BF16_COUNTERS})


def read_lanes():
    """The native page lane's counters: pages it served, page-group
    launches, documents it bailed on."""
    from ocrd_keraslm_torch.wrapper import page_native
    return {name: getattr(page_native, name) for name in LANE_COUNTERS}


def check_glyphs(directory, n_glyphs):
    glyphs, files = output_glyphs(directory)
    assert len(files) == 4, 'pages written: %d of 4' % len(files)
    assert len(glyphs) == n_glyphs, (len(glyphs), n_glyphs)
    bad = [g for g, tes in glyphs.items() if len(tes) != 1]
    assert not bad, 'glyphs without one TextEquiv: %s' % bad[:5]


def small_card_vs_cpu(work, rater, scoring, tol):
    """A small workspace through the CLI on the card and on the CPU:
    same Unicode per glyph, confs within ``tol``; returns the max conf
    difference and the glyphs."""
    outs = {}
    for platform in ('cuda', 'cpu'):
        small = os.path.join(work, 'small_%s_%d' % (platform, scoring))
        build_workspace(small, np.random.default_rng(8), 2, 3,
                        rater.vocab, alt_share=0.3)
        run_cli(small, platform, scoring=scoring)
        outs[platform] = output_glyphs(small)[0]
    assert outs['cuda'].keys() == outs['cpu'].keys()
    conf_err = 0.0
    for gid, ((u_g, c_g),) in outs['cuda'].items():
        ((u_c, c_c),) = outs['cpu'][gid]
        assert u_g == u_c, (gid, u_g, u_c)
        conf_err = max(conf_err, abs(c_g - c_c))
    assert conf_err <= tol, conf_err
    return conf_err, len(outs['cuda'])


# a near-tie of the host engine: two choices whose path costs, both
# decoded on the CPU, lie within this many bits
HOST_TIE_BITS = 1e-3


@contextlib.contextmanager
def counted_predict_steps():
    """Count the host engine's device steps (``rater._predict_step``
    calls) inside the block: yields a one-element list."""
    from ocrd_keraslm_torch import rater as rater_mod
    plain, calls = rater_mod._predict_step, [0]

    def counted(*args):
        calls[0] += 1
        return plain(*args)
    rater_mod._predict_step = counted
    try:
        yield calls
    finally:
        rater_mod._predict_step = plain


@contextlib.contextmanager
def branching_pages(page_ids):
    """The port's lattice builder returns, for the pages ``page_ids``, a
    DiGraph with a diamond bypass (two routes of a space between two
    chain nodes in the middle of the page): a lattice the device engine
    refuses, so the processor's device lane bails into the host
    engine."""
    import networkx as nx
    from ocrd_keraslm_torch.wrapper import rate as rate_mod
    from ocrd_keraslm_torch.wrapper.page import TextEquivType
    orig = rate_mod.page_get_linear_lattice_at

    def build(level, pcgts, logger=None):
        edges = orig(level, pcgts, logger=logger)
        if pcgts.get_pcGtsId() not in page_ids:
            return edges
        g = nx.DiGraph()
        g.add_node(0)
        for i, e in enumerate(edges):
            g.add_edge(i, i + 1, **e)
        m = len(edges) // 2
        for u, v in ((m, 'bypass'), ('bypass', m + 1)):
            g.add_edge(u, v, element=None, alternatives=[
                TextEquivType(Unicode=' ', conf=0.4, index=0)])
        return g
    rate_mod.page_get_linear_lattice_at = build
    try:
        # the native lane builds its lattices in C++: a customised
        # builder reaches the record lane only
        with env_vars(KERASLM_NATIVE_PAGE='0'):
            yield
    finally:
        rate_mod.page_get_linear_lattice_at = orig


def choices_cost(cpu_rater, directory, choices):
    """Bits of the path that takes, at every glyph, the input
    alternative of index ``choices[glyph id]``, decoded by the host
    engine on the CPU over the workspace's first page."""
    from ocrd_keraslm_torch.wrapper import rate as rate_mod
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.page import parse_page
    ws = Workspace(directory)
    f = next(ws.mets.find_files(fileGrp='OCR-D-OCR'))
    pcgts = parse_page(os.path.join(directory, f.local_filename))
    graph, start, end = rate_mod.page_get_linear_graph_at('glyph', pcgts)
    for _, _, edge in graph.edges(data=True):
        el = edge['element']
        if el is not None and el.id in choices:
            edge['alternatives'] = [te for te in edge['alternatives']
                                    if te.index == choices[el.id]]
    _, ent, tb = cpu_rater.rate_best(
        graph, start, end, context=rate_mod.mets_get_context(ws.mets),
        beam_width=10, beam_clustering_dist=rate_mod.BEAM_CLUSTERING_DIST)
    return ent + cpu_rater.next_path(tb[0], ([], tb[1]))[1]


def host_card_vs_cpu(rater, work, name, n_lines, branching):
    """A one-page seeded workspace through the CLI on the card and on
    the CPU by the host engine: ``-P device_decoding false``, or, with
    ``branching``, the default device lane on a branching page, which
    bails into the host engine.  Same choice per glyph and confs within
    1e-4; where the choices part at a near-tie (both choices' path
    costs, decoded on the CPU, within ``HOST_TIE_BITS``), the glyphs are
    listed and pass.  Returns the card's numbers."""
    import torch
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    outs, walls, steps = {}, {}, {}
    for platform in ('cuda', 'cpu'):
        d = os.path.join(work, '%s_%s' % (name, platform))
        n_glyphs = build_workspace(d, np.random.default_rng(7), 1, n_lines,
                                   rater.vocab)
        ctx = branching_pages({'phys_0001'}) if branching else \
            contextlib.nullcontext()
        zero_counts()
        with ctx, counted_predict_steps() as calls:
            t0 = time.time()
            run_cli(d, platform, host=not branching)
            if platform == 'cuda':
                torch.cuda.synchronize()
            walls[platform] = time.time() - t0
        steps[platform] = calls[0]
        counts = read_counts()
        assert counts == NO_LAUNCHES, (name, platform, counts)
        assert calls[0] > 0, (name, platform, 'no host engine step')
        glyphs, files = output_glyphs(d)
        assert len(files) == 1 and len(glyphs) == n_glyphs
        assert all(len(tes) == 1 for tes in glyphs.values())
        outs[platform] = (d, glyphs)
    assert steps['cuda'] == steps['cpu'], steps
    (d_card, card), (d_cpu, cpu) = outs['cuda'], outs['cpu']
    conf_err, ties = 0.0, []
    for gid, ((u_g, c_g),) in card.items():
        ((u_c, c_c),) = cpu[gid]
        if u_g != u_c:
            ties.append(gid)
        else:
            conf_err = max(conf_err, abs(c_g - c_c))
    cost_gap = 0.0
    if ties:
        # the index of every written TextEquiv is the input alternative's
        cpu_rater = german_rater('cpu')
        picks = []
        for d in (d_card, d_cpu):
            ws = Workspace(d)
            f = next(ws.mets.find_files(fileGrp='OCR-D-LM'))
            picks.append(output_indices(os.path.join(d, f.local_filename)))
        costs = [choices_cost(cpu_rater, d_cpu, c) for c in picks]
        cost_gap = abs(costs[0] - costs[1])
        assert cost_gap <= HOST_TIE_BITS, (name, ties, costs)
    else:
        assert conf_err <= 1e-4, (name, conf_err)
    return dict(glyphs=len(card), wall=walls['cuda'], wall_cpu=walls['cpu'],
                steps=steps['cuda'], conf_err=conf_err, ties=ties,
                cost_gap=cost_gap)


def output_indices(path):
    """{glyph id: index of its one TextEquiv} of a written page."""
    from ocrd_keraslm_torch.wrapper.page import parse_page
    pcgts = parse_page(path)
    return {g.id: g.get_TextEquiv()[0].index
            for region in pcgts.get_Page().get_TextRegion()
            for line in region.get_TextLine()
            for word in line.get_Word() for g in word.get_Glyph()}


def host_engine_path(rater, work, card):
    """Phase 6, the host decode engine on the card: page 1 of the seeded
    workspace (40 lines) with ``-P device_decoding false``, and a
    branching page (10 lines) through the default device lane's bail,
    each card against CPU; returns their numbers."""
    out = {}
    for name, n_lines, branching, what in (
            ('host', 40, False, '-P device_decoding false'),
            ('bail', 10, True, 'the device lane on a branching page '
             '(bailed into the host engine)')):
        res = host_card_vs_cpu(rater, work, name, n_lines, branching)
        print('host engine path, %s: 1 page, %d glyphs written; no kernel '
              'launched; %d host engine steps (_predict_step calls: one a '
              'char position and edge), the same on the CPU; %.3f s on the '
              'card (CLI call incl. model load, host clock), %.3f s on the '
              'CPU; choices %s, max conf diff %.3g (tolerance 1e-4)%s [%s]'
              % (what, res['glyphs'], res['steps'], res['wall'],
                 res['wall_cpu'], 'equal on the card and on the CPU'
                 if not res['ties'] else 'equal but at %d glyph(s) of a '
                 'near-tie' % len(res['ties']), res['conf_err'],
                 '; near-tie glyphs %s, path costs %.3g bits apart '
                 '(tolerance %g)' % (res['ties'][:5], res['cost_gap'],
                                     HOST_TIE_BITS) if res['ties'] else '',
                 card))
        out[name] = res
    return out


def decode_path(rater, work):
    """Phase 4; returns the path's numbers."""
    from ocrd_keraslm_torch.rater import E_BUCKETS
    big = os.path.join(work, 'ws')
    n_glyphs = build_workspace(big, np.random.default_rng(7), 4, 40,
                               rater.vocab)
    sizes, groups = page_groups(big, rater)
    n_edges = sum(sizes)
    zero_counts()
    t0 = time.time()
    run_cli(big, 'cuda')
    wall = time.time() - t0
    counts, lanes = read_counts(), read_lanes()
    check_glyphs(big, n_glyphs)
    assert counts == dict(NO_LAUNCHES, decode_lattice=len(groups)), \
        (counts, groups)
    assert lanes == dict(pages=4, groups=len(groups), bails=0), lanes
    print('decode path: 4 pages, %d glyphs, %d decode edges (%s a page) '
          'written; launches %s (expected %d decode_lattice: one a page '
          'group of <= %d edges, groups %s); the native page lane served '
          '%d pages in %d group launch(es), %d bails'
          % (n_glyphs, n_edges, sizes, counts, len(groups), E_BUCKETS[-1],
             groups, lanes['pages'], lanes['groups'], lanes['bails']))
    conf_err, n_small = small_card_vs_cpu(work, rater, False, 1e-4)
    print('decode path small workspace: %d glyphs, same choices on the '
          'card and on the CPU, max conf diff %.3g (tolerance 1e-4)'
          % (n_small, conf_err))
    # the native lane against the record lane (KERASLM_NATIVE_PAGE=0),
    # alternating on fresh copies of the same 4 pages
    walls = {'native': [], 'records': []}
    for i, lane in enumerate(('native', 'records') * 2):
        d = os.path.join(work, 'ws_lane%d' % i)
        build_workspace(d, np.random.default_rng(7), 4, 40, rater.vocab)
        zero_counts()
        with env_vars(**LANES[lane]):
            t0 = time.time()
            run_cli(d, 'cuda')
            walls[lane].append(time.time() - t0)
        assert read_lanes()['pages'] == (4 if lane == 'native' else 0)
        assert output_glyphs(d)[0] == output_glyphs(big)[0], lane
    # where the host time goes: the same pages once more, split
    d = os.path.join(work, 'ws_split')
    build_workspace(d, np.random.default_rng(7), 4, 40, rater.vocab)
    with decode_split() as split:
        t0 = time.time()
        run_cli(d, 'cuda')
        split_wall = time.time() - t0
    # where the time goes: the same four pages (a fresh copy) once
    # more, under torch.profiler
    traced = os.path.join(work, 'ws_traced')
    build_workspace(traced, np.random.default_rng(7), 4, 40, rater.vocab)
    traced_wall, busy = profile_main_path(traced)
    return dict(wall=wall, n_edges=n_edges, launches=counts,
                traced_wall=traced_wall, busy=busy, workspace=big,
                lane_walls=walls, split=split, split_wall=split_wall,
                sizes=sizes, groups=groups)


@contextlib.contextmanager
def decode_split():
    """Host seconds of the decoding processor's parts, summed into the
    yielded dict while the block runs (host clocks around the port's
    calls): ``model load``, ``page scan`` (``NativePageDoc`` and the
    record lanes' parsers: in the prefetch thread, beside the rest),
    ``lattice and fill`` (the native lattice and array fill, the record
    lane's lattice), ``launch`` (``Rater._launch_decode``: uploads and
    the kernel launch, which does not wait), ``finish`` (the group,
    array and record finishes: the wait for the device and the walk)
    and ``splice write-back`` (``apply_decode``, the record lane's
    write-back and ``_write_page``)."""
    from ocrd_keraslm_torch import rater as rmod
    from ocrd_keraslm_torch.wrapper import page_native
    from ocrd_keraslm_torch.wrapper import rate as wmod
    secs = dict.fromkeys(('model load', 'page scan', 'lattice and fill',
                          'launch', 'finish', 'splice write-back'), 0.0)
    saved = []

    def wrap(obj, name, key):
        fn, raw = getattr(obj, name), vars(obj)[name]

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                secs[key] += time.perf_counter() - t0
        saved.append((obj, name, raw))
        setattr(obj, name, staticmethod(timed)
                if isinstance(raw, staticmethod) else timed)
    doc = page_native.NativePageDoc
    for obj, name, key in (
            (wmod.KerasRate, 'setup', 'model load'),
            (doc, '__init__', 'page scan'),
            (wmod, 'parse_page_fast', 'page scan'),
            (wmod, 'parse_page', 'page scan'),
            (doc, 'lattice', 'lattice and fill'),
            (doc, 'fill', 'lattice and fill'),
            (wmod, 'page_get_linear_lattice_at', 'lattice and fill'),
            (rmod.Rater, '_launch_decode', 'launch'),
            (rmod.Rater, 'rate_best_device_finish_group', 'finish'),
            (rmod.Rater, 'rate_best_device_finish_arrays', 'finish'),
            (rmod.Rater, 'rate_best_device_finish', 'finish'),
            (doc, 'apply_decode', 'splice write-back'),
            (wmod, '_page_update_from_path', 'splice write-back'),
            (wmod, 'page_update_higher_textequiv_levels',
             'splice write-back'),
            (wmod.KerasRate, '_write_page', 'splice write-back')):
        wrap(obj, name, key)
    try:
        yield secs
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


@contextlib.contextmanager
def scoring_split():
    """Host seconds of the scoring processor's parts, summed into the
    yielded dict while the block runs (host clocks around the port's own
    calls, which stay as they are): ``model load`` (``KerasRate.setup``),
    ``PAGE parse and lattice`` (``parse_page_fast``/``parse_page`` and
    ``page_get_linear_lattice_at``), ``prep and upload`` (the outermost
    ``Rater._score_batch`` up to its ``_score_stream`` call: ids,
    contexts, padding, host-to-device copies), ``kernel`` (``_score_stream``
    between two synchronisations: the layer-0 projection and the
    ``score_scan`` launches), ``fetch`` (the rest of ``_score_batch``:
    device-to-host copies, per-text slices) and ``write-back``
    (``_apply_confidences`` and ``_write_page``)."""
    import torch
    from ocrd_keraslm_torch import rater as rmod
    from ocrd_keraslm_torch.wrapper import rate as wmod
    secs = dict.fromkeys(('model load', 'PAGE parse and lattice',
                          'prep and upload', 'kernel', 'fetch',
                          'write-back'), 0.0)
    marks = {'depth': 0}
    saved = []

    def wrap(obj, name, key, sync=False):
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if sync:
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                secs[key] += t1 - t0
                if sync:
                    marks.setdefault('stream', t0)
                    marks['stream_end'] = t1
        saved.append((obj, name, fn))
        setattr(obj, name, timed)

    def score_batch(fn):
        def timed(*args, **kwargs):
            marks['depth'] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                marks['depth'] -= 1
                if not marks['depth']:
                    t1 = time.perf_counter()
                    start = marks.pop('stream', t1)
                    secs['prep and upload'] += start - t0
                    secs['fetch'] += t1 - marks.pop('stream_end', t1)
        return timed

    wrap(wmod.KerasRate, 'setup', 'model load')
    for name in ('parse_page_fast', 'parse_page',
                 'page_get_linear_lattice_at'):
        wrap(wmod, name, 'PAGE parse and lattice')
    wrap(wmod.KerasRate, '_apply_confidences', 'write-back')
    wrap(wmod.KerasRate, '_write_page', 'write-back')
    wrap(rmod, '_score_stream', 'kernel', sync=True)
    saved.append((rmod.Rater, '_score_batch', rmod.Rater._score_batch))
    rmod.Rater._score_batch = score_batch(rmod.Rater._score_batch)
    try:
        yield secs
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


def scoring_path(rater, work):
    """Phase 5; returns the path's numbers."""
    from click.testing import CliRunner
    from ocrd_keraslm_torch.scripts.run import cli as keraslm_rate
    ws = os.path.join(work, 'ws_score')
    n_glyphs = build_workspace(ws, np.random.default_rng(7), 4, 40,
                               rater.vocab)
    texts = page_texts(ws)
    chunks = score_chunks(texts)
    zero_counts()
    t0 = time.time()
    run_cli(ws, 'cuda', scoring=True)
    wall = time.time() - t0
    counts = read_counts()
    check_glyphs(ws, n_glyphs)
    assert counts == dict(NO_LAUNCHES, score_scan=chunks), (counts, chunks)
    n_chars = sum(len(t) for t in texts)
    print('scoring path: 4 pages, %d glyphs, %d chars scored in one '
          'rate_batch; launches %s (expected %d score_scan, one per '
          '4096-char chunk)' % (n_glyphs, n_chars, counts, chunks))
    # the CPU scores through the layered path: per-char probs agree to
    # f32 rounding, but may round to neighbouring float16 values (one
    # step is at most 4.9e-4 below 1), which moves a glyph's blended
    # conf by lm_weight (0.5) times that
    tol = 1e-4 + 0.5 * 2.0 ** -11
    conf_err, n_small = small_card_vs_cpu(work, rater, True, tol)
    print('scoring path small workspace: %d glyphs, the same on the card '
          'and on the CPU, max conf diff %.3g (tolerance 1e-4 plus one '
          'float16 step of a prob times lm_weight: %.3g)'
          % (n_small, conf_err, tol))
    # the layered path through the Rater API
    import torch
    context = [179]
    fused = rater.rate_batch(texts, [context] * 4)
    rater.fused_score = False
    zero_counts()
    layered = rater.rate_batch(texts, [context] * 4)
    torch.cuda.synchronize()
    layered_counts = read_counts()
    rater.fused_score = True
    assert layered_counts == dict(NO_LAUNCHES,
                                  lstm_scan=rater.depth * chunks), \
        layered_counts
    diff = max(float(np.abs(np.subtract(a, b)).max())
               for a, b in zip(fused, layered))
    assert diff <= 2.0 ** -11, diff
    print('layered path (Rater.rate_batch, fused_score off, same 4 '
          'pages): launches %s (expected %d lstm_scan, one per layer and '
          'chunk); max |rating - fused rating| %.3g (tolerance: one '
          'float16 step, 4.9e-4)' % (layered_counts,
                                     rater.depth * chunks, diff))
    # keraslm-rate test and apply, card against CPU
    rng = np.random.default_rng(9)
    words = [w for w in GERMAN_WORDS if set(w) <= _charset(rater.vocab)]
    corpus = os.path.join(work, 'corpus')
    os.makedirs(corpus)
    for name, n in (('kant_smoke_1784.txt', 1200), ('lessing_smoke_1779'
                                                    '.txt', 300)):
        with open(os.path.join(corpus, name), 'w', encoding='utf-8') as fh:
            fh.write(' '.join(words[i] for i in
                              rng.integers(len(words), size=n)))
    sentence = ' '.join(words[i] for i in rng.integers(len(words), size=40))
    outs = {}
    for platform in ('cuda', 'cpu'):
        runner = CliRunner()
        env = {'KERASLM_PLATFORM': platform}
        zero_counts()
        res_t = runner.invoke(keraslm_rate, ['-l', 'WARNING', 'test', '-m',
                                             MODEL, corpus], env=env)
        res_a = runner.invoke(keraslm_rate, ['-l', 'WARNING', 'apply',
                                             '-m', MODEL, '-c', '1784',
                                             sentence], env=env)
        for res in (res_t, res_a):
            assert res.exit_code == 0, (res.output, res.exception)
        ppl_a, ratings = res_a.output.strip().splitlines()[-2:]
        outs[platform] = (float(res_t.output.strip().splitlines()[-1]),
                          float(ppl_a), json.loads(ratings), read_counts())
    (t_g, a_g, r_g, c_g), (t_c, a_c, r_c, _) = outs['cuda'], outs['cpu']
    assert c_g['score_scan'] >= 2, c_g
    assert abs(t_g - t_c) <= 1e-4 * t_c and abs(a_g - a_c) <= 1e-4 * a_c
    r_diff = max(abs(p - q) for (_, p), (_, q) in zip(r_g, r_c))
    assert [c for c, _ in r_g] == [c for c, _ in r_c] and r_diff <= 1e-3
    print('keraslm-rate test (2 files, %d chars): ppl %.6f on the card, '
          '%.6f on the CPU; apply (%d chars, context 1784): ppl %.6f and '
          '%.6f, max rating diff %.3g; card launches %s (tolerances: ppl '
          'rtol 1e-4, ratings atol 1e-3)'
          % (sum(os.path.getsize(os.path.join(corpus, f))
                 for f in os.listdir(corpus)), t_g, t_c, len(sentence),
             a_g, a_c, r_diff, c_g))
    split_ws = os.path.join(work, 'ws_score_split')
    build_workspace(split_ws, np.random.default_rng(7), 4, 40, rater.vocab)
    with scoring_split() as split:
        t0 = time.time()
        run_cli(split_ws, 'cuda', scoring=True)
        split_wall = time.time() - t0
    split['other (CLI, METS, setup outside the model)'] = \
        split_wall - sum(split.values())
    traced = os.path.join(work, 'ws_score_traced')
    build_workspace(traced, np.random.default_rng(7), 4, 40, rater.vocab)
    traced_wall, busy = profile_main_path(traced, scoring=True)
    return dict(wall=wall, n_chars=n_chars, texts=texts, split=split,
                split_wall=split_wall, workspace=ws,
                launches=counts['score_scan'],
                lstm_launches=layered_counts['lstm_scan'],
                traced_wall=traced_wall, busy=busy)


BATCH_DOCS, BATCH_MULTI, BATCH_PAGES = 32, 8, 4


def page_contents(directory, grp='OCR-D-LM'):
    """{element id: (texts, confs)} of every region, line, word and
    glyph of the pages written to ``grp``."""
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.page import parse_page
    out = {}
    for f in Workspace(directory).mets.find_files(fileGrp=grp):
        pcgts = parse_page(os.path.join(directory, f.local_filename))
        for region in pcgts.get_Page().get_AllRegions():
            els = [region]
            for line in region.get_TextLine():
                els.append(line)
                for word in line.get_Word():
                    els += [word] + list(word.get_Glyph())
            for el in els:
                out[el.id] = tuple((te.Unicode, te.conf)
                                   for te in el.get_TextEquiv())
    return out


def output_files(directory, grp='OCR-D-LM'):
    """{file name: the written page}, its Created and LastChange times
    blanked."""
    d = os.path.join(directory, grp)
    return {name: re.sub(r'<(Created|LastChange)>[^<]*</\1>', r'<\1/>',
                         open(os.path.join(d, name), encoding='utf-8').read())
            for name in sorted(os.listdir(d))}


def output_choices(directory):
    """{glyph id: index of its one TextEquiv} over every written page."""
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    out = {}
    for f in Workspace(directory).mets.find_files(fileGrp='OCR-D-LM'):
        out.update(output_indices(os.path.join(directory, f.local_filename)))
    return out


def concat_choices(rater, directory, picks=None):
    """(glyph id: index chosen, bits) of the decode of every input page
    of ``directory`` as ONE lattice (``Rater.concat_graphs``) by
    ``rater``; with ``picks`` ({glyph id: index}) every such glyph keeps
    only that alternative (the bits of that path)."""
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.rate import mets_get_context
    pages = workspace_graphs(directory)
    if picks is not None:
        for g in pages:
            for _, _, e in g.edges(data=True):
                el = e['element']
                if el is not None and el.id in picks:
                    e['alternatives'] = [te for te in e['alternatives']
                                         if te.index == picks[el.id]]
    whole = rater.concat_graphs(pages)
    path, ent, _ = rater.rate_best_device(
        whole, 0, 0, context=mets_get_context(Workspace(directory).mets),
        beam_width=10)
    return {el.id: te.index for el, te, _ in path if el is not None}, ent


@contextlib.contextmanager
def reverse_walk_clock():
    """Seconds of the lookahead's reverse walk (the
    ``rate_best_device_finish`` calls with ``return_entry``), summed
    into the yielded list's first item."""
    from ocrd_keraslm_torch import rater as rmod
    fn = rmod.Rater.rate_best_device_finish
    secs = [0.0]

    def timed(self, pending, start_slot=0, return_entry=False):
        t0 = time.perf_counter()
        try:
            return fn(self, pending, start_slot=start_slot,
                      return_entry=return_entry)
        finally:
            if return_entry:
                secs[0] += time.perf_counter() - t0
    rmod.Rater.rate_best_device_finish = timed
    try:
        yield secs
    finally:
        rmod.Rater.rate_best_device_finish = fn


def lane_path(rater, work, card):
    """Phase 6, the page lanes on the card: the native, record and
    object lanes give the same content (a seeded 2-page workspace, 30%
    of the glyphs with alternatives); page groups on and off
    (``KERASLM_FUSE_PAGES``) write byte-identical files over 16 short
    pages (6 lines), launches and walls alternating; lookahead
    write-back over the 4-page workspace of phase 4 equals the card's
    decode of the pages concatenated, and the CPU's lookahead (a
    near-tie passes where both choices' path bits, decoded on the CPU,
    lie within ``HOST_TIE_BITS``).  Returns the numbers."""
    import torch
    out = {}
    contents = {}
    for lane, env in LANES.items():
        d = os.path.join(work, 'lanes_%s' % lane)
        build_workspace(d, np.random.default_rng(17), 2, 6, rater.vocab,
                        alt_share=0.3)
        zero_counts()
        with env_vars(**env):
            run_cli(d, 'cuda')
        lanes = read_lanes()
        assert lanes['pages'] == (2 if lane == 'native' else 0), \
            (lane, lanes)
        contents[lane] = page_contents(d)
    assert contents['native'] == contents['records'] == contents['object']
    print('page lanes on the card: native (C++ scan, array lattice, splice '
          'write-back), records (ElementTree) and object model over 2 pages '
          'of 6 lines: the same text and conf in all %d elements'
          % len(contents['native']))
    short = os.path.join(work, 'short_sizes')
    build_workspace(short, np.random.default_rng(19), 16, 6, rater.vocab)
    sizes, groups = page_groups(short, rater)
    files, walls, counts = {}, {'on': [], 'off': []}, {}
    for i, fuse in enumerate(('on', 'off') * 2):
        d = os.path.join(work, 'short_%d' % i)
        build_workspace(d, np.random.default_rng(19), 16, 6, rater.vocab)
        zero_counts()
        with env_vars(KERASLM_FUSE_PAGES='1' if fuse == 'on' else '0'):
            torch.cuda.synchronize()
            t0 = time.time()
            run_cli(d, 'cuda')
            walls[fuse].append(time.time() - t0)
        counts[fuse] = dict(read_counts(), **read_lanes())
        got = output_files(d)
        assert files.setdefault(fuse, got) == got, fuse
    assert files['on'] == files['off'] and len(files['on']) == 16
    assert counts['on']['decode_lattice'] == len(groups) == \
        counts['on']['groups'], (counts, groups)
    assert counts['off']['decode_lattice'] == 16 and \
        counts['off']['groups'] == 0, counts
    print('page groups on the card: 16 pages of 6 lines (%d-%d decode edges '
          'a page), groups %s; KERASLM_FUSE_PAGES=1 %d decode_lattice '
          'launch(es), =0 %d; the written files byte-identical (times '
          'aside)' % (min(sizes), max(sizes), [len(g) for g in groups],
                      counts['on']['decode_lattice'],
                      counts['off']['decode_lattice']))
    traced = {}
    for fuse in ('on', 'off'):
        d = os.path.join(work, 'short_traced_%s' % fuse)
        build_workspace(d, np.random.default_rng(19), 16, 6, rater.vocab)
        with env_vars(KERASLM_FUSE_PAGES='1' if fuse == 'on' else '0'):
            traced[fuse] = profiled(lambda: run_cli(d, 'cuda'))
    out['groups'] = dict(walls=walls, groups=groups, sizes=sizes,
                         traced=traced,
                         launches={k: v['decode_lattice']
                                   for k, v in counts.items()})
    # lookahead write-back over the 4 pages of phase 4
    look = {}
    for platform in ('cuda', 'cpu'):
        d = os.path.join(work, 'look_%s' % platform)
        build_workspace(d, np.random.default_rng(7), 4, 40, rater.vocab)
        zero_counts()
        with reverse_walk_clock() as walk:
            t0 = time.time()
            run_cli(d, platform, lookahead=True)
            if platform == 'cuda':
                torch.cuda.synchronize()
            wall = time.time() - t0
        counts, lanes = read_counts(), read_lanes()
        look[platform] = dict(dir=d, wall=wall, walk=walk[0],
                              choices=output_choices(d), counts=counts)
        assert lanes['pages'] == 0, lanes
    blocks = -(-np.asarray(page_groups(look['cuda']['dir'], rater)[0])
               // 1024)
    assert look['cuda']['counts'] == dict(
        NO_LAUNCHES, decode_lattice=int(blocks.sum())), look['cuda']
    assert look['cpu']['counts'] == NO_LAUNCHES, look['cpu']
    card = look['cuda']['choices']
    whole = concat_choices(rater, look['cuda']['dir'])[0]
    said = []
    for what, other, r in (('the card\'s decode of the 4 pages as one '
                            'lattice', whole, rater),
                           ('the CPU\'s lookahead', look['cpu']['choices'],
                            None)):
        ties = sorted(g for g in card if card[g] != other[g])
        gap = 0.0
        if ties:
            # both choices' path bits, the pages decoded as one lattice
            r = r or german_rater('cpu')
            bits = [concat_choices(r, look['cuda']['dir'], c)[1]
                    for c in (card, other)]
            gap = abs(bits[0] - bits[1])
            assert gap <= HOST_TIE_BITS, (what, ties, bits)
        said.append('%s %s' % (what, 'at every glyph' if not ties else
                               'but at %d glyph(s) of a near-tie (path bits '
                               '%.3g apart, tolerance %g): %s'
                               % (len(ties), gap, HOST_TIE_BITS, ties[:5])))
    print('lookahead write-back on the card (-P lookahead_writeback true, 4 '
          'pages of 40 lines, %d glyphs): every page written, %d '
          'decode_lattice launches (records kept, walked in reverse with '
          'the entry slot chained), the native lane stood aside; the '
          'choices equal %s' % (len(card), int(blocks.sum()),
                                ', and '.join(said)))
    out['lookahead'] = dict(wall=look['cuda']['wall'],
                            walk=look['cuda']['walk'],
                            wall_cpu=look['cpu']['wall'], glyphs=len(card))
    return out


def workspace_graphs(directory):
    """The glyph-level linear lattice of every page of a workspace's
    OCR-D-OCR group, each as a networkx chain."""
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.page_fast import parse_page_fast
    from ocrd_keraslm_torch.wrapper.rate import page_get_linear_lattice_at
    ws = Workspace(directory)
    return [chain_graph(page_get_linear_lattice_at('glyph', parse_page_fast(
        os.path.join(directory, f.local_filename))))
        for f in ws.mets.find_files(fileGrp='OCR-D-OCR')]


def same_results(got, want, tol=1e-4, cost_ulps=0):
    """Decode results ``[(path, entropy)]`` against others: paths equal
    element for element (element and TextEquiv), scores and entropies
    within ``tol`` plus ``cost_ulps`` ulps of the document's cumulative
    f32 cost (its entropy).  A score is 2^-(c_t - c_{t-1}) of cumulative
    costs c, so two f32 runs (card and CPU) that round a c of thousands
    of bits one ulp apart (2.4e-4 from 2048 bits up) move the entropy by
    that and a score by up to ln 2 times two such ulps: card against CPU
    takes ``cost_ulps=2``, the card against itself none.  Returns the
    largest difference."""
    assert len(got) == len(want)
    diff = 0.0
    for (p_g, e_g), (p_w, e_w) in zip(got, want):
        assert [(el, te) for el, te, _ in p_g] == \
            [(el, te) for el, te, _ in p_w]
        d = max([abs(a - b) for (_, _, a), (_, _, b) in zip(p_g, p_w)]
                + [abs(e_g - e_w)])
        assert d <= tol + cost_ulps * float(np.spacing(np.float32(
            abs(e_w)))), (d, e_w)
        diff = max(diff, d)
    return diff


def batch_prep(rater, graphs):
    """(merge flag the batch takes, prepared edges per document, kernel
    blocks per document)."""
    from ocrd_keraslm_torch.rater import E_BUCKETS, _linear_edges
    merge, scans = rater._batch_scans([_linear_edges(g) for g in graphs],
                                      10)
    sizes = [n for n, _ in scans]
    return merge, sizes, [-(-n // E_BUCKETS[-1]) for n in sizes]


def batch_path(rater, work, card):
    """The batched serving path (``Rater.rate_best_batch``): 32 one-page
    documents, 8 documents of 4 pages joined with ``concat_graphs``, a
    double-buffered pair, each document against its own single-document
    decode on the card, 4 documents card against CPU; returns the path's
    numbers."""
    import torch
    ws = os.path.join(work, 'ws_batch')
    build_workspace(ws, np.random.default_rng(11), BATCH_DOCS, 40,
                    rater.vocab)
    docs = workspace_graphs(ws)
    ws4 = os.path.join(work, 'ws_batch_multi')
    build_workspace(ws4, np.random.default_rng(12), BATCH_MULTI * BATCH_PAGES,
                    40, rater.vocab)
    pages = workspace_graphs(ws4)
    multi = [rater.concat_graphs(pages[i:i + BATCH_PAGES])
             for i in range(0, len(pages), BATCH_PAGES)]
    out = {}
    for name, graphs in (('one-page', docs), ('4-page', multi)):
        merge, sizes, blocks = batch_prep(rater, graphs)
        zero_counts()
        t0 = time.time()
        got = rater.rate_best_batch(graphs)
        wall = time.time() - t0
        counts = read_counts()
        n_blk = max(blocks)
        assert counts == dict(NO_LAUNCHES, decode_lattice_batch=n_blk,
                              walk_records_batch=n_blk), (counts, n_blk)
        print('batched serving path, %d %s documents (beam_width 10, K=16, '
              'lm_weight 0.5): %s prep (%s), decode edges per document '
              '%d-%d, kernel blocks per document %d-%d; launches %s '
              '(expected one decode_lattice_batch and one walk_records_batch '
              'per block of <= 1024 edges for the whole batch)'
              % (len(graphs), name, 'merged' if merge else 'unmerged L=1',
                 'every alternative a single char' if not merge else
                 'run merging', min(sizes), max(sizes), min(blocks),
                 max(blocks), counts))
        # every document against its own single-document decode, with
        # the batch's merge choice
        keep = rater.merge_runs
        rater.merge_runs = merge
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            seq = [rater.rate_best_device(g, 0, 0)[:2] for g in graphs]
            wall_seq = time.time() - t0
        finally:
            rater.merge_runs = keep
        diff = same_results(got, seq)
        print('batched serving path, %d %s documents: every path equals the '
              'document\'s own rate_best_device decode on the card (elements '
              'and choices; max score or entropy difference %.3g, tolerance '
              '1e-4)' % (len(graphs), name, diff))
        out[name] = dict(wall=wall, wall_seq=wall_seq, sizes=sizes,
                         launches=counts, merge=merge, results=got)
    # where the wall goes: begin (host prep, uploads, launches; it does
    # not wait) and finish (the wait for the device, path emission), the
    # prep in C++ and with KERASLM_NATIVE=0 in Python, alternating
    splits = {'native': [], 'python': []}
    for prep in ('native', 'python') * 2:
        with env_vars(KERASLM_NATIVE='0' if prep == 'python' else None):
            torch.cuda.synchronize()
            t0 = time.time()
            pending = rater.rate_best_batch_begin(docs)
            t1 = time.time()
            again = rater.rate_best_batch_finish(pending)
            t2 = time.time()
        splits[prep].append((t1 - t0, t2 - t1))
        if prep == 'native':
            assert again == out['one-page']['results']
        else:
            same_results(again, out['one-page']['results'])
    for prep, what in (('native', 'C++ prep'),
                       ('python', 'Python prep, KERASLM_NATIVE=0')):
        print('batched serving path, %d one-page documents split (%s): '
              'begin %s s (host prep, uploads, launches), finish %s s (the '
              'wait for the device, path emission); results equal [%s]'
              % (BATCH_DOCS, what,
                 ', '.join('%.3f' % b for b, _ in splits[prep]),
                 ', '.join('%.3f' % f for _, f in splits[prep]), card))
    out['begin'] = splits
    # double buffering: batch B launched before batch A finishes
    half = BATCH_DOCS // 2
    zero_counts()
    pending_a = rater.rate_best_batch_begin(docs[:half])
    pending_b = rater.rate_best_batch_begin(docs[half:])
    got_b = rater.rate_best_batch_finish(pending_b)
    got_a = rater.rate_best_batch_finish(pending_a)
    pair_counts = read_counts()
    assert got_a + got_b == out['one-page']['results']
    print('batched serving path, double-buffered pair: the second half '
          'launched before the first finished, finished first; both equal '
          'the %d-document batch exactly; launches %s'
          % (BATCH_DOCS, pair_counts))
    # 4 smaller documents, card against CPU
    small = os.path.join(work, 'ws_batch_small')
    build_workspace(small, np.random.default_rng(13), 4, 10, rater.vocab,
                    alt_share=0.3)
    graphs = workspace_graphs(small)
    card_res = rater.rate_best_batch(graphs)
    diff = same_results(card_res, german_rater('cpu').rate_best_batch(graphs),
                        cost_ulps=2)
    sizes = batch_prep(rater, graphs)[1]
    print('batched serving path, 4 documents of %d-%d edges (entropies '
          '%.1f-%.1f bits): the same paths on the card and on the CPU, max '
          'score or entropy difference %.3g (tolerance 1e-4 plus two ulps '
          'of the document\'s f32 cumulative cost, %.3g at the largest)'
          % (min(sizes), max(sizes), min(e for _, e in card_res),
             max(e for _, e in card_res), diff,
             2 * float(np.spacing(np.float32(max(e for _, e in card_res))))))
    # the first launch's inputs at the main path's shape, for the numbers
    first = first_batch_launch(rater, docs)
    traced_wall, busy = profiled(lambda: rater.rate_best_batch(docs))
    out.update(traced_wall=traced_wall, busy=busy, first=first,
               launches=out['one-page']['launches'])
    return out


# -P beam_width of the K=32 paths (17-32 take K=32: the cluster layout's
# sharded plan at the german model's width)
BEAM32 = 32
# edges of the 32-document batch's first block at beam 32 held against
# the plain version (its first edges: the plain version decodes the 32
# documents edge by edge)
K32_BATCH_PARITY_E = 256


def k32_path(rater, work, decode, card):
    """Beam 32 (K=32) on its serving paths: (a) ``rate_best_batch`` of the
    32 one-page documents of the batched path at ``beam_width`` 32 (one
    ``decode_lattice_batch`` and one walk a block), every path equal to
    the document's own ``rate_best_device`` decode at beam 32 on the card;
    the first block's launch, its first ``K32_BATCH_PARITY_E`` edges, held
    against the plain version (:func:`parity_batch`); (b) the bf16 decode
    mode's processor over phase 4's pages at beam 32: every page written,
    one bf16 ``decode_lattice`` launch a page group and no f32 one.
    Returns the paths' numbers."""
    import torch
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    wts = rater._decode_weights(None)
    docs = workspace_graphs(os.path.join(work, 'ws_batch'))
    merge, sizes, blocks = batch_prep(rater, docs)
    zero_counts()
    t0 = time.time()
    got = rater.rate_best_batch(docs, beam_width=BEAM32)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    n_blk = max(blocks)
    assert counts == dict(NO_LAUNCHES, decode_lattice_batch=n_blk,
                          walk_records_batch=n_blk), (counts, n_blk)
    keep = rater.merge_runs
    rater.merge_runs = merge
    try:
        seq = [rater.rate_best_device(g, 0, 0, beam_width=BEAM32)[:2]
               for g in docs]
    finally:
        rater.merge_runs = keep
    diff = same_results(got, seq)
    args, kw = first_batch_launch(rater, docs, BEAM32)
    N = kw['n_docs']
    K, A, L = args[8].shape[0] // N, args[4].shape[1] // N, args[4].shape[2]
    cl = dk.cluster_blocks(rater.device, True, N, K, A, L, rater.depth,
                           rater.width, wts['v_pad'], wts['v_real'])
    print('K=32 batched serving path: Rater.rate_best_batch of %d one-page '
          'documents at -P beam_width %d (K=%d, decode edges per document '
          '%d-%d, %d block(s)): %.3f s (host clock, ended by the fetch); '
          'launches %s; decode_lattice_batch takes %d block(s) a document; '
          'every path equals the document\'s own rate_best_device decode '
          'at beam %d on the card (max score or entropy difference %.3g, '
          'tolerance 1e-4) [%s]'
          % (N, BEAM32, K, min(sizes), max(sizes), n_blk, wall, counts, cl,
             BEAM32, diff, card))
    E = min(K32_BATCH_PARITY_E, args[4].shape[0])
    n_real = min(kw['n_real'], E)
    steps = kw['alt_steps']
    if steps is None:  # the wrapper's default: L steps every edge
        steps = torch.full((args[4].shape[0], 1), L, dtype=torch.int32,
                           device=args[4].device)
    arrays = tuple(a[:E] for a in args[4:8]) + (steps[:E],)

    def run(fn, part, n, state, cost):
        out = fn(*args[:4], *part[:4], state, cost, n_docs=N,
                 lm_weight=kw['lm_weight'], v_real=kw['v_real'],
                 alt_steps=part[4], n_real=n)
        torch.cuda.synchronize()
        return out
    t0 = time.time()
    err, ties, _, _ = parity_batch(run, dk.decode_lattice_batch,
                                   dk.decode_lattice_batch_ref, arrays,
                                   n_real, args[8], args[9], N, K,
                                   rater.width)
    plain_ms = cuda_ms(lambda: run(dk.decode_lattice_batch_ref, arrays,
                                   n_real, args[8], args[9]), 1)
    kernel_ms = cuda_ms(lambda: run(dk.decode_lattice_batch, arrays, n_real,
                                    args[8], args[9]), 3)
    print('parity decode_lattice_batch at beam %d: the first %d edges of '
          'the batch\'s first block (%d documents, K=%d, A=%d, L=%d, %d '
          'blocks a document) against the plain version, every edge of '
          'every document compared, max |kernel - plain| %.3g, near-ties at '
          'the K-th rank resumed from the kernel\'s state at edges %s '
          '(tolerances: costs rtol 1e-5 atol 1e-4, stateF atol %g, c also '
          'rtol %g) in %.1f s; there the kernel %.3f ms, the plain version '
          '%.3f ms (CUDA events) [%s]'
          % (BEAM32, E, N, K, A, L, cl, err, ties or 'none',
             BATCH_STATE_ATOL, BATCH_C_RTOL, time.time() - t0, kernel_ms,
             plain_ms, card))
    # (b) the bf16 decode mode at beam 32 over phase 4's pages
    d = os.path.join(work, 'ws_bf16_k32')
    n_glyphs = build_workspace(d, np.random.default_rng(7), 4, 40,
                               rater.vocab)
    groups = page_groups(d, rater, BEAM32)[1]
    zero_counts()
    t0 = time.time()
    run_processor(d, 'cuda', True, beam_width=BEAM32)
    wall_bf16 = time.time() - t0
    bf16_counts = read_counts()
    check_glyphs(d, n_glyphs)
    assert bf16_counts == dict(NO_LAUNCHES,
                               decode_lattice_bf16=len(groups)), \
        (bf16_counts, groups)
    print('K=32 bf16 decode path: 4 pages, %d glyphs written through the '
          'processor at -P beam_width %d with rater.decode_bf16 = True: '
          '%.3f s (model load included); launches %s (one bf16 '
          'decode_lattice a page group %s, no f32 launch) [%s]'
          % (n_glyphs, BEAM32, wall_bf16, bf16_counts, groups, card))
    return dict(first=(args, kw), launches=counts, wall=wall,
                bf16_launches=bf16_counts)


def first_batch_launch(rater, docs, beam_width=10):
    """``(args, kwargs)`` of the first ``decode_lattice_batch`` launch of
    ``rater.rate_best_batch(docs, beam_width=beam_width)``."""
    import ocrd_keraslm_torch.rater as rater_module
    first = []
    real = rater_module.decode_lattice_batch
    rater_module.decode_lattice_batch = \
        lambda *a, **k: first.append((a, k)) or real(*a, **k)
    try:
        rater.rate_best_batch(docs, beam_width=beam_width)
    finally:
        rater_module.decode_lattice_batch = real
    return first[0]


def batch_numbers(rater, batch, parity_times, card):
    """Phase 7, the batched decode kernel and its walk at the main path's
    shape (the first block of the 32-document batch): times (CUDA
    events), bounds, and the yardstick, one ``decode_lattice`` launch
    per document on the same edges, one after another."""
    import torch
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    args, kw = batch['first']
    emb, embT, wcat, bias, chars, mask, conf, valid, state0, cost0 = args
    N, n_real = kw['n_docs'], kw['n_real']
    E, NA, L = chars.shape
    A, K = NA // N, state0.shape[0] // N
    D, W = rater.depth, rater.width
    v_real, v_pad = kw['v_real'], emb.shape[0]
    def run():
        return dk.decode_lattice_batch(*args, **kw)
    ms = cuda_ms(run, 3)
    rec, stateF, costF = run()
    # bound: the work each document's own edges need, summed
    mask_np = mask.cpu().numpy().reshape(E, N, A, L)
    flops = 0
    for n in range(N):
        steps_n = mask_np[:, n].sum(axis=2).max(axis=1).astype(int)
        flops += decode_bound(mask_np[:, n], steps_n, n_real, K, D, W,
                              v_real, 0)[2]
    steps = kw['alt_steps']
    nbytes = (tensor_bytes(*args, steps) + tensor_bytes(rec, stateF, costF)
              - 2 * W * (v_pad - v_real) * 4)
    bound_ms, bound_by, _ = bound(flops, nbytes)
    with decode_cluster(1):
        one_ms = cuda_ms(run, 1)
    ms2 = cuda_ms(run, 3)
    cl = dk.cluster_blocks(chars.device, True, N, K, A, L, D, W, v_pad,
                           v_real)
    print('decode_lattice_batch at the main path shape in the one-block '
          'layout (the parent\'s kernel, its code unchanged): %.3f ms (CUDA '
          'events, one warm launch); the cluster layout (%d blocks a '
          'document, %d units a block) %.2fx faster [%s]'
          % (one_ms, cl, W // cl, one_ms / ms2, card))
    print('decode_lattice_batch at the main path shape (block 1 of the '
          '%d-document batch: E=%d, n_real=%d, L=%d, K=%d, A=%d): %.3f '
          'ms/launch then %.3f ms/launch (CUDA events, mean of 3 warm '
          'launches), %.2f us per edge of the longest document [%s]'
          % (N, E, n_real, L, K, A, ms, ms2, 1e3 * ms2 / n_real, card))
    # the yardstick: one single-document launch per document, in turn
    singles = []
    for n in range(N):
        cost_n = torch.full((1, 128), BIG, device=chars.device)
        cost_n[0, :K] = cost0[n * K:(n + 1) * K, 0]
        singles.append(
            (emb, embT, wcat, bias,
             *(t[:, n * A:(n + 1) * A].contiguous() for t in
               (chars, mask, conf)),
             valid[:, n * A:(n + 1) * A, 0].contiguous(),
             state0[n * K:(n + 1) * K].contiguous(), cost_n))
    single_kw = dict(lm_weight=kw['lm_weight'], v_real=v_real,
                     alt_steps=None if steps is None else steps[:, 0]
                     .contiguous(), n_real=n_real)
    seq_ms = cuda_ms(lambda: [dk.decode_lattice(*a, **single_kw)
                              for a in singles], 1)
    print('decode_lattice_batch yardstick: the same %d documents\' edges '
          'through %d decode_lattice launches one after another: %.3f ms '
          '(CUDA events), %.1fx the batched launch [%s]'
          % (N, N, seq_ms, seq_ms / ms2, card))
    kernel_ms, plain_ms = parity_times
    print('decode_lattice_batch plain version on the parity block (%d '
          'documents x %d edges, L=8): %.3f ms, the kernel %.3f ms there '
          '(CUDA events) [%s]' % (BATCH_PARITY_N, BATCH_PARITY_E, plain_ms,
                                   kernel_ms, card))
    print('decode_lattice_batch bound: %.3f ms by %s (%.3g f32 FLOP at 67 '
          'TFLOP/s: the documents\' own edges, %d bytes at 3.35 TB/s); '
          'kernel at %.2f%% of it; library call: none - no single PyTorch '
          'call computes lattice decoding' % (bound_ms, bound_by, flops,
                                               nbytes, 100 * bound_ms / ms2))
    k_in = torch.zeros((N,), dtype=torch.int32, device=chars.device)
    def walk():
        return dk.walk_records_batch(rec, k_in, n_docs=N, beam=K)
    walk_ms = cuda_ms(walk, 20)
    walk_plain_ms = cuda_ms(lambda: dk.walk_records_batch_ref(
        rec, k_in, n_docs=N, beam=K), 1)
    walk_ms2 = cuda_ms(walk, 20)
    # the walk reads one [bp | alt | cost] triple per edge and document
    # and the start slots, writes (N, E, 2) and the end slots
    walk_bytes = N * E * 3 * 4 + N * 4 + N * E * 2 * 4 + N * 4
    walk_bound = bound(0, walk_bytes)
    print('walk_records_batch at the same block (%d documents x %d edges): '
          '%.4f then %.4f ms/launch (CUDA events, mean of 20); plain '
          'version %.3f ms; bound %.3g ms by %s (%d bytes at 3.35 TB/s; a '
          'chain of %d dependent loads per document); library call: none '
          '[%s]' % (N, E, walk_ms, walk_ms2, walk_plain_ms, walk_bound[0],
                    walk_bound[1], walk_bytes, E, card))
    return {'decode_lattice_batch': dict(
        ms=ms2, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None),
        'walk_records_batch': dict(
        ms=walk_ms2, plain_ms=walk_plain_ms, bound_ms=walk_bound[0],
        bound_by=walk_bound[1], library_ms=None)}


def page_block(rater, directory, bf16=False, K=16):
    """``decode_lattice``'s arguments for page 1 of the workspace in
    ``directory`` as the processor launches them (the native lane's
    arrays of its page group, page 1 alone at the main path's 40-line
    pages; K=16 (``beam_width`` 10, or K=32: 17-32), A=4, records walked
    on the host; with ``bf16`` the bf16 decode weights), and the page's
    mask and per-edge steps as numpy arrays."""
    import torch
    from ocrd_keraslm_torch.rater import DECODE_MERGE_MAX, _alt_steps
    doc = native_docs(directory)[0]
    _, n, maxlen = doc.lattice('glyph', rater.merge_runs, DECODE_MERGE_MAX)
    E, L = rater.fused_gate_arrays(n, maxlen, 10 if K <= 16 else K)
    wts = rater._decode_weights(None, bf16=bf16)
    chars, mask, conf, valid = doc.fill(rater.vocab._table(), E, 4, L)
    steps = _alt_steps(mask)[:, 0]
    ins = [torch.from_numpy(a).to(rater.device)
           for a in (chars, mask, conf, valid, steps)]
    state0, cost0 = rater._fused_traceback(None, K, wts['emb'])
    args = (wts['emb'], wts['embT'], wts['wcat'], wts['bias'],
            ins[0], ins[1], ins[2], ins[3], state0, cost0)
    kw = dict(lm_weight=0.5, v_real=wts['v_real'], device_walk=False,
              alt_steps=ins[4], n_real=n)
    return args, kw, mask, steps


def decode_numbers(rater, decode, card, K=16):
    """Phase 7, decode kernel at the main path's shape (page 1) at K (16;
    32: row 1k, the processor's beam_width 17-32)."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    wts = rater._decode_weights(None)
    D, W, A = rater.depth, rater.width, 4
    S = (2 * D + 1) * W
    args, kw, mask, steps = page_block(rater, decode['workspace'], K=K)
    n = kw['n_real']
    E, _, L = args[4].shape
    ins = [kw['alt_steps']]
    ms = cuda_ms(lambda: dk.decode_lattice(*args, **kw), 3)
    plain_ms = cuda_ms(lambda: dk.decode_lattice_ref(*args, **kw), 1)
    with decode_cluster(1):
        one_ms = cuda_ms(lambda: dk.decode_lattice(*args, **kw), 1)
    ms2 = cuda_ms(lambda: dk.decode_lattice(*args, **kw), 3)
    cl = dk.cluster_blocks(rater.device, False, 1, K, A, L, D, W,
                           wts['v_pad'], wts['v_real'])
    plan = '' if cl == 1 else ', the %s plan' % (
        'sharded' if dk.cluster_shard(K, A, L, D, W, wts['v_pad'],
                                      wts['v_real'], cl) else 'rows')
    out_bytes = ((E + 1) * 3 * K + K * S + 128) * 4
    # emb and embT are read at their v_real real rows/columns only
    nbytes = (tensor_bytes(*args, ins[0]) + out_bytes
              - 2 * W * (wts['v_pad'] - wts['v_real']) * 4)
    bound_ms, bound_by, flops = decode_bound(
        mask, steps, n, K, D, W, wts['v_real'], nbytes)
    print('decode_lattice at the main path shape (page 1: E=%d, n_real=%d, '
          'L=%d, K=%d, A=%d): %.3f ms/launch then %.3f ms/launch (CUDA '
          'events, mean of 3 warm launches), %.2f us/edge [%s]'
          % (E, n, L, K, A, ms, ms2, 1e3 * ms2 / n, card))
    print('decode_lattice at the same shape in the one-block layout (the '
          'first port\'s kernel, its code unchanged): %.3f ms (CUDA events, '
          'one warm launch); the cluster layout (%d blocks, %d units a '
          'block%s) %.1fx faster [%s]' % (one_ms, cl, W // cl, plan,
                                          one_ms / ms2, card))
    print('decode_lattice plain version at the same shape: %.3f ms (CUDA '
          'events, one warm run) [%s]' % (plain_ms, card))
    print('decode_lattice bound: %.3f ms by %s (%.3g f32 FLOP at 67 '
          'TFLOP/s, %d bytes at 3.35 TB/s); kernel at %.2f%% of it; '
          'library call: none - no single PyTorch call computes lattice '
          'decoding' % (bound_ms, bound_by, flops,
                        nbytes, 100 * bound_ms / ms2))
    return dict(ms=ms2, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def decode_numbers_bf16(rater, decode, card, K=16):
    """Phase 7, row 1b (1bk at K=32): ``decode_lattice`` with the bf16
    decode weights at the main path's shape (page 1), its plain version,
    its one-block layout, and the f32 kernel on the same page in the same
    call."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    wts = rater._decode_weights(None, bf16=True)
    D, W, A = rater.depth, rater.width, 4
    S = (2 * D + 1) * W
    args, kw, mask, steps = page_block(rater, decode['workspace'], True, K)
    args32 = page_block(rater, decode['workspace'], K=K)[0]
    n = kw['n_real']
    E, _, L = args[4].shape
    times = {'bf16': [], 'f32': []}
    for kind in ('bf16', 'f32') * 2:
        times[kind].append(cuda_ms(lambda: dk.decode_lattice(
            *(args if kind == 'bf16' else args32), **kw), 3))
    plain_ms = cuda_ms(lambda: dk.decode_lattice_ref(*args, **kw), 1)
    with decode_cluster(1):
        one_ms = cuda_ms(lambda: dk.decode_lattice(*args, **kw), 1)
    cl = dk.cluster_blocks(rater.device, False, 1, K, A, L, D, W,
                           wts['v_pad'], wts['v_real'], True)
    out_bytes = ((E + 1) * 3 * K + K * S + 128) * 4
    # emb and embT (bf16) are read at their v_real real rows/columns only
    nbytes = (tensor_bytes(*args, kw['alt_steps']) + out_bytes
              - 2 * W * (wts['v_pad'] - wts['v_real']) * 2)
    flops = decode_bound(mask, steps, n, K, D, W, wts['v_real'], 0)[2]
    bound_ms, bound_by, _ = bound(flops, nbytes, bf16_flops=flops)
    ms = times['bf16'][-1]
    print('decode_lattice bf16 at the main path shape (page 1: E=%d, '
          'n_real=%d, L=%d, K=%d, A=%d): %s ms/launch (CUDA events, mean of '
          '3 warm launches, alternating with the f32 kernel), %.2f us/edge; '
          'the f32 kernel on the same page in the same call %s ms, %.2fx '
          'the bf16 one [%s]'
          % (E, n, L, K, A, ', '.join('%.3f' % t for t in times['bf16']),
             1e3 * ms / n, ', '.join('%.3f' % t for t in times['f32']),
             times['f32'][-1] / ms, card))
    print('decode_lattice bf16 in the one-block layout: %.3f ms (CUDA '
          'events, one warm launch); the cluster layout (%d blocks) %.1fx '
          'faster; its plain version %.3f ms [%s]'
          % (one_ms, cl, one_ms / ms, plain_ms, card))
    print('decode_lattice bf16 bound: %.4f ms by %s (%.3g FLOP with bf16 '
          'operands at 989 TFLOP/s, %d bytes at 3.35 TB/s); kernel at %.3f%% '
          'of it; library call: none - no single PyTorch call computes '
          'lattice decoding' % (bound_ms, bound_by, flops, nbytes,
                                100 * bound_ms / ms))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def batch_numbers_bf16(rater, batch, bf16, parity_times, card):
    """Phase 7, row 2b: ``decode_lattice_batch`` with the bf16 decode
    weights at the main path's shape (the first block of the 32-document
    batch as ``rate_best_batch`` launches it in bf16), and the f32
    kernel's first block in the same call."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    args, kw = bf16['first']
    args32, kw32 = batch['first']
    emb, embT, wcat, bias, chars, mask, conf, valid, state0, cost0 = args
    N, n_real = kw['n_docs'], kw['n_real']
    E, NA, L = chars.shape
    A, K = NA // N, state0.shape[0] // N
    D, W = rater.depth, rater.width
    v_real, v_pad = kw['v_real'], emb.shape[0]
    times = {'bf16': [], 'f32': []}
    for kind in ('bf16', 'f32') * 2:
        times[kind].append(cuda_ms(
            (lambda: dk.decode_lattice_batch(*args, **kw)) if kind == 'bf16'
            else (lambda: dk.decode_lattice_batch(*args32, **kw32)), 3))
    rec, stateF, costF = dk.decode_lattice_batch(*args, **kw)
    mask_np = mask.cpu().numpy().reshape(E, N, A, L)
    flops = 0
    for n in range(N):
        steps_n = mask_np[:, n].sum(axis=2).max(axis=1).astype(int)
        flops += decode_bound(mask_np[:, n], steps_n, n_real, K, D, W,
                              v_real, 0)[2]
    nbytes = (tensor_bytes(*args, kw['alt_steps'])
              + tensor_bytes(rec, stateF, costF)
              - 2 * W * (v_pad - v_real) * 2)
    bound_ms, bound_by, _ = bound(flops, nbytes, bf16_flops=flops)
    ms = times['bf16'][-1]
    kernel_ms, plain_ms = parity_times
    print('decode_lattice_batch bf16 at the main path shape (block 1 of the '
          '%d-document batch: E=%d, n_real=%d, L=%d, K=%d, A=%d): %s '
          'ms/launch (CUDA events, mean of 3 warm launches, alternating with '
          'the f32 kernel); the f32 kernel on its block 1 in the same call '
          '%s ms, %.2fx the bf16 one [%s]'
          % (N, E, n_real, L, K, A, ', '.join('%.3f' % t for t in
                                              times['bf16']),
             ', '.join('%.3f' % t for t in times['f32']),
             times['f32'][-1] / ms, card))
    print('decode_lattice_batch bf16 plain version on the parity block (%d '
          'documents x %d edges, L=8): %.3f ms, the kernel %.3f ms there '
          '(CUDA events) [%s]' % (BATCH_PARITY_N, BATCH_PARITY_E, plain_ms,
                                   kernel_ms, card))
    print('decode_lattice_batch bf16 bound: %.4f ms by %s (%.3g FLOP with '
          'bf16 operands at 989 TFLOP/s: the documents\' own edges, %d bytes '
          'at 3.35 TB/s); kernel at %.3f%% of it; library call: none'
          % (bound_ms, bound_by, flops, nbytes, 100 * bound_ms / ms))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def scan_layouts(kind, B, W, D, n_sm=132):
    """Every layout the chooser could return for the shape, as
    ``(rb, cl, reg)``: the one-block layout, the register layout on
    clusters of 1-16 blocks of rows_per_block(B) streams down to one
    where it fits, and the grid layout (``reg`` ``GRID``) in as few
    groups as ``n_sm`` SMs hold where it fits."""
    from ocrd_keraslm_torch.ops import scan_layout as sl
    out = [(sl.one_block_rows(kind, B, W, D), 1, False)]
    groups = sl.grid_groups(W, n_sm) if W >= sl.GRID_UNITS else 0
    if groups:
        grid = sl.grid_layout_for(kind, B, W, -(-B // min(B, groups)))
        if grid is not None:
            out.append((grid.rb, grid.cl, GRID))
    for cl in sl.CLUSTERS:
        rb = sl.rows_per_block(B)
        while rb >= 1:
            if sl.reg_layout_for(kind, W, D, rb, cl) is not None:
                out.append((rb, cl, True))
            rb //= 2
    return out


def scoring_numbers(rater, scoring, card):
    """Phase 6, scoring and LSTM-scan kernels at the main path's shape:
    the first chunk of the 4 pages' one rate_batch."""
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import score_kernel as sk
    args, inp = score_main_inputs(rater, scoring['texts'], [179])
    B, T, _ = args[0].shape
    D, W = rater.depth, rater.width
    lstm_args = (args[0], args[3][0], args[4][0],
                 rater.params['lstm'][0]['recurrent'])
    out = {}
    for name, kernel, plain, bnd, depth, reps in (
            ('score_scan', lambda: sk.score_scan(*args),
             lambda: sk.score_scan_ref(*args), score_bound(args), D, 5),
            ('lstm_scan', lambda: lc.lstm_scan(*lstm_args),
             lambda: lc.lstm_scan_ref(*lstm_args),
             lstm_bound(lstm_args, False), 1, 5)):
        library = cudnn_lstm(rater, depth, inp)
        ms = cuda_ms(kernel, reps)
        plain_ms = cuda_ms(plain, 1)
        library_ms = cuda_ms(library, reps)
        ms2 = cuda_ms(kernel, reps)
        bound_ms, bound_by, flops = bnd
        print('%s at the main path shape (B=%d streams, T=%d, D=%d, W=%d): '
              '%.3f ms/launch then %.3f ms/launch (CUDA events, mean of %d '
              'warm launches), %.2f us/step [%s]'
              % (name, B, T, D if name == 'score_scan' else 1, W, ms, ms2,
                 reps, 1e3 * ms2 / T, card))
        print('%s plain version at the same shape: %.3f ms (CUDA events, '
              'one warm run) [%s]' % (name, plain_ms, card))
        print('%s bound: %.4f ms by %s (%.3g f32 FLOP at 67 TFLOP/s); '
              'kernel at %.3f%% of it [%s]'
              % (name, bound_ms, bound_by, flops, 100 * bound_ms / ms2,
                 card))
        print('%s library yardstick: torch.nn.LSTM (cuDNN) of %d layer(s) '
              'over the same %d streams x %d steps: %.3f ms (mean of %d); '
              '%s [%s]' % (
                  name, depth, B, T, library_ms, reps,
                  'it covers the LSTM stack but not the tied softmax, '
                  'probs and NLL' if name == 'score_scan' else
                  'it also computes the input projection that the kernel '
                  'receives precomputed', card))
        out[name] = dict(ms=ms2, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
    return out


# ---------------------------------------------------------------------
# training: the LSTM scan with c_all and the LSTM backward
# ---------------------------------------------------------------------

# Under a bf16 U the forward rounds h to bf16 at every step, so two f32
# runs that differ in the last bit round some h to neighbouring bf16
# values: a step of 2^-8 relative, which the next products carry on.
# Kernel and plain version are then as far from each other as each is
# from a float64 run; h and c are held to 4e-3 there (one bf16 step at
# |h| <= 1).  The backward gets one forward's saved states, rounds the
# same h in both versions, and is held like the f32 one.
BF16_FWD_ATOL = 4e-3
# dU sums T*B = 32,768 products per element; kernel (blocks of 32, then
# 32 splits) and plain version (one product per step, added over T) sum
# in other orders: held to 5e-6 of max |dU| (both err ~1e-6 of it
# against a float64 run); dx_proj, dh0, dc0 to atol 1e-5 + rtol 1e-4
DU_RTOL_OF_MAX = 5e-6


def lstm_train_inputs(rng, device, bf16, B=TRAIN_B, T=TRAIN_T, W=TRAIN_W):
    """Seeded arguments of ``lstm_scan`` at the training shape (x_proj,
    h0, c0, U with orthonormal rows as ``init_params`` makes it) and the
    cotangents of h_all, hT and cT."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.astype(np.float32))).to(device)
    q, _ = np.linalg.qr(rng.normal(0, 1, (4 * W, 4 * W)))
    U = t(q[:W])
    if bf16:
        U = U.to(torch.bfloat16)
    return ((t(rng.normal(0, 1, (B, T, 4 * W))), t(rng.normal(0, 0.5, (B, W))),
             t(rng.normal(0, 0.5, (B, W))), U),
            (t(rng.normal(0, 1, (T, B, W))), t(rng.normal(0, 1, (B, W))),
             t(rng.normal(0, 1, (B, W)))))


def lstm_bwd_args(fwd_args, cotangents, saved):
    """``lstm_bwd``'s arguments from a forward's arguments, its saved
    ``(h_all, c_all)`` and the cotangents, as ``LSTMScan`` builds them."""
    import torch
    x_proj, h0, c0, U = fwd_args
    h_all, c_all = saved
    dh_all, dhT, dcT = cotangents
    return (x_proj.transpose(0, 1).contiguous(),
            torch.cat([h0[None], h_all[:-1]]),
            torch.cat([c0[None], c_all[:-1]]), c_all, dh_all, U, dhT, dcT)


def compare_bwd(got, want):
    """Hold one ``lstm_bwd`` output ``(dxp, dU, dh0, dc0)`` against
    another; returns ``(max abs error of dxp, dh0, dc0; max abs error of
    dU over max |dU|)``."""
    import torch
    err = 0.0
    for i in (0, 2, 3):
        torch.testing.assert_close(got[i], want[i], rtol=1e-4, atol=1e-5)
        err = max(err, float((got[i] - want[i]).abs().max()))
    scale = float(want[1].abs().max())
    du_err = float((got[1] - want[1]).abs().max()) / max(scale, 1e-30)
    assert du_err <= DU_RTOL_OF_MAX, ('dU', du_err, scale)
    return err, du_err


def train_parity(dev):
    """Phase 3 at the training shape: ``lstm_scan`` with ``c_all`` and
    ``lstm_bwd``, f32 and bf16 U, against their plain versions and a
    float64 run of those.  Returns {row name: max abs error}."""
    import torch
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    rng = np.random.default_rng(20261018)
    errs = {}
    for bf16 in (False, True):
        kind = 'bf16' if bf16 else 'f32'
        fwd, cot = lstm_train_inputs(rng, dev, bf16)
        B, T, _ = fwd[0].shape
        got = lc.lstm_scan(*fwd, want_c_all=True)
        torch.cuda.synchronize()
        want = lc.lstm_scan_ref(*fwd, want_c_all=True)
        atol = BF16_FWD_ATOL if bf16 else 1e-5
        h_err, c_err = compare_lstm(got, want, atol=atol)
        errs['lstm_scan_' + ('bf16' if bf16 else 'train')] = h_err
        print('parity lstm_scan %s U at the training shape (B=%d, T=%d, '
              'W=%d, nonzero carry, c_all on): max |kernel - plain| %.3g '
              'over h_all and hT, relative %.3g over c_all and cT '
              '(tolerances: h atol %g, c atol %g + rtol %g)'
              % (kind, B, T, TRAIN_W, h_err, c_err, atol, atol, C_RTOL))
        print('accuracy lstm_scan %s U: max |x - x_float64| / max(1, '
              '|x_float64|) over h_all, c_all, hT and cT: kernel %.3g, '
              'plain version %.3g'
              % ((kind,) + f64_errors(
                  lambda *a: lc.lstm_scan(*a, want_c_all=True),
                  lambda *a: lc.lstm_scan_ref(*a, want_c_all=True), fwd,
                  lambda out: out)))
        args = lstm_bwd_args(fwd, cot, got[:2])
        outs = [lc.lstm_bwd(*args) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(outs[0][1], outs[1][1]), \
            'dU differs between two launches'
        err, du_err = compare_bwd(outs[0], lc.lstm_bwd_ref(*args))
        errs['lstm_bwd' + ('_bf16' if bf16 else '')] = max(
            err, du_err * float(outs[0][1].abs().max()))
        print('parity lstm_bwd %s U at the training shape (the states '
              'the kernel forward saved): max |kernel - plain| %.3g over '
              'dx_proj, dh0 and dc0, %.3g of max |dU| = %.4g over dU; dU '
              'bit-equal over two launches (tolerances: atol 1e-5 + rtol '
              '1e-4; dU %g of its max)'
              % (kind, err, du_err, float(outs[0][1].abs().max()),
                 DU_RTOL_OF_MAX))
        k64, p64 = f64_errors(lc.lstm_bwd, lc.lstm_bwd_ref, args,
                              lambda out: (out[0], out[2], out[3]))
        du64 = f64_errors(
            lc.lstm_bwd, lc.lstm_bwd_ref, args,
            lambda out: (out[1] / float(outs[0][1].abs().max()),))
        print('accuracy lstm_bwd %s U: max |x - x_float64| / max(1, '
              '|x_float64|) over dx_proj, dh0, dc0: kernel %.3g, plain '
              'version %.3g; over dU / max |dU|: kernel %.3g, plain '
              'version %.3g' % (kind, k64, p64, du64[0], du64[1]))
    return errs


def write_corpus(directory, rng, sizes):
    """Seeded German-like text files ``{name: chars}`` (lines of about
    ten words); returns their paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for name, n_chars in sizes.items():
        lines, total = [], 0
        while total < n_chars:
            line = ' '.join(GERMAN_WORDS[i] for i in rng.integers(
                len(GERMAN_WORDS), size=int(rng.integers(8, 13))))
            lines.append(line)
            total += len(line) + 1
        path = os.path.join(directory, name)
        with open(path, 'w', encoding='utf-8') as fh:
            fh.write('\n'.join(lines)[:n_chars])
        paths.append(path)
    return paths


def split_plan(files, seed):
    """The split ``keraslm-rate train`` makes of ``files`` after
    :func:`seed_host`, and the vocabulary it assigns."""
    from ocrd_keraslm_torch import data as pdata
    from ocrd_keraslm_torch.utils.vocab import Vocab
    seed_host(seed)
    plan = pdata.split_data(files, stateful=True, length=TRAIN_T)
    vocab = Vocab()
    vocab.assign(plan.charset)
    return plan, vocab


def seed_host(seed):
    """Seed the two host generators the trainer draws its split, its
    dropout seed and its data seed from."""
    import random
    random.seed(seed)
    np.random.seed(seed)


def stream_batches(files, vocab, train=False, rng=None, length=TRAIN_T):
    from ocrd_keraslm_torch import data as pdata
    return pdata.gen_stateful_streams(
        files, vocab, length=length, batch_size=TRAIN_B, n_contexts=1,
        train=train, rng=rng)


def run_train_cli(work, model, files, epochs, seed, extra=(), ckpt=None):
    """``keraslm-rate train`` at the main path's width on the card, in
    this process, counts zeroed before, checkpoints into ``ckpt``
    (default WORK/ckpt); returns (wall s, counts, the chars/s the
    trainer logged per epoch)."""
    import logging

    import torch
    from click.testing import CliRunner
    from ocrd_keraslm_torch.scripts.run import cli as keraslm_rate
    rates = []

    class Epochs(logging.Handler):
        def emit(self, record):
            if str(record.msg).startswith('epoch %d:'):
                rates.append(float(record.args[-1]))
    logger = logging.getLogger('ocrd_keraslm_torch.rater')
    handler, level = Epochs(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    seed_host(seed)
    zero_counts()
    t0 = time.time()
    try:
        res = CliRunner().invoke(keraslm_rate, [
            '-l', 'WARNING', 'train', '-m', model, '-C',
            os.path.join(work, 'no_ckpt.h5'), '-w', str(TRAIN_W), '-d',
            str(TRAIN_D), '-l', str(TRAIN_T), '-b', str(TRAIN_B), '-e',
            str(epochs)] + list(extra) + list(files),
            env={'KERASLM_PLATFORM': 'cuda',
                 'KERASLM_CKPT_DIR': ckpt or os.path.join(work, 'ckpt')})
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    wall = time.time() - t0
    assert res.exit_code == 0, (res.output, res.exception)
    return wall, read_counts(), rates


def training_path(work, card):
    """Phase 6; returns the path's numbers."""
    import glob

    from click.testing import CliRunner
    from ocrd_keraslm_torch.scripts.run import cli as keraslm_rate
    from ocrd_keraslm_torch.utils import h5io
    rng = np.random.default_rng(11)
    per_file = TRAIN_B * (6 * TRAIN_T + 1)
    files = write_corpus(os.path.join(work, 'train_corpus'), rng, {
        'kant_kritik_1781.txt': per_file, 'goethe_faust_1808.txt': per_file,
        'lessing_nathan_1779.txt': per_file})
    seed, epochs = 31, 2
    plan, vocab = split_plan(files, seed)
    n_val = sum(1 for _ in stream_batches(plan.validation_files, vocab))
    n_clean = sum(1 for _ in stream_batches(plan.training_files, vocab))
    model = os.path.join(work, 'trained.h5')
    wall, counts, rates = run_train_cli(work, model, files, epochs, seed)
    steps = counts['lstm_bwd'] // TRAIN_D
    assert counts['lstm_bwd'] == steps * TRAIN_D and \
        epochs * n_clean <= steps <= 2 * epochs * n_clean, (counts, n_clean)
    assert counts == dict(
        NO_LAUNCHES, lstm_bwd=steps * TRAIN_D,
        lstm_scan=(steps + epochs * n_val) * TRAIN_D), (counts, n_val)
    _, saved_vocab, history = h5io.load_config(model)
    assert saved_vocab.c2i == vocab.c2i
    loss, val_loss = history['loss'], history['val_loss']
    assert len(loss) == epochs and np.isfinite(loss + val_loss).all()
    ln_v = float(np.log(vocab.size))
    assert abs(loss[0] - ln_v) < 0.5 and loss[-1] < loss[0], (loss, ln_v)
    ckpts = sorted(glob.glob(os.path.join(work, 'ckpt', 'ckpt.*.h5')))
    assert ckpts, 'no checkpoint written'
    n_chars = sum(os.path.getsize(f) for f in files)
    print('training path: keraslm-rate train -w %d -d %d -l %d -b %d -e %d '
          'on 3 files, %d chars, V=%d (2 files train, 1 validates): %d '
          'steps (%d windows of all streams an epoch, the rest degraded '
          'duplicates) and %d validation steps; launches %s (expected '
          'lstm_bwd = steps x depth, lstm_scan = (steps + validation '
          'steps) x depth)' % (TRAIN_W, TRAIN_D, TRAIN_T, TRAIN_B, epochs,
                               n_chars, vocab.size, steps, n_clean,
                               epochs * n_val, counts))
    print('training path: loss per epoch %s (ln V = %.4f), val_loss %s; '
          'checkpoints %s; model %s (%d bytes)'
          % (['%.4f' % v for v in loss], ln_v,
             ['%.4f' % v for v in val_loss],
             [os.path.basename(c) for c in ckpts],
             os.path.basename(model), os.path.getsize(model)))
    # the saved model and the last checkpoint load and rate, card and CPU
    excerpt = os.path.join(work, 'excerpt_smoke_1790.txt')
    with open(plan.validation_files[0], encoding='utf-8') as fh:
        text = fh.read(3000)
    with open(excerpt, 'w', encoding='utf-8') as fh:
        fh.write(text)
    ppl = {}
    for platform in ('cuda', 'cpu'):
        res = CliRunner().invoke(
            keraslm_rate, ['-l', 'WARNING', 'test', '-m', model, excerpt],
            env={'KERASLM_PLATFORM': platform})
        assert res.exit_code == 0, (res.output, res.exception)
        ppl[platform] = float(res.output.strip().splitlines()[-1])
    assert np.isfinite(ppl['cuda']) and 1 < ppl['cuda'] < vocab.size
    assert abs(ppl['cuda'] - ppl['cpu']) <= 1e-4 * ppl['cpu'], ppl
    params, cfg, _, _ = h5io.load_model(model)
    assert params['char_embedding'].shape == (vocab.size, TRAIN_W)
    assert h5io.load_weights(ckpts[-1], cfg)['lstm'][1]['recurrent'].shape \
        == (TRAIN_W, 4 * TRAIN_W)
    print('training path: keraslm-rate test of the saved model on a '
          '3000-char excerpt of the validation file: ppl %.6f on the card, '
          '%.6f on the CPU (tolerance rtol 1e-4; exp(val_loss) = %.4f)'
          % (ppl['cuda'], ppl['cpu'], float(np.exp(val_loss[-1]))))
    # --bf16, one epoch of a smaller corpus
    small = write_corpus(os.path.join(work, 'train_corpus_bf16'), rng, {
        'kant_kritik_1781.txt': TRAIN_B * (2 * TRAIN_T + 1),
        'goethe_faust_1808.txt': TRAIN_B * (2 * TRAIN_T + 1)})
    plan16, vocab16 = split_plan(small, seed)
    n_val16 = sum(1 for _ in stream_batches(plan16.validation_files,
                                            vocab16))
    model16 = os.path.join(work, 'trained_bf16.h5')
    wall16, counts16, _ = run_train_cli(work, model16, small, 1, seed,
                                        extra=('--bf16',))
    steps16 = counts16['lstm_bwd'] // TRAIN_D
    assert steps16 >= 2 and counts16['lstm_scan'] == \
        (steps16 + n_val16) * TRAIN_D, (counts16, n_val16)
    hist16 = h5io.load_config(model16)[2]
    assert np.isfinite(hist16['loss'] + hist16['val_loss']).all()
    assert abs(hist16['loss'][0] - float(np.log(vocab16.size))) < 0.5
    print('training path --bf16: 1 epoch on 2 files, %d steps and %d '
          'validation steps; launches %s; loss %.4f (ln V = %.4f), '
          'val_loss %.4f; model %s written'
          % (steps16, n_val16, counts16, hist16['loss'][0],
             float(np.log(vocab16.size)), hist16['val_loss'][0],
             os.path.basename(model16)))
    return dict(wall=wall, steps=steps, val_steps=epochs * n_val,
                epochs=epochs, rates=rates, launches=counts, files=files,
                seed=seed,
                launches_bf16=counts16, plan=plan, vocab=vocab,
                n_chars=n_chars)


def trainer(device, vocab, compute_dtype='float32', width=TRAIN_W,
            length=TRAIN_T):
    """A configured ``Rater`` at the main path's width (or ``width``)
    with fresh parameters (``configure`` seeds them), trainable copies of
    them and their optimizer."""
    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.rater import Rater
    rater = Rater(device=device)
    rater.width, rater.depth, rater.length = width, TRAIN_D, length
    rater.compute_dtype = compute_dtype
    rater.vocab, rater.voc_size = vocab, vocab.size
    rater.configure()
    params = training.copy_params(rater.params, requires_grad=True)
    return rater.cfg, params, training.make_optimizer(params)


def run_steps(device, vocab, batches, compute_dtype='float32', sync=None,
              width=TRAIN_W, length=TRAIN_T):
    """``train_step`` over ``batches`` from a fresh initialisation and
    dropout seed 5; returns ([loss per step], final carry, [wall s per
    step] when ``sync`` is given)."""
    import torch
    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.models.lstm_lm import zero_carry
    cfg, params, optimizer = trainer(device, vocab, compute_dtype, width,
                                     length)
    rng = torch.Generator().manual_seed(5)
    carry = zero_carry(cfg, TRAIN_B, device)
    losses, walls = [], []
    for batch in batches:
        x, zs, y, mask, x_mask = training.batch_tensors(batch, device)
        t0 = time.time()
        carry, loss, _, _ = training.train_step(
            params, optimizer, cfg, x, zs, y, mask, carry, rng, x_mask)
        if sync:
            sync()
            walls.append(time.time() - t0)
        losses.append(loss)
    return [float(v) for v in losses], carry, walls


def training_steps(train, dev, card):
    """Card against CPU over five steps, then the wall per step and the
    device's busy share over a window of steps."""
    import itertools

    import torch
    batches = list(itertools.islice(
        stream_batches(train['plan'].training_files, train['vocab']), 12))
    vocab = train['vocab']
    zero_counts()
    got, carry_g, _ = run_steps(dev, vocab, batches[:5])
    torch.cuda.synchronize()
    counts = read_counts()
    assert counts['lstm_scan'] == counts['lstm_bwd'] == 5 * TRAIN_D, counts
    want, carry_c, _ = run_steps('cpu', vocab, batches[:5])
    loss_err = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    carry_err = max(float((g.cpu() - c).abs().max())
                    for g, c in zip(carry_g, carry_c))
    assert loss_err <= 1e-5 and carry_err <= 1e-5, (got, want, carry_err)
    print('train_step card against CPU (5 steps at -w %d -d %d -l %d -b %d, '
          'same initialisation, batches and dropout seed): losses %s on '
          'the card, %s on the CPU, max relative diff %.3g; final carry '
          'max abs diff %.3g (tolerances: losses rtol 1e-5, carry atol '
          '1e-5)' % (TRAIN_W, TRAIN_D, TRAIN_T, TRAIN_B,
                     ['%.6f' % v for v in got], ['%.6f' % v for v in want],
                     loss_err, carry_err))
    out = {}
    for dtype in ('float32', 'bfloat16'):
        _, _, walls = run_steps(dev, vocab, batches, dtype,
                                sync=torch.cuda.synchronize)
        steady = walls[2:]
        step_s = sum(steady) / len(steady)
        print('train_step wall %s (host clock, synchronised each step, '
              'mean of %d steps after 2 warm-ups; min %.2f, max %.2f ms): '
              '%.2f ms/step = %.0f chars/s inside a run of steps [%s]'
              % (dtype, len(steady), 1e3 * min(steady), 1e3 * max(steady),
                 1e3 * step_s, TRAIN_B * TRAIN_T / step_s, card))
        out[dtype] = step_s
    traced_wall, busy = profiled(
        lambda: run_steps(dev, vocab, batches[:10]))
    print_profile('training steps', traced_wall, busy, card,
                  over='10 train_steps from a fresh initialisation')
    print_others('training steps')
    out.update(traced_wall=traced_wall, busy=busy)
    return out


def lstm_train_bound(args, bf16):
    """Bound of one ``lstm_scan`` launch with ``c_all``: 2*T*B*W*4W
    FLOP, held to the bf16 tensor-core peak under a bf16 U (its operands
    are bf16 values) and to the f32 peak otherwise; x_proj, the carry
    and U read once, h_all, c_all and the final carry written once."""
    x_proj = args[0]
    B, T, G = x_proj.shape
    W = G // 4
    flops = 2 * B * T * W * G
    out = (2 * B * T * W + 2 * B * W) * 4
    return bound(flops, tensor_bytes(*args) + out, flops if bf16 else 0)


def lstm_bwd_bound(args, bf16):
    """Bound of one ``lstm_bwd`` launch: 6*T*B*W*4W FLOP (the z
    recompute, dz @ U^T and h_prev^T @ dz).  Under a bf16 U the z
    recompute has bf16 operands (tensor-core peak); dz is f32, so the
    other two products are held to the f32 peak.  Every input read once
    (U once: its transpose is made from it), dx_proj, dU, dh0 and dc0
    written once."""
    xp = args[0]
    T, B, G = xp.shape
    W = G // 4
    flops = 6 * T * B * W * G
    out = (T * B * G + W * G + 2 * B * W) * 4
    return bound(flops, tensor_bytes(*args) + out,
                 flops // 3 if bf16 else 0)


def cudnn_layer(inp, W):
    """``torch.nn.LSTM`` (cuDNN, f32, one layer, seeded default
    weights) over ``inp`` (B, T, in): (forward alone, forward and
    backward) as functions of nothing; the library yardstick, never
    called by the port."""
    import torch
    torch.manual_seed(0)
    lstm = torch.nn.LSTM(inp.shape[-1], W, batch_first=True).to(inp.device)
    grad = torch.ones((inp.shape[0], inp.shape[1], W), device=inp.device)
    inp_g = inp.clone().requires_grad_()

    def forward():
        with torch.no_grad():
            return lstm(inp)

    def forward_backward():
        lstm.zero_grad(set_to_none=True)
        inp_g.grad = None
        out, _ = lstm(inp_g)
        out.backward(grad)
    return forward, forward_backward


def training_numbers(dev, card):
    """Phase 7, the two training kernels at the main path's shape with
    f32 and bf16 U; returns {row name: numbers}."""
    import torch
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    rng = np.random.default_rng(20261019)
    B, T, W = TRAIN_B, TRAIN_T, TRAIN_W
    inp = torch.from_numpy(rng.normal(0, 1, (B, T, W + 10)).astype(
        np.float32)).to(dev)
    cudnn_fwd, cudnn_fwd_bwd = cudnn_layer(inp, W)
    out = {}
    for bf16 in (False, True):
        kind = 'bf16' if bf16 else 'f32'
        fwd, cot = lstm_train_inputs(rng, dev, bf16)
        saved = lc.lstm_scan(*fwd, want_c_all=True)[:2]
        bwd = lstm_bwd_args(fwd, cot, saved)
        for name, kernel, plain, library, bnd, what in (
                ('lstm_scan_' + ('bf16' if bf16 else 'train'),
                 lambda: lc.lstm_scan(*fwd, want_c_all=True),
                 lambda: lc.lstm_scan_ref(*fwd, want_c_all=True),
                 cudnn_fwd, lstm_train_bound(fwd, bf16), 'forward'),
                ('lstm_bwd' + ('_bf16' if bf16 else ''),
                 lambda: lc.lstm_bwd(*bwd), lambda: lc.lstm_bwd_ref(*bwd),
                 cudnn_fwd_bwd, lstm_bwd_bound(bwd, bf16),
                 'forward and backward')):
            ms = cuda_ms(kernel, 5)
            plain_ms = cuda_ms(plain, 1)
            library_ms = cuda_ms(library, 5)
            ms2 = cuda_ms(kernel, 5)
            bound_ms, bound_by, flops = bnd
            print('%s (%s U) at the training shape (B=%d streams, T=%d, '
                  'W=%d, c_all on): %.3f ms/launch then %.3f ms/launch '
                  '(CUDA events, mean of 5 warm launches), %.2f us/step '
                  '[%s]' % (name, kind, B, T, W, ms, ms2, 1e3 * ms2 / T,
                            card))
            print('%s plain version at the same shape: %.3f ms (CUDA '
                  'events, one warm run) [%s]' % (name, plain_ms, card))
            print('%s bound: %.4f ms by %s (%.3g FLOP%s); kernel at %.2f%% '
                  'of it [%s]'
                  % (name, bound_ms, bound_by, flops,
                     ', the products with bf16 operands at the tensor '
                     'cores\' 989 TFLOP/s although the kernel runs them on '
                     'CUDA cores (the bound is the card\'s, not the '
                     'kernel\'s), the rest at 67 TFLOP/s' if bf16
                     else ' at 67 TFLOP/s f32', 100 * bound_ms / ms2, card))
            print('%s library yardstick: torch.nn.LSTM (cuDNN, f32), 1 '
                  'layer, %s over the same %d streams x %d steps: %.3f ms '
                  '(mean of 5); it also computes the input projection '
                  'that the kernel receives precomputed%s [%s]'
                  % (name, what, B, T, library_ms,
                     ', and its forward (the kernel is the backward alone)'
                     if 'bwd' in name else '', card))
            out[name] = dict(ms=ms2, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms)
        lay = lc.bwd_layout_on(dev, B, W)
        with scan_layout(reg=False):
            one_ms = cuda_ms(lambda: lc.lstm_bwd(*bwd), 5)
        print('lstm_bwd (%s U) at the training shape in the one-block layout '
              '(the first port\'s chain, z from lstm_bwd_z): %.3f ms/launch '
              '(CUDA events, mean of 5); the layout taken, %s (%d streams a '
              'cluster of %d blocks, %d units a block, %d streams a thread '
              'chain), %.2fx faster [%s]'
              % (kind, one_ms, 'the register layout' if lay.reg else
                 'the one-block layout', lay.rb, lay.cl, -(-W // lay.cl),
                 lay.rt, one_ms / out['lstm_bwd' + ('_bf16' if bf16
                                                    else '')]['ms'], card))
    return out


def kernel_split(fn):
    """[(kernel name, device ms)] of one ``fn()`` call (torch.profiler,
    after a warm-up), largest first (``gen_beam_phases.py bwd``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            key = evt.name.split('<')[0].split('(')[0][:60]
            per[key] = per.get(key, 0.0) + evt.time_range.elapsed_us() / 1e3
    return sorted(per.items(), key=lambda kv: -kv[1])


# ---------------------------------------------------------------------
# generation: the beam-step and traceback kernels
# ---------------------------------------------------------------------

GEN_PROMPT = 'Die Vernunft '
GEN_N, GEN_VARIANTS = 1000, 3           # keraslm-rate generate -n -v
GEN_BATCH, GEN_BATCH_N = 16, 256        # generate_batch: prompts, chars


def gen_inputs(rater, prompts):
    """``gen_beam``'s weights, v_real and the prefix-conditioned fringes
    (N, 256, S), (N, 256) of ``prompts``, as ``beam_device`` makes them."""
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    from ocrd_keraslm_torch.ops.beam_device import FRINGE, _prefix_arrays
    w = rater._decode_weights(None)
    weights = (w['emb'], w['embT'], w['wcat'], w['bias'])
    ids, mask = _prefix_arrays([rater.vocab.encode(p) for p in prompts])
    state0, cost0 = gk._prefix_fringe(*weights, ids, mask, w['v_real'],
                                      FRINGE)
    return weights, w['v_real'], state0, cost0


def gen_prompts(rater, rng, n):
    """``n`` seeded German-like prompts of 1-4 words and a space."""
    words = [w for w in GERMAN_WORDS if set(w) <= _charset(rater.vocab)]
    return [' '.join(words[i] for i in rng.integers(
        len(words), size=int(rng.integers(1, 5)))) + ' ' for _ in range(n)]


def gen_bound(weights, v_real, state0, cost0, rec):
    """Bound of one ``gen_beam`` launch: 2*(D*2W*4W + W*v_real) FLOP per
    live fringe row and step (the gate products over ``[x | h]`` and the
    tied logits over the real columns; rows dead before the step need
    none: the fringe fills in the first three steps); bytes of the
    weights (``emb``/``embT`` at their v_real real rows and columns),
    ``state0`` and ``cost0`` read once and the records written once."""
    import torch
    emb, embT, wcat, bias = weights
    D, W = wcat.shape[0], emb.shape[1]
    parents = torch.cat([cost0[:, None], rec[:, :-1, 2]], 1)
    rows = int((parents < 1e38).sum())
    flops = rows * 2 * (D * 2 * W * 4 * W + W * v_real)
    nbytes = (2 * v_real * W * 4 + tensor_bytes(wcat, bias, state0, cost0)
              + tensor_bytes(rec))
    return bound(flops, nbytes)


# sha256 of gen_beam's records and final fringe in gen_digests, as the
# kernel of commit 2399e92 gave them (its first design: the fringe rows
# split over a cluster of 16 or of 8 blocks, both equal; NVIDIA H100 80GB
# HBM3, 700.00 W): every layout the chooser can take keeps them bit for
# bit
GEN_DIGESTS = {
    'german prompt t64 rec':
        'bc63c6725738013234fe4de0338f1bce4a1bdcbd23231c04daa89b43ed40c81f',
    'german prompt t64 final':
        '1621b395fa6c231d34b8dffcfc3b6ffda18d39d3b776055e2f683a96a6ce86f1',
    'german batch16 t256 rec':
        'dba43a54cfdfcdbd7e73bbd46a86885c2380a6bb13a61169799cb03211a9b37e',
    'german batch16 t256 final':
        '0fb56b8a99cb74c2b6e8c88f309de293832d56b34fb50b51d869a6e1a8a13fee',
    'd1w64 t128 rec':
        '30d28626262f0ca59ab1408dbdca62fbabb6d0f821e85472c807ccc25beafbd0',
    'd1w64 t128 final':
        'f1689115704d9a323e84bcc13123584e8dcdaaaa7d057b27a3c45ac5d3702c95'}


def gen_digest_cases(rater, dev):
    """{case: (weights, v_real, state0, cost0, steps)} of
    :func:`gen_digests`: the german model from the prompt of
    :func:`gen_parity_phase` (64 steps) and from the ``GEN_BATCH``
    prompts of the batch row (``GEN_BATCH_N`` steps), and seeded random
    weights of a narrower one-layer model (D=1, W=64, v_real=70 of 128)
    from three seeded prefixes (128 steps); K=256 throughout."""
    import torch
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    from ocrd_keraslm_torch.ops.beam_device import FRINGE
    cases = {}
    prompts = gen_prompts(rater, np.random.default_rng(20261020), 2)
    weights, v_real, state0, cost0 = gen_inputs(rater, prompts)
    cases['german prompt t64'] = (weights, v_real, state0[:1].contiguous(),
                                  cost0[:1].contiguous(), 64)
    prompts = gen_prompts(rater, np.random.default_rng(21), GEN_BATCH)
    cases['german batch16 t256'] = gen_inputs(rater, prompts) + (
        GEN_BATCH_N,)
    rng = np.random.default_rng(20261107)
    D, W, Vp, vr = 1, 64, 128, 70
    emb = np.zeros((Vp, W), np.float32)
    emb[:vr] = rng.normal(0, 1, (vr, W))
    small = tuple(torch.from_numpy(a).to(dev) for a in (
        emb, emb.T.copy(),
        rng.normal(0, 0.3, (D, 2 * W, 4 * W)).astype(np.float32),
        rng.normal(0, 0.1, (D, 1, 4 * W)).astype(np.float32)))
    ids = rng.integers(1, vr, (3, 6)).astype(np.int32)
    mask = np.ones((3, 6), np.float32)
    mask[:, -1] = 0.0
    state0, cost0 = gk._prefix_fringe(*small, ids, mask, vr, FRINGE)
    cases['d1w64 t128'] = (small, vr, state0, cost0, 128)
    return cases


def gen_digests(rater, dev):
    """{(case + ' rec' or ' final', layout): sha256} of ``gen_beam``'s
    records (N, T, 3, K) and final fringe (N, K, S) on
    :func:`gen_digest_cases`, in every layout the chooser can take for
    the case's shape and streams (:func:`gen_layouts_on`; row groups
    where the case's few streams leave the card room)."""
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    out = {}
    for case, (weights, v_real, state0, cost0, T) in gen_digest_cases(
            rater, dev).items():
        Vp, W = weights[0].shape
        for lay in gen_layouts_on(dev, state0.shape[1], weights[2].shape[0],
                                  W, Vp, 10, v_real, state0.shape[0]):
            with gen_layout(lay):
                rec, final = gk.gen_beam(*weights, state0, cost0, length=T,
                                         v_real=v_real, final_state=True)
            out[case + ' rec', lay] = _digest((rec,))
            out[case + ' final', lay] = _digest((final,))
    return out


def gen_layouts_on(dev, K, D, W, Vp, topk, v_real, N=1):
    """Every ``gen_beam`` layout the chooser can take for the shape on
    the card, for a launch of N streams: those of
    ``gen_kernel.gen_layouts`` the card holds a cluster of, in row groups
    only where it holds all N*g clusters at once."""
    import torch
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return [lay for lay in gk.gen_layouts(K, D, W, Vp, topk, v_real)
            if gk.clusters_that_fit(index, K, D, W, Vp, topk, v_real,
                                    lay) >= (N * lay.g if lay.g > 1 else 1)]


@contextlib.contextmanager
def gen_layout(lay):
    """``gen_beam`` launches the layout ``lay`` (a ``gen_kernel.GenLayout``
    of :func:`gen_layouts_on`) inside the block, whatever the chooser
    would take.  The wrapper's cached choices are dropped on entry and on
    exit."""
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    choose = gk.choose
    gk.choose = lambda *args: lay
    gk._layout.cache_clear()
    try:
        yield
    finally:
        gk.choose = choose
        gk._layout.cache_clear()


@contextlib.contextmanager
def decode_cluster(cl, shard=None):
    """``decode_lattice`` and ``decode_lattice_batch`` run a document on
    ``cl`` blocks (1: the one-block kernel of the first port) inside the
    block, whatever the card's occupancy would choose; with ``shard``
    true or false the cluster layout in its sharded or its rows plan,
    whatever the shape would take (``decode_kernel.cluster_shard``).
    The wrappers' cached choices are dropped on entry and on exit."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    choose, plan = dk.choose_cluster, getattr(dk, 'cluster_shard', None)
    dk.choose_cluster = lambda *args: cl
    if shard is not None:
        dk.cluster_shard = lambda *args: shard
    dk._cluster_choice.cache_clear()
    dk._clusters_that_fit.cache_clear()
    try:
        yield
    finally:
        dk.choose_cluster = choose
        if plan is not None:
            dk.cluster_shard = plan
        dk._cluster_choice.cache_clear()
        dk._clusters_that_fit.cache_clear()


# scan_layout's and scan_layouts' third field for the grid layout
GRID = 'grid'


@contextlib.contextmanager
def scan_layout(rb=None, cl=1, reg=True):
    """``lstm_scan``, ``score_scan`` and ``lstm_bwd`` launch the register
    layout on clusters of ``cl`` blocks of ``rb`` streams (default: as
    many as the chooser would put in one cluster), with ``reg`` false
    the one-block layout (of ``rb`` streams a block where given), or
    with ``reg`` equal to ``GRID`` the grid layout of ``lstm_scan`` and
    ``lstm_bwd`` in groups of ``rb`` streams (default: as the chooser
    groups them on this card), inside the block, whatever the card's
    occupancy would choose.  The wrappers' cached layouts are dropped on
    entry and on exit."""
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import scan_layout as sl
    from ocrd_keraslm_torch.ops import score_kernel as sk
    choose, one_block_rows = sl.choose, sl.one_block_rows
    if not reg and rb:
        sl.one_block_rows = lambda kind, B, *a, **k: min(
            rb, sl.rows_per_block(B))

    def forced(kind, B, W, D, fits, n_sm, bf16=False, Vp=0):
        if not reg:
            return sl.one_block_layout(kind, B, W, D, bf16, Vp)
        if reg == GRID:
            lay = sl.grid_layout_for(kind, B, W, rb or -(-B // min(
                B, sl.grid_groups(W, n_sm))))
        else:
            lay = sl.reg_layout_for(kind, W, D, rb or sl.rows_per_block(B),
                                    cl)
        assert lay is not None, (kind, B, W, D, rb, cl, reg)
        return lay

    def clear():
        lc._layout.cache_clear()
        lc._bwd_layout.cache_clear()
        sk._layout.cache_clear()
    sl.choose = forced
    clear()
    try:
        yield
    finally:
        sl.choose, sl.one_block_rows = choose, one_block_rows
        clear()


def gen_parity_phase(rater):
    """Phase 3, the two generation kernels at full width: the beam step
    in every unit layout the card takes, against its plain version, then
    its digests in every layout the chooser can take; returns the beam
    step's max abs cost error."""
    import torch
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    rng = np.random.default_rng(20261020)
    prompts = gen_prompts(rater, rng, 2)
    weights, v_real, state0, cost0 = gen_inputs(rater, prompts)
    Vp, W = weights[0].shape
    err = 0.0
    for lay in gen_layouts_on(state0.device, 256, rater.depth, W, Vp, 10,
                              v_real):
        if not lay.units:
            continue
        t0 = time.time()
        with gen_layout(lay):
            e, ties = gen_parity(gk.gen_beam, gk.gen_beam_ref, weights,
                                 state0[:1].contiguous(),
                                 cost0[:1].contiguous(), 64, v_real)
        err = max(err, e)
        print('parity gen_beam (%s, prompt %r, K=256, TOPK=10, 64 steps, '
              'D=%d, W=%d, v_real=%d): chars and backpointers equal at '
              'every step, max |kernel - plain| %.3g over live costs, '
              'near-ties resumed from the kernel\'s fringe at steps %s '
              '(tolerance: costs rtol 1e-5 atol 1e-6) in %.1f s'
              % (describe_gen_layout(lay), prompts[0], rater.depth,
                 rater.width, v_real, e, ties or 'none', time.time() - t0))
    t0 = time.time()
    got = gen_digests(rater, state0.device)
    bad = sorted((k, tuple(lay)) for (k, lay), v in got.items()
                 if v != GEN_DIGESTS[k])
    print('gen_beam output digests (sha256 of the records and the final '
          'fringe, %d cases) in every layout the chooser can take (%s): %s '
          'equal to those of the kernel of commit 2399e92%s, in %.1f s'
          % (len(GEN_DIGESTS) // 2, '; '.join(sorted({
              describe_gen_layout(lay) + ' for ' + k.rsplit(' ', 1)[0]
              for k, lay in got})), 'all' if not bad else 'NOT all',
             ': differ in %s' % bad if bad else '', time.time() - t0))
    assert not bad, ('gen_beam outputs changed', bad)
    rec = gk.gen_beam(*weights, state0, cost0, length=64, v_real=v_real)
    for out_length in (64, 41):
        best = torch.argsort(rec[:, out_length - 1, 2], dim=1,
                             stable=True)[:, :GEN_VARIANTS].int().contiguous()
        got = gk.traceback(rec, best, out_length)
        torch.cuda.synchronize()
        assert torch.equal(got, gk.traceback_ref(rec, best, out_length))
    print('parity gen_traceback (2 streams, %d cursors each, T=64, '
          'out_length 64 and 41): equal to the plain version'
          % GEN_VARIANTS)
    return err


# traceback shapes held to the plain version: (streams, steps, slots,
# cursors, out_length, forced steps a segment)
TB_CASES = ((1, 1024, 256, 3, 1000, None),    # generate -n 1000 -v 3
            (16, 256, 256, 1, 256, None),     # generate_batch of 16
            (3, 4096, 256, 3, 4000, None),    # T*K beyond a block's memory
            (2, 1024, 256, 1024, 1024, None),  # 1024 cursors
            (5, 16, 256, 3, 16, None),        # one segment, one launch
            (1, 5000, 200, 2, 4999, 64))      # maps composed in chunks


def tb_parity_phase():
    """Phase 3, the traceback's segment plans over seeded records (half
    the backpointers at slot K-1, 255 at K=256): equal to the plain
    version, one launch counted a call."""
    import torch
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    rng = np.random.default_rng(20261017)
    t0 = time.time()
    for N, T, K, VARS, out_length, segment in TB_CASES:
        rec = np.zeros((N, T, 3, K), np.float32)
        rec[:, :, 0] = rng.integers(1, 70, (N, T, K))
        rec[:, :, 1] = np.where(rng.random((N, T, K)) < 0.5, K - 1,
                                rng.integers(0, K, (N, T, K)))
        best = rng.integers(0, K, (N, VARS)).astype(np.int32)
        rec, best = torch.from_numpy(rec), torch.from_numpy(best)
        launches = gk.traceback.launches
        got = gk.traceback(rec.cuda(), best.cuda(), out_length, segment)
        torch.cuda.synchronize()
        assert gk.traceback.launches == launches + 1
        assert torch.equal(got.cpu(), gk.traceback_ref(rec, best,
                                                       out_length)), \
            (N, T, K, VARS, out_length, segment)
    print('parity gen_traceback over seeded records at %s ((streams, steps, '
          'slots, cursors, out_length, forced segment)): equal to the plain '
          'version, segment plans %s, in %.1f s'
          % (', '.join(str(c) for c in TB_CASES),
             ', '.join('%d x %d steps' % (lay.G, lay.L) for lay in (
                 gk.tb_layout(T, K, o, seg)
                 for N, T, K, _, o, seg in TB_CASES)), time.time() - t0))


def describe_gen_layout(lay):
    """A ``gen_kernel.GenLayout`` in words."""
    if lay.units and lay.g > 1:
        return ('the unit layout in %d row groups a stream, each on a '
                'cluster of %d blocks (%d row half(s) by %d unit groups), '
                'tiles of %d rows'
                % (lay.g, lay.cl, lay.rh, lay.cl // lay.rh, lay.tr))
    if lay.units:
        return ('the unit layout on %d blocks a stream (%d row half(s) by '
                '%d unit groups), tiles of %d rows'
                % (lay.cl, lay.rh, lay.cl // lay.rh, lay.tr))
    return 'the rows layout (the first design) on %d blocks a stream' % \
        lay.cl


def run_generate(number, variants, platform):
    """``keraslm-rate generate`` of ``GEN_PROMPT`` in this process, the
    counts zeroed before; returns (its result lines, wall s, counts)."""
    import torch
    from click.testing import CliRunner
    from ocrd_keraslm_torch.scripts.run import cli as keraslm_rate
    zero_counts()
    t0 = time.time()
    res = CliRunner().invoke(keraslm_rate, [
        '-l', 'WARNING', 'generate', '-m', MODEL, '-n', str(number), '-v',
        str(variants), GEN_PROMPT], env={'KERASLM_PLATFORM': platform})
    torch.cuda.synchronize()
    wall = time.time() - t0
    assert res.exit_code == 0, (res.output, res.exception)
    # a line may end with a space: cut the newline alone
    lines = res.output.rstrip('\n').split('\n')[-variants:]
    assert len(lines) == variants and all(
        ln.startswith(GEN_PROMPT) and len(ln) == len(GEN_PROMPT) + number
        for ln in lines), lines
    return lines, wall, read_counts()


def generation_path(rater, card):
    """Phase 6, generation; returns the path's numbers."""
    import torch
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    gk.gen_beam.row_groups = 0
    lines, wall_cli, counts = run_generate(GEN_N, GEN_VARIANTS, 'cuda')
    assert counts == dict(NO_LAUNCHES, gen_beam=1, gen_traceback=1), counts
    print('generation path: keraslm-rate generate -n %d -v %d %r: %d '
          'lines of %d chars; launches %s (expected one gen_beam and one '
          'gen_traceback), its row groups (gen_beam.row_groups) %d; first '
          'line ends %r'
          % (GEN_N, GEN_VARIANTS, GEN_PROMPT, len(lines), len(lines[0]),
             counts, gk.gen_beam.row_groups, lines[0][-60:]))
    small = {p: run_generate(64, GEN_VARIANTS, p)[0] for p in ('cuda', 'cpu')}
    assert small['cuda'] == small['cpu'], small
    print('generation path -n 64 -v %d: the same %d lines on the card and '
          'on the CPU: %r' % (GEN_VARIANTS, GEN_VARIANTS, small['cuda']))
    prompts = gen_prompts(rater, np.random.default_rng(21), GEN_BATCH)
    zero_counts()
    gk.gen_beam.row_groups = 0
    t0 = time.time()
    batch = rater.generate_batch(prompts, GEN_BATCH_N)
    wall_batch = time.time() - t0
    batch_counts = read_counts()
    assert batch_counts == dict(NO_LAUNCHES, gen_beam=1, gen_traceback=1), \
        batch_counts
    batch_groups = gk.gen_beam.row_groups
    singles = [rater.generate(p, GEN_BATCH_N)[0] for p in prompts]
    assert batch == singles
    print('generation path: Rater.generate_batch of %d prompts at -n %d: '
          'launches %s (one of each for all prompts), row groups %d; every '
          'string equals its single generate call'
          % (GEN_BATCH, GEN_BATCH_N, batch_counts, batch_groups))
    walls = []
    for _ in range(3):
        t0 = time.time()
        rater.generate(GEN_PROMPT, GEN_N, variants=GEN_VARIANTS)
        walls.append(time.time() - t0)
    traced_wall, busy = profiled(
        lambda: rater.generate(GEN_PROMPT, GEN_N, variants=GEN_VARIANTS))
    return dict(wall_cli=wall_cli, walls=walls, launches=counts,
                batch_launches=batch_counts, wall_batch=wall_batch,
                prompts=prompts, traced_wall=traced_wall, busy=busy)


def generation_numbers(rater, gen, card):
    """Phase 7, the generation kernels at the main path's shapes: one
    stream of the 1024-step bucket (``-n 1000``) and the batch of
    ``GEN_BATCH`` streams of ``GEN_BATCH_N`` steps; the traceback of
    ``GEN_VARIANTS`` cursors over the first's records."""
    import torch
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    from ocrd_keraslm_torch.ops.beam_device import LENGTH_BUCKETS
    from ocrd_keraslm_torch.utils.buckets import bucket_unbounded
    out = {}
    for name, prompts, number in (
            ('gen_beam', [GEN_PROMPT], GEN_N),
            ('gen_beam_batch', gen['prompts'], GEN_BATCH_N)):
        weights, v_real, state0, cost0 = gen_inputs(rater, prompts)
        T = bucket_unbounded(number, LENGTH_BUCKETS)
        N = len(prompts)

        def kernel():
            return gk.gen_beam(*weights, state0, cost0, length=T,
                               v_real=v_real)

        ms = cuda_ms(kernel, 3)
        plain_ms = cuda_ms(lambda: gk.gen_beam_ref(
            *weights, state0, cost0, length=T, v_real=v_real), 1)
        ms2 = cuda_ms(kernel, 3)
        rec = kernel()
        bound_ms, bound_by, flops = gen_bound(weights, v_real, state0, cost0,
                                              rec)
        lay = gk.layout_on(state0.device, N, 256, rater.depth,
                           rater.width, weights[0].shape[0], 10, v_real)
        print('%s at the main path shape (N=%d streams, T=%d steps, K=256, '
              'TOPK=10, D=%d, W=%d; %s): %.3f ms/launch then %.3f '
              'ms/launch (CUDA events, mean of 3 warm launches), %.2f '
              'us/step, %.0f generated chars/s over the streams [%s]'
              % (name, N, T, rater.depth, rater.width,
                 describe_gen_layout(lay), ms, ms2, 1e3 * ms2 / T,
                 N * T / (ms2 / 1e3), card))
        print('%s plain version at the same shape: %.3f ms (CUDA events, '
              'one warm run) [%s]' % (name, plain_ms, card))
        # the floor of one cluster of 16 SMs a stream (128 f32 FMA a
        # clock each, 1.98 GHz boost), and of the SMs the launch holds at
        # once (its clusters up to as many as fit the card)
        floor_ms = 1e3 * flops / min(N, 132 // 16) / (16 * 256 * 1.98e9)
        at_once = min(N * lay.g, gk.clusters_that_fit(
            torch.cuda.current_device(), 256, rater.depth, rater.width,
            weights[0].shape[0], 10, v_real, lay))
        sms = at_once * lay.cl
        print('%s launch holds %d SMs at once (%d of its %d cluster(s) of '
              '%d blocks, %d row group(s) a stream, one block an SM): their '
              'floor %.3f ms, kernel at %.1f%% of it [%s]'
              % (name, sms, at_once, N * lay.g, lay.cl, lay.g,
                 1e3 * flops / (sms * 256 * 1.98e9),
                 100 * 1e3 * flops / (sms * 256 * 1.98e9) / ms2, card))
        print('%s bound: %.4f ms by %s (%.4g f32 FLOP at 67 TFLOP/s, %.4g '
              'a step and stream); kernel at %.3f%% of it; the floor of '
              'one 16-SM cluster a stream (at most %d at once; 16 x 128 '
              'FMA a clock at 1.98 GHz): %.3f ms, kernel at %.1f%% of it; '
              'library call: none - no single PyTorch call runs a beam step '
              '[%s]' % (name, bound_ms, bound_by, flops, flops / N / T,
                        100 * bound_ms / ms2, 132 // 16, floor_ms,
                        100 * floor_ms / ms2, card))
        out[name] = dict(ms=ms2, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
        if name == 'gen_beam':
            walk = (rec, torch.argsort(rec[:, GEN_N - 1, 2], dim=1,
                                       stable=True)[:, :GEN_VARIANTS]
                    .int().contiguous(), GEN_N)
    assert torch.equal(gk.traceback(*walk).cpu(), gk.traceback_ref(
        walk[0].cpu(), walk[1].cpu(), GEN_N))
    ms = device_ms(lambda: gk.traceback(*walk), 20)
    plain_ms = cuda_ms(lambda: gk.traceback_ref(*walk), 1)
    ms2 = device_ms(lambda: gk.traceback(*walk), 20)
    host_ms = cuda_ms(lambda: gk.traceback(*walk), 20)
    # the walk needs two floats of the records a cursor and step, the
    # cursors' start slots, and writes the (VARS, T) chars
    nbytes = GEN_VARIANTS * (GEN_N * 2 * 4 + 4 + walk[0].shape[1] * 4)
    bound_ms, bound_by, _ = bound(0, nbytes)
    lay = gk.tb_layout(walk[0].shape[1], walk[0].shape[3], GEN_N)
    print('gen_traceback at the main path shape (%d cursors, T=%d, '
          'out_length %d; %d segments of %d steps, %d launches a call): '
          '%.4f ms/call then %.4f ms/call (device time: calls queued behind '
          'a sleep kernel, CUDA events, mean of 20), %.1f ns/step; %.4f '
          'ms/call timed as launched one after another by the host (mean '
          'of 20) [%s]'
          % (GEN_VARIANTS, walk[0].shape[1], GEN_N, lay.G, lay.L,
             1 + (lay.G > 1), ms, ms2, 1e6 * ms2 / GEN_N, host_ms, card))
    print('gen_traceback plain version: %.3f ms; bound %.3g ms by %s (%d '
          'bytes at 3.35 TB/s; the walk is a chain of %d dependent loads); '
          'kernel at %.3g%% of it; library call: none - no single PyTorch '
          'call walks backpointers [%s]'
          % (plain_ms, bound_ms, bound_by, nbytes, GEN_N,
             100 * bound_ms / ms2, card))
    out['gen_traceback'] = dict(ms=ms2, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=None)
    return out


# ---------------------------------------------------------------------
# the unbounded engines: beam widths over 32, texts over 64 chars, a
# model that no kernel layout takes
# ---------------------------------------------------------------------

ENGINE_BEAM = 40             # -P beam_width of part (a) and the batch
WIDE_W, WIDE_T = 512, 64     # part (d): the width and training window
# sha256 of lstm_bwd's outputs at W=512 (the one-block layout at 4
# streams a block; B=128, T=64, f32 U, seeded as wide_bwd_inputs makes
# them), from the first chip run of that layout (NVIDIA H100 80GB HBM3);
# the grid layout keeps it
WIDE_BWD_DIGEST = \
    'e392cbde8c1ceb9ff0cff5732ba8124c0bb03437cade73bd3a82ee16265dc629'
# sha256 of lstm_scan's outputs (h_all, c_all, hT, cT) on the same
# inputs, from the one-block layout of the first port (NVIDIA H100 80GB
# HBM3); the grid layout keeps it
WIDE_SCAN_DIGEST = \
    '9ce353c0d7c8542b00b675e4c36c05aba141838cc23ef4daf4948aa54027abfc'


# the bf16 decode mode card against CPU: two bf16 runs drift apart from
# the first h that rounds to another bf16 value (parity_stepwise).  On
# the card (NVIDIA H100 80GB HBM3) the one-page workspace's confs parted
# by 1.1e-3 and the kernel-engine-kernel pages' scores by 9.2e-5: scores
# are held to BF16_SCORE_TOL, about twice the larger.  Kernel and plain
# version lie up to 0.0127 bits apart after one edge (BF16_EDGE_TOL) and
# drift further from edge to edge: two paths whose bf16 costs lie within
# BF16_TIE_BITS are a near-tie
BF16_SCORE_TOL = 2.5e-3
BF16_TIE_BITS = 0.1


def run_processor(directory, platform, bf16, beam_width=10,
                  level='glyph'):
    """The processor over ``directory`` through its Python entry point
    (``KerasRate``) on ``platform``, with ``rater.decode_bf16 = bf16``
    set after its setup, as a caller turns the bf16 decode mode on (it
    has no CLI parameter, as in the JAX package)."""
    from ocrd_keraslm_torch.wrapper import KerasRate
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    ws = Workspace(directory)
    proc = KerasRate(workspace=ws, parameter=dict(
        model_file=MODEL, textequiv_level=level, beam_width=beam_width),
        device=platform)
    proc.setup()
    proc.rater.decode_bf16 = bf16
    proc.process_workspace(ws)


def bf16_path(rater, work, decode, batch, card):
    """The bf16 decode mode (``rater.decode_bf16 = True``) on its paths:
    (a) the 4 pages of phase 4 through the processor, every glyph with
    one TextEquiv, every page written, the native lane serving every page
    in the page groups of phase 4, one bf16 ``decode_lattice`` launch a
    group and no f32 one; how many glyph choices differ from the f32
    default's; the processor's wall in both modes, alternating; (b) a
    one-page workspace through the processor on the card and on the CPU
    (its plain bf16 version): the same choice per glyph and scores within
    ``BF16_SCORE_TOL``, or, where the choices part, both paths' bf16
    costs on the CPU within ``BF16_TIE_BITS``; (c) a bf16 kernel page,
    a page at beam 40 (the f32 engine: x recovered exactly from the bf16
    carry), a kernel page again, card against CPU; (d)
    ``rate_best_batch`` of the 32 one-page documents of the batched path
    in bf16, every path equal to its own bf16 ``rate_best_device``; (e)
    ``generate -n 64`` equal with the flag set and unset.  Returns the
    path's numbers."""
    import torch
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    # (a) the main path's pages
    d = os.path.join(work, 'ws_bf16')
    n_glyphs = build_workspace(d, np.random.default_rng(7), 4, 40,
                               rater.vocab)
    groups = page_groups(d, rater)[1]
    zero_counts()
    t0 = time.time()
    run_processor(d, 'cuda', True)
    wall = time.time() - t0
    counts, lanes = read_counts(), read_lanes()
    check_glyphs(d, n_glyphs)
    assert counts == dict(NO_LAUNCHES, decode_lattice_bf16=len(groups)), \
        (counts, groups)
    assert lanes == dict(pages=4, groups=len(groups), bails=0), lanes
    bf16_out, f32_out = output_glyphs(d)[0], output_glyphs(
        decode['workspace'])[0]
    assert bf16_out.keys() == f32_out.keys()
    differ = [g for g in f32_out if bf16_out[g][0][0] != f32_out[g][0][0]]
    conf_moved = max(abs(bf16_out[g][0][1] - f32_out[g][0][1])
                     for g in f32_out if g not in differ)
    print('bf16 decode path: 4 pages, %d glyphs written through the '
          'processor with rater.decode_bf16 = True; launches %s (expected '
          '%d bf16 decode_lattice: one a page group %s, no f32 launch); the '
          'native page lane served %d pages in %d group launch(es), %d '
          'bails; %d of %d glyph choices differ from the f32 default\'s '
          '(phase 4), confs of the others moved by up to %.3g'
          % (n_glyphs, counts, len(groups), groups, lanes['pages'],
             lanes['groups'], lanes['bails'], len(differ), len(f32_out),
             conf_moved))
    walls = {True: [], False: []}
    for i, mode in enumerate((False, True) * 2):
        di = os.path.join(work, 'ws_bf16_%d' % i)
        build_workspace(di, np.random.default_rng(7), 4, 40, rater.vocab)
        torch.cuda.synchronize()
        t0 = time.time()
        run_processor(di, 'cuda', mode)
        walls[mode].append(time.time() - t0)
    print('bf16 decode path wall (the processor\'s Python entry point over '
          'the same 4 pages, fresh copies, alternating; model load '
          'included, host clock): f32 %s s, bf16 %s s [%s]'
          % (', '.join('%.3f' % w for w in walls[False]),
             ', '.join('%.3f' % w for w in walls[True]), card))
    # (b) card against CPU through the processor
    outs = {}
    for platform in ('cuda', 'cpu'):
        small = os.path.join(work, 'small_bf16_%s' % platform)
        build_workspace(small, np.random.default_rng(8), 1, 6, rater.vocab,
                        alt_share=0.3)
        run_processor(small, platform, True)
        outs[platform] = (small, output_glyphs(small)[0])
    (d_card, card_g), (d_cpu, cpu_g) = outs['cuda'], outs['cpu']
    assert card_g.keys() == cpu_g.keys()
    ties = [g for g in card_g if card_g[g][0][0] != cpu_g[g][0][0]]
    conf_err = max(abs(card_g[g][0][1] - cpu_g[g][0][1])
                   for g in card_g if g not in ties)
    assert conf_err <= BF16_SCORE_TOL, conf_err
    cost_gap = 0.0
    if ties:
        from ocrd_keraslm_torch.wrapper.mets import Workspace
        cpu_rater = german_rater('cpu')
        cpu_rater.decode_bf16 = True
        graph = workspace_graphs(d_cpu)[0]
        costs = []
        for dd in (d_card, d_cpu):
            f = next(Workspace(dd).mets.find_files(fileGrp='OCR-D-LM'))
            costs.append(picks_cost(cpu_rater, graph, output_indices(
                os.path.join(dd, f.local_filename))))
        cost_gap = abs(costs[0] - costs[1])
        assert cost_gap <= BF16_TIE_BITS, (ties, costs)
    print('bf16 decode path, one page of %d glyphs through the processor on '
          'the card and on the CPU (its plain bf16 version): %d choice(s) '
          'part%s; max conf diff of the others %.3g (tolerance %g)'
          % (len(card_g), len(ties),
             ' at a near-tie (both paths\' bf16 costs on the CPU %.4g bits '
             'apart, within %g)' % (cost_gap, BF16_TIE_BITS) if ties else '',
             conf_err, BF16_SCORE_TOL))
    # (c) kernel -> engine -> kernel
    carry = os.path.join(work, 'ws_bf16_carry')
    build_workspace(carry, np.random.default_rng(41), 3, 3, rater.vocab,
                    alt_share=0.3)
    pages = workspace_graphs(carry)
    res = {}
    for device in ('cuda', 'cpu'):
        r = rater if device == 'cuda' else german_rater('cpu')
        r.decode_bf16 = True
        zero_counts()
        edges0 = engine_counters()[0]
        tb, out = None, []
        for g, beam in zip(pages, (10, ENGINE_BEAM, 10)):
            if beam == ENGINE_BEAM:
                x = r._engine_traceback(tb, 64)[2].long()
                emb16 = r.params['char_embedding'].bfloat16().float()
                assert torch.equal(emb16[x[:tb[0].shape[0]]],
                                   tb[0][:, :r.width]), 'x not exact'
            path, ent, tb = r.rate_best_device(g, 0, 0, device_traceback=tb,
                                               beam_width=beam)
            out.append((path, ent))
        r.decode_bf16 = None
        if device == 'cuda':
            carry_counts = read_counts()
            assert carry_counts == dict(NO_LAUNCHES, decode_lattice_bf16=2), \
                carry_counts
            assert engine_counters()[0] > edges0
        res[device] = out
    cpu_rater = german_rater('cpu')
    cpu_rater.decode_bf16 = True
    diff, gaps = same_or_tied(res['cuda'], res['cpu'], pages, cpu_rater,
                              10, tol=BF16_SCORE_TOL, tie_bits=BF16_TIE_BITS)
    print('bf16 decode path, kernel -> engine -> kernel: page 1 at beam 10 '
          '(one bf16 decode_lattice launch), page 2 at beam %d (the f32 '
          'engine, x of every slot recovered exactly from the bf16 carry), '
          'page 3 at beam 10 (one more); card against CPU: max score or '
          'entropy difference %.3g (tolerance %g), near-ties %s'
          % (ENGINE_BEAM, diff, BF16_SCORE_TOL, gaps or 'none'))
    # (d) the serving batch
    docs = workspace_graphs(os.path.join(work, 'ws_batch'))
    merge = batch_prep(rater, docs)[0]
    rater.decode_bf16 = True
    try:
        zero_counts()
        t0 = time.time()
        got = rater.rate_best_batch(docs)
        wall_batch = time.time() - t0
        batch_counts = read_counts()
        keep = rater.merge_runs
        rater.merge_runs = merge
        try:
            seq = [rater.rate_best_device(g, 0, 0)[:2] for g in docs]
        finally:
            rater.merge_runs = keep
        first = first_batch_launch(rater, docs)
    finally:
        rater.decode_bf16 = None
    n_blk = batch['one-page']['launches']['decode_lattice_batch']
    assert batch_counts == dict(NO_LAUNCHES, decode_lattice_batch_bf16=n_blk,
                                walk_records_batch=n_blk), batch_counts
    diff = same_results(got, seq)
    print('bf16 decode path: Rater.rate_best_batch of the %d one-page '
          'documents in %.3f s (host clock, ended by the fetch; f32 %.3f s '
          'in the batched path); launches %s; every path equals the '
          'document\'s own bf16 rate_best_device decode on the card (max '
          'score or entropy difference %.3g, tolerance 1e-4) [%s]'
          % (len(docs), wall_batch, batch['one-page']['wall'], batch_counts,
             diff, card))
    # (e) generation ignores the flag
    plain = rater.generate(GEN_PROMPT, 64, variants=GEN_VARIANTS)
    rater.decode_bf16 = True
    try:
        zero_counts()
        flagged = rater.generate(GEN_PROMPT, 64, variants=GEN_VARIANTS)
        gen_counts = read_counts()
    finally:
        rater.decode_bf16 = None
    assert flagged == plain, (flagged, plain)
    assert gen_counts == dict(NO_LAUNCHES, gen_beam=1, gen_traceback=1)
    print('bf16 decode path: Rater.generate -n 64 -v %d with decode_bf16 '
          'set equals it unset (generation stays f32); launches %s'
          % (GEN_VARIANTS, gen_counts))
    return dict(wall=wall, walls=walls, launches=counts, groups=groups,
                batch_launches=batch_counts, batch_wall=wall_batch,
                first=first, differ=len(differ), glyphs=len(f32_out))


def picks_cost(cpu_rater, graph, pick):
    """Bits, decoded by ``cpu_rater``, of the path through a page's
    ``graph`` that takes at every glyph the alternative of index
    ``pick[glyph id]`` (:func:`output_indices`)."""
    path = []
    for _, _, data in sorted(graph.edges(data=True), key=lambda e: e[0]):
        el, alts = data['element'], data['alternatives']
        path.append((el, alts[0] if el is None else next(
            te for te in alts if te.index == pick[el.id]), 0.0))
    return path_cost(cpu_rater, graph, path, 10)


def engine_counters():
    """(edges, char steps) the decode engine ran so far."""
    from ocrd_keraslm_torch.ops import beam_device as bd
    return (bd.decode_lattice_device.edges,
            bd.decode_lattice_device.char_steps)


def output_level(directory, level, grp='OCR-D-LM'):
    """({glyph, line or region id: [(Unicode, conf), ...]}, output files)
    over every page of ``grp``."""
    if level == 'glyph':
        return output_glyphs(directory, grp)
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.page import parse_page
    ws = Workspace(directory)
    out, files = {}, list(ws.mets.find_files(fileGrp=grp))
    for f in files:
        pcgts = parse_page(os.path.join(directory, f.local_filename))
        for region in pcgts.get_Page().get_TextRegion():
            for el in ([region] if level == 'region' else
                       region.get_TextLine()):
                out[el.id] = [(te.Unicode, te.conf)
                              for te in el.get_TextEquiv()]
    return out, files


def engine_choices_cost(cpu_rater, directory, picks, beam_width):
    """Bits of the document path that takes, at every glyph, the input
    alternative of index ``picks[glyph id]``: every page of the
    workspace, restricted to those alternatives, decoded on the CPU by
    ``rate_best_device`` with the carry (one live path)."""
    from ocrd_keraslm_torch.wrapper import rate as rate_mod
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.page import parse_page
    ws = Workspace(directory)
    total, tb = 0.0, None
    for f in ws.mets.find_files(fileGrp='OCR-D-OCR'):
        pcgts = parse_page(os.path.join(directory, f.local_filename))
        graph, start, end = rate_mod.page_get_linear_graph_at('glyph',
                                                              pcgts)
        for _, _, edge in graph.edges(data=True):
            el = edge['element']
            if el is not None and el.id in picks:
                edge['alternatives'] = [te for te in edge['alternatives']
                                        if te.index == picks[el.id]]
        _, ent, tb = cpu_rater.rate_best_device(
            graph, start, end, device_traceback=tb,
            context=rate_mod.mets_get_context(ws.mets),
            beam_width=beam_width)
        total += ent
    return total


def engine_parity(raters, graphs, context, beam_width):
    """The decode engine on the card against the CPU over the pages
    ``graphs`` (the beam carried from page to page), each page from the
    card's carry: records and final beam held by :func:`compare_decode`.
    Where the two part at a near-tie at the K-th rank (edge t: at K=64
    the candidates about rank 64 of cumulative costs of thousands of bits
    lie within a few f32 ulps, 4.9e-4 bits each, of each other often, and
    the two runs' costs drift apart by that much over a page), the card
    decodes the page once more up to t and both go on from its carry
    after t, as :func:`parity_block` does for the kernels.  Returns (max
    abs error, edges compared, near-tie edges)."""
    from ocrd_keraslm_torch.rater import (L_BUCKETS, STEP_BUCKETS,
                                          _bucket, _bucket_unbounded,
                                          _linear_edges, _longest)
    card, cpu = raters['cuda'], raters['cpu']
    K = _bucket(beam_width, STEP_BUCKETS)
    carry = card._engine_traceback(None, K)
    err, n, ties, offset = 0.0, 0, [], 0
    for graph in graphs:
        edges = card._prepare_decode_edges(_linear_edges(graph))
        arrays = card._fill_decode_arrays(
            edges, len(edges), 4,
            _bucket_unbounded(max(_longest(edges), 1), L_BUCKETS))
        lo = 0
        while lo < len(edges):
            part = tuple(a[lo:] for a in arrays)
            outs = []
            for r, cr in ((card, carry),
                          (cpu, tuple(t.cpu() for t in carry))):
                packed, *new = r._launch_engine(part, context, cr, 0.5,
                                                False)
                # the final beam packed as the kernels carry it
                outs.append((packed.cpu().numpy(),) + tuple(
                    t.cpu().numpy() for t in r._fused_traceback(
                        tuple(new), K, r._decode_weights(context)['emb'])))
                if r is card:
                    nxt = tuple(new)
            e, m, tie = compare_decode(outs[0], outs[1], K, card.width)
            err, n = max(err, e), n + m
            if tie is None:
                carry, lo = nxt, lo + len(part[0])
                continue
            ties.append(offset + lo + tie)
            carry = tuple(card._launch_engine(
                tuple(a[:tie + 1] for a in part), context, carry, 0.5,
                False)[1:])
            lo += tie + 1
        offset += len(edges)
    return err, n, ties


def engine_cli_card_vs_cpu(rater, base, build, level, beam_width, n_pages,
                           may_part=False):
    """A seeded workspace (``build(directory)``) through the processor's
    CLI on the card and on the CPU, ``OCRD_MISSING_OUTPUT`` unset: every
    page written; the same text per glyph, line or region and confs
    within 1e-4; where glyph choices part at a near-tie (both documents'
    path costs, decoded on the CPU, within ``HOST_TIE_BITS``), the
    glyphs are listed and pass.  With ``may_part`` (the engine's parity
    over the same pages found near-ties at the K-th rank, after which
    the two beam searches hold other hypotheses and their later confs
    differ) the outputs may part further: at least 98% of the glyphs
    must keep the same choice.  Returns {platform:
    numbers}, the card's kernel counts and the engine's edges and char
    steps."""
    import torch
    outs = {}
    for platform in ('cuda', 'cpu'):
        d = '%s_%s' % (base, platform)
        build(d)
        zero_counts()
        e0 = engine_counters()
        with env_vars(OCRD_MISSING_OUTPUT=None):
            t0 = time.time()
            run_cli(d, platform, beam_width=beam_width, level=level)
            if platform == 'cuda':
                torch.cuda.synchronize()
            wall = time.time() - t0
        edges, steps = (b - a for a, b in zip(e0, engine_counters()))
        out, files = output_level(d, level)
        assert len(files) == n_pages, ('pages written', len(files), n_pages)
        assert out and all(len(tes) == 1 for tes in out.values())
        outs[platform] = dict(dir=d, out=out, wall=wall, counts=read_counts(),
                              edges=edges, steps=steps)
    card, cpu = outs['cuda']['out'], outs['cpu']['out']
    assert card.keys() == cpu.keys()
    # a near-tie at K=64 among cumulative costs of thousands of bits (one
    # f32 ulp: 4.9e-4 bits) may part the choices or only the entry slot a
    # later page's path walks back to, which moves the confs of its first
    # glyphs
    ties = [k for k, ((u, c),) in card.items()
            if cpu[k][0][0] != u or abs(c - cpu[k][0][1]) > 1e-4]
    conf_err = max([abs(c - cpu[k][0][1]) for k, ((_, c),) in card.items()
                    if k not in ties] + [0.0])
    gap = None
    changed = sum(card[k][0][0] != cpu[k][0][0] for k in ties)
    if ties and may_part:
        assert changed <= 0.02 * len(card), (changed, len(card))
    elif ties:
        assert level == 'glyph', (level, ties[:5])
        from ocrd_keraslm_torch.wrapper.mets import Workspace
        cpu_rater = german_rater('cpu')
        costs = []
        for p in ('cuda', 'cpu'):
            d = outs[p]['dir']
            picks = {}
            for f in Workspace(d).mets.find_files(fileGrp='OCR-D-LM'):
                picks.update(output_indices(os.path.join(
                    d, f.local_filename)))
            costs.append(engine_choices_cost(cpu_rater, outs['cpu']['dir'],
                                             picks, beam_width))
        gap = abs(costs[0] - costs[1])
        assert gap <= HOST_TIE_BITS, (ties[:5], costs)
    outs.update(ties=ties, conf_err=conf_err, gap=gap, changed=changed,
                n=len(card))
    return outs


def path_cost(cpu_rater, graph, path, beam_width):
    """Bits of a decode result's ``path`` (one entry an edge, in chain
    order) through ``graph``: the graph restricted to the path's
    TextEquivs, decoded on the CPU."""
    edges = [data for _, _, data in sorted(graph.edges(data=True),
                                           key=lambda e: e[0])]
    assert len(edges) == len(path)
    restricted = chain_graph([dict(data, alternatives=[te])
                              for data, (_, te, _) in zip(edges, path)])
    return cpu_rater.rate_best_device(restricted, 0, 0,
                                      beam_width=beam_width)[1]


def same_or_tied(got, want, graphs, cpu_rater, beam_width, cost_ulps=2,
                 tol=1e-4, tie_bits=HOST_TIE_BITS):
    """:func:`same_results` document by document (within ``tol``); a
    document whose two results part (an f32 near-tie of two paths)
    passes where the two paths' costs, decoded on the CPU, lie within
    ``tie_bits``.  Returns (largest difference of the equal documents,
    [cost gap of each tied document])."""
    diff, gaps = 0.0, []
    for g, w, graph in zip(got, want, graphs):
        try:
            diff = max(diff, same_results([g], [w], tol=tol,
                                          cost_ulps=cost_ulps))
        except AssertionError:
            gap = abs(path_cost(cpu_rater, graph, g[0], beam_width)
                      - path_cost(cpu_rater, graph, w[0], beam_width))
            assert gap <= tie_bits, ('paths part beyond a near-tie', gap)
            gaps.append(gap)
    return diff, gaps


def device_launches(fn):
    """(host wall s, CUDA kernel launches, device ms of them) of one
    ``fn()`` call under ``torch.profiler`` (copies and fills not
    counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(('Memcpy', 'Memset'))]
    return (wall, len(kernels),
            sum(e.time_range.elapsed_us() for e in kernels) / 1e3)


def engine_glyph_pages(rater, work, card):
    """Part (a): ``-P beam_width 40`` over pages 1-2 of phase 4's seeded
    workspace, card against CPU: every page written, no kernel launched,
    the engine's edges and char steps counted; the same pages at beam 32
    through ``decode_lattice``, for scale; then the engine alone on page
    1 (``Rater.rate_best_device``): seconds per edge and per char step,
    CUDA launches per edge."""
    import torch

    def build(d):
        return build_workspace(d, np.random.default_rng(7), 2, 40,
                               rater.vocab)
    from ocrd_keraslm_torch.wrapper import rate as rate_mod
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    base = os.path.join(work, 'engine_glyph')
    d = base + '_parity'
    build(d)
    context = rate_mod.mets_get_context(Workspace(d).mets)
    t0 = time.time()
    p_err, p_edges, p_ties = engine_parity(
        {'cuda': rater, 'cpu': german_rater('cpu')}, workspace_graphs(d),
        context, ENGINE_BEAM)
    print('unbounded engines (a), the decode engine card against CPU over '
          'the 2 pages (the processor\'s context %s, beam %d, K=64, each page '
          'from the card\'s carry): %d edges compared, max abs error %.3g '
          '(costs rtol 1e-5 / atol 1e-4, states atol 1e-5), near-ties at the '
          'K-th rank at edges %s, both resumed from the card\'s beam after '
          'each; %.1f s'
          % (context, ENGINE_BEAM, p_edges, p_err, p_ties, time.time() - t0))
    res = engine_cli_card_vs_cpu(rater, base, build, 'glyph', ENGINE_BEAM, 2,
                                 may_part=bool(p_ties))
    run = res['cuda']
    assert run['counts'] == NO_LAUNCHES, run['counts']
    assert run['edges'] > 0 and run['steps'] >= run['edges'], run
    d32 = base + '_beam32'
    build(d32)
    # the blocks a document each decode_lattice launch takes
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    taken, chooser = [], dk.cluster_blocks
    dk.cluster_blocks = lambda *a, **k: taken.append(chooser(*a, **k)) or \
        taken[-1]
    zero_counts()
    t0 = time.time()
    try:
        run_cli(d32, 'cuda', beam_width=32)
        torch.cuda.synchronize()
    finally:
        dk.cluster_blocks = chooser
    wall32 = time.time() - t0
    launches32 = read_counts()['decode_lattice']
    assert launches32 > 0 and len(taken) == launches32, (launches32, taken)
    graph = workspace_graphs(run['dir'])[0]
    rater.rate_best_device(graph, 0, 0, beam_width=ENGINE_BEAM)  # warm
    e0 = engine_counters()
    t0 = time.time()
    rater.rate_best_device(graph, 0, 0, beam_width=ENGINE_BEAM)
    torch.cuda.synchronize()
    alone = time.time() - t0
    edges, steps = (b - a for a, b in zip(e0, engine_counters()))
    # traced over the page's first 400 lattice edges (the trace of the
    # whole page holds ~10^5 launches)
    head = chain_graph([data for _, _, data in sorted(
        graph.edges(data=True), key=lambda e: e[0])[:400]])
    e0 = engine_counters()
    traced, launches, dev_ms = device_launches(
        lambda: rater.rate_best_device(head, 0, 0, beam_width=ENGINE_BEAM))
    t_edges, t_steps = (b - a for a, b in zip(e0, engine_counters()))
    print('unbounded engines (a), -P beam_width %d (K=64) over 2 glyph pages '
          '(%d glyphs) through the CLI: every page written, no kernel '
          'launched (%s), %d engine edges and %d char steps on the card; '
          '%.3f s on the card = %.3f s/page (CLI call incl. model load, host '
          'clock), %.3f s on the CPU; choices and confs %s, max conf diff '
          '%.3g elsewhere (tolerance 1e-4)%s [%s]'
          % (ENGINE_BEAM, len(run['out']), json.dumps(run['counts']),
             run['edges'], run['steps'], run['wall'], run['wall'] / 2,
             res['cpu']['wall'], 'equal on the card and on the CPU'
             if not res['ties'] else 'equal but at %d of %d glyph(s)'
             % (len(res['ties']), res['n']), res['conf_err'],
             '' if not res['ties'] else
             '; those glyphs %s... (%d with another choice): %s'
             % (res['ties'][:3], res['changed'],
                'the two beam searches part after the near-ties above'
                if res['gap'] is None else 'a near-tie, the two documents\' '
                'path costs %.3g bits apart (tolerance %g)'
                % (res['gap'], HOST_TIE_BITS)), card))
    print('unbounded engines (a) for scale: the same 2 pages at -P '
          'beam_width 32 (K=32) through decode_lattice, %d launch(es) on '
          '%s block(s) a document: %.3f s = %.3f s/page (CLI call incl. '
          'model load) [%s]'
          % (launches32, taken, wall32, wall32 / 2, card))
    print('unbounded engines (a), the engine alone on page 1 '
          '(Rater.rate_best_device, beam %d, K=64; %d edges, %d char '
          'steps): %.3f s (host clock, synchronised) = %.3f ms/edge, %.3f '
          'ms/char step; traced (torch.profiler) over its first %d edges '
          '(%d char steps): wall %.3f s, %d CUDA kernel launches = %.1f a '
          'char step, %.1f an edge, %.1f ms of device time (device idle '
          '%.1f%% of the wall) [%s]'
          % (ENGINE_BEAM, edges, steps, alone, 1e3 * alone / edges,
             1e3 * alone / steps, t_edges, t_steps, traced, launches,
             launches / t_steps, launches / t_edges, dev_ms,
             100 * (1 - dev_ms / 1e3 / traced), card))
    return dict(wall=run['wall'], wall_cpu=res['cpu']['wall'],
                edges=run['edges'], steps=run['steps'], wall32=wall32,
                launches32=launches32, blocks32=taken,
                alone=alone, alone_edges=edges, alone_steps=steps,
                launches_per_edge=launches / t_edges)


def engine_line_pages(rater, work, card):
    """Part (b): ``-P textequiv_level line`` over a seeded 3-page
    workspace whose page 2 has lines over 64 chars, card against CPU:
    pages 1 and 3 launch ``decode_lattice`` (2 launches), page 2 goes
    through the engine, so the carry converts both ways; every page is
    written with ``OCRD_MISSING_OUTPUT`` unset."""
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.page import parse_page

    def build(d):
        return build_workspace(d, np.random.default_rng(17), 3, 12,
                               rater.vocab, line_words=((2, 5), (8, 13),
                                                        (2, 5)))
    base = os.path.join(work, 'engine_line')
    res = engine_cli_card_vs_cpu(rater, base, build, 'line', 10, 3)
    run = res['cuda']
    ws = Workspace(run['dir'])
    longest = [max(len(line.get_TextEquiv()[0].Unicode)
                   for region in parse_page(os.path.join(
                       run['dir'], f.local_filename)).get_Page()
                   .get_TextRegion() for line in region.get_TextLine())
               for f in ws.mets.find_files(fileGrp='OCR-D-OCR')]
    assert longest[1] > 64 >= max(longest[0], longest[2]), longest
    assert run['counts']['decode_lattice'] == 2, run['counts']
    assert run['edges'] > 0, run
    print('unbounded engines (b), -P textequiv_level line over 3 pages '
          '(longest line per page: %s chars; %d lines), OCRD_MISSING_OUTPUT '
          'unset: 3 of 3 pages written; decode_lattice launched %d times '
          '(pages 1 and 3), the engine %d edges and %d char steps (page 2); '
          '%.3f s on the card = %.3f s/page (CLI call incl. model load, host '
          'clock), %.3f s on the CPU; line texts equal, max conf diff %.3g '
          '(tolerance 1e-4) [%s]'
          % (longest, len(run['out']), run['counts']['decode_lattice'],
             run['edges'], run['steps'], run['wall'], run['wall'] / 3,
             res['cpu']['wall'], res['conf_err'], card))
    return dict(wall=run['wall'], wall_cpu=res['cpu']['wall'])


def engine_batch(rater, work, card):
    """Part (c): ``rate_best_batch`` of 4 one-page documents at beam 40:
    one engine call for the batch (pending ``'xlab'``), no kernel
    launched, each document equal to its own ``rate_best_device``."""
    import torch
    d = os.path.join(work, 'engine_batch')
    build_workspace(d, np.random.default_rng(27), 4, 10, rater.vocab)
    docs = workspace_graphs(d)
    calls = []
    launch = rater._launch_engine

    def counted(arrays, *args, **kwargs):
        calls.append(arrays[0].shape)
        return launch(arrays, *args, **kwargs)
    rater._launch_engine = counted
    try:
        zero_counts()
        t0 = time.time()
        got = rater.rate_best_batch(docs, beam_width=ENGINE_BEAM)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        n_calls = len(calls)
        t0 = time.time()
        single = [rater.rate_best_device(g, 0, 0,
                                         beam_width=ENGINE_BEAM)[:2]
                  for g in docs]
        wall_seq = time.time() - t0
    finally:
        del rater._launch_engine
    assert counts == NO_LAUNCHES, counts
    assert n_calls == 1 and calls[0][0] == len(docs), calls
    diff, gaps = same_or_tied(got, single, docs, german_rater('cpu'),
                              ENGINE_BEAM)
    print('unbounded engines (c), Rater.rate_best_batch of %d one-page '
          'documents (%s edges) at beam %d: one engine call over (%s) '
          'arrays, no kernel launched; %.3f s (host clock, ended by the '
          'fetch), %d sequential rate_best_device calls %.3f s; each '
          'document equal to its own decode (max score/entropy diff %.3g)%s '
          '[%s]' % (len(docs), [len(p) for p, _ in got], ENGINE_BEAM,
                    ', '.join(map(str, calls[0])), wall, len(docs),
                    wall_seq, diff, '' if not gaps else ' but %d at a '
                    'near-tie (path costs %s bits apart, tolerance %g)'
                    % (len(gaps), ['%.3g' % g for g in gaps],
                       HOST_TIE_BITS), card))
    return dict(wall=wall, wall_seq=wall_seq)


def wide_params(rng, V, W, D, contexts):
    """Seeded float32 weights of a D-layer, width-W model (numpy, the
    layout the h5 reader gives): embeddings N(0, 0.5), so that the
    softmax is not flat; kernels N(0, 1/fan-in); forget bias 1."""
    def normal(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    ctx = sum(dim for _, dim in contexts)
    lstm = []
    for d in range(D):
        n_in = W + (ctx if d == 0 else 0)
        bias = np.zeros((4 * W,), np.float32)
        bias[W:2 * W] = 1.0
        lstm.append(dict(kernel=normal((n_in, 4 * W), n_in ** -0.5),
                         recurrent=normal((W, 4 * W), W ** -0.5), bias=bias))
    return {'char_embedding': normal((V, W), 0.5),
            'context_embeddings': [normal((n, dim), 0.001)
                                   for n, dim in contexts],
            'lstm': lstm}


def wide_rater(device):
    """A D=2, W=512 ``Rater`` with the german model's vocabulary and
    seeded weights carried in by ``params_from_numpy``."""
    from ocrd_keraslm_torch.models.lstm_lm import params_from_numpy
    from ocrd_keraslm_torch.rater import Rater
    vocab = german_rater('cpu').vocab
    rater = Rater(device=device)
    rater.width, rater.depth, rater.length = WIDE_W, 2, WIDE_T
    rater.vocab, rater.voc_size = vocab, vocab.size
    rater.params = params_from_numpy(wide_params(
        np.random.default_rng(512), vocab.size, WIDE_W, 2, rater.contexts),
        device)
    rater.configure()
    rater.status = 2
    return rater


def wide_lattice(rng, vocab, n_edges):
    """A seeded chain of ``n_edges`` glyph edges, a third of them with
    2-3 alternatives."""
    from ocrd_keraslm_torch.wrapper.page import TextEquivType
    letters = sorted(c for c in _charset(vocab) if c.isalpha())
    edges = []
    for e in range(n_edges):
        n = int(rng.integers(2, 4)) if rng.random() < 0.33 else 1
        edges.append(dict(element='g%d' % e, alternatives=[
            TextEquivType(Unicode=letters[int(rng.integers(len(letters)))],
                          conf=float(round(rng.uniform(0.7, 0.95), 4)),
                          index=i) for i in range(n)]))
    return chain_graph(edges)


def wide_bwd_inputs(dev):
    """``lstm_bwd``'s arguments at W=512 (B=128, T=64, f32 U), seeded."""
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    rng = np.random.default_rng([20261103, TRAIN_B, WIDE_T, WIDE_W])
    fwd, cot = lstm_train_inputs(rng, dev, False, B=TRAIN_B, T=WIDE_T,
                                 W=WIDE_W)
    return fwd, lstm_bwd_args(fwd, cot, lc.lstm_scan(*fwd,
                                                     want_c_all=True)[:2])


def wide_model_path(dev, train, card):
    """Part (d), a D=2, W=512 model that no layout of the decode and
    generation kernels takes: ``rate_best_device`` of a 256-edge lattice
    and a 2-document batch with no kernel launched, card against CPU;
    ``generate -n 256`` with no ``gen_beam`` launch, ``-n 32`` card
    against CPU; three ``train_step``s at B=128, T=64 with ``lstm_scan``
    and ``lstm_bwd`` in their grid layouts, card against CPU; both
    kernels there against their plain versions, their digests through
    the one-block layout and then the chosen one (``WIDE_SCAN_DIGEST``,
    ``WIDE_BWD_DIGEST``), and the one-block layout at 8, 4 and 2 streams
    a block bit-equal at W=256.  Returns the training steps' launch
    counts, both kernels' errors and the generation walls."""
    import itertools

    import torch
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    raters = {p: wide_rater(p) for p in ('cuda', 'cpu')}
    rng = np.random.default_rng(33)
    vocab = raters['cpu'].vocab
    graphs = [wide_lattice(rng, vocab, n) for n in (256, 97)]
    out = {}
    for p, r in raters.items():
        zero_counts()
        t0 = time.time()
        single = r.rate_best_device(graphs[0], 0, 0)[:2]
        batch = r.rate_best_batch(graphs)
        wall = time.time() - t0
        out[p] = (single, batch, wall, read_counts())
    assert out['cuda'][3] == NO_LAUNCHES, out['cuda'][3]
    d1, g1 = same_or_tied([out['cuda'][0]], [out['cpu'][0]], graphs[:1],
                          raters['cpu'], 10)
    d2, g2 = same_or_tied(out['cuda'][1], out['cpu'][1], graphs,
                          raters['cpu'], 10)
    print('unbounded engines (d), D=2 W=%d V=%d (seeded weights through '
          'params_from_numpy): rate_best_device of a 256-edge lattice and '
          'rate_best_batch of 2 documents (256 and 97 edges) at beam 10 '
          '(K=16: no decode layout fits a block), no kernel launched; card '
          'equal to CPU (max score/entropy diff %.3g)%s; %.3f s on the card '
          '(host clock), %.3f s on the CPU [%s]'
          % (WIDE_W, vocab.size, max(d1, d2), '' if not g1 + g2 else
             ' but %d document(s) at a near-tie (path costs %s bits apart)'
             % (len(g1 + g2), ['%.3g' % g for g in g1 + g2]),
             out['cuda'][2], out['cpu'][2], card))
    wr = raters['cuda']
    zero_counts()
    walls = []
    for _ in range(2):
        t0 = time.time()
        text = wr.generate(GEN_PROMPT, 256)
        walls.append(time.time() - t0)
    counts = read_counts()
    assert counts['gen_beam'] == counts['gen_traceback'] == 0, counts
    assert text and len(text[0]) == 257, text
    want = raters['cpu'].generate(GEN_PROMPT, 32, variants=2)
    got = wr.generate(GEN_PROMPT, 32, variants=2)
    assert got == want, (got, want)
    print('unbounded engines (d), generate -n 256 at W=%d through the '
          'engine (gen_layouts empty; no gen_beam or gen_traceback launch): '
          '%s s per request (host clock, ended by the fetch) = %s generated '
          'chars/s; -n 32 -v 2 card equal to CPU: %s [%s]'
          % (WIDE_W, ', '.join('%.3f' % w for w in walls),
             ', '.join('%.0f' % (256 / w) for w in walls), json.dumps(got),
             card))
    lay = lc.bwd_layout_on(dev, TRAIN_B, WIDE_W)
    scan_lay = lc.scan_layout_on(dev, TRAIN_B, WIDE_W, False)
    assert lay.grid and scan_lay.grid, (lay, scan_lay)
    batches = list(itertools.islice(stream_batches(
        train['plan'].training_files, train['vocab'], length=WIDE_T), 3))
    zero_counts()
    got, carry_g, _ = run_steps(dev, train['vocab'], batches, width=WIDE_W,
                                length=WIDE_T)
    torch.cuda.synchronize()
    counts = read_counts()
    assert counts['lstm_scan'] == counts['lstm_bwd'] == 3 * TRAIN_D, counts
    want, carry_c, _ = run_steps('cpu', train['vocab'], batches,
                                 width=WIDE_W, length=WIDE_T)
    loss_err = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    carry_err = max(float((g.cpu() - c).abs().max())
                    for g, c in zip(carry_g, carry_c))
    assert loss_err <= 1e-5 and carry_err <= 1e-5, (got, want, carry_err)
    print('unbounded engines (d), 3 train_steps at -w %d -d %d -l %d -b %d: '
          'lstm_bwd %d launches, its chain in %s (%d bytes of shared memory '
          'a block), lstm_scan %d in %s (%d bytes); losses %s on the card, '
          '%s on the CPU, max relative diff %.3g; final carry max abs diff '
          '%.3g (tolerances: losses rtol 1e-5, carry atol 1e-5) [%s]'
          % (WIDE_W, TRAIN_D, WIDE_T, TRAIN_B, counts['lstm_bwd'],
             describe_scan_layout(lay), lay.smem, counts['lstm_scan'],
             describe_scan_layout(scan_lay), scan_lay.smem,
             ['%.6f' % v for v in got], ['%.6f' % v for v in want],
             loss_err, carry_err, card))
    fwd, bwd = wide_bwd_inputs(dev)
    # the digests through the one-block layout first, then the chosen one
    digests = {}
    for what, ctx in (('one-block', scan_layout(reg=False)),
                      ('chosen', contextlib.nullcontext())):
        with ctx:
            saved = lc.lstm_scan(*fwd, want_c_all=True)
            got = lc.lstm_bwd(*bwd)
            digests[what] = (_digest(saved), _digest(got))
    scan_err = compare_lstm(saved, lc.lstm_scan_ref(*fwd, want_c_all=True))
    err = compare_bwd(got, lc.lstm_bwd_ref(*bwd))
    print('lstm_scan at W=%d (B=%d, T=%d, f32 U, c_all on) in %s against '
          'its plain version: max abs error %.3g over h, relative %.3g over '
          'c; output digest %s, the one-block layout\'s %s, pinned %s'
          % (WIDE_W, TRAIN_B, WIDE_T, describe_scan_layout(scan_lay),
             scan_err[0], scan_err[1], digests['chosen'][0],
             digests['one-block'][0], WIDE_SCAN_DIGEST))
    print('lstm_bwd at W=%d (B=%d, T=%d, f32 U) in %s against its plain '
          'version: max abs error %.3g, dU %.3g of its max; output digest '
          '%s, the one-block layout\'s %s, pinned %s'
          % (WIDE_W, TRAIN_B, WIDE_T, describe_scan_layout(lay), err[0],
             err[1], digests['chosen'][1], digests['one-block'][1],
             WIDE_BWD_DIGEST))
    assert digests['one-block'] == digests['chosen'] == (
        WIDE_SCAN_DIGEST, WIDE_BWD_DIGEST), ('W=512 outputs changed',
                                             digests)
    rng = np.random.default_rng(20261104)
    fwd256, cot256 = lstm_train_inputs(rng, dev, False, B=TRAIN_B, T=32,
                                       W=256)
    digests = {}
    for rb in (8, 4, 2):
        with scan_layout(rb, reg=False):
            saved = lc.lstm_scan(*fwd256, want_c_all=True)
            digests[rb] = (_digest(saved), _digest(lc.lstm_bwd(
                *lstm_bwd_args(fwd256, cot256, saved[:2]))))
    assert len(set(digests.values())) == 1, digests
    print('one-block layout at W=256 (B=%d, T=32) with 8, 4 and 2 streams a '
          'block: lstm_scan and lstm_bwd outputs bit-equal (sha256 %s, %s)'
          % (TRAIN_B, digests[8][0][:16], digests[8][1][:16]))
    return dict(launches=counts, err=err[0], scan_err=scan_err[0],
                gen_walls=walls)


def wide_texts(seed=4):
    """Four seeded German texts of 400 words each: the scoring chunk of
    row 3w where no workspace's pages are at hand."""
    rng = np.random.default_rng(seed)
    return [' '.join(rng.choice(GERMAN_WORDS, 400)) for _ in range(4)]


def wide_numbers(dev, card, texts):
    """Rows 3w, 4w and 5w of PERF.md at W=512: ``score_scan`` with the
    seeded D=2, W=512 model on the first chunk of ``texts`` (timing only:
    the rater scores W > 384 through the layered path), ``lstm_scan``
    (c_all on) and ``lstm_bwd`` at part (d)'s training shape (B=128,
    T=64, f32 U), each beside its plain version, its bound and cuDNN;
    the two training kernels in the layout the chooser takes and in the
    one-block layout, side by side.  Returns {row name: numbers}."""
    import torch
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import score_kernel as sk
    wr = wide_rater(dev)
    args, inp = score_main_inputs(wr, texts, [179])
    B, T, _ = args[0].shape
    ms = cuda_ms(lambda: sk.score_scan(*args), 2)
    plain_ms = cuda_ms(lambda: sk.score_scan_ref(*args), 1)
    library_ms = cuda_ms(cudnn_lstm(wr, 2, inp), 3)
    bound_ms, bound_by, flops = score_bound(args)
    lay = sk.scan_layout_on(dev, B, WIDE_W, 2, args[-2].shape[1])
    print('score_scan_w512 (row 3w: the seeded D=2, W=%d model, the scoring '
          'chunk B=%d, T=%d; timing only, the rater scores W > 384 through '
          'the layered path): %.3f ms/launch (CUDA events, mean of 2) in %s, '
          '%.2f us/step; plain version %.3f ms; bound %.4f ms by %s (%.3g '
          'FLOP), kernel at %.3f%% of it; cuDNN torch.nn.LSTM, 2 layers, '
          'f32, without the softmax: %.3f ms [%s]'
          % (WIDE_W, B, T, ms, describe_scan_layout(lay), 1e3 * ms / T,
             plain_ms, bound_ms, bound_by, flops, 100 * bound_ms / ms,
             library_ms, card))
    out = {'score_scan_w512': dict(ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=library_ms)}
    fwd, bwd = wide_bwd_inputs(dev)
    rng = np.random.default_rng(20261106)
    inp = torch.from_numpy(rng.normal(0, 1, (TRAIN_B, WIDE_T, WIDE_W)).astype(
        np.float32)).to(dev)
    cudnn_fwd, cudnn_fwd_bwd = cudnn_layer(inp, WIDE_W)
    for name, kernel, plain, library, bnd, lay, what in (
            ('lstm_scan_w512', lambda: lc.lstm_scan(*fwd, want_c_all=True),
             lambda: lc.lstm_scan_ref(*fwd, want_c_all=True), cudnn_fwd,
             lstm_train_bound(fwd, False),
             lc.scan_layout_on(dev, TRAIN_B, WIDE_W, False), 'forward'),
            ('lstm_bwd_w512', lambda: lc.lstm_bwd(*bwd),
             lambda: lc.lstm_bwd_ref(*bwd), cudnn_fwd_bwd,
             lstm_bwd_bound(bwd, False), lc.bwd_layout_on(dev, TRAIN_B,
                                                          WIDE_W),
             'forward+backward')):
        ms = cuda_ms(kernel, 5)
        with scan_layout(reg=False):
            one_ms = cuda_ms(kernel, 3)
        plain_ms = cuda_ms(plain, 1)
        library_ms = cuda_ms(library, 5)
        ms2 = cuda_ms(kernel, 5)
        with scan_layout(reg=False):
            one_ms2 = cuda_ms(kernel, 3)
        bound_ms, bound_by, flops = bnd
        print('%s (row %s) at W=%d (B=%d, T=%d, f32 U%s): %.3f then '
              '%.3f ms/launch in %s; the one-block layout %.3f then %.3f '
              'ms/launch (CUDA events, means of 5 and 3, alternating), %.2fx; '
              'plain version %.3f ms; bound %.4f ms by %s (%.3g FLOP), kernel '
              'at %.2f%% of it; cuDNN torch.nn.LSTM %s, 1 layer, f32: %.3f ms '
              '(%.2fx the kernel) [%s]'
              % (name, '4w' if 'scan' in name else '5w', WIDE_W, TRAIN_B,
                 WIDE_T, ', c_all on' if 'scan' in name else '', ms, ms2,
                 describe_scan_layout(lay), one_ms, one_ms2,
                 one_ms2 / ms2, plain_ms, bound_ms, bound_by, flops,
                 100 * bound_ms / ms2, what, library_ms, library_ms / ms2,
                 card))
        out[name] = dict(ms=ms2, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
    return out


# AWD-LSTM's enwik8 layers 1 and 2 at the cell's window (B=128, T=200)
AWD_W, AWD_T = 1840, 200
# the plain versions sum each column of 1840 terms in cuBLAS's order,
# the kernels in 32-term blocks (tests/test_torch_wide_layout.py); dU
# is held to a share of its largest entry
AWD_RTOL, AWD_ATOL, AWD_DU_OF_MAX = 1e-4, 2e-5, 1e-4


def wide1840_phase(dev, card):
    """Phase 3 at AWD-LSTM's enwik8 width: ``lstm_scan`` (c_all on) and
    ``lstm_bwd`` from its saved states at W=1840, B=128, T=200 (f32 U),
    which the chooser gives the wide layout; each bit for bit equal to
    the one-block layout and held to its plain version (``AWD_RTOL``,
    ``AWD_ATOL``; dU within ``AWD_DU_OF_MAX`` of its largest entry).
    The wide counters (``lstm_scan.wide``, ``lstm_bwd.wide``) are set to
    0 on entry and read at the end.  Times (CUDA events): the wide
    layout, the one-block layout, the plain versions and cuDNN's f32
    LSTM (TF32 off), beside the bound.  Returns the launches, the
    errors and {row name: numbers}."""
    import torch
    from gen_beam_phases import wide_inputs
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    B, T, W = TRAIN_B, AWD_T, AWD_W
    lay_f = lc.scan_layout_on(dev, B, W, False)
    lay_b = lc.bwd_layout_on(dev, B, W)
    assert lay_f.wide and lay_b.wide, (lay_f, lay_b)
    lc.lstm_scan.wide = lc.lstm_bwd.wide = 0
    fwd, cot = wide_inputs(dev, B, T, W)
    saved = lc.lstm_scan(*fwd, want_c_all=True)
    bwd = lstm_bwd_args(fwd, cot, saved[:2])
    grads = lc.lstm_bwd(*bwd)
    with scan_layout(reg=False):
        one_saved = lc.lstm_scan(*fwd, want_c_all=True)
        one_grads = lc.lstm_bwd(*bwd)
    same = [torch.equal(x, y) for x, y in zip(
        list(saved) + list(grads), list(one_saved) + list(one_grads))]
    del one_saved, one_grads
    want = lc.lstm_scan_ref(*fwd, want_c_all=True)
    scan_err = 0.0
    for x, y in zip(saved, want):
        torch.testing.assert_close(x, y, rtol=AWD_RTOL, atol=AWD_ATOL)
        scan_err = max(scan_err, float((x - y).abs().max()))
    # the plain backward from the kernel's saved states, so that the
    # two differ by the backward alone
    want = lc.lstm_bwd_ref(*bwd)
    err = 0.0
    for i in (0, 2, 3):
        torch.testing.assert_close(grads[i], want[i], rtol=AWD_RTOL,
                                   atol=AWD_ATOL)
        err = max(err, float((grads[i] - want[i]).abs().max()))
    du_err = float((grads[1] - want[1]).abs().max()) / float(
        want[1].abs().max())
    del want
    print('lstm_scan and lstm_bwd at W=%d (B=%d, T=%d, f32 U; AWD-LSTM\'s '
          'enwik8 layers 1-2) in %s (forward) and %s (backward\'s chain): '
          'every output equal bit for bit to the one-block layout\'s: %s; '
          'against the plain versions: forward max abs error %.3g, '
          'backward %.3g, dU %.3g of its max (limits rtol %g, atol %g, dU '
          '%g of its max)'
          % (W, B, T, describe_scan_layout(lay_f),
             describe_scan_layout(lay_b), same, scan_err, err, du_err,
             AWD_RTOL, AWD_ATOL, AWD_DU_OF_MAX))
    assert all(same), ('the wide layout differs from the one-block layout',
                       same)
    assert du_err <= AWD_DU_OF_MAX, ('dU', du_err)
    inp = torch.randn((B, T, W), generator=torch.Generator(
        device=dev).manual_seed(20261107), device=dev)
    cudnn_fwd, cudnn_fwd_bwd = cudnn_layer(inp, W)
    out = {}
    for name, kernel, plain, library, bnd in (
            ('lstm_scan_w1840', lambda: lc.lstm_scan(*fwd, want_c_all=True),
             lambda: lc.lstm_scan_ref(*fwd, want_c_all=True), cudnn_fwd,
             lstm_train_bound(fwd, False)),
            ('lstm_bwd_w1840', lambda: lc.lstm_bwd(*bwd),
             lambda: lc.lstm_bwd_ref(*bwd), cudnn_fwd_bwd,
             lstm_bwd_bound(bwd, False))):
        ms = cuda_ms(kernel, 3)
        with scan_layout(reg=False):
            one_ms = cuda_ms(kernel, 1)
        plain_ms = cuda_ms(plain, 1)
        library_ms = cuda_ms(library, 3)
        bound_ms, bound_by, flops = bnd
        print('%s (row %s) at W=%d (B=%d, T=%d, f32 U): %.3f ms/launch '
              '(CUDA events, mean of 3) in the wide layout, %.2f%% of the '
              'bound %.2f ms by %s (%.3g FLOP); the one-block layout %.3f '
              'ms (%.1fx); plain version %.3f ms; cuDNN torch.nn.LSTM %s, '
              '1 layer, f32: %.3f ms [%s]'
              % (name, '4x' if 'scan' in name else '5x', W, B, T, ms,
                 100 * bound_ms / ms, bound_ms, bound_by, flops, one_ms,
                 one_ms / ms, plain_ms, 'forward' if 'scan' in name else
                 'forward+backward', library_ms, card))
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms,
                         one_block_ms=one_ms)
    launches = {'lstm_scan': lc.lstm_scan.wide, 'lstm_bwd': lc.lstm_bwd.wide}
    print('wide layout launches in this phase (lstm_scan.wide, '
          'lstm_bwd.wide, set to 0 at its start): %s' % json.dumps(launches))
    # one each for the parity, then a warm-up and 3 timed launches each
    assert launches == {'lstm_scan': 5, 'lstm_bwd': 5}, launches
    return dict(launches=launches, scan_err=scan_err, err=err,
                numbers=out)


def describe_scan_layout(lay):
    """A layout of ``ops/scan_layout.py`` in words."""
    if getattr(lay, 'wide', False):
        return ('the wide layout (%d blocks, one an SM, %d streams, U '
                'streamed in 32-term chunks)' % (lay.cl, lay.rb))
    if getattr(lay, 'grid', False):
        return ('the grid layout (%d streams a group of %d blocks, %d '
                'streams a staged chunk)' % (lay.rb, lay.cl, lay.rt))
    if lay.reg:
        return ('the register layout (%d streams a cluster of %d blocks, %d '
                'a thread chain)' % (lay.rb, lay.cl, lay.rt))
    return 'the one-block layout (%d streams a block)' % lay.rb


def engine_path(rater, work, train, card):
    """Phase 6, the unbounded engines: parts (a)-(d) (see each);
    returns their numbers.  Matmuls stay f32 throughout."""
    import torch
    out = dict(glyph=engine_glyph_pages(rater, work, card),
               line=engine_line_pages(rater, work, card),
               batch=engine_batch(rater, work, card),
               wide=wide_model_path(torch.device('cuda'), train, card))
    assert torch.get_float32_matmul_precision() == 'highest'
    assert not torch.backends.cuda.matmul.allow_tf32
    return out


# ---------------------------------------------------------------------
# serving roles, resume snapshots, pruning, device trace
# ---------------------------------------------------------------------

SERVE_JOBS, WORKER_JOBS, SERVE_THREADS = 3, 2, 4
RESUME_EPOCHS = 3
PRUNED_CHAR = 'J'


def _post_job(base, payload):
    """``POST /process`` of ``payload``; returns (HTTP status, JSON
    answer)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        base + '/process', data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as err:
        return err.code, json.load(err)


def _wait_for_socket(path, proc, timeout=120.0):
    deadline = time.time() + timeout
    while not os.path.exists(path):
        assert proc.is_alive(), 'the METS server process died'
        assert time.time() < deadline, 'the METS server did not start'
        time.sleep(0.05)


def switch_jobs(params, fresh, groups, decode, n_jobs=2):
    """Decoding jobs on a processing server set up for scoring: the
    reuse gate builds a new processor and Rater for each, the first
    stages the decode weights, the next find them in the process-wide
    cache (emptied first).  Times each new Rater's first staging
    (synchronised) and whether it came from that cache."""
    import threading
    import torch
    from ocrd_keraslm_torch import rater as rater_mod
    from ocrd_keraslm_torch.wrapper import cli as wcli
    staged = []
    plain = rater_mod.Rater._decode_weights

    def timed(self, context, bf16=False):
        key = (tuple(context or self.underspecify_contexts()), bool(bf16))
        if key in self._decode_cache:
            return plain(self, context, bf16)
        held = {id(w) for w in rater_mod._DECODE_WCACHE.values()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        weights = plain(self, context, bf16)
        torch.cuda.synchronize()
        staged.append(((time.perf_counter() - t0) * 1e3,
                       id(weights) in held))
        return weights
    dirs = [fresh('switch_%d' % i) for i in range(n_jobs)]
    job_s = []
    with platform_env('cuda'):
        httpd = wcli.make_processing_server(
            '127.0.0.1:0', dict(params, alternative_decoding=False))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        rater_mod._DECODE_WCACHE.clear()
        rater_mod.Rater._decode_weights = timed
        try:
            base = 'http://127.0.0.1:%d' % httpd.server_address[1]
            zero_counts()
            for d in dirs:
                t0 = time.time()
                answer = _post_job(base, {
                    'mets': d, 'parameter': {'alternative_decoding': True}})
                job_s.append(time.time() - t0)
                assert answer == (200, {'state': 'SUCCESS'}), answer
            counts = read_counts()
        finally:
            rater_mod.Rater._decode_weights = plain
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
    assert counts == dict(NO_LAUNCHES, decode_lattice=n_jobs * groups), \
        counts
    want = page_contents(decode['workspace'])
    for d in dirs:
        assert page_contents(d) == want, ('switched job output', d)
    assert [hit for _, hit in staged] == [False] + [True] * (n_jobs - 1), \
        staged
    return dict(job_s=job_s, staged=staged, counts=counts)


def serving_path(rater, work, decode, scoring, card):
    """Part (a) of the serving roles: the HTTP processing server, the
    spool worker, a METS server in a spawned process and decodes in
    threads; returns the numbers."""
    import multiprocessing
    import threading
    import urllib.request

    import torch
    from ocrd_keraslm_torch.wrapper import cli as wcli
    from ocrd_keraslm_torch.wrapper import mets_server
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.rate import mets_get_context
    want = output_files(decode['workspace'])
    groups = len(decode['groups'])
    # run_cli's parameters, in its order (the written pages list them)
    params = {'model_file': MODEL, 'textequiv_level': 'glyph',
              'beam_width': 10}

    def fresh(name):
        d = os.path.join(work, name)
        build_workspace(d, np.random.default_rng(7), 4, 40, rater.vocab)
        return d
    # the processing server: model load once, SERVE_JOBS jobs
    with platform_env('cuda'):
        t0 = time.time()
        httpd = wcli.make_processing_server('127.0.0.1:0', params)
        setup_s = time.time() - t0
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            base = 'http://127.0.0.1:%d' % httpd.server_address[1]
            with urllib.request.urlopen(base + '/health') as resp:
                assert json.load(resp) == {'status': 'ok'}
            dirs = [fresh('serve_%d' % i) for i in range(SERVE_JOBS)]
            job_s = []
            zero_counts()
            for d in dirs:
                t0 = time.time()
                answer = _post_job(base, {'mets': d})
                job_s.append(time.time() - t0)
                assert answer == (200, {'state': 'SUCCESS'}), answer
            counts = read_counts()
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
    assert counts == dict(NO_LAUNCHES,
                          decode_lattice=SERVE_JOBS * groups), counts
    for d in dirs:
        assert output_files(d) == want, ('server job output', d)
    print('serving: processing server on 127.0.0.1:%d (model load %.3f s), '
          'GET /health ok, %d POST /process jobs on fresh copies of phase '
          '4\'s workspace: %s s a job (host clock, HTTP included); launches '
          '%s (expected decode_lattice %d: %d page groups a job); every '
          'page equal to phase 4\'s CLI output (timestamps blanked) [%s]'
          % (httpd.server_address[1], setup_s, SERVE_JOBS,
             ', '.join('%.3f' % w for w in job_s), counts,
             SERVE_JOBS * groups, groups, card))
    switch = switch_jobs(params, fresh, groups, decode)
    print('serving: a server set up for scoring, %d decoding jobs (a new '
          'processor and Rater each, the process-wide weight cache emptied '
          'first): %s s a job (host clock, model load included); each new '
          'Rater\'s first staging of the decode weights %s ms (synchronised; '
          'from the process-wide cache: %s); launches %s; every page\'s '
          'texts and confs equal to phase 4\'s [%s]'
          % (len(switch['job_s']), ', '.join('%.3f' % w
                                             for w in switch['job_s']),
             ', '.join('%.3f' % ms for ms, _ in switch['staged']),
             [hit for _, hit in switch['staged']], switch['counts'], card))
    # the spool worker, --once
    queue = os.path.join(work, 'spool')
    os.makedirs(queue)
    wdirs = [fresh('worker_%d' % i) for i in range(WORKER_JOBS)]
    for i, d in enumerate(wdirs):
        with open(os.path.join(queue, 'job%d.json' % i), 'w') as fh:
            json.dump({'mets': d}, fh)
    zero_counts()
    t0 = time.time()
    with platform_env('cuda'):
        wcli.ocrd_keraslm_rate.main(args=[
            'worker', '--queue', queue, '--once', '-l', 'WARNING',
            '-P', 'model_file', MODEL, '-P', 'textequiv_level', 'glyph',
            '-P', 'beam_width', '10'], standalone_mode=False)
    worker_s = time.time() - t0
    wcounts = read_counts()
    for i, d in enumerate(wdirs):
        with open(os.path.join(queue, 'job%d.result.json' % i)) as fh:
            result = json.load(fh)
        assert result == {'state': 'SUCCESS'}, result
        assert os.path.exists(os.path.join(queue, 'job%d.json.done' % i))
        assert output_files(d) == want, ('worker job output', d)
    assert wcounts == dict(NO_LAUNCHES,
                           decode_lattice=WORKER_JOBS * groups), wcounts
    print('serving: worker --once over %d spool jobs: %.3f s (model load '
          'included); both SUCCESS, renamed .done; launches %s; every page '
          'equal to phase 4\'s [%s]'
          % (WORKER_JOBS, worker_s, wcounts, card))
    # page-parallel scoring through a METS server in a spawned process
    served = fresh('served')
    url = os.path.join(work, 'mets.sock')
    proc = multiprocessing.get_context('spawn').Process(
        target=mets_server.serve, args=(served, url), daemon=True)
    t0 = time.time()
    proc.start()
    try:
        _wait_for_socket(url, proc)
        start_s = time.time() - t0
        zero_counts()
        t0 = time.time()
        with platform_env('cuda'), env_vars(OCRD_MAX_PARALLEL_PAGES='4'):
            wcli.ocrd_keraslm_rate.main(args=[
                '-U', url, '-I', 'OCR-D-OCR', '-O', 'OCR-D-LM', '-l',
                'WARNING', '-P', 'model_file', MODEL, '-P',
                'textequiv_level', 'glyph', '-P', 'beam_width', '10', '-P',
                'alternative_decoding', 'false'], standalone_mode=False)
        mets_s = time.time() - t0
        mcounts = read_counts()
        remote = mets_server.RemoteWorkspace(url)
        n_out = len(list(remote.mets.find_files(fileGrp='OCR-D-LM')))
        remote.stop_server()
        remote.close()
        proc.join(timeout=30)
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
    assert proc.exitcode == 0, ('METS server exit code', proc.exitcode)
    assert n_out == 4, n_out
    assert output_files(served) == output_files(scoring['workspace']), \
        'METS-server scoring output differs from the local run'
    assert mcounts == dict(NO_LAUNCHES, score_scan=scoring['launches']), \
        mcounts
    print('serving: METS server in a spawned process (socket up after %.2f '
          's), scoring with -U and OCRD_MAX_PARALLEL_PAGES=4: %.3f s (CLI '
          'call incl. model load), 4 pages registered through the server; '
          'launches %s; every page equal to phase 5\'s local run; the server '
          'stopped by its client, exit code 0 [%s]'
          % (start_s, mets_s, mcounts, card))
    # SERVE_THREADS threads decode a page each on their own raters (the
    # decode weights shared through the process-wide cache), against the
    # same decodes one after another
    from ocrd_keraslm_torch import rater as rater_mod
    graphs = workspace_graphs(decode['workspace'])[:SERVE_THREADS]
    ctx = mets_get_context(Workspace(decode['workspace']).mets)
    raters = [german_rater(rater.device) for _ in graphs]

    def decode_page(i):
        path, ent, _ = raters[i].rate_best_device(
            graphs[i], 0, 0, context=ctx, beam_width=10)
        return [(el.id if el is not None else None, te.index, score)
                for el, te, score in path], ent
    zero_counts()
    serial = [decode_page(i) for i in range(len(graphs))]
    n_serial = read_counts()['decode_lattice']
    results = {}
    errors = []

    def work_thread(k):
        try:
            results[k] = decode_page(k % len(graphs))
        except BaseException as err:  # noqa: BLE001 - asserted below
            errors.append(err)
    zero_counts()
    t0 = time.time()
    threads = [threading.Thread(target=work_thread, args=(k,))
               for k in range(2 * len(graphs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    threads_s = time.time() - t0
    tcounts = read_counts()
    assert not errors, errors
    for k, got in results.items():
        assert got == serial[k % len(graphs)], ('thread result', k)
    assert tcounts == dict(NO_LAUNCHES, decode_lattice=2 * n_serial), \
        (tcounts, n_serial)
    shared = len({id(r._decode_weights(ctx)['wcat']) for r in raters})
    print('serving: %d threads at once on %d raters, two a page of phase '
          '4\'s 4: %.3f s (host clock), every path and cost equal bit for '
          'bit to the serial decodes; launches %s (serial: %d); decode '
          'weights shared: %d set(s) for %d raters, process cache %d of %d '
          'entries [%s]' % (len(threads), len(raters), threads_s, tcounts,
                            n_serial,
                    shared, len(raters), len(rater_mod._DECODE_WCACHE),
                    rater_mod.DECODE_WCACHE_SIZE, card))
    assert shared == 1
    return dict(setup_s=setup_s, job_s=job_s, worker_s=worker_s,
                mets_s=mets_s, threads_s=threads_s,
                launches=counts['decode_lattice'],
                worker_launches=wcounts['decode_lattice'],
                thread_launches=tcounts['decode_lattice'])


def resume_path(work, card):
    """Part (b): ``keraslm-rate train`` at the main path's width three
    epochs uninterrupted, killed during epoch 2 with ``--resume-dir``,
    then resumed from its snapshot; returns the numbers."""
    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.utils import h5io, orbaxio
    rng = np.random.default_rng(12)
    per_file = TRAIN_B * (2 * TRAIN_T + 1)
    files = write_corpus(os.path.join(work, 'resume_corpus'), rng, {
        'kant_kritik_1781.txt': per_file, 'goethe_faust_1808.txt': per_file,
        'lessing_nathan_1779.txt': per_file})
    seed = 37
    models = {k: os.path.join(work, 'resume_%s.h5' % k) for k in 'abc'}
    snap = os.path.join(work, 'resume_snap')
    wall_a, counts_a, _ = run_train_cli(work, models['a'], files,
                                        RESUME_EPOCHS, seed)
    hist_a = h5io.load_config(models['a'])[2]

    class Killed(BaseException):
        pass
    real = training.Prefetcher

    class Dying:
        made = 0

        def __init__(self, gen):
            type(self).made += 1
            self.inner = real(gen)

        def __iter__(self):
            for n, batch in enumerate(iter(self.inner)):
                # the third prefetcher is epoch 2's training pass
                if type(self).made == 3 and n == 1:
                    self.inner.close()
                    raise Killed()
                yield batch
    training.Prefetcher = Dying
    try:
        run_train_cli(work, models['b'], files, RESUME_EPOCHS, seed,
                      extra=('--resume-dir', snap))
        raise AssertionError('the run to be killed was not killed')
    except Killed:
        pass
    finally:
        training.Prefetcher = real
    kept = orbaxio.load_train_state(snap)
    assert kept['meta']['epoch_done'] == 1, kept['meta']['epoch_done']
    assert sorted(os.listdir(snap)) == ['ep_0001'], os.listdir(snap)
    made = []
    real_ckpt = orbaxio.TrainCheckpointer

    class Recording(real_ckpt):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    orbaxio.TrainCheckpointer = Recording
    try:
        wall_c, counts_c, _ = run_train_cli(work, models['c'], files,
                                            RESUME_EPOCHS, seed,
                                            extra=('--resume-dir', snap))
    finally:
        orbaxio.TrainCheckpointer = real_ckpt
    hist_c = h5io.load_config(models['c'])[2]
    for key in hist_a:
        np.testing.assert_allclose(hist_c[key], hist_a[key], rtol=1e-5,
                                   err_msg=key)
    diff = max(float(np.max(np.abs(np.subtract(hist_c[k], hist_a[k]))))
               for k in hist_a)
    steps1 = int(kept['meta']['steps_done'])
    assert counts_c == dict(
        NO_LAUNCHES, lstm_bwd=counts_a['lstm_bwd'] - steps1 * TRAIN_D,
        lstm_scan=counts_c['lstm_scan']), (counts_c, counts_a, steps1)
    assert counts_c['lstm_scan'] > counts_c['lstm_bwd'] > 0
    last = made[-1].last
    assert orbaxio.load_train_state(snap)['meta']['epoch_done'] == \
        RESUME_EPOCHS
    print('resume: keraslm-rate train -w %d -d %d -l %d -b %d -e %d on 3 '
          'files of %d chars: uninterrupted %.3f s; killed in epoch 2 with '
          '--resume-dir (snapshot of epoch 1 kept: %d steps); resumed %.3f '
          's; every history key within rtol 1e-5 of the uninterrupted run '
          '(max |diff| %.3g; loss %s); the resumed run\'s launches %s '
          '(lstm_bwd = uninterrupted %d - epoch 1\'s %d) [%s]'
          % (TRAIN_W, TRAIN_D, TRAIN_T, TRAIN_B, RESUME_EPOCHS, per_file,
             wall_a, steps1, wall_c, diff,
             ['%.6f' % v for v in hist_c['loss']], counts_c,
             counts_a['lstm_bwd'], steps1 * TRAIN_D, card))
    print('resume: a snapshot is %d bytes (params, best params and Adam\'s '
          'state as CPU tensors, meta.json); its synchronous copy to the '
          'host %.4f s, its write and commit in the background %.4f s '
          '(host clock, the last epoch\'s) [%s]'
          % (last['bytes'], last['copy_s'], last['commit_s'], card))
    return dict(wall_a=wall_a, wall_c=wall_c, launches=counts_c,
                snapshot_bytes=last['bytes'], copy_s=last['copy_s'],
                commit_s=last['commit_s'])


def prune_path(rater, work, decode, card):
    """Part (c): ``prune-charset`` of one char, then page 1 decoded and
    scored at V=69 through the kernels, each held against its plain
    version, the decode against the CPU; returns the numbers."""
    import shutil

    import torch
    from click.testing import CliRunner
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    from ocrd_keraslm_torch.ops import score_kernel as sk
    from ocrd_keraslm_torch.scripts.run import cli as keraslm_rate
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.rate import mets_get_context
    pruned = os.path.join(work, 'pruned.h5')
    shutil.copy(MODEL, pruned)
    res = CliRunner().invoke(keraslm_rate, [
        '-l', 'WARNING', 'prune-charset', '-m', pruned, PRUNED_CHAR],
        env={'KERASLM_PLATFORM': 'cuda'})
    assert res.exit_code == 0, (res.output, res.exception)
    card_r, cpu_r = (_load_pruned(pruned, dev)
                     for dev in (rater.device, 'cpu'))
    assert card_r.voc_size == rater.voc_size - 1 and \
        PRUNED_CHAR not in card_r.vocab.c2i
    ws = decode['workspace']
    ctx = mets_get_context(Workspace(ws).mets)
    graph = workspace_graphs(ws)[0]
    zero_counts()
    path, ent, _ = card_r.rate_best_device(graph, 0, 0, context=ctx,
                                           beam_width=10)
    texts = page_texts(ws)[:1]
    ratings, ppl = card_r.rate2(texts[0], ctx)
    torch.cuda.synchronize()
    counts = read_counts()
    assert counts == dict(NO_LAUNCHES, decode_lattice=1,
                          score_scan=counts['score_scan']), counts
    assert counts['score_scan'] >= 1
    # the kernels against their plain versions at these shapes
    args, kw, _, _ = page_block(card_r, ws)
    got = [a.cpu().numpy() for a in dk.decode_lattice(*args, **kw)]
    want = [a.cpu().numpy() for a in dk.decode_lattice_ref(*args, **kw)]
    err, n_cmp, tie = compare_decode(got, want, 16, card_r.width)
    sargs = score_inputs(np.random.default_rng(69), 'german_b4',
                         rater.device, card_r)
    s_err, c_err, flips = compare_score(sk.score_scan(*sargs),
                                        sk.score_scan_ref(*sargs))
    # the decode and the scoring against the CPU (a small page: two f32
    # beam searches part at K-th-rank near-ties on long ones)
    small = os.path.join(work, 'small_pruned')
    build_workspace(small, np.random.default_rng(8), 2, 3, rater.vocab,
                    alt_share=0.3)
    sgraph = workspace_graphs(small)[0]
    on = {}
    for name, r in (('card', card_r), ('cpu', cpu_r)):
        p, e, _ = r.rate_best_device(sgraph, 0, 0, context=ctx,
                                     beam_width=10)
        on[name] = [(p, e)]
    cpu_diff = same_results(on['card'], on['cpu'], cost_ulps=2)
    cpu_ppl = cpu_r.rate2(texts[0], ctx)[1]
    assert abs(ppl - cpu_ppl) <= 1e-4 * cpu_ppl, (ppl, cpu_ppl)
    print('pruning: keraslm-rate prune-charset %r: V %d -> %d, saved in '
          'place; page 1 (%d glyphs) decoded through decode_lattice and its '
          'text (%d chars) scored through score_scan at V=%d: launches %s; '
          'entropy %.3f bits, ppl %.6f on the card, %.6f on the CPU '
          '(tolerance rtol 1e-4) [%s]'
          % (PRUNED_CHAR, rater.voc_size, card_r.voc_size, len(path),
             len(texts[0]), card_r.voc_size, counts, ent, ppl, cpu_ppl,
             card))
    print('pruning: decode_lattice against its plain version at V=%d '
          '(page 1: K=16, A=4, n_real=%d): %d edges compared, max |kernel - '
          'plain| %.3g%s; score_scan against its plain version (B=4, T=4096): max '
          '|kernel - plain| %.3g over probs and h, relative %.3g over c, %d '
          'probs round to another float16; a 2-page small workspace\'s page '
          '1 card against CPU: same path, max score/entropy diff %.3g'
          % (card_r.voc_size, kw['n_real'], n_cmp, err, '' if tie is None else
             ' (compared up to a near-tie at the K-th rank, edge %d)' % tie,
             s_err, c_err, flips, cpu_diff))
    return dict(launches=counts, err=err, score_err=s_err)


def _load_pruned(path, device):
    from ocrd_keraslm_torch.rater import Rater
    r = Rater(device=device)
    r.load_config(path)
    r.configure()
    r.load_weights(path)
    return r


TRACE_RUNS = 3      # traced CLI runs of part (d): the loss varied by run


def trace_events(path):
    """``(events, kernel events, names of the decode_lattice kernel
    events, kernel events of the clock warm-up)`` of a Chrome trace."""
    with open(path, encoding='utf-8') as fh:
        events = json.load(fh)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    named = [e['name'] for e in kernels
             if 'decode_lattice' in e.get('name', '')]
    warm = [e for e in events if e.get('cat') == 'user_annotation'
            and e.get('name') == 'keraslm_clock_warmup']
    launched = {e.get('args', {}).get('correlation') for e in events
                for w in warm if e.get('cat') == 'cuda_runtime'
                and w['ts'] <= e['ts'] <= w['ts'] + w.get('dur', 0)}
    warmed = [e for e in kernels
              if e.get('args', {}).get('correlation') in launched]
    return events, kernels, named, warmed


def trace_path(rater, work, decode, card):
    """Part (d): the decoding processor's CLI with ``--jax-trace``,
    ``TRACE_RUNS`` times: each Chrome trace must hold one
    ``decode_lattice`` kernel event for each launch the wrapper counted,
    and the pages must equal phase 4's."""
    import glob

    from ocrd_keraslm_torch.utils import devtrace
    from ocrd_keraslm_torch.wrapper.cli import ocrd_keraslm_rate
    runs = []
    for i in range(TRACE_RUNS):
        d = os.path.join(work, 'ws_jax_trace%d' % i)
        build_workspace(d, np.random.default_rng(7), 4, 40, rater.vocab)
        tdir = os.path.join(work, 'jax_trace%d' % i)
        zero_counts()
        t0 = time.time()
        with platform_env('cuda'):
            ocrd_keraslm_rate.main(args=[
                '-m', os.path.join(d, 'mets.xml'), '-I', 'OCR-D-OCR', '-O',
                'OCR-D-LM', '-l', 'WARNING', '--jax-trace', tdir, '-P',
                'model_file', MODEL, '-P', 'textequiv_level', 'glyph', '-P',
                'beam_width', '10'], standalone_mode=False)
        wall = time.time() - t0
        counts = read_counts()
        files = glob.glob(os.path.join(tdir, '*.pt.trace.json'))
        assert len(files) == 1, files
        events, kernels, named, warmed = trace_events(files[0])
        assert counts == decode['launches'], (counts, decode['launches'])
        assert output_files(d) == output_files(decode['workspace'])
        runs.append(dict(wall=wall, bytes=os.path.getsize(files[0]),
                         events=len(events), kernels=len(kernels),
                         decode_events=len(named),
                         launches=counts['decode_lattice'],
                         names=sorted(set(named)), warmed=len(warmed)))
    print('trace: the decoding CLI with --jax-trace, %d runs: decode_lattice '
          'kernel events %s against counted launches %s (%s); the clock '
          'warm-up kept %s of its %d kernels; %s s (host clock, tracing on), '
          '%s bytes of Chrome trace, %s events, %s of them CUDA kernels; the '
          'pages equal to phase 4\'s [%s]'
          % (TRACE_RUNS, [r['decode_events'] for r in runs],
             [r['launches'] for r in runs],
             '; '.join(n[:60] for n in runs[0]['names']),
             [r['warmed'] for r in runs], devtrace.WARMUP_KERNELS,
             ['%.3f' % r['wall'] for r in runs], [r['bytes'] for r in runs],
             [r['events'] for r in runs], [r['kernels'] for r in runs],
             card))
    assert all(r['decode_events'] == r['launches'] > 0 for r in runs), \
        ('the trace lost decode_lattice kernel events', runs)
    return runs


# ---------------------------------------------------------------------
# the distributed phase (parallel/): ranks on the one card
# ---------------------------------------------------------------------

DIST_RANKS = 2
DIST_STEPS = 3             # steps of the vocabulary and pipeline meshes
DIST_TIMEOUT = 300         # seconds a rank may take before the phase fails
DIST_DROPOUT_SEED = 7


def aligned_seed(seed):
    """The seed that ``parallel.multihost.align_seed`` gives every rank
    of a world whose rank 0 was seeded with :func:`seed_host` (seed): the
    one-process reference of a mesh run draws from it."""
    seed_host(seed)
    return int(np.random.randint(0, 2 ** 31 - 1))


def dist_batches(V, seed=41):
    """``DIST_STEPS`` seeded full-width batches (B=128, T=256): ids in
    [1, V), context 0, the last stream's last 100 targets masked."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(DIST_STEPS):
        mask = np.ones((TRAIN_B, TRAIN_T), np.float32)
        mask[-1, -100:] = 0.0
        out.append(dict(
            x=rng.integers(1, V, (TRAIN_B, TRAIN_T)).astype(np.int64),
            y=rng.integers(1, V, (TRAIN_B, TRAIN_T)).astype(np.int64),
            z=np.zeros((TRAIN_B,), np.int64), mask=mask))
    return out


def dist_cfg(kind):
    """The german model's configuration for the step checks: dropout 0.1
    on the data and vocabulary meshes (their masks are the one-process
    run's), 0 on the pipeline steps (their masks differ in bits by
    design)."""
    from ocrd_keraslm_torch.utils import h5io
    cfg = h5io.load_config(MODEL)[0]
    return cfg.replace(length=TRAIN_T,
                       dropout=0.0 if kind in ('pipe', 'packed') else 0.1)


def held_bytes(leaves, opt):
    """Bytes of ``leaves`` and of their Adam moments in ``opt``."""
    return sum(t.numel() * t.element_size() * (1 + sum(
        1 for k in ('exp_avg', 'exp_avg_sq') if k in opt.state.get(t, {})))
        for t in leaves)


def dist_steps(kind, dev, mesh=None):
    """``DIST_STEPS`` steps from the german model's weights on the seeded
    batches: one process (``mesh`` None, ``training.train_step``), the
    2-rank data mesh (``kind`` 'dp', each rank its half of the rows), the
    1x2 vocabulary mesh ('tp'), the 2-stage pipeline with 2 microbatches
    ('pipe') or the same on the packed layout ('packed', each rank its
    stage's layers and their moments).  Returns (losses, seconds a step
    (synchronised host clock), the canonical weights after the last step
    as numpy leaves, launch counts, the steps' collective counters, and
    after the steps the bytes this rank holds of parameters and moments,
    all and of the LSTM layers)."""
    import torch
    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    from ocrd_keraslm_torch.utils import h5io
    cfg = dist_cfg(kind)
    tree = h5io.load_weights(MODEL, cfg)
    if mesh is None:
        params = training.copy_params(tlm.params_from_numpy(tree, dev),
                                      requires_grad=True)
        opt = training.make_optimizer(params)

        def step(*args):
            return training.train_step(params, opt, cfg, *args)
    else:
        from ocrd_keraslm_torch.parallel import pipeline as tp
        from ocrd_keraslm_torch.parallel.mesh import gather_params
        from ocrd_keraslm_torch.parallel.train import make_sharded_train_step
        if kind == 'packed':
            fn, shard_fn = tp.make_pipeline_train_step(mesh, cfg, 2)
            n_stages = mesh.shape['pipe']
            params, opt, carry = shard_fn(
                tp.pack_pipeline_params(tree, cfg, n_stages),
                tp.pack_carry(tuple(np.zeros((cfg.depth, TRAIN_B, cfg.width),
                                             np.float32) for _ in 'hc'),
                              n_stages))
        else:
            fn, shard_fn = (tp.make_pipeline_train_step_canonical(mesh, cfg,
                                                                   2)
                            if kind == 'pipe' else
                            make_sharded_train_step(mesh, cfg))
            params, opt = shard_fn(tlm.params_from_numpy(tree, dev))

        def step(*args):
            return fn(params, opt, *args)
    rng = torch.Generator().manual_seed(DIST_DROPOUT_SEED) \
        if cfg.dropout > 0 else None
    n_data = 1 if mesh is None else mesh.shape['data']
    if kind != 'packed':
        carry = tlm.zero_carry(cfg, TRAIN_B // n_data, dev)
    from ocrd_keraslm_torch.parallel import comm
    losses, walls = [], []
    zero_counts()
    comm.reset_counters()
    for b in dist_batches(cfg.voc_size):
        if n_data > 1:
            from ocrd_keraslm_torch.parallel.mesh import local_rows
            b = {k: local_rows(mesh, a) for k, a in b.items()}
        args = [torch.from_numpy(b[k]).to(dev) for k in ('x', 'z', 'y',
                                                        'mask')]
        torch.cuda.synchronize()
        t0 = time.time()
        carry, loss, _, _ = step(args[0], [args[1]], args[2], args[3],
                                 carry, rng)
        losses.append(float(loss))
        walls.append(time.time() - t0)
    counts = read_counts()
    stats = dict(staged_bytes=comm.staged_bytes,
                 staged_seconds=comm.staged_seconds, seconds=comm.seconds,
                 calls=comm.calls)
    own = tlm.param_leaves(params)
    held = (held_bytes(own, opt), held_bytes(own[1 + len(cfg.contexts):],
                                             opt))
    if kind == 'packed':
        params = tp.unpack_pipeline_params(
            tp.gather_pipeline_params(mesh, params), cfg)
    elif mesh is not None:
        params = gather_params(mesh, params)
    leaves = [np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t)
                         else t) for t in tlm.param_leaves(params)]
    return losses, walls, leaves, counts, stats, held


def dist_decode_json(results):
    return [[[te.Unicode for _, te, _ in path],
             [float(x) for _, _, x in path], float(ent)]
            for path, ent in results]


def dist_serving(rater, spec, counts_of):
    """(d) scoring, (e) the batch decode and (f) generation with
    ``rater``'s mesh (or none): their results, launches and the seconds
    of a second call (the first in a fresh process loads libraries and
    chooses layouts)."""
    import torch
    out = {}
    docs = workspace_graphs(spec['ws_batch'])
    prompts = gen_prompts(rater, np.random.default_rng(21), GEN_BATCH)
    calls = (
        ('score', lambda: [np.asarray(p, np.float64).tolist() for p in
                           rater.rate_batch(spec['texts'],
                                            [[179]] * len(spec['texts']))]),
        ('decode', lambda: dist_decode_json(rater.rate_best_batch(docs))),
        ('generate', lambda: rater.generate_batch(prompts, GEN_BATCH_N)))
    for name, call in calls:
        zero_counts()
        got = call()
        launches = counts_of()
        torch.cuda.synchronize()
        t0 = time.time()
        assert call() == got, name
        torch.cuda.synchronize()
        out[name] = dict(result=got, wall=time.time() - t0,
                         launches=launches)
    return out


def rank_main(task, work, out):
    """One rank of the distributed phase (``chip_smoke.py --rank TASK
    WORK OUT``, started by :func:`distributed_path` with the
    ``KERASLM_*`` variables): joins the world, runs its part, writes its
    results as JSON to OUT."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    from ocrd_keraslm_torch.parallel import comm, multihost
    from ocrd_keraslm_torch.parallel.mesh import make_mesh
    from ocrd_keraslm_torch.parallel.pipeline import make_pipe_mesh
    from ocrd_keraslm_torch.parallel.train import make_sharded_train_step
    from ocrd_keraslm_torch.utils import h5io
    dev = torch.device('cuda')
    res = {}

    def comm_stats():
        stats = dict(staged_bytes=comm.staged_bytes,
                     staged_seconds=comm.staged_seconds,
                     seconds=comm.seconds, calls=comm.calls)
        comm.reset_counters()
        return stats
    if task == 'nccl':
        # one rank over NCCL: one data-parallel step of the german model
        multihost.join_from_env()
        mesh = make_mesh(1)
        cfg = dist_cfg('dp')
        step, shard_fn = make_sharded_train_step(mesh, cfg)
        params, opt = shard_fn(tlm.params_from_numpy(
            h5io.load_weights(MODEL, cfg), dev))
        comm.reset_counters()
        zero_counts()
        carry = tlm.zero_carry(cfg, TRAIN_B, dev)
        losses, walls = [], []
        for b in dist_batches(cfg.voc_size)[:2]:
            torch.cuda.synchronize()
            t0 = time.time()
            carry, loss, _, _ = step(
                params, opt, torch.from_numpy(b['x']).to(dev),
                [torch.from_numpy(b['z']).to(dev)],
                torch.from_numpy(b['y']).to(dev),
                torch.from_numpy(b['mask']).to(dev), carry, None)
            losses.append(float(loss))
            walls.append(time.time() - t0)
        res.update(backend=mesh.backend, losses=losses, walls=walls,
                   launches=read_counts(), comm=comm_stats())
    else:
        with open(os.path.join(work, 'dist_spec.json')) as fh:
            spec = json.load(fh)
        # (a) keraslm-rate train --mesh 2: the command joins the world
        wall, counts, rates = run_train_cli(
            work, spec['model'], spec['files'], 1, spec['seed'],
            extra=('--mesh', str(DIST_RANKS)), ckpt=os.path.join(
                work, 'dist_ckpt' + os.environ['KERASLM_PROCESS_ID']))
        res['train'] = dict(wall=wall, launches=counts, rates=rates,
                            comm=comm_stats(), rank=multihost.rank())
        torch.distributed.barrier()     # rank 0 has written the model
        res['train']['history'] = h5io.load_config(spec['model'])[2]
        # the data mesh's steps, (b) the vocabulary over 2 ranks, (c) 2
        # pipeline stages
        # pipeline stages, then the same on the packed layout
        pipe = make_pipe_mesh(DIST_RANKS, DIST_RANKS)
        for kind, mesh in (('dp', make_mesh(DIST_RANKS)),
                           ('tp', make_mesh(DIST_RANKS, DIST_RANKS)),
                           ('pipe', pipe), ('packed', pipe)):
            losses, walls, leaves, counts, stats, held = dist_steps(
                kind, dev, mesh)
            res[kind] = dict(losses=losses, walls=walls, launches=counts,
                             backend=mesh.backend, comm=stats, held=held)
            if mesh.rank == 0:
                np.savez(os.path.join(work, 'dist_%s.npz' % kind), *leaves)
        # (d)-(f): the rows, documents and streams over 2 ranks
        rater = german_rater(dev)
        rater.mesh = make_mesh(DIST_RANKS)
        comm_stats()
        res['serving'] = dist_serving(rater, spec, read_counts)
        res['serving_comm'] = comm_stats()
        res['backend'] = rater.mesh.backend
    multihost.shutdown()
    with open(out, 'w') as fh:
        json.dump(res, fh)
    return 0


def dist_world(task, n, work):
    """Run ``n`` ranks of :func:`rank_main` on the card, joined through
    ``KERASLM_COORDINATOR`` on a free local port (tried once more with a
    fresh port where the port was taken); returns each rank's results.
    A rank that fails or outlives ``DIST_TIMEOUT`` fails the phase."""
    import socket
    for attempt in range(2):
        sock = socket.socket()
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
        sock.close()
        outs = [os.path.join(work, 'dist_%s_%d.json' % (task, r))
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--rank', task, work,
             outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=HERE, env=dict(
                os.environ, KERASLM_COORDINATOR='127.0.0.1:%d' % port,
                KERASLM_NUM_PROCESSES=str(n), KERASLM_PROCESS_ID=str(r),
                KERASLM_PLATFORM='cuda')) for r in range(n)]
        logs, failed = [], []
        deadline = time.time() + DIST_TIMEOUT
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=max(1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                log, _ = p.communicate()
                failed.append('rank %d timed out after %d s' % (
                    r, DIST_TIMEOUT))
            logs.append(log)
            if p.returncode != 0 and not failed:
                failed.append('rank %d exited %d' % (r, p.returncode))
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if not failed:
            results = []
            for path in outs:
                with open(path) as fh:
                    results.append(json.load(fh))
            return results
        if attempt == 0 and any('Address already in use' in log
                                for log in logs):
            continue
        for r, log in enumerate(logs):
            print('rank %d of the %s world:\n%s' % (r, task, log[-4000:]))
        raise AssertionError('the %s world failed: %s' % (task, failed))
    raise AssertionError('no free port for the %s world' % task)


def distributed_path(rater, work, train, scoring, card):
    """Phase 6, distributed (``parallel/``): 2 ranks on the one card
    (gloo, the CUDA tensors staged through pinned host buffers) and one
    rank over NCCL, each against one process on the card; returns the
    phase's numbers."""
    import torch
    from ocrd_keraslm_torch.utils import h5io
    dev = torch.device('cuda')
    spec = dict(files=train['files'], seed=train['seed'],
                model=os.path.join(work, 'dist_model.h5'),
                texts=scoring['texts'],
                ws_batch=os.path.join(work, 'ws_batch'))
    with open(os.path.join(work, 'dist_spec.json'), 'w') as fh:
        json.dump(spec, fh)
    # the one-process references on the card
    single = os.path.join(work, 'dist_single.h5')
    wall1, counts1, rates1 = run_train_cli(work, single, spec['files'], 1,
                                           aligned_seed(spec['seed']))
    hist1 = h5io.load_config(single)[2]
    steps = {kind: dist_steps(kind, dev) for kind in ('dp', 'tp', 'pipe')}
    serving1 = dist_serving(rater, spec, read_counts)
    t0 = time.time()
    ranks = dist_world('mesh', DIST_RANKS, work)
    world_wall = time.time() - t0
    t0 = time.time()
    nccl, = dist_world('nccl', 1, work)
    nccl_wall = time.time() - t0
    # (a) keraslm-rate train --mesh 2
    loss1 = hist1['loss'][0]
    assert os.path.isfile(spec['model'])
    assert glob_files(os.path.join(work, 'dist_ckpt0'), 'ckpt.*.h5')
    assert not glob_files(os.path.join(work, 'dist_ckpt1'), '*'), \
        'rank 1 wrote a checkpoint'
    for r, got in enumerate(ranks):
        t = got['train']
        assert t['history'] == ranks[0]['train']['history']
        np.testing.assert_allclose(t['history']['loss'][0], loss1,
                                   rtol=1e-5, err_msg='rank %d' % r)
        assert t['launches'] == dict(
            NO_LAUNCHES, lstm_scan=counts1['lstm_scan'],
            lstm_bwd=counts1['lstm_bwd']), (r, t['launches'], counts1)
        assert t['launches']['lstm_bwd'] % TRAIN_D == 0
    n_steps = counts1['lstm_bwd'] // TRAIN_D
    from click.testing import CliRunner
    from ocrd_keraslm_torch.scripts.run import cli as keraslm_rate
    excerpt = os.path.join(work, 'excerpt_smoke_1790.txt')
    res = CliRunner().invoke(keraslm_rate, ['-l', 'WARNING', 'test', '-m',
                                            spec['model'], excerpt],
                             env={'KERASLM_PLATFORM': 'cuda'})
    assert res.exit_code == 0, (res.output, res.exception)
    ppl = float(res.output.strip().splitlines()[-1])
    assert np.isfinite(ppl) and ppl > 1
    tr = [got['train'] for got in ranks]
    print('distributed (a): keraslm-rate train -w %d -d %d -l %d -b %d -e 1 '
          '--mesh %d, %d ranks on the one card (backend %s): epoch loss %s '
          'on the ranks, %.8f in one process (rtol 1e-5); launches a rank %s '
          '(%d steps: lstm_bwd = steps x depth, lstm_scan = (steps + '
          'validation steps) x depth, as the one process); rank 0 alone '
          'wrote the model and the checkpoint; keraslm-rate test of it: ppl '
          '%.6f; wall %s s a rank against %.3f s in one process (CLI call, '
          'host clock; a rank\'s is its process\'s first work on the card: '
          'the group, the libraries and the layouts), the trainer\'s epoch '
          'chars/s %s on the ranks, %s in one process; collectives %s s in '
          '%s calls (of it the staging copies %s s), %s bytes staged '
          'through pinned host memory a rank [%s]'
          % (TRAIN_W, TRAIN_D, TRAIN_T, TRAIN_B, DIST_RANKS, DIST_RANKS,
             ranks[0]['backend'],
             ['%.8f' % t['history']['loss'][0] for t in tr], loss1,
             tr[0]['launches'], n_steps, ppl,
             ['%.3f' % t['wall'] for t in tr], wall1,
             [['%.0f' % r for r in t['rates']] for t in tr],
             ['%.0f' % r for r in rates1],
             ['%.3f' % t['comm']['seconds'] for t in tr],
             [t['comm']['calls'] for t in tr],
             ['%.3f' % t['comm']['staged_seconds'] for t in tr],
             [t['comm']['staged_bytes'] for t in tr], card))
    # the data mesh, (b) the vocabulary, (c) the pipeline: 3 steps
    # against one process
    out = dict(train=dict(wall=[t['wall'] for t in tr], wall1=wall1,
                          steps=n_steps, comm=[t['comm'] for t in tr]))
    for kind, what in (('dp', '(a) --mesh 2 (the rows over 2 ranks, '
                        'dropout 0.1 from one generator)'),
                       ('tp', '(b) --mesh 1x2 (the vocabulary over 2 ranks, '
                        'dropout 0.1 from one generator)'),
                       ('pipe', '(c) --mesh 2p (2 stages of one layer, 2 '
                        'microbatches, dropout 0)')):
        losses1, walls1, leaves1 = steps[kind][:3]
        leaves = np.load(os.path.join(work, 'dist_%s.npz' % kind))
        err = max(float(np.max(np.abs(leaves['arr_%d' % i] - a)))
                  for i, a in enumerate(leaves1))
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(got[kind]['losses'], losses1,
                                       rtol=1e-5, err_msg='%s %d' % (kind, r))
            assert got[kind]['launches'] == dict(
                NO_LAUNCHES, lstm_scan=DIST_STEPS * TRAIN_D,
                lstm_bwd=DIST_STEPS * TRAIN_D), (kind, r, got[kind])
        assert err <= 1e-5, (kind, err)
        g = [got[kind] for got in ranks]
        print('distributed %s: %d steps of the german model (W=%d, '
              'D=%d, B=%d, T=%d), losses %s on rank 0, %s in one process '
              '(rtol 1e-5); weights after the steps within %.3g of one '
              'process\'s (tolerance 1e-5); launches a rank %s; seconds a '
              'step %s on the ranks, %s in one process; in the steps a '
              'rank\'s collectives %s s (of it the staging copies %s s), '
              '%s bytes staged (backend %s) [%s]'
              % (what, DIST_STEPS, TRAIN_W,
                 TRAIN_D, TRAIN_B, TRAIN_T,
                 ['%.7f' % v for v in g[0]['losses']],
                 ['%.7f' % v for v in losses1], err, g[0]['launches'],
                 [['%.4f' % w for w in x['walls']] for x in g],
                 ['%.4f' % w for w in walls1],
                 ['%.4f' % x['comm']['seconds'] for x in g],
                 ['%.4f' % x['comm']['staged_seconds'] for x in g],
                 [x['comm']['staged_bytes'] for x in g], g[0]['backend'],
                 card))
        out[kind] = dict(walls=[x['walls'] for x in g], walls1=walls1,
                         err=err, comm=[x['comm'] for x in g])
    # (c) on the packed layout, in the same rank processes: equal bit for
    # bit to the canonical step (a data group of one rank: the canonical
    # step's sums over pipe add exact zeros), each rank its stage's layers
    packed = np.load(os.path.join(work, 'dist_packed.npz'))
    canon = np.load(os.path.join(work, 'dist_pipe.npz'))
    assert sorted(packed.files) == sorted(canon.files)
    diff = max(float(np.max(np.abs(packed[k] - canon[k])))
               for k in canon.files)
    g = [got['packed'] for got in ranks]
    for r, got in enumerate(ranks):
        assert got['packed']['losses'] == got['pipe']['losses'], r
        assert got['packed']['launches'] == got['pipe']['launches'] == dict(
            NO_LAUNCHES, lstm_scan=DIST_STEPS * TRAIN_D,
            lstm_bwd=DIST_STEPS * TRAIN_D), (r, got['packed']['launches'])
    assert diff == 0, diff
    print('distributed (c) on the packed layout (make_pipeline_train_step: '
          'a rank holds its stage\'s kernel, recurrent and bias stacks and '
          'their moments, the embeddings whole), same ranks, mesh, batches '
          'and weights: losses %s on rank 0, equal to the canonical step\'s '
          'on every rank; weights after %d steps max |diff| %g against the '
          'canonical step\'s (unpacked); launches a rank %s (summed over the '
          'ranks lstm_scan %d, lstm_bwd %d); bytes of parameters and Adam '
          'moments a rank %s (of them the LSTM layers %s), the canonical '
          'step %s (%s); seconds a step %s on the ranks, the canonical step '
          '%s [%s]'
          % (['%.7f' % v for v in g[0]['losses']], DIST_STEPS, diff,
             g[0]['launches'],
             sum(x['launches']['lstm_scan'] for x in g),
             sum(x['launches']['lstm_bwd'] for x in g),
             [x['held'][0] for x in g], [x['held'][1] for x in g],
             [got['pipe']['held'][0] for got in ranks],
             [got['pipe']['held'][1] for got in ranks],
             [['%.4f' % w for w in x['walls']] for x in g],
             [['%.4f' % w for w in got['pipe']['walls']] for got in ranks],
             card))
    out['packed'] = dict(walls=[x['walls'] for x in g], held=[
        x['held'] for x in g], canonical_held=[got['pipe']['held']
                                               for got in ranks])
    # (d)-(f): bit for bit equal to one process
    for name, what in (('score', '(d) phase 5\'s 4 pages scored, rows over '
                        '2 ranks'),
                       ('decode', '(e) rate_best_batch of the %d one-page '
                        'documents over 2 ranks' % BATCH_DOCS),
                       ('generate', '(f) generate_batch of %d prompts at -n '
                        '%d over 2 ranks' % (GEN_BATCH, GEN_BATCH_N))):
        want = serving1[name]
        for r, got in enumerate(ranks):
            assert got['serving'][name]['result'] == want['result'], \
                (name, r)
            assert any(got['serving'][name]['launches'].values()), (name, r)
        g = [got['serving'][name] for got in ranks]
        print('distributed %s: equal bit for bit to one process on every '
              'rank; launches a rank %s, in one process %s; seconds a call '
              '%s on the ranks, %.4f in one process [%s]'
              % (what, [x['launches'] for x in g], want['launches'],
                 ['%.4f' % x['wall'] for x in g], want['wall'], card))
        out[name] = dict(walls=[x['wall'] for x in g], wall1=want['wall'],
                         launches=[x['launches'] for x in g])
    sc = [got['serving_comm'] for got in ranks]
    print('distributed (d)-(f) collectives: %s s in %s calls (the gathers '
          'wait for the slower rank), %s bytes staged a rank [%s]'
          % (['%.3f' % c['seconds'] for c in sc], [c['calls'] for c in sc],
             [c['staged_bytes'] for c in sc], card))
    # (g) NCCL
    # without dropout the data step is the one process's pipeline
    # reference step (dropout 0) on the same batches
    assert nccl['backend'] == 'nccl' and nccl['comm']['calls'] > 0
    assert nccl['comm']['staged_bytes'] == 0
    assert nccl['launches']['lstm_bwd'] == 2 * TRAIN_D, nccl['launches']
    np.testing.assert_allclose(nccl['losses'], steps['pipe'][0][:2],
                               rtol=1e-5)
    print('distributed (g): one rank over NCCL (world of 1): backend %s, '
          'two data-parallel steps of the german model without dropout, '
          'losses %s (one process: %s, rtol 1e-5), %d collectives in %.4f s, '
          'nothing staged, launches %s, %s s a step (host clock, the first '
          'the process\'s first work on the card) [%s]'
          % (nccl['backend'], ['%.7f' % v for v in nccl['losses']],
             ['%.7f' % v for v in steps['pipe'][0][:2]],
             nccl['comm']['calls'], nccl['comm']['seconds'],
             nccl['launches'], ['%.4f' % w for w in nccl['walls']], card))
    print('distributed phase: the 2-rank world %.1f s and the NCCL world '
          '%.1f s of wall (process start, CUDA and the group included)'
          % (world_wall, nccl_wall))
    out.update(world_wall=world_wall, nccl_wall=nccl_wall, nccl=nccl)
    return out


def glob_files(directory, pattern):
    import glob
    return glob.glob(os.path.join(directory, pattern))


def main() -> int:
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on a '
              'GPU', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # f32 products throughout (the engines' too): no TF32
    assert torch.get_float32_matmul_precision() == 'highest'
    dev = torch.device('cuda')

    # ---- 1. card ----
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi)
    print('card: %s | torch %s, CUDA %s, %d device(s): %s'
          % (card, torch.__version__, torch.version.cuda, count, kind))
    print('tf32: matmul %s, cudnn %s (both off: f32 reference)'
          % (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32))

    # ---- 2. build ----
    build_kernels()
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import score_kernel as sk
    rater = german_rater(dev)
    D, W = rater.depth, rater.width
    wts = rater._decode_weights(None)
    print('model: %s  D=%d W=%d V=%d (padded %d), wcat %s'
          % (os.path.relpath(MODEL, HERE), D, W, wts['v_real'],
             wts['v_pad'], tuple(wts['wcat'].shape)))
    for K in (16, 32):
        for L in (1, 8):
            for what, batch, N in (('decode_lattice', False, 1),
                                   ('decode_lattice_batch', True,
                                    BATCH_DOCS)):
                cl = dk.cluster_blocks(dev, batch, N, K, 4, L, D, W,
                                       wts['v_pad'], wts['v_real'])
                shard = cl > 1 and dk.cluster_shard(
                    K, 4, L, D, W, wts['v_pad'], wts['v_real'], cl)
                lib = dk._batch_library() if batch else dk._library()
                smem = getattr(lib, what + '_smem_bytes')(
                    4, L, K, D, W, wts['v_pad'], wts['v_real'], cl,
                    int(shard))
                assert cl == 1 or smem == dk.cluster_smem_bytes(
                    4, L, K, D, W, wts['v_pad'], wts['v_real'], cl), smem
                print('layout %s at K=%d, A=4, L=%d, %d document(s): %s; %d '
                      'bytes of shared memory a block'
                      % (what, K, L, N, 'a thread-block cluster of %d blocks '
                         'of 256 threads a document, %d units a block, their '
                         'gate columns of both layers in registers, the %s '
                         'plan' % (cl, W // cl, 'sharded' if shard else
                                   'rows') if cl > 1 else
                         'the one-block layout, one block of 512 threads a '
                         'document', smem))
        for L in (1, 8):
            for what, batch, N in (('decode_lattice', False, 1),
                                   ('decode_lattice_batch', True,
                                    BATCH_DOCS)):
                print('layout %s with bf16 weights at K=%d, A=4, L=%d, %d '
                      'document(s): %d blocks a document (the f32 plan of '
                      'shared memory)' % (what, K, L, N, dk.cluster_blocks(
                          dev, batch, N, K, 4, L, D, W, wts['v_pad'],
                          wts['v_real'], True)))
    hmma = sass_hmma()
    bf16_fns = {f: n for f, n in hmma.items()
                if 'cluster_kernel' in f and 'bfloat16' in f}
    f32_hmma = sum(n for f, n in hmma.items() if 'bfloat16' not in f)
    print('SASS (cuobjdump -sass of the two decode libraries): HMMA '
          'instructions in each bf16 cluster kernel %s; in every f32 kernel '
          'and the one-block kernels %d'
          % (json.dumps(bf16_fns), f32_hmma + sum(
              n for f, n in hmma.items()
              if 'bfloat16' in f and 'cluster_kernel' not in f)))
    assert bf16_fns and all(n > 0 for n in bf16_fns.values()), bf16_fns
    assert f32_hmma == 0, 'an f32 kernel uses the tensor cores'
    for what, lay in (
            ('score_scan at B=4 (the scoring chunk)',
             sk.scan_layout_on(dev, 4, W, D, wts['v_pad'])),
            ('lstm_scan at B=4 (the layered scoring chunk)',
             lc.scan_layout_on(dev, 4, W, False)),
            ('lstm_scan at the training shape, f32 U',
             lc.scan_layout_on(dev, TRAIN_B, TRAIN_W, False)),
            ('lstm_scan at the training shape, bf16 U',
             lc.scan_layout_on(dev, TRAIN_B, TRAIN_W, True))):
        print('layout %s: %s; %d bytes of shared memory a block'
              % (what, 'the register layout on clusters of %d blocks of '
                 '512 threads, %d streams a cluster, %d a thread chain'
                 % (lay.cl, lay.rb, lay.rt) if lay.reg else
                 'the one-block layout, %d streams a block' % lay.rb,
                 lay.smem))
    lay = lc.bwd_layout_on(dev, TRAIN_B, TRAIN_W)
    print('layout lstm_bwd at the training shape (B=%d, W=%d), f32 and bf16 '
          'U: %s; %d bytes of shared memory a block; its dU product splits '
          'the %d rows %d ways'
          % (TRAIN_B, TRAIN_W, 'the z recompute as one product, then the '
             'chain in the register layout on clusters of %d blocks of 512 '
             'threads, %d streams a cluster, %d a thread chain, %d units a '
             'block' % (lay.cl, lay.rb, lay.rt, -(-TRAIN_W // lay.cl))
             if lay.reg else 'the one-block layout, %d streams a block'
             % lay.rb, lay.smem, TRAIN_B * TRAIN_T,
             lc._bwd_library().lstm_bwd_splits(TRAIN_B, TRAIN_T)))
    for what, lay in (
            ('lstm_scan at W=%d (B=%d: part (d)\'s training steps), f32 '
             'and bf16 U' % (WIDE_W, TRAIN_B),
             lc.scan_layout_on(dev, TRAIN_B, WIDE_W, False)),
            ('lstm_bwd\'s chain at W=%d (B=%d)' % (WIDE_W, TRAIN_B),
             lc.bwd_layout_on(dev, TRAIN_B, WIDE_W))):
        print('layout %s: %s, %d blocks of 256 threads in all; %d bytes of '
              'shared memory a block'
              % (what, describe_scan_layout(lay),
                 -(-TRAIN_B // lay.rb) * lay.cl if lay.grid else 0,
                 lay.smem))
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    index = torch.cuda.current_device()
    for lay in gk.gen_layouts(256, D, W, wts['v_pad'], 10, wts['v_real']):
        print('layout gen_beam at K=256, TOPK=10, D=%d, W=%d, Vp=%d: %s, %d '
              'bytes of shared memory a block, %d such clusters fit the '
              'card at once; the cost model\'s step %.1f us'
              % (D, W, wts['v_pad'], describe_gen_layout(lay), lay.smem,
                 gk.clusters_that_fit(index, 256, D, W, wts['v_pad'], 10,
                                      wts['v_real'], lay),
                 gk.step_cost(lay, 256, D, W, wts['v_real'])))
    for N in (1, GEN_BATCH):
        print('layout gen_beam for %d stream(s): the chooser takes %s'
              % (N, describe_gen_layout(gk.layout_on(
                  dev, N, 256, D, W, wts['v_pad'], 10, wts['v_real']))))

    # ---- 3. parity at full width ----
    sizes = set(dk.cluster_sizes(16, 4, 8, D, W, wts['v_pad'],
                                 wts['v_real'])) & set(
        dk.cluster_sizes(16, 4, 1, D, W, wts['v_pad'], wts['v_real']))
    for cl in sorted(sizes | {1}, reverse=True):
        with decode_cluster(cl):
            digests = decode_digests(rater, dev)
        print('decode_lattice output digests, %s (sha256 of records, '
              'stateF, costF and the device walk over a seeded 1024-edge '
              'block, K=16): %s; before the device code moved into '
              'decode_common.cuh: %s'
              % ('%d blocks a document' % cl if cl > 1 else
                 'the one-block layout', digests, DECODE_DIGESTS))
        assert digests == DECODE_DIGESTS, ('decode_lattice outputs changed',
                                           cl)
    t0 = time.time()
    score_dig, lstm_dig = score_digests(rater, dev), lstm_digests(dev)
    for name, got, want in (('score_scan', score_dig, SCORE_DIGESTS),
                            ('lstm_scan and lstm_bwd', lstm_dig,
                             LSTM_DIGESTS)):
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        print('%s output digests (sha256 of every output, %d seeded '
              'full-width cases): %s equal to those of the kernels of '
              'commit cdb1b2b%s' % (name, len(want),
                                    'all' if not bad else 'NOT all',
                                    ': differ in %s' % bad if bad else ''))
        assert not bad, (name, 'outputs changed', bad)
    layouts = scan_layouts('bwd', TRAIN_B, TRAIN_W, 1)
    bwd_dig = bwd_digests(dev, layouts)
    bad = sorted(k for k, v in bwd_dig.items() if v != LSTM_DIGESTS[k[1]])
    print('lstm_bwd output digests in every layout the chooser could take '
          'at the training shape (%s; (streams, blocks, register layout)): '
          '%s equal to those of the kernels of commit cdb1b2b%s'
          % (', '.join(str(x) for x in layouts), 'all' if not bad else
             'NOT all', ': differ in %s' % bad if bad else ''))
    assert not bad, ('lstm_bwd outputs changed', bad)
    print('digests in %.1f s' % (time.time() - t0))
    decode_err = decode_parity(rater, dev)
    batch_err, batch_times = batch_parity(rater, dev)
    t0 = time.time()
    decode_bf16_err = decode_parity_bf16(rater, dev)
    batch_bf16_err, batch_bf16_times = batch_parity_bf16(rater, dev)
    print('bf16 decode parity in %.1f s' % (time.time() - t0))
    t0 = time.time()
    k32_err, k32_batch_err, k32_batch_times, k32_bf16_err = k32_parity(
        rater, dev)
    print('K=32 decode parity in %.1f s' % (time.time() - t0))
    score_err, lstm_err = score_parity(rater, dev)
    train_errs = train_parity(dev)
    t0 = time.time()
    wide1840 = wide1840_phase(dev, card)
    print('W=1840 wide layout phase in %.1f s' % (time.time() - t0))
    gen_err = gen_parity_phase(rater)
    tb_parity_phase()
    print('kernels held against their plain versions: %s'
          % json.dumps(list(KERNELS)))

    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as work:
        # ---- 4. decode path, 5. scoring path, 6. training path ----
        decode = decode_path(rater, work)
        scoring = scoring_path(rater, work)
        train = training_path(work, card)
        training_steps(train, dev, card)
        gen = generation_path(rater, card)
        host = host_engine_path(rater, work, card)
        lanes = lane_path(rater, work, card)
        batch = batch_path(rater, work, card)
        t0 = time.time()
        k32 = k32_path(rater, work, decode, card)
        print('K=32 paths: %.1f s' % (time.time() - t0))
        t0 = time.time()
        bf16 = bf16_path(rater, work, decode, batch, card)
        print('bf16 decode paths: %.1f s' % (time.time() - t0))
        t0 = time.time()
        engines = engine_path(rater, work, train, card)
        print('unbounded engines phase: %.1f s' % (time.time() - t0))
        t0 = time.time()
        serving_path(rater, work, decode, scoring, card)
        resume_path(work, card)
        prune_path(rater, work, decode, card)
        trace_path(rater, work, decode, card)
        print('serving, resume, pruning and trace phases: %.1f s'
              % (time.time() - t0))
        t0 = time.time()
        distributed_path(rater, work, train, scoring, card)
        print('distributed phase: %.1f s' % (time.time() - t0))

        # ---- 7. numbers ----
        print('decode path wall: %.3f s for 4 pages = %.3f s/page, %.0f '
              'decode edges/s (host clock, CLI call incl. model load) [%s]'
              % (decode['wall'], decode['wall'] / 4,
                 decode['n_edges'] / decode['wall'], card))
        print_profile('decode path', decode['traced_wall'], decode['busy'],
                      card)
        lw = decode['lane_walls']
        print('decode path wall by page lane (same 4 pages, fresh copies, '
              'alternating; CLI call incl. model load, host clock): native '
              '%s s = %s s/page; records (KERASLM_NATIVE_PAGE=0) %s s = %s '
              's/page [%s]'
              % (', '.join('%.3f' % w for w in lw['native']),
                 ', '.join('%.3f' % (w / 4) for w in lw['native']),
                 ', '.join('%.3f' % w for w in lw['records']),
                 ', '.join('%.3f' % (w / 4) for w in lw['records']), card))
        sw = decode['split_wall']
        print('decode path wall split (host clocks around the port\'s calls, '
              'one more processor run over the same 4 pages, native lane; '
              'the page scan runs in the prefetch thread beside the rest): '
              '%.3f s = %s, other (CLI, METS, the loop) %.4f s [%s]'
              % (sw, ', '.join('%s %.4f s (%.1f%%)' % (k, v, 100 * v / sw)
                               for k, v in decode['split'].items()),
                 sw - sum(decode['split'].values()), card))
        gr = lanes['groups']
        print('page groups wall (16 pages of 6 lines, alternating; CLI call '
              'incl. model load, host clock): KERASLM_FUSE_PAGES=1 %s s with '
              '%d decode_lattice launch(es), =0 %s s with %d [%s]'
              % (', '.join('%.3f' % w for w in gr['walls']['on']),
                 gr['launches']['on'],
                 ', '.join('%.3f' % w for w in gr['walls']['off']),
                 gr['launches']['off'], card))
        for fuse in ('on', 'off'):
            print_profile('page groups %s' % fuse, *gr['traced'][fuse],
                          card, over='16 pages of 6 lines, '
                          'KERASLM_FUSE_PAGES=%d' % (fuse == 'on'))
        la = lanes['lookahead']
        print('lookahead write-back wall: %.3f s for the 4 pages (CLI call '
              'incl. model load, host clock; the default lane %.3f s in '
              'phase 4), of it the reverse walk %.4f s; the CPU %.3f s [%s]'
              % (la['wall'], decode['wall'], la['walk'], la['wall_cpu'],
                 card))
        print('scoring path wall: %.3f s for 4 pages = %.3f s/page, %.0f '
              'scored chars/s (host clock, CLI call incl. model load) [%s]'
              % (scoring['wall'], scoring['wall'] / 4,
                 scoring['n_chars'] / scoring['wall'], card))
        print_profile('scoring path', scoring['traced_wall'],
                      scoring['busy'], card)
        print('scoring path wall split (host clocks around the port\'s '
              'calls, one more processor run over the same 4 pages): %.3f '
              's = %s [%s]'
              % (scoring['split_wall'], ', '.join(
                  '%s %.4f s (%.1f%%)' % (k, v, 100 * v / scoring[
                      'split_wall']) for k, v in scoring['split'].items()),
                 card))
        print('training path wall: %.3f s for the CLI call (2 epochs: %d '
              'steps, %d validation steps, split, vocabulary, checkpoints '
              'and model write included); the trainer\'s own chars/s per '
              'epoch (training chars over the epoch\'s training and '
              'validation time): %s [%s]'
              % (train['wall'], train['steps'], train['val_steps'],
                 ['%.0f' % r for r in train['rates']], card))
        print('generation path wall: %.3f s for keraslm-rate generate -n '
              '%d -v %d (CLI call incl. model load); Rater.generate of the '
              'same: %s s = %s generated chars/s (host clock, each call '
              'synchronised by its fetch); Rater.generate_batch of %d '
              'prompts at -n %d: %.3f s = %.0f generated chars/s [%s]'
              % (gen['wall_cli'], GEN_N, GEN_VARIANTS,
                 ', '.join('%.4f' % w for w in gen['walls']),
                 ', '.join('%.0f' % (GEN_N / w) for w in gen['walls']),
                 GEN_BATCH, GEN_BATCH_N, gen['wall_batch'],
                 GEN_BATCH * GEN_BATCH_N / gen['wall_batch'], card))
        print_profile('generation path', gen['traced_wall'], gen['busy'],
                      card, over='one Rater.generate -n %d -v %d'
                      % (GEN_N, GEN_VARIANTS))
        print('host decode engine wall: %.3f s for 1 page of %d glyphs with '
              '-P device_decoding false (CLI call incl. model load, host '
              'clock), %d _predict_step calls, %.2f ms a call over the '
              'wall; the branching page of %d glyphs through the device '
              'lane\'s bail %.3f s, %d calls [%s]'
              % (host['host']['wall'], host['host']['glyphs'],
                 host['host']['steps'],
                 1e3 * host['host']['wall'] / host['host']['steps'],
                 host['bail']['glyphs'], host['bail']['wall'],
                 host['bail']['steps'], card))
        one = batch['one-page']
        n_edges = sum(one['sizes'])
        print('batched serving path wall: %.3f s for Rater.rate_best_batch '
              'of %d one-page documents (%d decode edges) = %.1f documents/s, '
              '%.0f decode edges/s (host clock, ended by the fetch); the same '
              'documents through %d sequential rate_best_device calls: %.3f '
              's (%.1fx); %d documents of %d pages: %.3f s, sequentially '
              '%.3f s [%s]'
              % (one['wall'], BATCH_DOCS, n_edges, BATCH_DOCS / one['wall'],
                 n_edges / one['wall'], BATCH_DOCS, one['wall_seq'],
                 one['wall_seq'] / one['wall'], BATCH_MULTI, BATCH_PAGES,
                 batch['4-page']['wall'], batch['4-page']['wall_seq'], card))
        print_profile('batched serving path', batch['traced_wall'],
                      batch['busy'], card, over='one rate_best_batch of %d '
                      'one-page documents' % BATCH_DOCS)
        numbers = dict(decode_lattice=decode_numbers(rater, decode, card),
                       **scoring_numbers(rater, scoring, card),
                       **training_numbers(dev, card),
                       **generation_numbers(rater, gen, card),
                       **batch_numbers(rater, batch, batch_times, card),
                       **wide_numbers(dev, card, scoring['texts']),
                       **wide1840['numbers'],
                       decode_lattice_bf16=decode_numbers_bf16(rater, decode,
                                                               card),
                       decode_lattice_batch_bf16=batch_numbers_bf16(
                           rater, batch, bf16, batch_bf16_times, card),
                       decode_lattice_k32=decode_numbers(rater, decode,
                                                         card, K=32),
                       decode_lattice_bf16_k32=decode_numbers_bf16(
                           rater, decode, card, K=32),
                       decode_lattice_batch_k32=batch_numbers(
                           rater, k32, k32_batch_times,
                           card)['decode_lattice_batch'])
    rows = []
    # lstm_scan is on two paths: 'lstm_scan' is the layered scoring
    # path's row (B=4, T=4096), 'lstm_scan_train' and 'lstm_scan_bf16'
    # the training path's (B=128, T=256, c_all on); a wrapper counts all
    # of its launches, so the bf16 rows read the --bf16 run's counts
    for name, source, launches, err in (
            ('decode_lattice', 'decode_lattice',
             decode['launches']['decode_lattice'], decode_err),
            ('score_scan', 'score_scan', scoring['launches'], score_err),
            ('lstm_scan', 'lstm_scan', scoring['lstm_launches'], lstm_err),
            ('lstm_scan_train', 'lstm_scan',
             train['launches']['lstm_scan'], train_errs['lstm_scan_train']),
            ('lstm_scan_bf16', 'lstm_scan',
             train['launches_bf16']['lstm_scan'],
             train_errs['lstm_scan_bf16']),
            ('lstm_bwd', 'lstm_bwd', train['launches']['lstm_bwd'],
             train_errs['lstm_bwd']),
            ('lstm_bwd_bf16', 'lstm_bwd',
             train['launches_bf16']['lstm_bwd'],
             train_errs['lstm_bwd_bf16']),
            # the W=512 model's training steps (part (d)): the grid
            # layouts
            ('lstm_scan_w512', 'lstm_scan',
             engines['wide']['launches']['lstm_scan'],
             engines['wide']['scan_err']),
            ('lstm_bwd_w512', 'lstm_bwd',
             engines['wide']['launches']['lstm_bwd'],
             engines['wide']['err']),
            # AWD-LSTM's enwik8 layers 1-2 (W=1840): the wide layout's
            # launches of phase 3
            ('lstm_scan_w1840', 'lstm_scan',
             wide1840['launches']['lstm_scan'], wide1840['scan_err']),
            ('lstm_bwd_w1840', 'lstm_bwd',
             wide1840['launches']['lstm_bwd'], wide1840['err']),
            ('gen_beam', 'gen_beam', gen['launches']['gen_beam'], gen_err),
            ('gen_beam_batch', 'gen_beam',
             gen['batch_launches']['gen_beam'], gen_err),
            # the traceback equals its plain version exactly
            ('gen_traceback', 'gen_traceback',
             gen['launches']['gen_traceback'], 0.0),
            ('decode_lattice_batch', 'decode_lattice_batch',
             batch['launches']['decode_lattice_batch'], batch_err),
            # the walk equals its plain version exactly
            ('walk_records_batch', 'decode_lattice_batch',
             batch['launches']['walk_records_batch'], 0.0),
            # the bf16 decode mode: the processor's pages and the serving
            # batch with rater.decode_bf16 = True
            ('decode_lattice_bf16', 'decode_lattice',
             bf16['launches']['decode_lattice_bf16'], decode_bf16_err),
            ('decode_lattice_batch_bf16', 'decode_lattice_batch',
             bf16['batch_launches']['decode_lattice_batch_bf16'],
             batch_bf16_err),
            # beam_width 17-32 (K=32): the cluster layout's sharded plan;
            # the beam-32 CLI pages of part (a), the 32-document batch at
            # beam 32 and the bf16 decode mode's pages at beam 32
            ('decode_lattice_k32', 'decode_lattice',
             engines['glyph']['launches32'], k32_err),
            ('decode_lattice_batch_k32', 'decode_lattice_batch',
             k32['launches']['decode_lattice_batch'], k32_batch_err),
            ('decode_lattice_bf16_k32', 'decode_lattice',
             k32['bf16_launches']['decode_lattice_bf16'], k32_bf16_err)):
        assert launches > 0, (name, 'was not launched on its path')
        module = {'decode_lattice': 'decode_kernel.py:318',
                  'score_scan': 'score_kernel.py:132',
                  'lstm_scan': 'lstm_cell.py:111',
                  'lstm_bwd': 'lstm_cell.py:252',
                  'gen_beam': 'gen_kernel.py:241',
                  'gen_traceback': 'gen_kernel.py:346',
                  'decode_lattice_batch': 'decode_kernel.py:756',
                  # the jitted walk beside the batched kernel
                  'walk_records_batch': 'decode_kernel.py:830'}[
                      name if name.startswith('walk') else source]
        rows.append(dict(name=name, route='cuda',
                         source='ocrd_keraslm_torch/csrc/%s.cu' % source,
                         replaces='ocrd_keraslm_tpu/ops/%s' % module,
                         launches=launches, max_abs_err=err,
                         **numbers[name]))
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': kind,
                                             'count': count}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--rank']:
        sys.path.insert(0, HERE)
        sys.exit(rank_main(*sys.argv[2:5]))
    sys.exit(main())
