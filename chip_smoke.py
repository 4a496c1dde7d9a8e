#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure exits non-zero):

1. card: name and power limit (``nvidia-smi``), torch device name/count;
   no CUDA device is a failure, never a fallback;
2. build: ``nvcc`` builds the four kernel sources of
   ``ocrd_keraslm_torch/csrc/`` (``decode_lattice.cu``, ``score_scan.cu``,
   ``lstm_scan.cu``, ``lstm_bwd.cu``) for sm_90a, all at once; prints
   seconds, ``-Xptxas -v`` registers and spills, and each block's dynamic
   shared memory;
3. parity at full width (``pretrained/model_german.h5``), each kernel
   against its plain PyTorch version, and both versions' error against
   the plain version run in float64:
   the decode kernel (K=16, A=4, L in {1, 8}) over a seeded lattice of
   E=1024 edges and a chained tail block with n_real < E; the scoring
   kernel over 4096-step chunks at B in {1, 4} and at D=1, from a seeded
   nonzero carry with a partial mask; the LSTM-scan kernel at B=4,
   T=4096, with and without ``c_all``; at the training shape (B=128,
   T=256, W=128) the LSTM-scan kernel with f32 and bf16 U and the
   LSTM backward kernel with both, ``dU`` equal from launch to launch;
4. decode path: a seeded synthetic METS/PAGE workspace (4 pages of ~1800
   glyphs, 2-4 alternatives on ~15% of them) through
   ``ocrd_keraslm_torch.wrapper.cli`` at glyph level, beam_width 10;
   every glyph must end with one TextEquiv, every page must be written,
   the kernel must have launched once per page block, and a small
   workspace must decode the same on the card and on the CPU;
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
   the CPU;
7. numbers: wall per page, edges/s and scored chars/s, the device's busy
   and idle share of the paths (``torch.profiler``), wall per training
   step and chars/s, and per kernel at the main path's shapes: its time
   and the plain version's (CUDA events), its bound, and a library
   yardstick where there is one.

Every kernel count is set to 0 just before a path runs and read just
after.  The last two lines are the kernel table and
``{"ok": true, "device": {...}}`` as JSON.
"""
from __future__ import annotations

import contextlib
import json
import os
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
                   c_rtol=2e-5, cost_rtol=1e-5, cost_atol=1e-4):
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
    output (E+1, 2) is compared whole: choices equal, costs close."""
    g_pk, g_st, g_co = got
    w_pk, w_st, w_co = want
    assert g_pk.shape == w_pk.shape, (g_pk.shape, w_pk.shape)
    err = 0.0

    def close(name, a, b):
        nonlocal err
        fin = np.abs(b) < 1e29
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
    assert d[:, :split].max() <= state_atol, \
        ('stateF xemb/h', float(d[:, :split].max()))
    c_tol = state_atol + c_rtol * np.abs(w_st[:, split:])
    assert (d[:, split:] <= c_tol).all(), \
        ('stateF c', float((d[:, split:] - c_tol).max()))
    err = max(err, float(d.max()))
    close('costF', g_co, w_co)
    return err, n_edges, None


def parity_block(run, kernel, plain, arrays, n_real, state, cost, K,
                 width):
    """Hold ``kernel`` against ``plain`` over one block of edges, both
    from the same ``state``/``cost``, records and device walk, with
    :func:`compare_decode`.  ``run(fn, arrays, n_real, state, cost,
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
        e, _, div = compare_decode(got[0], want[0], K, width)
        err = max(err, e)
        if div is None:
            final = want[0][0][-1, 2 * K:]
            if final[1] - final[0] > max(1e-3, 1e-5 * abs(final[0])):
                # the best final slot is one hypothesis in both runs
                err = max(err, compare_decode(got[1], want[1], K, width)[0])
            return (err, ties) + tuple(carry)
        ties.append(start + div)
        _, state, cost = run(kernel, part, div + 1, state, cost, False)
        start += div + 1
    return err, ties, state, cost


def as_float64(fn):
    """``fn`` (a decode function) run in float64 on the same inputs,
    outputs back in float32.  The cost carry's dead lanes map to BIG
    exactly, so dead slots still tie as in float32."""
    import torch

    def run64(*args, **kwargs):
        args = [a.double() if a.is_floating_point() else a for a in args]
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
                    alt_share=0.15, identifier='urn:smoke/kant_1784'):
    """A METS/PAGE workspace of German-like text from ``vocab``'s
    charset: one region per page, ``n_lines`` lines of ~10 words, one
    Glyph per char; ``alt_share`` of the glyphs carry 2-4 alternatives
    (the true char among them, confs within 0.1 of the first)."""
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
            for wi in range(int(rng.integers(8, 13))):
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


def run_cli(directory, platform, beam_width=10, scoring=False):
    """The processor through its CLI entry point, in this process: beam
    decoding, or with ``scoring`` ``-P alternative_decoding false``."""
    from ocrd_keraslm_torch.wrapper.cli import ocrd_keraslm_rate
    args = ['-m', os.path.join(directory, 'mets.xml'),
            '-I', 'OCR-D-OCR', '-O', 'OCR-D-LM', '-l', 'WARNING',
            '-P', 'model_file', MODEL, '-P', 'textequiv_level', 'glyph',
            '-P', 'beam_width', str(beam_width)]
    if scoring:
        args += ['-P', 'alternative_decoding', 'false']
    with platform_env(platform):
        ocrd_keraslm_rate.main(args=args, standalone_mode=False)


@contextlib.contextmanager
def platform_env(platform):
    """``KERASLM_PLATFORM`` set to ``platform`` inside the block."""
    old = os.environ.get('KERASLM_PLATFORM')
    os.environ['KERASLM_PLATFORM'] = platform
    try:
        yield
    finally:
        if old is None:
            del os.environ['KERASLM_PLATFORM']
        else:
            os.environ['KERASLM_PLATFORM'] = old


KERNELS = ('decode_lattice', 'score_scan', 'lstm_scan', 'lstm_bwd')
# device kernels by name, for the profiler's sums (lstm_bwd launches
# three: the recurrence, the dU partial products and their sum)
DEVICE_KERNELS = KERNELS + ('lstm_du',)


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


def page_blocks(directory, rater):
    """(kernel launches the processor makes, prepared edges) summed
    over the input pages: one launch per block of <= 1024 edges."""
    from ocrd_keraslm_torch.rater import E_BUCKETS
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from ocrd_keraslm_torch.wrapper.page_fast import parse_page_fast
    from ocrd_keraslm_torch.wrapper.rate import page_get_linear_lattice_at
    ws = Workspace(directory)
    launches = edges = 0
    for f in ws.mets.find_files(fileGrp='OCR-D-OCR'):
        pcgts = parse_page_fast(os.path.join(directory, f.local_filename))
        prep = rater._prepare_decode_edges(
            page_get_linear_lattice_at('glyph', pcgts))
        launches += -(-len(prep) // E_BUCKETS[-1])
        edges += len(prep)
    return launches, edges


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
    """``score_scan``'s arguments for a named case: ``d1w32``,
    ``d2w32b9``, ``d3w32`` (seeded weights of depth 1-3, W=32, V=40
    padded to 128, B=5 or 9, T=100) or ``german_b1``, ``german_b4``,
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
        D, W, v_real = int(case[1]), 32, 40
        B, T = (9 if case.endswith('b9') else 5), 100
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
    """Build the four kernel sources at once (one ``nvcc`` each, in
    threads); print seconds and ``ptxas`` lines."""
    from concurrent.futures import ThreadPoolExecutor
    from ocrd_keraslm_torch.ops import _build
    from ocrd_keraslm_torch.ops import decode_kernel, lstm_cell, score_kernel
    sources = [m.SOURCE for m in (decode_kernel, score_kernel, lstm_cell)] \
        + [lstm_cell.BWD_SOURCE]

    def one(src):
        t0 = time.time()
        path, log = _build.build(src)
        return path, log, time.time() - t0
    t0 = time.time()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(one, sources))
    for name, (path, log, secs) in zip(KERNELS, built):
        print('build %s: nvcc %s -> %s in %.2f s'
              % (name, ' '.join(_build.NVCC_FLAGS),
                 os.path.relpath(path, HERE), secs))
        for line in log.splitlines():
            if any(w in line for w in ('registers', 'spill', 'smem',
                                       'Compiling entry')):
                print('ptxas:', line.strip())
    print('build: %d kernel sources in %.2f s (parallel nvcc)'
          % (len(sources), time.time() - t0))


def decode_parity(rater, dev):
    """Phase 3, decode kernel; returns its max abs error."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    wts = rater._decode_weights(None)
    W, K, A = rater.width, 16, 4
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
            if b == 0:
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
            print('parity L=%d block %d (E=%d, n_real=%d, K=%d, A=%d): '
                  'every edge compared, max |kernel - plain| %.3g, '
                  'near-ties at the K-th rank resumed from the kernel\'s '
                  'state at edges %s; device walk = host walk of the '
                  'records (tolerances: costs rtol 1e-5 atol 1e-4, stateF '
                  'atol 1e-5, c also rtol 2e-5) in %.1f s'
                  % (L, b, E, n, K, A, err, ties or 'none',
                     time.time() - t0))
    return max_err


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


def zero_counts():
    from ocrd_keraslm_torch.ops import decode_kernel, lstm_cell, score_kernel
    decode_kernel.decode_lattice.launches = 0
    score_kernel.score_scan.launches = 0
    lstm_cell.lstm_scan.launches = 0
    lstm_cell.lstm_bwd.launches = 0


def read_counts():
    from ocrd_keraslm_torch.ops import decode_kernel, lstm_cell, score_kernel
    return {'decode_lattice': decode_kernel.decode_lattice.launches,
            'score_scan': score_kernel.score_scan.launches,
            'lstm_scan': lstm_cell.lstm_scan.launches,
            'lstm_bwd': lstm_cell.lstm_bwd.launches}


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


def decode_path(rater, work):
    """Phase 4; returns the path's numbers."""
    from ocrd_keraslm_torch.rater import E_BUCKETS
    big = os.path.join(work, 'ws')
    n_glyphs = build_workspace(big, np.random.default_rng(7), 4, 40,
                               rater.vocab)
    expect, n_edges = page_blocks(big, rater)
    zero_counts()
    t0 = time.time()
    run_cli(big, 'cuda')
    wall = time.time() - t0
    counts = read_counts()
    check_glyphs(big, n_glyphs)
    assert counts['decode_lattice'] == expect, (counts, expect)
    print('decode path: 4 pages, %d glyphs, %d decode edges written; '
          'launches %s (expected %d decode_lattice, one per page block of '
          '<= %d edges)' % (n_glyphs, n_edges, counts, expect,
                            E_BUCKETS[-1]))
    conf_err, n_small = small_card_vs_cpu(work, rater, False, 1e-4)
    print('decode path small workspace: %d glyphs, same choices on the '
          'card and on the CPU, max conf diff %.3g (tolerance 1e-4)'
          % (n_small, conf_err))
    # where the time goes: the same four pages (a fresh copy) once
    # more, under torch.profiler
    traced = os.path.join(work, 'ws_traced')
    build_workspace(traced, np.random.default_rng(7), 4, 40, rater.vocab)
    traced_wall, busy = profile_main_path(traced)
    return dict(wall=wall, n_edges=n_edges, launches=counts,
                traced_wall=traced_wall, busy=busy, workspace=big)


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
    assert counts == {'decode_lattice': 0, 'score_scan': chunks,
                      'lstm_scan': 0, 'lstm_bwd': 0}, (counts, chunks)
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
    assert layered_counts == {'decode_lattice': 0, 'score_scan': 0,
                              'lstm_scan': rater.depth * chunks,
                              'lstm_bwd': 0}, layered_counts
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
    traced = os.path.join(work, 'ws_score_traced')
    build_workspace(traced, np.random.default_rng(7), 4, 40, rater.vocab)
    traced_wall, busy = profile_main_path(traced, scoring=True)
    return dict(wall=wall, n_chars=n_chars, texts=texts,
                launches=counts['score_scan'],
                lstm_launches=layered_counts['lstm_scan'],
                traced_wall=traced_wall, busy=busy)


def decode_numbers(rater, decode, card):
    """Phase 6, decode kernel at the main path's shape (page 1)."""
    import torch
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    from ocrd_keraslm_torch.rater import E_BUCKETS, L_BUCKETS, _alt_steps
    from ocrd_keraslm_torch.utils.buckets import bucket
    from ocrd_keraslm_torch.wrapper.page_fast import parse_page_fast
    from ocrd_keraslm_torch.wrapper.rate import page_get_linear_lattice_at
    first = os.path.join(decode['workspace'], 'OCR-D-OCR',
                         'OCR-D-OCR_phys_0001.xml')
    prep = rater._prepare_decode_edges(
        page_get_linear_lattice_at('glyph', parse_page_fast(first)))
    wts = rater._decode_weights(None)
    D, W, K, A = rater.depth, rater.width, 16, 4
    S = (2 * D + 1) * W
    n = len(prep)
    L = bucket(max(len(ids) for pe in prep for ids in pe['alt_ids']),
               L_BUCKETS)
    E = bucket(n, E_BUCKETS)
    chars, mask, conf, valid = rater._fill_decode_arrays(prep, E, A, L)
    steps = _alt_steps(mask)[:, 0]
    ins = [torch.from_numpy(a).to(rater.device)
           for a in (chars, mask, conf, valid, steps)]
    state0, cost0 = rater._fused_traceback(None, K, wts['emb'])
    args = (wts['emb'], wts['embT'], wts['wcat'], wts['bias'],
            ins[0], ins[1], ins[2], ins[3], state0, cost0)
    kw = dict(lm_weight=0.5, v_real=wts['v_real'], device_walk=True,
              alt_steps=ins[4], n_real=n)
    ms = cuda_ms(lambda: dk.decode_lattice(*args, **kw), 3)
    plain_ms = cuda_ms(lambda: dk.decode_lattice_ref(*args, **kw), 1)
    ms2 = cuda_ms(lambda: dk.decode_lattice(*args, **kw), 3)
    out_bytes = ((E + 1) * 2 + K * S + 128) * 4
    # emb and embT are read at their v_real real rows/columns only
    nbytes = (tensor_bytes(*args, ins[4]) + out_bytes
              - 2 * W * (wts['v_pad'] - wts['v_real']) * 4)
    bound_ms, bound_by, flops = decode_bound(
        mask, steps, n, K, D, W, wts['v_real'], nbytes)
    print('decode_lattice at the main path shape (page 1: E=%d, n_real=%d, '
          'L=%d, K=%d, A=%d): %.3f ms/launch then %.3f ms/launch (CUDA '
          'events, mean of 3 warm launches), %.2f us/edge [%s]'
          % (E, n, L, K, A, ms, ms2, 1e3 * ms2 / n, card))
    print('decode_lattice plain version at the same shape: %.3f ms (CUDA '
          'events, one warm run) [%s]' % (plain_ms, card))
    print('decode_lattice bound: %.3f ms by %s (%.3g f32 FLOP at 67 '
          'TFLOP/s, %d bytes at 3.35 TB/s); kernel at %.2f%% of it; '
          'library call: none - no single PyTorch call computes lattice '
          'decoding' % (bound_ms, bound_by, flops,
                        nbytes, 100 * bound_ms / ms2))
    return dict(ms=ms2, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


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


def stream_batches(files, vocab, train=False, rng=None):
    from ocrd_keraslm_torch import data as pdata
    return pdata.gen_stateful_streams(
        files, vocab, length=TRAIN_T, batch_size=TRAIN_B, n_contexts=1,
        train=train, rng=rng)


def run_train_cli(work, model, files, epochs, seed, extra=()):
    """``keraslm-rate train`` at the main path's width on the card, in
    this process, counts zeroed before; returns (wall s, counts, the
    chars/s the trainer logged per epoch)."""
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
                 'KERASLM_CKPT_DIR': os.path.join(work, 'ckpt')})
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
    assert counts == {
        'decode_lattice': 0, 'score_scan': 0, 'lstm_bwd': steps * TRAIN_D,
        'lstm_scan': (steps + epochs * n_val) * TRAIN_D}, (counts, n_val)
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
                epochs=epochs, rates=rates, launches=counts,
                launches_bf16=counts16, plan=plan, vocab=vocab,
                n_chars=n_chars)


def trainer(device, vocab, compute_dtype='float32'):
    """A configured ``Rater`` at the main path's width with fresh
    parameters (``configure`` seeds them), trainable copies of them and
    their optimizer."""
    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.rater import Rater
    rater = Rater(device=device)
    rater.width, rater.depth, rater.length = TRAIN_W, TRAIN_D, TRAIN_T
    rater.compute_dtype = compute_dtype
    rater.vocab, rater.voc_size = vocab, vocab.size
    rater.configure()
    params = training.copy_params(rater.params, requires_grad=True)
    return rater.cfg, params, training.make_optimizer(params)


def run_steps(device, vocab, batches, compute_dtype='float32', sync=None):
    """``train_step`` over ``batches`` from a fresh initialisation and
    dropout seed 5; returns ([loss per step], final carry, [wall s per
    step] when ``sync`` is given)."""
    import torch
    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.models.lstm_lm import zero_carry
    cfg, params, optimizer = trainer(device, vocab, compute_dtype)
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
    return out


def main() -> int:
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on a '
              'GPU', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    for L in (1, 8):
        print('shared memory decode_lattice: %d bytes dynamic per block at '
              'K=16, A=4, L=%d (one block of 512 threads per document)'
              % (dk._library().decode_lattice_smem_bytes(
                  4, L, 16, D, W, wts['v_pad']), L))
    print('shared memory score_scan: %d bytes dynamic per block at B=4, '
          'D=%d, W=%d, Vp=%d; lstm_scan: %d bytes at B=4, W=%d (one block '
          'of 512 threads per <= 8 streams)'
          % (sk._library().score_scan_smem_bytes(4, D, W, wts['v_pad']), D,
             W, wts['v_pad'], lc._library().lstm_scan_smem_bytes(4, W, 0), W))
    print('shared memory at the training shape (B=%d, W=%d, 8 streams a '
          'block): lstm_scan %d bytes with an f32 U, %d with a bf16 U (the '
          'rounded h beside h, c and z); lstm_bwd %d bytes; its dU product '
          'splits the %d rows %d ways'
          % (TRAIN_B, TRAIN_W,
             lc._library().lstm_scan_smem_bytes(TRAIN_B, TRAIN_W, 0),
             lc._library().lstm_scan_smem_bytes(TRAIN_B, TRAIN_W, 1),
             lc._bwd_library().lstm_bwd_smem_bytes(TRAIN_B, TRAIN_W),
             TRAIN_B * TRAIN_T,
             lc._bwd_library().lstm_bwd_splits(TRAIN_B, TRAIN_T)))

    # ---- 3. parity at full width ----
    decode_err = decode_parity(rater, dev)
    score_err, lstm_err = score_parity(rater, dev)
    train_errs = train_parity(dev)
    print('kernels held against their plain versions: %s'
          % json.dumps(list(KERNELS)))

    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as work:
        # ---- 4. decode path, 5. scoring path, 6. training path ----
        decode = decode_path(rater, work)
        scoring = scoring_path(rater, work)
        train = training_path(work, card)
        training_steps(train, dev, card)

        # ---- 7. numbers ----
        print('decode path wall: %.3f s for 4 pages = %.3f s/page, %.0f '
              'decode edges/s (host clock, CLI call incl. model load) [%s]'
              % (decode['wall'], decode['wall'] / 4,
                 decode['n_edges'] / decode['wall'], card))
        print_profile('decode path', decode['traced_wall'], decode['busy'],
                      card)
        print('scoring path wall: %.3f s for 4 pages = %.3f s/page, %.0f '
              'scored chars/s (host clock, CLI call incl. model load) [%s]'
              % (scoring['wall'], scoring['wall'] / 4,
                 scoring['n_chars'] / scoring['wall'], card))
        print_profile('scoring path', scoring['traced_wall'],
                      scoring['busy'], card)
        print('training path wall: %.3f s for the CLI call (2 epochs: %d '
              'steps, %d validation steps, split, vocabulary, checkpoints '
              'and model write included); the trainer\'s own chars/s per '
              'epoch (training chars over the epoch\'s training and '
              'validation time): %s [%s]'
              % (train['wall'], train['steps'], train['val_steps'],
                 ['%.0f' % r for r in train['rates']], card))
        numbers = dict(decode_lattice=decode_numbers(rater, decode, card),
                       **scoring_numbers(rater, scoring, card),
                       **training_numbers(dev, card))
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
             train_errs['lstm_bwd_bf16'])):
        assert launches > 0, (name, 'was not launched on its path')
        module = {'decode_lattice': 'decode_kernel.py:318',
                  'score_scan': 'score_kernel.py:132',
                  'lstm_scan': 'lstm_cell.py:111',
                  'lstm_bwd': 'lstm_cell.py:252'}[source]
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
    sys.exit(main())
