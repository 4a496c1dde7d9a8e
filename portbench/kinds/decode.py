"""Driver of the processor cells: ``ocrd-keraslm-rate`` over documents.

One warm ``KerasRate`` processor (the port's ``wrapper/rate.py``) runs
``process_workspace`` back to back over seeded documents, as a worker
of an OCR-D workflow would; the traffic file gives the documents (pages,
lines, words a line, the share of glyphs with alternatives, the year of
the METS identifier), the processor's parameters and the check's sample
and limits.  Set-up writes the documents, loads the model and runs one
pass over each document (every shape the window meets, and in a fresh
checkout the kernels' build).  The window cycles through the documents;
between two passes of a document its METS is restored and its output
group moved aside.  ``pages_per_s`` is the pages written over the
window's wall time.

The check takes a seeded sample of the pages written in the window and
holds every glyph to its input (exactly one TextEquiv, one of its
alternatives) and the confs written for glyphs with alternatives to the
plain reference's probabilities along the written path, from the
written text of the page before (``reference/lm.py``:
``conf_gap_bits``).  It also holds the search: on each document's
first page, where no beam carries over from a page before, the written
path may cost no more than the best path that the reference's own beam
search (``reference/decode.py``, at the program's K) finds
(``search_gap_bits``), so that a narrower beam, a broken top K or a
greedy walk shows.  The control puts the reference's own beam search in
bfloat16 in the program's place; the planted faults (:func:`planted`)
put it there in float32 with fewer rows.
"""
from __future__ import annotations

import gc
import logging
import os
import time

import numpy as np

from portbench import inputs, roofline
from portbench.reference import decode as rdecode
from portbench.reference import lm as rlm

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUTPUT_GRP = 'OCR-D-LM'


class Job:
    attempted = 0
    failed = 0
    trace = None


def setup(cell, seed, work, device):
    import torch
    from ocrd_keraslm_torch.wrapper import KerasRate
    logging.getLogger('ocrd_keraslm_torch').setLevel(logging.WARNING)
    cfg, traffic = cell.config, cell.traffic
    job = Job()
    job.cell, job.device = cell, device
    job.model = os.path.join(ROOT, cfg['weights'])
    job.weights, job.codepoints = rlm.load_h5(job.model)
    charset = [chr(c) for c in job.codepoints if c > 0]
    rng = np.random.default_rng(seed)
    job.docs = []
    for d in range(traffic['documents']):
        directory = os.path.join(work, 'doc%d' % d)
        pages = inputs.build_workspace(
            directory, rng, traffic['pages'], traffic['lines'], charset,
            alt_share=traffic['alt_share'],
            identifier='urn:portbench/doc%d_%d' % (d, traffic['year']),
            line_words=[tuple(traffic['line_words'])])
        with open(os.path.join(directory, 'mets.xml'), 'rb') as fh:
            job.docs.append((directory, fh.read(), pages))
    job.out = os.path.join(work, 'out')
    os.makedirs(job.out)
    params = dict(traffic['parameters'], model_file=job.model)
    job.params = params
    job.proc = KerasRate(parameter=params, device=device)
    job.proc.setup()
    job.passes = []
    for d in range(len(job.docs)):
        _pass(job, d, os.path.join(work, 'warmup%d' % d))
    if device == 'cuda':
        torch.cuda.synchronize()
    return job


def _pass(job, d, keep_as):
    """One ``process_workspace`` over document ``d``; its output group is
    moved to ``keep_as``.  Returns the pages written."""
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    directory, mets, _ = job.docs[d]
    with open(os.path.join(directory, 'mets.xml'), 'wb') as fh:
        fh.write(mets)
    job.proc.process_workspace(Workspace(directory))
    out = os.path.join(directory, OUTPUT_GRP)
    n = len(os.listdir(out)) if os.path.isdir(out) else 0
    if n:
        os.replace(out, keep_as)
    return n


class _Waits:
    """Host seconds inside the rater's ``rate_best_device_finish*``
    calls (the waits for the device's results), with a trace range
    around each; installed for a traced window only."""

    def __init__(self, rater_cls):
        import torch
        self.seconds, self.saved = 0.0, {}
        for name in dir(rater_cls):
            if not name.startswith('rate_best_device_finish'):
                continue
            raw = rater_cls.__dict__.get(name)
            if raw is None:
                continue
            self.saved[name] = raw
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                with torch.profiler.record_function('rater.' + _name):
                    try:
                        return _fn(*a, **kw)
                    finally:
                        self.seconds += time.perf_counter() - t0
            setattr(rater_cls, name, staticmethod(timed)
                    if isinstance(raw, staticmethod) else timed)
        self.cls = rater_cls

    def remove(self):
        for name, raw in self.saved.items():
            setattr(self.cls, name, raw)


def window(job, seconds, tracer):
    import torch
    from ocrd_keraslm_torch.ops import decode_kernel
    from ocrd_keraslm_torch.rater import Rater
    waits = _Waits(Rater) if tracer is not None else None
    launches0 = getattr(decode_kernel.decode_lattice, 'launches', 0)
    n_docs = len(job.docs)
    try:
        ctx = tracer.window() if tracer is not None else _null()
        with ctx:
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while True:
                i = len(job.passes)
                keep = os.path.join(job.out, 'pass%d' % i)
                job.passes.append((i % n_docs, keep,
                                   _pass(job, i % n_docs, keep)))
                if time.perf_counter() >= deadline:
                    break
            if job.device == 'cuda':
                torch.cuda.synchronize()
            job.window_s = time.perf_counter() - t0
    finally:
        if waits is not None:
            waits.remove()
    job.finish_wait_s = waits.seconds if waits is not None else None
    job.launches = getattr(decode_kernel.decode_lattice, 'launches',
                           0) - launches0
    n_pages = job.cell.traffic['pages']
    job.attempted = n_pages * len(job.passes)
    job.pages = sum(n for _, _, n in job.passes)
    job.failed = job.attempted - job.pages
    _work_counts(job)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _work_counts(job):
    """Model FLOPs and the decode kernel's least time over the window's
    pages, counted from the documents' lattices."""
    w = job.weights
    D = len(w['lstm'])
    V, W = w['char_embedding'].shape
    K = job.cell.traffic['check']['beam_rows']
    flops = nbytes = 0
    for d, _, n in job.passes:
        for positions in job.docs[d][2][:n]:
            flops += roofline.decode_page(len(positions), K, D, W, V)
            nbytes += roofline.decode_launch_bytes(
                D, W, V, len(positions), sum(len(a) for _, a in positions),
                K)
    # the weights are read once a launch, not once a page
    weights = 4 * (2 * V * W + D * (2 * W * 4 * W + 4 * W))
    nbytes += weights * (job.launches - job.pages)
    job.model_flops = flops
    job.bound_s = {'decode_lattice': roofline.least_seconds(flops, nbytes)}


def release(job):
    import torch
    job.proc = None
    gc.collect()
    if job.device == 'cuda':
        torch.cuda.empty_cache()


def end_to_end(job):
    return {'pages_per_s': job.pages / job.window_s}


def _written(job, keep, p, positions, encode):
    """The written path of page ``p`` of a pass: (chosen alternative per
    position, its char ids, written conf per position or None, glyphs
    not held to their input)."""
    path = os.path.join(keep, '%s_phys_%04d.xml' % (OUTPUT_GRP, p + 1))
    if not os.path.isfile(path):
        return None
    glyphs = inputs.read_glyphs(path)
    choice, ids, confs, bad = [], [], [], 0
    for gid, alts in positions:
        k, conf = 0, None
        if gid is not None:
            tes = glyphs.get(gid)
            chars = [a[0] for a in alts]
            if not tes or len(tes) != 1 or tes[0][0] not in chars:
                bad += 1
            else:
                k, conf = chars.index(tes[0][0]), tes[0][1]
        choice.append(k)
        ids.extend(encode(alts[k][0]))
        confs.append(conf)
    return [choice, ids, confs, bad]


def _sample(job, seed, encode):
    """The seeded sample of written pages: per page (its positions, the
    written path [choice, ids, confs, bad], the char ids of the page
    written before it in its pass, the page's index), and the pages or
    glyphs not held to their input."""
    done = [(i, p) for i, (_, _, n) in enumerate(job.passes)
            for p in range(n)]
    rng = np.random.default_rng([seed, 1])
    picks = [done[int(k)] for k in rng.choice(
        len(done), min(job.cell.traffic['check']['sample_pages'],
                       len(done)), replace=False)]
    bad = job.failed
    pages = []
    for i, p in picks:
        d, keep, _ = job.passes[i]
        positions = job.docs[d][2][p]
        got = _written(job, keep, p, positions, encode)
        if got is None:
            bad += 1
            continue
        hist = []
        if p > 0:
            prev = _written(job, keep, p - 1, job.docs[d][2][p - 1], encode)
            if prev is None:
                bad += 1
                continue
            hist = prev[1]
        bad += got[3]
        pages.append((positions, got, hist, p))
    return pages, bad


def _judge(job, lm, pages, firsts, bad, encode):
    """The numbers compared: outputs not held to their input, and the
    widest gap between a written conf and the reference's along the
    written path, at the glyphs with alternatives.  On a page after a
    document's first, the first ``settle_positions`` are left out: the
    program's path there runs on from whichever hypothesis of the
    previous page's final beam serves it best, which need not be the one
    written for that page, so the written history matches the program's
    only some chars in."""
    chk = job.cell.traffic['check']
    lm_weight = float(job.params['lm_weight'])
    z = int(np.ceil(job.cell.traffic['year'] / 10))
    start = encode('\n')[0]
    conf_gap = 0.0
    job.diagnostics = []
    if pages:
        streams = [hist + got[1] for positions, got, hist, p in pages]
        log2p = rlm.teacher_forced_log2p(lm, streams, z, start)
        for (positions, got, hist, p), lp in zip(pages, log2p):
            choice, ids, confs, _ = got
            lp = lp[len(hist):]
            alt_conf = [positions[t][1][choice[t]][1]
                        for t in range(len(positions))]
            bits = rdecode.path_bits(lp, alt_conf, lm_weight)
            s0 = chk['settle_positions'] if p else 0
            worst = (0.0, -1)
            for t, (gid, alts) in enumerate(positions):
                if t < s0 or len(alts) < 2 or confs[t] is None:
                    continue
                # written conf = 2 ** -bits of the program's own step
                gap = abs(np.log2(max(confs[t], 1e-300)) + bits[t])
                worst = max(worst, (float(gap), t))
            conf_gap = max(conf_gap, worst[0])
            job.diagnostics.append({'page': p, 'conf_gap': worst[0],
                                    'at': worst[1]})
    search_gap = _search_gap(job, lm, firsts, encode) if firsts else 0.0
    return [
        {'name': 'bad_outputs', 'value': float(bad), 'limit': 0.0},
        {'name': 'conf_gap_bits', 'value': conf_gap,
         'limit': chk['limits']['conf_gap_bits']},
        {'name': 'search_gap_bits', 'value': search_gap,
         'limit': chk['limits']['search_gap_bits']}]


def _first_pages(job, seed, encode):
    """Each document's first page as one of its passes in the window,
    drawn from the seed, wrote it: (positions, its written path), and
    the pages or glyphs not held to their input."""
    rng = np.random.default_rng([seed, 2])
    firsts, bad = [], 0
    for d in range(len(job.docs)):
        passes = [i for i, (dd, _, n) in enumerate(job.passes)
                  if dd == d and n]
        if not passes:
            continue
        i = passes[int(rng.integers(len(passes)))]
        positions = job.docs[d][2][0]
        got = _written(job, job.passes[i][1], 0, positions, encode)
        if got is None:
            bad += 1
            continue
        bad += got[3]
        firsts.append((positions, got[0]))
    return firsts, bad


def _page_bits(lm, firsts, choices, encode, z, start, lm_weight):
    """The reference's bits of each first page along ``choices``."""
    streams, confs = [], []
    for (positions, _), choice in zip(firsts, choices):
        ids, cf = [], []
        for (gid, alts), k in zip(positions, choice):
            ids.extend(encode(alts[k][0]))
            cf.append(alts[k][1])
        streams.append(ids)
        confs.append(cf)
    log2p = rlm.teacher_forced_log2p(lm, streams, z, start)
    return [float(rdecode.path_bits(lp, cf, lm_weight).sum())
            for lp, cf in zip(log2p, confs)]


def _search_gap(job, lm, firsts, encode):
    """By how many bits the written path of a document's first page
    costs more than the best path of the reference's own beam search,
    both by the float32 reference (the widest over the pages)."""
    lm_weight = float(job.params['lm_weight'])
    z = int(np.ceil(job.cell.traffic['year'] / 10))
    start = encode('\n')[0]
    written = _page_bits(lm, firsts, [c for _, c in firsts], encode, z,
                         start, lm_weight)
    best = rdecode.beam_decode(
        lm, [{'history': [], 'alts': _alt_ids(positions, encode)}
             for positions, _ in firsts],
        z, start, job.cell.traffic['check']['beam_rows'], lm_weight)
    gaps = [w - b for w, (b, _) in zip(written, best)]
    job.search_gaps = gaps
    return max(gaps)


def _alt_ids(positions, encode):
    return [[(encode(c)[0], conf) for c, conf in alts]
            for _, alts in positions]





def _reference(job, dtype='float32'):
    if job.device == 'cuda':
        rlm.strict_float32()
    return rlm.LM(job.weights, job.device, dtype)


def check(job, seed):
    import torch
    encode = rlm.encoder(job.codepoints)
    pages, bad = _sample(job, seed, encode)
    firsts, bad_first = _first_pages(job, seed, encode)
    lm = _reference(job)
    numbers = _judge(job, lm, pages, firsts, bad + bad_first, encode)
    del lm
    if job.device == 'cuda':
        torch.cuda.empty_cache()
    return numbers


def _in_place(job, seed, dtype, K):
    """The reference's own beam search (in ``dtype``, ``K`` rows) in the
    program's place: over the sampled pages, from the same written
    history, and over the documents' first pages; its confs along its
    own path.  Returns (the sampled pages, the first pages) as the
    program's would be judged."""
    encode = rlm.encoder(job.codepoints)
    pages, _ = _sample(job, seed, encode)
    firsts, _ = _first_pages(job, seed, encode)
    low = _reference(job, dtype)
    lm_weight = float(job.params['lm_weight'])
    z = int(np.ceil(job.cell.traffic['year'] / 10))
    start = encode('\n')[0]
    beams = rdecode.beam_decode(
        low, [{'history': hist, 'alts': _alt_ids(positions, encode)}
              for positions, got, hist, p in pages] +
        [{'history': [], 'alts': _alt_ids(positions, encode)}
         for positions, _ in firsts], z, start, K, lm_weight)
    firsts = [(positions, choice) for (positions, _), (_, choice)
              in zip(firsts, beams[len(pages):])]
    ctrl = []
    streams = []
    for (positions, got, hist, p), (_, choice) in zip(pages, beams):
        ids = []
        for (gid, alts), k in zip(positions, choice):
            ids.extend(encode(alts[k][0]))
        streams.append(hist + ids)
        ctrl.append((positions, [choice, ids, None, 0], hist, p))
    log2p = rlm.teacher_forced_log2p(low, streams, z, start)
    for (positions, got, hist, p), lp in zip(ctrl, log2p):
        lp = lp[len(hist):]
        alt_conf = [positions[t][1][got[0][t]][1]
                    for t in range(len(positions))]
        bits = rdecode.path_bits(lp, alt_conf, lm_weight)
        got[2] = [float(2.0 ** -b) for b in bits]
    return _judge(job, _reference(job), ctrl, firsts, 0, encode)


def control(job, seed):
    """The check's numbers for the reference's beam search put in the
    program's place in bfloat16 (products rounded to bf16): over the
    sampled pages from the same written history, its confs along its
    own path, and over the first pages, judged as the program's are."""
    return _in_place(job, seed, 'bfloat16',
                     job.cell.traffic['check']['beam_rows'])


# narrowed searches planted in the program's place: the beam's rows
PLANTED_ROWS = (4, 1)


def planted(job, seed):
    """{fault: the check's numbers} for the reference's float32 beam
    search put in the program's place with fewer rows."""
    return {'rows_%d' % k: _in_place(job, seed, 'float32', k)
            for k in PLANTED_ROWS}
