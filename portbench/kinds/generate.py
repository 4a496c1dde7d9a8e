"""Driver of the generation cells: ``keraslm-rate generate`` requests.

One client sends ``Rater.generate(prefix, number, context, variants)``
requests one after another (a closed loop), as ``keraslm-rate generate
-n NUMBER -v VARIANTS PREFIX`` calls it (the rater loaded incremental,
the unspecified context).  The traffic file gives the prompts' lengths
in chars (the words and the order seeded), the request's size and the
check's sample and limits.  Set-up loads the model and sends every prompt once.  The
window sends the prompts in a seeded order, over and over, until its
time is up; ``request_p95_ms`` is the 95th percentile of all its
requests' latencies.

The check takes one request of each prompt, drawn from the seed (every
other request of a prompt has to return the same strings), and the
reference (``reference/generate.py``) scores each returned string after
its prompt: every char has to be one that a beam step keeps (among the
step's ten most probable and above the threshold: ``rule_gap_nats``),
and the best returned string has to cost no more than the reference's
own search finds (``search_gap_nats``), so that a narrower fringe, a
broken top ten or a greedy walk shows, nor lie far from it either way
on average over the requests (``search_drift_nats``: two sound float32
searches part at a near-tie now and then, a bfloat16 one often).  The
control puts the
reference's own search in bfloat16 in the program's place; the planted
faults (:func:`planted`) put it there in float32 with a narrower
fringe.
"""
from __future__ import annotations

import gc
import logging
import os
import time

import numpy as np

from portbench import inputs, roofline
from portbench.reference import generate as rgen
from portbench.reference import lm as rlm

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Job:
    attempted = 0
    failed = 0
    trace = None


def setup(cell, seed, work, device):
    import torch
    from ocrd_keraslm_torch.rater import Rater
    logging.getLogger('ocrd_keraslm_torch').setLevel(logging.WARNING)
    cfg, traffic = cell.config, cell.traffic
    job = Job()
    job.cell, job.device = cell, device
    job.model = os.path.join(ROOT, cfg['weights'])
    job.weights, job.codepoints = rlm.load_h5(job.model)
    charset = [chr(c) for c in job.codepoints if c > 0]
    rng = np.random.default_rng(seed)
    job.prompts = [inputs.prompt(rng, charset, n)
                   for n in traffic['prompt_chars']]
    job.order = [int(i) for i in rng.permutation(len(job.prompts))]
    rater = Rater(device=device)
    rater.load_config(job.model)
    rater.stateful = False
    rater.incremental = True
    rater.configure()
    rater.load_weights(job.model)
    job.rater = rater
    job.context = rater.underspecify_contexts()
    for prompt in job.prompts:
        _request(job, prompt)
    if device == 'cuda':
        torch.cuda.synchronize()
    return job


def _request(job, prompt):
    """One ``generate`` request: its strings."""
    t = job.cell.traffic
    return job.rater.generate(prompt, t['number'], list(job.context),
                              t['variants'])


def window(job, seconds, tracer):
    import torch
    job.requests = []   # (prompt index, latency s, strings)
    ctx = tracer.window() if tracer is not None else _null()
    with ctx:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            k = job.order[i % len(job.order)]
            r0 = time.perf_counter()
            out = _request(job, job.prompts[k])
            job.requests.append((k, time.perf_counter() - r0, out))
            i += 1
            if time.perf_counter() >= deadline:
                break
        if job.device == 'cuda':
            torch.cuda.synchronize()
        job.window_s = time.perf_counter() - t0
    t = job.cell.traffic
    job.attempted = len(job.requests)
    job.failed = sum(1 for _, _, out in job.requests
                     if len(out) != t['variants'])
    w = job.weights
    D = len(w['lstm'])
    V, W = w['char_embedding'].shape
    flops, nbytes = roofline.gen_request(t['number'], rgen.FRINGE,
                                         rgen.TOPK, D, W, V)
    prompt_flops = sum(
        max(len(job.prompts[k]) - 1, 0) for k, _, _ in job.requests
    ) * roofline.decode_row_flops(D, W, V)
    job.model_flops = flops * len(job.requests) + prompt_flops
    job.bound_s = {'gen_beam': roofline.least_seconds(flops, nbytes)
                   * len(job.requests)}


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def release(job):
    import torch
    job.rater = None
    gc.collect()
    if job.device == 'cuda':
        torch.cuda.empty_cache()


def latency_p95_ms(latencies) -> float:
    """The 95th percentile (linear between order statistics) in ms."""
    return float(np.percentile(np.asarray(latencies) * 1e3, 95))


def end_to_end(job):
    return {'request_p95_ms': latency_p95_ms(
        [lat for _, lat, _ in job.requests])}


def _picks(job, seed):
    """One request of each prompt sent in the window, drawn from the
    seed, and the requests whose strings differ from those of their
    prompt's other requests (the program is deterministic)."""
    rng = np.random.default_rng([seed, 1])
    by_prompt = {}
    for i, (k, _, _) in enumerate(job.requests):
        by_prompt.setdefault(k, []).append(i)
    picks, differ = [], 0
    for k in sorted(by_prompt):
        idx = by_prompt[k]
        pick = idx[int(rng.integers(len(idx)))]
        picks.append(pick)
        differ += sum(1 for i in idx if job.requests[i][2] !=
                      job.requests[pick][2])
    return picks, differ


def _reference(job, dtype='float32'):
    if job.device == 'cuda':
        rlm.strict_float32()
    return rlm.LM(job.weights, job.device, dtype)


def _judge(job, prompts, outputs, bad):
    """The numbers compared: requests or strings not of the asked form
    (``variants`` strings, each the prompt's last char and ``number``
    mapped chars), the widest margin by which a returned char lies
    outside what a beam step keeps, by how much the best returned
    string of a request costs more than the best that the reference's
    own search finds (the widest over the requests), and how far the
    two lie apart either way on average (nats, all by the float32
    reference)."""
    t = job.cell.traffic
    encode = rlm.encoder(job.codepoints)
    lm = _reference(job)
    pairs, owner = [], []
    for r, (prompt, out) in enumerate(zip(prompts, outputs)):
        if len(out) != t['variants']:
            bad += 1
            continue
        for s in out:
            ids = encode(s[1:])
            if not s or s[0] != prompt[-1] or len(ids) != t['number'] \
                    or 0 in ids:
                bad += 1
                continue
            pairs.append((encode(prompt), ids))
            owner.append(r)
    rule_gap = search_gap = drift = 0.0
    job.diagnostics = []
    if pairs:
        scored = rgen.score_strings(lm, [p for p, _ in pairs],
                                    [c for _, c in pairs])
        key = tuple(prompts)
        if getattr(job, 'best', (None,))[0] != key:
            job.best = (key, rgen.beam_generate(
                lm, [encode(p) for p in prompts], t['number'],
                t['variants']))
        best = job.best[1]
        mine = {}
        for r, (cost, gap) in zip(owner, scored):
            mine.setdefault(r, []).append(cost)
            rule_gap = max(rule_gap, gap)
        gaps = []
        for r, costs in sorted(mine.items()):
            ref = [c for c, _ in best[r]]
            costs = sorted(costs)
            gaps.append(costs[0] - ref[0])
            job.diagnostics.append({
                'prompt': r, 'search_gap': gaps[-1],
                'variant_gaps': [a - b for a, b in zip(costs, ref)]})
        search_gap = max(gaps)
        drift = float(np.mean(np.abs(gaps)))
    lim = t['check']['limits']
    return [
        {'name': 'bad_outputs', 'value': float(bad), 'limit': 0.0},
        {'name': 'rule_gap_nats', 'value': float(rule_gap),
         'limit': lim['rule_gap_nats']},
        {'name': 'search_gap_nats', 'value': float(search_gap),
         'limit': lim['search_gap_nats']},
        {'name': 'search_drift_nats', 'value': drift,
         'limit': lim['search_drift_nats']}]


def _sampled(job, seed):
    picks, differ = _picks(job, seed)
    prompts = [job.prompts[job.requests[i][0]] for i in picks]
    return picks, differ, prompts


def check(job, seed):
    import torch
    picks, differ, prompts = _sampled(job, seed)
    outputs = [job.requests[i][2] for i in picks]
    numbers = _judge(job, prompts, outputs, job.failed + differ)
    if job.device == 'cuda':
        torch.cuda.empty_cache()
    return numbers


def _in_place(job, seed, dtype, fringe):
    """The check's numbers for the reference's own search put in the
    program's place, in ``dtype`` with ``fringe`` hypotheses a step."""
    t = job.cell.traffic
    _, _, prompts = _sampled(job, seed)
    encode = rlm.encoder(job.codepoints)
    i2c = {i: chr(c) for i, c in enumerate(job.codepoints) if c > 0}
    found = rgen.beam_generate(_reference(job, dtype),
                               [encode(p) for p in prompts], t['number'],
                               t['variants'], fringe=fringe)
    outputs = [[p[-1] + ''.join(i2c[i] for i in seq) for _, seq in res]
               for p, res in zip(prompts, found)]
    return _judge(job, prompts, outputs, 0)


def control(job, seed):
    """The check's numbers for the reference's search put in the
    program's place in bfloat16, on the same sampled prompts."""
    return _in_place(job, seed, 'bfloat16', rgen.FRINGE)


# narrowed searches planted in the program's place: the fringe kept
PLANTED_FRINGES = (64, 16)


def planted(job, seed):
    """{fault: the check's numbers} for the reference's float32 search
    put in the program's place with a narrower fringe."""
    return {'fringe_%d' % f: _in_place(job, seed, 'float32', f)
            for f in PLANTED_FRINGES}
