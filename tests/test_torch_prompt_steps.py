"""Generation's prompt steps on the CPU: the LSTM stack step without the
tied-softmax logits, the plain prompt loop, and the step that the card
captures as a CUDA graph, run here in plain PyTorch over its static
buffers.  Each is held bit for bit (``torch.equal``) to the prompt loop
as it was before the logits left the prompt step (``_old_gen_layers``,
``_old_prefix_state`` below, kept as the reference).  The card's graph
path is held to the plain loop in ``test_torch_gpu.py``."""
import os

import numpy as np
import pytest
import torch

from ocrd_keraslm_torch.ops import beam_device as bd

torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'pretrained', 'model_german.h5')
TEXT = ('Was ist Aufklärung? Aufklärung ist der Ausgang des Menschen aus '
        'seiner selbstverschuldeten Unmündigkeit. Unmündigkeit ist das '
        'Unvermögen, sich seines Verstandes ohne Leitung eines anderen zu '
        'bedienen.')
# prompt lengths in chars: the shortest, the cell's longest (36), and
# both sides of the 64-column bucket's edge
LENGTHS = (1, 2, 6, 36, 64, 65)


def _old_gen_layers(emb, embT, wcat, bias, v_real, state):
    W = emb.shape[1]
    D = wcat.shape[0]
    new_h, new_c = [], []
    inp = state[:, :W]
    for d in range(D):
        operand = torch.cat([inp, state[:, (1 + d) * W:(2 + d) * W]], 1)
        z = operand @ wcat[d] + bias[d]
        i = torch.sigmoid(z[:, :W])
        f = torch.sigmoid(z[:, W:2 * W])
        g = torch.tanh(z[:, 2 * W:3 * W])
        o = torch.sigmoid(z[:, 3 * W:])
        c2 = f * state[:, (1 + D + d) * W:(2 + D + d) * W] + i * g
        h2 = o * torch.tanh(c2)
        new_h.append(h2)
        new_c.append(c2)
        inp = h2
    logits = inp @ embT
    col = torch.arange(logits.shape[1], device=logits.device)
    logits = torch.where(col[None, :] < v_real, logits, -bd.NEG_INF)
    return torch.cat(new_h + new_c, 1), logits


def _old_prefix_state(emb, embT, wcat, bias, prefix, prefix_mask, v_real):
    W = emb.shape[1]
    D = wcat.shape[0]
    N = prefix.shape[0]
    steps = int(prefix_mask.sum(axis=1).max()) if prefix_mask.size else 0
    ids = torch.from_numpy(np.ascontiguousarray(prefix, np.int64))
    mask = torch.from_numpy(np.ascontiguousarray(prefix_mask, np.float32))
    state = torch.zeros((N, (2 * D + 1) * W), dtype=torch.float32)
    for t in range(steps):
        xemb = emb[ids[:, t]]
        hs, _ = _old_gen_layers(emb, embT, wcat, bias, v_real,
                                torch.cat([xemb, state[:, W:]], 1))
        state = torch.where(mask[:, t, None] > 0,
                            torch.cat([xemb, hs], 1), state)
    n_prefix = torch.from_numpy(prefix_mask.sum(axis=1).astype(np.int64))
    last = ids.gather(1, n_prefix[:, None])[:, 0]
    return torch.cat([emb[last], state[:, W:]], 1)


@pytest.fixture(scope='module')
def german():
    """The german model's generation weights (emb, embT, wcat, bias),
    v_real and vocabulary on the CPU."""
    from ocrd_keraslm_torch.rater import Rater
    rater = Rater(device='cpu')
    rater.load_config(MODEL)
    rater.configure()
    rater.load_weights(MODEL)
    w = rater._decode_weights(None)
    return (w['emb'], w['embT'], w['wcat'], w['bias']), w['v_real'], \
        rater.vocab


def _prompts(vocab, lengths):
    enc = [vocab.encode(TEXT[:n]) for n in lengths]
    assert [len(e) for e in enc] == list(lengths)
    return bd._prefix_arrays(enc)


@pytest.mark.parametrize('D', [1, 2])
def test_stack_step_equals_the_layers_state(D):
    """The step without logits gives the state of the step with them,
    and ``_gen_layers`` (which the beam engines keep) gives both of the
    old step, bit for bit."""
    rng = np.random.default_rng(D)
    W, Vp, v_real, N = 32, 128, 70, 7
    emb = np.zeros((Vp, W), np.float32)
    emb[:v_real] = rng.normal(0, 1, (v_real, W))
    emb, embT, wcat, bias = (torch.from_numpy(a) for a in (
        emb, emb.T.copy(),
        rng.normal(0, 0.3, (D, 2 * W, 4 * W)).astype(np.float32),
        rng.normal(0, 0.1, (D, 1, 4 * W)).astype(np.float32)))
    state = torch.from_numpy(
        rng.normal(0, 1, (N, (2 * D + 1) * W)).astype(np.float32))
    want_hs, want_logits = _old_gen_layers(emb, embT, wcat, bias, v_real,
                                           state)
    hs, top = bd._gen_stack(wcat, bias, state[:, :W], state)
    assert torch.equal(hs, want_hs)
    assert torch.equal(top, want_hs[:, (D - 1) * W:D * W])
    hs, logits = bd._gen_layers(emb, embT, wcat, bias, v_real, state)
    assert torch.equal(hs, want_hs)
    assert torch.equal(logits, want_logits)


@pytest.mark.parametrize('n_chars', LENGTHS)
def test_prefix_state_on_the_cpu_is_unchanged(german, n_chars):
    """One stream: the prompt loop without logits gives the old root
    rows bit for bit, and counts no capture or replay on the CPU."""
    (emb, embT, wcat, bias), v_real, vocab = german
    ids, mask = _prompts(vocab, [n_chars])
    counts = bd._prefix_state.captures, bd._prefix_state.replays
    got = bd._prefix_state(emb, wcat, bias, ids, mask)
    assert torch.equal(got, _old_prefix_state(emb, embT, wcat, bias, ids,
                                              mask, v_real))
    assert (bd._prefix_state.captures, bd._prefix_state.replays) == counts


def test_prefix_state_of_ragged_streams_is_unchanged(german):
    """Six streams of every length at once (the 256-column bucket): the
    shorter ones keep their state after their prompt ends."""
    (emb, embT, wcat, bias), v_real, vocab = german
    ids, mask = _prompts(vocab, LENGTHS)
    assert ids.shape == (6, 256)
    got = bd._prefix_state(emb, wcat, bias, ids, mask)
    assert torch.equal(got, _old_prefix_state(emb, embT, wcat, bias, ids,
                                              mask, v_real))


@pytest.mark.parametrize('lengths', [(36,), (65,), LENGTHS],
                         ids=['n1-36', 'n1-65', 'n6'])
def test_captured_step_run_in_plain_pytorch_matches(german, lengths):
    """The card's captured step, run here eagerly over its buffers (a
    staged request, one step a call with ``t`` on the device, then the
    root rows): equal to the plain loop, also for a second, shorter
    request staged over the first one's buffers."""
    (emb, _, wcat, bias), _, vocab = german
    n = len(lengths)
    run = bd._PromptSteps(emb, wcat, n, 64)
    for req in (lengths, tuple(max(k // 3, 1) for k in lengths)):
        ids, mask = _prompts(vocab, req)
        steps = bd._prompt_steps(mask)
        run.stage(ids, mask, steps)
        for _ in range(steps):
            run.step(emb, wcat, bias)
        assert int(run.t) == steps
        assert torch.equal(run.root(emb),
                           bd._prefix_eager(emb, wcat, bias, ids, mask))
