"""The model core of the port against the JAX package on the CPU:
``forward_seq`` in all its modes, the regularizers, the cross-entropy,
dropout and ``init_params``.

Weights and inputs are made with numpy from a seed and given to both.
Tolerances: f32 logits and carry atol 1e-5 (the same f32 products
summed in another order over <= 12 steps).  ``compute_dtype='bfloat16'``:
atol 2e-3 on logits and carry: operands are rounded to bf16 at the same
places in both packages and products are exact, but a last-bit
difference in a sum can round an activation to the neighbouring bf16
value, 2^-8 relative (values here are of order 1, and a flipped
activation enters the next product with weights of order 0.2).
Regularizers and cross-entropy: rtol 1e-5, their gradients rtol 1e-4 /
atol 1e-6."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrd_keraslm_tpu.models import lstm_lm as jlm
from ocrd_keraslm_torch.models import lstm_lm as tlm

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 1e-5


def seeded_params(cfg, seed):
    """Seeded f32 numpy parameters in the shared tree layout."""
    rng = np.random.default_rng(seed)
    W = cfg.width

    def normal(scale, shape):
        return rng.normal(0, scale, shape).astype(np.float32)
    return {'char_embedding': normal(1, (cfg.voc_size, W)),
            'context_embeddings': [normal(1, (n, d))
                                   for n, d in cfg.contexts],
            'lstm': [{'kernel': normal(1 / np.sqrt(fan_in),
                                       (fan_in, 4 * W)),
                      'recurrent': normal(1 / np.sqrt(W), (W, 4 * W)),
                      'bias': normal(0.1, (4 * W,))}
                     for fan_in in [cfg.input_dim] + [W] * (cfg.depth - 1)]}


def jax_params(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def both_cfgs(**kw):
    cfg = jlm.LMConfig(**kw)
    return cfg, tlm.LMConfig(**dataclasses.asdict(cfg))


def seeded_batch(cfg, seed, B=3, T=12):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.voc_size, (B, T)).astype(np.int32)
    zs = [rng.integers(0, n, (B,)).astype(np.int32)
          for n, _ in cfg.contexts]
    h0 = rng.normal(0, 0.5, (cfg.depth, B, cfg.width)).astype(np.float32)
    c0 = rng.normal(0, 0.5, (cfg.depth, B, cfg.width)).astype(np.float32)
    return x, zs, h0, c0


def run_both(cfg, tcfg, tree, x, zs, h0, c0, x_mask=None, use_pallas=False):
    want, (wh, wc) = jlm.forward_seq(
        jax_params(tree), cfg, jnp.asarray(x), [jnp.asarray(z) for z in zs],
        (jnp.asarray(h0), jnp.asarray(c0)), use_pallas=use_pallas,
        x_mask=None if x_mask is None else jnp.asarray(x_mask))
    got, (gh, gc) = tlm.forward_seq(
        tlm.params_from_numpy(tree, 'cpu'), tcfg,
        torch.from_numpy(x).long(), [torch.from_numpy(z).long() for z in zs],
        (torch.from_numpy(h0), torch.from_numpy(c0)),
        x_mask=None if x_mask is None else torch.from_numpy(x_mask))
    return ((got.numpy(), gh.numpy(), gc.numpy()),
            (np.asarray(want), np.asarray(wh), np.asarray(wc)))


MODES = [(1, ()), (3, ((20, 4), (7, 3)))]


@pytest.mark.parametrize('depth, contexts', MODES)
@pytest.mark.parametrize('mode', ['plain', 'x_mask', 'bfloat16',
                                  'bfloat16_x_mask'])
def test_forward_seq_modes_match_jax(depth, contexts, mode):
    bf16 = mode.startswith('bfloat16')
    cfg, tcfg = both_cfgs(width=16, depth=depth, length=12, voc_size=13,
                          contexts=contexts,
                          compute_dtype='bfloat16' if bf16 else 'float32')
    tree = seeded_params(cfg, depth)
    x, zs, h0, c0 = seeded_batch(cfg, depth + 10)
    x_mask = None
    if mode.endswith('x_mask'):
        x_mask = np.ones(x.shape, np.float32)
        x_mask[0, :5] = 0.0     # a left-padded short window
        x_mask[2, :11] = 0.0
    atol = 2e-3 if bf16 else ATOL
    for use_pallas in ((False, True) if x_mask is None else (False,)):
        got, want = run_both(cfg, tcfg, tree, x, zs, h0, c0, x_mask,
                             use_pallas)
        for name, g, w in zip(('logits', 'h', 'c'), got, want):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=name)


def test_masked_window_equals_short_window():
    """A left-padded window with its mask gives the logits and carry of
    the unpadded short window."""
    _, tcfg = both_cfgs(width=16, depth=2, length=8, voc_size=9,
                        contexts=((20, 4),))
    params = tlm.params_from_numpy(seeded_params(tcfg, 3), 'cpu')
    x = torch.tensor([[0, 0, 0, 4, 2, 7, 1, 3]])
    mask = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 1.]])
    z = [torch.tensor([5])]
    full, (h, c) = tlm.forward_seq(params, tcfg, x, z, x_mask=mask)
    short, (hs, cs) = tlm.forward_seq(params, tcfg, x[:, 3:], z)
    torch.testing.assert_close(full[:, 3:], short, rtol=0, atol=1e-6)
    torch.testing.assert_close(h, hs, rtol=0, atol=1e-6)
    torch.testing.assert_close(c, cs, rtol=0, atol=1e-6)


def test_bfloat16_mode_rounds_operands_not_results():
    """Under bfloat16 the logits differ from f32's (operands rounded)
    but stay f32 values: the products are not rounded to bf16."""
    _, tcfg = both_cfgs(width=16, depth=2, length=12, voc_size=13,
                        contexts=((20, 4),))
    params = tlm.params_from_numpy(seeded_params(tcfg, 4), 'cpu')
    x, zs, _, _ = seeded_batch(tcfg, 4)
    args = (torch.from_numpy(x).long(),
            [torch.from_numpy(z).long() for z in zs])
    ref, _ = tlm.forward_seq(params, tcfg, *args)
    out, (h, _) = tlm.forward_seq(
        params, tcfg.replace(compute_dtype='bfloat16'), *args)
    assert out.dtype == h.dtype == torch.float32
    assert not torch.equal(out, out.to(torch.bfloat16).float())
    diff = (torch.softmax(ref, -1) - torch.softmax(out, -1)).abs().max()
    assert 0 < float(diff) < 0.03
    with pytest.raises(ValueError, match='compute_dtype'):
        tlm.forward_seq(params, tcfg.replace(compute_dtype='float16'),
                        *args)


def test_forward_seq_gradients_match_jax():
    """d(loss)/d(params) through ``forward_seq`` and ``sequence_xent``
    (the path ``train_step`` differentiates), f32, depth 2."""
    cfg, tcfg = both_cfgs(width=16, depth=2, length=12, voc_size=13,
                          contexts=((20, 4),), dropout=0.0)
    tree = seeded_params(cfg, 5)
    x, zs, h0, c0 = seeded_batch(cfg, 5)
    y = np.random.default_rng(6).integers(0, 13, x.shape).astype(np.int32)

    def jloss(p):
        logits, _ = jlm.forward_seq(
            p, cfg, jnp.asarray(x), [jnp.asarray(z) for z in zs],
            (jnp.asarray(h0), jnp.asarray(c0)))
        return jlm.sequence_xent(logits, jnp.asarray(y))[0] \
            + jlm.regularization_loss(p)
    want = jax.grad(jloss)(jax_params(tree))
    params = tlm.params_from_numpy(tree, 'cpu')
    for t in tlm.param_leaves(params):
        t.requires_grad_()
    logits, _ = tlm.forward_seq(
        params, tcfg, torch.from_numpy(x).long(),
        [torch.from_numpy(z).long() for z in zs],
        (torch.from_numpy(h0), torch.from_numpy(c0)))
    loss = tlm.sequence_xent(logits, torch.from_numpy(y).long())[0] \
        + tlm.regularization_loss(params)
    loss.backward()
    want_leaves = ([want['char_embedding']] + want['context_embeddings']
                   + [lp[k] for lp in want['lstm']
                      for k in ('kernel', 'recurrent', 'bias')])
    for g, w in zip(tlm.param_leaves(params), want_leaves):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('name, rows', [
    ('char_embedding_regularizer', 9), ('char_embedding_regularizer', 1),
    ('context_embedding_regularizer', 20)])
def test_regularizers_match_jax(name, rows):
    emb = np.random.default_rng(rows).normal(0, 0.7, (rows, 6)).astype(
        np.float32)
    want, wgrad = jax.value_and_grad(getattr(jlm, name))(jnp.asarray(emb))
    t = torch.from_numpy(emb).requires_grad_()
    got = getattr(tlm, name)(t)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    if rows > 1:
        got.backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wgrad),
                                   rtol=1e-4, atol=1e-6)


def test_regularization_loss_matches_jax():
    cfg, tcfg = both_cfgs(width=8, depth=1, voc_size=11,
                          contexts=((20, 4), (7, 3)))
    tree = seeded_params(cfg, 8)
    want = jlm.regularization_loss(jax_params(tree))
    got = tlm.regularization_loss(tlm.params_from_numpy(tree, 'cpu'))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize('shape, masked', [((3, 7), False), ((3, 7), True),
                                           ((5,), True), ((4,), 'empty')])
def test_sequence_xent_matches_jax(shape, masked):
    rng = np.random.default_rng(len(shape))
    logits = rng.normal(0, 2, shape + (11,)).astype(np.float32)
    y = rng.integers(0, 11, shape).astype(np.int32)
    mask = None
    if masked == 'empty':
        mask = np.zeros(shape, np.float32)
    elif masked:
        mask = (rng.random(shape) < 0.6).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    (wn, wa), wg = jax.value_and_grad(
        lambda lg: jlm.sequence_xent(lg, jnp.asarray(y), jm),
        has_aux=True)(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    gn, ga = tlm.sequence_xent(t, torch.from_numpy(y).long(),
                               None if mask is None
                               else torch.from_numpy(mask))
    np.testing.assert_allclose(gn.item(), float(wn), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ga.item(), float(wa), rtol=1e-6)
    gn.backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), rtol=1e-4,
                               atol=1e-7)


def test_dropout_mask_shape_scale_and_seed():
    """The keep mask is (B, 1, W), constant over time, 0 or 1/(1-p),
    applied to the output of every layer above the first (the last one
    included) and to none in eval mode; the same seed gives the same
    mask."""
    cfg = tlm.LMConfig(width=16, depth=3, voc_size=9, contexts=(),
                       dropout=0.25)
    keep = tlm.dropout_keep(cfg, 5, torch.Generator().manual_seed(3), 'cpu')
    assert keep.shape == (5, 1, 16)
    np.testing.assert_allclose(np.unique(keep.numpy()), [0.0, 1 / 0.75],
                               rtol=1e-6)
    again = tlm.dropout_keep(cfg, 5, torch.Generator().manual_seed(3), 'cpu')
    assert torch.equal(keep, again)

    params = tlm.params_from_numpy(seeded_params(cfg, 9), 'cpu')
    x = torch.from_numpy(np.random.default_rng(9).integers(0, 9, (5, 6)))
    clean, carry_clean = tlm.forward_seq(params, cfg, x, [])
    # with depth 2 one mask is drawn, for the top layer's output (layer
    # 0's is never dropped): the logits are the clean top-layer h times
    # that mask, through the tied softmax
    from ocrd_keraslm_torch.ops.lstm_cell import lstm_scan_ref
    cfg2 = cfg.replace(depth=2)
    p2 = dict(params, lstm=params['lstm'][:2])
    top = tlm.embed_inputs(p2, x, [])
    for lp in p2['lstm']:
        h_all = lstm_scan_ref(top @ lp['kernel'] + lp['bias'],
                              torch.zeros(5, 16), torch.zeros(5, 16),
                              lp['recurrent'])[0]
        top = h_all.transpose(0, 1)
    dropped2, carry2 = tlm.forward_seq(
        p2, cfg2, x, [], train=True, rng=torch.Generator().manual_seed(3))
    torch.testing.assert_close(
        dropped2, (top * keep) @ params['char_embedding'].T, rtol=0,
        atol=1e-5)
    # the carry is the undropped state
    torch.testing.assert_close(
        carry2[0], tlm.forward_seq(p2, cfg2, x, [])[1][0])
    # depth 3: two masks are drawn, one per layer above the first
    g = torch.Generator().manual_seed(3)
    tlm.forward_seq(params, cfg, x, [], train=True, rng=g)
    g2 = torch.Generator().manual_seed(3)
    tlm.dropout_keep(cfg, 5, g2, 'cpu')
    tlm.dropout_keep(cfg, 5, g2, 'cpu')
    assert torch.equal(g.get_state(), g2.get_state())
    # no rng, no train, or dropout 0: nothing is dropped
    for kw in (dict(train=True), dict(rng=torch.Generator().manual_seed(3))):
        out, _ = tlm.forward_seq(params, cfg, x, [], **kw)
        assert torch.equal(out, clean)
    out, _ = tlm.forward_seq(params, cfg.replace(dropout=0.0), x, [],
                             train=True,
                             rng=torch.Generator().manual_seed(3))
    assert torch.equal(out, clean)


def test_init_params_shapes_and_distributions():
    """Shapes as JAX's ``init_params``; embeddings N(0, 0.001); kernel
    within the glorot-uniform limit; recurrent rows orthonormal; unit
    forget bias; the same seed gives the same weights.  (Not bit-equal
    to ``jax.random``: distributions and shapes are compared.)"""
    cfg, tcfg = both_cfgs(width=16, depth=2, length=8, voc_size=50,
                          contexts=((200, 10), (7, 3)))
    want = jlm.init_params(cfg, jax.random.PRNGKey(0))
    got = tlm.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), want)
    assert shapes == {
        'char_embedding': tuple(got['char_embedding'].shape),
        'context_embeddings': [tuple(e.shape)
                               for e in got['context_embeddings']],
        'lstm': [{k: tuple(v.shape) for k, v in lp.items()}
                 for lp in got['lstm']]}
    for emb, ref in zip([got['char_embedding']] + got['context_embeddings'],
                        [want['char_embedding']]
                        + want['context_embeddings']):
        assert 0.5 < float(emb.std()) / float(np.asarray(ref).std()) < 2.0
        assert abs(float(emb.std()) - 0.001) < 3e-4
    for layer, lp in enumerate(got['lstm']):
        fan_in = tcfg.input_dim if layer == 0 else 16
        limit = np.sqrt(6.0 / (fan_in + 64))
        assert float(lp['kernel'].abs().max()) <= limit
        assert float(lp['kernel'].abs().max()) > 0.9 * limit
        rec = lp['recurrent']
        torch.testing.assert_close(rec @ rec.T, torch.eye(16), rtol=0,
                                   atol=1e-5)
        bias = lp['bias'].numpy()
        assert (bias[16:32] == 1).all() and bias.sum() == 16
        np.testing.assert_array_equal(
            bias, np.asarray(want['lstm'][layer]['bias']))
    again = tlm.init_params(tcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tlm.param_leaves(got),
                                                 tlm.param_leaves(again)))


def test_params_round_trip_through_numpy():
    cfg = tlm.LMConfig(width=8, depth=2, voc_size=7, contexts=((5, 2),))
    tree = seeded_params(cfg, 1)
    back = tlm.params_to_numpy(tlm.params_from_numpy(tree, 'cpu'))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
