"""The wide layout of the LSTM recurrence kernels (``ops/scan_layout.py``
``wide_layout_for``; ``csrc/wide_common.cuh``): the chooser's host
arithmetic on the CPU, and on the card (``gpu``) the kernels at W=1840
against the one-block layout (bit for bit: every layout sums each column
in 32-term blocks added in order, 1840 = 57 x 32 + 16) and against the
plain versions, one training step of AWD-LSTM's enwik8 model at its
published widths against the plain reference, and the device trace of a
step.

Tolerances against the plain versions (float32 on the card, TF32 off):
the plain version sums each column of 1840 terms in cuBLAS's order, the
kernels in 32-term blocks: rtol 1e-4, atol 2e-5 (the ``lstm_scan`` and
``lstm_bwd`` tests of ``test_torch_gpu.py`` at W=512); bfloat16 products
are off by ~1e-2.
"""
import numpy as np
import pytest
import torch

from ocrd_keraslm_torch.ops import scan_layout as sl

torch.set_num_threads(1)

N_SM = 132  # an H100's SMs


def fits(lay):
    return 1 << 20


@pytest.mark.parametrize('kind', ['lstm', 'bwd'])
@pytest.mark.parametrize('B', [1, 8, 128])
def test_the_wide_layout_takes_width_1840(kind, B):
    """At W=1840 no register or grid layout fits; the wide layout does,
    one block an SM (115 of 16 units' gate columns; 4 x 29 of 64 units'
    quarters of U^T), and its cost model beats the one-block layout's."""
    lay = sl.choose(kind, B, 1840, 1, fits, N_SM)
    assert lay.wide and not lay.grid and not lay.reg
    assert lay == sl.wide_layout_for(kind, B, 1840, N_SM)
    assert (lay.rb, lay.cl, lay.rt) == (B, 115 if kind == 'lstm' else 116, 0)
    assert lay.smem == sl.WIDE_SMEM <= sl.SMEM_MAX
    one = sl.one_block_layout(kind, B, 1840, 1)
    assert sl.step_cost(kind, 1840, 1, lay) < \
        sl.step_cost(kind, 1840, 1, one) * sl.waves(B, one, fits, N_SM)
    sl.check(kind, B, 1840, 1, lay)


@pytest.mark.parametrize('kind', ['lstm', 'bwd'])
def test_width_512_keeps_the_grid_layout(kind):
    lay = sl.choose(kind, 128, 512, 1, fits, N_SM)
    assert lay.grid and not lay.wide
    assert lay == sl.grid_layout_for(kind, 128, 512, 32)


@pytest.mark.parametrize('kind', ['lstm', 'bwd'])
@pytest.mark.parametrize('W', [400, 512, 256])
def test_the_wide_layout_takes_no_width_another_layout_serves(kind, W):
    """Widths up to 512 are the other layouts' (W=400, AWD's last layer,
    runs the one-block layout); the score kind has no wide layout."""
    assert sl.wide_layout_for(kind, 128, W, N_SM) is None
    assert not sl.choose(kind, 128, W, 1, fits, N_SM).wide
    assert sl.wide_layout_for('score', 128, 1840, N_SM) is None
    assert sl.choose(kind, 128, 400, 1, fits, N_SM) == \
        sl.one_block_layout(kind, 128, 400, 1)


def test_the_wide_layout_needs_its_blocks_on_the_card():
    """Fewer SMs than its blocks, more than 128 streams or a width not a
    multiple of 4: no wide layout, the one-block layout."""
    assert sl.wide_layout_for('lstm', 128, 1840, 114) is None
    assert sl.wide_layout_for('bwd', 128, 1840, 115) is None
    assert sl.wide_layout_for('lstm', 129, 1840, N_SM) is None
    assert sl.wide_layout_for('lstm', 128, 1842, N_SM) is None
    assert sl.choose('lstm', 128, 1840, 1, fits, 114) == \
        sl.one_block_layout('lstm', 128, 1840, 1)
    assert sl.waves(128, sl.wide_layout_for('lstm', 128, 1840, N_SM),
                    fits, 114) == 0


@pytest.mark.parametrize('field, value', [
    ('rb', 64), ('cl', 116), ('rt', 1), ('smem', 1024)])
def test_check_refuses_another_wide_layout(field, value):
    lay = sl.wide_layout_for('lstm', 128, 1840, N_SM)
    with pytest.raises(ValueError):
        sl.check('lstm', 128, 1840, 1, lay._replace(**{field: value}))


def test_wide_plan_bytes():
    """A block's ring, whatever B: 8 stages of room for 128 rows of 32
    floats and a 32 x 64 chunk of packed columns, 1024 bytes to align
    it, an mbarrier a stage."""
    assert sl.WIDE_SMEM == 1024 + 8 * (128 * 128 + 8192) + 64
    assert sl.wide_layout_for('lstm', 1, 1840, N_SM).smem == sl.WIDE_SMEM
    assert sl.wide_blocks('lstm', 1840) == 115
    assert sl.wide_blocks('bwd', 1840) == 116


# -- on the card ---------------------------------------------------------

@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('B', [1, 8, 128])
def test_wide_layout_equals_one_block_at_width_1840(cuda, B):
    from chip_smoke import lstm_bwd_args, scan_layout
    from gen_beam_phases import wide_inputs
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    fwd, cot = wide_inputs(cuda, B, 16, 1840)
    assert lc.scan_layout_on(cuda, B, 1840, False).wide
    assert lc.bwd_layout_on(cuda, B, 1840).wide
    scan0, bwd0 = lc.lstm_scan.wide, lc.lstm_bwd.wide
    f = lc.lstm_scan(*fwd, want_c_all=True)
    b = lc.lstm_bwd(*lstm_bwd_args(fwd, cot, f[:2]))
    assert (lc.lstm_scan.wide - scan0, lc.lstm_bwd.wide - bwd0) == (1, 1)
    with scan_layout(reg=False):  # the one-block layout
        f1 = lc.lstm_scan(*fwd, want_c_all=True)
        b1 = lc.lstm_bwd(*lstm_bwd_args(fwd, cot, f1[:2]))
    for x, y in zip(list(f) + list(b), list(f1) + list(b1)):
        assert torch.equal(x, y)
    rf = lc.lstm_scan_ref(*fwd, want_c_all=True)
    rb = lc.lstm_bwd_ref(*lstm_bwd_args(fwd, cot, rf[:2]))
    for x, y in zip(list(f) + [b[0], b[2], b[3]],
                    list(rf) + [rb[0], rb[2], rb[3]]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=2e-5)
    scale = float(rb[1].abs().max())
    assert float((b[1] - rb[1]).abs().max()) <= 1e-4 * scale


def _awd_model(dev, V=60, seed=7):
    """AWD-LSTM's enwik8 model at its published widths: the reference's
    weights and the port's configuration."""
    import awd_lstm_reference as ref
    from ocrd_keraslm_torch.models import lstm_lm as lm
    w = ref.init_weights(seed, V, (1840, 1840, 400), dev)
    cfg = lm.LMConfig(width=400, depth=3, voc_size=V, contexts=(),
                      widths=(1840, 1840, 400), head_bias=True,
                      weight_drop=0.2, dropout_input=0.1, dropout_hidden=0.1,
                      dropout_output=0.4, length=200)
    params = {'char_embedding': w['char_embedding'].clone(),
              'context_embeddings': [],
              'lstm': [{k: v.clone() for k, v in lw.items()}
                       for lw in w['lstm']],
              'head_bias': w['head_bias'].clone()}
    for t in lm.param_leaves(params):
        t.requires_grad_(True)
    return w, cfg, params


@pytest.mark.gpu
def test_train_step_at_published_widths_matches_the_reference(cuda):
    """One ``train_step`` of the full configuration (B=128, T=200) on the
    card against the plain reference from the same weights, batch and
    masks: each leaf's first gradient (Adam's first moment over 1 -
    beta1) within 1e-4 of the leaf's largest (the float32 sums of
    25,600 positions in two orders; bfloat16 products are off by ~1e-2),
    and the wide kernels launched twice each."""
    import awd_lstm_reference as ref
    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.models import lstm_lm as lm
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    B, T, V = 128, 200, 60
    w, cfg, params = _awd_model(cuda, V)
    rng = np.random.default_rng(3)
    x, y = rng.integers(1, V, (B, T)), rng.integers(1, V, (B, T))
    mask = np.ones((B, T), np.float32)
    opt = training.make_optimizer(params)
    gen = torch.Generator().manual_seed(17)
    masks = ref.trainer_masks(gen.get_state(), 1, B, 400, (1840, 1840, 400),
                              0.2, 0.1, 0.1, 0.4, cuda)
    scan0, bwd0 = lc.lstm_scan.wide, lc.lstm_bwd.wide
    training.train_step(params, opt, cfg, torch.as_tensor(x, device=cuda), [],
                        torch.as_tensor(y, device=cuda),
                        torch.as_tensor(mask, device=cuda),
                        lm.zero_carry(cfg, B, cuda), gen)
    assert (lc.lstm_scan.wide - scan0, lc.lstm_bwd.wide - bwd0) == (2, 2)
    want = ref.train_steps(w, [(x, y, mask, True)], masks, cuda)
    for (name, _), p in zip(ref.leaves(w), lm.param_leaves(params)):
        got = opt.state[p]['exp_avg'] / 0.1
        scale = float(want['grads'][name].abs().max())
        err = float((got - want['grads'][name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.gpu
def test_trace_of_a_step_holds_two_wide_kernels_each(cuda):
    from torch.profiler import ProfilerActivity, profile
    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.models import lstm_lm as lm
    B, T, V = 128, 200, 60
    _, cfg, params = _awd_model(cuda, V)
    opt = training.make_optimizer(params)
    x = torch.randint(1, V, (B, T), device=cuda)
    args = (params, opt, cfg, x, [], x, torch.ones((B, T), device=cuda),
            lm.zero_carry(cfg, B, cuda), torch.Generator().manual_seed(1))
    training.train_step(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        training.train_step(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum('lstm_scan_wide_kernel' in n for n in names) == 2, names
    assert sum('lstm_bwd_wide_kernel' in n for n in names) == 2, names
