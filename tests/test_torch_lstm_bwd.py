"""The LSTM layer's backward of the port against the JAX package on the
CPU.

``lstm_bwd_ref`` (the plain version of the CUDA kernel
``csrc/lstm_bwd.cu``, which the wrapper ``lstm_bwd`` runs for CPU
tensors) is held against the Pallas kernel ``_lstm_bwd_pallas`` in
interpret mode on the same arrays; the gradients of ``LSTMScan`` (the
``torch.autograd.Function`` over the two wrappers) against ``jax.grad``
through ``lstm_scan_pallas`` and through ``_layer_scan_jnp``, and
against PyTorch's autograd through ``lstm_scan_ref``.  Inputs are made
with numpy from a seed and given to both.

Tolerances.  f32: rtol 1e-4, atol 1e-5, the JAX package's own for its
backward kernel (``tests/test_model_core.py``): the same products are
summed in another order.  bf16 U, forward: h is rounded to bf16 at every
step, so two f32 runs that differ in the last bit can round one h to the
neighbouring bf16 value (a step of 2^-8 relative); the products
themselves are exact in f32 in both packages.  On these inputs the port
reaches atol 1e-6 against ``_layer_scan_jnp`` and the Pallas kernel (no
rounding flips), not bit equality: XLA's and PyTorch's CPU products sum
the 16 terms in different orders.  bf16 U, gradients: rtol = atol = 0.02
as in the JAX test: autograd through the cast rounds dh to bf16 at every
step, the kernel's arithmetic (and ``lstm_bwd_ref``) keeps it f32."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrd_keraslm_tpu.models.lstm_lm import _layer_scan_jnp
from ocrd_keraslm_tpu.ops import lstm_cell as jlc
from ocrd_keraslm_torch.ops import lstm_cell as tlc

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.02, atol=0.02)


def _inputs(seed, B, T, W, scale=0.3):
    """x_proj, h0, c0, U and the cotangents of h_all (B, T, W), hT and
    cT, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return dict(x_proj=normal(B, T, 4 * W), h0=normal(B, W),
                c0=normal(B, W),
                rec=(normal(W, 4 * W) * scale).astype(np.float32),
                wh=normal(B, T, W), whT=normal(B, W), wcT=normal(B, W))


def _bf16(a):
    """numpy f32 -> (torch bf16, jax bf16) of the same values."""
    return (torch.from_numpy(a).to(torch.bfloat16),
            jnp.asarray(a).astype(jnp.bfloat16))


def _torch_grads(fn, a, rec):
    """Gradients of sum(h_all*wh) + sum(hT*whT) + sum(cT*wcT) through
    ``fn`` (time-major h_all) w.r.t. x_proj, h0, c0 and ``rec``."""
    leaves = [torch.from_numpy(a[k]).requires_grad_()
              for k in ('x_proj', 'h0', 'c0')] + [rec.requires_grad_()]
    h_all, hT, cT = fn(*leaves)
    loss = ((h_all.transpose(0, 1) * torch.from_numpy(a['wh'])).sum()
            + (hT * torch.from_numpy(a['whT'])).sum()
            + (cT * torch.from_numpy(a['wcT'])).sum())
    return torch.autograd.grad(loss, leaves)


def _jax_grads(fn, a, rec):
    def loss(xp, h, c, r):
        h_all, hT, cT = fn(xp, h, c, r)
        return (jnp.sum(h_all * a['wh']) + jnp.sum(hT * a['whT'])
                + jnp.sum(cT * a['wcT']))
    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(a['x_proj']), jnp.asarray(a['h0']),
        jnp.asarray(a['c0']), rec)


def _ref_scan(xp, h0, c0, rec):
    h_all, _, hT, cT = tlc.lstm_scan_ref(xp, h0, c0, rec)
    return h_all, hT, cT


def _bwd_arrays(a, rec_t):
    """The time-major arguments of ``lstm_bwd`` from a forward run of
    the plain version."""
    xp, h0, c0 = (torch.from_numpy(a[k]) for k in ('x_proj', 'h0', 'c0'))
    h_all, c_all, _, _ = tlc.lstm_scan_ref(xp, h0, c0, rec_t,
                                           want_c_all=True)
    hprev = torch.cat([h0[None], h_all[:-1]])
    cprev = torch.cat([c0[None], c_all[:-1]])
    return [xp.transpose(0, 1).contiguous(), hprev, cprev, c_all,
            torch.from_numpy(a['wh']).transpose(0, 1).contiguous(), rec_t,
            torch.from_numpy(a['whT']), torch.from_numpy(a['wcT'])]


@pytest.mark.parametrize('B, T, W, bf16', [
    (3, 7, 8, False), (12, 9, 16, False), (5, 1, 8, False),
    (12, 9, 16, True), (3, 1, 8, True),
    # the width of the grid layout on the card (16 blocks of 32 terms)
    (2, 3, 512, False)])
def test_lstm_bwd_ref_matches_pallas(B, T, W, bf16):
    """The plain backward and the Pallas backward kernel (interpret
    mode) on the same saved states: every output, f32 tolerance in both
    weight types (neither rounds dh)."""
    a = _inputs(B * 100 + T, B, T, W)
    rec_t, rec_j = _bf16(a['rec']) if bf16 else (
        torch.from_numpy(a['rec']), jnp.asarray(a['rec']))
    args = _bwd_arrays(a, rec_t)
    got = tlc.lstm_bwd_ref(*args)
    jargs = [rec_j if t is rec_t else jnp.asarray(t.numpy()) for t in args]
    want = jlc._lstm_bwd_pallas(*jargs)
    for name, g, w in zip(('dxp_tm', 'dU', 'dh0', 'dc0'), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **F32)


def test_lstm_bwd_on_cpu_runs_the_plain_version():
    """For CPU tensors the wrapper returns the plain version's values
    and launches nothing."""
    a = _inputs(5, 3, 4, 8)
    args = _bwd_arrays(a, torch.from_numpy(a['rec']))
    before = tlc.lstm_bwd.launches
    for g, w in zip(tlc.lstm_bwd(*args), tlc.lstm_bwd_ref(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tlc.lstm_bwd.launches == before


@pytest.mark.parametrize('B, T, W', [(3, 7, 8), (11, 5, 16), (4, 1, 8)])
def test_lstm_scan_gradients_match_jax_f32(B, T, W):
    """dx_proj, dh0, dc0, dU of ``LSTMScan`` with cotangents on h_all,
    hT and cT: against jax.grad through the Pallas custom VJP and
    through the jnp scan, and against torch autograd through the plain
    forward.  B = 11 is not a multiple of 8; T = 1 is one step."""
    a = _inputs(B + T, B, T, W)
    got = _torch_grads(tlc.LSTMScan.apply, a, torch.from_numpy(a['rec']))
    refs = {
        'pallas': _jax_grads(jlc.lstm_scan_pallas, a, jnp.asarray(a['rec'])),
        'jnp': _jax_grads(_layer_scan_jnp, a, jnp.asarray(a['rec'])),
        'autograd': [g.numpy() for g in _torch_grads(
            _ref_scan, a, torch.from_numpy(a['rec']))]}
    for ref, want in refs.items():
        for name, g, w in zip(('dx_proj', 'dh0', 'dc0', 'dU'), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg='%s vs %s' % (name, ref),
                                       **F32)


@pytest.mark.parametrize('B, T, W', [(12, 9, 16), (5, 1, 8)])
def test_lstm_scan_bf16_forward_matches_jax(B, T, W):
    """bf16 U: the port's forward against ``_layer_scan_jnp`` and the
    Pallas kernel; h, c f32; atol 1e-6 (see the module docstring)."""
    a = _inputs(B, B, T, W)
    rec_t, rec_j = _bf16(a['rec'])
    h_all, c_all, hT, cT = tlc.lstm_scan(
        *(torch.from_numpy(a[k]) for k in ('x_proj', 'h0', 'c0')), rec_t,
        want_c_all=True)
    assert h_all.dtype == c_all.dtype == torch.float32
    jin = [jnp.asarray(a[k]) for k in ('x_proj', 'h0', 'c0')]
    for fn in (_layer_scan_jnp, jlc.lstm_scan_pallas):
        ha, hT_j, cT_j = fn(*jin, rec_j)
        np.testing.assert_allclose(h_all.transpose(0, 1).numpy(),
                                   np.asarray(ha), rtol=0, atol=1e-6)
        np.testing.assert_allclose(hT.numpy(), np.asarray(hT_j), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(cT.numpy(), np.asarray(cT_j), rtol=0,
                                   atol=1e-6)
    # the product is not PyTorch's bf16 matmul, which rounds its result
    h = torch.from_numpy(a['h0'])
    exact = tlc.recurrent_product(h, rec_t)
    assert exact.dtype == torch.float32
    assert not torch.equal(
        exact, (h.to(torch.bfloat16) @ rec_t).to(torch.float32))


def test_lstm_scan_gradients_match_jax_bf16():
    """bf16 U: gradients within bf16 resolution of jax.grad through the
    Pallas custom VJP and the jnp scan and of torch autograd through the
    plain forward; the cotangent of U is bf16, as in JAX."""
    B, T, W = 12, 9, 16
    a = _inputs(1, B, T, W)
    rec_t, rec_j = _bf16(a['rec'])
    got = _torch_grads(tlc.LSTMScan.apply, a, rec_t)
    assert got[3].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[:3])
    refs = {'pallas': _jax_grads(jlc.lstm_scan_pallas, a, rec_j),
            'jnp': _jax_grads(_layer_scan_jnp, a, rec_j),
            'autograd': _torch_grads(_ref_scan, a, _bf16(a['rec'])[0])}
    for ref, want in refs.items():
        for name, g, w in zip(('dx_proj', 'dh0', 'dc0', 'dU'), got, want):
            w = w.float().numpy() if torch.is_tensor(w) \
                else np.asarray(w, np.float32)
            np.testing.assert_allclose(g.float().numpy(), w,
                                       err_msg='%s vs %s' % (name, ref),
                                       **BF16)


def test_bf16_weight_gradient_reaches_an_f32_parameter():
    """Through ``U.to(bfloat16)`` the bf16 cotangent is promoted into
    the f32 parameter's gradient, as JAX's outer ``astype`` does."""
    a = _inputs(2, 4, 3, 8)
    U = torch.from_numpy(a['rec']).requires_grad_()
    h_all, hT, cT = tlc.LSTMScan.apply(
        *(torch.from_numpy(a[k]) for k in ('x_proj', 'h0', 'c0')),
        U.to(torch.bfloat16))
    (h_all.sum() + cT.sum()).backward()
    assert U.grad.dtype == torch.float32
    # every value is a bf16 value
    assert torch.equal(U.grad, U.grad.to(torch.bfloat16).float())
    assert float(U.grad.abs().max()) > 0
