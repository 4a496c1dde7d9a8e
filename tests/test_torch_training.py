"""Training of the port against the JAX package on the CPU: the update
step over a trajectory, the epoch loop, and the ``keraslm-rate train``
command.

Trajectory: from the same parameters and the same batches (numpy, from a
seed), ``dropout=0``, six ``train_step``s then an ``eval_step`` in both
packages.  Tolerances: loss, NLL and carry rtol 2e-4 / atol 2e-5,
accuracy exact to 1e-6.  Parameters are held with atol 2.5e-3 = 2.5
steps of the learning rate from step 0, because Adam's first updates are
``lr * g / (|g| + 1e-7)``: an element whose gradient is of the size of
f32 rounding (~1e-7) moves by up to ``lr`` in either direction for a
rounding-sized difference between the packages (such elements exist:
the embedding rows of chars that do not occur).  Started in the middle,
with Adam's moments carried across from optax, the denominators are
well away from zero and parameters agree to rtol 1e-3 / atol 1e-5."""
import contextlib
import glob
import io
import os
import random

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax
import jax.numpy as jnp

import ocrd_keraslm_tpu.training as jtraining
from ocrd_keraslm_tpu.models import lstm_lm as jlm
from ocrd_keraslm_tpu.rater import Rater as JRater
import ocrd_keraslm_torch.training as ttraining
from ocrd_keraslm_torch.models import lstm_lm as tlm
from ocrd_keraslm_torch.rater import Rater
from ocrd_keraslm_torch.scripts.run import cli

from test_torch_model_core import both_cfgs, jax_params, seeded_params

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

B, T = 4, 8
N_STEPS = 6


def _batches(cfg, seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = np.ones((B, T), np.float32)
        mask[rng.integers(0, B), T - 3:] = 0.0
        out.append(dict(
            x=rng.integers(1, cfg.voc_size, (B, T)).astype(np.int32),
            zs=[rng.integers(0, n_, (B,)).astype(np.int32)
                for n_, _ in cfg.contexts],
            y=rng.integers(1, cfg.voc_size, (B, T)).astype(np.int32),
            mask=mask))
    return out


def _jax_leaves(tree):
    return [np.asarray(a) for a in (
        [tree['char_embedding']] + list(tree['context_embeddings'])
        + [lp[k] for lp in tree['lstm']
           for k in ('kernel', 'recurrent', 'bias')])]


def _jax_steps(cfg, params, opt_state, carry, batches):
    """Run JAX ``train_step`` over ``batches``; returns the new state
    and [(loss, nll, acc, h, c)] per step."""
    rng = jax.random.PRNGKey(0)
    out = []
    for b in batches:
        params, opt_state, carry, loss, nll, acc = jtraining.train_step(
            params, opt_state, cfg, jnp.asarray(b['x']),
            tuple(jnp.asarray(z) for z in b['zs']), jnp.asarray(b['y']),
            jnp.asarray(b['mask']), carry, rng)
        out.append((float(loss), float(nll), float(acc),
                    np.asarray(carry[0]), np.asarray(carry[1])))
    return params, opt_state, carry, out


def _torch_steps(tcfg, params, optimizer, carry, batches):
    out = []
    for b in batches:
        carry, loss, nll, acc = ttraining.train_step(
            params, optimizer, tcfg, torch.from_numpy(b['x']).long(),
            [torch.from_numpy(z).long() for z in b['zs']],
            torch.from_numpy(b['y']).long(), torch.from_numpy(b['mask']),
            carry, torch.Generator().manual_seed(0))
        assert not carry[0].requires_grad and not loss.requires_grad
        out.append((loss.item(), nll.item(), acc.item(), carry[0].numpy(),
                    carry[1].numpy()))
    return carry, out


def _compare_steps(got, want):
    for step, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(('loss', 'nll'), g[:2], w[:2]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5,
                                       err_msg='%s at step %d' % (name, step))
        assert abs(g[2] - w[2]) < 1e-6, ('accuracy', step)
        for name, a, b in zip(('h', 'c'), g[3:], w[3:]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5,
                                       err_msg='%s at step %d' % (name, step))


def _trainable(tree):
    params = tlm.params_from_numpy(tree, 'cpu')
    for t in tlm.param_leaves(params):
        t.requires_grad_()
    return params


def test_train_step_trajectory_matches_jax():
    cfg, tcfg = both_cfgs(width=16, depth=2, length=T, voc_size=13,
                          contexts=((20, 4),), dropout=0.0)
    tree = seeded_params(cfg, 21)
    # embeddings small, as at the start of training
    tree['char_embedding'] *= 0.1
    batches = _batches(cfg, 22, N_STEPS + 1)
    jparams = jax_params(tree)
    jparams, opt_state, jcarry, want = _jax_steps(
        cfg, jparams, jtraining._OPT.init(jparams),
        jlm.zero_carry(cfg, B), batches[:N_STEPS])
    params = _trainable(tree)
    optimizer = ttraining.make_optimizer(params)
    carry, got = _torch_steps(tcfg, params, optimizer,
                              tlm.zero_carry(tcfg, B, 'cpu'),
                              batches[:N_STEPS])
    _compare_steps(got, want)
    assert want[-1][0] < want[0][0]          # and it learns
    for a, b in zip(tlm.param_leaves(params), _jax_leaves(jparams)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=2.5e-3)
    # eval_step: pure cross-entropy, no update, carry threaded
    b = batches[N_STEPS]
    wn, wa, wcarry = jtraining.eval_step(
        jparams, cfg, jnp.asarray(b['x']),
        tuple(jnp.asarray(z) for z in b['zs']), jnp.asarray(b['y']),
        jnp.asarray(b['mask']), jcarry)
    before = [t.detach().clone() for t in tlm.param_leaves(params)]
    gn, ga, gcarry = ttraining.eval_step(
        params, tcfg, torch.from_numpy(b['x']).long(),
        [torch.from_numpy(z).long() for z in b['zs']],
        torch.from_numpy(b['y']).long(), torch.from_numpy(b['mask']), carry)
    np.testing.assert_allclose(gn.item(), float(wn), rtol=1e-3)
    assert abs(ga.item() - float(wa)) < 1e-6
    np.testing.assert_allclose(gcarry[1].numpy(), np.asarray(wcarry[1]),
                               rtol=1e-3, atol=1e-4)
    assert all(torch.equal(a, t) for a, t in
               zip(before, tlm.param_leaves(params)))
    assert not gn.requires_grad


def test_trajectory_from_optax_moments_matches_jax():
    """Start in the middle: three JAX steps, then parameters, Adam's
    moments and step count carried into the port, three more steps in
    both."""
    cfg, tcfg = both_cfgs(width=16, depth=2, length=T, voc_size=13,
                          contexts=((20, 4),), dropout=0.0)
    tree = seeded_params(cfg, 21)
    batches = _batches(cfg, 23, 6)
    jparams = jax_params(tree)
    jparams, opt_state, jcarry, _ = _jax_steps(
        cfg, jparams, jtraining._OPT.init(jparams),
        jlm.zero_carry(cfg, B), batches[:3])
    adam = opt_state[1][0]
    mid = jax.tree_util.tree_map(np.array, jparams)
    count, mu, nu = int(adam.count), _jax_leaves(adam.mu), \
        _jax_leaves(adam.nu)
    carry0 = (np.array(jcarry[0]), np.array(jcarry[1]))
    assert count == 3
    jparams, _, _, want = _jax_steps(cfg, jparams, opt_state, jcarry,
                                     batches[3:])
    params = _trainable(mid)
    optimizer = ttraining.make_optimizer(params)
    ttraining.load_optimizer_state(optimizer, count, mu, nu)
    _, got = _torch_steps(tcfg, params, optimizer,
                          tuple(torch.from_numpy(c) for c in carry0),
                          batches[3:])
    _compare_steps(got, want)
    assert int(optimizer.state[tlm.param_leaves(params)[0]]['step']) == 6
    for a, b in zip(tlm.param_leaves(params), _jax_leaves(jparams)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-3,
                                   atol=1e-5)


def test_optimizer_clips_elementwise_then_adam():
    """One step on a known gradient: clip at 1.0 per element, then Adam
    with eps 1e-7: the first update is lr * g / (|g| + eps) of the
    clipped g."""
    cfg = tlm.LMConfig(width=4, depth=1, voc_size=3, contexts=())
    params = _trainable(seeded_params(cfg, 1))
    optimizer = ttraining.make_optimizer(params)
    group = optimizer.param_groups[0]
    assert (group['lr'], group['betas'], group['eps']) == (
        1e-3, (0.9, 0.999), 1e-7)
    leaf = tlm.param_leaves(params)[0]
    before = leaf.detach().clone()
    for t in tlm.param_leaves(params):
        t.grad = torch.zeros_like(t)
    leaf.grad[0, 0], leaf.grad[0, 1], leaf.grad[0, 2] = 50.0, -1e-7, 0.25
    torch.nn.utils.clip_grad_value_(tlm.param_leaves(params), 1.0)
    assert leaf.grad[0, 0] == 1.0
    optimizer.step()
    delta = (leaf.detach() - before)[0]
    np.testing.assert_allclose(delta[:3].numpy(), [-1e-3, 0.5e-3, -1e-3],
                               rtol=1e-3)
    assert float(delta[3]) == 0.0


# ----------------------------------------------------------------------
# the epoch loop
# ----------------------------------------------------------------------

@pytest.fixture()
def corpus(tmp_path):
    random.seed(7)
    words = ['die', 'der', 'und', 'ist', 'kant', 'vernunft', 'mensch']
    files = []
    for name in ['a_eins_1781.txt', 'b_zwei_1790.txt', 'c_drei_1800.txt']:
        path = tmp_path / name
        with open(path, 'w') as fh:
            for _ in range(60):
                fh.write(' '.join(random.choices(words, k=10)) + '\n')
        files.append(str(path))
    return files


@contextlib.contextmanager
def _global_rngs_kept():
    """Keep the global random states across a block that trains: the
    tests after it in this file (unseeded, run in one worker) then draw
    what they drew when the block trained nothing."""
    np_state, py_state = np.random.get_state(), random.getstate()
    try:
        yield
    finally:
        np.random.set_state(np_state)
        random.setstate(py_state)


def _train(files, tmp_path, epochs=2, monkeypatch=None, **attrs):
    old_epochs = ttraining.EPOCHS
    ttraining.EPOCHS = epochs
    try:
        r = Rater(device='cpu')
        r.width, r.depth, r.length = 16, 1, 16
        r.ckpt_dir = str(tmp_path)
        for k, v in attrs.items():
            setattr(r, k, v)
        r.configure()
        r.train(files)
        return r
    finally:
        ttraining.EPOCHS = old_epochs


def test_stateful_streams_training_learns_and_saves(corpus, tmp_path):
    """The main layout: loss falls from ~ln(V), best-only checkpoints
    and the history are written, and the saved model loads in the JAX
    package and rates alike."""
    random.seed(3)
    np.random.seed(3)
    r = _train(corpus, tmp_path, epochs=5, batch_size=8, depth=2)
    assert r.status == 2
    hist = r.history
    assert len(hist['loss']) == 5 and set(hist) == {
        'loss', 'accuracy', 'val_loss', 'val_accuracy'}
    assert abs(hist['loss'][0] - np.log(r.voc_size)) < 0.6
    assert hist['loss'][-1] < hist['loss'][0] - 0.1
    assert np.isfinite(hist['val_loss']).all()
    ckpts = sorted(glob.glob(str(tmp_path / 'ckpt.*.h5')))
    best = int(np.argmin(hist['val_loss']))
    assert os.path.basename(ckpts[-1]) == 'ckpt.%02d-%.2f.h5' % (
        best + 1, hist['val_loss'][best])
    assert not any(t.requires_grad for t in tlm.param_leaves(r.params))
    path = str(tmp_path / 'model.h5')
    r.save(path)
    j = JRater()
    j.load_config(path)
    j.configure()
    j.load_weights(path)
    assert j.history == hist and j.vocab.c2i == r.vocab.c2i
    np.testing.assert_allclose(r.rate('die vernunft', [179]),
                               j.rate('die vernunft', [179]), atol=1e-3)
    # the best checkpoint holds the returned weights
    r2 = Rater(device='cpu')
    r2.load_config(path)
    r2.configure()
    r2.load_weights(ckpts[-1])
    for a, b in zip(tlm.param_leaves(r2.params), tlm.param_leaves(r.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('attrs', [
    dict(stateful=True, train_streams=False),
    dict(stateful=False),
    dict(stateful=False, variable_length=True),
    dict(stateful=True, contexts=((200, 10), (50, 4))),
    dict(stateful=True, compute_dtype='bfloat16'),
], ids=['parity', 'stateless', 'variable_length', 'two_contexts', 'bf16'])
def test_training_layouts(corpus, tmp_path, attrs):
    r = _train(corpus, tmp_path, epochs=1, batch_size=32, **attrs)
    assert r.status == 2
    assert np.isfinite(r.history['val_loss'][-1])
    context = [179, 3][:len(r.contexts)]
    assert len(r.rate('die vernunft', context)) == 12
    _, ppl = r.rate2('die kant', context)
    assert np.isfinite(ppl) and ppl > 0
    if len(r.contexts) == 2:
        path = str(tmp_path / 'ctx2.h5')
        r.save(path)
        r2 = Rater(device='cpu')
        r2.load_config(path)
        assert r2.contexts == ((200, 10), (50, 4))


def test_vocab_growth_continuation(corpus, tmp_path):
    """Continued training with new characters keeps the old embedding
    rows' positions and every other weight's shape, and drops the
    weight sets packed from the old parameters."""
    r = _train(corpus, tmp_path, depth=2)
    old_voc = r.voc_size
    old_c2i = dict(r.vocab.c2i)
    r.fused_score = True
    r.rate('die vernunft', [179])
    assert r._score_pack is not None
    extra = tmp_path / 'd_vier_1810.txt'
    extra.write_text('xqXQ 1234!? ' * 200)
    ttraining.EPOCHS, old = 1, ttraining.EPOCHS
    try:
        r.train(corpus + [str(extra)])
    finally:
        ttraining.EPOCHS = old
    assert r.voc_size > old_voc
    assert r.params['char_embedding'].shape[0] == r.voc_size
    assert all(r.vocab.c2i[c] == i for c, i in old_c2i.items())
    assert r._score_pack is None or \
        r._score_pack[0] is r.params
    assert len(r.rate('die vernunft xq', [179])) == 15


def test_reconfigure_for_mapping_transfers_rows():
    r = Rater(device='cpu')
    r.load_config('pretrained/model_synthetic.h5')
    r.configure()
    r.load_weights('pretrained/model_synthetic.h5')
    old = {k: v for k, v in r.params.items()}
    old_voc = r.voc_size
    r.vocab.grow('☃☄')
    r.voc_size = r.vocab.size
    r.reconfigure_for_mapping()
    assert r.params['char_embedding'].shape[0] == old_voc + 2 == r.voc_size
    assert torch.equal(r.params['char_embedding'][:old_voc],
                       old['char_embedding'])
    assert float(r.params['char_embedding'][old_voc:].abs().max()) < 0.01
    assert r.params['lstm'][0]['kernel'] is old['lstm'][0]['kernel']
    assert r.cfg.voc_size == r.voc_size
    assert r.mapping == (r.vocab.c2i, r.vocab.i2c)


def _flat_eval(monkeypatch):
    real_eval = ttraining.eval_step

    def flat_eval(params, cfg, x, zs, y, mask, carry, x_mask=None):
        nll, acc, carry = real_eval(params, cfg, x, zs, y, mask, carry,
                                    x_mask)
        return torch.tensor(1.0), acc, carry   # constant val loss
    monkeypatch.setattr(ttraining, 'eval_step', flat_eval)


def test_early_stop_respects_step_floor(corpus, tmp_path, monkeypatch):
    _flat_eval(monkeypatch)
    monkeypatch.setattr(ttraining, 'MIN_STEPS_BEFORE_STOP', 10 ** 9)
    r = _train(corpus, tmp_path, epochs=6, batch_size=32)
    assert len(r.history['val_loss']) == 6 and r.status == 2
    monkeypatch.setattr(ttraining, 'MIN_STEPS_BEFORE_STOP', 1)
    r = _train(corpus, tmp_path, epochs=6, batch_size=32)
    assert len(r.history['val_loss']) == 1 + ttraining.PATIENCE
    assert r.status == 2


def test_epochs_below_patience(corpus, tmp_path, monkeypatch):
    _flat_eval(monkeypatch)
    monkeypatch.setattr(ttraining, 'MIN_STEPS_BEFORE_STOP', 1)
    r = _train(corpus, tmp_path, epochs=2, batch_size=32)
    assert len(r.history['val_loss']) == 2 and r.status == 2


def test_nan_stops_and_recovers_best_weights(corpus, tmp_path, monkeypatch):
    """A NaN loss in epoch 2 ends training; the rater keeps epoch 1's
    weights and status 2.  A NaN in epoch 1 leaves no usable epoch:
    status 1."""
    real_step, real_eval = ttraining.train_step, ttraining.eval_step
    state = {'epochs_done': 0, 'nan_from_epoch': 1}

    def step(params, optimizer, *args, **kw):
        out = real_step(params, optimizer, *args, **kw)
        if state['epochs_done'] >= state['nan_from_epoch']:
            return (out[0], out[1] * float('nan')) + out[2:]
        return out

    def evaluate(*args, **kw):
        state['validating'] = True
        return real_eval(*args, **kw)

    def counting_step(*args, **kw):
        # the first train step after a validation pass opens an epoch
        if state.pop('validating', False):
            state['epochs_done'] += 1
        return step(*args, **kw)
    monkeypatch.setattr(ttraining, 'train_step', counting_step)
    monkeypatch.setattr(ttraining, 'eval_step', evaluate)
    r = _train(corpus, tmp_path, epochs=5, batch_size=32)
    assert r.status == 2 and len(r.history['loss']) == 2
    assert all(torch.isfinite(t).all() for t in tlm.param_leaves(r.params))
    ckpt = sorted(glob.glob(str(tmp_path / 'ckpt.01-*.h5')))[-1]
    r2 = Rater(device='cpu')
    r2.width, r2.depth, r2.length = 16, 1, 16
    r2.vocab, r2.voc_size = r.vocab, r.voc_size
    r2.configure()
    r2.load_weights(ckpt)
    assert torch.equal(r2.params['char_embedding'],
                       r.params['char_embedding'])
    state.update(epochs_done=0, nan_from_epoch=0)
    state.pop('validating', None)
    r = _train(corpus, tmp_path, epochs=5, batch_size=32)
    assert r.status == 1 and len(r.history['loss']) == 1


def test_huge_loss_warns(corpus, tmp_path, monkeypatch, caplog):
    real_step = ttraining.train_step

    def step(*args, **kw):
        out = real_step(*args, **kw)
        return (out[0], out[1] + 100.0) + out[2:]
    monkeypatch.setattr(ttraining, 'train_step', step)
    with caplog.at_level('WARNING'):
        r = _train(corpus, tmp_path, epochs=1, batch_size=32)
    assert r.status == 2
    assert any('huge loss' in rec.message for rec in caplog.records)


def test_stateless_carry_reset_every_batch(corpus, tmp_path, monkeypatch):
    seen = []
    real_step = ttraining.train_step

    def step(params, optimizer, cfg, x, zs, y, mask, carry, *a, **kw):
        seen.append(float(carry[0].abs().max()))
        return real_step(params, optimizer, cfg, x, zs, y, mask, carry,
                         *a, **kw)
    monkeypatch.setattr(ttraining, 'train_step', step)
    _train(corpus, tmp_path, epochs=1, stateful=False, batch_size=32)
    assert len(seen) > 2 and max(seen) == 0.0
    seen.clear()
    _train(corpus, tmp_path, epochs=1, stateful=True, batch_size=4)
    assert max(seen) > 0.0     # stateful: the carry threads through


def test_train_from_handles_and_no_data(tmp_path):
    text = 'die vernunft ist der mensch und kant \n' * 40
    r = _train([io.StringIO(text), io.StringIO(text[::-1])], tmp_path,
               batch_size=4)
    assert r.status == 2
    # files shorter than two chars give no batch at all
    empty = []
    for name in ('x_a_1800.txt', 'x_b_1801.txt'):
        (tmp_path / name).write_text('a')
        empty.append(str(tmp_path / name))
    r = _train(empty, tmp_path, batch_size=4)
    assert r.status == 1


@pytest.mark.parametrize('how, item', [
    ('mesh', 'Queue 1 #16'), ('resume_dir', 'Queue 1 #12'),
    ('KERASLM_RESUME_DIR', 'Queue 1 #12')])
def test_unported_training_modes_name_their_roadmap_item(
        corpus, tmp_path, monkeypatch, how, item):
    """Training over a mesh (Queue 1 #16) still raises, naming its item;
    the train-state snapshots of Queue 1 #12 (``resume_dir`` or
    ``KERASLM_RESUME_DIR``) are ported: the run snapshots every epoch
    (``tests/test_torch_resume.py`` holds the resume itself)."""
    snap = tmp_path / 'snap'
    if how == 'mesh':
        r = Rater(device='cpu')
        r.width, r.depth, r.length = 16, 1, 16
        r.configure()
        r.mesh = str(tmp_path)
        with pytest.raises(NotImplementedError, match=item):
            r.train(corpus)
        assert r.params is None      # nothing was touched
        return
    from ocrd_keraslm_torch.utils.orbaxio import load_train_state
    if how == 'KERASLM_RESUME_DIR':
        monkeypatch.setenv(how, str(snap))
    with _global_rngs_kept():
        r = _train(corpus, tmp_path, batch_size=8, **(
            {'resume_dir': str(snap)} if how == 'resume_dir' else {}))
    assert r.status == 2
    assert os.listdir(snap) == ['ep_0002']
    meta = load_train_state(str(snap))['meta']
    assert meta['epoch_done'] == 2 and meta['history'] == r.history


# ----------------------------------------------------------------------
# keraslm-rate train
# ----------------------------------------------------------------------

@pytest.fixture()
def cpu_platform(monkeypatch, tmp_path):
    monkeypatch.setenv('KERASLM_PLATFORM', 'cpu')
    monkeypatch.setenv('KERASLM_CKPT_DIR', str(tmp_path / 'ckpt'))
    monkeypatch.delenv('KERASLM_RESUME_DIR', raising=False)
    old = ttraining.EPOCHS
    yield
    ttraining.EPOCHS = old


def test_cli_train_then_test_and_continue(tmp_path, corpus, cpu_platform):
    """``train`` writes checkpoints and the model; ``test``,
    ``apply`` and ``print-history`` read it, and so does the JAX
    package's CLI; a second ``train`` continues from the saved model, a
    third with another topology starts fresh, a fourth from a
    checkpoint."""
    from ocrd_keraslm_tpu.scripts.run import cli as jcli
    model = tmp_path / 'trained.h5'
    args = ['-l', 'WARNING', 'train', '-m', str(model), '-C',
            str(tmp_path / 'none.h5'), '-w', '16', '-d', '1', '-l', '32',
            '-e', '2', '-b', '16']
    res = CliRunner().invoke(cli, args + corpus)
    assert res.exit_code == 0, (res.output, res.exception)
    assert model.exists() and 'continuing' not in res.output
    ckpts = glob.glob(str(tmp_path / 'ckpt' / 'ckpt.*.h5'))
    assert ckpts
    res = CliRunner().invoke(cli, ['test', '-m', str(model), corpus[0]])
    assert res.exit_code == 0, (res.output, res.exception)
    ppl = float(res.output.strip().splitlines()[-1])
    assert 1.0 < ppl < 50.0
    jres = CliRunner().invoke(jcli, ['test', '-m', str(model), corpus[0]])
    assert jres.exit_code == 0, jres.output
    np.testing.assert_allclose(
        float(jres.output.strip().splitlines()[-1]), ppl, rtol=1e-4)
    res = CliRunner().invoke(cli, ['apply', '-m', str(model), 'die kant'])
    assert res.exit_code == 0 and len(res.output.splitlines()) >= 2
    res = CliRunner().invoke(cli, ['print-history', '-m', str(model)])
    assert res.exit_code == 0, (res.output, res.exception)
    assert 'val_loss: [' in res.output and 'accuracy: [' in res.output

    res = CliRunner().invoke(cli, args + corpus)
    assert res.exit_code == 0, (res.output, res.exception)
    assert 'continuing training from saved model' in res.output
    wide = [a if a != '16' or args[i - 1] != '-w' else '24'
            for i, a in enumerate(args)]
    res = CliRunner().invoke(cli, wide + corpus)
    assert res.exit_code == 0, (res.output, res.exception)
    assert 'different topology' in res.output
    fresh = [str(tmp_path / 'other.h5') if a == str(model) else
             ckpts[0] if a == str(tmp_path / 'none.h5') else a
             for a in args]
    res = CliRunner().invoke(cli, fresh + ['-v', corpus[0]] + corpus[1:])
    assert res.exit_code == 0, (res.output, res.exception)
    assert 'continuing training from checkpoint' in res.output
    assert (tmp_path / 'other.h5').exists()


def test_cli_train_bf16(tmp_path, corpus, cpu_platform):
    model = tmp_path / 'bf16.h5'
    res = CliRunner().invoke(cli, [
        '-l', 'WARNING', 'train', '-m', str(model), '-w', '16', '-d', '2',
        '-l', '16', '-e', '1', '-b', '8', '--bf16'] + corpus)
    assert res.exit_code == 0, (res.output, res.exception)
    assert model.exists()


@pytest.mark.parametrize('option, value, item', [
    ('--mesh', '2', 'Queue 1 #16'), ('--resume-dir', 'snap', 'Queue 1 #12')])
def test_cli_train_unported_options_raise(tmp_path, corpus, cpu_platform,
                                          option, value, item):
    """``--mesh`` (Queue 1 #16) still raises and writes no model;
    ``--resume-dir`` (Queue 1 #12) is ported: the model is written and
    the directory holds the last epoch's snapshot."""
    if option == '--resume-dir':
        value = str(tmp_path / value)
    with _global_rngs_kept():
        res = CliRunner().invoke(cli, [
            '-l', 'WARNING', 'train', '-m', str(tmp_path / 'm.h5'), '-w',
            '16', '-d', '1', '-l', '16', '-e', '1', '-b', '8', option,
            value] + corpus)
    if option == '--mesh':
        assert isinstance(res.exception, NotImplementedError)
        assert item in str(res.exception)
        assert not (tmp_path / 'm.h5').exists()
        return
    assert res.exit_code == 0, (res.output, res.exception)
    assert (tmp_path / 'm.h5').exists()
    assert os.listdir(value) == ['ep_0001']


def test_cli_lists_train_and_print_history_as_ported():
    """train and print-history, and since the generation slice also
    generate, are listed without the "not ported" mark."""
    res = CliRunner().invoke(cli, ['--help'])
    lines = {ln.split()[0]: ln for ln in res.output.splitlines()
             if ln.startswith('  ') and ln.split()}
    assert 'not ported' not in lines['train']
    assert 'not ported' not in lines['print-history']
    assert 'not ported' not in lines['generate']
    assert 'not ported' not in lines['prune-charset']
