"""The port's pipeline-parallel training (``parallel/pipeline.py``) on
rank processes on the CPU against the JAX package's
``make_pipeline_train_step_canonical`` over its virtual CPU devices,
and against the port's one-rank step.

The packed-layout step (``make_pipeline_train_step``) runs 3 steps on
every mesh against JAX's over its virtual CPU devices, and against the
port's canonical step from the same weights, with dropout 0 and 0.3.

Two worlds run every check once (this file is also the rank's script):
two ranks for the ``(dp, pp, n_micro)`` meshes ``(1, 2, 2)`` and
``(1, 2, 4)``, the bf16 step and ``keraslm-rate train --mesh 2p``; four
ranks for ``(2, 2, 2)``.  Dropout 0 against JAX, as the JAX package's
own pipeline tests hold parity (its dropout masks differ in bits by
design).

Tolerances: loss, NLL, accuracy and the carry within rtol 1e-5 / atol
1e-6 of the port's one-rank step and rtol 1e-4 / atol 2e-5 of JAX's
pipeline step; parameters within atol 1e-5 of one rank's and 2.5e-3 of
JAX's (Adam's first step, see ``tests/test_torch_parallel.py``); bf16
within rtol 1e-4 of one rank's bf16 step (the operands round alike, the
microbatch products sum in another order).  The packed step after 3
steps: loss, NLL and accuracy within rtol 1e-5 / atol 1e-6 of JAX's
packed step, the parameters too after unpacking, the carry within rtol
1e-4 / atol 1e-6 (the tolerances of JAX's own pipeline test); against
the port's canonical step equal bit for bit (the same arithmetic on the
same ranks; see ``parallel/pipeline.py``)."""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_parallel import (launch, leaves, load_tree, save_tree,
                                 worker_main, write_corpus)

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

W, D, V, T, B = 16, 2, 32, 8, 8
CONTEXTS = ((20, 4),)
MESHES = [(1, 2, 2), (2, 2, 2), (1, 2, 4)]
STEPS = 3                   # steps of the packed and canonical runs
DROPOUTS = (0.0, 0.3)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[2, T - 3:] = 0.0
    return dict(x=rng.integers(1, V, (B, T)).astype(np.int32),
                y=rng.integers(1, V, (B, T)).astype(np.int32),
                z=rng.integers(0, 20, (B,)).astype(np.int32), mask=mask,
                h=rng.normal(0, 0.1, (D, B, W)).astype(np.float32),
                c=rng.normal(0, 0.1, (D, B, W)).astype(np.float32))


def _cfg(module, dtype='float32'):
    return module.LMConfig(width=W, depth=D, length=T, voc_size=V,
                           contexts=CONTEXTS, dropout=0.0,
                           compute_dtype=dtype)


# ----------------------------------------------------------------------
# the rank's work
# ----------------------------------------------------------------------

def _rank_step(out, tag, dp, pp, n_micro, dtype='float32'):
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    from ocrd_keraslm_torch.parallel import comm
    from ocrd_keraslm_torch.parallel.mesh import local_rows, shard_carry
    from ocrd_keraslm_torch.parallel.pipeline import (
        make_pipe_mesh, make_pipeline_train_step_canonical)
    inp = dict(np.load(os.path.join(out, '..', 'inputs.npz')))
    tree = load_tree(os.path.join(out, '..', 'params.npz'))
    mesh = make_pipe_mesh(dp * pp, pipe_parallel=pp)
    cfg = _cfg(tlm, dtype)
    step, shard_fn = make_pipeline_train_step_canonical(mesh, cfg, n_micro)
    params, opt = shard_fn(tlm.params_from_numpy(tree, 'cpu'))

    def rows(a):
        return torch.from_numpy(local_rows(mesh, a))
    carry, loss, nll, acc = step(
        params, opt, rows(inp['x']).long(), [rows(inp['z']).long()],
        rows(inp['y']).long(), rows(inp['mask']),
        tuple(torch.from_numpy(a) for a in shard_carry(
            mesh, (inp['h'], inp['c']))), None)
    res = {'sums': np.array([loss.item(), nll.item(), acc.item()])}
    for name, t in zip('hc', carry):
        res[name] = comm.all_gather_rows(t, mesh.data, dim=1).numpy()
    for i, a in enumerate(leaves(tlm.params_to_numpy(params))):
        res['p%d' % i] = a
    np.savez(os.path.join(out, '%s_%d.npz' % (tag, mesh.rank)), **res)


def _rank_steps(out, dp, pp, n_micro):
    """``STEPS`` steps of the packed and of the canonical step from the
    same weights, with every dropout of ``DROPOUTS`` (one generator of
    one seed for each run); writes the losses, the whole carry, the
    canonical leaves (the packed run's unpacked) and the packed run's
    optimizer state to ``pk<mesh>_<dropout>_<rank>.npz`` and
    ``cn...``."""
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    from ocrd_keraslm_torch.parallel import comm
    from ocrd_keraslm_torch.parallel import pipeline as tp
    from ocrd_keraslm_torch.parallel.mesh import local_rows, shard_carry
    inp = dict(np.load(os.path.join(out, '..', 'inputs.npz')))
    tree = load_tree(os.path.join(out, '..', 'params.npz'))
    mesh = tp.make_pipe_mesh(dp * pp, pipe_parallel=pp)

    def rows(a):
        return torch.from_numpy(local_rows(mesh, a))
    args = (rows(inp['x']).long(), [rows(inp['z']).long()],
            rows(inp['y']).long(), rows(inp['mask']))
    for dropout in DROPOUTS:
        cfg = _cfg(tlm).replace(dropout=dropout)
        step, shard_fn = tp.make_pipeline_train_step(mesh, cfg, n_micro)
        local, opt, carry = shard_fn(
            tp.pack_pipeline_params(tree, cfg, pp),
            tp.pack_carry((inp['h'], inp['c']), pp))
        rng = torch.Generator().manual_seed(5)
        sums = []
        for _ in range(STEPS):
            carry, loss, nll, acc = step(local, opt, *args, carry, rng)
            sums.append([loss.item(), nll.item(), acc.item()])
        res = {'sums': np.array(sums)}
        res['h'], res['c'] = tp.unpack_carry(
            tp.gather_pipeline_carry(mesh, carry))
        whole = tp.unpack_pipeline_params(
            tp.gather_pipeline_params(mesh, local), cfg)
        for i, a in enumerate(leaves(whole)):
            res['p%d' % i] = a
        for i, t in enumerate(tlm.param_leaves(local)):
            res['leaf%d' % i] = np.array(t.shape)
            for key in ('exp_avg', 'exp_avg_sq'):
                res['%s%d' % (key, i)] = np.array(opt.state[t][key].shape)
        tag = '%d%d%d_%s_%d' % (dp, pp, n_micro, dropout, mesh.rank)
        np.savez(os.path.join(out, 'pk%s.npz' % tag), **res)

        step, shard_fn = tp.make_pipeline_train_step_canonical(mesh, cfg,
                                                               n_micro)
        params, opt = shard_fn(tlm.params_from_numpy(tree, 'cpu'))
        carry = tuple(torch.from_numpy(a) for a in shard_carry(
            mesh, (inp['h'], inp['c'])))
        rng = torch.Generator().manual_seed(5)
        sums = []
        for _ in range(STEPS):
            carry, loss, nll, acc = step(params, opt, *args, carry, rng)
            sums.append([loss.item(), nll.item(), acc.item()])
        res = {'sums': np.array(sums)}
        for name, t in zip('hc', carry):
            res[name] = comm.all_gather_rows(t, mesh.data, dim=1).numpy()
        for i, a in enumerate(leaves(tlm.params_to_numpy(params))):
            res['p%d' % i] = a
        np.savez(os.path.join(out, 'cn%s.npz' % tag), **res)


def _task_two(rank, out):
    from click.testing import CliRunner
    from ocrd_keraslm_torch.scripts.run import cli
    from ocrd_keraslm_torch.utils import h5io
    for dp, pp, n_micro in MESHES:
        if dp == 1:
            _rank_step(out, 'm%d%d%d' % (dp, pp, n_micro), dp, pp, n_micro)
            _rank_steps(out, dp, pp, n_micro)
    _rank_step(out, 'bf16', 1, 2, 2, 'bfloat16')
    corpus = os.path.join(out, '..', 'corpus')
    model = os.path.join(out, 'model.h5')
    os.environ['KERASLM_CKPT_DIR'] = os.path.join(out, 'ck%d' % rank)
    res = CliRunner().invoke(cli, [
        '-l', 'WARNING', 'train', '-m', model, '-w', str(W), '-d', '2',
        '-l', '16', '-b', '8', '-e', '1', '--mesh', '2p', corpus])
    if res.exit_code != 0:
        raise RuntimeError(res.output) from res.exception
    torch.distributed.barrier()    # rank 0 has written the model
    with open(os.path.join(out, 'cli%d.json' % rank), 'w') as fh:
        json.dump({'exit': res.exit_code,
                   'history': h5io.load_config(model)[2]}, fh)


def _task_four(rank, out):
    _rank_step(out, 'm222', 2, 2, 2)
    _rank_steps(out, 2, 2, 2)


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    from ocrd_keraslm_tpu.models import lstm_lm as jlm
    from test_torch_model_core import seeded_params
    tmp = tmp_path_factory.mktemp('pipeline')
    tree = seeded_params(_cfg(jlm), 31)
    save_tree(tmp / 'params.npz', tree)
    np.savez(tmp / 'inputs.npz', **_inputs())
    (tmp / 'corpus').mkdir()
    write_corpus(tmp / 'corpus', seed=4, n=1200)
    return {'two': launch(__file__, 'two', 2, tmp),
            'four': launch(__file__, 'four', 4, tmp),
            'tree': tree, 'inputs': _inputs()}


def _one_rank(worlds, dtype='float32'):
    import ocrd_keraslm_torch.training as tt
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    inp = worlds['inputs']
    params = tlm.params_from_numpy(worlds['tree'], 'cpu')
    for t in tlm.param_leaves(params):
        t.requires_grad_()
    opt = tt.make_optimizer(params)
    carry, loss, nll, acc = tt.train_step(
        params, opt, _cfg(tlm, dtype), torch.from_numpy(inp['x']).long(),
        [torch.from_numpy(inp['z']).long()],
        torch.from_numpy(inp['y']).long(), torch.from_numpy(inp['mask']),
        (torch.from_numpy(inp['h']), torch.from_numpy(inp['c'])), None)
    return (np.array([loss.item(), nll.item(), acc.item()]),
            [t.numpy() for t in carry], leaves(tlm.params_to_numpy(params)))


def _jax_step(worlds, dp, pp, n_micro):
    import jax
    import jax.numpy as jnp
    from ocrd_keraslm_tpu.models import lstm_lm as jlm
    from ocrd_keraslm_tpu.parallel.pipeline import (
        make_pipe_mesh, make_pipeline_train_step_canonical)
    from ocrd_keraslm_tpu.training import _OPT
    from test_torch_model_core import jax_params
    inp = worlds['inputs']
    cfg = _cfg(jlm)
    mesh = make_pipe_mesh(dp * pp, pipe_parallel=pp,
                          devices=jax.devices('cpu'))
    _, shard_fn, jit_step = make_pipeline_train_step_canonical(
        mesh, cfg, n_micro=n_micro)
    params = jax_params(worlds['tree'])
    sp, so, _ = shard_fn(params, _OPT.init(params))
    fn = jit_step(sp, so, 1, True)
    p2, _, carry, loss, nll, acc = fn(
        sp, so, jnp.asarray(inp['x']), (jnp.asarray(inp['z']),),
        jnp.asarray(inp['y']), jnp.asarray(inp['mask']),
        (jnp.asarray(inp['h']), jnp.asarray(inp['c'])),
        jax.random.PRNGKey(0))
    return (np.array([float(loss), float(nll), float(acc)]),
            [np.asarray(t) for t in carry],
            leaves(jax.tree_util.tree_map(np.asarray, p2)))


def _got(worlds, dp, pp, n_micro, rank):
    key = 'two' if dp * pp == 2 else 'four'
    return np.load(worlds[key] / ('m%d%d%d_%d.npz' % (dp, pp, n_micro,
                                                      rank)))


@pytest.mark.parametrize('dp, pp, n_micro', MESHES)
def test_pipeline_step_matches_one_rank(worlds, dp, pp, n_micro):
    sums, carry, want = _one_rank(worlds)
    for rank in range(dp * pp):
        got = _got(worlds, dp, pp, n_micro, rank)
        np.testing.assert_allclose(got['sums'], sums, rtol=1e-5, atol=1e-6)
        for name, t in zip('hc', carry):
            np.testing.assert_allclose(got[name], t, rtol=1e-5, atol=1e-6)
        for i, w in enumerate(want):
            np.testing.assert_allclose(got['p%d' % i], w, rtol=0,
                                       atol=1e-5, err_msg='leaf %d' % i)


@pytest.mark.parametrize('dp, pp, n_micro', MESHES)
def test_pipeline_step_matches_jax(worlds, dp, pp, n_micro):
    sums, carry, want = _jax_step(worlds, dp, pp, n_micro)
    got = _got(worlds, dp, pp, n_micro, 0)
    np.testing.assert_allclose(got['sums'][:2], sums[:2], rtol=1e-4)
    assert abs(got['sums'][2] - sums[2]) < 1e-6
    for name, t in zip('hc', carry):
        np.testing.assert_allclose(got[name], t, rtol=1e-4, atol=2e-5)
    for i, w in enumerate(want):
        np.testing.assert_allclose(got['p%d' % i], w, rtol=0, atol=2.5e-3,
                                   err_msg='leaf %d' % i)


def _jax_packed(worlds, dp, pp, n_micro):
    """``STEPS`` steps of JAX's packed-layout step (as
    ``tests/test_pipeline.py`` runs it); returns the losses, the
    canonical carry and the unpacked leaves."""
    import jax
    import jax.numpy as jnp
    from ocrd_keraslm_tpu.models import lstm_lm as jlm
    from ocrd_keraslm_tpu.parallel import pipeline as jp
    from ocrd_keraslm_tpu.training import make_optimizer
    from test_torch_model_core import jax_params
    inp = worlds['inputs']
    cfg = _cfg(jlm)
    mesh = jp.make_pipe_mesh(dp * pp, pipe_parallel=pp,
                             devices=jax.devices('cpu'))
    opt = make_optimizer()
    packed = jp.pack_pipeline_params(jax_params(worlds['tree']), cfg, pp)
    o = opt.init(packed)
    pc = jp.pack_carry((jnp.asarray(inp['h']), jnp.asarray(inp['c'])), pp)
    jit_step, shard_fn = jp.make_pipeline_train_step(mesh, cfg, n_micro,
                                                     optimizer=opt)
    packed, o, pc = shard_fn(packed, o, pc)
    fn = jit_step(packed, o)
    sums = []
    for _ in range(STEPS):
        packed, o, pc, loss, nll, acc = fn(
            packed, o, jnp.asarray(inp['x']), (jnp.asarray(inp['z']),),
            jnp.asarray(inp['y']), jnp.asarray(inp['mask']), pc,
            jax.random.PRNGKey(3))
        sums.append([float(loss), float(nll), float(acc)])
    return (np.array(sums), [np.asarray(t) for t in jp.unpack_carry(pc)],
            leaves(jax.tree_util.tree_map(
                np.asarray, jp.unpack_pipeline_params(packed, cfg))))


def _steps(worlds, kind, dp, pp, n_micro, dropout, rank):
    key = 'two' if dp * pp == 2 else 'four'
    return np.load(worlds[key] / ('%s%d%d%d_%s_%d.npz' % (
        kind, dp, pp, n_micro, dropout, rank)))


@pytest.mark.parametrize('dp, pp, n_micro', MESHES)
def test_packed_step_matches_jax(worlds, dp, pp, n_micro):
    sums, carry, want = _jax_packed(worlds, dp, pp, n_micro)
    for rank in range(dp * pp):
        got = _steps(worlds, 'pk', dp, pp, n_micro, 0.0, rank)
        np.testing.assert_allclose(got['sums'], sums, rtol=1e-5, atol=1e-6)
        for name, t in zip('hc', carry):
            np.testing.assert_allclose(got[name], t, rtol=1e-4, atol=1e-6)
        for i, w in enumerate(want):
            np.testing.assert_allclose(got['p%d' % i], w, rtol=1e-5,
                                       atol=1e-6, err_msg='leaf %d' % i)


@pytest.mark.parametrize('dropout', DROPOUTS)
@pytest.mark.parametrize('dp, pp, n_micro', MESHES)
def test_packed_step_equals_canonical(worlds, dp, pp, n_micro, dropout):
    for rank in range(dp * pp):
        got = _steps(worlds, 'pk', dp, pp, n_micro, dropout, rank)
        want = _steps(worlds, 'cn', dp, pp, n_micro, dropout, rank)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=key)
        if dropout:                     # the masks did drop units
            off = _steps(worlds, 'cn', dp, pp, n_micro, 0.0, rank)
            assert not np.array_equal(want['sums'], off['sums'])


@pytest.mark.parametrize('dp, pp, n_micro', MESHES)
def test_packed_step_holds_its_stage_only(worlds, dp, pp, n_micro):
    """A rank's parameters and Adam's moments: the embeddings whole, its
    stage's ``D/pp`` layers of the stacks, no more."""
    I = W + CONTEXTS[0][1]
    want = [(V, W), CONTEXTS[0], (D // pp, I, 4 * W), (D // pp, W, 4 * W),
            (D // pp, 4 * W)]
    for rank in range(dp * pp):
        got = _steps(worlds, 'pk', dp, pp, n_micro, 0.0, rank)
        for i, shape in enumerate(want):
            for key in ('leaf', 'exp_avg', 'exp_avg_sq'):
                assert tuple(got['%s%d' % (key, i)]) == shape, (key, i)
        assert 'leaf%d' % len(want) not in got.files


@pytest.mark.parametrize('case', ['varlen', 'depth'])
def test_packed_step_refusals_carry_jax_messages(case, one_rank_world):
    import jax
    from ocrd_keraslm_tpu.models import lstm_lm as jlm
    from ocrd_keraslm_tpu.parallel import pipeline as jp
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    from ocrd_keraslm_torch.parallel import pipeline as tp
    cfg = dict(width=W, depth=3 if case == 'depth' else D, length=T,
               voc_size=V, variable_length=case == 'varlen')
    want = NotImplementedError if case == 'varlen' else AssertionError
    mesh = tp.make_pipe_mesh(1, pipe_parallel=1)
    if case == 'depth':
        mesh.shape['pipe'] = 2          # two stages over three layers
    errors = []
    for make, m, module in (
            (tp.make_pipeline_train_step, mesh, tlm),
            (jp.make_pipeline_train_step,
             jp.make_pipe_mesh(2, pipe_parallel=2,
                               devices=jax.devices('cpu')), jlm)):
        with pytest.raises(want) as info:
            make(m, module.LMConfig(**cfg), 2)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert ('variable-length' if case == 'varlen' else 'divisible') \
        in errors[0]


def test_pipeline_honours_bf16(worlds):
    want_bf16 = _one_rank(worlds, 'bfloat16')[0]
    want_f32 = _one_rank(worlds)[0]
    got = np.load(worlds['two'] / 'bf16_0.npz')['sums']
    np.testing.assert_allclose(got, want_bf16, rtol=1e-4)
    assert abs(got[1] - want_f32[1]) > 1e-6     # the operands did round


def test_pack_unpack_round_trip_equals_jax(worlds):
    from ocrd_keraslm_tpu.models import lstm_lm as jlm
    from ocrd_keraslm_tpu.parallel import pipeline as jp
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    from ocrd_keraslm_torch.parallel import pipeline as tp
    from test_torch_model_core import jax_params
    cfg = _cfg(jlm)
    tree = worlds['tree']
    got = tp.pack_pipeline_params(tlm.params_from_numpy(tree, 'cpu'),
                                  _cfg(tlm), 2)
    want = jp.pack_pipeline_params(jax_params(tree), cfg, 2)
    for k in ('kernel', 'recurrent', 'bias', 'char_embedding'):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert not got['kernel'][1, 0, W:].any()    # layer 1's zero padding
    back = tp.unpack_pipeline_params(got, _cfg(tlm))
    for a, b in zip(leaves(back), leaves(tree)):
        np.testing.assert_array_equal(a, b)
    inp = worlds['inputs']
    carry = (inp['h'], inp['c'])
    for a, b in zip(tp.pack_carry(carry, 2), jp.pack_carry(carry, 2)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tp.unpack_carry(tp.pack_carry(carry, 2)), carry):
        np.testing.assert_array_equal(a, b)


def test_cli_mesh_2p(worlds):
    """``keraslm-rate train --mesh 2p`` on two ranks: both finish with
    one history, rank 0 writes the model and the checkpoints."""
    got = []
    for rank in range(2):
        with open(worlds['two'] / ('cli%d.json' % rank)) as fh:
            got.append(json.load(fh))
    assert got[0] == got[1] and got[0]['exit'] == 0
    assert np.isfinite(got[0]['history']['val_loss']).all()
    assert list((worlds['two'] / 'ck0').glob('ckpt.*.h5'))
    assert not (worlds['two'] / 'ck1').exists() or not list(
        (worlds['two'] / 'ck1').glob('*'))


@pytest.fixture
def one_rank_world(monkeypatch):
    """A world of one rank on the CPU in this process, left after the
    test."""
    from ocrd_keraslm_torch.parallel import multihost
    monkeypatch.setenv('KERASLM_PLATFORM', 'cpu')
    multihost.init_file(multihost.local_store())
    yield
    multihost.shutdown()


@pytest.mark.parametrize('case', ['microbatches', 'layout', 'varlen',
                                  'depth'])
def test_rejections_carry_jax_messages(case, tmp_path, one_rank_world):
    """The refusals of a pipeline run, with the JAX package's messages
    (``ocrd_keraslm_tpu/training.py``, ``parallel/pipeline.py``)."""
    import jax
    from ocrd_keraslm_tpu import training as jtraining
    from ocrd_keraslm_tpu.parallel.pipeline import (
        make_pipe_mesh as jmesh, make_pipeline_train_step_canonical as jstep)
    from ocrd_keraslm_tpu.rater import Rater as JRater
    from ocrd_keraslm_torch import training as ttraining
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    from ocrd_keraslm_torch.parallel.pipeline import (
        make_pipe_mesh, make_pipeline_train_step_canonical)
    from ocrd_keraslm_torch.rater import Rater
    files = write_corpus(tmp_path, seed=2, n=600)
    mesh = make_pipe_mesh(1, pipe_parallel=1)
    jm = jmesh(2, pipe_parallel=2, devices=jax.devices('cpu'))
    errors = []
    if case in ('varlen', 'depth'):
        cfg = dict(width=W, depth=3 if case == 'depth' else D, length=T,
                   voc_size=V, variable_length=case == 'varlen')
        want = NotImplementedError if case == 'varlen' else ValueError
        from ocrd_keraslm_tpu.models import lstm_lm as jlm
        for fn, m, module in ((make_pipeline_train_step_canonical, mesh,
                               tlm), (jstep, jm, jlm)):
            if case == 'depth' and module is tlm:
                m = make_pipe_mesh(1, pipe_parallel=1)
                m.shape['pipe'] = 2     # two stages over three layers
            try:
                fn(m, module.LMConfig(**cfg), 2)
            except (want, AssertionError) as err:
                errors.append(str(err))
        assert len(errors) == 2 and errors[0] == errors[1], errors
        return
    for r, mod, m in ((Rater(device='cpu'), ttraining, mesh),
                      (JRater(), jtraining, jm)):
        r.width, r.depth, r.length = W, D, 16
        r.batch_size = 8
        if case == 'microbatches':
            r.pipe_microbatches = 3
        else:
            r.stateful = False
        r.mesh = m
        r.configure()
        old = mod.EPOCHS
        mod.EPOCHS = 1
        try:
            with pytest.raises(ValueError) as info:
                r.train(files)
        finally:
            mod.EPOCHS = old
        errors.append(str(info.value))
    if case == 'microbatches':
        # one rank holds the 8 rows JAX's 2-stage mesh gives each device
        assert errors[0].startswith('per-device batch 8 not divisible by 3')
        assert errors[1].startswith('per-device batch 8 not divisible by 3')
    assert errors[0] == errors[1]


if __name__ == '__main__':
    worker_main({'two': _task_two, 'four': _task_four})
