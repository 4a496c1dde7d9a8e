"""The port's ``parallel/`` on a 2x2 rank mesh (4 processes on the CPU,
gloo over a ``file://`` store) against the JAX package's
``make_mesh(4, model_parallel=2)`` on the virtual CPU devices, and
against the port on one rank.

One world of four ranks runs every check once (this file is also the
rank's script, ``python tests/test_torch_parallel.py TASK RANK N STORE
OUT``) and writes its results; each comparison is a test of its own.

Tolerances: the dp/tp step's NLL within rtol 1e-4 of JAX's sharded step
(``tests/test_parallel.py`` holds JAX's sharded step to its unsharded
one so), its loss, NLL, accuracy and carry within rtol 1e-5 / atol 1e-6
of the port's one-rank step (the sums are reduced in another order),
the parameters after the step within atol 1e-5 of one rank's and 2.5e-3
of JAX's (Adam's first step moves an element whose gradient is of
rounding size by up to the learning rate, see
``tests/test_torch_training.py``).  Sharded scoring, batch decoding and
generation equal one rank's results exactly (every row, document or
stream is computed alone), and JAX's sharded results within the port's
parity tolerances (probabilities 2e-3 as float16 leaves the device,
decode scores 1e-4, generated strings equal)."""
import contextlib
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
W, D, V, T, B = 16, 2, 32, 8, 8
CONTEXTS = ((20, 4),)
CHARS = 'abcdefghijk'
PREFIXES = ['abcd a', 'bcd ab', 'cd abc', 'd abcd', 'kjih g']


# ----------------------------------------------------------------------
# worlds of rank processes (shared by the other test_torch_* files of
# parallel/)
# ----------------------------------------------------------------------

def launch(script, task, n, tmp, env=None, timeout=400, args=()):
    """Run ``script TASK RANK N STORE OUT`` as ``n`` rank processes on
    the CPU over a fresh ``file://`` store; returns OUT.  Any rank that
    fails or outlives ``timeout`` fails the world, with its output."""
    out = tmp / task
    out.mkdir(exist_ok=True)
    store = str(tmp / ('store_' + task))
    full = dict(os.environ, KERASLM_PLATFORM='cpu', OMP_NUM_THREADS='1',
                PYTHONPATH=REPO + os.pathsep + os.environ.get(
                    'PYTHONPATH', ''))
    full.pop('XLA_FLAGS', None)
    full.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, script, task, str(r), str(n), store, str(out)]
        + list(args), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=full, cwd=REPO) for r in range(n)]
    fails = []
    for r, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            text, _ = p.communicate()
            fails.append('rank %d timed out:\n%s' % (r, text[-3000:]))
            continue
        (out / ('log%d.txt' % r)).write_text(text)
        if p.returncode != 0:
            fails.append('rank %d exit %d:\n%s' % (r, p.returncode,
                                                    text[-3000:]))
    if fails:
        raise AssertionError('\n'.join(fails))
    return out


def worker_main(tasks):
    """The rank side of :func:`launch`: join the world, run the task,
    leave."""
    task, rank, n, store, out = sys.argv[1:6]
    torch.set_num_threads(1)
    from ocrd_keraslm_torch.parallel import multihost
    multihost.init_file(store, int(n), int(rank))
    try:
        tasks[task](int(rank), out, *sys.argv[6:])
    finally:
        multihost.shutdown()


@contextlib.contextmanager
def one_rank_mesh(second_axis='model'):
    """A mesh of one rank on the CPU in this process (a world of one
    over a ``file://`` store), left on exit."""
    from ocrd_keraslm_torch.parallel import multihost
    from ocrd_keraslm_torch.parallel.mesh import make_mesh
    old = os.environ.get('KERASLM_PLATFORM')
    os.environ['KERASLM_PLATFORM'] = 'cpu'
    try:
        yield make_mesh(1, 1, second_axis)
    finally:
        multihost.shutdown()
        if old is None:
            del os.environ['KERASLM_PLATFORM']
        else:
            os.environ['KERASLM_PLATFORM'] = old


def save_tree(path, tree):
    flat = {'char_embedding': np.asarray(tree['char_embedding'])}
    for i, e in enumerate(tree['context_embeddings']):
        flat['ctx%d' % i] = np.asarray(e)
    for i, lp in enumerate(tree['lstm']):
        for k in ('kernel', 'recurrent', 'bias'):
            flat['lstm%d_%s' % (i, k)] = np.asarray(lp[k])
    np.savez(path, **flat)


def load_tree(path):
    f = np.load(path)
    n_ctx = sum(k.startswith('ctx') for k in f.files)
    depth = sum(k.endswith('_bias') for k in f.files)
    return {'char_embedding': f['char_embedding'],
            'context_embeddings': [f['ctx%d' % i] for i in range(n_ctx)],
            'lstm': [{k: f['lstm%d_%s' % (i, k)]
                      for k in ('kernel', 'recurrent', 'bias')}
                     for i in range(depth)]}


def leaves(tree):
    return [np.asarray(tree['char_embedding'])] + [
        np.asarray(e) for e in tree['context_embeddings']] + [
        np.asarray(lp[k]) for lp in tree['lstm']
        for k in ('kernel', 'recurrent', 'bias')]


# ----------------------------------------------------------------------
# inputs (numpy, from seeds) and lattices built with either package's
# TextEquivType
# ----------------------------------------------------------------------

def step_inputs(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[1, T - 3:] = 0.0          # rank rows differ in their mask sums
    mask[B - 1, :T - 1] = 0.0
    x_mask = np.ones((B, T), np.float32)
    for b in range(B):             # left-padded windows, shards differ
        x_mask[b, :b % 5] = 0.0
    y1_mask = np.ones((B,), np.float32)
    y1_mask[[2, 3]] = 0.0
    return dict(
        x=rng.integers(1, V, (B, T)).astype(np.int32),
        y=rng.integers(1, V, (B, T)).astype(np.int32),
        z=rng.integers(0, 20, (B,)).astype(np.int32),
        mask=mask, x_mask=x_mask,
        y1=rng.integers(1, V, (B,)).astype(np.int32), y1_mask=y1_mask)


def doc_graphs(te_cls):
    """Linear lattices of the serving checks: mixed documents for the
    engine and the batch kernel, then documents with long merged runs
    beside documents of 1-char alternatives (per-shard step bounds)."""
    import networkx as nx

    def chain(spec):
        g = nx.DiGraph()
        g.add_node(0)
        for e, alts in enumerate(spec):
            g.add_edge(e, e + 1, element='e%d' % e, alternatives=[
                te_cls(Unicode=u, conf=c, index=i)
                for i, (u, c) in enumerate(alts)])
        return g
    rng = np.random.default_rng(5)
    mixed = []
    for k in range(5):
        spec = []
        for e in range(6 + 2 * k):
            n_alts = 1 + int(rng.integers(0, 3))
            spec.append([(''.join(rng.choice(list(CHARS),
                                              1 + int(rng.integers(0, 2)))),
                          float(rng.uniform(0.5, 1.0)))
                         for _ in range(n_alts)])
        mixed.append(chain(spec))
    bounds = []
    for seed in range(2):
        text = ('abcd' * 5)[:14 + seed]
        bounds.append(chain([[(c, 0.8), ('ef'[seed], 0.75)] if e == 0
                             else [(c, 0.9)] for e, c in enumerate(text)]))
    for seed in range(2):
        text = ('abcd' * 5)[:14 + seed]
        bounds.append(chain([[(c, 0.8), ('ghij'[(e + seed) % 4], 0.75)]
                             for e, c in enumerate(text)]))
    return mixed, bounds


def texts_of():
    rng = np.random.default_rng(5)
    return [''.join(rng.choice(list(CHARS + ' '), 30 + 7 * k))
            for k in range(8)]


def paths_json(results):
    return [{'text': [te.Unicode for _, te, _ in p],
             'elements': [el for el, _, _ in p],
             'scores': [float(s) for _, _, s in p], 'entropy': float(e)}
            for p, e in results]


def write_corpus(d, seed=3, n=2000):
    rng = np.random.default_rng(seed)
    files = []
    for name in ('a_b_1800', 'c_d_1810'):
        p = d / (name + '.txt')
        p.write_text(''.join('abcdefgh '[i] for i in rng.integers(0, 9, n)))
        files.append(str(p))
    return files


def train_rater_run(files, ckpt_dir, mesh=None, seed=23, epochs=2,
                    resume_dir=None, model_parallel=False):
    """A seeded training run of the port's Rater (over ``mesh`` when
    given).  One rank replays the reseeding that
    :func:`multihost.align_seed` makes in a world of several."""
    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.rater import Rater
    random.seed(seed)
    np.random.seed(seed)
    if mesh is None:
        aligned = np.random.randint(0, 2 ** 31 - 1)
        np.random.seed(aligned)
        random.seed(aligned)
    old = training.EPOCHS
    training.EPOCHS = epochs
    try:
        r = Rater(device='cpu')
        r.width, r.depth, r.length = W, D, 32
        r.stateful = True
        r.batch_size = 8
        r.mesh = mesh
        r.ckpt_dir = ckpt_dir
        r.resume_dir = resume_dir
        r.configure()
        r.train(files)
        return r
    finally:
        training.EPOCHS = old


# ----------------------------------------------------------------------
# the rank's work
# ----------------------------------------------------------------------

def _rank_steps(mesh, inp, tree, out):
    """The dp/tp train and eval steps on this rank's rows."""
    from ocrd_keraslm_torch.models.lstm_lm import (LMConfig,
                                                   params_from_numpy,
                                                   params_to_numpy,
                                                   zero_carry)
    from ocrd_keraslm_torch.parallel import comm
    from ocrd_keraslm_torch.parallel.mesh import (gather_adam_state,
                                                  gather_params,
                                                  local_rows)
    from ocrd_keraslm_torch.parallel.train import (make_sharded_eval_step,
                                                   make_sharded_train_step)
    res = {}

    def rows(a):
        return torch.from_numpy(local_rows(mesh, a))

    def run(tag, cfg, y, mask, x_mask=None, rng=None, carry=True):
        step, shard_fn = make_sharded_train_step(mesh, cfg)
        params, opt = shard_fn(params_from_numpy(tree, 'cpu'))
        res[tag + '_emb_rows'] = params['char_embedding'].shape[0]
        c0 = zero_carry(cfg, B // mesh.shape['data'], 'cpu')
        c, loss, nll, acc = step(
            params, opt, rows(inp['x']).long(), [rows(inp['z']).long()],
            rows(y).long(), rows(mask),
            c0, rng, None if x_mask is None else rows(x_mask))
        res[tag + '_sums'] = np.array([loss.item(), nll.item(), acc.item()])
        if carry:
            for name, t in zip('hc', c):
                res[tag + '_' + name] = comm.all_gather_rows(
                    t, mesh.data, dim=1).numpy()
        for i, a in enumerate(leaves(params_to_numpy(
                gather_params(mesh, params)))):
            res['%s_p%d' % (tag, i)] = a
        state = opt.state_dict()['state']
        res[tag + '_mu0_rows'] = state[0]['exp_avg'].shape[0]
        res[tag + '_mu1_rows'] = state[1]['exp_avg'].shape[0]
        full = gather_adam_state(mesh, opt)['state']
        for i in range(len(full)):
            res['%s_mu%d' % (tag, i)] = full[i]['exp_avg'].numpy()
            res['%s_nu%d' % (tag, i)] = full[i]['exp_avg_sq'].numpy()
        return params, cfg

    cfg0 = LMConfig(width=W, depth=D, length=T, voc_size=V,
                    contexts=CONTEXTS, dropout=0.0)
    params, cfg = run('dp0', cfg0, inp['y'], inp['mask'])
    estep = make_sharded_eval_step(mesh, cfg)
    nll, acc, c = estep(params, rows(inp['x']).long(),
                        [rows(inp['z']).long()], rows(inp['y']).long(),
                        rows(inp['mask']),
                        zero_carry(cfg, B // mesh.shape['data'], 'cpu'))
    res['eval'] = np.array([nll.item(), acc.item()])
    run('drop', cfg0.replace(dropout=0.1), inp['y'], inp['mask'],
        rng=torch.Generator().manual_seed(5))
    run('varlen', cfg0.replace(stateful=False, variable_length=True),
        inp['y1'], inp['y1_mask'], x_mask=inp['x_mask'], carry=False)
    run('partial', cfg0.replace(stateful=False), inp['y1'],
        inp['y1_mask'], x_mask=inp['x_mask'], carry=False)
    np.savez(os.path.join(out, 'steps%d.npz' % mesh.rank), **res)


def _rank_serving(mesh, model, out):
    """Scoring, batch decoding (engine, kernel, per-shard step bounds)
    and generation with ``rater.mesh`` set."""
    from ocrd_keraslm_torch.rater import Rater
    from ocrd_keraslm_torch.wrapper.page import TextEquivType
    r = Rater(device='cpu')
    r.load_config(model)
    r.configure()
    r.load_weights(model)
    r.mesh = mesh
    mixed, bounds = doc_graphs(TextEquivType)
    res = {'scores': [list(map(float, p)) for p in r.rate_batch(
        texts_of())]}
    r.fused_decode = False
    res['engine'] = paths_json(r.rate_best_batch(mixed, beam_width=4))
    r.fused_decode = True
    res['kernel'] = paths_json(r.rate_best_batch(mixed, beam_width=4))
    res['bounds'] = paths_json(r.rate_best_batch(bounds, beam_width=4))
    # two batches in flight, finished out of order
    pa = r.rate_best_batch_begin(mixed[:3], beam_width=4)
    pb = r.rate_best_batch_begin(mixed[3:], beam_width=4)
    res['split'] = paths_json(r.rate_best_batch_finish(pb)
                              + r.rate_best_batch_finish(pa))
    res['generate'] = r.generate_batch(PREFIXES, 12)
    with open(os.path.join(out, 'serving%d.json' % mesh.rank), 'w') as fh:
        json.dump(res, fh)


def _rank_global_batch(mesh, inp, out):
    """``multihost.global_batch`` from this rank's rows (the ranks after
    the first of a data row pass other inputs) against ``shard_batch``
    and ``shard_carry`` of the whole batch; then rows of unequal shapes
    (rank 3 passes one row fewer)."""
    from ocrd_keraslm_torch.data import Batch
    from ocrd_keraslm_torch.parallel import multihost
    from ocrd_keraslm_torch.parallel.mesh import (local_rows, shard_batch,
                                                  shard_carry)
    rng = np.random.default_rng(9)
    carry = tuple(rng.normal(size=(D, B, W)).astype(np.float32)
                  for _ in range(2))
    want = shard_batch(mesh, Batch(x=inp['x'], zs=[inp['z']], y=inp['y'],
                                   mask=inp['mask']))
    want_carry = shard_carry(mesh, carry)

    def args(cut=0):
        def rows(a, axis=0):
            return local_rows(mesh, a, axis)[
                (slice(None),) * axis + (slice(0, B // 2 - cut),)]
        return (rows(inp['x']) + mesh.second_index, [rows(inp['z'])],
                rows(inp['y']), rows(inp['mask']),
                tuple(rows(c, 1) for c in carry))
    x, zs, y, mask, got_carry = multihost.global_batch(mesh, *args())
    res = {'equal': [np.array_equal(x.numpy(), want.x),
                     np.array_equal(zs[0].numpy(), want.zs[0]),
                     np.array_equal(y.numpy(), want.y),
                     np.array_equal(mask.numpy(), want.mask)]
           + [np.array_equal(a.numpy(), b)
              for a, b in zip(got_carry, want_carry)],
           'dtypes': [str(t.dtype) for t in (x, zs[0], y, mask)
                      + got_carry]}
    try:
        multihost.global_batch(mesh, *args(int(mesh.rank == 3)))
        res['refused'] = None
    except ValueError as err:
        res['refused'] = str(err)
    with open(os.path.join(out, 'global_batch%d.json' % mesh.rank),
              'w') as fh:
        json.dump(res, fh)


def _task_all(rank, out, model):
    from ocrd_keraslm_torch.parallel import comm
    from ocrd_keraslm_torch.parallel.mesh import make_mesh
    import pathlib
    mesh = make_mesh(4, model_parallel=2)
    assert (mesh.data_index, mesh.second_index) == divmod(rank, 2)
    inp = dict(np.load(os.path.join(out, '..', 'inputs.npz')))
    tree = load_tree(os.path.join(out, '..', 'params.npz'))
    _rank_steps(mesh, inp, tree, out)
    _rank_global_batch(mesh, inp, out)
    files = sorted(str(p) for p in pathlib.Path(out, '..', 'corpus')
                   .glob('*.txt'))
    r = train_rater_run(files, os.path.join(out, 'ck%d' % rank), mesh)
    with open(os.path.join(out, 'history%d.json' % rank), 'w') as fh:
        json.dump({'history': r.history, 'status': r.status}, fh)
    _rank_serving(make_mesh(4, model_parallel=2), model, out)
    with open(os.path.join(out, 'comm%d.json' % rank), 'w') as fh:
        json.dump({'staged_bytes': comm.staged_bytes, 'calls': comm.calls,
                   'backend': mesh.backend}, fh)


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_rater():
    from test_decode_exhaustive import make_rater
    jr = make_rater(5)
    jr.fused_decode = True   # JAX's Pallas batch kernel, interpret mode
    return jr


@pytest.fixture(scope='module')
def world(tmp_path_factory, jax_rater):
    from test_torch_model_core import seeded_params
    from test_torch_rater import port_of
    from ocrd_keraslm_torch.utils import h5io
    from ocrd_keraslm_tpu.models.lstm_lm import LMConfig
    tmp = tmp_path_factory.mktemp('parallel')
    cfg = LMConfig(width=W, depth=D, length=T, voc_size=V,
                   contexts=CONTEXTS, dropout=0.0)
    tree = seeded_params(cfg, 21)
    save_tree(tmp / 'params.npz', tree)
    np.savez(tmp / 'inputs.npz', **step_inputs())
    (tmp / 'corpus').mkdir()
    write_corpus(tmp / 'corpus')
    tr = port_of(jax_rater)
    model = str(tmp / 'model.h5')
    h5io.save_model(model, tr.params, tr.cfg, tr.vocab)
    out = launch(__file__, 'all', 4, tmp, args=[model])
    return {'dir': out, 'tree': tree, 'inputs': step_inputs(),
            'corpus': sorted(str(p) for p in (tmp / 'corpus').glob('*.txt')),
            'model': model, 'tmp': tmp}


def _steps(world, rank=0):
    return np.load(world['dir'] / ('steps%d.npz' % rank))


def _serving(world, rank=0):
    with open(world['dir'] / ('serving%d.json' % rank)) as fh:
        return json.load(fh)


def test_global_batch_gives_the_sharded_rows(world):
    """Every rank's ``global_batch`` equals its ``shard_batch`` and
    ``shard_carry`` rows, the ranks of a data row its first rank's; rows
    of unequal shapes are refused on every rank."""
    for rank in range(4):
        with open(world['dir'] / ('global_batch%d.json' % rank)) as fh:
            got = json.load(fh)
        assert got['equal'] == [True] * 6, (rank, got)
        assert got['dtypes'] == ['torch.int64'] * 3 + ['torch.float32'] * 3
        assert 'same shapes' in got['refused'], got


def _one_rank_step(world, dropout=0.0, layout='stateful', rng=None):
    """The port's unsharded train_step on the full batch."""
    import ocrd_keraslm_torch.training as tt
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    inp = world['inputs']
    cfg = tlm.LMConfig(width=W, depth=D, length=T, voc_size=V,
                       contexts=CONTEXTS, dropout=dropout,
                       stateful=layout == 'stateful',
                       variable_length=layout == 'varlen')
    params = tlm.params_from_numpy(world['tree'], 'cpu')
    for t in tlm.param_leaves(params):
        t.requires_grad_()
    opt = tt.make_optimizer(params)
    y, mask, x_mask = ((inp['y'], inp['mask'], None) if layout == 'stateful'
                       else (inp['y1'], inp['y1_mask'], inp['x_mask']))
    carry, loss, nll, acc = tt.train_step(
        params, opt, cfg, torch.from_numpy(inp['x']).long(),
        [torch.from_numpy(inp['z']).long()], torch.from_numpy(y).long(),
        torch.from_numpy(mask), tlm.zero_carry(cfg, B, 'cpu'), rng,
        None if x_mask is None else torch.from_numpy(x_mask))
    return (np.array([loss.item(), nll.item(), acc.item()]), carry,
            leaves(tlm.params_to_numpy(params)), opt, params)


def _close_step(res, tag, want_sums, want_leaves, carry=None):
    np.testing.assert_allclose(res[tag + '_sums'], want_sums, rtol=1e-5,
                               atol=1e-6)
    if carry is not None:
        for name, t in zip('hc', carry):
            np.testing.assert_allclose(res[tag + '_' + name], t.numpy(),
                                       rtol=1e-5, atol=1e-6)
    for i, want in enumerate(want_leaves):
        np.testing.assert_allclose(res['%s_p%d' % (tag, i)], want, rtol=0,
                                   atol=1e-5, err_msg='leaf %d' % i)


def test_dp_tp_step_matches_one_rank(world):
    sums, carry, want, _, _ = _one_rank_step(world)
    for rank in range(4):
        _close_step(_steps(world, rank), 'dp0', sums, want, carry)


def test_dp_tp_step_matches_jax_mesh(world):
    """Against ``make_sharded_train_step`` over JAX's 2x2 mesh, as
    ``tests/test_parallel.py::test_sharded_step_matches_single_device``
    holds JAX's."""
    import jax
    import jax.numpy as jnp
    from ocrd_keraslm_tpu.models.lstm_lm import LMConfig, zero_carry
    from ocrd_keraslm_tpu.parallel.mesh import make_mesh
    from ocrd_keraslm_tpu.parallel.train import make_sharded_train_step
    from ocrd_keraslm_tpu.training import _OPT
    from test_torch_model_core import jax_params
    cfg = LMConfig(width=W, depth=D, length=T, voc_size=V,
                   contexts=CONTEXTS, dropout=0.0)
    inp = world['inputs']
    params = jax_params(world['tree'])
    mesh = make_mesh(4, model_parallel=2, devices=jax.devices('cpu'))
    _, shard_fn, jit_step = make_sharded_train_step(mesh, cfg)
    sp, so, _ = shard_fn(params, _OPT.init(params))
    fn = jit_step(sp, so, n_contexts=1, stateful_targets=True)
    p2, _, c2, loss, nll, acc = fn(
        sp, so, jnp.asarray(inp['x']), (jnp.asarray(inp['z']),),
        jnp.asarray(inp['y']), jnp.asarray(inp['mask']),
        zero_carry(cfg, B), jax.random.PRNGKey(0))
    res = _steps(world)
    np.testing.assert_allclose(res['dp0_sums'][1], float(nll), rtol=1e-4)
    np.testing.assert_allclose(res['dp0_sums'][0], float(loss), rtol=1e-4)
    assert abs(res['dp0_sums'][2] - float(acc)) < 1e-6
    np.testing.assert_allclose(res['dp0_c'], np.asarray(c2[1]), rtol=2e-4,
                               atol=2e-5)
    for i, want in enumerate(leaves(jax.tree_util.tree_map(np.asarray,
                                                           p2))):
        np.testing.assert_allclose(res['dp0_p%d' % i], want, rtol=0,
                                   atol=2.5e-3)


def test_eval_step_over_mesh_matches_one_rank(world):
    import ocrd_keraslm_torch.training as tt
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    _, _, _, _, params = _one_rank_step(world)
    inp = world['inputs']
    cfg = tlm.LMConfig(width=W, depth=D, length=T, voc_size=V,
                       contexts=CONTEXTS, dropout=0.0)
    nll, acc, _ = tt.eval_step(
        params, cfg, torch.from_numpy(inp['x']).long(),
        [torch.from_numpy(inp['z']).long()],
        torch.from_numpy(inp['y']).long(), torch.from_numpy(inp['mask']),
        tlm.zero_carry(cfg, B, 'cpu'))
    np.testing.assert_allclose(_steps(world)['eval'],
                               [nll.item(), acc.item()], rtol=1e-5,
                               atol=1e-6)


def test_dropout_rows_match_one_rank(world):
    """Dropout 0.1: each rank keeps its rows of the full-batch masks, so
    the sharded step equals the unsharded one with the same
    generator."""
    sums, carry, want, _, _ = _one_rank_step(
        world, dropout=0.1, rng=torch.Generator().manual_seed(5))
    for rank in range(4):
        _close_step(_steps(world, rank), 'drop', sums, want, carry)


def test_adam_moments_sharded_like_params(world):
    """The vocab-sharded embedding's moments hold the rank's rows only;
    gathered, every moment equals one rank's."""
    _, _, _, opt, _ = _one_rank_step(world)
    res = _steps(world, 1)
    assert res['dp0_emb_rows'] == V // 2
    assert res['dp0_mu0_rows'] == V // 2
    assert res['dp0_mu1_rows'] == CONTEXTS[0][0]    # replicated table
    state = opt.state_dict()['state']
    for i in range(len(state)):
        np.testing.assert_allclose(res['dp0_mu%d' % i],
                                   state[i]['exp_avg'].numpy(), rtol=1e-4,
                                   atol=1e-9)
        np.testing.assert_allclose(res['dp0_nu%d' % i],
                                   state[i]['exp_avg_sq'].numpy(),
                                   rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize('layout', ['varlen', 'partial'])
def test_stateless_windows_over_mesh_match_one_rank(world, layout):
    """Variable-length and left-padded partial windows (``x_mask``),
    next-char targets, rank shares with different mask sums."""
    sums, _, want, _, _ = _one_rank_step(world, layout=layout)
    for rank in range(4):
        _close_step(_steps(world, rank), layout, sums, want)


def test_train_rater_over_mesh(world, tmp_path):
    """``train_rater`` with ``rater.mesh`` on a 2x2 mesh: every rank
    ends with the history of the port's one-rank run from the same
    seed (rtol 1e-5), and learns."""
    r = train_rater_run(world['corpus'], str(tmp_path / 'ck'))
    for rank in range(4):
        with open(world['dir'] / ('history%d.json' % rank)) as fh:
            got = json.load(fh)
        assert got['status'] == 2
        for key in r.history:
            np.testing.assert_allclose(got['history'][key], r.history[key],
                                       rtol=1e-5, err_msg=key)
    assert r.history['loss'][-1] < r.history['loss'][0]
    # the best-only checkpoint, gathered from the shards, from rank 0
    cks = sorted((world['dir'] / 'ck0').glob('ckpt.*.h5'))
    assert cks and not list((world['dir'] / 'ck1').glob('*'))


def test_sharded_scoring(world, jax_rater):
    from test_torch_rater import port_of
    want = port_of(jax_rater).rate_batch(texts_of())
    got = [_serving(world, rank)['scores'] for rank in range(4)]
    for g in got:
        assert g == [list(map(float, w)) for w in want]
    import jax
    from ocrd_keraslm_tpu.parallel.mesh import make_mesh
    jax_rater.mesh = make_mesh(2, model_parallel=1,
                               devices=jax.devices('cpu')[:2])
    jax_rater._sharded_score = None
    try:
        ref = jax_rater.rate_batch(texts_of())
    finally:
        jax_rater.mesh = None
    for a, b in zip(got[0], ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


def _same_paths(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g['text'] == w['text'] and g['elements'] == w['elements']
        np.testing.assert_allclose(g['scores'], w['scores'], rtol=0,
                                   atol=tol)
        assert g['entropy'] == pytest.approx(w['entropy'], abs=tol)


@pytest.mark.parametrize('kind', ['engine', 'kernel', 'bounds', 'split'])
def test_sharded_batch_decode_matches_one_rank(world, jax_rater, kind):
    from test_torch_rater import port_of
    from ocrd_keraslm_torch.wrapper.page import TextEquivType
    tr = port_of(jax_rater)
    mixed, bounds = doc_graphs(TextEquivType)
    tr.fused_decode = kind != 'engine'
    docs = bounds if kind == 'bounds' else mixed
    want = paths_json(tr.rate_best_batch(docs, beam_width=4))
    if kind == 'split':
        want = want[3:] + want[:3]
    for rank in range(4):
        _same_paths(_serving(world, rank)[kind], want, 0.0)


@pytest.mark.parametrize('kind', ['kernel', 'bounds'])
def test_sharded_batch_decode_matches_jax_mesh(world, jax_rater, kind):
    """Against JAX's fused batch decode over a 2-device data mesh
    (``tests/test_parallel.py``'s sharded fused decode and its
    per-shard step bounds)."""
    import jax
    from ocrd_keraslm_tpu.parallel.mesh import make_mesh
    from ocrd_keraslm_tpu.wrapper.page import TextEquivType
    mixed, bounds = doc_graphs(TextEquivType)
    jax_rater.mesh = make_mesh(2, model_parallel=1,
                               devices=jax.devices('cpu')[:2])
    try:
        want = paths_json(jax_rater.rate_best_batch(
            bounds if kind == 'bounds' else mixed, beam_width=4))
    finally:
        jax_rater.mesh = None
    got = _serving(world)[kind]
    assert [g['text'] for g in got] == [w['text'] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g['scores'], w['scores'], rtol=0,
                                   atol=1e-4)
        assert g['entropy'] == pytest.approx(w['entropy'], abs=1e-4)


def test_sharded_generation(world, jax_rater):
    """Five prompts over the data axis of 2 (one pad stream): equal to
    one rank's and to JAX's sharded ``generate_batch``."""
    from test_torch_rater import port_of
    import jax
    from ocrd_keraslm_tpu.parallel.mesh import make_mesh
    want = port_of(jax_rater).generate_batch(PREFIXES, 12)
    for rank in range(4):
        assert _serving(world, rank)['generate'] == want
    jax_rater.mesh = make_mesh(2, model_parallel=1,
                               devices=jax.devices('cpu')[:2])
    try:
        ref = jax_rater.generate_batch(PREFIXES, 12)
    finally:
        jax_rater.mesh = None
    assert want == ref


def test_gloo_on_the_cpu_stages_nothing(world):
    with open(world['dir'] / 'comm0.json') as fh:
        got = json.load(fh)
    assert got['backend'] == 'gloo' and got['calls'] > 0
    assert got['staged_bytes'] == 0     # CPU tensors go to gloo as they are


def test_vocabulary_not_divisible_by_model_axis_is_refused():
    """JAX's ``P('model', None)`` refuses V=33 over 2 (device_put); the
    port's shard boundaries refuse it alike."""
    import jax
    from ocrd_keraslm_tpu.models.lstm_lm import LMConfig, init_params
    from ocrd_keraslm_tpu.parallel.mesh import make_mesh as jmake_mesh
    from ocrd_keraslm_tpu.parallel.train import make_sharded_train_step
    from ocrd_keraslm_tpu.training import _OPT
    from ocrd_keraslm_torch.parallel.mesh import vocab_range

    class Two:
        n_model, second_index = 2, 1
    cfg = LMConfig(width=W, depth=1, length=T, voc_size=33)
    params = init_params(cfg, jax.random.PRNGKey(0))
    mesh = jmake_mesh(4, model_parallel=2, devices=jax.devices('cpu'))
    _, shard_fn, _ = make_sharded_train_step(mesh, cfg)
    with pytest.raises(ValueError, match='divisible by 2'):
        shard_fn(params, _OPT.init(params))
    with pytest.raises(ValueError, match='not divisible by the model axis'):
        vocab_range(Two, 33)
    assert vocab_range(Two, 32) == (16, 32)


if __name__ == '__main__':
    worker_main({'all': _task_all})
