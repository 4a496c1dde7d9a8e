"""Joining the process group and training over several ranks with the
port's ``parallel/multihost.py``, as ``tests/test_multihost.py`` holds
the JAX package's:

* the partial ``KERASLM_*`` configurations are refused with the JAX
  package's messages (and the command line maps them to a usage error);
* ``keraslm-rate train --mesh 2`` on two real processes joined through
  ``KERASLM_COORDINATOR``/``KERASLM_NUM_PROCESSES``/``KERASLM_PROCESS_ID``
  (a free port, retried on environment flakes as the JAX test retries):
  both ranks finish with one loss, rank 0 alone writes the model and the
  checkpoints, and the JAX package loads that model and rates as the
  port does (probabilities within 2e-3, float16 as they leave the
  device; perplexity rtol 1e-4);
* a single-host world of two ranks (``file://`` store): a vocabulary-
  parallel (1x2) run's checkpoint gathered from the shards, and a mesh
  run resumed from its snapshot equal to the uninterrupted mesh run
  (every history key within rtol 1e-5), as ``tests/test_resume.py``
  holds JAX's;
* a world that spans hosts (``LOCAL_WORLD_SIZE=1`` per rank, as
  ``torchrun`` sets it on each of two nodes) refuses pipeline meshes,
  train-state snapshots and a model axis across hosts, with the JAX
  package's messages."""
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from test_torch_parallel import (REPO, launch, train_rater_run, worker_main,
                                 write_corpus)

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

# failure signatures of the environment (a port taken between the probe
# and the bind, a slow rendezvous on a loaded host): retried with a
# fresh port; anything else fails at once
_ENV_FLAKE = ('Address already in use', 'EADDRINUSE', 'Connection refused',
              'timed out', 'Timed out', 'timeout')


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ----------------------------------------------------------------------
# the rank's work
# ----------------------------------------------------------------------

def _task_single_host(rank, out):
    from ocrd_keraslm_torch.models.lstm_lm import params_to_numpy
    from ocrd_keraslm_torch.parallel.mesh import make_mesh
    from test_torch_parallel import leaves
    corpus = os.path.join(out, '..', 'corpus')
    files = sorted(os.path.join(corpus, f) for f in os.listdir(corpus))
    r = train_rater_run(files, os.path.join(out, 'ck%d' % rank),
                        make_mesh(2, model_parallel=2), epochs=1)
    np.savez(os.path.join(out, 'final%d.npz' % rank),
             *leaves(params_to_numpy(r.params)))
    snap = os.path.join(out, 'snap')
    hist = {}
    for tag, epochs, resume in (('a', 3, None), ('b', 2, snap),
                                ('c', 3, snap)):
        r = train_rater_run(files, os.path.join(out, 'ck_%s%d' % (tag, rank)),
                            make_mesh(2, model_parallel=2), epochs=epochs,
                            resume_dir=resume)
        hist[tag] = r.history
    with open(os.path.join(out, 'resume%d.json' % rank), 'w') as fh:
        json.dump(hist, fh)


def _task_two_hosts(rank, out):
    from ocrd_keraslm_torch.parallel import multihost
    from ocrd_keraslm_torch.parallel.mesh import make_mesh
    from ocrd_keraslm_torch.scripts.run import cli
    assert multihost.is_multihost()
    corpus = os.path.join(out, '..', 'corpus')
    files = sorted(os.path.join(corpus, f) for f in os.listdir(corpus))
    got = {}
    res = CliRunner().invoke(cli, ['train', '-m', os.path.join(out, 'm.h5'),
                                   '-w', '16', '-d', '2', '--mesh', '2p',
                                   corpus])
    got['pipe'] = [res.exit_code, res.output]
    try:
        train_rater_run(files, os.path.join(out, 'ck%d' % rank),
                        make_mesh(2), resume_dir=os.path.join(out, 'snap'))
    except ValueError as err:
        got['resume'] = str(err)
    try:
        multihost.make_global_mesh(model_parallel=2)
    except ValueError as err:
        got['model_axis'] = str(err)
    with open(os.path.join(out, 'refusals%d.json' % rank), 'w') as fh:
        json.dump(got, fh)


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------

def test_init_multihost_rejects_partial_config(monkeypatch):
    """The cases of ``tests/test_multihost.py``: both halves of a
    partial explicit configuration are refused up front."""
    import torch.distributed as dist
    from ocrd_keraslm_torch.parallel.multihost import init_multihost
    if dist.is_initialized():
        pytest.skip('process already in a group')
    for var in ('KERASLM_COORDINATOR', 'KERASLM_NUM_PROCESSES',
                'KERASLM_PROCESS_ID'):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match='KERASLM_COORDINATOR is not'):
        init_multihost(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match='needs both'):
        init_multihost(coordinator='127.0.0.1:9999')
    monkeypatch.setenv('KERASLM_COORDINATOR', '127.0.0.1:9999')
    monkeypatch.setenv('KERASLM_NUM_PROCESSES', '2')
    with pytest.raises(ValueError, match='needs both'):
        init_multihost()
    assert not dist.is_initialized()


@pytest.mark.parametrize('env, match', [
    ({'KERASLM_PROCESS_ID': '0'}, 'KERASLM_COORDINATOR is not'),
    ({'KERASLM_COORDINATOR': '127.0.0.1:9'}, 'needs both'),
    ({'KERASLM_MULTIHOST': '1'}, 'multihost initialization failed')])
def test_cli_maps_partial_config_to_usage_error(env, match, monkeypatch):
    """As the JAX package's ``cli()`` does, at the entry of every
    command: a usage error (exit 2), never independent training."""
    from ocrd_keraslm_torch.scripts.run import cli
    for var in ('KERASLM_COORDINATOR', 'KERASLM_NUM_PROCESSES',
                'KERASLM_PROCESS_ID', 'KERASLM_MULTIHOST', 'RANK',
                'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    res = CliRunner().invoke(cli, ['print-history', '-m', 'none.h5'])
    assert res.exit_code == 2, res.output
    assert match in res.output


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp('mh_corpus')
    write_corpus(d, seed=5, n=1200)
    return d


@pytest.fixture(scope='module')
def cli_world(tmp_path_factory, corpus):
    """Two real ``keraslm-rate train --mesh 2`` processes over
    ``KERASLM_*`` on one free port (retried with a fresh one on an
    environment flake)."""
    tmp = tmp_path_factory.mktemp('mh_cli')
    model = str(tmp / 'model.h5')
    base = dict(os.environ, KERASLM_PLATFORM='cpu', OMP_NUM_THREADS='1',
                KERASLM_NUM_PROCESSES='2',
                PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH',
                                                              ''))
    base.pop('XLA_FLAGS', None)
    for attempt in range(3):
        port = str(_free_port())
        procs = []
        for pid in range(2):
            env = dict(base, KERASLM_COORDINATOR='127.0.0.1:' + port,
                       KERASLM_PROCESS_ID=str(pid),
                       KERASLM_CKPT_DIR=str(tmp / ('ck%d' % pid)))
            procs.append(subprocess.Popen(
                [sys.executable, '-m', 'ocrd_keraslm_torch.scripts.run',
                 'train', '-m', model, '-w', '16', '-d', '1', '-l', '16',
                 '-b', '8', '-e', '2', '--mesh', '2', str(corpus)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=REPO))
        outs, failed = [], None
        for p in procs:
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                failed = failed or 'timeout:\n' + out[-3000:]
                continue
            outs.append(out)
            if p.returncode != 0:
                failed = failed or out[-3000:]
        if failed is None:
            return {'outs': outs, 'model': model, 'dir': tmp}
        if attempt == 2 or not any(s in failed for s in _ENV_FLAKE):
            raise AssertionError(failed)


def test_two_rank_cli_train_agrees(cli_world):
    finals = []
    for out in cli_world['outs']:
        m = re.search(r'training finished with val_loss ([\d.]+)', out)
        assert m, out[-2000:]
        finals.append(m.group(1))
        assert 'backend gloo' in out
    assert finals[0] == finals[1], finals


def test_rank0_alone_writes(cli_world):
    assert os.path.isfile(cli_world['model'])
    assert list((cli_world['dir'] / 'ck0').glob('ckpt.*.h5'))
    assert not (cli_world['dir'] / 'ck1').exists() or not list(
        (cli_world['dir'] / 'ck1').glob('*'))


def test_jax_loads_and_rates_the_model_alike(cli_world):
    from ocrd_keraslm_tpu.rater import Rater as JRater
    from ocrd_keraslm_torch.rater import Rater
    model = cli_world['model']
    raters = []
    for r in (JRater(), Rater(device='cpu')):
        r.load_config(model)
        r.configure()
        r.load_weights(model)
        raters.append(r)
    text = 'abcde fgh abc'
    (jp, jppl), (tp, tppl) = (r.rate2(text, None) for r in raters)
    np.testing.assert_allclose([p for _, p in tp], [p for _, p in jp],
                               rtol=0, atol=2e-3)
    assert tppl == pytest.approx(jppl, rel=1e-4)


@pytest.fixture(scope='module')
def single_host_world(tmp_path_factory, corpus):
    tmp = tmp_path_factory.mktemp('mh_single')
    os.symlink(corpus, tmp / 'corpus')
    return launch(__file__, 'single_host', 2, tmp)


def test_tp_checkpoint_gathered_from_shards(single_host_world):
    """A 1x2 (vocabulary-parallel) run: rank 0's best-only checkpoint
    holds the whole embedding, gathered from both shards, equal to the
    gathered weights the run ends with."""
    from ocrd_keraslm_torch.utils import h5io
    from ocrd_keraslm_torch.models.lstm_lm import LMConfig
    cks = sorted((single_host_world / 'ck0').glob('ckpt.*.h5'))
    assert len(cks) == 1
    assert not (single_host_world / 'ck1').exists() or not list(
        (single_host_world / 'ck1').glob('*'))
    final = np.load(single_host_world / 'final0.npz')
    emb = final['arr_0']
    assert emb.shape == (10, 16)       # 9 chars and index 0, both halves
    got = h5io.load_weights(str(cks[0]), LMConfig(
        width=16, depth=2, length=32, voc_size=10))
    np.testing.assert_array_equal(got['char_embedding'], emb)
    np.testing.assert_array_equal(got['lstm'][1]['kernel'], final['arr_5'])
    other = np.load(single_host_world / 'final1.npz')
    for k in final.files:
        np.testing.assert_array_equal(final[k], other[k])


def test_mesh_resume_matches_uninterrupted(single_host_world):
    for rank in range(2):
        with open(single_host_world / ('resume%d.json' % rank)) as fh:
            hist = json.load(fh)
        assert len(hist['c']['loss']) == 3
        for key in hist['a']:
            np.testing.assert_allclose(hist['c'][key], hist['a'][key],
                                       rtol=1e-5, err_msg=key)


@pytest.fixture(scope='module')
def two_hosts_world(tmp_path_factory, corpus):
    tmp = tmp_path_factory.mktemp('mh_two_hosts')
    os.symlink(corpus, tmp / 'corpus')
    out = launch(__file__, 'two_hosts', 2, tmp,
                 env={'LOCAL_WORLD_SIZE': '1', 'LOCAL_RANK': '0'})
    got = []
    for rank in range(2):
        with open(out / ('refusals%d.json' % rank)) as fh:
            got.append(json.load(fh))
    assert got[0] == got[1]
    return got[0]


def test_multihost_refuses_pipeline_mesh(two_hosts_world):
    code, output = two_hosts_world['pipe']
    assert code == 2
    assert ('pipeline meshes (--mesh 2p) are single-host; unset '
            'KERASLM_COORDINATOR/KERASLM_NUM_PROCESSES or use a DPxMP mesh '
            '(multi-host dp/tp)') in ' '.join(output.split())


def test_multihost_refuses_resume_dir(two_hosts_world):
    assert two_hosts_world['resume'].startswith(
        'resume_dir under multihost training is not supported: '
        'snapshot/restore is single-controller.')


def test_multihost_keeps_model_axis_in_one_host(two_hosts_world):
    assert two_hosts_world['model_axis'] == \
        'model axis must fit inside one host (1 ranks/host)'


if __name__ == '__main__':
    worker_main({'single_host': _task_single_host,
                 'two_hosts': _task_two_hosts})
