"""Full train-state snapshots and the model directory format of the
port (``ocrd_keraslm_torch/utils/orbaxio.py``), as
``tests/test_resume.py`` and ``tests/test_orbax_profile.py`` hold the
JAX package's: a run killed in the middle of an epoch resumes from the
last completed epoch and matches the uninterrupted run (every history
key within rtol 1e-5); a snapshot's ``meta.json`` has the JAX
package's keys; a model directory round-trips bit for bit and its
``config.json`` equals JAX's; the JAX package's Orbax directories are
refused, never taken as empty."""
import json
import os
import random

import numpy as np
import pytest
import torch

import ocrd_keraslm_tpu.training as jtraining
from ocrd_keraslm_tpu.rater import Rater as JRater
import ocrd_keraslm_torch.training as training
from ocrd_keraslm_torch.rater import Rater
from ocrd_keraslm_torch.utils import orbaxio

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
GERMAN = os.path.join(REPO, 'pretrained', 'model_german.h5')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp('corpus')
    random.seed(7)
    words = ['die', 'der', 'und', 'ist', 'kant', 'vernunft', 'mensch']
    files = []
    for name in ['a_eins_1781.txt', 'b_zwei_1790.txt', 'c_drei_1800.txt']:
        path = d / name
        with open(path, 'w') as fh:
            for _ in range(60):
                fh.write(' '.join(random.choices(words, k=10)) + '\n')
        files.append(str(path))
    return files


def _configure(r, tmp_path, tag, resume_dir, width=16):
    r.width, r.depth, r.length = width, 1, 16
    r.batch_size = 32
    r.stateful = True
    r.train_streams = True
    r.ckpt_dir = str(tmp_path / ('ckpt_' + tag))
    if resume_dir:
        r.resume_dir = str(resume_dir)
    r.configure()


def _train(files, tmp_path, epochs, resume_dir=None, tag='a', width=16,
           rater_cls=Rater, module=training):
    """A seeded run: the same seeds give the same trajectory (the
    per-epoch data generator and the snapshot's dropout generator make
    a resumed run replay the cut epoch)."""
    old = module.EPOCHS, module.MIN_STEPS_BEFORE_STOP
    module.EPOCHS = epochs
    module.MIN_STEPS_BEFORE_STOP = 10 ** 9  # no early stop here
    try:
        random.seed(11)
        np.random.seed(13)
        r = rater_cls(device='cpu') if rater_cls is Rater else rater_cls()
        _configure(r, tmp_path, tag, resume_dir, width)
        r.train(files)
        return r
    finally:
        module.EPOCHS, module.MIN_STEPS_BEFORE_STOP = old


class _SimulatedKill(BaseException):
    """Raised in the middle of an epoch: nothing after the last
    committed snapshot survives."""


def _dying_prefetcher(real, instance, batch):
    class Dying:
        made = 0

        def __init__(self, gen):
            type(self).made += 1
            self.inner = real(gen)

        def __iter__(self):
            for n, b in enumerate(iter(self.inner)):
                # training and validation passes each prefetch: instance
                # 5 is epoch 3's training pass
                if type(self).made == instance and n == batch:
                    self.inner.close()
                    raise _SimulatedKill()
                yield b
    return Dying


def test_kill_resume_matches_uninterrupted(corpus, tmp_path, monkeypatch):
    ra = _train(corpus, tmp_path, 4, tag='a')
    assert ra.status == 2 and len(ra.history['loss']) == 4
    snap = tmp_path / 'snap'
    monkeypatch.setattr(training, 'Prefetcher', _dying_prefetcher(
        training.Prefetcher, 5, 2))
    with pytest.raises(_SimulatedKill):
        _train(corpus, tmp_path, 4, resume_dir=snap, tag='b')
    monkeypatch.undo()
    st = orbaxio.load_train_state(str(snap))
    assert st['meta']['epoch_done'] == 2
    assert len(st['meta']['history']['loss']) == 2
    assert [e for e in os.listdir(snap)] == ['ep_0002']
    rc = _train(corpus, tmp_path, 4, resume_dir=snap, tag='c')
    assert rc.status == 2 and len(rc.history['loss']) == 4
    for key in ra.history:
        np.testing.assert_allclose(
            rc.history[key], ra.history[key], rtol=1e-5,
            err_msg='resumed %s diverged from the uninterrupted run' % key)
    # the optimizer went on from its state: epochs 3-4 improve on 2
    assert rc.history['loss'][3] < rc.history['loss'][1]
    for a, b in zip(rc.params['lstm'][0].values(),
                    ra.params['lstm'][0].values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_resume_by_environment_restores_best_and_adam(
        corpus, tmp_path, monkeypatch):
    """``KERASLM_RESUME_DIR`` takes the place of ``rater.resume_dir``;
    the early-stopping bookkeeping and Adam's step survive the restart."""
    snap = tmp_path / 'snap2'
    monkeypatch.setenv('KERASLM_RESUME_DIR', str(snap))
    rb = _train(corpus, tmp_path, 2, tag='d')
    assert rb.status == 2
    st = orbaxio.load_train_state(str(snap))
    steps = st['meta']['steps_done']
    opt = st['state']['opt']
    assert {int(s['step']) for s in opt['state'].values()} == {steps}
    assert len(opt['state']) == len(training.param_leaves(rb.params))
    rc = _train(corpus, tmp_path, 4, tag='e')
    assert rc.status == 2 and len(rc.history['val_loss']) == 4
    assert rc.history['loss'][:2] == rb.history['loss']
    assert min(rc.history['val_loss']) <= min(rb.history['val_loss'])
    assert orbaxio.load_train_state(str(snap))['meta']['steps_done'] == \
        2 * steps


def test_resume_ignores_mismatched_topology(corpus, tmp_path, caplog):
    snap = tmp_path / 'snap3'
    _train(corpus, tmp_path, 2, resume_dir=snap, tag='f')
    with caplog.at_level('WARNING'):
        r = _train(corpus, tmp_path, 1, resume_dir=snap, tag='g', width=24)
    assert r.status == 2 and len(r.history['loss']) == 1   # fresh
    assert any('different configuration' in rec.message
               for rec in caplog.records)


def test_sigint_mid_epoch_keeps_last_completed_snapshot(
        corpus, tmp_path, monkeypatch):
    snap1 = tmp_path / 'snap_sig1'
    _train(corpus, tmp_path, 1, resume_dir=snap1, tag='s1')
    steps_epoch = int(orbaxio.load_train_state(str(snap1))['meta'][
        'steps_done'])
    assert steps_epoch > 4
    counter = {'n': 0}
    real_step = training.train_step

    def counting_step(*a, **k):
        counter['n'] += 1
        return real_step(*a, **k)

    class FakeStop:
        """'received' two steps into epoch 2."""

        def __init__(self, *a, **k):
            pass

        @property
        def received(self):
            return counter['n'] >= steps_epoch + 2

        def restore(self):
            pass
    monkeypatch.setattr(training, 'train_step', counting_step)
    monkeypatch.setattr(training, 'StopSignal', FakeStop)
    snap2 = tmp_path / 'snap_sig2'
    _train(corpus, tmp_path, 4, resume_dir=snap2, tag='s2')
    assert orbaxio.load_train_state(str(snap2))['meta']['epoch_done'] == 1


def test_early_stop_snapshots_before_it_breaks(corpus, tmp_path,
                                               monkeypatch):
    """Every validation pass after the first scores worse: with patience
    1 the run stops after epoch 2, and snapshots that epoch first."""
    real_pref, real_eval = training.Prefetcher, training.eval_step
    made = {'n': 0}

    class Counting:
        def __init__(self, gen):
            made['n'] += 1
            self.inner = real_pref(gen)

        def __iter__(self):
            return iter(self.inner)

    def eval_worse(*a, **k):
        nll, acc, carry = real_eval(*a, **k)
        return nll + 10.0 * (made['n'] // 2), acc, carry
    monkeypatch.setattr(training, 'Prefetcher', Counting)
    monkeypatch.setattr(training, 'eval_step', eval_worse)
    monkeypatch.setattr(training, 'PATIENCE', 1)
    old = training.EPOCHS
    training.EPOCHS = 5
    try:
        random.seed(11)
        np.random.seed(13)
        r = Rater(device='cpu')
        _configure(r, tmp_path, 'es', tmp_path / 'snap_es')
        monkeypatch.setattr(training, 'MIN_STEPS_BEFORE_STOP', 0)
        r.train(corpus)
    finally:
        training.EPOCHS = old
    assert r.status == 2 and len(r.history['loss']) == 2
    meta = orbaxio.load_train_state(str(tmp_path / 'snap_es'))['meta']
    assert meta['epoch_done'] == 2 and meta['bad_epochs'] == 1
    assert meta['best_epoch'] == 0


def test_snapshot_is_copied_before_save_returns(tmp_path):
    """The next training step updates the tensors in place: what was
    saved is what they held when ``save`` was called."""
    ck = orbaxio.TrainCheckpointer(str(tmp_path / 'snap'))
    t = torch.arange(4.0)
    ck.save(1, {'params': {'x': t}}, {'epoch_done': 1})
    t.add_(100.0)
    ck.finalize()
    st = orbaxio.load_train_state(str(tmp_path / 'snap'))
    assert st['state']['params']['x'].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert set(ck.last) == {'copy_s', 'commit_s', 'bytes'}
    assert ck.last['bytes'] == sum(
        os.path.getsize(os.path.join(tmp_path, 'snap', 'ep_0001', n))
        for n in ('meta.json', 'state.pt'))


def test_snapshot_commit_failure_surfaces_once(tmp_path):
    ck = orbaxio.TrainCheckpointer(str(tmp_path / 'snap'))
    ck.save(1, {'x': torch.zeros(3)}, {'epoch_done': 1})
    ck.finalize()
    # a commit that cannot succeed (as at disk full or no permission)
    ck._write_and_commit({'x': torch.zeros(3)},
                         str(tmp_path / 'snap' / 'missing.tmp'),
                         str(tmp_path / 'snap' / 'ep_0002'))
    with pytest.raises(RuntimeError, match='snapshot commit failed'):
        ck.finalize()
    ck.finalize()
    assert orbaxio.load_train_state(str(tmp_path / 'snap'))['meta'][
        'epoch_done'] == 1


# ----------------------------------------------------------------------
# against the JAX package's files
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_snapshot(tmp_path_factory, corpus):
    """A snapshot written by the JAX package's trainer (one epoch)."""
    d = tmp_path_factory.mktemp('jax_snap')
    _train(corpus, d, 1, resume_dir=d / 'snap', tag='j', rater_cls=JRater,
           module=jtraining)
    return d / 'snap'


def test_snapshot_meta_keys_equal_jax(corpus, tmp_path, jax_snapshot):
    _train(corpus, tmp_path, 1, resume_dir=tmp_path / 'snap', tag='k')
    got = orbaxio.load_train_state(str(tmp_path / 'snap'))['meta']
    with open(os.path.join(jax_snapshot, 'ep_0001', 'meta.json')) as fh:
        want = json.load(fh)
    assert sorted(got) == sorted(want)
    assert got['topology'] == want['topology']
    assert got['mapping'] == want['mapping']
    for key in ('epoch_done', 'best_epoch', 'bad_epochs', 'steps_done',
                'training_files', 'validation_files', 'window_split'):
        assert got[key] == want[key], key


@pytest.mark.parametrize('how', ['resume_dir', 'checkpointer'])
def test_jax_snapshots_are_refused_not_pruned(corpus, tmp_path,
                                              jax_snapshot, how):
    before = sorted(os.listdir(jax_snapshot))
    with pytest.raises(ValueError, match='JAX package'):
        if how == 'checkpointer':
            orbaxio.TrainCheckpointer(str(jax_snapshot))
        else:
            _train(corpus, tmp_path, 1, resume_dir=jax_snapshot, tag='r')
    assert sorted(os.listdir(jax_snapshot)) == before == ['ep_0001']
    assert os.path.isdir(os.path.join(jax_snapshot, 'ep_0001', 'state'))


def _port_rater(path):
    r = Rater(device='cpu')
    r.load_config(path)
    r.configure()
    r.load_weights(path)
    return r


def _leaves(params):
    return [params['char_embedding']] + list(params['context_embeddings']) \
        + [lp[k] for lp in params['lstm']
           for k in ('kernel', 'recurrent', 'bias')]


def test_model_directory_round_trip_and_config_equal_jax(tmp_path):
    r = _port_rater(GERMAN)
    r.save(str(tmp_path / 'port.orbax'))
    assert sorted(os.listdir(tmp_path / 'port.orbax')) == [
        'config.json', 'params.pt']
    jr = JRater()
    jr.load_config(GERMAN)
    jr.configure()
    jr.load_weights(GERMAN)
    jr.save(str(tmp_path / 'jax.orbax'))
    configs = []
    for name in ('port', 'jax'):
        with open(tmp_path / (name + '.orbax') / 'config.json') as fh:
            configs.append(json.load(fh))
    assert configs[0] == configs[1]
    back = _port_rater(str(tmp_path / 'port.orbax'))
    assert back.vocab.c2i == r.vocab.c2i and back.history == r.history
    assert (back.width, back.depth, back.length, back.contexts) == \
        (r.width, r.depth, r.length, r.contexts)
    for a, b in zip(_leaves(back.params), _leaves(r.params)):
        assert torch.equal(a, b)
    text = 'Die Vernunft ist das Vermögen der Prinzipien.'
    assert back.rate(text, [179]) == r.rate(text, [179])
    # a trailing slash names a directory too
    r.save(str(tmp_path / 'plain') + '/')
    assert torch.equal(_port_rater(str(tmp_path / 'plain'))
                       .params['char_embedding'],
                       r.params['char_embedding'])


def test_jax_model_directory_is_refused(tmp_path):
    jr = JRater()
    jr.width, jr.depth, jr.length = 8, 1, 8
    from ocrd_keraslm_tpu.utils.vocab import Vocab
    jr.vocab = Vocab('abc')
    jr.voc_size = jr.vocab.size
    jr.configure()
    jr.status = 2
    path = str(tmp_path / 'm.orbax')
    jr.save(path)
    r = Rater(device='cpu')
    r.load_config(path)       # config.json is shared
    r.configure()
    with pytest.raises(ValueError, match='h5'):
        r.load_weights(path)
