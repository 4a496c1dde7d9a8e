"""h5 files written by the port: they open with h5py, load in the JAX
package with equal arrays, config, vocabulary and history, and load
through the port's own reader.  (JAX-written files read by the port are
covered by ``test_torch_io_model.py``.)  All comparisons are exact: the
writer stores the float32 arrays as they are."""
import json
import os

import h5py
import numpy as np
import pytest
import torch

import jax

from ocrd_keraslm_tpu.models import lstm_lm as jlm
from ocrd_keraslm_tpu.utils import h5io as jh5
from ocrd_keraslm_torch.models import lstm_lm as tlm
from ocrd_keraslm_torch.utils import h5io as th5
from ocrd_keraslm_torch.utils import hdf5
from ocrd_keraslm_torch.utils.vocab import Vocab

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

GERMAN = 'pretrained/model_german.h5'
HISTORY = {'loss': [3.5, np.float32(2.25)], 'val_loss': [3.0, 2.5],
           'accuracy': [0.1, 0.2], 'val_accuracy': [0.1, 0.3]}


def _model(depth, contexts, voc=23, width=8, stateful=True):
    cfg = tlm.LMConfig(width=width, depth=depth, length=12, voc_size=voc,
                       contexts=contexts, stateful=stateful,
                       variable_length=not stateful)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(depth))
    vocab = Vocab()
    vocab.assign('abcdefghij klmnopqrs\näöü'[:voc - 1])
    return params, cfg.replace(voc_size=vocab.size), vocab


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _same_model(loaded, params, cfg, vocab, history):
    lp, lcfg, lvocab, lhist = loaded
    for a, b in zip(_leaves(lp), _leaves(tlm.params_to_numpy(params))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for field in ('width', 'depth', 'length', 'voc_size', 'contexts',
                  'stateful', 'variable_length'):
        assert getattr(lcfg, field) == getattr(cfg, field), field
    assert lvocab.c2i == vocab.c2i and lvocab.i2c == vocab.i2c
    assert lhist == json.loads(json.dumps(history,
                                          cls=th5.NumpyJSONEncoder))


@pytest.mark.parametrize('depth, contexts, stateful', [
    (1, (), True), (2, ((200, 10),), True), (3, ((20, 4), (7, 3)), False)])
def test_saved_model_loads_in_both_packages(tmp_path, depth, contexts,
                                            stateful):
    params, cfg, vocab = _model(depth, contexts, stateful=stateful)
    path = str(tmp_path / 'model.h5')
    th5.save_model(path, params, cfg, vocab, HISTORY)
    _same_model(jh5.load_model(path), params, cfg, vocab, HISTORY)
    _same_model(th5.load_model(path), params, cfg, vocab, HISTORY)


def test_saved_model_opens_with_h5py(tmp_path):
    """The layout the reference tool reads: ``layer_names`` and
    ``weight_names`` attributes, a weight at ``<layer>/<layer>/<name>``,
    the ``config`` group with its types."""
    params, cfg, vocab = _model(2, ((200, 10),))
    path = str(tmp_path / 'model.h5')
    th5.save_model(path, params, cfg, vocab, HISTORY)
    with h5py.File(path, 'r') as f:
        names = [n.decode() for n in f.attrs['layer_names']]
        assert names == ['char_input', 'context1_input', 'char_embedding',
                         'context1_embedding', 'concat_hidden_input',
                         'lstm_1', 'lstm_2', 'dropout_1', 'char_output']
        assert sorted(f.keys()) == sorted(names + ['config'])
        assert f.attrs['keras_version'] == b'2.3.1'
        assert f.attrs['backend'] == b'pytorch'
        assert [n.decode() for n in f['lstm_2'].attrs['weight_names']] == [
            'lstm_2/kernel:0', 'lstm_2/recurrent_kernel:0', 'lstm_2/bias:0']
        assert len(f['dropout_1'].attrs['weight_names']) == 0
        assert len(f['dropout_1'].keys()) == 0
        rec = f['lstm_2/lstm_2/recurrent_kernel:0']
        assert rec.dtype == np.float32 and rec.shape == (8, 32)
        np.testing.assert_array_equal(
            rec[()], params['lstm'][1]['recurrent'].numpy())
        np.testing.assert_array_equal(
            f['char_embedding/char_embedding/embeddings:0'][()],
            params['char_embedding'].numpy())
        g = f['config']
        assert sorted(g.keys()) == ['contexts', 'depth', 'history', 'length',
                                    'mapping', 'stateful',
                                    'variable_length', 'width']
        assert g['stateful'].dtype == bool and g['stateful'][()]
        assert not g['variable_length'][()]
        assert int(g['width'][()]) == 8 and g['width'].shape == ()
        assert g['mapping'].dtype == np.uint32
        np.testing.assert_array_equal(g['mapping'][()],
                                      vocab.to_codepoints())
        assert g['contexts'][()].tolist() == [[200, 10]]
        assert json.loads(g['history'][()])['val_loss'] == [3.0, 2.5]
        f.visit(lambda name: None)    # every link resolves


def test_save_config_appends_to_a_weights_file(tmp_path):
    """``save_weights`` then ``save_config``, as the JAX package's
    ``save_model`` goes; on a port-written and on a JAX-written weights
    file; a second ``save_config`` replaces the first."""
    params, cfg, vocab = _model(2, ((200, 10),))
    jparams = jax.tree_util.tree_map(np.asarray,
                                     tlm.params_to_numpy(params))
    jcfg = jlm.LMConfig(width=cfg.width, depth=cfg.depth, length=cfg.length,
                        voc_size=cfg.voc_size, contexts=cfg.contexts)
    for writer in ('port', 'jax'):
        path = str(tmp_path / ('weights_%s.h5' % writer))
        if writer == 'port':
            th5.save_weights(path, params, cfg)
        else:
            jh5.save_weights(path, jparams, jcfg)
        with pytest.raises(ValueError, match='config'):
            th5.load_config(path)
        th5.save_config(path, cfg, vocab, {'loss': [9.0]})
        th5.save_config(path, cfg, vocab, HISTORY)
        _same_model(jh5.load_model(path), params, cfg, vocab, HISTORY)
        _same_model(th5.load_model(path), params, cfg, vocab, HISTORY)
    # and the JAX package appends its config to a port-written file
    path = str(tmp_path / 'weights_then_jax_config.h5')
    th5.save_weights(path, params, cfg)
    jh5.save_config(path, jcfg, vocab, HISTORY)
    _same_model(th5.load_model(path), params, cfg, vocab, HISTORY)


def test_save_weights_takes_numpy_and_tensors(tmp_path):
    params, cfg, vocab = _model(1, ((20, 4),))
    a, b = str(tmp_path / 'a.h5'), str(tmp_path / 'b.h5')
    th5.save_weights(a, params, cfg)
    th5.save_weights(b, tlm.params_to_numpy(params), cfg)
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        assert fa.read() == fb.read()


def test_german_model_written_back_loads_unchanged(tmp_path):
    path = str(tmp_path / 'german.h5')
    th5.save_model(path, *th5.load_model(GERMAN))
    want = jh5.load_model(GERMAN)
    got = jh5.load_model(path)
    for a, b in zip(_leaves(got[0]), _leaves(want[0])):
        np.testing.assert_array_equal(a, b)
    assert got[1] == want[1]
    assert got[2].c2i == want[2].c2i
    assert got[3] == want[3]


def test_writer_lays_out_large_groups_and_value_types(tmp_path):
    """More entries than one symbol node holds (8), sorted for the
    library's search; every value type the writer takes; the tree reads
    back through the port's reader."""
    names = ['g%02d' % i for i in range(30)] + ['Z', 'a/b'.replace('/', '_')]
    tree = {'attrs': {'names': names, 'n': np.int32(7), 'note': 'ä'},
            'items': {n: {'items': {}} for n in names}}
    tree['items']['data'] = {'items': {
        'f64': np.linspace(0, 1, 5), 'i8': np.arange(-2, 2, dtype=np.int8),
        'u16': np.array([[1, 2], [3, 4]], np.uint16),
        'flag': np.array(False), 'text': b'plain', 'empty': np.zeros((0, 2)),
        'with_attr': hdf5.Leaf(np.float32(1.5), {'unit': b'm'})}}
    path = str(tmp_path / 'tree.h5')
    hdf5.write_file(path, tree)
    with h5py.File(path, 'r') as f:
        assert sorted(f.keys()) == sorted(names + ['data'])
        assert [n.decode() for n in f.attrs['names']] == names
        assert f.attrs['n'] == 7 and f.attrs['note'].decode() == 'ä'
        d = f['data']
        np.testing.assert_array_equal(d['f64'][()], np.linspace(0, 1, 5))
        assert d['i8'].dtype == np.int8 and d['i8'][()].tolist() == [
            -2, -1, 0, 1]
        assert d['u16'][()].tolist() == [[1, 2], [3, 4]]
        assert d['flag'].dtype == bool and not d['flag'][()]
        assert d['text'][()] == b'plain'
        assert d['empty'].shape == (0, 2)
        assert d['with_attr'][()] == 1.5
        assert d['with_attr'].attrs['unit'] == b'm'
    back = hdf5.read_tree(path)
    assert sorted(back['items']) == sorted(names + ['data'])
    assert back['items']['data']['items']['flag'] == np.array(False)
    assert back['items']['data']['items']['with_attr'].attrs == {
        'unit': b'm'}
    with pytest.raises(ValueError, match='complex'):
        hdf5.write_file(path, {'items': {'c': np.zeros(2, complex)}})


def test_rater_save_refuses_the_orbax_format(tmp_path):
    """Saving needs weights; since the port's model directory format
    (Queue 1 #12) a directory or an ``.orbax`` path is saved in it (and
    loads back bit for bit), an h5 path as an h5 file the JAX package
    loads."""
    from ocrd_keraslm_torch.rater import Rater
    r = Rater(device='cpu')
    r.load_config(GERMAN)
    r.configure()
    with pytest.raises(RuntimeError, match='weights'):
        r.save(str(tmp_path / 'm.h5'))
    r.load_weights(GERMAN)
    for target in (str(tmp_path / 'model.orbax'), str(tmp_path)):
        r.save(target)
        assert os.path.isfile(os.path.join(target, 'config.json'))
        back = Rater(device='cpu')
        back.load_config(target)
        back.configure()
        back.load_weights(target)
        for a, b in zip(_leaves(back.params), _leaves(r.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    r.save(str(tmp_path / 'm.h5'))
    got = jh5.load_model(str(tmp_path / 'm.h5'))
    want = jh5.load_model(GERMAN)
    for a, b in zip(_leaves(got[0]), _leaves(want[0])):
        np.testing.assert_array_equal(a, b)
