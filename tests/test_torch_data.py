"""The data pipeline of the port against the JAX package's: with
``random.seed`` and ``np.random.seed`` set alike, ``split_data`` gives
the same plan, and the three generators yield the same ``Batch``es (all
fields, exactly), with degradation on.  Both are pure numpy, so the
comparison is exact."""
import random

import numpy as np
import pytest

from ocrd_keraslm_tpu import data as jdata
from ocrd_keraslm_tpu.utils.vocab import Vocab as JVocab
from ocrd_keraslm_torch import data as tdata
from ocrd_keraslm_torch.utils.vocab import Vocab as TVocab

WORDS = ['die', 'der', 'und', 'ist', 'kant', 'vernunft', 'mensch', 'über']


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    rnd = random.Random(7)
    directory = tmp_path_factory.mktemp('corpus')
    files = []
    for name, lines in (('a_eins_1781.txt', 40), ('b_zwei_1790.txt', 25),
                        ('c_drei_2010.txt', 31), ('d_kurz_1800.txt', 1),
                        ('ohne_jahr.txt', 12)):
        path = directory / name
        path.write_text(''.join(' '.join(rnd.choices(WORDS, k=8)) + '\n'
                                for _ in range(lines)), encoding='utf-8')
        files.append(str(path))
    return files


def _plans(files, **kw):
    out = []
    for mod in (jdata, tdata):
        random.seed(11)
        np.random.seed(12)
        out.append(mod.split_data(files, **kw))
    return out


def _vocabs(charset):
    jv, tv = JVocab(), TVocab()
    jv.assign(charset)
    tv.assign(charset)
    assert jv.c2i == tv.c2i and len(jv) == len(tv) == tv.size
    return jv, tv


def _same_batches(jgen, tgen, min_batches=3):
    n = extra = 0
    for jb, tb in zip(jgen, tgen):
        for name in ('x', 'y', 'mask'):
            a, b = getattr(jb, name), getattr(tb, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert len(jb.zs) == len(tb.zs)
        for a, b in zip(jb.zs, tb.zs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert jb.reset_carry == tb.reset_carry
        assert jb.file_name == tb.file_name
        assert (jb.x_mask is None) == (tb.x_mask is None)
        if jb.x_mask is not None:
            np.testing.assert_array_equal(jb.x_mask, tb.x_mask)
        n += 1
    # both ran dry together
    assert next(jgen, None) is None and next(tgen, None) is None
    assert n >= min_batches
    return n


@pytest.mark.parametrize('stateful, split, with_val', [
    (True, 0.2, False), (True, 0.0, False), (True, 0.2, True),
    (False, 0.2, False), (False, 0.0, False), (False, 0.2, True)])
def test_split_data_is_the_same_plan(corpus, stateful, split, with_val):
    kw = dict(stateful=stateful, length=16, validation_split=split,
              val_files=corpus[:1] if with_val else None,
              known_chars={'X'})
    jp, tp = _plans(corpus[1:] if with_val else corpus, **kw)
    assert jp.training_files == tp.training_files
    assert jp.validation_files == tp.validation_files
    assert (jp.total_chars, jp.step) == (tp.total_chars, tp.step)
    assert jp.charset == tp.charset and 'X' in tp.charset
    assert (jp.window_split is None) == (tp.window_split is None)
    if jp.window_split is not None:
        np.testing.assert_array_equal(jp.window_split, tp.window_split)


def test_split_data_needs_two_files_when_stateful(corpus):
    with pytest.raises(ValueError, match='>= 2 files'):
        tdata.split_data(corpus[:1], stateful=True, length=16)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('n_contexts', [1, 2])
def test_stateful_streams_batches_match(corpus, train, n_contexts):
    jp, tp = _plans(corpus, stateful=True, length=16)
    jv, tv = _vocabs(jp.charset)
    kw = dict(length=16, batch_size=6, n_contexts=n_contexts, train=train,
              char_degradation=0.3, context_degradation=0.4)
    n = _same_batches(
        jdata.gen_stateful_streams(corpus, jv, rng=np.random.default_rng(
            [5, 0]), **kw),
        tdata.gen_stateful_streams(corpus, tv, rng=np.random.default_rng(
            [5, 0]), **kw))
    plain = sum(1 for _ in tdata.gen_stateful_streams(
        corpus, tv, length=16, batch_size=6))
    assert (n > plain) == train    # degradation adds duplicate batches


@pytest.mark.parametrize('train', [False, True])
def test_stateful_parity_batches_match(corpus, train):
    jp, _ = _plans(corpus, stateful=True, length=16)
    jv, tv = _vocabs(jp.charset)
    kw = dict(length=16, n_contexts=1, train=train, char_degradation=0.3,
              context_degradation=0.4)
    _same_batches(
        jdata.gen_stateful_parity(corpus, jv, rng=np.random.default_rng(
            3), **kw),
        tdata.gen_stateful_parity(corpus, tv, rng=np.random.default_rng(
            3), **kw))


@pytest.mark.parametrize('train, variable_length, use_split', [
    (True, False, True), (False, False, True), (True, True, True),
    (True, False, False), (True, True, False)])
def test_stateless_batches_match(corpus, train, variable_length,
                                 use_split):
    jp, tp = _plans(corpus, stateful=False, length=16,
                    validation_split=0.2 if use_split else 0.0)
    jv, tv = _vocabs(jp.charset)
    kw = dict(length=16, batch_size=8, step=3, train=train,
              validation_split=0.2, char_degradation=0.2,
              context_degradation=0.3, first_window=0.3, n_contexts=1,
              variable_length=variable_length)
    _same_batches(
        jdata.gen_stateless(corpus, jv, window_split=jp.window_split,
                            rng=np.random.default_rng(4), **kw),
        tdata.gen_stateless(corpus, tv, window_split=tp.window_split,
                            rng=np.random.default_rng(4), **kw))


def test_stream_windows_cover_all_chars(corpus):
    """Every (input, target) pair of a file is in exactly one stream
    window (the last stream takes the tiling remainder)."""
    _, tp = _plans(corpus, stateful=True, length=16)
    _, tv = _vocabs(tp.charset)
    name = corpus[0]
    ids = tv.encode(tdata.read_normalized(name))
    total = sum(float(b.mask.sum()) for b in tdata.gen_stateful_streams(
        [name], tv, length=16, batch_size=6))
    assert total == len(ids) - 1


def test_vocab_grow_appends_and_drops_caches():
    jv, tv = JVocab(), TVocab()
    for v in (jv, tv):
        v.assign('cab')
    assert tv.encode('abcx').tolist() == jv.encode('abcx').tolist() \
        == [1, 2, 3, 0]
    assert tv.encode_cached('x').tolist() == [0]
    added = [v.grow('xayz') for v in (jv, tv)]
    assert added[0] == added[1] == ['x', 'y', 'z']
    assert tv.c2i == jv.c2i and tv.size == 7 and 'x' in tv and 'q' not in tv
    # the lookup table and the memo were rebuilt
    assert tv.encode('abcx').tolist() == [1, 2, 3, 4]
    assert tv.encode_cached('x').tolist() == [4]
    np.testing.assert_array_equal(tv.to_codepoints(), jv.to_codepoints())


def test_prefetcher_yields_in_order_and_propagates_errors():
    assert list(tdata.Prefetcher(iter(range(20)), depth=2)) == list(range(20))

    def broken():
        yield 1
        raise KeyError('boom')
    with pytest.raises(KeyError, match='boom'):
        list(tdata.Prefetcher(broken()))
    # an early break releases the worker
    pf = tdata.Prefetcher(iter(range(1000)), depth=1)
    for item in pf:
        if item == 3:
            break
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
