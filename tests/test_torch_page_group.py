"""Page-group fusion in the port: consecutive native-lane pages decode
in ONE ``decode_lattice`` launch (``wrapper/rate.py``
``_flush_page_group``, ``Rater.rate_best_device_begin_arrays_group``).
The outputs must be byte-identical to a launch a page
(``KERASLM_FUSE_PAGES=0``) across group splits, a mid-document flush
and the page policy, and their content equal to the JAX processor's
(native lane, page groups, Pallas kernel in interpret mode).  A failure
of the group's host side retries page by page; a kernel error raises."""
import os
import re

import pytest
import torch

from ocrd_keraslm_tpu.wrapper import KerasRate as JKerasRate
from ocrd_keraslm_torch import rater as rater_mod
from ocrd_keraslm_torch.rater import Rater
from ocrd_keraslm_torch.wrapper import KerasRate, page_native

from helpers import build_workspace, make_tiny_model
from test_page_fast import _page_content

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

PAGES = {'phys_0001': [['Das', 'ist'], ['ein', 'Test']],
         'phys_0002': [['Ende', 'gut']],
         'phys_0003': [['alles', 'gut']],
         'phys_0004': [['und', 'aus']]}
ALTS = {(0, 0, 0): [('D', 0.9), ('O', 0.88)],
        (1, 0, 1): [('e', 0.7), ('c', 0.69)],
        (3, 0, 0): [('u', 0.8), ('n', 0.79)]}


@pytest.fixture(scope='module')
def model(tmp_path_factory):
    return make_tiny_model(tmp_path_factory.mktemp('m') / 'model.h5')


def _strip_ts(xml):
    return re.sub(r'<(Created|LastChange)>[^<]*</\1>', r'<\1/>', xml)


def _run(tmp_path, monkeypatch, name, fuse, model, edit=None,
         policy=None, jax=False):
    """{page id: output XML or None} of one processor run, and the page
    counts of each group launch."""
    wdir = tmp_path / ('ws_%s' % name)
    ws = build_workspace(wdir, PAGES, glyph_alternatives=ALTS)
    if edit is not None:
        edit(str(wdir))
    monkeypatch.setenv('KERASLM_FUSE_PAGES', '1' if fuse else '0')
    if policy:
        monkeypatch.setenv('OCRD_MISSING_OUTPUT', policy)
        monkeypatch.setenv('OCRD_MAX_MISSING_OUTPUTS', '-1')
    par = {'model_file': model, 'textequiv_level': 'glyph',
           'beam_width': 4}
    groups = []
    if jax:
        proc = JKerasRate(workspace=ws, parameter=par)
        proc.setup()
        proc.rater.fused_decode = True
    else:
        proc = KerasRate(workspace=ws, parameter=par, device='cpu')
        proc.setup()
        orig = Rater.rate_best_device_begin_arrays_group

        def spying(self, segs, **kw):
            groups.append([s[0] for s in segs])
            return orig(self, segs, **kw)
        monkeypatch.setattr(Rater, 'rate_best_device_begin_arrays_group',
                            spying)
    page_native.groups = 0
    proc.process_workspace(ws)
    if not jax:
        assert page_native.groups == len(groups)
    out = {}
    for pid in PAGES:
        path = os.path.join(str(wdir), 'OCR-D-LM', 'OCR-D-LM_%s.xml' % pid)
        out[pid] = (_strip_ts(open(path, encoding='utf-8').read())
                    if os.path.exists(path) else None)
    return out, groups


def test_group_byte_identical_and_equal_to_jax(tmp_path, monkeypatch,
                                               model):
    fused, groups = _run(tmp_path, monkeypatch, 'fused', True, model)
    plain, none = _run(tmp_path, monkeypatch, 'plain', False, model)
    assert fused == plain
    assert groups == [[4, 2, 2, 2]] and none == []
    jax, _ = _run(tmp_path, monkeypatch, 'jax', True, model, jax=True)
    assert fused == jax
    assert {p: _page_content(x) for p, x in fused.items()} == \
        {p: _page_content(x) for p, x in jax.items()}


def test_group_split_at_the_block_limit(tmp_path, monkeypatch, model):
    """With one block capped at 4 edges (the 1024-edge limit, made
    small) the pages (4, 2, 2, 2 prepared edges) split into groups
    [4], [2, 2], [2], chained through the carry, byte-identical to a
    launch a page."""
    monkeypatch.setattr(rater_mod, 'E_BUCKETS', (4,))
    fused, groups = _run(tmp_path, monkeypatch, 'split', True, model)
    plain, _ = _run(tmp_path, monkeypatch, 'plain', False, model)
    assert fused == plain
    assert groups == [[4], [2, 2], [2]]


def _nest_page_2(wdir):
    p2 = os.path.join(wdir, 'OCR-D-OCR', 'OCR-D-OCR_phys_0002.xml')
    xml = open(p2, encoding='utf-8').read()
    with open(p2, 'w', encoding='utf-8') as fh:
        fh.write(xml.replace(
            '<TextRegion id="phys_0002_r1">',
            '<TextRegion id="phys_0002_r1"><TextRegion id="nested">'
            '<TextEquiv><Unicode>x</Unicode></TextEquiv></TextRegion>'))


def test_group_flush_on_ineligible_page(tmp_path, monkeypatch, model):
    """A page the scanner bails on flushes the open group and decodes in
    the record lane; the next pages regroup; byte-identical to a launch
    a page, content equal to the JAX processor's."""
    fused, groups = _run(tmp_path, monkeypatch, 'mix', True, model,
                         edit=_nest_page_2)
    plain, _ = _run(tmp_path, monkeypatch, 'mixplain', False, model,
                    edit=_nest_page_2)
    assert fused == plain
    assert groups == [[4], [2, 2]]
    jax, _ = _run(tmp_path, monkeypatch, 'mixjax', True, model,
                  edit=_nest_page_2, jax=True)
    assert {p: _page_content(x) for p, x in fused.items()} == \
        {p: _page_content(x) for p, x in jax.items()}


def _corrupt_page_2(wdir):
    with open(os.path.join(wdir, 'OCR-D-OCR', 'OCR-D-OCR_phys_0002.xml'),
              'w', encoding='utf-8') as fh:
        fh.write('this is not XML <<<')


@pytest.mark.parametrize('policy', ['SKIP', 'COPY'])
def test_group_error_policy_mid_document(tmp_path, monkeypatch, model,
                                         policy):
    fused, groups = _run(tmp_path, monkeypatch, 'pol', True, model,
                         edit=_corrupt_page_2, policy=policy)
    plain, _ = _run(tmp_path, monkeypatch, 'polplain', False, model,
                    edit=_corrupt_page_2, policy=policy)
    assert fused == plain
    assert groups == [[4, 2, 2]]
    assert None not in (fused['phys_0001'], fused['phys_0003'],
                        fused['phys_0004'])
    assert fused['phys_0002'] == ('this is not XML <<<' if policy == 'COPY'
                                  else None)


def test_host_side_failure_retries_page_by_page(tmp_path, monkeypatch,
                                                model):
    """A page's fill fails inside the group: the group's pages launch
    one by one; a page that fails there too goes to the page policy
    under ITS id and the others are written as in a plain run."""
    from ocrd_keraslm_torch.wrapper.page_native import NativePageDoc
    orig_fill = NativePageDoc.fill
    orig_begin = KerasRate.process_page_pcgts_device_begin

    def fill(self, table, E, A, L):
        if E == self._lat[1] and self.get_pcGtsId() == 'phys_0003':
            raise RuntimeError('simulated group fill failure')
        return orig_fill(self, table, E, A, L)

    def begin(self, pcgts, device_tb, file_id, page_id):
        if page_id == 'phys_0002':
            raise RuntimeError('simulated per-page failure')
        return orig_begin(self, pcgts, device_tb, file_id, page_id)
    monkeypatch.setattr(NativePageDoc, 'fill', fill)
    monkeypatch.setattr(KerasRate, 'process_page_pcgts_device_begin', begin)
    fused, groups = _run(tmp_path, monkeypatch, 'retry', True, model,
                         policy='SKIP')
    assert groups == []
    assert [p for p, x in fused.items() if x is None] == ['phys_0002']


def test_kernel_error_in_a_group_raises(tmp_path, monkeypatch, model):
    """The group's launch fails (as a kernel build or launch error
    would): the run raises; the pages are not retried one by one."""
    launched = []

    def broken(*args, **kwargs):
        launched.append(kwargs['device_walk'])
        raise RuntimeError('decode_lattice kernel launch failed')
    monkeypatch.setattr(rater_mod, 'decode_lattice', broken)
    with pytest.raises(RuntimeError, match='kernel launch failed'):
        _run(tmp_path, monkeypatch, 'broken', True, model, policy='SKIP')
    assert launched == [False]
