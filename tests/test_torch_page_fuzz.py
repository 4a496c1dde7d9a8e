"""Randomised PAGE documents (``test_page_fuzz.fuzz_page_xml``: comments,
entities, CRLF, reading order, layout directives, joins, up to six
alternatives, tied confs) through the port's three lanes (native,
ElementTree records, object model) and the JAX processor (native lane,
Pallas kernel in interpret mode), at the full width of
``pretrained/model_german.h5``: a tiny untrained model leaves near-ties
that part even JAX's own engines.  The port's lanes must give the
same parsed content (texts, and confs rounded to 5 places); each must
equal JAX's in every text and within 2e-5 in every conf (the written
confs of two f32 decodes may differ by 1e-5, and the rounding by one
more step); with lookahead write-back too."""
import os
import random

import pytest
import torch

from ocrd_keraslm_tpu.wrapper import KerasRate as JKerasRate
from ocrd_keraslm_torch.wrapper import KerasRate, page_native

from test_page_fast import _page_content
from test_page_fuzz import _build_raw_workspace, fuzz_page_xml

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

GERMAN = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                      'pretrained', 'model_german.h5')
LANES = {'native': ('1', '1'), 'records': ('1', '0'), 'object': ('0', '0')}


def _run(tmp_path, monkeypatch, page_xmls, parameter):
    outputs = {}
    runs = [(lane, fast, nat, False) for lane, (fast, nat) in LANES.items()]
    for lane, fast, nat, is_jax in runs + [('jax', '1', '1', True)]:
        wdir = tmp_path / ('ws_%s' % lane)
        ws = _build_raw_workspace(wdir, page_xmls)
        monkeypatch.setenv('KERASLM_FAST_PAGE', fast)
        monkeypatch.setenv('KERASLM_NATIVE_PAGE', nat)
        par = dict(parameter, model_file=GERMAN)
        if is_jax:
            proc = JKerasRate(workspace=ws, parameter=par)
            proc.setup()
            proc.rater.fused_decode = True
        else:
            proc = KerasRate(workspace=ws, parameter=par, device='cpu')
            proc.setup()
        proc.process_workspace(ws)
        outputs[lane] = {
            pid: _page_content(open(os.path.join(
                str(wdir), 'OCR-D-LM', 'OCR-D-LM_%s.xml' % pid),
                encoding='utf-8').read()) for pid in page_xmls}
    return outputs


def _assert_lanes(outputs, seed):
    for lane in LANES:
        assert outputs[lane] == outputs['native'], \
            'seed %d: %s lane diverged from the native lane' % (seed, lane)
    for pid, (pcgts_id, want) in outputs['jax'].items():
        got_id, got = outputs['native'][pid]
        assert got_id == pcgts_id and len(got) == len(want)
        for (eid, texts, confs), (w_id, w_texts, w_confs) in zip(got, want):
            assert (eid, texts) == (w_id, w_texts), (seed, pid, eid)
            assert len(confs) == len(w_confs)
            for c, w in zip(confs, w_confs):
                assert (c is None) == (w is None) and \
                    (c is None or abs(c - w) <= 2e-5), (seed, eid, c, w)


@pytest.mark.parametrize('seed', range(3))
def test_fuzz_three_lane_equality(tmp_path, monkeypatch, seed):
    rnd = random.Random(1000 + seed)
    level = 'word' if rnd.random() < 0.25 else 'glyph'
    page_xmls = {}
    for pi in range(rnd.randint(1, 2)):
        page_id = 'phys_%04d' % (pi + 1)
        page_xmls[page_id] = fuzz_page_xml(rnd, page_id)[0]
    page_native.pages = 0
    outputs = _run(tmp_path, monkeypatch, page_xmls,
                   {'textequiv_level': level, 'beam_width': 4})
    assert page_native.pages > 0, 'seed %d: no native-lane page' % seed
    _assert_lanes(outputs, seed)


@pytest.mark.parametrize('seed', range(2))
def test_fuzz_lookahead_lane_equality(tmp_path, monkeypatch, seed):
    """Lookahead write-back: the native lane stands aside (record
    protocol); every lane equals JAX's lookahead output."""
    rnd = random.Random(5000 + seed)
    page_xmls = {'phys_%04d' % (pi + 1):
                 fuzz_page_xml(rnd, 'phys_%04d' % (pi + 1))[0]
                 for pi in range(2)}
    page_native.pages = 0
    outputs = _run(tmp_path, monkeypatch, page_xmls,
                   {'textequiv_level': 'glyph', 'beam_width': 4,
                    'lookahead_writeback': True})
    assert page_native.pages == 0
    _assert_lanes(outputs, seed)
