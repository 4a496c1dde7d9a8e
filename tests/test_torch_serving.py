"""The serving roles of the port against the JAX processor: the HTTP
processing server, the spool-queue worker, page-parallel runs through a
METS server in a second process, the OCR-D adapter (with the genuine
``ocrd`` core faked in ``sys.modules``, as ``tests/test_ocrd_adapter.py``
does), and concurrent raters sharing the process-wide decode weights.

Every role writes the pages JAX's processor writes on the same
workspace: the same texts at every level, confs within 1e-4.  The port
runs on the CPU (``KERASLM_PLATFORM=cpu``), JAX in its CPU defaults."""
import json
import multiprocessing
import os
import re
import shutil
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from helpers import build_workspace, make_tiny_model
import ocrd_keraslm_tpu.wrapper.ocrd_adapter as jadapter
from ocrd_keraslm_tpu.wrapper import KerasRate as JKerasRate
from ocrd_keraslm_tpu.wrapper.mets import Workspace as JWorkspace
from ocrd_keraslm_tpu.wrapper.page import parse_page as jparse_page
import ocrd_keraslm_torch.wrapper.ocrd_adapter as tadapter
from ocrd_keraslm_torch import rater as trater_mod
from ocrd_keraslm_torch.rater import Rater as TRater
from ocrd_keraslm_torch.wrapper import cli as tcli
from ocrd_keraslm_torch.wrapper import mets_server as tms
from ocrd_keraslm_torch.wrapper.mets import Workspace as TWorkspace
from ocrd_keraslm_torch.wrapper.page import TextEquivType
from ocrd_keraslm_torch.wrapper.page import parse_page as tparse_page
from ocrd_keraslm_torch.wrapper.rate import KerasRate as TKerasRate

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

CONF_TOL = 1e-4
CHARS = 'abcdefghijklmnopqrstuvwxyzXY '
PAGES = {
    'page1': [['the', 'quick', 'brown'], ['fox', 'jumps']],
    'page2': [['over', 'the', 'lazy'], ['dog', 'today']],
    'page3': [['many', 'hands', 'make'], ['light', 'work']],
    'page4': [['time', 'flies', 'like'], ['an', 'arrow']],
}
ALTERNATIVES = {(0, 1, 0): [('q', 0.9), ('X', 0.88)],
                (1, 0, 1): [('o', 0.9), ('Y', 0.89), ('a', 0.8)]}
DECODE = {'textequiv_level': 'glyph', 'beam_width': 4}
SCORE = {'textequiv_level': 'word', 'alternative_decoding': False}


@pytest.fixture(scope='module')
def model(tmp_path_factory):
    return make_tiny_model(tmp_path_factory.mktemp('model') / 'model.h5',
                           chars=CHARS)


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv('KERASLM_PLATFORM', 'cpu')


def _workspace(directory):
    build_workspace(str(directory), PAGES, glyph_alternatives=ALTERNATIVES)
    return str(directory)


@pytest.fixture(scope='module')
def jax_runs(tmp_path_factory, model):
    """JAX's processor over the workspace, decoding and scoring: {mode:
    output directory}."""
    out = {}
    for mode, params in (('decode', DECODE), ('score', SCORE)):
        d = _workspace(tmp_path_factory.mktemp('jax_' + mode))
        proc = JKerasRate(workspace=JWorkspace(d),
                          parameter=dict(params, model_file=model))
        proc.setup()
        proc.process_workspace(proc.workspace)
        out[mode] = d
    return out


def _texts(directory, grp='OCR-D-LM'):
    """{output file ID: {element id: [(Unicode, conf)]}} of every
    TextEquiv at every level."""
    ws = JWorkspace(directory)
    out = {}
    for f in ws.mets.find_files(fileGrp=grp):
        pcgts = jparse_page(os.path.join(directory, f.local_filename))
        elems = {}
        for region in pcgts.get_Page().get_TextRegion():
            elems[region.id] = region.get_TextEquiv()
            for line in region.get_TextLine():
                elems[line.id] = line.get_TextEquiv()
                for word in line.get_Word():
                    elems[word.id] = word.get_TextEquiv()
                    for g in word.get_Glyph():
                        elems[g.id] = g.get_TextEquiv()
        out[f.ID.replace(grp, 'OCR-D-LM')] = {
            k: [(te.Unicode, te.conf) for te in v] for k, v in elems.items()}
    return out


def assert_like_jax(directory, jax_dir, grp='OCR-D-LM'):
    got, want = _texts(directory, grp), _texts(jax_dir)
    assert sorted(got) == sorted(want) and len(want) == len(PAGES)
    for fid, elems in want.items():
        assert got[fid].keys() == elems.keys(), fid
        for eid, tes in elems.items():
            assert [u for u, _ in got[fid][eid]] == [u for u, _ in tes], eid
            for (_, a), (_, b) in zip(got[fid][eid], tes):
                assert (a is None) == (b is None), eid
                if a is not None:
                    assert abs(a - b) <= CONF_TOL, (eid, a, b)


def _normalized(path):
    """A written page without its timestamps (they differ by run)."""
    with open(path, encoding='utf-8') as fh:
        return re.sub(r'<(pc:)?(Created|LastChange)>[^<]*</\1?\2>', '',
                      fh.read())


def _same_files(a, b, grp='OCR-D-LM'):
    names = sorted(os.listdir(os.path.join(a, grp)))
    assert names == sorted(os.listdir(os.path.join(b, grp))) and names
    for name in names:
        assert _normalized(os.path.join(a, grp, name)) == \
            _normalized(os.path.join(b, grp, name)), name


def _post(base, payload):
    req = urllib.request.Request(
        base + '/process', data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as err:
        return err.code, json.load(err)


def test_processing_server_matches_jax_and_the_cli(tmp_path, cpu, model,
                                                   jax_runs):
    httpd = tcli.make_processing_server(
        '127.0.0.1:0', dict(DECODE, model_file=model))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = 'http://127.0.0.1:%d' % httpd.server_address[1]
        with urllib.request.urlopen(base + '/health') as resp:
            assert json.load(resp)['status'] == 'ok'
        with urllib.request.urlopen(base + '/info') as resp:
            assert json.load(resp)['executable'] == 'ocrd-keraslm-rate'
        dirs = [_workspace(tmp_path / ('ws%d' % i)) for i in range(2)]
        for d in dirs:   # the second job runs on the warm rater
            assert _post(base, {'mets': d}) == (200, {'state': 'SUCCESS'})
            assert_like_jax(d, jax_runs['decode'])
        _same_files(dirs[0], dirs[1])
        # a job naming a model that is not there fails, and says so
        code, body = _post(base, {'mets': dirs[0], 'output_file_grp': 'X',
                                  'parameter': {'model_file': 'none.h5'}})
        assert code == 500 and body['state'] == 'FAILED'
        assert 'none.h5' in body['error']
    finally:
        httpd.shutdown()
        thread.join(timeout=5)
    cli_dir = _workspace(tmp_path / 'cli')
    # (the parameters in the server's order: the page's metadata lists
    # them)
    res = CliRunner().invoke(tcli.ocrd_keraslm_rate, [
        '-m', os.path.join(cli_dir, 'mets.xml'), '-P', 'textequiv_level',
        'glyph', '-P', 'beam_width', '4', '-P', 'model_file', model])
    assert res.exit_code == 0, (res.output, res.exception)
    _same_files(dirs[0], cli_dir)


def test_warm_rater_reuse_gate(tmp_path, cpu, model, monkeypatch):
    """A job reuses the warm rater unless it changes the model file or
    the decode mode; an explicitly passed default changes neither."""
    seed = TKerasRate(parameter=dict(DECODE, model_file=model))
    seed.setup()
    used = []
    real = tcli._run_processor

    def spy(workspace, i, o, params, rater=None):
        used.append(rater is seed.rater)
        return real(workspace, i, o, params, rater=rater)
    monkeypatch.setattr(tcli, '_run_processor', spy)
    d = _workspace(tmp_path / 'ws')
    for grp, override in (('A', {}),
                          ('B', {'alternative_decoding': True}),
                          ('C', {'alternative_decoding': False}),
                          ('D', {'model_file': model + '.copy'})):
        if 'model_file' in override:
            shutil.copy(model, override['model_file'])
        tcli._run_job({'mets': d, 'output_file_grp': grp,
                       'parameter': override},
                      dict(DECODE, model_file=model), seed)
    assert used == [True, True, False, False]


def test_worker_matches_jax(tmp_path, cpu, model, jax_runs):
    queue = tmp_path / 'spool'
    queue.mkdir()
    dirs = [_workspace(tmp_path / ('ws%d' % i)) for i in range(2)]
    for i, d in enumerate(dirs):
        with open(queue / ('job%d.json' % i), 'w') as fh:
            json.dump({'mets': d, 'input_file_grp': 'OCR-D-OCR',
                       'output_file_grp': 'OCR-D-LM'}, fh)
    with open(queue / 'job9.json', 'w') as fh:
        json.dump({'mets': dirs[0], 'output_file_grp': 'X',
                   'parameter': {'model_file': 'none.h5'}}, fh)
    res = CliRunner().invoke(tcli.ocrd_keraslm_rate, [
        'worker', '--queue', str(queue), '--once', '-P', 'model_file',
        model, '-P', 'textequiv_level', 'glyph', '-P', 'beam_width', '4'])
    assert res.exit_code == 0, (res.output, res.exception)
    states = {}
    for i in (0, 1, 9):
        with open(queue / ('job%d.result.json' % i)) as fh:
            states[i] = json.load(fh)['state']
        assert (queue / ('job%d.json.done' % i)).exists()
    assert states == {0: 'SUCCESS', 1: 'SUCCESS', 9: 'FAILED'}
    for d in dirs:
        assert_like_jax(d, jax_runs['decode'])


@pytest.fixture
def served(tmp_path):
    """A METS server in a second process (spawned: the child imports
    the port's ``mets_server`` module, not this test module) over a
    fresh workspace; yields (workspace directory, socket path)."""
    d = _workspace(tmp_path / 'served')
    url = str(tmp_path / 'mets.sock')
    proc = multiprocessing.get_context('spawn').Process(
        target=tms.serve, args=(d, url), daemon=True)
    proc.start()
    for _ in range(600):
        if os.path.exists(url):
            break
        time.sleep(0.05)
    else:
        raise RuntimeError('METS server did not start')
    yield d, url
    proc.terminate()
    proc.join(timeout=5)


def test_page_parallel_scoring_through_the_mets_server(
        served, tmp_path, cpu, model, jax_runs, monkeypatch):
    """Four page threads score against the served METS: the pages JAX
    writes, and the port's own sequential local run's files."""
    d, url = served
    local = _workspace(tmp_path / 'local')
    res = CliRunner().invoke(tcli.ocrd_keraslm_rate, [
        '-m', local, '-P', 'model_file', model, '-P', 'textequiv_level',
        'word', '-P', 'alternative_decoding', 'false'])
    assert res.exit_code == 0, (res.output, res.exception)
    monkeypatch.setenv('OCRD_MAX_PARALLEL_PAGES', '4')
    res = CliRunner().invoke(tcli.ocrd_keraslm_rate, [
        '-U', url, '-P', 'model_file', model, '-P', 'textequiv_level',
        'word', '-P', 'alternative_decoding', 'false'])
    assert res.exit_code == 0, (res.output, res.exception)
    remote = tms.RemoteWorkspace(url)
    assert sorted(f.ID for f in remote.mets.find_files(
        fileGrp='OCR-D-LM')) == sorted(f.ID for f in TWorkspace(
            local).mets.find_files(fileGrp='OCR-D-LM'))
    remote.close()
    assert_like_jax(d, jax_runs['score'])
    _same_files(d, local)


def test_remote_workspace_roundtrip(served):
    d, url = served
    remote = tms.RemoteWorkspace(url)
    assert remote.directory == os.path.abspath(d)
    assert remote.mets.unique_identifier == 'urn:test/kant_1784'
    assert remote.mets.page_ids == list(PAGES)
    assert len(list(remote.mets.find_files(fileGrp='OCR-D-OCR'))) == 4
    remote.add_file('OCR-D-NEW', 'OCR-D-NEW_page1', 'page1',
                    'OCR-D-NEW/OCR-D-NEW_page1.xml', content='<PcGts/>')
    remote.save_mets()
    remote2 = tms.RemoteWorkspace(url)
    assert next(remote2.mets.find_files(ID='OCR-D-NEW_page1'), None)
    assert next(TWorkspace(d).mets.find_files(ID='OCR-D-NEW_page1'), None)
    # a file the port's server wrote is read by the JAX package
    assert next(JWorkspace(d).mets.find_files(ID='OCR-D-NEW_page1'), None)
    # the server's FileExistsError crosses the protocol as itself (the
    # processor's OCRD_EXISTING_OUTPUT policy catches that type)
    with pytest.raises(FileExistsError, match='already exists'):
        remote.add_file('OCR-D-NEW', 'OCR-D-NEW_page1', 'page1',
                        'OCR-D-NEW/OCR-D-NEW_page1.xml', content='<a/>')
    remote.close()
    remote2.stop_server()
    remote2.close()


def test_mets_server_refuses_a_live_or_foreign_path(tmp_path):
    d = _workspace(tmp_path / 'ws')
    mets_path = os.path.join(d, 'mets.xml')
    with pytest.raises(OSError, match='not a socket'):
        tms.MetsServer(TWorkspace(d), mets_path)
    assert os.path.exists(mets_path)
    sock = str(tmp_path / 's.sock')
    server = tms.MetsServer(TWorkspace(d), sock)
    server.start()
    try:
        with pytest.raises(OSError, match='already listening'):
            tms.MetsServer(TWorkspace(d), sock)
        remote = tms.RemoteWorkspace(sock)
        remote.add_file('A', 'X', 'p1', 'A/X.xml', content='<a/>')
        remote.add_file('B', 'X', 'p1', 'B/X.xml', content='<b/>',
                        force=True)
        assert [f.fileGrp for f in remote.mets.find_files(ID='X')] == ['B']
        remote.close()
    finally:
        server.stop()


def test_download_file_returns_the_local_file(tmp_path):
    """``download_file`` (the adapter's interface) hands back the file
    it was given, on a local and on a served workspace, as JAX's
    does."""
    d = _workspace(tmp_path / 'ws')
    sock = str(tmp_path / 's.sock')
    server = tms.MetsServer(TWorkspace(d), sock)
    server.start()
    try:
        remote = tms.RemoteWorkspace(sock)
        for ws in (TWorkspace(d), remote, JWorkspace(d)):
            files = list(ws.mets.find_files(fileGrp='OCR-D-OCR'))
            assert len(files) == len(PAGES)
            for f in files:
                assert ws.download_file(f) is f
        remote.close()
    finally:
        server.stop()


def _written(directory, grp):
    """{file name: the written page} of ``grp``, its Created and
    LastChange times blanked."""
    d = os.path.join(directory, grp)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), encoding='utf-8') as fh:
            out[name] = re.sub(r'<(pc:)?(Created|LastChange)>[^<]*</',
                               r'<\1\2></', fh.read())
    return out


def test_per_page_api_matches_jax(tmp_path, cpu, model):
    """One page at a time through both packages' ``process_page_pcgts``
    (scoring) and ``process_page_pcgts_device`` (decoding with the
    carry): the written pages equal JAX's byte for byte (times
    blanked)."""
    outs = {}
    for name, proc_cls, parse in (('jax', JKerasRate, jparse_page),
                                  ('port', TKerasRate, tparse_page)):
        d = _workspace(tmp_path / name)
        ws = (JWorkspace if name == 'jax' else TWorkspace)(d)
        files = sorted(ws.mets.find_files(fileGrp='OCR-D-OCR'),
                       key=lambda f: f.ID)
        scorer = proc_cls(workspace=ws, parameter=dict(
            SCORE, model_file=model), output_file_grp='S')
        scorer.setup()
        assert (scorer._level, scorer._beam_width, scorer._lm_weight) == \
            ('word', 10, 0.5)
        decoder = proc_cls(workspace=ws, parameter=dict(
            DECODE, model_file=model), output_file_grp='D')
        decoder.setup()
        tb = None
        for f in files:
            pcgts = parse(os.path.join(d, f.local_filename))
            page = parse(os.path.join(d, f.local_filename))
            assert scorer.process_page_pcgts(pcgts) is pcgts
            tb = decoder.process_page_pcgts_device(
                page, tb, 'D_' + f.pageId, f.pageId)
            assert pcgts.get_Metadata().items[-1].value == \
                'ocrd-keraslm-rate'
            scorer._write_page(pcgts, 'S_' + f.pageId, f.pageId)
            assert tb is not None
        outs[name] = d
    for grp in ('S', 'D'):
        got, want = _texts(outs['port'], grp), _texts(outs['jax'], grp)
        assert got.keys() == want.keys() and len(want) == len(PAGES)
        for fid in want:
            for eid, tes in want[fid].items():
                assert [u for u, _ in got[fid][eid]] == \
                    [u for u, _ in tes], eid
                for (_, a), (_, b) in zip(got[fid][eid], tes):
                    assert a is None and b is None or \
                        abs(a - b) <= CONF_TOL, (eid, a, b)
        assert _written(outs['port'], grp) == _written(outs['jax'], grp)


@pytest.mark.parametrize('mode', ['decode', 'score'])
def test_download_passes_every_input_through_download_file(
        tmp_path, cpu, model, mode):
    """``KerasRate(download=True)`` hands each input to the workspace's
    ``download_file`` once, in page order on the calling thread (the page
    prefetch is off), and writes what ``download=False`` writes and what
    JAX's processor writes with ``download=True`` (decoding: both in the
    native page lane, JAX's kernel in interpret mode)."""
    params = dict(DECODE if mode == 'decode' else SCORE, model_file=model)
    outs = {}
    for name, download in (('jax', True), ('port', False), ('port', True)):
        d = _workspace(tmp_path / ('%s%d' % (name, download)))
        ws = (JWorkspace if name == 'jax' else TWorkspace)(d)
        calls = []
        plain = ws.download_file

        def counted(f, plain=plain, calls=calls):
            calls.append((f.ID, threading.current_thread().name))
            return plain(f)
        ws.download_file = counted
        proc = (JKerasRate if name == 'jax' else TKerasRate)(
            workspace=ws, parameter=params, download=download)
        assert proc.download is download
        proc.setup()
        if name == 'jax':
            proc.rater.fused_decode = True
        proc.process_workspace(ws)
        files = sorted(f.ID for f in ws.mets.find_files(
            fileGrp='OCR-D-OCR'))
        if download:
            assert [c[0] for c in calls] == files
            assert {c[1] for c in calls} == {
                threading.current_thread().name}
        else:
            assert calls == []
        outs[name, download] = _written(d, 'OCR-D-LM')
    assert len(outs['jax', True]) == len(PAGES)
    assert outs['port', True] == outs['port', False] == outs['jax', True]


# ----------------------------------------------------------------------
# the OCR-D adapter, with the genuine core faked
# ----------------------------------------------------------------------

class FakeProcessor:
    """Stand-in for ``ocrd.Processor`` (the attributes the adapter
    uses)."""

    def __init__(self, workspace=None, parameter=None, **kwargs):
        import logging
        self.workspace = workspace
        self.parameter = dict(parameter or {})
        self.logger = logging.getLogger('fake-ocrd')

    def resolve_resource(self, name):
        return name


class FakePageResult:
    def __init__(self, pcgts):
        self.pcgts = pcgts


@pytest.fixture
def fake_ocrd(monkeypatch):
    ocrd_mod = types.ModuleType('ocrd')
    ocrd_mod.Processor = FakeProcessor
    ocrd_mod.OcrdPageResult = FakePageResult
    models_mod = types.ModuleType('ocrd_models')
    page_mod = types.ModuleType('ocrd_models.ocrd_page')
    page_mod.OcrdPage = object
    models_mod.ocrd_page = page_mod
    monkeypatch.setitem(sys.modules, 'ocrd', ocrd_mod)
    monkeypatch.setitem(sys.modules, 'ocrd_models', models_mod)
    monkeypatch.setitem(sys.modules, 'ocrd_models.ocrd_page', page_mod)
    for mod in (jadapter, tadapter):
        monkeypatch.setattr(mod, '_CACHED', None)
    yield ocrd_mod


def test_adapter_selection(monkeypatch, fake_ocrd):
    assert tadapter.genuine_ocrd_available()
    cls = tadapter.select_processor_class()
    assert issubclass(cls, FakeProcessor) and cls is not TKerasRate
    assert tadapter.select_processor_class() is cls
    monkeypatch.setenv('KERASLM_STANDALONE', '1')
    assert not tadapter.genuine_ocrd_available()
    assert tadapter.select_processor_class() is TKerasRate
    monkeypatch.delenv('KERASLM_STANDALONE')
    monkeypatch.delitem(sys.modules, 'ocrd')
    monkeypatch.setitem(sys.modules, 'ocrd', None)   # not installed
    assert not tadapter.genuine_ocrd_available()
    assert tadapter.select_processor_class() is TKerasRate


@pytest.mark.parametrize('params', [
    dict(SCORE), dict(DECODE), dict(DECODE, device_decoding=False)],
    ids=['score', 'device-decode', 'host-decode'])
def test_adapter_pages_match_jax(fake_ocrd, tmp_path, cpu, model, params):
    """The adapter's ``process_page_pcgts`` over the pages, page after
    page with the carry, against JAX's adapter."""
    outs = {}
    for name, adapter, parse, ws_cls in (
            ('jax', jadapter, jparse_page, JWorkspace),
            ('port', tadapter, tparse_page, TWorkspace)):
        d = _workspace(tmp_path / name)
        ws = ws_cls(d)
        # the genuine core hands a processor every parameter, defaults
        # filled in
        parameter = {k: v.get('default') for k, v in
                     tcli.OCRD_TOOL['parameters'].items()}
        parameter.update(params, model_file=model, beam_width=4)
        proc = adapter.make_processor_class()(workspace=ws,
                                              parameter=parameter)
        proc.setup()
        elems = {}
        for f in sorted(ws.mets.find_files(fileGrp='OCR-D-OCR'),
                        key=lambda f: f.ID):
            pcgts = parse(os.path.join(d, f.local_filename))
            result = proc.process_page_pcgts(pcgts, page_id=f.pageId)
            assert isinstance(result, FakePageResult)
            for region in pcgts.get_Page().get_TextRegion():
                for line in region.get_TextLine():
                    for w in line.get_Word():
                        elems[w.id] = [(te.Unicode, te.conf)
                                       for te in w.get_TextEquiv()]
                        for g in w.get_Glyph():
                            elems[g.id] = [(te.Unicode, te.conf)
                                           for te in g.get_TextEquiv()]
        outs[name] = elems
    assert outs['port'].keys() == outs['jax'].keys()
    for eid, tes in outs['jax'].items():
        got = outs['port'][eid]
        assert [u for u, _ in got] == [u for u, _ in tes], eid
        for (_, a), (_, b) in zip(got, tes):
            assert a is None and b is None or abs(a - b) <= CONF_TOL, eid


def test_main_routes_the_service_subcommands(fake_ocrd, monkeypatch):
    """With the genuine core importable, the console script still
    reaches the standalone service subcommands."""
    for sub in ('worker', 'server', 'mets-server'):
        monkeypatch.setattr(sys, 'argv', ['ocrd-keraslm-rate', sub,
                                          '--help'])
        with pytest.raises(SystemExit) as exc:
            tcli.main()
        assert exc.value.code == 0, sub


# ----------------------------------------------------------------------
# concurrent raters and the process-wide decode weights
# ----------------------------------------------------------------------

N_MODELS = 5   # one more than the cache holds: evictions
N_ROUNDS = 2


def _lattice(seed, n_words=8):
    rng = np.random.default_rng(seed)
    edges = []
    for w in range(n_words):
        for j in range(int(rng.integers(2, 5))):
            n = 3 if j == 0 else 1
            edges.append({'element': None, 'alternatives': [
                TextEquivType(Unicode='abcd'[int(rng.integers(4))],
                              conf=float(rng.uniform(0.6, 0.95)), index=i)
                for i in range(n)]})
        edges.append({'element': None, 'alternatives': [
            TextEquivType(Unicode=' ', conf=1.0, index=0)]})
    return edges


def _decode(path, edges):
    r = TRater(device='cpu')
    r.load_config(path)
    r.stateful, r.incremental = False, True
    r.configure()
    r.load_weights(path)
    out, ent, _ = r.rate_best_device(edges, 0, len(edges), beam_width=4)
    return tuple((te.Unicode, float(score)) for _, te, score in out), \
        float(ent)


def test_concurrent_raters_equal_serial(tmp_path, monkeypatch):
    paths = [make_tiny_model(tmp_path / ('m%d.h5' % i), chars='abcd ',
                             seed=i) for i in range(N_MODELS)]
    docs = [_lattice(i) for i in range(N_MODELS)]
    monkeypatch.setattr(trater_mod, '_DECODE_WCACHE',
                        trater_mod.OrderedDict())
    serial = [_decode(p, e) for p, e in zip(paths, docs)]
    assert len(set(serial)) == N_MODELS      # distinct weights
    assert len(trater_mod._DECODE_WCACHE) == 4
    jobs = [(i, p, e) for _ in range(N_ROUNDS)
            for i, (p, e) in enumerate(zip(paths, docs))]
    results = [None] * len(jobs)
    errors = []

    def work(k):
        try:
            i, p, e = jobs[k]
            results[k] = (i, _decode(p, e))
        except BaseException as err:  # noqa: BLE001 - asserted below
            errors.append(err)
    threads = [threading.Thread(target=work, args=(k,))
               for k in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    for i, got in results:
        assert got == serial[i], i
    assert len(trater_mod._DECODE_WCACHE) == 4


def test_decode_weights_are_shared_between_raters(tmp_path, monkeypatch):
    """A new Rater over the same unchanged file reuses the staged
    weights; a changed file, or params changed since the load, do
    not."""
    monkeypatch.setattr(trater_mod, '_DECODE_WCACHE',
                        trater_mod.OrderedDict())
    path = make_tiny_model(tmp_path / 'm.h5', chars='abcd ')
    raters = []
    for _ in range(2):
        r = TRater(device='cpu')
        r.load_config(path)
        r.configure()
        r.load_weights(path)
        raters.append(r)
    a, b = (r._decode_weights([0]) for r in raters)
    assert a is b
    raters[1].remove_from_mapping(char='d')
    assert raters[1]._decode_weights([0]) is not a
    os.utime(path, ns=(1, 1))
    r = TRater(device='cpu')
    r.load_config(path)
    r.configure()
    r.load_weights(path)
    assert r._decode_weights([0]) is not a


def test_service_roles_raise_without_cuda(tmp_path, model, monkeypatch):
    """The roles run on CUDA unless the CPU is asked for: without a
    card the server and the worker raise at their model load, and do
    not go on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('this check needs a machine without CUDA')
    monkeypatch.delenv('KERASLM_PLATFORM', raising=False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tcli.make_processing_server('127.0.0.1:0', dict(DECODE,
                                                        model_file=model))
    res = CliRunner().invoke(tcli.ocrd_keraslm_rate, [
        'worker', '--queue', str(tmp_path / 'q'), '--once', '-P',
        'model_file', model])
    assert isinstance(res.exception, RuntimeError)
    assert 'CUDA' in str(res.exception)


def test_launch_counters_lose_no_count_under_threads():
    """``_build.count`` under a lock: threads counting at once (switching
    every microsecond) lose no launch, where a plain ``+= 1`` can."""
    from ocrd_keraslm_torch.ops import _build

    def fn():
        pass
    fn.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count(fn) for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 16 * 2000
