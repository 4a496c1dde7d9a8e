"""OCR-D-style processor: rate or decode text in PAGE-XML workspaces.

Counterpart of the scoring and decode paths of
``ocrd_keraslm_tpu/wrapper/rate.py`` (the reference ``KerasRate``,
wrapper/rate.py of ocrd_keraslm): PAGE-XML parsing down to the
configured ``textequiv_level`` and linear lattice construction with
artificial whitespace/newline edges and tokenisation repair, then

* with ``alternative_decoding=false`` (scoring): the first TextEquiv of
  every element is rated, all pages of the document as the parallel
  streams of one ``Rater.rate_batch`` call, and its conf blended with
  the LM's char probabilities;
* with ``alternative_decoding=true`` (the default): best-path beam
  decoding over all TextEquiv alternatives with the beam carried across
  pages.  With ``device_decoding=true`` (the default) every page is
  launched on the device first (the beam carry chains there), then each
  is fetched, walked and written in page order; a page whose lattice
  branches (a customised lattice builder may return a DAG) decodes
  through the host engine instead, and the carry resets at that page.
  With ``device_decoding=false`` every page decodes through the host
  engine (``Rater.rate_best``), with the reference's one-page lookahead:
  page N is written once page N+1 has decoded, the last page at the end.

Pages are read in one of three lanes: the native lane (default for
device decoding at word or glyph level; ``KERASLM_NATIVE_PAGE=0`` turns
it off): a C++ byte scan builds the array lattice and the result is
spliced into the original bytes (``page_native``); the ElementTree
records (``page_fast``); the object model (``KERASLM_FAST_PAGE=0``).
Consecutive native-lane pages decode as page groups, one kernel launch
for up to 1024 edges of several pages (``KERASLM_FUSE_PAGES=0``: a
launch a page).  ``lookahead_writeback=true`` keeps every page's
records and walks the pages in reverse with the entry slot chained
(the reference's lock-in); its pages take the record lane.

Both write the result back and recompute all higher hierarchy levels
honoring ReadingOrder, ``textLineOrder`` (bottom-to-top),
``readingDirection`` (right-to-left) and ``Relation type=join``.
"""
from __future__ import annotations

import logging
import os
import threading
from collections import defaultdict
from dataclasses import dataclass
from math import ceil, log
from typing import Any, Dict, List, Optional, Tuple

from .. import native
from ..utils.devtrace import span
from ..rater import (DECODE_MERGE_MAX, NonLinearLatticeError, Rater,
                     _gc_paused)
from .mets import MIMETYPE_PAGE, Mets, Workspace
from .page import (BOTTOM_TO_TOP, RIGHT_TO_LEFT, OrderedGroupIndexedType,
                   OrderedGroupType, PcGts, TextEquivType, MetadataItem,
                   parse_page, to_xml)
from . import page_native
from .page_fast import parse_page_fast
from .page_native import NativePageDoc

LOG = logging.getLogger(__name__)

CHOICE_THRESHOLD_NUM = 4     # maximum number of choices per element
CHOICE_THRESHOLD_CONF = 0.1  # maximum conf drop from best choice
# history clustering of the host engine's beam (the reference's values)
BEAM_CLUSTERING_ENABLE = True
BEAM_CLUSTERING_DIST = 5

# child level per hierarchy tag (for tokenisation-problem filtering)
_HIERARCHY = {
    'Page': 'region',
    'TextRegion': 'line',
    'TextLine': 'word',
    'Word': 'glyph',
    'Glyph': '',
}

OCRD_TOOL = {
    'executable': 'ocrd-keraslm-rate',
    'categories': ['Text recognition and optimization'],
    'steps': ['recognition/text-recognition'],
    'description': 'Rate elements of the text with a character-level '
                   'LSTM language model (PyTorch/CUDA)',
    'parameters': {
        'model_file': {'type': 'string', 'required': True},
        'textequiv_level': {
            'type': 'string',
            'enum': ['region', 'line', 'word', 'glyph'],
            'default': 'glyph'},
        'alternative_decoding': {'type': 'boolean', 'default': True},
        'beam_width': {'type': 'number', 'default': 10},
        'lm_weight': {'type': 'number', 'default': 0.5},
        'device_decoding': {'type': 'boolean', 'default': True},
        'lookahead_writeback': {'type': 'boolean', 'default': False},
    },
}

def _config_env(name, default):
    return os.environ.get(name, default)


def _pending_ready(pending) -> bool:
    """Whether finishing a launched page cannot block: every result of
    its pending is on the host (its copy's CUDA event has completed, or
    it lies in host memory already)."""
    if pending[0] == 'done':
        return True
    if pending[0] == 'gseg':
        pending = pending[1]
    return all(not hasattr(a, 'ready') or a.ready() for a in pending[2])


@dataclass
class RateState:
    """Cross-page state of the host engine: its traceback is one page
    ahead of the written output (page N's decisions lock in when page
    N+1 decodes).  ``traceback`` is ``(hypotheses, anchor)`` as
    ``host_beam.advance_traceback`` leaves it."""
    traceback: Tuple[List[Any], Any]
    pcgts: PcGts
    file_id: str
    page_id: str


class KerasRate:
    """The ``ocrd-keraslm-rate`` processor (scoring, or beam decoding of
    TextEquiv alternatives on the device or by the host engine)."""

    def __init__(self, workspace: Optional[Workspace] = None,
                 input_file_grp: str = 'OCR-D-OCR',
                 output_file_grp: str = 'OCR-D-LM',
                 parameter: Optional[Dict[str, Any]] = None,
                 logger: Optional[logging.Logger] = None,
                 download: bool = False, device=None):
        self.workspace = workspace
        self.input_file_grp = input_file_grp
        self.output_file_grp = output_file_grp
        self.logger = logger or LOG
        # pass every input through workspace.download_file first
        self.download = download
        self.device = device
        self._ws_lock = threading.Lock()
        self.parameter = dict(parameter or {})
        # deferred-METS-save state (see process_workspace)
        self._defer_mets = False
        self._mets_dirty = False
        self._mets_unsaved = 0
        for name, schema in OCRD_TOOL['parameters'].items():
            if name not in self.parameter:
                if schema.get('required'):
                    raise ValueError('parameter %s is required' % name)
                self.parameter[name] = schema.get('default')
            if 'enum' in schema and \
                    self.parameter[name] not in schema['enum']:
                raise ValueError('invalid value %r for parameter %s'
                                 % (self.parameter[name], name))
        self.rater: Optional[Rater] = None

    @property
    def executable(self):
        return OCRD_TOOL['executable']

    @property
    def input_files(self):
        return sorted(self.workspace.mets.find_files(
            fileGrp=self.input_file_grp),
            key=lambda f: self.workspace.mets.page_ids.index(f.pageId)
            if f.pageId in self.workspace.mets.page_ids else 1 << 30)

    # -- setup ---------------------------------------------------------

    def resolve_resource(self, name):
        if os.path.isfile(name):
            return name
        for base in (os.getcwd(),
                     os.path.expanduser('~/.local/share/ocrd-resources/'
                                        'ocrd-keraslm-rate')):
            cand = os.path.join(base, name)
            if os.path.isfile(cand):
                return cand
        raise FileNotFoundError('cannot resolve model resource %r' % name)

    # frequently consulted parameters, in one place
    @property
    def _level(self) -> str:
        return self.parameter['textequiv_level']

    @property
    def _beam_width(self) -> int:
        return self.parameter['beam_width']

    @property
    def _lm_weight(self) -> float:
        return self.parameter['lm_weight']

    def _page_context(self):
        """Year-decade context from the METS unique identifier."""
        return mets_get_context(self.workspace.mets)

    def setup(self):
        model = self.resolve_resource(self.parameter['model_file'])
        self.rater = Rater(logger=self.logger, device=self.device)
        self.rater.load_config(model)
        if self.parameter['alternative_decoding']:
            self.rater.stateful = False   # no implicit state transfer
            self.rater.incremental = True  # explicit state transfer
        elif self.rater.stateful:
            self.rater.batch_size = 1
        self.rater.configure()
        self.rater.load_weights(model)
        self.logger.debug("Loaded model_file '%s'", model)

    def add_metadata(self, pcgts: PcGts):
        pcgts.add_metadata_item(MetadataItem(
            type='processingStep',
            name=OCRD_TOOL['steps'][0],
            value=OCRD_TOOL['executable'],
            labels={'parameters': {
                k: str(v) for k, v in self.parameter.items()}}))

    def verify(self):
        if self.workspace is None:
            raise ValueError('no workspace set')
        return True

    # -- dispatch ------------------------------------------------------

    @_gc_paused
    def process_workspace(self, workspace: Workspace) -> None:
        """Score (``alternative_decoding=false``) or beam-decode
        (``=true``) all pages of the workspace.

        The METS is saved at the end of the run (and every
        ``KERASLM_METS_FLUSH_PAGES`` pages), not per page; an abort
        persists what was registered before it re-raises."""
        with span('rate.workspace'):
            if self.rater is None:
                self.workspace = workspace
                self.setup()
            self._defer_mets = True
            self._mets_dirty = False
            self._mets_unsaved = 0
            try:
                if self.parameter['alternative_decoding']:
                    self.process_workspace_stateful(workspace)
                else:
                    self.process_workspace_stateless(workspace)
            except BaseException:
                # persist what was registered so far, but never mask the
                # in-flight error with a failing save
                self._defer_mets = False
                try:
                    if self._mets_dirty:
                        with self._ws_lock:
                            self.workspace.save_mets()
                except Exception as save_err:
                    self.logger.error(
                        'deferred METS save failed during abort: %s',
                        save_err)
                raise
            self._defer_mets = False
            if self._mets_dirty:
                with self._ws_lock, span('rate.mets_save'):
                    self.workspace.save_mets()

    def process_workspace_stateless(self, workspace: Workspace) -> None:
        """Plain scoring: pages are independent.  All pages of the
        document are rated as the parallel streams of ONE
        ``Rater.rate_batch`` call; the host work around it (PAGE parse,
        lattice build, write-back) runs in ``OCRD_MAX_PARALLEL_PAGES``
        threads.  A page that fails follows ``OCRD_MISSING_OUTPUT``."""
        self.workspace = workspace
        self.verify()
        n_par = int(os.environ.get('OCRD_MAX_PARALLEL_PAGES', '1') or 1)
        level = self._level
        context = self._page_context()

        def prep(input_file):
            page_id = input_file.pageId
            try:
                pcgts = self._load_page(input_file, page_id)
                if pcgts is None:
                    return None
                file_id = self._make_file_id(input_file)
                if self._output_exists(file_id):
                    return None
                edges = _require_edge_list(
                    page_get_linear_lattice_at(level, pcgts,
                                               logger=self.logger),
                    'stateless scoring')
                text = [(edge['element'], edge['alternatives'])
                        for edge in edges]
                return (pcgts, file_id, page_id, text,
                        ''.join(tes[0].Unicode for _, tes in text),
                        input_file)
            except KeyboardInterrupt:
                raise
            except Exception as err:
                self._handle_page_error(err, page_id, input_file)
                return 'failed'

        def in_threads(fn, items):
            if n_par > 1 and len(items) > 1:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(max_workers=n_par) as pool:
                    return list(pool.map(fn, items))
            return [fn(item) for item in items]

        prepped = in_threads(prep, self.input_files)
        nr_failed = sum(1 for p in prepped if p == 'failed')
        pages = [p for p in prepped
                 if p is not None and not isinstance(p, str)]
        self._check_missing_ratio(nr_failed, nr_failed + len(pages))
        if not pages:
            return
        all_confidences = self.rater.rate_batch(
            [p[4] for p in pages], [context] * len(pages))

        def finish(args):
            (pcgts, file_id, page_id, text, _,
             input_file), confidences = args
            try:
                self._apply_confidences(pcgts, text, confidences, level)
                self._write_page(pcgts, file_id, page_id)
                return True
            except KeyboardInterrupt:
                raise
            except Exception as err:
                self._handle_page_error(err, page_id, input_file)
                return False

        done = in_threads(finish, list(zip(pages, all_confidences)))
        nr_failed += sum(1 for ok in done if not ok)
        self._check_missing_ratio(nr_failed, nr_failed +
                                  sum(1 for ok in done if ok))

    def _apply_confidences(self, pcgts, text, confidences, level):
        apply_confidences(text, confidences, level,
                          self._lm_weight, self.logger)

    def process_workspace_stateful(self, workspace: Workspace) -> None:
        """Sequential page loop with the beam carried across pages and
        the OCR-D error policy (OCRD_MISSING_OUTPUT /
        OCRD_EXISTING_OUTPUT / OCRD_MAX_MISSING_OUTPUTS).

        On the device every page is launched first, then fetched and
        written in page order; pages whose results are already on the
        host are written between launches.  Pages that the native lane
        serves gather into page groups, one ``decode_lattice`` launch a
        group (``KERASLM_FUSE_PAGES=0``: a launch a page); any other
        page flushes the open group first, so the carry stays in page
        order.  With ``lookahead_writeback`` every page keeps its
        records, and the pages are walked in reverse with the entry
        slot chained, so that page N's path is the one the globally
        best final path runs through (reference lib/rating.py:736-741);
        they are still written in page order.  A branching page decodes
        through the host engine and is locked in and written at once
        (the pages launched before it are walked and written first),
        and the device carry resets: the device and host beams are not
        interchangeable.  With ``device_decoding=false`` the host engine
        decodes every page, writing each once the next has decoded; the
        last is locked in at the end."""
        level = self._level
        self.workspace = workspace
        self.verify()
        nr_succeeded = 0
        nr_failed = 0
        nr_errors: Dict[str, int] = defaultdict(int)
        missing_policy = _config_env('OCRD_MISSING_OUTPUT', 'SKIP')
        reason = {'SKIP': 'skipped', 'COPY': 'fallback-copied'}.get(
            missing_policy, 'failed')
        prev: Optional[RateState] = None
        device_tb = None
        device_mode = self.parameter['device_decoding']
        lookahead = bool(self.parameter['lookahead_writeback'])
        device_pending = []  # launched pages awaiting fetch/write
        input_files = list(self.input_files)
        if device_mode and native.enabled():
            # build the native libraries here, outside the page policy:
            # a failed build raises instead of failing every page
            native.load_decode_prep()
            self._native_page_eligible()

        def page_failure(input_file, page_id, err):
            """OCRD_MISSING_OUTPUT policy for ONE failed page: ABORT
            raises, COPY emits the input as fallback, every failure is
            logged and counted toward the ratio abort.  A failure inside
            a page group is attributed to ITS page.  What the port does
            not have yet (NotImplementedError) raises under every
            policy: a page it cannot write is never skipped silently."""
            nonlocal nr_failed
            if missing_policy == 'ABORT' or \
                    isinstance(err, NotImplementedError):
                self.logger.error('Failure on page %s: %s', page_id,
                                  str(err) or err.__class__.__name__)
                raise err
            self.logger.exception('Failure on page %s: %s', page_id,
                                  str(err) or err.__class__.__name__)
            if missing_policy == 'COPY':
                self._copy_page_file(input_file)
            nr_errors[err.__class__.__name__] += 1
            nr_failed += 1
            # early abort only when the ratio is ALREADY hopeless (even
            # if every remaining page succeeds)
            max_missing = self._max_missing_ratio()
            if 0 < max_missing < nr_failed / max(len(input_files), 1):
                raise RuntimeError(
                    'too many failures with %s output (%d of %d, %s)'
                    % (reason, nr_failed, len(input_files),
                       dict(nr_errors)))

        def existing_output(err):
            existing_policy = _config_env('OCRD_EXISTING_OUTPUT', 'SKIP')
            if existing_policy == 'ABORT':
                raise err
            if existing_policy == 'OVERWRITE':
                raise RuntimeError(
                    'got %r despite OCRD_EXISTING_OUTPUT==OVERWRITE' % err)

        def finish_one(rec, result=None):
            """Fetch and write ONE launched page under the policy;
            success counts only once the page is written."""
            nonlocal nr_succeeded
            page_id, input_file = rec[3], rec[4]
            try:
                self._finish_device_page(rec[:4], result=result)
                nr_succeeded += 1
            except FileExistsError as err:
                existing_output(err)
            except KeyboardInterrupt:
                raise
            except Exception as err:
                page_failure(input_file, page_id, err)

        def drain_ready():
            """Write head pages whose results are already on the host
            (never blocks the launches); lookahead needs every page's
            records first, so it never drains early."""
            if lookahead:
                return
            while device_pending and \
                    _pending_ready(device_pending[0][0]):
                finish_one(device_pending.pop(0))

        def finish_pending():
            """Fetch and write every launched page, in page order; under
            lookahead walk them in reverse first, chaining the entry
            slot.  A failed walk restarts the chain at slot 0 and leaves
            its page to the write loop's error policy."""
            results = [None] * len(device_pending)
            if lookahead and device_pending:
                with span('rate.finish'):
                    fetched = self.rater.fetch_pendings(
                        [rec[0] for rec in device_pending], prefetched=True)
                device_pending[:] = [(p,) + rec[1:] for p, rec in
                                     zip(fetched, device_pending)]
                slot = 0
                for pi in range(len(device_pending) - 1, -1, -1):
                    try:
                        with span('rate.finish',
                                  'page=%s' % device_pending[pi][3]):
                            results[pi], slot = \
                                self.rater.rate_best_device_finish(
                                    device_pending[pi][0], start_slot=slot,
                                    return_entry=True)
                    except KeyboardInterrupt:
                        raise
                    except Exception:
                        if missing_policy == 'ABORT':
                            raise
                        self.logger.exception(
                            'lookahead walk failed on page %s',
                            device_pending[pi][3])
                        slot = 0
            pending = list(device_pending)
            device_pending.clear()
            for rec, result in zip(pending, results):
                finish_one(rec, result)

        # page-group fusion: consecutive native-lane pages gather here
        # and launch as ONE decode_lattice call (bit-identical results)
        gbuf: List[tuple] = []
        fuse_pages = os.environ.get('KERASLM_FUSE_PAGES', '1') != '0'

        def flush_group():
            nonlocal device_tb
            device_tb = self._flush_page_group(gbuf, device_tb,
                                               device_pending, page_failure)

        # one-ahead page load: the file read and native scan of page i+1
        # overlap page i's launch work (one worker thread; an error
        # surfaces at .result() inside the consuming page's policy
        # guard); off while downloading: download_file changes the
        # workspace, so the pages load in order
        prefetcher = None
        futures: List[Any] = [None] * len(input_files)
        if device_mode and not self.download and len(input_files) > 1:
            from concurrent.futures import ThreadPoolExecutor
            prefetcher = ThreadPoolExecutor(max_workers=1)

        def load_page_at(i):
            page_id = input_files[i].pageId
            if prefetcher is None:
                with span('rate.load_wait', 'page=%s' % page_id):
                    return self._load_page(input_files[i], page_id)
            for j in (i, i + 1):
                if j < len(input_files) and futures[j] is None:
                    futures[j] = prefetcher.submit(
                        self._load_page, input_files[j],
                        input_files[j].pageId)
            with span('rate.load_wait', 'page=%s' % page_id):
                return futures[i].result()

        try:
            for page_i, input_file in enumerate(input_files):
                drain_ready()
                page_id = input_file.pageId
                self.logger.info('preparing page %s', page_id)
                try:
                    # inside the policy guard: a non-PAGE input is a page
                    # failure (SKIP/COPY/ABORT), not a silent skip
                    pcgts = load_page_at(page_i)
                    if pcgts is None:
                        continue
                    file_id = self._make_file_id(input_file)
                    if self._output_exists(file_id):
                        continue
                    if not device_mode:
                        prev = self.process_page_pcgts_stateful(
                            pcgts, prev, file_id, page_id)
                        nr_succeeded += 1
                        continue
                    scan = (self._native_scan_for_group(pcgts)
                            if fuse_pages and
                            isinstance(pcgts, NativePageDoc) else None)
                except FileExistsError as err:
                    existing_output(err)
                    continue
                except KeyboardInterrupt:
                    raise
                except Exception as err:
                    page_failure(input_file, page_id, err)
                    continue
                # group flushes run outside the page guard: host-side
                # failures retry page by page inside the flush, and a
                # kernel error raises
                if scan is not None:
                    n_raw, n_prep, maxlen = scan
                    if gbuf and not self.rater.fused_group_fits(
                            sum(g[3] for g in gbuf) + n_prep,
                            max(max(g[4] for g in gbuf), maxlen),
                            self._beam_width):
                        flush_group()
                    # per-page log lines as on the per-page path
                    self.rater.logger.info(
                        "Scoring text in page '%s' at the %s level "
                        '(device beam)', pcgts.get_pcGtsId(), level)
                    self.rater.logger.info(
                        'Rating %d elements including its alternatives',
                        n_raw)
                    gbuf.append((pcgts, file_id, page_id, n_prep, maxlen,
                                 n_raw, input_file))
                    continue
                flush_group()
                try:
                    rec, device_tb = self.process_page_pcgts_device_begin(
                        pcgts, device_tb, file_id, page_id)
                except NonLinearLatticeError as nle:
                    # a branching lattice (a customised builder returned
                    # a DAG) decodes THIS page by the host engine, locked
                    # in at once; the device carry resets in both
                    # directions at the engine switch
                    self.logger.info(
                        'page %s: %s — decoding via the host DAG engine '
                        '(beam carry resets at the engine switch)',
                        page_id, nle)
                    try:
                        if isinstance(pcgts, NativePageDoc):
                            # the host engine needs the PAGE object API
                            pcgts = pcgts.to_fast()
                        state = self.process_page_pcgts_stateful(
                            pcgts, None, file_id, page_id)
                        path, entropy, _ = self.rater.next_path(
                            state.traceback[0], ([], state.traceback[1]))
                        finish_pending()
                        _page_update_from_path(level, path, entropy,
                                               logger=self.logger)
                        page_update_higher_textequiv_levels(level,
                                                            state.pcgts)
                        self._write_page(state.pcgts, state.file_id,
                                         state.page_id)
                        nr_succeeded += 1
                    except FileExistsError as err:
                        existing_output(err)
                    except KeyboardInterrupt:
                        raise
                    except Exception as err:
                        page_failure(input_file, page_id, err)
                    device_tb = None
                    continue
                except FileExistsError as err:
                    existing_output(err)
                    continue
                except KeyboardInterrupt:
                    raise
                except Exception as err:
                    page_failure(input_file, page_id, err)
                    continue
                # success is only counted when the page is fetched AND
                # written (finish_one)
                device_pending.append(rec + (input_file,))
        finally:
            # the prefetch thread must not outlive the run
            if prefetcher is not None:
                prefetcher.shutdown(wait=False, cancel_futures=True)
        flush_group()
        finish_pending()
        if prev:
            # the host engine's last page: lock it into its own best path
            path, entropy, _ = self.rater.next_path(
                prev.traceback[0], ([], prev.traceback[1]))
            _page_update_from_path(level, path, entropy, logger=self.logger)
            page_update_higher_textequiv_levels(level, prev.pcgts)
            self._write_page(prev.pcgts, prev.file_id, prev.page_id)
        if nr_failed > 0:
            self.logger.warning('%s %d of %d pages due to %s', reason,
                                nr_failed, nr_failed + nr_succeeded,
                                dict(nr_errors))
            # end-of-run enforcement over PROCESSED pages (ocrd core
            # semantics: failures/(failures+successes))
            max_missing = self._max_missing_ratio()
            if 0 < max_missing < \
                    nr_failed / max(nr_failed + nr_succeeded, 1):
                raise RuntimeError(
                    'too many failures with %s output (%d of %d, %s)'
                    % (reason, nr_failed, nr_failed + nr_succeeded,
                       dict(nr_errors)))

    # -- per-page processing ------------------------------------------

    def _native_page_eligible(self) -> bool:
        """Whether the native lane serves this run's pages: device
        decoding at word or glyph level without lookahead (whose reverse
        walk needs the record protocol), ``KERASLM_NATIVE_PAGE`` not 0
        and the scanner built (a failed build raises)."""
        return (self.parameter['alternative_decoding']
                and self.parameter['device_decoding']
                and not self.parameter['lookahead_writeback']
                and self._level in ('word', 'glyph')
                and self.rater is not None
                and os.environ.get('KERASLM_NATIVE_PAGE', '1') != '0'
                and page_native.available())

    def _native_scan_for_group(self, doc: NativePageDoc):
        """The lattice of a native doc for page-group fusion: ``(n_raw,
        n_prep, maxlen)`` when one launch can take the page, else None
        (the caller flushes the group and takes the per-page path,
        which checks its own gates)."""
        lat = doc.lattice(self._level,
                          self.rater.merge_runs, DECODE_MERGE_MAX)
        if lat is None or self.rater.fused_gate_arrays(
                lat[1], lat[2], self._beam_width) is None:
            return None
        return lat

    def _flush_page_group(self, gbuf, device_tb, device_pending,
                          on_failure):
        """Launch the buffered native pages as ONE ``decode_lattice``
        call (:meth:`Rater.rate_best_device_begin_arrays_group`): the
        carry flows through the concatenated edges as it would across
        per-page launches, and each page is walked from its own last
        edge's rank-0 slot.  When the host side of the group fails (the
        gate or a page's fill), each page is retried through the
        per-page begin, and a page that fails there too goes to
        ``on_failure`` (the caller's page policy) under ITS page id.  A
        failure of the launch itself (a kernel build or launch error)
        raises."""
        if not gbuf:
            return device_tb
        beam_width = self._beam_width
        pages = list(gbuf)
        gbuf.clear()
        with span('rate.launch', 'page=%s' % pages[0][2]):
            try:
                gate = self.rater.fused_gate_arrays(
                    sum(g[3] for g in pages), max(g[4] for g in pages),
                    beam_width)
                if gate is None:
                    raise RuntimeError('page group no longer fits one launch')
                table = self.rater.vocab._table()
                segs = [(n_prep,) + doc.fill(table, n_prep, 4, gate[1])
                        for doc, _, _, n_prep, _, _, _ in pages]
            except KeyboardInterrupt:
                raise
            except Exception:
                self.logger.exception('page-group prep failed; launching its '
                                      'pages one by one')
                for doc, fid, pid, _, _, _, inf in pages:
                    try:
                        rec, device_tb = self.process_page_pcgts_device_begin(
                            doc, device_tb, fid, pid)
                    except KeyboardInterrupt:
                        raise
                    except Exception as err:
                        on_failure(inf, pid, err)
                        continue
                    device_pending.append(rec + (inf,))
                return device_tb
            pending, device_tb = \
                self.rater.rate_best_device_begin_arrays_group(
                    segs, device_traceback=device_tb,
                    context=self._page_context(),
                    lm_weight=self._lm_weight, beam_width=beam_width)
            page_native.groups += 1
            page_native.pages += len(pages)
            for i, (doc, fid, pid, _, _, _, inf) in enumerate(pages):
                device_pending.append((('gseg', pending, i), doc, fid, pid,
                                       inf))
            return device_tb

    def _device_begin_native(self, doc: NativePageDoc, device_tb,
                             file_id: str, page_id: str):
        """Native-lane begin: the array lattice straight into one
        ``decode_lattice`` launch.  Returns None when the lattice or the
        kernel's gate refuses the page (counted as a bail; the caller
        takes the record lane through ``doc.to_fast()``)."""
        level = self._level
        beam_width = self._beam_width
        lat = doc.lattice(level, self.rater.merge_runs, DECODE_MERGE_MAX)
        if lat is None:
            return None
        n_raw, n_prep, maxlen = lat
        gate = self.rater.fused_gate_arrays(n_prep, maxlen, beam_width)
        if gate is None:
            page_native._bail(
                doc, 'kernel gate: %d prepared edges, alternatives of up '
                'to %d chars at beam width %d' % (n_prep, maxlen,
                                                  beam_width))
            return None
        E, L = gate
        self.rater.logger.info("Scoring text in page '%s' at the %s "
                               'level (device beam)',
                               doc.get_pcGtsId(), level)
        chars, mask, conf, valid = doc.fill(self.rater.vocab._table(),
                                            E, 4, L)
        self.rater.logger.info('Rating %d elements including its '
                               'alternatives', n_raw)
        pending, device_tb = self.rater.rate_best_device_begin_arrays(
            n_prep, E, L, chars, mask, conf, valid,
            device_traceback=device_tb, context=self._page_context(),
            lm_weight=self._lm_weight, beam_width=beam_width)
        page_native.pages += 1
        return (pending, doc, file_id, page_id), device_tb

    def process_page_pcgts_device_begin(self, pcgts: PcGts, device_tb,
                                        file_id: str, page_id: str):
        """Build the page lattice and LAUNCH its decode; returns
        (pending record, new device traceback).  A native doc takes the
        array lattice where its gates pass, else the record lane."""
        with span('rate.launch', 'page=%s' % page_id):
            if isinstance(pcgts, NativePageDoc):
                rec = self._device_begin_native(pcgts, device_tb, file_id,
                                                page_id)
                if rec is not None:
                    return rec
                self.logger.debug('native page lane ineligible (%s): record '
                                  'lane', pcgts.bail)
                pcgts = pcgts.to_fast()
            level = self._level
            self.rater.logger.info("Scoring text in page '%s' at the %s "
                                   'level (device beam)',
                                   pcgts.get_pcGtsId(), level)
            edges = page_get_linear_lattice_at(level, pcgts,
                                               logger=self.logger)
            self.rater.logger.info('Rating %d elements including its '
                                   'alternatives', len(edges))
            pending, device_tb = self.rater.rate_best_device_begin(
                edges, 0, len(edges),
                device_traceback=device_tb,
                context=self._page_context(),
                lm_weight=self._lm_weight,
                beam_width=self._beam_width,
                defer_walk=bool(self.parameter['lookahead_writeback']))
            return (pending, pcgts, file_id, page_id), device_tb

    def process_page_pcgts_device(self, pcgts: PcGts, device_tb,
                                  file_id: str, page_id: str):
        """Decode and write one page on the device from ``device_tb`` (the
        previous page's traceback, or None); returns this page's."""
        rec, device_tb = self.process_page_pcgts_device_begin(
            pcgts, device_tb, file_id, page_id)
        self._finish_device_page(rec)
        return device_tb

    def process_page_pcgts_stateful(self, pcgts: PcGts,
                                    prev: Optional[RateState],
                                    file_id: str, page_id: str
                                    ) -> RateState:
        """Decode one page by the host engine from the previous page's
        traceback, and write the previous page with the path this
        decode locked in; returns this page's state (written later)."""
        level = self._level
        self.rater.logger.info("Scoring text in page '%s' at the %s level",
                               pcgts.get_pcGtsId(), level)
        graph, start_node, end_node = page_get_linear_graph_at(
            level, pcgts, logger=self.logger)
        # edge count, not node arithmetic: a customised builder's DAG may
        # use non-integer node labels
        self.rater.logger.info('Rating %d elements including its '
                               'alternatives', graph.number_of_edges())
        path, entropy, traceback = self.rater.rate_best(
            graph, start_node, end_node,
            start_traceback=prev and prev.traceback,
            context=self._page_context(),
            lm_weight=self._lm_weight,
            beam_width=self._beam_width,
            beam_clustering_dist=(BEAM_CLUSTERING_DIST
                                  if BEAM_CLUSTERING_ENABLE else 0))
        if prev:
            _page_update_from_path(level, path, entropy,
                                   logger=self.logger)
            page_update_higher_textequiv_levels(level, prev.pcgts)
            try:
                self._write_page(prev.pcgts, prev.file_id, prev.page_id)
            except FileExistsError:
                # this page's state must still advance: re-raising would
                # freeze ``prev`` and drop every later page's output
                if _config_env('OCRD_EXISTING_OUTPUT', 'SKIP') == 'ABORT':
                    raise
                self.logger.warning('output for page %s already exists: '
                                    'skipped', prev.page_id)
        return RateState(traceback=traceback, pcgts=pcgts, file_id=file_id,
                         page_id=page_id)

    def _finish_device_page(self, rec, result=None):
        """Fetch, walk and write one launched page: a page-group segment
        or a native doc by splice edits inside the doc, a record-lane
        page by its path (``result``: the path a lookahead walk
        found)."""
        with span('rate.finish', 'page=%s' % rec[3]):
            pending, pcgts, file_id, page_id = rec
            level = self._level
            if pending[0] == 'gseg' or isinstance(pcgts, NativePageDoc):
                if pending[0] == 'gseg':
                    _, group_pending, seg_i = pending
                    choices, costs, start_cost = \
                        self.rater.rate_best_device_finish_group(
                            group_pending, seg_i)
                else:
                    choices, costs, start_cost = \
                        self.rater.rate_best_device_finish_arrays(pending)
                pcgts.apply_decode(level, choices, costs, start_cost,
                                   logger=self.logger)
                self._write_page(pcgts, file_id, page_id)
                return
            path, entropy = (result if result is not None
                             else self.rater.rate_best_device_finish(pending))
            _page_update_from_path(level, path, entropy, logger=self.logger)
            page_update_higher_textequiv_levels(level, pcgts)
            self._write_page(pcgts, file_id, page_id)

    def process_page_pcgts(self, pcgts: PcGts) -> PcGts:
        """Score one page (no alternatives) and add this processor's
        metadata; returns the page (not written)."""
        level = self._level
        self.rater.logger.info("Scoring text in page '%s' at the %s level",
                               pcgts.get_pcGtsId(), level)
        score_page_pcgts(self.rater, pcgts, level, self._page_context(),
                         self._lm_weight, logger=self.logger)
        self.add_metadata(pcgts)
        return pcgts

    # -- helpers -------------------------------------------------------

    def _load_page(self, input_file, page_id) -> Optional[PcGts]:
        with span('rate.load', 'page=%s' % page_id):
            if self.download:
                input_file = self.workspace.download_file(input_file)
            if input_file.local_filename is None:
                self.logger.debug('ignoring missing file for page %s',
                                  page_id)
                return None
            path = os.path.join(self.workspace.directory,
                                input_file.local_filename)
            self.logger.info('processing page %s', page_id)
            # outside the page guard: a failed build of the scanner raises
            native_lane = os.environ.get('KERASLM_FAST_PAGE',
                                         '1') != '0' and \
                self._native_page_eligible()
            try:
                # three lanes: the native byte lane (C++ scan and splice
                # write-back, device decoding only), the ElementTree records
                # (page_fast), the object model (KERASLM_FAST_PAGE=0)
                if native_lane:
                    doc = NativePageDoc(path)
                    if doc.bail is None:
                        return doc
                    self.logger.debug('native page lane bailed (%s): record '
                                      'lane', doc.bail)
                if os.environ.get('KERASLM_FAST_PAGE', '1') != '0':
                    return parse_page_fast(path)
                return parse_page(path)
            except Exception as err:
                # surface as a page FAILURE so the caller's
                # OCRD_MISSING_OUTPUT policy applies
                raise ValueError('non-PAGE input for page %s: %s'
                                 % (page_id, err)) from err

    def _make_file_id(self, input_file) -> str:
        if input_file.fileGrp == self.output_file_grp:
            return input_file.ID
        return input_file.ID.replace(input_file.fileGrp,
                                     self.output_file_grp) \
            if input_file.fileGrp in input_file.ID \
            else '%s_%s' % (self.output_file_grp, input_file.ID)

    def _output_exists(self, file_id) -> bool:
        existing = next(self.workspace.mets.find_files(ID=file_id), None)
        if existing and _config_env('OCRD_EXISTING_OUTPUT',
                                    'SKIP') != 'OVERWRITE':
            self.logger.error(
                'A file with ID==%s already exists %s and neither force '
                'nor ignore are set', file_id, existing)
            return True
        return False

    def _write_page(self, pcgts: PcGts, file_id: str, page_id: str):
        pcgts.set_pcGtsId(file_id)
        self.add_metadata(pcgts)
        with self._ws_lock:
            self.workspace.add_file(
                file_grp=self.output_file_grp,
                ID=file_id,
                pageId=page_id,
                local_filename=os.path.join(self.output_file_grp,
                                            file_id + '.xml'),
                mimetype=MIMETYPE_PAGE,
                content=to_xml(pcgts),
                force=_config_env('OCRD_EXISTING_OUTPUT',
                                  'SKIP') == 'OVERWRITE')
            self._mets_changed_locked()

    def _mets_changed_locked(self):
        """Under ``_ws_lock``: save the METS now, or — while a run
        defers it — record the change and flush every
        ``KERASLM_METS_FLUSH_PAGES`` pages (default 64, 0 = end of run
        only), so a hard kill loses at most one window."""
        if not self._defer_mets:
            with span('rate.mets_save'):
                self.workspace.save_mets()
            return
        self._mets_dirty = True
        self._mets_unsaved += 1
        window = int(os.environ.get('KERASLM_METS_FLUSH_PAGES',
                                    '64') or 0)
        if window > 0 and self._mets_unsaved >= window:
            with span('rate.mets_save'):
                self.workspace.save_mets()
            self._mets_unsaved = 0
            self._mets_dirty = False

    def _copy_page_file(self, input_file):
        path = os.path.join(self.workspace.directory,
                            input_file.local_filename)
        with open(path, encoding='utf-8') as fh:
            content = fh.read()
        file_id = self._make_file_id(input_file)
        with self._ws_lock:
            self.workspace.add_file(
                file_grp=self.output_file_grp, ID=file_id,
                pageId=input_file.pageId,
                local_filename=os.path.join(self.output_file_grp,
                                            file_id + '.xml'),
                mimetype=MIMETYPE_PAGE, content=content, force=True)
            self._mets_changed_locked()

    def _handle_page_error(self, err, page_id, input_file=None):
        """Apply OCRD_MISSING_OUTPUT to one page failure: ABORT
        re-raises, COPY falls back to the input file (when given),
        anything else skips with a log.  NotImplementedError (what the
        port does not have yet) re-raises under every policy."""
        policy = _config_env('OCRD_MISSING_OUTPUT', 'SKIP')
        if policy == 'ABORT' or isinstance(err, NotImplementedError):
            self.logger.error('Failure on page %s: %s', page_id, err)
            raise err
        self.logger.exception('Failure on page %s', page_id)
        if policy == 'COPY' and input_file is not None:
            try:
                self._copy_page_file(input_file)
            except Exception:  # noqa: BLE001 — fallback of a fallback
                self.logger.exception('COPY fallback failed for page %s',
                                      page_id)

    def _check_missing_ratio(self, nr_failed: int, total: int) -> None:
        """Raise once the failed-page share exceeds
        OCRD_MAX_MISSING_OUTPUTS (disabled at <= 0)."""
        max_missing = self._max_missing_ratio()
        if nr_failed and 0 < max_missing < nr_failed / max(total, 1):
            raise RuntimeError(
                'too many failures with missing output (%d of %d)'
                % (nr_failed, total))

    @staticmethod
    def _max_missing_ratio() -> float:
        """OCRD_MAX_MISSING_OUTPUTS as a float; empty/invalid values
        disable the threshold instead of crashing the error handler."""
        raw = (_config_env('OCRD_MAX_MISSING_OUTPUTS', '-1')
               or '').strip()
        try:
            return float(raw)
        except ValueError:
            return -1.0


# ---------------------------------------------------------------------
# context extraction
# ---------------------------------------------------------------------

def mets_get_context(mets: Mets, limit: int = 200) -> List[int]:
    """Year context from the METS unique identifier suffix, bucketed as
    ceil(year/10) (reference wrapper/rate.py:328-341).  Buckets beyond
    the context table (years >= 2000 at the default 200 rows) map to
    the underspecified 0 instead of silently clamping on device."""
    ident = mets.unique_identifier
    context = [0]
    if ident:
        name = ident.split('/')[-1]
        year = name.split('_')[-1]
        if year.isnumeric():
            bucket = ceil(int(year) / 10)
            context = [bucket] if bucket < limit else [0]
    return context


# ---------------------------------------------------------------------
# page scoring
# ---------------------------------------------------------------------

def apply_confidences(text, confidences, level, lm_weight,
                      logger=None) -> None:
    """Blend LM char probabilities into the first TextEquiv of every
    element (conf = lm*w + ocr*(1-w)), delete other alternatives, and
    log the avg/char-ppl/segment-ppl line (the line format is API —
    tests parse it; reference wrapper/rate.py:309-325)."""
    logger = logger or LOG
    if not confidences:
        logger.warning('page has no text to rate')
        return
    i = 0
    for element, textequivs in text:
        textequiv = textequivs[0]
        if element:
            element.set_TextEquiv([textequiv])
        n = len(textequiv.Unicode)
        conf = sum(confidences[i:i + n]) / max(n, 1)
        conf2 = textequiv.conf if textequiv.conf is not None else 1.0
        textequiv.set_conf(conf * lm_weight + conf2 * (1. - lm_weight))
        i += n
    if i != len(confidences):
        logger.critical('Input text length and output scores length are '
                        'off by %d characters', i - len(confidences))
    avg = sum(confidences) / len(confidences)
    ent = sum(-log(max(p, 1e-99), 2)
              for p in confidences) / len(confidences)
    ppl = pow(2.0, ent)
    ppll = pow(2.0, ent * len(confidences) / max(len(text), 1))
    logger.info('avg: %.3f, char ppl: %.3f, %s ppl: %.3f',
                avg, ppl, level, ppll)


def score_page_pcgts(rater, pcgts, level, context, lm_weight,
                     logger=None) -> None:
    """Plain scoring of one page (no alternatives): the whole page text
    in one ``rater.rate`` call, confidences blended by ``lm_weight``."""
    logger = logger or LOG
    edges = _require_edge_list(
        page_get_linear_lattice_at(level, pcgts, logger=logger),
        'plain page scoring')
    text = [(edge['element'], edge['alternatives']) for edge in edges]
    textstring = ''.join(tes[0].Unicode for _, tes in text)
    logger.info('Rating %d elements with a total of %d characters',
                len(text), len(textstring))
    confidences = rater.rate(textstring, context)
    apply_confidences(text, confidences, level, lm_weight, logger)


def _require_edge_list(edges, where: str) -> list:
    """Reject a customized lattice builder's DiGraph on the chain-only
    scoring paths with an actionable message."""
    if hasattr(edges, 'add_edge'):
        raise ValueError(
            'a customized lattice builder returned a DAG, but %s scores '
            'the single best chain; DAG lattices need '
            'alternative_decoding=true (the host decode engine decodes '
            'them)' % where)
    return edges


# ---------------------------------------------------------------------
# lattice construction
# ---------------------------------------------------------------------

def page_get_linear_graph_at(level: str, pcgts: PcGts, logger=None):
    """The page's lattice as a networkx DiGraph for the host engine:
    ``(graph, start node, end node)``, one edge per element (carrying
    ``element`` and ``alternatives``) along the chain of
    :func:`page_get_linear_lattice_at`.  A customised builder that
    returns a DiGraph passes through when it has one source, one sink
    and no cycle (``rate_best`` takes any such DAG); an empty graph
    becomes the empty chain."""
    import networkx as nx
    edges = page_get_linear_lattice_at(level, pcgts, logger=logger)
    if hasattr(edges, 'add_edge'):
        graph = edges
        if graph.number_of_edges() == 0:
            # a blank page is not an error
            graph = nx.DiGraph(level=level)
            graph.add_node(0)
            return graph, 0, 0
        starts = [n for n in graph if graph.in_degree(n) == 0]
        ends = [n for n in graph if graph.out_degree(n) == 0]
        if len(starts) != 1 or len(ends) != 1:
            raise ValueError(
                'lattice DAG needs exactly one source and one sink '
                '(got %d/%d)' % (len(starts), len(ends)))
        if not nx.is_directed_acyclic_graph(graph):
            raise ValueError(
                'lattice graph contains a cycle: the decoder requires a '
                'directed acyclic lattice (one edge per text alternative '
                'in reading order)')
        return graph, starts[0], ends[0]
    graph = nx.DiGraph(level=level)
    graph.add_node(0)
    for i, edge in enumerate(edges):
        graph.add_edge(i, i + 1, **edge)
    return graph, 0, len(edges)



def page_get_linear_lattice_at(level: str, pcgts, logger=None) -> list:
    """Linear lattice of a page as a list of edge dicts
    (``{'element', 'alternatives'}``) in chain order — edge ``i`` spans
    nodes ``(i, i+1)`` of the equivalent DiGraph.  Same traversal,
    space/newline, tokenisation-repair, and choice-filter semantics as
    the reference lattice construction (wrapper/rate.py:343-424); works on any
    tree exposing the generateDS-style PAGE API (the standalone object
    model, ``page_fast`` records, or genuine ``ocrd_models``)."""
    if logger is None:
        logger = LOG
    problems = _page_get_tokenisation_problems(level, pcgts,
                                               logger=logger)
    edges: list = []

    def add_element(element, textequivs):
        edges.append({'element': element,
                      'alternatives': _filter_choices(textequivs)})

    def add_space(space, last_start, problem, textequivs):
        """Whitespace pseudo-edge, skipped where a tokenisation problem
        shows the parent text already concatenates."""
        if (textequivs and textequivs[0].Unicode and problem and
                _repair_tokenisation(
                    problem.actual,
                    ''.join(edge['alternatives'][0].Unicode
                            for edge in edges[last_start:]),
                    textequivs[0].Unicode, logger=logger)):
            return  # skip space (concatenation join)
        add_element(None, [TextEquivType(Unicode=space, conf=1.0)])

    regions = pcgts.get_Page().get_TextRegion()
    if not regions:
        logger.warning('Page contains no text regions')
    first_region = True
    for region in regions:
        if level == 'region':
            textequivs = region.get_TextEquiv()
            if not first_region:
                # no page-level tokenisation check exists (the Page
                # element has no own TextEquiv to compare against), so
                # newline edges between regions are never repaired
                add_space('\n', 0, None, textequivs)
            if textequivs:
                add_element(region, textequivs)
            else:
                logger.warning("Region '%s' contains no text results",
                               region.id)
            first_region = False
            continue
        lines = region.get_TextLine()
        if not lines:
            logger.warning("Region '%s' contains no text lines",
                           region.id)
        region_start = len(edges)
        first_line = True
        for line in lines:
            if level == 'line':
                textequivs = line.get_TextEquiv()
                if not first_line or not first_region:
                    add_space('\n', region_start,
                              not first_line and problems.get(region.id),
                              textequivs)
                if textequivs:
                    add_element(line, textequivs)
                else:
                    logger.warning("Line '%s' contains no text results",
                                   line.id)
                first_line = False
                continue
            words = line.get_Word()
            if not words:
                logger.warning("Line '%s' contains no words", line.id)
            line_start = len(edges)
            first_word = True
            for word in words:
                textequivs = word.get_TextEquiv()
                if not first_word or not first_line or not first_region:
                    add_space('\n' if first_word else ' ', line_start,
                              not first_word and problems.get(line.id),
                              textequivs)
                if level == 'word':
                    if textequivs:
                        add_element(word, textequivs)
                    else:
                        logger.warning(
                            "Word '%s' contains no text results",
                            word.id)
                    first_word = False
                    continue
                glyphs = word.get_Glyph()
                if not glyphs:
                    logger.warning("Word '%s' contains no glyphs",
                                   word.id)
                for glyph in glyphs:
                    textequivs = glyph.get_TextEquiv()
                    if textequivs:
                        add_element(glyph, textequivs)
                    else:
                        logger.warning(
                            "Glyph '%s' contains no text results",
                            glyph.id)
                first_word = False
            first_line = False
        first_region = False
    return edges


def _repair_tokenisation(tokenisation, concatenation, next_token,
                         logger=None):
    """Decide whether the artificial joining space must be SKIPPED at
    this junction: the parent's own text annotation is authoritative —
    if the text emitted so far (``concatenation``) lines up with a
    prefix of it and the annotation continues IMMEDIATELY (no white
    space) with ``next_token``, the two elements are glued in the
    original and inserting a space would corrupt the tokenisation.
    (Junction rule of the reference, wrapper/rate.py:641-653.)"""
    if logger is None:
        logger = LOG
    # longest suffix of the emitted text that the annotation starts
    # with (the two strings overlap there); 0 = no alignment found
    limit = min(len(tokenisation), len(concatenation))
    overlap = next((n for n in range(limit, 0, -1)
                    if tokenisation.startswith(concatenation[-n:])), 0)
    if overlap and tokenisation[overlap:].startswith(next_token):
        logger.warning('Repairing tokenisation between "%s" and "%s"',
                       concatenation[-overlap:], next_token)
        return True
    return False


def _filter_choices(textequivs):
    """Cap alternatives at CHOICE_THRESHOLD_NUM and within
    CHOICE_THRESHOLD_CONF of the best; default conf 1.0.

    Direct attribute assignment, not ``set_conf``: this normalization
    is search-internal (the winner's conf is overwritten with the
    decoded score at write-back) and must not trigger the fast path's
    XML write-through on every parsed alternative."""
    if not textequivs:
        return []
    if len(textequivs) == 1:
        te = textequivs[0]
        if te.conf is None:
            te.conf = 1.0
        return textequivs
    textequivs = textequivs[:CHOICE_THRESHOLD_NUM]
    for te in textequivs:
        # None/missing -> 1.0; an EXPLICIT conf=0.0 is preserved
        # (deviation from the reference, which falsy-coerces 0.0 to
        # fully-confident 1.0 — inverting the least confident
        # alternative into the most confident one)
        if te.conf is None:
            te.conf = 1.0
    conf0 = textequivs[0].conf
    return [te for te in textequivs
            if conf0 - te.conf < CHOICE_THRESHOLD_CONF]


# ---------------------------------------------------------------------
# tokenisation consistency (validator-equivalent)
# ---------------------------------------------------------------------

@dataclass
class ConsistencyError:
    tag: str
    ID: str
    actual: str
    expected: str


def _page_get_tokenisation_problems(level, pcgts, logger=None
                                    ) -> Dict[str, ConsistencyError]:
    """Detect elements whose own text annotation deviates from the
    concatenation of their children only w.r.t. white space (then the
    artificial joining space must be skipped).  Standalone equivalent
    of the reference's PageValidator-based check
    (wrapper/rate.py:592-610)."""
    if logger is None:
        logger = LOG
    problems: Dict[str, ConsistencyError] = {}

    def check(tag, elem_id, own, joined):
        if not own or own == joined:
            return
        if len(own.split()) != len(joined.split()):
            if _HIERARCHY.get(tag) == level:
                problems[elem_id] = ConsistencyError(
                    tag=tag, ID=elem_id, actual=own, expected=joined)
                logger.warning(
                    'Tokenisation inconsistency in %s "%s": "%s" vs '
                    'joined "%s"', tag, elem_id, own, joined)

    page = pcgts.get_Page()
    for region in page.get_AllRegions(classes=['Text']):
        own = region.text_equivs[0].Unicode if region.text_equivs else ''
        joined = '\n'.join(
            (line.text_equivs[0].Unicode if line.text_equivs else '')
            for line in region.get_TextLine())
        check('TextRegion', region.id, own, joined)
        for line in region.get_TextLine():
            own = line.text_equivs[0].Unicode if line.text_equivs else ''
            joined = ' '.join(
                (w.text_equivs[0].Unicode if w.text_equivs else '')
                for w in line.get_Word())
            check('TextLine', line.id, own, joined)
            for word in line.get_Word():
                own = (word.text_equivs[0].Unicode
                       if word.text_equivs else '')
                joined = ''.join(
                    (g.text_equivs[0].Unicode if g.text_equivs else '')
                    for g in word.get_Glyph())
                check('Word', word.id, own, joined)
    return problems


# ---------------------------------------------------------------------
# result write-back / text projection
# ---------------------------------------------------------------------

def _page_update_from_path(level, path, entropy, logger=None):
    """Apply the decoded best path: keep the winning TextEquiv per
    element, conf = 2^(-cost/len); log ppl summary (the line format is
    API — tests parse it; reference wrapper/rate.py:426-440)."""
    if logger is None:
        logger = LOG
    strlen = 0
    for element, textequiv, score in path:
        if element:
            element.set_TextEquiv([textequiv])
            strlen += len(textequiv.Unicode)
            textequiv.set_conf(score)
        else:
            strlen += 1
    if not strlen:
        return
    ent = entropy / strlen
    avg = pow(2.0, -ent)
    ppl = pow(2.0, ent)
    ppll = pow(2.0, ent * strlen / max(len(path), 1))
    logger.info('avg: %.3f, char ppl: %.3f, %s ppl: %.3f',
                avg, ppl, level, ppll)


def page_element_unicode0(element):
    """Unicode string of the first text result."""
    if element.get_TextEquiv():
        return element.get_TextEquiv()[0].Unicode or ''
    return ''


def page_element_conf0(element):
    """Confidence of the first text result."""
    if element.get_TextEquiv():
        conf = element.get_TextEquiv()[0].conf
        return float(conf) if conf is not None else 1.0
    return 1.0


def page_get_reading_order(ro, rogroup):
    """Flatten a ReadingOrder group tree into ``ro``: one entry per
    member, keyed by the region it orders (``regionRef``; groups
    without one — e.g. the top-level group — key by their own id).
    Iterative worklist over nested groups; members of an Ordered group
    are the ``*Indexed`` variants, of an Unordered group the plain
    ones (reference wrapper/rate.py:457-476)."""
    worklist = [] if rogroup is None else [rogroup]
    while worklist:
        group = worklist.pop()
        ordered = isinstance(group,
                             (OrderedGroupType, OrderedGroupIndexedType))
        leaves, subgroups = ((group.get_RegionRefIndexed(),
                              group.get_OrderedGroupIndexed() +
                              group.get_UnorderedGroupIndexed())
                             if ordered else
                             (group.get_RegionRef(),
                              group.get_OrderedGroup() +
                              group.get_UnorderedGroup()))
        for member in leaves + subgroups:
            getref = getattr(member, 'get_regionRef', None)
            ro[(getref() if getref else '') or member.id] = member
        worklist.extend(subgroups)


def _rtl(*scopes) -> bool:
    """Resolve ``readingDirection`` by scope inheritance (innermost
    wins); True = right-to-left traversal."""
    for scope in scopes:
        direction = scope.get_readingDirection()
        if direction:
            return direction == RIGHT_TO_LEFT
    return False


def _aggregate(children, separator):
    """(joined text, mean conf) over already-projected children.

    ``separator`` is a string, or a callable ``(prev, next) -> str``
    for junction-dependent joining (the Relation type=join rules).
    Empty children aggregate to ``('', 0)`` — the value the write-back
    stores for childless elements."""
    if not children:
        return '', 0
    pieces = [page_element_unicode0(children[0])]
    for prev, nxt in zip(children, children[1:]):
        pieces.append(separator if isinstance(separator, str)
                      else separator(prev, nxt))
        pieces.append(page_element_unicode0(nxt))
    conf = sum(page_element_conf0(c) for c in children) / len(children)
    return ''.join(pieces), conf


def _store_joined(element, text_conf, overwrite):
    """Write the aggregated (text, conf) as the element's single
    TextEquiv; with ``overwrite=False`` existing text is kept."""
    if not element.get_TextEquiv() or overwrite:
        text, conf = text_conf
        element.set_TextEquiv([TextEquivType(Unicode=text, conf=conf)])


def page_update_higher_textequiv_levels(level, pcgts, overwrite=True):
    """Project text up the hierarchy: join first TextEquivs by the rules
    of each level (words by space, lines/regions by newline, glyphs by
    concatenation), traversing ReadingOrder OrderedGroups,
    ``textLineOrder=bottom-to-top`` and
    ``readingDirection=right-to-left`` in reverse, and joining directly
    (no whitespace) across ``Relation type=join`` pairs; average confs
    (reference wrapper/rate.py:478-590).

    Structure: each level is "order the children, aggregate their
    (text, conf), store" with a per-level separator rule — a constant
    for words/glyphs, a junction function consulting the join-relation
    pairs for lines/subregions."""
    if level == 'region':
        return
    page = pcgts.get_Page()
    relations = page.get_Relations()
    joins = {(rel.get_SourceRegionRef().get_regionRef(),
              rel.get_TargetRegionRef().get_regionRef())
             for rel in (relations.get_Relation() if relations else [])
             if rel.get_type() == 'join'}
    reading_order: Dict[str, Any] = {}
    ro = page.get_ReadingOrder()
    if ro:
        page_get_reading_order(reading_order,
                               ro.get_OrderedGroup() or
                               ro.get_UnorderedGroup())

    def newline_unless_joined(prev, nxt):
        # subregion junction: the regions themselves are related
        return '' if (prev.id, nxt.id) in joins else '\n'

    def newline_unless_word_joined(prev_line, next_line):
        # line junction: the join relation names the EDGE words
        last = prev_line.get_Word()
        first = next_line.get_Word()
        if last and first and (last[-1].id, first[0].id) in joins:
            return ''
        return '\n'

    def by_reading_order(subs):
        # sort whenever ALL subregions have indexed entries
        # (RegionRefIndexed or indexed groups) — resolves the
        # reference's open TODO at wrapper/rate.py:489, which only
        # sorted when the entries were OrderedGroup instances
        entries = [reading_order.get(sub.id) for sub in subs]
        if all(hasattr(e, 'index') for e in entries):
            return [sub for _, sub in sorted(
                zip(entries, subs), key=lambda es: es[0].index)]
        return subs

    # CHILDREN BEFORE PARENTS: a nested region's text must be joined
    # from its subregions' FRESHLY projected texts (the reference's
    # stated traversal contract, wrapper/rate.py:517-519 "already
    # visited in earlier iterations").  get_AllRegions returns
    # pre-order (parents first), so reverse it — in reversed pre-order
    # every region precedes its ancestors.
    for region in reversed(page.get_AllRegions(classes=['Text'])):
        subregions = region.get_TextRegion()
        if subregions:
            # nested region: its subregions were projected in their
            # own (earlier) iterations — only join
            _store_joined(region,
                          _aggregate(by_reading_order(subregions),
                                     newline_unless_joined),
                          overwrite)
            continue
        lines = region.get_TextLine()
        if ((region.get_textLineOrder() or
             page.get_textLineOrder()) == BOTTOM_TO_TOP):
            lines = lines[::-1]
        if level != 'line':
            for line in lines:
                words = line.get_Word()
                if _rtl(line, region, page):
                    words = words[::-1]
                if level != 'word':
                    for word in words:
                        glyphs = word.get_Glyph()
                        if _rtl(word, line, region, page):
                            glyphs = glyphs[::-1]
                        _store_joined(word, _aggregate(glyphs, ''),
                                      overwrite)
                _store_joined(line, _aggregate(words, ' '), overwrite)
        _store_joined(region,
                      _aggregate(lines, newline_unless_word_joined),
                      overwrite)
