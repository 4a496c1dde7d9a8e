"""Optional adapter onto a genuine OCR-D installation.

Counterpart of ``ocrd_keraslm_tpu/wrapper/ocrd_adapter.py``.  The port
ships a standalone OCR-D stack (ElementTree PAGE model, METS workspace,
processor surface) because no ``ocrd`` distribution is assumed.  When a
real OCR-D core is installed, ``ocrd-keraslm-rate`` takes part in
genuine workflows through this module:

* :func:`genuine_ocrd_available` detects a usable ``ocrd`` core
  (``KERASLM_STANDALONE=1`` forces the standalone stack);
* :func:`make_processor_class` builds (once) a ``KerasRate`` subclass
  of the genuine ``ocrd.Processor`` whose page processing delegates to
  this package's lattice, decode and write-back code: the standalone
  PAGE model mirrors the generateDS API (``get_Page``,
  ``get_TextRegion``, ``get_TextEquiv``, ...), so
  :func:`~.rate.page_get_linear_graph_at` and
  :func:`~.rate.page_update_higher_textequiv_levels` work on real
  ``ocrd_models`` objects unchanged;
* :func:`select_processor_class` returns the genuine adapter when
  available and the standalone processor otherwise.

The ``ocrd`` core is imported only inside these functions.
"""
from __future__ import annotations

import os
from typing import Optional, Type

_CACHED: Optional[type] = None


def genuine_ocrd_available() -> bool:
    """True if a real ``ocrd`` core (Processor + ocrd_models) imports.

    Guarded by ``KERASLM_STANDALONE=1`` for forcing the built-in stack
    even when OCR-D is installed (e.g. for A/B comparison).
    """
    if os.environ.get('KERASLM_STANDALONE') == '1':
        return False
    try:
        from ocrd import Processor  # noqa: F401
        from ocrd_models.ocrd_page import OcrdPage  # noqa: F401
        return True
    except Exception:  # ImportError or broken install
        return False


def make_processor_class() -> type:
    """Build the ``KerasRate(ocrd.Processor)`` adapter class (cached).

    Raises ImportError when no genuine OCR-D core is present.
    """
    global _CACHED
    if _CACHED is not None:
        return _CACHED

    from ocrd import OcrdPageResult, Processor

    from .. import lib
    from . import rate as _rate

    class KerasRateOcrd(Processor):
        """``ocrd-keraslm-rate`` on the genuine OCR-D core.

        The model/lattice machinery is this package's; the workspace
        loop, METS I/O, error policy, and PAGE (de)serialization are
        the real OCR-D core's.  ``alternative_decoding`` uses the
        device decoder page by page (each page's beam
        carries into the next via the device traceback), so the
        processor stays usable under the core's standard
        (page-sequential) dispatch; plain scoring uses the core's
        default page-parallel contract.
        """

        max_workers = 1  # decoding carries LM state across pages

        @property
        def executable(self):
            return _rate.OCRD_TOOL['executable']

        @property
        def metadata_filename(self) -> str:
            return os.path.join('wrapper', 'ocrd-tool.json')

        def setup(self):
            model = self.resolve_resource(self.parameter['model_file'])
            self.rater = lib.Rater(logger=self.logger)
            self.rater.load_config(model)
            if self.parameter['alternative_decoding']:
                self.rater.stateful = False
                self.rater.incremental = True
            elif self.rater.stateful:
                self.rater.batch_size = 1
            self.rater.configure()
            self.rater.load_weights(model)
            self._device_tb = None  # cross-page beam carry (device)
            self._host_tb = None    # cross-page traceback (host)
            self._context = None
            if self.parameter.get('lookahead_writeback'):
                # the genuine core writes each page as soon as
                # process_page_pcgts returns, so deferring page N
                # until page N+1 confirms the crossing point is not
                # expressible here — only the standalone processor
                # implements it (wrapper/rate.py)
                self.logger.warning(
                    'lookahead_writeback is not supported under the '
                    'genuine OCR-D core (pages are written as '
                    'returned); decoding finalizes each page '
                    'immediately')
            self.logger.debug("Loaded model_file '%s'", model)

        def process_page_pcgts(self, *input_pcgts, page_id=None):
            pcgts = input_pcgts[0]
            level = self.parameter['textequiv_level']
            if self._context is None:
                self._context = _rate.mets_get_context(
                    self.workspace.mets)
            if not self.parameter['alternative_decoding']:
                _rate.score_page_pcgts(
                    self.rater, pcgts, level, self._context,
                    float(self.parameter['lm_weight']),
                    logger=self.logger)
                return OcrdPageResult(pcgts)
            graph, start, end = _rate.page_get_linear_graph_at(
                level, pcgts, logger=self.logger)
            if self.parameter.get('device_decoding', True):
                path, entropy, self._device_tb = \
                    self.rater.rate_best_device(
                        graph, start, end,
                        device_traceback=self._device_tb,
                        context=self._context,
                        lm_weight=float(self.parameter['lm_weight']),
                        beam_width=int(self.parameter['beam_width']))
            else:
                # host engine with cross-page traceback carry; the
                # page locks into its own best path immediately (the
                # core writes it on return — see the setup() note on
                # lookahead_writeback).  The previous page was fully
                # flushed, so the locked segment (p1) plus the flush
                # (p2) together cover exactly this page's edges.
                p1, e1, tb = self.rater.rate_best(
                    graph, start, end,
                    start_traceback=self._host_tb,
                    context=self._context,
                    lm_weight=float(self.parameter['lm_weight']),
                    beam_width=int(self.parameter['beam_width']))
                p2, e2, self._host_tb = self.rater.next_path(
                    tb[0], ([], tb[1]))
                path, entropy = p1 + p2, e1 + e2
            _rate._page_update_from_path(level, path, entropy,
                                         logger=self.logger)
            _rate.page_update_higher_textequiv_levels(level, pcgts)
            return OcrdPageResult(pcgts)

    _CACHED = KerasRateOcrd
    return _CACHED


def select_processor_class() -> Type:
    """The processor class to serve: genuine-OCR-D adapter when the
    real core imports, the standalone implementation otherwise."""
    if genuine_ocrd_available():
        return make_processor_class()
    from .rate import KerasRate
    return KerasRate
