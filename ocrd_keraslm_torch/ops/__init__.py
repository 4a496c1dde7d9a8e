from .decode_kernel import (decode_lattice, decode_lattice_batch,
                            decode_lattice_batch_ref, decode_lattice_ref,
                            walk_records_batch, walk_records_batch_ref)
from .gen_kernel import gen_beam, gen_beam_ref, traceback, traceback_ref
from .lstm_cell import (LSTMScan, lstm_bwd, lstm_bwd_ref, lstm_scan,
                        lstm_scan_ref)
from .score_kernel import score_scan, score_scan_ref

__all__ = ['LSTMScan', 'decode_lattice', 'decode_lattice_batch',
           'decode_lattice_batch_ref', 'decode_lattice_ref', 'gen_beam',
           'gen_beam_ref', 'lstm_bwd', 'lstm_bwd_ref', 'lstm_scan',
           'lstm_scan_ref', 'score_scan', 'score_scan_ref', 'traceback',
           'traceback_ref', 'walk_records_batch', 'walk_records_batch_ref']
