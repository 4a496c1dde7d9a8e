from .decode_kernel import decode_lattice, decode_lattice_ref
from .lstm_cell import (LSTMScan, lstm_bwd, lstm_bwd_ref, lstm_scan,
                        lstm_scan_ref)
from .score_kernel import score_scan, score_scan_ref

__all__ = ['LSTMScan', 'decode_lattice', 'decode_lattice_ref', 'lstm_bwd',
           'lstm_bwd_ref', 'lstm_scan', 'lstm_scan_ref', 'score_scan',
           'score_scan_ref']
