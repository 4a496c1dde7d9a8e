from .decode_kernel import decode_lattice, decode_lattice_ref
from .lstm_cell import lstm_scan, lstm_scan_ref
from .score_kernel import score_scan, score_scan_ref

__all__ = ['decode_lattice', 'decode_lattice_ref', 'lstm_scan',
           'lstm_scan_ref', 'score_scan', 'score_scan_ref']
