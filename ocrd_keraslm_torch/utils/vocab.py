"""Character vocabulary mapping.

Bidirectional char<->index mapping with index 0 reserved for
unknown/padding ("underspecification"), as read from the h5
``config/mapping`` codepoint array.  Counterpart of the lookup half of
``ocrd_keraslm_tpu/utils/vocab.py`` (numpy only), with
``read_normalized`` for scoring text files.
"""
from __future__ import annotations

import logging
import unicodedata
from typing import Dict, Sequence

import numpy as np

LOG = logging.getLogger(__name__)


def nfc(text: str) -> str:
    """NFC-normalize a string (all model I/O goes through this)."""
    return unicodedata.normalize('NFC', text)


def read_normalized(file) -> str:
    """Read a text file handle (or path) and NFC-normalize its content."""
    if isinstance(file, str):
        with open(file, 'r', encoding='utf-8') as fh:
            return nfc(fh.read())
    return nfc(file.read())


class Vocab:
    """Bidirectional char<->index mapping; index 0 = unknown/padding."""

    def __init__(self):
        self.c2i: Dict[str, int] = {}
        self.i2c: Dict[int, str] = {}
        self._encode_cache: Dict[str, np.ndarray] = {}
        self._table_cache = None

    @classmethod
    def from_codepoints(cls, codepoints: Sequence[int]) -> 'Vocab':
        """Build from a positional uint32 codepoint array (h5 schema).

        Position = index, value = codepoint, 0 = gap/reserved.
        """
        v = cls()
        v.c2i = {chr(c): i for i, c in enumerate(codepoints) if c > 0}
        v.i2c = {i: chr(c) for i, c in enumerate(codepoints) if c > 0}
        return v

    def to_codepoints(self) -> np.ndarray:
        """Positional uint32 codepoint array (h5 `config/mapping` schema)."""
        return np.fromiter(
            (ord(self.i2c[i]) if i in self.i2c else 0
             for i in range(self.size)),
            dtype=np.uint32)

    @property
    def size(self) -> int:
        """Vocabulary size including the reserved 0 slot (= voc_size)."""
        if not self.i2c:
            return 0
        return max(self.i2c.keys()) + 1

    def get(self, char: str, on_unmapped=None) -> int:
        """Index of char; 0 if unmapped (optionally calling
        ``on_unmapped``)."""
        idx = self.c2i.get(char)
        if idx is None:
            if on_unmapped is not None:
                on_unmapped(char)
            return 0
        return idx

    def encode(self, text: str, log_unmapped: bool = False) -> np.ndarray:
        """Encode a string into an int32 index array (0 for unmapped),
        vectorized via a codepoint lookup table."""
        if not text:
            return np.zeros(0, dtype=np.int32)
        cps = np.frombuffer(text.encode('utf-32-le'), dtype=np.uint32)
        table = self._table()
        out = np.where(cps < len(table), table[np.minimum(
            cps, len(table) - 1)], 0).astype(np.int32)
        if log_unmapped:
            for j in np.nonzero(out == 0)[0][:20]:
                LOG.error('unmapped character "%s" at input position %d',
                          text[j], int(j))
        return out

    def encode_cached(self, text: str) -> np.ndarray:
        """Memoized encode for short, repetitive strings (lattice
        alternatives: the glyph alphabet is tiny, so hit rates are
        ~100%)."""
        ids = self._encode_cache.get(text)
        if ids is None:
            ids = self.encode(text)
            ids.setflags(write=False)
            if len(self._encode_cache) < 65536:
                self._encode_cache[text] = ids
        return ids

    def _table(self) -> np.ndarray:
        """Codepoint -> index lookup table (built once)."""
        if self._table_cache is None:
            max_cp = max((ord(c) for c in self.c2i), default=0)
            table = np.zeros(max_cp + 1, dtype=np.int32)
            for c, i in self.c2i.items():
                table[ord(c)] = i
            self._table_cache = table
        return self._table_cache
