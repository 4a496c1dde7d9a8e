"""Character vocabulary mapping.

Bidirectional char<->index mapping with index 0 reserved for
unknown/padding ("underspecification"), as read from the h5
``config/mapping`` codepoint array or assigned and grown by training.
Counterpart of ``ocrd_keraslm_tpu/utils/vocab.py`` (numpy only), with
``read_normalized`` for reading text files.
"""
from __future__ import annotations

import logging
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

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

    def assign(self, chars: Iterable[str]) -> None:
        """Assign a fresh sorted mapping (1-based; 0 stays reserved)."""
        chars = sorted(set(chars))
        self.c2i = {c: i for i, c in enumerate(chars, 1)}
        self.i2c = {i: c for i, c in enumerate(chars, 1)}
        self._mapping_changed()

    def grow(self, chars: Iterable[str]) -> List[str]:
        """Add new characters at the end of the mapping; returns the
        added ones."""
        added = sorted(set(c for c in chars if c not in self.c2i))
        base = self.size if self.i2c else 1
        for k, c in enumerate(added):
            self.c2i[c] = base + k
            self.i2c[base + k] = c
        self._mapping_changed()
        return added

    def _mapping_changed(self) -> None:
        """Drop the caches that were built from the old mapping."""
        self._encode_cache = {}
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

    def __len__(self) -> int:
        return self.size

    def __contains__(self, char: str) -> bool:
        return char in self.c2i

    def get(self, char: str, on_unmapped=None) -> int:
        """Index of char; 0 if unmapped (optionally calling
        ``on_unmapped``)."""
        idx = self.c2i.get(char)
        if idx is None:
            if on_unmapped is not None:
                on_unmapped(char)
            return 0
        return idx

    def char(self, idx: int) -> Optional[str]:
        return self.i2c.get(idx)

    def decode(self, indices: Iterable[int]) -> str:
        return ''.join(self.i2c.get(int(i), '\ufffd') for i in indices)

    def remove(self, char: Optional[str] = None,
               idx: Optional[int] = None) -> Optional[int]:
        """Remove one char, re-indexing all higher indices down by one.
        Returns the removed index (for the weight row to delete), or
        None where nothing was mapped."""
        if char is None and idx is None:
            return None
        if char is not None:
            if char not in self.c2i:
                LOG.error('unmapped character "%s" cannot be removed', char)
                return None
            idx = self.c2i[char]
        else:
            if idx not in self.i2c:
                LOG.error('unmapped index "%d" cannot be removed', idx)
                return None
            char = self.i2c[idx]
        size = self.size
        self.c2i.pop(char)
        self.i2c.pop(idx)
        for i in range(idx + 1, size):
            other = self.i2c.get(i)
            if other is None:
                continue
            self.c2i[other] = i - 1
            self.i2c[i - 1] = other
            self.i2c.pop(i)
        self._mapping_changed()
        return idx

    def print_charset(self) -> None:
        """Print the mapped characters, warning about entries that are
        not NFC-normalised."""
        for i, c in sorted(self.i2c.items()):
            print('%d: "%s"' % (i, c))
            char = nfc(c)
            if c != char:
                LOG.warning(
                    'mapped character "%s" (%d) should have been normalized '
                    'to "%s", which is %s mapped',
                    c, i, char, 'also' if char in self.c2i else 'not')

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
