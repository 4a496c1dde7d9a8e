"""Shape bucketing: dynamic sizes round up to a small set of buckets
(the decode kernel's beam K, alternative length L and edge-block E;
scoring's chunk count and batch), so the packed formats and the
kernels' shared-memory plans take few shapes.
"""
from __future__ import annotations

from typing import Sequence


def bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; CAPS at the largest bucket (callers must
    guarantee n fits or handle the truncation)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def bucket_unbounded(n: int, buckets: Sequence[int]) -> int:
    """Like :func:`bucket` but never truncates: above the largest
    bucket, round up to the next power of two."""
    for b in buckets:
        if n <= b:
            return b
    return 1 << max(n - 1, 1).bit_length()
