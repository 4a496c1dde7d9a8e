"""Context variables of corpus files.

The port's own copy of ``context_from_filename`` from
``ocrd_keraslm_tpu/data.py`` (the rest of that module feeds training,
which is not ported yet).
"""
from __future__ import annotations

import logging
from math import ceil
from typing import List

LOG = logging.getLogger(__name__)


def context_from_filename(name: str, limit: int = 200) -> List[int]:
    """Context variables from an ``author_title_year`` filename: the
    year bucketed as ceil(year/10).  Buckets beyond the context table
    (default 200 rows, i.e. years >= 2000) map to the underspecified 0
    with a warning; names without a year map to 0."""
    base = name.rsplit('/', 1)[-1].split('.')[0].split('_')
    if len(base) == 3 and base[2].isdigit():
        bucket = ceil(int(base[2]) / 10)
        if bucket >= limit:
            LOG.warning('year context %s out of range for the %d-row '
                        'context table: using underspecified 0',
                        base[2], limit)
            return [0]
        return [bucket]
    return [0]
