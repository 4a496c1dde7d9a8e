"""The reference-compatible beam-search node type.

Counterpart of ``ocrd_keraslm_tpu/beam.py``.  The reference
(ocrd_keraslm's ``lib/rating.py``) exports a ``Node`` backpointer type as
part of its public API, so downstream code that builds or walks beam
trees keeps working against this package.  The port's engines do not
use it: the device engines keep the beam in fixed-shape tensors, the
host engine (``host_beam.py``) per-edge ``PathStep``/``Hypothesis``
records.

Contract: ``cum_cost`` accumulates the parent's cost and the node's own;
nodes order by prospective cost, ``cum_cost`` plus half a bit per char
of the current alternative not consumed yet (``extras[1]``);
``to_sequence(stop_at)`` lists the lineage root-first up to the nearest
ancestor found in ``stop_at`` (the whole lineage when ``stop_at`` is
empty, [] when the node derives from no ``stop_at`` node);
``cut_at(node)`` makes the child of ``node`` on the lineage a root.
"""
from __future__ import annotations

from functools import total_ordering
from typing import Any, Iterator, List, Optional


@total_ordering
class Node:
    """One node in a tree of textual alternatives for beam search."""

    __slots__ = ('value', 'parent', 'state', 'cum_cost', 'length',
                 'extras', '_sequence')

    def __init__(self, state: Any, value: str, cost: float,
                 parent: Optional['Node'] = None, extras: Any = None):
        self.parent = parent
        self.value = value
        self.state = state
        self.extras = extras
        if parent is None:
            self.cum_cost = cost
            self.length = 1
        else:
            self.cum_cost = parent.cum_cost + cost
            self.length = parent.length + 1
        self._sequence: Optional[List['Node']] = None

    def _lineage(self) -> Iterator['Node']:
        """Self and all ancestors, leaf first."""
        node: Optional['Node'] = self
        while node is not None:
            yield node
            node = node.parent

    def to_sequence(self, stop_at=None) -> List['Node']:
        """With ``stop_at``: the lineage from the root down to (and
        including) the nearest ancestor that is a ``stop_at`` member,
        or [] if none is.  Without: the full root-to-self lineage."""
        if stop_at:
            lineage = list(self._lineage())
            for i, node in enumerate(lineage):
                if node in stop_at:
                    before = lineage[i:]  # crossing .. root
                    before.reverse()
                    return before
            return []  # derives from no stop_at node
        if self._sequence is None:
            collected = list(self._lineage())
            collected.reverse()
            self._sequence = collected
        return self._sequence

    def cut_at(self, node: 'Node') -> None:
        """Detach the subtree: the child of ``node`` on this lineage
        becomes a root."""
        for member in self._lineage():
            if member.parent is node:
                member.parent = None
                self._sequence = None
                return

    def pro_cost(self) -> float:
        """Prospective cost: cumulative cost plus a 0.5-bit lookahead
        per remaining char of the current alternative."""
        if not self.extras:
            return self.cum_cost
        outstanding = len(self.extras[1].Unicode) - len(self.value)
        return self.cum_cost + 0.5 * outstanding

    def __lt__(self, other: 'Node') -> bool:
        return self.pro_cost() < other.pro_cost()

    def __eq__(self, other) -> bool:
        return self is other

    def __hash__(self):
        return id(self)
