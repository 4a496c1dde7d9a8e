"""The reference's ``ocrd_keraslm.lib.rating`` module path."""
from ..beam import Node
from ..rater import Rater

__all__ = ['Rater', 'Node']
