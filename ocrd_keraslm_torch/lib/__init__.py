"""Backend library interface (the reference's module path).

Rater - encapsulates LM definition and application
Node - tree data type for beam search
"""
from ..beam import Node
from ..rater import Rater
from . import rating

__all__ = ['Rater', 'Node', 'rating']
