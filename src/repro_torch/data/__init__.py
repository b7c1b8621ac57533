"""Synthetic spatial datasets (NumPy)."""
from . import spatial  # noqa: F401
