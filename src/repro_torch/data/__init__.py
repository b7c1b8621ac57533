"""Data substrate: synthetic spatial benchmarks, token pipeline, DDC-driven
curation."""
from . import spatial  # noqa: F401
