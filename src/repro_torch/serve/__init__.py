"""Serving: the LM stack's prefill/decode engine, and the DDC facade's
query tier and fault-injection plan."""
from . import engine, faults, query_tier  # noqa: F401
