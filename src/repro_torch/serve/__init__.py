"""Serving: the LM stack's prefill/decode engine."""
from . import engine  # noqa: F401
