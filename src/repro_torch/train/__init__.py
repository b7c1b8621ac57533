"""LM training on one card: the optimizer (``optimizer``), the train step
(``step``) and checkpoints in the reference's layout (``checkpoint``)."""
from . import checkpoint, optimizer, step  # noqa: F401
