"""The LM stack's serving path: configuration, layers and the transformer
(dense GQA/MQA and Mamba-2 so far)."""
from . import config, layers, transformer  # noqa: F401
