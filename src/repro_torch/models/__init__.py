"""The LM stack: configuration, layers, the transformer (serving and the
training loss) and parameter trees in the reference's layout."""
from . import config, layers, transformer, tree  # noqa: F401
