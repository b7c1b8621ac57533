"""What crosses between shards: the wire size of the buffers DDC's phase-2
schedules exchange (``compress.pytree_wire_bytes``)."""
from . import compress  # noqa: F401
