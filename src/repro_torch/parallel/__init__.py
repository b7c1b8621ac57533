"""The parallelism context of the model stack on one card (``api``), the
wire size of the buffers DDC's phase-2 schedules exchange and the int8
gradient compression (``compress``)."""
from . import api, compress  # noqa: F401
