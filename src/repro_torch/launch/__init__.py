"""Entry points of the port: the lane layout of the device-resident serve
engine (``mesh``) and the serving entry point (``serve``, run as
``python -m repro_torch.launch.serve``)."""
from . import mesh  # noqa: F401
