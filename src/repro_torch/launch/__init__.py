"""Entry points of the port: the lane layout of the device-resident serve
engine (``mesh``), the serving entry point (``serve``, run as
``python -m repro_torch.launch.serve``) and the training entry point
(``train``, run as ``python -m repro_torch.launch.train``), and the LM
dry run (``dryrun`` and ``dryrun_scaleout`` over ``cost`` and
``roofline``, run as ``python -m repro_torch.launch.dryrun``)."""
from . import mesh  # noqa: F401
