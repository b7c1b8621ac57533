"""DDC — the paper's contribution, on one device.

- dbscan: dense DBSCAN on the fused kernels, and the NumPy oracle
- geometry: grid contours (the 1–2 % reduction) + NumPy overlap oracles
- ddc: ClusterSet buffers, local phase, batched merge, the one-device
  sync pipeline, host oracle
"""
from . import dbscan, ddc, geometry  # noqa: F401
