"""DDC — the paper's contribution, on one device.

- dbscan: DBSCAN on the fused kernels (dense and block-sparse paths), and
  the NumPy oracle
- partitioner: the Morton code that orders the block-sparse path
- geometry: grid contours (the 1–2 % reduction) + NumPy overlap oracles
- ddc: ClusterSet buffers, local phase, batched merge, the one-device
  sync pipeline, host oracle
"""
from . import dbscan, ddc, geometry, partitioner  # noqa: F401
