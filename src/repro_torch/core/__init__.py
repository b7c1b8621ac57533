"""DDC — the paper's contribution, on one device.

- dbscan: DBSCAN on the fused kernels (dense and block-sparse paths), and
  the NumPy oracle
- kmeans: K-Means (Lloyd, k-means++ seeding) on the pairwise-distance
  kernel, the paper's second local algorithm
- partitioner: the Morton code that orders the block-sparse path, and the
  shard splits (block, random, spatial, capacity-aware) and the paper's
  scenario sizes
- simulate: the discrete-event simulator of DDC on a heterogeneous cluster
- geometry: grid contours (the 1–2 % reduction), farthest-point
  subsampling + NumPy overlap oracles
- ddc: ClusterSet buffers, local phase, batched merge, the sync, async
  and tree schedules on one device, the one-device pipeline, host oracle
"""
from . import dbscan, ddc, geometry, kmeans, partitioner, simulate  # noqa: F401
