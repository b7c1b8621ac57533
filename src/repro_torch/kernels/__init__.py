"""Hand-written CUDA kernels for the DDC hot spots and the LM stack,
with plain versions.

- pairwise_dist: DBSCAN ε-neighbour counting + min-label sweeps, K-Means'
  squared distances
- contour_dist: phase-2 slot×slot contour min-distance merge matrix
- flash_attention: the LM stack's forward attention (online softmax)
- ssd_scan: the Mamba-2 SSD chunked scan
- ref: the plain PyTorch version of each kernel (CPU path, and the
  comparison on the card)

Use ``repro_torch.kernels.ops``: it dispatches by tensor device.  The
CUDA sources under ``csrc/`` are built with nvcc at first use
(``_build``), never at import.
"""
from . import contour_dist, flash_attention, ops, pairwise_dist, ref, ssd_scan  # noqa: F401
