"""PyTorch + CUDA port of the DDC reproduction (the JAX package ``repro``
is the reference it is held against).

- core: DBSCAN (dense and block-sparse) and K-Means, grid contours, the batched
  phase-2 merge and its three schedules, the one-device DDC pipeline
  (``core.ddc.make_ddc_fn``) and the NumPy oracles
- kernels: hand-written CUDA kernels for Hopper with plain PyTorch versions
- ddc: the estimator facade (``DDC(DDCConfig(...)).fit(points)``) over the
  host and one-device backends, with save/load
- models, configs: the LM stack (dense, Mamba-2 and MoE configurations)
- serve: the LM serving path (prefill + decode), and the facade's snapshot
  query tier and fault plan
- data: NumPy copies of the synthetic spatial generators
- parallel: the wire size of the buffers the schedules exchange

Public entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU or hands in CPU tensors.
"""
from . import configs, core, data, ddc, kernels, models, parallel, serve  # noqa: F401
