"""PyTorch + CUDA port of the DDC reproduction (the JAX package ``repro``
is the reference it is held against).

- core: DBSCAN (dense and block-sparse) and K-Means, grid contours, the batched
  phase-2 merge and its three schedules, the one-device DDC pipeline
  (``core.ddc.make_ddc_fn``) and the NumPy oracles
- kernels: hand-written CUDA kernels for Hopper with plain PyTorch versions
- ddc: the estimator facade (``DDC(DDCConfig(...)).fit(points)``) over the
  host and one-device backends, with save/load
- models, configs: the LM stack (every configuration kind), its training
  loss and parameter trees
- train: the optimizers, the train step and checkpoints (one card)
- serve: the LM serving path (prefill + decode), and the facade's snapshot
  query tier and fault plan
- data: NumPy copies of the synthetic spatial generators and the token
  pipeline
- parallel: the parallelism context on one card, the wire size of the
  buffers the schedules exchange and int8 gradient compression

Public entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU or hands in CPU tensors.
"""
from . import configs, core, data, ddc, kernels, models, parallel, serve, train  # noqa: F401
