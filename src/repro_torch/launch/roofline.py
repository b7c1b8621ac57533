"""Three-term roofline of a dry-run count, for an NVIDIA H100 SXM: the
port's counterpart of the reference package's ``launch/roofline.py``
(TPU v5e).

  compute term    = FLOPs a rank / PEAK_FLOPS
  memory term     = bytes a rank / HBM_BW
  collective term = collective bytes a rank / LINK_BW

The figures are the card's specifications (NVIDIA H100 SXM5 80GB HBM3 at
its 700 W power limit), not measurements:

* ``PEAK_FLOPS`` 989e12 FLOP/s — dense bf16 on the tensor cores (the
  production cells run bf16);
* ``HBM_BW`` 3.35e12 B/s — HBM3;
* ``LINK_BW`` 50e9 B/s a GPU — NDR InfiniBand at 400 Gb/s: a 16-rank mesh
  axis spans two 8-GPU nodes, so its collectives cross the network (NVLink
  within a node is faster; the slowest link bounds a ring);
* ``HBM_CAPACITY`` 80e9 bytes — the card's "80 GB".

All counts are a rank's (``launch/cost.py``), so no term divides by the
number of ranks.
"""
from __future__ import annotations

import dataclasses

CARD = "NVIDIA H100 SXM5 80GB HBM3, 700 W (specifications)"
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9
HBM_CAPACITY = 80e9


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    chips: int
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def finalize(self):
        self.t_compute = self.flops / PEAK_FLOPS
        self.t_memory = self.bytes_accessed / HBM_BW
        self.t_collective = self.coll_bytes / LINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        if self.flops > 0 and self.model_flops > 0:
            self.useful_ratio = self.model_flops / (self.flops * self.chips)
        return self

    @property
    def roofline_frac(self) -> float:
        """The share of the step's bound that is useful compute: the
        useful ratio times the compute term's share of the largest term."""
        top = max(self.t_compute, self.t_memory, self.t_collective, 1e-30)
        return max(self.useful_ratio, 0.0) * self.t_compute / top


def memory_summary(count: dict, params: int, grads: int, opt: int, inputs: int) -> dict:
    """A rank's memory from its count: ``params``, ``grads`` (the
    gradients' buffers), ``opt`` (the optimizer state) and ``inputs`` (the
    batch, or the cache and the token) in bytes from the shards' shapes,
    and the count's peak of live storages over the step
    (``total_hbm_bytes``); ``activations`` is the rest of that peak:
    activations and temporaries."""
    total = count["peak_bytes"]
    return {"params_bytes": params, "grads_bytes": grads, "opt_state_bytes": opt,
            "inputs_bytes": inputs, "resident_bytes": count["resident_bytes"],
            "activations_bytes": total - params - grads - opt - inputs,
            "total_hbm_bytes": total}


def fits_h100_80gb(total_hbm_bytes: float) -> bool:
    return total_hbm_bytes <= HBM_CAPACITY
