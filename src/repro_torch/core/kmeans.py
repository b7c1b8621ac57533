"""K-Means (Lloyd) — the paper's second local-clustering algorithm, on
the ``pairwise_dist_sq`` kernel.

Counterpart of ``repro/core/kmeans.py``: masked, fixed-size, k-means++
seeding, a fixed number of Lloyd steps.  The reference seeds from a
``jax.random`` key, whose stream PyTorch cannot reproduce; here the
seeding draws from an explicit ``torch.Generator`` on the points' device,
or the caller hands in the initial centres (``init``), as the tests do
with the reference's own.

Every step is deterministic on the card, so a run with the kernel equals
a run on the plain version bit for bit: the assignment is the kernel's
float32 distances and a first-index argmin; the centroid sums are
float64 sums of float32 points, in a fixed order, rounded once to
float32 (no float atomics, no TF32).  The reference's float32
``onehot.T @ points`` rounds in an order of its own, so centroids agree
with it to about one ulp, not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops

_MIN_WEIGHT = 1e-30  # the reference's floor under log-weights


class KMeansResult(NamedTuple):
    labels: torch.Tensor     # (n,) int32, -1 where masked
    centroids: torch.Tensor  # (k, 2) float32
    inertia: torch.Tensor    # () float32


def _pick(weights: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One index drawn with probability ∝ max(weight, 1e-30), as the
    reference's ``categorical(log(max(w, 1e-30)))``: inverse CDF over a
    float64 running sum.  Returns a () int64 tensor (no host sync)."""
    w = weights.to(torch.float32).clamp_min(_MIN_WEIGHT).to(torch.float64)
    cdf = torch.cumsum(w, 0)
    u = torch.rand((), dtype=torch.float64, device=w.device, generator=generator) * cdf[-1]
    return torch.searchsorted(cdf, u, right=True).clamp_max(w.shape[0] - 1)


def _d2_to(points: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    d = points - p
    return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]


def kmeanspp_init(points: torch.Tensor, mask: torch.Tensor, k: int,
                  generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding on a masked buffer: the first centre uniform over
    the masked points, each next one ∝ its squared distance to the
    nearest centre so far (masked-out points weigh nothing).  ``generator``
    lies on the points' device.  Returns (k, 2) float32."""
    points = points.to(torch.float32)
    first = _pick(mask.to(torch.float32), generator)
    cents = points[first].expand(k, 2).clone()
    d2 = torch.where(mask, _d2_to(points, points[first]), 0.0)
    for i in range(1, k):
        nxt = _pick(d2, generator)
        cents[i] = points[nxt]
        d2 = torch.minimum(d2, torch.where(mask, _d2_to(points, points[nxt]), 0.0))
    return cents


def kmeans(points: torch.Tensor, mask: torch.Tensor, k: int, iters: int = 25, *,
           init: torch.Tensor | None = None,
           generator: torch.Generator | None = None) -> KMeansResult:
    """``iters`` Lloyd steps from ``init`` (k, 2), or from k-means++ seeds
    drawn with ``generator`` (a generator seeded 0 on the points' device
    when neither is given).  Masked-out points take no part: their
    distances are 0 before the argmin, they add nothing to the sums, and
    their final label is -1.  An empty cluster keeps its centre.  One
    ``pairwise_dist_sq`` launch per step and one for the final
    assignment."""
    points = points.to(torch.float32).contiguous()
    dev = points.device
    if init is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        cents = kmeanspp_init(points, mask, k, generator)
    else:
        cents = torch.as_tensor(init, device=dev).to(torch.float32)
        if cents.shape != (k, 2):
            raise ValueError(f"init must be ({k}, 2), got {tuple(cents.shape)}")
    cents = cents.contiguous()
    onto = torch.arange(k, device=dev)
    pts64 = points.to(torch.float64)
    for _ in range(iters):
        d2 = torch.where(mask[:, None], ops.pairwise_dist_sq(points, cents), 0.0)
        onehot = (d2.argmin(dim=1)[:, None] == onto[None, :]) & mask[:, None]   # (n, k)
        # Each product is exact in float64 (a 0/1 weight times a float32),
        # and the sum over points runs in a fixed order.
        sums = (onehot.to(torch.float64)[:, :, None] * pts64[:, None, :]).sum(dim=0)
        cnts = onehot.sum(dim=0, dtype=torch.int64).to(torch.float32)[:, None]
        cents = torch.where(cnts > 0, sums.to(torch.float32) / cnts.clamp_min(1.0), cents)
    d2 = ops.pairwise_dist_sq(points, cents)
    labels = torch.where(mask, d2.argmin(dim=1), -1).to(torch.int32)
    inertia = torch.where(mask, d2.amin(dim=1), 0.0).sum(dtype=torch.float64)
    return KMeansResult(labels, cents, inertia.to(torch.float32))
