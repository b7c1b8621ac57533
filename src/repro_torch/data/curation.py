"""DDC-driven data curation — the paper's clustering inside the LM data
pipeline; the port's counterpart of the reference package's
``data/curation.py``.

Documents are embedded (here: provided 2-D embeddings) and clustered
with DDC: each shard clusters its local embeddings (phase 1, zero
communication), the contour representatives merge (phase 2), and the
global clusters drive cluster-balanced sampling weights (upweight rare
clusters).  Without a mesh the host path runs (``ddc_host``, 8 shards,
NumPy); with ``mesh``, a tuple of lanes from
``launch/mesh.py::make_lane_mesh`` (the port's mesh axis), the lanes run
``make_ddc_fn`` on the lanes' device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import ddc
from repro_torch.data.pipeline import DataConfig


# curate's configuration when none is given (the reference's).
DEFAULT_CONFIG = ddc.DDCConfig(eps=0.04, min_pts=4, grid=128, max_clusters=64, max_verts=64)


@dataclasses.dataclass
class CurationResult:
    labels: np.ndarray          # (n_docs,) global cluster id (-1 noise)
    n_clusters: int
    cluster_sizes: np.ndarray
    sample_weights: np.ndarray  # per-cluster balanced sampling weights
    exchanged_fraction: float   # bytes exchanged / raw embedding bytes


def curate(
    embeddings: np.ndarray,
    mesh=None,
    cfg: ddc.DDCConfig | None = None,
    temperature: float = 0.5,
) -> CurationResult:
    """Cluster document embeddings with DDC and derive sampling weights.

    With ``mesh`` (lanes of ``make_lane_mesh``): ``make_ddc_fn`` over
    ``len(mesh)`` lanes on their device, the embeddings zero-padded to a
    multiple of the lane count and masked; the wire fraction is the
    reference's formula (log2 K buffers for async, K − 1 otherwise).
    Without: the host path.  Weights ∝ (1 / cluster_size)^temperature,
    normalised — temperature=0 keeps natural frequency, 1 is fully
    balanced.
    """
    n = len(embeddings)
    cfg = cfg or DEFAULT_CONFIG
    if mesh is not None:
        k = len(mesh)
        pad = (-n) % k
        pts = np.pad(embeddings, ((0, pad), (0, 0)))
        mask = np.arange(len(pts)) < n
        run = ddc.make_ddc_fn(cfg, k, device=mesh[0].device)
        glabels, _, _ = run(pts, mask)
        labels = glabels.cpu().numpy()[:n]
        wire = cfg.buffer_bytes() * (k.bit_length() - 1 if cfg.schedule == "async" else k - 1)
        exchanged = wire / (n * embeddings.itemsize * embeddings.shape[1])
    else:
        labels, _, exch_pts = ddc.ddc_host(
            embeddings, 8, eps=cfg.eps, min_pts=cfg.min_pts
        )
        exchanged = exch_pts / max(n, 1)

    ids = sorted(set(labels[labels >= 0]))
    remap = {c: i for i, c in enumerate(ids)}
    labels = np.array([remap.get(l, -1) for l in labels])
    sizes = np.bincount(labels[labels >= 0], minlength=len(ids)).astype(np.float64)
    w = (1.0 / np.maximum(sizes, 1)) ** temperature
    w = w / w.sum() if len(w) else np.ones(1)
    return CurationResult(
        labels=labels,
        n_clusters=len(ids),
        cluster_sizes=sizes,
        sample_weights=w,
        exchanged_fraction=float(exchanged),
    )


def apply_to_data_config(dcfg: DataConfig, result: CurationResult,
                         doc_clusters: np.ndarray) -> DataConfig:
    """Map DDC clusters onto the synthetic pipeline's latent clusters and
    install balanced weights."""
    k = dcfg.n_latent_clusters
    weights = np.ones(k)
    for latent in range(k):
        members = result.labels[doc_clusters == latent]
        members = members[members >= 0]
        if len(members):
            ddc_cluster = np.bincount(members).argmax()
            weights[latent] = result.sample_weights[ddc_cluster]
    weights /= weights.sum()
    return dataclasses.replace(dcfg, curation_weights=weights)
