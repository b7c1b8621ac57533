"""Token data pipeline: deterministic, restart-safe, shardable.

The port's copy of the reference package's ``data/pipeline.py`` (NumPy
only): the same ``DataConfig``, batches and embeddings, bit for bit.

Synthetic corpus (offline container) with structure: a mixture of
"documents" drawn from latent clusters so that DDC-based curation has
real signal to find.  The pipeline is stateless-by-construction — batch
``i`` is a pure function of (seed, i) — so checkpoint/restart needs no
iterator state (fault tolerance) and any host can produce exactly its
own shard (multi-host determinism).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_latent_clusters: int = 16
    frontend: str = "none"
    frontend_seq: int = 0
    prefix_len: int = 0
    d_model: int = 0
    curation_weights: np.ndarray | None = None  # per-cluster sample weights


def _doc_tokens(rng: np.random.Generator, cluster: int, cfg: DataConfig) -> np.ndarray:
    """A 'document': cluster-specific unigram distribution (Zipf-ish)."""
    base = np.arange(cfg.vocab, dtype=np.float64) + 1.0
    probs = 1.0 / base ** 1.1
    crng = np.random.default_rng(1000 + cluster)
    boost_ids = crng.choice(cfg.vocab, 64, replace=False)
    probs[boost_ids] *= 50.0
    probs /= probs.sum()
    return rng.choice(cfg.vocab, cfg.seq_len, p=probs).astype(np.int32)


def batch_at(cfg: DataConfig, index: int) -> dict:
    """Batch ``index`` as numpy host arrays (pure function of seed+index)."""
    rng = np.random.default_rng((cfg.seed, index))
    weights = cfg.curation_weights
    if weights is None:
        weights = np.ones(cfg.n_latent_clusters)
    p = np.asarray(weights, np.float64)
    p = p / p.sum()
    clusters = rng.choice(cfg.n_latent_clusters, cfg.global_batch, p=p)
    tokens = np.stack([_doc_tokens(rng, int(c), cfg) for c in clusters])
    batch = {"tokens": tokens}
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.normal(
            0, 0.3, (cfg.global_batch, cfg.frontend_seq, cfg.d_model)
        ).astype(np.float32)
    if cfg.prefix_len:
        batch["prefix"] = rng.normal(
            0, 0.3, (cfg.global_batch, cfg.prefix_len, cfg.d_model)
        ).astype(np.float32)
    return batch


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    i = start_step
    while True:
        yield batch_at(cfg, i)
        i += 1


def doc_embeddings(cfg: DataConfig, n_docs: int, dim: int = 2,
                   seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """2-D embeddings of synthetic docs (cluster structure preserved) —
    the input to DDC curation.  Returns (embeddings, true cluster ids)."""
    rng = np.random.default_rng(seed)
    k = cfg.n_latent_clusters
    g = int(np.ceil(np.sqrt(k)))
    centers = (np.stack(np.meshgrid(np.arange(g), np.arange(g)), -1)
               .reshape(-1, 2)[:k] + 0.5) / g
    ids = rng.integers(0, k, n_docs)
    emb = centers[ids] + rng.normal(0, 0.02, (n_docs, 2))
    return np.clip(emb, 0, 1).astype(np.float32), ids.astype(np.int32)
