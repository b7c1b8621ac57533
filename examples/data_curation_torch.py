"""DDC-powered data curation on the PyTorch port (the counterpart of
examples/data_curation.py).

Embeds a synthetic skewed corpus, clusters the embeddings with DDC,
derives cluster-balanced sampling weights and shows the rebalanced batch
mixture.  ``--lanes K`` (default 8) runs ``make_ddc_fn`` over K lanes on
``--device`` (default ``cuda``); ``--lanes 0`` takes the reference's host
path instead (``ddc_host``, 8 shards, NumPy).

  PYTHONPATH=src python examples/data_curation_torch.py [--lanes 8] [--device cuda]
"""
import argparse

import numpy as np

from repro_torch.data import curation, pipeline
from repro_torch.launch import mesh as mesh_mod


def corpus(n_docs: int = 4000):
    """The example's skewed corpus: 8 latent clusters, cluster 0 rare."""
    dcfg = pipeline.DataConfig(vocab=4096, seq_len=64, global_batch=64,
                               n_latent_clusters=8, seed=0)
    emb, ids = pipeline.doc_embeddings(dcfg, n_docs=n_docs)
    # Skew the corpus: cluster 0 is rare, cluster 1 dominates.
    keep = np.ones(len(ids), bool)
    keep[(ids == 0) & (np.arange(len(ids)) % 8 != 0)] = False
    return dcfg, emb[keep], ids[keep]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=8, help="0: the reference's host path")
    args = ap.parse_args(argv)
    dcfg, emb, ids = corpus()
    lanes = mesh_mod.make_lane_mesh(args.lanes, args.device) if args.lanes else None
    res = curation.curate(emb, mesh=lanes)
    where = f"{args.lanes} lanes on {args.device}" if lanes else "the host path"
    print(f"DDC ({where}) found {res.n_clusters} clusters over {len(emb)} docs "
          f"(true latent clusters: 8)")
    print(f"cluster sizes: {res.cluster_sizes.astype(int).tolist()}")
    print(f"balanced weights: {np.round(res.sample_weights, 3).tolist()}")
    print(f"exchanged {res.exchanged_fraction:.2%} of embedding bytes "
          f"across 'nodes' (paper: 1-2%)")

    before = pipeline.batch_at(dcfg, 0)
    dcfg2 = curation.apply_to_data_config(dcfg, res, ids)
    after = pipeline.batch_at(dcfg2, 0)

    def mixture(cfg):
        w = cfg.curation_weights
        if w is None:
            w = np.ones(cfg.n_latent_clusters)
        w = w / w.sum()
        return np.round(w, 3).tolist()

    print(f"sampling mixture before: {mixture(dcfg)}")
    print(f"sampling mixture after : {mixture(dcfg2)}")
    assert after["tokens"].shape == before["tokens"].shape
    print("pipeline batches regenerate deterministically under new weights ✓")
    return res


if __name__ == "__main__":
    main()
