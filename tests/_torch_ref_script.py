"""The reference package's runs on 8 host devices that
tests/test_torch_curation.py and tests/test_torch_dryrun_ddc.py hold the
port to.  The device count must be set before JAX starts, so the tests
run this in a subprocess; it imports neither torch nor the port, and the
tests import its inputs from here.

    PYTHONPATH=src python tests/_torch_ref_script.py MODE OUT

Modes:

* ``curation`` — the reference's ``curate(emb, mesh=make_host_mesh(8),
  cfg=...)`` for every case of ``CURATION_CASES`` on
  examples/data_curation.py's corpus (``OUT`` an .npz);
* ``dryrun_meters`` — the reference's ``CommMeter`` for each schedule of
  its dry run's config at 8 lanes on ``DRYRUN_POINTS`` points, filled by
  tracing its ``make_ddc_fn`` (no compile; ``OUT`` a .json).
"""
import dataclasses
import json
import os
import sys

import numpy as np

# name -> DDCConfig fields (None: curate's default, async) for the mesh path.
CURATION_CASES = {"default": None}
# The reference dry run's facade config (src/repro/launch/dryrun_ddc.py).
DRYRUN_CONFIG = dict(eps=0.01, min_pts=4, grid=256, max_clusters=64, max_verts=128,
                     backend="jit")
DRYRUN_SCHEDULES = ("sync", "tree", "async")
DRYRUN_POINTS = 1024


def example_corpus(pipe):
    """examples/data_curation.py's skewed 4,000-document corpus."""
    cfg = pipe.DataConfig(vocab=4096, seq_len=64, global_batch=64, n_latent_clusters=8, seed=0)
    emb, ids = pipe.doc_embeddings(cfg, n_docs=4000)
    keep = np.ones(len(ids), bool)
    keep[(ids == 0) & (np.arange(len(ids)) % 8 != 0)] = False
    return cfg, emb[keep], ids[keep]


def curation(out: str) -> None:
    from repro.core import ddc as jddc
    from repro.data import curation as jcur
    from repro.data import pipeline as jpipe
    from repro.launch import mesh as mesh_mod

    _, emb, _ = example_corpus(jpipe)
    arrays = {}
    for name, fields in CURATION_CASES.items():
        cfg = None if fields is None else jddc.DDCConfig(**fields)
        res = jcur.curate(emb, mesh=mesh_mod.make_host_mesh(8), cfg=cfg)
        arrays |= {f"{name}/{f.name}": np.asarray(getattr(res, f.name))
                   for f in dataclasses.fields(res)}
    np.savez(out, **arrays)


def dryrun_meters(out: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import ddc as jfacade
    from repro.core import ddc as jddc
    from repro.launch import mesh as mesh_mod

    meters = {}
    for sched in DRYRUN_SCHEDULES:
        cfg = jfacade.DDCConfig(**DRYRUN_CONFIG, schedule=sched, shards=8).core()
        meter = jddc.CommMeter()
        run = jddc.make_ddc_fn(mesh_mod.make_host_mesh(8), "data", cfg, meter)
        run.lower(jax.ShapeDtypeStruct((DRYRUN_POINTS, 2), jnp.float32),
                  jax.ShapeDtypeStruct((DRYRUN_POINTS,), jnp.bool_))
        meters[sched] = meter.snapshot()
    with open(out, "w") as f:
        json.dump(meters, f)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    {"curation": curation, "dryrun_meters": dryrun_meters}[sys.argv[1]](sys.argv[2])
