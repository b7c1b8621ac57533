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
  tracing its ``make_ddc_fn`` (no compile; ``OUT`` a .json);
* ``mesh`` — the LM stack's collectives and MoE islands on 8 devices
  (``OUT`` an .npz): ``int8_all_to_all`` over (data 8) forward and
  backward on ``a2a_inputs()``, ``shard_map_all_reduce`` of one leaf,
  and ``moe_apply`` of tiny llama4-scout on (data 2, model 4) for each
  of ``MOE_VARIANTS`` (its capacity factor) with the gradients of Σ y·w + aux
  (``moe_inputs``);
* ``dryrun_lm`` — the LM dry run's pure functions for every arch × shape
  (``model_flops``, ``applicable``, ``shape_cell_cfg``, ``batch_specs``,
  ``train_recipe``) and ``lower_cell``'s records of ``DRYRUN_TINY_CELLS``:
  tiny configurations (``tiny(**overrides)``) at ``DRYRUN_TINY_SHAPES``
  on a (data 2, model 4) mesh, patched into the module at run time, keyed
  by ``tiny_key`` (``OUT`` a .json).  JAX's
  backend starts on 8 devices before ``repro.launch.dryrun`` is imported
  (its import asks for 512).
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
# The LM dry run's tiny cells: shape name -> (seq_len, global_batch, kind),
# and the (arch, shape, tiny() overrides or None) cells lowered on (data 2,
# model 4): MLA, Mamba-2 and the encoder-decoder at every kind, and GQA whose
# query or kv heads do not divide the 4 ``model`` lanes.
DRYRUN_TINY_SHAPES = {"train_4k": (32, 16, "train"), "prefill_32k": (64, 4, "prefill"),
                      "decode_32k": (64, 4, "decode"), "long_500k": (128, 1, "decode")}
DRYRUN_TINY_CELLS = (
    ("qwen3-8b", "train_4k", None), ("qwen3-8b", "prefill_32k", None),
    ("qwen3-8b", "decode_32k", None), ("llama4-scout-17b-a16e", "train_4k", None),
    *((arch, shape, None) for arch in ("minicpm3-4b", "mamba2-1.3b", "whisper-small")
      for shape in ("train_4k", "prefill_32k", "decode_32k")),
    ("deepseek-coder-33b", "prefill_32k", {"n_heads": 8, "n_kv_heads": 2}),
    ("deepseek-coder-33b", "prefill_32k", {"n_heads": 4, "n_kv_heads": 2}),
    ("deepseek-coder-33b", "prefill_32k", {"n_heads": 6, "n_kv_heads": 2}),
    ("deepseek-coder-33b", "train_4k", {"n_heads": 6, "n_kv_heads": 2}),
    ("minicpm3-4b", "prefill_32k", {"n_heads": 6, "n_kv_heads": 6}),
    ("whisper-small", "prefill_32k", {"n_heads": 6, "n_kv_heads": 6}))
DRYRUN_TINY_MESH = ((2, 4), ("data", "model"))
# name -> (moe_impl, a2a_int8, batch, capacity_factor) of the mesh mode's
# MoE runs: None keeps the tiny config's drop-free E; at 1.25 (the
# published configs') the routes drop token-copies.
MOE_VARIANTS = {"epsum": ("epsum", False, 4, None), "a2a": ("a2a", False, 4, None),
                "a2a_int8": ("a2a", True, 4, None), "a2a_rep": ("a2a", False, 1, None),
                "a2a_rep_int8": ("a2a", True, 1, None),
                "epsum_cf125": ("epsum", False, 4, 1.25), "a2a_cf125": ("a2a", False, 4, 1.25),
                "a2a_int8_cf125": ("a2a", True, 4, 1.25)}


def tiny_key(arch, shape, overrides=None) -> str:
    """A tiny cell's key: "arch/shape", then ",".join("k=v") of its
    overrides."""
    key = f"{arch}/{shape}"
    if overrides:
        key += "/" + ",".join(f"{k}={v}" for k, v in sorted(overrides.items()))
    return key


def a2a_inputs():
    """(x, dy) (8·8, 3, 16) float32: 8 lanes' (D 8, C 3, d 16) blocks, and
    one leaf (64, 64) for the all-reduce."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((64, 3, 16)) * rng.uniform(0.01, 10, (64, 3, 1))).astype(np.float32)
    dy = rng.standard_normal((64, 3, 16)).astype(np.float32)
    leaf = rng.standard_normal((64, 64)).astype(np.float32)
    return x, dy, leaf


def moe_inputs(cfg, d_model):
    """(x (4, 16, d), w (4, 16, d)): the reference check's x
    (``normal(PRNGKey(1))``, tests/_dist_script.py) and a seeded weight."""
    import jax
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 16, d_model)))
    w = np.random.default_rng(3).standard_normal((4, 16, d_model)).astype(np.float32)
    return x, w


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


def mesh(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat, configs
    from repro.launch import mesh as mesh_mod
    from repro.models import layers as L
    from repro.parallel import api as par
    from repro.parallel import compress

    arrays = {}
    x, dy, leaf = a2a_inputs()
    m8 = mesh_mod.make_host_mesh(8)
    fn = compat.shard_map(lambda t: compress.int8_all_to_all(t, "data"), mesh=m8,
                          in_specs=P("data"), out_specs=P("data"), check_vma=False)
    y, vjp = jax.vjp(jax.jit(fn), jnp.asarray(x))
    arrays["a2a/y"], arrays["a2a/dx"] = np.asarray(y), np.asarray(vjp(jnp.asarray(dy))[0])
    arrays["allreduce/same"] = np.asarray(
        compress.shard_map_all_reduce({"w": jnp.asarray(leaf)}, m8, axes=("data",))["w"])

    cfg = configs.get_config("llama4-scout-17b-a16e").tiny()
    p = L.moe_init(cfg, jax.random.PRNGKey(0))
    xm, wm = moe_inputs(cfg, cfg.d_model)
    m24 = mesh_mod.make_mesh((2, 4), ("data", "model"))
    for name, (impl, int8, b, cf) in MOE_VARIANTS.items():
        pctx = par.ParallelCtx(mesh=m24, moe_impl=impl, a2a_int8=int8)
        cfg_v = cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)

        def loss(p, x, w, cfg_v=cfg_v, pctx=pctx):
            with par.use(pctx):
                y, aux = L.moe_apply(cfg_v, p, x)
            return jnp.sum(y * w) + aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                             has_aux=True))(
            p, jnp.asarray(xm[:b]), jnp.asarray(wm[:b]))
        arrays[f"moe/{name}/y"], arrays[f"moe/{name}/aux"] = np.asarray(y), np.asarray(aux)
        arrays[f"moe/{name}/dx"] = np.asarray(gx)
        for k, v in jax.tree_util.tree_flatten_with_path(gp)[0]:
            arrays[f"moe/{name}/d/" + ".".join(str(getattr(q, "key", q)) for q in k)] = \
                np.asarray(v)
    np.savez(out, **arrays)


def dryrun_lm(out: str) -> None:
    import jax

    jax.devices()   # the backend starts on 8 devices: the import below asks for 512
    from repro import configs
    from repro.configs.shapes import SHAPES, ShapeConfig, applicable
    from repro.launch import dryrun as dr
    from repro.launch import mesh as mesh_mod

    cells, recipes = {}, {}
    for arch in configs.all_archs():
        cfg = configs.get_config(arch)
        tc = dr.train_recipe(arch)
        recipes[arch] = {"opt": dataclasses.asdict(tc.opt), "param_dtype": tc.param_dtype,
                         "microbatches": tc.microbatches, "seed": tc.seed}
        for name, shape in SHAPES.items():
            ok, why = applicable(cfg, shape)
            specs = dr.batch_specs(cfg, shape, shape.global_batch, shape.seq_len)
            cells[f"{arch}/{name}"] = {
                "applicable": ok, "reason": why, "model_flops": dr.model_flops(cfg, shape),
                "window": dr.shape_cell_cfg(cfg, shape),
                "specs": {k: [list(v.shape), str(v.dtype)] for k, v in specs.items()}}
    get = configs.get_config
    dr.SHAPES = {k: ShapeConfig(k, *v) for k, v in DRYRUN_TINY_SHAPES.items()}
    dr.mesh_mod.make_production_mesh = lambda multi_pod=False: mesh_mod.make_mesh(
        *DRYRUN_TINY_MESH)
    tiny = {}
    for arch, name, overrides in DRYRUN_TINY_CELLS:
        dr.configs.get_config = lambda a, o=overrides or {}: get(a).tiny(**o)
        rec = dr.lower_cell(arch, name, False)
        if rec["status"] != "ok":
            raise RuntimeError(f"{arch} {name} {overrides}: {rec}")
        tiny[tiny_key(arch, name, overrides)] = {k: rec[k] for k in (
            "flops_per_dev", "bytes_per_dev", "coll_counts", "coll_detail", "xla_flops",
            "hbm_per_device_gb")}
    with open(out, "w") as f:
        json.dump({"cells": cells, "recipes": recipes, "tiny": tiny}, f)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    {"curation": curation, "dryrun_meters": dryrun_meters, "mesh": mesh,
     "dryrun_lm": dryrun_lm}[sys.argv[1]](sys.argv[2])
