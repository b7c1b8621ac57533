"""The LM stack's dry run: the port's counterpart of the reference
package's ``launch/dryrun.py``.  For each (arch × shape × mesh) cell it
answers, without a card: does this model, at this shape, fit on this many
cards, and what bounds its step?

The reference lowers and compiles the step on 512 host devices and reads
the partitioned HLO.  The port runs explicit SPMD, one rank a mesh
position, so it traces what ONE rank of the production mesh runs: this
process plays rank 0 of 256 (or 512) in a fake world
(``launch.mesh.fake_world``), every parameter, optimizer state, batch and
cache a fake tensor of that rank's shard (on torch's ``meta`` device: no
data), and ``launch/cost.py`` counts the step: FLOPs, bytes, collectives
by kind and the peak of live storages.  ``device`` names the routes the
count takes: "cuda" (the default) the card's, B7/B8/B9 where the card
launches them; "cpu" the plain versions'.  Nothing touches a card, and
the dry run runs anywhere.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --single-pod-only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table results/dryrun.json \
      [--parent OTHER.json]

Each cell's record keeps the reference's keys (``hbm_per_device_gb``,
``memory``, ``flops_per_dev``, ``bytes_per_dev``, ``coll_bytes_per_dev``,
``coll_detail``, ``coll_counts``, the three terms, ``bottleneck``,
``model_flops``, ``useful_ratio``, ``roofline_frac``) with these
differences: ``trace_s`` replaces ``lower_s``/``compile_s``; there is no
``xla_flops``; ``bytes_per_dev`` is eager (every aten op's inputs and
outputs: no fusion); ``coll_detail`` counts the bytes a rank puts into
each collective (the reference counts the result's); ``memory`` is the
count's (``roofline.memory_summary``); ``fits_h100_80gb`` is added, and
``kernels`` (B7/B8/B9's calls, FLOPs and bytes) and ``traced`` (the
depths and microbatch counts traced, ``cost.weigh``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import NamedTuple

import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable
from repro_torch.launch import cost
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline
from repro_torch.models import transformer as T
from repro_torch.models.tree import Stack, flatten
from repro_torch.parallel import api as par
from repro_torch.serve import engine
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step as step_mod

# Per-arch training recipe: the 100B+ param configs use Adafactor+bf16
# (Adam state would exceed pod HBM — EXPERIMENTS.md §Dry-run).
BIG_ARCHS = {"kimi-k2-1t-a32b", "jamba-1.5-large-398b", "llama4-scout-17b-a16e"}


def train_recipe(arch: str, microbatches: int = 8) -> step_mod.TrainConfig:
    """Per-arch training recipe.  8 gradient-accumulation microbatches keep
    train_4k activations inside v5e HBM (EXPERIMENTS.md §Dry-run)."""
    if arch in BIG_ARCHS:
        return step_mod.TrainConfig(
            opt=opt_mod.OptConfig(name="adafactor", stochastic_rounding=True),
            param_dtype="bfloat16", microbatches=microbatches,
        )
    return step_mod.TrainConfig(
        opt=opt_mod.OptConfig(name="adamw"), param_dtype="bfloat16",
        microbatches=microbatches,
    )


def shape_cell_cfg(cfg, shape: ShapeConfig):
    """Arch tweaks for a given cell (long-context window for hybrids)."""
    window = "cfg"
    if shape.name == "long_500k" and cfg.long_window is not None:
        window = cfg.long_window
    return window


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype (the reference's ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def batch_specs(cfg, shape: ShapeConfig, global_batch: int, seq: int) -> dict:
    b = {"tokens": TensorSpec((global_batch, seq), torch.int32)}
    if cfg.frontend == "audio_stub":
        b["frames"] = TensorSpec((global_batch, cfg.frontend_seq, cfg.d_model), torch.bfloat16)
    if cfg.prefix_len:
        b["prefix"] = TensorSpec((global_batch, cfg.prefix_len, cfg.d_model), torch.bfloat16)
    return b


def model_flops(cfg, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / per-token (decode),
    N = active params, + causal attention term."""
    pc = cfg.param_counts()
    n_active = pc["active"]
    b, s = shape.global_batch, shape.seq_len
    n_attn = sum(1 for k, _ in cfg.layer_kinds() if k == "attn") * cfg.n_groups
    n_attn += cfg.encoder_layers
    hd, h = cfg.head_dim, cfg.n_heads
    if shape.kind == "train":
        tokens = b * s
        attn = n_attn * 2.0 * b * h * s * s * hd / 2 * 3  # fwd+bwd(2x)
        return 6.0 * n_active * tokens + attn
    if shape.kind == "prefill":
        tokens = b * s
        attn = n_attn * 2.0 * b * h * s * s * hd / 2
        return 2.0 * n_active * tokens + attn
    # decode: one token against a seq_len cache
    attn = n_attn * 4.0 * b * h * min(s, 10**9 if cfg.window is None else cfg.window) * hd
    return 2.0 * n_active * b + attn


# ---------------------------------------------------------------------------
# One rank's step, traced
# ---------------------------------------------------------------------------


HOST = "meta"   # where the fake tensors stand: no data


def _empty(specs: dict) -> dict:
    return {k: torch.empty(s.shape, dtype=s.dtype, device=HOST) for k, s in specs.items()}


def _nbytes(tensors) -> int:
    """The bytes of ``tensors`` (a ``Stack`` counts its groups')."""
    return sum(t.numel() * t.element_size() for leaf in tensors
               for t in (leaf if isinstance(leaf, Stack) else (leaf,)))


def _cut(cfg, groups: int):
    return dataclasses.replace(cfg, n_layers=groups * cfg.pattern_len)


def _trace_train(cfg, tcfg, shape, pctx, card: bool, micro: int, memo):
    """The count of one train step of ``cfg`` over ``micro`` microbatches of
    the cell's microbatch size."""
    per_micro = shape.global_batch // tcfg.microbatches
    tcfg = dataclasses.replace(tcfg, microbatches=micro)

    def run(c):
        model = T.abstract_params(cfg, device=HOST, dtype=getattr(torch, tcfg.param_dtype),
                                  trainable=True, pctx=pctx)
        state = step_mod.state_for(model, tcfg)
        batch = _empty(batch_specs(cfg, shape, per_micro * micro, shape.seq_len))
        params = list(model.parameters())
        step_fn = step_mod.build_train_step(cfg, tcfg, pctx)
        with c.measure():
            step_fn(state, batch)
        return {"params": _nbytes(params),
                "grads": sum(p.numel() * (4 if micro > 1 else p.element_size())
                             for p in params),
                "opt": _nbytes(leaf for _, leaf in flatten(state.opt)),
                "inputs": _nbytes(batch.values())}

    return _run(run, card, memo)


def _trace_serve(cfg, shape, pctx, card: bool, window, memo):
    """The count of one prefill of the cell's batch, or of one decode step
    against a ``shape.seq_len`` cache (at its last position)."""
    scfg = engine.ServeConfig(max_len=shape.seq_len, window=window)

    def run(c):
        model = T.abstract_params(cfg, device=HOST, dtype=torch.bfloat16, pctx=pctx)
        seq = shape.seq_len if shape.kind == "prefill" else 1
        batch = _empty(batch_specs(cfg, shape, shape.global_batch, seq))
        local, split = pctx.shard_batch(batch)
        with par.use(dataclasses.replace(pctx, batch_sharded=split)):
            if shape.kind == "prefill":
                fn = engine.build_prefill(cfg, scfg)
                args = (model, local["tokens"], local.get("prefix"), local.get("frames"))
                inputs = list(batch.values())
            else:
                cache = T.init_cache(cfg, local["tokens"].shape[0], shape.seq_len,
                                     dtype=torch.bfloat16, window=window, device=HOST)
                fn = engine.build_decode(cfg, scfg)
                args = (model, local["tokens"], cache, shape.seq_len - 1)
                inputs = [batch["tokens"]] + [t for _, t in flatten(cache)]
            with c.measure():
                fn(*args)
        return {"params": _nbytes(model.parameters()), "grads": 0, "opt": 0,
                "inputs": _nbytes(inputs)}

    return _run(run, card, memo)


def _run(run, card: bool, memo) -> dict:
    """``run(count)`` under a new count: its summary, and the sizes
    (bytes) ``run`` returns under "sizes"."""
    with cost.Count(card, memo) as c:
        sizes = run(c)
    return {**c.summary(), "sizes": sizes}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             pctx_overrides: dict | None = None,
             tcfg: step_mod.TrainConfig | None = None,
             capacity_factor: float | None = None, device="cuda", *,
             cfg=None, shape: ShapeConfig | None = None, mesh: tuple | None = None,
             weighted: bool = True) -> dict:
    """The record of one cell (``lower_cell``'s counterpart).  ``cfg``,
    ``shape`` and ``mesh`` ((sizes, axes)) replace the arch's config, the
    shape and the production mesh (the tests run tiny cells on (data 2,
    model 4)).  ``weighted``: trace two depths and microbatch counts and
    extend the counts (``cost.weigh``); False traces the whole step."""
    cfg = cfg or configs.get_config(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    shape = shape or SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    sizes, axes = mesh or mesh_mod.production_shape(multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, sizes)) if mesh else ("2x16x16" if multi_pod else "16x16")}
    if not ok:
        return dict(rec, status="skipped", reason=why)

    overrides = dict(fsdp=True, remat="full")
    overrides.update(pctx_overrides or {})
    window = shape_cell_cfg(cfg, shape)
    chips = 1
    for n in sizes:
        chips *= n
    t0 = time.perf_counter()
    try:
        with mesh_mod.fake_world(chips):
            m = mesh_mod.make_mesh(sizes, axes, device=HOST)
            card = torch.device(device).type == "cuda"
            pctx = par.ParallelCtx(mesh=m, **overrides)
            memo: dict = {}
            groups = cfg.n_groups
            g_traced = (groups,) if not weighted else cost.depths(groups)
            if shape.kind == "train":
                tcfg = tcfg or train_recipe(arch)
                micro = tcfg.microbatches
                if shape.global_batch % micro:
                    raise ValueError(f"{shape.global_batch} sequences do not split into "
                                     f"{micro} microbatches")
                m_traced = (micro,) if not weighted else cost.depths(micro)
                traced = {(g, k): _trace_train(_cut(cfg, g), tcfg, shape, pctx, card, k, memo)
                          for g in g_traced for k in m_traced}
            else:
                micro, m_traced = 1, (1,)
                traced = {(g, 1): _trace_serve(_cut(cfg, g), shape, pctx, card, window, memo)
                          for g in g_traced}
            my = cost.weigh(traced, groups, micro)
        trace_s = time.perf_counter() - t0
        coll_detail = {k: v["bytes"] for k, v in my["collectives"].items()}
        coll_counts = {k: v["calls"] for k, v in my["collectives"].items()}
        coll_bytes = sum(coll_detail.values())
        mf = model_flops(cfg, shape)
        r = roofline.Roofline(flops=my["flops"], bytes_accessed=my["bytes"],
                              coll_bytes=coll_bytes, chips=chips, model_flops=mf).finalize()
        s = my["sizes"]
        mem = roofline.memory_summary(my, s["params"], s["grads"], s["opt"], s["inputs"])
        rec.update(
            status="ok", trace_s=round(trace_s, 2),
            hbm_per_device_gb=round(mem["total_hbm_bytes"] / 2**30, 3),
            memory=mem, fits_h100_80gb=roofline.fits_h100_80gb(mem["total_hbm_bytes"]),
            flops_per_dev=my["flops"], bytes_per_dev=my["bytes"],
            coll_bytes_per_dev=coll_bytes, coll_detail=coll_detail, coll_counts=coll_counts,
            kernels=my["kernels"], ops=my["ops"],
            t_compute=r.t_compute, t_memory=r.t_memory, t_collective=r.t_collective,
            bottleneck=r.bottleneck, model_flops=mf, useful_ratio=round(r.useful_ratio, 4),
            roofline_frac=round(r.roofline_frac, 4),
            traced={"groups": list(g_traced), "of_groups": groups,
                    "microbatches": list(m_traced), "of_microbatches": micro},
            device=str(device), ranks=chips)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


SHORT_KEYS = ("arch", "shape", "mesh", "status", "hbm_per_device_gb", "fits_h100_80gb",
              "t_compute", "t_memory", "t_collective", "bottleneck", "useful_ratio",
              "trace_s", "reason", "error")


TABLE_HEAD = ("| Arch | Shape | GiB a rank | FLOPs a rank | Bytes a rank | Coll. bytes | "
              "t_compute s | t_memory s | t_coll. s | Bound | Fits 80 GB | trace s | "
              "FLOPs·chips / model | ÷ qwen3's |")


def table(records: list, parent: list | None = None) -> list[str]:
    """The markdown rows of the ``ok`` records: the record's numbers, its
    replication (a rank's FLOPs × the mesh's chips / ``model_flops``:
    how many times the model's FLOPs the mesh computes) and that over
    qwen3-8b's at the same shape; with ``parent`` (another run's records)
    the FLOPs a rank read "new [parent]" where they differ."""
    ok = [r for r in records if r.get("status") == "ok"]
    old = {(r["arch"], r["shape"], r["mesh"]): r for r in parent or ()}

    def chips(r):
        n = 1
        for d in r["mesh"].split("x"):
            n *= int(d)
        return n

    rep = {(r["arch"], r["shape"]): r["flops_per_dev"] * chips(r) / r["model_flops"]
           for r in ok if r.get("model_flops")}
    rows = [TABLE_HEAD, "|" + " --- |" * (TABLE_HEAD.count("|") - 1)]
    for r in ok:
        flops = f"{r['flops_per_dev']:.4g}"
        was = old.get((r["arch"], r["shape"], r["mesh"]))
        if was is not None and was.get("flops_per_dev") != r["flops_per_dev"]:
            flops += f" [{was['flops_per_dev']:.4g}]"
        x = rep.get((r["arch"], r["shape"]))
        q = rep.get(("qwen3-8b", r["shape"]))
        rows.append("| " + " | ".join([
            r["arch"], r["shape"], f"{r['hbm_per_device_gb']:.3f}", flops,
            f"{r['bytes_per_dev']:.4g}", f"{r['coll_bytes_per_dev']:.4g}",
            f"{r['t_compute']:.4g}", f"{r['t_memory']:.4g}", f"{r['t_collective']:.4g}",
            r["bottleneck"], "yes" if r["fits_h100_80gb"] else "no", f"{r['trace_s']:.2f}",
            "—" if x is None else f"{x:.2f}",
            "—" if x is None or not q else f"{x / q:.2f}"]) + " |")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--moe-impl", default="epsum")
    ap.add_argument("--a2a-int8", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="whose routes the count takes: cuda (the card's) or cpu (the "
                         "plain versions'); no card is touched")
    ap.add_argument("--out", default=None)
    ap.add_argument("--table", default=None,
                    help="print the markdown table of a run's records (an --out .json) "
                         "and run nothing")
    ap.add_argument("--parent", default=None,
                    help="with --table: another run's records, whose FLOPs a rank are "
                         "shown where they differ")
    args = ap.parse_args(argv)
    if args.table:
        def load(path):
            with open(path) as f:
                return json.load(f)
        print("\n".join(table(load(args.table), load(args.parent) if args.parent else None)))
        return []

    archs = configs.all_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    overrides = dict(fsdp=bool(args.fsdp), remat=args.remat,
                     moe_impl=args.moe_impl, a2a_int8=args.a2a_int8)
    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, pctx_overrides=overrides,
                               capacity_factor=args.capacity_factor, device=args.device)
                print(json.dumps({k: rec.get(k) for k in SHORT_KEYS}), flush=True)
                records.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out + ".json", "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}.json")
    return records


if __name__ == "__main__":
    main()
