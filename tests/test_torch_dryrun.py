"""The LM dry run (``launch/{dryrun,dryrun_scaleout,cost,roofline}.py``,
the meta-tensor paths of ``kernels/ops.py``, the fake world of
``launch/mesh.py``) against the reference's dry run, against FLOP
counter formulas and against a real run over gloo ranks.

Beside this process, the reference runs in a subprocess on 8 host devices
(``tests/_torch_ref_script.py dryrun_lm``: its pure functions for every
arch × shape, and ``lower_cell`` of ``DRYRUN_TINY_CELLS`` on (data 2,
model 4)) and 4 gloo ranks run the tiny train steps the collectives are
held to, all at once.

What is held, and how closely:
* ``model_flops``, ``applicable`` and its reason, ``shape_cell_cfg``,
  ``batch_specs`` and ``train_recipe``: equal, every arch × shape;
* the plain routes' FLOPs per device (``device="cpu"``) against
  ``hlo_cost.analyze_text`` of the reference's partitioned module: within
  2 %, and exactly once one named term is added: the reference's train
  step takes the vocabulary head over every position and the port's
  vocab-parallel loss over all but the last (forward and backward, 3 × 2 ×
  tokens × d × vocab/model for that position);
* the card's routes count the plain versions' forward FLOPs once more a
  kernel call with a gradient (``_plain_vjp`` recomputes it): exactly the
  closed forms, which equal ``torch.utils.flop_counter`` over the plain
  versions exactly;
* the weighted count (``cost.weigh``: two depths, two microbatch counts)
  equals the whole step's exactly in FLOPs, bytes, ops, collectives and
  kernels; its peak memory within 1 % (each storage is rounded to 512
  bytes, which an extension along a line does not keep);
* the collectives a rank makes in the dry run: exactly those of a real
  4-rank gloo step (``parallel.collectives.STATS``), by kind.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_mesh_probe as probe  # noqa: E402
import _torch_ref_script as refscript  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import cost, dryrun, ranks  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY_SHAPES = {k: ShapeConfig(k, *v) for k, v in refscript.DRYRUN_TINY_SHAPES.items()}
MESH24 = refscript.DRYRUN_TINY_MESH
MESH22 = ((2, 2), ("data", "model"))
GLOO_ARCHS = ("qwen3-8b", "llama4-scout-17b-a16e")
CARD_CELLS = refscript.DRYRUN_TINY_CELLS + (("mamba2-1.3b", "train_4k"),)


def tiny_cell(arch, shape, device, mesh=MESH24, **kw):
    rec = dryrun.run_cell(arch, shape, False, device=device, cfg=configs.get_config(arch).tiny(),
                          shape=TINY_SHAPES[shape], mesh=mesh, **kw)
    assert rec["status"] == "ok", rec.get("trace")
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    ref_out = tmp / "reference.json"
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_ref_script.py"),
                             "dryrun_lm", str(ref_out)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        seq, batch, _ = refscript.DRYRUN_TINY_SHAPES["train_4k"]
        cases = [ranks.Case(probe.dryrun_step_rank, 4, (*MESH22, arch, (batch, seq)))
                 for arch in GLOO_ARCHS]
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(ranks.run_cases, cases, 4, device="cpu", timeout=300)
            out = {"cells": {(a, s, dev): tiny_cell(a, s, dev)
                             for a, s in CARD_CELLS for dev in ("cpu", "cuda")},
                   "mesh22": {a: tiny_cell(a, "train_4k", "cuda", mesh=MESH22)
                              for a in GLOO_ARCHS}}
            out["gloo"] = dict(zip(GLOO_ARCHS, (r[0] for r in fut.result())))
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log
    finally:
        if proc.poll() is None:
            proc.kill()
    out["ref"] = json.loads(ref_out.read_text())
    return out


# -- the pure functions -------------------------------------------------------


@pytest.mark.parametrize("arch", configs.all_archs())
def test_pure_functions_equal_reference(runs, arch):
    ref = runs["ref"]
    tc = dryrun.train_recipe(arch)
    assert {"opt": dataclasses.asdict(tc.opt), "param_dtype": tc.param_dtype,
            "microbatches": tc.microbatches, "seed": tc.seed} == ref["recipes"][arch]
    cfg = configs.get_config(arch)
    for name, shape in SHAPES.items():
        want = ref["cells"][f"{arch}/{name}"]
        ok, why = configs.applicable(cfg, shape)
        specs = dryrun.batch_specs(cfg, shape, shape.global_batch, shape.seq_len)
        assert (ok, why) == (want["applicable"], want["reason"]), name
        assert dryrun.model_flops(cfg, shape) == want["model_flops"], name
        assert dryrun.shape_cell_cfg(cfg, shape) == want["window"], name
        assert {k: [list(s.shape), str(s.dtype).removeprefix("torch.")]
                for k, s in specs.items()} == want["specs"], name
        if not ok:
            rec = dryrun.run_cell(arch, name, False)
            assert (rec["status"], rec["reason"]) == ("skipped", want["reason"])


# -- FLOPs against the reference's partitioned module ----------------------------


def head_last_position(arch) -> int:
    """The FLOPs of the vocabulary head at the last position of every
    training sequence, forward and backward, on one rank of MESH24: the
    reference's train step computes them, the port's loss does not."""
    cfg = configs.get_config(arch).tiny()
    seq, batch, _ = refscript.DRYRUN_TINY_SHAPES["train_4k"]
    (data, model), _ = MESH24
    return 3 * 2 * (batch // data) * cfg.d_model * (cfg.padded_vocab // model)


@pytest.mark.parametrize("arch,shape", refscript.DRYRUN_TINY_CELLS)
def test_tiny_flops_match_hlo_cost(runs, arch, shape):
    ref = runs["ref"]["tiny"][f"{arch}/{shape}"]["flops_per_dev"]
    got = runs["cells"][(arch, shape, "cpu")]["flops_per_dev"]
    assert abs(got - ref) <= 0.02 * ref
    named = head_last_position(arch) if shape == "train_4k" else 0
    assert got + named == ref


def attention_calls(arch, shape):
    """(B7's q shape, its calls with a gradient, all its calls) in a tiny
    cell on MESH24: a training layer calls it in the forward pass and in
    the checkpoint's recompute, and differentiates one of the two."""
    cfg = configs.get_config(arch).tiny()
    seq, batch, kind = refscript.DRYRUN_TINY_SHAPES[shape]
    (data, model), _ = MESH24
    micro = dryrun.train_recipe(arch).microbatches if kind == "train" else 1
    q = (batch // data // micro, cfg.n_heads // model, seq, cfg.head_dim)
    n_attn = cfg.n_groups * sum(k == "attn" for k, _ in cfg.layer_kinds())
    grads = n_attn * micro if kind == "train" else 0
    return q, grads, {"train": 2 * grads, "prefill": n_attn, "decode": 0}[kind]


@pytest.mark.parametrize("arch,shape", CARD_CELLS)
def test_card_route_adds_the_vjp_recompute(runs, arch, shape):
    card = runs["cells"][(arch, shape, "cuda")]
    plain = runs["cells"][(arch, shape, "cpu")]
    if arch == "mamba2-1.3b":
        cfg = configs.get_config(arch).tiny()
        seq, batch, _ = refscript.DRYRUN_TINY_SHAPES[shape]
        micro = dryrun.train_recipe(arch).microbatches
        x = (batch // MESH24[0][0] // micro, seq, cfg.ssm_heads, cfg.ssm_head_dim)
        want = cfg.n_layers * micro * ops.ssd_flops(x, cfg.ssm_state)
        assert card["kernels"]["ssd_scan"]["calls"] == 2 * cfg.n_layers * micro
    else:
        q, grads, calls = attention_calls(arch, shape)
        want = grads * ops.attention_flops(q, q, q)
        assert card["kernels"].get("flash_attention", {}).get("calls", 0) == calls
    assert card["flops_per_dev"] - plain["flops_per_dev"] == want
    assert plain["kernels"] == {}
    assert card["coll_counts"] == plain["coll_counts"]


# -- the closed forms --------------------------------------------------------------

ATTENTION_CASES = {"exact": ((2, 3, 40, 8), (2, 1, 40, 8), (2, 1, 40, 8), True),
                   "chunked_padded": ((1, 1, 1500, 8), (1, 1, 1500, 8), (1, 1, 1500, 8), True),
                   "mla_dims": ((1, 2, 24, 12), (1, 2, 24, 12), (1, 2, 24, 8), True),
                   "cross": ((2, 2, 1, 8), (2, 2, 30, 8), (2, 2, 30, 8), False)}
SSD_CASES = {"sequential": (2, 40, 3, 4, 5), "chunked_padded": (1, 300, 2, 4, 3)}


def _grads_flops(fn, inputs):
    with FlopCounterMode(display=False) as fc:
        out = fn(*inputs)
    with FlopCounterMode(display=False) as fc_vjp:
        ops._plain_vjp("t", fn, inputs, [True] * len(inputs), torch.ones_like(out))
    return fc.get_total_flops(), fc_vjp.get_total_flops(), out


def _on_meta(fn, inputs):
    """``fn`` on meta copies of ``inputs`` (requiring grad) under a count of
    the card's routes, twice, each with its backward."""
    with cost.Count(card=True) as c, c.measure():
        for _ in range(2):
            leaves = [torch.empty(t.shape, dtype=t.dtype, device="meta", requires_grad=True)
                      for t in inputs]
            out = fn(*leaves)
            torch.autograd.grad(out, leaves, torch.ones_like(out))
    return c


@pytest.mark.parametrize("case", list(ATTENTION_CASES) + list(SSD_CASES))
def test_closed_forms_match_flop_counter(case):
    g = torch.Generator().manual_seed(0)
    if case in ATTENTION_CASES:
        *shapes, causal = ATTENTION_CASES[case]
        inputs = [torch.randn(s, generator=g) for s in shapes]
        plain = lambda q, k, v: ops._plain_attention(q, k, v, causal, None, None)  # noqa: E731
        run = lambda q, k, v: ops.flash_attention(q, k, v, causal=causal)  # noqa: E731
        closed, name = ops.attention_flops(*shapes), "flash_attention"
    else:
        b, l, h, dh, ds = SSD_CASES[case]
        inputs = [torch.randn((b, l, h, dh), generator=g),
                  -torch.rand((b, l, h), generator=g),
                  torch.randn((b, l, h, ds), generator=g), torch.randn((b, l, h, ds), generator=g)]
        plain, run = ops._plain_ssd, ops.ssd_scan
        closed, name = ops.ssd_flops((b, l, h, dh), ds), "ssd_scan"
    fwd, vjp, out = _grads_flops(plain, inputs)
    assert fwd == closed
    c = _on_meta(run, inputs)
    assert c.kernels[name]["calls"] == 2
    assert c.kernels[name]["flops"] == 2 * closed
    # Each backward's recompute and VJP, counted op by op (the second replayed).
    assert c.flops == 2 * (closed + vjp)
    assert out.shape == run(*[t.to("meta") for t in inputs]).shape


def test_gather_on_meta():
    """B9 on meta tensors: the kernel's outputs, no FLOPs, its bytes (each
    slot's row read, the ids, the rows and scales written); under grad the
    plain gather's VJP."""
    x = torch.empty((6, 4), device="meta", requires_grad=True)
    idx = torch.empty((5,), dtype=torch.int32, device="meta")
    with cost.Count(card=True) as c, c.measure():
        buf, scales = ops.dispatch_gather(x.detach(), idx, quant=True)
        assert (buf.shape, buf.dtype, scales.shape, scales.dtype) == \
            ((5, 4), torch.int8, (5,), torch.float32)
        assert c.kernels["dispatch_gather"] == {"calls": 1, "flops": 0,
                                                "bytes": 5 * 4 * 4 + 5 * 4 + 5 * 4 + 5 * 4}
        buf, _ = ops.dispatch_gather(x, idx, quant=False)
        assert buf.dtype == torch.float32 and buf.requires_grad
        before = c.ops
        (dx,) = torch.autograd.grad(buf, x, torch.ones_like(buf))
        assert dx.shape == x.shape and c.ops > before
    assert c.kernels["dispatch_gather"]["calls"] == 2


# -- trip weighting ---------------------------------------------------------------


# (arch, block groups, microbatches): qwen3-8b (AdamW) extended in depth,
# llama4-scout (MoE, Adafactor's stacked leaves) in microbatches.
WEIGHED = {"qwen3-8b": (4, 2), "llama4-scout-17b-a16e": (2, 4)}


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_weighted_equals_unweighted(arch):
    groups, micro = WEIGHED[arch]
    base = configs.get_config(arch).tiny()
    cfg = dataclasses.replace(base, n_layers=groups * base.pattern_len)
    tcfg = dryrun.train_recipe(arch, microbatches=micro)
    recs = [dryrun.run_cell(arch, "train_4k", False, cfg=cfg, shape=TINY_SHAPES["train_4k"],
                            mesh=MESH24, tcfg=tcfg, weighted=w) for w in (True, False)]
    assert [r["status"] for r in recs] == ["ok", "ok"], [r.get("trace") for r in recs]
    weighted, whole = recs
    assert weighted["traced"] == {"groups": list(cost.depths(groups)), "of_groups": groups,
                                  "microbatches": list(cost.depths(micro)),
                                  "of_microbatches": micro}
    assert len(weighted["traced"]["groups"] + weighted["traced"]["microbatches"]) == 3
    for key in ("flops_per_dev", "bytes_per_dev", "ops", "coll_counts", "coll_detail",
                "kernels"):
        assert weighted[key] == whole[key], key
    for key, v in whole["memory"].items():
        assert abs(weighted["memory"][key] - v) <= 0.01 * whole["memory"]["total_hbm_bytes"]


# -- collectives against a real gloo step ------------------------------------------


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_collectives_equal_gloo_step(runs, arch):
    stats = runs["gloo"][arch]
    rec = runs["mesh22"][arch]
    assert rec["coll_counts"] == {k: v["calls"] for k, v in stats["kinds"].items()}
    assert rec["coll_detail"] == {k: v["bytes"] for k, v in stats["kinds"].items()}
    assert sum(rec["coll_counts"].values()) == stats["collectives"]
    assert rec["coll_bytes_per_dev"] == stats["bytes"]
    assert stats["staged_bytes"] == 0


def test_checkpoint_recompute_keeps_the_context():
    """A checkpointed block group recomputes under the context it ran under,
    also where the backward pass runs on another thread (a card's autograd
    engine runs it on the device's thread): here tiny qwen3-8b on (data 2,
    model 2) in a fake world, its loss differentiated from a new thread."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import api as par

    cfg = configs.get_config("qwen3-8b").tiny()
    with mesh_mod.fake_world(4), cost.Count(card=False):
        pctx = par.ParallelCtx(mesh=mesh_mod.make_mesh(*MESH22, device="meta"), fsdp=True,
                               remat="full")
        model = T.abstract_params(cfg, device="meta", trainable=True, pctx=pctx)
        with par.use(pctx):
            loss = T.loss_fn(cfg, model, {"tokens": torch.empty((2, 16), dtype=torch.int32,
                                                                 device="meta")})
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            grads = pool.submit(torch.autograd.grad, loss, list(model.parameters())).result()
    assert [g.shape for g in grads] == [p.shape for p in model.parameters()]


def test_fake_world_and_records(runs):
    with mesh_mod.fake_world(256):
        m = mesh_mod.make_production_mesh(device="meta")
        assert (m.backend, m.staged, m.coords) == ("fake", False, {"data": 0, "model": 0})
        coll.reset_stats()
        coll.all_reduce_raw(torch.empty((3, 4), device="meta"), m, "model")
        assert coll.STATS["kinds"]["all-reduce"] == {"calls": 1, "bytes": 48}
    assert not torch.distributed.is_initialized() and not mesh_mod._GROUPS
    rec = runs["cells"][("qwen3-8b", "train_4k", "cuda")]
    for key in ("hbm_per_device_gb", "memory", "flops_per_dev", "bytes_per_dev",
                "coll_bytes_per_dev", "coll_detail", "coll_counts", "t_compute", "t_memory",
                "t_collective", "bottleneck", "model_flops", "useful_ratio", "roofline_frac",
                "trace_s", "fits_h100_80gb"):
        assert key in rec, key
    mem = rec["memory"]
    assert mem["total_hbm_bytes"] >= mem["params_bytes"] + mem["opt_state_bytes"] > 0
    assert rec["fits_h100_80gb"] and rec["bottleneck"] in ("compute", "memory", "collective")
