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
  ``hlo_cost.analyze_text`` of the reference's partitioned module, for
  dense GQA, MoE, MLA, Mamba-2, the encoder-decoder and GQA whose heads do
  not divide ``model``: within 2 % once the deviations the port accepts
  are taken out, and exactly once the named terms are added: the
  reference's train step takes the vocabulary head over every position
  and the port's vocab-parallel loss over all but the last
  (``head_last_position``); with GQA query heads that do not divide
  ``model`` the reference splits P·V over the head dim where the port
  keeps B7 on whole heads (``pv_split``); in training the reference runs
  MLA's latent down-projections' backward partly whole
  (``latent_backward``);
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
import math
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
CARD_CELLS = (("qwen3-8b", "train_4k"), ("qwen3-8b", "prefill_32k"), ("qwen3-8b", "decode_32k"),
              ("llama4-scout-17b-a16e", "train_4k"), ("mamba2-1.3b", "train_4k"))


def tiny_cfg(arch, overrides=None):
    return configs.get_config(arch).tiny(**(overrides or {}))


def tiny_cell(arch, shape, device, mesh=MESH24, overrides=None, **kw):
    rec = dryrun.run_cell(arch, shape, False, device=device, cfg=tiny_cfg(arch, overrides),
                          shape=TINY_SHAPES[shape], mesh=mesh, **kw)
    assert rec["status"] == "ok", rec.get("trace")
    return rec


def cell_id(cell) -> str:
    arch, shape, overrides = cell
    return "-".join([arch, shape] + [f"{k}{v}" for k, v in sorted((overrides or {}).items())])


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
                   "tiny": {refscript.tiny_key(*c): tiny_cell(*c[:2], "cpu", overrides=c[2])
                            for c in refscript.DRYRUN_TINY_CELLS},
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


def head_last_position(cfg) -> int:
    """The FLOPs of the vocabulary head at the last position of every
    training sequence, forward and backward, on one rank of MESH24: the
    reference's train step computes them, the port's loss does not."""
    seq, batch, _ = refscript.DRYRUN_TINY_SHAPES["train_4k"]
    (data, model), _ = MESH24
    return 3 * 2 * (batch // data) * cfg.d_model * (cfg.padded_vocab // model)


def _attn_layers(cfg) -> int:
    return cfg.n_groups * sum(k == "attn" for k, _ in cfg.layer_kinds())


def _micro(arch, kind) -> int:
    return dryrun.train_recipe(arch).microbatches if kind == "train" else 1


def pv_split(arch, cfg, shape) -> int:
    """The FLOPs by which B7's P·V products on whole heads exceed the
    reference's on one rank of MESH24 (m ``model`` lanes), where GQA query
    heads do not divide m: the reference runs the H heads in g = gcd(H, m)
    groups of H/g on m/g lanes each, its logits on whole heads and P·V on
    1/(m/g) of the head dim (its GQA repeats k and v); the port keeps B7
    on whole heads (its kernels take one head dim for q, k and v).  Each
    P·V product, 2·b·(H/g)·sq·skv·hd, costs the port (1 − g/m) of it more:
    one a layer in prefill, four a layer and microbatch in training (the
    forward, its recompute, and the backward's dV and dP)."""
    seq, batch, kind = refscript.DRYRUN_TINY_SHAPES[shape]
    (data, m), _ = MESH24
    h = cfg.n_heads
    if h % m == 0 or h == cfg.n_kv_heads or cfg.attn_kind == "mla":
        return 0
    g = math.gcd(h, m)
    micro = _micro(arch, kind)
    pv = 2 * (batch // data // micro) * (h // g) * seq * seq * cfg.head_dim
    products = {"train": 4 * micro, "prefill": 1, "decode": 0}[kind] * _attn_layers(cfg)
    return products * pv * (m - g) // m


def latent_backward(arch, cfg, shape) -> int:
    """The FLOPs by which the reference's backward of MLA's latent
    down-projections (``w_dq``, ``w_dkv``: d → q_lora + kv_lora + rope)
    exceeds the port's on one rank of MESH24: both split their forward
    over the m ``model`` lanes, but the reference computes the input
    gradient whole and the weight gradient on half of d_model, where the
    port's column split takes 1/m of each.  A layer and microbatch: one
    product 2·t·d·(q_lora + kv_lora + rope) times (1 − 1/m) + (1/2 − 1/m)
    (t a microbatch's tokens on the rank)."""
    seq, batch, kind = refscript.DRYRUN_TINY_SHAPES[shape]
    if kind != "train" or cfg.attn_kind != "mla":
        return 0
    (data, m), _ = MESH24
    micro = _micro(arch, kind)
    t = batch // data // micro * seq
    width = cfg.q_lora_rank + cfg.kv_lora_rank + cfg.qk_rope_dim
    one = 2 * t * cfg.d_model * width
    return _attn_layers(cfg) * micro * one * (3 * m - 4) // (2 * m)


@pytest.mark.parametrize("arch,shape,overrides", refscript.DRYRUN_TINY_CELLS,
                         ids=[cell_id(c) for c in refscript.DRYRUN_TINY_CELLS])
def test_tiny_flops_match_hlo_cost(runs, arch, shape, overrides):
    key = refscript.tiny_key(arch, shape, overrides)
    ref = runs["ref"]["tiny"][key]["flops_per_dev"]
    got = runs["tiny"][key]["flops_per_dev"]
    cfg = tiny_cfg(arch, overrides)
    accepted = pv_split(arch, cfg, shape) - latent_backward(arch, cfg, shape)
    assert abs(got - accepted - ref) <= 0.02 * ref
    named = head_last_position(cfg) if shape == "train_4k" else 0
    assert got + named - accepted == ref


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
        # B8 runs on the rank's ssm_heads / model heads.
        x = (batch // MESH24[0][0] // micro, seq, cfg.ssm_heads // MESH24[0][1], cfg.ssm_head_dim)
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
    """(``fn``'s FLOPs by ``torch.utils.flop_counter``, its plain VJP's
    FLOPs by the dry run's rule, its output).  The VJPs of the plain SSD
    and of one-row attention hold outer products, which the dry run (as
    ``hlo_cost``: XLA rewrites such a dot into a multiply) does not count
    and the flop counter does."""
    with FlopCounterMode(display=False) as fc:
        out = fn(*inputs)
    with FlopCounterMode(display=False) as fc_vjp:
        ops._plain_vjp("t", fn, inputs, [True] * len(inputs), torch.ones_like(out))
    with cost.Count(card=False) as c, c.measure():
        ops._plain_vjp("t", fn, inputs, [True] * len(inputs), torch.ones_like(out))
    assert c.flops <= fc_vjp.get_total_flops()
    return fc.get_total_flops(), c.flops, out


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


def test_outer_products_are_not_counted():
    """A product of the matmul family whose contraction has length 1 counts
    no FLOPs (XLA rewrites such a dot into an elementwise multiply); one
    of length 2 counts 2·m·n·k."""
    a, b = torch.ones((3, 1)), torch.ones((1, 4))
    with cost.Count(card=False) as c, c.measure():
        a @ b
        torch.bmm(a[None], b[None])
        torch.addmm(torch.ones((3, 4)), a, b)
        assert c.flops == 0
        torch.ones((3, 2)) @ torch.ones((2, 4))
    assert c.flops == 2 * 3 * 4 * 2


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


def test_table_rows():
    """``dryrun.table``: a row an ``ok`` record, the replication column a
    rank's FLOPs × chips / ``model_flops`` and its ratio to qwen3-8b's at
    the same shape, a parent run's FLOPs in brackets where they differ."""
    base = dict(mesh="2x2", status="ok", hbm_per_device_gb=1.0, bytes_per_dev=2.0,
                coll_bytes_per_dev=3.0, t_compute=0.5, t_memory=0.25, t_collective=0.125,
                bottleneck="compute", fits_h100_80gb=True, trace_s=0.5, model_flops=400.0)
    recs = [dict(base, arch="qwen3-8b", shape="train_4k", flops_per_dev=100.0),
            dict(base, arch="mamba2-1.3b", shape="train_4k", flops_per_dev=300.0),
            dict(base, arch="mamba2-1.3b", shape="long_500k", status="skipped")]
    parent = [dict(recs[1], flops_per_dev=600.0), recs[0]]
    rows = dryrun.table(recs, parent)
    assert rows[0] == dryrun.TABLE_HEAD and len(rows) == 4
    assert rows[2].split(" | ")[3] == "100" and rows[2].endswith("| 1.00 | 1.00 |")
    assert rows[3].split(" | ")[3] == "300 [600]" and rows[3].endswith("| 3.00 | 3.00 |")
