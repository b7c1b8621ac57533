"""The LM stack over a mesh of gloo ranks on the CPU (``launch/mesh.py``,
``parallel/{collectives,compress,sharding}.py``, the layers' tensor,
expert and FSDP parallelism, the train step, elastic checkpoints) against
the reference and against the port's one-rank runs.

One spawn of 8 CPU ranks (``launch/ranks.py::run_cases``; the rank
functions live in ``tests/_torch_mesh_probe.py``) runs the cases on 8,
and one of 4 those on 4 (a mesh spans its spawn's world).  Beside them, the reference's
multi-device runs go in one subprocess with 8 forced host devices
(``tests/_torch_ref_script.py mesh``), and the one-rank runs and the
reference's one-device ``moe_apply`` in this process, all at once.

Tolerances:
* ``int8_all_to_all`` (both directions), ``shard_map_all_reduce``, the
  elastic restores: bit for bit (the reference's, or the gathered state);
* sharded MoE, output and aux: the reference's one-device ``moe_apply``
  at the reference's own mesh-vs-local bounds (rtol / atol 2e-3, aux rtol
  1e-3, tests/_dist_script.py), and without the int8 wire the port's
  one-rank route at 1e-5; at capacity factor 1.25, where each route drops
  copies by its own rule, the output the reference's own mesh run at
  2e-3 and, without the wire, the one-rank route with the mesh route's
  drops applied at 1e-5; under the int8 wire (its rounding is a
  different result by design) the reference's own a2a-int8 run on the
  same mesh at 2e-3 but for elements at an int8 rounding midpoint
  (``assert_int8_close``); the gradients of Σ y·w + aux the reference's
  mesh run, likewise;
* the FSDP + TP train steps (loss, gradient norm, parameters after two
  updates, lr 1e-3): the one-rank step, losses at rtol 1e-5 (1e-4 with
  compress_grads, the gradient norm 1e-4 and 1e-3) and parameters at
  rtol 1e-4 / atol 2e-3 — AdamW's first
  updates divide each gradient by its own magnitude, so a gradient near 0
  that rounds otherwise (or, compressed, lands in the next int8 step)
  moves its parameter by up to lr; the layers computed on their shards
  (MLA, Mamba-2, whisper's encoder and cross-attention, GQA whose heads do
  not divide ``model``) on (data 1, model 4), the reference's parameters
  carried in by ``params_from_jax(..., pctx=)``: the same, and their
  greedy generation's logits within 1e-5 and tokens exactly, each rank's
  cache holding its share.
"""
import concurrent.futures
import functools
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_mesh_probe as probe  # noqa: E402
import _torch_ref_script as refscript  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.parallel import api as jpar  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.parallel import api as tpar  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
MESH24 = ((2, 4), ("data", "model"))
MESH22 = ((2, 2), ("data", "model"))
OPT = dict(lr=1e-3, warmup=1)
TRAIN = {"adamw": (dict(fsdp=True), OPT),
         "adamw_compress": (dict(fsdp=True, compress_grads=True), OPT),
         "adafactor": (dict(fsdp=True), dict(OPT, name="adafactor"))}
TRAIN_STEPS = 3
# The layers computed on their shards: arch -> tiny() overrides (6 query
# heads and 2 kv heads on 4 ``model`` lanes: neither divides).
TP_ARCHS = {"minicpm3-4b": None, "mamba2-1.3b": None, "whisper-small": None,
            "deepseek-coder-33b": {"n_heads": 6, "n_kv_heads": 2}}
MESH14 = ((1, 4), ("data", "model"))
TP_GEN = 4


def tp_trees():
    """The reference's ``init_params(PRNGKey(0))`` of each ``TP_ARCHS``
    configuration, as numpy."""
    from repro.models import transformer as JT

    return {a: jax.tree_util.tree_map(np.asarray, JT.init_params(
        jconfigs.get_config(a).tiny(**(o or {})), jax.random.PRNGKey(0)))
        for a, o in TP_ARCHS.items()}


def tp_inputs(arch):
    """(train batch, prompts, frames for generation or None)."""
    batch = train_batch()
    frames = None
    if arch == "whisper-small":
        frames = np.random.default_rng(2).standard_normal((4, 16, 64)).astype(np.float32)
        batch["frames"] = frames
    prompts = np.random.default_rng(9).integers(0, 200, (2, 8)).astype(np.int64)
    return batch, prompts, None if frames is None else frames[:2]


def moe_params():
    cfg = jconfigs.get_config(probe.MOE_ARCH).tiny()
    p = JL.moe_init(cfg, jax.random.PRNGKey(0))
    flat = {"router": p["router"], "w1": p["w1"], "w3": p["w3"], "w2": p["w2"]}
    flat.update({f"shared.{k}": v for k, v in p.get("shared", {}).items()})
    return cfg, p, {k: np.asarray(v) for k, v in flat.items()}


def train_batch():
    return {"tokens": np.random.default_rng(1).integers(0, 100, (4, 16)).astype(np.int64)}


def one_rank_train(pctx_kw, opt_kw, arch=None, tree=None, batch=None):
    """The port's one-rank train steps from the same seed (or of tiny
    ``arch`` holding the reference's ``tree``, on ``batch``): (losses,
    gnorms, parameters).  With ``compress_grads`` the one-rank gradients
    go through the reference's ``compress_decompress`` before the update,
    as a mesh step applies it."""
    from repro_torch.models import transformer as TT
    from repro_torch.parallel import compress

    tcfg = tstep.TrainConfig(opt=topt.OptConfig(**opt_kw))
    if arch is None:
        cfg = tconfigs.get_config(probe.TRAIN_ARCH).tiny()
        state = tstep.make_train_state(cfg, tcfg, gen=0, device="cpu")
    else:
        cfg = probe.tp_cfg(arch, TP_ARCHS[arch])
        state = tstep.state_for(TT.params_from_jax(cfg, tree, device="cpu"), tcfg)
    batch = {k: torch.tensor(v) for k, v in (batch or train_batch()).items()}
    losses, gnorms = [], []
    for _ in range(TRAIN_STEPS):
        loss, grads = tstep._loss_and_grads(cfg, tcfg, state.params, batch)
        if pctx_kw.get("compress_grads"):
            grads = compress.compress_decompress(grads)
        _, opt, metrics = topt.apply_updates(tcfg.opt, grads, state.opt, state.params,
                                             state.step)
        state = tstep.TrainState(state.params, opt, state.step + 1)
        losses.append(float(loss))
        gnorms.append(float(metrics["gnorm"]))
    return losses, gnorms, {n: p.detach().numpy() for n, p in state.params.named_parameters()}


def _chip_smoke():
    """chip_smoke.py as a module (it imports nothing at module level but
    the standard library): its MoE drop rules are the card's references."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mesh_keep(name, topi):
    """The token-copies the mesh run of ``MOE_VARIANTS[name]`` keeps on
    (data 2, model 4), by chip_smoke.py's plain drop rules."""
    impl, _, b, cf = refscript.MOE_VARIANTS[name]
    route = "epsum" if impl == "epsum" else "a2a" if b % 2 == 0 else "a2a_replicated"
    cfg = tconfigs.get_config(probe.MOE_ARCH).tiny()
    return _chip_smoke().moe_mesh_keep(torch, topi, route, MESH24[0][0], cfg.n_experts,
                                       cf if cf is not None else cfg.capacity_factor)


def mesh_routes(name):
    """For a variant below the drop-free capacity: the one-rank route made
    to drop what its mesh route drops (chip_smoke.py's ``masked_routes``),
    as the card's references are; else None."""
    from repro_torch.models import layers as TL

    if refscript.MOE_VARIANTS[name][3] is None:
        return None
    return _chip_smoke().masked_routes(torch, TL, functools.partial(mesh_keep, name))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    ref_out = tmp / "reference.npz"
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_ref_script.py"),
                             "mesh", str(ref_out)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        cfg, p, p_np = moe_params()
        x, w = refscript.moe_inputs(cfg, cfg.d_model)
        a2a_x, a2a_dy, leaf = refscript.a2a_inputs()
        each = np.random.default_rng(11).standard_normal((WORLD, 32, 16)).astype(np.float32)
        blocks = lambda a: a.reshape(WORLD, -1, *a.shape[1:])  # noqa: E731
        cases = {"facts": ranks.Case(probe.mesh_facts, 8, MESH24),
                 "a2a": ranks.Case(probe.int8_a2a, 8, (blocks(a2a_x), blocks(a2a_dy))),
                 "allreduce": ranks.Case(probe.int8_allreduce, 8, (leaf, each)),
                 "coll": ranks.Case(probe.collectives_grad, 8,
                                    (np.random.default_rng(5).standard_normal(
                                        (WORLD, 3, 8)).astype(np.float32),))}
        for name, (impl, int8, b, cf) in refscript.MOE_VARIANTS.items():
            cases[f"moe/{name}"] = ranks.Case(probe.moe_rank, 8, (*MESH24, impl, int8, p_np,
                                                                   x[:b], w[:b], cf))
        cases["elastic"] = ranks.Case(probe.elastic_rank, 8, (str(tmp / "elastic"),))
        prompts = np.random.default_rng(9).integers(0, 200, (4, 8)).astype(np.int64)
        cases["serve_tp"] = ranks.Case(probe.serve_tp_rank, 8, (probe.TRAIN_ARCH, prompts, 5))
        # A mesh spans its spawn's world: the 4-rank cases get a spawn of 4.
        ck = str(tmp / "ckpt")
        cases4 = {f"train/{name}": ranks.Case(
            probe.train_rank, 4, (*MESH22, pkw, okw, train_batch(), TRAIN_STEPS,
                                  ck if name == "adamw" else None))
            for name, (pkw, okw) in TRAIN.items()}
        cases4["restore"] = ranks.Case(probe.restore_rank, 4, ((4, 1), ("data", "model"),
                                                                TRAIN["adamw"][0], OPT, ck))
        trees = tp_trees()
        for arch, over in TP_ARCHS.items():
            batch, prompts_tp, frames = tp_inputs(arch)
            cases4[f"tp_train/{arch}"] = ranks.Case(
                probe.tp_train_rank, 4, (*MESH14, arch, over, trees[arch], batch, TRAIN_STEPS,
                                         OPT))
            cases4[f"tp_serve/{arch}"] = ranks.Case(
                probe.tp_serve_rank, 4, (*MESH14, arch, over, trees[arch], prompts_tp, TP_GEN,
                                         frames))
        timing: dict = {}
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            fut = pool.submit(ranks.run_cases, list(cases.values()), WORLD, device="cpu",
                              timeout=300, timing=timing)
            fut4 = pool.submit(ranks.run_cases, list(cases4.values()), 4, device="cpu",
                               timeout=300)
            one = {"serve": probe.serve_one_rank(probe.TRAIN_ARCH, prompts, 5),
                   "moe_router": p_np["router"],
                   "moe": {name: probe.moe_one_rank(p_np, x[:b], w[:b], mesh_routes(name))
                           for name, (_, _, b, _) in refscript.MOE_VARIANTS.items()},
                   "train": {name: one_rank_train(*kw) for name, kw in TRAIN.items()}}
            for arch, over in TP_ARCHS.items():
                batch, prompts_tp, frames = tp_inputs(arch)
                one[f"tp_train/{arch}"] = one_rank_train(TRAIN["adamw"][0], OPT, arch,
                                                         trees[arch], batch)
                one[f"tp_serve/{arch}"] = probe.tp_serve_one_rank(arch, over, trees[arch],
                                                                  prompts_tp, TP_GEN, frames)
            local = {}
            jcfg = jconfigs.get_config(probe.MOE_ARCH).tiny()
            with jpar.use(jpar.ParallelCtx(mesh=None)):
                for b in (1, 4):
                    y, aux = JL.moe_apply(jcfg, p, x[:b])
                    local[b] = (np.asarray(y), float(aux))
            res = dict(zip(cases, fut.result())) | dict(zip(cases4, fut4.result()))
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
    with np.load(ref_out) as z:
        ref = dict(z)
    return {"res": res, "ref": ref, "one": one, "local": local, "timing": timing,
            "inputs": dict(a2a=(a2a_x, a2a_dy), leaf=leaf, each=each), "ckpt": ck}


def test_mesh_layout_and_backend(runs):
    """Rank r sits at (r // 4, r % 4) of (data 2, model 4), row-major as
    jax lays devices out; each axis's group is the ranks that differ on
    it alone; on the CPU the backend is gloo and nothing stages."""
    facts = runs["res"]["facts"]
    assert runs["timing"]["backend"] == "gloo"
    for r, f in enumerate(facts):
        assert f["coords"] == {"data": r // 4, "model": r % 4}
        assert f["groups"] == {"data": [r % 4, 4 + r % 4],
                               "model": [4 * (r // 4) + i for i in range(4)]}
        assert f["backend"] == "gloo" and not f["staged"]
        assert f["index_pod_data"] == r // 4


def test_int8_all_to_all_equals_the_reference(runs):
    """``int8_all_to_all`` over 8 lanes, forward and backward: the
    reference's bit for bit; the plain ``all_to_all`` is the block
    transpose."""
    ref, res = runs["ref"], runs["res"]["a2a"]
    y = np.concatenate([r[0][0] for r in res])
    dx = np.concatenate([r[0][1] for r in res])
    np.testing.assert_array_equal(y, ref["a2a/y"])
    np.testing.assert_array_equal(dx, ref["a2a/dx"])
    x, dy = runs["inputs"]["a2a"]
    xb, dyb = x.reshape(8, 8, 3, 16), dy.reshape(8, 8, 3, 16)
    for r, rec in enumerate(res):
        np.testing.assert_array_equal(rec[1][0], xb[:, r])
        np.testing.assert_array_equal(rec[1][1], dyb[:, r])
    assert np.abs(y - x.reshape(8, 8, 3, 16).transpose(1, 0, 2, 3).reshape(x.shape)).max() > 0


def test_shard_map_all_reduce(runs):
    """The same leaf on every lane: the reference's output bit for bit;
    a different leaf on each: Σ int8 values (int32) · max scale / n, as
    the reference's island computes it (in NumPy, true divisions)."""
    ref, res = runs["ref"], runs["res"]["allreduce"]
    for r in res:
        np.testing.assert_array_equal(r[0], ref["allreduce/same"])
    each = runs["inputs"]["each"]
    absmax = np.abs(each).max(axis=(1, 2)) + np.float32(1e-12)
    scale = (absmax / np.float32(127.0)).astype(np.float32)
    q = np.clip(np.round(each / scale[:, None, None]), -127, 127).astype(np.int32)
    want = (q.sum(0).astype(np.float32) * scale.max()) / np.float32(8)
    for r in res:
        np.testing.assert_array_equal(r[1], want.astype(np.float32))


def test_collectives_are_exact_transposes(runs):
    """all_gather / reduce_scatter / all_reduce over ``model`` (4 ranks of
    (2, 4)) and their backward passes: reduce-scatter, all-gather and
    all-reduce of the ranks' cotangents (each rank's loss weighted by
    rank + 1)."""
    xs = np.random.default_rng(5).standard_normal((WORLD, 3, 8)).astype(np.float32)
    res = runs["res"]["coll"]
    for r, rec in enumerate(res):
        grp = [4 * (r // 4) + i for i in range(4)]
        lane = r % 4
        wsum = float(sum(g + 1 for g in grp))
        np.testing.assert_array_equal(rec["all_gather"][0], np.concatenate(xs[grp], axis=1))
        np.testing.assert_allclose(rec["all_gather"][1], np.full((3, 8), wsum), rtol=0)
        tot = xs[grp].sum(0)
        np.testing.assert_allclose(rec["reduce_scatter"][0], tot[:, lane * 2:(lane + 1) * 2],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rec["reduce_scatter"][1],
                                   np.repeat(np.array([g + 1.0 for g in grp]), 2)[None]
                                   .repeat(3, 0), rtol=0)
        np.testing.assert_allclose(rec["all_reduce"][0], tot, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rec["all_reduce"][1], np.full((3, 8), wsum), rtol=0)


@pytest.mark.parametrize("name", list(refscript.MOE_VARIANTS))
def test_moe_sharded(runs, name):
    """``moe_apply`` on (data 2, model 4): the route the reference takes,
    the output and aux (and with the int8 wire, the reference's own mesh
    run), the gradients against the reference's mesh run.  At capacity
    factor 1.25 the routes drop token-copies, each by its own rule, so the
    output is held to the reference's own mesh run and to the port's
    one-rank route with that mesh route's drops (chip_smoke.py's plain
    rules, which the card's gates use), and the drops must be there and
    matter."""
    impl, int8, b, cf = refscript.MOE_VARIANTS[name]
    ref = runs["ref"]
    recs = runs["res"][f"moe/{name}"]
    route, y, aux, dx, dp = recs[0]
    assert route == impl
    for rec in recs[1:]:
        np.testing.assert_array_equal(rec[1], y)
    y_loc, aux_loc = runs["local"][b]
    if cf is not None:
        cfg = tconfigs.get_config(probe.MOE_ARCH).tiny()
        router = torch.tensor(runs["one"]["moe_router"])
        x = torch.tensor(refscript.moe_inputs(cfg, cfg.d_model)[0][:b]).reshape(-1, cfg.d_model)
        topi = torch.sort(x @ router, dim=-1, descending=True,
                          stable=True)[1][:, :cfg.topk]
        assert (~mesh_keep(name, topi)).sum() > 0
        assert np.abs(y - y_loc).max() > 1e-2
    if int8:
        assert_int8_close(y, ref[f"moe/{name}/y"])
    else:
        if cf is None:
            np.testing.assert_allclose(y, y_loc, rtol=2e-3, atol=2e-3)
        else:
            np.testing.assert_allclose(y, ref[f"moe/{name}/y"], rtol=2e-3, atol=2e-3)
        y1, aux1, dx1, dp1 = runs["one"]["moe"][name]
        np.testing.assert_allclose(y, y1, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux, aux1, rtol=1e-5)
    np.testing.assert_allclose(aux, aux_loc, rtol=1e-3)
    np.testing.assert_allclose(aux, float(ref[f"moe/{name}/aux"]), rtol=1e-3)
    close = assert_int8_close if int8 else functools.partial(
        np.testing.assert_allclose, rtol=2e-3, atol=2e-3)
    close(dx, ref[f"moe/{name}/dx"])
    for k, g in dp.items():
        close(g, ref[f"moe/{name}/d/{k}"], err_msg=k)


def assert_int8_close(got, want, err_msg=""):
    """Within rtol / atol 2e-3 of the reference's int8-wire run, but for
    rows whose wire rounding lands on the other int8 step: the port's and
    the reference's float32 partial sums differ in their last bits, and an
    element at a rounding midpoint then moves by one quantum (its row's
    absmax / 127, under 1 % of the largest value).  At most 0.1 % of the
    elements may do so."""
    got, want = np.asarray(got), np.asarray(want)
    off = np.abs(got - want) > 2e-3 + 2e-3 * np.abs(want)
    assert off.mean() <= 1e-3, (err_msg, off.sum(), off.size)
    assert np.all(np.abs(got - want)[off] <= 1e-2 * np.abs(want).max()), err_msg


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_fsdp_tp(runs, name):
    """Tiny qwen3-8b on (data 2, model 2), FSDP: three steps (AdamW, AdamW
    with compress_grads, Adafactor) held to the one-rank steps from the
    same seed on the same batch: losses, gradient norms, parameters."""
    losses, gnorms, full = runs["res"][f"train/{name}"][0]
    want_l, want_g, want_p = runs["one"]["train"][name]
    np.testing.assert_allclose(losses, want_l, rtol=1e-4 if "compress" in name else 1e-5)
    np.testing.assert_allclose(gnorms, want_g, rtol=1e-3 if "compress" in name else 1e-4)
    assert losses[-1] < losses[0]
    assert set(full) == set(want_p)
    for k in want_p:
        np.testing.assert_allclose(full[k], want_p[k], rtol=1e-4, atol=2e-3, err_msg=k)
    for rec in runs["res"][f"train/{name}"][1:]:
        assert rec[0] == losses


def test_elastic_restore(runs):
    """The (2, 2) FSDP state saved from 4 ranks restores onto (4, 1) bit for
    bit (parameters, AdamW moments, step; wq now (data 4, model 1)); the
    reference's ``restore`` reads the same checkpoint; an (8, 8) leaf saved
    from 8 ``data`` lanes restores onto (4, 2) as ("model", "data"), as the
    reference's elastic check does."""
    saved = runs["res"]["train/adamw"][0][2]
    for params, moments, step, spec in runs["res"]["restore"]:
        assert step == TRAIN_STEPS and spec == ("data", "model")
        for k in saved:
            np.testing.assert_array_equal(params[k], saved[k], err_msg=k)
        assert len(moments) > 2 * len(saved) // 2
    jcfg = jconfigs.get_config(probe.TRAIN_ARCH).tiny()
    from repro.train import step as jstep
    like = jax.eval_shape(lambda: jstep.make_train_state(jcfg, jstep.TrainConfig()))
    restored, manifest = jck.restore(runs["ckpt"], like)
    assert manifest["step"] == TRAIN_STEPS and int(restored.step) == TRAIN_STEPS
    np.testing.assert_array_equal(np.asarray(restored.params["embed"]), saved["embed"])
    np.testing.assert_array_equal(np.asarray(restored.params["blocks"]["l0"]["mixer"]["wq"][0]),
                                  saved["blocks.0.l0.mixer.wq"])
    x = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for mine, box, spec, whole in runs["res"]["elastic"]:
        assert spec == ("model", "data")
        np.testing.assert_array_equal(mine, x[box[0][0]:box[0][1], box[1][0]:box[1][1]])
        np.testing.assert_array_equal(whole, x)


def test_quant_rows_is_the_compiled_reference():
    """The port's ``_quant_rows`` equals the reference's as XLA compiles it
    (absmax · float32(1/127)), bit for bit, scales and int8 values; the
    reference run eagerly divides truly, which differs in some scales."""
    from repro.parallel import compress as jcomp
    from repro_torch.parallel import compress as tcomp

    x, _, _ = refscript.a2a_inputs()
    x = x.reshape(-1, 16)
    q, s = jax.jit(jcomp._quant_rows)(x)
    tq, ts = tcomp._quant_rows(torch.tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    eager = np.asarray(jcomp._quant_rows(jax.numpy.asarray(x))[1])
    assert not np.array_equal(eager, np.asarray(s))


def test_b9_int8_is_quant_rows_on_the_send_buffer():
    """B9's int8 mode (``ops.dispatch_gather(..., quant=True)``; its plain
    version here) on a send buffer with whole −1 lanes: the int8 rows and
    scales of the reference's ``_quant_rows`` run eagerly (a true division,
    as the Pallas body) on each valid row, and an empty row dequantises to
    0 (scale 0 against the reference's 1e-12 over q = 0)."""
    from repro.parallel import compress as jcomp
    from repro_torch.kernels import ops

    x, _, _ = refscript.a2a_inputs()
    x = torch.tensor(x.reshape(-1, 16)[:40])
    idx = torch.full((4 * 16,), -1, dtype=torch.int32)
    idx[:16] = torch.arange(16)          # lane 0 full, lane 1 empty
    idx[32:40] = torch.arange(20, 28)    # lane 2 half
    q, s = ops.dispatch_gather(x, idx, quant=True)
    valid = idx >= 0
    rows = x[idx.clamp(0).long()]
    jq, js = jcomp._quant_rows(jax.numpy.asarray(rows.numpy()))
    np.testing.assert_array_equal(q.numpy()[valid.numpy()], np.asarray(jq)[valid.numpy()])
    np.testing.assert_array_equal(s.numpy()[valid.numpy()], np.asarray(js)[valid.numpy(), 0])
    assert (q[~valid] == 0).all() and (s[~valid] == 0).all()
    deq = q.float() * s[:, None]
    assert (deq[16:32] == 0).all()


@pytest.mark.parametrize("requests,temperature", [(3, 0.0), (4, 1.0)])
def test_serve_lm_mesh_devices_2(capsys, requests, temperature):
    """``serve_lm`` with ``--mesh-devices 2``: 3 greedy requests, which do
    not split over 2 lanes, so each rank generates for all of them
    (replicated, as the reference's constrain falls back); and 4 sampled
    at temperature 1, split, each rank drawing for the whole batch and
    keeping its rows.  The tokens equal the one-process run's exactly."""
    import argparse

    from repro_torch.launch import serve as tserve

    ns = dict(arch="qwen3-8b", tiny=True, requests=requests, prompt_len=8, gen=4,
              temperature=temperature, seed=2, device="cpu")
    want = tserve.serve_lm(argparse.Namespace(**ns, mesh_devices=0))
    got = tserve.serve_lm(argparse.Namespace(**ns, mesh_devices=2))
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert torch.equal(got, want) and lines[-1]["ranks"] == 2
    if temperature:
        # The draws are not the greedy tokens.
        greedy = tserve.serve_lm(argparse.Namespace(**ns | {"temperature": 0.0},
                                                    mesh_devices=0))
        assert not torch.equal(greedy, want)


def test_backend_rule(monkeypatch):
    """NCCL when each rank has a card of its own, gloo when ranks share a
    card or run on the CPU."""
    from repro_torch.launch import mesh as tmesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.choose_backend(4, "cuda") == "nccl"
    assert tmesh.choose_backend(1, "cuda") == "nccl"
    assert tmesh.choose_backend(8, "cuda") == "gloo"
    assert tmesh.choose_backend(2, "cpu") == "gloo"


def test_compress_decompress_takes_a_stack_whole():
    """``compress_decompress`` of a ``Stack`` (a block leaf held a group at a
    time) quantises the stacked leaf with one absmax, as the reference's
    ``compress_decompress`` does its stacked array: bit for bit; and the
    train step's whole-leaf form (``_compress_whole``) off a mesh agrees."""
    from repro.parallel import compress as jcomp
    from repro_torch.models.tree import Stack
    from repro_torch.parallel import compress as tcomp

    rng = np.random.default_rng(4)
    groups = [rng.standard_normal((8, 8)).astype(np.float32) * s for s in (0.1, 3.0)]
    want = np.asarray(jcomp.compress_decompress({"w": jax.numpy.asarray(np.stack(groups))})["w"])
    got = tcomp.compress_decompress({"w": Stack(torch.tensor(g) for g in groups)})["w"]
    np.testing.assert_array_equal(torch.stack(list(got)).numpy(), want)
    whole = tstep._compress_whole({"w": Stack(torch.tensor(g) for g in groups)}, [()], None)
    np.testing.assert_array_equal(torch.stack(list(whole["w"])).numpy(), want)


def test_greedy_generate_tensor_parallel(runs):
    """Tiny qwen3-8b generating over (data 4, model 2) with its parameters
    sharded: each rank's cache holds its kv heads (2 of 4), the prefill's
    logits are the one-rank run's within 1e-5 and the greedy tokens
    exactly."""
    want_toks, want_logits = runs["one"]["serve"]
    for toks, logits, kv in runs["res"]["serve_tp"]:
        np.testing.assert_array_equal(toks, want_toks)
        np.testing.assert_allclose(logits, want_logits, rtol=1e-5, atol=1e-5)
        cfg = tconfigs.get_config(probe.TRAIN_ARCH).tiny()
        assert kv[2] == cfg.n_kv_heads // 2


@pytest.mark.parametrize("arch", list(TP_ARCHS))
def test_tp_train_step(runs, arch):
    """Tiny MLA, Mamba-2, whisper and (6, 2)-head GQA on (data 1, model 4),
    FSDP, each layer computed on its shards, the reference's parameters
    carried in: three AdamW steps held to the one-rank steps (losses,
    gradient norms, parameters after) as ``test_train_step_fsdp_tp``."""
    recs = runs["res"][f"tp_train/{arch}"]
    losses, gnorms, full = recs[0]
    want_l, want_g, want_p = runs["one"][f"tp_train/{arch}"]
    np.testing.assert_allclose(losses, want_l, rtol=1e-5)
    np.testing.assert_allclose(gnorms, want_g, rtol=1e-4)
    assert losses[-1] < losses[0]
    assert set(full) == set(want_p)
    for k in want_p:
        np.testing.assert_allclose(full[k], want_p[k], rtol=1e-4, atol=2e-3, err_msg=k)
    for rec in recs[1:]:
        assert rec[0] == losses


@pytest.mark.parametrize("arch", list(TP_ARCHS))
def test_tp_greedy_generate(runs, arch):
    """The same configurations generating over (data 1, model 4): every
    step's logits the one-rank run's within 1e-5 and the greedy tokens
    exactly; each rank's prefill cache holds its share of the one-rank
    cache: Mamba's conv its channels (x of its heads, its 1/4 of B and C)
    and ssm its heads, the cross-attention's xk / xv and the GQA k / v the
    kv heads its query heads read, MLA's latent cache whole; every B7 /
    B8 input has a unit-stride last axis, as the card's kernels need."""
    from repro_torch.models import layers as TL

    cfg = probe.tp_cfg(arch, TP_ARCHS[arch])
    want_toks, want_logits, want_cache = runs["one"][f"tp_serve/{arch}"]
    m, lanes = MESH14[0][1], set()
    for toks, logits, cache, lane, strides in runs["res"][f"tp_serve/{arch}"]:
        lanes.add(lane)
        assert strides == {1}, strides
        np.testing.assert_array_equal(toks, want_toks)
        for got, want in zip(logits, want_logits, strict=True):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        share = {}
        if arch == "mamba2-1.3b":
            _, conv = TL._mamba_cols(cfg, m, lane, "cpu")
            hl = cfg.ssm_heads // m
            share = {"conv": want_cache["conv"][..., conv.numpy()],
                     "ssm": want_cache["ssm"][:, lane * hl:(lane + 1) * hl]}
        elif cfg.attn_kind == "mla":
            share = {"ckv": want_cache["ckv"], "kr": want_cache["kr"]}
        else:
            kv = TL.heads_at(cfg.n_heads, cfg.n_kv_heads, cfg.n_heads * cfg.head_dim, m,
                             lane).kv
            names = ("k", "v", "xk", "xv") if cfg.encoder_layers else ("k", "v")
            share = {n: want_cache[n][:, list(kv)] for n in names}
            assert len(kv) < cfg.n_kv_heads
        assert set(share) == set(cache)
        for name, want in share.items():
            assert cache[name].shape == want.shape, name
            np.testing.assert_allclose(cache[name], want, rtol=1e-5, atol=1e-5, err_msg=name)
    assert lanes == set(range(m))
