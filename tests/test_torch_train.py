"""The port's training modules against the reference package's, on the CPU:
``repro_torch.train.optimizer`` (adamw, sgdm, adafactor factored and
unfactored, the bf16 neighbour and stochastic rounding), the int8
gradient compression of ``repro_torch.parallel.compress``,
``repro_torch.train.checkpoint`` (the reference's ``tests/test_checkpoint.
py`` cases, and checkpoints written by one package restored by the other),
``repro_torch.train.step.build_train_step`` (one step of tiny qwen3-8b,
one and two microbatches) and ``repro_torch.launch.train`` (given the
reference's initial state).  ``tests/test_optimizer.py``'s cases are
mirrored on the port.  Inputs are made with numpy; the reference's
``jax.random`` draws (parameters, stochastic rounding's uniforms) are
handed to the port.

Tolerances, and why:
- the optimizer over 5 steps: rtol 1e-6, atol 1e-7.  The same float32
  operations in the same order; ``pow``, ``sqrt`` and the global norm's
  sum may round differently in the last place.
- the bf16 neighbour, stochastic rounding given the same uniforms, int8
  compression, checkpoints: bit for bit.
- one train step of tiny qwen3-8b (loss, new parameters, AdamW moments):
  rtol 1e-5, atol 1e-6, as the forward (tests/test_torch_models.py).
- ``launch/train``'s losses: 1e-5 against the reference; a resumed
  run against an uninterrupted one: 1e-6.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.parallel import api as jpar  # noqa: E402
from repro.parallel import compress as jcompress  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.tree import Stack, flatten  # noqa: E402
from repro_torch.parallel import api as tpar  # noqa: E402
from repro_torch.parallel import compress as tcompress  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

OPT_TOL = dict(rtol=1e-6, atol=1e-7)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(t):
    if isinstance(t, Stack):
        t = torch.stack(list(t))
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _flat_np(tree):
    return {"/".join(p): _np(leaf) for p, leaf in flatten(tree)}


def _jflat(tree):
    def part(k):
        return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
    return {"/".join(part(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got: dict, want: dict, **tol):
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


# -- optimizer against the reference ------------------------------------------


def _opt_params(rng):
    """A 1-D, a 2-D and a stacked (3 groups of 5 x 6) leaf; the port holds
    the stacked one a group at a time."""
    return {"b": rng.normal(size=(8,)).astype(np.float32),
            "blocks": {"w1": rng.normal(size=(3, 5, 6)).astype(np.float32)},
            "w": rng.normal(size=(4, 8)).astype(np.float32)}


def _port_tree(arrays):
    out = {"b": torch.as_tensor(arrays["b"].copy()), "w": torch.as_tensor(arrays["w"].copy()),
           "blocks": {"w1": Stack(torch.as_tensor(a.copy()) for a in arrays["blocks"]["w1"])}}
    return out


@pytest.mark.parametrize("name,threshold", [("adamw", 2), ("sgdm", 2), ("adafactor", 2),
                                            ("adafactor", 4)])
def test_optimizer_equals_the_reference(name, threshold):
    """5 steps on the same parameters and gradients; adafactor factored
    (threshold 2: the 2-D and stacked leaves) and unfactored (4)."""
    rng = np.random.default_rng(0)
    arrays = _opt_params(rng)
    cfg = dict(name=name, lr=0.05, warmup=2, decay_steps=6, factored_threshold=threshold,
               clip_norm=3.0)
    jcfg, tcfg = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, arrays)
    js = jopt.init_state(jcfg, jp)
    tp = _port_tree(arrays)
    ts = topt.init_state(tcfg, tp)
    for step in range(5):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), arrays)
        jp, js, jm = jopt.apply_updates(jcfg, jax.tree.map(jnp.asarray, grads), js, jp, step)
        tp, ts, tm = topt.apply_updates(tcfg, _port_tree(grads), ts, tp,
                                        torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]), **OPT_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **OPT_TOL)
    _close(_flat_np(tp), _jflat(jp), **OPT_TOL)
    _close(_flat_np(ts), _jflat(js), **OPT_TOL)


def _bf16_cases():
    """bf16 bit patterns: ±0, the smallest subnormals, normals, the largest
    finite, as uint16."""
    bits = [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x0080, 0x3F80, 0xBF80, 0x3F81, 0x4049,
            0xC049, 0x7F7F, 0xFF7F, 0x0100, 0x8100]
    return np.array(bits, np.uint16)


@pytest.mark.parametrize("toward_up", [True, False])
def test_bf16_neighbor_bit_for_bit(toward_up):
    bits = _bf16_cases()
    want = jopt._bf16_neighbor(jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16),
                               jnp.full(bits.shape, toward_up))
    down = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    got = topt._bf16_neighbor(down, torch.full(bits.shape, toward_up))
    want_bits = np.asarray(jax.lax.bitcast_convert_type(want, jnp.uint16))
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), want_bits)


def test_stochastic_rounding_bit_for_bit_given_the_uniforms():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(size=500) * 10.0 ** rng.integers(-6, 4, 500),
                        [0.0, -0.0, 1e-40, -1e-40, 1.0, 3.0]]).astype(np.float32)
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, x.shape))
    want = jopt._stochastic_round_to(jnp.asarray(x), jnp.bfloat16, key)
    got = topt._stochastic_round_to(torch.as_tensor(x), torch.bfloat16, torch.as_tensor(u))
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(jax.lax.bitcast_convert_type(want, jnp.uint16)))
    # A generator's draws: each value lands on one of its two bf16 neighbours.
    xt = torch.as_tensor(x)
    g = topt._stochastic_round_to(xt, torch.bfloat16, torch.Generator().manual_seed(0))
    down = xt.bfloat16()
    other = topt._bf16_neighbor(down, xt > down.float())
    assert bool(((g.view(torch.int16) == down.view(torch.int16))
                 | (g.view(torch.int16) == other.view(torch.int16))).all())


def test_adafactor_stochastic_rounding_equals_the_reference_given_the_uniforms():
    rng = np.random.default_rng(2)
    cfg = dict(name="adafactor", lr=1e-3, warmup=0, schedule="const", stochastic_rounding=True,
               weight_decay=0.0)
    w = rng.normal(size=(2, 16, 8)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    tp = {"w": Stack(torch.as_tensor(a).bfloat16() for a in w)}
    js, ts = jopt.init_state(jopt.OptConfig(**cfg), jp), topt.init_state(topt.OptConfig(**cfg),
                                                                         tp)
    for step in range(3):
        g = rng.normal(size=w.shape).astype(np.float32)
        key = jax.random.PRNGKey(step)
        u = [torch.as_tensor(np.array(jax.random.uniform(k, w.shape)))
             for k in jax.random.split(key, 1)]
        jp, js, _ = jopt.apply_updates(jopt.OptConfig(**cfg), {"w": jnp.asarray(g)}, js, jp,
                                       step, key=key)
        tp, ts, _ = topt.apply_updates(topt.OptConfig(**cfg),
                                       {"w": Stack(torch.as_tensor(a) for a in g)}, ts, tp,
                                       step, key=u)
    got = torch.stack(list(tp["w"])).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, np.asarray(jax.lax.bitcast_convert_type(jp["w"], jnp.uint16)))


# -- tests/test_optimizer.py's cases, on the port --------------------------------


def _quad_grads(p):
    return {"w": p["w"] - 3.0, "b": p["b"] + 1.0}


def _quad_loss(p):
    return float(0.5 * ((p["w"] - 3.0) ** 2).sum() + 0.5 * ((p["b"] + 1.0) ** 2).sum())


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_converges_on_quadratic(name):
    cfg = topt.OptConfig(name=name, lr=0.1, warmup=0, schedule="const", weight_decay=0.0,
                         clip_norm=100.0)
    params = {"w": torch.zeros((4, 8)), "b": torch.zeros((8,))}
    state = topt.init_state(cfg, params)
    for step in range(200):
        params, state, _ = topt.apply_updates(cfg, _quad_grads(params), state, params, step)
    assert _quad_loss(params) < 0.05


def test_lr_schedule_shapes():
    cfg = topt.OptConfig(lr=1.0, warmup=10, decay_steps=100, schedule="cosine",
                         min_lr_frac=0.1)
    assert float(topt.lr_at(cfg, 0)) == 0.0
    assert abs(float(topt.lr_at(cfg, 10)) - 1.0) < 1e-6
    assert abs(float(topt.lr_at(cfg, 100)) - 0.1) < 1e-3
    mid = float(topt.lr_at(cfg, 55))
    assert 0.1 < mid < 1.0
    for schedule in ("cosine", "linear", "const"):
        c = topt.OptConfig(lr=0.5, warmup=3, decay_steps=9, schedule=schedule)
        jc = jopt.OptConfig(lr=0.5, warmup=3, decay_steps=9, schedule=schedule)
        for s in range(12):
            np.testing.assert_allclose(float(topt.lr_at(c, s)), float(jopt.lr_at(jc, s)),
                                       rtol=1e-6)


def test_grad_clipping():
    tree = {"a": torch.full((10,), 100.0)}
    clipped, gnorm = topt.clip_by_norm(tree, 1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert float(gnorm) > 100


def test_adafactor_state_is_factored():
    cfg = topt.OptConfig(name="adafactor")
    params = {"big": torch.zeros((64, 32)), "vec": torch.zeros((16,)),
              "stacked": Stack(torch.zeros(16) for _ in range(3))}
    state = topt.init_state(cfg, params)
    assert state["f"]["big"]["vr"].shape == (64,)
    assert state["f"]["big"]["vc"].shape == (32,)
    assert state["f"]["vec"]["v"].shape == (16,)
    # a stacked 1-D leaf is 2-D in the reference: factored over the groups
    assert state["f"]["stacked"]["vr"].shape == (3,)
    assert state["f"]["stacked"]["vc"].shape == (16,)
    n_state = sum(x.numel() for x in (l for _, l in flatten(state)))
    assert n_state < 64 * 32


def test_adafactor_bf16_stochastic_rounding_moves_params():
    cfg = topt.OptConfig(name="adafactor", lr=1e-3, warmup=0, schedule="const",
                         stochastic_rounding=True, weight_decay=0.0)
    p = {"w": torch.ones((32, 32), dtype=torch.bfloat16)}
    state = topt.init_state(cfg, p)
    grads = {"w": torch.full((32, 32), 0.5)}
    for step in range(20):
        p, state, _ = topt.apply_updates(cfg, grads, state, p, step,
                                         key=torch.Generator().manual_seed(step))
    # lr*update ~1e-3 is below bf16 ulp at 1.0 (~0.0078): deterministic
    # rounding would freeze params; stochastic rounding must move them.
    assert float((p["w"].float() - 1.0).abs().mean()) > 1e-4
    assert p["w"].dtype == torch.bfloat16


def test_adamw_weight_decay_shrinks():
    cfg = topt.OptConfig(name="adamw", lr=0.1, warmup=0, schedule="const", weight_decay=0.5)
    params = {"w": torch.full((8,), 10.0)}
    state = topt.init_state(cfg, params)
    zeros = {"w": torch.zeros((8,))}
    for step in range(10):
        params, state, _ = topt.apply_updates(cfg, zeros, state, params, step)
    assert float(params["w"][0]) < 10.0


# -- int8 compression ------------------------------------------------------------


def test_compress_bit_for_bit():
    rng = np.random.default_rng(3)
    grads = {"a": (rng.normal(size=(7, 5)) * 1e-3).astype(np.float32),
             "b": [rng.normal(size=(13,)).astype(np.float32), np.zeros(4, np.float32)]}
    errors = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-5).astype(np.float32), grads)
    tg = {"a": torch.as_tensor(grads["a"]), "b": [torch.as_tensor(x) for x in grads["b"]]}
    te = {"a": torch.as_tensor(errors["a"]), "b": [torch.as_tensor(x) for x in errors["b"]]}
    q, s = tcompress.quantize_int8(tg["a"])
    jq, js = jcompress.quantize_int8(jnp.asarray(grads["a"]))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and float(s) == float(js)
    assert np.array_equal(tcompress.dequantize_int8(q, s).numpy(),
                          np.asarray(jcompress.dequantize_int8(jq, js)))
    want = jcompress.compress_decompress(jax.tree.map(jnp.asarray, grads))
    got = tcompress.compress_decompress(tg)
    assert np.array_equal(got["a"].numpy(), np.asarray(want["a"]))
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got["b"], want["b"]))
    jw, je = jcompress.ef_compress(jax.tree.map(jnp.asarray, grads),
                                   jax.tree.map(jnp.asarray, errors))
    tw, terr = tcompress.ef_compress(tg, te)
    for got_t, want_t in ((tw, jw), (terr, je)):
        assert np.array_equal(got_t["a"].numpy(), np.asarray(want_t["a"]))
        assert all(np.array_equal(g.numpy(), np.asarray(w))
                   for g, w in zip(got_t["b"], want_t["b"]))
    bf = torch.as_tensor(grads["a"]).bfloat16()
    want_bf = jcompress.compress_decompress(jnp.asarray(grads["a"], jnp.bfloat16))
    assert np.array_equal(tcompress.compress_decompress(bf).view(torch.int16).numpy(),
                          np.asarray(jax.lax.bitcast_convert_type(want_bf, jnp.int16)))


# -- checkpoints: tests/test_checkpoint.py's cases, and across the packages ------


def make_state(scale=1.0):
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4) * scale,
                   "blocks": {"l0": {"w1": torch.ones((2, 5)) * scale}}},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _jstate(scale=1.0):
    return {"params": {"w": jnp.arange(12.0).reshape(3, 4) * scale,
                       "blocks": {"l0": {"w1": jnp.ones((2, 5)) * scale}}},
            "step": jnp.asarray(7, jnp.int32)}


def _leaves_equal(a, b):
    fa, fb = _flat_np(a), _flat_np(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


def test_roundtrip(tmp_path):
    state = make_state()
    tck.save(str(tmp_path), state, step=7)
    restored, manifest = tck.restore(str(tmp_path), make_state(0.0))
    assert manifest["step"] == 7
    _leaves_equal(state, restored)


def test_latest_selected(tmp_path):
    tck.save(str(tmp_path), make_state(1.0), step=1)
    tck.save(str(tmp_path), make_state(2.0), step=2)
    restored, manifest = tck.restore(str(tmp_path), make_state())
    assert manifest["step"] == 2
    assert float(restored["params"]["w"][0, 1]) == 2.0


def test_restore_specific_step(tmp_path):
    tck.save(str(tmp_path), make_state(1.0), step=1)
    tck.save(str(tmp_path), make_state(2.0), step=2)
    restored, manifest = tck.restore(str(tmp_path), make_state(), step=1)
    assert manifest["step"] == 1


def test_no_tmp_dirs_left(tmp_path):
    tck.save(str(tmp_path), make_state(), step=3)
    assert not [d for d in os.listdir(tmp_path) if ".tmp" in d]


def test_manager_retention_and_async(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        mgr.save_async(make_state(float(s)), s)
    mgr.wait()
    assert tck.list_steps(str(tmp_path)) == [30, 40]
    assert mgr.latest_step() == 40


def test_manager_snapshots_at_the_call(tmp_path):
    """``save_async`` copies the state before it returns: an in-place
    update right after it (the next train step) does not reach the file."""
    mgr = tck.CheckpointManager(str(tmp_path))
    state = make_state(1.0)
    mgr.save_async(state, 1)
    state["params"]["w"].add_(5.0)
    state["params"]["blocks"]["l0"]["w1"].mul_(3.0)
    mgr.wait()
    restored, _ = tck.restore(str(tmp_path), make_state(0.0))
    _leaves_equal(restored, make_state(1.0))


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "nope"), make_state())


def test_extra_metadata(tmp_path):
    tck.save(str(tmp_path), make_state(), step=5, extra={"loss": 1.25})
    _, manifest = tck.restore(str(tmp_path), make_state())
    assert manifest["extra"]["loss"] == 1.25


def test_the_reference_restores_the_ports_checkpoint(tmp_path):
    """float32 and int32 leaves; the port's files and manifest are the
    reference's layout."""
    tck.save(str(tmp_path), make_state(1.5), step=4, extra={"x": 1})
    restored, manifest = jck.restore(str(tmp_path), jax.eval_shape(lambda: _jstate()))
    assert manifest["step"] == 4 and manifest["extra"] == {"x": 1}
    want = _jflat(_jstate(1.5))
    got = _jflat(restored)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    d = tmp_path / "step_0000000004"
    assert sorted(os.listdir(d)) == ["host_00000.npz", "manifest_00000.json"]
    leaves = json.loads((d / "manifest_00000.json").read_text())["leaves"]
    assert list(leaves) == ["params/blocks/l0/w1", "params/w", "step"]


def test_the_port_restores_the_references_checkpoint(tmp_path):
    jck.save(str(tmp_path), _jstate(2.5), step=9)
    restored, manifest = tck.restore(str(tmp_path), make_state())
    assert manifest["step"] == 9
    _leaves_equal(restored, make_state(2.5))


def test_bf16_and_stacked_leaves_round_trip(tmp_path):
    """A bf16 leaf as its uint16 bits ("dtype": "bfloat16"), a Stack as one
    stacked array, a module filled in place."""
    cfg = tconfigs.get_config("qwen3-8b").tiny()
    model = TT.init_params(cfg, 1, device="cpu", dtype=torch.bfloat16, trainable=True)
    state = {"model": model, "x": torch.tensor([1.5, -0.0, 3e-39]).bfloat16()}
    tck.save(str(tmp_path), state, step=2)
    manifest = json.loads((tmp_path / "step_0000000002" / "manifest_00000.json").read_text())
    assert manifest["leaves"]["x"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["model/blocks/l0/mixer/wq"]["shape"][0] == cfg.n_groups
    fresh = TT.init_params(cfg, 2, device="cpu", dtype=torch.bfloat16, trainable=True)
    restored, _ = tck.restore(str(tmp_path), {"model": fresh, "x": torch.zeros(3).bfloat16()})
    assert restored["model"] is fresh
    assert torch.equal(restored["x"].view(torch.int16), state["x"].view(torch.int16))
    for (name, a), (_, b) in zip(model.named_parameters(), fresh.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16), b.view(torch.int16)), name


# -- the train step and launch/train against the reference -----------------------


@pytest.fixture(scope="module")
def tiny_qwen():
    """(reference cfg, port cfg, the reference's initial TrainState, batch)."""
    jcfg = jconfigs.get_config("qwen3-8b").tiny()
    state = jstep.make_train_state(jcfg, jstep.TrainConfig())
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)}
    return jcfg, tconfigs.get_config("qwen3-8b").tiny(), state, batch


def _port_state(tcfg, jstate, tc):
    model = TT.params_from_jax(tcfg, jax.tree.map(np.asarray, jstate.params), device="cpu")
    return tstep.state_for(model, tc)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_equals_the_reference(tiny_qwen, microbatches):
    """One step from the same parameters and batch: the loss, the new
    parameters and the AdamW moments."""
    jcfg, tcfg, jstate, batch = tiny_qwen
    ocfg = dict(lr=1e-2, warmup=0)
    jtc = jstep.TrainConfig(opt=jopt.OptConfig(**ocfg), microbatches=microbatches)
    ttc = tstep.TrainConfig(opt=topt.OptConfig(**ocfg), microbatches=microbatches)
    jnew, jm = jax.jit(jstep.build_train_step(jcfg, jtc, jpar.ParallelCtx()))(
        jstate, {"tokens": jnp.asarray(batch["tokens"])})
    state = _port_state(tcfg, jstate, ttc)
    new, m = tstep.build_train_step(tcfg, ttc, tpar.ParallelCtx())(
        state, {"tokens": torch.as_tensor(batch["tokens"])})
    assert int(new.step) == int(jnew.step) == 1
    for key in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **STEP_TOL)
    _close(_flat_np(new.params), _jflat(jnew.params), **STEP_TOL)
    _close(_flat_np(new.opt), _jflat(jnew.opt), **STEP_TOL)


def _args(*extra):
    return ["--arch", "qwen3-8b", "--tiny", "--steps", "3", "--batch", "2", "--seq", "16",
            "--log-every", "1", *extra]


def test_launch_train_equals_the_reference(tiny_qwen, capsys):
    """``launch/train.main``'s losses given the reference's initial state,
    against ``repro.launch.train.main`` (which draws that state itself)."""
    _, tcfg, jstate, _ = tiny_qwen
    want = jlaunch.main(_args())
    args = tlaunch.parser().parse_args(_args("--device", "cpu"))
    got = tlaunch.train(args, state=_port_state(tcfg, jstate, tstep.TrainConfig()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    port = [x for x in lines if "device" in x]
    assert [x["step"] for x in port] == [1, 2, 3] and port[0]["device"] == "cpu"
    assert set(port[0]) == {"step", "loss", "gnorm", "lr", "steps_per_s", "device"}


def test_launch_train_resumes_at_the_saved_step(tiny_qwen, tmp_path, capsys):
    """4 steps with checkpoints every 2, then ``--resume`` to 6: the last two
    losses of an uninterrupted 6-step run, within 1e-6 relative (the
    restored state is bit for bit the saved one, but the CPU's BLAS may
    round a product otherwise for buffers at other alignments); the port's
    final TrainState checkpoint restores in the reference's TrainState."""
    _, tcfg, jstate, _ = tiny_qwen
    ck = str(tmp_path / "ck")

    def run(steps, *extra):
        args = tlaunch.parser().parse_args(_args("--device", "cpu", "--steps", str(steps),
                                                 *extra))
        return tlaunch.train(args, state=_port_state(tcfg, jstate, tstep.TrainConfig()))

    full = run(6)
    run(4, "--ckpt-dir", ck, "--ckpt-every", "2")
    assert tck.list_steps(ck) == [2, 4]
    resumed = run(6, "--ckpt-dir", ck, "--resume")
    assert "[ckpt] resumed at step 4" in capsys.readouterr().out
    np.testing.assert_allclose(resumed, full[4:], rtol=1e-6, atol=0)
    like = jax.eval_shape(lambda: jstep.make_train_state(jconfigs.get_config("qwen3-8b").tiny(),
                                                         jstep.TrainConfig()))
    restored, manifest = jck.restore(ck, like)
    assert manifest["step"] == 6 and int(restored.step) == 6
    assert restored.params["blocks"]["l0"]["mixer"]["wq"].shape == like.params["blocks"]["l0"][
        "mixer"]["wq"].shape


@pytest.mark.parametrize("flag", [["--mesh", "production"], ["--multi-pod"],
                                  ["--mesh-devices", "2"], ["--fsdp"], ["--compress-grads"]])
def test_multi_card_flags_raise(flag, capfd):
    """The mesh flags.  ``--mesh production`` / ``--multi-pod`` lay the
    state over (16, 16) / (2, 16, 16) and raise naming the 256 / 512 ranks
    they need (one runs here).  ``--mesh-devices 2`` trains on 2 gloo ranks
    over the host mesh (2 ``data`` lanes): the one-process losses (rtol
    1e-5; the batch's two halves' means averaged); ``--fsdp`` and
    ``--compress-grads`` on those ranks: FSDP shards every leaf and gives
    the same losses, the int8 gradients losses within 1e-2 of them and not
    equal.  Rank 0 logs, with the backend."""
    if flag[0] in ("--mesh", "--multi-pod"):
        with pytest.raises(ValueError, match="needs 256 ranks" if flag[0] == "--mesh"
                           else "needs 512 ranks"):
            tlaunch.main(_args("--device", "cpu", *flag))
        return
    base = tlaunch.main(_args("--device", "cpu"))
    capfd.readouterr()
    extra = flag if flag[0] == "--mesh-devices" else [*flag, "--mesh-devices", "2"]
    got = tlaunch.main(_args("--device", "cpu", *extra))
    lines = [json.loads(line) for line in capfd.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 3 and lines[-1]["ranks"] == 2 and lines[-1]["backend"] == "gloo"
    assert lines[-1]["mesh"] == {"data": 2} and not lines[-1]["staged"]
    assert [line["loss"] for line in lines] == [round(v, 4) for v in got]
    if flag[0] == "--compress-grads":
        np.testing.assert_allclose(got, base, rtol=1e-2)
        assert got != base
    else:
        np.testing.assert_allclose(got, base, rtol=1e-5)


def test_launch_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(_args())
