"""The port's one-card MoE layer and its dispatch gather (B9) against the
reference package, on the CPU.

- ``ref.dispatch_gather`` (the plain version the kernel is held to) is
  held exactly to a copy of ``tests/test_moe_gather.py``'s numpy
  ``reference()`` and to an exact numpy transcription of the Pallas
  ``_gather_kernel``'s int8 formula (the Pallas kernel itself does not run
  on the installed jax, ROADMAP C).
- ``_route`` is held exactly to the reference's routing expressions
  (``repro/models/layers.py::_moe_local``, copied below as ``_ref_route``,
  jitted as the model runs them) on the same probabilities, ties and
  over-capacity experts included; the port's expert buffer ``xe`` equals
  the reference's gather → mask → scatter chain bit for bit.
- ``moe_apply`` is held to ``repro.models.layers.moe_apply`` for the tiny
  llama4-scout, kimi-k2 and jamba configurations with the reference's
  weights carried across: y within 1e-5 (both run the same float32
  operations and differ only in the order of the matmul sums; measured
  differences are below 1e-6 at |y| ~ 1, so test_models.py's 5e-4 would
  hide a real fault) and aux within 1e-6.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import moe_gather, ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

MOE_ARCHS = ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"]
Y_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = 1e-6


def reference(x, idx):
    """tests/test_moe_gather.py's numpy oracle (copied: a test module is not
    imported)."""
    out = np.zeros((len(idx), x.shape[1]), np.float32)
    for i, r in enumerate(np.asarray(idx)):
        if r >= 0:
            out[i] = np.asarray(x)[r]
    return out


def quant_reference(x, idx):
    """``_gather_kernel``'s quant=True body in numpy, row by row: float32
    throughout, a true division by 127, round half to even."""
    x = np.asarray(x, np.float32)
    q = np.zeros((len(idx), x.shape[1]), np.int8)
    scales = np.zeros(len(idx), np.float32)
    for i, r in enumerate(np.asarray(idx)):
        vals = x[r] if r >= 0 else np.zeros(x.shape[1], np.float32)
        absmax = np.float32(np.abs(vals).max()) if vals.size else np.float32(0)
        scale = np.maximum(absmax / np.float32(127.0), np.float32(1e-12))
        q[i] = np.clip(np.rint(vals / scale), -127, 127).astype(np.int8)
        scales[i] = scale if r >= 0 else np.float32(0)
    return q, scales


def _as_torch(a, dtype):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


# -- (a) the plain dispatch_gather ------------------------------------------------


@pytest.mark.parametrize("t,d,s", [(64, 16, 256), (128, 32, 128), (32, 8, 512)])
def test_plain_gather_equals_the_numpy_reference(t, d, s):
    """test_moe_gather.py::test_exact_gather_sweep's shapes and inputs."""
    rng = np.random.default_rng(t + s)
    x = rng.normal(size=(t, d)).astype(np.float32)
    idx = rng.integers(-1, t, size=(s,)).astype(np.int32)
    buf, scales = ref.dispatch_gather(torch.as_tensor(x), torch.as_tensor(idx), quant=False)
    assert buf.dtype == torch.float32 and scales.dtype == torch.float32
    np.testing.assert_array_equal(buf.numpy(), reference(x, idx))
    np.testing.assert_array_equal(scales.numpy(), (idx >= 0).astype(np.float32))


@pytest.mark.parametrize("quant", [False, True])
def test_plain_gather_all_empty(quant):
    """test_moe_gather.py::test_empty_slots_zero, in both modes."""
    x = torch.ones((8, 4))
    buf, scales = ref.dispatch_gather(x, torch.full((32,), -1, dtype=torch.int32), quant=quant)
    assert buf.dtype == (torch.int8 if quant else torch.float32)
    assert int(buf.abs().sum()) == 0 and float(scales.abs().sum()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_quant_equals_the_kernel_formula(dtype):
    """int8 values and scales equal the numpy transcription exactly, on
    test_moe_gather.py's inputs and on rows built to land on halves (v /
    scale = k + 0.5 with scale exactly 1), which round to even."""
    rng = np.random.default_rng(0)
    x = _as_torch(rng.normal(size=(64, 16)) * 3, dtype)
    idx = torch.as_tensor(rng.integers(-1, 64, size=(128,)).astype(np.int32))
    halves = torch.tensor([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5] * 2])
    x = torch.cat([x, halves.to(dtype)])
    idx = torch.cat([idx, torch.tensor([64, -1, 64], dtype=torch.int32)])
    buf, scales = ref.dispatch_gather(x, idx, quant=True)
    want_q, want_s = quant_reference(x.float().numpy(), idx.numpy())
    assert buf.dtype == torch.int8
    np.testing.assert_array_equal(buf.numpy(), want_q)
    np.testing.assert_array_equal(scales.numpy(), want_s)
    np.testing.assert_array_equal(buf[-1, :8].numpy(), [127, 2, -4, 0, 0, 2, 126, -126])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_quant_roundtrip_bound(dtype):
    """test_moe_gather.py::test_int8_quantised_roundtrip: per-row absmax
    int8 is within 1/127 of the row max."""
    rng = np.random.default_rng(0)
    x = _as_torch(rng.normal(size=(64, 16)) * 3, dtype)
    idx = rng.integers(-1, 64, size=(128,)).astype(np.int32)
    buf, scales = ref.dispatch_gather(x, torch.as_tensor(idx), quant=True)
    deq = buf.numpy().astype(np.float32) * scales.numpy()[:, None]
    want = reference(x.float().numpy(), idx)
    assert np.abs(deq - want).max() <= np.abs(want).max() / 127 * 1.01 + 1e-6


def test_plain_gather_bounds():
    """A negative id of any size is an empty slot, and so is an id >= t,
    in both modes, as the kernel treats them; a strided x is read as it
    is."""
    x = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    buf, scales = ref.dispatch_gather(x, torch.tensor([5, -7, 0], dtype=torch.int32),
                                      quant=False)
    assert torch.equal(buf, torch.stack([x[5], torch.zeros(4), x[0]]))
    assert scales.tolist() == [1.0, 0.0, 1.0]
    idx = torch.tensor([6, 2, 1000, -1], dtype=torch.int32)
    for quant in (False, True):
        buf, scales = ref.dispatch_gather(x, idx, quant=quant)
        want, want_scales = ref.dispatch_gather(
            x, torch.tensor([-1, 2, -1, -1], dtype=torch.int32), quant=quant)
        assert torch.equal(buf, want) and torch.equal(scales, want_scales)
        assert not buf[[0, 2, 3]].any() and scales[[0, 2, 3]].tolist() == [0.0] * 3
    wide = torch.arange(48, dtype=torch.float32).reshape(6, 8)
    buf, _ = ref.dispatch_gather(wide[:, 2:5], torch.tensor([1, 3], dtype=torch.int32),
                                 quant=False)
    assert torch.equal(buf, wide[[1, 3], 2:5])


# -- (b) routing ------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "capacity"))
def _ref_route(probs, *, k, capacity):
    """``_moe_local``'s routing (repro/models/layers.py:394-408) at e_lo 0,
    e_local E, copied expression for expression."""
    t, e_local = probs.shape
    e_lo, e_hi = 0, e_local
    topv, topi = jax.lax.top_k(probs, k)
    gates = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    fe = topi.reshape(-1)
    mine = (fe >= e_lo) & (fe < e_hi)
    le = jnp.where(mine, fe - e_lo, e_local)
    order = jnp.argsort(le, stable=True)
    le_s = le[order]
    tok_s = order // k
    first = jnp.searchsorted(le_s, jnp.arange(e_local + 1))
    rank = jnp.arange(t * k) - first[jnp.clip(le_s, 0, e_local)]
    keep = (le_s < e_local) & (rank < capacity)
    slot = jnp.where(keep, le_s * capacity + rank, e_local * capacity)
    return topi, gates, order, tok_s, keep, slot


def _ref_xe(x_flat, tok_s, keep, slot, e, capacity):
    """The reference's expert buffer (layers.py:410-412)."""
    d = x_flat.shape[1]
    xe = jnp.zeros((e * capacity + 1, d), x_flat.dtype)
    xe = xe.at[slot].set(jnp.where(keep[:, None], x_flat[tok_s], 0))
    return xe[:-1].reshape(e, capacity, d)


ROUTE_CASES = [
    # t, E, k, capacity, probabilities
    (64, 4, 1, 20, "softmax"),
    (64, 4, 2, 40, "softmax"),
    (96, 16, 8, 64, "softmax"),
    (64, 8, 2, 5, "ties"),       # exact ties everywhere, experts over capacity
    (64, 8, 1, 3, "ties"),
    (40, 16, 1, 2, "one-hot"),   # every token on expert 3: 38 dropped
    (4, 16, 1, 1, "softmax"),    # llama4's decode shape: cap 1
]


def _probs(t, e, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "softmax":
        z = rng.normal(size=(t, e)).astype(np.float32)
        p = np.exp(z - z.max(-1, keepdims=True))
        return (p / p.sum(-1, keepdims=True)).astype(np.float32)
    if kind == "ties":
        return (rng.integers(0, 3, size=(t, e)) / 4).astype(np.float32)
    p = np.zeros((t, e), np.float32)
    p[:, 3] = 1.0
    return p


@pytest.mark.parametrize("t,e,k,cap,kind", ROUTE_CASES)
def test_route_equals_the_reference(t, e, k, cap, kind):
    probs = _probs(t, e, kind, seed=t * e + k)
    topi, gates, order, tok_s, keep, slot = (np.asarray(a) for a in _ref_route(
        jnp.asarray(probs), k=k, capacity=cap))
    r = L._route(torch.as_tensor(probs), k, cap)
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(r.gates.numpy(), gates)
    np.testing.assert_array_equal(r.order.numpy(), order)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    want_idx = np.full(e * cap, -1, np.int32)
    want_idx[slot[keep]] = tok_s[keep]
    assert r.idx.dtype == torch.int32
    np.testing.assert_array_equal(r.idx.numpy(), want_idx)
    if kind != "softmax":
        assert not keep.all()


# -- (c) the expert buffer -----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,e,k,cap,kind", ROUTE_CASES[3:])
def test_expert_buffer_equals_the_reference(t, e, k, cap, kind, dtype):
    probs = _probs(t, e, kind, seed=7)
    _, _, _, tok_s, keep, slot = _ref_route(jnp.asarray(probs), k=k, capacity=cap)
    x = np.random.default_rng(8).normal(size=(t, 24)).astype(np.float32)
    want = _ref_xe(jnp.asarray(x, getattr(jnp, dtype)), tok_s, keep, slot, e, cap)
    r = L._route(torch.as_tensor(probs), k, cap)
    got = ops.dispatch_gather(_as_torch(x, getattr(torch, dtype)), r.idx, quant=False)[0]
    got = got.reshape(e, cap, 24)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# -- (d) moe_apply against the reference ----------------------------------------


def _moe_pair(arch, **overrides):
    """(reference cfg, port cfg, reference ffn params, port MoE) of the
    tiny configuration's first MoE layer, weights carried across."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch).tiny(), **overrides)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).tiny(), **overrides)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = TT.params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    i = [is_moe for _, is_moe in tcfg.layer_kinds()].index(True)
    jp = jax.tree.map(lambda a: a[0], params["blocks"][f"l{i}"]["ffn"])
    return jcfg, tcfg, jp, model.blocks[0][f"l{i}"].ffn


@pytest.mark.parametrize("cf", [None, 1.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_equals_the_reference(arch, cf):
    """Drop-free (the tiny configs' capacity) and at capacity_factor 1.0,
    where experts overflow and copies are dropped."""
    jcfg, tcfg, jp, p = _moe_pair(arch, **({} if cf is None else {"capacity_factor": cf}))
    assert isinstance(p, L.MoE) and hasattr(p, "shared") == bool(tcfg.n_shared_experts)
    x = np.random.default_rng(1).normal(size=(2, 24, tcfg.d_model)).astype(np.float32)
    want, want_aux = JL.moe_apply(jcfg, jp, jnp.asarray(x))
    ops.reset_launch_counts()
    got, aux = L.moe_apply(tcfg, p, torch.as_tensor(x))
    assert sum(ops.launch_counts().values()) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Y_TOL)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL
    if cf is not None:  # the drops are real: some token gets no routed output
        t = x.shape[0] * x.shape[1]
        cap = int(np.ceil(t * tcfg.topk / tcfg.n_experts * cf))
        probs = torch.softmax((torch.as_tensor(x).reshape(t, -1) @ p.router), -1)
        assert not L._route(probs, tcfg.topk, cap).keep.all()


def test_moe_init_scales_are_the_reference_quirk():
    """router normal·0.02, w2 1/√f, and w1/w3 ``_init``'s default
    1/√shape[0] = 1/√E (not 1/√d), as the reference draws them."""
    cfg = dataclasses.replace(tconfigs.get_config("llama4-scout-17b-a16e").tiny(), d_model=128)
    p = TT.init_params(cfg, 0, device="cpu").blocks[0]["l0"].ffn
    e, f = cfg.n_experts, cfg.expert_ff
    assert p.w1.shape == (e, cfg.d_model, f) and p.w2.shape == (e, f, cfg.d_model)
    for w, want in ((p.router, 0.02), (p.w1, e ** -0.5), (p.w3, e ** -0.5), (p.w2, f ** -0.5)):
        assert abs(float(w.std()) / want - 1.0) < 0.03, (w.shape, float(w.std()), want)
    assert p.shared.w1.shape == (cfg.d_model, cfg.shared_d_ff * cfg.n_shared_experts)


# -- (e) the op on the CPU -------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
def test_op_on_cpu_runs_the_plain_version(quant):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(16, 12)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-1, 16, size=(40,)).astype(np.int32))
    ops.reset_launch_counts()
    got = ops.dispatch_gather(x, idx, quant=quant)
    direct = moe_gather.dispatch_gather(x, idx, quant=quant)
    want = ref.dispatch_gather(x, idx, quant=quant)
    assert moe_gather.launches["dispatch_gather"] == 0
    assert ops.launch_counts()["dispatch_gather"] == 0
    for a, b, c in zip(got, direct, want):
        assert torch.equal(a, c) and torch.equal(b, c) and a.dtype == c.dtype


def test_kernel_wrapper_refuses_other_devices():
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        moe_gather.dispatch_gather(x, torch.zeros(2, dtype=torch.int32, device="meta"),
                                   quant=False)
