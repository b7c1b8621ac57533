"""The port's training loss and its gradients (``repro_torch.models.
transformer.loss_fn`` under ``torch.autograd``) against the reference
package's ``jax.value_and_grad(transformer.loss_fn)`` on the CPU, for the
tiny configurations of qwen3-8b (GQA, qk-norm), mamba2-1.3b (the SSD scan,
tied embeddings), llama4-scout (MoE: the aux loss, the routed gather),
minicpm3-4b (MLA, v padded to the qk dim), whisper-small (frames through
the encoder, cross-attention) and internvl2-26b (a VLM prefix).  The
reference's ``init_params(PRNGKey(0))`` is carried across with
``params_from_jax``; the batch (2 × 16 tokens, frames and prefix) is
made with numpy.  Each reference result is computed once per module.

Tolerances, and why:
- loss: rtol 1e-5.  Both run the same float32 operations; only the order
  of the matmul and reduction sums differs.
- every parameter's gradient: rtol 1e-4 with an atol of 5e-6 × the
  largest |gradient| of its leaf.  A gradient is a sum over every token's
  path through the layers, so the reordered float32 sums differ more than
  the forward does; entries many orders below the leaf's largest are
  cancellations, held by the atol.  Its size is measured: against the
  same gradients computed in float64 by the port, the reference's float32
  gradients are off by up to 1.4e-6 × the leaf's largest (whisper-small's
  cross-attention wq, the worst leaf) and the port's by up to 2.9e-6, so
  the two may differ by about 4.3e-6 × it (at 1e-6 one entry of that leaf
  fails, the port being the nearer of the two to the float64 value).
- the port against itself (remat, the MoE branches, the differentiable
  ops' Functions against autograd of the plain versions): bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.tree import Stack, flatten  # noqa: E402
from repro_torch.parallel import api as par  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ["qwen3-8b", "mamba2-1.3b", "llama4-scout-17b-a16e", "minicpm3-4b", "whisper-small",
         "internvl2-26b"]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 5e-6


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "audio_stub":
        out["frames"] = (rng.normal(size=(b, cfg.frontend_seq, cfg.d_model)) * 0.1).astype(
            np.float32)
    if cfg.prefix_len:
        out["prefix"] = (rng.normal(size=(b, cfg.prefix_len, cfg.d_model)) * 0.1).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def reference():
    """{arch: (port cfg, reference params as numpy, batch, loss, {path: grad})}."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch).tiny()
        params = JT.init_params(jcfg, jax.random.PRNGKey(0))
        batch = _batch(jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(jcfg, p, jb)))(params)
        flat = {"/".join(str(k.key) for k in path): np.asarray(g)
                for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
        out[arch] = (tconfigs.get_config(arch).tiny(), jax.tree.map(np.asarray, params), batch,
                     float(loss), flat)
    return out


def _model(cfg, params):
    return TT.params_from_jax(cfg, params, device="cpu", trainable=True)


def _tx(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _loss_and_grads(cfg, model, batch):
    """(loss, {path: stacked gradient}) in the reference's leaf layout."""
    loss, grads = tstep._loss_and_grads(cfg, tstep.TrainConfig(), model, _tx(batch))
    return loss, {"/".join(p): (torch.stack(list(g)) if isinstance(g, Stack) else g)
                  for p, g in flatten(grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_the_reference(reference, arch):
    cfg, params, batch, want_loss, want = reference[arch]
    loss, got = _loss_and_grads(cfg, _model(cfg, params), batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * float(np.abs(w).max()), err_msg=path)
        assert np.isfinite(g.numpy()).all(), path


def test_moe_aux_loss_reaches_the_router(reference):
    """llama4-scout: AUX_COEF × aux is in the loss, and the router learns
    from the gates and the aux term (a nonzero gradient)."""
    cfg, params, batch, _, _ = reference["llama4-scout-17b-a16e"]
    model = _model(cfg, params)
    with torch.no_grad():
        _, aux = TT.forward(cfg, model, torch.as_tensor(batch["tokens"]))
    assert float(aux) > 0
    _, got = _loss_and_grads(cfg, model, batch)
    router = [p for p in got if p.endswith("ffn/router")]
    assert router and all(float(got[p].abs().max()) > 0 for p in router)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_bf16_input_gradient_comes_back_in_bf16(norm):
    """The reference's ``_f32c``: the norms compute in float32, and the
    cotangent of a bf16 input comes back in bf16 (``x.float()``'s own
    backward casts it), equal to the float32 cotangent rounded."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(3, 8)).astype(np.float32)).bfloat16()
    w = torch.as_tensor(rng.normal(size=(8,)).astype(np.float32)).bfloat16()
    b = torch.zeros(8, dtype=torch.bfloat16)
    x.requires_grad_(True)
    fn = (lambda x: L.rmsnorm(x, w)) if norm == "rmsnorm" else (lambda x: L.layernorm(x, w, b))
    y = fn(x)
    g = torch.as_tensor(rng.normal(size=(3, 8)).astype(np.float32)).bfloat16()
    (dx,) = torch.autograd.grad(y, x, g)
    assert dx.dtype == torch.bfloat16
    x32 = x.detach().float().requires_grad_(True)
    # The same graph with the upcast made explicit: the bf16 cast of the
    # float32 cotangent at x32.
    x32b = x32.to(torch.bfloat16)
    (dx32,) = torch.autograd.grad(fn(x32b), x32, g)
    assert torch.equal(dx, dx32.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-small"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_loss_and_gradients(reference, arch, remat):
    """Each block group (and whisper's encoder layers) checkpointed whole,
    or with the products of matrices kept: the same loss and gradients as
    without, bit for bit."""
    cfg, params, batch, _, _ = reference[arch]
    loss, want = _loss_and_grads(cfg, _model(cfg, params), batch)
    with par.use(par.ParallelCtx(remat=remat)):
        loss_r, got = _loss_and_grads(cfg, _model(cfg, params), batch)
    assert torch.equal(loss, loss_r)
    for path, g in got.items():
        assert torch.equal(g, want[path]), path


def test_parallel_ctx_refuses_several_cards():
    """``ParallelCtx`` takes a mesh, ``fsdp`` and ``compress_grads`` (the
    mesh path, tests/test_torch_mesh.py): on the production meshes (abstract
    here) ``axis_size`` and ``spec`` follow the reference's, ``dp`` counts
    the DP lanes, ``shard_batch`` refuses nothing and ``constrain`` is the
    identity; an unknown ``remat`` still raises."""
    from repro import compat
    from repro.parallel import api as jpar
    from repro_torch.launch import mesh as tmesh

    for multi_pod in (False, True):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
        c = par.ParallelCtx(mesh=mesh, fsdp=True, compress_grads=True)
        jc = jpar.ParallelCtx(mesh=compat.abstract_mesh(*tmesh.production_shape(multi_pod)),
                              fsdp=True)
        for logical in ("batch", "heads", "experts", "vocab", "embed"):
            assert c.axis_size(logical) == jc.axis_size(logical)
            assert P(*c.spec(logical, None)) == jc.spec(logical, None)
        assert c.dp == (32 if multi_pod else 16) and c.fsdp and c.compress_grads
    with pytest.raises(ValueError, match="remat"):
        par.ParallelCtx(remat="some")
    x = torch.ones(2)
    assert par.constrain(x, "batch") is x
    assert par.ctx().remat == "none" and par.ctx().mesh is None
    assert par.ctx().shard_batch({"tokens": x}) == ({"tokens": x}, True)


def test_moe_training_branch_equals_the_serving_branch(reference):
    """``_moe_local`` with a gradient (out of place) and without (the
    serving branch's in-place buffers): the same forward, bit for bit."""
    cfg, params, batch, _, _ = reference["llama4-scout-17b-a16e"]
    p = _model(cfg, params).blocks[0]["l0"].ffn
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(32, cfg.d_model)).astype(np.float32))
    cap = 5
    y_serve, parts_serve = L._moe_local(cfg, p.requires_grad_(False), x, cap)
    p.requires_grad_(True)
    y_train, parts_train = L._moe_local(cfg, p, x, cap)
    assert y_train.requires_grad and not y_serve.requires_grad
    assert torch.equal(y_train.detach(), y_serve)
    for a, b in zip(parts_train, parts_serve):
        assert torch.equal(a.detach(), b)


def test_training_on_the_cpu_launches_no_kernel(reference):
    ops.reset_launch_counts()
    for arch in ("qwen3-8b", "mamba2-1.3b", "llama4-scout-17b-a16e"):
        cfg, params, batch, _, _ = reference[arch]
        _loss_and_grads(cfg, _model(cfg, params), batch)
    assert not any(ops.launch_counts().values())


# -- the differentiable ops' Functions on the CPU (their kernel forward takes
# the plain version there): the backward is the plain version's VJP ----------


def _req(rng, shape):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32)).requires_grad_(True)


def _grads_equal(out_fn, plain_fn, inputs, g):
    got = torch.autograd.grad(out_fn(*inputs), inputs, g)
    want = torch.autograd.grad(plain_fn(*inputs), inputs, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["gqa_causal", "window", "mla_padded_v", "cross_views"])
def test_flash_attention_function_backward_is_the_plain_vjp(case):
    """GQA causal, a window, MLA's v padded to the qk dim (the pad's
    gradient cut off by ``F.pad``'s own backward) and cross_kv's
    transposed (B, kv, Fs, hd) views of one product."""
    rng = np.random.default_rng(4)
    kw = dict(causal=case != "cross_views", scale=0.3, window=4 if case == "window" else None)

    def fn(q, k, v):
        return ops._FlashAttention.apply(q, k, v, kw["causal"], kw["scale"], kw["window"])

    def plain(q, k, v):
        return ref.flash_attention(q, k, v, **kw)

    if case == "cross_views":
        inputs = (_req(rng, (2, 4, 5, 16)), _req(rng, (2, 7, 32)))

        def run(attn):
            return lambda q, kv: attn(q, kv[..., :16].reshape(2, 7, 1, 16).transpose(1, 2),
                                      kv[..., 16:].reshape(2, 7, 1, 16).transpose(1, 2))
        g_shape = (2, 4, 5, 16)
    elif case == "mla_padded_v":
        inputs = (_req(rng, (2, 4, 9, 16)), _req(rng, (2, 2, 9, 16)), _req(rng, (2, 2, 9, 12)))

        def run(attn):
            return lambda q, k, v: attn(q, k, torch.nn.functional.pad(v, (0, 4)))[..., :12]
        g_shape = (2, 4, 9, 12)
    else:
        inputs = (_req(rng, (2, 4, 9, 16)), _req(rng, (2, 2, 9, 16)), _req(rng, (2, 2, 9, 16)))

        def run(attn):
            return attn
        g_shape = (2, 4, 9, 16)
    g = torch.as_tensor(rng.normal(size=g_shape).astype(np.float32))
    _grads_equal(run(fn), run(plain), inputs, g)


def test_ssd_function_backward_is_the_plain_vjp():
    """The Mamba layer's inputs: c broadcast over the heads (stride 0)."""
    rng = np.random.default_rng(5)
    x, bm, cm = _req(rng, (2, 20, 3, 8)), _req(rng, (2, 20, 1, 4)), _req(rng, (2, 20, 1, 4))
    a = torch.as_tensor(-rng.uniform(0.1, 0.9, (2, 20, 3)).astype(np.float32)).requires_grad_()

    def run(scan):
        return lambda x, a, bm, cm: scan(x, a, bm.expand(2, 20, 3, 4) * 0.5,
                                         cm.expand(2, 20, 3, 4))

    g = torch.as_tensor(rng.normal(size=(2, 20, 3, 8)).astype(np.float32))
    _grads_equal(run(ops._SSDScan.apply), run(ref.ssd_scan), (x, a, bm, cm), g)


def test_chunked_ssd_gradient_is_finite_at_real_decay():
    """A Mamba-2 layer decays by about 0.7 a step at init, so a 128-step
    chunk's decay sums past float32's exp range: the plain chunked SSD (the
    VJP the card's backward recomputes at 2,048 steps) masks the exponent
    before the exp, and its gradient is finite and equals the sequential
    recurrence's (rtol 1e-5 of each input's largest gradient)."""
    rng = np.random.default_rng(7)
    x, b, c = (_req(rng, s) for s in ((1, 256, 2, 8), (1, 256, 2, 4), (1, 256, 2, 4)))
    a = torch.full((1, 256, 2), -0.9, requires_grad=True)
    g = torch.as_tensor(rng.normal(size=(1, 256, 2, 8)).astype(np.float32))
    got = torch.autograd.grad(ref.ssd_scan_chunked(x, a, b, c, chunk=128), (x, a, b, c), g)
    want = torch.autograd.grad(ref.ssd_scan(x, a, b, c), (x, a, b, c), g)
    for u, w in zip(got, want):
        assert bool(torch.isfinite(u).all())
        torch.testing.assert_close(u, w, rtol=0, atol=1e-5 * float(w.abs().max()))


def test_dispatch_gather_function_backward_is_the_plain_vjp():
    """Empty slots, ids beyond t, a token in several slots."""
    rng = np.random.default_rng(6)
    x = _req(rng, (6, 5))
    idx = torch.tensor([0, -1, 3, 3, 5, 9, 1, -1], dtype=torch.int32)
    g = torch.as_tensor(rng.normal(size=(8, 5)).astype(np.float32))
    _grads_equal(lambda x: ops._DispatchGather.apply(x, idx)[0],
                 lambda x: ref.dispatch_gather(x, idx, quant=False)[0], (x,), g)
