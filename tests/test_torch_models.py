"""The port's LM serving path (``repro_torch.models``, ``configs``,
``serve.engine``) against the reference package's, on the CPU, for the
tiny configurations of all ten architectures: qwen3-8b (GQA, qk-norm),
granite-20b (MQA, gelu MLP), deepseek-coder-33b (GQA), mamba2-1.3b
(Mamba-2 SSD, tied embeddings), the MoE models llama4-scout (top-1,
shared expert), kimi-k2 (top-2 at tiny size, shared expert) and
jamba-1.5-large (MoE on the attention layer of each 8-layer pattern,
Mamba-2 elsewhere), minicpm3-4b (MLA), whisper-small (encoder-decoder:
frames through the encoder, cross-attention in every decoder layer) and
internvl2-26b (a VLM prefix of patch embeddings before the tokens).  The
tiny configurations route drop-free (capacity factor E), as the
reference's tests need for decode == forward.  The reference's
``init_params(PRNGKey(0))`` is carried across with ``params_from_jax``;
tokens, frames and prefixes are made with numpy.  Everything runs in
float32.  ``tests/test_torch_models_mla_encdec.py`` holds the MLA,
cross-attention, encoder and prefix pieces on their own.

Tolerances, and why:
- port against the reference, logits and caches: 1e-5 absolute and
  relative.  Both run the same float32 operations; only the order of the
  matmul and reduction sums differs (measured differences are below 2e-6
  on logits of size ~1).
- the port's own decode against its teacher-forced forward: 5e-4, the
  reference's tests/test_models.py tolerance for the same check.
- greedy tokens: equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel import api as jpar  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ARCHS = ["qwen3-8b", "granite-20b", "deepseek-coder-33b", "mamba2-1.3b",
         "llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "jamba-1.5-large-398b",
         "minicpm3-4b", "whisper-small", "internvl2-26b"]
TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = 1e-6  # the MoE aux loss: float32 sums of probabilities in another order
SELF_TOL = 5e-4


@pytest.fixture(scope="module")
def models():
    """{arch: (reference cfg, port cfg, reference params, port model)}."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch).tiny()
        tcfg = tconfigs.get_config(arch).tiny()
        params = JT.init_params(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, tcfg, params,
                     TT.params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    return out


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _extras(cfg, b, seed=0):
    """The inputs beside the tokens a configuration serves with, as numpy:
    an encoder-decoder's frames (b, frontend_seq, d) and a VLM's prefix (b,
    prefix_len, d), each normal · 0.1 as the reference's
    ``launch/serve.py`` draws them."""
    rng = np.random.default_rng(seed + 100)
    out = {}
    if cfg.frontend == "audio_stub":
        out["frames"] = (rng.normal(size=(b, cfg.frontend_seq, cfg.d_model)) * 0.1).astype(
            np.float32)
    if cfg.prefix_len:
        out["prefix"] = (rng.normal(size=(b, cfg.prefix_len, cfg.d_model)) * 0.1).astype(
            np.float32)
    return out


def _jx(extras):
    return {k: jnp.asarray(v) for k, v in extras.items()}


def _tx(extras):
    return {k: torch.as_tensor(v) for k, v in extras.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), **(tol or TOL))


# -- configuration ---------------------------------------------------------------


def test_registry_equals_the_reference():
    assert tconfigs.all_archs() == jconfigs.all_archs()
    assert tconfigs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for name in tconfigs.SHAPES:
        assert dataclasses.asdict(tconfigs.SHAPES[name]) == dataclasses.asdict(
            jconfigs.SHAPES[name])
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_config_and_param_counts_equal_the_reference(arch):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.tiny()) == dataclasses.asdict(jcfg.tiny())
    assert tcfg.param_counts() == jcfg.param_counts()
    assert tcfg.tiny().param_counts() == jcfg.tiny().param_counts()
    for shape in tconfigs.SHAPES.values():
        assert tconfigs.applicable(tcfg, shape) == jconfigs.applicable(
            jcfg, jconfigs.SHAPES[shape.name])
    assert tconfig.pad_to(tcfg.vocab, 128) == jconfig.pad_to(jcfg.vocab, 128) == \
        tcfg.padded_vocab


# -- parameters ------------------------------------------------------------------


def _jax_leaves(cfg, params):
    """{port parameter name: (shape, dtype)} of the reference's pytree,
    the group axis of ``blocks`` taken off."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        if keys[0] in ("blocks", "encoder"):
            for g in range(cfg.n_groups if keys[0] == "blocks" else cfg.encoder_layers):
                out[".".join([keys[0], str(g)] + keys[1:])] = (tuple(leaf.shape[1:]),
                                                                str(leaf.dtype))
        else:
            out[".".join(keys)] = (tuple(leaf.shape), str(leaf.dtype))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_the_reference(arch, dtype):
    jcfg, tcfg = jconfigs.get_config(arch).tiny(), tconfigs.get_config(arch).tiny()
    want = _jax_leaves(jcfg, JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=getattr(
        jnp, dtype)))
    model = TT.init_params(tcfg, 0, device="cpu", dtype=getattr(torch, dtype))
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in model.named_parameters()}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_scales_and_seed(arch):
    """The reference's scales (embeddings 0.02, matrices 1/√fan_in, norms
    1), and the same seed gives the same weights."""
    cfg = tconfigs.get_config(arch).tiny()
    m = TT.init_params(cfg, 3, device="cpu")
    assert torch.equal(m.embed, TT.init_params(cfg, 3, device="cpu").embed)
    assert not torch.equal(m.embed, TT.init_params(cfg, 4, device="cpu").embed)
    assert abs(float(m.embed.std()) - 0.02) < 0.002
    mixer = m.blocks[0]["l0"].mixer
    w = next(getattr(mixer, n) for n in ("wq", "w_dq", "w_in") if hasattr(mixer, n))
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.1
    assert torch.equal(m.final_norm.w, torch.ones_like(m.final_norm.w))


def test_params_from_jax_checks_the_tree(models):
    jcfg, tcfg, params, _ = models["qwen3-8b"]
    tree = jax.tree.map(np.asarray, params)
    del tree["blocks"]["l0"]["mixer"]["k_norm"]
    with pytest.raises(ValueError, match="k_norm"):
        TT.params_from_jax(tcfg, tree, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config("qwen3-8b").tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_cache(cfg, 1, 8)
    TT.init_params(cfg, 0, device="cpu")


# -- forward, prefill, decode, generation against the reference ------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_the_reference(models, arch):
    """Logits, and the aux loss summed over the MoE layers (0 without)."""
    jcfg, tcfg, params, model = models[arch]
    toks, extras = _tokens(jcfg, 2, 16), _extras(jcfg, 2)
    want, want_aux = JT.forward(jcfg, params, jnp.asarray(toks), **_jx(extras))
    got, aux = TT.forward(tcfg, model, torch.as_tensor(toks), **_tx(extras))
    assert got.shape == (2, 16, tcfg.padded_vocab) and aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL
    assert (float(aux) == 0.0) == (tcfg.n_experts == 0)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_reference(models, arch):
    """Prefill's last-token logits and every cache leaf (values and dtypes),
    then each decode step's logits and the updated cache."""
    jcfg, tcfg, params, model = models[arch]
    toks, extras = _tokens(jcfg, 2, 12, seed=1), _extras(jcfg, 2, seed=1)
    max_len = 12 + jcfg.prefix_len
    jl, jcache, jpos = JT.prefill(jcfg, params, jnp.asarray(toks[:, :6]), max_len=max_len,
                                  **_jx(extras))
    tl, tcache, tpos = TT.prefill(tcfg, model, torch.as_tensor(toks[:, :6]), max_len=max_len,
                                  **_tx(extras))
    assert tpos == int(jpos) == 6 + jcfg.prefix_len
    _close(tl, jl)
    assert tcache.keys() == jcache.keys()
    for key in jcache:
        assert tcache[key].keys() == jcache[key].keys()
        for leaf in jcache[key]:
            assert str(tcache[key][leaf].dtype).removeprefix("torch.") == str(
                jcache[key][leaf].dtype)
            _close(tcache[key][leaf], jcache[key][leaf])
    for t in range(6, 11):
        jl, jcache = JT.decode_step(jcfg, params, jnp.asarray(toks[:, t:t + 1]), jcache,
                                    jnp.asarray(jpos))
        tl, tcache = TT.decode_step(tcfg, model, torch.as_tensor(toks[:, t:t + 1]), tcache, tpos)
        jpos, tpos = jpos + 1, tpos + 1
        _close(tl, jl)
    for key in jcache:
        for leaf in jcache[key]:
            _close(tcache[key][leaf], jcache[key][leaf])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_equals_the_reference(models, arch):
    jcfg, tcfg, params, model = models[arch]
    prompt, extras = _tokens(jcfg, 2, 10, seed=2), _extras(jcfg, 2, seed=2)
    max_len = 18 + jcfg.prefix_len
    want = jengine.greedy_generate(jcfg, params, jnp.asarray(prompt), 8,
                                   jengine.ServeConfig(max_len=max_len), jpar.ParallelCtx(),
                                   **_jx(extras))
    trace: dict = {}
    got = tengine.greedy_generate(tcfg, model, torch.as_tensor(prompt), 8,
                                  tengine.ServeConfig(max_len=max_len), trace=trace,
                                  **_tx(extras))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(trace["logits"]) == 8 and trace["prefill_s"] >= 0 and trace["decode_s"] >= 0


# -- the port's own consistency (tests/test_models.py's checks) -------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(models, arch):
    """prefill + decode_step reproduce the teacher-forced logits
    (tests/test_models.py::test_decode_matches_forward)."""
    _, cfg, _, model = models[arch]
    toks, extras = torch.as_tensor(_tokens(cfg, 2, 12, seed=3)), _tx(_extras(cfg, 2, seed=3))
    logits_tf, _ = TT.forward(cfg, model, toks, **extras)
    lg, cache, pos = TT.prefill(cfg, model, toks[:, :6], max_len=12 + cfg.prefix_len, **extras)
    errs = [float((lg - logits_tf[:, 5]).abs().max())]
    for t in range(6, 11):
        lg, cache = TT.decode_step(cfg, model, toks[:, t:t + 1], cache, pos)
        pos += 1
        errs.append(float((lg - logits_tf[:, t]).abs().max()))
    assert max(errs) < SELF_TOL, errs


def test_windowed_ring_decode_matches_full(models):
    """Ring-buffer windowed decode == full-cache windowed attention
    (tests/test_models.py::test_windowed_ring_decode_matches_full), and
    equals the reference's ring decode step by step."""
    jcfg = dataclasses.replace(jconfigs.get_config("qwen3-8b").tiny(), window=8)
    cfg = dataclasses.replace(tconfigs.get_config("qwen3-8b").tiny(), window=8)
    params = models["qwen3-8b"][2]
    model = TT.params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    toks = _tokens(cfg, 1, 24, seed=4)
    logits_tf, _ = TT.forward(cfg, model, torch.as_tensor(toks))
    lg, cache, pos = TT.prefill(cfg, model, torch.as_tensor(toks[:, :8]), max_len=24)
    jl, jcache, jpos = JT.prefill(jcfg, params, jnp.asarray(toks[:, :8]), max_len=24)
    assert cache["l0"]["k"].shape[3] == 8
    errs = []
    for t in range(8, 23):
        lg, cache = TT.decode_step(cfg, model, torch.as_tensor(toks[:, t:t + 1]), cache, pos)
        jl, jcache = JT.decode_step(jcfg, params, jnp.asarray(toks[:, t:t + 1]), jcache,
                                    jnp.asarray(jpos))
        pos, jpos = pos + 1, jpos + 1
        errs.append(float((lg - logits_tf[:, t]).abs().max()))
        _close(lg, jl)
    assert max(errs) < SELF_TOL, errs


def test_windowed_prefill_keeps_the_trailing_window(models):
    """A prompt longer than the window: the cache keeps its last entries
    (``_fit``), as the reference's."""
    jcfg = dataclasses.replace(jconfigs.get_config("qwen3-8b").tiny(), window=8)
    cfg = dataclasses.replace(tconfigs.get_config("qwen3-8b").tiny(), window=8)
    params = models["qwen3-8b"][2]
    model = TT.params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    toks = _tokens(cfg, 2, 13, seed=5)
    tl, tcache, _ = TT.prefill(cfg, model, torch.as_tensor(toks), max_len=20)
    jl, jcache, _ = JT.prefill(jcfg, params, jnp.asarray(toks), max_len=20)
    _close(tl, jl)
    _close(tcache["l0"]["k"], jcache["l0"]["k"])


def test_decode_clamps_the_cache_slot_as_the_reference(models):
    """Past the end of a non-ring cache, dynamic_update_slice clamps the
    start: the step writes the last slot, in both packages."""
    jcfg, tcfg, params, model = models["qwen3-8b"]
    toks = _tokens(jcfg, 1, 6, seed=6)
    jl, jcache, _ = JT.prefill(jcfg, params, jnp.asarray(toks[:, :4]), max_len=4)
    tl, tcache, _ = TT.prefill(tcfg, model, torch.as_tensor(toks[:, :4]), max_len=4)
    jl, jcache = JT.decode_step(jcfg, params, jnp.asarray(toks[:, 4:5]), jcache, jnp.asarray(6))
    tl, tcache = TT.decode_step(tcfg, model, torch.as_tensor(toks[:, 4:5]), tcache, 6)
    _close(tl, jl)
    _close(tcache["l0"]["k"], jcache["l0"]["k"])


def test_token_ids_out_of_range_as_the_reference(models):
    """``jnp.take``'s default bounds: a negative id counts from the end, an
    id outside [−V, V) gives NaN (jax's "fill" mode; nothing clamps)."""
    jcfg, tcfg, params, model = models["qwen3-8b"]
    v = tcfg.padded_vocab
    toks = np.array([[0, v - 1, -1, -v, v, -v - 1, 5 * v]], np.int32)
    want = np.asarray(jnp.take(params["embed"], jnp.asarray(toks), axis=0))
    got = TT.embed_tokens(model.embed, torch.as_tensor(toks)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.isnan(got[0, 4:]).all() and not np.isnan(got[0, :4]).any()


def test_sampling_with_a_generator(models):
    """temperature > 0 draws from the softmax with the given generator:
    the same seed gives the same tokens, and the tokens stay in the
    vocabulary (the padding columns are cut)."""
    _, cfg, _, model = models["mamba2-1.3b"]
    prompt = torch.as_tensor(_tokens(cfg, 2, 8, seed=7))
    scfg = tengine.ServeConfig(max_len=14)
    runs = [tengine.greedy_generate(cfg, model, prompt, 6, scfg, temperature=1.0,
                                    generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert int(runs[0].max()) < cfg.vocab


def test_serve_config_fields_equal_the_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(tengine.ServeConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jengine.ServeConfig)]


def test_serving_path_launches_nothing_on_cpu(models):
    _, cfg, _, model = models["qwen3-8b"]
    ops.reset_launch_counts()
    tengine.greedy_generate(cfg, model, torch.as_tensor(_tokens(cfg, 1, 5)), 3,
                            tengine.ServeConfig(max_len=8))
    assert sum(ops.launch_counts().values()) == 0
