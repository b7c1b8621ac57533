"""The port's MLA (minicpm3-4b), encoder and cross-attention (whisper-small)
and VLM prefix (internvl2-26b) against the reference package's, on the
CPU, for their tiny configurations: the layers one at a time
(``mla_apply`` with and without ``pad_v``, ``mla_decode``, ``encode``,
``cross_kv`` / ``cross_apply``), then prefill and decode with inputs
``tests/test_torch_models.py`` does not give them (a batch of 3, frames
longer than ``frontend_seq``, a VLM run without its prefix), every cache
leaf (``ckv``, ``kr``, ``k``, ``v``, ``xk``, ``xv``) and every decode
step's logits, the greedy tokens, and the port's decode against its own
teacher-forced forward.  The reference's ``init_params(PRNGKey(0))`` is
carried across with ``params_from_jax``; tokens, frames and prefixes are
made with numpy.  Everything runs in float32.

Tolerances, as tests/test_torch_models.py's: 1e-5 absolute and relative
against the reference (the same float32 operations summed in another
order), 5e-4 for the port's decode against its teacher-forced forward
(tests/test_models.py's), greedy tokens equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel import api as jpar  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SELF_TOL = 5e-4
ARCHS = ["minicpm3-4b", "whisper-small", "internvl2-26b"]


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


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), **(tol or TOL))


def _layer0(params, *keys):
    """Group 0's slice of a leaf dict under ``blocks.l0``."""
    node = params["blocks"]["l0"]
    for k in keys:
        node = node[k]
    return jax.tree.map(lambda a: a[0], node)


# -- the layers ------------------------------------------------------------------


@pytest.mark.parametrize("pad_v", [True, False])
def test_mla_apply_equals_the_reference(models, pad_v):
    """The output and the (c_kv, k_rope) prefill caches; v padded from 16
    to the qk dim 24 (nope 16 + rope 8) or left at 16 (the plain route)."""
    jcfg, tcfg, params, model = models["minicpm3-4b"]
    assert tcfg.v_dim_per_head < tcfg.qk_nope_dim + tcfg.qk_rope_dim
    x = _normal((2, 11, tcfg.d_model), 1)
    jp = _layer0(params, "mixer")
    want, (want_c, want_kr) = JL.mla_apply(jcfg, jp, jnp.asarray(x), pad_v=pad_v)
    got, (got_c, got_kr) = TL.mla_apply(tcfg, model.blocks[0]["l0"].mixer, torch.as_tensor(x),
                                        pad_v=pad_v)
    assert got.shape == (2, 11, tcfg.d_model) and got_kr.shape == (2, 1, 11, tcfg.qk_rope_dim)
    _close(got, want)
    _close(got_c, want_c)
    _close(got_kr, want_kr)


def test_mla_decode_equals_the_reference(models):
    """One absorbed decode step against a latent cache with entries past
    ``pos`` (masked), the cache written in place at ``pos``."""
    jcfg, tcfg, params, model = models["minicpm3-4b"]
    b, s, pos = 2, 9, 5
    x = _normal((b, 1, tcfg.d_model), 2)
    ckv = _normal((b, s, tcfg.kv_lora_rank), 3)
    kr = _normal((b, s, tcfg.qk_rope_dim), 4)
    want, jcache = JL.mla_decode(jcfg, _layer0(params, "mixer"), jnp.asarray(x),
                                 {"ckv": jnp.asarray(ckv), "kr": jnp.asarray(kr)},
                                 jnp.asarray(pos))
    cache = {"ckv": torch.as_tensor(ckv.copy()), "kr": torch.as_tensor(kr.copy())}
    got, tcache = TL.mla_decode(tcfg, model.blocks[0]["l0"].mixer, torch.as_tensor(x), cache,
                                pos)
    assert tcache is cache
    _close(got, want)
    for leaf in ("ckv", "kr"):
        _close(cache[leaf], jcache[leaf])


def test_attn_init_dispatch(models):
    """MLA for an MLA configuration's self-attention, ``Attention`` for
    cross-attention and other configurations, as the reference's
    ``attn_init``."""
    cfg = models["minicpm3-4b"][1]
    assert isinstance(TL.attn_init(cfg), TL.MLA)
    assert isinstance(TL.attn_init(cfg, cross=True), TL.Attention)
    assert isinstance(TL.attn_init(models["whisper-small"][1]), TL.Attention)
    names = {n for n, _ in TL.MLA(cfg).named_parameters()}
    assert names == set(_layer0(models["minicpm3-4b"][2], "mixer"))


def test_encode_and_cross_attention_equal_the_reference(models):
    """``encode`` over frames (sinusoid positions, non-causal attention,
    ``enc_final_norm``), then layer 0's ``cross_kv`` and ``cross_apply``
    for a sequence and for one decode token."""
    jcfg, tcfg, params, model = models["whisper-small"]
    frames = _normal((2, tcfg.frontend_seq, tcfg.d_model), 5, 0.1)
    want = JT.encode(jcfg, params, jnp.asarray(frames))
    enc = TT.encode(tcfg, model, torch.as_tensor(frames))
    _close(enc, want)
    jp, tp = _layer0(params, "cross"), model.blocks[0]["l0"].cross
    jkv = JL.cross_kv(jcfg, jp, want)
    tkv = TL.cross_kv(tcfg, tp, enc)
    for g, w in zip(tkv, jkv):
        assert g.shape == (2, tcfg.n_kv_heads, tcfg.frontend_seq, tcfg.head_dim)
        _close(g, w)
    for s in (7, 1):
        x = _normal((2, s, tcfg.d_model), 6 + s)
        _close(TL.cross_apply(tcfg, tp, torch.as_tensor(x), tkv),
               JL.cross_apply(jcfg, jp, jnp.asarray(x), jkv))


# -- prefill and decode ----------------------------------------------------------

# Per architecture: the batch, prompt length and max_len, and the extras:
# frames 1.5 x frontend_seq long (the cross cache takes their length), a
# prefix, or none (a VLM served without one).
CASES = {
    "minicpm3-4b": (3, 7, 13, {}),
    "whisper-small": (3, 5, 11, {"frames": (24, 0.1)}),
    "internvl2-26b": (3, 6, 10, {}),
    "internvl2-26b+prefix": (1, 6, 14, {"prefix": (4, 0.1)}),
}


def _case(models, name, seed):
    arch = name.split("+")[0]
    jcfg, tcfg, params, model = models[arch]
    b, s, max_len, spec = CASES[name]
    extras = {k: _normal((b, n, tcfg.d_model), seed + len(k), scale)
              for k, (n, scale) in spec.items()}
    return jcfg, tcfg, params, model, b, s, max_len, extras


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_cache_and_decode_equal_the_reference(models, name):
    jcfg, tcfg, params, model, b, s, max_len, extras = _case(models, name, 10)
    toks = _tokens(tcfg, b, s + 4, 11)
    jl, jcache, jpos = JT.prefill(jcfg, params, jnp.asarray(toks[:, :s]), max_len=max_len,
                                  **{k: jnp.asarray(v) for k, v in extras.items()})
    tl, tcache, tpos = TT.prefill(tcfg, model, torch.as_tensor(toks[:, :s]), max_len=max_len,
                                  **{k: torch.as_tensor(v) for k, v in extras.items()})
    assert tpos == int(jpos) == s + (extras["prefix"].shape[1] if "prefix" in extras else 0)
    _close(tl, jl)
    want_leaves = {"minicpm3-4b": {"ckv", "kr"}, "whisper-small": {"k", "v", "xk", "xv"},
                   "internvl2-26b": {"k", "v"}}[name.split("+")[0]]
    for key in jcache:
        assert set(tcache[key]) == set(jcache[key]) == want_leaves
        for leaf in jcache[key]:
            assert tuple(tcache[key][leaf].shape) == jcache[key][leaf].shape
            _close(tcache[key][leaf], jcache[key][leaf])
    for t in range(s, s + 4):
        jl, jcache = JT.decode_step(jcfg, params, jnp.asarray(toks[:, t:t + 1]), jcache,
                                    jnp.asarray(jpos))
        tl, tcache = TT.decode_step(tcfg, model, torch.as_tensor(toks[:, t:t + 1]), tcache, tpos)
        jpos, tpos = jpos + 1, tpos + 1
        _close(tl, jl)
    for key in jcache:
        for leaf in jcache[key]:
            _close(tcache[key][leaf], jcache[key][leaf])


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_and_decode_against_forward(models, name):
    """Greedy tokens equal to the reference's generation loop, and the
    port's prefill + decode equal to its own teacher-forced forward on the
    generated sequence."""
    jcfg, tcfg, params, model, b, s, _, extras = _case(models, name, 20)
    prompt = _tokens(tcfg, b, s, 21)
    steps = 5
    scfg_len = s + steps + (extras["prefix"].shape[1] if "prefix" in extras else 0)
    want = jengine.greedy_generate(jcfg, params, jnp.asarray(prompt), steps,
                                   jengine.ServeConfig(max_len=scfg_len), jpar.ParallelCtx(),
                                   **{k: jnp.asarray(v) for k, v in extras.items()})
    tx = {k: torch.as_tensor(v) for k, v in extras.items()}
    trace: dict = {}
    got = tengine.greedy_generate(tcfg, model, torch.as_tensor(prompt), steps,
                                  tengine.ServeConfig(max_len=scfg_len), trace=trace, **tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seq = torch.cat([torch.as_tensor(prompt), got[:, :-1]], dim=1)
    logits_tf, _ = TT.forward(tcfg, model, seq, **tx)
    errs = [float((lg - logits_tf[:, s - 1 + i]).abs().max())
            for i, lg in enumerate(trace["logits"])]
    assert max(errs) < SELF_TOL, errs


def test_encoder_decoder_prefill_needs_frames(models):
    """Without frames an encoder-decoder has no cross K/V to cache: the
    port raises, as the reference's prefill fails (its cache tree lacks
    them)."""
    jcfg, tcfg, params, model = models["whisper-small"]
    toks = _tokens(tcfg, 1, 4, 30)
    with pytest.raises(ValueError, match="needs frames"):
        TT.prefill(tcfg, model, torch.as_tensor(toks), max_len=8)
    with pytest.raises(Exception):
        JT.prefill(jcfg, params, jnp.asarray(toks), max_len=8)
    with pytest.raises(ValueError, match="no encoder"):
        TT.encode(tcfg, models["internvl2-26b"][3], torch.zeros((1, 4, tcfg.d_model)))


def test_params_from_jax_checks_the_encoder_tree(models):
    jcfg, tcfg, params, _ = models["whisper-small"]
    tree = jax.tree.map(np.asarray, params)
    del tree["encoder"]["ffn"]["w2"]
    with pytest.raises(ValueError, match=r"encoder\.0\.ffn\.w2"):
        TT.params_from_jax(tcfg, tree, device="cpu")
