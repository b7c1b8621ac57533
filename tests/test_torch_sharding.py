"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``): ``spec_for`` on every leaf of
all ten configurations at full size, and ``cache_shardings`` on every
cache leaf, exactly, on both production meshes (16, 16) and (2, 16, 16),
with FSDP on and off and ``moe_impl`` "epsum" and "a2a"; and every case
of tests/test_sharding.py.

Shapes only: ``jax.eval_shape`` on the reference's side, the ``meta``
device on the port's, abstract meshes on both (the reference's
``compat.abstract_mesh``, the port's ``make_production_mesh`` with no
process group).  A reference ``PartitionSpec`` normalises a one-axis tuple
entry to the axis name; the port's specs are compared after the same
normalisation.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel import api as jpar  # noqa: E402
from repro.parallel import sharding as jsr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.tree import flatten  # noqa: E402
from repro_torch.parallel import api as tpar  # noqa: E402
from repro_torch.parallel import sharding as tsr  # noqa: E402

ARCHS = tconfigs.all_archs()
COMBOS = list(itertools.product((False, True), (False, True), ("epsum", "a2a")))


def norm(spec) -> tuple:
    """A spec as a reference ``PartitionSpec`` holds it."""
    return tuple(P(*spec))


def ctxs(multi_pod, fsdp, impl):
    shape, axes = tmesh.production_shape(multi_pod)
    jctx = jpar.ParallelCtx(mesh=compat.abstract_mesh(shape, axes), fsdp=fsdp, moe_impl=impl)
    tctx = tpar.ParallelCtx(mesh=tmesh.make_production_mesh(multi_pod=multi_pod), fsdp=fsdp,
                            moe_impl=impl)
    return jctx, tctx


@pytest.fixture(scope="module")
def shapes():
    """{arch: (reference [(path, shape)], port [(path, shape)])} at full size."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch)
        tree = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
        ref = [(jsr._path_strs(path), tuple(leaf.shape))
               for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
        port = [(path, tuple(leaf.shape)) for path, leaf in
                flatten(TT.LM(tconfigs.get_config(arch), None, device="meta"))]
        out[arch] = (ref, port)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_every_leaf_at_full_size(shapes, arch):
    """The port's parameter tree has the reference's leaves (paths, stacked
    shapes), and ``spec_for`` gives each the reference's spec on both
    production meshes, FSDP on and off, both MoE routes; ``leaf_specs``
    (the per-group specs the model is built with) is each one's part
    after the group axis."""
    ref, port = shapes[arch]
    assert sorted(port) == sorted(ref)
    cfg = tconfigs.get_config(arch)
    for multi_pod, fsdp, impl in COMBOS:
        jctx, tctx = ctxs(multi_pod, fsdp, impl)
        want = {path: tuple(jsr.spec_for(path, shape, jctx)) for path, shape in ref}
        got = {path: norm(tsr.spec_for(path, shape, tctx)) for path, shape in port}
        assert got == want, (multi_pod, fsdp, impl)
        assert tsr.param_shardings(TT.LM(cfg, None, device="meta"), tctx)["embed"] == \
            tsr.spec_for(("embed",), (cfg.padded_vocab, cfg.d_model), tctx)
        if (multi_pod, fsdp, impl) == (False, True, "epsum"):
            for name, spec in TT.leaf_specs(cfg, tctx):
                path, stacked = TT.ref_path(name)
                full = dict(port)[path]
                assert spec == tsr.spec_for(path, full, tctx)[int(stacked):], name


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_every_leaf_at_full_size(arch):
    """``cache_shardings`` of the full-size cache (batch 32, 4,096 slots; an
    encoder-decoder's cross cache at its frames) equal the reference's on
    both production meshes."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 32, 4096))
    tcache = TT.init_cache(tcfg, 32, 4096, device="meta")
    ref = {jsr._path_strs(path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(jcache)[0]}
    for multi_pod in (False, True):
        jctx, tctx = ctxs(multi_pod, False, "epsum")
        want = {jsr._path_strs(path): tuple(sh.spec) for path, sh in
                jax.tree_util.tree_flatten_with_path(jsr.cache_shardings(jcfg, jcache, jctx))[0]}
        got = {path: norm(spec) for path, spec in
               flatten(tsr.cache_shardings(tcfg, tcache, tctx))}
        assert {p: tuple(leaf.shape) for p, leaf in flatten(tcache)} == \
            {p: tuple(leaf.shape) for p, leaf in ref.items()}
        assert got == want, multi_pod


# -- tests/test_sharding.py's cases ----------------------------------------


def tctx(fsdp=False, multi_pod=False):
    return tpar.ParallelCtx(mesh=tmesh.make_production_mesh(multi_pod=multi_pod), fsdp=fsdp)


SHARDING_CASES = [
    # (name, path, shape, fsdp, multi_pod, want)
    ("attention_tp_wq", ("blocks", "l0", "mixer", "wq"), (62, 4096, 4096), False, False,
     P(None, None, "model")),
    ("attention_tp_wo", ("blocks", "l0", "mixer", "wo"), (62, 4096, 4096), False, False,
     P(None, "model", None)),
    ("embed_vocab_sharded", ("embed",), (151936, 4096), False, False, P("model", None)),
    ("moe_expert_parallel", ("blocks", "l0", "ffn", "w1"), (61, 384, 7168, 2048), False, False,
     P(None, "model", None, None)),
    ("dense_ffn_vs_moe", ("blocks", "l0", "ffn", "w1"), (36, 4096, 12288), False, False,
     P(None, None, "model")),
    ("shared_expert_is_dense_tp", ("blocks", "l0", "ffn", "shared", "w2"), (61, 2048, 7168),
     False, False, P(None, "model", None)),
    ("non_divisible_shards", ("blocks", "l0", "mixer", "wq"), (62, 2560, 2560), False, False,
     P(None, None, "model")),
    ("non_divisible_replicates", ("blocks", "l0", "mixer", "wq"), (62, 2560, 61), False, False,
     P(None, None, None)),
    ("fsdp_adds_data_axis", ("blocks", "l0", "mixer", "wq"), (62, 4096, 4096), True, False,
     P(None, "data", "model")),
    ("fsdp_multipod_both_dp_axes", ("blocks", "l0", "mixer", "wq"), (62, 4096, 4096), True,
     True, P(None, ("pod", "data"), "model")),
]


@pytest.mark.parametrize("case", SHARDING_CASES, ids=[c[0] for c in SHARDING_CASES])
def test_sharding_cases(case):
    _, path, shape, fsdp, multi_pod, want = case
    got = tsr.spec_for(path, shape, tctx(fsdp, multi_pod))
    assert P(*got) == want
    jctx = jpar.ParallelCtx(mesh=compat.abstract_mesh(*tmesh.production_shape(multi_pod)),
                            fsdp=fsdp)
    assert norm(got) == tuple(jsr.spec_for(path, shape, jctx))


def test_norms_replicated_tp():
    spec = tsr.spec_for(("blocks", "l0", "norm1", "w"), (62, 4096), tctx())
    assert P(*spec) in (P(None, None), P(None, "data"))


def test_ctx_helpers():
    """``spec`` drops axes the mesh lacks, ``axis_size`` multiplies the
    rule's axes, no mesh leaves ``constrain`` the identity — as the
    reference's ParallelCtx."""
    c = tpar.ParallelCtx(mesh=tmesh.make_production_mesh())
    assert P(*c.spec("batch", None, "heads")) == P(("data",), None, "model")
    c2 = tpar.ParallelCtx(mesh=tmesh.make_production_mesh(multi_pod=True))
    assert c2.axis_size("batch") == 32 and c2.axis_size("experts") == 16
    x = torch.ones(4, 4)
    assert tpar.constrain(x, "batch", None) is x
    assert c.mesh.abstract and c2.mesh.shape == {"pod": 2, "data": 16, "model": 16}
    for logical in ("batch", "heads", "vocab", "embed", "seq_sp"):
        jc = jpar.ParallelCtx(mesh=compat.abstract_mesh((2, 16, 16), ("pod", "data", "model")))
        assert P(*c2.spec(logical, None)) == jc.spec(logical, None)
        assert c2.axis_size(logical) == jc.axis_size(logical)


def test_local_slice_and_shard_leaf():
    """This rank's shard under a spec, for each position of a concrete
    (data 2, model 4) mesh laid out without a process group: the
    reference's row-major device order, an entry of two axes row-major in
    the order listed, an axis the mesh lacks as one shard."""
    x = torch.arange(8 * 12).reshape(8, 12)
    parts = {}
    for r in range(8):
        mesh = tmesh.Mesh(("data", "model"), (2, 4), tuple(range(8)), r)
        assert mesh.coords == {"data": r // 4, "model": r % 4}
        parts[r] = tsr.shard_leaf(x, ("data", "model"), mesh)
        assert torch.equal(parts[r], x[(r // 4) * 4:(r // 4 + 1) * 4, (r % 4) * 3:(r % 4 + 1) * 3])
        both = tsr.local_slice((8, 12), (("data", "model"), None), mesh)
        assert both == (slice(r, r + 1), slice(0, 12))
        assert tsr.local_slice((8, 12), ("pod", None), mesh) == (slice(0, 8), slice(0, 12))


@pytest.mark.parametrize("arch", tconfigs.all_archs())
def test_head_plans_tile_the_output_projection(arch):
    """``layers.heads_at`` at full size on 2, 4 and 16 ``model`` lanes (the
    attention, cross-attention or MLA heads of every configuration): the
    lanes of a group compute the same query heads, the groups cover every
    head once, each lane's ``out`` columns of its heads' merged output are
    exactly its contiguous row shard of ``wo`` (the layer's
    ``o[..., out] @ wo_local``), and each local query head reads its own kv
    head where the flash kernel's grouping puts it.  Mamba-2's
    ``_mamba_cols``: the lanes' columns of ``w_in`` and channels of the
    conv each cover them once, a lane's z / x / dt those of its heads."""
    from repro_torch.models import layers as TL

    cfg = tconfigs.get_config(arch)
    kinds = {kind for kind, _ in cfg.layer_kinds()}
    mla = cfg.attn_kind == "mla"
    h, kv = cfg.n_heads, (cfg.n_heads if mla else cfg.n_kv_heads)
    hd = cfg.v_dim_per_head if mla else cfg.head_dim
    for m in (2, 4, 16):
        if "attn" in kinds:
            plans = [TL.heads_at(h, kv, h * hd, m, lane) for lane in range(m)]
            assert None not in plans
            rows = h * hd // m
            seen = set()
            for lane, pl in enumerate(plans):
                qs = range(pl.q0, pl.q0 + pl.n_q)
                seen.update(qs)
                assert pl.q0 * hd + pl.out.start == lane * rows
                assert pl.out.stop - pl.out.start == rows <= pl.n_q * hd
                assert pl.local_q == (h % m == 0)
                rep = pl.n_q // len(pl.kv)
                assert rep * len(pl.kv) == pl.n_q
                assert all(pl.kv[i // rep] == q // (h // kv) for i, q in enumerate(qs))
            assert seen == set(range(h))
        if "mamba" in kinds:
            di, st, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            cols, conv = zip(*(TL._mamba_cols(cfg, m, lane, "cpu") for lane in range(m)))
            width = 2 * di + 2 * st + nh
            assert sorted(torch.cat(cols).tolist()) == list(range(width))
            assert sorted(torch.cat(conv).tolist()) == list(range(di + 2 * st))
            dl, hl = di // m, nh // m
            for lane, c in enumerate(cols):
                assert c[:dl].tolist() == list(range(lane * dl, (lane + 1) * dl))
                assert c[-hl:].tolist() == list(range(2 * di + 2 * st + lane * hl,
                                                      2 * di + 2 * st + (lane + 1) * hl))
