"""The port's exact and delta phase 2 against the reference package's, on
the CPU, bit for bit: ``cross_min_d2`` (rectangular, A != B, empty and
full slots), ``contour_pair_d2_exact``, ``update_pair_d2``,
``update_pair_d2_many`` and ``merge_delta`` against the jitted reference
functions, and the plain contour distance against the jitted
``repro.kernels.ref.contour_min_d2``.

The batches are the 8-shard ``rings`` layout of the phase-2 table
(``spatial.PHASE2_LAYOUTS``, 2,048 points, the stream tests' size) through
``local_phase`` in both packages (held identical here too); the dirty sets
are tests/test_hierarchy.py's: [1, 3, 6] with a repeated index and
[0, 2, 5, 7] over poisoned rows, plus one dirty shard and a quarantined
(excluded) one.  A second batch replaces shards 1, 3 and 6 with the
ClusterSets of another rings draw (seed 7), so the patch meets rows that
really changed.  The reference's vertex-pair d2 compiles to fma(dy, dy,
dx·dx) under XLA:CPU; the port computes that rounding (``ref.fma_f32``,
``__fmaf_rn`` on the card), which these tests hold without tolerance."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import ddc as jddc  # noqa: E402
from repro.data import spatial as jsp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SHARDS = 8
N = 2048
SPEC = jsp.PHASE2_LAYOUTS["rings"]
JCFG = jddc.DDCConfig(eps=SPEC["eps"], min_pts=SPEC["min_pts"], grid=SPEC["grid"],
                      max_clusters=SPEC["max_clusters"], max_verts=SPEC["max_verts"])
TCFG = tddc.DDCConfig.from_dict(dataclasses.asdict(JCFG))
C, V = JCFG.max_clusters, JCFG.max_verts
M = SHARDS * C
REPLACED = (1, 3, 6)

j_cross = jax.jit(jddc.cross_min_d2)
j_contour = jax.jit(jref.contour_min_d2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _local_sets(pts):
    """Each shard's ClusterSet from both packages' local_phase."""
    jsets, tsets = [], []
    for idx in np.array_split(np.arange(len(pts)), SHARDS):
        jsets.append(jddc.local_phase(jnp.asarray(pts[idx]), jnp.ones(len(idx), bool),
                                      JCFG)[1])
        tsets.append(tddc.local_phase(torch.from_numpy(pts[idx]),
                                      torch.ones(len(idx), dtype=torch.bool), TCFG)[1])
    return jsets, tsets


def _jstack(sets):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *sets)


@pytest.fixture(scope="module")
def batches():
    """{"rings": (jax batch, port batch), "replaced": the same with shards
    1, 3 and 6 taken from another draw}."""
    jsets, tsets = _local_sets(jsp.make_rings(N))
    jnew, tnew = _local_sets(jsp.make_rings(N, seed=7))
    out = {"rings": (_jstack(jsets), tddc.stack_clustersets(tsets))}
    for i in REPLACED:
        jsets[i], tsets[i] = jnew[i], tnew[i]
    out["replaced"] = (_jstack(jsets), tddc.stack_clustersets(tsets))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_sets_equal(t_cs, j_cs):
    for f in tddc.ClusterSet._fields:
        np.testing.assert_array_equal(_np(getattr(t_cs, f)), _np(getattr(j_cs, f)),
                                      err_msg=f)


def _flat(batch):
    return batch.contours.reshape(M, V, 2), batch.counts.reshape(M), batch.valid.reshape(M)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _poison(d2, shards, value):
    stale = np.array(d2, copy=True)
    for s in shards:
        stale[s * C:(s + 1) * C, :] = value
        stale[:, s * C:(s + 1) * C] = value
    return stale


def test_local_batches_equal_reference(batches):
    for jb, tb in batches.values():
        _assert_sets_equal(tb, jb)
    jb, _ = batches["rings"]
    assert 2 <= int(jb.valid.sum()) < M and int(jb.counts.max()) < V
    jr, _ = batches["replaced"]
    for i in range(SHARDS):   # shards 1, 3 and 6 really changed, no other
        assert np.array_equal(np.asarray(jr.contours[i]), np.asarray(jb.contours[i])) \
            == (i not in REPLACED)


def _random_side(rng, a, v, kind):
    contours = rng.uniform(0, 1, (a, v, 2)).astype(np.float32)
    if kind == "full":
        return contours, np.full(a, v, np.int32), np.ones(a, bool)
    if kind == "empty":
        return contours, np.zeros(a, np.int32), np.zeros(a, bool)
    counts = rng.integers(0, v + 1, a).astype(np.int32)
    counts[0], counts[-1] = v, 0                       # a full slot and an empty one
    return contours, counts, rng.random(a) > 0.25


@pytest.mark.parametrize("a,b,v,kind_a,kind_b", [
    (12, 40, 16, "mixed", "mixed"),     # A != B, ragged counts
    (40, 12, 16, "mixed", "full"),
    (9, 9, 8, "full", "full"),          # no padding vertex: no BIG in any min
    (7, 20, 24, "empty", "mixed"),      # every row empty: all BIG
    (20, 7, 24, "mixed", "empty"),
    (1, 33, 5, "mixed", "mixed"),
])
def test_cross_min_d2_equals_jitted_reference(a, b, v, kind_a, kind_b):
    rng = np.random.default_rng(a * 1000 + b * 10 + v)
    sa, sb = _random_side(rng, a, v, kind_a), _random_side(rng, b, v, kind_b)
    want = np.asarray(j_cross(*map(jnp.asarray, sa), *map(jnp.asarray, sb)))
    got = tddc.cross_min_d2(*_t(*sa), *_t(*sb)).numpy()
    assert got.shape == (a, b) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if "empty" in (kind_a, kind_b):
        assert (got == np.float32(1e30)).all()
    if (kind_a, kind_b) == ("full", "full"):
        assert (got < 1e29).all()


@pytest.mark.parametrize("rows", [(1, 3), (0,), (2, 4, 5, 6, 7)])
def test_cross_min_d2_dirty_rows_equal_reference(batches, rows):
    """The delta merge's shape: a few shards' C rows against all M slots,
    from the layout's real contours."""
    jb, tb = batches["rings"]
    idx = np.concatenate([np.arange(s * C, (s + 1) * C) for s in rows])
    jc, jn, jv = _flat(jb)
    tc, tn, tv = _flat(tb)
    want = np.asarray(j_cross(jc[idx], jn[idx], jv[idx], jc, jn, jv))
    got = tddc.cross_min_d2(tc[idx], tn[idx], tv[idx], tc, tn, tv)
    np.testing.assert_array_equal(got.numpy(), want)
    full = tddc.contour_pair_d2(tb, TCFG)
    np.testing.assert_array_equal(got.numpy(), full.numpy()[idx])


@pytest.mark.parametrize("name", ["rings", "replaced"])
def test_exact_matrix_equals_reference(batches, name):
    """``contour_pair_d2_exact`` equals the jitted reference's, and the
    square form (``contour_pair_d2``, B5's square launch on the card)
    equals it bit for bit, as does the reference's own jnp merge matrix
    (``contour_pair_d2`` through ``ops`` on the CPU); d2 is symmetric."""
    jb, tb = batches[name]
    want = np.asarray(jddc.contour_pair_d2_exact(jb, JCFG))
    exact = tddc.contour_pair_d2_exact(tb, TCFG).numpy()
    np.testing.assert_array_equal(exact, want)
    np.testing.assert_array_equal(tddc.contour_pair_d2(tb, TCFG).numpy(), exact)
    np.testing.assert_array_equal(np.asarray(jddc.contour_pair_d2(jb, JCFG)), exact)
    np.testing.assert_array_equal(exact, exact.T)


@pytest.mark.parametrize("m,v,seed", [(16, 32, 1), (11, 16, 2), (40, 7, 3)])
def test_fma_form_is_symmetric(m, v, seed):
    """fl(a − b) = −fl(b − a), so fma(dy, dy, dx·dx) is the same both
    ways round: the plain matrix is symmetric bit for bit, and a
    rectangular row block equals the transposed column block."""
    rng = np.random.default_rng(seed)
    c, n, val = _t(*_random_side(rng, m, v, "mixed"))
    d2 = tref.contour_min_d2(c, n, val)
    assert torch.equal(d2, d2.T)
    lo, hi = slice(0, m // 3), slice(m // 3, m)
    ab = tref.cross_min_d2(c[lo], n[lo], val[lo], c[hi], n[hi], val[hi])
    ba = tref.cross_min_d2(c[hi], n[hi], val[hi], c[lo], n[lo], val[lo])
    assert torch.equal(ab, ba.T) and torch.equal(ab, d2[lo, hi])


def _contours(m, v, seed):
    """tests/test_torch_kernels.py's random contour buffers."""
    rng = np.random.default_rng(seed)
    contours = rng.uniform(0, 1, (m, v, 2)).astype(np.float32)
    counts = rng.integers(0, v + 1, m).astype(np.int32)
    valid = rng.random(m) > 0.25
    return contours, counts, valid


@pytest.mark.parametrize("m,v", [(16, 32), (32, 64), (8, 16), (24, 8), (11, 16)])
def test_plain_contour_min_d2_equals_jitted_reference(m, v):
    arrays = _contours(m, v, m * v)
    want = np.asarray(j_contour(*map(jnp.asarray, arrays)))
    np.testing.assert_array_equal(tref.contour_min_d2(*_t(*arrays)).numpy(), want)
    np.testing.assert_array_equal(ops.contour_min_d2(*_t(*arrays)).numpy(), want)


@pytest.mark.parametrize("name", ["rings", "replaced"])
@pytest.mark.parametrize("shard", [0, 3])
def test_update_pair_d2_equals_reference(batches, name, shard):
    """One dirty shard over poisoned rows: the patched matrix equals the
    reference's patch and the rebuild; the port patches in place."""
    jb, tb = batches[name]
    exact = np.asarray(jddc.contour_pair_d2_exact(jb, JCFG))
    stale = _poison(exact, [shard], 123.0)
    want = np.asarray(jddc.update_pair_d2(jnp.asarray(stale), jb, shard, JCFG))
    cached = torch.from_numpy(stale.copy())
    got = tddc.update_pair_d2(cached, tb, shard, TCFG)
    assert got is cached
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), exact)


def test_update_pair_d2_many_equals_reference(batches):
    """tests/test_hierarchy.py's case: dirty [1, 3, 6], the reference's
    power-of-two padding repeats the last shard; the port's result is the
    same with and without the repeat, and equals the sequential patch,
    the reference's batched patch and the rebuild."""
    jb, tb = batches["replaced"]
    dirty = list(REPLACED)
    exact = np.asarray(jddc.contour_pair_d2_exact(jb, JCFG))
    stale = _poison(np.asarray(jddc.contour_pair_d2_exact(batches["rings"][0], JCFG)),
                    dirty, 123.0)
    padded = dirty + [dirty[-1]]
    want = np.asarray(jddc.update_pair_d2_many(jnp.asarray(stale), jb,
                                               jnp.asarray(padded, jnp.int32), JCFG))
    seq = torch.from_numpy(stale.copy())
    for s in dirty:
        tddc.update_pair_d2(seq, tb, s, TCFG)
    for shards in (padded, dirty, torch.tensor([6, 1, 3, 1], dtype=torch.int32)):
        got = tddc.update_pair_d2_many(torch.from_numpy(stale.copy()), tb, shards, TCFG)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), seq.numpy())
    np.testing.assert_array_equal(want, exact)


def _merge_delta_both(batches, name, cached, dirty, exclude):
    jb, tb = batches[name]
    jex = None if exclude is None else jnp.asarray(exclude)
    tex = None if exclude is None else torch.from_numpy(exclude)
    j = jddc.merge_delta(jb, None if cached is None else jnp.asarray(cached), dirty, JCFG,
                         jex)
    t = tddc.merge_delta(tb, None if cached is None else torch.from_numpy(cached.copy()),
                         dirty, TCFG, tex)
    return j, t


def _assert_delta_equal(t, j):
    (tm, tmaps, td2), (jm, jmaps, jd2) = t, j
    np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))
    np.testing.assert_array_equal(tmaps.numpy(), np.asarray(jmaps))
    _assert_sets_equal(tm, jm)


EXCLUDE = np.array([False, False, True, False, False, False, False, False])


@pytest.mark.parametrize("case", ["multi_poisoned", "multi_replaced", "repeated",
                                  "single", "exclude", "none_dirty", "rebuild"])
def test_merge_delta_equals_reference_and_rebuild(batches, case):
    """merge_delta with a cached matrix equals the reference's merge_delta
    on the same inputs, and equals the rebuild (``pair_d2=None``): the
    matrix bit for bit, the maps and the merged ClusterSet."""
    name, dirty, exclude, value = {
        "multi_poisoned": ("rings", [0, 2, 5, 7], None, -1.0),
        "multi_replaced": ("replaced", list(REPLACED), None, None),
        "repeated": ("replaced", [1, 3, 6, 3], None, None),
        "single": ("rings", [3], None, 123.0),
        "exclude": ("replaced", list(REPLACED), EXCLUDE, None),
        "none_dirty": ("rings", [], None, None),
        "rebuild": ("replaced", None, EXCLUDE, None),
    }[case]
    base = np.asarray(jddc.contour_pair_d2_exact(batches["rings"][0], JCFG))
    if value is not None:
        cached = _poison(base, dirty, value)
    elif case == "rebuild":
        cached = None
    else:
        cached = base      # the matrix before shards 1, 3, 6 changed
    j, t = _merge_delta_both(batches, name, cached, dirty, exclude)
    _assert_delta_equal(t, j)
    rebuild = tddc.merge_delta(batches[name][1], None, None, TCFG,
                               None if exclude is None else torch.from_numpy(exclude))
    _assert_delta_equal(t, rebuild)
    if exclude is not None:
        assert (t[1].numpy()[exclude] == -1).all()


def test_merge_delta_equals_merge_many(batches):
    """The rebuild's maps and merged set are ``merge_many``'s (the square
    form), the ``delta_equals_full`` column of BENCH_serve.json."""
    _, tb = batches["replaced"]
    merged, maps, _ = tddc.merge_delta(tb, None, None, TCFG)
    want_merged, want_maps = tddc.merge_many(tb, TCFG)
    assert torch.equal(maps, want_maps)
    _assert_sets_equal(merged, want_merged)
