"""The port's plain kernel versions against the reference package's jnp
oracles (``repro.kernels.ref``), on the shapes of tests/test_kernels.py,
and the port's dispatch rules.  Runs on the CPU; the CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import contour_dist, ops, pairwise_dist  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.asarray(a))


class TestPairwise:
    @pytest.mark.parametrize("n,m", [(128, 128), (256, 128), (512, 512), (64, 64)])
    def test_dist_sweep(self, n, m):
        x = RNG.normal(size=(n, 2)).astype(np.float32)
        y = RNG.normal(size=(m, 2)).astype(np.float32)
        want = np.asarray(jref.pairwise_dist_sq(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose(tref.pairwise_dist_sq(t(x), t(y)).numpy(), want,
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("n", [64, 256, 1024])
    def test_dist_is_the_jitted_form(self, n):
        """Bit for bit the jitted reference's d2: XLA contracts both depth-2
        sums (|x|² and x·y) into an FMA, and the port computes that single
        rounding.  The FMA-free form differs in the last bit, which at
        scale moves points across the eps boundary."""
        x = np.random.default_rng(n).uniform(0, 1, (n, 2)).astype(np.float32)
        want = np.asarray(jax.jit(jref.pairwise_dist_sq)(jnp.asarray(x), jnp.asarray(x)))
        np.testing.assert_array_equal(tref.pairwise_dist_sq(t(x), t(x)).numpy(), want)
        xx = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
        dot = x[:, None, 0] * x[None, :, 0] + x[:, None, 1] * x[None, :, 1]
        fma_free = np.maximum((xx[:, None] + xx[None, :]) - np.float32(2) * dot, 0)
        assert (fma_free != want).any()

    def test_fma_rounds_once(self):
        """fma_f32 against exact rational arithmetic, including sums that
        a float64 evaluation alone would round twice."""
        from fractions import Fraction
        rng = np.random.default_rng(5)
        a = rng.uniform(0.5, 1, 2000).astype(np.float32)
        b = rng.uniform(0.5, 1, 2000).astype(np.float32)
        c = (rng.uniform(0.5, 1, 2000) * 2.0 ** rng.integers(-40, 2, 2000)).astype(np.float32)
        # (1 + 2^-12)² is a float32 midpoint and ±2^-60 is below float64's
        # half ulp there: a float64 sum alone would round to the tie.
        a, b, c = (np.append(v, np.float32(w)) for v, w in (
            (a, [1 + 2**-12] * 2), (b, [1 + 2**-12] * 2), (c, [2**-60, -2**-60])))
        got = tref.fma_f32(t(a), t(b), t(c)).numpy()
        assert got[-2] == np.float32(1 + 2**-11 + 2**-23) and got[-1] == np.float32(1 + 2**-11)
        for x, y, z, g in zip(a, b, c, got):
            exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
            lo = np.float32(float(exact))
            cands = [lo, np.nextafter(lo, np.float32(-np.inf)), np.nextafter(lo, np.float32(np.inf))]
            best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                             int(np.float32(v).view(np.int32)) & 1))
            assert g == best

    @pytest.mark.parametrize("eps", [0.1, 0.5, 2.0])
    def test_neighbor_count(self, eps):
        # The reference squares a traced (float32) eps inside jit, which is
        # what the port always does: hand it a float32 eps.
        x = RNG.normal(size=(256, 2)).astype(np.float32)
        mask = RNG.random(256) > 0.3
        want = jref.neighbor_count(jnp.asarray(x), jnp.asarray(mask), jnp.float32(eps))
        got = tref.neighbor_count(t(x), t(mask), eps)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("eps,n", [(0.4, 128), (0.25, 300)])
    def test_min_label_sweep(self, eps, n):
        x = RNG.normal(size=(n, 2)).astype(np.float32)
        mask = RNG.random(n) > 0.2
        labels = RNG.permutation(n).astype(np.int32)
        labels[::5] = tref.SENTINEL
        core = RNG.random(n) > 0.5
        want = jref.min_label_sweep(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(labels),
                                    jnp.asarray(core), eps)
        got = tref.min_label_sweep(t(x), t(mask), t(labels), t(core), eps)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_row_chunks_change_no_bit(self, monkeypatch):
        x = t(RNG.normal(size=(300, 2)).astype(np.float32))
        mask = t(RNG.random(300) > 0.1)
        whole = tref.neighbor_count(x, mask, 0.3)
        monkeypatch.setattr(tref, "ROW_CHUNK", 7)
        assert torch.equal(tref.neighbor_count(x, mask, 0.3), whole)

    def test_eps_squared_in_float32(self):
        e = 0.1
        assert tref.eps_sq_f32(e) == float(np.float32(e) * np.float32(e))
        assert tref.eps_sq_f32(e) != float(np.float32(e * e))


def _np_fma(a, b, c):
    """float32 fma(a, b, c) in NumPy: a·b exact in float64, the sum
    rounded to odd (TwoSum's error sets the last bit), then to float32."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    odd = np.where((err != 0) & (s.view(np.int64) & 1 == 0),
                   np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return odd.astype(np.float32)


def _contours(m, v, seed):
    rng = np.random.default_rng(seed)
    contours = rng.uniform(0, 1, (m, v, 2)).astype(np.float32)
    counts = rng.integers(0, v + 1, m).astype(np.int32)
    valid = rng.random(m) > 0.25
    return contours, counts, valid


class TestContourMinD2:
    @pytest.mark.parametrize("m,v", [(16, 32), (32, 64), (8, 16), (24, 8), (11, 16)])
    def test_sweep(self, m, v):
        """Bit for bit the jnp oracle: XLA's CPU backend contracts the
        oracle's dx·dx + dy·dy into fma(dy, dy, dx·dx), rounded once, and
        the port (and its CUDA kernel) computes that rounding."""
        contours, counts, valid = _contours(m, v, m * v)
        want = np.asarray(jref.contour_min_d2(jnp.asarray(contours), jnp.asarray(counts),
                                              jnp.asarray(valid)))
        got = tref.contour_min_d2(t(contours), t(counts), t(valid)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("m,v", [(16, 32), (11, 16)])
    def test_exact_difference_form(self, m, v):
        """Bit-exact against the float32 difference form in NumPy, d2 =
        fma(dy, dy, dx·dx) rounded once — the expression the CUDA kernel
        reproduces — built as ``ref.fma_f32`` builds it: dy·dy exact in
        float64, the float64 sum rounded to odd, then once to float32 (a
        float64 sum rounded to nearest could round twice)."""
        contours, counts, valid = _contours(m, v, m + v)
        vv = (np.arange(v)[None, :] < counts[:, None]) & valid[:, None]
        want = np.full((m, m), np.float32(1e30))
        for i in range(m):
            for j in range(m):
                d = contours[i][:, None, :] - contours[j][None, :, :]
                d2 = _np_fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0])
                d2 = np.where(vv[i][:, None] & vv[j][None, :], d2, np.float32(1e30))
                want[i, j] = d2.min()
        got = tref.contour_min_d2(t(contours), t(counts), t(valid)).numpy()
        np.testing.assert_array_equal(got, want)
        dx = contours[:, :, None, None, 0] - contours[None, None, :, :, 0]
        dy = contours[:, :, None, None, 1] - contours[None, None, :, :, 1]
        assert (dx * dx + dy * dy != _np_fma(dy, dy, dx * dx)).any()  # the FMA-free form

    def test_empty_slots_get_big(self):
        m, v = 8, 16
        out = tref.contour_min_d2(torch.zeros((m, v, 2)), torch.zeros(m, dtype=torch.int32),
                                  torch.zeros(m, dtype=torch.bool))
        want = np.asarray(jref.contour_min_d2(jnp.zeros((m, v, 2)), jnp.zeros(m, jnp.int32),
                                              jnp.zeros(m, bool)))
        np.testing.assert_array_equal(out.numpy(), want)
        assert (out.numpy() == np.float32(1e30)).all()


class TestDispatch:
    def test_cpu_tensors_never_launch(self):
        ops.reset_launch_counts()
        x = t(RNG.normal(size=(64, 2)).astype(np.float32))
        mask = torch.ones(64, dtype=torch.bool)
        lab = torch.arange(64, dtype=torch.int32)
        core = torch.ones(64, dtype=torch.bool)
        c, cnt, val = (t(a) for a in _contours(6, 8, 1))
        assert torch.equal(ops.neighbor_count(x, mask, 0.3), tref.neighbor_count(x, mask, 0.3))
        assert torch.equal(ops.min_label_sweep(x, mask, lab, core, 0.3),
                           tref.min_label_sweep(x, mask, lab, core, 0.3))
        assert torch.equal(ops.contour_min_d2(c, cnt, val), tref.contour_min_d2(c, cnt, val))
        assert torch.equal(ops.cross_min_d2(c[:2], cnt[:2], val[:2], c, cnt, val),
                           tref.cross_min_d2(c[:2], cnt[:2], val[:2], c, cnt, val))
        assert torch.equal(pairwise_dist.neighbor_count(x, mask, 0.3),
                           tref.neighbor_count(x, mask, 0.3))
        assert torch.equal(contour_dist.contour_min_d2(c, cnt, val),
                           tref.contour_min_d2(c, cnt, val))
        assert torch.equal(ops.pairwise_dist_sq(x, x[:5]), tref.pairwise_dist_sq(x, x[:5]))
        assert ops.launch_counts() == {
            "neighbor_count": 0, "min_label_sweep": 0, "neighbor_count_sparse": 0,
            "min_label_sweep_sparse": 0, "pairwise_dist_sq": 0, "contour_min_d2": 0,
            "cross_min_d2": 0, "flash_attention": 0, "ssd_scan": 0, "dispatch_gather": 0}
        assert not ops.use_gpu_kernels(x)

    def test_force_ref_keeps_plain_versions(self, monkeypatch):
        monkeypatch.setattr(ops, "FORCE", "ref")
        x = torch.zeros((4, 2))
        assert not ops.use_gpu_kernels(x)
        assert ops.neighbor_count(x, torch.ones(4, dtype=torch.bool), 0.1).tolist() == [4] * 4

    def test_other_devices_raise(self):
        x = torch.zeros((4, 2), device="meta")
        mask = torch.ones(4, dtype=torch.bool, device="meta")
        with pytest.raises(ValueError):
            pairwise_dist.neighbor_count(x, mask, 0.1)
        with pytest.raises(ValueError):
            contour_dist.contour_min_d2(torch.zeros((2, 4, 2), device="meta"),
                                        torch.zeros(2, dtype=torch.int32, device="meta"),
                                        torch.zeros(2, dtype=torch.bool, device="meta"))
        side = (torch.zeros((2, 4, 2), device="meta"),
                torch.zeros(2, dtype=torch.int32, device="meta"),
                torch.zeros(2, dtype=torch.bool, device="meta"))
        with pytest.raises(ValueError):
            contour_dist.cross_min_d2(*side, *side)


@pytest.mark.parametrize("v,slots,staged", [(128, 256, False), (128, 28_000, False),
                                            (128, 29_000, True), (128, 32_768, True),
                                            (2048, 27_500, True), (2048, 26_000, False),
                                            (16, 1, False)])
def test_contour_dist_stages_lists_past_shared_memory(v, slots, staged):
    """B5's square wrapper keeps the slot lists in shared memory while v
    row vertices, the block min and 2 ints a slot fit 227 KB, and otherwise
    hands the kernel a scratch buffer of 2 ints a slot and the list's
    length (the staged entry: a 512-lane fold has 32,768 slots); a row of
    vertices past shared memory raises."""
    buf = contour_dist._staged(v, slots, torch.device("cpu"))
    assert (buf is not None) == staged
    if staged:
        assert buf.dtype == torch.int32 and buf.shape == (2 * slots + 1,)
    with pytest.raises(ValueError, match="shared memory"):
        contour_dist._staged(29_100, 1, torch.device("cpu"))
