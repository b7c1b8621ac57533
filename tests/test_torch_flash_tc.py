"""The tensor-core route of the port's flash attention (B7), on the CPU.

``csrc/flash_attention_tc.cu`` runs only on the card, where
tests/test_torch_gpu.py and chip_smoke.py hold it against the plain
version.  Here:

- ``flash_attention.route`` is held to its rule (bfloat16 at head dim 64,
  96 or 128 takes the tensor cores, everything else the float32 CUDA-core
  kernel) for every dtype and head dim that chip_smoke.py's FLASH_SWEEP
  and the ten configurations use;
- ``_tc_numerics`` repeats the kernel's arithmetic in plain torch: bf16
  q·k products summed in float32, an online softmax over 128-key tiles in
  log2 units, P split into p_hi = bf16(p) and p_lo = bf16(p − p_hi), both
  multiplied by v and accumulated in float32 (at d 96 too: the kernel's
  P·v is an n96 product over v's three 32-column atoms), the output
  rounded once to bf16.  It must sit within chip_smoke.py's
  ``bf16_tol`` (one bf16 ulp: rtol 2^-7, atol 2^-12·max|plain|) of the
  port's ``ref.flash_attention`` and of the reference package's
  ``ref.flash_attention`` on the same numpy inputs, on the sweep's bf16
  tensor-core cases, a qwen3-8b-shaped causal case and an MLA-shaped one
  (h = hkv, v zero-padded from 64 to 96 as ``layers.mla_apply`` pads it,
  scale 1/√96, ragged lengths);
- the same arithmetic with P rounded once to bf16 (no p_lo) breaks that
  gate on the qwen3-8b-shaped case: that is why the kernel splits P;
- a CUDA tensor goes to the kernel of its route and nowhere else: a launch
  error raises, and no other route is tried.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

BK = 128  # the kernel's kv tile
LOG2E = 1.4426950408889634

# chip_smoke.py's bf16 FLASH_SWEEP cases that take the tensor cores (d 64,
# 96 and 128): GQA, MQA, non-causal, windowed, ragged sq and skv, sq < 64
# and a decode query against a cache.  (b, h, hkv, sq, skv, d, causal, window)
TC_SWEEP = [
    (1, 4, 2, 100, 173, 64, True, 50),
    (1, 32, 8, 300, 300, 128, True, None),
    (2, 8, 2, 128, 256, 128, True, None),
    (1, 4, 1, 256, 256, 64, True, None),
    (1, 2, 2, 128, 128, 128, False, None),
    (1, 2, 2, 192, 192, 64, True, 32),
    (1, 2, 2, 300, 300, 128, True, 100),
    (1, 4, 2, 100, 173, 128, True, None),
    (1, 4, 2, 200, 333, 64, False, None),
    (1, 4, 4, 33, 70, 128, True, None),
    (2, 8, 2, 1, 300, 128, True, None),
    (1, 4, 4, 1, 77, 64, True, None),
    (2, 32, 8, 200, 200, 128, True, None),
    (1, 4, 2, 150, 150, 64, True, 64),
    (1, 8, 2, 256, 256, 96, True, None),
    (1, 4, 4, 100, 173, 96, True, None),
    (1, 2, 2, 300, 300, 96, True, 100),
    (2, 8, 8, 1, 300, 96, True, None),
]
QWEN3_SHAPE = (1, 32, 8, 512, 512, 128, True, None)
# MLA as minicpm3-4b hands it over: h = hkv, qk dim 96 = nope 64 + rope 32,
# v 64 wide padded with zeros to 96, scale 1/√96, causal; sq and skv not
# multiples of the kernel's 128-row tiles.
MLA_SHAPE = (2, 8, 8, 200, 333, 96, True, None)
MLA_V_DIM = 64


def _tc_numerics(q, k, v, *, causal=True, window=None, split=True, scale=None):
    """The tensor-core kernel's arithmetic in plain torch (see the module
    docstring); ``split=False`` rounds P once to bf16."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = h // hkv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -torch.inf)
    c = (scale if scale is not None else 1.0 / math.sqrt(d)) * LOG2E
    m = torch.full((b, h, sq, 1), -torch.inf)
    l_sum = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, skv, BK):
        st = s[..., k0:k0 + BK]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        mu = torch.where(m_new == -torch.inf, 0.0, m_new * c)
        alpha = torch.exp2(m * c - mu)
        p = torch.exp2(st * c - mu)
        p_hi = p.bfloat16().float()
        pv = p_hi + (p - p_hi).bfloat16().float() if split else p_hi
        l_sum = l_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + pv @ vf[..., k0:k0 + BK, :]
        m = m_new
    out = torch.where(l_sum > 0, acc / l_sum, 0.0)
    return out.to(torch.bfloat16)


def _inputs(case, seed):
    b, h, hkv, sq, skv, d, _, _ = case
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    return [torch.from_numpy(a).bfloat16() for a in arrays]


def _violations(got, want) -> int:
    """Entries outside chip_smoke.py's bf16_tol of ``want``."""
    g, w = got.double(), want.double()
    atol = 2.0 ** -12 * float(w.abs().max())
    return int(((g - w).abs() > atol + 2.0 ** -7 * w.abs()).sum())


def _jax_ref(q, k, v, causal, window, scale=None):
    args = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    out = jref.flash_attention(*args, causal=causal, window=window, scale=scale)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).bfloat16()


# chip_smoke.py's FLASH_SWEEP head dims, float32 and bfloat16.
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_by_dtype_and_head_dim(dtype, d):
    want = "tc" if dtype == torch.bfloat16 and d in (64, 96, 128) else "simt"
    assert tfa.route(dtype, d) == want


@pytest.mark.parametrize("arch", configs.all_archs())
def test_route_of_each_configuration(arch):
    """The head dim each configuration hands the attention kernel: the
    served bf16 models with GQA heads of 128 (qwen3-8b, llama4-scout,
    jamba, ...), whisper's 64 and minicpm3's MLA, which pads v to its q/k
    dim of 96, take the tensor cores; float32 always takes the CUDA cores;
    mamba2 has no attention layer."""
    cfg = configs.get_config(arch)
    if not any(kind == "attn" for kind, _ in cfg.layer_kinds()):
        assert arch == "mamba2-1.3b"
        return
    d = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.attn_kind == "mla" else cfg.head_dim
    assert (d == 96) == (arch == "minicpm3-4b")
    assert tfa.route(torch.bfloat16, d) == "tc"
    assert tfa.route(torch.float32, d) == "simt"


@pytest.mark.parametrize("case", TC_SWEEP + [QWEN3_SHAPE])
def test_tc_numerics_within_one_bf16_ulp(case):
    q, k, v = _inputs(case, sum(case[:6]))
    causal, window = case[6], case[7]
    assert tfa.route(q.dtype, q.shape[-1]) == "tc"
    got = _tc_numerics(q, k, v, causal=causal, window=window)
    want = tref.flash_attention(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _violations(got, want) == 0
    assert _violations(got, _jax_ref(q, k, v, causal, window)) == 0


def test_tc_numerics_mla_padded_v_within_one_bf16_ulp():
    """MLA's layout at d 96: the 64-wide v padded with zeros to the qk dim;
    the padded columns of the output stay 0."""
    b, h, hkv, sq, skv, d, causal, window = MLA_SHAPE
    rng = np.random.default_rng(sum(MLA_SHAPE[:6]))
    q, k = (torch.from_numpy(rng.normal(size=(b, n, s, d)).astype(np.float32)).bfloat16()
            for n, s in ((h, sq), (hkv, skv)))
    v = torch.from_numpy(rng.normal(size=(b, hkv, skv, MLA_V_DIM)).astype(np.float32))
    v = torch.nn.functional.pad(v.bfloat16(), (0, d - MLA_V_DIM))
    scale = 1.0 / math.sqrt(d)
    assert tfa.route(q.dtype, d) == "tc"
    got = _tc_numerics(q, k, v, causal=causal, window=window, scale=scale)
    want = tref.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    assert got.shape == want.shape == (b, h, sq, d)
    assert not got[..., MLA_V_DIM:].any()
    assert _violations(got, want) == 0
    assert _violations(got, _jax_ref(q, k, v, causal, window, scale)) == 0


def test_p_rounded_once_breaks_the_gate():
    """Without p_lo the output moves by up to 2^-9 of each weight, more
    than one bf16 ulp on some of the qwen3-8b-shaped case's outputs."""
    q, k, v = _inputs(QWEN3_SHAPE, sum(QWEN3_SHAPE[:6]))
    want = tref.flash_attention(q, k, v, causal=True)
    assert _violations(_tc_numerics(q, k, v, causal=True, split=False), want) > 0
    assert _violations(_tc_numerics(q, k, v, causal=True), want) == 0


# Each case keeps the id it was collected under: MLA's bf16 d 96 case was
# "dtype2-96-simt" before d 96 took the tensor cores.
@pytest.mark.parametrize("dtype,d,kind", [(torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
                                          pytest.param(torch.bfloat16, 96, "tc",
                                                       id="dtype2-96-simt"),
                                          (torch.float32, 128, "simt")])
def test_cuda_tensors_launch_their_routes_kernel_only(monkeypatch, dtype, d, kind):
    """The wrapper's dispatch, without a card: a (stand-in) CUDA tensor is
    launched on its route's kernel once, and that kernel's launch error
    reaches the caller; the other route is never tried."""
    q = types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype, shape=(1, 2, 8, d))
    tried = []

    def launch(route, *args):
        tried.append(route)
        raise _build.KernelLaunchError(f"{route}: refused")

    monkeypatch.setattr(tfa, "_check", lambda *args: None)
    monkeypatch.setattr(tfa, "_launch", launch)
    before = dict(tfa.route_launches)
    with pytest.raises(_build.KernelLaunchError, match=kind):
        tfa.flash_attention(q, q, q)
    assert tried == [kind] and tfa.route_launches == before
