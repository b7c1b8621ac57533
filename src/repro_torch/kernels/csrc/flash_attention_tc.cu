// Forward attention on Hopper's tensor cores (wgmma), for bfloat16 inputs
// with head dim 64 or 128 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
//   flash_attention (_flash_kernel)
// for bfloat16 q, k, v with d in {64, 128}; float32 inputs and every other
// head dim take csrc/flash_attention.cu (IEEE float32 on the CUDA cores).
//
// What it computes: out[b, h, r] = softmax_k(scale * q[b, h, r] . k[b, h // rep, k])
// . v[b, h // rep, k] over the visible keys k, as flash_attention.cu does: GQA
// (head h reads kv head h // rep), right-aligned positions (query row r sits
// at skv - sq + r), an optional causal mask and an optional sliding window
// (keys in (pos - window, pos]), ragged sq and skv masked here, q, k and v
// read in place at any 16-byte-aligned strides over (batch, head, seq) with a
// contiguous last axis.  The output (b, h, sq, d) is bfloat16.
//
// What bounds it: 4 * d operations per visible (query, key) pair against
// 2 * (b*h*sq*d + 2*b*hkv*skv*d) bytes: at the LM prefill shapes (s = 2048,
// d = 128) about 2,000 operations per byte, far above the ~295 at which the
// bf16 tensor cores (989 TFLOP/s) rather than HBM (3.35 TB/s) are the limit.
// So the design feeds the tensor cores and keeps everything else off their
// path.
//
// Design.
// - One block per (head, batch, 128-row query tile); the query tiles are
//   numbered from the last, so the causal tiles with the most keys start
//   first and the short ones fill the tail.  384 threads: two consumer
//   warpgroups of 64 query rows each, and a producer warpgroup that hands
//   its registers to them (setmaxnreg 24 / 240) and issues every copy from
//   one thread.
// - The producer loads the block's q tile once and then the k and v tiles
//   of 128 keys into a ring of 3 stages with TMA (cp.async.bulk.tensor,
//   4-D tensor maps over (d, seq, head, batch) built from each call's
//   strides), each stage signalled by an mbarrier that counts the bytes
//   (full) and released by the 256 consumer threads (empty).  TMA writes the
//   128-byte swizzle that wgmma reads, one 64-column atom at a time, and fills
//   rows past sq or skv with zeros, so the ragged edge needs no copy.
// - Each consumer warpgroup computes S = q k^T for its 64 rows as d/16
//   wgmma m64n128k16 (q and k from shared memory, k's (keys, d) tile the
//   K-major B operand), float32 accumulators in registers.  The online
//   softmax runs on those registers in log2 units (scale * log2 e folded
//   into one FMA before exp2f): each row's max is reduced over the 4 lanes
//   that hold it with shuffles; its running sum stays per thread and is
//   reduced once at the end.  The causal, window and ragged masks are
//   applied only on the tiles that cross a boundary; tiles that hold no
//   visible key for the block are never loaded.
// - Each warpgroup keeps the tensor cores busy through its softmax: tile
//   i's q k^T and tile i-1's P v are issued together, and tile i's softmax
//   (float32, in place) runs once its S is in, while P v is still in
//   flight; then O is rescaled, tile i-1's stage released and tile i's P
//   split into the registers P v reads.
// - P never leaves the registers: the S accumulator's fragment layout is
//   wgmma's register A layout, so P is converted in place.  P rounded once
//   to bf16 moves the output by up to 2^-9 of each weight, which breaks the
//   one-bf16-ulp gate against the float32 plain version on some outputs
//   (chip_smoke.py's bf16_tol; tests/test_torch_flash_tc.py shows it on a
//   qwen3-shaped case); so P is split into p_hi = bf16(p) and
//   p_lo = bf16(p - p_hi), and O += P v runs as two wgmma m64n{d}k16 per 16
//   keys into the same float32 accumulator, with v's (keys, d) tile as the
//   MN-major B operand (the transpose bit; no transposed copy of v).  The
//   q k^T products of bf16 values are exact in float32, so p_lo is the only
//   extra work the gate costs (1.5x the tensor-core operations).
// - Every sum runs in a fixed order and no atomics are used: the output is
//   deterministic.  A row that sees no key at all (only when sq > skv) is
//   written as 0, as flash_attention.cu writes it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 128;                   // query rows per block
constexpr int kBK = 128;                   // keys per kv tile
constexpr int kStages = 3;                 // the k/v ring
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128; // and the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: q (kBQ rows), then per stage k and v (kBK rows each), each
// stored as d/64 swizzled atoms of (rows x 128 bytes), then the mbarriers.
template <int D>
struct Layout {
  static constexpr int kAtoms = D / 64;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;  // k or v
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

struct Params {
  void* out;  // (b, h, sq, d) contiguous bf16
  int h, hkv, sq, skv, n_qtiles;
  float scale_log2;  // scale * log2(e)
  int causal;
  int window;  // 0: no window
};


// wgmma wrappers.  _ss: A and B from shared memory (acc = 0 overwrites D);
// _rs_..._tb: A from four registers of packed bf16 pairs, B from shared
// memory MN-major (the transpose bit), always accumulating.

__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n64_tb(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n128_tb(o, a, db);
}


// Issue S = q k^T for a warpgroup's 64 rows: d / 16 steps of 16 along d;
// step kk lies in atom kk / 4 at byte 32 (kk % 4) of each 128-byte row.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], uint32_t q_wg, uint32_t k_st) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t dq = desc_sw128(q_wg + (kk >> 2) * kBQ * 128 + off, 16, 1024);
    const uint64_t dk = desc_sw128(k_st + (kk >> 2) * kBK * 128 + off, 16, 1024);
    wgmma_ss_m64n128(sc, dq, dk, kk > 0);
  }
  wg_commit();
}

// Issue O += P v: step kk takes keys 16 kk .. 16 kk + 15, two 8-row groups
// (1024 bytes apart) of every atom; the atoms along d lie kBK * 128 bytes
// apart.  p_hi and p_lo go into the same accumulator.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&ph)[kBK / 16][4],
                                         const uint32_t (&pl)[kBK / 16][4], uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dv = desc_sw128(v_st + kk * 16 * 128, kBK * 128, 1024);
    wgmma_pv<D>(o, ph[kk], dv);
    wgmma_pv<D>(o, pl[kk], dv);
  }
  wg_commit();
}

// Where this thread's rows and keys lie: sc[4 j + e] is row r_in + 8 (e / 2)
// (position qpos0 + 8 (e / 2)) at key k0 + 8 j + col0 + (e % 2).
struct Rows {
  int qpos0, col0, q_first, q_last;  // q_first / q_last: the warpgroup's first / last position
};

// One kv tile's softmax step on the S accumulator, in place: the masks
// (only on a tile that crosses an edge), the running max m and sum l in
// log2 units, alpha = the factor that rescales O, and sc = P = exp2(c s -
// c m) in float32.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Params& a, const Rows& w,
                                             int k0) {
  const float c = a.scale_log2;
  const bool edge = k0 + kBK > a.skv || (a.causal && k0 + kBK - 1 > w.q_first) ||
                    (a.window > 0 && k0 <= w.q_last - a.window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + w.col0 + (e & 1);
        const int qpos = w.qpos0 + 8 * (e >> 1);
        bool ok = kpos < a.skv;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        if (!ok) sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mu[r] = mx[r] == -INFINITY ? 0.f : mx[r] * c;  // nothing visible yet: p = 0
    alpha[r] = exp2f(m[r] * c - mu[r]);            // 0 while m was -inf
    m[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = exp2f(fmaf(sc[4 * j + e], c, -mu[e >> 1]));
      rs[e >> 1] += sc[4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// P as bf16 hi + lo pairs in wgmma's register A layout: register q of step
// kk holds row r_in + 8 (q % 2) at keys 16 kk + 8 (q / 2) + col0 + {0, 1},
// which is p[4 (2 kk + q / 2) + 2 (q % 2) + {0, 1}].
__device__ __forceinline__ void split_p(const float (&p)[kBK / 2], uint32_t (&ph)[kBK / 16][4],
                                        uint32_t (&pl)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = 4 * (2 * kk + (q >> 1)) + 2 * (q & 1);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p[e], p[e + 1]);
      const float2 hf = __bfloat1622float2(hi);
      ph[kk][q] = bits(hi);
      pl[kk][q] = bits(__floats2bfloat162_rn(p[e] - hf.x, p[e + 1] - hf.y));
    }
}

// A consumer warpgroup's whole loop: query rows q0w .. q0w + 63 of the
// block's tile, over kv tiles t_begin .. t_end - 1 of the ring.  The
// tensor cores work while the softmax runs: tile i's q k^T and tile i - 1's
// P v are issued together, tile i's softmax (in float32, in place) runs as
// soon as its S is in, while P v is still in flight; then O is rescaled,
// tile i - 1's stage is released and tile i's P is split into the bf16
// registers that P v reads (never written while a P v is in flight).
template <int D>
__device__ __forceinline__ void consume(const Params& a, uint32_t q_s, uint32_t kv_s,
                                        uint32_t q_full, uint32_t full0, uint32_t empty0, int hh,
                                        int bb, int q0, int q_off, int t_begin, int t_end) {
  using L = Layout<D>;
  const int tid = threadIdx.x;
  // This thread holds rows r_in and r_in + 8 of the warpgroup's 64 (r_in =
  // 16 warp + lane / 4), and in every group of 8 columns the two at 2 (lane % 4).
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0w = q0 + 64 * wg;
  const int r_in = 16 * warp + (lane >> 2);
  const Rows w{q_off + q0w + r_in, 2 * (lane & 3), q_off + q0w, q_off + q0w + 63};

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_wg = q_s + wg * 64 * 128;
  mbar_wait(q_full, 0);

  const int n = t_end - t_begin;
  if (n > 0) {
    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
    {
      float sc[kBK / 2], alpha[2];
      mbar_wait(full0, 0);
      wg_fence();
      issue_qk<D>(sc, q_wg, kv_s);
      wg_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, m, l, alpha, a, w, t_begin * kBK);  // O is 0: alpha unused
      split_p(sc, ph, pl);
    }
    for (int i = 1; i < n; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      const uint32_t k_st = kv_s + s * L::kStageBytes;
      const uint32_t v_prev = kv_s + sp * L::kStageBytes + L::kTileBytes;
      float sc[kBK / 2], alpha[2];
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      wg_fence();
      issue_qk<D>(sc, q_wg, k_st);
      issue_pv<D>(o, ph, pl, v_prev);
      wg_wait<1>();  // q k^T is in; P v may still run
      fence_regs(sc);
      softmax_tile(sc, m, l, alpha, a, w, (t_begin + i) * kBK);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
      mbar_arrive(empty0 + 8 * sp);
      split_p(sc, ph, pl);
    }
    const int sl = (n - 1) % kStages;
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wg_fence();
    issue_pv<D>(o, ph, pl, kv_s + sl * L::kStageBytes + L::kTileBytes);
    wg_wait<0>();
    fence_regs(o);
    mbar_arrive(empty0 + 8 * sl);
  }

  // The row sums over the 4 lanes of each row (the same bits in all four),
  // then the output.
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       (static_cast<long long>(bb) * a.h + hh) * a.sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0w + r_in + 8 * r;
    if (row >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float y0 = l[r] > 0.f ? o[4 * j + 2 * r] / l[r] : 0.f;
      const float y1 = l[r] > 0.f ? o[4 * j + 2 * r + 1] / l[r] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(&out[static_cast<long long>(row) * D + 8 * j + w.col0]) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params a) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms need 1024
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQBytes;
  const uint32_t q_full = base + L::kBarOffset;
  const uint32_t full0 = q_full + 8;               // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;     // empty[s] = empty0 + 8 s

  const int tid = threadIdx.x;
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int q0 = (a.n_qtiles - 1 - static_cast<int>(blockIdx.z)) * kBQ;  // heaviest first
  const int kh = hh / (a.h / a.hkv);
  const int q_off = a.skv - a.sq;  // right-aligned positions

  // The kv tiles that hold a visible key for some row of this block.
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  int kv_end = a.skv;
  if (a.causal) kv_end = min(kv_end, q_off + q_last + 1);
  int kv_begin = 0;
  if (a.window > 0) kv_begin = max(0, q_off + q0 - a.window + 1);
  const int t_begin = kv_begin / kBK;
  const int t_end = kv_end > kv_begin ? (kv_end + kBK - 1) / kBK : t_begin;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warpgroup gives its registers to the consumers; one of
    // its threads issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int j = 0; j < L::kAtoms; ++j) tma_load_4d(q_s + j * kBQ * 128, &tq, q_full, 64 * j, q0, hh, bb);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty0 + 8 * s, (i / kStages - 1) & 1);
        const uint32_t stage = kv_s + s * L::kStageBytes;
        mbar_expect_tx(full0 + 8 * s, L::kStageBytes);
#pragma unroll
        for (int j = 0; j < L::kAtoms; ++j) {
          tma_load_4d(stage + j * kBK * 128, &tk, full0 + 8 * s, 64 * j, t * kBK, kh, bb);
          tma_load_4d(stage + L::kTileBytes + j * kBK * 128, &tv, full0 + 8 * s, 64 * j, t * kBK,
                      kh, bb);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D>(a, q_s, kv_s, q_full, full0, empty0, hh, bb, q0, q_off, t_begin, t_end);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int h, int hkv, int sq,
           int skv, const long long* st, float scale, int causal, int window,
           cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, fn, q, D, sq, h, b, st[2], st[1], st[0], kBQ);
  if (e == 0) e = encode(&tk, fn, k, D, skv, hkv, b, st[5], st[4], st[3], kBK);
  if (e == 0) e = encode(&tv, fn, v, D, skv, hkv, b, st[8], st[7], st[6], kBK);
  if (e != 0) return e;
  const int smem = Layout<D>::kBytes;
  cudaError_t ce = cudaFuncSetAttribute(flash_tc_kernel<D>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
  Params p{out, h, hkv, sq, skv, n_qtiles, scale * kLog2e, causal, window};
  dim3 grid(h, b, n_qtiles);
  flash_tc_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (b, h, sq, d); k, v: (b, hkv, skv, d), bf16, each with the given
// element strides over its first three axes (multiples of 8, the pointers
// 16-byte aligned; a stride over an axis of extent 1 may be any such value)
// and a contiguous last axis; out: (b, h, sq, d) contiguous bf16.  d is 64
// or 128, h % hkv == 0, window >= 0 (0: none).  Returns 0, a CUDA error
// (cudaGetLastError() after the launch), or one of this file's codes above.
int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out, int b, int h,
                              int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss, float scale,
                              int causal, int window, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return (int)cudaGetLastError();
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k, v, out, b, h, hkv, sq, skv, st, scale, causal, window, s);
  if (d == 128) return launch<128>(q, k, v, out, b, h, hkv, sq, skv, st, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_tc_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
