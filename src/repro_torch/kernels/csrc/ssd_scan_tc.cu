// Mamba-2 SSD chunked scan on Hopper's tensor cores (wgmma), for bfloat16
// inputs with head dim 64 and state size 128 (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:
//   ssd_scan (_ssd_kernel)
// for bfloat16 x, b, c at (dh, ds) = (64, 128), the shape of Mamba-2 1.3B's
// and Jamba's SSM heads; float32 inputs and every other shape take
// csrc/ssd_scan.cu (IEEE float32 on the CUDA cores).
//
// What it computes: for every (batch, head), the recurrence
//   S_t = exp(a_t) S_{t-1} + b_t^T x_t      (ds, dh), S_0 = 0
//   y_t = c_t S_t
// in the chunked (dual) form, as ssd_scan.cu does, at a chunk of 64 steps:
//   y_i = exp(cum_i) c_i S_in + sum_{j <= i} exp(cum_i - cum_j) (c_i . b_j) x_j
//   S   = exp(cum_last) S_in + sum_j exp(cum_last - cum_j) b_j^T x_j
// with cum the inclusive running sum of a inside the chunk (a float32).  x,
// b and c are read in place at any 16-byte-aligned strides over (batch,
// step, head) with a contiguous last axis; an axis of stride 0 (the Mamba
// layer's c, broadcast over the heads) is read once through a map of extent
// 1 there.  y (bsz, l, h, 64) is bfloat16, rounded once from float32.
//
// What bounds it: the inputs are read once and y written once, 2 (2 dh +
// 2 ds) + 4 bytes per (batch, step, head) (less where c is broadcast); the
// tensor cores issue about 6.3 M operations per chunk (below), 0.052 ms at
// the Mamba-2 1.3B prefill shape against 0.081 ms for the bytes at 3.35
// TB/s.  So the design keeps the copies in flight and the chunk loop's
// serial chain short.
//
// Design.
// - One block per (head, batch); the chunk loop runs inside it, as the TPU
//   kernel's sequential grid axis does.  288 threads: a producer warp and
//   two consumer warpgroups.
// - The producer keeps a ring of 3 stages in flight: per chunk, c and b
//   (64 x 128, two 64-column atoms each) and x (64 x 64) by TMA in the
//   128-byte swizzle that wgmma reads (rows past l read as zeros), and a's
//   64 floats by ordinary loads (0 past l).  A stage's full mbarrier counts
//   the TMA bytes and the 32 lanes' arrivals; its empty mbarrier the 256
//   consumer threads.  Padded rows (a = 0, b = c = x = 0) change no valid
//   row and no state.
// - Each consumer warp forms cum with a shuffle scan in a fixed order (lane
//   l holds steps 2l and 2l + 1: pair sums, an inclusive scan over the
//   lanes, then cum[2l] = prefix + a[2l], cum[2l + 1] = cum[2l] + a[2l + 1])
//   and reads the entries it needs by shuffles.
// - Warpgroup 0 computes y.  G = c b^T is wgmma m64n64k16 with both tiles
//   K-major from shared memory; the decay exp(cum_i - cum_j) is applied in
//   the accumulator and the upper triangle is selected away (never a
//   multiply by 0: above the diagonal the exponent overflows to inf, and
//   inf * 0 is NaN).  c S_in (S_in from shared memory, MN-major, the
//   transpose bit) goes into the y accumulator, is scaled by exp(cum_i), and
//   G x accumulates on it with G as a register A operand and x as the
//   MN-major B operand.  G's products for a chunk do not wait for the state.
// - Warpgroup 1 carries S (128 x 64 float32) in wgmma accumulators that
//   never leave its registers: S <- exp(cum_last) S + b^T (w x), w_j =
//   exp(cum_last - cum_j), with b^T the MN-major A operand read from the b
//   tile (the transpose bit) and w x written to shared memory in the
//   swizzle.  After each chunk it writes S as bf16 into one of two buffers
//   (mbarriers s_full / s_empty between the warpgroups), so it runs up to a
//   chunk ahead of warpgroup 0.  The last chunk's state is not computed.
// - No wgmma sits on a branch, and each warp's role is read from lane 0:
//   ptxas serializes every wgmma of a kernel where it cannot prove a
//   warpgroup converged (warning C7520), which cost 1.5x here.
// - Precision.  The products of bf16 values are exact in float32 and summed
//   there; three float32 operands must be rounded to bf16 for wgmma: G, S_in
//   and w x.  One rounding of any of them breaks the one-bf16-ulp gate
//   against the float32 plain version on some outputs (chip_smoke.py's
//   bf16_tol; tests/test_torch_ssd_tc.py shows each), so each is split
//   into hi = bf16(v) and lo = bf16(v - hi), two wgmma into one float32
//   accumulator.  Tensor-core operations per chunk and (batch, head):
//   2*64*64*128 (G) + 2 * 2*64*64*128 (c S) + 2 * 2*64*64*64 (G x) +
//   2 * 2*128*64*64 (state) = 6.29 M; the last chunk's state is not
//   computed, and the first chunk's c S_in reads a zeroed buffer.
// - Every sum runs in a fixed order and no atomics are used: the output is
//   deterministic.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kL = 64;      // chunk steps
constexpr int kDh = 64;     // head dim
constexpr int kDs = 128;    // state size
constexpr int kStages = 3;  // the input ring
constexpr int kWg = 128;    // threads in a warpgroup
constexpr int kConsumers = 2 * kWg;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr unsigned kFull = 0xffffffffu;

// Shared memory, every tile in 64-column atoms of (rows x 128 bytes) in the
// 128-byte swizzle, each atom on a 1024-byte boundary.
constexpr int kAtom = kL * 128;              // 64 rows x 64 bf16
constexpr int kCOff = 0;                     // c: atoms over ds 0..63, 64..127
constexpr int kBOff = 2 * kAtom;             // b: the same
constexpr int kXOff = 4 * kAtom;             // x: one atom
constexpr int kAOff = 5 * kAtom;             // a: 64 floats
constexpr int kTxBytes = 5 * kAtom;          // what TMA brings per stage
constexpr int kStageBytes = 5 * kAtom + 1024;
constexpr int kSBytes = kDs * 128;           // S as bf16: 128 rows x 64 columns
constexpr int kSOff = kStages * kStageBytes; // S buffers [2][hi, lo]
constexpr int kWOff = kSOff + 4 * kSBytes;   // w x: hi, lo
constexpr int kBarOff = kWOff + 2 * kAtom;
constexpr int kBars = 2 * kStages + 4;       // full, empty, s_full[2], s_empty[2]
constexpr int kBytes = kBarOff + 8 * kBars + 1024;  // + alignment slack
static_assert(kStageBytes % 1024 == 0 && kSOff % 1024 == 0 && kWOff % 1024 == 0,
              "swizzle atoms need 1024-byte alignment");

struct Params {
  const float* a;  // (bsz, l, h)
  long long a_sb, a_sl, a_sh;
  __nv_bfloat16* y;  // (bsz, l, h, 64) contiguous
  int l, h, n_chunks;
  int xh, xb, bh, bb, ch, cb;  // 1: the map has this axis (head, batch); 0: extent 1
};

__device__ __forceinline__ void mbar_add_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// Make this thread's ordinary shared-memory writes visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Warpgroup 1's own barrier (barrier 0 is __syncthreads).
__device__ __forceinline__ void sync_state_group() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWg) : "memory");
}

// wgmma m64n64k16 with A and B from shared memory; TA / TB: the operand is
// MN-major (the transpose bit).  acc = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// The chunk's cum, in every warp alike: lane l returns cum[2l] and cum[2l + 1].
__device__ __forceinline__ float2 chunk_cum(const float* as, int lane) {
  const float2 av = reinterpret_cast<const float2*>(as)[lane];
  float inc = av.x + av.y;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += up;
  }
  float exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = 0.f;
  const float c0 = exc + av.x;
  return make_float2(c0, c0 + av.y);
}

// cum[k] from the lane that holds it (every lane of the warp must call).
__device__ __forceinline__ float cum_at(float2 cum, int k) {
  const float v0 = __shfl_sync(kFull, cum.x, k >> 1);
  const float v1 = __shfl_sync(kFull, cum.y, k >> 1);
  return (k & 1) ? v1 : v0;
}

// Byte offset of element (row, col) in a swizzled tile of 128-byte rows.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// Warpgroup 0: y for every chunk.  This thread holds rows r_in and r_in + 8
// of the chunk (r_in = 16 warp + lane / 4) at columns 8 j + col0 + {0, 1}:
// acc[4 j + e] is row r_in + 8 (e / 2), column 8 j + col0 + (e % 2).
__device__ __forceinline__ void y_group(const Params& p, uint8_t* sp, uint32_t base,
                                        uint32_t bar0, int hh, int bb) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r_in = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  __nv_bfloat16* y = p.y + (static_cast<long long>(bb) * p.l * p.h + hh) * kDh;
  const long long y_sl = static_cast<long long>(p.h) * kDh;

  for (int i = 0; i < p.n_chunks; ++i) {
    const int s = i % kStages;
    const uint32_t st = base + s * kStageBytes;
    mbar_wait(bar0 + 8 * s, (i / kStages) & 1);
    const float2 cum = chunk_cum(reinterpret_cast<const float*>(sp + s * kStageBytes + kAOff), lane);
    const float cr[2] = {cum_at(cum, r_in), cum_at(cum, r_in + 8)};
    float cc[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cc[2 * j] = cum_at(cum, 8 * j + col0);
      cc[2 * j + 1] = cum_at(cum, 8 * j + col0 + 1);
    }

    // G = c b^T: 8 steps of 16 along ds; step kk lies in atom kk / 4 at
    // byte 32 (kk % 4) of each row.
    float g[32], acc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDs / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kAtom + (kk & 3) * 32;
      wgmma_ss_m64n64<0, 0>(g, desc_sw128(st + kCOff + off, 16, 1024),
                            desc_sw128(st + kBOff + off, 16, 1024), kk > 0);
    }
    wg_commit();
    // c S_in, S_in = S_hi + S_lo from the buffer warpgroup 1 wrote after
    // chunk i - 1 (128 rows of ds, MN-major: 16 rows per step); chunk 0
    // reads buffer 1, zeroed at the start.  No branch around a wgmma:
    // ptxas serializes them on a path it cannot prove convergent.
    const int sb = (i + 1) & 1;
    if (i > 0) mbar_wait(bar0 + 8 * (2 * kStages + sb), ((i - 1) >> 1) & 1);
    const uint32_t s_buf = base + kSOff + sb * 2 * kSBytes;
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < kDs / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kAtom + (kk & 3) * 32;
        wgmma_ss_m64n64<0, 1>(acc, desc_sw128(st + kCOff + off, 16, 1024),
                              desc_sw128(s_buf + part * kSBytes + kk * 2048, kSBytes, 1024),
                              part > 0 || kk > 0);
      }
    wg_commit();
    wg_wait<1>();
    fence_regs(g);

    // Decay and causal select on G, then G as bf16 hi + lo in wgmma's
    // register A layout: register q of step kk holds row r_in + 8 (q % 2)
    // at keys 16 kk + 8 (q / 2) + col0 + {0, 1}.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_in + 8 * (e >> 1), col = 8 * j + col0 + (e & 1);
        const float v = g[4 * j + e] * expf(cr[e >> 1] - cc[2 * j + (e & 1)]);
        g[4 * j + e] = col <= row ? v : 0.f;
      }
    uint32_t gh[4][4], gl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * (2 * kk + (q >> 1)) + 2 * (q & 1);
        split2(g[e], g[e + 1], gh[kk][q], gl[kk][q]);
      }

    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar0 + 8 * (2 * kStages + 2 + sb));  // S_in read
    const float er[2] = {expf(cr[0]), expf(cr[1])};
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] *= er[(e >> 1) & 1];

    // acc += G x: 4 steps of 16 keys, x's (keys, dh) tile the MN-major B.
    fence_regs(acc);
    fence_regs(gh);
    fence_regs(gl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = desc_sw128(st + kXOff + kk * 2048, kAtom, 1024);
      wgmma_rs_m64n64_tb(acc, gh[kk], dx);
      wgmma_rs_m64n64_tb(acc, gl[kk], dx);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar0 + 8 * (kStages + s));  // the stage is free for warpgroup 0

    const int t0 = i * kL;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + r_in + 8 * r;
      if (t >= p.l) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(&y[t * y_sl + 8 * j + col0]) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// Warpgroup 1: the state after chunks 0 .. n_chunks - 2, as two m64n64
// accumulators over ds (s[mt] holds state rows 64 mt + r_in + 8 (e / 2)).
__device__ __forceinline__ void state_group(const Params& p, uint8_t* sp, uint32_t base,
                                            uint32_t bar0) {
  const int tid = threadIdx.x - kWg;
  const int warp = tid >> 5, lane = tid & 31;
  const int r_in = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const uint32_t wx = base + kWOff;
  float s[2][32] = {};

  for (int i = 0; i + 1 < p.n_chunks; ++i) {
    const int st_i = i % kStages;
    const uint32_t st = base + st_i * kStageBytes;
    mbar_wait(bar0 + 8 * st_i, (i / kStages) & 1);
    const float2 cum = chunk_cum(reinterpret_cast<const float*>(sp + st_i * kStageBytes + kAOff), lane);
    const float last = __shfl_sync(kFull, cum.y, 31);

    // w x as bf16 hi + lo in x's swizzle: this thread's 16-byte groups are
    // rows tid / 8 + 16 k, group tid % 8.  The previous chunk's products
    // that read the buffers are done in every warp first.
    sync_state_group();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = (tid >> 3) + 16 * k;
      const float w = expf(last - cum_at(cum, row));
      const uint32_t off = swz(row, 8 * (tid & 7));
      const uint4 xv = *reinterpret_cast<const uint4*>(sp + st_i * kStageBytes + kXOff + off);
      const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw[q]));
        split2(w * xf.x, w * xf.y, hi[q], lo[q]);
      }
      *reinterpret_cast<uint4*>(sp + kWOff + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sp + kWOff + kAtom + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_async_smem();
    sync_state_group();

    // S <- exp(cum_last) S + b^T (w x): b^T is the MN-major A operand (atom
    // mt of the b tile), 4 steps of 16 keys.
    const float decay = expf(last);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 32; ++e) s[mt][e] *= decay;
    fence_regs(s[0]);
    fence_regs(s[1]);
    wg_fence();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n64<1, 1>(s[mt], desc_sw128(st + kBOff + mt * kAtom + kk * 2048, kAtom, 1024),
                                desc_sw128(wx + part * kAtom + kk * 2048, kAtom, 1024), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(s[0]);
    fence_regs(s[1]);
    mbar_arrive(bar0 + 8 * (kStages + st_i));  // the stage is free for warpgroup 1

    // S as bf16 hi + lo into buffer i % 2, once warpgroup 0 has read what
    // it held (the state after chunk i - 2, or buffer 1's zeros, in its
    // chunk i - 1).
    const int sb = i & 1;
    if (i >= 1) mbar_wait(bar0 + 8 * (2 * kStages + 2 + sb), ((i - 1) >> 1) & 1);
    uint8_t* s_buf = sp + kSOff + sb * 2 * kSBytes;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = swz(64 * mt + r_in + 8 * r, 8 * j + col0);
          uint32_t hi, lo;
          split2(s[mt][4 * j + 2 * r], s[mt][4 * j + 2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_buf + off) = hi;
          *reinterpret_cast<uint32_t*>(s_buf + kSBytes + off) = lo;
        }
    fence_async_smem();
    mbar_arrive(bar0 + 8 * (2 * kStages + sb));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_tc_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tc, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024
  uint8_t* sp = smem_raw + (base - raw);
  const uint32_t bar0 = base + kBarOff;  // full[s], empty[s], s_full[2], s_empty[2]
  const int tid = threadIdx.x;
  const int hh = blockIdx.x, bb = blockIdx.y;
  // 0: y, 1: state, 2: producer; read from lane 0 so that ptxas sees it
  // warp-uniform (wgmma on a path it cannot prove convergent is serialized).
  const int role = __shfl_sync(kFull, tid / kWg, 0);

  // S_in of chunk 0: buffer 1 (hi and lo) zeroed.
  for (int e = tid; e < 2 * kSBytes / 16; e += kThreads)
    reinterpret_cast<uint4*>(sp + kSOff + 2 * kSBytes)[e] = make_uint4(0, 0, 0, 0);
  fence_async_smem();

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar0 + 8 * s, 32);
      mbar_init(bar0 + 8 * (kStages + s), kConsumers);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) mbar_init(bar0 + 8 * (2 * kStages + b), kWg);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (role == 2) {
    // The producer warp: lane 0 issues the TMA copies, every lane loads two
    // of a's 64 floats; all 32 arrive on the stage's full barrier.
    const int lane = tid & 31;
    const float* a = p.a + bb * p.a_sb + hh * p.a_sh;
    for (int i = 0; i < p.n_chunks; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(bar0 + 8 * (kStages + s), (i / kStages - 1) & 1);
      const uint32_t st = base + s * kStageBytes;
      const uint32_t full = bar0 + 8 * s;
      const int t0 = i * kL;
      if (lane == 0) {
        mbar_add_tx(full, kTxBytes);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          tma_load_4d(st + kCOff + j * kAtom, &tc, full, 64 * j, t0, hh * p.ch, bb * p.cb);
          tma_load_4d(st + kBOff + j * kAtom, &tb, full, 64 * j, t0, hh * p.bh, bb * p.bb);
        }
        tma_load_4d(st + kXOff, &tx, full, 0, t0, hh * p.xh, bb * p.xb);
      }
      float* as = reinterpret_cast<float*>(sp + s * kStageBytes + kAOff);
#pragma unroll
      for (int r = lane; r < kL; r += 32)
        as[r] = t0 + r < p.l ? a[static_cast<long long>(t0 + r) * p.a_sl] : 0.f;
      mbar_arrive(full);
    }
  } else if (role == 0) {
    y_group(p, sp, base, bar0, hh, bb);
  } else {
    state_group(p, sp, base, bar0);
  }
}

// A map's extent over an axis: the tensor's, or 1 where the axis is
// broadcast (flag 0; the kernel then reads coordinate 0).
int extent(int n, int flag) { return flag ? n : 1; }

}  // namespace

extern "C" {

// x: (bsz, l, h, 64); b, c: (bsz, l, h, 128); bf16, each with the given
// element strides over (batch, step, head) (multiples of 8, the pointers
// 16-byte aligned) and a contiguous last axis, and flags saying whether the
// batch and head axes are read (0: broadcast, coordinate 0).  a: (bsz, l, h)
// float32 at any strides.  y: (bsz, l, h, 64) contiguous bf16.  Returns 0,
// a CUDA error (cudaGetLastError() after the launch), or one of
// hopper.cuh's encoder codes.
int ssd_scan_tc_launch(const void* x, const void* a, const void* b, const void* c, void* y,
                       int bsz, int l, int h,
                       long long x_sb, long long x_sl, long long x_sh, int x_fb, int x_fh,
                       long long b_sb, long long b_sl, long long b_sh, int b_fb, int b_fh,
                       long long c_sb, long long c_sl, long long c_sh, int c_fb, int c_fh,
                       long long a_sb, long long a_sl, long long a_sh, void* stream) {
  if (bsz <= 0 || l <= 0 || h <= 0) return (int)cudaGetLastError();
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  CUtensorMap tx, tb, tc;
  int e = encode(&tx, fn, x, kDh, l, extent(h, x_fh), extent(bsz, x_fb), x_sl, x_sh, x_sb, kL);
  if (e == 0)
    e = encode(&tb, fn, b, kDs, l, extent(h, b_fh), extent(bsz, b_fb), b_sl, b_sh, b_sb, kL);
  if (e == 0)
    e = encode(&tc, fn, c, kDs, l, extent(h, c_fh), extent(bsz, c_fb), c_sl, c_sh, c_sb, kL);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(ssd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        kBytes);
  if (ce != cudaSuccess) return (int)ce;
  Params p{static_cast<const float*>(a), a_sb, a_sl, a_sh, static_cast<__nv_bfloat16*>(y),
           l, h, (l + kL - 1) / kL, x_fh, x_fb, b_fh, b_fb, c_fh, c_fb};
  dim3 grid(h, bsz);
  ssd_tc_kernel<<<grid, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(tx, tb, tc, p);
  return (int)cudaGetLastError();
}

const char* ssd_scan_tc_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
