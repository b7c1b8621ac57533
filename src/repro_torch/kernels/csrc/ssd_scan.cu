// Mamba-2 SSD (state-space duality) chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:
//   ssd_scan (_ssd_kernel)
//
// What it computes: for every (batch, head), the recurrence
//   S_t = exp(a_t) S_{t-1} + b_t^T x_t      (ds, dh), S_0 = 0
//   y_t = c_t S_t
// over l steps, in the chunked (dual) form: within a chunk of Lc steps,
//   y_i = sum_{j <= i} exp(cum_i - cum_j) (c_i . b_j) x_j + exp(cum_i) c_i S_prev
//   S   = exp(cum_last) S_prev + sum_j exp(cum_last - cum_j) b_j^T x_j
// with cum the inclusive running sum of a inside the chunk.  x, b, c are
// float32 or bfloat16, a is float32; all arithmetic is IEEE float32; y has
// x's dtype.
//
// What bounds it: the inputs are read once and y written once, (2*dh + 2*ds)
// * sizeof(T) + 4 bytes per (batch, step, head); the chunked form does about
// 2*Lc*ds + 2*Lc*dh + 4*ds*dh operations per (batch, step, head).  At the
// Mamba-2 1.3B prefill shape (dh 64, ds 128) that is about 70 operations per
// byte: bound by bytes against the bf16 tensor-core rate, by operations on
// the float32 CUDA cores this kernel uses.
//
// Design: the TPU kernel walks the chunks on a sequential grid axis and
// carries S in VMEM scratch.  Blocks on the card run in parallel, so each
// block owns one (batch, head, slice of 32 state columns) and loops over the
// chunks itself, carrying its (ds, 32) slice of S in shared memory.  The
// columns of S evolve independently, so splitting dh across blocks is exact;
// it doubles the blocks at the 1.3B shape (b * h = 256 per sequence batch of
// 4) at the price of recomputing c . b in each slice.  The chunk is 32 steps,
// chosen for shared memory and for the c . b work, which grows with Lc while
// the state terms do not: b, c (Lc x ds), x (Lc x 32), the masked decayed
// c . b matrix (Lc x Lc) and S (ds x 32) all fit in shared memory, up to ds
// = 256.  Per chunk: one warp forms cum with a shuffle scan; the block
// computes G = (c . b^T) masked and decayed, then y = G x + exp(cum) (c S),
// then the new S into registers, and writes S back once every thread has
// read the old one.  Shared memory, not arithmetic, limits the plain
// one-product-per-lane form of these three products, so each lane keeps a
// small tile in registers: four rows of G or y per lane, read as float4
// along ds (rows of b and c padded to ds + 4 keep float4 loads aligned and
// a warp's rows on distinct banks; ds must be a multiple of 4), and four
// state rows per quad of b.  A ragged last chunk is padded with zeros (a =
// 0, b = c = x = 0), which changes no valid row.  Inputs may have any
// strides over (batch, step, head) with a contiguous last axis, so the
// broadcast c of the Mamba layer is read without a copy.  No atomics: the
// output is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLc = 32;     // chunk length
constexpr int kCols = 32;   // state columns (of dh) per block
constexpr int kMaxDs = 256;
static_assert(kLc == 32 && kThreads == 256,
              "one warp scans a chunk's log-decays; 8 warps own its rows");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Args {
  const void* x;   // (bsz, l, h, dh)
  const float* a;  // (bsz, l, h)
  const void* b;   // (bsz, l, h, ds)
  const void* c;   // (bsz, l, h, ds)
  void* y;         // (bsz, l, h, dh) contiguous
  int bsz, l, h, dh, ds;
  long long x_sb, x_sl, x_sh;  // element strides over (batch, step, head)
  long long a_sb, a_sl, a_sh;
  long long b_sb, b_sl, b_sh;
  long long c_sb, c_sl, c_sh;
};

size_t smem_bytes(int ds) {
  return sizeof(float) *
         (2 * kLc * (ds + 4) + kLc * (kCols + 1) + kLc * (kLc + 1) + ds * kCols + 2 * kLc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args p) {
  extern __shared__ float4 smem4[];
  const int ds = p.ds;          // a multiple of 4
  const int lb = ds + 4;        // row stride of b and c: float4-aligned, rows on distinct banks
  constexpr int LX = kCols + 1; // row stride of x
  constexpr int LG = kLc + 1;   // row stride of G
  constexpr int kRows = kLc / 8;          // rows of G and y per lane: w, w + 8, ...
  constexpr int kQuads = kMaxDs / 32;     // state row quads per thread
  float* bs = reinterpret_cast<float*>(smem4);  // kLc x lb
  float* cs = bs + kLc * lb;    // kLc x lb
  float* xs = cs + kLc * lb;    // kLc x LX
  float* g = xs + kLc * LX;     // kLc x LG
  float* st = g + kLc * LG;     // ds x kCols
  float* cum = st + ds * kCols; // kLc
  float* w = cum + kLc;         // kLc: exp(cum_last - cum_j)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kCols;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int ncols = min(kCols, p.dh - n0);
  const T* x = static_cast<const T*>(p.x) + bb * p.x_sb + hh * p.x_sh + n0;
  const float* a = p.a + bb * p.a_sb + hh * p.a_sh;
  const T* b = static_cast<const T*>(p.b) + bb * p.b_sb + hh * p.b_sh;
  const T* c = static_cast<const T*>(p.c) + bb * p.c_sb + hh * p.c_sh;
  T* y = static_cast<T*>(p.y) + ((long long)bb * p.l * p.h + hh) * p.dh + n0;
  const long long y_sl = (long long)p.h * p.dh;

  for (int e = tid; e < ds * kCols; e += kThreads) st[e] = 0.f;

  for (int t0 = 0; t0 < p.l; t0 += kLc) {
    const int len = min(kLc, p.l - t0);
    __syncthreads();  // the previous chunk's readers are done, S is written
    if (warp == 0) {
      // cum: an inclusive scan of the chunk's a over the warp's 32 lanes
      // (kLc = 32), in a fixed order.
      float run = lane < len ? a[(long long)(t0 + lane) * p.a_sl] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float prev = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += prev;
      }
      cum[lane] = run;
    }
    // b and c rows of the chunk: element (r, k) for e = tid + 256 i, the
    // row and column stepped without a division.
    for (int r = tid / ds, k = tid % ds; r < kLc;) {
      const bool ok = r < len;
      bs[r * lb + k] = ok ? to_float(b[(long long)(t0 + r) * p.b_sl + k]) : 0.f;
      cs[r * lb + k] = ok ? to_float(c[(long long)(t0 + r) * p.c_sl + k]) : 0.f;
      k += kThreads;
      while (k >= ds) { k -= ds; ++r; }
    }
    for (int e = tid; e < kLc * kCols; e += kThreads) {
      const int r = e / kCols, n = e % kCols;
      xs[r * LX + n] = (r < len && n < ncols) ? to_float(x[(long long)(t0 + r) * p.x_sl + n]) : 0.f;
    }
    __syncthreads();
    if (tid < kLc) w[tid] = expf(cum[kLc - 1] - cum[tid]);

    // G[i][j] = (c_i . b_j) exp(cum_i - cum_j) for j <= i, else 0.  Warp w
    // owns rows w, w + 8, w + 16, w + 24 at once, lane j its column: per
    // four k, one float4 of b_j and one (broadcast) float4 of each row's c.
    {
      const int j = lane;
      float dot[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
      if (j <= warp + 8 * (kRows - 1)) {
        for (int k = 0; k < ds; k += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(&bs[j * lb + k]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 cv = *reinterpret_cast<const float4*>(&cs[(warp + 8 * r) * lb + k]);
            dot[r] = fmaf(cv.x, bv.x, dot[r]);
            dot[r] = fmaf(cv.y, bv.y, dot[r]);
            dot[r] = fmaf(cv.z, bv.z, dot[r]);
            dot[r] = fmaf(cv.w, bv.w, dot[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = warp + 8 * r;
        g[i * LG + j] = j <= i ? dot[r] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    __syncthreads();

    // y_i = sum_{j <= i} G[i][j] x_j + exp(cum_i) (c_i . S): warp w owns
    // rows w, w + 8, ... at once, lane n its column (G is 0 above the
    // diagonal, so j runs over the whole chunk).
    {
      const int n = lane;
      float intra[kRows], inter[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) intra[r] = inter[r] = 0.f;
      for (int j = 0; j < kLc; ++j) {
        const float xv = xs[j * LX + n];
#pragma unroll
        for (int r = 0; r < kRows; ++r) intra[r] = fmaf(g[(warp + 8 * r) * LG + j], xv, intra[r]);
      }
      for (int k = 0; k < ds; k += 4) {
        const float s0 = st[k * kCols + n], s1 = st[(k + 1) * kCols + n];
        const float s2 = st[(k + 2) * kCols + n], s3 = st[(k + 3) * kCols + n];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 cv = *reinterpret_cast<const float4*>(&cs[(warp + 8 * r) * lb + k]);
          inter[r] = fmaf(cv.x, s0, inter[r]);
          inter[r] = fmaf(cv.y, s1, inter[r]);
          inter[r] = fmaf(cv.z, s2, inter[r]);
          inter[r] = fmaf(cv.w, s3, inter[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = warp + 8 * r;
        if (i < len && n < ncols)
          store(&y[(long long)(t0 + i) * y_sl + n], intra[r] + expf(cum[i]) * inter[r]);
      }
    }

    // S <- exp(cum_last) S + sum_j b_j^T (w_j x_j).  Thread (warp w, lane n)
    // owns column n of the row quads k = 4w + 32q .. 4w + 32q + 3, so each
    // j needs one x, one w and one (broadcast) float4 of b per quad.
    float s_new[kQuads][4];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) s_new[q][0] = s_new[q][1] = s_new[q][2] = s_new[q][3] = 0.f;
    for (int j = 0; j < kLc; ++j) {
      const float xw = xs[j * LX + lane] * w[j];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int k = 4 * warp + 32 * q;
        if (k < ds) {
          const float4 bv = *reinterpret_cast<const float4*>(&bs[j * lb + k]);
          s_new[q][0] = fmaf(bv.x, xw, s_new[q][0]);
          s_new[q][1] = fmaf(bv.y, xw, s_new[q][1]);
          s_new[q][2] = fmaf(bv.z, xw, s_new[q][2]);
          s_new[q][3] = fmaf(bv.w, xw, s_new[q][3]);
        }
      }
    }
    const float decay = expf(cum[kLc - 1]);
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int k = 4 * warp + 32 * q;
      if (k < ds)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s_new[q][e] = fmaf(decay, st[(k + e) * kCols + lane], s_new[q][e]);
    }
    __syncthreads();  // every thread has read the old S
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int k = 4 * warp + 32 * q;
      if (k < ds)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[(k + e) * kCols + lane] = s_new[q][e];
    }
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t shmem = smem_bytes(a.ds);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.dh + kCols - 1) / kCols, a.h, a.bsz);
  ssd_scan_kernel<T><<<grid, kThreads, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (bsz, l, h, dh); a: (bsz, l, h) float32; b, c: (bsz, l, h, ds); each
// with the given element strides over its first three axes and a
// contiguous last axis.  y: (bsz, l, h, dh) contiguous.  dtype: 0 float32,
// 1 bfloat16 (x, b, c and y alike).  4 <= ds <= 256, ds % 4 == 0.  Returns
// cudaGetLastError() after the launch.
int ssd_scan_launch(const void* x, const void* a, const void* b, const void* c, void* y,
                    int dtype, int bsz, int l, int h, int dh, int ds,
                    long long x_sb, long long x_sl, long long x_sh,
                    long long a_sb, long long a_sl, long long a_sh,
                    long long b_sb, long long b_sl, long long b_sh,
                    long long c_sb, long long c_sl, long long c_sh, void* stream) {
  if (bsz <= 0 || l <= 0 || h <= 0 || dh <= 0) return (int)cudaGetLastError();
  Args p{x, static_cast<const float*>(a), b, c, y, bsz, l, h, dh, ds,
         x_sb, x_sl, x_sh, a_sb, a_sl, a_sh, b_sb, b_sl, b_sh, c_sb, c_sl, c_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
