// K-Means' squared distance matrix for Hopper (sm_90a).  DBSCAN's
// neighbour counts and min-label sweeps, which test each unordered pair of
// points once, are in pair_sweep.cu.
//
// Replaces the TPU kernel src/repro/kernels/pairwise_dist.py:
//   pairwise_dist_sq       (_dist_kernel)             -- the (n, m) squared
//                                                        distance matrix of
//                                                        K-Means' assignment
//
// What bounds it: the bytes it writes.  It writes its whole (n, m) output,
// at m = k = 8 centres on K-Means' path: 4 bytes a pair against about six
// fp32 operations; at n 32,768 that is 1 MB, under half a microsecond of
// memory time, so one launch is latency-bound, and the cost over an empty
// launch is mostly the stores.  A warp owns 32 consecutive rows, whose
// distances are contiguous in the output, and writes them in order: lane L
// takes the same four columns of rows L / (m / 4), + 32 / (m / 4), ... (m
// 4, 8, ..., 128; other m store single floats, element L, L + 32, ...), so
// every store instruction of the warp writes 512 contiguous bytes (128
// with single floats).  A lane loads its rows' x before its four centres,
// so that every load is in flight at once, and keeps the centres and their
// |y|^2 in registers; |x|^2 is recomputed by the m / 4 lanes of a row (two
// at k 8).  256 rows a block: at n 32,768 that is 128 blocks, one wave.
//
// Exactness: the pair test is the same float32 expression as the plain
// version (repro_torch/kernels/ref.py::_d2_rows) and as the jitted
// reference, whose compiler contracts each depth-2 sum into one FMA:
//   (xx_i + yy_j) - 2 * fma(x_i1, y_j1, x_i0 * y_j0),
//   xx = fma(x1, x1, x0 * x0),
// written with __fmaf_rn where the reference fuses and __fmul_rn /
// __fadd_rn / __fsub_rn elsewhere, which the compiler never contracts, so
// kernel and plain version agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;  // rows per block: 8 warps of 32 rows

__device__ __forceinline__ float sqnorm(float a, float b) {
  return __fmaf_rn(b, b, __fmul_rn(a, a));
}

// Clipped at 0 as the plain version's clamp_min (which keeps a NaN).
__device__ __forceinline__ float pair_d2(float2 p, float xx, float2 q, float qq) {
  const float dot = __fmaf_rn(p.y, q.y, __fmul_rn(p.x, q.x));
  const float d2 = __fsub_rn(__fadd_rn(xx, qq), __fmul_rn(2.0f, dot));
  return d2 < 0.f ? 0.f : d2;
}

__global__ void __launch_bounds__(kRows)
dist_rows_kernel(const float2* __restrict__ x, const float2* __restrict__ y, int n, int m,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows + (threadIdx.x - lane);  // the warp's first row
  if (row0 >= n) return;
  const int rows = min(32, n - row0);
  float* base = out + (size_t)row0 * m;
  if ((m & 3) == 0 && 32 % (m >> 2) == 0) {  // m 4, 8, ..., 128: a lane keeps its 4 columns
    const int quads = m >> 2, step = 32 / quads, c = (lane % quads) * 4;
    int r = lane / quads;
    float2 pa = r < rows ? __ldg(x + row0 + r) : make_float2(0.f, 0.f);
    float2 pb = r + step < rows ? __ldg(x + row0 + r + step) : make_float2(0.f, 0.f);
    float2 q[4];
    float qq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = __ldg(y + c + k);
#pragma unroll
    for (int k = 0; k < 4; ++k) qq[k] = sqnorm(q[k].x, q[k].y);
    while (r < rows) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + h * step;
        const float2 p = h ? pb : pa;
        if (rr < rows) {
          const float xx = sqnorm(p.x, p.y);
          float4 o;
          o.x = pair_d2(p, xx, q[0], qq[0]);
          o.y = pair_d2(p, xx, q[1], qq[1]);
          o.z = pair_d2(p, xx, q[2], qq[2]);
          o.w = pair_d2(p, xx, q[3], qq[3]);
          *reinterpret_cast<float4*>(base + rr * m + c) = o;
        }
      }
      r += 2 * step;
      if (r < rows) pa = __ldg(x + row0 + r);
      if (r + step < rows) pb = __ldg(x + row0 + r + step);
    }
  } else {
    for (int e = lane; e < rows * m; e += 32) {
      const int r = e / m;
      const float2 p = __ldg(x + row0 + r);
      const float2 q = __ldg(y + (e - r * m));
      base[e] = pair_d2(p, sqnorm(p.x, p.y), q, sqnorm(q.x, q.y));
    }
  }
}

}  // namespace

extern "C" {

// x: (n, 2), y: (m, 2) float32, out: (n, m) float32, all contiguous; out
// 16-byte aligned (the wrapper allocates it).
int pairwise_dist_sq_launch(const void* x, const void* y, int n, int m, void* out,
                            void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  if ((long long)32 * m >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  dist_rows_kernel<<<(n + kRows - 1) / kRows, kRows, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (const float2*)y, n, m, (float*)out);
  return (int)cudaGetLastError();
}

const char* pairwise_dist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
