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
// fp32 operations.  One thread owns one output element; a block covers
// whole rows of at most kThreads columns, with those columns' (y0, y1,
// |y|^2) staged once in shared memory, so that a warp writes consecutive
// addresses.
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

constexpr int kThreads = 256;  // threads per block, and most columns per block

__device__ __forceinline__ float sqnorm(float a, float b) {
  return __fmaf_rn(b, b, __fmul_rn(a, a));
}

__device__ __forceinline__ float pair_d2(float xi0, float xi1, float xxi,
                                         float yj0, float yj1, float yyj) {
  float dot = __fmaf_rn(xi1, yj1, __fmul_rn(xi0, yj0));
  return __fsub_rn(__fadd_rn(xxi, yyj), __fmul_rn(2.0f, dot));
}

// Squared distances, clipped at 0 as the plain version's clamp_min (which
// keeps a NaN).  The block's columns are [blockIdx.y * cols, + cols) and its
// rows [blockIdx.x * rows, + rows), rows * cols <= blockDim.x.
__global__ void __launch_bounds__(kThreads)
dist_kernel(const float2* __restrict__ x, const float2* __restrict__ y, int n, int m,
            int cols, int rows, float* __restrict__ out) {
  __shared__ float4 ys[kThreads];  // y0, y1, |y|^2
  const int c0 = blockIdx.y * cols;
  const int width = min(cols, m - c0);
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    const float2 q = y[c0 + k];
    ys[k] = make_float4(q.x, q.y, sqnorm(q.x, q.y), 0.f);
  }
  __syncthreads();
  const int lr = threadIdx.x / cols, lc = threadIdx.x % cols;
  const int i = blockIdx.x * rows + lr;
  if (lr >= rows || i >= n || lc >= width) return;
  const float2 p = x[i];
  const float4 q = ys[lc];
  const float d2 = pair_d2(p.x, p.y, sqnorm(p.x, p.y), q.x, q.y, q.z);
  out[(size_t)i * m + c0 + lc] = d2 < 0.f ? 0.f : d2;
}

}  // namespace

extern "C" {

// x: (n, 2), y: (m, 2) float32, out: (n, m) float32, all contiguous.
int pairwise_dist_sq_launch(const void* x, const void* y, int n, int m, void* out,
                            void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  const int cols = m < kThreads ? m : kThreads;
  const int rows = kThreads / cols;
  const int col_blocks = (m + cols - 1) / cols;
  if (col_blocks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n + rows - 1) / rows, col_blocks);
  dist_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (const float2*)y, n, m, cols, rows, (float*)out);
  return (int)cudaGetLastError();
}

const char* pairwise_dist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
