// Phase-1 DBSCAN kernels for Hopper (sm_90a): the fused epsilon-neighbour
// count and one min-label propagation sweep.
//
// Replaces the TPU kernels src/repro/kernels/pairwise_dist.py:
//   neighbor_count  (_count_kernel)      -- per point, masked points within eps
//   min_label_sweep (_min_label_kernel)  -- per point, min label over masked
//                                           core points within eps, or 2^30
//
// What bounds it: both are n^2 pair tests at d = 2 on fp32 CUDA cores (no
// tensor-core form exists for a depth-2 product at IEEE fp32), about six
// fp32 operations a pair, against O(n) bytes in and out.  They are bound
// by operations, not memory.
//
// Design: one thread owns one row point; its count or running min label
// stays in a register.  A block stages a tile of column points in shared
// memory as one float4 each (x0, x1, |x|^2, and the column's mask flag or
// effective label as raw bits), so a pair costs one 16-byte shared load,
// and every thread of the block reads the same column at the same time (a
// broadcast, free of bank conflicts).  The loop over column tiles replaces
// the TPU's sequential grid axis.  To fill the card when n is small relative to 132
// SMs, the column range is split over gridDim.y; each split writes its
// partial result to its own row of a scratch buffer, and a second pass
// sums (or min-reduces) the splits in a fixed order.  Integer results and
// a fixed order make the output deterministic without atomics.  The
// ragged last tile is masked by the loop bound; nothing is padded.
//
// Exactness: the pair test is the same float32 expression as the plain
// version (repro_torch/kernels/ref.py::_d2_rows),
//   (xx_i + yy_j) - 2 * (x_i0 * y_j0 + x_i1 * y_j1),  xx = x0*x0 + x1*x1,
// written with __fmul_rn / __fadd_rn / __fsub_rn, which the compiler never
// contracts into an FMA, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rows per block
constexpr int kTile = 256;     // columns staged per shared-memory tile
constexpr int kSentinel = 1 << 30;

__device__ __forceinline__ float sqnorm(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

__device__ __forceinline__ float pair_d2(float xi0, float xi1, float xxi,
                                         float yj0, float yj1, float yyj) {
  float dot = __fadd_rn(__fmul_rn(xi0, yj0), __fmul_rn(xi1, yj1));
  return __fsub_rn(__fadd_rn(xxi, yyj), __fmul_rn(2.0f, dot));
}

// part[s * n + i] = number of masked j in split s with d2(i, j) <= eps_sq
// (0 for a masked-out row i).
__global__ void __launch_bounds__(kThreads)
count_kernel(const float2* __restrict__ x, const uint8_t* __restrict__ mask,
             int n, float eps_sq, int cols_per_split, int* __restrict__ part) {
  __shared__ float4 cols[kTile];  // x0, x1, |x|^2, mask flag (int bits)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(n, c_begin + cols_per_split);
  float xi0 = 0.f, xi1 = 0.f;
  bool row_ok = false;
  if (i < n) {
    float2 p = x[i];
    xi0 = p.x;
    xi1 = p.y;
    row_ok = mask[i] != 0;
  }
  const float xxi = sqnorm(xi0, xi1);
  int count = 0;
  for (int t0 = c_begin; t0 < c_end; t0 += kTile) {
    const int len = min(kTile, c_end - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < len; k += kThreads) {
      float2 q = x[t0 + k];
      cols[k] = make_float4(q.x, q.y, sqnorm(q.x, q.y),
                            __int_as_float(mask[t0 + k] != 0 ? 1 : 0));
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < len; ++k) {
      float4 q = cols[k];
      float d2 = pair_d2(xi0, xi1, xxi, q.x, q.y, q.z);
      count += (d2 <= eps_sq) ? __float_as_int(q.w) : 0;
    }
  }
  if (i < n) part[(size_t)blockIdx.y * n + i] = row_ok ? count : 0;
}

// part[s * n + i] = min over j in split s of (ok(i, j) ? label_j : 2^30),
// ok = d2 <= eps_sq and mask_j and core_j; 2^30 for a masked-out row.
__global__ void __launch_bounds__(kThreads)
min_label_kernel(const float2* __restrict__ x, const uint8_t* __restrict__ mask,
                 const int* __restrict__ labels, const uint8_t* __restrict__ core,
                 int n, float eps_sq, int cols_per_split, int* __restrict__ part) {
  __shared__ float4 cols[kTile];  // x0, x1, |x|^2, effective label (int bits)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(n, c_begin + cols_per_split);
  float xi0 = 0.f, xi1 = 0.f;
  bool row_ok = false;
  if (i < n) {
    float2 p = x[i];
    xi0 = p.x;
    xi1 = p.y;
    row_ok = mask[i] != 0;
  }
  const float xxi = sqnorm(xi0, xi1);
  int best = 0x7fffffff;
  for (int t0 = c_begin; t0 < c_end; t0 += kTile) {
    const int len = min(kTile, c_end - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < len; k += kThreads) {
      const int j = t0 + k;
      float2 q = x[j];
      // A column that is masked out or not core contributes 2^30, exactly
      // as the plain version's where(ok, label, 2^30).
      const int lab = (mask[j] != 0 && core[j] != 0) ? labels[j] : kSentinel;
      cols[k] = make_float4(q.x, q.y, sqnorm(q.x, q.y), __int_as_float(lab));
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < len; ++k) {
      float4 q = cols[k];
      float d2 = pair_d2(xi0, xi1, xxi, q.x, q.y, q.z);
      best = min(best, (d2 <= eps_sq) ? __float_as_int(q.w) : kSentinel);
    }
  }
  if (i < n) part[(size_t)blockIdx.y * n + i] = row_ok ? best : kSentinel;
}

__global__ void sum_splits(const int* __restrict__ part, int n, int splits,
                           int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int acc = 0;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * n + i];
  out[i] = acc;
}

__global__ void min_splits(const int* __restrict__ part, int n, int splits,
                           int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int acc = part[i];
  for (int s = 1; s < splits; ++s) acc = min(acc, part[(size_t)s * n + i]);
  out[i] = acc;
}

int cols_per_split(int n, int splits) {
  const int tiles = (n + kTile - 1) / kTile;
  return ((tiles + splits - 1) / splits) * kTile;
}

}  // namespace

extern "C" {

// part: (splits, n) int32 scratch, unused (may be null) when splits == 1.
int neighbor_count_launch(const void* x, const void* mask, int n, float eps_sq,
                          int splits, void* part, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((n + kThreads - 1) / kThreads, splits);
  int* dst = splits == 1 ? (int*)out : (int*)part;
  count_kernel<<<grid, kThreads, 0, s>>>((const float2*)x, (const uint8_t*)mask,
                                         n, eps_sq, cols_per_split(n, splits), dst);
  if (splits > 1)
    sum_splits<<<(n + 255) / 256, 256, 0, s>>>((const int*)part, n, splits, (int*)out);
  return (int)cudaGetLastError();
}

int min_label_sweep_launch(const void* x, const void* mask, const void* labels,
                           const void* core, int n, float eps_sq, int splits,
                           void* part, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((n + kThreads - 1) / kThreads, splits);
  int* dst = splits == 1 ? (int*)out : (int*)part;
  min_label_kernel<<<grid, kThreads, 0, s>>>(
      (const float2*)x, (const uint8_t*)mask, (const int*)labels,
      (const uint8_t*)core, n, eps_sq, cols_per_split(n, splits), dst);
  if (splits > 1)
    min_splits<<<(n + 255) / 256, 256, 0, s>>>((const int*)part, n, splits, (int*)out);
  return (int)cudaGetLastError();
}

const char* pairwise_dist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
