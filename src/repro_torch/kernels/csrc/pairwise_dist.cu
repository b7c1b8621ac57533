// Phase-1 DBSCAN kernels for Hopper (sm_90a): the fused epsilon-neighbour
// count and one min-label propagation sweep, each in a dense form and in a
// block-sparse form over a list of active tile pairs.
//
// Replaces the TPU kernels src/repro/kernels/pairwise_dist.py:
//   neighbor_count         (_count_kernel)            -- per point, masked
//                                                        points within eps
//   min_label_sweep        (_min_label_kernel)        -- per point, min label
//                                                        over masked core
//                                                        points within eps,
//                                                        or 2^30
//   neighbor_count_sparse  (_count_sparse_kernel)     -- the count over the
//                                                        active tile pairs
//   min_label_sweep_sparse (_min_label_sparse_kernel) -- the sweep over the
//                                                        active tile pairs
//   pairwise_dist_sq       (_dist_kernel)             -- the (n, m) squared
//                                                        distance matrix of
//                                                        K-Means' assignment
//
// What bounds them: pair tests at d = 2 on fp32 CUDA cores (no tensor-core
// form exists for a depth-2 product at IEEE fp32), about six fp32
// operations a pair, against O(n) bytes in and out.  They are bound by
// operations, not memory: n^2 pair tests for the dense forms, n_active *
// bt^2 for the sparse ones.
//
// Design: one thread owns one row point; its count or running min label
// stays in a register.  A block stages column points in shared memory as
// one float4 each (x0, x1, |x|^2, and the column's mask flag or effective
// label as raw bits), so a pair costs one 16-byte shared load, and every
// thread of the block reads the same column at the same time (a broadcast,
// free of bank conflicts).  A loop inside the block replaces the TPU's
// sequential grid axis:
//   - dense: the block walks a contiguous column range;
//   - sparse: the block's rows all lie in one row tile (its row count
//     divides bt), and it walks that tile's column tiles from a CSR list
//     (row_ptr over the row-major active-pair list).  This replaces the
//     TPU's PAIR_FIRST / PAIR_VALID output-block protocol.
// To fill the card, the columns (dense) or each row tile's column-tile list
// (sparse) are split over gridDim.y; each split writes its partial result
// to its own row of a scratch buffer, and a second pass sums (or
// min-reduces) the splits in a fixed order.  Integer results and a fixed
// order make the output deterministic without atomics.  Ragged ranges are
// masked by the loop bounds; nothing is padded.
//
// pairwise_dist_sq is the exception: it writes its whole (n, m) output, at
// m = k = 8 centres on K-Means' path, so it is bound by the bytes it writes
// (4 a pair against six operations).  One thread owns one output element;
// a block covers whole rows of at most kThreads columns, with those
// columns' (y0, y1, |y|^2) staged once in shared memory, so that a warp
// writes consecutive addresses.
//
// Exactness: the pair test is the same float32 expression as the plain
// version (repro_torch/kernels/ref.py::_d2_rows) and as the jitted
// reference, whose compiler contracts each depth-2 sum into one FMA:
//   (xx_i + yy_j) - 2 * fma(x_i1, y_j1, x_i0 * y_j0),
//   xx = fma(x1, x1, x0 * x0),
// written with __fmaf_rn where the reference fuses and __fmul_rn /
// __fadd_rn / __fsub_rn elsewhere, which the compiler never contracts, so
// kernel and plain version agree bit for bit, and the sparse forms test
// each pair exactly as the dense forms do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // most rows per block
constexpr int kTile = 256;     // columns staged per shared-memory tile
constexpr int kSentinel = 1 << 30;

__device__ __forceinline__ float sqnorm(float a, float b) {
  return __fmaf_rn(b, b, __fmul_rn(a, a));
}

__device__ __forceinline__ float pair_d2(float xi0, float xi1, float xxi,
                                         float yj0, float yj1, float yyj) {
  float dot = __fmaf_rn(xi1, yj1, __fmul_rn(xi0, yj0));
  return __fsub_rn(__fadd_rn(xxi, yyj), __fmul_rn(2.0f, dot));
}

// The count: a column carries its mask flag; a pair within eps adds it.
struct CountOp {
  const uint8_t* mask;
  static constexpr int kInit = 0;
  __device__ int column(int j) const { return mask[j] != 0 ? 1 : 0; }
  __device__ static int fold(int acc, bool within, int w) {
    return acc + (within ? w : 0);
  }
  __device__ static int finish(bool row_ok, int acc) { return row_ok ? acc : 0; }
};

// The sweep: a column that is masked out or not core carries 2^30, exactly
// as the plain version's where(ok, label, 2^30).
struct MinLabelOp {
  const uint8_t* mask;
  const int* labels;
  const uint8_t* core;
  static constexpr int kInit = 0x7fffffff;
  __device__ int column(int j) const {
    return (mask[j] != 0 && core[j] != 0) ? labels[j] : kSentinel;
  }
  __device__ static int fold(int acc, bool within, int w) {
    return min(acc, within ? w : kSentinel);
  }
  __device__ static int finish(bool row_ok, int acc) {
    return row_ok ? acc : kSentinel;
  }
};

// Fold columns [c_begin, c_end) into acc, staged kTile at a time through
// shared memory.  Every thread of the block calls it with the same range.
template <class Op>
__device__ __forceinline__ int fold_columns(float4* cols, const float2* __restrict__ x,
                                            const Op& op, int c_begin, int c_end,
                                            float xi0, float xi1, float xxi,
                                            float eps_sq, int acc) {
  for (int t0 = c_begin; t0 < c_end; t0 += kTile) {
    const int len = min(kTile, c_end - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < len; k += blockDim.x) {
      const int j = t0 + k;
      float2 q = x[j];
      cols[k] = make_float4(q.x, q.y, sqnorm(q.x, q.y), __int_as_float(op.column(j)));
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < len; ++k) {
      float4 q = cols[k];
      float d2 = pair_d2(xi0, xi1, xxi, q.x, q.y, q.z);
      acc = Op::fold(acc, d2 <= eps_sq, __float_as_int(q.w));
    }
  }
  return acc;
}

// Dense: part[s * n + i] = the fold over the columns of split s.
template <class Op>
__device__ __forceinline__ void dense_body(const float2* __restrict__ x,
                                           const uint8_t* __restrict__ mask, const Op& op,
                                           int n, float eps_sq, int cols_per_split,
                                           int* __restrict__ part) {
  __shared__ float4 cols[kTile];  // x0, x1, |x|^2, column weight (int bits)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
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
  const int acc = fold_columns(cols, x, op, c_begin, c_end, xi0, xi1,
                               sqnorm(xi0, xi1), eps_sq, Op::kInit);
  if (i < n) part[(size_t)blockIdx.y * n + i] = Op::finish(row_ok, acc);
}

// Sparse: the block's rows lie in row tile r (blockDim.x divides bt, and
// n = T * bt, so every thread has a row).  Split s of gridDim.y takes its
// share of r's column tiles col_tiles[row_ptr[r] .. row_ptr[r + 1]);
// part[s * n + i] = the fold over those tiles.
template <class Op>
__device__ __forceinline__ void sparse_body(const float2* __restrict__ x,
                                            const uint8_t* __restrict__ mask, const Op& op,
                                            const int* __restrict__ row_ptr,
                                            const int* __restrict__ col_tiles, int n, int bt,
                                            float eps_sq, int* __restrict__ part) {
  __shared__ float4 cols[kTile];  // x0, x1, |x|^2, column weight (int bits)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = (blockIdx.x * blockDim.x) / bt;
  const int p0 = row_ptr[r], p1 = row_ptr[r + 1];
  const int per = (p1 - p0 + gridDim.y - 1) / gridDim.y;
  const int p_begin = min(p1, p0 + (int)blockIdx.y * per);
  const int p_end = min(p1, p_begin + per);
  const float2 p = x[i];
  const bool row_ok = mask[i] != 0;
  const float xxi = sqnorm(p.x, p.y);
  int acc = Op::kInit;
  for (int q = p_begin; q < p_end; ++q) {
    const int c0 = col_tiles[q] * bt;
    acc = fold_columns(cols, x, op, c0, c0 + bt, p.x, p.y, xxi, eps_sq, acc);
  }
  part[(size_t)blockIdx.y * n + i] = Op::finish(row_ok, acc);
}

// One named kernel per function, so that profiles tell them apart.
__global__ void __launch_bounds__(kThreads)
count_kernel(const float2* __restrict__ x, const uint8_t* __restrict__ mask, int n,
             float eps_sq, int cols_per_split, int* __restrict__ part) {
  dense_body(x, mask, CountOp{mask}, n, eps_sq, cols_per_split, part);
}

__global__ void __launch_bounds__(kThreads)
min_label_kernel(const float2* __restrict__ x, const uint8_t* __restrict__ mask,
                 const int* __restrict__ labels, const uint8_t* __restrict__ core, int n,
                 float eps_sq, int cols_per_split, int* __restrict__ part) {
  dense_body(x, mask, MinLabelOp{mask, labels, core}, n, eps_sq, cols_per_split, part);
}

__global__ void __launch_bounds__(kThreads)
count_sparse_kernel(const float2* __restrict__ x, const uint8_t* __restrict__ mask,
                    const int* __restrict__ row_ptr, const int* __restrict__ col_tiles,
                    int n, int bt, float eps_sq, int* __restrict__ part) {
  sparse_body(x, mask, CountOp{mask}, row_ptr, col_tiles, n, bt, eps_sq, part);
}

__global__ void __launch_bounds__(kThreads)
min_label_sparse_kernel(const float2* __restrict__ x, const uint8_t* __restrict__ mask,
                        const int* __restrict__ labels, const uint8_t* __restrict__ core,
                        const int* __restrict__ row_ptr,
                        const int* __restrict__ col_tiles, int n, int bt, float eps_sq,
                        int* __restrict__ part) {
  sparse_body(x, mask, MinLabelOp{mask, labels, core}, row_ptr, col_tiles, n, bt, eps_sq,
              part);
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

// The splits' second pass: part -> out, when there is more than one split.
void reduce_splits(bool is_sum, const void* part, int n, int splits, void* out,
                   cudaStream_t s) {
  if (splits == 1) return;
  if (is_sum)
    sum_splits<<<(n + 255) / 256, 256, 0, s>>>((const int*)part, n, splits, (int*)out);
  else
    min_splits<<<(n + 255) / 256, 256, 0, s>>>((const int*)part, n, splits, (int*)out);
}

bool bad_sparse_shape(int n, int bt, int rows_per_block, int splits) {
  return bt <= 0 || n % bt != 0 || rows_per_block <= 0 || rows_per_block > kThreads ||
         rows_per_block % 32 != 0 || bt % rows_per_block != 0 || splits < 1;
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
  count_kernel<<<grid, kThreads, 0, s>>>((const float2*)x, (const uint8_t*)mask, n, eps_sq,
                                         cols_per_split(n, splits), dst);
  reduce_splits(true, part, n, splits, out, s);
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
      (const float2*)x, (const uint8_t*)mask, (const int*)labels, (const uint8_t*)core, n,
      eps_sq, cols_per_split(n, splits), dst);
  reduce_splits(false, part, n, splits, out, s);
  return (int)cudaGetLastError();
}

// row_ptr: (n / bt + 1,) int32 CSR offsets into col_tiles, the column tiles
// of the active pairs in row-major order.  rows_per_block: a multiple of 32
// that divides bt, at most 256.  part as above.
int neighbor_count_sparse_launch(const void* x, const void* mask, const void* row_ptr,
                                 const void* col_tiles, int n, int bt,
                                 int rows_per_block, float eps_sq, int splits,
                                 void* part, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (bad_sparse_shape(n, bt, rows_per_block, splits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(n / rows_per_block, splits);
  int* dst = splits == 1 ? (int*)out : (int*)part;
  count_sparse_kernel<<<grid, rows_per_block, 0, s>>>(
      (const float2*)x, (const uint8_t*)mask, (const int*)row_ptr, (const int*)col_tiles,
      n, bt, eps_sq, dst);
  reduce_splits(true, part, n, splits, out, s);
  return (int)cudaGetLastError();
}

int min_label_sweep_sparse_launch(const void* x, const void* mask, const void* labels,
                                  const void* core, const void* row_ptr,
                                  const void* col_tiles, int n, int bt,
                                  int rows_per_block, float eps_sq, int splits,
                                  void* part, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (bad_sparse_shape(n, bt, rows_per_block, splits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(n / rows_per_block, splits);
  int* dst = splits == 1 ? (int*)out : (int*)part;
  min_label_sparse_kernel<<<grid, rows_per_block, 0, s>>>(
      (const float2*)x, (const uint8_t*)mask, (const int*)labels, (const uint8_t*)core,
      (const int*)row_ptr, (const int*)col_tiles, n, bt, eps_sq, dst);
  reduce_splits(false, part, n, splits, out, s);
  return (int)cudaGetLastError();
}

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
