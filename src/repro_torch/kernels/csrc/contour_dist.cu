// Phase-2 merge-matrix kernel for Hopper (sm_90a): the (M, M) slot-by-slot
// minimum squared distance between padded contour buffers.
//
// Replaces the TPU kernel src/repro/kernels/contour_dist.py:
//   contour_min_d2 (_contour_min_kernel)
//
// What bounds it: (M*V)^2 vertex pair tests at d = 2, about five fp32
// operations each (two subtractions, two products, one sum) plus a min,
// against M*V*8 bytes in and M*M*4 bytes out: bound by operations.  Only
// valid vertices need testing, so the work this data needs is (sum of the
// valid slots' vertex counts)^2, usually far below the padded (M*V)^2.
//
// Design: block (i, jb) owns row slot i and a group of column slots.  It
// stages row slot i's valid vertices in shared memory; each thread holds
// one column vertex in registers, walks the row vertices (every thread
// reads the same one: a broadcast) and keeps its running min in a
// register.  The block then min-reduces each column slot's vertices in
// shared memory with integer atomicMin on the float bits, which orders
// non-negative floats exactly as float comparison does, so the result is
// exact and independent of the order the atomics land in.  An invalid row
// slot writes its row without any pair test; an invalid column vertex
// skips its loop.  The TPU path centres coordinates for its MXU
// expansion; the difference form needs no centring.
//
// Exactness: d2 = dx*dx + dy*dy with __fsub_rn / __fmul_rn / __fadd_rn,
// never contracted into an FMA: the same float32 expression as the plain
// version (repro_torch/kernels/ref.py::contour_min_d2), bit for bit.  A
// slot pair that has any invalid vertex pair also sees BIG in the min,
// exactly as the plain version's where(valid, d2, BIG).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kThreads)
contour_min_kernel(const float2* __restrict__ pts, const int* __restrict__ counts,
                   const uint8_t* __restrict__ valid, int m, int v,
                   int slots_per_block, float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  float2* rowv = reinterpret_cast<float2*>(smem);                    // v vertices
  unsigned int* colmin = reinterpret_cast<unsigned int*>(rowv + v);  // slots_per_block

  const int i = blockIdx.x;
  const int j0 = blockIdx.y * slots_per_block;
  const int nj = min(slots_per_block, m - j0);
  const int cnt_i = valid[i] ? max(0, min(counts[i], v)) : 0;

  for (int k = threadIdx.x; k < nj; k += kThreads)
    colmin[k] = __float_as_uint(__int_as_float(0x7f800000));  // +inf
  for (int k = threadIdx.x; k < cnt_i; k += kThreads) rowv[k] = pts[(size_t)i * v + k];
  __syncthreads();

  if (cnt_i > 0) {
    for (int q = threadIdx.x; q < nj * v; q += kThreads) {
      const int jl = q / v;
      const int w = q - jl * v;
      const int j = j0 + jl;
      const int cnt_j = valid[j] ? max(0, min(counts[j], v)) : 0;
      if (w >= cnt_j) continue;
      const float2 c = pts[(size_t)j * v + w];
      float best = __int_as_float(0x7f800000);
      for (int p = 0; p < cnt_i; ++p) {
        const float2 r = rowv[p];
        const float dx = __fsub_rn(r.x, c.x);
        const float dy = __fsub_rn(r.y, c.y);
        best = fminf(best, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      }
      atomicMin(&colmin[jl], __float_as_uint(best));
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < nj; k += kThreads) {
    const int j = j0 + k;
    const int cnt_j = valid[j] ? max(0, min(counts[j], v)) : 0;
    float d = __uint_as_float(colmin[k]);
    if (cnt_i < v || cnt_j < v) d = fminf(d, kBig);  // some pair is invalid
    out[(size_t)i * m + j] = d;
  }
}

}  // namespace

extern "C" {

// pts: (m, v, 2) f32; counts: (m,) i32; valid: (m,) bool; out: (m, m) f32.
int contour_min_d2_launch(const void* pts, const void* counts, const void* valid,
                          int m, int v, void* out, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  // Enough column slots per block to give every thread a few vertices.
  const int slots_per_block = max(1, min(m, (4 * kThreads + v - 1) / max(v, 1)));
  const size_t shmem = (size_t)v * sizeof(float2) + slots_per_block * sizeof(unsigned int);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        contour_min_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(m, (m + slots_per_block - 1) / slots_per_block);
  contour_min_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      (const float2*)pts, (const int*)counts, (const uint8_t*)valid, m, v,
      slots_per_block, (float*)out);
  return (int)cudaGetLastError();
}

const char* contour_dist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
