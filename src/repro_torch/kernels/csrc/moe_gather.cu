// MoE dispatch gather (+ optional per-row int8 quantisation), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gather.py:
//   dispatch_gather (_gather_kernel)
//
// What it computes: for each of the S slots, the token row idx[slot] of x
// (t, d), or zeros where idx[slot] < 0 (an empty slot).  An id >= t also
// gives an empty slot, as the plain version does: the kernel never reads
// outside x.  Without quantisation the row is copied bit for bit
// into buf (S, d) of x's dtype and the slot's scale is 1 (0 when empty).
// With quantisation the row is taken to float32, scale = max(absmax / 127,
// 1e-12) by a true IEEE division, and buf = clamp(rint(v / scale), -127,
// 127) as int8 (rint rounds halves to even, as jnp.round does; roundf would
// round them away from zero); an empty slot's scale is 0.  This file must be
// built without --use_fast_math: both divisions and rintf must be IEEE.
//
// What bounds it: bytes.  It reads each kept row once (t*d*sizeof(T) at
// most, the first pass of the quantised mode reads it again from the cache)
// and writes S*d*sizeof(out) plus 4 bytes of scale a slot; a copy does no
// arithmetic, the quantised mode a few operations a byte.  At llama4-scout's
// prefill (S = 10,240 slots, d = 5,120, bf16) that is ~189 MB, 0.056 ms at
// 3.35 TB/s.
//
// Design: the TPU kernel walks a block of slots with a sequential loop and
// dynamic single-row HBM loads.  Here one block of 128 threads owns one slot
// (S blocks in flight, no loop across slots): it reads the slot's row id,
// then copies the row with 16-byte vector loads and stores (uint4: 8 bf16 or
// 4 float32 a thread) and a scalar tail when the row's byte length is not a
// multiple of 16 or a row is not 16-byte aligned (a row stride that breaks
// the alignment takes the scalar path for the whole row).  The quantised
// mode reduces the row's absmax in float32 (warp shuffles, then one value a
// warp in shared memory; max is order-free, so every run gives the same
// bits), then writes the int8 values, 8 or 4 a thread at a time, and the
// scale.  No atomics: the output is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// The value k of a 16-byte vector of T.
template <typename T>
__device__ __forceinline__ float lane(const uint4& raw, int k) {
  return to_float(reinterpret_cast<const T*>(&raw)[k]);
}

// int8 values of one vector, stored as one 8- or 4-byte word.
template <int N>
struct Q8;
template <>
struct Q8<8> {
  using Word = uint2;
};
template <>
struct Q8<4> {
  using Word = uint32_t;
};

__device__ __forceinline__ int8_t quantise(float v, float scale) {
  float q = rintf(v / scale);
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_copy_kernel(const T* __restrict__ x, const int* __restrict__ idx, T* __restrict__ buf,
                   float* __restrict__ scales, int t, int d, long long row_stride) {
  constexpr int N = 16 / sizeof(T);
  const long long slot = blockIdx.x;
  const int row = idx[slot];
  const bool valid = row >= 0 && row < t;
  const T* src = x + (valid ? row : 0) * row_stride;
  T* dst = buf + slot * d;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int nv = vec ? d / N : 0;
  if (valid) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < nv; i += kThreads) d4[i] = __ldg(s4 + i);
    for (int j = nv * N + threadIdx.x; j < d; j += kThreads) dst[j] = src[j];
  } else {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4 z4 = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < nv; i += kThreads) d4[i] = z4;
    for (int j = nv * N + threadIdx.x; j < d; j += kThreads) dst[j] = zero<T>();
  }
  if (threadIdx.x == 0) scales[slot] = valid ? 1.0f : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_quant_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                    int8_t* __restrict__ buf, float* __restrict__ scales, int t, int d,
                    long long row_stride) {
  constexpr int N = 16 / sizeof(T);
  using Word = typename Q8<N>::Word;
  __shared__ float warp_max[kWarps];
  const long long slot = blockIdx.x;
  const int row = idx[slot];
  const bool valid = row >= 0 && row < t;
  const T* src = x + (valid ? row : 0) * row_stride;
  int8_t* dst = buf + slot * d;
  // Vectors: 16 bytes of x in, N bytes of int8 out.
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(dst) & (N - 1)) == 0;
  const int nv = vec ? d / N : 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);

  // Pass 1: the row's absmax (0 for an empty slot).
  float m = 0.0f;
  if (valid) {
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const uint4 raw = __ldg(s4 + i);
#pragma unroll
      for (int k = 0; k < N; ++k) m = fmaxf(m, fabsf(lane<T>(raw, k)));
    }
    for (int j = nv * N + threadIdx.x; j < d; j += kThreads) m = fmaxf(m, fabsf(to_float(src[j])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
  const float scale = fmaxf(m / 127.0f, 1e-12f);

  // Pass 2: the int8 row (zeros for an empty slot: 0 / scale rounds to 0).
  Word* dw = reinterpret_cast<Word*>(dst);
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    union {
      Word w;
      int8_t q[N];
    } out;
    if (valid) {
      const uint4 raw = __ldg(s4 + i);
#pragma unroll
      for (int k = 0; k < N; ++k) out.q[k] = quantise(lane<T>(raw, k), scale);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) out.q[k] = 0;
    }
    dw[i] = out.w;
  }
  for (int j = nv * N + threadIdx.x; j < d; j += kThreads)
    dst[j] = valid ? quantise(to_float(src[j]), scale) : static_cast<int8_t>(0);
  if (threadIdx.x == 0) scales[slot] = valid ? scale : 0.0f;
}

template <typename T>
int launch(const void* x, const int* idx, void* buf, float* scales, int t, int d, int s,
           long long row_stride, int quant, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (quant)
    gather_quant_kernel<T><<<s, kThreads, 0, stream>>>(xt, idx, static_cast<int8_t*>(buf),
                                                       scales, t, d, row_stride);
  else
    gather_copy_kernel<T><<<s, kThreads, 0, stream>>>(xt, idx, static_cast<T*>(buf), scales,
                                                      t, d, row_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (t, d) with element row stride row_stride and a contiguous last axis;
// idx: (s,) int32; buf: (s, d) contiguous, int8 when quant else x's dtype;
// scales: (s,) float32.  dtype: 0 float32, 1 bfloat16.  Returns
// cudaGetLastError() after the launch.
int dispatch_gather_launch(const void* x, const void* idx, void* buf, void* scales, int dtype,
                           int t, int d, int s, long long row_stride, int quant,
                           void* stream) {
  if (s <= 0) return (int)cudaGetLastError();
  const int* id = static_cast<const int*>(idx);
  float* sc = static_cast<float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch<__nv_bfloat16>(x, id, buf, sc, t, d, s, row_stride, quant, st)
             : launch<float>(x, id, buf, sc, t, d, s, row_stride, quant, st);
}

const char* dispatch_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
