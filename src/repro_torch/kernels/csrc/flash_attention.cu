// Forward attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
//   flash_attention (_flash_kernel)
//
// What it computes: out[b, h, r] = softmax_k(scale * q[b, h, r] . k[b, h // rep, k])
// . v[b, h // rep, k] over the visible keys k, with GQA (head h reads kv head
// h // rep), right-aligned positions (query row r sits at skv - sq + r, so a
// decode query sees the whole cache), an optional causal mask and an
// optional sliding window (keys in (pos - window, pos]).  Inputs are float32
// or bfloat16; all arithmetic is IEEE float32 on the CUDA cores (no TF32, no
// tensor cores); the output has the input's dtype.
//
// What bounds it: for sq = skv = s, about 4 * d operations per visible
// (query, key) pair (q.k and p.v) against 2 * (b*h*s*d + 2*b*hkv*s*d) *
// sizeof(T) bytes: at the LM prefill shapes (s = 2048, d = 128) it is bound
// by operations, about 2,000 operations per byte.  On the float32 CUDA cores
// that bound is 67 TFLOP/s; bf16 tensor cores (wgmma) would lift it 15x and
// are work for a later kernel.
//
// Design: one block per (query tile of 64 rows, head, batch) walks the kv
// tiles in a loop inside the block; that loop takes the place of the TPU's
// sequential kv grid axis, whose VMEM scratch carried the running max, sum
// and accumulator.  Here those live in registers: 256 threads as 16 x 16,
// thread (ty, tx) owns query rows 4ty..4ty+3; for a kv tile it computes the
// scores of those rows against keys tx, tx+16, ... from q and k staged in
// shared memory (float32, rows padded to keep float4 loads aligned and the
// 16 lanes of a row on distinct banks), reduces each row's max and sum over
// its 16 lanes with shuffles, writes the probabilities to shared memory, and
// accumulates p.v into its rows' output columns tx, tx+16, ... in
// registers.  The kv loop covers only the tiles that hold a visible key:
// tiles wholly above the causal diagonal or wholly before the window are
// never loaded (the TPU kernel skips them with pl.when).  Ragged sq and skv
// are masked here, so the caller pads nothing.  Every sum runs in a fixed
// order and no atomics are used: the output is deterministic.
//
// Scores are kept in log2 units (q is scaled by scale * log2(e) and exp2f is
// used), which is exp(x) up to float32 rounding.  Masked scores are -inf;
// a row that sees no key at all (only possible when sq > skv) is written as
// 0, where the exact plain version gives NaN: the LM stack never asks for
// such a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // (b, h, sq, d) contiguous
  int b, h, hkv, sq, skv, d;
  long long q_sb, q_sh, q_ss;  // element strides of q over (batch, head, seq)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  float scale_log2;  // scale * log2(e)
  int causal;
  int window;  // 0: no window
};

// Keys per kv tile for a head-dim bucket: 64, or 32 from d = 128 on, so
// that q, k, v and p fit a few blocks' shared memory per SM.
template <int D>
__host__ __device__ constexpr int kv_tile() { return D >= 128 ? 32 : 64; }

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return (kBQ + 2 * kv_tile<D>()) * (D + 4) + kBQ * (kv_tile<D>() + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int BK = kv_tile<D>();
  constexpr int LD = D + 4;   // row stride of q, k, v in shared memory
  constexpr int LP = BK + 4;  // row stride of p
  constexpr int NJ = BK / 16; // score columns per thread
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (a.h / a.hkv);
  const T* q = static_cast<const T*>(a.q) + bb * a.q_sb + hh * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + bb * a.k_sb + kh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + bb * a.v_sb + kh * a.v_sh;
  const int q_off = a.skv - a.sq;  // right-aligned positions

  // The query tile, pre-scaled; rows past sq and columns past d are 0.
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    float x = 0.f;
    if (q0 + r < a.sq && c < a.d) x = to_float(q[(long long)(q0 + r) * a.q_ss + c]) * a.scale_log2;
    qs[r * LD + c] = x;
  }

  // The kv range that holds a visible key for some row of this tile.
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  int kv_end = a.skv;
  if (a.causal) kv_end = min(kv_end, q_off + q_last + 1);
  int kv_begin = 0;
  if (a.window > 0) kv_begin = max(0, q_off + q0 - a.window + 1);
  const int t_begin = kv_begin / BK;
  const int t_end = kv_end > kv_begin ? (kv_end + BK - 1) / BK : t_begin;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's k, v and p are no longer read
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const bool ok = k0 + r < a.skv && c < a.d;
      ks[r * LD + c] = ok ? to_float(k[(long long)(k0 + r) * a.k_ss + c]) : 0.f;
      vs[r * LD + c] = ok ? to_float(v[(long long)(k0 + r) * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&qs[(ty * 4 + i) * LD + c]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * LD + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_off + q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < a.skv;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        if (!ok) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // The row's 16 lanes are one half of the warp: xor offsets < 16 stay in it.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = exp2f(m[i] - m_new);  // 0 while nothing was visible before
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = exp2f(s[i][j] - m_new);  // masked: exp2(-inf) = 0
          sum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < NJ; ++j) ps[(ty * 4 + i) * LP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    const int jn = min(BK, a.skv - k0);  // keys past skv have p = 0
    for (int j = 0; j < jn; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * LP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float x = vs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], x, acc[i][c]);
      }
    }
  }

  T* out = static_cast<T*>(a.out) + ((long long)bb * a.h + hh) * a.sq * a.d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= a.sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < a.d) store(&out[(long long)r * a.d + col], l[i] > 0.f ? acc[i][c] / l[i] : 0.f);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t shmem = smem_floats<D>() * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  flash_fwd_kernel<T, D><<<grid, kThreads, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bucket(const Args& a, cudaStream_t stream) {
  if (a.d <= 16) return launch<T, 16>(a, stream);
  if (a.d <= 32) return launch<T, 32>(a, stream);
  if (a.d <= 64) return launch<T, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace

extern "C" {

// q: (b, h, sq, d); k, v: (b, hkv, skv, d), each with the given element
// strides over its first three axes and a contiguous last axis; out: (b, h,
// sq, d) contiguous.  dtype: 0 float32, 1 bfloat16 (q, k, v and out alike).
// 16 <= d <= 256, h % hkv == 0, window >= 0 (0: none).  Returns
// cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int dtype,
                           int b, int h, int hkv, int sq, int skv, int d,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           float scale, int causal, int window, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return (int)cudaGetLastError();
  Args a{q, k, v, out, b, h, hkv, sq, skv, d,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         scale * kLog2e, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_bucket<__nv_bfloat16>(a, s) : launch_bucket<float>(a, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
