// Phase-2 merge-matrix kernel for Hopper (sm_90a): the minimum squared
// distance between padded contour buffers, slot by slot, square (M, M) for
// the merge matrix and rectangular (A, B) for the delta merge's dirty rows.
//
// Replaces the TPU kernel src/repro/kernels/contour_dist.py:
//   contour_min_d2 (_contour_min_kernel)
// and computes, in its rectangular form, the reference's jnp function
// src/repro/core/ddc.py::cross_min_d2.
//
// What bounds it: its output.  The pair tests this data needs are the
// valid slots' vertices against each other (each unordered pair once in
// the square form), about five fp32 operations each; the phase-2 batches
// hold few valid slots (about 17 of 256 on the full-width path), so the
// tests take less time than the M*V*8 bytes in and A*B*4 bytes out.  At
// that size one launch is latency-bound (tools/phase2_ab.py on an H100:
// about 0.2 us for the grid, 0.7 for the compaction, 1.1 for an item's
// loads, barriers and stores and 1.2 for its tests, over a 2 us empty
// launch): the design keeps that chain short and gives each block at most
// one item while the grid has blocks to spare (kBlocksPerSm, measured
// against 1, 3, 4 and 8).
//
// Design: a persistent grid.  Every block compacts the valid slots of
// each side (an ordered ballot scan of the counts and flags, so every
// block holds the same lists in shared memory, with no host sync).  The
// work items are the pairs of valid slots, in the square form each
// unordered pair p < q once; the first blocks take one item each, and the
// blocks left over write BIG with plain stores wherever a slot is empty
// (and 0 on the square form's valid diagonal: a slot's min over its own
// vertex pairs is d2(p, p) = 0), so the fill is off the items' path.  An
// item stages its row slot's vertices in shared memory; each thread holds
// two column vertices in registers and walks a share of the row vertices,
// two at a time (every thread of a warp reads the same ones: a broadcast),
// with four running minima; a warp-shuffle and block min gives the entry,
// which the square form writes to (i, j) and (j, i).  Every entry of the
// output is written exactly once.  The TPU path centres coordinates for its
// MXU expansion; the difference form needs no centring.
//
// Large square batches (contour_min_d2_staged_launch): when the slot
// lists do not fit a block's shared memory (2 ints a slot: about 28,000
// slots at v 128, fewer than a 512-lane fold's 32,768), one block first
// compacts them into a global scratch buffer (compact_kernel: the same
// ordered scan, a launch of its own), and the main kernel reads the
// counts, the list and its length from there instead of compacting in
// every block.  Items, fill and arithmetic are the same.  No path gives
// the rectangular form that many slots; it has no staged entry.
//
// Exactness: d2 = fma(dy, dy, dx*dx), dx = __fsub_rn(r.x, c.x),
// dx*dx = __fmul_rn, the sum __fmaf_rn: the float32 expression XLA:CPU
// compiles from the jitted reference's sum((p - q) ** 2, -1) and the plain
// version (repro_torch/kernels/ref.py::cross_min_d2), bit for bit.
// fl(a - b) = -fl(b - a), so d2 is symmetric bit for bit and one test
// serves both (i, j) and (j, i); a min is exact in any order.  A slot pair
// with a padding vertex on either side (count < V) also sees BIG in its
// min, exactly as the plain version's where(valid, d2, BIG).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float vert_d2(float2 r, float2 c) {
  const float dx = __fsub_rn(r.x, c.x);
  const float dy = __fsub_rn(r.y, c.y);
  return __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
}

// cnt[s] = the real vertices of slot s (0 for an invalid slot), list[] =
// the slots with cnt > 0 in increasing order; returns their number.  The
// same in every block.  Ends with a barrier.
__device__ int compact(const int* __restrict__ counts, const uint8_t* __restrict__ valid,
                       int m, int v, int* cnt, int* list, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int s = base + threadIdx.x;
    int c = 0;
    if (s < m) {
      c = valid[s] ? max(0, min(counts[s], v)) : 0;
      cnt[s] = c;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, c > 0);
    if (lane == 0) warp_tot[warp] = __popc(ball);
    __syncthreads();
    int off = total, step = 0;
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? warp_tot[w] : 0;
      step += warp_tot[w];
    }
    if (c > 0) list[off + __popc(ball & ((1u << lane) - 1u))] = s;
    total += step;
    __syncthreads();
  }
  return total;
}

// The staged entry's first launch: one block compacts the slots into global
// memory, cnt (m,) and list (m,), and stores the list's length in *n.
__global__ void __launch_bounds__(kThreads)
compact_kernel(const int* __restrict__ counts, const uint8_t* __restrict__ valid, int m,
               int v, int* cnt, int* list, int* n) {
  __shared__ int warp_tot[kWarps];
  const int total = compact(counts, valid, m, v, cnt, list, warp_tot);
  if (threadIdx.x == 0) *n = total;
}

// Item t of the n(n - 1)/2 pairs p < q, row-major: the upper triangle
// with its diagonal of n - 1 slots, shifted one column right.
__device__ __forceinline__ void upper_pair(int t, int n, int& p, int& q) {
  const int n1 = n - 1;
  const long long r = (long long)n1 * (n1 + 1) / 2 - 1 - t;  // from the end
  long long k = (long long)((sqrtf(8.0f * (float)r + 1.0f) - 1.0f) * 0.5f);
  while ((k + 1) * (k + 2) / 2 <= r) ++k;
  while (k * (k + 1) / 2 > r) --k;
  p = n1 - 1 - (int)k;
  q = n1 - (int)(r - k * (k + 1) / 2);
}

// kStaged (square form only): the counts, the list and its length are in
// the global buffer ``staged``, from compact_kernel.
template <bool kSym, bool kStaged>
__global__ void __launch_bounds__(kThreads)
contour_min_kernel(const float2* __restrict__ pa, const int* __restrict__ cnt_a,
                   const uint8_t* __restrict__ valid_a, int a,
                   const float2* __restrict__ pb, const int* __restrict__ cnt_b,
                   const uint8_t* __restrict__ valid_b, int b, int v,
                   float* __restrict__ out, int* __restrict__ staged) {
  static_assert(kSym || !kStaged, "only the square form is staged");
  extern __shared__ float2 smem[];
  float2* rowv = smem;                                  // v row vertices
  float* red = reinterpret_cast<float*>(rowv + v);      // kWarps
  int* warp_tot = reinterpret_cast<int*>(red + kWarps); // kWarps
  int* ca = kStaged ? staged : warp_tot + kWarps;       // a
  int* la = ca + a;                                     // a
  int* cb = kSym ? ca : la + a;                         // b
  int* lb = kSym ? la : cb + b;                         // b

  int na, nb;
  if (kStaged) {
    na = nb = la[a];
  } else {
    na = compact(cnt_a, valid_a, a, v, ca, la, warp_tot);
    nb = kSym ? na : compact(cnt_b, valid_b, b, v, cb, lb, warp_tot);
  }
  // The square form's items skip the diagonal: a valid slot's min over its
  // own vertex pairs is d2(p, p) = 0, which the fill writes.
  const int items = kSym ? na * (na - 1) / 2 : na * nb;
  const int item_blocks = min(items, (int)gridDim.x);

  // BIG where either slot is empty (and 0 on the square form's valid
  // diagonal): plain stores, by the blocks that hold no item, or by every
  // block after its items when there are none to spare.
  auto fill = [&](int first, int stride) {
    for (int e = first; e < a * b; e += stride) {
      const int i = e / b;
      const int j = e - i * b;
      if (ca[i] == 0 || cb[j] == 0)
        out[e] = kBig;
      else if (kSym && i == j)
        out[e] = 0.f;
    }
  };
  const int fill_blocks = (int)gridDim.x - item_blocks;
  if ((int)blockIdx.x >= item_blocks) {
    fill(((int)blockIdx.x - item_blocks) * kThreads + threadIdx.x, fill_blocks * kThreads);
    return;
  }

  // One item per pair of valid slots.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    int p, q;
    if (kSym) {
      upper_pair(t, na, p, q);
    } else {
      p = t / nb;
      q = t - p * nb;
    }
    const int i = la[p], j = lb[q];
    const int ci = ca[i], cj = cb[j];
    // Row groups: a thread holds two column vertices; with fewer than
    // 2 * kThreads columns, the spare threads split the rows.
    const int half = (cj + 1) >> 1;
    const int groups = half >= kThreads ? 1 : min(ci, kThreads / half);
    const int width = groups * half;
    const float2* col = pb + (size_t)j * v;
    float2 c = make_float2(0.f, 0.f), c2 = c;
    if (threadIdx.x < width) {
      const int w = 2 * (threadIdx.x % half);
      c = col[w];
      c2 = col[min(w + 1, cj - 1)];
    }
    for (int k = threadIdx.x; k < ci; k += kThreads) rowv[k] = pa[(size_t)i * v + k];
    __syncthreads();
    float b0 = __int_as_float(0x7f800000), b1 = b0, b2 = b0, b3 = b0;
    for (int u = threadIdx.x; u < width; u += kThreads) {
      const int g = u / half;
      if (u != threadIdx.x) {
        const int w = 2 * (u - g * half);
        c = col[w];
        c2 = col[min(w + 1, cj - 1)];
      }
      int r = g;
      for (; r + groups < ci; r += 2 * groups) {
        const float2 ra = rowv[r], rb = rowv[r + groups];
        b0 = fminf(b0, vert_d2(ra, c));
        b1 = fminf(b1, vert_d2(ra, c2));
        b2 = fminf(b2, vert_d2(rb, c));
        b3 = fminf(b3, vert_d2(rb, c2));
      }
      for (; r < ci; r += groups) {
        b0 = fminf(b0, vert_d2(rowv[r], c));
        b1 = fminf(b1, vert_d2(rowv[r], c2));
      }
    }
    float best = fminf(fminf(b0, b1), fminf(b2, b3));
    for (int o = 16; o > 0; o >>= 1) best = fminf(best, __shfl_xor_sync(0xffffffffu, best, o));
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      float d = lane < kWarps ? red[lane] : __int_as_float(0x7f800000);
      for (int o = kWarps / 2; o > 0; o >>= 1)
        d = fminf(d, __shfl_xor_sync(0xffffffffu, d, o));
      if (ci < v || cj < v) d = fminf(d, kBig);  // a padding vertex pair
      if (lane == 0) {
        out[(size_t)i * b + j] = d;
        if (kSym) out[(size_t)j * b + i] = d;
      }
    }
  }
  if (fill_blocks == 0) fill(blockIdx.x * kThreads + threadIdx.x, gridDim.x * kThreads);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

// kStaged: staged is an int buffer of 2 * a + 1 for the slot lists that do
// not fit shared memory (square form only).
template <bool kSym, bool kStaged>
int launch(const void* pa, const void* cnta, const void* va, int a, const void* pb,
           const void* cntb, const void* vb, int b, int v, void* out, int* staged,
           void* stream) {
  if (a <= 0 || b <= 0) return (int)cudaGetLastError();
  if ((long long)a * b >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const size_t lists = kStaged ? 0 : (size_t)(kSym ? 2 * a : 2 * (a + b)) * sizeof(int);
  const size_t shmem = (size_t)v * sizeof(float2) + 2 * kWarps * sizeof(int) + lists;
  auto kernel = contour_min_kernel<kSym, kStaged>;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  if (kStaged) {
    // Layout: cnt (a), list (a), n.
    compact_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)cnta, (const uint8_t*)va, a, v, staged, staged + a, staged + 2 * a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // At most one block per item (each unordered pair of slots in the
  // square form), and enough more for the fill; at most kBlocksPerSm an SM.
  const long long items = kSym ? (long long)a * (a - 1) / 2 : (long long)a * b;
  const long long fill = ((long long)a * b + kThreads - 1) / kThreads;
  long long grid = items + fill;
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  if (grid > cap) grid = cap;
  kernel<<<(int)grid, kThreads, shmem, (cudaStream_t)stream>>>(
      (const float2*)pa, (const int*)cnta, (const uint8_t*)va, a, (const float2*)pb,
      (const int*)cntb, (const uint8_t*)vb, b, v, (float*)out, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pts: (m, v, 2) f32; counts: (m,) i32; valid: (m,) bool; out: (m, m) f32.
int contour_min_d2_launch(const void* pts, const void* counts, const void* valid, int m,
                          int v, void* out, void* stream) {
  return launch<true, false>(pts, counts, valid, m, pts, counts, valid, m, v, out, nullptr,
                             stream);
}

// pa: (a, v, 2), pb: (b, v, 2) f32; cnt*: i32; valid*: bool; out: (a, b) f32.
int cross_min_d2_launch(const void* pa, const void* cnta, const void* va, int a,
                        const void* pb, const void* cntb, const void* vb, int b, int v,
                        void* out, void* stream) {
  return launch<false, false>(pa, cnta, va, a, pb, cntb, vb, b, v, out, nullptr, stream);
}

// The square form with the slot lists staged in global memory: two launches
// (compact_kernel, then the main kernel); staged is an i32 buffer of
// 2 * m + 1 elements.
int contour_min_d2_staged_launch(const void* pts, const void* counts, const void* valid,
                                 int m, int v, void* out, void* staged, void* stream) {
  return launch<true, true>(pts, counts, valid, m, pts, counts, valid, m, v, out,
                            (int*)staged, stream);
}

const char* contour_dist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
