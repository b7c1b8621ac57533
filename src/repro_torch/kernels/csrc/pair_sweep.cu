// DBSCAN's pair kernels for Hopper (sm_90a): the eps-neighbour count and
// the min-label propagation sweep, dense and block-sparse, on one pair
// sweep that tests each unordered pair of points once.
//
// Replaces the TPU kernels src/repro/kernels/pairwise_dist.py:
//   neighbor_count         (_count_kernel)            -- per point, the masked
//                                                        points within eps,
//                                                        self included; 0 for
//                                                        a masked-out point
//   neighbor_count_sparse  (_count_sparse_kernel)     -- the same over the
//                                                        active tile pairs
//   min_label_sweep        (_min_label_kernel)        -- per point, the min
//                                                        over all columns of
//                                                        (within eps and
//                                                        masked core ? label
//                                                        : 2^30)
//   min_label_sweep_sparse (_min_label_sparse_kernel) -- the same over the
//                                                        active tile pairs,
//                                                        from 2^30
//
// What bounds them: instruction issue on the CUDA cores.  The pair test is
// IEEE float32 in a fixed FMA form that the reference's bits depend on,
//   d2 = (xx_i + xx_j) - 2 * fma(x_i1, x_j1, x_i0 * x_j0),
// and no tensor-core product reproduces it (TF32 and bf16 round the
// inputs, FP64 rounds once where float32 rounds twice), so every test is
// issued one instruction at a time: FMUL, FFMA (the dot), FADD (xx_i +
// xx_j), FFMA (d2 = fma(-2, dot, s)), FSETP and two predicated integer
// folds (IMNMX for the sweep, IADD for the count) -- 7 per test as the
// source reads (not counted from SASS), against 4 bytes of output per point.
//
// Design: one sweep, two operations (Op below).
//   - Each unordered pair is tested once.  d2(i, j) and d2(j, i) are the
//     same float32 bits (each product, the FMA and the sum commute and
//     round once), so one test feeds both directions: row i folds w_j and
//     row j folds w_i.  The sweep folds w = (mask && core) ? label : 2^30
//     with min (MinOp); the count folds w = mask ? 1 : 0 with + (CountOp).
//     Both are exact and order-free on integers.
//   - Work items are unordered pairs of square tiles {A, B} of S <= 256
//     points.  The cover is exact, as a count needs: an off-diagonal item
//     (A != B) feeds its rows (A's points against B's) and its columns (B's
//     points against A's) from the same tests; a diagonal item (A == B)
//     feeds only its rows, whose S x S ordered tests give each point of
//     the tile every point of the tile once, itself included (d2(i, i) is
//     0 exactly in both forms, so a masked point counts itself).  The
//     choice is uniform across the block.  A diagonal item still folds its
//     column values (the same pairs seen from the other side) and drops
//     them: one instantiation of the tests, where a second one without
//     the column folds measured slower for every kernel
//     (tools/sweep_sym_ab.py; B2 0.1844 against 0.1827 ms).
//   - Register blocking.  256 threads test an item of S x S pairs as a
//     grid of GR row groups x GC column groups (Blocking below); thread
//     (g, c) holds TM rows g + GR i in registers and streams TN columns
//     c + GC j from shared memory, one float4 (x0, x1, |x|^2, w) each.  At
//     S = 256 that is 8 rows x 32 columns: 40 shared loads for 256 tests.
//     Column groups are rotated by the row group so that a warp's column
//     loads and shared atomics spread over GC addresses.  Row values stay
//     in registers over the item; a column's value over the thread's rows
//     is complete after its TM tests.  Both merge across threads with one
//     shared integer atomic per value; then the block issues one global
//     integer atomic per row and per column of the item (atomicMin below
//     the output's start value; atomicAdd of a non-zero count to a row
//     whose mask is true).  Integer atomics merge exactly in any order:
//     every run gives the same bits, with no second pass and no scratch.
//   - Balanced work.  A persistent grid (the blocks that fit on the SMs
//     together) walks the item list with a stride; each block loads the
//     next item's points into registers while it tests the current one.
//     Dense: the T(T+1)/2 unordered pairs of the ceil(n / 256) tiles of
//     256, the ragged last tile padded in shared memory (a padded point
//     has weight INT_MAX for the min and 0 for the count, so it folds
//     nothing, and it is never written).  Sparse: the T diagonal tiles of
//     bt points cut into k = bt / S sub-tiles (k(k+1)/2 items each), then
//     k^2 items for each active pair I < J of the upper list that
//     ops.build_tile_pairs builds once per dbscan call; its length is read
//     here from device memory, so a launch needs no host sync.  S is the
//     largest of 256, 128, 64, 32 that divides bt.
//
// Exactness, item by item (the result equals the plain version on every
// input the wrappers accept, labels above 2^30 included):
//   - The tested form d2 = fma(-2, dot, s) equals s - 2 * dot bit for bit
//     wherever 2 * dot is finite (2 * dot is exact; both round once).
//     With every coordinate of both tiles within 2^62, |dot| <= 2^125 and
//     2 * dot is finite (tests/test_torch_sweep_sym.py holds both).
//   - The count's fast path needs nothing more: it sums w over the
//     within-eps columns from 0, as the plain version does.
//   - The sweep's fast path folds predicated mins into row and column mins
//     that start at 2^30, giving min(2^30, min of w over the within-eps
//     columns).  That equals the item's exact value, the min over its
//     columns of (within ? w : 2^30), whenever the column tile holds a
//     point with w <= 2^30: if that point is within eps the min is <= 2^30
//     either way, and if it is not, the exact value includes 2^30 too.
//   - An item whose coordinates leave 2^62 (or are NaN), or, for the sweep,
//     one of whose tiles has no point with w <= 2^30, takes the exact path
//     instead: one thread a row, s - 2 * dot, (within ? w : 2^30) folded
//     from INT_MAX (the sweep) or (within ? w : 0) summed from 0 (the
//     count) over the real columns.  dbscan never sends one (its labels
//     are indices below 2^30, its points centred): the exact path is there
//     for correctness alone, held by the card tests at small n, and no
//     full-width workload runs it, so its speed is not measured.
//   - Every ordered pair of points meets once in some item (the dense list
//     holds all tile pairs, the sparse one every active pair once with the
//     diagonal), so the sum or min over items is the plain version's.  The
//     count's output starts at 0 and a masked-out row is never written;
//     the dense sweep's starts at INT_MAX (its plain version folds from
//     there), the sparse one's at 2^30 (as its plain version and the TPU
//     kernels do); a sweep row whose mask is false writes 2^30.
//
// Registers and residency (-Xptxas -v, sm_90a, printed by
// tools/sweep_sym_ab.py), no spills in any kernel; shared memory 40 bytes
// a point of S:
//   kernel                          S = 256  128  64  32  (dense: 256)
//   neighbor_count_sym_kernel           95                 2 blocks/SM
//   neighbor_count_sparse_sym_kernel   109   95  64  52    2, 2, 4, 4
//   min_label_sym_kernel                95                 2
//   min_label_sparse_sym_kernel         95   95  71  56    2, 2, 3, 4
// (blocks of 256 threads an SM holds by registers).  So 16 warps stay on
// an SM at S = 256 and 128, and the persistent grid is 264 blocks on lane
// 0's inputs: 8,256 dense items (31.3 rounds), 1,488 sparse ones (5.6).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kDenseTile = 256;
constexpr int kSentinel = 1 << 30;
constexpr int kNone = 0x7fffffff;      // the min's identity: its padding's weight
constexpr float kFoldBound = 0x1p62f;  // |coordinate| up to which the fold is exact

// Rows a thread owns in an item of S x S tests (S^2 / 256 tests a thread).
template <int S>
struct RowsPerThread {
  static constexpr int TM = S >= 128 ? 8 : S == 64 ? 4 : 2;
};

__device__ __forceinline__ float sqnorm(float a, float b) {
  return __fmaf_rn(b, b, __fmul_rn(a, a));
}

// The plain version's pair test, (xx_i + xx_j) - 2 * dot.
__device__ __forceinline__ bool within_exact(float4 r, float4 c, float eps_sq) {
  const float dot = __fmaf_rn(r.y, c.y, __fmul_rn(r.x, c.x));
  return __fsub_rn(__fadd_rn(r.z, c.z), __fmul_rn(2.0f, dot)) <= eps_sq;
}

__device__ __forceinline__ bool foldable(float2 p) {
  return fabsf(p.x) <= kFoldBound && fabsf(p.y) <= kFoldBound;  // false on NaN
}

// The min-label sweep: w = (mask && core) ? label : 2^30, folded with min.
// kStart is the output's start value (INT_MAX dense, 2^30 sparse).
template <int kStart>
struct MinOp {
  static constexpr int kInit = kSentinel;    // an item's row and column mins start here
  static constexpr int kExactInit = kNone;   // the exact path's fold starts here
  static constexpr bool kNeedsSmall = true;  // the fast path needs a w <= 2^30 in each tile
  const uint8_t* mask;
  const int* labels;
  const uint8_t* core;

  // One point as the block loads it for the next item: raw, in registers,
  // so that the loads stay in flight while the current item is tested.  A
  // padded point (i >= n) has label INT_MAX and counts as masked core, so
  // its weight is INT_MAX.
  struct Raw {
    float2 p;
    int label;
    uint8_t mask, core;
  };
  __device__ __forceinline__ Raw load(const float2* x, int i, int n) const {
    Raw r{make_float2(0.f, 0.f), kNone, 1, 1};
    if (i < n) {
      r.p = __ldg(x + i);
      r.label = __ldg(labels + i);
      r.mask = __ldg(mask + i);
      r.core = __ldg(core + i);
    }
    return r;
  }
  __device__ static int weight(const Raw& r) {
    return (r.mask != 0 && r.core != 0) ? r.label : kSentinel;
  }
  __device__ static bool ok(const Raw& r) { return r.mask != 0; }
  __device__ static bool small(int w) { return w <= kSentinel; }  // false for padding

  // Where d2 <= eps_sq: a = min(a, wa), b = min(b, wb), as two predicated
  // integer mins.  setp.le is false on a NaN.
  __device__ static void fold(float d2, float eps_sq, int& a, int wa, int& b, int wb) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.le.f32 p, %2, %3;\n\t"
        "@p min.s32 %0, %0, %4;\n\t"
        "@p min.s32 %1, %1, %5;\n\t}"
        : "+r"(a), "+r"(b)
        : "f"(d2), "f"(eps_sq), "r"(wa), "r"(wb));
  }
  __device__ static int exact(int acc, bool within, int w) {
    return min(acc, within ? w : kSentinel);
  }
  __device__ static void merge(int* v, int x) { atomicMin(v, x); }
  // Row i's value (its mask false: 2^30), where below the output's start
  // value (a write of kStart or more changes nothing).
  __device__ static void commit(int* __restrict__ out, int i, bool ok, int v) {
    v = ok ? v : kSentinel;
    if (v < kStart) atomicMin(out + i, v);
  }
};

// The neighbour count: w = mask ? 1 : 0, folded with +.  The output starts
// at 0; a masked-out row is never written.
struct CountOp {
  static constexpr int kInit = 0;
  static constexpr int kExactInit = 0;
  static constexpr bool kNeedsSmall = false;
  const uint8_t* mask;

  // As MinOp::Raw; a padded point is unmasked: weight 0, never written.
  struct Raw {
    float2 p;
    uint8_t mask;
  };
  __device__ __forceinline__ Raw load(const float2* x, int i, int n) const {
    Raw r{make_float2(0.f, 0.f), 0};
    if (i < n) {
      r.p = __ldg(x + i);
      r.mask = __ldg(mask + i);
    }
    return r;
  }
  __device__ static int weight(const Raw& r) { return r.mask != 0 ? 1 : 0; }
  __device__ static bool ok(const Raw& r) { return r.mask != 0; }
  __device__ static bool small(int) { return true; }

  // Where d2 <= eps_sq: a += wa, b += wb, as two predicated integer adds.
  __device__ static void fold(float d2, float eps_sq, int& a, int wa, int& b, int wb) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.le.f32 p, %2, %3;\n\t"
        "@p add.s32 %0, %0, %4;\n\t"
        "@p add.s32 %1, %1, %5;\n\t}"
        : "+r"(a), "+r"(b)
        : "f"(d2), "f"(eps_sq), "r"(wa), "r"(wb));
  }
  __device__ static int exact(int acc, bool within, int w) { return acc + (within ? w : 0); }
  // Unconditional: a shared add of 0 costs less than a branch around it
  // (B1 0.2098 against 0.1741 ms, tools/sweep_sym_ab.py).
  __device__ static void merge(int* v, int x) { atomicAdd(v, x); }
  __device__ static void commit(int* __restrict__ out, int i, bool ok, int v) {
    if (ok && v != 0) atomicAdd(out + i, v);
  }
};

// The thread grid of an item of S x S tests: kThreads threads in GR row
// groups x GC column groups, TM rows x TN columns each.  Thread (g, c) owns
// rows g + GR i and columns c + GC j, with c = (tid / GR + g) % GC.
template <int S, int TM>
struct Blocking {
  static constexpr int GR = S / TM;
  static constexpr int TN = S * S / (kThreads * TM);
  static constexpr int GC = S / TN;
  static_assert(GR * GC == kThreads && GR * TM == S && GC * TN == S, "blocking");
};

// The fast path: every test of one item, rows of tile_a against columns of
// tile_b, folded into acc_a (rows) and acc_b (columns), which start at
// Op::kInit.
template <int S, int TM, class Op>
__device__ __forceinline__ void test_item(const float4* __restrict__ tile_a,
                                          const float4* __restrict__ tile_b, int* acc_a,
                                          int* acc_b, int tid, float eps_sq) {
  using B = Blocking<S, TM>;
  const int g = tid % B::GR;
  const int c0 = (tid / B::GR + g) % B::GC;
  float4 r[TM];
  int racc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    r[i] = tile_a[g + B::GR * i];
    racc[i] = Op::kInit;
  }
  float4 next = tile_b[c0];
#pragma unroll
  for (int j = 0; j < B::TN; ++j) {
    const float4 c = next;  // the next column loads while this one is tested
    if (j + 1 < B::TN) next = tile_b[c0 + B::GC * (j + 1)];
    const int wc = __float_as_int(c.w);
    int cacc = Op::kInit;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float dot = __fmaf_rn(r[i].y, c.y, __fmul_rn(r[i].x, c.x));
      const float d2 = __fmaf_rn(-2.0f, dot, __fadd_rn(r[i].z, c.z));
      Op::fold(d2, eps_sq, racc[i], wc, cacc, __float_as_int(r[i].w));
    }
    Op::merge(&acc_b[c0 + B::GC * j], cacc);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) Op::merge(&acc_a[g + B::GR * i], racc[i]);
}

// The exact path: row tid of `rows` against the real columns of `cols`
// (those below n - c0), folded from Op::kExactInit.
template <class Op>
__device__ __forceinline__ int exact_row(const float4* __restrict__ rows,
                                         const float4* __restrict__ cols, int real_cols, int tid,
                                         float eps_sq) {
  const float4 r = rows[tid];
  int acc = Op::kExactInit;
  for (int j = 0; j < real_cols; ++j) {
    const float4 c = cols[j];
    acc = Op::exact(acc, within_exact(r, c, eps_sq), __float_as_int(c.w));
  }
  return acc;
}

// q in [0, m(m+1)/2) -> the unordered pair {a <= b} of [0, m): pair (r, (r
// + c) mod m) for c = q / m, r = q % m (round-robin: c covers every pair at
// cyclic distance c once; at distance m / 2, m even, q < m(m+1)/2 leaves
// only r < m / 2, so no pair is taken twice).
__device__ __forceinline__ void divmod(long long q, int d, int& quo, int& rem) {
  quo = (int)(q / d);
  rem = (int)(q - (long long)quo * d);
}

__device__ __forceinline__ void unordered_pair(long long q, int m, int& a, int& b) {
  int c, r;
  divmod(q, m, c, r);
  const int t = r + c < m ? r + c : r + c - m;
  a = min(r, t);
  b = max(r, t);
}

// Dense: the unordered pairs of the ceil(n / 256) tiles of 256 points.
struct DenseItems {
  static constexpr int S = kDenseTile;
  int tiles;
  __device__ long long count() const { return (long long)tiles * (tiles + 1) / 2; }
  __device__ void at(long long q, int& a0, int& b0) const {
    int a, b;
    unordered_pair(q, tiles, a, b);
    a0 = a * S;
    b0 = b * S;
  }
};

// Sparse: tiles of bt points, sub-tiles of S = bt / k.  First the T
// diagonal tiles' k(k+1)/2 unordered sub-tile pairs each, then the k^2
// sub-tile pairs of each active pair I < J of the upper list.
template <int S>
struct SparseItems {
  const int* up_rows;
  const int* up_cols;
  int n_up, tiles, bt, k;
  __device__ long long count() const {
    return (long long)tiles * (k * (k + 1) / 2) + (long long)n_up * k * k;
  }
  __device__ void at(long long q, int& a0, int& b0) const {
    const long long diag = (long long)tiles * (k * (k + 1) / 2);
    int t, sub, a, b;
    if (q < diag) {
      divmod(q, k * (k + 1) / 2, t, sub);
      unordered_pair(sub, k, a, b);
      a0 = t * bt + a * S;
      b0 = t * bt + b * S;
    } else {
      divmod(q - diag, k * k, t, sub);  // t: the pair of the upper list
      a0 = up_rows[t] * bt + (sub / k) * S;
      b0 = up_cols[t] * bt + (sub % k) * S;
    }
  }
};

// The persistent loop: each block walks items blockIdx.x, + gridDim.x, ...
template <int S, int TM, class Op, class Items>
__device__ __forceinline__ void sym_body(const float2* __restrict__ x, const Op& op, int n,
                                         float eps_sq, const Items& items,
                                         int* __restrict__ out) {
  __shared__ float4 tile_a[S], tile_b[S];
  __shared__ int acc_a[S], acc_b[S];
  const int tid = threadIdx.x;
  const long long n_items = items.count();
  long long q = blockIdx.x;
  int a0 = 0, b0 = 0;
  typename Op::Raw pa{}, pb{};
  if (q < n_items) {
    items.at(q, a0, b0);
    if (tid < S) {
      pa = op.load(x, a0 + tid, n);
      pb = op.load(x, b0 + tid, n);
    }
  }
  for (; q < n_items; q += gridDim.x) {
    const int a = a0, b = b0;
    const bool diag = a == b;  // block-uniform
    bool ok_a = false, ok_b = false, small_a = false, small_b = false, fold = true;
    if (tid < S) {
      const int wa = Op::weight(pa), wb = Op::weight(pb);
      tile_a[tid] = make_float4(pa.p.x, pa.p.y, sqnorm(pa.p.x, pa.p.y), __int_as_float(wa));
      tile_b[tid] = make_float4(pb.p.x, pb.p.y, sqnorm(pb.p.x, pb.p.y), __int_as_float(wb));
      acc_a[tid] = Op::kInit;
      acc_b[tid] = Op::kInit;
      ok_a = Op::ok(pa);  // padding is never written
      ok_b = Op::ok(pb);
      small_a = Op::small(wa);
      small_b = Op::small(wb);
      fold = foldable(pa.p) && foldable(pb.p);
    }
    // Block-uniform: the fast path needs every coordinate within the fold's
    // bound and, for the sweep, a point of w <= 2^30 in each tile.
    bool fast = __syncthreads_and(fold);
    if constexpr (Op::kNeedsSmall) {
      const bool any_small_a = __syncthreads_or(small_a);
      fast = fast && any_small_a && __syncthreads_or(small_b);
    }
    if (q + gridDim.x < n_items) {  // the next item's points, in flight meanwhile
      items.at(q + gridDim.x, a0, b0);
      if (tid < S) {
        pa = op.load(x, a0 + tid, n);
        pb = op.load(x, b0 + tid, n);
      }
    }
    if (fast) {
      test_item<S, TM, Op>(tile_a, tile_b, acc_a, acc_b, tid, eps_sq);
    } else if (tid < S) {
      acc_a[tid] = exact_row<Op>(tile_a, tile_b, min(S, n - b), tid, eps_sq);
      if (!diag) acc_b[tid] = exact_row<Op>(tile_b, tile_a, min(S, n - a), tid, eps_sq);
    }
    __syncthreads();
    if (tid < S) {
      if (a + tid < n) Op::commit(out, a + tid, ok_a, acc_a[tid]);
      if (!diag && b + tid < n) Op::commit(out, b + tid, ok_b, acc_b[tid]);
    }
    __syncthreads();
  }
}

// One named kernel per function, so that profiles tell them apart.
__global__ void __launch_bounds__(kThreads, 2)
neighbor_count_sym_kernel(const float2* __restrict__ x, const uint8_t* __restrict__ mask,
                          int n, float eps_sq, int* __restrict__ out) {
  const DenseItems items{(n + kDenseTile - 1) / kDenseTile};
  sym_body<kDenseTile, RowsPerThread<kDenseTile>::TM>(x, CountOp{mask}, n, eps_sq, items, out);
}

template <int S>
__global__ void __launch_bounds__(kThreads, 2)
neighbor_count_sparse_sym_kernel(const float2* __restrict__ x, const uint8_t* __restrict__ mask,
                                 const int* __restrict__ up_rows,
                                 const int* __restrict__ up_cols,
                                 const int* __restrict__ n_up, int n, int bt, float eps_sq,
                                 int* __restrict__ out) {
  const SparseItems<S> items{up_rows, up_cols, *n_up, n / bt, bt, bt / S};
  sym_body<S, RowsPerThread<S>::TM>(x, CountOp{mask}, n, eps_sq, items, out);
}

__global__ void __launch_bounds__(kThreads, 2)
min_label_sym_kernel(const float2* __restrict__ x, const uint8_t* __restrict__ mask,
                     const int* __restrict__ labels, const uint8_t* __restrict__ core, int n,
                     float eps_sq, int* __restrict__ out) {
  const DenseItems items{(n + kDenseTile - 1) / kDenseTile};
  sym_body<kDenseTile, RowsPerThread<kDenseTile>::TM>(
      x, MinOp<kNone>{mask, labels, core}, n, eps_sq, items, out);
}

template <int S>
__global__ void __launch_bounds__(kThreads, 2)
min_label_sparse_sym_kernel(const float2* __restrict__ x, const uint8_t* __restrict__ mask,
                            const int* __restrict__ labels, const uint8_t* __restrict__ core,
                            const int* __restrict__ up_rows, const int* __restrict__ up_cols,
                            const int* __restrict__ n_up, int n, int bt, float eps_sq,
                            int* __restrict__ out) {
  const SparseItems<S> items{up_rows, up_cols, *n_up, n / bt, bt, bt / S};
  sym_body<S, RowsPerThread<S>::TM>(x, MinOp<kSentinel>{mask, labels, core}, n, eps_sq, items,
                                    out);
}

// The persistent grid: as many blocks as fit on the SMs together.
// Computed once per kernel (every card of a host is alike here).
template <class K>
int resident_blocks(K kernel, int* cache) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    *cache = sms * (per_sm > 0 ? per_sm : 1);
  }
  return *cache;
}

// At most `items` blocks (at least one), at most the resident ones.
int grid_for(long long items, int resident) {
  return (int)(items < resident ? (items > 0 ? items : 1) : resident);
}

long long dense_items(int n) {
  const long long tiles = (n + kDenseTile - 1) / kDenseTile;
  return tiles * (tiles + 1) / 2;
}

// The most sparse items there can be: every pair I < J active.
long long sparse_items(int n, int bt, int tile) {
  const long long t = n / bt, k = bt / tile;
  return t * (k * (k + 1) / 2) + t * (t - 1) / 2 * k * k;
}

bool bad_sparse_shape(int n, int bt, int tile) {
  return bt <= 0 || n % bt != 0 || tile <= 0 || bt % tile != 0;
}

// f(std::integral_constant<int, S>{}) for the sub-tile S == tile; false if
// tile is not one of 256, 128, 64, 32.
template <class F>
bool with_tile(int tile, F f) {
  switch (tile) {
    case 256: f(std::integral_constant<int, 256>{}); return true;
    case 128: f(std::integral_constant<int, 128>{}); return true;
    case 64: f(std::integral_constant<int, 64>{}); return true;
    case 32: f(std::integral_constant<int, 32>{}); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// x: (n, 2) float32, mask: (n,) uint8, contiguous; out: (n,) int32,
// filled with 0 by the caller.
int neighbor_count_launch(const void* x, const void* mask, int n, float eps_sq, void* out,
                          void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  static int resident = 0;
  const int grid = grid_for(dense_items(n), resident_blocks(neighbor_count_sym_kernel, &resident));
  neighbor_count_sym_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (const uint8_t*)mask, n, eps_sq, (int*)out);
  return (int)cudaGetLastError();
}

// up_rows/up_cols: the upper list's tile rows and columns (I < J, active
// pairs first), n_up: () int32 on the device, their count.  n a multiple of
// bt; tile: the sub-tile S, one of 256, 128, 64, 32, dividing bt.  out:
// (n,) int32, filled with 0 by the caller.
int neighbor_count_sparse_launch(const void* x, const void* mask, const void* up_rows,
                                 const void* up_cols, const void* n_up, int n, int bt,
                                 int tile, float eps_sq, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (bad_sparse_shape(n, bt, tile)) return (int)cudaErrorInvalidValue;
  const bool known = with_tile(tile, [&](auto s) {
    constexpr int S = decltype(s)::value;
    static int resident = 0;
    auto kernel = neighbor_count_sparse_sym_kernel<S>;
    const int grid = grid_for(sparse_items(n, bt, S), resident_blocks(kernel, &resident));
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float2*)x, (const uint8_t*)mask, (const int*)up_rows, (const int*)up_cols,
        (const int*)n_up, n, bt, eps_sq, (int*)out);
  });
  return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// x: (n, 2) float32, mask/core: (n,) uint8, labels: (n,) int32, all
// contiguous; out: (n,) int32, filled with INT_MAX by the caller.
int min_label_sweep_launch(const void* x, const void* mask, const void* labels,
                           const void* core, int n, float eps_sq, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  static int resident = 0;
  const int grid = grid_for(dense_items(n), resident_blocks(min_label_sym_kernel, &resident));
  min_label_sym_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (const uint8_t*)mask, (const int*)labels, (const uint8_t*)core, n,
      eps_sq, (int*)out);
  return (int)cudaGetLastError();
}

// As neighbor_count_sparse_launch, with labels and core as for the dense
// sweep; out: (n,) int32, filled with 2^30 by the caller.
int min_label_sweep_sparse_launch(const void* x, const void* mask, const void* labels,
                                  const void* core, const void* up_rows, const void* up_cols,
                                  const void* n_up, int n, int bt, int tile, float eps_sq,
                                  void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (bad_sparse_shape(n, bt, tile)) return (int)cudaErrorInvalidValue;
  const bool known = with_tile(tile, [&](auto s) {
    constexpr int S = decltype(s)::value;
    static int resident = 0;
    auto kernel = min_label_sparse_sym_kernel<S>;
    const int grid = grid_for(sparse_items(n, bt, S), resident_blocks(kernel, &resident));
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float2*)x, (const uint8_t*)mask, (const int*)labels, (const uint8_t*)core,
        (const int*)up_rows, (const int*)up_cols, (const int*)n_up, n, bt, eps_sq, (int*)out);
  });
  return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // extern "C"
