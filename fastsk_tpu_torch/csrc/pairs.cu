// Kernel A: the exact gapped k-mer count matrix from one-hot windows.
//
// Replaces fastsk_tpu/ops/pairs_pallas.py:_pairs_kernel (called through
// pairs_kernel_blocks and kernel/pairs_engine.py:_pairs_full_device_jit).
// It computes the full symmetric [n_pad, n_pad] int32 matrix
//
//     K[i, j] = sum_{p, q} C(D(w_ip, w_jq), k),   D = <x_ip, x_jq>
//
// over sequence-aligned one-hot window rows x [n_pad * p_pad, 4 * W] (0/1
// bytes, four to a 32-bit word). Invalid and padding windows are all-zero
// rows: D = 0 and C(0, k) = 0 for k >= 1, so they add nothing.
//
// What bounds it on the H100: integer work and shared-memory traffic per
// window pair. Each pair costs W __dp4a (four byte products each), a
// table lookup and an add; there are about (n_pad * p_pad)^2 / 2 pairs.
// The design against that:
//   - a block owns an S x S tile of sequences (i tile <= j tile: the
//     upper block triangle) and writes both K[i, j] and K[j, i], so no
//     block depends on another and no mirror pass runs;
//   - the j tile's windows sit in shared memory; each thread keeps RI
//     i-windows in registers and streams the j windows of one sequence
//     past them, so one shared-memory word feeds RI __dp4a;
//   - threads of a warp share their j sequence, so their shared loads are
//     broadcasts;
//   - C(d, k) for d <= g comes from a 32-entry int32 table in shared
//     memory (the TPU's falling-factorial chain and deferred /k! only kept
//     the VPU exact; integers make that unnecessary);
//   - sums are int32: every per-pair total is < p_pad^2 * C(g, k) < 2^31,
//     which the engine guards.
// That is the `__dp4a` body (pairs_kernel), kernel A's first port: A runs
// it only where the caller asks for it (body="dp4a"). Kernel A's body,
// pairs_mma_kernel and pairs_mma_deep_kernel below, counts the matches on
// the int8 tensor cores at every shape.
//
// Kernel H: variants of kernel A's tensor-core body that attribute its
// time (replace experiments/probe_pairs.py:make_kernel, keeping its
// variant names). Each runs A's grid, plan, loads, ring and writes in the
// layout A takes, and differs only in the per-pair work:
//   noop      tile set-up and the output writes only (zeros);
//   loads     A's loads and ring, no products (zeros);
//   matmul    the wgmma products, kept live by a per-thread sum of the
//             match counts, no lookup: each tile pair's sum of match
//             counts (mod 2^32) at its corner entry;
//   skeleton  the products and A's bin sums with weight w = d: K = S S^T,
//             S_i = sum_p x_ip;
//   no_mma    A's epilogue on opaque zero counts, every lookup run (zeros);
//   current   kernel A itself (the C(d, k) table);
//   int32     C(d, k) as the falling-factorial chain in registers, summed
//             per flush and divided exactly by k! once, in place of the
//             table (A's counts).
// A's entry point is the `current` variant, whose code is A's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace fastsk_hopper;

constexpr int kThreads = 256;

// kernel H's variants, in the order of the C entry point
enum Variant : int {
  kNoop = 0, kLoads = 1, kMatmul = 2, kSkeleton = 3, kNoMma = 4, kCurrent = 5, kInt32 = 6
};
constexpr int kVariants = 7;

// d (d - 1) ... (d - k + 1) in int32 with balanced factor pairing, as
// fastsk_tpu/ops/pairs_pallas.py:ffact_pairing_i32: 0 for 0 <= d < k. The
// loop stays rolled: unrolled over a k known only at run time, ptxas made
// each of kernel H's int32 kernels ~25,000 instructions.
__device__ __forceinline__ int ffact_i32(int d, int k) {
  if (k == 1) return d;
  const int t = d * (d - (k - 1));
  int prod = t;
#pragma unroll 1
  for (int i = 1; i < k / 2; ++i) prod *= t + i * (k - 1 - i);
  if (k & 1) prod *= d - (k - 1) / 2;
  return prod;
}

template <int W, int RI>
__global__ void __launch_bounds__(kThreads)
pairs_kernel(const uint32_t* __restrict__ x, int32_t* __restrict__ out,
             int n_pad, int p_pad, int s, int k) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bj < bi) return;  // lower block triangle: written by its mirror block

  extern __shared__ uint32_t smem[];
  const int tile_rows = s * p_pad;
  uint32_t* xj = smem;                                     // [tile_rows, W]
  int32_t* acc = reinterpret_cast<int32_t*>(xj + tile_rows * W);  // [s, s]
  int32_t* tbl = acc + s * s;                              // [32]

  const int tid = threadIdx.x;
  const uint32_t* xj_g = x + static_cast<size_t>(bj) * tile_rows * W;
  for (int t = tid; t < tile_rows * W; t += kThreads) xj[t] = xj_g[t];
  for (int t = tid; t < s * s; t += kThreads) acc[t] = 0;
  if (tid < 32) {
    // C(tid, k) exactly: each step's quotient is the integer C(tid, j + 1)
    int64_t c = 1;
    for (int j = 0; j < k; ++j) c = c * (tid - j) / (j + 1);
    tbl[tid] = static_cast<int32_t>(tid >= k ? c : 0);
  }
  __syncthreads();

  const int groups_per_seq = p_pad / RI;  // p_pad % 8 == 0, RI | 8
  const int n_groups = s * groups_per_seq;
  const int n_items = n_groups * s;
  const uint32_t* xi_g = x + static_cast<size_t>(bi) * tile_rows * W;
  for (int item = tid; item < n_items; item += kThreads) {
    const int grp = item % n_groups;  // RI consecutive i windows
    const int sj = item / n_groups;   // one j sequence of the tile
    const int si = grp / groups_per_seq;
    uint32_t a[RI][W];
    const uint32_t* ap = xi_g + static_cast<size_t>(grp) * RI * W;
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int w = 0; w < W; ++w) a[r][w] = __ldg(ap + r * W + w);

    int32_t sum = 0;
    const uint32_t* bp = xj + sj * p_pad * W;
    for (int q = 0; q < p_pad; ++q, bp += W) {
      unsigned int d[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) d[r] = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const unsigned int b = bp[w];
#pragma unroll
        for (int r = 0; r < RI; ++r) d[r] = __dp4a(a[r][w], b, d[r]);
      }
#pragma unroll
      for (int r = 0; r < RI; ++r) sum += tbl[d[r]];
    }
    atomicAdd(&acc[si * s + sj], sum);
  }
  __syncthreads();

  for (int t = tid; t < s * s; t += kThreads) {
    const int gi = bi * s + t / s;
    const int gj = bj * s + t % s;
    out[static_cast<size_t>(gi) * n_pad + gj] = acc[t];
    out[static_cast<size_t>(gj) * n_pad + gi] = acc[t];
  }
}

template <int W>
cudaError_t launch(const uint32_t* x, int32_t* out, int n_pad, int p_pad,
                   int s, int k, cudaStream_t stream) {
  // RI i-windows per thread: about 64 registers of operands
  constexpr int RI = W <= 8 ? 8 : (W <= 16 ? 4 : (W <= 32 ? 2 : 1));
  const size_t smem =
      (static_cast<size_t>(s) * p_pad * W + s * s + 32) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      pairs_kernel<W, RI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = n_pad / s;
  dim3 grid(tiles, tiles);
  pairs_kernel<W, RI><<<grid, kThreads, smem, stream>>>(x, out, n_pad, p_pad, s, k);
  return cudaGetLastError();
}

// ------------------------------------------------------- A, tensor cores
//
// Kernel A's body: the same count matrix with the match counts as the
// int8 tensor-core product M = X_i X_j^T of the one-hot window rows (the
// wrapper pads their depth g * alpha with zero bytes to a multiple of 64;
// zero bytes add no matches), by wgmma s8 -> s32. It takes every shape
// the engine admits, in one of four layouts that the wrapper picks
// (ops/pairs_cuda.py:mma_plan, which owns the sizing rule; the entry
// point below refuses a plan whose block does not fit):
//   resident  a tile's whole j windows stay in shared memory
//             (pairs_mma_kernel, kRanged false): every shape where one
//             sequence's windows and two streamed i chunks fit;
//   windows   the same kernel (kRanged true), one sequence a tile, with
//             a range of rc 128-row j chunks resident a block: several
//             blocks cover one tile pair (long sequences);
//   depth     pairs_mma_deep_kernel<true>: one j chunk at full depth,
//             the i chunks streamed past it in 64-byte k-slabs through
//             a ring of cp.async stages (one-hot rows deeper than the
//             windows layout can hold at full depth);
//   slabs     pairs_mma_deep_kernel<false>: both operands in k-slabs
//             (rows too deep for one j chunk at full depth).
// In the last three, blocks add their per-sequence partial sums into an
// output the wrapper zeroed, with int32 atomics: the sums are integers
// below 2^31 (the engine's bound), so the result is exact and does not
// depend on the order the blocks run in.
//
// What bounds it, and the design:
//   - the time is shared by the product (64 bytes a row at KAT2B: about
//     59 ms at the card's int8 peak), the epilogue (one C(M, k) and one
//     add a window pair, ~1e12 pairs at KAT2B) and the tile loads; kernel
//     H's variants (experiments/probe_pairs.py) time each part in every
//     layout. C(M, k) is
//     a lookup in a 32-entry shared table (one LDS a pair, conflict-free:
//     a bank per entry);
//   - a block owns a pair of sequence tiles (bi <= bj, a 1-D triangular
//     grid, times the ranges a pair) and writes or adds both K[i, j] and
//     K[j, i] from s x s shared bins (a diagonal tile's block adds K[i, j]
//     only: its bins hold both orders);
//   - A's rows are one-hot already, so tiles arrive by 16-byte cp.async
//     straight into wgmma's K-major core-matrix layout, in core-matrix
//     order (contiguous in shared memory; a warp reads 8 whole rows at a
//     depth of 64): tile bj (or its range) stays resident, tile bi streams
//     in 128-row chunks, double buffered; rows past the tile are
//     zero-filled;
//   - each warpgroup multiplies its 64 rows of the i chunk by every
//     128-row j chunk, as two 64-column halves in a pipeline: one half's
//     wgmma runs while the warp looks up the other's counts. ptxas
//     serializes the wgmmas (C7515, C7518) where a non-wgmma instruction
//     writes an accumulator or a divergent path runs while one is in
//     flight, so the accumulators are never zeroed (each half's first
//     k-step overwrites them) and, for sequences of 64 windows or more
//     (a half then spans at most two sequences), the epilogue has no
//     branch: each lookup goes to one of two sums by a select, flushed
//     once a half (a redux.sync each, a shared atomic by lane 0);
//     shorter sequences take a run per column sequence. p_pad % 8 == 0,
//     so an 8-row group, and an 8-column group of the fragment, lies in
//     one sequence. Rows and columns past the tile are zero-filled, so
//     they weigh C(0, k) = 0 and need no test;
//   - two blocks an SM where the resident tile allows (the plan sizes
//     it), so one block's loads overlap the other's work.
// Both kernels take kernel H's variant (kVariant, kCurrent for A itself):
// every `if constexpr` on it below keeps A's code where the variant is
// kCurrent.

constexpr int kMmaThreads = 256;  // 2 warpgroups: 64 i rows x 128 j rows each
constexpr int kChunk = 128;       // window rows of a chunk
constexpr unsigned kFullMask = 0xffffffffu;

// two blocks an SM must fit the SM's 228 KB of shared memory, 1 KB a
// block reserved; one block alone may take 227 KB
constexpr size_t kMaxSmemBytes = 227 * 1024;

// the depth and slabs layouts: 64-byte k-slabs (two wgmma k-steps) of
// 128 rows (8 KB) in a ring of stages: the depth layout's 4 stages hold an
// i slab each, the slabs layout's 6 an i and a j slab
constexpr int kSlab = 64;
constexpr int kSlabBytes = kChunk * kSlab;
template <bool kResidentJ>
struct Ring {
  static constexpr int kStages = kResidentJ ? 4 : 6;
  static constexpr int kAhead = kStages - 2;  // steps loaded ahead of the one multiplied
  static constexpr int kStageBytes = (kResidentJ ? 1 : 2) * kSlabBytes;
};

size_t bins_bytes(int s) { return (static_cast<size_t>(s) * s + 32) * sizeof(int32_t); }

// Shared memory of a resident or windows-layout block: `chunks` 128-row
// chunks of tile bj, two streamed chunks of tile bi, the s x s bins and
// the C(d, k) table.
size_t mma_smem_bytes(int s, int chunks, int depth) {
  return (static_cast<size_t>(chunks) + 2) * kChunk * depth + bins_bytes(s);
}

// Shared memory of a depth-layout block (the i slab ring, one resident
// j chunk at full depth, bins and table) or a slabs-layout block (the
// slab-pair ring, bins and table).
size_t deep_smem_bytes(int s, int depth, bool resident_j) {
  constexpr size_t kAlign = 1024;  // the swizzled ring's alignment
  return kAlign +
         (resident_j ? static_cast<size_t>(Ring<true>::kStages) * Ring<true>::kStageBytes +
                           static_cast<size_t>(kChunk) * depth + bins_bytes(s)
                     : static_cast<size_t>(Ring<false>::kStages) * Ring<false>::kStageBytes +
                           bins_bytes(s));
}

// The weight of a window pair of d matches: C(d, k) from the shared table
// (kernel A), k! C(d, k) as the falling-factorial chain (int32; unscale
// divides a flush's sum by k!) or d itself (skeleton).
template <int V>
__device__ __forceinline__ int weigh(int d, const int32_t* tbl, int k) {
  if constexpr (V == kSkeleton) {
    return d;
  } else if constexpr (V == kInt32) {
    return ffact_i32(d, k);
  } else {
    return tbl[d];
  }
}

template <int V>
__device__ __forceinline__ int unscale(int sum, int kfact) {
  if constexpr (V == kInt32) {
    return sum / kfact;  // exact: each chain is a multiple of k!
  } else {
    return sum;
  }
}

// Adds the weights (weigh<V>) of one warp's 64-column half of its 16 x 64
// fragment rows (d: the half's 32 accumulators; element v at row wrow +
// gid + 8 * ((v >> 1) & 1), column cbase + 8 * (v >> 2) + 2 * tig + (v &
// 1) of the j tile) into the s x s bins; si0, si1 are the tile sequences
// of the warp's two 8-row groups. A lane's flush sums at most 16 weights.
template <int V>
__device__ __forceinline__ void add_half(const int* d, int cbase, int p_pad, int s,
                                         int si0, int si1, int lane, const int32_t* tbl,
                                         int32_t* bins, int k, int kfact) {
  if (p_pad >= 64) {
    // a half's 64 columns span at most two sequences: sums a (the
    // first) and b, selected without a branch, flushed once each, so
    // no divergent path runs while the other half's wgmma is in
    // flight. Rows and columns past the tile are zero (their counts
    // 0 weigh 0); their bins are clamped into the tile.
    const int sq = cbase / p_pad;
    const int edge = (sq + 1) * p_pad;  // the second sequence's first column
    int a0 = 0, a1 = 0, b0 = 0, b1 = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const bool first = cbase + 8 * c < edge;
      const int w0 = weigh<V>(d[4 * c], tbl, k) + weigh<V>(d[4 * c + 1], tbl, k);
      const int w1 = weigh<V>(d[4 * c + 2], tbl, k) + weigh<V>(d[4 * c + 3], tbl, k);
      a0 += first ? w0 : 0;
      b0 += first ? 0 : w0;
      a1 += first ? w1 : 0;
      b1 += first ? 0 : w1;
    }
    const int sa_ = min(sq, s - 1), sb_ = min(sq + 1, s - 1);
    const int t0 = __reduce_add_sync(kFullMask, unscale<V>(a0, kfact));
    const int t1 = __reduce_add_sync(kFullMask, unscale<V>(a1, kfact));
    const int t2 = __reduce_add_sync(kFullMask, unscale<V>(b0, kfact));
    const int t3 = __reduce_add_sync(kFullMask, unscale<V>(b1, kfact));
    if (lane == 0) {
      atomicAdd(&bins[si0 * s + sa_], t0);
      atomicAdd(&bins[si1 * s + sa_], t1);
      atomicAdd(&bins[si0 * s + sb_], t2);
      atomicAdd(&bins[si1 * s + sb_], t3);
    }
  } else {  // short sequences: a run per column sequence
    int sq = cbase / p_pad;        // the column sequence of the run
    int next = (sq + 1) * p_pad;   // its end
    int run0 = 0, run1 = 0;
    auto flush = [&]() {
      const int t0 = __reduce_add_sync(kFullMask, unscale<V>(run0, kfact));
      const int t1 = __reduce_add_sync(kFullMask, unscale<V>(run1, kfact));
      if (lane == 0) {
        atomicAdd(&bins[si0 * s + min(sq, s - 1)], t0);
        atomicAdd(&bins[si1 * s + min(sq, s - 1)], t1);
      }
    };
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int jc = cbase + 8 * c;
      if (jc >= next) {  // a new column sequence (p_pad >= 8)
        flush();
        ++sq;
        next += p_pad;
        run0 = run1 = 0;
      }
      run0 += weigh<V>(d[4 * c], tbl, k) + weigh<V>(d[4 * c + 1], tbl, k);
      run1 += weigh<V>(d[4 * c + 2], tbl, k) + weigh<V>(d[4 * c + 3], tbl, k);
    }
    flush();
  }
}

// k! (the int32 variant's divisor).
__device__ __forceinline__ int factorial(int k) {
  int f = 1;
  for (int j = 2; j <= k; ++j) f *= j;
  return f;
}

// The matmul variant's per-thread sums of match counts into bins[0] (the
// corner entry), ahead of the writes.
__device__ __forceinline__ void flush_sum(int sum, int lane, int32_t* bins) {
  const int t = __reduce_add_sync(kFullMask, sum);
  if (lane == 0) atomicAdd(&bins[0], t);
  __syncthreads();
}

// C(tid, k) exactly into tbl[tid] for the first 32 threads.
__device__ __forceinline__ void fill_binom(int32_t* tbl, int tid, int k) {
  if (tid < 32) {
    int64_t c = tid >= k ? 1 : 0;
    for (int j = 0; j < k && c; ++j) c = c * (tid - j) / (j + 1);
    tbl[tid] = static_cast<int32_t>(c);
  }
}

// A range block's bins into the zeroed output: K[i, j] and, off the
// diagonal tile, its mirror K[j, i].
__device__ __forceinline__ void add_bins(int32_t* out, const int32_t* bins, int64_t bi,
                                         int64_t bj, int s, int n_pad, int tid) {
  for (int t = tid; t < s * s; t += kMmaThreads) {
    const int v = bins[t];
    if (v == 0) continue;
    const int64_t gi = bi * s + t / s;
    const int64_t gj = bj * s + t % s;
    atomicAdd(&out[gi * n_pad + gj], v);
    if (bi != bj) atomicAdd(&out[gj * n_pad + gi], v);
  }
}

// The resident layout (kRanged false: rc is the tile's chunk count, one
// block a tile pair) and the windows layout (kRanged true: ceil(nc / rc)
// blocks a tile pair, block r holding j chunks [r rc, r rc + rc)).
template <int kVariant, bool kRanged>
__global__ void __launch_bounds__(kMmaThreads, 2)
pairs_mma_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out,
                 int n_pad, int p_pad, int s, int k, int depth, int rc) {
  extern __shared__ __align__(128) uint4 smem_raw[];
  const int64_t nt = n_pad / s;
  const int T = s * p_pad;  // window rows of a tile
  const int nc = (T + kChunk - 1) / kChunk;
  const int nr = kRanged ? (nc + rc - 1) / rc : 1;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) / nr;
  const int c0 = kRanged ? static_cast<int>(blockIdx.x % nr) * rc : 0;
  const int c1 = kRanged ? min(c0 + rc, nc) : nc;  // j chunks [c0, c1)
  const int64_t bi = row_tile_of(pair, nt);
  const int64_t bj = bi + (pair - pairs_before(bi, nt));
  const int chunk_bytes = kChunk * depth;
  uint8_t* sj = reinterpret_cast<uint8_t*>(smem_raw);  // tile bj: chunks c0..c1-1
  uint8_t* sa = sj + (kRanged ? rc : nc) * chunk_bytes;  // tile bi: [2] chunks
  int32_t* bins = reinterpret_cast<int32_t*>(sa + 2 * chunk_bytes);  // [s, s]
  int32_t* tbl = bins + s * s;                                       // [32]
  const int tid = threadIdx.x;

  // chunk c of a tile into dst in core-matrix order (dst + 16 q is
  // onehot_at(r, 16 pc)); rows past the tile are zero
  const int pieces = depth >> 4;
  auto load_chunk = [&](uint8_t* dst, int64_t tile, int c) {
    for (int q = tid; q < kChunk * pieces; q += kMmaThreads) {
      const int grp = q / (8 * pieces), rem = q - grp * 8 * pieces;
      const int r = grp * 8 + (rem & 7);
      const int tr = c * kChunk + r;
      const bool ok = tr < T;
      const uint8_t* src =
          x + (tile * T + (ok ? tr : 0)) * static_cast<int64_t>(depth) + (rem >> 3) * 16;
      cp_async16_zfill(dst + q * 16, src, ok ? 16 : 0);
    }
  };
  if constexpr (kVariant != kNoop) {
    for (int c = c0; c < c1; ++c) load_chunk(sj + (c - c0) * chunk_bytes, bj, c);
    load_chunk(sa, bi, 0);
    cp_async_commit();
  }
  fill_binom(tbl, tid, k);
  for (int q = tid; q < s * s; q += kMmaThreads) bins[q] = 0;

  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  // this warp's fragment rows: lane's gid in the 8-row groups at
  // wrow and wrow + 8 of the warpgroup's 64 rows of the chunk
  const int wrow = 64 * wg + 16 * (warp & 3);
  const int kfact = kVariant == kInt32 ? factorial(k) : 1;
  int sum = 0;  // matmul: this thread's sum of match counts
  if constexpr (kVariant == kNoop) __syncthreads();  // the zeroed bins
  for (int ci = 0; ci < (kVariant == kNoop ? 0 : nc); ++ci) {
    if (ci + 1 < nc) {
      load_chunk(sa + ((ci + 1) & 1) * chunk_bytes, bi, ci + 1);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // the warp's two 8-row groups (each in one sequence: p_pad % 8 == 0);
    // rows past the tile are zero, their bins clamped into the tile
    const int ir = ci * kChunk + wrow;
    const int si0 = min(ir / p_pad, s - 1), si1 = min((ir + 8) / p_pad, s - 1);
    const uint8_t* a_rows = sa + (ci & 1) * chunk_bytes + wg * 64 * depth;
    // a warpgroup whose 64 rows all lie past the tile has nothing to add
    const bool live = ci * kChunk + 64 * wg < T;
    // each j chunk's 128 columns as two 64-column halves h, in a
    // pipeline: half h + 1's wgmma is in flight while half h's epilogue
    // runs, so every warp overlaps its products with its lookups
    int acc[2][32];
    auto start_half = [&](int* d, int cj, int h) {
      if constexpr (kVariant == kNoMma) {  // opaque zero counts
#pragma unroll
        for (int v = 0; v < 32; ++v) asm volatile("mov.b32 %0, 0;" : "=r"(d[v]));
      } else {
        const uint8_t* b_rows = sj + (cj - c0) * chunk_bytes + h * 64 * depth;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        for (int kk = 0; kk < depth; kk += 32) {  // two core matrices along K
          wgmma_s8_n64(d, smem_desc(a_rows + kk * 8, 128, depth * 8),
                       smem_desc(b_rows + kk * 8, 128, depth * 8), kk > 0);
        }
        wgmma_commit();
      }
    };
    auto epilogue = [&](const int* d, int cbase) {
      if constexpr (kVariant == kMatmul) {  // keep the products live
#pragma unroll
        for (int v = 0; v < 32; ++v) sum += d[v];
      } else {
        add_half<kVariant>(d, cbase, p_pad, s, si0, si1, lane, tbl, bins, k, kfact);
      }
    };
    if (kVariant != kLoads && live) {
      // a range holds a chunk at least; unless ptxas knows the loop below
      // runs, it serializes the wgmmas (as the resident layout's loop
      // runs inside ci < nc)
      if constexpr (kRanged) __builtin_assume(c1 > c0);
      start_half(acc[0], c0, 0);
      for (int cj = c0; cj < c1; ++cj) {
        start_half(acc[1], cj, 1);
        wgmma_wait<1>();  // half 0 of chunk cj landed
        epilogue(acc[0], cj * kChunk);
        // the next chunk's half 0; at the last chunk the last chunk's
        // again, discarded: 1 / (2 nc) more products, but peeling the last
        // chunk off instead measured slower (PERF.md section 5)
        start_half(acc[0], min(cj + 1, c1 - 1), 0);
        wgmma_wait<1>();  // half 1 of chunk cj landed
        epilogue(acc[1], cj * kChunk + 64);
      }
      wgmma_wait<0>();
    }
    __syncthreads();  // the chunk's buffer is refilled two chunks on
  }
  if constexpr (kVariant == kMatmul) flush_sum(sum, lane, bins);

  if constexpr (kRanged) {
    add_bins(out, bins, bi, bj, s, n_pad, tid);
  } else {
    for (int t = tid; t < s * s; t += kMmaThreads) {
      const int64_t gi = bi * s + t / s;
      const int64_t gj = bj * s + t % s;
      out[gi * n_pad + gj] = bins[t];
      out[gj * n_pad + gi] = bins[t];
    }
  }
}

// The depth layout (kResidentJ) and the slabs layout: ceil(nc / rc)
// blocks a tile pair (block r: j chunks [r rc, r rc + rc)). A block walks
// steps of one 64 x 128 x 64 product a warpgroup (m64n128k32 twice),
// accumulated over the depth's k-slabs, then the lookups of the 128 x 128
// tile once, after its last slab. The depth layout holds one j chunk at
// full depth (loaded once a chunk, so it is read once a block) and
// streams tile bi's i chunks in k-slabs past it, steps in (j chunk, i
// chunk, slab) order; the slabs layout, for rows too deep for that,
// streams both operands in k-slabs, steps in (i chunk, j chunk, slab)
// order. The loads run kAhead steps ahead through the ring (a step's slot
// is refilled once every warp has waited its wgmma: two steps on), and
// nothing but wgmma touches the accumulators while one is in flight.
template <int kVariant, bool kResidentJ>
__global__ void __launch_bounds__(kMmaThreads, 2)
pairs_mma_deep_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out,
                      int n_pad, int p_pad, int s, int k, int depth, int rc) {
  using R = Ring<kResidentJ>;
  extern __shared__ __align__(128) uint4 smem_raw[];
  const int64_t nt = n_pad / s;
  const int T = s * p_pad;
  const int nc = (T + kChunk - 1) / kChunk;
  const int nr = (nc + rc - 1) / rc;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) / nr;
  const int c0 = static_cast<int>(blockIdx.x % nr) * rc;
  const int ncj = min(c0 + rc, nc) - c0;
  const int64_t bi = row_tile_of(pair, nt);
  const int64_t bj = bi + (pair - pairs_before(bi, nt));
  // the ring 1 KB aligned, as the swizzle needs (the wrapper adds 1 KB)
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_raw) +
                  ((1024 - (__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);
  uint8_t* sb = ring + R::kStages * R::kStageBytes;      // the j chunk (depth layout)
  int32_t* bins = reinterpret_cast<int32_t*>(sb + (kResidentJ ? kChunk * depth : 0));
  int32_t* tbl = bins + s * s;
  const int tid = threadIdx.x;
  const int nks = depth / kSlab;
  const int steps = nc * ncj * nks;
  constexpr int kPieces = kSlabBytes / 16;  // 16-byte pieces of a slab

  // step t's slabs into its slot, 64-byte rows in the 64-byte swizzle
  // (four threads a row, so a warp reads 8 rows' 64 contiguous bytes);
  // rows past the tile, and steps past the last, load zeros
  auto load_step = [&](int t) {
    const int ks = t % nks, tile = t / nks;
    const int ci = kResidentJ ? tile % nc : tile / ncj;
    const int cj = c0 + (kResidentJ ? 0 : tile % ncj);
    uint8_t* dst = ring + (t % R::kStages) * R::kStageBytes;
#pragma unroll
    for (int u = 0; u < R::kStageBytes / 16 / kMmaThreads; ++u) {
      const int q = tid + u * kMmaThreads;
      const int op = q / kPieces;  // 0: tile bi's slab, 1: tile bj's
      const int r = (q % kPieces) >> 2, c = q & 3;
      const int tr = (op ? cj : ci) * kChunk + r;
      const bool ok = t < steps && tr < T;
      const uint8_t* src = x + ((op ? bj : bi) * T + (ok ? tr : 0)) * static_cast<int64_t>(depth) +
                           ks * kSlab + c * 16;
      cp_async16_zfill(dst + op * kSlabBytes + sw64_at(r, c), src, ok ? 16 : 0);
    }
  };
  // j chunk cj at full depth into sb (the depth layout): its k-slabs one
  // after another, each as a ring slab
  auto load_j = [&](int cj) {
    const int pieces = depth >> 4;
    for (int q = tid; q < kChunk * pieces; q += kMmaThreads) {
      const int r = q / pieces, rem = q - r * pieces;
      const int tr = cj * kChunk + r;
      const bool ok = tr < T;
      const uint8_t* src = x + (bj * T + (ok ? tr : 0)) * static_cast<int64_t>(depth) + rem * 16;
      cp_async16_zfill(sb + (rem >> 2) * kSlabBytes + sw64_at(r, rem & 3), src, ok ? 16 : 0);
    }
  };
  if constexpr (kVariant != kNoop) {
    for (int t = 0; t < R::kAhead; ++t) {
      load_step(t);
      cp_async_commit();
    }
  }
  fill_binom(tbl, tid, k);
  for (int q = tid; q < s * s; q += kMmaThreads) bins[q] = 0;

  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int wrow = 64 * wg + 16 * (warp & 3);
  const int kfact = kVariant == kInt32 ? factorial(k) : 1;
  int sum = 0;  // matmul: this thread's sum of match counts
  int acc[64];  // 64 x 128 a warpgroup: columns 0-63, then 64-127
  int t = 0;
  // one 128 x 128 tile: i chunk ci against j chunk cj, all its slabs
  auto tile = [&](int ci, int cj) {
    for (int ks = 0; ks < nks; ++ks, ++t) {
      cp_async_wait<R::kAhead - 1>();  // step t's slabs (this thread's part)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // every thread's part landed; every warp has waited step t - 1's
      // wgmma down to one in flight, so step t - 2's slot is free
      __syncthreads();
      load_step(t + R::kAhead);  // into step t - 2's slot
      cp_async_commit();
      if constexpr (kVariant != kLoads && kVariant != kNoMma) {
        const uint8_t* slot = ring + (t % R::kStages) * R::kStageBytes;
        const uint8_t* a_rows = slot + wg * 64 * kSlab;
        // the j slab: the ring's, or slab ks of the resident chunk
        const uint8_t* b_rows = kResidentJ ? sb + ks * kSlabBytes : slot + kSlabBytes;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        // the two k-steps: bytes 0-31 and 32-63 of the swizzled rows
        wgmma_s8(acc, smem_desc_sw64(a_rows, 8 * kSlab), smem_desc_sw64(b_rows, 8 * kSlab),
                 ks > 0);
        wgmma_s8(acc, smem_desc_sw64(a_rows + 32, 8 * kSlab),
                 smem_desc_sw64(b_rows + 32, 8 * kSlab), 1);
        wgmma_commit();
        wgmma_wait<1>();
      }
    }
    if constexpr (kVariant == kNoMma) {  // opaque zero counts
#pragma unroll
      for (int v = 0; v < 64; ++v) asm volatile("mov.b32 %0, 0;" : "=r"(acc[v]));
    } else if constexpr (kVariant != kLoads) {
      wgmma_wait<0>();
    }
    if constexpr (kVariant == kMatmul) {  // keep the products live
#pragma unroll
      for (int v = 0; v < 64; ++v) sum += acc[v];
    } else if constexpr (kVariant != kLoads) {
      const int ir = ci * kChunk + wrow;
      const int si0 = min(ir / p_pad, s - 1), si1 = min((ir + 8) / p_pad, s - 1);
      add_half<kVariant>(acc, cj * kChunk, p_pad, s, si0, si1, lane, tbl, bins, k, kfact);
      add_half<kVariant>(acc + 32, cj * kChunk + 64, p_pad, s, si0, si1, lane, tbl, bins, k,
                         kfact);
    }
  };
  if constexpr (kVariant == kNoop) {
    __syncthreads();  // the zeroed bins
  } else if constexpr (kResidentJ) {
    for (int cj = c0; cj < c0 + ncj; ++cj) {
      __syncthreads();  // every warp's products on the last chunk are done
      load_j(cj);
      cp_async_commit();
      cp_async_wait_all();  // (the ring's loads ahead too)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      for (int ci = 0; ci < nc; ++ci) tile(ci, cj);
    }
  } else {
    for (int ci = 0; ci < nc; ++ci)
      for (int cj = c0; cj < c0 + ncj; ++cj) tile(ci, cj);
  }
  if constexpr (kVariant != kNoop) {
    cp_async_wait_all();  // the zero loads past the last step
    __syncthreads();
  }
  if constexpr (kVariant == kMatmul) flush_sum(sum, lane, bins);
  add_bins(out, bins, bi, bj, s, n_pad, tid);
}

using MmaKernel = void (*)(const uint8_t*, int32_t*, int, int, int, int, int, int);
// [variant][layout]: resident, windows, depth, slabs
#define FASTSK_LAYOUTS(V)                                             \
  {pairs_mma_kernel<V, false>, pairs_mma_kernel<V, true>,             \
   pairs_mma_deep_kernel<V, true>, pairs_mma_deep_kernel<V, false>}
const MmaKernel kMmaKernels[kVariants][4] = {
    FASTSK_LAYOUTS(kNoop),   FASTSK_LAYOUTS(kLoads),   FASTSK_LAYOUTS(kMatmul),
    FASTSK_LAYOUTS(kSkeleton), FASTSK_LAYOUTS(kNoMma), FASTSK_LAYOUTS(kCurrent),
    FASTSK_LAYOUTS(kInt32)};
#undef FASTSK_LAYOUTS

}  // namespace

// x: [n_pad * p_pad, 4 * w] int8 one-hot windows; out: [n_pad, n_pad] int32.
// s (tile sequences) divides n_pad; p_pad % 8 == 0; w is one of the widths
// below (the wrapper pads the one-hot width with zero bytes to reach one).
extern "C" int pairs_counts_launch(const void* x, void* out, int n_pad,
                                   int p_pad, int w, int k, int s,
                                   void* stream) {
  const uint32_t* xw = static_cast<const uint32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w) {
#define FASTSK_W(N) \
  case N:           \
    return launch<N>(xw, o, n_pad, p_pad, s, k, st);
    FASTSK_W(1) FASTSK_W(2) FASTSK_W(3) FASTSK_W(4) FASTSK_W(5) FASTSK_W(6)
    FASTSK_W(7) FASTSK_W(8) FASTSK_W(9) FASTSK_W(10) FASTSK_W(11)
    FASTSK_W(12) FASTSK_W(13) FASTSK_W(14) FASTSK_W(15) FASTSK_W(16)
    FASTSK_W(20) FASTSK_W(24) FASTSK_W(32) FASTSK_W(48) FASTSK_W(64)
    FASTSK_W(96) FASTSK_W(128)
#undef FASTSK_W
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel A's tensor-core body. x: [n_pad * p_pad, depth] int8 one-hot
// windows, depth a multiple of 64; layout 0 (resident: rc the tile's chunk
// count), 1 (windows: s = 1, rc j chunks a block), 2 (depth) or 3 (slabs:
// rc j chunks a block) with tile side s and rc from the wrapper's plan;
// out must be zeroed for layouts 1 to 3. Variant 5 (current) computes the
// counts; the others are kernel H's (kNoop to kInt32), in every layout.
// Refuses a plan whose block does not fit shared memory or whose grid is
// too large.
extern "C" int pairs_mma_launch(const void* x, void* out, int n_pad, int p_pad,
                                int depth, int k, int s, int rc, int layout,
                                int variant, void* stream) {
  if (depth < 64 || depth % 64 || p_pad < 8 || p_pad % 8 || n_pad < 1 || k < 1 ||
      s < 1 || s > 8 || n_pad % s || rc < 1 || layout < 0 || layout > 3 ||
      variant < 0 || variant >= kVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = (s * p_pad + kChunk - 1) / kChunk;
  if (rc > nc || (layout == 0 && rc != nc) || (layout == 1 && s != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nt = n_pad / s;
  const int64_t blocks = nt * (nt + 1) / 2 * ((nc + rc - 1) / rc);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem =
      layout >= 2 ? deep_smem_bytes(s, depth, layout == 2) : mma_smem_bytes(s, rc, depth);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidConfiguration);
  const MmaKernel kernel = kMmaKernels[variant][layout];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kMmaThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<int32_t*>(out), n_pad, p_pad,
      s, k, depth, rc);
  return static_cast<int>(cudaGetLastError());
}
