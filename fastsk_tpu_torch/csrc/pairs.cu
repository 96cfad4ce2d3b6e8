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
// pairs_ws_kernel and pairs_mma_deep_kernel below, counts the matches on
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
//             counts (mod 2^32) at its corner entry (of the pair indices
//             (g + 1) d0 + d1 in the resident and windows layouts);
//   skeleton  the products and A's bin sums with weight w = d: K = S S^T,
//             S_i = sum_p x_ip;
//   no_mma    A's epilogue on opaque zero counts, every lookup run (zeros);
//   current   kernel A itself (the C(d, k) table);
//   int32     C(d, k) as the falling-factorial chain in registers, divided
//             exactly by k! (per flush, or per entry in pairs_ws_kernel),
//             in place of the table (A's counts).
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
// wrapper pads their depth g * alpha with zero bytes; zero bytes add no
// matches), by wgmma s8 -> s32. It takes every shape the engine admits,
// in one of four layouts that the wrapper picks (ops/pairs_cuda.py:
// mma_plan, which owns the sizing rule; the entry point below refuses a
// plan whose block does not fit):
//   resident  pairs_ws_kernel: a tile's whole j windows (paired, two a
//             row) stay in shared memory while every i tile of its row of
//             the tile triangle streams past them (rows padded to 32
//             bytes, one k-step);
//   windows   the same kernel, one sequence a tile, a range of rc 128-row
//             j chunks held at a time (long sequences; blocks add);
//   depth     pairs_mma_deep_kernel<true>: one j chunk at full depth,
//             the i chunks streamed past it in 64-byte k-slabs through
//             a ring of cp.async stages (rows deeper than the windows
//             layout can hold at full depth);
//   slabs     pairs_mma_deep_kernel<false>: both operands in k-slabs
//             (rows too deep for one j chunk at full depth).
// In the windows layout (more than one range a tile) and the last two,
// blocks add their per-sequence partial sums into an output the wrapper
// zeroed, with int32 atomics: the sums are integers below 2^31 (the
// engine's bound), so the result is exact and does not depend on the
// order the blocks run in.
//
// What bounds it, and the design (pairs_ws_kernel; the deep kernel's
// notes are above it):
//   - the time is shared by the product, the epilogue (one C(M, k) and
//     one add a window pair, ~1e12 pairs at KAT2B) and the tile loads,
//     and the product's operands and the epilogue's lookups share the
//     SM's shared-memory bandwidth; kernel H's variants
//     (experiments/probe_pairs.py) time each part in every layout;
//   - the j operand holds two windows a row: row q of a tile is
//     (g + 1) x_2q + x_2q+1 (entries <= g + 2 < 128), so a product entry
//     is e = (g + 1) d0 + d1, the match counts of two window pairs of one
//     sequence (each sequence re-padded to a multiple of 16 windows), and
//     a shared table of C(d0, k) + C(d1, k) weighs both at once: half the
//     products, operand reads and epilogue instructions of a window pair
//     (KAT2B's 65-byte rows padded to 96: about 44 ms at the card's int8
//     peak). The table has one copy for each lane (entry e of lane l at
//     word 32 e + l), so a warp's 32 lookups fall in 32 banks whatever
//     the counts: one LDS an entry;
//   - persistent blocks, one an SM, each a contiguous range of the units
//     (resident tile ti, j range r, streamed tile tj >= ti) in that
//     order, so the resident tile (or range) is loaded once for every
//     streamed tile of its row; a block writes or adds both K[i, j] and
//     K[j, i] from s x s shared bins (a diagonal unit only K[i, j]: its
//     bins hold both orders), double buffered so that the next unit adds
//     while one is written;
//   - warp specialised: a producer warpgroup (registers moved to the
//     consumers by setmaxnreg) has one thread copy the resident chunks
//     and the streamed tile's 128-row i chunks by cp.async.bulk into
//     shared memory (the wrapper lays each tile out in wgmma's K-major
//     core-matrix order, 128-row chunks contiguous, rows past the tile
//     zero), the i chunks through a ring of stages, each completed on an
//     mbarrier and released by the consumers on another; two consumer
//     warpgroups multiply their 64 rows of each i chunk by every 128-row
//     j chunk (m64n128k32) into one of two accumulator sets, and weigh the
//     previous product while the next one is in flight: no block barrier
//     and no wgmma drain between i chunks or units, only where the
//     resident strip changes;
//   - the epilogue is chosen from the shape (kEpi): where each 32 paired
//     columns of a product lie in one sequence (p_pad % 64 == 0, or one
//     sequence a tile) one sum a quarter (kOneSeq); for 128 windows or
//     more two sums a 64-column half by a select (a half spans at most two
//     sequences, kTwoSeq); shorter sequences a run per column sequence
//     (kRuns). A warp's 16 rows and an 8-column group of the fragment
//     always lie in one sequence (p_pad % 16 == 0); rows and columns past
//     the tile are zero, weigh C(0, k) = 0 and have their bins clamped
//     into the tile;
//   - ptxas serializes the wgmmas (C7514, C7515) where a non-wgmma
//     instruction reads or writes an accumulator while one is in flight,
//     so the accumulators are never zeroed (each product's first k-step
//     overwrites them).
// Both kernels take kernel H's variant (kVariant, kCurrent for A itself):
// every `if constexpr` on it below keeps A's code where the variant is
// kCurrent.

constexpr int kMmaThreads = 256;  // 2 warpgroups: 64 i rows x 128 j rows each
constexpr int kChunk = 128;       // window rows of a chunk
constexpr unsigned kFullMask = 0xffffffffu;
// pairs_ws_kernel: two consumer warpgroups and a producer warpgroup (one
// thread of which issues the copies), registers moved from the producer
// to the consumers (40 and 232 a thread of the SM's 65,536)
constexpr int kWsConsumers = kMmaThreads;
constexpr int kWsThreads = kWsConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// two blocks an SM must fit the SM's 228 KB of shared memory, 1 KB a
// block reserved; one block alone may take 227 KB
constexpr size_t kMaxSmemBytes = 227 * 1024;

// pairs_ws_kernel's epilogues, in the order of the C entry point
enum Epilogue : int { kOneSeq = 0, kTwoSeq = 1, kRuns = 2 };
constexpr int kEpilogues = 3;

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

// Shared memory of a pairs_ws_kernel block (ops/pairs_cuda.py:_ws_smem):
// `chunks` resident 128-row j chunks, `stages` i chunks in the ring, the
// per-lane pair table, two sets of s x s bins and the ring's, and the
// strip's, full and empty mbarriers.
size_t ws_smem_bytes(int s, int chunks, int stages, int depth, int g) {
  return (static_cast<size_t>(chunks) + stages) * kChunk * depth +
         static_cast<size_t>(g + 1) * (g + 1) * 32 * sizeof(int32_t) +
         2 * static_cast<size_t>(s) * s * sizeof(int32_t) + (2 * stages + 2) * sizeof(uint64_t);
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

// C(d, k) exactly, 0 for d < k.
__device__ __forceinline__ int binom_i32(int d, int k) {
  int64_t c = d >= k ? 1 : 0;
  for (int j = 0; j < k && c; ++j) c = c * (d - j) / (j + 1);
  return static_cast<int>(c);
}

// A unit of pairs_ws_kernel's walk: the resident tile ti (its j range r)
// against the streamed tile tj >= ti. Units run in (ti, r, tj) order, so
// a run of units shares its resident strip (ti, r); ws_unit decodes unit
// L, ws_next steps to the next.
struct WsUnit {
  int64_t ti, tj;
  int r;
};

__device__ __forceinline__ WsUnit ws_unit(int64_t L, int64_t nt, int nr) {
  const int64_t ti = row_tile_of(L / nr, nt);
  const int64_t rem = L - pairs_before(ti, nt) * nr, w = nt - ti;
  return {ti, ti + rem % w, static_cast<int>(rem / w)};
}

__device__ __forceinline__ void ws_next(WsUnit& u, int64_t nt, int nr) {
  if (++u.tj < nt) return;
  if (++u.r == nr) {
    u.r = 0;
    ++u.ti;
  }
  u.tj = u.ti;
}

// One product of pairs_ws_kernel's consumers: i chunk ci (ring stage st,
// of ring round parity ph) of the unit's streamed tile against the
// strip's paired chunk cj (paired column col of the tile), and what
// follows it.
struct WsJob {
  WsUnit u;
  int ci, cj, col, st, ph, buf;  // buf: the unit's set of bins
  bool chunk_end, unit_end;       // the last product of its i chunk, of its unit
};

// The resident and windows layouts. Rows are the wrapper's (ops/
// pairs_cuda.py:ws_operands): every sequence re-padded with zero rows to
// p_pad windows (a multiple of 16), a tile of s sequences in 128-row
// chunks in core-matrix order, chunk c of tile t at (t nc + c) 128 depth
// bytes of x: the i operand, one-hot rows. The j operand follows it:
// tile t's rows paired, row q = (g + 1) x_2q + x_2q+1 (integers <= g + 2),
// in ncy chunks of its own, so a product's entry is the pair index
// e = (g + 1) d0 + d1 of the match counts of two window pairs (columns
// 2q, 2q + 1: one sequence, as p_pad is even), which the table weighs at
// once. rc paired chunks a range (ncy in the resident layout), `stages`
// ring stages; one block an SM, each over a contiguous range of the
// nr nt (nt + 1) / 2 units.
template <int kVariant, int kEpi>
__global__ void __launch_bounds__(kWsThreads, 1)
pairs_ws_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out, int n_pad, int p_pad,
                int s, int k, int g, int depth, int rc, int stages) {
  extern __shared__ __align__(128) uint4 smem_raw[];
  __builtin_assume(depth >= 32);
  const int64_t nt = n_pad / s;
  const int T = s * p_pad;  // window rows of a tile
  const int nc = (T + kChunk - 1) / kChunk;
  const int ncy = (T / 2 + kChunk - 1) / kChunk;  // its paired chunks
  const int nr = (ncy + rc - 1) / rc;
  const int64_t units = nr * (nt * (nt + 1) / 2);
  const int64_t u0 = units * blockIdx.x / gridDim.x;
  const int64_t u1 = units * (blockIdx.x + 1) / gridDim.x;
  const int cb = kChunk * depth;  // bytes of a chunk
  const uint8_t* y = x + nt * nc * static_cast<int64_t>(cb);  // the paired rows
  const int g1 = g + 1, ss = s * s;
  uint8_t* strip = reinterpret_cast<uint8_t*>(smem_raw);  // the resident paired chunks
  uint8_t* ring = strip + rc * cb;                         // [stages] i chunks
  int32_t* tbl = reinterpret_cast<int32_t*>(ring + stages * cb);  // [g1 g1][32 lanes]
  int32_t* bins = tbl + g1 * g1 * 32;                             // [2][s, s]
  uint64_t* full = reinterpret_cast<uint64_t*>(bins + 2 * ss);    // [stages]
  uint64_t* empty = full + stages;                                // [stages]
  uint64_t* strip_full = empty + stages;
  uint64_t* strip_empty = strip_full + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if constexpr (kVariant == kCurrent || kVariant == kNoMma || kVariant == kSkeleton) {
    // entry e of each lane: the weights of the match counts d0, d1 of
    // pair index e (C(d, k), or d for the skeleton)
    for (int q = tid; q < g1 * g1 * 32; q += kWsThreads) {
      const int e = q >> 5, d0 = e / g1, d1 = e - d0 * g1;
      tbl[q] = kVariant == kSkeleton ? d0 + d1 : binom_i32(d0, k) + binom_i32(d1, k);
    }
  }
  for (int q = tid; q < 2 * ss; q += kWsThreads) bins[q] = 0;
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kWsConsumers / 32);  // lane 0 of each consumer warp
    }
    mbar_init(strip_full, 1);
    mbar_init(strip_empty, kWsConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kWsConsumers / 32) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if constexpr (kVariant != kNoop) {
      if (warp == kWsConsumers / 32 && lane == 0) {
        WsUnit u = ws_unit(u0, nt, nr);
        int st = 0, ph = 0, strips = 0;
        for (int64_t L = u0; L < u1; ++L, ws_next(u, nt, nr)) {
          if (L == u0 || u.tj == u.ti) {  // a new resident strip, once the last is done
            const int c0 = u.r * rc, ncj = min(rc, ncy - c0);
            mbar_wait(strip_empty, (strips++ & 1) ^ 1);
            mbar_arrive_tx(strip_full, ncj * cb);
            for (int c = 0; c < ncj; ++c)
              bulk_g2s(strip + c * cb, y + (u.ti * ncy + c0 + c) * static_cast<int64_t>(cb), cb,
                       strip_full);
          }
          for (int ci = 0; ci < nc; ++ci) {
            mbar_wait(empty + st, ph ^ 1);
            mbar_arrive_tx(full + st, cb);
            bulk_g2s(ring + st * cb, x + (u.tj * nc + ci) * static_cast<int64_t>(cb), cb,
                     full + st);
            if (++st == stages) {
              st = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg's 64 rows of each i chunk; this warp's
  // fragment rows are lane's gid in the 8-row groups at wrow and wrow + 8,
  // its 16 rows in one sequence (p_pad % 16 == 0)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wrow = 64 * wg + 16 * (warp & 3);
  const int kfact = kVariant == kInt32 ? factorial(k) : 1;
  const int32_t* ptbl = tbl + lane;
  int sum = 0;  // matmul: this thread's sum of pair indices in the unit
  // the tile sequence of row t, or of paired column t (p_pad / 2 a
  // sequence), clamped into the tile: t < 8 p_pad + 128 is exact by a
  // multiply-high where p_pad < 2^14, and one sequence a tile has s = 1
  const uint32_t magic_r = 0xffffffffu / static_cast<uint32_t>(p_pad) + 1;
  const uint32_t magic_c = 0xffffffffu / static_cast<uint32_t>(p_pad / 2) + 1;
  auto seq_r = [&](int t) { return min(static_cast<int>(__umulhi(t, magic_r)), s - 1); };
  auto seq_c = [&](int t) { return min(static_cast<int>(__umulhi(t, magic_c)), s - 1); };
  const uint32_t magic_g = 0xffffffffu / static_cast<uint32_t>(g1) + 1;  // e < g1^2: exact
  const int pj = p_pad / 2;
  // descriptors of the ring's and the strip's first rows (a descriptor's
  // address field is the byte address / 16)
  const uint64_t ring_desc = smem_desc(ring + wg * 64 * depth, 128, depth * 8);
  const uint64_t strip_desc = smem_desc(strip, 128, depth * 8);
  const int nks = depth >> 5;  // k-steps
  __builtin_assume(nks >= 1);

  // a unit's bins into the output, zeroed for its set's next unit, once
  // every consumer warp has added its part
  auto flush = [&](const WsUnit& fu, int buf) {
    if constexpr (kVariant == kMatmul) {
      const int t = __reduce_add_sync(kFullMask, sum);
      if (lane == 0) atomicAdd(&bins[buf * ss], t);
      sum = 0;
    }
    named_bar_sync(1, kWsConsumers);
    if (tid < ss) {
      int32_t* b = bins + buf * ss + tid;
      const int v = *b;
      *b = 0;
      const int64_t gi = fu.tj * s + tid / s, gj = fu.ti * s + tid % s;
      if (nr == 1) {  // the unit's entries are its alone
        out[gi * n_pad + gj] = v;
        if (fu.tj != fu.ti) out[gj * n_pad + gi] = v;
      } else if (v != 0) {
        atomicAdd(&out[gi * n_pad + gj], v);
        if (fu.tj != fu.ti) atomicAdd(&out[gj * n_pad + gi], v);
      }
    }
  };

  if constexpr (kVariant == kNoop) {
    WsUnit fu = ws_unit(u0, nt, nr);
    for (int64_t L = u0; L < u1; ++L, ws_next(fu, nt, nr)) flush(fu, static_cast<int>(L & 1));
    return;
  }

  // the weights of the two window pairs of pair index e
  auto wt = [&](int e) -> int {
    if constexpr (kVariant == kInt32) {  // each chain a multiple of k!
      const int d0 = __umulhi(e, magic_g), d1 = e - d0 * g1;
      return (ffact_i32(d0, k) + ffact_i32(d1, k)) / kfact;
    } else {
      return ptbl[e << 5];
    }
  };
  // the weights of the lane's 8-column group c of a product (its two rows)
  auto group = [&](const int* d, int c) {
    return wt(d[4 * c]) + wt(d[4 * c + 1]) + wt(d[4 * c + 2]) + wt(d[4 * c + 3]);
  };
  // job j's product into d (m64n128k32 over the depth's k-steps)
  auto issue = [&](int* d, const WsJob& j) {
    if constexpr (kVariant == kNoMma) {  // opaque zero counts
#pragma unroll
      for (int v = 0; v < 64; ++v) asm volatile("mov.b32 %0, 0;" : "=r"(d[v]));
    } else if constexpr (kVariant != kLoads) {
      const uint64_t da = ring_desc + ((j.st * cb) >> 4);
      const uint64_t db = strip_desc + ((j.cj * cb) >> 4);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int ks = 0; ks < nks; ++ks) {  // two core matrices (256 bytes) along K a step
        wgmma_s8(d, da + 16 * ks, db + 16 * ks, ks > 0);
      }
      wgmma_commit();
    }
  };
  // job j's weights (d: its 64 x 128 product, this warp's 16 rows, element
  // v at paired column j.col + 8 (v >> 2) + 2 tig + (v & 1)) into its
  // unit's bins
  auto epilogue = [&](const int* d, const WsJob& j) {
    if constexpr (kVariant == kMatmul) {  // keep the products live
#pragma unroll
      for (int v = 0; v < 64; ++v) sum += d[v];
    } else if constexpr (kVariant != kLoads) {
      int32_t* b = bins + j.buf * ss + seq_r(j.ci * kChunk + wrow) * s;  // the row's bins
      if constexpr (kEpi == kOneSeq) {
        // each 32-column quarter in one sequence: a sum each
        int q[4] = {0, 0, 0, 0};
#pragma unroll
        for (int c = 0; c < 16; ++c) q[c >> 2] += group(d, c);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int t = __reduce_add_sync(kFullMask, q[h]);
          if (lane == 0) atomicAdd(&b[seq_c(j.col + 32 * h)], t);
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // 64-column halves
          const int cbase = j.col + 64 * h;
          int sq = seq_c(cbase);
          if constexpr (kEpi == kTwoSeq) {
            // at most two sequences: sums a (the first) and z, selected
            // without a branch
            const int edge = (sq + 1) * pj;
            int a = 0, z = 0;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int w = group(d + 32 * h, c);
              const bool first = cbase + 8 * c < edge;
              a += first ? w : 0;
              z += first ? 0 : w;
            }
            const int ta = __reduce_add_sync(kFullMask, a);
            const int tz = __reduce_add_sync(kFullMask, z);
            if (lane == 0) {
              atomicAdd(&b[sq], ta);
              atomicAdd(&b[min(sq + 1, s - 1)], tz);
            }
          } else {  // short sequences: a run per column sequence
            int next = (sq + 1) * pj, run = 0;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              if (cbase + 8 * c >= next) {  // a new column sequence
                const int t = __reduce_add_sync(kFullMask, run);
                if (lane == 0) atomicAdd(&b[min(sq, s - 1)], t);
                ++sq;
                next += pj;
                run = 0;
              }
              run += group(d + 32 * h, c);
            }
            const int t = __reduce_add_sync(kFullMask, run);
            if (lane == 0) atomicAdd(&b[min(sq, s - 1)], t);
          }
        }
      }
    }
  };
  auto wait_products = [&]() {
    if constexpr (kVariant != kLoads && kVariant != kNoMma) wgmma_wait<0>();
  };

  // the job cursor: unit L (u), i chunk ci, strip-relative paired chunk cj
  WsUnit u = ws_unit(u0, nt, nr);
  int64_t L = u0;
  int c0 = u.r * rc, ncj = min(rc, ncy - c0);
  int ci = 0, cj = 0, st = 0, ph = 0, buf = 0, strips = 0;
  bool more = true;
  WsJob pv{};  // the job in flight in the other accumulator set
  bool pending = false;

  // the previous job's weights once its product has landed (its stage
  // released first where it was its i chunk's last)
  auto retire = [&](const int* d) {
    if (pv.chunk_end && lane == 0) mbar_arrive(empty + pv.st);
    epilogue(d, pv);
    if (pv.unit_end) flush(pv.u, pv.buf);
  };
  // the job at the cursor into acc; the one before it out of prev, weighed
  // while the new product runs
  auto step = [&](int* acc, int* prev) {
    const WsJob cur{u, ci, cj, (c0 + cj) * kChunk, st, ph, buf, cj == ncj - 1,
                    ci == nc - 1 && cj == ncj - 1};
    if (ci == 0 && cj == 0 && (L == u0 || u.tj == u.ti)) {
      // a new resident strip: drain, hand the old one back, wait for it
      if (pending) {
        wait_products();
        retire(prev);
        pending = false;
      }
      if (strips > 0 && lane == 0) mbar_arrive(strip_empty);
      mbar_wait(strip_full, strips++ & 1);
    }
    if (cj == 0) mbar_wait(full + st, ph);  // the i chunk landed
    issue(acc, cur);
    if (pending) {
      if constexpr (kVariant != kLoads && kVariant != kNoMma) wgmma_wait<1>();
      retire(prev);
    }
    pv = cur;
    pending = true;
    if (++cj == ncj) {
      cj = 0;
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
      if (++ci == nc) {
        ci = 0;
        buf ^= 1;
        if (++L == u1) {
          more = false;
        } else {
          ws_next(u, nt, nr);
          c0 = u.r * rc;
          ncj = min(rc, ncy - c0);
        }
      }
    }
  };
  int acc0[64], acc1[64];
  while (true) {
    step(acc0, acc1);
    if (!more) {
      wait_products();
      retire(acc0);
      break;
    }
    step(acc1, acc0);
    if (!more) {
      wait_products();
      retire(acc1);
      break;
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

using WsKernel = void (*)(const uint8_t*, int32_t*, int, int, int, int, int, int, int, int);
using DeepKernel = void (*)(const uint8_t*, int32_t*, int, int, int, int, int, int);
// [variant][epilogue] and [variant][layout - 2]: depth, slabs
#define FASTSK_EPILOGUES(V) \
  {pairs_ws_kernel<V, kOneSeq>, pairs_ws_kernel<V, kTwoSeq>, pairs_ws_kernel<V, kRuns>}
#define FASTSK_DEEP(V) {pairs_mma_deep_kernel<V, true>, pairs_mma_deep_kernel<V, false>}
const WsKernel kWsKernels[kVariants][kEpilogues] = {
    FASTSK_EPILOGUES(kNoop),     FASTSK_EPILOGUES(kLoads), FASTSK_EPILOGUES(kMatmul),
    FASTSK_EPILOGUES(kSkeleton), FASTSK_EPILOGUES(kNoMma), FASTSK_EPILOGUES(kCurrent),
    FASTSK_EPILOGUES(kInt32)};
const DeepKernel kDeepKernels[kVariants][2] = {
    FASTSK_DEEP(kNoop),   FASTSK_DEEP(kLoads), FASTSK_DEEP(kMatmul), FASTSK_DEEP(kSkeleton),
    FASTSK_DEEP(kNoMma), FASTSK_DEEP(kCurrent), FASTSK_DEEP(kInt32)};
#undef FASTSK_EPILOGUES
#undef FASTSK_DEEP

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

// Kernel A's tensor-core body. Layout 0 (resident: rc the tile's paired
// chunk count) or 1 (windows: s = 1, rc paired chunks a range): x the
// wrapper's operands (ops/pairs_cuda.py:ws_operands: p_pad the re-padded
// windows a sequence, a multiple of 16; depth a multiple of 32), `stages`
// ring stages, the epilogue (0: each 32 paired columns and a warp's 16
// rows in one sequence, which needs s = 1 or p_pad % 64 == 0; 1: two sums
// a 64-column half, p_pad >= 128; 2: runs), g the one-hot rows' codes
// (the pair table's side, g + 1); one block an SM, out zeroed where a
// tile has more than one range. Layout 2 (depth) or 3
// (slabs: rc j chunks a block): x [n_pad * p_pad, depth] int8 one-hot
// windows, depth a multiple of 64, out zeroed. Tile side s and rc from
// the wrapper's plan. Variant 5 (current) computes the counts; the others
// are kernel H's (kNoop to kInt32), in every layout. Refuses a plan whose
// block does not fit shared memory or whose grid is too large.
extern "C" int pairs_mma_launch(const void* x, void* out, int n_pad, int p_pad,
                                int depth, int k, int s, int rc, int layout,
                                int variant, int g, int stages, int epilogue, void* stream) {
  if (p_pad < 8 || p_pad % 8 || n_pad < 1 || k < 1 || s < 1 || s > 8 || n_pad % s || rc < 1 ||
      layout < 0 || layout > 3 || variant < 0 || variant >= kVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // j chunks a tile: paired rows in the resident and windows layouts
  const int nc = (s * p_pad / (layout <= 1 ? 2 : 1) + kChunk - 1) / kChunk;
  if (rc > nc || (layout == 0 && rc != nc) || (layout == 1 && s != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nt = n_pad / s;
  const int64_t units = nt * (nt + 1) / 2 * ((nc + rc - 1) / rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout <= 1) {
    if (p_pad % 16 || depth < 32 || depth % 32 || k > g || g > 20 || stages < 2 ||
        epilogue < 0 || epilogue >= kEpilogues || (epilogue == kOneSeq && s > 1 && p_pad % 64) ||
        (epilogue == kTwoSeq && p_pad < 128)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = ws_smem_bytes(s, rc, stages, depth, g);
    if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidConfiguration);
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const WsKernel kernel = kWsKernels[variant][epilogue];
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>(units < sms ? units : sms);
    kernel<<<blocks, kWsThreads, smem, st>>>(static_cast<const uint8_t*>(x),
                                             static_cast<int32_t*>(out), n_pad, p_pad, s, k, g,
                                             depth, rc, stages);
    return static_cast<int>(cudaGetLastError());
  }
  if (depth < 64 || depth % 64) return static_cast<int>(cudaErrorInvalidValue);
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = deep_smem_bytes(s, depth, layout == 2);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidConfiguration);
  const DeepKernel kernel = kDeepKernels[variant][layout - 2];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(units), kMmaThreads, smem, st>>>(
      static_cast<const uint8_t*>(x), static_cast<int32_t*>(out), n_pad, p_pad,
      s, k, depth, rc);
  return static_cast<int>(cudaGetLastError());
}
