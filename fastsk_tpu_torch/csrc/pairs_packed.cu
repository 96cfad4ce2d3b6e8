// Kernels D, F, G and E, and F's stage 1: the packed (ragged) exact gapped
// k-mer counts.
//
// Replace, in fastsk_tpu/ops/pairs_packed_pallas.py:
//   D  packed_block_mma_kernel / packed_block_kernel over the whole upper
//      tile triangle        <- _packed_band_kernel (packed_band_pallas)
//   F  packed_block_mma_kernel / packed_block_kernel over one strip's
//      triangle or a rectangle of strips, with the JAX mesh paths' stage 2
//      (fastsk_tpu/ops/pairs_packed.py:_pair_parts) and landing
//      (strip_planes_update, strip_block_shard_update) folded in
//                           <- _packed_s1_kernel (packed_s1_pallas);
//      packed_s1_kernel is that TPU kernel's stage 1 alone
//   G  packed_block_mma_kernel / packed_block_kernel into part blocks
//                           <- _packed_part_kernel (packed_part_pallas)
//   E  packed_pairlist_kernel <- _packed_pairlist_kernel (packed_pairlist_pallas)
//
// All compute, for row pairs (r, c) of the packed window table,
//
//     w(r, c) = C(matches(r, c), k)
//
// and sum w into (seq_of[r], seq_of[c]). They differ only in which pairs
// of row tiles they walk and where the sums land:
//   D  every upper-triangle pair of 128-row tiles (ti <= tj), one launch,
//      landing straight into one [ld, ld] int64 matrix: bins at (si, sj),
//      and for ti < tj also at (sj, si), so every ordered row pair counts
//      exactly once (a diagonal tile holds both orders itself) and no
//      scatter or mirror pass follows;
//   F  the same rule restricted to the row tiles of a run of strips and
//      the column tiles up to a last strip (the mesh's round-robin route:
//      strip a's rows against every row from its own tile on; the ring's
//      diagonal step: a device's own strips against themselves), or, with
//      no mirror, a rectangle of one table's row tiles against another
//      table's column tiles (the ring's other steps: a device's own strips
//      against the visiting shard's); both land at (si - row_off, sj) of
//      the caller's row block, the mirror at (sj - row_off, si). Rows
//      outside the strips' own count as padding, where strips narrower
//      than a tile share one; the calls over a partition of the strips
//      then add up to D's matrix;
//   G  a rectangle, strip a against a run of strips b, into part blocks
//      out[b - b0, si - first_seq[a], sj - first_seq[b]] (the caller lands
//      them, ops/pairs_packed.py:land_parts); strips narrower than a
//      128-row tile run E's kernel over the pairs (a, b);
//   E  a list of strip pairs (pa[s], pb[s]), every tile pair of the two
//      strips, into out[s, si - fa, sj - fb] likewise.
//
// D, F and G have two bodies: the int8 tensor-core product of one-hot rows
// (packed_block_mma_kernel, described at the kernel, the default to a
// stated depth g * alpha) and the byte-code body below
// (packed_block_kernel), whose tile pair E shares; F's stage 1 has its own
// copy of the pair loop. The rest of this note is the
// byte-code body's.
//
// Row encoding: a window's g codes, one byte each, in ceil(g / 4) 32-bit
// words (the bytes past g are 0 in every row). matches = popc(vcmpeq4)/8
// summed over the words, minus the (4W - g) padding bytes, which always
// compare equal; the C(d, k) table is indexed before that subtraction.
// The TPU's one-hot MXU operands, digit planes and byte-split landings
// only kept bf16/int8 products exact; integers need none of them, and
// the width no longer grows with the alphabet (<= 5 words at any
// alphabet; one-hot at alpha = 24, g = 8 is 48 words).
//
// What bounds it on the H100: integer work per row pair (W vcmpeq4 +
// popc + adds and one shared table load), then atomics. The design:
//   - a block (128 threads) owns one pair of row tiles; thread t keeps
//     i-row t's words in registers and streams the j tile's rows from
//     shared memory (every lane reads the same word: broadcast);
//   - rows are sorted by sequence, so a thread's running int32 sum covers
//     a run of j rows of one sequence and is flushed only where the j
//     sequence changes (uniform across the block): at most ~17 flushes
//     per 128 pairs, each one warp reduction plus one shared atomic
//     when the warp's rows share a sequence (the common case);
//   - per-sequence bins of the tile pair live in shared memory as 32-bit
//     unsigned: a bin is at most 128^2 * C(20, 10) = 3.03e9 < 2^32;
//   - bins flush to global int64 with one atomicAdd per nonzero bin:
//     a K entry can reach p_i * p_j * C(g, k) > 2^31;
//   - padding rows (seq_of = -1) are skipped by seq_of, not by weight:
//     their code bytes may still compare equal;
//   - the grid is a 1-D index over the walk's tile pairs: no block outside
//     it is launched.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace fastsk_hopper;

constexpr int kThreads = 128;  // = the largest row tile
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kAllRows = INT64_MAX;

// The tables a tile pair reads: row tiles from (xa, seq_a), column tiles
// from (xb, seq_b) (one table but in F's ring), each with its tile_first,
// and the rows of each that count, [r_lo, r_hi) of a and [c_lo, c_hi) of
// b; the others act as padding rows.
struct Operands {
  const uint32_t* xa;
  const int* seq_a;
  const int* tf_a;
  const uint32_t* xb;
  const int* seq_b;
  const int* tf_b;
  int64_t r_lo, r_hi, c_lo, c_hi;
};

__host__ __device__ Operands one_table(const uint32_t* x, const int* seq_of,
                                       const int* tile_first) {
  return {x, seq_of, tile_first, x, seq_of, tile_first, 0, kAllRows, 0, kAllRows};
}

// A run of tile pairs in row-tile-major order: a rectangle (row tiles
// ti0.., column tiles tj0 .. tj0 + nc - 1 for each), or the upper triangle
// of nt tiles restricted to row tiles ti0.. (column tiles ti .. nt - 1 for
// row tile ti; pair L of the run is pair L + base of the whole triangle).
struct Walk {
  int64_t ti0, tj0, nc;  // rectangle
  int64_t nt, base;      // triangle
  int64_t total;         // tile pairs in the run
  int tri;

  __device__ void at(int64_t L, int64_t& ti, int64_t& tj) const {
    if (tri) {
      const int64_t g = L + base;
      ti = row_tile_of(g, nt);
      tj = ti + (g - pairs_before(ti, nt));
    } else {
      ti = ti0 + L / nc;
      tj = tj0 + L % nc;
    }
  }

  __device__ void next(int64_t& ti, int64_t& tj) const {
    if (++tj == (tri ? nt : tj0 + nc)) {
      ++ti;
      tj = tri ? ti : tj0;
    }
  }
};

Walk rect_walk(int64_t ti0, int64_t ti1, int64_t tj0, int64_t tj1) {
  Walk w{};
  w.ti0 = ti0;
  w.tj0 = tj0;
  w.nc = tj1 - tj0;
  w.total = (ti1 - ti0) * w.nc;
  return w;
}

Walk tri_walk(int64_t ti0, int64_t ti1, int64_t nt) {
  Walk w{};
  w.tri = 1;
  w.nt = nt;
  w.base = pairs_before(ti0, nt);
  w.total = pairs_before(ti1, nt) - w.base;
  return w;
}

// Where a tile pair's bins land. kLandMatrix: out[(si - row_off) * ld +
// sj], and with mirror, off the diagonal tile, also out[(sj - row_off) *
// ld + si]. kLandParts: the part block of column strip b = tj / tps,
// out[((b - b0) * c_pad + si - fs_a[a]) * c_pad + sj - fs_b[b]].
enum { kLandMatrix = 0, kLandParts = 1 };

struct Land {
  unsigned long long* out;
  int64_t ld, row_off;
  int mirror;
  const int* fs_a;
  const int* fs_b;
  int a, b0, tps, c_pad;
};

// Adds the nonzero bins of tile pair (ti, tj) into the output and zeroes
// them; every thread of the block calls it once the bins are complete.
template <int kLand>
__device__ void land_bins(unsigned* bins, int cb, int fi, int fj, int64_t ti,
                          int64_t tj, const Land& d) {
  int64_t part = 0;
  int fa = 0, fb = 0;
  if (kLand == kLandParts) {
    const int b = static_cast<int>(tj / d.tps);
    fa = d.fs_a[d.a];
    fb = d.fs_b[b];
    part = static_cast<int64_t>(b - d.b0) * d.c_pad * d.c_pad;
  }
  for (int q = threadIdx.x; q < cb * cb; q += blockDim.x) {
    const unsigned long long v = bins[q];
    if (!v) continue;
    bins[q] = 0;
    const int64_t si = fi + q / cb, sj = fj + q % cb;
    if (kLand == kLandMatrix) {
      atomicAdd(&d.out[(si - d.row_off) * d.ld + sj], v);
      if (d.mirror && ti != tj) atomicAdd(&d.out[(sj - d.row_off) * d.ld + si], v);
    } else {
      atomicAdd(&d.out[part + (si - fa) * d.c_pad + (sj - fb)], v);
    }
  }
}

struct Tile {
  uint32_t* x;   // [kThreads * W] j rows
  int* seq;      // [kThreads] j rows' sequence ids
  int* tbl;      // [32] C(t - pad, k)
  unsigned* bins;  // [cb, cb]
};

// One warp's flush of its running sums for j sequence (fj + lj): rows of
// one i sequence reduce in the warp first.
__device__ __forceinline__ void flush(unsigned* bins, int cb, int li, int lj,
                                      unsigned acc) {
  const int lmax = __reduce_max_sync(kFull, li);
  if (lmax < 0) return;  // no valid i row in this warp
  if (__all_sync(kFull, li < 0 || li == lmax)) {
    const unsigned tot = __reduce_add_sync(kFull, li < 0 ? 0u : acc);
    if ((threadIdx.x & 31) == 0) atomicAdd(&bins[lmax * cb + lj], tot);
  } else if (li >= 0) {
    atomicAdd(&bins[li * cb + lj], acc);
  }
}

// The byte-code body of one tile pair: row tile ti of table a (i side)
// against row tile tj of table b (j side), tr rows each, summed into
// t.bins[(si - fi) * cb + (sj - fj)]. Every thread of the block must call
// it.
template <int W>
__device__ void tile_pair(const Operands& op, int64_t ti, int64_t tj, int tr,
                          int cb, int fi, int fj, int k, int pad, Tile t) {
  const int tid = threadIdx.x;
  const uint32_t* xj = op.xb + tj * tr * W;
  for (int q = tid; q < tr * W; q += kThreads) t.x[q] = xj[q];
  if (tid < tr) {
    const int64_t c = tj * tr + tid;
    t.seq[tid] = c >= op.c_lo && c < op.c_hi ? op.seq_b[c] : -1;
  }
  for (int q = tid; q < cb * cb; q += kThreads) t.bins[q] = 0;
  if (tid < 32) {
    // C(d, k) for d = tid - pad matches, exactly
    const int d = tid - pad;
    int64_t c = d >= k ? 1 : 0;
    for (int j = 0; j < k && c; ++j) c = c * (d - j) / (j + 1);
    t.tbl[tid] = static_cast<int>(c);
  }
  __syncthreads();

  uint32_t a[W];
  int li = -1;
  if (tid < tr) {
    const int64_t row = ti * tr + tid;
    const int si = op.seq_a[row];
    if (si >= 0 && row >= op.r_lo && row < op.r_hi) li = si - fi;
#pragma unroll
    for (int w = 0; w < W; ++w) a[w] = __ldg(op.xa + row * W + w);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) a[w] = 0;
  }

  int cur = -1;
  unsigned acc = 0;
  for (int j = 0; j < tr; ++j) {
    const int sj = t.seq[j];
    if (sj < 0) continue;  // block-uniform
    if (sj != cur) {
      if (cur >= 0) flush(t.bins, cb, li, cur - fj, acc);
      cur = sj;
      acc = 0;
    }
    const uint32_t* b = t.x + j * W;
    int pc = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) pc += __popc(__vcmpeq4(a[w], b[w]));
    acc += t.tbl[pc >> 3];
  }
  if (cur >= 0) flush(t.bins, cb, li, cur - fj, acc);
  __syncthreads();
}

#define FASTSK_TILE_SMEM(W)                      \
  __shared__ uint32_t sx[kThreads * (W)];        \
  __shared__ int sseq[kThreads];                 \
  __shared__ int stbl[32];                       \
  extern __shared__ unsigned sbins[];            \
  const Tile tile{sx, sseq, stbl, sbins};

// D, F and G, byte codes: block L = tile pair L of the walk.
template <int W, int kLand>
__global__ void __launch_bounds__(kThreads)
packed_block_kernel(Operands op, Walk walk, Land land, int cb, int k, int pad) {
  FASTSK_TILE_SMEM(W)
  int64_t ti, tj;
  walk.at(blockIdx.x, ti, tj);
  const int fi = op.tf_a[ti], fj = op.tf_b[tj];
  tile_pair<W>(op, ti, tj, kThreads, cb, fi, fj, k, pad, tile);
  land_bins<kLand>(sbins, cb, fi, fj, ti, tj, land);
}

// Lands a tile pair's bins into one [c_pad, c_pad] part block whose
// corner is sequence (fa, fb).
__device__ __forceinline__ void flush_part(const unsigned* bins, int cb,
                                           int fi, int fj, int fa, int fb,
                                           int c_pad,
                                           unsigned long long* part) {
  for (int q = threadIdx.x; q < cb * cb; q += kThreads) {
    const unsigned v = bins[q];
    if (!v) continue;
    const int i = fi + q / cb - fa, j = fj + q % cb - fb;
    atomicAdd(&part[i * c_pad + j], static_cast<unsigned long long>(v));
  }
}

// E: block = (slot s, tile pair within strips pa[s] x pb[s]).
template <int W>
__global__ void __launch_bounds__(kThreads)
packed_pairlist_kernel(const uint32_t* __restrict__ x,
                       const int* __restrict__ seq_of,
                       const int* __restrict__ tile_first,
                       const int* __restrict__ first_seq,
                       const int* __restrict__ pa, const int* __restrict__ pb,
                       unsigned long long* __restrict__ out, int tr, int tps,
                       int cb, int k, int pad, int c_pad) {
  FASTSK_TILE_SMEM(W)
  const int64_t blk = blockIdx.x;
  const int64_t s = blk / (tps * tps);
  const int sub = static_cast<int>(blk % (tps * tps));
  const int a = pa[s], b = pb[s];
  const int64_t ti = static_cast<int64_t>(a) * tps + sub / tps;
  const int64_t tj = static_cast<int64_t>(b) * tps + sub % tps;
  const int fi = tile_first[ti], fj = tile_first[tj];
  tile_pair<W>(one_table(x, seq_of, tile_first), ti, tj, tr, cb, fi, fj, k, pad, tile);
  flush_part(sbins, cb, fi, fj, first_seq[a], first_seq[b], c_pad,
             out + s * c_pad * c_pad);
}

#undef FASTSK_TILE_SMEM

// F's stage 1 alone: strip a against a run of column rows (n_b strips of
// `tile` rows, flattened to n_cols):
//
//     s1[b, li, c] = sum_{r in strip a, seq_a[r] = fa + li} C(matches(r, c), k)
//
// into out [n_b, c_pad, tile] int32, zeroed by the caller: the TPU
// kernel's own output, one value in place of its digit planes sum_d
// base^d * s1_d (s1 <= tile * C(g, k) < 2^31, which the wrapper guards).
// The mesh paths run packed_block, which folds stage 2 and the landing in.
//
// What bounds it: the integer work per row pair (D's per-pair body: W
// vcmpeq4 + popc, one shared table load), then the s1 writes. The design:
//   - a block of 128 threads owns 128 consecutive column rows; thread t
//     keeps its column row's words in registers;
//   - the block streams strip a's rows through shared memory in 128-row
//     chunks (every lane reads the same word: broadcast);
//   - rows are sorted by sequence, so the i sequence changes uniformly
//     across the block: each thread flushes its running sum to s1[b, li,
//     c] with a plain store when it does. A local sequence is one run of
//     rows, so each (li, c) has exactly one writer and no atomics;
//   - padding rows (seq_of = -1) are skipped on the i side and write
//     nothing on the j side: their code bytes may still compare equal.
template <int W>
__global__ void __launch_bounds__(kThreads)
packed_s1_kernel(const uint32_t* __restrict__ xa, const int* __restrict__ seq_a,
                 const int* __restrict__ first_seq_a, int a, int tile,
                 const uint32_t* __restrict__ xb, const int* __restrict__ seq_b,
                 int64_t n_cols, int c_pad, int k, int pad,
                 int* __restrict__ out) {
  __shared__ uint32_t sx[kThreads * W];
  __shared__ int sseq[kThreads];
  __shared__ int stbl[32];
  const int tid = threadIdx.x;
  if (tid < 32) {
    const int d = tid - pad;
    int64_t c = d >= k ? 1 : 0;
    for (int j = 0; j < k && c; ++j) c = c * (d - j) / (j + 1);
    stbl[tid] = static_cast<int>(c);
  }
  const int fa = first_seq_a[a];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  bool live = false;
  int* dst = out;  // &s1[b, 0, c]; row li is li * tile further
  uint32_t bw[W];
  if (col < n_cols) {
    live = seq_b[col] >= 0;
    dst = out + (col / tile) * c_pad * tile + col % tile;
#pragma unroll
    for (int w = 0; w < W; ++w) bw[w] = __ldg(xb + col * W + w);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) bw[w] = 0;
  }

  const uint32_t* xs = xa + static_cast<int64_t>(a) * tile * W;
  const int* ss = seq_a + static_cast<int64_t>(a) * tile;
  int cur = -1;
  int acc = 0;
  for (int r0 = 0; r0 < tile; r0 += kThreads) {
    const int nr = min(kThreads, tile - r0);
    __syncthreads();  // the previous chunk is consumed (and stbl is set)
    for (int q = tid; q < nr * W; q += kThreads) sx[q] = xs[r0 * W + q];
    if (tid < nr) sseq[tid] = ss[r0 + tid];
    __syncthreads();
    for (int j = 0; j < nr; ++j) {
      const int si = sseq[j];
      if (si < 0) continue;  // block-uniform
      if (si != cur) {
        if (cur >= 0 && live) dst[static_cast<int64_t>(cur - fa) * tile] = acc;
        cur = si;
        acc = 0;
      }
      const uint32_t* r = sx + j * W;
      int pc = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) pc += __popc(__vcmpeq4(r[w], bw[w]));
      acc += stbl[pc >> 3];
    }
  }
  if (cur >= 0 && live) dst[static_cast<int64_t>(cur - fa) * tile] = acc;
}

size_t bins_bytes(int cb) { return static_cast<size_t>(cb) * cb * sizeof(unsigned); }

cudaError_t set_smem(const void* fn, int cb) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bins_bytes(cb)));
}

// ------------------------------------------------ D, F and G, tensor cores
//
// The default body of D, F and G (packed_block_mma_kernel): the match
// counts as the int8 tensor-core product of one-hot rows, M = X_r X_c^T
// (X_r [128, depth], byte p * alpha + code_p set, depth = g * alpha
// rounded up to 64), by wgmma m64n128k32 s8 -> s32 (two warpgroups, 64
// rows each, against the 128 columns). A persistent block walks a
// contiguous run of the launch's tile pairs (Walk) in row-tile-major
// order, so the row tile's one-hot stays in shared memory across the run
// and only the column tile changes. What bounds it, and the design:
//   - one-hot operands are g * alpha bytes a row where the codes are g:
//     staged from global memory they would be about a terabyte of L2
//     traffic at the 2.19 shape (one 24 KB tile a tile pair). Only the
//     code words and sequence ids travel (cp.async, double buffered: the
//     next column tile's arrive while this one computes); each block
//     expands them into zeroed one-hot tiles in shared memory itself,
//     straight into wgmma's K-major core-matrix layout (onehot_at), and
//     wgmma reads both operands from there: no fragment loads;
//   - the epilogue looks up C(M, k) only where the warp holds some
//     M >= k (a vote), and then only for those counts, each added to its
//     shared 32-bit (si, sj) bin: at alpha = 24 a window pair matches in
//     k = 4 places about once in 5,000, so most warps pay one max a count
//     and one vote;
//   - bins land in the int64 output once a tile pair (Land): D's and F's
//     matrix, or G's part blocks. F's walk and landing are what the JAX
//     mesh paths do in a stage-2 cumsum, a gather and a scatter after the
//     TPU kernel (about 48 torch launches per launch of the stage-1
//     kernel); here no buffer sits between the product and the landing;
//   - measured at the 2.19 shape (experiments/probe_band.py), the wgmma
//     loop sets the pace (about half the card's int8 peak), then the
//     lookups, then expansion and barriers;
//   - two barriers a tile pair (tiles ready; bins complete and the next
//     codes landed), the next column tile's codes in flight meanwhile;
//   - the first k-step overwrites the accumulators (scale-d 0), so nothing
//     else writes them: ptxas serializes wgmma around other writes
//     (C7515). Only the no-wgmma timing variant zeroes them;
//   - padding rows, and rows outside the launch's strips, expand to zero
//     rows: M = 0 and C(0, k) = 0 for k >= 1, so they add nothing and need
//     no test in the product.
// The depth grows as g * alpha (5,120 bytes at g = 20 over 256 codes),
// where the byte-code body's cost does not: the wrappers take this body to
// a stated depth (ops/pairs_packed_cuda.py:band_body) and the byte-code
// body above it.

constexpr int kMmaThreads = 256;  // 2 warpgroups, 64 rows x 128 columns each
constexpr int kMaxWords = 5;
constexpr int kMmaDepthMax = 768;  // two 128-row tiles of 768 B rows fit

struct MmaShape {
  int w, g, alpha, depth, cb, k;
};

size_t mma_smem_bytes(int depth, int cb) {
  return 2 * static_cast<size_t>(kThreads) * depth +
         2 * kThreads * kMaxWords * sizeof(uint32_t) + 3 * kThreads * sizeof(int) +
         32 * sizeof(int) + bins_bytes(cb);
}

// One 128-row tile's one-hot rows into dst (onehot_at's layout), from
// its code words [128, w] and sequence ids; the tile's row r is row
// row0 + r of its table, and only rows in [lo, hi) are set. Thread t
// zeroes and fills half t & 1 of row t >> 1, so no thread waits on another
// here. The writes are made visible to wgmma (the async proxy) before it
// reads.
__device__ void expand_onehot(uint8_t* dst, int depth, const uint32_t* codes,
                              const int* seq, int w, int g, int alpha,
                              int64_t row0, int64_t lo, int64_t hi) {
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const int half = depth / 2;  // a multiple of 32
  for (int q = h * half; q < (h + 1) * half; q += 16) {
    *reinterpret_cast<uint4*>(dst + onehot_at(r, q, depth)) = make_uint4(0, 0, 0, 0);
  }
  if (seq[r] >= 0 && row0 + r >= lo && row0 + r < hi) {
    uint32_t word = 0;
    for (int p = 0; p < g; ++p) {
      if ((p & 3) == 0) word = codes[r * w + (p >> 2)];
      const int pos = p * alpha + ((word >> (8 * (p & 3))) & 0xff);
      if ((pos >= half) == (h != 0)) dst[onehot_at(r, pos, depth)] = 1;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// kVariant 0 is the kernel; the others time its parts (the product is
// then not the count matrix): 1 skips the epilogue, 2 the mma loop, 3 the
// column tiles' expansion (they stay zero, so the epilogue finds nothing).
template <int kVariant, int kLand>
__global__ void __launch_bounds__(kMmaThreads, 2)
packed_block_mma_kernel(Operands op, Walk walk, Land land, MmaShape s) {
  extern __shared__ __align__(128) uint4 smem_raw[];
  const int depth = s.depth, w = s.w, k = s.k, cb = s.cb;
  uint8_t* sa = reinterpret_cast<uint8_t*>(smem_raw);
  uint8_t* sb = sa + kThreads * depth;
  uint32_t* scode = reinterpret_cast<uint32_t*>(sb + kThreads * depth);  // [2][128 * w]
  int* sseq_b = reinterpret_cast<int*>(scode + 2 * kThreads * kMaxWords);  // [2][128]
  int* sseq_a = sseq_b + 2 * kThreads;
  int* tbl = sseq_a + kThreads;
  unsigned* bins = reinterpret_cast<unsigned*>(tbl + 32);
  const int tid = threadIdx.x;

  const int64_t begin = blockIdx.x * walk.total / gridDim.x;
  const int64_t end = (blockIdx.x + 1) * walk.total / gridDim.x;
  if (begin >= end) return;
  if (tid < 32) {  // C(d, k) for d = tid matches, exactly
    int64_t c = tid >= k ? 1 : 0;
    for (int j = 0; j < k && c; ++j) c = c * (tid - j) / (j + 1);
    tbl[tid] = static_cast<int>(c);
  }
  for (int q = tid; q < cb * cb; q += kMmaThreads) bins[q] = 0;

  int64_t ti, tj;
  walk.at(begin, ti, tj);

  // column tile t's code words and sequence ids into buffer `buf`
  auto prefetch = [&](int64_t t, int buf) {
    const int code_chunks = 32 * w;  // 128 * w words, 16 bytes a chunk
    if (tid < code_chunks) {
      cp_async16(scode + buf * kThreads * kMaxWords + tid * 4, op.xb + t * kThreads * w + tid * 4);
    } else if (tid < code_chunks + 32) {
      const int q = tid - code_chunks;
      cp_async16(sseq_b + buf * kThreads + q * 4, op.seq_b + t * kThreads + q * 4);
    }
    cp_async_commit();
  };
  prefetch(tj, 0);
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2;  // warpgroup: rows 64 * wg of the row tile
  const int row0 = 64 * wg + 16 * (warp & 3) + gid;  // this thread's first row
  int64_t cur_ti = -1;
  int buf = 0;
  // two barriers a tile pair: after the expansion (tiles ready) and after
  // the epilogue (bins complete, the next codes landed, tiles free)
  for (int64_t L = begin; L < end; ++L) {
    if (ti != cur_ti) {  // a new row tile: its one-hot straight from global
      expand_onehot(sa, depth, op.xa + ti * kThreads * w, op.seq_a + ti * kThreads, w,
                    s.g, s.alpha, ti * kThreads, op.r_lo, op.r_hi);
      if (tid < kThreads) sseq_a[tid] = op.seq_a[ti * kThreads + tid];
      cur_ti = ti;
    }
    const int fi = op.tf_a[ti], fj = op.tf_b[tj];
    int64_t ti2 = ti, tj2 = tj;
    walk.next(ti2, tj2);
    if (L + 1 < end) prefetch(tj2, buf ^ 1);
    const int* sseq = sseq_b + buf * kThreads;
    if (kVariant != 3) {
      expand_onehot(sb, depth, scode + buf * kThreads * kMaxWords, sseq, w, s.g,
                    s.alpha, tj * kThreads, op.c_lo, op.c_hi);
    } else if (L == begin) {  // zero column tiles: every count 0
      for (int q = tid; q < kThreads * depth / 16; q += kMmaThreads) {
        reinterpret_cast<uint4*>(sb)[q] = make_uint4(0, 0, 0, 0);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();

    // this warpgroup's 64 x 128 counts: element v of a thread is row
    // row0 + 8 * ((v >> 1) & 1), column 8 * (v >> 2) + 2 * tig + (v & 1)
    int acc[64];
    if (kVariant == 2) {
#pragma unroll
      for (int v = 0; v < 64; ++v) acc[v] = 0;
    } else {
      const uint8_t* a_rows = sa + wg * 64 * depth;  // 8 row groups of 8 * depth B
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int c = 0; c < depth; c += 32) {  // two core matrices along K
        wgmma_s8(acc, smem_desc(a_rows + c * 8, 128, depth * 8),
                 smem_desc(sb + c * 8, 128, depth * 8), c > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }

    if (kVariant == 1) {  // consume the counts, so the products stay
      int x = 0;
#pragma unroll
      for (int v = 0; v < 64; ++v) x ^= acc[v];
      if (x == 0x7fffffff) atomicAdd(&bins[0], 1u);
    } else {
      int mx = 0;
#pragma unroll
      for (int v = 0; v < 64; ++v) mx = max(mx, acc[v]);
      if (__any_sync(kFull, mx >= k)) {
        // only counts >= k weigh anything (and only rows that count reach
        // them: the others are zero)
#pragma unroll
        for (int v = 0; v < 64; ++v) {
          const int m = acc[v];
          if (m >= k) {
            const int si = sseq_a[row0 + 8 * ((v >> 1) & 1)];
            const int sj = sseq[8 * (v >> 2) + 2 * tig + (v & 1)];
            atomicAdd(&bins[(si - fi) * cb + (sj - fj)], static_cast<unsigned>(tbl[m]));
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    land_bins<kLand>(bins, cb, fi, fj, ti, tj, land);
    ti = ti2;
    tj = tj2;
    buf ^= 1;
  }
}

using MmaKernel = void (*)(Operands, Walk, Land, MmaShape);
const MmaKernel kMmaMatrix[4] = {
    packed_block_mma_kernel<0, kLandMatrix>, packed_block_mma_kernel<1, kLandMatrix>,
    packed_block_mma_kernel<2, kLandMatrix>, packed_block_mma_kernel<3, kLandMatrix>};
const MmaKernel kMmaParts = packed_block_mma_kernel<0, kLandParts>;

// The byte-code body over a walk: one block a tile pair.
template <int kLand>
cudaError_t launch_bytes(const Operands& op, const Walk& walk, const Land& land,
                         int w, int cb, int k, int pad, cudaStream_t st) {
  if (walk.total == 0) return cudaSuccess;
  if (walk.total > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err;
  const unsigned blocks = static_cast<unsigned>(walk.total);
  switch (w) {
#define FASTSK_W(N)                                                          \
  case N:                                                                    \
    err = set_smem(reinterpret_cast<const void*>(packed_block_kernel<N, kLand>), cb); \
    if (err != cudaSuccess) return err;                                      \
    packed_block_kernel<N, kLand><<<blocks, kThreads, bins_bytes(cb), st>>>( \
        op, walk, land, cb, k, pad);                                         \
    break;
    FASTSK_W(1) FASTSK_W(2) FASTSK_W(3) FASTSK_W(4) FASTSK_W(5)
#undef FASTSK_W
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The tensor-core body over a walk: persistent blocks, as many as the
// card holds at once.
cudaError_t launch_mma(MmaKernel kernel, const Operands& op, const Walk& walk,
                       const Land& land, const MmaShape& s, cudaStream_t st) {
  if (s.w < 1 || s.w > kMaxWords || s.depth % 64 || s.depth > kMmaDepthMax ||
      s.g * s.alpha > s.depth || s.alpha > 256) {
    return cudaErrorInvalidValue;
  }
  if (walk.total == 0) return cudaSuccess;
  const size_t smem = mma_smem_bytes(s.depth, s.cb);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t blocks = std::min<int64_t>(walk.total, static_cast<int64_t>(sms) * per_sm);
  kernel<<<static_cast<unsigned>(blocks), kMmaThreads, smem, st>>>(op, walk, land, s);
  return cudaGetLastError();
}

Operands one_table(const void* x, const void* seq_of, const void* tile_first) {
  return one_table(static_cast<const uint32_t*>(x), static_cast<const int*>(seq_of),
                   static_cast<const int*>(tile_first));
}

Land matrix_land(void* out, int64_t ld, int64_t row_off, int mirror) {
  Land d{};
  d.out = static_cast<unsigned long long*>(out);
  d.ld = ld;
  d.row_off = row_off;
  d.mirror = mirror;
  return d;
}

}  // namespace

// Common arguments: x [R, w] int32 words of window code bytes; seq_of [R]
// int32 (-1 padding); tile_first [R / tr] int32, the first sequence of each
// tr-row tile (0 for a tile with no valid row; tr = 128 but for E); cb >=
// every tile's sequence span; pad = 4 * w - g; 1 <= k <= g <= 20, 1 <= w <=
// 5; the tensor-core body's depth a multiple of 64 with g * alpha <= depth
// <= 768. Outputs are int64, zeroed by the caller; the kernels add into
// them.

// D: n_tiles 128-row tiles, the whole upper triangle; out [ld, ld]. body 0
// is the tensor-core body, whose `variant` 0 computes the counts and 1 to
// 3 time its parts (see packed_block_mma_kernel) and leave `out`
// meaningless; body 1 is the byte-code body.
extern "C" int packed_band_launch(const void* x, const void* seq_of,
                                  const void* tile_first, void* out,
                                  long long n_tiles, long long ld, int w,
                                  int g, int alpha, int depth, int cb, int k,
                                  int body, int variant, void* stream) {
  if (variant < 0 || variant > 3 || body < 0 || body > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operands op = one_table(x, seq_of, tile_first);
  const Walk walk = tri_walk(0, n_tiles, n_tiles);
  const Land land = matrix_land(out, ld, 0, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    return static_cast<int>(launch_bytes<kLandMatrix>(op, walk, land, w, cb, k, 4 * w - g, st));
  }
  return static_cast<int>(
      launch_mma(kMmaMatrix[variant], op, walk, land, {w, g, alpha, depth, cb, k}, st));
}

// F: rows [r_lo, r_hi) of table a (xa, seq_a, tf_a) against rows [c_lo,
// c_hi) of table b, landing at (si - row_off, sj) of out [*, ld]. tri 1:
// the triangle walk (table b is table a, c_lo is ignored and c_hi >= r_hi):
// the row tiles holding rows [r_lo, r_hi) against every tile from their
// own on that holds rows below c_hi, landing off the diagonal tile also at
// (sj - row_off, si). tri 0: the rectangle. body 0 tensor cores, 1 byte
// codes.
extern "C" int packed_block_launch(const void* xa, const void* seq_a,
                                   const void* tf_a, const void* xb,
                                   const void* seq_b, const void* tf_b,
                                   long long r_lo, long long r_hi,
                                   long long c_lo, long long c_hi, int tri,
                                   void* out, long long ld, long long row_off,
                                   int w, int g, int alpha, int depth, int cb,
                                   int k, int body, void* stream) {
  if (r_lo >= r_hi || (tri ? c_hi < r_hi : c_lo >= c_hi) || body < 0 || body > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operands a = one_table(xa, seq_a, tf_a), b = one_table(xb, seq_b, tf_b);
  Operands op{a.xa, a.seq_a, a.tf_a, b.xb, b.seq_b, b.tf_b, r_lo, r_hi, 0, c_hi};
  const int64_t ti0 = r_lo / kThreads, ti1 = (r_hi + kThreads - 1) / kThreads;
  const int64_t tj1 = (c_hi + kThreads - 1) / kThreads;
  Walk walk;
  if (tri) {
    walk = tri_walk(ti0, ti1, tj1);
  } else {
    op.c_lo = c_lo;
    walk = rect_walk(ti0, ti1, c_lo / kThreads, tj1);
  }
  const Land land = matrix_land(out, ld, row_off, tri);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    return static_cast<int>(launch_bytes<kLandMatrix>(op, walk, land, w, cb, k, 4 * w - g, st));
  }
  return static_cast<int>(
      launch_mma(kMmaMatrix[0], op, walk, land, {w, g, alpha, depth, cb, k}, st));
}

// E: n_pairs slots; tps = tiles per strip (strip = tps * tr rows);
// out [n_pairs, c_pad, c_pad].
extern "C" int packed_pairlist_launch(const void* x, const void* seq_of,
                                      const void* tile_first,
                                      const void* first_seq, const void* pa,
                                      const void* pb, void* out, int n_pairs,
                                      int w, int tr, int tps, int cb, int k,
                                      int pad, int c_pad, void* stream) {
  const int64_t blocks = static_cast<int64_t>(n_pairs) * tps * tps;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* xw = static_cast<const uint32_t*>(x);
  const int* sq = static_cast<const int*>(seq_of);
  const int* tf = static_cast<const int*>(tile_first);
  const int* fs = static_cast<const int*>(first_seq);
  const int* a = static_cast<const int*>(pa);
  const int* b = static_cast<const int*>(pb);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err;
  switch (w) {
#define FASTSK_W(N)                                                           \
  case N:                                                                     \
    err = set_smem(reinterpret_cast<const void*>(packed_pairlist_kernel<N>), cb); \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    packed_pairlist_kernel<N><<<static_cast<unsigned>(blocks), kThreads,      \
                                bins_bytes(cb), st>>>(                        \
        xw, sq, tf, fs, a, b, o, tr, tps, cb, k, pad, c_pad);                 \
    break;
    FASTSK_W(1) FASTSK_W(2) FASTSK_W(3) FASTSK_W(4) FASTSK_W(5)
#undef FASTSK_W
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// G: strip a against strips b0 .. b0 + n_b - 1 in 128-row tiles (tps a
// strip); out [n_b, c_pad, c_pad]; body 0 tensor cores, 1 byte codes.
extern "C" int packed_grouped_launch(const void* x, const void* seq_of,
                                     const void* tile_first,
                                     const void* first_seq, int a, int b0,
                                     int n_b, void* out, int tps, int c_pad,
                                     int w, int g, int alpha, int depth,
                                     int cb, int k, int body, void* stream) {
  if (body < 0 || body > 1) return static_cast<int>(cudaErrorInvalidValue);
  Land land{};
  land.out = static_cast<unsigned long long*>(out);
  land.fs_a = land.fs_b = static_cast<const int*>(first_seq);
  land.a = a;
  land.b0 = b0;
  land.tps = tps;
  land.c_pad = c_pad;
  const Walk walk = rect_walk(static_cast<int64_t>(a) * tps, static_cast<int64_t>(a + 1) * tps,
                              static_cast<int64_t>(b0) * tps,
                              static_cast<int64_t>(b0 + n_b) * tps);
  const Operands op = one_table(x, seq_of, tile_first);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    return static_cast<int>(launch_bytes<kLandParts>(op, walk, land, w, cb, k, 4 * w - g, st));
  }
  return static_cast<int>(launch_mma(kMmaParts, op, walk, land, {w, g, alpha, depth, cb, k}, st));
}

// F's stage 1: xa / seq_a the whole table holding strip a (first_seq_a[a]
// its first sequence); xb / seq_b the first of n_cols = n_b * tile column
// rows; out [n_b, c_pad, tile] int32.
extern "C" int packed_s1_launch(const void* xa, const void* seq_a,
                                const void* first_seq_a, int a, int tile,
                                const void* xb, const void* seq_b,
                                long long n_cols, int c_pad, int w, int k,
                                int pad, void* out, void* stream) {
  const int64_t blocks = (n_cols + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* x_a = static_cast<const uint32_t*>(xa);
  const uint32_t* x_b = static_cast<const uint32_t*>(xb);
  const int* sa = static_cast<const int*>(seq_a);
  const int* sb = static_cast<const int*>(seq_b);
  const int* fs = static_cast<const int*>(first_seq_a);
  int* o = static_cast<int*>(out);
  switch (w) {
#define FASTSK_W(N)                                                        \
  case N:                                                                  \
    packed_s1_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>( \
        x_a, sa, fs, a, tile, x_b, sb, n_cols, c_pad, k, pad, o);          \
    break;
    FASTSK_W(1) FASTSK_W(2) FASTSK_W(3) FASTSK_W(4) FASTSK_W(5)
#undef FASTSK_W
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
