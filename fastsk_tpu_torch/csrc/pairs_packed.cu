// Kernels D, E, G and F: the packed (ragged) exact gapped k-mer counts.
//
// Replace, in fastsk_tpu/ops/pairs_packed_pallas.py:
//   D  packed_band_mma_kernel, packed_band_kernel
//                             <- _packed_band_kernel (packed_band_pallas)
//   E  packed_pairlist_kernel <- _packed_pairlist_kernel (packed_pairlist_pallas)
//   G  packed_grouped_kernel  <- _packed_part_kernel (packed_part_pallas)
//   F  packed_s1_kernel       <- _packed_s1_kernel (packed_s1_pallas); the
//      mesh paths' stage 1, described at the kernel below
//
// All four compute, for row pairs (r, c) of the packed window table,
//
//     w(r, c) = C(matches(r, c), k)
//
// and sum w into (seq_of[r], seq_of[c]). They differ only in which row
// tiles they pair and where the sums land:
//   D  every upper-triangle pair of 128-row tiles (ti <= tj), one launch,
//      landing straight into one [ld, ld] int64 matrix: bins at (si, sj),
//      and for ti < tj also at (sj, si), so every ordered row pair counts
//      exactly once (a diagonal tile holds both orders itself) and no
//      scatter or mirror pass follows;
//   E  a list of strip pairs (pa[s], pb[s]), every tile pair of the two
//      strips, into part blocks out[s, si - fa, sj - fb] (the caller lands
//      them, ops/pairs_packed.py:land_parts);
//   G  strip a against strips gidx * group + u, u < group, into
//      out[u, si - fa, sj - fb].
//
// D has two bodies: the int8 tensor-core product of one-hot rows
// (packed_band_mma_kernel, described at the kernel, the default to a
// stated depth g * alpha) and the byte-code body below, which E, G and F
// share (F with its own copy of the pair loop). The rest of this note is
// the byte-code body's.
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
//   - D's grid is a 1-D triangular index over the upper tile pairs: no
//     lower-triangle blocks are launched.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace fastsk_hopper;

constexpr int kThreads = 128;  // = the largest row tile
constexpr unsigned kFull = 0xffffffffu;

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

// The per-pair body shared by D, E and G: row tile ti (i side) against
// row tile tj (j side), tr rows each, summed into t.bins[(si - fi) * cb +
// (sj - fj)]. Every thread of the block must call it.
template <int W>
__device__ void tile_pair(const uint32_t* __restrict__ x,
                          const int* __restrict__ seq_of, int64_t ti,
                          int64_t tj, int tr, int cb, int fi, int fj, int k,
                          int pad, Tile t) {
  const int tid = threadIdx.x;
  const uint32_t* xj = x + tj * tr * W;
  for (int q = tid; q < tr * W; q += kThreads) t.x[q] = xj[q];
  if (tid < tr) t.seq[tid] = seq_of[tj * tr + tid];
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
    const int si = seq_of[row];
    if (si >= 0) li = si - fi;
#pragma unroll
    for (int w = 0; w < W; ++w) a[w] = __ldg(x + row * W + w);
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

// D: block L of the upper tile triangle -> (ti <= tj), L = tj(tj+1)/2 + ti.
template <int W>
__global__ void __launch_bounds__(kThreads)
packed_band_kernel(const uint32_t* __restrict__ x,
                   const int* __restrict__ seq_of,
                   const int* __restrict__ tile_first,
                   unsigned long long* __restrict__ out, int64_t ld, int cb,
                   int k, int pad) {
  FASTSK_TILE_SMEM(W)
  const int64_t L = blockIdx.x;
  int64_t tj = static_cast<int64_t>((sqrt(8.0 * L + 1.0) - 1.0) / 2.0);
  while (tj * (tj + 1) / 2 > L) --tj;
  while ((tj + 1) * (tj + 2) / 2 <= L) ++tj;
  const int64_t ti = L - tj * (tj + 1) / 2;
  const int fi = tile_first[ti], fj = tile_first[tj];
  tile_pair<W>(x, seq_of, ti, tj, kThreads, cb, fi, fj, k, pad, tile);
  for (int q = threadIdx.x; q < cb * cb; q += kThreads) {
    const unsigned v = sbins[q];
    if (!v) continue;
    const int64_t si = fi + q / cb, sj = fj + q % cb;
    atomicAdd(&out[si * ld + sj], static_cast<unsigned long long>(v));
    if (ti != tj) atomicAdd(&out[sj * ld + si], static_cast<unsigned long long>(v));
  }
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
  tile_pair<W>(x, seq_of, ti, tj, tr, cb, fi, fj, k, pad, tile);
  flush_part(sbins, cb, fi, fj, first_seq[a], first_seq[b], c_pad,
             out + s * c_pad * c_pad);
}

// G: block = (u, tile pair within strips a x (gidx * group + u)).
template <int W>
__global__ void __launch_bounds__(kThreads)
packed_grouped_kernel(const uint32_t* __restrict__ x,
                      const int* __restrict__ seq_of,
                      const int* __restrict__ tile_first,
                      const int* __restrict__ first_seq, int a, int gidx,
                      int group, unsigned long long* __restrict__ out, int tr,
                      int tps, int cb, int k, int pad, int c_pad) {
  FASTSK_TILE_SMEM(W)
  const int blk = blockIdx.x;
  const int u = blk / (tps * tps);
  const int sub = blk % (tps * tps);
  const int b = gidx * group + u;
  const int64_t ti = static_cast<int64_t>(a) * tps + sub / tps;
  const int64_t tj = static_cast<int64_t>(b) * tps + sub % tps;
  const int fi = tile_first[ti], fj = tile_first[tj];
  tile_pair<W>(x, seq_of, ti, tj, tr, cb, fi, fj, k, pad, tile);
  flush_part(sbins, cb, fi, fj, first_seq[a], first_seq[b], c_pad,
             out + static_cast<int64_t>(u) * c_pad * c_pad);
}

#undef FASTSK_TILE_SMEM

// F: stage 1 of strip a against a run of column rows (n_b strips of `tile`
// rows, flattened to n_cols):
//
//     s1[b, li, c] = sum_{r in strip a, seq_a[r] = fa + li} C(matches(r, c), k)
//
// into out [n_b, c_pad, tile] int32, zeroed by the caller; stage 2 (the
// j-side cumsum and boundary gather) stays in torch ops, as it stays in
// XLA beside the TPU kernel. One value in place of the TPU's digit planes
// sum_d base^d * s1_d: s1 <= tile * C(g, k) < 2^31, which the wrapper
// guards.
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

// ------------------------------------------------------ D, tensor cores
//
// D's default body (packed_band_mma_kernel): the match counts as the int8
// tensor-core product of one-hot rows, M = X_r X_c^T (X_r [128, depth],
// byte p * alpha + code_p set, depth = g * alpha rounded up to 64), by
// wgmma m64n128k32 s8 -> s32 (two warpgroups, 64 rows each, against the
// 128 columns). A persistent block walks a contiguous run of the upper
// tile triangle in row-tile-major order, so the row tile's one-hot stays
// in shared memory across the run and only the column tile changes. What
// bounds it, and the design:
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
//     bins land in the int64 output once a tile pair, both halves off the
//     diagonal;
//   - measured at the 2.19 shape (experiments/probe_band.py), the wgmma
//     loop sets the pace (about half the card's int8 peak), then the
//     lookups, then expansion and barriers;
//   - two barriers a tile pair (tiles ready; bins complete and the next
//     codes landed), the next column tile's codes in flight meanwhile;
//   - padding rows expand to zero rows: M = 0 and C(0, k) = 0 for k >= 1,
//     so they add nothing and need no test in the product.
// The depth grows as g * alpha (5,120 bytes at g = 20 over 256 codes),
// where the byte-code body's cost does not: packed_band takes this body
// to a stated depth (ops/pairs_packed_cuda.py:band_body) and D's byte-code
// body above it.

constexpr int kMmaThreads = 256;  // 2 warpgroups, 64 rows x 128 columns each
constexpr int kMaxWords = 5;
constexpr int kMmaDepthMax = 768;  // two 128-row tiles of 768 B rows fit

size_t mma_smem_bytes(int depth, int cb) {
  return 2 * static_cast<size_t>(kThreads) * depth +
         2 * kThreads * kMaxWords * sizeof(uint32_t) + 3 * kThreads * sizeof(int) +
         32 * sizeof(int) + bins_bytes(cb);
}

// One 128-row tile's one-hot rows into dst (onehot_at's layout), from
// its code words [128, w] and sequence ids; thread t zeroes and fills
// half t & 1 of row t >> 1, so no thread waits on another here. The
// writes are made visible to wgmma (the async proxy) before it reads.
__device__ void expand_onehot(uint8_t* dst, int depth, const uint32_t* codes,
                              const int* seq, int w, int g, int alpha) {
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const int half = depth / 2;  // a multiple of 32
  for (int q = h * half; q < (h + 1) * half; q += 16) {
    *reinterpret_cast<uint4*>(dst + onehot_at(r, q, depth)) = make_uint4(0, 0, 0, 0);
  }
  if (seq[r] >= 0) {
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
template <int kVariant>
__global__ void __launch_bounds__(kMmaThreads, 2)
packed_band_mma_kernel(const uint32_t* __restrict__ x,
                       const int* __restrict__ seq_of,
                       const int* __restrict__ tile_first,
                       unsigned long long* __restrict__ out, int64_t nt,
                       int64_t ld, int w, int g, int alpha, int depth, int cb,
                       int k) {
  extern __shared__ __align__(128) uint4 smem_raw[];
  uint8_t* sa = reinterpret_cast<uint8_t*>(smem_raw);
  uint8_t* sb = sa + kThreads * depth;
  uint32_t* scode = reinterpret_cast<uint32_t*>(sb + kThreads * depth);  // [2][128 * w]
  int* sseq_b = reinterpret_cast<int*>(scode + 2 * kThreads * kMaxWords);  // [2][128]
  int* sseq_a = sseq_b + 2 * kThreads;
  int* tbl = sseq_a + kThreads;
  unsigned* bins = reinterpret_cast<unsigned*>(tbl + 32);
  const int tid = threadIdx.x;

  const int64_t total = nt * (nt + 1) / 2;
  const int64_t begin = blockIdx.x * total / gridDim.x;
  const int64_t end = (blockIdx.x + 1) * total / gridDim.x;
  if (begin >= end) return;
  if (tid < 32) {  // C(d, k) for d = tid matches, exactly
    int64_t c = tid >= k ? 1 : 0;
    for (int j = 0; j < k && c; ++j) c = c * (tid - j) / (j + 1);
    tbl[tid] = static_cast<int>(c);
  }
  for (int q = tid; q < cb * cb; q += kMmaThreads) bins[q] = 0;

  // the run's first tile pair: the last row tile ti with pairs_before <= begin
  int64_t ti = row_tile_of(begin, nt);
  int64_t tj = ti + (begin - pairs_before(ti, nt));

  // column tile t's code words and sequence ids into buffer `buf`
  auto prefetch = [&](int64_t t, int buf) {
    const int code_chunks = 32 * w;  // 128 * w words, 16 bytes a chunk
    if (tid < code_chunks) {
      cp_async16(scode + buf * kThreads * kMaxWords + tid * 4, x + t * kThreads * w + tid * 4);
    } else if (tid < code_chunks + 32) {
      const int q = tid - code_chunks;
      cp_async16(sseq_b + buf * kThreads + q * 4, seq_of + t * kThreads + q * 4);
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
      expand_onehot(sa, depth, x + ti * kThreads * w, seq_of + ti * kThreads, w,
                    g, alpha);
      if (tid < kThreads) sseq_a[tid] = seq_of[ti * kThreads + tid];
      cur_ti = ti;
    }
    const int fi = tile_first[ti], fj = tile_first[tj];
    int64_t ti2 = ti, tj2 = tj + 1;
    if (tj2 == nt) tj2 = ++ti2;
    if (L + 1 < end) prefetch(tj2, buf ^ 1);
    const int* sseq = sseq_b + buf * kThreads;
    if (kVariant != 3) {
      expand_onehot(sb, depth, scode + buf * kThreads * kMaxWords, sseq, w, g,
                    alpha);
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
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] = 0;
    if (kVariant != 2) {
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
      int s = 0;
#pragma unroll
      for (int v = 0; v < 64; ++v) s ^= acc[v];
      if (s == 0x7fffffff) atomicAdd(&bins[0], 1u);
    } else {
      int mx = 0;
#pragma unroll
      for (int v = 0; v < 64; ++v) mx = max(mx, acc[v]);
      if (__any_sync(kFull, mx >= k)) {
        // only counts >= k weigh anything (and only rows of sequences
        // reach them: padding rows are zero)
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

    for (int q = tid; q < cb * cb; q += kMmaThreads) {
      const unsigned v = bins[q];
      if (!v) continue;
      bins[q] = 0;
      const int64_t si = fi + q / cb, sj = fj + q % cb;
      atomicAdd(&out[si * ld + sj], static_cast<unsigned long long>(v));
      if (ti != tj) atomicAdd(&out[sj * ld + si], static_cast<unsigned long long>(v));
    }
    ti = ti2;
    tj = tj2;
    buf ^= 1;
  }
}

using MmaKernel = void (*)(const uint32_t*, const int*, const int*,
                           unsigned long long*, int64_t, int64_t, int, int,
                           int, int, int, int);
const MmaKernel kMmaVariants[4] = {
    packed_band_mma_kernel<0>, packed_band_mma_kernel<1>,
    packed_band_mma_kernel<2>, packed_band_mma_kernel<3>};

}  // namespace

// Common arguments: x [R, w] int32 words of window code bytes; seq_of [R]
// int32 (-1 padding); tile_first [R / tr] int32, the first sequence of each
// tr-row tile (0 for a tile with no valid row); cb >= every tile's sequence
// span; pad = 4 * w - g; 1 <= k <= g <= 20, 1 <= w <= 5. Outputs are int64,
// zeroed by the caller; the kernels add into them.

// D's byte-code body: n_tiles 128-row tiles; out [ld, ld].
extern "C" int packed_band_launch(const void* x, const void* seq_of,
                                  const void* tile_first, void* out,
                                  long long n_tiles, long long ld, int w,
                                  int cb, int k, int pad, void* stream) {
  const int64_t blocks = n_tiles * (n_tiles + 1) / 2;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* xw = static_cast<const uint32_t*>(x);
  const int* sq = static_cast<const int*>(seq_of);
  const int* tf = static_cast<const int*>(tile_first);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err;
  switch (w) {
#define FASTSK_W(N)                                                        \
  case N:                                                                  \
    err = set_smem(reinterpret_cast<const void*>(packed_band_kernel<N>), cb); \
    if (err != cudaSuccess) return static_cast<int>(err);                  \
    packed_band_kernel<N><<<static_cast<unsigned>(blocks), kThreads,       \
                            bins_bytes(cb), st>>>(xw, sq, tf, o, ld, cb, k, pad); \
    break;
    FASTSK_W(1) FASTSK_W(2) FASTSK_W(3) FASTSK_W(4) FASTSK_W(5)
#undef FASTSK_W
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// D's tensor-core body: n_tiles 128-row tiles; out [ld, ld]; g * alpha <=
// depth <= 768, depth a multiple of 64. Persistent blocks, as many as the
// card holds at once. variant 0 computes the counts; 1 to 3 time its parts
// (see packed_band_mma_kernel) and leave `out` meaningless.
extern "C" int packed_band_mma_launch(const void* x, const void* seq_of,
                                      const void* tile_first, void* out,
                                      long long n_tiles, long long ld, int w,
                                      int g, int alpha, int depth, int cb,
                                      int k, int variant, void* stream) {
  if (n_tiles == 0) return 0;
  if (w < 1 || w > kMaxWords || depth % 64 || depth > kMmaDepthMax ||
      g * alpha > depth || alpha > 256 || variant < 0 || variant > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MmaKernel kernel = kMmaVariants[variant];
  const size_t smem = mma_smem_bytes(depth, cb);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t pairs = n_tiles * (n_tiles + 1) / 2;
  const int64_t blocks = std::min<int64_t>(pairs, static_cast<int64_t>(sms) * per_sm);
  kernel<<<static_cast<unsigned>(blocks), kMmaThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int*>(seq_of),
      static_cast<const int*>(tile_first),
      static_cast<unsigned long long*>(out), n_tiles, ld, w, g, alpha, depth,
      cb, k);
  return static_cast<int>(cudaGetLastError());
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

// G: strip a against strips gidx * group + u; out [group, c_pad, c_pad].
extern "C" int packed_grouped_launch(const void* x, const void* seq_of,
                                     const void* tile_first,
                                     const void* first_seq, int a, int gidx,
                                     int group, void* out, int w, int tr,
                                     int tps, int cb, int k, int pad,
                                     int c_pad, void* stream) {
  const int64_t blocks = static_cast<int64_t>(group) * tps * tps;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* xw = static_cast<const uint32_t*>(x);
  const int* sq = static_cast<const int*>(seq_of);
  const int* tf = static_cast<const int*>(tile_first);
  const int* fs = static_cast<const int*>(first_seq);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err;
  switch (w) {
#define FASTSK_W(N)                                                          \
  case N:                                                                    \
    err = set_smem(reinterpret_cast<const void*>(packed_grouped_kernel<N>), cb); \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    packed_grouped_kernel<N><<<static_cast<unsigned>(blocks), kThreads,      \
                               bins_bytes(cb), st>>>(                        \
        xw, sq, tf, fs, a, gidx, group, o, tr, tps, cb, k, pad, c_pad);      \
    break;
    FASTSK_W(1) FASTSK_W(2) FASTSK_W(3) FASTSK_W(4) FASTSK_W(5)
#undef FASTSK_W
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// F: xa / seq_a the whole table holding strip a (first_seq_a[a] its first
// sequence); xb / seq_b the first of n_cols = n_b * tile column rows;
// out [n_b, c_pad, tile] int32.
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
