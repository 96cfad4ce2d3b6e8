// Kernels D, E, G and F: the packed (ragged) exact gapped k-mer counts.
//
// Replace, in fastsk_tpu/ops/pairs_packed_pallas.py:
//   D  packed_band_kernel     <- _packed_band_kernel (packed_band_pallas)
//   E  packed_pairlist_kernel <- _packed_pairlist_kernel (packed_pairlist_pallas)
//   G  packed_grouped_kernel  <- _packed_part_kernel (packed_part_pallas)
//   F  packed_s1_kernel       <- _packed_s1_kernel (packed_s1_pallas); the
//      mesh paths' stage 1, described at the kernel below
//
// All three compute, for row pairs (r, c) of the packed window table,
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
// Tensor-core products, wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// Common arguments: x [R, w] int32 words of window code bytes; seq_of [R]
// int32 (-1 padding); tile_first [R / tr] int32, the first sequence of each
// tr-row tile (0 for a tile with no valid row); cb >= every tile's sequence
// span; pad = 4 * w - g; 1 <= k <= g <= 20, 1 <= w <= 5. Outputs are int64,
// zeroed by the caller; the kernels add into them.

// D: n_tiles 128-row tiles; out [ld, ld].
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
