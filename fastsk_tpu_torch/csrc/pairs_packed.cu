// Kernels D, E, F and G, and F's stage 1: the packed (ragged) exact gapped
// k-mer counts.
//
// Replace, in fastsk_tpu/ops/pairs_packed_pallas.py:
//   D  packed_bytes_kernel over the whole upper tile triangle
//                           <- _packed_band_kernel (packed_band_pallas)
//   F  packed_bytes_kernel over one strip's triangle or a rectangle of
//      strips, with the JAX mesh paths' stage 2
//      (fastsk_tpu/ops/pairs_packed.py:_pair_parts) and landing
//      (strip_planes_update, strip_block_shard_update) folded in
//                           <- _packed_s1_kernel (packed_s1_pallas);
//      packed_s1_kernel is that TPU kernel's stage 1 alone
//   G  packed_bytes_kernel into part blocks
//                           <- _packed_part_kernel (packed_part_pallas)
//   E  packed_bytes_kernel over a list of strip pairs
//                           <- _packed_pairlist_kernel (packed_pairlist_pallas)
//
// All compute, for row pairs (r, c) of the packed window table,
//
//     w(r, c) = C(matches(r, c), k)
//
// and sum w into (seq_of[r], seq_of[c]). They differ only in which pairs
// of row tiles they walk (Walk) and where the sums land (Land):
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
//      128-row tile run E's pair list (a, b) into part blocks;
//   E  a list of strip pairs (pa[s], pb[s]), every tile pair of the two
//      strips (tiles of tr <= 128 rows), landing into the matrix like D,
//      mirrored per slot where pb[s] > pa[s] (a diagonal slot holds both
//      orders), or into part blocks out[s, si - fa, sj - fb].
//
// One body computes the counts, packed_bytes_kernel (described at the
// kernel), on code planes; F's stage 1 has its own byte-code pair loop.
//
// Padding rows (seq_of = -1) are skipped by seq_of, not by the codes,
// since their codes may still compare equal; per-sequence bins of
// a tile pair live in shared memory as 32-bit unsigned (a bin is at most
// 128^2 * C(20, 10) = 3.03e9 < 2^32) and flush to the int64 output with
// one atomicAdd per nonzero bin (an entry can reach p_i * p_j * C(g, k) >
// 2^31); rows are sorted by sequence, so a thread's running sum covers a
// run of j rows of one sequence and is flushed only where the j sequence
// changes.

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

// A run of tile pairs in row-tile-major order:
//   kRect  row tiles ti0.., column tiles tj0 .. tj0 + nc - 1 for each;
//   kTri   the upper triangle of nt tiles restricted to row tiles ti0..
//          (column tiles ti .. nt - 1 for row tile ti; pair L of the run
//          is pair L + base of the whole triangle);
//   kList  slot s = L / tps^2 is strip pair (pa[s], pb[s]), its tps x tps
//          tile pairs row tile first: ti = pa[s] * tps + u / tps, tj =
//          pb[s] * tps + u % tps for u = L % tps^2.
// Indices are int64: a list or triangle may hold more than 2^31 pairs.
enum { kRect = 0, kTri = 1, kList = 2 };

struct Walk {
  int64_t ti0, tj0, nc;  // rectangle
  int64_t nt, base;      // triangle
  const int* pa;         // list
  const int* pb;
  int64_t tps;
  int64_t total;  // tile pairs in the run
  int kind;

  __device__ void at(int64_t L, int64_t& ti, int64_t& tj) const {
    if (kind == kTri) {
      const int64_t g = L + base;
      ti = row_tile_of(g, nt);
      tj = ti + (g - pairs_before(ti, nt));
    } else if (kind == kList) {
      const int64_t s = L / (tps * tps), u = L % (tps * tps);
      ti = pa[s] * tps + u / tps;
      tj = pb[s] * tps + u % tps;
    } else {
      ti = ti0 + L / nc;
      tj = tj0 + L % nc;
    }
  }

  // (ti, tj) of pair L + 1, from pair L's
  __device__ void next(int64_t L, int64_t& ti, int64_t& tj) const {
    if (kind == kList) {
      at(L + 1, ti, tj);
    } else if (++tj == (kind == kTri ? nt : tj0 + nc)) {
      ++ti;
      tj = kind == kTri ? ti : tj0;
    }
  }
};

Walk rect_walk(int64_t ti0, int64_t ti1, int64_t tj0, int64_t tj1) {
  Walk w{};
  w.kind = kRect;
  w.ti0 = ti0;
  w.tj0 = tj0;
  w.nc = tj1 - tj0;
  w.total = (ti1 - ti0) * w.nc;
  return w;
}

Walk tri_walk(int64_t ti0, int64_t ti1, int64_t nt) {
  Walk w{};
  w.kind = kTri;
  w.nt = nt;
  w.base = pairs_before(ti0, nt);
  w.total = pairs_before(ti1, nt) - w.base;
  return w;
}

Walk list_walk(const int* pa, const int* pb, int64_t n_pairs, int64_t tps) {
  Walk w{};
  w.kind = kList;
  w.pa = pa;
  w.pb = pb;
  w.tps = tps;
  w.total = n_pairs * tps * tps;
  return w;
}

// Where a tile pair's bins land. kLandMatrix: out[(si - row_off) * ld +
// sj], and with mirror also out[(sj - row_off) * ld + si] where the walk's
// mirror rule holds (off the diagonal tile; for a list, a slot with pb[s]
// > pa[s]). kLandParts: a part block, out[(part * c_pad + si - fa) * c_pad
// + sj - fb]: a list's slot s (fa, fb the first sequences of strips pa[s]
// and pb[s]), or the rectangle's column strip b = tj / tps (part b - b0,
// strips a and b).
enum { kLandMatrix = 0, kLandParts = 1 };

struct Land {
  unsigned long long* out;
  int64_t ld, row_off;
  int mirror;
  const int* fs_a;
  const int* fs_b;
  int a, b0, tps, c_pad;
};

// A tile pair's landing: mirrored or not, and its part block.
struct Target {
  int mirror;
  int64_t part;
  int fa, fb;
};

template <int kLand>
__device__ Target target_of(const Walk& w, const Land& d, int64_t L, int64_t ti, int64_t tj) {
  Target t{0, 0, 0, 0};
  if (w.kind == kList) {
    const int64_t s = L / (w.tps * w.tps);
    const int a = w.pa[s], b = w.pb[s];
    t.mirror = d.mirror && b > a;
    if (kLand == kLandParts) {
      t.part = s;
      t.fa = d.fs_a[a];
      t.fb = d.fs_b[b];
    }
  } else {
    t.mirror = d.mirror && ti != tj;
    if (kLand == kLandParts) {
      const int b = static_cast<int>(tj / d.tps);
      t.part = b - d.b0;
      t.fa = d.fs_a[d.a];
      t.fb = d.fs_b[b];
    }
  }
  return t;
}

// Adds the nonzero bins of a tile pair whose sequences start at (fi, fj)
// into the output and zeroes them; every thread of the block calls it
// once the bins are complete.
template <int kLand>
__device__ void land_bins(unsigned* bins, int cb, int fi, int fj, const Target& t,
                          const Land& d) {
  const int64_t part = t.part * d.c_pad * d.c_pad;
  for (int q = threadIdx.x; q < cb * cb; q += blockDim.x) {
    const unsigned long long v = bins[q];
    if (!v) continue;
    bins[q] = 0;
    const int64_t si = fi + q / cb, sj = fj + q % cb;
    if (kLand == kLandMatrix) {
      atomicAdd(&d.out[(si - d.row_off) * d.ld + sj], v);
      if (t.mirror) atomicAdd(&d.out[(sj - d.row_off) * d.ld + si], v);
    } else {
      atomicAdd(&d.out[part + (si - t.fa) * d.c_pad + (sj - t.fb)], v);
    }
  }
}

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

size_t bins_bytes(int cb) { return static_cast<size_t>(cb) * cb * sizeof(unsigned); }

// ---------------------------------------------- D, E, F and G, code planes
//
// packed_bytes_kernel: the counts from each window's code bits. A row's g
// codes (alpha letters, nb = ceil(log2 alpha) <= 8 bits each) are stored
// as nb plane words, plane p holding bit p of code q at bit q (bits past g
// are 0), padded to S = 4 or 8 words a row (ops/pairs_packed_cuda.py:
// PackedRows.planes). The positions where two windows differ are then one
// word,
//
//     m = OR_p (a_p XOR b_p) | pad_b,   matches = g - popc(m),
//
// nb LOP3 and one POPC a window pair, whatever g is (pad_b folds into the
// first LOP3). The positions past g compare equal and never count. pad_b
// is all ones where the j row is padding (its seq_of, -1, shifted right by
// 31), so such a pair has d = popc(m) = 32 > g and weighs tbl[d] = 0 with
// no test, for every g <= 20 and k (the weight table tbl[d] = C(g - d, k)
// has 64 entries, zero past g); padding i rows flush nowhere.
//
// What bounds it on the H100: integer issue per window pair (the nb LOP3,
// the POPC at a quarter of the ALU rate, the weight), then shared-memory
// loads. The design:
//   - persistent blocks (as many as the card holds), each walking a
//     contiguous run of the launch's tile pairs (Walk: rectangle, triangle
//     or pair list) in row-tile-major order: the row tile's planes stay in
//     registers across its column tiles, the C(d, k) table is built once a
//     block, and the next column tile's planes and sequence ids arrive by
//     cp.async into a second buffer while this one computes;
//   - a thread holds kRows = 4 i rows (lane + 32 q of the row tile) and a
//     warp takes a quarter of the column tile's j rows, so every broadcast
//     j word read from shared memory serves four pairs;
//   - j rows go in aligned groups of kGroup = 8: a sequence owns whole
//     groups of rows, its valid rows first, padding after
//     (ops/pairs_packed.py:pack_windows; PackedRows.planes checks it), so
//     the sequence is compared once a group, 32 pairs of a thread, and the
//     group's 8 j rows are independent work;
//   - the weight is looked up only where some lane of the warp has a pair
//     of the group with d <= g - k (a vote): at wide alphabets most window
//     pairs match in fewer than k places and weigh 0;
//   - one barrier a tile pair: the bins are double-buffered, so a tile
//     pair's landing overlaps the next one's sums;
//   - tiles of tr <= 128 rows (a multiple of 8) serve lists over strips
//     narrower than 128 rows; lanes past tr hold no row.
// SASS of the inner loop at nb = 5 (experiments/sass_loop.py, sm_90a,
// nvcc 12.9): the common path of a step (8 j rows for a thread's 4 i
// rows, no sequence change, the vote false) is 259 instructions, 160 LOP3,
// 32 POPC and 18 LDS among them: 8.09 a window pair. chip_smoke.py
// counts it again from the library it builds.

constexpr int kRows = 4;   // i rows a thread
constexpr int kGroup = 8;  // j rows of one sequence (or padding) a step

__host__ __device__ constexpr int plane_stride(int nb) { return nb <= 4 ? 4 : 8; }

template <int NB, int kLand>
__global__ void __launch_bounds__(kThreads)
packed_bytes_kernel(Operands op, Walk walk, Land land, int tr, int cb, int g, int k) {
  constexpr int S = plane_stride(NB);
  __shared__ __align__(16) uint32_t sx[2][kThreads * S];
  __shared__ __align__(16) int sseq[2][kThreads];
  __shared__ unsigned tbl[64];
  extern __shared__ unsigned sbins[];  // [2][cb * cb]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int64_t begin = blockIdx.x * walk.total / gridDim.x;
  const int64_t end = (blockIdx.x + 1) * walk.total / gridDim.x;
  if (begin >= end) return;
  if (tid < 64) {  // C(g - d, k) for d = tid mismatches, exactly
    const int m = g - tid;
    int64_t c = tid <= g && m >= k ? 1 : 0;
    for (int j = 0; j < k && c; ++j) c = c * (m - j) / (j + 1);
    tbl[tid] = static_cast<unsigned>(c);
  }
  for (int q = tid; q < 2 * cb * cb; q += kThreads) sbins[q] = 0;

  // column tile t's planes and sequence ids into buffer `buf`
  auto prefetch = [&](int64_t t, int buf) {
    const uint32_t* src = op.xb + t * tr * S;
    for (int q = tid; q < tr * S / 4; q += kThreads) cp_async16(&sx[buf][q * 4], src + q * 4);
    const int* ss = op.seq_b + t * tr;
    for (int q = tid; q < tr / 4; q += kThreads) cp_async16(&sseq[buf][q * 4], ss + q * 4);
    cp_async_commit();
  };

  int64_t ti, tj;
  walk.at(begin, ti, tj);
  prefetch(tj, 0);
  cp_async_wait_all();
  __syncthreads();

  const int gk = g - k;
  uint32_t a[kRows][NB];
  int li[kRows];
  int64_t cur_ti = -1;
  int fi = 0, buf = 0;
  for (int64_t L = begin; L < end; ++L) {
    if (ti != cur_ti) {  // a new row tile: its planes into registers
      fi = op.tf_a[ti];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = lane + 32 * q;
        const int64_t row = ti * tr + r;
        li[q] = -1;
#pragma unroll
        for (int p = 0; p < NB; ++p) a[q][p] = 0;
        if (r < tr) {
          const int si = op.seq_a[row];
          if (si >= 0 && row >= op.r_lo && row < op.r_hi) li[q] = si - fi;
#pragma unroll
          for (int p = 0; p < NB; ++p) a[q][p] = __ldg(op.xa + row * S + p);
        }
      }
      cur_ti = ti;
    }
    const int fj = op.tf_b[tj];
    int64_t ti2 = ti, tj2 = tj;
    if (L + 1 < end) {
      walk.next(L, ti2, tj2);
      prefetch(tj2, buf ^ 1);
    }

    // this warp's j rows: a quarter of the tile, within [c_lo, c_hi)
    const int64_t c0 = tj * tr;
    const int j0 = static_cast<int>(max(static_cast<int64_t>(32 * warp), op.c_lo - c0));
    const int j1 = static_cast<int>(min(static_cast<int64_t>(min(32 * warp + 32, tr)), op.c_hi - c0));
    const uint32_t* xs = sx[buf];
    const int* ss = sseq[buf];
    unsigned* bins = sbins + buf * cb * cb;
    unsigned acc[kRows] = {};
    int cur = -1;
    for (int j8 = j0; j8 < j1; j8 += kGroup) {
      // the group's sequence ids: one sequence's rows, then padding (-1)
      const int4 s_lo = *reinterpret_cast<const int4*>(ss + j8);
      const int4 s_hi = *reinterpret_cast<const int4*>(ss + j8 + 4);
      const int sj = s_lo.x;  // warp-uniform
      if (sj < 0) continue;   // a group of padding rows
      if (sj != cur) {
        if (cur >= 0) {
#pragma unroll
          for (int q = 0; q < kRows; ++q) flush(bins, cb, li[q], cur - fj, acc[q]);
        }
        cur = sj;
#pragma unroll
        for (int q = 0; q < kRows; ++q) acc[q] = 0;
      }
      const int sg[kGroup] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w, s_hi.x, s_hi.y, s_hi.z, s_hi.w};
      int d[kGroup][kRows];
      int dmin = 64;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const uint32_t pad = static_cast<uint32_t>(sg[u] >> 31);  // all ones on padding
        uint32_t b[S];
#pragma unroll
        for (int p = 0; p < S; p += 4) {
          const uint4 v = *reinterpret_cast<const uint4*>(xs + (j8 + u) * S + p);
          b[p] = v.x;
          b[p + 1] = v.y;
          b[p + 2] = v.z;
          b[p + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          uint32_t m = (a[q][0] ^ b[0]) | pad;
#pragma unroll
          for (int p = 1; p < NB; ++p) m |= a[q][p] ^ b[p];
          d[u][q] = __popc(m);
          dmin = min(dmin, d[u][q]);
        }
      }
      if (__any_sync(kFull, dmin <= gk)) {  // some pair of the warp weighs
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
#pragma unroll
          for (int q = 0; q < kRows; ++q) acc[q] += tbl[d[u][q]];
        }
      }
    }
    if (cur >= 0) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) flush(bins, cb, li[q], cur - fj, acc[q]);
    }
    cp_async_wait_all();
    __syncthreads();  // bins complete, the next tile landed

    land_bins<kLand>(bins, cb, fi, fj, target_of<kLand>(walk, land, L, ti, tj), land);
    ti = ti2;
    tj = tj2;
    buf ^= 1;
  }
}

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
// What bounds it: the integer work per row pair (W vcmpeq4 + popc, one
// shared table load), then the s1 writes. The design:
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

// Persistent blocks over a walk: as many as the card holds at once.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, int threads, size_t smem, int64_t total,
                              cudaStream_t st, Args... args) {
  if (total == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t blocks = std::min<int64_t>(total, static_cast<int64_t>(sms) * per_sm);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// Code planes a letter of an alphabet of alpha letters: ceil(log2 alpha).
int planes_of(int alpha) {
  int nb = 1;
  while ((1 << nb) < alpha) ++nb;
  return nb;
}

// The code-plane body over a walk: x holds w = plane_stride(nb) words a
// row; tiles of tr rows.
template <int kLand>
cudaError_t launch_bytes(const Operands& op, const Walk& walk, const Land& land, int w,
                         int g, int alpha, int tr, int cb, int k, cudaStream_t st) {
  const int nb = planes_of(alpha);
  if (alpha < 1 || alpha > 256 || w != plane_stride(nb) || g < 1 || g > 20 || k < 1 ||
      k > g || tr < kGroup || tr > kThreads || tr % kGroup || cb < 1 || op.c_lo % kGroup ||
      (op.c_hi != kAllRows && op.c_hi % kGroup)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = 2 * bins_bytes(cb);
  switch (nb) {
#define FASTSK_NB(N)                                                                 \
  case N:                                                                            \
    return launch_persistent(packed_bytes_kernel<N, kLand>, kThreads, smem, walk.total, \
                             st, op, walk, land, tr, cb, g, k);
    FASTSK_NB(1) FASTSK_NB(2) FASTSK_NB(3) FASTSK_NB(4)
    FASTSK_NB(5) FASTSK_NB(6) FASTSK_NB(7) FASTSK_NB(8)
#undef FASTSK_NB
    default:
      return cudaErrorInvalidValue;
  }
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

// Common arguments: x [R, w] int32, the code planes (w = plane_stride(
// ceil(log2 alpha)), ops/pairs_packed_cuda.py:PackedRows.planes), R a
// multiple of the tile; seq_of [R] int32 (-1 padding); tile_first [R / tr]
// int32, the first sequence of each tr-row tile (0 for a tile with no
// valid row; tr = 128 but for E); cb >= every tile's sequence span; 1 <= k
// <= g <= 20, alpha <= 256. Outputs are int64, zeroed by the caller; the
// kernels add into them.

// D: n_tiles 128-row tiles, the whole upper triangle; out [ld, ld].
extern "C" int packed_band_launch(const void* x, const void* seq_of,
                                  const void* tile_first, void* out,
                                  long long n_tiles, long long ld, int w,
                                  int g, int alpha, int cb, int k, void* stream) {
  return static_cast<int>(launch_bytes<kLandMatrix>(
      one_table(x, seq_of, tile_first), tri_walk(0, n_tiles, n_tiles), matrix_land(out, ld, 0, 1),
      w, g, alpha, kThreads, cb, k, static_cast<cudaStream_t>(stream)));
}

// F: rows [r_lo, r_hi) of table a (xa, seq_a, tf_a) against rows [c_lo,
// c_hi) of table b, landing at (si - row_off, sj) of out [*, ld]. tri 1:
// the triangle walk (table b is table a, c_lo is ignored and c_hi >= r_hi):
// the row tiles holding rows [r_lo, r_hi) against every tile from their
// own on that holds rows below c_hi, landing off the diagonal tile also at
// (sj - row_off, si). tri 0: the rectangle.
extern "C" int packed_block_launch(const void* xa, const void* seq_a,
                                   const void* tf_a, const void* xb,
                                   const void* seq_b, const void* tf_b,
                                   long long r_lo, long long r_hi,
                                   long long c_lo, long long c_hi, int tri,
                                   void* out, long long ld, long long row_off,
                                   int w, int g, int alpha, int cb, int k,
                                   void* stream) {
  if (r_lo >= r_hi || (tri ? c_hi < r_hi : c_lo >= c_hi)) {
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
  return static_cast<int>(launch_bytes<kLandMatrix>(op, walk, matrix_land(out, ld, row_off, tri),
                                                    w, g, alpha, kThreads, cb, k,
                                                    static_cast<cudaStream_t>(stream)));
}

// E: n_pairs slots of strip pairs (pa[s], pb[s]) in tiles of tr rows, tps
// a strip. parts 0: into out [*, ld], slot s also mirrored where pb[s] >
// pa[s]; parts 1: into part blocks out [n_pairs, c_pad, c_pad].
extern "C" int packed_pairlist_launch(const void* x, const void* seq_of,
                                      const void* tile_first,
                                      const void* first_seq, const void* pa,
                                      const void* pb, long long n_pairs,
                                      void* out, long long ld, int parts,
                                      int w, int g, int alpha, int tr, int tps,
                                      int cb, int k, int c_pad, void* stream) {
  if (n_pairs < 0 || tps < 1 || parts < 0 || parts > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operands op = one_table(x, seq_of, tile_first);
  const Walk walk = list_walk(static_cast<const int*>(pa), static_cast<const int*>(pb),
                              n_pairs, tps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (parts == 0) {
    return static_cast<int>(launch_bytes<kLandMatrix>(op, walk, matrix_land(out, ld, 0, 1), w,
                                                      g, alpha, tr, cb, k, st));
  }
  Land land{};
  land.out = static_cast<unsigned long long*>(out);
  land.fs_a = land.fs_b = static_cast<const int*>(first_seq);
  land.c_pad = c_pad;
  return static_cast<int>(
      launch_bytes<kLandParts>(op, walk, land, w, g, alpha, tr, cb, k, st));
}

// G: strip a against strips b0 .. b0 + n_b - 1 in 128-row tiles (tps a
// strip); out [n_b, c_pad, c_pad].
extern "C" int packed_grouped_launch(const void* x, const void* seq_of,
                                     const void* tile_first,
                                     const void* first_seq, int a, int b0,
                                     int n_b, void* out, int tps, int c_pad,
                                     int w, int g, int alpha, int cb, int k,
                                     void* stream) {
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
  return static_cast<int>(launch_bytes<kLandParts>(
      one_table(x, seq_of, tile_first), walk, land, w, g, alpha, kThreads, cb, k,
      static_cast<cudaStream_t>(stream)));
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
