// Kernels B and C: the whole SMO loop in one launch.
//
// Kernel B replaces fastsk_tpu/svm/smo_pallas.py:_smo_kernel (called
// through smo_solve_fused), LIBSVM's Solver::Solve. It solves
//
//     min 0.5 a^T Q a + p^T a,  0 <= a <= C,  y^T a = const
//
// from a feasible start (alpha0, grad0 = Q alpha0 + p) with LIBSVM's
// second-order working-set selection, the clipped analytic pair update
// and the stop gmax + gmax2 < eps, and returns (alpha, grad, iters); one
// launch solves a batch of such problems over one Q (the Platt folds,
// which differ only in C and alpha0). Kernel C replaces
// smo_pallas.py:_smo_nu_kernel (smo_solve_nu_fused), LIBSVM's Solver_NU:
// the same problem with the sum of alpha conserved in each class
// separately, so the pair is chosen within a class (see
// smo_nu_cluster_kernel below). Their plain twins are svm/smo_cuda.py:
// smo_loop_plain and smo_nu_loop_plain; each kernel follows its twin's
// f32 trajectory:
//   - the operations and their order are the twin's (and
//     fastsk_tpu/svm/kernel_svm.py:_smo_solve_general's / _smo_solve_nu's),
//     built with --fmad=false so no multiply-add is contracted;
//   - argmax / argmin ties go to the lowest index, as torch.argmax does;
//     an empty candidate set (every score -1e30) therefore gives index 0,
//     never the reductions' 0x7fffffff start value, which only threads
//     without a row hold (their -inf loses to any row's -1e30);
//   - max and argmax are exact, so the reduction order does not matter.
//
// What bounds kernel B on the H100 is the serial chain of one iteration:
// two reductions over all n rows (the I_up/I_low argmax, then the
// second-order argmin, which needs the argmax's row i), each ending in a
// cluster barrier, and two dependent row-slice loads from HBM (row i for
// the j scan, row j for the gradient update; Q is n x n f32, larger than
// L2 at n = 6k). The design against that:
//   - one thread-block cluster of cs CTAs (cs = 16, non-portable, or 8)
//     owns one problem; CTA r holds the contiguous slice [r*sl, r*sl + sl)
//     of alpha, grad, y, C, diag(Q) and the current row i (6 floats a row,
//     ceil(n / cs) rows) in its shared memory, so a row read is spread over
//     cs SMs instead of one;
//   - a reduction goes warp -> CTA -> cluster: warp 0 of each CTA stores
//     the CTA's partial into slot [rank] of every CTA of the cluster
//     (distributed shared memory), one barrier.cluster arrive/wait, then
//     every warp reduces the cs partials itself, one a lane; each warp
//     reduction is three redux.sync on order-preserving integer keys of
//     the scores (ties to the lowest index) instead of shuffle rounds;
//   - the winning partial carries the winner's state (alpha, grad, y, C,
//     diag(Q), and for j also Q[i, j], which j's owner loaded in its j
//     scan), so the pair update needs no third barrier;
//   - the two reductions of an iteration use two slot sets: a CTA writes
//     a set again only after the other set's barrier, which every CTA
//     passes only after reading the first; two cluster barriers an
//     iteration are all the synchronisation there is;
//   - iteration t's gradient update and iteration t+1's I_up/I_low scan
//     are one pass over the slice, and row i's slice stays in shared
//     memory from the j scan to the update, so row i is read once an
//     iteration and row j once;
//   - b problems over one Q run as b clusters of one launch.
// The state stays in shared memory while 24 * ceil(n / cs) bytes fit in
// 220 KB: every n up to 150,000 at cs = 16 (Q would need 90 GB), up to
// 75,000 at cs = 8. Past that the same code runs on global vectors (only
// cs < 16 at such n, or the tests' cs = 1 past 9,386 rows).
//
// Kernel C (smo_nu_cluster_kernel) carries the same design to Solver_NU,
// whose iteration is wider: the first reduction is two arg-maxes (ip over
// upP, in over upN) and two maxes (gmaxp2, gmaxn2), carrying both winners'
// state; the j scan reads two rows, Q[ip] and Q[in] (both loads in flight,
// both slices kept in shared memory: 7 floats a row, about 22 KB a CTA at
// 2n = 12,636 and cs = 16), and j's owner carries Q[ip, j] or Q[in, j]
// by j's class; the update reads row i's resident slice and one load of
// row j, fused with the next iteration's class-wise scan. Two cluster
// barriers an iteration, as in B. Past 220 KB a slice it runs on global
// vectors too.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // the twin's _NEG_INF sentinel
constexpr float kTau = 1e-12f;
constexpr int kNoRow = 0x7fffffff;

// ------------------------------------------------------------- kernel B

constexpr int kBThreads = 512;  // 16 warps a CTA
constexpr int kBWarps = kBThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kBVectors = 6;  // y, C, diag(Q), alpha, grad, row i
constexpr int kCVectors = 7;  // ... and kernel C's second row (Q[ip], Q[in])
constexpr size_t kBSmemMax = 220 * 1024;

__host__ __device__ int b_slice(int n, int cs) { return (n + cs - 1) / cs; }

// Whether `vectors` floats a row of an n-row problem's slice fit in one
// CTA's shared memory at cs CTAs a problem.
bool b_smem(int n, int cs, int vectors = kBVectors) {
  return static_cast<size_t>(vectors) * b_slice(n, cs) * sizeof(float) <=
         kBSmemMax;
}

// One CTA's reduction result as it lands in every CTA of the cluster: the
// arg-best (v, i), the max w, and the state of row i.
struct Part {
  float v;
  int i;
  float w;
  float a, g, y, c, q, r;  // alpha, grad, y, C, diag(Q), Q[i_sel, i]
};

// A CTA's view of its slice, indexed by the global row t in [lo, hi).
struct Slice {
  const float* y;
  const float* C;
  const float* qd;
  float* alpha;
  float* grad;
  float* row;  // Q[i, t] of the current i, from the j scan (C: Q[ip, t])
  float* row_n;  // kernel C: Q[in, t]; null in kernel B
};

// A float's bits as an unsigned key of the same order (-0 first made
// +0, which compares equal to it, so that equal scores tie on the index).
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Warp-wide (arg-best of v, lowest index on ties; max of w) in three
// redux.sync instructions; every lane gets the result.
template <bool kMax>
__device__ __forceinline__ void warp_best(float& v, int& i, float& w) {
  const unsigned key = ordered(v);
  const unsigned best = kMax ? __reduce_max_sync(kFull, key) : __reduce_min_sync(kFull, key);
  i = __reduce_min_sync(kFull, key == best ? i : kNoRow);
  v = unordered(best);
  w = unordered(__reduce_max_sync(kFull, ordered(w)));
}

// Cluster-wide (arg-best of v, max of w) with the winner's state; every
// thread of every CTA passes its own values and gets the result. `slot`
// is this reduction's set of kMaxCluster partials.
template <bool kMax>
__device__ Part cluster_best(cg::cluster_group& cl, int cs, float v,
                             int i, float w, const Slice& s, bool with_row,
                             Part* slot, float* red_v, int* red_i,
                             float* red_w) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  warp_best<kMax>(v, i, w);
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
    red_w[warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < kBWarps;
    v = has ? red_v[lane] : (kMax ? -inf : inf);
    i = has ? red_i[lane] : kNoRow;
    w = has ? red_w[lane] : -inf;
    warp_best<kMax>(v, i, w);
    if (lane < cs) {
      Part p{v, i, w, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (i != kNoRow) {  // a row of this CTA's slice
        p.a = s.alpha[i];
        p.g = s.grad[i];
        p.y = s.y[i];
        p.c = s.C[i];
        p.q = s.qd[i];
        if (with_row) p.r = (s.row_n && p.y < 0.0f) ? s.row_n[i] : s.row[i];
      }
      *cl.map_shared_rank(slot + cl.block_rank(), lane) = p;
    }
  }
  cl.sync();
  // every warp reduces the cs partials itself, lane r holding partial r;
  // the slices are disjoint, so the winning index names one partial
  const bool has = lane < cs;
  const int own = has ? slot[lane].i : kNoRow;
  v = has ? slot[lane].v : (kMax ? -inf : inf);
  i = own;
  w = has ? slot[lane].w : -inf;
  warp_best<kMax>(v, i, w);
  const unsigned hit = __ballot_sync(kFull, has && own == i);
  Part out = slot[hit ? __ffs(hit) - 1 : 0];
  out.w = w;
  return out;
}

// Problem blockIdx.x / cs; y, diag(Q) [n] shared by the batch; C, alpha0,
// grad0, alpha, grad, row [batch, n]; iters [batch].
__global__ void __launch_bounds__(kBThreads, 1)
smo_cluster_kernel(const float* __restrict__ Q, const float* y_g,
                   const float* c_g, const float* qd_g, const float* a0,
                   const float* g0, float* a_out, float* g_out, float* row_g,
                   int* iters_out, int n, float eps, int max_iter,
                   int use_smem) {
  extern __shared__ float sm[];
  __shared__ Part slots[2][kMaxCluster];
  __shared__ float red_v[kBWarps], red_w[kBWarps];
  __shared__ int red_i[kBWarps];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int prob = blockIdx.x / cs;
  const int sl = b_slice(n, cs);
  const int lo = min(n, rank * sl), hi = min(n, lo + sl);
  const size_t off = static_cast<size_t>(prob) * n;
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  Slice s;
  if (use_smem) {  // the slice's vectors at sm + v * sl, indexed by t - lo
    float* sy = sm - lo;
    float* sc = sm + sl - lo;
    float* sq = sm + 2 * sl - lo;
    for (int t = lo + tid; t < hi; t += kBThreads) {
      sy[t] = y_g[t];
      sc[t] = c_g[off + t];
      sq[t] = qd_g[t];
    }
    s = {sy, sc, sq, sm + 3 * sl - lo, sm + 4 * sl - lo, sm + 5 * sl - lo, nullptr};
  } else {
    s = {y_g, c_g + off, qd_g, a_out + off, g_out + off, row_g + off, nullptr};
  }
  for (int t = lo + tid; t < hi; t += kBThreads) {
    s.alpha[t] = a0[off + t];
    s.grad[t] = g0[off + t];
  }

  // i = argmax over I_up of -y*G; gmax2 = max over I_low of y*G
  float gmax = -inf, gmax2 = -inf;
  int ii = kNoRow;
  auto scan = [&](int t, float at, float gt) {
    const float yt = s.y[t], ct = s.C[t];
    const bool pos = yt > 0.0f;
    const bool up = pos ? (at < ct) : (at > 0.0f);
    const bool low = pos ? (at > 0.0f) : (at < ct);
    const float minus_yg = -yt * gt;
    const float su = up ? minus_yg : kNegInf;
    if (su > gmax) {
      gmax = su;
      ii = t;
    }
    gmax2 = fmaxf(gmax2, low ? -minus_yg : kNegInf);
  };
  for (int t = lo + tid; t < hi; t += kBThreads) scan(t, s.alpha[t], s.grad[t]);
  Part pi = cluster_best<true>(cl, cs, gmax, ii, gmax2, s, false, slots[0],
                               red_v, red_i, red_w);

  int it = 0;
  bool more = max_iter > 0;  // the twin's viol starts at +inf
  while (more) {
    // j = second-order argmin over I_low with b > 0; row i's slice kept
    const int i = pi.i;
    const float* row_i = Q + static_cast<size_t>(i) * n;
    const float yi = pi.y, qdi = pi.q;
    float best = inf, unused = -inf;
    int jj = kNoRow;
#pragma unroll 4
    for (int t = lo + tid; t < hi; t += kBThreads) {
      const float rt = row_i[t];
      s.row[t] = rt;
      const float yt = s.y[t], at = s.alpha[t], ct = s.C[t];
      const bool pos = yt > 0.0f;
      const bool low = pos ? (at > 0.0f) : (at < ct);
      const float b = pi.v + yt * s.grad[t];
      float a_coef = (qdi + s.qd[t]) - ((2.0f * yi) * yt) * rt;
      a_coef = a_coef <= 0.0f ? kTau : a_coef;
      const float obj_diff = -(b * b) / a_coef;
      const float sc = (low && b > 0.0f) ? obj_diff : -kNegInf;
      if (sc < best) {
        best = sc;
        jj = t;
      }
    }
    const Part pj = cluster_best<false>(cl, cs, best, jj, unused, s, true,
                                        slots[1], red_v, red_i, red_w);

    // clipped analytic pair update (every thread computes the scalars)
    const int j = pj.i;
    const float yj = pj.y, qdj = pj.q, qij = pj.r;
    float quad = (qdi + qdj) - ((2.0f * yi) * yj) * qij;
    quad = quad <= 0.0f ? kTau : quad;
    const float ai = pi.a, aj = pj.a;
    const float gi = pi.g, gj = pj.g;
    const float ci = pi.c, cj = pj.c;
    const bool same = yi == yj;
    const float delta_eq = (gi - gj) / quad;
    const float delta_neq = (-gi - gj) / quad;
    float new_ai = same ? ai - delta_eq : ai + delta_neq;
    const float s_term = same ? ai + aj : ai - aj;
    const float lo_i = same ? fmaxf(0.0f, s_term - cj) : fmaxf(0.0f, s_term);
    const float hi_i = same ? fminf(ci, s_term) : fminf(ci, cj + s_term);
    new_ai = fminf(fmaxf(new_ai, lo_i), hi_i);
    const float new_aj = same ? s_term - new_ai : new_ai - s_term;
    const float dai = new_ai - ai;
    const float daj = new_aj - aj;
    ++it;
    more = it < max_iter && pi.v + pi.w >= eps;

    // this update and the next iteration's I_up/I_low scan in one pass
    const float* row_j = Q + static_cast<size_t>(j) * n;
    gmax = -inf;
    gmax2 = -inf;
    ii = kNoRow;
#pragma unroll 4
    for (int t = lo + tid; t < hi; t += kBThreads) {
      const float gt = (s.grad[t] + s.row[t] * dai) + row_j[t] * daj;
      s.grad[t] = gt;
      float at = s.alpha[t];
      if (t == i) at = new_ai;
      if (t == j) at = new_aj;  // j last, as the twin's .at[i].set().at[j].set()
      if (t == i || t == j) s.alpha[t] = at;
      if (more) scan(t, at, gt);
    }
    if (more) {
      pi = cluster_best<true>(cl, cs, gmax, ii, gmax2, s, false, slots[0],
                              red_v, red_i, red_w);
    }
  }

  if (use_smem) {
    for (int t = lo + tid; t < hi; t += kBThreads) {
      a_out[off + t] = s.alpha[t];
      g_out[off + t] = s.grad[t];
    }
  }
  if (rank == 0 && tid == 0) iters_out[prob] = it;
  cl.sync();  // no CTA leaves while another may still address its slots
}

// ------------------------------------------------------------- kernel C

// The first reduction of Solver_NU as it lands in every CTA: the arg-maxes
// (vp, ip) over upP and (vn, in) over upN, the maxes wp (gmaxp2) and wn
// (gmaxn2), and both winners' alpha, grad, C and diag(Q).
struct NuPart {
  float vp;
  int ip;
  float vn;
  int in;
  float wp, wn;
  float ap, gp, cp, qp, an, gn, cn, qn;
};

// Cluster-wide NuPart of every thread's (vp, ip, wp) and (vn, in, wn), as
// cluster_best: warp -> CTA (red*) -> cluster (slot, one barrier).
__device__ NuPart cluster_best_nu(cg::cluster_group& cl, int cs, float vp,
                                  int ip, float wp, float vn, int in,
                                  float wn, const Slice& s, NuPart* slot,
                                  float* red_v, int* red_i, float* red_w) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  warp_best<true>(vp, ip, wp);
  warp_best<true>(vn, in, wn);
  if (lane == 0) {
    red_v[warp] = vp;
    red_i[warp] = ip;
    red_w[warp] = wp;
    red_v[kBWarps + warp] = vn;
    red_i[kBWarps + warp] = in;
    red_w[kBWarps + warp] = wn;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < kBWarps;
    vp = has ? red_v[lane] : -inf;
    ip = has ? red_i[lane] : kNoRow;
    wp = has ? red_w[lane] : -inf;
    vn = has ? red_v[kBWarps + lane] : -inf;
    in = has ? red_i[kBWarps + lane] : kNoRow;
    wn = has ? red_w[kBWarps + lane] : -inf;
    warp_best<true>(vp, ip, wp);
    warp_best<true>(vn, in, wn);
    if (lane < cs) {
      NuPart p{vp, ip, vn, in, wp, wn, 0.0f, 0.0f, 0.0f, 0.0f,
               0.0f, 0.0f, 0.0f, 0.0f};
      if (ip != kNoRow) {  // rows of this CTA's slice
        p.ap = s.alpha[ip];
        p.gp = s.grad[ip];
        p.cp = s.C[ip];
        p.qp = s.qd[ip];
      }
      if (in != kNoRow) {
        p.an = s.alpha[in];
        p.gn = s.grad[in];
        p.cn = s.C[in];
        p.qn = s.qd[in];
      }
      *cl.map_shared_rank(slot + cl.block_rank(), lane) = p;
    }
  }
  cl.sync();
  const bool has = lane < cs;
  const int own_p = has ? slot[lane].ip : kNoRow;
  const int own_n = has ? slot[lane].in : kNoRow;
  vp = has ? slot[lane].vp : -inf;
  ip = own_p;
  wp = has ? slot[lane].wp : -inf;
  vn = has ? slot[lane].vn : -inf;
  in = own_n;
  wn = has ? slot[lane].wn : -inf;
  warp_best<true>(vp, ip, wp);
  warp_best<true>(vn, in, wn);
  const unsigned hp = __ballot_sync(kFull, has && own_p == ip);
  const unsigned hn = __ballot_sync(kFull, has && own_n == in);
  const NuPart& wp_part = slot[hp ? __ffs(hp) - 1 : 0];
  const NuPart& wn_part = slot[hn ? __ffs(hn) - 1 : 0];
  return NuPart{vp, ip, vn, in, wp, wn,
                wp_part.ap, wp_part.gp, wp_part.cp, wp_part.qp,
                wn_part.an, wn_part.gn, wn_part.cn, wn_part.qn};
}

// Kernel C, Solver_NU (svm.cpp:1029-1285), one cluster of cs CTAs. Per
// iteration: ip = argmax of -G over upP = {y=+1, a<C}, in = argmax of +G
// over upN = {y=-1, a>0}, gmaxp2 / gmaxn2 = max of G over lowP / of -G
// over lowN; then j = the global second-order argmin across both classes,
// with the ip row scoring the positive candidates and the in row the
// negative ones; i is ip or in by j's class, and the same-class pair
// update conserves a_i + a_j. y, C, diag(Q), alpha0, grad0, alpha, grad
// [n]; rows [2, n] scratch (read only where the slices leave shared
// memory); iters [1].
__global__ void __launch_bounds__(kBThreads, 1)
smo_nu_cluster_kernel(const float* __restrict__ Q, const float* y_g,
                      const float* c_g, const float* qd_g, const float* a0,
                      const float* g0, float* a_out, float* g_out,
                      float* rows_g, int* iters_out, int n, float eps,
                      int max_iter, int use_smem) {
  extern __shared__ float sm[];
  __shared__ NuPart slots_i[kMaxCluster];
  __shared__ Part slots_j[kMaxCluster];
  __shared__ float red_v[2 * kBWarps], red_w[2 * kBWarps];
  __shared__ int red_i[2 * kBWarps];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int sl = b_slice(n, cs);
  const int lo = min(n, rank * sl), hi = min(n, lo + sl);
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  Slice s;
  if (use_smem) {  // the slice's vectors at sm + v * sl, indexed by t - lo
    float* sy = sm - lo;
    float* sc = sm + sl - lo;
    float* sq = sm + 2 * sl - lo;
    for (int t = lo + tid; t < hi; t += kBThreads) {
      sy[t] = y_g[t];
      sc[t] = c_g[t];
      sq[t] = qd_g[t];
    }
    s = {sy, sc, sq, sm + 3 * sl - lo, sm + 4 * sl - lo, sm + 5 * sl - lo,
         sm + 6 * sl - lo};
  } else {
    s = {y_g, c_g, qd_g, a_out, g_out, rows_g, rows_g + n};
  }
  for (int t = lo + tid; t < hi; t += kBThreads) {
    s.alpha[t] = a0[t];
    s.grad[t] = g0[t];
  }

  // the class-wise I_up arg-maxes and I_low maxima of one row
  float gmaxp, gmaxn, gmaxp2, gmaxn2;
  int ip, in;
  auto reset = [&]() {
    gmaxp = gmaxn = gmaxp2 = gmaxn2 = -inf;
    ip = in = kNoRow;
  };
  auto scan = [&](int t, float at, float gt) {
    const float yt = s.y[t], ct = s.C[t];
    const bool pos = yt > 0.0f, neg = yt < 0.0f;
    const float sp = (pos && at < ct) ? -gt : kNegInf;
    if (sp > gmaxp) {
      gmaxp = sp;
      ip = t;
    }
    const float sn = (neg && at > 0.0f) ? gt : kNegInf;
    if (sn > gmaxn) {
      gmaxn = sn;
      in = t;
    }
    gmaxp2 = fmaxf(gmaxp2, (pos && at > 0.0f) ? gt : kNegInf);
    gmaxn2 = fmaxf(gmaxn2, (neg && at < ct) ? -gt : kNegInf);
  };
  reset();
  for (int t = lo + tid; t < hi; t += kBThreads) scan(t, s.alpha[t], s.grad[t]);
  NuPart pi = cluster_best_nu(cl, cs, gmaxp, ip, gmaxp2, gmaxn, in, gmaxn2,
                              s, slots_i, red_v, red_i, red_w);

  int it = 0;
  bool more = max_iter > 0;  // the twin's viol starts at +inf
  while (more) {
    // j = second-order argmin over lowP with bP > 0 and lowN with bN > 0;
    // both rows' slices kept for the update
    const float* row_p = Q + static_cast<size_t>(pi.ip) * n;
    const float* row_n = Q + static_cast<size_t>(pi.in) * n;
    const float qdp = pi.qp, qdn = pi.qn;
    float best = inf, unused = -inf;
    int jj = kNoRow;
#pragma unroll 4
    for (int t = lo + tid; t < hi; t += kBThreads) {
      const float rp = row_p[t];  // two independent loads, both in flight
      const float rn = row_n[t];
      s.row[t] = rp;
      s.row_n[t] = rn;
      const float yt = s.y[t], at = s.alpha[t], ct = s.C[t], gt = s.grad[t];
      const float bP = pi.vp + gt;
      const float bN = pi.vn - gt;
      float sc = -kNegInf;
      if (yt > 0.0f && at > 0.0f && bP > 0.0f) {
        const float aP = (qdp + s.qd[t]) - 2.0f * rp;
        sc = -(bP * bP) / fmaxf(aP, kTau);
      } else if (yt < 0.0f && at < ct && bN > 0.0f) {
        const float aN = (qdn + s.qd[t]) - 2.0f * rn;
        sc = -(bN * bN) / fmaxf(aN, kTau);
      }
      if (sc < best) {
        best = sc;
        jj = t;
      }
    }
    const Part pj = cluster_best<false>(cl, cs, best, jj, unused, s, true,
                                        slots_j, red_v, red_i, red_w);

    // same-class clipped pair update (every thread computes the scalars)
    const int j = pj.i;
    const bool j_pos = pj.y > 0.0f;
    const int i = j_pos ? pi.ip : pi.in;
    const float qdi = j_pos ? qdp : qdn, qdj = pj.q, qij = pj.r;
    float quad = (qdi + qdj) - 2.0f * qij;
    quad = quad <= 0.0f ? kTau : quad;
    const float ai = j_pos ? pi.ap : pi.an, aj = pj.a;
    const float gi = j_pos ? pi.gp : pi.gn, gj = pj.g;
    const float ci = j_pos ? pi.cp : pi.cn, cj = pj.c;
    const float delta = (gi - gj) / quad;
    const float s_term = ai + aj;
    const float lo_i = fmaxf(0.0f, s_term - cj);
    const float hi_i = fminf(ci, s_term);
    const float new_ai = fminf(fmaxf(ai - delta, lo_i), hi_i);
    const float new_aj = s_term - new_ai;
    const float dai = new_ai - ai;
    const float daj = new_aj - aj;
    ++it;
    more = it < max_iter &&
           fmaxf(pi.vp + pi.wp, pi.vn + pi.wn) >= eps;

    // this update and the next iteration's class-wise scan in one pass
    const float* row_i = j_pos ? s.row : s.row_n;
    const float* row_j = Q + static_cast<size_t>(j) * n;
    reset();
#pragma unroll 4
    for (int t = lo + tid; t < hi; t += kBThreads) {
      const float gt = (s.grad[t] + row_i[t] * dai) + row_j[t] * daj;
      s.grad[t] = gt;
      float at = s.alpha[t];
      if (t == i) at = new_ai;
      if (t == j) at = new_aj;  // j last, as the twin's alpha[i] = ...; alpha[j] = ...
      if (t == i || t == j) s.alpha[t] = at;
      if (more) scan(t, at, gt);
    }
    if (more) {
      pi = cluster_best_nu(cl, cs, gmaxp, ip, gmaxp2, gmaxn, in, gmaxn2, s,
                           slots_i, red_v, red_i, red_w);
    }
  }

  if (use_smem) {
    for (int t = lo + tid; t < hi; t += kBThreads) {
      a_out[t] = s.alpha[t];
      g_out[t] = s.grad[t];
    }
  }
  if (rank == 0 && tid == 0) iters_out[0] = it;
  cl.sync();  // no CTA leaves while another may still address its slots
}

// One launch of a cluster kernel: `problems` clusters of `cluster` CTAs
// with `smem` dynamic shared bytes; refuses a cluster size the card
// cannot hold.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int problems,
                            int cluster, size_t smem, cudaStream_t stream,
                            Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(problems * cluster));
  cfg.blockDim = dim3(kBThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;  // clusters of this size the card can hold at once
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Kernel B. Q: [n, n] f32 row-major; y, qd: [n] f32; C, alpha0, grad0:
// [batch, n] f32; alpha, grad: [batch, n] f32 out; row: [batch, n] f32
// scratch (read only where the slices leave shared memory); iters:
// [batch] int32 out. cluster: CTAs a problem, 1 to 16.
extern "C" int smo_solve_launch(const void* Q, const void* y, const void* C,
                                const void* qd, const void* alpha0,
                                const void* grad0, void* alpha, void* grad,
                                void* row, void* iters, int n, int batch,
                                float eps, int max_iter, int cluster,
                                void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || batch < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int use_smem = b_smem(n, cluster);
  const size_t smem = use_smem ? static_cast<size_t>(kBVectors) *
                                     b_slice(n, cluster) * sizeof(float)
                               : 0;
  return static_cast<int>(launch_clusters(
      smo_cluster_kernel, batch, cluster, smem,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(Q),
      static_cast<const float*>(y), static_cast<const float*>(C),
      static_cast<const float*>(qd), static_cast<const float*>(alpha0),
      static_cast<const float*>(grad0), static_cast<float*>(alpha),
      static_cast<float*>(grad), static_cast<float*>(row),
      static_cast<int*>(iters), n, eps, max_iter, use_smem));
}

// 1 if kernel B (solver 0) or C (solver 1) keeps an n-row problem's
// slices in shared memory at this cluster size, else 0.
extern "C" int smo_solve_smem(int n, int cluster, int solver) {
  return cluster >= 1 && b_smem(n, cluster, solver ? kCVectors : kBVectors)
             ? 1 : 0;
}

// Kernel C. Q: [n, n] f32 row-major; y, C, qd, alpha0, grad0: [n] f32;
// alpha, grad: [n] f32 out; rows: [2, n] f32 scratch; iters: [1] int32
// out; alpha0 must be feasible for both class sums. cluster: CTAs, 1 to
// 16.
extern "C" int smo_nu_solve_launch(const void* Q, const void* y,
                                   const void* C, const void* qd,
                                   const void* alpha0, const void* grad0,
                                   void* alpha, void* grad, void* rows,
                                   void* iters, int n, float eps,
                                   int max_iter, int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int use_smem = b_smem(n, cluster, kCVectors);
  const size_t smem = use_smem ? static_cast<size_t>(kCVectors) *
                                     b_slice(n, cluster) * sizeof(float)
                               : 0;
  return static_cast<int>(launch_clusters(
      smo_nu_cluster_kernel, 1, cluster, smem,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(Q),
      static_cast<const float*>(y), static_cast<const float*>(C),
      static_cast<const float*>(qd), static_cast<const float*>(alpha0),
      static_cast<const float*>(grad0), static_cast<float*>(alpha),
      static_cast<float*>(grad), static_cast<float*>(rows),
      static_cast<int*>(iters), n, eps, max_iter, use_smem));
}
