// Kernel B: the whole C-SVC SMO loop in one launch.
//
// Replaces fastsk_tpu/svm/smo_pallas.py:_smo_kernel (called through
// smo_solve_fused). It solves
//
//     min 0.5 a^T Q a + p^T a,  0 <= a <= C,  y^T a = const
//
// from a feasible start (alpha0, grad0 = Q alpha0 + p) with LIBSVM's
// second-order working-set selection, the clipped analytic pair update
// and the stop gmax + gmax2 < eps, and returns (alpha, grad, iters). Its
// plain twin is svm/smo_cuda.py:smo_loop_plain; the two follow the same
// f32 trajectory:
//   - the operations and their order are the twin's (and
//     fastsk_tpu/svm/kernel_svm.py:_smo_solve_general's), built with
//     --fmad=false so no multiply-add is contracted;
//   - argmax / argmin ties go to the lowest index, as torch.argmax does;
//   - max and argmax are exact, so the reduction order does not matter.
//
// What bounds it on the H100: the serial dependency — every iteration
// needs a block-wide argmax before it can read row i, and an argmin over
// that row before it can read row j — and the two Q-row reads per
// iteration (Q is n x n f32, larger than L2 at n = 6k, so a row is one
// pass of 4n bytes from HBM). The design against that:
//   - one persistent block of 1024 threads runs every iteration; block
//     reductions (warp shuffles, then one warp over 32 partials) replace
//     a grid-wide sync, so nothing returns to the host between updates;
//   - alpha, grad, y, C and diag(Q) (20 n bytes) live in shared memory
//     while they fit (n <= 10240); beyond that the same code runs on
//     them in global memory, where they stay L2-resident;
//   - the rows are read straight from Q with coalesced loads.
// Fusing the gradient update with the next selection pass, and spreading
// the row reads over more SMs, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // 32 warps: one partial per lane below
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // the twin's _NEG_INF sentinel
constexpr float kTau = 1e-12f;
constexpr int kSmemVectors = 5;
constexpr int kSmemMaxN = 10240;  // 5 * 4 * 10240 = 200 KB of 227

template <bool kMax>
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  const bool better = kMax ? (ov > v || (ov == v && oi < i))
                           : (ov < v || (ov == v && oi < i));
  if (better) {
    v = ov;
    i = oi;
  }
}

// Block-wide (arg-best of v, max of w); every thread gets the result.
template <bool kMax>
__device__ void block_reduce(float& v, int& i, float& w, float* red_v,
                             int* red_i, float* red_w) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    take_better<kMax>(v, i, __shfl_xor_sync(kFull, v, off),
                      __shfl_xor_sync(kFull, i, off));
    w = fmaxf(w, __shfl_xor_sync(kFull, w, off));
  }
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
    red_w[warp] = w;
  }
  __syncthreads();
  v = red_v[lane];
  i = red_i[lane];
  w = red_w[lane];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    take_better<kMax>(v, i, __shfl_xor_sync(kFull, v, off),
                      __shfl_xor_sync(kFull, i, off));
    w = fmaxf(w, __shfl_xor_sync(kFull, w, off));
  }
  __syncthreads();  // partials may be overwritten by the next reduction
}

__global__ void __launch_bounds__(kThreads, 1)
smo_kernel(const float* __restrict__ Q, const float* y_g, const float* c_g,
           const float* qd_g, const float* a0, const float* g0,
           float* a_out, float* g_out, int* iters_out, int n, float eps,
           int max_iter, int use_smem) {
  extern __shared__ float sm[];
  __shared__ float red_v[32], red_w[32];
  __shared__ int red_i[32];
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  const float* y = y_g;
  const float* C = c_g;
  const float* qd = qd_g;
  float* alpha = a_out;
  float* grad = g_out;
  if (use_smem) {
    float* sy = sm;
    float* sc = sm + n;
    float* sq = sm + 2 * n;
    for (int t = tid; t < n; t += kThreads) {
      sy[t] = y_g[t];
      sc[t] = c_g[t];
      sq[t] = qd_g[t];
    }
    y = sy;
    C = sc;
    qd = sq;
    alpha = sm + 3 * n;
    grad = sm + 4 * n;
  }
  for (int t = tid; t < n; t += kThreads) {
    alpha[t] = a0[t];
    grad[t] = g0[t];
  }
  __syncthreads();

  int it = 0;
  float viol = inf;
  while (it < max_iter && viol >= eps) {
    // i = argmax over I_up of -y*G; gmax2 = max over I_low of y*G
    float gmax = -inf, gmax2 = -inf;
    int i = 0x7fffffff;
    for (int t = tid; t < n; t += kThreads) {
      const float yt = y[t], at = alpha[t], ct = C[t];
      const bool pos = yt > 0.0f;
      const bool up = pos ? (at < ct) : (at > 0.0f);
      const bool low = pos ? (at > 0.0f) : (at < ct);
      const float minus_yg = -yt * grad[t];
      const float su = up ? minus_yg : kNegInf;
      if (su > gmax) {
        gmax = su;
        i = t;
      }
      gmax2 = fmaxf(gmax2, low ? -minus_yg : kNegInf);
    }
    block_reduce<true>(gmax, i, gmax2, red_v, red_i, red_w);

    // j = second-order argmin over I_low with b > 0
    const float* row_i = Q + static_cast<size_t>(i) * n;
    const float yi = y[i], qdi = qd[i];
    float best = inf, unused = -inf;
    int j = 0x7fffffff;
    for (int t = tid; t < n; t += kThreads) {
      const float yt = y[t], at = alpha[t], ct = C[t];
      const bool pos = yt > 0.0f;
      const bool low = pos ? (at > 0.0f) : (at < ct);
      const float b = gmax + yt * grad[t];
      float a_coef = (qdi + qd[t]) - ((2.0f * yi) * yt) * row_i[t];
      a_coef = a_coef <= 0.0f ? kTau : a_coef;
      const float obj_diff = -(b * b) / a_coef;
      const float sc = (low && b > 0.0f) ? obj_diff : -kNegInf;
      if (sc < best) {
        best = sc;
        j = t;
      }
    }
    block_reduce<false>(best, j, unused, red_v, red_i, red_w);

    // clipped analytic pair update (every thread computes the scalars)
    const float* row_j = Q + static_cast<size_t>(j) * n;
    const float yj = y[j], qdj = qd[j], qij = row_i[j];
    float quad = (qdi + qdj) - ((2.0f * yi) * yj) * qij;
    quad = quad <= 0.0f ? kTau : quad;
    const float ai = alpha[i], aj = alpha[j];
    const float gi = grad[i], gj = grad[j];
    const float ci = C[i], cj = C[j];
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
    __syncthreads();  // every thread has read alpha/grad at i and j

    for (int t = tid; t < n; t += kThreads) {
      grad[t] = (grad[t] + row_i[t] * dai) + row_j[t] * daj;
    }
    if (tid == 0) {
      alpha[i] = new_ai;
      alpha[j] = new_aj;  // j last, as the twin's .at[i].set().at[j].set()
    }
    __syncthreads();
    ++it;
    viol = gmax + gmax2;
  }

  if (use_smem) {
    for (int t = tid; t < n; t += kThreads) {
      a_out[t] = alpha[t];
      g_out[t] = grad[t];
    }
  }
  if (tid == 0) iters_out[0] = it;
}

}  // namespace

// Q: [n, n] f32 row-major; y, C, qd, alpha0, grad0: [n] f32;
// alpha, grad: [n] f32 out; iters: [1] int32 out.
extern "C" int smo_solve_launch(const void* Q, const void* y, const void* C,
                                const void* qd, const void* alpha0,
                                const void* grad0, void* alpha, void* grad,
                                void* iters, int n, float eps, int max_iter,
                                void* stream) {
  const int use_smem = n <= kSmemMaxN;
  const size_t smem =
      use_smem ? static_cast<size_t>(kSmemVectors) * n * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      smo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  smo_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Q), static_cast<const float*>(y),
      static_cast<const float*>(C), static_cast<const float*>(qd),
      static_cast<const float*>(alpha0), static_cast<const float*>(grad0),
      static_cast<float*>(alpha), static_cast<float*>(grad),
      static_cast<int*>(iters), n, eps, max_iter, use_smem);
  return static_cast<int>(cudaGetLastError());
}
