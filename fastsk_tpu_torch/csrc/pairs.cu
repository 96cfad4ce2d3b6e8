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
// int8 tensor-core products (mma / wgmma) are later work.
//
// Kernel H: variants of kernel A's body that attribute its cost (replace
// experiments/probe_pairs.py:make_kernel, keeping its variant names). Each
// runs A's grid, tiles and writes and differs only in the per-pair work:
//   noop      tile set-up and the output writes only (zeros);
//   matmul    the __dp4a match counts only, summed into one per-thread
//             value so they stay live, landed once per thread at the
//             tile's corner entry (no per-item sums);
//   skeleton  w = d with A's sums: K = S S^T, S_i = sum_p x_ip;
//   current   kernel A itself (the C(d, k) table);
//   int32     C(d, k) as the falling-factorial chain in int32, divided
//             exactly by k! once per RI pairs, in place of the table.
// A's own entry point instantiates `current` only, so its code is the
// same; the probe's entry point instantiates the widths of its shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Variant : int { kNoop = 0, kMatmul = 1, kSkeleton = 2, kCurrent = 3, kInt32 = 4 };

// d (d - 1) ... (d - k + 1) in int32 with balanced factor pairing, as
// fastsk_tpu/ops/pairs_pallas.py:ffact_pairing_i32: 0 for 0 <= d < k.
__device__ __forceinline__ int ffact_i32(int d, int k) {
  if (k == 1) return d;
  const int t = d * (d - (k - 1));
  int prod = t;
  for (int i = 1; i < k / 2; ++i) prod *= t + i * (k - 1 - i);
  if (k & 1) prod *= d - (k - 1) / 2;
  return prod;
}

template <int W, int RI, int V = kCurrent>
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
  const int n_items = V == kNoop ? 0 : n_groups * s;
  const uint32_t* xi_g = x + static_cast<size_t>(bi) * tile_rows * W;
  int kfact = 1;
  if constexpr (V == kInt32)
    for (int j = 2; j <= k; ++j) kfact *= j;
  uint32_t fold = 0;
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
      if constexpr (V == kCurrent) {
#pragma unroll
        for (int r = 0; r < RI; ++r) sum += tbl[d[r]];
      } else if constexpr (V == kInt32) {
        int f = 0;  // RI falling factorials < 2^31 (the wrapper's guard)
#pragma unroll
        for (int r = 0; r < RI; ++r) f += ffact_i32(static_cast<int>(d[r]), k);
        sum += f / kfact;
      } else {  // matmul, skeleton: w = d
#pragma unroll
        for (int r = 0; r < RI; ++r) sum += static_cast<int32_t>(d[r]);
      }
    }
    if constexpr (V == kMatmul)
      fold += static_cast<uint32_t>(sum);
    else
      atomicAdd(&acc[si * s + sj], sum);
  }
  if constexpr (V == kMatmul) atomicAdd(reinterpret_cast<unsigned*>(acc), fold);
  __syncthreads();

  for (int t = tid; t < s * s; t += kThreads) {
    const int gi = bi * s + t / s;
    const int gj = bj * s + t % s;
    out[static_cast<size_t>(gi) * n_pad + gj] = acc[t];
    out[static_cast<size_t>(gj) * n_pad + gi] = acc[t];
  }
}

template <int W, int V = kCurrent>
cudaError_t launch(const uint32_t* x, int32_t* out, int n_pad, int p_pad,
                   int s, int k, cudaStream_t stream) {
  // RI i-windows per thread: about 64 registers of operands
  constexpr int RI = W <= 8 ? 8 : (W <= 16 ? 4 : (W <= 32 ? 2 : 1));
  const size_t smem =
      (static_cast<size_t>(s) * p_pad * W + s * s + 32) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      pairs_kernel<W, RI, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = n_pad / s;
  dim3 grid(tiles, tiles);
  pairs_kernel<W, RI, V><<<grid, kThreads, smem, stream>>>(x, out, n_pad,
                                                           p_pad, s, k);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_probe(const uint32_t* x, int32_t* out, int n_pad,
                         int p_pad, int s, int k, int variant,
                         cudaStream_t stream) {
  switch (variant) {
    case kNoop: return launch<W, kNoop>(x, out, n_pad, p_pad, s, k, stream);
    case kMatmul: return launch<W, kMatmul>(x, out, n_pad, p_pad, s, k, stream);
    case kSkeleton: return launch<W, kSkeleton>(x, out, n_pad, p_pad, s, k, stream);
    case kCurrent: return launch<W, kCurrent>(x, out, n_pad, p_pad, s, k, stream);
    case kInt32: return launch<W, kInt32>(x, out, n_pad, p_pad, s, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

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

// Kernel H: kernel A's arguments plus the variant (0 noop, 1 matmul,
// 2 skeleton, 3 current, 4 int32), for the widths of the probe's shapes:
// w = 10 (KAT2B, g = 8 over 5 codes) and 16 (g = 16 over DNA).
extern "C" int pairs_probe_launch(const void* x, void* out, int n_pad,
                                  int p_pad, int w, int k, int s, int variant,
                                  void* stream) {
  const uint32_t* xw = static_cast<const uint32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 10: return launch_probe<10>(xw, o, n_pad, p_pad, s, k, variant, st);
    case 16: return launch_probe<16>(xw, o, n_pad, p_pad, s, k, variant, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
