// The dense theta engine's count Gram on the card: out = sum_t C_t C_t^T,
// the [n, n] int32 symmetric matrix of a batch of count matrices C_t
// [n, k] (ops/gkm.py:theta_gram, route "u8_wgmma"; wrapper
// ops/theta_gram_cuda.py). It replaces no TPU kernel: the JAX package
// leaves this product to XLA's matmul on the MXU (fastsk_tpu/ops/gkm.py),
// and the port ran it through cuBLAS in bf16 with f32 outputs, which at
// KAT2B's g13 m7 shape (7,020 x 15,625 buckets) took an sm75-class
// mma.sync kernel: the rows' 31,250-byte stride is no multiple of 16, so
// no TMA kernel could take it.
//
// What bounds it: the upper triangle's n (n + 1) k u8 multiply-adds at the
// int8 tensor-core peak (1,979 TOP/s): 0.39 ms a subset at 7,020 x 15,625.
// The operand (110 MB there) is read from device memory about once a
// round of tiles and the output (197 MB of int32) written once, ~0.1 ms.
// On the card the tiles' loads bind it: each tile reads its 384 rows
// from L2 (6 MB at 15,744 bytes a row), ~6.3 TB/s over the 132 SMs, and
// the loads alone take as long as the kernel (PERF.md §6).
//
// The design:
//   - exact u8 operands: a count is at most the sequence's windows, and the
//     route is taken only where that is <= 255 (ops/gkm.py:theta_route),
//     so the counts are the wgmma's u8 operands as they are, accumulated
//     in s32; an entry of one subset is at most p_max^2 and the engine
//     keeps a batch's sum below 2^31, so the product is the integer one;
//   - the operand is the wrapper's u8 [t, n, k_pad] (k_pad a multiple of
//     the 128-byte stage, the padding zero): one 2-D tensor map over its
//     t n rows of k_pad bytes, whose 128 x 128-byte boxes the TMA lays in
//     shared memory in the 128-byte swizzle that wgmma reads; rows past
//     the tensor land as zeros, and rows of the next subset past row n
//     only reach outputs past n, which are not written;
//   - only the tiles on or above the diagonal: a tile is 128 rows (two
//     consumer warpgroups of 64) by 256 columns (m64n256k32 a warpgroup);
//     row tile bi's tiles start at its own diagonal square, at columns
//     128 bi + 256 j (784 tiles at n = 7,020, six for each of 132 SMs
//     less eight; tiles aligned to 256 columns would be 811, a seventh
//     round for 19 SMs); each entry (r, c >= r) is written at (r, c) and
//     (c, r) by the thread that holds it, so every entry of the output is
//     written once, from the epilogue's registers in int32;
//   - warp specialised and persistent: one block an SM walks the tile
//     list with the grid's stride; a producer warp's one thread keeps a
//     ring of kStages stages (a 128-row A box and two 128-row B boxes over
//     128 bytes of k, 48 KB) in flight on full and empty mbarriers, across
//     tile boundaries, so the next tile's loads run under this tile's
//     epilogue; registers move from the producer to the consumers by
//     setmaxnreg;
//   - the k loop keeps one wgmma group a stage: a stage's four k-steps are
//     unrolled at compile time, committed together, and wgmma.wait_group 1
//     waits for the stage before, whose slot it then releases; nothing but
//     wgmma touches the accumulators while a group is in flight (each
//     tile's first k-step overwrites them), so ptxas has no cause to
//     serialize the groups whatever the run-time count of stages.
#include <cuda.h>  // CUtensorMap and the encoder's types; libcuda's encoder is looked up at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

using namespace fastsk_hopper;

namespace {

constexpr int kBm = 128;                        // tile rows: two consumer warpgroups of 64
constexpr int kBn = 256;                        // tile columns: m64n256k32 a warpgroup
constexpr int kBk = 128;                        // bytes of k a stage: the swizzle's row
constexpr int kBox = 128;                       // rows of a TMA box
constexpr int kStages = 4;
constexpr int kABytes = kBm * kBk;              // 16 KB
constexpr int kStageBytes = (kBm + kBn) * kBk;  // 48 KB
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr size_t kSmemBytes = 1024 + static_cast<size_t>(kStages) * kStageBytes +
                              2 * kStages * sizeof(uint64_t);

// The tile (bi, j) of the upper triangle's walk: row tile bi's columns
// from its own first row on, bi * kBm + j * kBn, in tiles of kBn (its
// first tile holds the diagonal square); rows in order.
struct Tile {
  int bi, j;
};

__host__ __device__ __forceinline__ int row_tiles(int bi, int n) {
  return (n - bi * kBm + kBn - 1) / kBn;
}

__host__ __device__ __forceinline__ void tile_advance(Tile& u, int step, int mt, int n) {
  u.j += step;
  while (u.bi < mt && u.j >= row_tiles(u.bi, n)) {
    u.j -= row_tiles(u.bi, n);
    ++u.bi;
  }
}

__host__ __forceinline__ int64_t tile_count(int mt, int n) {
  int64_t tiles = 0;
  for (int bi = 0; bi < mt; ++bi) tiles += row_tiles(bi, n);
  return tiles;
}

__global__ void __launch_bounds__(kThreads, 1)
theta_gram_kernel(const __grid_constant__ CUtensorMap map, int32_t* __restrict__ out, int n,
                  int t_count, int k_pad) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzled boxes need 1,024-byte alignment
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mt = (n + kBm - 1) / kBm;
  const int kt = k_pad / kBk;  // stages a subset

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kConsumers / 32);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      int st = 0, ph = 0;
      Tile u{0, 0};
      tile_advance(u, blockIdx.x, mt, n);
      for (; u.bi < mt; tile_advance(u, gridDim.x, mt, n)) {
        for (int t = 0; t < t_count; ++t) {
          const int ra = t * n + u.bi * kBm, rb = ra + u.j * kBn;
          for (int kb = 0; kb < kt; ++kb) {
            mbar_wait(empty + st, ph ^ 1);
            mbar_arrive_tx(full + st, kStageBytes);
            uint8_t* s = ring + st * kStageBytes;
            tma_load_2d(s, &map, kb * kBk, ra, full + st);
            tma_load_2d(s + kABytes, &map, kb * kBk, rb, full + st);
            tma_load_2d(s + kABytes + kBox * kBk, &map, kb * kBk, rb + kBox, full + st);
            if (++st == kStages) {
              st = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg's 64 rows of the tile against its 256
  // columns; this thread's accumulator v is row 16 (warp & 3) + lane / 4 +
  // 8 ((v >> 1) & 1) of them, column 8 (v >> 2) + 2 (lane & 3) + (v & 1)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int steps = t_count * kt;  // stages a tile
  int acc[128];
  int st = 0, ph = 0;
  Tile u{0, 0};
  tile_advance(u, blockIdx.x, mt, n);
  for (; u.bi < mt; tile_advance(u, gridDim.x, mt, n)) {
    int prev = 0;
    for (int i = 0; i < steps; ++i) {
      mbar_wait(full + st, ph);
      const uint8_t* s = ring + st * kStageBytes;
      const uint64_t da = smem_desc_sw128(s + wg * 64 * kBk);
      const uint64_t db = smem_desc_sw128(s + kABytes);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kBk / 32; ++ks) {
        wgmma_u8_n256(acc, da + 2 * ks, db + 2 * ks, i > 0 || ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before has been read: release its slot
      if (i > 0 && lane == 0) mbar_arrive(empty + prev);
      prev = st;
      if (++st == kStages) {
        st = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + prev);

    const int r0 = u.bi * kBm + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int c0 = u.bi * kBm + u.j * kBn + 2 * (lane & 3);
    const bool pairs = (n & 1) == 0;  // (r, c), (r, c + 1) 8-byte aligned for even c
#pragma unroll
    for (int v = 0; v < 128; v += 2) {
      const int r = r0 + 8 * ((v >> 1) & 1);
      const int c = c0 + 8 * (v >> 2);
      if (r >= n) continue;
      const bool w0 = c < n && c >= r, w1 = c + 1 < n && c + 1 >= r;
      int32_t* row = out + static_cast<int64_t>(r) * n;
      if (pairs && w0 && w1) {
        *reinterpret_cast<int2*>(row + c) = make_int2(acc[v], acc[v + 1]);
      } else {
        if (w0) row[c] = acc[v];
        if (w1) row[c + 1] = acc[v + 1];
      }
      if (w0) out[static_cast<int64_t>(c) * n + r] = acc[v];
      if (w1) out[static_cast<int64_t>(c + 1) * n + r] = acc[v + 1];
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link to libcuda): null where libcuda lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The device's SM count, with the kernel's shared-memory limit raised on
// it, once a process and device (a job launches the kernel once a subset);
// a CUDA error as its negative.
int prepare(int dev) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sms_of[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return -static_cast<int>(cudaErrorInvalidDevice);
  int sms = sms_of[dev].load(std::memory_order_relaxed);
  if (sms > 0) return sms;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(theta_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  sms_of[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

}  // namespace

// c: u8 [t_count, n, k_pad] counts (16-byte aligned, k_pad a multiple of
// 128, the padding columns zero); out: [n, n] int32, every entry written.
// The caller keeps every entry of sum_t C_t C_t^T below 2^31.
extern "C" int theta_gram_launch(const void* c, void* out, int n, int t_count, int k_pad,
                                 void* stream) {
  if (n < 1 || t_count < 1 || k_pad < kBk || k_pad % kBk ||
      reinterpret_cast<uintptr_t>(c) % 16 ||
      static_cast<int64_t>(t_count) * n + kBn > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_pad),
                              static_cast<cuuint64_t>(t_count) * static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_pad)};
  const cuuint32_t box[2] = {kBk, kBox};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(c), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = prepare(dev);
  if (sms < 0) return -sms;
  const int64_t tiles = tile_count((n + kBm - 1) / kBm, n);
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  theta_gram_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<int32_t*>(out), n, t_count, k_pad);
  return static_cast<int>(cudaGetLastError());
}
