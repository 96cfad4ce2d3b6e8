// Hopper building blocks of kernel A (pairs.cu): one-hot tiles in wgmma's
// K-major core-matrix layout, shared-memory matrix descriptors, cp.async
// and the int8 wgmma; kernels D to G (pairs_packed.cu) share its cp.async
// and upper-triangle walk; the theta Gram (theta_gram.cu) its mbarriers,
// with a TMA tensor copy, the 128-byte swizzle and the u8 wgmma.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fastsk_hopper {

// Byte (r, kb) of a one-hot tile in wgmma's K-major layout without
// swizzle: 8-row x 16-byte core matrices of 128 contiguous bytes, those
// of one 8-row group side by side along K (LBO 128 B), the groups one
// after another (SBO 8 * depth B).
__device__ __forceinline__ int onehot_at(int r, int kb, int depth) {
  return (r >> 3) * (depth * 8) + (kb >> 4) * 128 + (r & 7) * 16 + (kb & 15);
}

// A shared-memory matrix descriptor of wgmma (no swizzle).
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// A descriptor of a K-major tile of 64-byte rows in the 64-byte swizzle
// (8-row atoms of 512 B, 16-byte chunk c of row r at chunk c ^ ((r >> 1)
// & 3); the tile 512-byte aligned): sbo is the 8-row groups' stride.
__device__ __forceinline__ uint64_t smem_desc_sw64(const void* p, int sbo) {
  return smem_desc(p, 16, sbo) | (2ull << 62);
}

// A descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle
// (8-row atoms of 1,024 B, 16-byte chunk c of row r at chunk c ^ (r & 7),
// as a TMA copy with CU_TENSOR_MAP_SWIZZLE_128B lays it; the tile 1,024-byte
// aligned): the 8-row groups 1,024 B apart. A k-step of 32 bytes inside the
// row adds 2 to the descriptor (its address field counts 16 bytes).
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  return smem_desc(p, 16, 1024) | (1ull << 62);
}

// Byte offset of 16-byte chunk c of row r in such a tile.
__device__ __forceinline__ int sw64_at(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// 16 bytes from gmem, or 16 zero bytes where src_bytes is 0.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// All but the newest committed group landed.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// All but the N newest committed groups landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D (64 x 128 s32, this warpgroup's) += or = A (64 x 32 s8) B^T (128 x
// 32 s8), both K-major in shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The same with a 64-column B: D (64 x 64 s32) += or = A (64 x 32 s8)
// B^T (64 x 32 s8).
__device__ __forceinline__ void wgmma_s8_n64(int* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 256 s32, this warpgroup's) += or = A (64 x 32 u8) B^T (256 x
// 32 u8), both K-major in shared memory; scale_d = 0 overwrites D (the
// theta Gram, theta_gram.cu).
__device__ __forceinline__ void wgmma_u8_n256(int* d, uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers in shared memory: init (one thread, then mbar_init_fence and
// a block barrier), an arrival, an arrival that also expects `bytes` of
// bulk copies, and a wait for the completion of the phase of `parity`
// (a fresh barrier counts its phase of parity 1 as complete).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from gmem to
// smem by the bulk-copy engine, completed on `bar`'s transaction count.
__device__ __forceinline__ void bulk_g2s(void* smem, const void* gmem, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box of the tensor map `map` (a __grid_constant__ kernel parameter) at
// element coordinates (x, y), x innermost, from gmem to smem by the
// tensor-memory accelerator, completed on `bar`'s transaction count; the
// box's elements outside the tensor land as zeros.
__device__ __forceinline__ void tma_load_2d(void* smem, const void* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads') over `threads` threads.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Tile pairs before row tile ti in row-tile-major order of the upper
// triangle of nt tiles.
__host__ __device__ __forceinline__ int64_t pairs_before(int64_t ti, int64_t nt) {
  return ti * nt - ti * (ti - 1) / 2;
}

// The row tile of upper-triangle pair index L (row-tile-major order).
__device__ __forceinline__ int64_t row_tile_of(int64_t L, int64_t nt) {
  const double b2 = 2.0 * nt + 1.0;
  int64_t ti = static_cast<int64_t>((b2 - sqrt(b2 * b2 - 8.0 * L)) / 2.0);
  ti = ti < 0 ? 0 : (ti >= nt ? nt - 1 : ti);
  while (ti > 0 && pairs_before(ti, nt) > L) --ti;
  while (ti + 1 < nt && pairs_before(ti + 1, nt) <= L) ++ti;
  return ti;
}

}  // namespace fastsk_hopper
