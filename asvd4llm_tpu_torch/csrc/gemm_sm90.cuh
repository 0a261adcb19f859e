// Hopper (sm_90a) building blocks shared by the tensor-core forms written for
// this card: mbarriers, TMA tile loads, wgmma matrix descriptors and products,
// the host-side tensor-map encoder, `gemm_nt`, a pipelined wgmma GEMM with a
// rounding epilogue (kernel 1's tiled form, fused_lowrank.cu), and
// `gemm_nt_i8`, the same GEMM with an int8-coded weight operand converted to
// bf16 in shared memory and a per-column dequantizing epilogue (kernel 3's
// tiled form, fused_lowrank_q8.cu). The split tile of kernels 2 and 6
// (latent_split.cuh) runs its up-projection on the same pieces; kernel 4's
// tiled form (fused_lowrank_q4.cu) and kernel 5's split form
// (paged_dense_attention.cu) use the barriers, TMA loads and fragments.
//
// Operand layout, the one wgmma reads without transposing: both operands
// K-major (rows of K contiguous values), each stage tile [rows][64] bf16 =
// 128 bytes a row, loaded by TMA with the 128-byte swizzle. A matrix
// descriptor names such a tile with LBO 16 bytes (unused by the swizzled
// K-major layout), SBO 1024 bytes (the stride between 8-row groups) and
// layout type 1 (128-byte swizzle); each 16-deep k step inside the 64-wide
// row advances the start address by 32 bytes. Tiles start 1024-byte aligned.
//
// Accumulator layout of wgmma m64nNk16 (f32): thread t of the warpgroup, warp
// w = t / 32, lane l: d[4j + 2h + e] is row 16w + l/4 + 8h, column
// 8j + 2(l % 4) + e, for j < N/8, h, e in {0, 1}.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;            // K per stage: one 128-byte swizzled row of bf16
constexpr int kRowBytes = kBK * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operand reads, TMA) after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------------ TMA

// One tile of a 2-D (3-D) tensor map into shared memory; coordinates
// innermost first. Elements outside the tensor arrive as 0, and the barrier
// counts the whole box.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------- wgmma

// Descriptor of a K-major, 128-byte-swizzled bf16 tile starting at p.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Advance a descriptor by kk 16-deep k steps (32 bytes each) inside the row.
__device__ __forceinline__ uint64_t desc_k(uint64_t d, int kk) { return d + 2ull * kk; }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads of the accumulators above a wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[N/2] (+)= A(64x16) · B(16xN): both operands K-major in shared memory,
// named by matrix descriptors; f32 accumulators in registers. With
// accumulate = 0 the product overwrites d: the first step of a sum starts
// from it, so that no other instruction writes the accumulators while the
// wgmma pipeline runs (ptxas would serialize the products).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n176k16(float (&d)[88], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87}, "
      "%88, %89, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ------------------------------------------------- warp-level tensor cores

// c += A(16x16, row) · B(16x8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory (lane l names row l % 8 of
// matrix l / 8): the A fragment of mma16816 when lane l points at row l % 16,
// column 8·(l / 16) of a row-major 16x16 tile.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two 8x8 bf16 matrices, transposed: the B fragment of mma16816 when lane
// l < 16 points at row l of a row-major [16 k][8 n] tile.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// Four 8x8 bf16 matrices, transposed: the A fragment of mma16816 from a tile
// stored [k][m] (m contiguous), when lane l points at row k0 + 8·(l / 16) +
// l % 8, column m0 + 8·((l / 8) % 2).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two 8x8 bf16 matrices: the B fragment of mma16816 from a tile stored
// [n][k] (k contiguous), when lane l < 16 points at row n0 + l % 8, column
// k0 + 8·(l / 8).
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t da, uint64_t db,
                                          int accumulate) {
  static_assert(N == 64 || N == 128 || N == 176 || N == 192 || N == 256, "wgmma width");
  if constexpr (N == 64) wgmma_m64n64k16(d, da, db, accumulate);
  else if constexpr (N == 128) wgmma_m64n128k16(d, da, db, accumulate);
  else if constexpr (N == 176) wgmma_m64n176k16(d, da, db, accumulate);
  else if constexpr (N == 192) wgmma_m64n192k16(d, da, db, accumulate);
  else wgmma_m64n256k16(d, da, db, accumulate);
}

// ------------------------------------------------------------------ host side

// A tensor map of `rank` dimensions (innermost first) with a box of `box`
// elements, zero fill outside the tensor: bf16 with the 128-byte swizzle by
// default, or another element type and swizzle. The driver's encoder is
// found through the runtime, so nothing links libcuda.
inline cudaError_t encode_map(CUtensorMap* map, int rank, const void* base, const cuuint64_t* dims,
                              const cuuint64_t* strides_bytes, const cuuint32_t* box,
                              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, type, (cuuint32_t)rank,
                            const_cast<void*>(base), dims, strides_bytes, box, ones,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Lets `kernel` use `bytes` of dynamic shared memory on the current device.
// cudaFuncSetAttribute is not a stream operation, so it is made once for each
// kernel and device, on the first call, and skipped afterwards: a step that
// is captured into a CUDA graph runs eagerly once before the capture, so
// the capture itself makes no such call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> granted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = granted[{fn, dev}];
  if (have >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

// Map of a row-major bf16 matrix [rows, cols] read in boxes of
// [box_rows, 64] (cols * 2 a multiple of 16, base 16-byte aligned).
inline cudaError_t encode_rows(CUtensorMap* map, const void* base, int rows, int cols,
                               int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  return encode_map(map, 2, base, dims, strides, box);
}

// Dynamic shared memory comes 16-byte aligned; the swizzled tiles want 1024.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ------------------------------------------------------------------ gemm_nt

// Ring depth: as many stages of (BM + BN) rows of 128 bytes as fit in about
// 200 KB (6 at a 128 x 128 tile, 5 at 128 x 192, 4 at 128 x 256).
__host__ __device__ constexpr int gemm_stages(int BM, int BN) {
  return 200 * 1024 / ((BM + BN) * kRowBytes) < 6 ? 200 * 1024 / ((BM + BN) * kRowBytes) : 6;
}

__host__ __device__ constexpr size_t gemm_smem_bytes(int BM, int BN) {
  return 1024 + (size_t)gemm_stages(BM, BN) * ((BM + BN) * kRowBytes + 16);
}

// The epilogue of gemm_nt and of kernel 4's gemm_nt_q4: out's tile at
// (m0, n0) = round(acc + bias) in bf16, the bias added in f32, one
// rounding; the consumer warpgroups stage their rows in shared memory at
// `smem` (free once both are past their last products), so that each row
// leaves in 16-byte stores.
template <int NC, int BN>
__device__ __forceinline__ void store_bias_round(const float (&acc)[BN / 2], unsigned char* smem,
                                                 bf16* __restrict__ out,
                                                 const bf16* __restrict__ bias, int M, int N,
                                                 int m0, int n0) {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC * 128) : "memory");
  constexpr int LD = BN + 8;  // row stride: the 8 rows a warp writes at once miss
                              // each other's banks
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  bf16* cs = reinterpret_cast<bf16*>(smem) + (size_t)wg * 64 * LD;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      if (n0 + c < N) b0 = __bfloat162float(bias[n0 + c]);
      if (n0 + c + 1 < N) b1 = __bfloat162float(bias[n0 + c + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + lane / 4 + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(cs + r * LD + c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC * 128) : "memory");
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = threadIdx.x % 128; i < 64 * (BN / 8); i += 128) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int m = m0 + wg * 64 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const bf16* src = cs + r * LD + c;
    bf16* dst = out + (size_t)m * N + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

// out[M, N] = round(X[M, K] · W[N, K]ᵀ (+ bias)) in bf16, f32 accumulation.
// Block: NC consumer warpgroups, each owning 64 rows of a (64·NC) x BN
// output tile, then one producer warp whose lane 0 keeps the TMA loads of X
// and W a ring's depth of k-steps ahead. Each full[s] barrier completes when
// stage s has landed; each empty[s] when the consumer warps' products have
// finished reading it. The consumers keep one k-step's wgmma group in
// flight while they wait for the next stage. No split over K: the sum is
// whole when the epilogue rounds it, once.
template <int NC, int BN>
__global__ void __launch_bounds__(NC * 128 + 32)
gemm_nt(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
        bf16* __restrict__ out, const bf16* __restrict__ bias, int M, int N, int K) {
  constexpr int BM = 64 * NC, S = gemm_stages(64 * NC, BN);
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  unsigned char* base = align1024(gemm_smem);
  bf16* xs = reinterpret_cast<bf16*>(base);                 // [S][BM][64]
  bf16* ws = xs + (size_t)S * BM * kBK;                     // [S][BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + (size_t)S * BN * kBK);
  uint64_t* empty = full + S;
  // the row tiles of one W tile run side by side (blockIdx.x), so W, the
  // larger operand, streams through L2 once
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // producer warp
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], ((kt / S) - 1) & 1);
        mbar_expect_tx(&full[s], (BM + BN) * kRowBytes);
        tma_load_2d(xs + (size_t)s * BM * kBK, &map_x, kt * kBK, m0, &full[s]);
        tma_load_2d(ws + (size_t)s * BN * kBK, &map_w, kt * kBK, n0, &full[s]);
      }
    }
    return;
  }

  float acc[BN / 2];  // written first by the kt = 0 products
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    wgmma_fence();
    const uint64_t da = desc_sw128(xs + ((size_t)s * BM + wg * 64) * kBK);
    const uint64_t db = desc_sw128(ws + (size_t)s * BN * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_k16<BN>(acc, desc_k(da, kk), desc_k(db, kk), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with their stage
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  store_bias_round<NC, BN>(acc, base, out, bias, M, N, m0, n0);
}

template <int NC, int BN>
cudaError_t launch_gemm_tile(const CUtensorMap& mx, const CUtensorMap& mw, bf16* out,
                             const bf16* bias, int M, int N, int K, cudaStream_t stream) {
  const size_t bytes = gemm_smem_bytes(64 * NC, BN);
  const cudaError_t err = allow_smem(gemm_nt<NC, BN>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + 64 * NC - 1) / (64 * NC), (N + BN - 1) / BN);
  gemm_nt<NC, BN><<<grid, NC * 128 + 32, bytes, stream>>>(mx, mw, out, bias, M, N, K);
  return cudaGetLastError();
}

// Output tile width: the one of kTileWidths whose last wave ends first
// (waves of one block per SM, each as long as the tile is wide), the wider
// on a tie (fewer blocks, more products per byte staged). 176 fits the
// 2688-wide rank of a Llama-2-7B MLP at ratio 0.9 into 128 blocks of 128
// rows at M = 1024, one wave.
constexpr int kTileWidths[4] = {128, 176, 192, 256};

inline int gemm_tile_n(int M, int N, int BM) {
  constexpr int kSms = 132;
  const int rows = (M + BM - 1) / BM;
  int best = 128;
  long best_cost = -1;
  for (int bn : kTileWidths) {
    const long tiles = (long)rows * ((N + bn - 1) / bn);
    const long cost = (tiles + kSms - 1) / kSms * bn;
    if (best_cost < 0 || cost <= best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

// Launch gemm_nt on `stream`: a 128-row tile where M reaches it, else 64,
// and the tile width of gemm_tile_n. (A template, so that a source that
// includes this header without launching the GEMM compiles none of it.)
template <typename T>
cudaError_t launch_gemm_nt(const T* X, const T* W, T* out, const T* bias, int M, int N, int K,
                           cudaStream_t stream) {
  static_assert(sizeof(T) == 2, "bf16 operands");
  const int NC = M >= 128 ? 2 : 1;
  const int BN = gemm_tile_n(M, N, 64 * NC);
  CUtensorMap mx, mw;
  cudaError_t err = encode_rows(&mx, X, M, K, 64 * NC);
  if (err != cudaSuccess) return err;
  err = encode_rows(&mw, W, N, K, BN);
  if (err != cudaSuccess) return err;
  switch (NC * 1000 + BN) {
    case 2256: return launch_gemm_tile<2, 256>(mx, mw, out, bias, M, N, K, stream);
    case 2192: return launch_gemm_tile<2, 192>(mx, mw, out, bias, M, N, K, stream);
    case 2176: return launch_gemm_tile<2, 176>(mx, mw, out, bias, M, N, K, stream);
    case 2128: return launch_gemm_tile<2, 128>(mx, mw, out, bias, M, N, K, stream);
    case 1256: return launch_gemm_tile<1, 256>(mx, mw, out, bias, M, N, K, stream);
    case 1192: return launch_gemm_tile<1, 192>(mx, mw, out, bias, M, N, K, stream);
    case 1176: return launch_gemm_tile<1, 176>(mx, mw, out, bias, M, N, K, stream);
    default: return launch_gemm_tile<1, 128>(mx, mw, out, bias, M, N, K, stream);
  }
}

// ---------------------------------------------------------------- gemm_nt_i8

// Stages of gemm_nt_i8: a tile of ones [8][64] and three converted bf16 W
// tiles [BN][64] (128 bytes a row), then as many (X [BM][64] bf16, W8
// [BN][64] int8) ring stages as fit in about 200 KB, at most 6 (3 at
// 128 x 256, 4 at 128 x 176 or 192, 6 at 128 x 128).
__host__ __device__ constexpr int gemm_i8_stages(int BM, int BN) {
  return (200 * 1024 - (3 * BN + 8) * kRowBytes) / (BM * kRowBytes + BN * kBK) < 6
             ? (200 * 1024 - (3 * BN + 8) * kRowBytes) / (BM * kRowBytes + BN * kBK)
             : 6;
}

__host__ __device__ constexpr size_t gemm_i8_smem_bytes(int BM, int BN) {
  return 1024 + (3 * (size_t)BN + 8) * kRowBytes
         + (size_t)gemm_i8_stages(BM, BN) * (BM * kRowBytes + BN * kBK + 16);
}

// d[4] (+)= A(64x16) · B(16x8), the layout of the first eight columns of
// the wider products.
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// out[M, N] = round(sc[n]·acc[m, n] − (sc[n]·zp[n])·rowsum(X)[m] (+ bias[n]))
// with acc = X[M, K] · W8[N, K]ᵀ over the raw codes, in f32. It is gemm_nt
// with two changes:
//   * W arrives as int8 codes: the producer loads each stage's [BN][64]
//     codes by TMA (no swizzle, 64-byte rows) next to X's bf16 stage, and
//     the consumer warpgroups convert them (`Cvt`: 16 codes to two 16-byte
//     chunks of bf16, exact) into a bf16 tile in the layout TMA's 128-byte
//     swizzle would give (16-byte chunk c of row n at chunk c ^ (n % 8)), so
//     the wgmma descriptors are gemm_nt's; a proxy fence makes the stores
//     visible to wgmma. One conversion serves all BM rows of X. The
//     converted tiles rotate over three buffers: the conversion of step
//     k + 1 overlaps the products of step k, and the products of step k − 2
//     (the last reader of its buffer) are done in both warpgroups once both
//     have passed step k's barrier.
//   * rowsum(X) in f32 comes from the tensor cores: beside each 64-row
//     product a 64 x 8 one against a tile of ones, whose every column is the
//     row sum, in the rows the thread's epilogue writes. The epilogue
//     applies the per-column scale and zero point after the whole K sum,
//     then the bias, and rounds once.
// TMA fills X and W8 past M, N and K with zeros, so ragged edges add 0 to
// acc and to the row sums.
template <int NC, int BN, typename Cvt>
__global__ void __launch_bounds__(NC * 128 + 32)
gemm_nt_i8(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w8,
           bf16* __restrict__ out, const float* __restrict__ sc, const float* __restrict__ zp,
           const bf16* __restrict__ bias, int M, int N, int K) {
  constexpr int BM = 64 * NC, S = gemm_i8_stages(64 * NC, BN), NT = NC * 128;
  extern __shared__ __align__(128) unsigned char gemm_i8_smem[];
  unsigned char* base = align1024(gemm_i8_smem);
  bf16* wb = reinterpret_cast<bf16*>(base);                      // [3][BN][64]
  bf16* ones = wb + 3 * (size_t)BN * kBK;                        // [8][64]
  bf16* xs = ones + 8 * kBK;                                     // [S][BM][64]
  uint8_t* w8 = reinterpret_cast<uint8_t*>(xs + (size_t)S * BM * kBK);  // [S][BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(w8 + (size_t)S * BN * kBK);
  uint64_t* empty = full + S;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < 8 * kBK; i += blockDim.x) ones[i] = __float2bfloat16_rn(1.f);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // producer warp
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], ((kt / S) - 1) & 1);
        mbar_expect_tx(&full[s], BM * kRowBytes + BN * kBK);
        tma_load_2d(xs + (size_t)s * BM * kBK, &map_x, kt * kBK, m0, &full[s]);
        tma_load_2d(w8 + (size_t)s * BN * kBK, &map_w8, kt * kBK, n0, &full[s]);
      }
    }
    return;
  }

  const uint64_t d1 = desc_sw128(ones);
  float acc[BN / 2];  // written first by the kt = 0 products
  float rsa[4];       // rowsum(X) of the thread's rows, in every column
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    const uint8_t* src = w8 + (size_t)s * BN * kBK;
    bf16* dst = wb + (size_t)(kt % 3) * BN * kBK;
#pragma unroll
    for (int i = threadIdx.x; i < BN * 4; i += NT) {  // 16 codes: row i / 4, columns 16·(i % 4)..
      const int n = i / 4, c = i % 4;
      uint4 lo, hi;
      Cvt()(*reinterpret_cast<const uint4*>(src + n * kBK + c * 16), lo, hi);
      *reinterpret_cast<uint4*>(dst + n * kBK + (((2 * c) ^ (n % 8)) * 8)) = lo;
      *reinterpret_cast<uint4*>(dst + n * kBK + (((2 * c + 1) ^ (n % 8)) * 8)) = hi;
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
    wgmma_fence();
    const uint64_t da = desc_sw128(xs + ((size_t)s * BM + wg * 64) * kBK);
    const uint64_t db = desc_sw128(dst);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_k16<BN>(acc, desc_k(da, kk), desc_k(db, kk), kt > 0 || kk > 0);
      wgmma_m64n8k16(rsa, desc_k(da, kk), desc_k(d1, kk), kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with their stage
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  fence_operands(rsa);

  // Epilogue: scale, zero point, bias in f32, one rounding, then out through
  // shared memory (the converted tiles are free once both warpgroups are
  // past their last products), so that each row leaves in 16-byte stores.
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
  constexpr int LD = BN + 8;
  bf16* cs = reinterpret_cast<bf16*>(base) + (size_t)wg * 64 * LD;
  const int warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    float s0 = 0.f, s1 = 0.f, z0 = 0.f, z1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (n0 + c < N) {
      s0 = sc[n0 + c];
      z0 = s0 * zp[n0 + c];
      if (bias != nullptr) b0 = __bfloat162float(bias[n0 + c]);
    }
    if (n0 + c + 1 < N) {
      s1 = sc[n0 + c + 1];
      z1 = s1 * zp[n0 + c + 1];
      if (bias != nullptr) b1 = __bfloat162float(bias[n0 + c + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + lane / 4 + 8 * h;
      const float xsum = rsa[2 * h];
      *reinterpret_cast<__nv_bfloat162*>(cs + r * LD + c) = __floats2bfloat162_rn(
          acc[4 * j + 2 * h] * s0 - xsum * z0 + b0, acc[4 * j + 2 * h + 1] * s1 - xsum * z1 + b1);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = threadIdx.x % 128; i < 64 * (BN / 8); i += 128) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int m = m0 + wg * 64 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const bf16* srcp = cs + r * LD + c;
    bf16* dstp = out + (size_t)m * N + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dstp) = *reinterpret_cast<const uint4*>(srcp);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dstp[e] = srcp[e];
    }
  }
}

template <int NC, int BN, typename Cvt>
cudaError_t launch_gemm_i8_tile(const CUtensorMap& mx, const CUtensorMap& mw, bf16* out,
                                const float* sc, const float* zp, const bf16* bias, int M, int N,
                                int K, cudaStream_t stream) {
  const size_t bytes = gemm_i8_smem_bytes(64 * NC, BN);
  const cudaError_t err = allow_smem(gemm_nt_i8<NC, BN, Cvt>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + 64 * NC - 1) / (64 * NC), (N + BN - 1) / BN);
  gemm_nt_i8<NC, BN, Cvt><<<grid, NC * 128 + 32, bytes, stream>>>(mx, mw, out, sc, zp, bias, M,
                                                                  N, K);
  return cudaGetLastError();
}

// Launch gemm_nt_i8 on `stream` with gemm_nt's tile choice: X [M, K] bf16
// (K a multiple of 8), W8 [N, K] int8 codes in rows `ldw` bytes apart (a
// multiple of 16), sc/zp [N] f32, bias [N] or null; both base pointers
// 16-byte aligned.
template <typename Cvt>
cudaError_t launch_gemm_nt_i8(const bf16* X, const uint8_t* W8, int ldw, bf16* out,
                              const float* sc, const float* zp, const bf16* bias, int M, int N,
                              int K, cudaStream_t stream) {
  const int NC = M >= 128 ? 2 : 1;
  const int BN = gemm_tile_n(M, N, 64 * NC);
  CUtensorMap mx, mw;
  cudaError_t err = encode_rows(&mx, X, M, K, 64 * NC);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)ldw};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)BN};
  err = encode_map(&mw, 2, W8, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  switch (NC * 1000 + BN) {
    case 2256: return launch_gemm_i8_tile<2, 256, Cvt>(mx, mw, out, sc, zp, bias, M, N, K, stream);
    case 2192: return launch_gemm_i8_tile<2, 192, Cvt>(mx, mw, out, sc, zp, bias, M, N, K, stream);
    case 2176: return launch_gemm_i8_tile<2, 176, Cvt>(mx, mw, out, sc, zp, bias, M, N, K, stream);
    case 2128: return launch_gemm_i8_tile<2, 128, Cvt>(mx, mw, out, sc, zp, bias, M, N, K, stream);
    case 1256: return launch_gemm_i8_tile<1, 256, Cvt>(mx, mw, out, sc, zp, bias, M, N, K, stream);
    case 1192: return launch_gemm_i8_tile<1, 192, Cvt>(mx, mw, out, sc, zp, bias, M, N, K, stream);
    case 1176: return launch_gemm_i8_tile<1, 176, Cvt>(mx, mw, out, sc, zp, bias, M, N, K, stream);
    default: return launch_gemm_i8_tile<1, 128, Cvt>(mx, mw, out, sc, zp, bias, M, N, K, stream);
  }
}

}  // namespace sm90
