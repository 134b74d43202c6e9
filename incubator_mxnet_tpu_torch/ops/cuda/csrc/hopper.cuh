// Hopper (sm_90a) pieces shared by the kernels that run on the tensor cores
// (mm_wgmma.cu, and the bf16 and f16 flash kernels of flash_attention.cu
// and flash_attention_bwd.cu): the mbarrier and TMA wrappers, wgmma's
// shared-memory descriptor, its fences and its m64nNk16 bf16 and f16 forms
// (A's register fragments are made by pack2<T> of common.cuh), a named
// barrier, the split-TF32 pieces of the f32 flash kernels at D = 256
// (split_tf32, mma_tf32, ldsm4), the host's way to cuTensorMapEncodeTiled,
// and the tensor maps of the attention kernels.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only; libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace mxt {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// a 2-D box of the tensor map at (c0, c1) (c0 the contiguous coordinate)
// into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)) : "memory");
}

// the same for a 1-D map, at c0
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            int c0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(smem_u32(bar))
      : "memory");
}

// the same for a 4-D map, at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar)) : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// shared address `addr`: leading and stride byte offsets in bytes
__device__ __forceinline__ uint64_t wg_desc(unsigned addr, unsigned lbo,
                                            unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) |
         ((uint64_t)1 << 62);                      // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N of this warp's committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator (or of
// A's fragments in registers) across the asynchronous wgmma that owns it
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(unsigned (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
// an accumulator's registers set to zero
template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// The m64nNk16 forms with f32 accumulators, for T = __nv_bfloat16 (".bf16")
// or __half (".f16"): the same shapes, fragments and transpose bits. The
// PTX type is part of the instruction's text, so each form is written out
// once, as a macro of its type's name, and each wrapper picks its text.
#define MXT_ACC32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define MXT_ACC64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define MXT_D32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define MXT_D64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define MXT_ACC128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define MXT_D128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"
// both operands from shared memory through descriptors
#define MXT_WGMMA_N64_SS(TY)                                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" MXT_D32       \
  "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
#define MXT_WGMMA_N128_SS(TY)                                                 \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" MXT_D64      \
  "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
// A from registers, B (MN-major) from shared memory
#define MXT_WGMMA_N64_RS(TY)                                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" MXT_D32       \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
#define MXT_WGMMA_N128_RS(TY)                                                 \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" MXT_D64      \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
#define MXT_WGMMA_N256_RS(TY)                                                 \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" MXT_D128     \
  "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"

// D (64 x N, f32, in registers) += A (64 x 16, K-major) * B (16 x N), both
// read from shared memory through their descriptors. TB is imm-trans-b:
// 0 for a K-major B, 1 for an MN-major one.
template <typename T, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a,
                                             uint64_t b) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  if constexpr (kIsHalf<T>)
    asm volatile(MXT_WGMMA_N64_SS("f16")
                 : MXT_ACC32 : "l"(a), "l"(b), "r"(1), "n"(TB));
  else
    asm volatile(MXT_WGMMA_N64_SS("bf16")
                 : MXT_ACC32 : "l"(a), "l"(b), "r"(1), "n"(TB));
}

template <typename T, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  if constexpr (kIsHalf<T>)
    asm volatile(MXT_WGMMA_N128_SS("f16")
                 : MXT_ACC64 : "l"(a), "l"(b), "r"(1), "n"(TB));
  else
    asm volatile(MXT_WGMMA_N128_SS("bf16")
                 : MXT_ACC64 : "l"(a), "l"(b), "r"(1), "n"(TB));
}

// D (64 x N, f32) += A (64 x 16, in registers: the four 32-bit fragments
// of this thread, two 16-bit values each, as pack2<T> makes them) * B (16 x
// N, MN-major: imm-trans-b = 1, from shared memory through its descriptor)
template <typename T>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32],
                                                const unsigned (&a)[4],
                                                uint64_t b) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  if constexpr (kIsHalf<T>)
    asm volatile(MXT_WGMMA_N64_RS("f16")
                 : MXT_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
  else
    asm volatile(MXT_WGMMA_N64_RS("bf16")
                 : MXT_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
}

template <typename T>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64],
                                                 const unsigned (&a)[4],
                                                 uint64_t b) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  if constexpr (kIsHalf<T>)
    asm volatile(MXT_WGMMA_N128_RS("f16")
                 : MXT_ACC64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
  else
    asm volatile(MXT_WGMMA_N128_RS("bf16")
                 : MXT_ACC64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
}

// the widest form, for O += P V at D = 256: one A fragment feeds all 256
// columns (V's four 64-column boxes, LBO apart)
template <typename T>
__device__ __forceinline__ void wgmma_m64n256_rs(float (&d)[128],
                                                 const unsigned (&a)[4],
                                                 uint64_t b) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  if constexpr (kIsHalf<T>)
    asm volatile(MXT_WGMMA_N256_RS("f16")
                 : MXT_ACC128
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
  else
    asm volatile(MXT_WGMMA_N256_RS("bf16")
                 : MXT_ACC128
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The split-TF32 products of the f32 flash kernels at D = 256
// (flash_fwd_tf32x3_kernel, flash_bwd_dq_tf32x3_kernel and
// flash_bwd_dkv_tf32x3_kernel): an f32 product as three TF32
// mma.sync products of its operands' big and small parts.
//
// x = big + small + (a remainder near 2^-22 x): big = x rounded to TF32 to
// nearest, ties away from zero (the value of cvt.rna.tf32.f32; (bits +
// 0x1000) with the low 13 bits cleared); small = x - big (exact) rounded
// the same way, left with its low 13 bits set, which the tensor cores do
// not read. Four integer and float instructions, where cvt.rna.tf32.f32
// compiles to a longer sequence that also screens for NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += a b: one m16n8k8 product of TF32 operands, summed in f32
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 blocks of 16-bit values (here 8 x 4 f32) from shared memory,
// lane l giving the address of row l % 8 of block l / 8
__device__ __forceinline__ void ldsm4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The attention kernels' tiles: a box of 64 16-bit columns (128 bytes, one
// swizzle row) x 64 rows, 8 KB; D = 128 takes two column boxes, D = 256
// four.
constexpr int kBoxRows = 64;
constexpr int kBox = 64 * kBoxRows * 2;

// the tensor-map type of a 16-bit element type
template <typename T>
constexpr CUtensorMapDataType kMapType =
    kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// a (B, H, L, D) tensor of T (bf16 or f16) read through its (batch, head,
// row) strides in elements (unit stride on D) as the 4-D map (D, L, H, B),
// in boxes of 64 columns x kBoxRows rows with the 128-byte swizzle; rows
// past L read as zeros
template <typename T>
inline bool encode_bhld(CUtensorMap* map, const void* base, int B, int H,
                        int len, int d, const Strides& st) {
  static_assert(sizeof(T) == 2, "bf16 or f16 tiles");
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)len, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.l * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)kBoxRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, kMapType<T>, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 1-D maps' box: kBoxRows f32 values and 4 more. A TMA box starts on a
// 16-byte boundary in global memory (a start that is not faults the load:
// an illegal instruction on the card), so a caller wanting the kBoxRows
// values from index c loads from c & ~3 and skips c & 3 values in.
constexpr int kRowsBox = kBoxRows + 4;

// n contiguous f32 values as a 1-D map, in boxes of kRowsBox values (272
// bytes, unswizzled); values past n read as zeros
inline bool encode_rows(CUtensorMap* map, const float* base, long long n) {
  const EncodeTiled fn = encode_tiled();
  if (!fn || n <= 0 || n >= (1LL << 31)) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};               // rank 1: not read
  const cuuint32_t box[1] = {(cuuint32_t)kRowsBox};
  const cuuint32_t unit[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace mxt
