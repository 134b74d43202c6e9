// Small helpers shared by the hand-written kernels of this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mxt {

// Element type codes passed from the Python wrappers.
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// f32 to T, rounded to nearest even; past f16's 65504 that is inf
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and widened back: the value a 16-bit product operand
// holds (x itself for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Two 16-bit values of T (bf16 or f16) in one 32-bit word, lo in the low
// half: pack2 rounds two f32 values to nearest even into one, widen2 reads
// one back as f32.
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  static_assert(sizeof(T) == 2, "a 16-bit type");
  if constexpr (kIsHalf<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  }
}
template <typename T>
__device__ __forceinline__ float2 widen2(unsigned w) {
  static_assert(sizeof(T) == 2, "a 16-bit type");
  if constexpr (kIsHalf<T>) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  } else {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
}

// 16 bytes global -> shared without passing through registers (cp.async.cg,
// through L2); with `full` false nothing is read and the 16 bytes are
// zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes global -> shared (cp.async.ca: the only form that copies fewer
// than 16), zero-filled where `full` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0) : "memory");
}
// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive values from shared memory, widened to f32
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <typename T, typename = std::enable_if_t<sizeof(T) == 2>>
__device__ __forceinline__ void lds4(const T* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = widen2<T>(q.x), hi = widen2<T>(q.y);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// four consecutive values to global memory (16 bytes f32, 8 bytes bf16 or
// f16)
__device__ __forceinline__ void stg4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T, typename = std::enable_if_t<sizeof(T) == 2>>
__device__ __forceinline__ void stg4(T* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]));
}

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// The attention kernels' tiles and products (flash_attention.cu and
// flash_attention_bwd.cu).
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// (batch, head, row) strides of a (B, H, L, D) tensor, in elements; the
// stride on D is 1
struct Strides {
  long long b, h, l;
};

// A staged tile of rows of D values of T, unpadded and swizzled: the
// 16-byte chunk c of row r sits at chunk c ^ (r & 7) (within its group of
// 8 chunks, 128 bytes). A row is a multiple of 128 bytes (D = 64, 128 or
// 256).
template <typename T, int D>
struct Swizzled {
  static constexpr int E = 16 / (int)sizeof(T);    // values a chunk
  static constexpr int CPR = D / E;                 // chunks a row
  static_assert(CPR % 8 == 0, "a row is whole swizzle groups");
  // element offset of value e of row r
  static __device__ __forceinline__ int at(int r, int e) {
    return r * D + (((e / E) ^ (r & 7)) * E) + e % E;
  }
};

// Rows [r0, r0 + ROWS) of a (n, D) matrix read through row stride `ld`
// into the swizzled tile `dst` by the THREADS threads of the block, 16
// bytes a copy (cp.async), rows at or past n zero-filled.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ld,
                                      int r0, int n) {
  using G = Swizzled<T, D>;
  static_assert((ROWS * G::CPR) % THREADS == 0,
                "every thread issues as many copies");
#pragma unroll
  for (int i = 0; i < ROWS * G::CPR / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / G::CPR, c = (idx % G::CPR) * G::E;
    const bool in = r0 + r < n;
    cp_async16(dst + G::at(r, c), in ? src + (r0 + r) * ld + c : src, in);
  }
}

// A warp's lanes form a grid of TR row groups x TC = 32 / TR column groups:
// lane (tr, tc) owns rows tr + TR i (i < RI) and columns tc + TC j (j < NJ)
// of a score piece, and columns 4 tc + 4 TC m (+0..3) of a sum over the
// streamed rows.
//
// A warp's f32 tile of NS values a row (a score tile: P, or dS), laid out
// so that both the lanes' 4-byte writes of their pieces and their 16-byte
// reads along a row land in distinct banks: the 4-value chunk c of row r
// sits at c ^ ((r mod TR) * 8 / TR).
template <int NS, int TR>
__device__ __forceinline__ int xat(int r, int p) {
  static_assert(NS % 32 == 0 && (TR == 4 || TR == 8), "one swizzle a row");
  return r * NS + (((p >> 2) ^ ((r & (TR - 1)) * (8 / TR))) << 2) + (p & 3);
}

// acc[i][j] = sum_d a[row tr + TR i][d] * b[row tc + TC j][d]: a lane's
// RI x NJ piece of a score tile from two swizzled tiles (`a` at the warp's
// first row), four D-steps a 16-byte read (8 bytes in bf16). D is walked one
// swizzle group (8 chunks) at a time, so that the chunk's place in the group
// is known to the compiler: rows tr + TR i share tr's swizzle up to a
// constant XOR ((TR i) & 7), and so do columns tc + TC j, so a D-step costs
// a few XORs of addresses.
template <typename T, int D, int TR, int RI, int NJ>
__device__ __forceinline__ void score(float (&acc)[RI][NJ], const T* a,
                                      const T* b, int tr, int tc) {
  using G = Swizzled<T, D>;
  constexpr int E = G::E, TC = 32 / TR;
  const int pa = G::at(tr, 0), pb = G::at(tc, 0);
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int g = 0; g < D; g += 8 * E, a += 8 * E, b += 8 * E) {
#pragma unroll
    for (int d = 0; d < 8 * E; d += 4) {
      const int lo = (d / E) * E, hi = d % E;
      float av[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        lds4(a + ((pa ^ lo ^ (((TR * i) & 7) * E)) + hi) + TR * i * D,
             av[i]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float bv[4];
        lds4(b + ((pb ^ lo ^ (((TC * j) & 7) * E)) + hi) + TC * j * D, bv);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j] = fmaf(av[i][e], bv[e], acc[i][j]);
      }
    }
  }
}

// acc[i][4m + e] += sum_p x[row tr + TR i][p] * b[p][4 tc + 4 TC m + e]:
// a lane's rows of the warp's score tile `x` (NS values a row, laid out by
// xat) times the swizzled tile `b` of NS rows, four rows of b a 16-byte read
// of x, 8 rows of b (one swizzle pattern each) a step.
template <typename T, int D, int NS, int TR, int RI>
__device__ __forceinline__ void accumulate(
    float (&acc)[RI][4 * (D / (128 / TR))], const float* x, const T* b,
    int tr, int tc) {
  using G = Swizzled<T, D>;
  constexpr int TC = 32 / TR, MD = D / (4 * TC);
#pragma unroll 1
  for (int p0 = 0; p0 < NS; p0 += 8, b += 8 * D) {
#pragma unroll
    for (int p = 0; p < 8; p += 4) {
      float xv[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        lds4(x + xat<NS, TR>(tr + TR * i, p0 + p), xv[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int m = 0; m < MD; ++m) {
          float bv[4];
          lds4(b + G::at(p + kk, 4 * tc + 4 * TC * m), bv);
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][4 * m + e] = fmaf(xv[i][kk], bv[e], acc[i][4 * m + e]);
        }
    }
  }
}

}  // namespace mxt
