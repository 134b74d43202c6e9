// Host C++20 stand-ins for the CUDA pieces that the split-TF32 wide
// backward (flash_attention_wide.cu's second part) uses, so that its body
// compiles with g++ and runs on the CPU: one std::thread a CUDA thread,
// a std::barrier a block (__syncthreads) and a warp; ldmatrix and
// mma.sync m16n8k8 .tf32 exchange their fragments through the warp's
// slots. An mma sums its 8 products and the addend in double and cuts the
// result toward zero to f32, as the tensor cores do (NO_TRUNC rounds to
// nearest instead). cp.async is a copy (or zero fill): blocks run one
// after another or in parallel, each with its own shared memory.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <memory>
#include <thread>
#include <vector>
#include <type_traits>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct int2 { int x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; memcpy(&f, &u, 4); return f; }
using std::min; using std::max;
inline thread_local uint3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline thread_local unsigned char* g_smem;
inline thread_local std::barrier<>* g_block;
struct Warp {
  std::barrier<>* bar;
  unsigned addr[32];
  uint32_t a[32][4], b[32][2];
  float c[32][4];
};
inline thread_local Warp* g_warps;
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline Warp& my_warp() { return g_warps[threadIdx.x / 32]; }
namespace mxt {
inline unsigned smem_u32(const void* p) {
  return (unsigned)((const unsigned char*)p - g_smem);
}
inline void cp_async16(void* dst, const void* src, bool full) {
  if (full) memcpy(dst, src, 16); else memset(dst, 0, 16);
}
inline void cp_async4(void* dst, const void* src, bool full) {
  if (full) memcpy(dst, src, 4); else memset(dst, 0, 4);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
// ldmatrix .x4 .b16 on 32-bit words: lane l gets word l % 4 of row l / 4
// of each block j, whose rows' addresses lanes 8 j .. 8 j + 7 gave
inline void ldsm4(unsigned addr, uint32_t (&r)[4]) {
  Warp& w = my_warp();
  const int lane = threadIdx.x & 31;
  w.addr[lane] = addr;
  w.bar->arrive_and_wait();
  for (int j = 0; j < 4; ++j)
    memcpy(&r[j], g_smem + w.addr[8 * j + lane / 4] + 4 * (lane % 4), 4);
  w.bar->arrive_and_wait();
}
inline double tf32(uint32_t x) { return (double)__uint_as_float(x & 0xffffe000u); }
// d += a b, m16n8k8 tf32; the sum of 8 products and the addend in double,
// cut toward zero to f32 (the tensor cores' rounding)
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  Warp& w = my_warp();
  const int lane = threadIdx.x & 31;
  memcpy(w.a[lane], a, 16); w.b[lane][0] = b0; w.b[lane][1] = b1;
  memcpy(w.c[lane], d, 16);
  w.bar->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double s = w.c[(row % 8) * 4 + col / 2][(row >= 8) * 2 + col % 2];
    for (int k = 0; k < 8; ++k) {
      const double av = tf32(w.a[(row % 8) * 4 + k % 4][(row >= 8) + 2 * (k >= 4)]);
      const double bv = tf32(w.b[col * 4 + k % 4][k >= 4]);
      s += av * bv;
    }
    float f = (float)s;
#ifndef NO_TRUNC
    if (std::fabs((double)f) > std::fabs(s)) f = std::nextafter(f, 0.f);
#endif
    d[e] = f;
  }
  w.bar->arrive_and_wait();
}
}  // namespace mxt
