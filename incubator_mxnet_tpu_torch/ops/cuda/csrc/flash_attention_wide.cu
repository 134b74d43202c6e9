// FlashAttention-2 backward at head dims above 256, dQ and dK/dV, for
// Hopper (sm_90a) in f32, bf16 and f16: `flash_bwd_dq_wide_kernel<T>` and
// `flash_bwd_dkv_wide_kernel<T>`, T float, __nv_bfloat16 or __half, the
// head dim D a runtime multiple of 64 above 256 (the wrapper pads 257-319
// to 320, and so on). The forward above 256 is flash_attention.cu's
// (`flash_fwd_wide_wgmma_kernel`, `flash_fwd_wide_tf32x3_kernel`).
//
// Not a library of its own: flash_attention_bwd.cu includes this file, and
// its C entry points send D > 256 here.
//
// Replaces: incubator_mxnet_tpu/ops/pallas/flash_attention.py, `_dq_kernel`
// and `_dkv_kernel` (from `_bwd`, at :237 and :254), which run any head
// dim, padded to 128 lanes (:319). Same function as the kernels at D <= 256
// (flash_attention_bwd.cu, whose note gives the semantics): f32 scores and
// sums, dS rounded to the operand type before dS K and dS^T Q, P^T dO from
// P rounded to dO's type, lse and delta given by the caller; bottom-right
// causal masking (row r sees keys c <= r + lk - lq), keys at or past kv_len
// masked, ragged tiles masked in place, and a row that sees no key gives
// dQ = 0 and nothing to dK/dV.
//
// What bounds them on the card: operations in f32, 6 pairs D flops for dQ
// and 8 for dK/dV against about 4 L D elements moved a head. At
// (2, 4, 512, 512, 512) dQ's 6.4 GFLOP take 0.0390 ms by split TF32 or 0.0962
// ms on the FMA units, against 0.0100 ms for its 33.6 MB; in bf16 and f16
// 0.0065 ms on the tensor cores (989 TFLOP/s).
//
// What the design does about it: little yet. It is the simplest design that
// is right at any D; its speed is later work. Every product runs
// on the FMA units with f32 sums, in all three types (f32 stays exact f32,
// no TF32), each sum in one fixed order and no atomics, so two calls give
// the same bits. No accumulator row of D values fits registers at D = 512,
// so the D columns of dQ (of dK and dV) are split over blockIdx.z in
// chunks of 64: a block of 4 warps owns 64 rows (queries; keys for dK/dV)
// and one chunk, and streams the whole D of Q K^T and of dO V^T through
// shared memory in 64-column pieces for every tile of 64 keys (queries),
// so each of the D / 64 blocks of a row tile recomputes S and dP: at
// D = 512 they are computed 8 times, and dQ and dK/dV do 34 and 36 pairs D
// flops for their 6 and 8. Each staged tile is f32
// (the 16-bit types widened on the way in), 64 rows of 64 values padded to
// 65, so that a lane's reads along a row and down a column fall in
// distinct banks; lane (tr, tc) of a warp's 4 x 8 grid owns rows
// tr + 4 i (i < 4) and columns tc + 8 j (j < 8) of a 64 x 64 score tile and
// of its 64 x 64 accumulator, whose rows' P (dS) go through shared memory
// for the second product. Each 64-column piece of a score and each tile's
// share of an accumulator is a fresh f32 sum folded into the total, which
// keeps f32 rounding close to a blocked sum's. Loads are plain (no cp.async
// stages), 12 shared reads feed 32 FMAs: a bound on the design near a third
// of the FMA units' peak before the recompute.
#include "common.cuh"

namespace mxt {
namespace {
namespace wide {

constexpr int kX = 64;                   // rows a block, keys a tile, columns
                                         // a chunk and a streamed piece
constexpr int kLd = kX + 1;              // a staged row, padded
constexpr int kTile = kX * kLd;          // floats a staged tile
constexpr int kThreads = 128;            // 4 warps of 16 rows
constexpr int kRI = 4;                   // rows a lane
constexpr int kNJ = 8;                   // columns a lane
constexpr float kNeg = -1e30f;           // a row max before any key

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;      // (B*H, lq)
  const float* delta;    // (B*H, lq)
  void* dq;
  void* dk;
  void* dv;
  int H, lq, lk, d;
  Strides sq, sk, sv, sdo, so, sdq, sdk, sdv;
  float scale;
  int causal;
  int kv_len;
};

template <typename T>
__device__ __forceinline__ const T* head(const void* p, const Strides& s,
                                         int b, int h) {
  return static_cast<const T*>(p) + b * s.b + h * s.h;
}

// 16 bytes of T at p (16-byte aligned), widened to f32
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[16 / sizeof(T)]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(w.x); v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z); v[3] = __uint_as_float(w.w);
  } else {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = widen2<T>(u[i]);
      v[2 * i] = f.x; v[2 * i + 1] = f.y;
    }
  }
}

// Rows [r0, r0 + kX) and columns [c0, c0 + kX) of one head (row stride ld),
// widened to f32 into the padded tile dst; rows at or past n are zeros.
// Every thread of the block takes part.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ld,
                                      int r0, int n, int c0) {
  constexpr int E = 16 / sizeof(T), V = kX / E;
  for (int i = threadIdx.x; i < kX * V; i += kThreads) {
    const int r = i / V, c = (i % V) * E;
    float v[E];
    if (r0 + r < n) {
      load16<T>(src + (r0 + r) * ld + c0 + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) dst[r * kLd + c + e] = v[e];
  }
}

// acc[i][j] += sum_e a[r + 4 i][e] b[c + 8 j][e] over one 64-column piece
// (a score tile's share), summed apart and folded in
__device__ __forceinline__ void dot_rows(float (&acc)[kRI][kNJ],
                                         const float* a, const float* b,
                                         int r, int c) {
  float part[kRI][kNJ] = {};
#pragma unroll 4
  for (int e = 0; e < kX; ++e) {
    float x[kRI], y[kNJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i) x[i] = a[(r + 4 * i) * kLd + e];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) y[j] = b[(c + 8 * j) * kLd + e];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) part[i][j] = fmaf(x[i], y[j], part[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] += part[i][j];
}

// acc[i][j] += sum_p x[r + 4 i][p] w[p][c + 8 j] over one tile of 64 (a
// tile's share of an accumulator), summed apart and folded in
__device__ __forceinline__ void times_tile(float (&acc)[kRI][kNJ],
                                           const float* x, const float* w,
                                           int r, int c) {
  float part[kRI][kNJ] = {};
#pragma unroll 4
  for (int p = 0; p < kX; ++p) {
    float xv[kRI], wv[kNJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i) xv[i] = x[(r + 4 * i) * kLd + p];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) wv[j] = w[p * kLd + c + 8 * j];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) part[i][j] = fmaf(xv[i], wv[j], part[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] += part[i][j];
}

// whether query `row` sees key `col`
__device__ __forceinline__ bool visible(const Args& a, int row, int col) {
  return row < a.lq && col < a.kv_len &&
         (!a.causal || col <= row + a.lk - a.lq);
}

// one past the last key that a query tile from q0 sees
__device__ __forceinline__ int key_end(const Args& a, int q0) {
  int end = a.kv_len;
  if (a.causal) end = min(end, min(q0 + kX, a.lq) + a.lk - a.lq);
  return end;
}

// S (64 x 64, scores of this block's rows against the tile's columns)
// summed over the whole of D, one staged piece of each at a time
template <typename T>
__device__ __forceinline__ void scores(float (&s)[kRI][kNJ], float* ta,
                                       float* tb, const T* ra, long long lda,
                                       int r0, int nr, const T* rb,
                                       long long ldb, int c0, int nc, int D,
                                       int r, int c) {
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) s[i][j] = 0.f;
  for (int p0 = 0; p0 < D; p0 += kX) {
    __syncthreads();                 // the tiles' last readers are done
    stage<T>(ta, ra, lda, r0, nr, p0);
    stage<T>(tb, rb, ldb, c0, nc, p0);
    __syncthreads();
    dot_rows(s, ta, tb, r, c);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const Args a) {
  extern __shared__ __align__(16) float wide_smem[];
  float* ta = wide_smem;
  float* tb = ta + kTile;
  float* ts = tb + kTile;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kX, c0 = blockIdx.z * kX;
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 3), c = lane & 7;
  const T* q = head<T>(a.q, a.sq, b, h);
  const T* k = head<T>(a.k, a.sk, b, h);
  const T* v = head<T>(a.v, a.sv, b, h);
  const T* dout = head<T>(a.dout, a.sdo, b, h);
  const long long rows = (long long)blockIdx.x * a.lq;
  float lse[kRI], dl[kRI], acc[kRI][kNJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int row = q0 + r + 4 * i;
    lse[i] = row < a.lq ? a.lse[rows + row] : 0.f;
    dl[i] = row < a.lq ? a.delta[rows + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  }
  const int kend = key_end(a, q0);
  for (int k0 = 0; k0 < kend; k0 += kX) {
    float s[kRI][kNJ], dp[kRI][kNJ];
    scores<T>(s, ta, tb, q, a.sq.l, q0, a.lq, k, a.sk.l, k0, a.lk, a.d, r, c);
    scores<T>(dp, ta, tb, dout, a.sdo.l, q0, a.lq, v, a.sv.l, k0, a.lk, a.d,
              r, c);
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        // a select, so that an lse of -inf gives 0, not NaN
        const float p = visible(a, q0 + r + 4 * i, k0 + c + 8 * j)
                            ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        ts[(r + 4 * i) * kLd + c + 8 * j] =
            round_to<T>(p * (dp[i][j] - dl[i]) * a.scale);
      }
    __syncthreads();
    stage<T>(tb, k, a.sk.l, k0, a.lk, c0);
    __syncthreads();
    times_tile(acc, ts, tb, r, c);
  }
  T* dq = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int row = q0 + r + 4 * i;
    if (row >= a.lq) continue;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      dq[row * a.sdq.l + c0 + c + 8 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const Args a) {
  extern __shared__ __align__(16) float wide_smem[];
  float* ta = wide_smem;
  float* tb = ta + kTile;
  float* tp = tb + kTile;
  float* ts = tp + kTile;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  // key tiles in order: under the causal mask the first sees the most
  // queries
  const int k0 = blockIdx.y * kX, c0 = blockIdx.z * kX;
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 3), c = lane & 7;
  const T* q = head<T>(a.q, a.sq, b, h);
  const T* k = head<T>(a.k, a.sk, b, h);
  const T* v = head<T>(a.v, a.sv, b, h);
  const T* dout = head<T>(a.dout, a.sdo, b, h);
  const long long rows = (long long)blockIdx.x * a.lq;
  float dk[kRI][kNJ], dv[kRI][kNJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  // the first query tile that sees a key of this tile
  int qbegin = a.lq;
  if (k0 < a.kv_len)
    qbegin = a.causal ? max(0, k0 - (a.lk - a.lq)) / kX * kX : 0;
  for (int q0 = qbegin; q0 < a.lq; q0 += kX) {
    // S^T and dP^T: rows are this tile's keys, columns the queries
    float st[kRI][kNJ], dpt[kRI][kNJ];
    scores<T>(st, ta, tb, k, a.sk.l, k0, a.lk, q, a.sq.l, q0, a.lq, a.d, r, c);
    scores<T>(dpt, ta, tb, v, a.sv.l, k0, a.lk, dout, a.sdo.l, q0, a.lq, a.d,
              r, c);
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int row = q0 + c + 8 * j;
      const float lse = row < a.lq ? a.lse[rows + row] : 0.f;
      const float dl = row < a.lq ? a.delta[rows + row] : 0.f;
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const float p = visible(a, row, k0 + r + 4 * i)
                            ? expf(st[i][j] * a.scale - lse) : 0.f;
        tp[(r + 4 * i) * kLd + c + 8 * j] = round_to<T>(p);
        ts[(r + 4 * i) * kLd + c + 8 * j] =
            round_to<T>(p * (dpt[i][j] - dl) * a.scale);
      }
    }
    __syncthreads();
    stage<T>(ta, dout, a.sdo.l, q0, a.lq, c0);
    stage<T>(tb, q, a.sq.l, q0, a.lq, c0);
    __syncthreads();
    times_tile(dv, tp, ta, r, c);
    times_tile(dk, ts, tb, r, c);
  }
  T* gk = static_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  T* gv = static_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int key = k0 + r + 4 * i;
    if (key >= a.lk) continue;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      gk[key * a.sdk.l + c0 + c + 8 * j] = from_f32<T>(dk[i][j]);
      gv[key * a.sdv.l + c0 + c + 8 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

// A wide kernel on a grid of (B*H, row tiles, D / 64) blocks with `tiles`
// staged tiles of shared memory; D must be a multiple of 64 above 256.
template <typename T>
cudaError_t launch(void (*kernel)(Args), const Args& a, int B, int rows,
                   int tiles, cudaStream_t s) {
  if (a.d <= 256 || a.d % kX) return cudaErrorInvalidValue;
  const int smem = tiles * kTile * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.H, (rows + kX - 1) / kX, a.d / kX);
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(bool dkv, const Args& a, int B, cudaStream_t s) {
  if (dkv) return launch<T>(flash_bwd_dkv_wide_kernel<T>, a, B, a.lk, 4, s);
  return launch<T>(flash_bwd_dq_wide_kernel<T>, a, B, a.lq, 3, s);
}

}  // namespace wide
}  // namespace
}  // namespace mxt
