// FlashAttention-2 backward at head dims above 256, dQ and dK/dV, for
// Hopper (sm_90a), the head dim D a runtime multiple of 64 above 256 (the
// wrapper pads 257-319 to 320, and so on), in two forms, each part of this
// file with its own note: f32 runs `flash_bwd_dq_wide_tf32x3_kernel<float>`
// and `flash_bwd_dkv_wide_tf32x3_kernel<float>` on the tensor cores by
// split TF32 (the second part); bf16 and f16 run `flash_bwd_dq_wide_kernel
// <T>` and `flash_bwd_dkv_wide_kernel<T>` on the FMA units (the first
// part). The forward above 256 is flash_attention.cu's
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
// What bounds them on the card: operations, 6 pairs D flops for dQ and 8
// for dK/dV against about 4 L D elements moved a head. At
// (2, 4, 512, 512, 512) dQ's 6.4 GFLOP take 0.0390 ms by split TF32 (three
// TF32 products at 495 TFLOP/s) or 0.0962 ms on the FMA units, against
// 0.0100 ms for its 33.6 MB; in bf16 and f16 0.0065 ms on the tensor cores
// (989 TFLOP/s).
//
// ---------------------------------------------------------------------------
// The bf16 and f16 kernels, on the FMA units.
//
// What the design does about the bound: little yet. It is the simplest
// design that is right at any D; its speed is later work. Every product
// runs on the FMA units with f32 sums, each sum in one fixed order and no
// atomics, so two calls give the same bits. No accumulator row of D values
// fits registers at D = 512, so the D columns of dQ (of dK and dV) are
// split over blockIdx.z in chunks of 64: a block of 4 warps owns 64 rows
// (queries; keys for dK/dV) and one chunk, and streams the whole D of
// Q K^T and of dO V^T through shared memory in 64-column pieces for every
// tile of 64 keys (queries), so each of the D / 64 blocks of a row tile
// recomputes S and dP: at D = 512 they are computed 8 times, and dQ and
// dK/dV do 34 and 36 pairs D flops for their 6 and 8. Each staged tile is
// f32 (the 16-bit types widened on the way in), 64 rows of 64 values
// padded to 65, so that a lane's reads along a row and down a column fall
// in distinct banks; lane (tr, tc) of a warp's 4 x 8 grid owns rows
// tr + 4 i (i < 4) and columns tc + 8 j (j < 8) of a 64 x 64 score tile and
// of its 64 x 64 accumulator, whose rows' P (dS) go through shared memory
// for the second product. Each 64-column piece of a score and each tile's
// share of an accumulator is a fresh f32 sum folded into the total, which
// keeps f32 rounding close to a blocked sum's. Loads are plain (no cp.async
// stages), 12 shared reads feed 32 FMAs: a bound on the design near a third
// of the FMA units' peak before the recompute. The f32 instances of this
// design were 5.21x SDPA's whole backward (PERF.md) and are not built.
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
#include "hopper.cuh"

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

// 16 bytes of T (bf16 or f16) at p (16-byte aligned), widened to f32
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = widen2<T>(u[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
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
  static_assert(sizeof(T) == 2, "bf16 and f16: f32 runs the split-TF32 "
                                  "kernels below");
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
  static_assert(sizeof(T) == 2, "bf16 and f16: f32 runs the split-TF32 "
                                  "kernels below");
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

// bf16 or f16: flash_bwd_dq_wide_kernel<T> or flash_bwd_dkv_wide_kernel<T>
template <typename T>
cudaError_t launch_bwd(bool dkv, const Args& a, int B, cudaStream_t s) {
  if (dkv) return launch<T>(flash_bwd_dkv_wide_kernel<T>, a, B, a.lk, 4, s);
  return launch<T>(flash_bwd_dq_wide_kernel<T>, a, B, a.lq, 3, s);
}

// ---------------------------------------------------------------------------
// The f32 kernels, on the tensor cores by split TF32:
// `flash_bwd_dq_wide_tf32x3_kernel<float>` and
// `flash_bwd_dkv_wide_tf32x3_kernel<float>`. They join the D = 256
// split-TF32 backward (`x3_body` of flash_attention_bwd.cu: mma.sync m16n8k8
// .tf32 three times a product, big.big in one chain and the small terms in
// another, each tile's share of a sum folded in with f32 rounding) with the
// streaming of D of the wide f32 forward (`flash_fwd_wide_tf32x3_kernel` of
// flash_attention.cu), in place of the FMA design above, whose f32
// instances took 1.5972 and 1.6164 ms at (2, 4, 512, 512, 512), 5.21x
// SDPA's whole backward.
//
// What bounds them: 6 (dQ) and 8 (dK/dV) pairs D flops, by split TF32 at
// 495 / 3 TFLOP/s of f32 work: 0.0390 and 0.0521 ms at (2, 4, 512, 512,
// 512), 0.0782 and 0.1043 ms at the LM's (8, 4, 512, 512, 512) causal.
//
// What the design does about it:
// - The FMA units: every product is on the tensor cores, as at D = 256.
// - The recompute: a block owns 64 rows (dQ: queries; dK/dV: keys) and a
//   chunk of up to 256 of the output's columns, the grid is
//   (B * H * chunks, ceil(rows / 64)) with the ceil(D / 256) chunks of a
//   row tile side by side on blockIdx.x, so that they read the same
//   streamed tiles from L2 at about the same time, and blocks are issued
//   heavy first on blockIdx.y (dQ: the last query tile; dK/dV: the first
//   key tile). S and dP are summed once a chunk: at D = 512 dQ does 10
//   pairs D flops for its 6 and dK/dV 12 for its 8 (the FMA design: 34 and
//   36). (2, 4, 512, 512, 512) is 8 heads x 8 row tiles x 2 chunks = 128
//   blocks, one an SM, one wave of 132.
// - No tile stays resident (at D = 512 a 64-row f32 tile is 128 KB): for
//   each streamed tile of 64 rows (dQ: keys; dK/dV: queries) S and dP
//   (S^T and dP^T in dK/dV) are summed over the whole of D a 64-column
//   piece at a time, a unit of the ring carrying the four pieces of one
//   64 columns (Q, K, dO, V; 64 KB). A warp of a 16-row group takes 16 of
//   the tile's streamed rows and sums its 16 x 16 of S and of dP, a fresh
//   pair of chains a piece (8 k-steps of ldmatrix A and B, split as read),
//   folded in f32. One unit for both products halves the block barriers
//   of a unit each (96 mma a warp a barrier, as the D = 256 kernels'):
//   7-12% faster than a unit for each (PERF.md). lse is given, so
//   P = exp(scale S - lse) needs no row exchange: the warp forms P and
//   dS = P (dP - delta) scale itself, the mask a select, and puts them in
//   its group's exchange (dQ: dS, 4 KB; dK/dV: P^T and dS^T, 8 KB), lane
//   for lane in the accumulator's layout.
// - The second products stream too. Holding the tile's dO and Q chunks
//   (64 KB each) beside the ring and the exchanges would need more than
//   the 227 KB a block may use, so the chunk is taken in turn: a unit of
//   the ring also holds half a chunk (the tile's 64 rows x 128 columns,
//   32 KB), and every warp sums 32 columns of each half: dQ += dS K over
//   K's halves (32 registers a lane), dV += P^T dO over dO's halves, then
//   dK += dS^T Q over Q's (64 registers a lane), A from the group's
//   exchange (k-permuted: k = t is streamed row 2t, k = t + 4 row 2t + 1,
//   so a lane's own slot is its A fragment) and B split as it is read
//   from the unit, each 16 streamed rows' product in a partial of its own
//   folded in f32. So all 16 warps work on every unit, the units of every
//   phase run through one ring (kWStages slots, kWAhead in flight, one
//   __syncthreads a unit, which also publishes the exchange; 4 slots and
//   3 ahead timed the same), and the block takes 208 KB (dQ) or 225 KB
//   (dK/dV: lse and delta of a query tile by 4-byte cp.async with its
//   first unit, two tiles' worth by parity). A half past D is neither
//   loaded nor summed, nor its columns stored (D = 320's last chunk: one
//   half of 64 real columns).
// - Masks and skipping: a warp whose 16 x 16 piece no pair of sees skips
//   its S and dP products and puts zeros in the exchange; a group skips
//   the second products of 16 streamed rows that none of its rows sees
//   (their dS and P are exact zeros, so the skip keeps every bit); a
//   piece that straddles an edge is masked by a select, so a row that
//   sees no key (lse -inf) gives 0, never NaN.
// Every sum runs in a fixed order and nothing is atomic: the same bits on
// every call. ptxas: 128 registers each; dQ spills 4 bytes, dK/dV 344.
// Measured (PERF.md, on an NVIDIA H100 80GB HBM3 at 700 W): at (2, 4,
// 512, 512, 512) dQ 0.2794-0.2814 ms and dK/dV 0.3589-0.3673, together
// 1.03x SDPA's whole f32 backward (0.6163), 38 and 36 TFLOP/s of f32 work
// counting the recompute; at the LM's causal shape 0.6269-0.6317 and
// 0.8003-0.8089 ms, 1.29x SDPA's 1.1092-1.1205; errors against float64
// 0.2-1.0x the f32 plain version's.
// ---------------------------------------------------------------------------

constexpr int kW = 64;          // rows a block, rows a streamed tile,
                                // columns a piece
constexpr int kWCols = 256;     // the output's columns a block (a chunk)
constexpr int kWHalf = 128;     // columns of a chunk's half, a unit
constexpr int kWThreads = 512;  // 16 warps: four a 16-row group
constexpr int kWStages = 3;     // ring slots of a unit each
constexpr int kWAhead = 2;      // units in flight ahead of the one used
static_assert(kWAhead < kWStages, "a unit's slot is free when it is loaded");

template <bool DKV>
struct X3 {
  static constexpr int UNIT = 4 * kW * kW;   // floats: four pieces, or a
                                             // half (the first 32 KB)
  static constexpr int XCH = 8 * 32 * 4;     // a group's 16 x 64 exchange
  static constexpr int XCHS = DKV ? 8 : 4;   // exchanges (dK/dV: P^T, dS^T)
  static constexpr int ROWS = DKV ? 4 * kW : 0;  // 2 tiles' lse and delta
  static constexpr size_t SMEM =
      sizeof(float) * (kWStages * (size_t)UNIT + XCHS * (size_t)XCH + ROWS);
  static_assert(UNIT >= kW * kWHalf, "a half fits a unit");
};

// The body of both kernels. dQ (DKV false): resident rows are queries (Q,
// dO), streamed tiles keys (K, V), sum dS K. dK/dV (DKV true): resident
// rows are keys (K, V), streamed tiles queries (Q, dO, lse, delta), sums
// P^T dO and dS^T Q. Warp w: 16-row group w / 4, quarter w % 4 (its 16
// streamed rows of a tile in S and dP, its 32 columns of each half in the
// sums).
template <bool DKV>
__device__ __forceinline__ void x3_wide_body(const Args& a) {
  using G = X3<DKV>;
  using Half = Swizzled<float, kWHalf>;
  extern __shared__ __align__(128) unsigned char wx_smem[];
  float* const ring = reinterpret_cast<float*>(wx_smem);  // slot s: + s UNIT
  float* const xch = ring + kWStages * G::UNIT;   // group p: + p XCH; dK/dV
                                                  // dS^T at + (4 + p) XCH
  float* const rows = xch + G::XCHS * G::XCH;     // dK/dV tile t: + (t & 1)
                                                  // 2 kW: lse, then delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;       // the accumulator's layout
  const int d = a.d, np = d / kW;               // 64-column pieces of D
  const int nch = (d + kWCols - 1) / kWCols;
  const int bh = blockIdx.x / nch, chunk = blockIdx.x % nch;
  const int c0 = chunk * kWCols;                // the chunk's first column
  const int vcols = min(kWCols, d - c0);        // its real columns
  const int nh = (vcols + kWHalf - 1) / kWHalf; // its halves with any
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  const int r0 = (DKV ? (int)blockIdx.y : (int)(gridDim.y - 1 - blockIdx.y))
                 * kW;
  const int w0 = r0 + 16 * grp;                 // the group's first row

  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* r1 = DKV ? kb : qb;
  const float* r2 = DKV ? vb : dob;
  const float* s1 = DKV ? qb : kb;
  const float* s2 = DKV ? dob : vb;
  const long long lr1 = DKV ? a.sk.l : a.sq.l, lr2 = DKV ? a.sv.l : a.sdo.l;
  const long long ls1 = DKV ? a.sq.l : a.sk.l, ls2 = DKV ? a.sdo.l : a.sv.l;
  const int n_res = DKV ? lk : lq, n_str = DKV ? lq : lk;
  const size_t lrow = (size_t)bh * lq;          // lse and delta of the head

  // whether query rows [qlo, qhi) see any key of [klo, khi), and all of
  // them (every row real, every pair unmasked)
  auto sees = [&](int qlo, int qhi, int klo, int khi) {
    return qlo < lq && klo < kv_lim &&
           (!a.causal || klo <= min(qhi, lq) - 1 + offset);
  };
  auto sees_all = [&](int qlo, int qhi, int klo, int khi) {
    return qhi <= lq && khi <= kv_lim &&
           (!a.causal || khi - 1 <= qlo + offset);
  };
  // the resident rows [rlo, rhi) against streamed rows [slo, shi)
  auto meet = [&](int rlo, int rhi, int slo, int shi) {
    return DKV ? sees(slo, shi, rlo, rhi) : sees(rlo, rhi, slo, shi);
  };
  auto meet_all = [&](int rlo, int rhi, int slo, int shi) {
    return DKV ? sees_all(slo, shi, rlo, rhi) : sees_all(rlo, rhi, slo, shi);
  };

  // the streamed tiles [t_begin, t_end): dQ the key tiles up to kv_len and,
  // causal, the diagonal of the block's last real row; dK/dV the query
  // tiles that see its keys, none if every key is at or past kv_len
  int t_begin = 0, t_end;
  if (DKV) {
    t_end = (lq + kW - 1) / kW;
    if (a.causal) t_begin = max(0, r0 - offset) / kW;
    if (r0 >= kv_lim) t_begin = t_end;
  } else {
    t_end = (kv_lim + kW - 1) / kW;
    if (a.causal) {
      const int last_col = min(r0 + kW, lq) - 1 + offset;
      t_end = min(t_end, last_col < 0 ? 0 : last_col / kW + 1);
    }
  }
  // a tile's units in the order they are used: np of pieces (a resident
  // and a streamed one for S, then for dP: Q, K, dO, V in dQ; K, Q, V, dO
  // in dK/dV), then the sums' halves (dQ: K's; dK/dV: dO's, then Q's),
  // each at the start of its slot. Unit u + kWAhead is loaded while unit
  // u is used, one copy group each (empty past the end), so that waiting
  // for all but kWAhead - 1 groups waits for unit u.
  const int upt = np + (DKV ? 2 : 1) * nh;
  const int units = max(0, t_end - t_begin) * upt;
  auto issue = [&](int u) {
    if (u < units) {
      const int t = t_begin + u / upt, i = u % upt, s0 = t * kW;
      float* const dst = ring + (u % kWStages) * G::UNIT;
      if (i < np) {
        const int p = i * kW;
        // (mxt::stage: wide::stage, the FMA kernels' staging, hides it)
        mxt::stage<float, kW, kW, kWThreads>(dst, r1 + p, lr1, r0, n_res);
        mxt::stage<float, kW, kW, kWThreads>(dst + kW * kW, s1 + p, ls1, s0,
                                             n_str);
        mxt::stage<float, kW, kW, kWThreads>(dst + 2 * kW * kW, r2 + p, lr2,
                                             r0, n_res);
        mxt::stage<float, kW, kW, kWThreads>(dst + 3 * kW * kW, s2 + p, ls2,
                                             s0, n_str);
        if (DKV && i == 0 && tid < 2 * kW) {
          // the tile's lse, then its delta, zero past lq
          const int row = s0 + tid % kW;
          const float* src = (tid < kW ? a.lse : a.delta) + lrow;
          const bool in = row < lq;
          cp_async4(rows + (t & 1) * 2 * kW + tid, in ? src + row : src, in);
        }
      } else {
        // half hh of the chunk's columns of the tile (Swizzled<float,
        // kWHalf>), zeros past D
        const int j = i - np;
        const bool dk = DKV && j >= nh;
        const int hh = dk ? j - nh : j;
        const float* src = (DKV ? (dk ? qb : dob) : kb) + c0 + kWHalf * hh;
        const long long ld = DKV ? (dk ? a.sq.l : a.sdo.l) : a.sk.l;
        const int cols = vcols - kWHalf * hh;
        constexpr int CPR = kWHalf / 4;
#pragma unroll
        for (int n = 0; n < kW * CPR / kWThreads; ++n) {
          const int idx = tid + n * kWThreads;
          const int r = idx / CPR, c = (idx % CPR) * 4;
          const bool in = s0 + r < n_str && c < cols;
          cp_async16(dst + Half::at(r, c), in ? src + (s0 + r) * ld + c : src,
                     in);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < kWAhead; ++u) issue(u);
  int u = 0;
  // unit u has landed and every warp is done with unit u - 1's slot (and,
  // before a tile's first sum, every warp's P and dS are in the exchange)
  auto next = [&]() {
    cp_async_wait<kWAhead - 1>();
    __syncthreads();
    issue(u + kWAhead);
    return ring + (u++ % kWStages) * G::UNIT;
  };

  // S or dP by ldmatrix from a pair of 64-column pieces (rows of 256
  // bytes, Swizzled<float, kW>; A's piece, then B's), as in
  // flash_fwd_wide_tf32x3_kernel: A the group's 16 resident rows, B the
  // warp's 16 streamed rows; step s of a 32-column group reads chunk
  // (2 s + x) ^ mi = (2 s ^ (mi & 6)) + (x ^ (mi & 1)): a base and an XOR
  // of 32 s
  const int mj = lane >> 3, mi = lane & 7;
  const unsigned a_row = (unsigned)((16 * grp + 8 * (mj & 1) + mi) * 256 +
                                    (((mj >> 1) ^ (mi & 1)) << 4));
  const unsigned b_row = (unsigned)(kW * kW * 4 +
                                    (16 * wq + 8 * (mj >> 1) + mi) * 256 +
                                    (((mj & 1) ^ (mi & 1)) << 4));
  const unsigned m6 = (unsigned)(mi & 6) << 4;
  // sum[n][e] += this warp's 16 x 16 over the pair's 64 columns: element
  // (n, e) is resident row g + 8 (e >> 1), streamed row 16 wq + 8 n + 2 t4
  // + (e & 1); big.big in one chain, the small terms in another, the piece
  // folded in with f32 rounding
  auto piece = [&](float (&sum)[2][4], const float* pair) {
    const unsigned base = smem_u32(pair);
    float f[2][2][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[x][n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t ar[4], ab[4], as[4], br[4], bb[4], bs[4];
        ldsm4(base + a_row + ((32 * s) ^ m6) + 128 * c, ar);
        ldsm4(base + b_row + ((32 * s) ^ m6) + 128 * c, br);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(__uint_as_float(ar[e]), ab[e], as[e]);
          split_tf32(__uint_as_float(br[e]), bb[e], bs[e]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_tf32(f[1][n], as, bb[2 * n], bb[2 * n + 1]);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_tf32(f[1][n], ab, bs[2 * n], bs[2 * n + 1]);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_tf32(f[0][n], ab, bb[2 * n], bb[2 * n + 1]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[n][e] += f[0][n][e] + f[1][n][e];
  };

  // acc[h][n][e] += the group's A (16 x 64, from its exchange x4) times
  // the warp's 32 columns of a half (64 x 128, in `unit`): element (n, e)
  // is row g + 8 (e >> 1), column 32 wq + 8 n + 2 t4 + (e & 1) of the half.
  // B is rows 2 t4 (b0) and 2 t4 + 1 (b1) of each 8-row step, columns
  // 32 wq + 8 n + g: under the swizzle 8 (n ^ t4) + g and 8 (n ^ t4) +
  // (g ^ 4) on from 32 wq. A 16 streamed rows that the group does not meet
  // (dS and P zero there) are skipped.
  auto times = [&](float (&acc)[4][4], const float4* x4, const float* unit,
                   int s0) {
    const float* const bl = unit + 2 * t4 * kWHalf + 32 * wq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!meet(w0, w0 + 16, s0 + 16 * j, s0 + 16 * j + 16)) continue;
      uint32_t pb[2][4], ps[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float4 q = x4[(2 * j + kk) * 32 + lane];
        const float ax[4] = {q.x, q.z, q.y, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(ax[e], pb[kk][e], ps[kk][e]);
      }
#pragma unroll
      for (int u0 = 0; u0 < 4; u0 += 2) {
        float q[2][4];
#pragma unroll
        for (int uu = 0; uu < 2; ++uu)
#pragma unroll
          for (int e = 0; e < 4; ++e) q[uu][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* const bt = bl + (2 * j + kk) * 8 * kWHalf;
          uint32_t bb[2][2], bs[2][2];
#pragma unroll
          for (int uu = 0; uu < 2; ++uu) {
            const int x = 8 * ((u0 + uu) ^ t4);
            split_tf32(bt[x + g], bb[uu][0], bs[uu][0]);
            split_tf32(bt[kWHalf + x + (g ^ 4)], bb[uu][1], bs[uu][1]);
          }
#pragma unroll
          for (int uu = 0; uu < 2; ++uu)
            mma_tf32(q[uu], ps[kk], bb[uu][0], bb[uu][1]);
#pragma unroll
          for (int uu = 0; uu < 2; ++uu)
            mma_tf32(q[uu], pb[kk], bs[uu][0], bs[uu][1]);
#pragma unroll
          for (int uu = 0; uu < 2; ++uu)
            mma_tf32(q[uu], pb[kk], bb[uu][0], bb[uu][1]);
        }
#pragma unroll
        for (int uu = 0; uu < 2; ++uu)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u0 + uu][e] += q[uu][e];
      }
    }
  };

  const float sl2 = a.scale * kLog2e;
  // dQ: lse (times log2 e) and delta of the lane's two query rows
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = w0 + g + 8 * i;
      if (row < lq && t_begin < t_end) {
        lse_r[i] = a.lse[lrow + row] * kLog2e;
        dl_r[i] = a.delta[lrow + row];
      }
    }
  }
  // the sums: acc[role][h] holds the warp's 32 columns of half h (dQ: dQ;
  // dK/dV: role 0 dV, role 1 dK)
  float acc[DKV ? 2 : 1][2][4][4];
#pragma unroll
  for (int r = 0; r < (DKV ? 2 : 1); ++r)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][hh][n][e] = 0.f;
  float4* const xp = reinterpret_cast<float4*>(xch + grp * G::XCH);
  float4* const xs = reinterpret_cast<float4*>(xch + (4 + grp) * G::XCH);

  for (int t = t_begin; t < t_end; ++t) {
    const int s0 = t * kW, sw = s0 + 16 * wq;
    // the warp's 16 x 16: none visible (its products skipped), all
    // visible (no mask), or some
    const bool wmeet = meet(w0, w0 + 16, sw, sw + 16);
    const bool wall = meet_all(w0, w0 + 16, sw, sw + 16);
    float sa[2][4], dpa[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[n][e] = dpa[n][e] = 0.f;
    for (int i = 0; i < np; ++i) {
      const float* const unit = next();
      if (wmeet) {
        piece(sa, unit);
        piece(dpa, unit + 2 * kW * kW);
      }
    }
    // P and dS = P (dP - delta) scale of the warp's 16 x 16, to the
    // exchange: dQ dS; dK/dV P^T and dS^T (delta per query, a column)
    const float* const rs = rows + (t & 1) * 2 * kW;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = w0 + g + 8 * (e >> 1);
        const int si = sw + 8 * n + 2 * t4 + (e & 1);
        const float l2 = DKV ? rs[si - s0] * kLog2e : lse_r[e >> 1];
        const float dl = DKV ? rs[kW + si - s0] : dl_r[e >> 1];
        float p = exp2f(sa[n][e] * sl2 - l2);
        if (!wall) {
          // a select, so that an lse of -inf gives 0, not NaN
          const int row = DKV ? si : ri, key = DKV ? ri : si;
          p = wmeet && row < lq && key < kv_lim &&
              (!a.causal || key <= row + offset) ? p : 0.f;
        }
        pv[e] = p;
        dsv[e] = p * (dpa[n][e] - dl) * a.scale;
      }
      const int at = (2 * wq + n) * 32 + lane;
      if (DKV) xp[at] = make_float4(pv[0], pv[1], pv[2], pv[3]);
      (DKV ? xs : xp)[at] = make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    // the sums, a half a unit: dQ += dS K; dK/dV dV += P^T dO, then
    // dK += dS^T Q. A group that meets none of the tile skips them.
    const bool gmeet = meet(w0, w0 + 16, s0, s0 + kW);
#pragma unroll
    for (int r = 0; r < (DKV ? 2 : 1); ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (hh >= nh) continue;
        const float* const unit = next();
        if (gmeet && kWHalf * hh + 32 * wq < vcols)
          times(acc[r][hh], DKV && r ? xs : xp, unit, s0);
      }
  }

  // the warp's 32 columns of each half of the chunk, rows g and g + 8 of
  // the group, two columns a store; dK/dV role 0 is dV, role 1 dK. A block
  // that saw no tile writes its zeros: the outputs are torch.empty buffers.
#pragma unroll
  for (int r = 0; r < (DKV ? 2 : 1); ++r) {
    const Strides so = DKV ? (r ? a.sdk : a.sdv) : a.sdq;
    float* const o = static_cast<float*>(DKV ? (r ? a.dk : a.dv) : a.dq) +
                     b * so.b + h * so.h + c0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = kWHalf * hh + 32 * wq;
      if (col >= vcols) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = w0 + g + 8 * i;
        if (row >= n_res) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<float2*>(o + row * so.l + col + 8 * n + 2 * t4) =
              make_float2(acc[r][hh][n][2 * i], acc[r][hh][n][2 * i + 1]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWThreads, 1)
flash_bwd_dq_wide_tf32x3_kernel(const Args a) {
  static_assert(std::is_same<T, float>::value, "f32");
  x3_wide_body<false>(a);
}

template <typename T>
__global__ void __launch_bounds__(kWThreads, 1)
flash_bwd_dkv_wide_tf32x3_kernel(const Args a) {
  static_assert(std::is_same<T, float>::value, "f32");
  x3_wide_body<true>(a);
}

// f32: a split-TF32 kernel on the grid (B * H * chunks, ceil(rows / 64)),
// opted in to its dynamic shared memory and the largest carveout first; D
// must be a multiple of 64 above 256
template <bool DKV>
cudaError_t launch_x3(const Args& a, int B, cudaStream_t s) {
  const long long x = (long long)B * a.H * ((a.d + kWCols - 1) / kWCols);
  if (a.d <= 256 || a.d % kW || x >= (1LL << 31)) return cudaErrorInvalidValue;
  const auto kernel = DKV ? flash_bwd_dkv_wide_tf32x3_kernel<float>
                          : flash_bwd_dq_wide_tf32x3_kernel<float>;
  constexpr size_t smem = X3<DKV>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)x, ((DKV ? a.lk : a.lq) + kW - 1) / kW);
  kernel<<<grid, kWThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace
}  // namespace mxt
