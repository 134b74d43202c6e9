// FlashAttention-2 backward, written for Hopper (sm_90a): two kernels, dQ
// and dK/dV.
//
// Replaces: incubator_mxnet_tpu/ops/pallas/flash_attention.py, `_dq_kernel`
// (called from `_bwd` at its first pallas_call) and `_dkv_kernel` (its
// second). Same function, given the forward's O and per-row lse and
// delta = rowsum(dO * O) (computed by the caller, as `_bwd` does in XLA):
//
//   P  = exp(scale * Q K^T - lse), masked    dP = dO V^T
//   dS = P * (dP - delta) * scale
//   dQ = dS K        dK = dS^T Q        dV = P^T dO
//
// with the forward's masks: bottom-right causal (row r sees keys
// c <= r + lk - lq), keys at or past `kv_len` masked, ragged tiles masked in
// place. The mask is a select, not a product, so a row that sees no key
// (lse = -inf in the port's forward) gives dQ = 0 and adds nothing to dK/dV
// instead of inf * 0 = NaN.
//
// What bounds it on the card: operations. At B=8, H=12, L=512, D=64 causal
// (131,328 (query, key) pairs a head) the dQ kernel does 6*pairs*D flops
// (S, dP, dQ) and the dK/dV kernel 8*pairs*D (S, dP, dV, dK) against
// 4*L*D inputs and 1-2*L*D outputs a head: over 500 flop per f32 element
// moved, far above the H100's ridge of about 20 flop/byte between 67 TFLOP/s
// f32 (outside the tensor cores; the main paths run f32 with TF32 off) and
// 3.35 TB/s: 0.0723 ms (dQ) and 0.0963 ms (dK/dV) at that shape.
//
// The split stays the TPU kernels': two kernels, no atomics, the same bits
// on every call (the recompute of S and dP is its price: 14 instead of 10
// x pairs x D flops). The TPU kernels carried dQ (resp. dK, dV) in scratch
// across a sequential grid axis; blocks on the card run in no order, so
// that axis is a loop inside the block, with the sums in registers. Both
// kernels are one design with the roles of the operands swapped:
//
//   kernel  block owns (resident)      loops over (streamed)     sums
//   dQ      64 query rows: Q, dO, and  32-key tiles: K, V         dS K
//           their lse, delta
//   dK/dV   64 keys: K, V              32-row query tiles: Q, dO  P^T dO,
//                                      and their lse, delta       dS^T Q
//
// What the design does about what held the first version (PR 2's) back:
// - Shared-memory instructions set the pace (2.7 FMAs a load). Every tile
//   is row-major with rows of D values, and every product reads its
//   operands 16 bytes at a time (8 in bf16) along its reduction axis: D for
//   S = Q K^T and dP = dO V^T, the streamed index for the second products,
//   whose left side (dS or P) a warp keeps in a tile of its own in the
//   layout it reads. A warp owns 16 resident rows; lane (tr, tc) of its
//   4 x 8 grid owns rows tr + 4i (i < 4) and streamed columns tc + 8j
//   (j < 4) of the score tile, and value columns 4 tc + 32 m (+0..3) of the
//   sums. A 16-byte read feeds 8 FMAs in S and dP, 10.7 in the second
//   products (D = 64; 12.8 at D = 128), and the lanes of a warp share their
//   reads (the 4 row groups read the same streamed row, the 8 column groups
//   the same resident row). Tiles are unpadded and swizzled: 16-byte chunk c
//   of row r sits at c ^ (r & 7), so the 8 rows a warp reads at one D-step,
//   and the copies that fill them, land in 8 distinct groups of 4 banks; a
//   lane's rows share their swizzle two by two and its columns all have
//   tc's, so the swizzle costs three XORs of addresses a D-step. The dS/P
//   tiles (32 floats a row) swizzle by 2 (r & 3), so neither the lanes'
//   4-byte writes nor their 16-byte reads conflict. S and dP are formed
//   one after the other (S -> P in place, then dP -> dS); dK/dV pushes P
//   through dV's product before dP and reads it back for dS, so one tile
//   a warp and no P registers span dP. A warp's dS and P never leave it:
//   __syncwarp, not a block barrier, orders their writes and reads.
// - Staging was scalar and never overlapped compute. Tiles arrive by
//   16-byte cp.async (through L2, no registers, zero-filled past the end of
//   a sequence), lse and delta by 4-byte cp.async, and the streamed tile is
//   double-buffered: tile t + 1 is in flight while tile t is computed, and
//   one __syncthreads a tile both publishes tile t and frees the buffer
//   that tile t + 1 refills. bf16 inputs are staged as bf16 and widened at
//   the shared-memory read.
// - Occupancy and the causal tail. In f32 at D = 64 a block takes 128
//   threads, 72.5 KB of shared memory and (as ptxas builds it) 168
//   registers a thread, so 3 blocks, 12 warps, fit an SM; the grid at the
//   LM's shape is 96 x 8 = 768 blocks, 1.9 waves of 396. Blocks are issued
//   heavy first: blockIdx.y counts query tiles down from the last (dQ: the
//   tile that sees the most keys) and key tiles up from 0 (dK/dV: the tile
//   that the most queries see), so the longest blocks start in the first
//   wave and the short ones fill the tail. (Pairing tile y with tile
//   n - 1 - y in one block would balance the blocks too, but halves them
//   to 384, under one wave of 396.) A warp skips a tile that the causal
//   mask or kv_len hides from all of its rows, and applies the mask only
//   where the tile and its rows straddle an edge.
// - What bounds the design now, as far as its timings on an NVIDIA H100
//   80GB HBM3 at 700 W tell (PERF.md, PR 6):
//   the path from shared memory to registers (taken as 128 bytes a cycle
//   an SM, where a 16-byte read delivers 512 bytes to a warp, broadcast or
//   not). A 4 x 4 score piece needs 2 bytes a FMA, the 4 x 8 sums 1.5,
//   which caps these tiles near 55% of the FMA peak; larger pieces need a
//   wider streamed tile and fewer blocks an SM.
// - D = 128 uses the same tiles: 137 KB, one block of 4 warps an SM.
//
// The products run on the FMA units (no tensor cores), so f32 matches the
// plain version to f32 rounding; bf16 inputs are widened to f32 and the
// gradients rounded once at the end. Each sum runs in a fixed order.
//
// Q, K, V and dO are read, and dQ, dK and dV written, through (batch, head,
// row) strides with a unit stride on the head dimension, so the (B, L, H, D)
// views that multi-head attention cuts out of one fused QKV projection go in
// without a copy, and the gradients can be written as (B, L, H, D). The
// 16-byte copies need 16-byte aligned rows: the wrapper copies any input
// whose pointer or strides are not (no main path has one).
#include "common.cuh"

namespace mxt {
namespace {

constexpr int kRes = 64;        // resident rows a block
constexpr int kStr = 32;        // streamed rows a tile
constexpr int kThreads = 2 * kRes;  // one warp per 16 resident rows
constexpr int kNJ = kStr / 8;   // streamed columns a lane

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B*H, lq), natural log
  const float* delta;  // (B*H, lq)
  void* dq;
  void* dk;
  void* dv;
  int H, lq, lk;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  float scale;
  int causal;
  int kv_len;
};

// The swizzled tiles of common.cuh, sized for these kernels: Res1, Res2,
// two stages of (Str1, Str2), then f32: the warps' dS or P tiles, then the
// lse and delta of the resident rows (dQ) or of two stages of streamed rows
// (dK/dV): 2 kRes = 4 kStr values either way.
template <typename T, int D>
struct Tile : Swizzled<T, D> {
  static constexpr int MD = D / 32;                 // 4-column runs a lane
  static constexpr int RES = kRes * D;              // one resident tile
  static constexpr int STR = kStr * D;              // one streamed tile
  static constexpr size_t SMEM =
      sizeof(T) * (2 * (size_t)RES + 4 * (size_t)STR) +
      sizeof(float) * ((size_t)kRes * kStr + 2 * kRes);
  static_assert(2 * kRes == 4 * kStr && 2 * kRes <= kThreads,
                "one lse or delta copy a thread");
};

// The body of both kernels. dQ (DKV false): resident Q, dO; streamed K, V.
// dK/dV (DKV true): resident K, V; streamed Q, dO (and their lse, delta).
template <typename T, int D, bool DKV>
__device__ __forceinline__ void bwd_body(const BwdArgs& a) {
  using G = Tile<T, D>;
  constexpr int MD = G::MD;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  T* const res1 = reinterpret_cast<T*>(bwd_smem);
  T* const res2 = res1 + G::RES;
  T* const str = res2 + G::RES;                 // stage s: + 2 s STR
  float* const xs = reinterpret_cast<float*>(str + 4 * G::STR);
  float* const rows = xs + kRes * kStr;         // stage s: lse, delta

  const int tid = threadIdx.x;
  const int w = tid >> 5, tr = (tid >> 3) & 3, tc = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  // heavy first: dQ's last query tile sees the most keys, dK/dV's first key
  // tile is seen by the most queries
  const int r0 = (DKV ? (int)blockIdx.y : (int)(gridDim.y - 1 - blockIdx.y))
                 * kRes;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const T* r1 = DKV ? kb : qb;
  const T* r2 = DKV ? vb : dob;
  const T* s1 = DKV ? qb : kb;
  const T* s2 = DKV ? dob : vb;
  const long long lr1 = DKV ? a.sk.l : a.sq.l, lr2 = DKV ? a.sv.l : a.sdo.l;
  const long long ls1 = DKV ? a.sq.l : a.sk.l, ls2 = DKV ? a.sdo.l : a.sv.l;
  const int n_res = DKV ? lk : lq, n_str = DKV ? lq : lk;
  const size_t lrow = (size_t)bh * lq;          // lse and delta of this head

  // the streamed tiles this block meets
  int t_begin = 0, t_end;
  if (DKV) {
    // query tiles that see these keys: none if every key is at or past
    // kv_len; for causal from the first row r with r0 <= r + offset
    t_end = (lq + kStr - 1) / kStr;
    if (a.causal) t_begin = max(0, r0 - offset) / kStr;
    if (r0 >= kv_lim) t_begin = t_end;
  } else {
    // key tiles up to kv_len, and for causal up to the diagonal of the
    // block's last real row
    t_end = (kv_lim + kStr - 1) / kStr;
    if (a.causal) {
      const int last_col = min(r0 + kRes, lq) - 1 + offset;
      t_end = min(t_end, last_col < 0 ? 0 : last_col / kStr + 1);
    }
  }

  // lse and delta of the N query rows from `row0` into dst[0, N) and
  // dst[N, 2N), zero past lq
  auto stage_lse = [&](float* dst, int row0, int N) {
    if (tid < 2 * N) {
      const int row = row0 + tid % N;
      const float* src = (tid < N ? a.lse : a.delta) + lrow;
      const bool in = row < lq;
      cp_async4(dst + tid, in ? src + row : src, in);
    }
  };
  auto stage_streamed = [&](int t, int slot) {
    T* d1 = str + 2 * slot * G::STR;
    stage<T, D, kStr, kThreads>(d1, s1, ls1, t * kStr, n_str);
    stage<T, D, kStr, kThreads>(d1 + G::STR, s2, ls2, t * kStr, n_str);
    if (DKV) stage_lse(rows + slot * 2 * kStr, t * kStr, kStr);
  };

  if (t_begin < t_end) {
    stage<T, D, kRes, kThreads>(res1, r1, lr1, r0, n_res);
    stage<T, D, kRes, kThreads>(res2, r2, lr2, r0, n_res);
    if (!DKV) stage_lse(rows, r0, kRes);
    stage_streamed(t_begin, 0);
  }
  cp_async_commit();
  const float sl2 = a.scale * kLog2e;

  float acc1[4][4 * MD], acc2[DKV ? 4 : 1][DKV ? 4 * MD : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * MD; ++j) acc1[i][j] = 0.f;
  if constexpr (DKV) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * MD; ++j) acc2[i][j] = 0.f;
  }

  const T* const a1 = res1 + 16 * w * D;        // this warp's rows
  const T* const a2 = res2 + 16 * w * D;
  float* const wx = xs + 16 * w * kStr;         // this warp's dS or P

  for (int t = t_begin; t < t_end; ++t) {
    const int slot = (t - t_begin) & 1;
    // tile t has landed; every warp is done with tile t - 1's buffer
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < t_end) stage_streamed(t + 1, slot ^ 1);
    cp_async_commit();

    const T* const b1 = str + 2 * slot * G::STR;
    const T* const b2 = b1 + G::STR;
    const float* const rs = rows + slot * 2 * kStr;
    const int c0 = t * kStr;

    // the query rows [rlo, rhi) and keys [klo, khi) of the warp's piece:
    // none visible (skipped), all visible (no mask), or some
    const int w0 = r0 + 16 * w;
    const int rlo = DKV ? c0 : w0, rhi = rlo + (DKV ? kStr : 16);
    const int klo = DKV ? w0 : c0, khi = klo + (DKV ? 16 : kStr);
    if (rlo >= lq || klo >= kv_lim ||
        (a.causal && klo > rhi - 1 + offset))
      continue;
    const bool all = rhi <= lq && khi <= kv_lim &&
                     (!a.causal || khi - 1 <= rlo + offset);
    // lse and delta of the lane's query rows: one a row (dQ) or a column
    const float* const lse = DKV ? rs : rows;
    const float* const delta = lse + (DKV ? kStr : kRes);
    auto row_of = [&](int i, int j) {
      return DKV ? tc + 8 * j : 16 * w + tr + 4 * i;
    };

    float s[4][kNJ], dp[4][kNJ];
    score<T, D, 4, 4, kNJ>(s, a1, b1, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
        s[i][j] = s[i][j] * sl2 - lse[row_of(i, j)] * kLog2e;
    if (all) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) s[i][j] = exp2f(s[i][j]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = w0 + tr + 4 * i;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int cj = c0 + tc + 8 * j;
          const int row = DKV ? cj : ri, key = DKV ? ri : cj;
          const bool ok = row < lq && key < kv_lim &&
                          (!a.causal || key <= row + offset);
          s[i][j] = ok ? exp2f(s[i][j]) : 0.f;
        }
      }
    }
    if constexpr (DKV) {
      // dV += P^T dO through the warp's tile, which then takes dS^T; P is
      // read back from it rather than held in registers across dP
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          wx[xat<kStr, 4>(tr + 4 * i, tc + 8 * j)] = s[i][j];
      __syncwarp();
      accumulate<T, D, kStr, 4, 4>(acc2, wx, b2, tr, tc);
      __syncwarp();
    }
    score<T, D, 4, 4, kNJ>(dp, a2, b2, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int x = xat<kStr, 4>(tr + 4 * i, tc + 8 * j);
        const float p = DKV ? wx[x] : s[i][j];
        wx[x] = p * (dp[i][j] - delta[row_of(i, j)]) * a.scale;
      }
    __syncwarp();
    accumulate<T, D, kStr, 4, 4>(acc1, wx, b1, tr, tc);    // dS K, or dS^T Q
  }

  // dQ, or dK and dV, of the lane's rows, four columns a store
  T* const o1 = static_cast<T*>(DKV ? a.dk : a.dq) +
                b * (DKV ? a.sdk.b : a.sdq.b) + h * (DKV ? a.sdk.h : a.sdq.h);
  const long long lo1 = DKV ? a.sdk.l : a.sdq.l;
  T* const o2 = DKV ? static_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h
                    : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 16 * w + tr + 4 * i;
    if (row >= n_res) continue;
#pragma unroll
    for (int m = 0; m < MD; ++m) {
      const int col = 4 * tc + 32 * m;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc1[i][4 * m + e];
      stg4(o1 + row * lo1 + col, v);
      if constexpr (DKV) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc2[i][4 * m + e];
        stg4(o2 + row * a.sdv.l + col, v);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdArgs a) {
  bwd_body<T, D, false>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const BwdArgs a) {
  bwd_body<T, D, true>(a);
}

template <typename T, int D>
cudaError_t launch(bool dkv, const BwdArgs& a, int B, cudaStream_t s) {
  const auto kernel =
      dkv ? flash_bwd_dkv_kernel<T, D> : flash_bwd_dq_kernel<T, D>;
  const size_t smem = Tile<T, D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.H, ((dkv ? a.lk : a.lq) + kRes - 1) / kRes);
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dkv, const BwdArgs& a, int B, int d,
                     cudaStream_t s) {
  if (d == 64) return launch<T, 64>(dkv, a, B, s);
  if (d == 128) return launch<T, 128>(dkv, a, B, s);
  return cudaErrorInvalidValue;
}

int run(bool dkv, const BwdArgs& a, int B, int d, int dtype, int device,
        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || a.H <= 0 || (dkv ? a.lk : a.lq) <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)dispatch<float>(dkv, a, B, d, s);
  if (dtype == kBFloat16) return (int)dispatch<__nv_bfloat16>(dkv, a, B, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mxt

// q: (B, H, lq, d); k, v: (B, H, lk, d); dout and dq: (B, H, lq, d), each
// given by its (batch, head, row) strides in elements with a unit stride on
// d and 16-byte aligned rows; lse and delta: (B, H, lq) contiguous f32.
// Returns the CUDA error of the launch.
extern "C" int mxt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int lq, int lk,
    int d, int dtype, long long sqb, long long sqh, long long sql,
    long long skb, long long skh, long long skl, long long svb, long long svh,
    long long svl, long long sdob, long long sdoh, long long sdol,
    long long sdqb, long long sdqh, long long sdql, float scale, int causal,
    int kv_len, int device, void* stream) {
  mxt::BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.H = H; a.lq = lq; a.lk = lk;
  a.sq = {sqb, sqh, sql}; a.sk = {skb, skh, skl}; a.sv = {svb, svh, svl};
  a.sdo = {sdob, sdoh, sdol}; a.sdq = {sdqb, sdqh, sdql};
  a.scale = scale; a.causal = causal; a.kv_len = kv_len;
  return mxt::run(false, a, B, d, dtype, device, stream);
}

// As above, with dk and dv: (B, H, lk, d) given by their strides.
extern "C" int mxt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int lq, int lk, int d, int dtype, long long sqb, long long sqh,
    long long sql, long long skb, long long skh, long long skl, long long svb,
    long long svh, long long svl, long long sdob, long long sdoh,
    long long sdol, long long sdkb, long long sdkh, long long sdkl,
    long long sdvb, long long sdvh, long long sdvl, float scale, int causal,
    int kv_len, int device, void* stream) {
  mxt::BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk; a.dv = dv;
  a.H = H; a.lq = lq; a.lk = lk;
  a.sq = {sqb, sqh, sql}; a.sk = {skb, skh, skl}; a.sv = {svb, svh, svl};
  a.sdo = {sdob, sdoh, sdol}; a.sdk = {sdkb, sdkh, sdkl};
  a.sdv = {sdvb, sdvh, sdvl};
  a.scale = scale; a.causal = causal; a.kv_len = kv_len;
  return mxt::run(true, a, B, d, dtype, device, stream);
}
