// FlashAttention-2 backward, written for Hopper (sm_90a): two kernels, dQ
// and dK/dV, in three forms, each part of this file with its own note. f32
// at head dims 64 and 128 runs `flash_bwd_dq_kernel` and
// `flash_bwd_dkv_kernel` on the FMA units (the first part); f32 at 256 runs
// `flash_bwd_dq_tf32x3_kernel` and `flash_bwd_dkv_tf32x3_kernel` on the
// tensor cores by split TF32, mma.sync (the second part); bf16 and f16 run
// `flash_bwd_dq_wgmma_kernel` and `flash_bwd_dkv_wgmma_kernel` on the
// tensor cores, wgmma fed by TMA (the third part; one template for both
// 16-bit types), at every head dim up to 256. Above 256 f32 runs
// `flash_bwd_dq_wide_tf32x3_kernel` and `flash_bwd_dkv_wide_tf32x3_kernel`
// by split TF32, bf16 and f16 `flash_bwd_dq_wide_wgmma_kernel` and
// `flash_bwd_dkv_wide_wgmma_kernel` on the tensor cores, wgmma fed by TMA
// (flash_attention_wide.cu, included here).
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
// instead of inf * 0 = NaN. In bf16 and f16, as the TPU kernels do, P is
// rounded to the input type before P^T dO and dS before dS K and dS^T Q
// (in f16 a dS past 65504 is inf, as the cast makes it); every sum is f32.
//
// The split stays the TPU kernels': two kernels, no atomics, the same bits
// on every call (the recompute of S and dP is its price: 14 instead of 10
// x pairs x D flops). The TPU kernels carried dQ (resp. dK, dV) in scratch
// across a sequential grid axis; blocks on the card run in no order, so
// that axis is a loop inside the block, with the sums in registers. Both
// kernels of a form are one design with the roles of the operands swapped:
//
//   kernel  block owns (resident)      loops over (streamed)     sums
//   dQ      64 query rows: Q, dO, and  key tiles: K, V           dS K
//           their lse, delta
//   dK/dV   64 keys: K, V              query tiles: Q, dO, and   P^T dO,
//                                      their lse, delta          dS^T Q
//
// Blocks are issued heavy first: blockIdx.y counts query tiles down from
// the last (dQ: the tile that sees the most keys) and key tiles up from 0
// (dK/dV: the tile that the most queries see), so the longest blocks start
// in the first wave and the short ones fill the tail. A block skips a
// streamed tile that the causal mask or kv_len hides from all of its rows,
// and masks only where a tile crosses an edge.
//
// ---------------------------------------------------------------------------
// The f32 kernels, on the FMA units.
//
// What bounds them on the card: operations. At B=8, H=12, L=512, D=64
// causal (131,328 (query, key) pairs a head) the dQ kernel does 6*pairs*D
// flops (S, dP, dQ) and the dK/dV kernel 8*pairs*D (S, dP, dV, dK) against
// 4*L*D inputs and 1-2*L*D outputs a head: over 500 flop per f32 element
// moved, far above the H100's ridge of about 20 flop/byte between 67 TFLOP/s
// f32 (outside the tensor cores; the main paths run f32 with TF32 off) and
// 3.35 TB/s: 0.0723 ms (dQ) and 0.0963 ms (dK/dV) at that shape.
//
// A block of 4 warps owns 64 resident rows and streams 32-row tiles. What
// the design does about what held the kernels' first version back:
// - Shared-memory instructions set the pace (2.7 FMAs a load). Every tile
//   is row-major with rows of D values, and every product reads its
//   operands 16 bytes at a time along its reduction axis: D for
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
//   that tile t + 1 refills.
// - Occupancy and the causal tail. At D = 64 a block takes 128 threads,
//   72.5 KB of shared memory and (as ptxas builds it) 168 registers a
//   thread, so 3 blocks, 12 warps, fit an SM; the grid at the LM's shape is
//   96 x 8 = 768 blocks, 1.9 waves of 396. (Pairing tile y with tile
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
//   D = 256 (C5: head dims 129-256, which the wrapper pads to 256) runs
//   the split-TF32 kernels of the second part: these tiles fit it with one
//   stage only, and at 55% of the FMA peak took 3.06x SDPA's whole backward
//   (PERF.md).
//
// The products run on the FMA units (no tensor cores), so f32 matches the
// plain version to f32 rounding. Each sum runs in a fixed order. The
// kernels are built for f32 only, at D = 64 and 128.
//
// Q, K, V and dO are read, and dQ, dK and dV written, through (batch, head,
// row) strides with a unit stride on the head dimension, so the (B, L, H, D)
// views that multi-head attention cuts out of one fused QKV projection go in
// without a copy, and the gradients can be written as (B, L, H, D). The
// 16-byte copies need 16-byte aligned rows: the wrapper copies any input
// whose pointer or strides are not (no main path has one).
#include "common.cuh"
#include "flash_attention_wide.cu"
#include "hopper.cuh"

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
// the two stages of (Str1, Str2), then f32: the warps' dS or P tiles, then
// the lse and delta of the resident rows (dQ) or of the stages of streamed
// rows (dK/dV): 2 kRes >= 4 kStr values either way.
template <typename T, int D>
struct Tile : Swizzled<T, D> {
  static constexpr int RES = kRes * D;              // one resident tile
  static constexpr int STR = kStr * D;              // one streamed tile
  static constexpr size_t SMEM =
      sizeof(T) * (2 * (size_t)RES + 4 * (size_t)STR) +
      sizeof(float) * ((size_t)kRes * kStr + 2 * kRes);
  static_assert(2 * kRes == 4 * kStr && 2 * kRes <= kThreads,
                "one lse or delta copy a thread");
};

// The streamed tiles [first, last) of STR rows that a block of RES
// resident rows from row r0 meets. dK/dV: the query tiles that see its
// keys, none if every key is at or past kv_len, for causal from the first
// row r with r0 <= r + lk - lq. dQ: the key tiles up to kv_len and, for
// causal, up to the diagonal of the block's last real row.
template <bool DKV, int RES, int STR>
__device__ __forceinline__ int2 streamed_tiles(const BwdArgs& a, int r0) {
  const int offset = a.lk - a.lq, kv_lim = min(a.kv_len, a.lk);
  int first = 0, last;
  if (DKV) {
    last = (a.lq + STR - 1) / STR;
    if (a.causal) first = max(0, r0 - offset) / STR;
    if (r0 >= kv_lim) first = last;
  } else {
    last = (kv_lim + STR - 1) / STR;
    if (a.causal) {
      const int last_col = min(r0 + RES, a.lq) - 1 + offset;
      last = min(last, last_col < 0 ? 0 : last_col / STR + 1);
    }
  }
  return make_int2(first, last);
}

// The body of both kernels. dQ (DKV false): resident Q, dO; streamed K, V.
// dK/dV (DKV true): resident K, V; streamed Q, dO (and their lse, delta).
template <typename T, int D, bool DKV>
__device__ __forceinline__ void bwd_body(const BwdArgs& a) {
  static_assert(sizeof(T) == 4 && D <= 128,
                "f32 at D = 64 and 128: bf16 and f16 run the wgmma kernels, "
                "f32 at D = 256 the split-TF32 ones");
  using G = Tile<T, D>;
  constexpr int MD = D / 32;                    // 4-column runs a lane
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

  const int2 tiles = streamed_tiles<DKV, kRes, kStr>(a, r0);
  const int t_begin = tiles.x, t_end = tiles.y;

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
    // dS K, or dS^T Q
    accumulate<T, D, kStr, 4, 4>(acc1, wx, b1, tr, tc);
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

// ---------------------------------------------------------------------------
// The f32 kernels at D = 256, on the tensor cores by split TF32.
//
// Replace: the same two Pallas kernels as the FMA kernels above
// (`_dq_kernel` and `_dkv_kernel` of
// incubator_mxnet_tpu/ops/pallas/flash_attention.py), for f32 at head dims
// 129-256, which the wrapper pads to 256; f32 at 64 and 128 keeps the FMA
// kernels. Same function, masks and outputs.
//
// What bounds them: operations. At (4, 8, 512, 512, 256) without the mask
// dQ does 6 pairs D flops (12.9 GFLOP) and dK/dV 8 pairs D (17.2 GFLOP):
// 0.192 and 0.256 ms at the 67 TFLOP/s of the FMA units, whose tiles above
// reach about 55% of that (shared-memory reads), so that no FMA design
// came near SDPA's whole backward (0.68 ms; the D = 256 instances of the
// FMA kernels took 0.73 and 1.30). Split TF32 does three TF32 products an
// f32 one: 0.078 and 0.104 ms at 495 TFLOP/s. Each operand x is split into
// big = rna(x) and small = rna(x - big), TF32 rounded to nearest with ties
// away from zero (the value cvt.rna.tf32.f32 gives), and a product sums
// small.big + big.big + big.small in f32; small.small, near 2^-22 of the
// product, is dropped. This is CUTLASS's 3xTF32 (OpMultiplyAddFastF32),
// the scheme of SDPA's own f32 backward on this card
// (fmha_cutlassB_f32_*_sm80): f32-class results, not TF32 ones.
//
// The instruction: mma.sync m16n8k8 .tf32, both operands from registers.
// wgmma's .tf32 form reads B from shared memory, K-major only, so B's big
// and small parts would be two tiles there: beside the 64-row resident
// tiles (64 KB each in f32 at D = 256), streamed tiles of 32 rows would
// take 256 KB or more, past the 227 KB a block may use. With mma.sync the
// FMA kernels' swizzled row-major f32 tiles serve every product, the
// transposed ones too, and the split runs in registers as each fragment
// is loaded (CUTLASS's OpMultiplyAddFastF32 issues the same instruction).
// Measured (PERF.md): in every arrangement tried (2 or 4 warps a
// scheduler, 127 to 255 registers, folded sums or not) the kernels issue
// 126-140 TFLOP/s of TF32 products, about a quarter of the TF32 peak and
// 3.8x the split-TF32 bound; by inference (no profiler of the card's
// pipes here) the rate of the mma.sync path, which wgmma would pass.
//
// What the design does about what held the FMA instances back:
// - The FMA units: every product is on the tensor cores.
// - One block of 4 warps an SM: a block is 16 warps, four for each 16-row
//   group of its 64 resident rows (dQ: queries; dK/dV: keys), one block an
//   SM (213,248 bytes of shared memory: the two resident tiles, 2 x 64 KB;
//   two stages of the two streamed tiles, 2 x 2 x 16 KB; the stages' lse
//   and delta; a 4 KB exchange a group), 127 registers a thread (dK/dV:
//   128, spilling 16 bytes).
// - One stage: the streamed tiles are 16 rows (dQ: keys; dK/dV: queries)
//   in two stages, in the bytes one 32-row stage took: tile t + 1 is in
//   flight (16-byte cp.async; lse and delta by 4-byte cp.async, so no copy
//   needs an aligned start) while tile t is computed.
// - dK/dV's recompute: the four warps of a group split the work by role
//   and by half of D. In a tile, warps (0, h) form half h of the group's
//   16 x 16 scores (S = Q K^T, or S^T = K Q^T in dK/dV) and warps (1, h)
//   half h of dP (dO V^T, or V dO^T), 128 columns each; the four halves
//   meet through shared memory at a named barrier of the group, lane for
//   lane in the accumulator's layout, and every warp sums S and dP in the
//   same order and forms P and dS. Then in dQ each warp sums dS K into a
//   quarter of dQ's 256 columns (32 registers a lane), and in dK/dV warps
//   (0, h) sum P^T dO into half h of dV and warps (1, h) dS^T Q into half h
//   of dK (64 registers a lane). So S and dP are computed once: 8 pairs D
//   flops, not the 12 of the FMA kernel's split of D over blockIdx.z.
// The products. S and dP read A from the resident tile and B from the
// streamed one along D by ldmatrix (.b16 x4 moves four 8 x 4 f32 blocks,
// one 16-byte chunk a row: conflict-free under the swizzle), big.big in
// one chain and the small terms in another. The sums (dS K, P^T dO,
// dS^T Q) take A straight from the first products' accumulators: a lane
// holds columns 2t and 2t + 1 of its rows, so each 8-step of the sum runs
// its k in permuted order (k = t is column 2t, k = t + 4 column 2t + 1)
// and reads B's rows 2t and 2t + 1 with it, a 4-byte load a value, which
// the swizzle spreads over 32 banks. B is split as it is read.
// The tensor cores cut each mma's sum toward zero (a CPU model that does
// so reproduces the card's errors), so a sum carried in one accumulator
// over all 32 tiles, 6 mma a tile, grew to 7x the plain f32 version's
// error against float64. A tile's share of every sum is formed in a
// partial of its own and folded into the running sum with f32 rounding;
// S and dP meet as two halves of 16 steps: within 1.6x.
// Masks, ragged tiles, the heavy-first order, tile skipping and the
// strides are the FMA kernels'. Every sum runs in a fixed order and
// nothing is atomic: the same bits on every call.
// ---------------------------------------------------------------------------

constexpr int kXD = 256;           // the head dim of these kernels
constexpr int kXRes = 64;          // resident rows a block
constexpr int kXStr = 16;          // streamed rows a tile
constexpr int kXThreads = 512;     // 16 warps: four a 16-row group

struct XTile {
  static constexpr int RES = kXRes * kXD;   // floats of a resident tile
  static constexpr int STR = kXStr * kXD;   // of a streamed tile
  static constexpr int ROWS = 2 * kXStr;    // a stage's lse, then delta
  static constexpr int XCH = 4 * 8 * 32;    // a group: 8 values a lane a warp
  static constexpr size_t SMEM =
      sizeof(float) * (2 * (size_t)RES + 4 * (size_t)STR + 2 * ROWS +
                       (kXRes / 16) * XCH);
};

// The body of both kernels. dQ (DKV false): resident Q, dO; streamed K, V.
// dK/dV (DKV true): resident K, V; streamed Q, dO (and their lse, delta).
// Warp w of a block: 16-row group w / 4, role (w / 2) % 2 (0: S and P,
// with A from Q or K; 1: dP, with A from dO or V) and half w % 2 of D.
template <bool DKV>
__device__ __forceinline__ void x3_body(const BwdArgs& a) {
  constexpr int D = kXD;
  constexpr int NT = DKV ? D / 16 : D / 32;   // 8-column tiles a warp sums
  using G = XTile;
  extern __shared__ __align__(128) unsigned char x3_smem[];
  float* const res1 = reinterpret_cast<float*>(x3_smem);
  float* const res2 = res1 + G::RES;
  float* const str = res2 + G::RES;           // stage s: + 2 s STR
  float* const rows = str + 4 * G::STR;       // stage s: + s ROWS
  float* const xch = rows + 2 * G::ROWS;      // group p: + p XCH

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, role = (warp >> 1) & 1, half = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;      // the accumulator's layout
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  const int r0 = (DKV ? (int)blockIdx.y : (int)(gridDim.y - 1 - blockIdx.y))
                 * kXRes;
  const int w0 = r0 + 16 * grp;                // the group's first row

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
  const size_t lrow = (size_t)bh * lq;         // lse and delta of this head

  const int2 tiles = streamed_tiles<DKV, kXRes, kXStr>(a, r0);
  const int t_begin = tiles.x, t_end = tiles.y;

  auto stage_streamed = [&](int t, int slot) {
    float* d1 = str + 2 * slot * G::STR;
    stage<float, D, kXStr, kXThreads>(d1, s1, ls1, t * kXStr, n_str);
    stage<float, D, kXStr, kXThreads>(d1 + G::STR, s2, ls2, t * kXStr,
                                      n_str);
    if (DKV && tid < 2 * kXStr) {
      // the tile's lse, then its delta, zero past lq
      const int row = t * kXStr + tid % kXStr;
      const float* src = (tid < kXStr ? a.lse : a.delta) + lrow;
      const bool in = row < lq;
      cp_async4(rows + slot * G::ROWS + tid, in ? src + row : src, in);
    }
  };
  if (t_begin < t_end) {
    stage<float, D, kXRes, kXThreads>(res1, r1, lr1, r0, n_res);
    stage<float, D, kXRes, kXThreads>(res2, r2, lr2, r0, n_res);
    stage_streamed(t_begin, 0);
  }
  cp_async_commit();

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

  // S and dP by ldmatrix: lane l addresses row l % 8 of block l / 8. A
  // (resident): blocks are rows 0-7, 8-15, 0-7, 8-15 of the group at
  // columns k..k+3, k..k+3, k+4..k+7, k+4..k+7 (a0-a3); B (streamed):
  // rows 0-7 at k..k+3 and k+4..k+7 (b0, b1 of keys or queries 0-7), then
  // rows 8-15 likewise. Step s of a 32-column swizzle group reads chunk
  // 2 s + h of the row, at (2 s + h) ^ (row & 7); the warp's half of D
  // starts 4 groups (512 bytes) on.
  const int mj = lane >> 3, mi = lane & 7;
  const unsigned a_row = smem_u32(role ? res2 : res1) +
                         (unsigned)((16 * grp + 8 * (mj & 1) + mi) * D * 4 +
                                    512 * half);
  const unsigned b_row = (unsigned)(((8 * (mj >> 1) + mi) * D +
                                     role * G::STR) * 4 + 512 * half);
  unsigned a_at[4], b_at[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a_at[s] = a_row + ((((2 * s) + (mj >> 1)) ^ mi) << 4);
    b_at[s] = b_row + ((((2 * s) + (mj & 1)) ^ mi) << 4);
  }
  // The sums' B: rows 2 t4 (b0) and 2 t4 + 1 (b1) of each 8-row step of
  // the streamed tile (dQ: K; dK/dV: dO for dV, Q for dK), columns
  // d0 + 8 n + g. Under the swizzle column 8 n + g of row 2 t4 sits at
  // 8 (n ^ t4) + g, of row 2 t4 + 1 at 8 (n ^ t4) + (g ^ 4); with
  // n = 4 m + u that is 32 m on from the lane's offset for u. The warp's
  // columns: dQ a quarter of D (64 (2 role + half)), dK/dV a half.
  const int d0 = DKV ? 128 * half : 64 * (2 * role + half);
  const int sel = DKV && role == 0 ? G::STR : 0;
  int o0[4], o1[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    o0[u] = sel + 2 * t4 * D + d0 + 8 * (u ^ t4) + g;
    o1[u] = sel + (2 * t4 + 1) * D + d0 + 8 * (u ^ t4) + (g ^ 4);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float4* const x4 = reinterpret_cast<float4*>(xch + grp * G::XCH);

  for (int t = t_begin; t < t_end; ++t) {
    const int slot = (t - t_begin) & 1;
    // tile t has landed; every warp is done with tile t - 1's buffers
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < t_end) stage_streamed(t + 1, slot ^ 1);
    cp_async_commit();

    // the query rows [rlo, rhi) and keys [klo, khi) of the group's piece:
    // none visible (skipped by its four warps), all visible (no mask), or
    // some
    const int c0 = t * kXStr;
    const int rlo = DKV ? c0 : w0, rhi = rlo + 16;
    const int klo = DKV ? w0 : c0, khi = klo + 16;
    if (rlo >= lq || klo >= kv_lim ||
        (a.causal && klo > rhi - 1 + offset))
      continue;
    const bool all = rhi <= lq && khi <= kv_lim &&
                     (!a.causal || khi - 1 <= rlo + offset);
    float* const stile = str + 2 * slot * G::STR;
    const float* const rs = rows + slot * G::ROWS;

    // This warp's half of S (role 0) or dP (role 1) over the 16 x 16
    // piece: element (n, e) is row g + 8 (e >> 1), streamed index
    // 8 n + 2 t4 + (e & 1). big.big in one chain, the small terms in
    // another.
    float f[2][2][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[x][n][e] = 0.f;
    const unsigned sb = smem_u32(stile);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t ar[4], br[4], ab[4], as[4], bb[4], bs[4];
        ldsm4(a_at[s] + 128 * c, ar);
        ldsm4(sb + b_at[s] + 128 * c, br);
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
          mma_tf32(f[0][n], ab, bb[2 * n], bb[2 * n + 1]);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_tf32(f[1][n], ab, bs[2 * n], bs[2 * n + 1]);
      }
    }
    // the group's four halves meet: S = S_0 + S_1 and dP = dP_0 + dP_1,
    // summed in that order by every warp of the group
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float4 p = make_float4(f[0][n][0] + f[1][n][0],
                                   f[0][n][1] + f[1][n][1],
                                   f[0][n][2] + f[1][n][2],
                                   f[0][n][3] + f[1][n][3]);
      x4[(2 * (2 * role + half) + n) * 32 + lane] = p;
    }
    named_sync(1 + grp, 128);
    float sv[2][4], dpv[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float4 s0 = x4[(2 * 0 + n) * 32 + lane];
      const float4 s1 = x4[(2 * 1 + n) * 32 + lane];
      const float4 p0 = x4[(2 * 2 + n) * 32 + lane];
      const float4 p1 = x4[(2 * 3 + n) * 32 + lane];
      sv[n][0] = s0.x + s1.x; sv[n][1] = s0.y + s1.y;
      sv[n][2] = s0.z + s1.z; sv[n][3] = s0.w + s1.w;
      dpv[n][0] = p0.x + p1.x; dpv[n][1] = p0.y + p1.y;
      dpv[n][2] = p0.z + p1.z; dpv[n][3] = p0.w + p1.w;
    }
    // P, then dS = P (dP - delta) scale; v: what this warp's sum takes
    // (dQ: dS; dK/dV: P for dV, dS for dK)
    float v[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = w0 + g + 8 * (e >> 1);
        const int ci = c0 + 8 * n + 2 * t4 + (e & 1);
        const float l2 = DKV ? rs[ci - c0] * kLog2e : lse_r[e >> 1];
        float p = exp2f(sv[n][e] * sl2 - l2);
        if (!all) {
          const int row = DKV ? ci : ri, key = DKV ? ri : ci;
          p = row < lq && key < kv_lim &&
              (!a.causal || key <= row + offset) ? p : 0.f;
        }
        const float dl = DKV ? rs[kXStr + ci - c0] : dl_r[e >> 1];
        const float ds = p * (dpv[n][e] - dl) * a.scale;
        v[n][e] = DKV && role == 0 ? p : ds;
      }

    // dQ += dS K (a quarter of D a warp), dV += P^T dO (role 0) or
    // dK += dS^T Q (role 1) (half of D a warp): A is v, k-permuted (see
    // above). Each pair of 8-column tiles sums the tile's 16 rows in a
    // partial of its own, folded into acc with f32 rounding: a product's
    // sum is rounded toward zero by the tensor cores, which over a whole
    // sequence of tiles in one accumulator grew to 7x the plain f32
    // version's error against float64 (PERF.md).
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float ax[4] = {v[kk][0], v[kk][2], v[kk][1], v[kk][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(ax[e], ab[kk][e], as[kk][e]);
    }
#pragma unroll
    for (int m = 0; m < NT / 4; ++m)
#pragma unroll
      for (int u0 = 0; u0 < 4; u0 += 2) {
        float q[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) q[u][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* const bt = stile + kk * 8 * D + 32 * m;
          uint32_t bb[2][2], bs[2][2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            split_tf32(bt[o0[u0 + u]], bb[u][0], bs[u][0]);
            split_tf32(bt[o1[u0 + u]], bb[u][1], bs[u][1]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma_tf32(q[u], as[kk], bb[u][0], bb[u][1]);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma_tf32(q[u], ab[kk], bs[u][0], bs[u][1]);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma_tf32(q[u], ab[kk], bb[u][0], bb[u][1]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * m + u0 + u][e] += q[u][e];
      }
  }

  // dQ (its quarter of the columns), dV (role 0) or dK (role 1) (its
  // half) of the group's rows: rows g and g + 8, two columns a store. A
  // block that saw no tile writes its zeros: the outputs are torch.empty
  // buffers.
  const Strides so = DKV ? (role ? a.sdk : a.sdv) : a.sdq;
  float* const o = static_cast<float*>(DKV ? (role ? a.dk : a.dv) : a.dq) +
                   b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + g + 8 * i;
    if (row >= n_res) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(o + row * so.l + d0 + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kXThreads, 1)
flash_bwd_dq_tf32x3_kernel(const BwdArgs a) {
  static_assert(std::is_same<T, float>::value && D == kXD, "f32, D = 256");
  x3_body<false>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(kXThreads, 1)
flash_bwd_dkv_tf32x3_kernel(const BwdArgs a) {
  static_assert(std::is_same<T, float>::value && D == kXD, "f32, D = 256");
  x3_body<true>(a);
}

// an f32 kernel on the grid (B * H, ceil(resident rows / 64)), opted in to
// its dynamic shared memory and the largest carveout first
cudaError_t launch_f32(void (*kernel)(const BwdArgs), bool dkv,
                       const BwdArgs& a, int B, int threads, size_t smem,
                       cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.H, ((dkv ? a.lk : a.lq) + kRes - 1) / kRes);
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// f32: the FMA kernels at D = 64 and 128, the split-TF32 ones at 256
cudaError_t dispatch_f32(bool dkv, const BwdArgs& a, int B, int d,
                         cudaStream_t s) {
  static_assert(kXRes == kRes, "one grid for both forms");
  if (d == 64)
    return launch_f32(dkv ? flash_bwd_dkv_kernel<float, 64>
                          : flash_bwd_dq_kernel<float, 64>,
                      dkv, a, B, kThreads, Tile<float, 64>::SMEM, s);
  if (d == 128)
    return launch_f32(dkv ? flash_bwd_dkv_kernel<float, 128>
                          : flash_bwd_dq_kernel<float, 128>,
                      dkv, a, B, kThreads, Tile<float, 128>::SMEM, s);
  if (d == kXD)
    return launch_f32(dkv ? flash_bwd_dkv_tf32x3_kernel<float, kXD>
                          : flash_bwd_dq_tf32x3_kernel<float, kXD>,
                      dkv, a, B, kXThreads, XTile::SMEM, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The bf16 and f16 kernels on the tensor cores (sm_90a): wgmma fed by TMA.
//
// What bounds them on the card: bytes. At the LM's causal (8, 12, 512, 512,
// 64) the dQ kernel does 6 pairs D flops a head (4.84 GFLOP) and the dK/dV
// kernel 8 pairs D (6.45 GFLOP): 0.0049 and 0.0065 ms at 989 TFLOP/s bf16,
// under the 0.0095 and 0.0114 ms it takes to move Q, K, V, dO, lse, delta
// and the gradients once at 3.35 TB/s. The SIMT kernels above, fed bf16,
// took 20x and 23x those bounds on the FMA units. At D = 256 (C5, head
// dims 129-256 padded to 256) dK/dV turns to operations: at (4, 8, 512,
// 512, 256) 17.2 GFLOP, 0.0174 ms, against 0.0151 ms of bytes.
//
// What the design does about it:
// - A block is one consumer warpgroup (4 warps) that owns 64 resident rows
//   (dQ: queries; dK/dV: keys), and one producer warp: 160 threads, as in
//   the bf16 forward. The grid is (B * H, ceil(n / 64)), heavy first.
// - Loads move each byte once and cost the consumers nothing: Q, K, V and
//   dO each have the forward's 4-D tensor map (D, L, H, B) built from the
//   strides the wrapper passes (boxes of 64 columns x 64 rows, 128-byte
//   swizzle; D = 128 takes two column boxes). The producer's one thread
//   loads the two resident tiles once, then the two streamed tiles of
//   each 64-row step into a 2-stage ring: each completes on a full
//   mbarrier of its own, so the first product starts before the second
//   operand lands; each consumer warp frees a stage through its empty
//   mbarrier after the stage's last product. dK/dV streams lse and delta
//   with Q and dO, through 1-D maps of the (B * H * lq) f32 values, 68 a
//   box: a TMA box starts 16-byte aligned, and a head's rows start at
//   bh * lq, which is not when lq is no multiple of 4, so the box starts
//   at the multiple of 4 below and the consumers skip (bh * lq) & 3
//   values in (a 64-value box from bh * lq faulted on the card at lq =
//   130). dQ's consumers read their two rows' lse and delta once. Shared
//   memory: 50 KB at D = 64, 98 KB at D = 128, 194 KB at D = 256 (dK/dV:
//   K and V resident at 32 KB each, two stages of Q and dO at 64 KB
//   a stage, lse and delta 1.5 KB; dQ the same, without lse and delta).
// - Every product is `wgmma` with an f32 accumulator in registers. The
//   first two of a step (dQ: S = Q K^T and dP = dO V^T; dK/dV: S^T = K Q^T
//   and dP^T = V dO^T) read both operands from shared memory, K-major. The
//   two sums take their left side from registers: the m64n64 accumulator's
//   16-column slices, packed to T, are exactly the A fragments of
//   `wgmma.m64nDk16`, so P and dS never go through shared memory, and the
//   rounding to T that feeds them is the reference's own. Their right
//   side (dQ: K; dK/dV: dO and Q) is a keys-or-queries x D tile, read
//   MN-major through the transpose bit from the same swizzled bytes that
//   served as a K-major operand.
// - dK/dV computes the transposed scores S^T = K Q^T directly, with the
//   block's keys as rows, so no register tile is ever transposed: a
//   thread's P^T and dS^T columns are queries, whose lse and delta it reads
//   from the stage.
// - dK/dV at D = 256 replaces the FMA instance `flash_bwd_dkv_kernel<T, 256>`
//   that took 16-bit calls before, at 11x SDPA's whole backward. Whole 64 x
//   256 dK and dV accumulators would take 256 registers a thread, more than a
//   thread may hold, so the FMA kernel's split stays: blockIdx.z picks 128 of
//   the 256 output columns, and a block's dK and dV accumulators are D = 128's
//   (64 registers each). S^T and dP^T still contract over all 256 columns
//   (sixteen m64n64k16 steps each, from the resident K, V and the streamed Q,
//   dO, as at D = 128); the two sums read the block's half of the streamed
//   tiles MN-major, two column boxes (16 KB) from each tile's start. Both
//   blocks of a key tile compute S and dP: 12 instead of 8 pairs D flops, the
//   price of keeping every accumulator in registers without a second
//   warpgroup.
// - dQ at D = 256 replaces the FMA instance `flash_bwd_dq_kernel<T, 256>`
//   that took 16-bit calls before, at 5.5x SDPA's whole backward (254
//   registers and 128 spilled bytes there). What bounds it: at (4, 8, 512,
//   512, 256) operations without the mask (6 pairs D flops, 0.0130 ms) and
//   bytes under the causal one (0.0126 ms). dQ's 64 x 256 accumulator is
//   128 f32 registers a thread, beside S's and dP's 32 each and dS's 16
//   packed ones: the forward's budget (O 128, S 32, P 16) with one more 32,
//   under the 255 a thread may hold at one block an SM, which the 194 KB of
//   tiles allow in any case. So dQ stays whole and S and dP are computed
//   once (6 pairs D, not the 10 that splitting D over blockIdx.z would
//   cost); the launch bound asks for one block an SM, so that ptxas may
//   use the registers. S and dP are sixteen m64n64k16 steps each, as at
//   D = 128, and dS K is one `wgmma.m64n256k16` a k16 step, the forward's
//   P V form: K's four column boxes, read MN-major, sit 8 KB (LBO) apart.
// - P and dS run in registers on the accumulator's layout (a thread holds
//   2 rows x 16 columns), exp2 with scale * log2(e) folded in. The mask is
//   applied only on tiles that cross the diagonal, kv_len, lq or lk; TMA
//   zero-fills rows past a sequence's end, and a zero score does not give
//   P = 0, so dQ masks keys at or past kv_len and dK/dV queries at or past
//   lq.
// - The epilogue stages the T gradients through shared memory (the
//   tiles are free by then) and stores 16 bytes a thread, rows < n only,
//   through the gradients' strides. A block that sees no tile still writes
//   its zeros: the outputs are torch.empty buffers.
// - Tensor maps are encoded on the host per call and passed by value as
//   __grid_constant__ parameters, so a CUDA graph captures them with the
//   launch.
// Every sum runs in a fixed order and nothing is atomic: the same bits on
// every call. D is a template parameter (both kernels at 64, 128 and 256
// are built). Left for later: a 128-row block of two consumer warpgroups,
// ping-pong between them, overlapping a step's softmax with the next
// step's products, and a fused single-pass backward (ROADMAP).
// ---------------------------------------------------------------------------

constexpr int kWgRows = kBoxRows;        // resident rows a block, streamed
                                         // rows a step
constexpr int kWgThreads = 128 + 32;     // one consumer warpgroup, a producer
constexpr int kWgStages = 2;
// columns of dK and dV a dK/dV block sums: all, or at D = 256 the half that
// blockIdx.z picks
template <int D>
constexpr int kWgDkvCols = D > 128 ? 128 : D;

template <int D>
struct WgBwd {
  static constexpr int TILE = D / 64 * kBox;     // one 64-row tile
  // the two resident tiles at 0 and TILE; stage s's streamed tiles at
  // TILE (2 + 2 s) and right after; then (dK/dV) a stage's box of lse at
  // ROWS + ROW_STAGE s and of delta ROW_BOX bytes on (kRowsBox values
  // each, 128-byte aligned)
  static constexpr int ROWS = TILE * (2 + 2 * kWgStages);
  static constexpr int ROW_BOX = (4 * kRowsBox + 127) / 128 * 128;
  static constexpr int ROW_STAGE = 2 * ROW_BOX;
  static constexpr int BARS = ROWS + ROW_STAGE * kWgStages;
  static constexpr int NBARS = 2 + 3 * kWgStages;  // resident 2; full 2 and
                                                   // empty a stage
  static constexpr int OUT_LD = D + 8;             // a staged output row
  // slack to align the tiles to the 1024-byte period of the swizzle
  static constexpr int SMEM = BARS + 8 * NBARS + 1024;
  static_assert(2 * kWgRows * OUT_LD * 2 <= ROWS,
                "staged dK and dV fit the tiles");
};

struct WgArgs {
  void* o1;             // dQ, or dK
  void* o2;             // dV
  Strides so1, so2;
  const float* lse;     // (B*H, lq), natural log
  const float* delta;   // (B*H, lq)
  int H, lq, lk;
  float scale;
  int causal;
  int kv_len;
};

// The 1024-aligned base of the dynamic shared memory and its barriers
// (resident 2, then full1, full2 and empty a stage), initialised: one
// arrive (with the bytes) for a full or resident barrier, one a consumer
// warp for an empty one.
template <int D>
__device__ __forceinline__ unsigned char* wg_smem(unsigned char* raw,
                                                  uint64_t*& bars) {
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  bars = reinterpret_cast<uint64_t*>(smem + WgBwd<D>::BARS);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 2 + 2 * kWgStages; ++i) mbar_init(&bars[i], 1);
#pragma unroll
    for (int s = 0; s < kWgStages; ++s)
      mbar_init(&bars[2 + 2 * kWgStages + s], 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return smem;
}

// The producer's one thread: resident tiles at row r0 of maps r1 and r2,
// once; then, for t in [t_begin, t_end), the streamed tiles at row 64 t of
// maps s1 (on full1) and s2 (on full2) and, with `lse` and `delta`
// (dK/dV), a box of each of those 1-D maps beside them, from row_base +
// 64 t (row_base a multiple of 4, so that the box starts 16-byte aligned).
template <int D>
__device__ __forceinline__ void wg_produce(
    unsigned char* smem, uint64_t* bars, const CUtensorMap* r1,
    const CUtensorMap* r2, int r0, const CUtensorMap* s1,
    const CUtensorMap* s2, const CUtensorMap* lse, const CUtensorMap* delta,
    int row_base, int t_begin, int t_end, int h, int b) {
  using L = WgBwd<D>;
  uint64_t* const full1 = bars + 2;
  uint64_t* const full2 = full1 + kWgStages;
  uint64_t* const empty = full2 + kWgStages;
  const int rows = lse ? 4 * kRowsBox : 0;         // a box of f32 a map
  mbar_expect_tx(&bars[0], L::TILE);
#pragma unroll
  for (int j = 0; j < D / 64; ++j)
    tma_load_4d(smem + j * kBox, r1, 64 * j, r0, h, b, &bars[0]);
  mbar_expect_tx(&bars[1], L::TILE);
#pragma unroll
  for (int j = 0; j < D / 64; ++j)
    tma_load_4d(smem + L::TILE + j * kBox, r2, 64 * j, r0, h, b, &bars[1]);
  int stage = 0, phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    mbar_wait(&empty[stage], phase ^ 1);
    unsigned char* const st = smem + L::TILE * (2 + 2 * stage);
    unsigned char* const rs = smem + L::ROWS + L::ROW_STAGE * stage;
    mbar_expect_tx(&full1[stage], L::TILE + rows);
#pragma unroll
    for (int j = 0; j < D / 64; ++j)
      tma_load_4d(st + j * kBox, s1, 64 * j, t * kWgRows, h, b,
                  &full1[stage]);
    if (lse) tma_load_1d(rs, lse, row_base + t * kWgRows, &full1[stage]);
    mbar_expect_tx(&full2[stage], L::TILE + rows);
#pragma unroll
    for (int j = 0; j < D / 64; ++j)
      tma_load_4d(st + L::TILE + j * kBox, s2, 64 * j, t * kWgRows, h, b,
                  &full2[stage]);
    if (delta)
      tma_load_1d(rs + L::ROW_BOX, delta, row_base + t * kWgRows,
                  &full2[stage]);
    if (++stage == kWgStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// acc (64 x 64, f32) = A B^T over D: A's and B's rows are 64-row tiles of
// D values (K-major, at shared addresses a and b), D / 16 k16 steps of
// 32 bytes along a swizzled 128-byte row, the next column box after four
template <typename T, int D>
__device__ __forceinline__ void wg_scores(float (&acc)[32], unsigned a,
                                          unsigned b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const unsigned off = (kk / 4) * kBox + 32 * (kk % 4);
    wgmma_m64n64<T, 0>(acc, wg_desc(a + off, 16, 1024),
                       wg_desc(b + off, 16, 1024));
  }
}

// acc (64 x D, f32) += X B: X (64 x 64) in registers as four k16 A
// fragments, B a 64-row tile of D values at shared address b, read
// MN-major (16 rows, 2048 bytes, a step; column boxes 8 KB apart), one
// m64nDk16 a step (D = 256: the widest form)
template <typename T, int D>
__device__ __forceinline__ void wg_sum(float (&acc)[D / 2],
                                       const unsigned (&x)[4][4],
                                       unsigned b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bd = wg_desc(b + 2048 * kk, kBox, 1024);
    if constexpr (D == 64) wgmma_m64n64_rs<T>(acc, x[kk], bd);
    else if constexpr (D == 128) wgmma_m64n128_rs<T>(acc, x[kk], bd);
    else wgmma_m64n256_rs<T>(acc, x[kk], bd);
  }
}

// The epilogue, in three steps: wg_free (every consumer warp is past its
// last product, so the tiles can hold outputs); wg_stage for each
// accumulator (64 x D, f32, the thread's rows r and r + 8, columns
// 8 j + c + {0, 1}), rounded to T into staging slot `slot`; then, after
// a consumer barrier, wg_copy_out for each: 16 bytes a thread, rows
// row0 + i < n_rows only, through the output's strides.
__device__ __forceinline__ void wg_free() {
  named_sync(1, 128);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T, int D>
__device__ __forceinline__ void wg_stage(unsigned char* smem, int slot,
                                         const float (&acc)[D / 2], int r,
                                         int c) {
  constexpr int LD = WgBwd<D>::OUT_LD;
  T* const os = reinterpret_cast<T*>(smem) + slot * kWgRows * LD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<unsigned*>(os + (r + 8 * hh) * LD + 8 * j + c) =
          pack2<T>(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
}

template <typename T, int D>
__device__ __forceinline__ void wg_copy_out(const unsigned char* smem,
                                            int slot, void* out,
                                            const Strides& so, int b, int h,
                                            int row0, int n_rows) {
  constexpr int LD = WgBwd<D>::OUT_LD;
  constexpr int CPR = D / 8;                     // 16-byte chunks a row
  const T* const os = reinterpret_cast<const T*>(smem) + slot * kWgRows * LD;
  T* const ob = static_cast<T*>(out) + b * so.b + h * so.h;
#pragma unroll 4
  for (int x = threadIdx.x; x < kWgRows * CPR; x += 128) {
    const int rr = x / CPR, cc = (x % CPR) * 8;
    if (row0 + rr < n_rows)
      *reinterpret_cast<uint4*>(ob + (row0 + rr) * so.l + cc) =
          *reinterpret_cast<const uint4*>(os + rr * LD + cc);
  }
}

// T is __nv_bfloat16 or __half: the kernel's name carries its type, as every
// kernel of this directory's does.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, D == 256 ? 1 : 2)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const WgArgs a) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  using L = WgBwd<D>;
  extern __shared__ unsigned char bwg_smem_raw[];
  uint64_t* bars;
  unsigned char* const smem = wg_smem<D>(bwg_smem_raw, bars);
  uint64_t* const full1 = bars + 2;
  uint64_t* const full2 = full1 + kWgStages;
  uint64_t* const empty = full2 + kWgStages;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  // heavy first: the last query tile sees the most keys
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kWgRows;
  // key tiles up to kv_len, and for causal up to the diagonal of the
  // block's last real row
  int n_kv = (kv_lim + kWgRows - 1) / kWgRows;
  if (a.causal) {
    const int last_col = min(q0 + kWgRows, lq) - 1 + offset;
    n_kv = min(n_kv, last_col < 0 ? 0 : last_col / kWgRows + 1);
  }

  const int warp = threadIdx.x / 32;
  if (warp == 4) {
    if (threadIdx.x % 32 == 0 && n_kv > 0)
      wg_produce<D>(smem, bars, &tq, &tdo, q0, &tk, &tv, nullptr, nullptr,
                    0, 0, n_kv, h, b);
    return;
  }

  // The consumers. A thread holds, for each 8-column group j of a 64-row
  // accumulator, columns 8j + 2 (lane % 4) + {0, 1} of rows r0 and r0 + 8
  // (r0 = 16 warp + lane / 4): acc[4j + {0, 1}] and acc[4j + {2, 3}].
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int w0 = q0 + warp * 16;               // the warp's first row
  const float sl2 = a.scale * kLog2e;
  // lse (times log2 e) and delta of the thread's two rows
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    const size_t at = (size_t)bh * lq + row;
    lse2[hh] = row < lq ? a.lse[at] * kLog2e : 0.f;
    dl[hh] = row < lq ? a.delta[at] : 0.f;
  }
  float dq[D / 2];
  zero(dq);
  const unsigned qs = smem_u32(smem), dos = qs + L::TILE;
  if (n_kv > 0) {
    mbar_wait(&bars[0], 0);
    mbar_wait(&bars[1], 0);
  }

  int stage = 0, phase = 0;
  for (int t = 0; t < n_kv; ++t) {
    const unsigned ks = smem_u32(smem + L::TILE * (2 + 2 * stage));
    const unsigned vs = ks + L::TILE;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    // S = Q K^T as soon as K lands, then dP = dO V^T
    mbar_wait(&full1[stage], phase);
    __syncwarp();                  // wgmma is issued by converged warps
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
    wg_scores<T, D>(s, qs, ks);
    wgmma_commit();
    mbar_wait(&full2[stage], phase);
    __syncwarp();
    wg_scores<T, D>(dp, dos, vs);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(s);

    // P in place of S, under dP's product: the warp's rows [w0, w0 + 16)
    // against keys [k0, k0 + 64) are all visible (no mask) or some
    const int k0 = t * kWgRows;
    const bool all = k0 + kWgRows <= kv_lim &&
                     (!a.causal || k0 + kWgRows - 1 <= w0 + offset);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + cq + e;
          float& x = s[4 * j + 2 * hh + e];
          const float p = exp2f(x * sl2 - lse2[hh]);
          x = all || (key < kv_lim && (!a.causal || key <= row + offset))
                  ? p : 0.f;
        }
    }
    wgmma_wait<0>();
    fence_acc(dp);
    // dS = P (dP - delta) scale in T as A's fragments: k16 step kk is
    // columns 16 kk .. + 15, the accumulator's groups 2 kk and 2 kk + 1
    unsigned dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = 8 * kk + 2 * i;
        const float d = dl[i & 1];
        dsf[kk][i] = pack2<T>(s[x] * (dp[x] - d) * a.scale,
                              s[x + 1] * (dp[x + 1] - d) * a.scale);
      }

    // dQ += dS K, K read MN-major
    __syncwarp();
    fence_acc(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(dsf[kk]);
    wgmma_fence();
    wg_sum<T, D>(dq, dsf, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(dsf[kk]);
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kWgStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  wg_free();
  wg_stage<T, D>(smem, 0, dq, r0, cq);
  named_sync(1, 128);
  wg_copy_out<T, D>(smem, 0, a.o1, a.so1, b, h, q0, lq);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 2 : 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tlse,
                           const __grid_constant__ CUtensorMap tdelta,
                           const WgArgs a) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  using L = WgBwd<D>;
  // the output columns this block sums, from column box `box0` of D's
  constexpr int NO = kWgDkvCols<D>;
  const int box0 = (int)blockIdx.z * (NO / 64);
  extern __shared__ unsigned char bwg_smem_raw[];
  uint64_t* bars;
  unsigned char* const smem = wg_smem<D>(bwg_smem_raw, bars);
  uint64_t* const full1 = bars + 2;
  uint64_t* const full2 = full1 + kWgStages;
  uint64_t* const empty = full2 + kWgStages;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  // heavy first: the first key tile is seen by the most queries
  const int k0 = (int)blockIdx.y * kWgRows;
  // query tiles that see these keys: none if every key is at or past
  // kv_len; for causal from the first row r with k0 <= r + offset
  const int t_end = (lq + kWgRows - 1) / kWgRows;
  int t_begin = a.causal ? max(0, k0 - offset) / kWgRows : 0;
  if (k0 >= kv_lim) t_begin = t_end;

  const int warp = threadIdx.x / 32;
  if (warp == 4) {
    if (threadIdx.x % 32 == 0 && t_begin < t_end)
      wg_produce<D>(smem, bars, &tk, &tv, k0, &tq, &tdo, &tlse, &tdelta,
                    (bh * lq) & ~3, t_begin, t_end, h, b);
    return;
  }

  // The consumers, on the accumulator layout of the dQ kernel: rows are the
  // block's keys, columns a tile's queries.
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int kw = k0 + warp * 16;               // the warp's first key
  const float sl2 = a.scale * kLog2e;
  // stage 0's lse from this head's first row on (its delta ROW_BOX bytes
  // on, stage 1 ROW_STAGE bytes on; stage 1 is picked by a select: with a
  // product ptxas took 2 more registers and spilled at D = 64)
  static_assert(kWgStages == 2, "a stage's lse is picked by a select");
  const float* const lse0 =
      reinterpret_cast<const float*>(smem + L::ROWS) + ((bh * lq) & 3);
  float dk[NO / 2], dv[NO / 2];
  zero(dk);
  zero(dv);
  const unsigned ks = smem_u32(smem), vs = ks + L::TILE;
  if (t_begin < t_end) {
    mbar_wait(&bars[0], 0);
    mbar_wait(&bars[1], 0);
  }

  int stage = 0, phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const unsigned qs = smem_u32(smem + L::TILE * (2 + 2 * stage));
    const unsigned dos = qs + L::TILE;
    const float* const lse = lse0 + (stage ? L::ROW_STAGE / 4 : 0);
    const float* const delta = lse + L::ROW_BOX / 4;
    float s[32];
    zero(s);
    // S^T = K Q^T
    mbar_wait(&full1[stage], phase);
    __syncwarp();
    fence_acc(s);
    wgmma_fence();
    wg_scores<T, D>(s, ks, qs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    // P^T in place of S^T: the warp's keys [kw, kw + 16) against queries
    // [c0, c0 + 64) are all visible (no mask) or some
    const int c0 = t * kWgRows;
    const bool all = c0 + kWgRows <= lq && kw + 16 <= kv_lim &&
                     (!a.causal || kw + 15 <= c0 + offset);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + cq + e, query = c0 + col;
        const float l2 = lse[col] * kLog2e;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = k0 + r0 + 8 * hh;
          float& x = s[4 * j + 2 * hh + e];
          const float p = exp2f(x * sl2 - l2);
          x = all || (query < lq && key < kv_lim &&
                      (!a.causal || key <= query + offset))
                  ? p : 0.f;
        }
      }
    // P^T in T as A's fragments
    unsigned pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[kk][i] = pack2<T>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    // dV += P^T dO (the block's columns of dO, read MN-major), then
    // dP^T = V dO^T (all of dO, K-major)
    float dp[32];
    zero(dp);
    mbar_wait(&full2[stage], phase);
    __syncwarp();
    fence_acc(dv);
    fence_acc(dp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(pf[kk]);
    wgmma_fence();
    wg_sum<T, NO>(dv, pf, dos + box0 * kBox);
    wgmma_commit();
    wg_scores<T, D>(dp, vs, dos);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(pf[kk]);

    // dS^T = P^T (dP^T - delta) scale in T as A's fragments; delta is
    // per column (query)
    unsigned dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = 8 * kk + 2 * i;
        const int col = 8 * (2 * kk + (i >> 1)) + cq;
        dsf[kk][i] = pack2<T>(s[x] * (dp[x] - delta[col]) * a.scale,
                              s[x + 1] * (dp[x + 1] - delta[col + 1]) *
                                  a.scale);
      }

    // dK += dS^T Q (the block's columns of Q, read MN-major)
    __syncwarp();
    fence_acc(dk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(dsf[kk]);
    wgmma_fence();
    wg_sum<T, NO>(dk, dsf, qs + box0 * kBox);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(dsf[kk]);
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kWgStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  wg_free();
  wg_stage<T, NO>(smem, 0, dk, r0, cq);
  wg_stage<T, NO>(smem, 1, dv, r0, cq);
  named_sync(1, 128);
  wg_copy_out<T, NO>(smem, 0, static_cast<T*>(a.o1) + 64 * box0, a.so1, b,
                     h, k0, lk);
  wg_copy_out<T, NO>(smem, 1, static_cast<T*>(a.o2) + 64 * box0, a.so2, b,
                     h, k0, lk);
}

template <typename T, int D, bool DKV>
cudaError_t launch_wgmma(const CUtensorMap (&maps)[6], const WgArgs& a,
                         int B, int device, cudaStream_t s) {
  using L = WgBwd<D>;
  // above 48 KB of dynamic shared memory only after opting in, once a
  // device (before any capture: the wrapper's first call runs eagerly)
  static bool opted[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  const auto opt_in = [&](const void* kernel) {
    if (opted[device]) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    opted[device] = e == cudaSuccess;
    return e;
  };
  if constexpr (DKV) {
    const auto kernel = flash_bwd_dkv_wgmma_kernel<T, D>;
    const cudaError_t e = opt_in(reinterpret_cast<const void*>(kernel));
    if (e != cudaSuccess) return e;
    const dim3 grid(B * a.H, (a.lk + kWgRows - 1) / kWgRows,
                    D / kWgDkvCols<D>);
    kernel<<<grid, kWgThreads, L::SMEM, s>>>(maps[0], maps[1], maps[2],
                                             maps[3], maps[4], maps[5], a);
  } else {
    const auto kernel = flash_bwd_dq_wgmma_kernel<T, D>;
    const cudaError_t e = opt_in(reinterpret_cast<const void*>(kernel));
    if (e != cudaSuccess) return e;
    const dim3 grid(B * a.H, (a.lq + kWgRows - 1) / kWgRows);
    kernel<<<grid, kWgThreads, L::SMEM, s>>>(maps[0], maps[1], maps[2],
                                             maps[3], a);
  }
  return cudaGetLastError();
}

// the 16-bit backward for T = __nv_bfloat16 or __half: the wgmma kernels at
// D = 64, 128 and 256
template <typename T>
cudaError_t dispatch_wgmma(bool dkv, const BwdArgs& f, int B, int d,
                           int device, cudaStream_t s) {
  if (d != 64 && d != 128 && d != 256) return cudaErrorInvalidValue;
  // q, k, v, dO, then (dK/dV) lse and delta
  CUtensorMap maps[6];
  const long long n_rows = (long long)B * f.H * f.lq;
  if (!encode_bhld<T>(&maps[0], f.q, B, f.H, f.lq, d, f.sq) ||
      !encode_bhld<T>(&maps[1], f.k, B, f.H, f.lk, d, f.sk) ||
      !encode_bhld<T>(&maps[2], f.v, B, f.H, f.lk, d, f.sv) ||
      !encode_bhld<T>(&maps[3], f.dout, B, f.H, f.lq, d, f.sdo) ||
      n_rows >= (1LL << 31))
    return cudaErrorNotSupported;
  if (dkv && (!encode_rows(&maps[4], f.lse, n_rows) ||
              !encode_rows(&maps[5], f.delta, n_rows)))
    return cudaErrorNotSupported;
  WgArgs a{};
  a.o1 = dkv ? f.dk : f.dq;
  a.o2 = f.dv;
  a.so1 = dkv ? f.sdk : f.sdq;
  a.so2 = f.sdv;
  a.lse = f.lse; a.delta = f.delta;
  a.H = f.H; a.lq = f.lq; a.lk = f.lk;
  a.scale = f.scale; a.causal = f.causal; a.kv_len = f.kv_len;
  if (dkv) {
    if (d == 64) return launch_wgmma<T, 64, true>(maps, a, B, device, s);
    if (d == 128) return launch_wgmma<T, 128, true>(maps, a, B, device, s);
    return launch_wgmma<T, 256, true>(maps, a, B, device, s);
  }
  if (d == 64) return launch_wgmma<T, 64, false>(maps, a, B, device, s);
  if (d == 128) return launch_wgmma<T, 128, false>(maps, a, B, device, s);
  return launch_wgmma<T, 256, false>(maps, a, B, device, s);
}

// d > 256 (a multiple of 64): f32 flash_bwd_dq_wide_tf32x3_kernel<float>
// or flash_bwd_dkv_wide_tf32x3_kernel<float>, bf16 and f16
// flash_bwd_dq_wide_wgmma_kernel<T> or flash_bwd_dkv_wide_wgmma_kernel<T>
cudaError_t dispatch_wide(bool dkv, const BwdArgs& f, int B, int d,
                          int dtype, int device, cudaStream_t s) {
  wide::Args a{};
  a.q = f.q; a.k = f.k; a.v = f.v; a.dout = f.dout;
  a.lse = f.lse; a.delta = f.delta; a.dq = f.dq; a.dk = f.dk; a.dv = f.dv;
  a.H = f.H; a.lq = f.lq; a.lk = f.lk; a.d = d;
  a.sq = f.sq; a.sk = f.sk; a.sv = f.sv; a.sdo = f.sdo;
  a.sdq = f.sdq; a.sdk = f.sdk; a.sdv = f.sdv;
  a.scale = f.scale; a.causal = f.causal; a.kv_len = f.kv_len;
  if (dtype == kFloat32)
    return dkv ? wide::launch_x3<true>(a, B, s)
               : wide::launch_x3<false>(a, B, s);
  if (dtype == kBFloat16)
    return dkv ? wide::launch_wg<__nv_bfloat16, true>(a, B, device, s)
               : wide::launch_wg<__nv_bfloat16, false>(a, B, device, s);
  if (dtype == kFloat16)
    return dkv ? wide::launch_wg<__half, true>(a, B, device, s)
               : wide::launch_wg<__half, false>(a, B, device, s);
  return cudaErrorInvalidValue;
}

int run(bool dkv, const BwdArgs& a, int B, int d, int dtype, int device,
        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || a.H <= 0 || (dkv ? a.lk : a.lq) <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 256) return (int)dispatch_wide(dkv, a, B, d, dtype, device, s);
  if (dtype == kFloat32) return (int)dispatch_f32(dkv, a, B, d, s);
  if (dtype == kBFloat16)
    return (int)dispatch_wgmma<__nv_bfloat16>(dkv, a, B, d, device, s);
  if (dtype == kFloat16)
    return (int)dispatch_wgmma<__half>(dkv, a, B, d, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mxt

// q: (B, H, lq, d); k, v: (B, H, lk, d); dout and dq: (B, H, lq, d), each
// given by its (batch, head, row) strides in elements with a unit stride on
// d and 16-byte aligned rows (and, in bf16 and f16, no zero stride: TMA
// reads through them); lse and delta: (B, H, lq) contiguous f32 (16-byte
// aligned in bf16 and f16). f32 runs flash_bwd_dq_kernel at d = 64 and 128
// and flash_bwd_dq_tf32x3_kernel at 256, bf16 and f16
// flash_bwd_dq_wgmma_kernel; d is 64, 128 or 256, or above 256 a multiple
// of 64, which flash_bwd_dq_wide_tf32x3_kernel takes in f32 and
// flash_bwd_dq_wide_wgmma_kernel in bf16 and f16. Returns the CUDA error of
// the launch; cudaErrorNotSupported where the tensor maps cannot be
// encoded.
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

// As above, with dk and dv: (B, H, lk, d) given by their strides; f32 runs
// flash_bwd_dkv_kernel at d = 64 and 128 and flash_bwd_dkv_tf32x3_kernel at
// 256, bf16 and f16 flash_bwd_dkv_wgmma_kernel; above 256 f32
// flash_bwd_dkv_wide_tf32x3_kernel, bf16 and f16
// flash_bwd_dkv_wide_wgmma_kernel.
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
