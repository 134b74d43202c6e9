// FlashAttention-2 backward at head dims above 256, dQ and dK/dV, for
// Hopper (sm_90a), the head dim D a runtime multiple of 64 above 256 (the
// wrapper pads 257-319 to 320, and so on), in two forms, each part of this
// file with its own note: bf16 and f16 run
// `flash_bwd_dq_wide_wgmma_kernel<T>` and
// `flash_bwd_dkv_wide_wgmma_kernel<T>` on the tensor cores, wgmma fed by
// TMA (the first part); f32 runs `flash_bwd_dq_wide_tf32x3_kernel<float>`
// and `flash_bwd_dkv_wide_tf32x3_kernel<float>` on the tensor cores by split
// TF32 (the second part). The forward above 256 is flash_attention.cu's
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
// TF32 products at 495 TFLOP/s), against 0.0100 ms for its 33.6 MB; in
// bf16 and f16 0.0065 ms on the tensor cores (989 TFLOP/s), against 0.0063
// ms for its 21 MB.
#include "common.cuh"
#include "hopper.cuh"

namespace mxt {
namespace {
namespace wide {

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
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  float scale;
  int causal;
  int kv_len;
};

// ---------------------------------------------------------------------------
// The bf16 and f16 kernels, on the tensor cores: wgmma fed by TMA.
//
// They replace an FMA design (4 warps, the output's D columns split over
// blockIdx.z in 64-column chunks, each chunk recomputing S and dP over the
// whole of D from tiles widened to f32 by plain loads: 34 and 36 pairs D
// flops at D = 512 for the ideal 6 and 8), which took, at
// (2, 4, 512, 512, 512) in bf16, dQ 1.9844 ms and dK/dV 1.7885 (f16 1.9967
// and 1.7516), 4.9x SDPA's whole backward (0.7691), and at the LM's
// (8, 4, 512, 512, 512) causal 3.9001 and 4.5682 ms (PERF.md).
//
// What bounds them: at (2, 4, 512, 512, 512) operations, 0.0065 ms (dQ)
// and 0.0087 ms (dK/dV) at 989 TFLOP/s; at the LM's causal shape bytes,
// 0.0251 and 0.0301 ms at 3.35 TB/s.
//
// What the design does about it. It joins the 16-bit kernels at D = 256
// (flash_attention_bwd.cu: one consumer warpgroup and one TMA producer
// warp, 160 threads; P and dS in registers as wgmma's A fragments) with the
// streaming of D of the wide forward (`flash_fwd_wide_wgmma_kernel`: a ring
// of 64-column boxes):
// - Every product is wgmma with f32 accumulators in registers. A block
//   owns 64 rows (dQ: queries; dK/dV: keys) and a 256-column chunk of its
//   output, whose 64 x 256 accumulator takes 128 registers a thread, as
//   dQ's at D = 256. dK and dV of a chunk would take 256, so dK/dV makes
//   two passes over its query tiles: the first sums dV = P^T dO (S^T
//   only) and writes it out, the second dK = dS^T Q (S^T and dP^T). The
//   grid is (B * H * chunks, ceil(rows / 64)), the chunks of a row tile
//   neighbours on blockIdx.x, so that they read the same streamed tiles
//   from L2 at about the same time, heavy first on blockIdx.y (dQ: the
//   last query tile; dK/dV: the first key tile). S and dP are summed once
//   a chunk and S^T once more: at D = 512 dQ does 10 pairs D flops for its
//   6 and dK/dV 16 for its 8 (the FMA design: 34 and 36), the price of
//   keeping every accumulator in one warpgroup's registers.
// - No tile stays resident (at D = 512 a 64-row 16-bit tile is 64 KB).
//   For each streamed tile of 64 rows (dQ: keys; dK/dV: queries) S = Q K^T
//   and dP = dO V^T (S^T = K Q^T and dP^T = V dO^T) are summed over the
//   whole of D from a ring of PIECES slots, a slot a pair of 8 KB boxes
//   of one 64 columns (Q and K, then dO and V; K and Q, then V and dO),
//   each 4 `wgmma.m64n64k16` K-major into one f32 accumulator chain over
//   all of D; a slot is freed once the next slot's products are issued and
//   its own are done (wgmma.wait_group 1), as in the wide forward.
// - The sum's right side is the tile's chunk of 256 columns (dQ: K's;
//   dK/dV: dO's, then Q's), a stage of its own (two stages of 32 KB) that
//   the producer loads before the tile's pieces, so it lands while S and
//   dP are summed, read MN-major through the transpose bit (column boxes
//   8 KB apart) by four `wgmma.m64n256k16`. A chunk's boxes past D
//   (D = 320, 384: a last chunk of 64 or 128 real columns) are not
//   loaded; the stale columns they feed are not stored.
// - P and dS stay in registers, as at D = 256: the m64n64 accumulator's
//   16-column slices, packed to T, are the A fragments of the sums. dK/dV
//   reads a tile's lse and delta in 68-value 1-D TMA boxes from the
//   multiple of 4 at or below bh * lq, skipping (bh * lq) & 3 values (a
//   box starts 16-byte aligned; C11's repair at D = 256); dQ reads its
//   rows' lse and delta once.
// - Masks as at D = 256: a select on tiles that cross the diagonal,
//   kv_len, lq or lk, so a row that sees no key (lse -inf) gives 0, not
//   NaN; TMA zero-fills rows past a sequence's end.
// - The output is staged through a region of its own (dK/dV writes dV
//   while the ring fills for its second pass) and stored 16 bytes a
//   thread, the chunk's real columns and rows < n only. A block that sees
//   no tile still writes its zeros: the outputs are torch.empty buffers.
// - Tensor maps are encoded on the host per call and passed by value as
//   __grid_constant__ parameters, so a CUDA graph captures them; each
//   kernel opts in to its dynamic shared memory once a device, at its
//   first (eager) launch.
// Every sum runs in a fixed order and nothing is atomic: the same bits on
// every call. What sets the pace is the stream of box pairs from L2 (16 KB
// for 4 m64n64k16 products, 32 flops a byte), not the tensor cores.
// Measured (PERF.md, on an NVIDIA H100 80GB HBM3 at 700 W), bf16 at
// (2, 4, 512, 512, 512): dQ 0.0420-0.0424 ms, dK/dV 0.0889-0.0891 (one
// pass a 128-column chunk of dK and dV, 256 blocks: 0.1086-0.1106),
// together 0.15-0.17x SDPA's whole backward and 28x faster than the FMA
// pair; at the LM's causal shape 0.1040-0.1045 and 0.2274-0.2279 ms, 0.19x
// SDPA's.
// ---------------------------------------------------------------------------

constexpr int kGRows = kBoxRows;        // rows a block, streamed rows a tile
constexpr int kGCols = 256;             // output columns a block (a chunk)
constexpr int kGThreads = 128 + 32;     // one consumer warpgroup, a producer
constexpr int kGStages = 2;             // stages of a tile's chunk

template <bool DKV>
struct WideWg {
  // ring slots of a pair of boxes: dQ 6, dK/dV 4 (each the faster of 4, 6
  // and 7 on the card, PERF.md)
  static constexpr int PIECES = DKV ? 4 : 6;
  static constexpr int PIECE = 2 * kBox;
  static constexpr int CHUNK = kGCols / 64 * kBox;  // a stage: a tile's chunk
  static constexpr int OPS = PIECES * PIECE;        // the stages from here
  static constexpr int ROW_BOX = (4 * kRowsBox + 127) / 128 * 128;
  // dK/dV: stage s's box of lse at ROWS + 2 ROW_BOX s, of delta ROW_BOX on
  static constexpr int ROWS = OPS + kGStages * CHUNK;
  static constexpr int OUT = ROWS + 2 * ROW_BOX * kGStages;
  static constexpr int OUT_LD = kGCols + 8;         // a staged output row
  // the staged outputs, in a region of their own (dK/dV stages dV while
  // the ring fills for its second pass)
  static constexpr int BARS = OUT + kGRows * OUT_LD * 2;
  static constexpr int NBARS = 2 * (PIECES + kGStages);  // full, empty
  // slack to align the tiles to the 1024-byte period of the swizzle
  static constexpr int SMEM = BARS + 8 * NBARS + 1024;
};

// acc (64 x 64, f32) += A B^T over one pair of 64-column boxes at shared
// address a (A, K-major) and a + kBox (B): 4 k16 steps of 32 bytes along a
// swizzled 128-byte row, 8-row groups 1024 bytes apart
template <typename T>
__device__ __forceinline__ void wg_pair(float (&acc)[32], unsigned a) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64<T, 0>(acc, wg_desc(a + 32 * kk, 16, 1024),
                       wg_desc(a + kBox + 32 * kk, 16, 1024));
}

// acc (64 x 256) += X B: X (64 x 64) in registers as four k16 A fragments,
// B 64 rows of 256 columns at shared address b, read MN-major (16 rows,
// 2048 bytes, a step; column boxes 8 KB apart), one m64n256k16 a step
template <typename T>
__device__ __forceinline__ void wg_chunk_sum(float (&acc)[kGCols / 2],
                                             const unsigned (&x)[4][4],
                                             unsigned b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n256_rs<T>(acc, x[kk], wg_desc(b + 2048 * kk, kBox, 1024));
}

// The output: every consumer is past its last product and past its reads
// of the staging region; the accumulator (64 x 256, the thread's rows r
// and r + 8, columns 8 j + c + {0, 1}) rounded to T into the staging
// region; then 16 bytes a thread to columns [c0, c0 + cols) of rows
// row0 + i < n_rows of the output.
template <typename T, bool DKV>
__device__ __forceinline__ void wg_write_out(unsigned char* smem,
                                             const float (&acc)[kGCols / 2],
                                             int r, int c, void* out,
                                             const Strides& so, int b, int h,
                                             int c0, int cols, int row0,
                                             int n_rows) {
  constexpr int LD = WideWg<DKV>::OUT_LD;
  T* const os = reinterpret_cast<T*>(smem + WideWg<DKV>::OUT);
  named_sync(1, 128);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < kGCols / 8; ++j)
      *reinterpret_cast<unsigned*>(os + (r + 8 * hh) * LD + 8 * j + c) =
          pack2<T>(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  named_sync(1, 128);
  const int cpr = cols / 8;                      // 16-byte chunks a row
  T* const ob = static_cast<T*>(out) + b * so.b + h * so.h + c0;
  for (int x = threadIdx.x; x < kGRows * cpr; x += 128) {
    const int rr = x / cpr, cc = (x % cpr) * 8;
    if (row0 + rr < n_rows)
      *reinterpret_cast<uint4*>(ob + (row0 + rr) * so.l + cc) =
          *reinterpret_cast<const uint4*>(os + rr * LD + cc);
  }
}

// The body of both kernels. dQ (DKV false): resident rows are queries (Q,
// dO), streamed tiles keys (K, V), one pass summing dS K over K's chunk.
// dK/dV (DKV true): resident rows are keys (K, V), streamed tiles queries
// (Q, dO, lse, delta), two passes over them: dV += P^T dO over dO's chunk
// (S^T only), written out, then dK += dS^T Q over Q's chunk (S^T and dP^T).
template <typename T, bool DKV>
__device__ __forceinline__ void wg_wide_body(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const CUtensorMap* tlse,
    const CUtensorMap* tdelta, const Args& a) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  using L = WideWg<DKV>;
  constexpr int PASSES = DKV ? 2 : 1;
  extern __shared__ unsigned char wgw_smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wgw_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const pfull = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* const pempty = pfull + L::PIECES;
  uint64_t* const cfull = pempty + L::PIECES;
  uint64_t* const cempty = cfull + kGStages;

  const int nb = a.d / 64;                       // column boxes of D
  const int nch = (a.d + kGCols - 1) / kGCols;
  const int bh = blockIdx.x / nch, chunk = blockIdx.x % nch;
  const int c0 = chunk * kGCols;                 // the chunk's first column
  const int nv = min(kGCols, a.d - c0) / 64;     // its real column boxes
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  const int r0 = (DKV ? (int)blockIdx.y : (int)(gridDim.y - 1 - blockIdx.y))
                 * kGRows;
  // the streamed tiles [t_begin, t_end): dQ the key tiles up to kv_len and,
  // causal, the diagonal of the block's last real row; dK/dV the query
  // tiles that see its keys, none if every key is at or past kv_len
  int t_begin = 0, t_end;
  if (DKV) {
    t_end = (lq + kGRows - 1) / kGRows;
    if (a.causal) t_begin = max(0, r0 - offset) / kGRows;
    if (r0 >= kv_lim) t_begin = t_end;
  } else {
    t_end = (kv_lim + kGRows - 1) / kGRows;
    if (a.causal) {
      const int last_col = min(r0 + kGRows, lq) - 1 + offset;
      t_end = min(t_end, last_col < 0 ? 0 : last_col / kGRows + 1);
    }
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::PIECES; ++s) {
      mbar_init(&pfull[s], 1);     // the producer's arrive, plus the bytes
      mbar_init(&pempty[s], 1);    // the consumer warpgroup's arrive
    }
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&cfull[s], 1);
      mbar_init(&cempty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4) {
    // the producer: one thread loads, per streamed tile of a pass, the
    // tile's chunk (dQ: K's; dK/dV: dO's, then in the second pass Q's) and,
    // dK/dV, its lse and delta; then the pairs of boxes of S's pieces and,
    // but in dK/dV's first pass, of dP's
    if (threadIdx.x % 32 == 0) {
      const CUtensorMap* const r1 = DKV ? tk : tq;
      const CUtensorMap* const r2 = DKV ? tv : tdo;
      const CUtensorMap* const s1 = DKV ? tq : tk;
      const CUtensorMap* const s2 = DKV ? tdo : tv;
      const int row_base = (bh * lq) & ~3;       // 16-byte aligned boxes
      int ps = 0, pph = 0, cs = 0, cph = 0;
      for (int pass = 0; pass < PASSES; ++pass) {
        const CUtensorMap* const cm = DKV && pass == 0 ? tdo : s1;
        const int np = DKV && pass == 0 ? nb : 2 * nb;
        for (int t = t_begin; t < t_end; ++t) {
          const int s0 = t * kGRows;
          mbar_wait(&cempty[cs], cph ^ 1);
          unsigned char* const ct = smem + L::OPS + cs * L::CHUNK;
          mbar_expect_tx(&cfull[cs],
                         nv * kBox + (DKV ? 2 * 4 * kRowsBox : 0));
          for (int j = 0; j < nv; ++j)
            tma_load_4d(ct + j * kBox, cm, c0 + 64 * j, s0, h, b,
                        &cfull[cs]);
          if (DKV) {
            unsigned char* const rs = smem + L::ROWS + 2 * L::ROW_BOX * cs;
            tma_load_1d(rs, tlse, row_base + s0, &cfull[cs]);
            tma_load_1d(rs + L::ROW_BOX, tdelta, row_base + s0, &cfull[cs]);
          }
          if (++cs == kGStages) {
            cs = 0;
            cph ^= 1;
          }
          for (int i = 0; i < np; ++i) {
            const bool first = i < nb;
            const int j = first ? i : i - nb;
            mbar_wait(&pempty[ps], pph ^ 1);
            unsigned char* const pt = smem + ps * L::PIECE;
            mbar_expect_tx(&pfull[ps], L::PIECE);
            tma_load_4d(pt, first ? r1 : r2, 64 * j, r0, h, b, &pfull[ps]);
            tma_load_4d(pt + kBox, first ? s1 : s2, 64 * j, s0, h, b,
                        &pfull[ps]);
            if (++ps == L::PIECES) {
              ps = 0;
              pph ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // The consumers. A thread holds, for each 8-column group j of a 64-row
  // accumulator, columns 8j + 2 (lane % 4) + {0, 1} of rows rr and rr + 8
  // (rr = 16 warp + lane / 4): acc[4j + {0, 1}] and acc[4j + {2, 3}].
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int rr = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int w0 = r0 + warp * 16;               // the warp's first row
  const float sl2 = a.scale * kLog2e;
  // dQ: lse (times log2 e) and delta of the thread's two rows
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + rr + 8 * hh;
      const size_t at = (size_t)bh * lq + row;
      if (row < lq && t_begin < t_end) {
        lse2[hh] = a.lse[at] * kLog2e;
        dl[hh] = a.delta[at];
      }
    }
  }
  // dQ; dK/dV dV in the first pass, dK in the second
  float acc[kGCols / 2];

  int ps = 0, pph = 0, cs = 0, cph = 0;
  for (int pass = 0; pass < PASSES; ++pass) {
    // dK/dV's first pass sums dV = P^T dO, which needs no dP^T
    const bool with_dp = !DKV || pass == 1;
    zero(acc);
    for (int t = t_begin; t < t_end; ++t) {
      const int s0 = t * kGRows;
      float s[32], dp[32];
      zero(s);
      zero(dp);
      fence_acc(s);
      fence_acc(dp);
      // S (S^T) over D a pair of boxes at a time, then dP (dP^T): slot
      // `prev` is freed once the next slot's products are issued and its
      // own are done
      int prev = -1;
      for (int i = 0; i < nb; ++i) {
        mbar_wait(&pfull[ps], pph);
        __syncwarp();              // wgmma is issued by converged warps
        wgmma_fence();
        wg_pair<T>(s, smem_u32(smem + ps * L::PIECE));
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          if (tid == 0) mbar_arrive(&pempty[prev]);
        }
        prev = ps;
        if (++ps == L::PIECES) {
          ps = 0;
          pph ^= 1;
        }
      }
      for (int i = 0; with_dp && i < nb; ++i) {
        mbar_wait(&pfull[ps], pph);
        __syncwarp();
        wgmma_fence();
        wg_pair<T>(dp, smem_u32(smem + ps * L::PIECE));
        wgmma_commit();
        wgmma_wait<1>();
        if (tid == 0) mbar_arrive(&pempty[prev]);
        prev = ps;
        if (++ps == L::PIECES) {
          ps = 0;
          pph ^= 1;
        }
      }
      wgmma_wait_all();
      fence_acc(s);
      fence_acc(dp);
      if (tid == 0) mbar_arrive(&pempty[prev]);

      mbar_wait(&cfull[cs], cph);
      const unsigned ct = smem_u32(smem + L::OPS + cs * L::CHUNK);
      // X, the sum's left side in T as A's fragments: k16 step kk is
      // columns 16 kk .. + 15, the accumulator's groups 2 kk and 2 kk + 1
      unsigned xf[4][4];
      if constexpr (!DKV) {
        // P in place of S: the warp's rows [w0, w0 + 16) against keys
        // [s0, s0 + 64) are all visible (no mask) or some
        const bool all = s0 + kGRows <= kv_lim &&
                         (!a.causal || s0 + kGRows - 1 <= w0 + offset);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + rr + 8 * hh;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = s0 + 8 * j + cq + e;
              float& x = s[4 * j + 2 * hh + e];
              // a select, so that an lse of -inf gives 0, not NaN
              const float p = exp2f(x * sl2 - lse2[hh]);
              x = all || (key < kv_lim && (!a.causal || key <= row + offset))
                      ? p : 0.f;
            }
        }
        // dS = P (dP - delta) scale
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int x = 8 * kk + 2 * i;
            const float d = dl[i & 1];
            xf[kk][i] = pack2<T>(s[x] * (dp[x] - d) * a.scale,
                                 s[x + 1] * (dp[x + 1] - d) * a.scale);
          }
      } else {
        // the tile's lse and delta: the box from the multiple of 4 below
        // bh * lq, skipped into
        const float* const lse = reinterpret_cast<const float*>(
            smem + L::ROWS + 2 * L::ROW_BOX * cs) + ((bh * lq) & 3);
        const float* const delta = lse + L::ROW_BOX / 4;
        // P^T in place of S^T: the warp's keys [w0, w0 + 16) against
        // queries [s0, s0 + 64) are all visible (no mask) or some
        const bool all = s0 + kGRows <= lq && w0 + 16 <= kv_lim &&
                         (!a.causal || w0 + 15 <= s0 + offset);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + cq + e, query = s0 + col;
            const float l2 = lse[col] * kLog2e;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int key = r0 + rr + 8 * hh;
              float& x = s[4 * j + 2 * hh + e];
              const float p = exp2f(x * sl2 - l2);
              x = all || (query < lq && key < kv_lim &&
                          (!a.causal || key <= query + offset))
                      ? p : 0.f;
            }
          }
        // the first pass P^T; the second dS^T = P^T (dP^T - delta) scale,
        // delta per column (query)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int x = 8 * kk + 2 * i;
            const int col = 8 * (2 * kk + (i >> 1)) + cq;
            xf[kk][i] = with_dp
                ? pack2<T>(s[x] * (dp[x] - delta[col]) * a.scale,
                           s[x + 1] * (dp[x + 1] - delta[col + 1]) * a.scale)
                : pack2<T>(s[x], s[x + 1]);
          }
      }
      // dQ += dS K; dV += P^T dO; dK += dS^T Q: over the tile's chunk
      __syncwarp();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_acc(xf[kk]);
      wgmma_fence();
      wg_chunk_sum<T>(acc, xf, ct);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_acc(xf[kk]);
      if (tid == 0) mbar_arrive(&cempty[cs]);
      if (++cs == kGStages) {
        cs = 0;
        cph ^= 1;
      }
    }
    // a block that sees no tile still writes its zeros: the outputs are
    // torch.empty buffers
    void* const out = DKV ? (pass ? a.dk : a.dv) : a.dq;
    const Strides& so = DKV ? (pass ? a.sdk : a.sdv) : a.sdq;
    wg_write_out<T, DKV>(smem, acc, rr, cq, out, so, b, h, c0, 64 * nv, r0,
                         DKV ? lk : lq);
  }
}

// T is __nv_bfloat16 or __half: the kernel's name carries its type, as every
// kernel of this directory's does.
template <typename T>
__global__ void __launch_bounds__(kGThreads, 1)
flash_bwd_dq_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const Args a) {
  wg_wide_body<T, false>(&tq, &tk, &tv, &tdo, nullptr, nullptr, a);
}

template <typename T>
__global__ void __launch_bounds__(kGThreads, 1)
flash_bwd_dkv_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tlse,
                                const __grid_constant__ CUtensorMap tdelta,
                                const Args a) {
  wg_wide_body<T, true>(&tq, &tk, &tv, &tdo, &tlse, &tdelta, a);
}

// bf16 or f16: a wgmma kernel on the grid (B * H * chunks, ceil(rows /
// 64)), its tensor maps encoded for this call (q, k, v, dO, and for dK/dV
// lse and delta), opted in to its dynamic shared memory once a device
// (before any capture: the wrapper's first call runs eagerly); D must be a
// multiple of 64 above 256. cudaErrorNotSupported where a map cannot be
// encoded.
template <typename T, bool DKV>
cudaError_t launch_wg(const Args& a, int B, int device, cudaStream_t s) {
  using L = WideWg<DKV>;
  const long long x = (long long)B * a.H * ((a.d + kGCols - 1) / kGCols);
  const long long n_rows = (long long)B * a.H * a.lq;
  if (a.d <= 256 || a.d % 64 || x >= (1LL << 31)) return cudaErrorInvalidValue;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  CUtensorMap maps[6];
  if (!encode_bhld<T>(&maps[0], a.q, B, a.H, a.lq, a.d, a.sq) ||
      !encode_bhld<T>(&maps[1], a.k, B, a.H, a.lk, a.d, a.sk) ||
      !encode_bhld<T>(&maps[2], a.v, B, a.H, a.lk, a.d, a.sv) ||
      !encode_bhld<T>(&maps[3], a.dout, B, a.H, a.lq, a.d, a.sdo) ||
      n_rows >= (1LL << 31))
    return cudaErrorNotSupported;
  if (DKV && (!encode_rows(&maps[4], a.lse, n_rows) ||
              !encode_rows(&maps[5], a.delta, n_rows)))
    return cudaErrorNotSupported;
  static bool opted[64] = {};
  const auto opt_in = [&](const void* kernel) {
    if (opted[device]) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    opted[device] = e == cudaSuccess;
    return e;
  };
  const dim3 grid((unsigned)x, ((DKV ? a.lk : a.lq) + kGRows - 1) / kGRows);
  if constexpr (DKV) {
    const auto kernel = flash_bwd_dkv_wide_wgmma_kernel<T>;
    const cudaError_t e = opt_in(reinterpret_cast<const void*>(kernel));
    if (e != cudaSuccess) return e;
    kernel<<<grid, kGThreads, L::SMEM, s>>>(maps[0], maps[1], maps[2],
                                            maps[3], maps[4], maps[5], a);
  } else {
    const auto kernel = flash_bwd_dq_wide_wgmma_kernel<T>;
    const cudaError_t e = opt_in(reinterpret_cast<const void*>(kernel));
    if (e != cudaSuccess) return e;
    kernel<<<grid, kGThreads, L::SMEM, s>>>(maps[0], maps[1], maps[2],
                                            maps[3], a);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 kernels, on the tensor cores by split TF32:
// `flash_bwd_dq_wide_tf32x3_kernel<float>` and
// `flash_bwd_dkv_wide_tf32x3_kernel<float>`. They join the D = 256
// split-TF32 backward (`x3_body` of flash_attention_bwd.cu: mma.sync m16n8k8
// .tf32 three times a product, big.big in one chain and the small terms in
// another, each tile's share of a sum folded in with f32 rounding) with the
// streaming of D of the wide f32 forward (`flash_fwd_wide_tf32x3_kernel` of
// flash_attention.cu), in place of an FMA design (every product on the FMA
// units, the output's columns split over blocks in 64-column chunks, each
// recomputing S and dP: 8 times at D = 512), whose f32 instances took
// 1.5972 and 1.6164 ms at (2, 4, 512, 512, 512), 5.21x SDPA's whole
// backward.
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
        stage<float, kW, kW, kWThreads>(dst, r1 + p, lr1, r0, n_res);
        stage<float, kW, kW, kWThreads>(dst + kW * kW, s1 + p, ls1, s0,
                                        n_str);
        stage<float, kW, kW, kWThreads>(dst + 2 * kW * kW, r2 + p, lr2, r0,
                                        n_res);
        stage<float, kW, kW, kWThreads>(dst + 3 * kW * kW, s2 + p, ls2, s0,
                                        n_str);
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
