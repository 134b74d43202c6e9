// FlashAttention-2 forward, written for Hopper (sm_90a): five kernels. f32
// at head dims 64 and 128 runs `flash_fwd_kernel` on the FMA units (this
// note); f32 at 256 runs `flash_fwd_tf32x3_kernel` on the tensor cores by
// split TF32, mma.sync (the second note); bf16 and f16 run
// `flash_fwd_wgmma_kernel` on the tensor cores, wgmma fed by TMA, at every
// head dim up to 256 (the third note). Above 256 (the fourth note) bf16 and
// f16 run `flash_fwd_wide_wgmma_kernel` and f32
// `flash_fwd_wide_tf32x3_kernel`, each grown from its D = 256 sibling.
//
// Replaces: incubator_mxnet_tpu/ops/pallas/flash_attention.py, `_fwd_kernel`
// (called from `_fwd`). Same function: O = softmax(scale * Q K^T) V with an
// online softmax over key tiles in f32, the per-row logsumexp written beside
// O, bottom-right causal masking (row r sees keys c <= r + lk - lq), keys at
// or past `kv_len` masked, ragged tiles masked in place, and a row that sees
// no key gives O = 0 (and lse = -inf). O has the input dtype, lse is f32.
//
// What bounds it on the card: operations. The two products cost 4 D flops
// a (query, key) pair that the mask lets through, against 4 L D elements
// moved a head: at BERT's (L = 128, D = 64) 128 flops an element, 32 a byte
// in f32, and more at the LM's L = 512; the H100's ridge between 67 TFLOP/s
// f32 outside the tensor cores (the main paths run f32 with TF32 off) and
// 3.35 TB/s is about 20. So the bound is 4 pairs D / 67 TFLOP/s: 0.00601 ms
// at (8, 12, 128, 128, 64), 0.0482 ms at (8, 12, 512, 512, 64) causal.
//
// The TPU kernel's sequential grid axis over key blocks (which carried m, l
// and acc in scratch from one grid step to the next) becomes a loop over
// 64-key tiles inside the block, with m, l and O's accumulator in registers.
// A block of 4 warps owns 64 query rows, a warp 16 of them: lane (tr, tc) of
// its 4 x 8 grid owns rows tr + 4i (i < 4), keys tc + 8j (j < 8) of the
// 64-key score tile, and O columns 4 tc + 32 m (+0..3). What the design does
// about what held the kernel's first version back:
// - Shared-memory instructions set the pace (2.7 FMAs a scalar load, from
//   transposed tiles padded to 65 floats). Every tile is now row-major with
//   rows of D values, unpadded and XOR-swizzled (16-byte chunk c of row r at
//   c ^ (r & 7)), and both products read their operands 16 bytes at a time
//   (8 in bf16) along their reduction axis: a 4 x 8 score piece takes 12
//   reads for 128 FMAs a 4-step of D (10.7 FMAs a read, 1.5 bytes of shared
//   reads a FMA against the backward's 2), P V 4 + 4 D/32 reads for 64 D/32
//   FMAs a 4-step of keys (10.7 at D = 64, 12.8 at 128). The lanes of a warp
//   share their reads (the 8 lanes of a row group read one Q address; the 8
//   column groups read 8 rows whose chunks sit in distinct banks).
// - Staging was scalar and never overlapped compute. Q and every K/V tile
//   arrive by 16-byte cp.async (through L2, no registers, zero-filled past
//   the end of a sequence); K and V are double-buffered, so tile t + 1 is in
//   flight while tile t is computed. The scale is applied to S in registers
//   (32 multiplies a tile against 2048 FMAs), not to Q at staging.
// - P went round the whole block, behind a third barrier. Now P never
//   leaves its warp: each warp writes its 16 x 64 P to a tile of its own,
//   laid out so that the lanes' 4-byte writes and 16-byte reads land in
//   distinct banks, and reads it back after __syncwarp. The row max is a
//   3-step shuffle among the 8 lanes of a row; the row sum stays in each
//   lane (scaled with the row's max like O) and is summed over the 8 lanes
//   once, after the last tile. One __syncthreads a key tile both publishes
//   tile t and frees the buffer that tile t + 1 refills.
// - Occupancy and the causal tail. At D = 64 a block takes 128 threads and,
//   in f32, 96 KB of shared memory (Q 16 KB, two stages of K and V 64 KB,
//   the warps' P 16 KB), so 2 blocks (8 warps) fit an SM: 264 slots. The
//   LM's (8, 12, 512) is 96 heads x 8 query tiles = 768 blocks, 2.9 waves;
//   BERT's L = 128 is 2 query tiles a head: 24 blocks at bucket 1 (24 of
//   132 SMs busy), 192 at bucket 8 (0.73 of a wave: 60 SMs run two), 768 at
//   bucket 32. Blocks are issued heavy first: blockIdx.y counts query tiles
//   down from the last, which sees the most keys under the causal mask, so
//   the longest blocks start in the first wave and the short ones fill the
//   tail. A block stops at the diagonal of its last row and at kv_len; a
//   warp skips a key tile that the mask hides from all of its rows, and
//   applies the mask only where the tile crosses the diagonal or kv_len.
// - D = 128 uses the same tiles: 176 KB in f32, one block of 4 warps an SM.
// - What bounds the design now, as far as its timings on an NVIDIA H100
//   80GB HBM3 at 700 W tell (PERF.md, section 6): the path from shared
//   memory to registers, taken as 128 bytes a cycle an SM (32 floats a
//   cycle against 128 FMAs): a 4 x 8 piece needs 12 floats for 32 FMAs, so
//   these tiles cap near 67% of the FMA peak. At the LM's shape they reach
//   about 43% on the tiles they compute (38% of the bound, which counts
//   only the pairs the mask lets through), with 2 warps a scheduler to
//   hide the latency of the reads. An 8 x 8 piece (32 rows a warp) would
//   lift that cap, but spilled at 255 registers with O's accumulator live;
//   32-row blocks and 8 x 4 lane grids were slower.
//
// - D = 256 in f32 (C5: head dims 129-256, which the wrapper pads to 256)
//   runs flash_fwd_tf32x3_kernel below: these tiles fit it with one stage
//   of K and V only and O's accumulator at 128 registers a lane, and took
//   1.87x SDPA's forward there (PERF.md).
//
// The products run on the FMA units (no tensor cores, so f32 stays exact to
// f32 rounding), each sum in a fixed order: no atomics, the same bits on
// every call. The kernel is built for f32 only (D = 64 and 128): bf16 and
// f16 go to flash_fwd_wgmma_kernel at every head dim.
//
// Q, K and V are read through (batch, head, row) strides with a unit stride
// on the head dimension, so the (B, L, H, D) views that multi-head attention
// cuts out of one fused QKV projection go in without a copy; O is written
// 16 bytes a lane (8 in bf16) through its strides, into the (B, L, H, D)
// buffer the wrapper makes. The 16-byte copies and stores need 16-byte
// aligned rows: the wrapper copies any input whose pointer or strides are
// not (no main path has one).
#include "common.cuh"
#include "hopper.cuh"

namespace mxt {
namespace {

constexpr int kWarps = 4;               // warps a block
constexpr int kTR = 4;                  // row groups of a warp's lanes
constexpr int kTC = 32 / kTR;           // column groups
constexpr int kRI = 4;                  // query rows a lane
constexpr int kNJ = 8;                  // keys a lane
constexpr int kWR = kTR * kRI;          // query rows a warp
constexpr int kBQ = kWarps * kWR;       // query rows a block
constexpr int kBK = kTC * kNJ;          // keys a tile
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;          // a row max before any key

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // (B*H, lq), natural log
  int H, lq, lk;
  Strides sq, sk, sv, so;
  float scale;
  int causal;
  int kv_len;
};

// Q, the two stages of (K, V), then the warps' f32 P tiles
template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(T) * ((size_t)kBQ * D + 2 * 2 * (size_t)kBK * D) +
         sizeof(float) * (size_t)kWarps * kWR * kBK;
}

// Shared memory holds a block to 2 an SM at D = 64 in f32, so the bound
// lets ptxas use every register that 2 blocks allow (255); without it,
// ptxas stops at 168 and spills.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const FwdArgs a) {
  static_assert(std::is_same<T, float>::value && D <= 128,
                "f32 at D = 64 and 128; D = 256 is flash_fwd_tf32x3_kernel");
  constexpr int MD = D / (4 * kTC);     // 4-column runs of O a lane
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  T* const qs = reinterpret_cast<T*>(fwd_smem);
  T* const kv = qs + kBQ * D;           // stage s: K at + 2 s kBK D, then V
  float* const ps = reinterpret_cast<float*>(kv + 2 * 2 * kBK * D);

  const int tid = threadIdx.x;
  const int w = tid >> 5, tr = (tid & 31) / kTC, tc = tid % kTC;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  // heavy first: the last query tile sees the most keys
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBQ;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;

  // key tiles this block needs: up to kv_len, and for causal up to the
  // diagonal of its last real row
  int n_kv = (kv_lim + kBK - 1) / kBK;
  if (a.causal) {
    const int last_col = min(q0 + kBQ, lq) - 1 + offset;
    n_kv = min(n_kv, last_col < 0 ? 0 : last_col / kBK + 1);
  }
  auto stage_kv = [&](int t, int slot) {
    T* const dk = kv + 2 * slot * kBK * D;
    stage<T, D, kBK, kThreads>(dk, kb, a.sk.l, t * kBK, lk);
    stage<T, D, kBK, kThreads>(dk + kBK * D, vb, a.sv.l, t * kBK, lk);
  };
  if (n_kv > 0) {
    stage<T, D, kBQ, kThreads>(qs, qb, a.sq.l, q0, lq);
    stage_kv(0, 0);
  }
  cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  const float ninf = __int_as_float((int)0xff800000u);
  float m[kRI], l[kRI], acc[kRI][4 * MD];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * MD; ++c) acc[i][c] = 0.f;
  }

  const T* const qw = qs + kWR * w * D;         // this warp's rows
  float* const pw = ps + kWR * w * kBK;         // this warp's P
  const int w0 = q0 + kWR * w;

  for (int t = 0; t < n_kv; ++t) {
    const int slot = t & 1;
    // tile t has landed; every warp is done with tile t - 1's buffer
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_kv) stage_kv(t + 1, slot ^ 1);
    cp_async_commit();

    // the warp's rows [w0, w0 + kWR) against keys [k0, k0 + kBK): none
    // visible (skipped), all visible (no mask), or some
    const int k0 = t * kBK;
    if (w0 >= lq || k0 >= kv_lim || (a.causal && k0 > w0 + kWR - 1 + offset))
      continue;
    const bool all = k0 + kBK <= kv_lim &&
                     (!a.causal || k0 + kBK - 1 <= w0 + offset);
    const T* const kt = kv + 2 * slot * kBK * D;
    const T* const vt = kt + kBK * D;

    float s[kRI][kNJ];
    score<T, D, kTR, kRI, kNJ>(s, qw, kt, tr, tc);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int row = w0 + tr + kTR * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int key = k0 + tc + kTC * j;
        s[i][j] = all || (key < kv_lim && (!a.causal || key <= row + offset))
                      ? s[i][j] * sl2 : ninf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < kTC; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float p = exp2f(s[i][j] - m_new);   // 0 where masked
        rs += p;
        // P V takes p in T (`p.astype(v_ref.dtype)`); the sum does not
        pw[xat<kBK, kTR>(tr + kTR * i, tc + kTC * j)] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + rs;                   // this lane's keys only
#pragma unroll
      for (int c = 0; c < 4 * MD; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();
    accumulate<T, D, kBK, kTR, kRI>(acc, pw, vt, tr, tc);
    // the next tile's P writes come after the next __syncthreads
  }

  T* const ob = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    // the row sum over the lanes of the row
#pragma unroll
    for (int o = 1; o < kTC; o <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
    const int row = w0 + tr + kTR * i;
    if (row >= lq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int mm = 0; mm < MD; ++mm) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[i][4 * mm + e] * inv;
      stg4(ob + row * a.so.l + 4 * tc + 4 * kTC * mm, v);
    }
    if (tc == 0)
      a.lse[(size_t)bh * lq + row] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * 0.69314718055994531f : ninf;
  }
}

template <typename T, int D>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, D>();
  const auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.H, (a.lq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 forward at D = 256, on the tensor cores by split TF32.
//
// Replaces: `_fwd_kernel` of incubator_mxnet_tpu/ops/pallas/flash_attention.py
// (called from `_fwd`) for f32 at head dims 129-256, which the wrapper pads
// to 256; f32 at 64 and 128 keeps flash_fwd_kernel above. Same function,
// masks, strides, output buffer and lse as that kernel.
//
// What bounds it: operations. At (4, 8, 512, 512, 256) without the mask
// the two products do 4 pairs D flops (8.6 GFLOP) against 67 MB moved:
// 0.128 ms at the 67 TFLOP/s of the FMA units, which FMA tiles at D = 256
// did not come near (the FMA instance of the kernel above, one stage of K
// and V, took 0.49 ms, 1.87x SDPA's forward). Split TF32 runs each f32
// product as three TF32 products (split_tf32, mma_tf32 in hopper.cuh; the
// scheme of the backward's split-TF32 kernels, whose note in
// flash_attention_bwd.cu says why mma.sync and not wgmma): 0.052 ms at
// 495 TFLOP/s.
//
// What the design does about it:
// - Every product is on the tensor cores, mma.sync m16n8k8 .tf32, three
//   times a product (small.big + big.small + big.big, summed in f32).
// - A block owns 64 query rows and is 16 warps, four to a 16-row group, one
//   block an SM. Q stays resident (64 KB, swizzled as in the kernel above);
//   K and V stream in tiles of 16 keys through three cp.async stages
//   (180,224 bytes with the exchanges), so the next tiles are in flight
//   while one is computed; a tile's loads are published, and its buffers
//   freed, by one __syncthreads. ptxas gives 126 registers a thread and no
//   spill.
// - S = Q K^T: warp w of a group sums its quarter (64 columns) of D for the
//   group's 16 x 16 scores, A from Q and B from K by ldmatrix (conflict-free
//   under the swizzle), big.big in one chain and the small terms in
//   another. The four quarters meet through a 4 KB exchange of the group at
//   a named barrier, lane for lane in the accumulator's layout, and every
//   warp sums them in the same order, so the group's four warps hold the
//   same S and form the same masked P, row max m and row sum l.
// - O += P V: each warp sums P V into its quarter of O's 256 columns (32
//   registers a lane, against the FMA kernel's 128). A comes straight from
//   S's accumulators in the permuted k order of the backward's sums (k = t
//   is key 2t, k = t + 4 key 2t + 1), so P never touches shared memory; B
//   is V's rows 2t and 2t + 1, a 4-byte load a value, which the swizzle
//   spreads over the 32 banks. P (finite: masked scores are -inf before
//   exp2, 0 after) is split like any other operand.
// - The tensor cores cut each mma's sum toward zero, which over long
//   chains of one accumulator grew the backward's error (PERF.md).
//   Here a tile's S is a fresh sum of 8 k-steps a quarter, and a tile's
//   P V is formed in a partial of its own, folded into O's running sum with
//   f32 rounding after alpha rescales that sum.
// - Masks and order: the kernel above's. Blocks are issued heavy first; a
//   block stops at its last row's diagonal and at kv_len; a group skips a
//   tile the mask hides from all its rows and masks only tiles that cross
//   an edge. A row that sees no key gives O = 0 and lse = -inf. Every sum
//   runs in a fixed order and nothing is atomic: the same bits on every
//   call.
// Measured (PERF.md, on an NVIDIA H100 80GB HBM3 at 700 W): 0.24 ms at
// (4, 8, 512, 512, 256), 0.96x SDPA's forward and 2.0x faster than the FMA
// instance, issuing about 107 TFLOP/s of TF32 products: like the backward's
// split-TF32 kernels, the rate of the mma.sync path. Two stages, or one
// chain for S, timed the same; 32-key tiles spilled (128 registers) and
// were 4-6% slower.
// ---------------------------------------------------------------------------

constexpr int kTD = 256;            // the head dim of this kernel
constexpr int kTRows = 64;          // query rows a block
constexpr int kTKeys = 16;          // keys a tile
constexpr int kTStages = 3;         // K/V stages in flight
constexpr int kTThreads = 512;      // 16 warps: four a 16-row group
constexpr int kTN = kTKeys / 8;     // S's 8-key tiles, P V's k-steps

struct TTile {
  static constexpr int Q = kTRows * kTD;        // floats of Q
  static constexpr int KV = kTKeys * kTD;       // of a K or a V tile
  static constexpr int XCH = 4 * kTN * 32 * 4;  // a group's exchange
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)Q + 2 * kTStages * (size_t)KV +
                       (kTRows / 16) * (size_t)XCH);
};

// T and D name the instance (float, 256), as every kernel of this
// directory's name carries its type.
template <typename T, int D>
__global__ void __launch_bounds__(kTThreads, 1)
flash_fwd_tf32x3_kernel(const FwdArgs a) {
  static_assert(std::is_same<T, float>::value && D == kTD, "f32, D = 256");
  extern __shared__ __align__(128) unsigned char tf_smem[];
  float* const qs = reinterpret_cast<float*>(tf_smem);
  float* const kv = qs + TTile::Q;              // stage s: K at + 2 s KV
  float* const xch = kv + 2 * kTStages * TTile::KV;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, wq = warp & 3;     // 16-row group, quarter
  const int g = lane >> 2, t4 = lane & 3;       // the accumulator's layout
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  // heavy first: the last query tile sees the most keys
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kTRows;
  const int w0 = q0 + 16 * grp;                 // the group's first row

  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;

  int n_kv = (kv_lim + kTKeys - 1) / kTKeys;
  if (a.causal) {
    const int last_col = min(q0 + kTRows, lq) - 1 + offset;
    n_kv = min(n_kv, last_col < 0 ? 0 : last_col / kTKeys + 1);
  }
  auto stage_kv = [&](int t, int slot) {
    float* const dk = kv + 2 * slot * TTile::KV;
    stage<float, D, kTKeys, kTThreads>(dk, kb, a.sk.l, t * kTKeys, lk);
    stage<float, D, kTKeys, kTThreads>(dk + TTile::KV, vb, a.sv.l,
                                       t * kTKeys, lk);
  };
  // Q and tile 0 in the first copy group, tiles 1 .. kTStages - 2 in one
  // each; every thread commits a group per tile, empty or not, so that
  // waiting for all but kTStages - 2 groups waits for tile t
  if (n_kv > 0) stage<float, D, kTRows, kTThreads>(qs, qb, a.sq.l, q0, lq);
#pragma unroll
  for (int s = 0; s < kTStages - 1; ++s) {
    if (s < n_kv) stage_kv(s, s);
    cp_async_commit();
  }

  // S by ldmatrix: lane l addresses row l % 8 of block l / 8. A (Q):
  // blocks are rows 0-7, 8-15, 0-7, 8-15 of the group at columns k..k+3,
  // k..k+3, k+4..k+7, k+4..k+7 (a0-a3); B (K): keys 0-7 at k..k+3 and
  // k+4..k+7 (b0, b1 of n-tile 0), then keys 8-15 likewise. Step s of a
  // 32-column swizzle group reads chunk 2 s + (0 or 1) of the row, at that
  // XOR (row & 7); the warp's quarter of D starts 2 groups (256 bytes) on
  // per quarter.
  const int mj = lane >> 3, mi = lane & 7;
  const unsigned a_row = smem_u32(qs) +
                         (unsigned)((16 * grp + 8 * (mj & 1) + mi) * D * 4 +
                                    256 * wq);
  const unsigned b_row =
      (unsigned)((8 * (mj >> 1) + mi) * D * 4 + 256 * wq);
  unsigned a_at[4], b_at[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a_at[s] = a_row + ((((2 * s) + (mj >> 1)) ^ mi) << 4);
    b_at[s] = b_row + ((((2 * s) + (mj & 1)) ^ mi) << 4);
  }
  // P V's B: rows 2 t4 (b0) and 2 t4 + 1 (b1) of each 8-key step of V,
  // columns d0 + 8 n + g. Under the swizzle column 8 n + g of row 2 t4 sits
  // at 8 (n ^ t4) + g, of row 2 t4 + 1 at 8 (n ^ t4) + (g ^ 4); with
  // n = 4 m + u that is 32 m on from the lane's offset for u.
  const int d0 = 64 * wq;
  int o0[4], o1[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    o0[u] = 2 * t4 * D + d0 + 8 * (u ^ t4) + g;
    o1[u] = (2 * t4 + 1) * D + d0 + 8 * (u ^ t4) + (g ^ 4);
  }

  const float sl2 = a.scale * kLog2e;
  const float ninf = __int_as_float((int)0xff800000u);
  // O's quarter: acc[n][e] is row g + 8 (e >> 1), column d0 + 8 n + 2 t4 +
  // (e & 1); m and l of rows g and g + 8 (l: this lane's keys only)
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float4* const x4 = reinterpret_cast<float4*>(xch + grp * TTile::XCH);

  for (int t = 0; t < n_kv; ++t) {
    // tile t has landed; every warp is done with tile t - 1's buffers
    cp_async_wait<kTStages - 2>();
    __syncthreads();
    {
      const int nt = t + kTStages - 1;
      if (nt < n_kv) stage_kv(nt, nt % kTStages);
      cp_async_commit();
    }

    // the group's rows [w0, w0 + 16) against keys [k0, k0 + 16): none
    // visible (skipped by its four warps), all visible (no mask), or some
    const int k0 = t * kTKeys;
    if (w0 >= lq || k0 >= kv_lim || (a.causal && k0 > w0 + 15 + offset))
      continue;
    const bool all = k0 + kTKeys <= kv_lim &&
                     (!a.causal || k0 + kTKeys - 1 <= w0 + offset);
    const float* const kt = kv + 2 * (t % kTStages) * TTile::KV;
    const float* const vt = kt + TTile::KV;

    // this warp's quarter of S: element (n, e) is row g + 8 (e >> 1), key
    // k0 + 8 n + 2 t4 + (e & 1); big.big in f[0], the small terms in f[1]
    float f[2][kTN][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int n = 0; n < kTN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[x][n][e] = 0.f;
    const unsigned ks = smem_u32(kt);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t ar[4], ab[4], as[4];
        ldsm4(a_at[s] + 128 * c, ar);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(ar[e]), ab[e], as[e]);
#pragma unroll
        for (int kg = 0; kg < kTN / 2; ++kg) {
          // keys 16 kg .. 16 kg + 15: n-tiles 2 kg and 2 kg + 1
          uint32_t br[4], bb[4], bs[4];
          ldsm4(ks + b_at[s] + 128 * c + 16 * D * 4 * kg, br);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(br[e]), bb[e], bs[e]);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_tf32(f[1][2 * kg + n], as, bb[2 * n], bb[2 * n + 1]);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_tf32(f[1][2 * kg + n], ab, bs[2 * n], bs[2 * n + 1]);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_tf32(f[0][2 * kg + n], ab, bb[2 * n], bb[2 * n + 1]);
        }
      }
    }
    // the group's four quarters meet: S = ((S_0 + S_1) + S_2) + S_3,
    // summed in that order by every warp of the group
#pragma unroll
    for (int n = 0; n < kTN; ++n)
      x4[(kTN * wq + n) * 32 + lane] =
          make_float4(f[0][n][0] + f[1][n][0], f[0][n][1] + f[1][n][1],
                      f[0][n][2] + f[1][n][2], f[0][n][3] + f[1][n][3]);
    named_sync(1 + grp, 128);
    float sv[kTN][4];
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      float4 q = x4[n * 32 + lane];
#pragma unroll
      for (int p = 1; p < 4; ++p) {
        const float4 r = x4[(kTN * p + n) * 32 + lane];
        q.x += r.x; q.y += r.y; q.z += r.z; q.w += r.w;
      }
      sv[n][0] = q.x; sv[n][1] = q.y; sv[n][2] = q.z; sv[n][3] = q.w;
    }

    // the online softmax of rows g (hh 0) and g + 8 (hh 1): the row max
    // over the quad, exp2 with scale * log2(e) folded in
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = w0 + g + 8 * hh;
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < kTN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * n + 2 * t4 + e;
          float& x = sv[n][2 * hh + e];
          x = all || (key < kv_lim && (!a.causal || key <= row + offset))
                  ? x * sl2 : ninf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < kTN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sv[n][2 * hh + e];
          x = exp2f(x - m_new);                  // 0 where masked
          rs += x;
        }
      l[hh] = l[hh] * alpha + rs;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }

    // O += P V over the quarter: A is P, k-permuted (see above), split;
    // each pair of 8-column tiles sums the tile's 16 keys in a partial of
    // its own, folded into acc with f32 rounding
    uint32_t pb[kTN][4], ps[kTN][4];
#pragma unroll
    for (int kk = 0; kk < kTN; ++kk) {
      const float ax[4] = {sv[kk][0], sv[kk][2], sv[kk][1], sv[kk][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(ax[e], pb[kk][e], ps[kk][e]);
    }
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int u0 = 0; u0 < 4; u0 += 2) {
        float q[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) q[u][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kTN; ++kk) {
          const float* const bt = vt + kk * 8 * D + 32 * mm;
          uint32_t bb[2][2], bs[2][2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            split_tf32(bt[o0[u0 + u]], bb[u][0], bs[u][0]);
            split_tf32(bt[o1[u0 + u]], bb[u][1], bs[u][1]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma_tf32(q[u], ps[kk], bb[u][0], bb[u][1]);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma_tf32(q[u], pb[kk], bs[u][0], bs[u][1]);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma_tf32(q[u], pb[kk], bb[u][0], bb[u][1]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * mm + u0 + u][e] += q[u][e];
      }
  }

  // O = acc / l (0 for a row that saw no key) in the warp's quarter of the
  // columns, rows g and g + 8, two columns a store; lse from one warp of
  // the group. A block that saw no tile writes its zeros and -inf.
  T* const ob = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = w0 + g + 8 * hh;
    if (row >= lq) continue;
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(ob + row * a.so.l + d0 + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
    if (wq == 0 && t4 == 0)
      a.lse[(size_t)bh * lq + row] =
          l[hh] > 0.f ? (m[hh] + log2f(l[hh])) * 0.69314718055994531f
                      : ninf;
  }
}

cudaError_t launch_tf32x3(const FwdArgs& a, int B, cudaStream_t s) {
  const auto kernel = flash_fwd_tf32x3_kernel<float, kTD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TTile::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.H, (a.lq + kTRows - 1) / kTRows);
  kernel<<<grid, kTThreads, TTile::SMEM, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 and f16 forward on the tensor cores (sm_90a): wgmma fed by TMA.
//
// Replaces: `_fwd_kernel` of incubator_mxnet_tpu/ops/pallas/flash_attention.py
// for bf16 and f16 inputs, computing what it computes: S = Q K^T in f32 from
// 16-bit operands (a product of two bf16, or two f16, values is exact in
// f32), the online softmax in f32 with the row sum l taken from the
// unrounded p, p rounded to the input type T before P V
// (`p.astype(v_ref.dtype)`), O = acc / l rounded once to T (in f16 a value
// past 65504 is inf, as the cast makes it), the lse in f32; the same masks,
// the same (batch, head, row) strides, the same output buffer and the same
// lse as the f32 kernel above. One template serves both 16-bit types: only
// the wgmma's operand type, the tensor maps' element type and the two
// roundings differ.
//
// What bounds it on the card: bytes. At 4 D flops a visible (query, key)
// pair against 2 (2 lq + 2 lk) D bytes a head, BERT's (8, 12, 128, 128,
// 64) does 64 flops a byte and the LM's causal (8, 12, 512, 512, 64) 128,
// both under the H100's ridge of about 295 (989 TFLOP/s bf16 or f16 against
// 3.35 TB/s). The bound is Q, K, V and O moved once (and the f32 lse):
// 0.00189 ms at BERT's bucket 8, 0.0076 ms at the LM's shape (the
// products alone take 0.0008 and 0.0033 ms there). At D = 256 (C5, head
// dims 129-256 padded to 256) the non-causal (4, 8, 512, 512, 256) does
// 256 flops a byte, still under the ridge: 0.0100 ms of bytes against
// 0.0087 of products, so the products nearly set the pace there and the
// design has to keep the tensor cores busy, not just the loads in flight.
//
// What the design does about it:
// - A block is one consumer warpgroup (4 warps) that owns 64 query rows,
//   and one producer warp: 160 threads. The grid is (B * H, ceil(lq / 64)),
//   heavy first on blockIdx.y as in the f32 kernel. A block stops at its
//   last row's diagonal and at kv_len.
// - Loads move each byte once and cost the consumers nothing: Q, K and V
//   each have a 4-D tensor map (D, L, H, B) built from the strides the
//   wrapper passes, so the (B, L, H, D) views cut out of one fused QKV
//   projection go in without a copy. A box is 64 columns x 64 rows (128
//   bytes a row) with the 128-byte swizzle; D = 128 takes two column
//   boxes. The producer's one thread loads Q once, then K and V tile by
//   tile (64 keys) into a 2-stage ring: K and V complete on full mbarriers
//   of their own (S needs only K), and the consumers free a stage through
//   its empty mbarrier once P V has read it. TMA zero-fills rows past lq and
//   keys past lk. Shared memory: 40 KB at D = 64, 80 KB at D = 128, 160
//   KB at D = 256 (four column boxes a tile): one block an SM there.
// - S = Q K^T is D / 16 `wgmma.m64n64k16` with both operands in shared
//   memory (K is a K-major B: imm-trans-b = 0), into 32 f32 registers a
//   thread.
// - The softmax runs in registers on the accumulator's layout: a thread
//   holds 2 rows x 16 keys of S, so a row's max takes 2 shuffles within a
//   quad; exp2 with scale * log2(e) folded in; the mask is applied only on
//   tiles that cross the diagonal or kv_len.
// - O += P V never writes P to shared memory: the m64n64 accumulator's 16-
//   key slices are, packed to T, exactly the A fragments of the four k16
//   steps of `wgmma.m64nDk16` with A in registers. V (keys x D, D
//   contiguous) is an MN-major B, read through the transpose bit as w is in
//   mm_wgmma.cu.
// - D = 256 replaces the FMA instance `flash_fwd_kernel<T, 256>` that took
//   16-bit calls before, at 30x SDPA's flash forward. O's accumulator is the
//   whole 64 x 256 tile, 128 f32 registers a thread, beside S's 32 and P's 16
//   packed ones: under the 255 a thread may hold at one block an SM (160 KB of
//   tiles allow no second block anyway), so O is not split over blocks and S
//   is computed once. P V is one `wgmma.m64n256k16` a k16 step (the widest
//   form: one A fragment feeds all 256 columns, V's four column boxes LBO = 8
//   KB apart), S sixteen m64n64k16 steps.
// - The epilogue stages O / l (T) through shared memory (the ring is
//   free by then) and stores 16 bytes a thread, rows < lq only, through O's
//   strides into the (B, L, H, D) buffer.
// - Tensor maps are encoded on the host per call and passed by value as
//   __grid_constant__ parameters, so a CUDA graph captures them with the
//   launch.
// Every sum runs in a fixed order and nothing is atomic: the same bits on
// every call. Left for later: a 128-row block of two consumer warpgroups
// sharing K and V, ping-pong between them, and overlapping one tile's
// softmax with the next tile's S (ROADMAP); at D = 256 a block has one
// warpgroup of tensor-core work in flight, and the softmax runs while the
// tensor cores wait.
// ---------------------------------------------------------------------------

constexpr int kWgRows = kBoxRows;        // query rows a block
constexpr int kWgKeys = kBoxRows;        // keys a tile
constexpr int kWgThreads = 128 + 32;     // one consumer warpgroup, a producer

template <int D>
struct WgFwd {
  static constexpr int TILE = D / 64 * kBox;     // a Q, K or V tile
  static constexpr int STAGES = 2;
  // Q, then stage s's K at TILE (1 + 2 s) and its V right after
  static constexpr int BARS = TILE * (1 + 2 * STAGES);
  static constexpr int OUT_LD = D + 8;           // a staged O row, in values
  // the tiles, 7 mbarriers (Q, and full K, full V, empty a stage), slack
  // to align the tiles to the 1024-byte period of the 128-byte swizzle
  static constexpr int SMEM = BARS + 8 * (1 + 3 * STAGES) + 1024;
  static_assert(kWgRows * OUT_LD * 2 <= BARS, "staged O fits the tiles");
};

struct WgArgs {
  void* o;
  float* lse;          // (B*H, lq), natural log
  Strides so;
  int H, lq, lk;
  float scale;
  int causal;
  int kv_len;
};

// T is __nv_bfloat16 or __half: the kernel's name carries its type, as every
// kernel of this directory's does.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 3 : D == 128 ? 2 : 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const WgArgs a) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  using L = WgFwd<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char fwg_smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fwg_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const qbar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* const kfull = qbar + 1;
  uint64_t* const vfull = kfull + STAGES;
  uint64_t* const empty = vfull + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  // heavy first: the last query tile sees the most keys
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kWgRows;
  int n_kv = (kv_lim + kWgKeys - 1) / kWgKeys;
  if (a.causal) {
    const int last_col = min(q0 + kWgRows, lq) - 1 + offset;
    n_kv = min(n_kv, last_col < 0 ? 0 : last_col / kWgKeys + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);     // the producer's arrive, plus the bytes
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 1);     // the consumer warpgroup's arrive
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4) {
    // the producer: one thread loads Q, then keeps the ring full
    if (threadIdx.x % 32 == 0 && n_kv > 0) {
      mbar_expect_tx(qbar, L::TILE);
#pragma unroll
      for (int j = 0; j < D / 64; ++j)
        tma_load_4d(smem + j * kBox, &tq, 64 * j, q0, h, b, qbar);
      int stage = 0, phase = 0;
      for (int t = 0; t < n_kv; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* const kt = smem + L::TILE * (1 + 2 * stage);
        mbar_expect_tx(&kfull[stage], L::TILE);
#pragma unroll
        for (int j = 0; j < D / 64; ++j)
          tma_load_4d(kt + j * kBox, &tk, 64 * j, t * kWgKeys, h, b,
                      &kfull[stage]);
        mbar_expect_tx(&vfull[stage], L::TILE);
#pragma unroll
        for (int j = 0; j < D / 64; ++j)
          tma_load_4d(kt + L::TILE + j * kBox, &tv, 64 * j, t * kWgKeys, h,
                      b, &vfull[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers. A thread holds, for each 8-column group j of a 64-row
  // accumulator, columns 8j + 2 (lane % 4) + {0, 1} of rows r0 and r0 + 8
  // (r0 = 16 warp + lane / 4): acc[4j + {0, 1}] and acc[4j + {2, 3}].
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int w0 = q0 + warp * 16;               // the warp's first row
  const float sl2 = a.scale * kLog2e;
  const float ninf = __int_as_float((int)0xff800000u);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const unsigned qs = smem_u32(smem);
  if (n_kv > 0) mbar_wait(qbar, 0);

  int stage = 0, phase = 0;
  for (int t = 0; t < n_kv; ++t) {
    const unsigned ks = smem_u32(smem + L::TILE * (1 + 2 * stage));
    const unsigned vs = ks + L::TILE;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(&kfull[stage], phase);
    __syncwarp();                  // wgmma is issued by converged warps
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // 32 bytes a k16 step along a swizzled 128-byte row, the next column
      // box after four; 8-row groups 1024 bytes apart in Q and in K
      const unsigned off = (kk / 4) * kBox + 32 * (kk % 4);
      wgmma_m64n64<T, 0>(s, wg_desc(qs + off, 16, 1024),
                         wg_desc(ks + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);

    // the warp's rows [w0, w0 + 16) against keys [k0, k0 + 64): all
    // visible (no mask) or some
    const int k0 = t * kWgKeys;
    const bool all = k0 + kWgKeys <= kv_lim &&
                     (!a.causal || k0 + kWgKeys - 1 <= w0 + offset);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + cq + e;
          float& x = s[4 * j + 2 * hh + e];
          x = all || (key < kv_lim && (!a.causal || key <= row + offset))
                  ? x * sl2 : ninf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hh + e];
          x = exp2f(x - m_new);                  // 0 where masked
          rs += x;
        }
      l[hh] = l[hh] * alpha + rs;                // this thread's keys only
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * hh] *= alpha;
        o[4 * j + 2 * hh + 1] *= alpha;
      }
    }
    // P in T as A's fragments: k16 step kk is columns 16 kk .. + 15, the
    // accumulator's groups 2 kk and 2 kk + 1
    unsigned pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[kk][i] = pack2<T>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    mbar_wait(&vfull[stage], phase);
    __syncwarp();
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(pf[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // 16 keys (2048 bytes) a step; D's 64-wide column boxes 8 KB apart
      const uint64_t bd = wg_desc(vs + 2048 * kk, kBox, 1024);
      if constexpr (D == 64) wgmma_m64n64_rs<T>(o, pf[kk], bd);
      else if constexpr (D == 128) wgmma_m64n128_rs<T>(o, pf[kk], bd);
      else wgmma_m64n256_rs<T>(o, pf[kk], bd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(pf[kk]);
    if (tid == 0) mbar_arrive(&empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // the row sums over the quad
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  // every warp is done with the tiles before they hold O
  named_sync(1, 128);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  T* const os = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<unsigned*>(
          os + (r0 + 8 * hh) * L::OUT_LD + 8 * j + cq) =
          pack2<T>(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
  }
  named_sync(1, 128);
  // 16-byte stores: consecutive threads on consecutive chunks of a row
  T* const ob = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
  constexpr int CPR = D / 8;
#pragma unroll 4
  for (int i = tid; i < kWgRows * CPR; i += 128) {
    const int r = i / CPR, c = (i % CPR) * 8;
    if (q0 + r < lq)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * a.so.l + c) =
          *reinterpret_cast<const uint4*>(os + r * L::OUT_LD + c);
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      if (row < lq)
        a.lse[(size_t)bh * lq + row] =
            l[hh] > 0.f ? (m[hh] + log2f(l[hh])) * 0.69314718055994531f
                        : ninf;
    }
  }
}

template <typename T, int D>
cudaError_t launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                         const CUtensorMap& tv, const WgArgs& a, int B,
                         int device, cudaStream_t s) {
  using L = WgFwd<D>;
  const auto kernel = flash_fwd_wgmma_kernel<T, D>;
  // above 48 KB of dynamic shared memory only after opting in, once a
  // device (before any capture: the wrapper's first call runs eagerly)
  static bool opted[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return e;
    opted[device] = true;
  }
  const dim3 grid(B * a.H, (a.lq + kWgRows - 1) / kWgRows);
  kernel<<<grid, kWgThreads, L::SMEM, s>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The forward at head dims above 256 (a multiple of 64; the wrapper pads
// 257-319 to 320, and so on): `flash_fwd_wide_wgmma_kernel<T>` for bf16 and
// f16, wgmma fed by TMA, and `flash_fwd_wide_tf32x3_kernel<float>`, split
// TF32 on mma.sync. Each grows out of its D = 256 sibling above.
//
// Replaces: `_fwd_kernel` of incubator_mxnet_tpu/ops/pallas/flash_attention.py
// (called from `_fwd`), which runs any head dim, padded to 128 lanes; the
// same function, masks, strides, output buffer and lse as the kernels
// above. In place of the FMA kernel that took every dtype above 256 before
// (all products on the FMA units, O split over blocks in 64-column chunks,
// each recomputing S: 8 times at D = 512).
//
// What bounds them: operations. At (2, 4, 512, 512, 512) the two products
// do 4 pairs D flops (4.3 GFLOP) against 16.8 MB moved in 16 bits (33.6 MB
// in f32): 0.0043 ms on the tensor cores in 16 bits, just under the 0.0050
// ms of the bytes; 0.0260 ms by split TF32 in f32 (0.0641 on the FMA units).
//
// What the designs do about it:
// - A block owns 64 query rows and a chunk of up to 256 of O's columns,
//   the accumulator each D = 256 kernel already keeps whole (kXCols): the
//   grid is (B * H * chunks, ceil(lq / 64)), heavy first on blockIdx.y, and
//   the ceil(D / 256) chunks of a row tile are neighbours on blockIdx.x, so
//   they read the same Q and K from L2 at about the same time. S is
//   computed once a chunk: twice at D = 512, so the products cost 6 pairs
//   D flops for the ideal 4 (the FMA kernel's 64-column chunks cost 18).
//   (2, 4, 512, 512, 512) is 8 heads x 8 row tiles x 2 chunks = 128
//   blocks, one a SM, one wave of 132.
//   The last chunk of a D that is no multiple of 256 holds fewer real
//   columns: V's boxes past D are not loaded, and their columns of O are
//   neither summed (f32) nor stored.
// - No tile of Q stays resident: at D = 512 one would be 64 KB in 16 bits
//   and 128 KB in f32, at D = 1024 twice that. For each key tile Q and K
//   stream through a ring in 64-column pieces (Q read again from L2 for
//   each key tile), S summed piece by piece, and then the tile's chunk of V
//   (64 keys x 256 columns) comes in. Any D runs in the same shared memory.
// - 16 bits: one consumer warpgroup and one TMA producer warp, as in
//   flash_fwd_wgmma_kernel. The ring holds 4 pieces (a Q box and a K box,
//   16 KB), and V has two stages of 32 KB: 131 KB. The producer loads tile
//   t's V before its pieces, so V lands while S is summed. The
//   consumers run 4 `wgmma.m64n64k16` a piece and release a piece's slot
//   once the next piece's products are issued and its own are done
//   (wgmma.wait_group 1). S is summed a 256-column piece of D at a time
//   in a fresh accumulator, folded into the tile's S in f32. The softmax,
//   P fed back as register A fragments, O += P V as 4 `wgmma.m64n256k16`
//   (V MN-major through the transpose bit) and the epilogue are the D = 256
//   kernel's. O 128, S 32 and its piece 32 registers a thread: ptxas gives
//   248, no spill.
// - f32: 16 warps, four a 16-row group, as in flash_fwd_tf32x3_kernel, but
//   64-key tiles split by keys where that kernel split S by D: a warp sums
//   its group's 16 rows against its 16 keys of the tile over the whole of
//   D, one 64-column piece at a time (a fresh pair of chains a piece, 8
//   k-steps, folded in f32: the D = 256 kernel's quarter); the four warps'
//   scores meet through a 4 KB exchange of the group at a named barrier,
//   and every warp reads them there twice, once for the row max and once,
//   16 keys at a time, to form P as mma A fragments straight from the read
//   (k-permuted as above), so no warp holds the tile's 64 scores. A warp
//   sums P V into its quarter (64 columns) of the chunk, a fresh partial a
//   16 keys folded into O's running sum (the D = 256 kernel's sums). Loads
//   are cp.async by every thread: a unit is a piece (Q 16 KB and K 16 KB)
//   or a tile's V chunk (64 KB), kXAhead units in flight, one
//   __syncthreads a unit; 3 piece buffers, one V buffer, the exchanges:
//   180,224 bytes, one block an SM. ptxas gives 128 registers (the most
//   512 threads allow) and spills 260 bytes (272 with the ldmatrix and V
//   offsets held in registers, 2% slower).
// - Masks and order as in the kernels above; lse is written by the chunk
//   of blockIdx.x % chunks == 0 only. Every sum runs in a fixed order and
//   nothing is atomic: the same bits on every call.
// Measured (PERF.md, on an NVIDIA H100 80GB HBM3 at 700 W), at (2, 4, 512,
// 512, 512): bf16 0.0301 ms, 0.65x SDPA's forward; f32 0.1919 ms, 1.35x
// SDPA's, at 34 TFLOP/s of f32 work counting S twice (the D = 256 kernel
// 36): like the other split-TF32 kernels, the rate of the mma.sync path,
// not of the loads (4 piece buffers and 3 units ahead timed the same).
// ---------------------------------------------------------------------------

constexpr int kXCols = 256;                // O's columns a block (a chunk)

struct WideWg {
  static constexpr int PIECES = 4;         // (Q box, K box) slots
  static constexpr int PIECE = 2 * kBox;
  static constexpr int VT = kXCols / 64 * kBox;   // a tile's chunk of V
  static constexpr int VSTAGES = 2;
  static constexpr int BARS = PIECES * PIECE + VSTAGES * VT;
  static constexpr int OUT_LD = kXCols + 8;       // a staged O row, in values
  // the tiles, then full and empty mbarriers of each slot and stage, and
  // slack to align the tiles to the 1024-byte period of the swizzle
  static constexpr int SMEM = BARS + 8 * 2 * (PIECES + VSTAGES) + 1024;
  static_assert(kWgRows * OUT_LD * 2 <= BARS, "staged O fits the tiles");
};

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const WgArgs a, const int d) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  using L = WideWg;
  extern __shared__ unsigned char xwg_smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(xwg_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* const vbase = smem + L::PIECES * L::PIECE;
  uint64_t* const pfull = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* const pempty = pfull + L::PIECES;
  uint64_t* const vfull = pempty + L::PIECES;
  uint64_t* const vempty = vfull + L::VSTAGES;

  const int nch = (d + kXCols - 1) / kXCols;
  const int bh = blockIdx.x / nch, chunk = blockIdx.x % nch;
  const int c0 = chunk * kXCols;               // the chunk's first column
  const int nb = d / 64;                       // Q's and K's column boxes
  const int nv = min(kXCols, d - c0) / 64;     // V's boxes in the chunk
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  // heavy first: the last query tile sees the most keys
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kWgRows;
  int n_kv = (kv_lim + kWgKeys - 1) / kWgKeys;
  if (a.causal) {
    const int last_col = min(q0 + kWgRows, lq) - 1 + offset;
    n_kv = min(n_kv, last_col < 0 ? 0 : last_col / kWgKeys + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::PIECES; ++s) {
      mbar_init(&pfull[s], 1);     // the producer's arrive, plus the bytes
      mbar_init(&pempty[s], 1);    // the consumer warpgroup's arrive
    }
    for (int s = 0; s < L::VSTAGES; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4) {
    // the producer: one thread loads, per key tile, the tile's chunk of V,
    // then Q and K a 64-column piece at a time
    if (threadIdx.x % 32 == 0) {
      int ps = 0, pph = 0, vs = 0, vph = 0;
      for (int t = 0; t < n_kv; ++t) {
        mbar_wait(&vempty[vs], vph ^ 1);
        unsigned char* const vt = vbase + vs * L::VT;
        mbar_expect_tx(&vfull[vs], nv * kBox);
        for (int j = 0; j < nv; ++j)
          tma_load_4d(vt + j * kBox, &tv, c0 + 64 * j, t * kWgKeys, h, b,
                      &vfull[vs]);
        if (++vs == L::VSTAGES) {
          vs = 0;
          vph ^= 1;
        }
        for (int j = 0; j < nb; ++j) {
          mbar_wait(&pempty[ps], pph ^ 1);
          unsigned char* const pt = smem + ps * L::PIECE;
          mbar_expect_tx(&pfull[ps], L::PIECE);
          tma_load_4d(pt, &tq, 64 * j, q0, h, b, &pfull[ps]);
          tma_load_4d(pt + kBox, &tk, 64 * j, t * kWgKeys, h, b, &pfull[ps]);
          if (++ps == L::PIECES) {
            ps = 0;
            pph ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers, in flash_fwd_wgmma_kernel's accumulator layout: for each
  // 8-column group j, columns 8j + 2 (lane % 4) + {0, 1} of rows r0 and
  // r0 + 8 (r0 = 16 warp + lane / 4): acc[4j + {0, 1}] and acc[4j + {2, 3}].
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int w0 = q0 + warp * 16;               // the warp's first row
  const float sl2 = a.scale * kLog2e;
  const float ninf = __int_as_float((int)0xff800000u);
  float o[kXCols / 2];
#pragma unroll
  for (int i = 0; i < kXCols / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  int ps = 0, pph = 0, vs = 0, vph = 0;
  for (int t = 0; t < n_kv; ++t) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    // S = Q K^T, a 256-column piece of D (4 boxes) at a time in a fresh
    // accumulator, folded into s in f32
    for (int j0 = 0; j0 < nb; j0 += 4) {
      float sp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sp[i] = 0.f;
      const int j1 = min(j0 + 4, nb);
      int prev = -1;
      fence_acc(sp);
      for (int j = j0; j < j1; ++j) {
        mbar_wait(&pfull[ps], pph);
        __syncwarp();              // wgmma is issued by converged warps
        wgmma_fence();
        const unsigned qs = smem_u32(smem + ps * L::PIECE), ks = qs + kBox;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          // 32 bytes a k16 step along a swizzled 128-byte row; 8-row
          // groups 1024 bytes apart in Q and in K
          wgmma_m64n64<T, 0>(sp, wg_desc(qs + 32 * kk, 16, 1024),
                             wg_desc(ks + 32 * kk, 16, 1024));
        wgmma_commit();
        if (prev >= 0) {
          // the previous piece's products are done: free its slot
          wgmma_wait<1>();
          if (tid == 0) mbar_arrive(&pempty[prev]);
        }
        prev = ps;
        if (++ps == L::PIECES) {
          ps = 0;
          pph ^= 1;
        }
      }
      wgmma_wait_all();
      fence_acc(sp);
      if (tid == 0) mbar_arrive(&pempty[prev]);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += sp[i];
    }

    // the warp's rows [w0, w0 + 16) against keys [k0, k0 + 64): all
    // visible (no mask) or some
    const int k0 = t * kWgKeys;
    const bool all = k0 + kWgKeys <= kv_lim &&
                     (!a.causal || k0 + kWgKeys - 1 <= w0 + offset);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + cq + e;
          float& x = s[4 * j + 2 * hh + e];
          x = all || (key < kv_lim && (!a.causal || key <= row + offset))
                  ? x * sl2 : ninf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hh + e];
          x = exp2f(x - m_new);                  // 0 where masked
          rs += x;
        }
      l[hh] = l[hh] * alpha + rs;                // this thread's keys only
#pragma unroll
      for (int j = 0; j < kXCols / 8; ++j) {
        o[4 * j + 2 * hh] *= alpha;
        o[4 * j + 2 * hh + 1] *= alpha;
      }
    }
    // P in T as A's fragments: k16 step kk is keys 16 kk .. + 15, the
    // accumulator's groups 2 kk and 2 kk + 1
    unsigned pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[kk][i] = pack2<T>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    mbar_wait(&vfull[vs], vph);
    __syncwarp();
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(pf[kk]);
    wgmma_fence();
    const unsigned vsm = smem_u32(vbase + vs * L::VT);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      // 16 keys (2048 bytes) a step; the chunk's 64-wide column boxes 8 KB
      // apart (those past D hold stale values: their columns are dropped)
      wgmma_m64n256_rs<T>(o, pf[kk], wg_desc(vsm + 2048 * kk, kBox, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(pf[kk]);
    if (tid == 0) mbar_arrive(&vempty[vs]);
    if (++vs == L::VSTAGES) {
      vs = 0;
      vph ^= 1;
    }
  }

  // the row sums over the quad
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  // every warp is done with the tiles before they hold O
  named_sync(1, 128);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  T* const os = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
#pragma unroll
    for (int j = 0; j < kXCols / 8; ++j)
      *reinterpret_cast<unsigned*>(
          os + (r0 + 8 * hh) * L::OUT_LD + 8 * j + cq) =
          pack2<T>(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
  }
  named_sync(1, 128);
  // 16-byte stores of the chunk's real columns: consecutive threads on
  // consecutive chunks of a row
  T* const ob = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h + c0;
  const int cpr = nv * 8;                      // 16-byte chunks a row
  for (int i = tid; i < kWgRows * cpr; i += 128) {
    const int r = i / cpr, c = (i % cpr) * 8;
    if (q0 + r < lq)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * a.so.l + c) =
          *reinterpret_cast<const uint4*>(os + r * L::OUT_LD + c);
  }
  if (chunk == 0 && lane % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      if (row < lq)
        a.lse[(size_t)bh * lq + row] =
            l[hh] > 0.f ? (m[hh] + log2f(l[hh])) * 0.69314718055994531f
                        : ninf;
    }
  }
}

// the grid of a wide kernel: (B * H * chunks, query tiles)
inline bool wide_grid(int B, int H, int lq, int d, dim3* grid) {
  const long long x = (long long)B * H * ((d + kXCols - 1) / kXCols);
  if (d <= 256 || d % 64 || x >= (1LL << 31)) return false;
  *grid = dim3((unsigned)x, (lq + kWgRows - 1) / kWgRows);
  return true;
}

template <typename T>
cudaError_t launch_wide_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                              const CUtensorMap& tv, const WgArgs& a, int B,
                              int d, int device, cudaStream_t s) {
  const auto kernel = flash_fwd_wide_wgmma_kernel<T>;
  dim3 grid;
  if (!wide_grid(B, a.H, a.lq, d, &grid)) return cudaErrorInvalidValue;
  static bool opted[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WideWg::SMEM);
    if (e != cudaSuccess) return e;
    opted[device] = true;
  }
  kernel<<<grid, kWgThreads, WideWg::SMEM, s>>>(tq, tk, tv, a, d);
  return cudaGetLastError();
}

// the 16-bit forward for T = __nv_bfloat16 or __half: the wgmma kernel at
// D = 64, 128 and 256, the wide one above 256
template <typename T>
cudaError_t dispatch_wgmma(const FwdArgs& f, int B, int d, int device,
                           cudaStream_t s) {
  if (d != 64 && d != 128 && d != 256 && (d < 256 || d % 64))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_bhld<T>(&tq, f.q, B, f.H, f.lq, d, f.sq))
    return cudaErrorNotSupported;
  if (f.lk > 0) {
    if (!encode_bhld<T>(&tk, f.k, B, f.H, f.lk, d, f.sk) ||
        !encode_bhld<T>(&tv, f.v, B, f.H, f.lk, d, f.sv))
      return cudaErrorNotSupported;
  } else {
    tk = tv = tq;                  // no key: no block loads K or V
  }
  WgArgs a{};
  a.o = f.o; a.lse = f.lse; a.so = f.so;
  a.H = f.H; a.lq = f.lq; a.lk = f.lk;
  a.scale = f.scale; a.causal = f.causal; a.kv_len = f.kv_len;
  if (d == 64) return launch_wgmma<T, 64>(tq, tk, tv, a, B, device, s);
  if (d == 128) return launch_wgmma<T, 128>(tq, tk, tv, a, B, device, s);
  if (d == 256) return launch_wgmma<T, 256>(tq, tk, tv, a, B, device, s);
  return launch_wide_wgmma<T>(tq, tk, tv, a, B, d, device, s);
}

constexpr int kXKeys = 64;          // keys a tile of the f32 wide kernel
constexpr int kXPiece = 64;         // columns of D a streamed piece
constexpr int kXStages = 3;         // piece buffers
constexpr int kXAhead = 2;          // units in flight ahead of the one used
constexpr int kXN = kXKeys / 8;     // S's 8-key tiles, P V's k-steps
static_assert(kXAhead < kXStages && kXAhead <= 256 / kXPiece,
              "a unit's buffer is free when it is loaded");

struct XTile {
  static constexpr int PIECE = kTRows * kXPiece;  // floats of a Q or K piece
  static constexpr int V = kXKeys * kXCols;       // of a tile's chunk of V
  static constexpr int XCH = kXN * 32 * 4;        // a group's exchange
  static constexpr size_t SMEM =
      sizeof(float) * (2 * kXStages * (size_t)PIECE + V +
                       (kTRows / 16) * (size_t)XCH);
  static_assert(kXKeys == kTRows, "a K piece is as large as a Q piece");
};

template <typename T>
__global__ void __launch_bounds__(kTThreads, 1)
flash_fwd_wide_tf32x3_kernel(const FwdArgs a, const int d) {
  static_assert(std::is_same<T, float>::value, "f32");
  extern __shared__ __align__(128) unsigned char xt_smem[];
  // piece buffer s: Q at 2 s PIECE, K right after; then V, the exchanges
  float* const pieces = reinterpret_cast<float*>(xt_smem);
  float* const vt = pieces + 2 * kXStages * XTile::PIECE;
  float* const xch = vt + XTile::V;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, wq = warp & 3;     // 16-row group, quarter
  const int g = lane >> 2, t4 = lane & 3;       // the accumulator's layout
  const int nch = (d + kXCols - 1) / kXCols;
  const int bh = blockIdx.x / nch, chunk = blockIdx.x % nch;
  const int c0 = chunk * kXCols;                // the chunk's first column
  const int vcols = min(kXCols, d - c0);        // its real columns
  const int b = bh / a.H, h = bh % a.H;
  const int lq = a.lq, lk = a.lk, offset = lk - lq;
  const int kv_lim = min(a.kv_len, lk);
  // heavy first: the last query tile sees the most keys
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kTRows;
  const int w0 = q0 + 16 * grp;                 // the group's first row

  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vb =
      static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h + c0;

  int n_kv = (kv_lim + kXKeys - 1) / kXKeys;
  if (a.causal) {
    const int last_col = min(q0 + kTRows, lq) - 1 + offset;
    n_kv = min(n_kv, last_col < 0 ? 0 : last_col / kXKeys + 1);
  }
  // the loads in the order they are used: for each key tile its np pieces
  // of Q and K, then its chunk of V; unit u + kXAhead is loaded while unit
  // u is used, one copy group each (empty past the end), so that waiting
  // for all but kXAhead - 1 groups waits for unit u
  const int np = d / kXPiece;
  const int units = n_kv * (np + 1);
  auto issue = [&](int u) {
    if (u < units) {
      const int t = u / (np + 1), i = u % (np + 1);
      if (i < np) {
        float* const dq = pieces + 2 * ((t * np + i) % kXStages) * XTile::PIECE;
        stage<float, kXPiece, kTRows, kTThreads>(dq, qb + kXPiece * i,
                                                 a.sq.l, q0, lq);
        stage<float, kXPiece, kXKeys, kTThreads>(dq + XTile::PIECE,
                                                 kb + kXPiece * i, a.sk.l,
                                                 t * kXKeys, lk);
      } else {
        // the chunk's columns of V (Swizzled<float, kXCols>), zeros past D
        constexpr int CPR = kXCols / 4;
#pragma unroll
        for (int n = 0; n < kXKeys * CPR / kTThreads; ++n) {
          const int idx = tid + n * kTThreads;
          const int r = idx / CPR, c = (idx % CPR) * 4;
          const int key = t * kXKeys + r;
          const bool in = key < lk && c < vcols;
          cp_async16(vt + Swizzled<float, kXCols>::at(r, c),
                     in ? vb + key * a.sv.l + c : vb, in);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < kXAhead; ++u) issue(u);

  // S by ldmatrix, as in flash_fwd_tf32x3_kernel with rows of one 64-column
  // piece (256 bytes): A (Q) is the group's rows, B (K) the warp's 16 keys
  const int mj = lane >> 3, mi = lane & 7;
  // step s of a 32-column group reads chunk (2 s + x) ^ mi = (2 s ^ (mi &
  // 6)) + (x ^ (mi & 1)): a base and an XOR of 32 s
  const unsigned a_row = (unsigned)((16 * grp + 8 * (mj & 1) + mi) * 256 +
                                    (((mj >> 1) ^ (mi & 1)) << 4));
  const unsigned b_row = (unsigned)((16 * wq + 8 * (mj >> 1) + mi) * 256 +
                                    (((mj & 1) ^ (mi & 1)) << 4));
  const unsigned m6 = (unsigned)(mi & 6) << 4;
  // P V's B: rows 2 t4 (b0) and 2 t4 + 1 (b1) of each 8-key step of V,
  // columns d0 + 8 n + g, under the swizzle as in flash_fwd_tf32x3_kernel
  const int d0 = 64 * wq;
  const bool pv = d0 < vcols;          // the warp's quarter is real columns
  const float* const vl = vt + 2 * t4 * kXCols + d0;   // row 2 t4 of V

  const float sl2 = a.scale * kLog2e;
  const float ninf = __int_as_float((int)0xff800000u);
  // O's quarter: acc[n][e] is row g + 8 (e >> 1), column c0 + d0 + 8 n +
  // 2 t4 + (e & 1); m and l of rows g and g + 8 (l: this lane's keys only)
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float4* const x4 = reinterpret_cast<float4*>(xch + grp * XTile::XCH);

  int u = 0;
  // unit u has landed and every warp is done with unit u - 1's buffers
  auto next = [&]() {
    cp_async_wait<kXAhead - 1>();
    __syncthreads();
    issue(u + kXAhead);
    ++u;
  };
  for (int t = 0; t < n_kv; ++t) {
    // the group's rows [w0, w0 + 16) against keys [k0, k0 + 64): none
    // visible (skipped by its four warps), all visible (no mask), or some
    const int k0 = t * kXKeys;
    const bool skip = w0 >= lq || k0 >= kv_lim ||
                      (a.causal && k0 > w0 + 15 + offset);
    // this warp's 16 x 16 of S: element (n, e) is row g + 8 (e >> 1), key
    // k0 + 16 wq + 8 n + 2 t4 + (e & 1); a piece's sum folded in at a time
    float sa[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[n][e] = 0.f;
    for (int i = 0; i < np; ++i) {
      next();
      if (skip) continue;
      const float* const pq =
          pieces + 2 * ((t * np + i) % kXStages) * XTile::PIECE;
      const unsigned qs = smem_u32(pq), ks = smem_u32(pq + XTile::PIECE);
      // big.big in f[0], the small terms in f[1]
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
          ldsm4(qs + a_row + ((32 * s) ^ m6) + 128 * c, ar);
          ldsm4(ks + b_row + ((32 * s) ^ m6) + 128 * c, br);
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
        for (int e = 0; e < 4; ++e) sa[n][e] += f[0][n][e] + f[1][n][e];
    }
    next();                             // the tile's chunk of V has landed
    if (skip) continue;

    // the group's four warps' keys meet: lane for lane in the accumulator's
    // layout, 8-key tile n of the 64 at x4[n * 32 + lane]
#pragma unroll
    for (int n = 0; n < 2; ++n)
      x4[(2 * wq + n) * 32 + lane] =
          make_float4(sa[n][0], sa[n][1], sa[n][2], sa[n][3]);
    named_sync(1 + grp, 128);
    if (!pv) continue;
    const bool all = k0 + kXKeys <= kv_lim &&
                     (!a.causal || k0 + kXKeys - 1 <= w0 + offset);
    // the scaled score of (n, e) for row hh, -inf where masked
    auto score = [&](const float4& q, int n, int hh, int e) {
      const int key = k0 + 8 * n + 2 * t4 + e;
      const int row = w0 + g + 8 * hh;
      const float x = (hh ? (e ? q.w : q.z) : (e ? q.y : q.x));
      return all || (key < kv_lim && (!a.causal || key <= row + offset))
                 ? x * sl2 : ninf;
    };
    // the online softmax of rows g (hh 0) and g + 8 (hh 1): the row max
    // over the tile's 64 keys and the quad
    float alpha[2];
    {
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < kXN; ++n) {
        const float4 q = x4[n * 32 + lane];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mx[hh] = fmaxf(mx[hh], score(q, n, hh, e));
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh]);
        alpha[hh] = exp2f(m[hh] - m_new);
        m[hh] = m_new;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V, 16 keys at a time: P from a second read of the exchange,
    // as A fragments k-permuted (k = t is key 2t, k = t + 4 key 2t + 1)
    // and split; each 16 keys' sum of a pair of 8-column tiles formed in a
    // partial of its own and folded into acc with f32 rounding
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int k2 = 0; k2 < kXN; k2 += 2) {
      uint32_t pb[2][4], ps[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float4 q = x4[(k2 + kk) * 32 + lane];
        float p[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[hh][e] = exp2f(score(q, k2 + kk, hh, e) - m[hh]);  // 0 masked
            rs[hh] += p[hh][e];
          }
        const float ax[4] = {p[0][0], p[1][0], p[0][1], p[1][1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(ax[e], pb[kk][e], ps[kk][e]);
      }
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int u0 = 0; u0 < 4; u0 += 2) {
          float q[2][4];
#pragma unroll
          for (int uu = 0; uu < 2; ++uu)
#pragma unroll
            for (int e = 0; e < 4; ++e) q[uu][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const float* const bt = vl + (k2 + kk) * 8 * kXCols + 32 * mm;
            uint32_t bb[2][2], bs[2][2];
#pragma unroll
            for (int uu = 0; uu < 2; ++uu) {
              const int x = 8 * ((u0 + uu) ^ t4);
              split_tf32(bt[x + g], bb[uu][0], bs[uu][0]);
              split_tf32(bt[kXCols + x + (g ^ 4)], bb[uu][1], bs[uu][1]);
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
            for (int e = 0; e < 4; ++e) acc[4 * mm + u0 + uu][e] += q[uu][e];
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
  }

  // O = acc / l (0 for a row that saw no key) in the warp's quarter of the
  // chunk, rows g and g + 8, two columns a store; lse from one warp of the
  // group in the first chunk. A block that saw no tile writes its zeros and
  // -inf.
  if (!pv) return;
  float* const ob = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h + c0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = w0 + g + 8 * hh;
    if (row >= lq) continue;
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(ob + row * a.so.l + d0 + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
    // lse = m ln 2 + ln l, one rounding for the product and the sum (the
    // base-2 sum then a product rounds twice: up to 1.7x the f32 plain
    // version's error against float64 where the bar is WIDE_F64_FACTOR)
    if (chunk == 0 && wq == 0 && t4 == 0)
      a.lse[(size_t)bh * lq + row] =
          l[hh] > 0.f ? fmaf(m[hh], 0.69314718055994531f, logf(l[hh]))
                      : ninf;
  }
}

cudaError_t launch_wide_tf32x3(const FwdArgs& a, int B, int d,
                               cudaStream_t s) {
  const auto kernel = flash_fwd_wide_tf32x3_kernel<float>;
  dim3 grid;
  if (!wide_grid(B, a.H, a.lq, d, &grid)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)XTile::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kTThreads, XTile::SMEM, s>>>(a, d);
  return cudaGetLastError();
}

// f32: the FMA kernel at D = 64 and 128, the split-TF32 ones at 256 and,
// for a multiple of 64, above
cudaError_t dispatch_f32(const FwdArgs& a, int B, int d, cudaStream_t s) {
  if (d == 64) return launch<float, 64>(a, B, s);
  if (d == 128) return launch<float, 128>(a, B, s);
  if (d == kTD) return launch_tf32x3(a, B, s);
  return launch_wide_tf32x3(a, B, d, s);
}

}  // namespace
}  // namespace mxt

// q: (B, H, lq, d), k and v: (B, H, lk, d), o: (B, H, lq, d), each given by
// its (batch, head, row) strides in elements with a unit stride on d and
// 16-byte aligned rows (and, in bf16 and f16, no zero stride: TMA reads
// through them); lse: (B, H, lq) contiguous f32. d is 64, 128 or 256, or
// above 256 a multiple of 64. f32 runs flash_fwd_kernel at d = 64 and 128,
// flash_fwd_tf32x3_kernel at 256 and flash_fwd_wide_tf32x3_kernel above;
// bf16 and f16 run flash_fwd_wgmma_kernel up to 256 and
// flash_fwd_wide_wgmma_kernel above. Returns the CUDA error of the launch;
// cudaErrorNotSupported where the tensor maps cannot be encoded.
extern "C" int mxt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int lq, int lk, int d, int dtype, long long sqb, long long sqh,
    long long sql, long long skb, long long skh, long long skl, long long svb,
    long long svh, long long svl, long long sob, long long soh, long long sol,
    float scale, int causal, int kv_len, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || H <= 0 || lq <= 0) return 0;
  mxt::FwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.lse = static_cast<float*>(lse);
  a.H = H; a.lq = lq; a.lk = lk;
  a.sq = {sqb, sqh, sql}; a.sk = {skb, skh, skl}; a.sv = {svb, svh, svl};
  a.so = {sob, soh, sol};
  a.scale = scale; a.causal = causal; a.kv_len = kv_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mxt::kFloat32) return (int)mxt::dispatch_f32(a, B, d, s);
  if (dtype == mxt::kBFloat16)
    return (int)mxt::dispatch_wgmma<__nv_bfloat16>(a, B, d, device, s);
  if (dtype == mxt::kFloat16)
    return (int)mxt::dispatch_wgmma<__half>(a, B, d, device, s);
  return (int)cudaErrorInvalidValue;
}
