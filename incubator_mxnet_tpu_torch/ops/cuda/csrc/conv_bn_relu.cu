// The kernels of the fused conv + BatchNorm + activation path, written for
// Hopper (sm_90a).
//
// Replaces: incubator_mxnet_tpu/ops/pallas/conv_bn_relu.py.
//
// 1. `ssa_kernel` replaces `_ssa_kernel` (called from `_ssa_fwd_impl`):
//    y = act(x * scale + shift) per channel on the last axis of a (rows, C)
//    row-major x, act in {none, relu, relu6}, f32 arithmetic, y in x's dtype.
//    scale and shift arrive as f32, as the TPU kernel casts them.
//
//    What bounds it on the card: bytes. Per element it reads x once and
//    writes y once and does three flops, far below the ~20 flop/byte (f32)
//    at which the H100's 67 TFLOP/s would take over from its 3.35 TB/s.
//
//    What the design does about it: x is read once and y written once, with
//    16-byte loads and stores where C and the pointers allow (4 f32 or 8
//    bf16 a vector), one element at a time otherwise (any C, such as 3, and
//    any alignment). A thread owns one vector of channels for the whole
//    launch: it loads its scale and shift into registers once and then
//    strides down the rows, four rows in flight at a time. Threads next to
//    each other own neighbouring vectors of one row, and a block's rows are
//    neighbours too, so a warp reads one contiguous run of memory. The TPU
//    kernel's padding of rows to a multiple of 8 is gone: the row loop stops
//    at the last row. The product and the sum round separately (__fmul_rn,
//    __fadd_rn), as the plain PyTorch version's two operations do, so the
//    kernel agrees with it exactly in f32.
//
// 2. `mm_epilogue_kernel` replaces `_mm_kernel` (called from `_mm_epilogue`):
//    out = act((x @ w) * scale[n] + shift[n]) for x (M, K), w (K, N), both
//    row-major, the product accumulated in f32 (bf16 inputs widen to f32, as
//    `_mm_kernel` casts them), the epilogue applied once to the finished sum
//    and the result written once in x's dtype. This is a 1x1, stride-1,
//    unpadded NHWC convolution over flattened pixels followed by BatchNorm
//    with moving statistics folded into scale and shift.
//
//    What bounds it on the card: operations in f32, 2MNK flops on the FMA
//    units at 67 TFLOP/s (ResNet-50's 1x1 convolutions do 64-1024 flops per
//    byte moved, far above the ~20 at which bytes would take over). In bf16
//    it is held against the tensor cores' 989 TFLOP/s, where bytes bound
//    it; this kernel does not use them (see the last point).
//
//    The design, against the four faults of the first version:
//    - Nothing was pipelined. K is walked in k-tiles of 64 bytes a row (BK =
//      16 f32 or 32 bf16) through a ring of three stages in shared memory:
//      `cp.async` fills tile i + 2 while tile i is consumed, and one
//      __syncthreads a tile orders the ring (`cp.async.wait_group 1` leaves
//      the newest copy in flight).
//    - The global loads were scalar. Each thread now copies 16-byte chunks
//      with `cp.async.cg` (to shared memory through L2, no registers),
//      zero-filling past M, N and the end of its K range through the
//      src-size operand, wherever the row lengths in bytes and the pointers
//      are 16-byte aligned. Any other shape (K or N not a multiple of 4 f32
//      or 8 bf16, a pointer off 16 bytes) takes a guarded path that loads
//      one element at a time through registers into the same layout.
//      x's k-tile lands row-major, as it arrives: cp.async cannot transpose,
//      a transposed slot would take one 4-byte copy per f32 value, and bf16
//      has no copy that small. A thread reads four k at once of each of its
//      8 rows (one 16-byte load, 8 bytes in bf16) and then four rows of w's
//      tile, so it makes as many shared loads per FMA as with a transposed
//      x. The threads of a quarter-warp share their rows, so reads of x are
//      broadcasts.
//    - One tile shape for every problem. The tile is now 128 x 64 (128
//      threads, each 8 x 8 outputs in registers), half as wide, so N = 64
//      fills it and mid-sized grids have twice the blocks; where the grid
//      is still short of the card, K is split (below). The Python
//      wrapper's `mm_plan` picks the split from the shapes alone. Tiles
//      of 128 x 128 and 64 x 64 from the same template were timed against
//      it on an H100: 128 x 128 was at most 6% faster at three of
//      ResNet-50's shapes (under 2% of a forward's GEMM time), 64 x 64
//      slower at every shape, m = 49 included, so only this tile is
//      built. Row and column tiles share gridDim.x, columns fastest so
//      that the blocks reading one slice of x run together, and the split
//      is gridDim.y: M is no longer capped at 65,535 row tiles.
//      Registers are not capped: a thread holds 64 sums, 32 values of x, 8
//      of w and its copy addresses, and a cap of 128 made ptxas spill.
//    - Shared-memory reads conflicted. A thread's 8 columns are two runs of
//      4, half a tile apart (and its 8 rows likewise), so a quarter-warp's
//      16-byte reads of w cover 128 contiguous bytes: no bank conflict.
//
//    Split-K, for grids too small to fill the 132 SMs: a block sums only its
//    K range (a multiple of BK long) and writes its f32 partial tile to a
//    (split, M, N) workspace that the wrapper allocates;
//    `mm_splitk_reduce_kernel` then sums each output's partials in range
//    order, applies the epilogue and writes out. No atomics: two identical
//    calls give identical bits.
//
//    Why no tensor cores: the main paths run f32 with TF32 off, and the
//    tensor cores cannot form an f32 product without rounding its inputs to
//    TF32's 10-bit mantissa. A bf16 kernel on wgmma and TMA is a design of
//    its own.
#include "common.cuh"

namespace mxt {
namespace {

// Activation codes passed from the Python wrappers.
enum Act : int { kNone = 0, kRelu = 1, kRelu6 = 2 };

template <int ACT>
__device__ __forceinline__ float apply_act(float y) {
  if (ACT == kRelu) return fmaxf(y, 0.f);
  if (ACT == kRelu6) return fminf(fmaxf(y, 0.f), 6.f);
  return y;
}

// ---------------------------------------------------------------------------
// scale, shift, activation
// ---------------------------------------------------------------------------

constexpr int kSsaThreads = 256;
constexpr int kSsaUnroll = 4;      // rows a thread has in flight at once
constexpr int kSsaMaxRowBlocks = 4096;

template <typename T, int VN> struct Vec;
template <typename T> struct Vec<T, 1> { using type = T; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<__nv_bfloat16, 8> { using type = uint4; };

// x, y: (rows, C) row-major; the thread layout is (ty, tx) with tx over the
// C / VN vectors of a row and ty over rows.
template <typename T, int VN, int ACT>
__global__ void __launch_bounds__(kSsaThreads)
ssa_kernel(const T* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ shift, T* __restrict__ y, long long rows,
           int c, int tx_n) {
  using V = typename Vec<T, VN>::type;
  const int nvec = c / VN;
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int ty_n = blockDim.x / tx_n;
  const int cv = blockIdx.x * tx_n + tx;
  if (ty >= ty_n || cv >= nvec) return;
  float s[VN], b[VN];
#pragma unroll
  for (int j = 0; j < VN; ++j) {
    s[j] = scale[cv * VN + j];
    b[j] = shift[cv * VN + j];
  }
  const V* xv = reinterpret_cast<const V*>(x);
  V* yv = reinterpret_cast<V*>(y);
  const long long step = (long long)gridDim.y * ty_n;
  for (long long r0 = (long long)blockIdx.y * ty_n + ty; r0 < rows;
       r0 += step * kSsaUnroll) {
    V in[kSsaUnroll];
#pragma unroll
    for (int u = 0; u < kSsaUnroll; ++u) {
      const long long r = r0 + u * step;
      if (r < rows) in[u] = xv[r * nvec + cv];
    }
#pragma unroll
    for (int u = 0; u < kSsaUnroll; ++u) {
      const long long r = r0 + u * step;
      if (r < rows) {
        const T* e = reinterpret_cast<const T*>(&in[u]);
        V out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < VN; ++j)
          o[j] = from_f32<T>(apply_act<ACT>(
              __fadd_rn(__fmul_rn(to_f32(e[j]), s[j]), b[j])));
        yv[r * nvec + cv] = out;
      }
    }
  }
}

template <typename T, int VN>
cudaError_t launch_ssa_vn(const T* x, const float* s, const float* b, T* y,
                          long long rows, int c, int act, cudaStream_t st) {
  const int nvec = c / VN;
  const int tx_n = nvec < kSsaThreads ? nvec : kSsaThreads;
  const int ty_n = kSsaThreads / tx_n;
  const int col_blocks = (nvec + tx_n - 1) / tx_n;
  long long row_blocks = (rows + ty_n - 1) / ty_n;
  const long long cap = kSsaMaxRowBlocks / col_blocks > 0
                            ? kSsaMaxRowBlocks / col_blocks : 1;
  if (row_blocks > cap) row_blocks = cap;
  const dim3 grid(col_blocks, (unsigned)row_blocks);
  const int threads = tx_n * ty_n;
  switch (act) {
    case kNone:
      ssa_kernel<T, VN, kNone><<<grid, threads, 0, st>>>(x, s, b, y, rows, c, tx_n);
      break;
    case kRelu:
      ssa_kernel<T, VN, kRelu><<<grid, threads, 0, st>>>(x, s, b, y, rows, c, tx_n);
      break;
    case kRelu6:
      ssa_kernel<T, VN, kRelu6><<<grid, threads, 0, st>>>(x, s, b, y, rows, c, tx_n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ssa(const void* xv, const float* s, const float* b,
                       void* yv, long long rows, int c, int act,
                       cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  constexpr int VN = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                       (c % VN == 0);
  if (aligned) return launch_ssa_vn<T, VN>(x, s, b, y, rows, c, act, st);
  return launch_ssa_vn<T, 1>(x, s, b, y, rows, c, act, st);
}

// ---------------------------------------------------------------------------
// (M, K) @ (K, N) with the scale, shift and activation epilogue
// ---------------------------------------------------------------------------

constexpr int kStages = 3;        // k-tiles in shared memory at once
constexpr int kMaxSplit = 65535;  // K ranges, on gridDim.y

// k-tile depth: 64 bytes of a row of x, four 16-byte chunks
template <typename T> struct MmBK;
template <> struct MmBK<float> { static constexpr int value = 16; };
template <> struct MmBK<__nv_bfloat16> { static constexpr int value = 32; };

__device__ __forceinline__ float act_of(float y, int act) {
  if (act == kRelu) return fmaxf(y, 0.f);
  if (act == kRelu6) return fminf(fmaxf(y, 0.f), 6.f);
  return y;
}

template <typename T, int BM, int BN>
struct MmTile {
  static constexpr int BK = MmBK<T>::value;
  static constexpr int CE = 16 / sizeof(T);        // values in 16 bytes
  static constexpr int TX = BN / 8;                // threads along N
  static constexpr int THREADS = (BM / 8) * (BN / 8);
  static constexpr int A = BM * BK;                // x's k-tile, (BM, BK)
  static constexpr int B = BK * BN;                // w's k-tile, (BK, BN)
  static constexpr int SMEM = kStages * (A + B) * (int)sizeof(T);
  static_assert((A / CE) % THREADS == 0 && (B / CE) % THREADS == 0 &&
                A % THREADS == 0 && B % THREADS == 0,
                "every thread copies the same number of chunks");
};

// Block (blockIdx.x, blockIdx.y) computes row tile blockIdx.x / col_tiles,
// column tile blockIdx.x % col_tiles, over K range blockIdx.y: [y * kchunk,
// min(k, (y + 1) * kchunk)). Thread (ty, tx) owns rows ty*4 + {0..3} and
// BM/2 + ty*4 + {0..3}, columns tx*4 + {0..3} and BN/2 + tx*4 + {0..3}.
// With `partial` null the block applies the epilogue and writes `out`;
// otherwise it writes its f32 sums to partial[blockIdx.y] (M, N).
// VEC: 16-byte cp.async copies and 4-wide stores (k and n multiples of 16
// bytes of values, pointers 16-byte aligned); otherwise one element at a
// time.
template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__((BM / 8) * (BN / 8))
mm_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, T* __restrict__ out,
                   float* __restrict__ partial, int m, int n, int k,
                   int kchunk, int col_tiles, int act) {
  using Tile = MmTile<T, BM, BN>;
  constexpr int BK = Tile::BK, CE = Tile::CE, THREADS = Tile::THREADS;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  T* const ring = reinterpret_cast<T*>(mm_smem);   // stage s: A then B

  const int t = threadIdx.x;
  const int tx = t % Tile::TX, ty = t / Tile::TX;
  const int m0 = (int)(blockIdx.x / col_tiles) * BM;
  const int n0 = (int)(blockIdx.x % col_tiles) * BN;
  const int kbeg = (int)blockIdx.y * kchunk;
  const int kend = (int)min((long long)k, (long long)kbeg + kchunk);
  const int ntiles = (kend - kbeg + BK - 1) / BK;

  auto load = [&](int slot, int k0) {
    T* as = ring + slot * (Tile::A + Tile::B);
    T* bs = as + Tile::A;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < Tile::A / CE / THREADS; ++i) {
        const int c = t + i * THREADS;
        const int r = c / (BK / CE), kc = (c % (BK / CE)) * CE;
        const bool in = m0 + r < m && k0 + kc < kend;
        cp_async16(as + r * BK + kc,
                   in ? x + (size_t)(m0 + r) * k + k0 + kc : x, in);
      }
#pragma unroll
      for (int i = 0; i < Tile::B / CE / THREADS; ++i) {
        const int c = t + i * THREADS;
        const int r = c / (BN / CE), nc = (c % (BN / CE)) * CE;
        const bool in = k0 + r < kend && n0 + nc < n;
        cp_async16(bs + r * BN + nc,
                   in ? w + (size_t)(k0 + r) * n + n0 + nc : w, in);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < Tile::A / THREADS; ++i) {
        const int e = t + i * THREADS;
        const int r = e / BK, kk = e % BK;
        as[e] = (m0 + r < m && k0 + kk < kend)
                    ? x[(size_t)(m0 + r) * k + k0 + kk] : from_f32<T>(0.f);
      }
#pragma unroll 4
      for (int i = 0; i < Tile::B / THREADS; ++i) {
        const int e = t + i * THREADS;
        const int r = e / BN, nn = e % BN;
        bs[e] = (k0 + r < kend && n0 + nn < n)
                    ? w[(size_t)(k0 + r) * n + n0 + nn] : from_f32<T>(0.f);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load(s, kbeg + s * BK);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    // tile `it` has landed (only the newest group may still be in flight);
    // the barrier also frees the slot consumed last iteration for refill
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = it + kStages - 1;
    if (next < ntiles) load(next % kStages, kbeg + next * BK);
    cp_async_commit();

    const T* as = ring + (it % kStages) * (Tile::A + Tile::B);
    const T* bs = as + Tile::A;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        lds4(as + (ty * 4 + (i & 3) + (i >> 2) * (BM / 2)) * BK + kq, a[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b0[4], b1[4];
        lds4(bs + (kq + kk) * BN + tx * 4, b0);
        lds4(bs + (kq + kk) * BN + BN / 2 + tx * 4, b1);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(a[i][kk], b0[j], acc[i][j]);
            acc[i][j + 4] = fmaf(a[i][kk], b1[j], acc[i][j + 4]);
          }
      }
    }
  }

  float* const part =
      partial ? partial + (size_t)blockIdx.y * m * n : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {                   // the two column runs
    const int c0 = n0 + h * (BN / 2) + tx * 4;
    float s[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = !part && c0 + j < n;
      s[j] = in ? scale[c0 + j] : 0.f;
      b[j] = in ? shift[c0 + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + ty * 4 + (i & 3) + (i >> 2) * (BM / 2);
      if (r >= m || c0 >= n) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = part ? acc[i][h * 4 + j]
                    : act_of(__fadd_rn(__fmul_rn(acc[i][h * 4 + j], s[j]),
                                       b[j]), act);
      const size_t o = (size_t)r * n + c0;
      if constexpr (VEC) {        // n % 4 == 0: the run is whole
        if (part) stg4(part + o, v);
        else stg4(out + o, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c0 + j >= n) break;
          if (part) part[o + j] = v[j];
          else out[o + j] = from_f32<T>(v[j]);
        }
      }
    }
  }
}

// out = act(sum_s partial[s] * scale + shift), the partials summed in
// order s = 0, 1, ...; VN values a thread at a time (VN = 4 when n % 4 ==
// 0 and out is 16-byte aligned, so a vector never crosses a row)
template <typename T, int VN>
__global__ void __launch_bounds__(256)
mm_splitk_reduce_kernel(const float* __restrict__ partial,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift, T* __restrict__ out,
                        long long mn, int n, int split, int act) {
  const long long nv = mn / VN;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < nv; v += step) {
    const long long e = v * VN;
    float acc[VN];
#pragma unroll
    for (int j = 0; j < VN; ++j) acc[j] = partial[e + j];
    for (int s = 1; s < split; ++s) {
      const float* p = partial + (size_t)s * mn + e;
#pragma unroll
      for (int j = 0; j < VN; ++j) acc[j] = __fadd_rn(acc[j], p[j]);
    }
    const int c = (int)(e % n);
#pragma unroll
    for (int j = 0; j < VN; ++j)
      acc[j] = act_of(__fadd_rn(__fmul_rn(acc[j], scale[c + j]),
                                shift[c + j]), act);
    if constexpr (VN == 4) {
      stg4(out + e, acc);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) out[e + j] = from_f32<T>(acc[j]);
    }
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the one block tile (`MM_TILE` in the Python wrapper): 36 KB of shared
// memory in f32 and bf16, under the 48 KB a launch gets without opting in
constexpr int kBM = 128, kBN = 64;

template <typename T, bool VEC>
cudaError_t launch_mm_tile(const T* x, const T* w, const float* s,
                           const float* b, T* o, float* part, int m, int n,
                           int k, int kchunk, int split, int act,
                           cudaStream_t st) {
  using Tile = MmTile<T, kBM, kBN>;
  static_assert(Tile::SMEM <= 48 * 1024, "no opt-in to more shared memory");
  const long long col_tiles = (n + kBN - 1) / kBN;
  const long long blocks = ((long long)m + kBM - 1) / kBM * col_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  mm_epilogue_kernel<T, kBM, kBN, VEC>
      <<<dim3((unsigned)blocks, (unsigned)split), Tile::THREADS, Tile::SMEM,
         st>>>(x, w, s, b, o, part, m, n, k, kchunk, (int)col_tiles, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mm(const void* xv, const void* wv, const float* s,
                      const float* b, void* ov, float* part, int m, int n,
                      int k, int kchunk, int split, int act,
                      cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* o = static_cast<T*>(ov);
  constexpr int CE = 16 / sizeof(T);
  const bool vec = aligned16(x) && aligned16(w) && aligned16(o) &&
                   (!part || aligned16(part)) && k % CE == 0 && n % CE == 0;
  if (vec)
    return launch_mm_tile<T, true>(x, w, s, b, o, part, m, n, k, kchunk,
                                   split, act, st);
  return launch_mm_tile<T, false>(x, w, s, b, o, part, m, n, k, kchunk,
                                  split, act, st);
}

template <typename T>
cudaError_t launch_reduce(const float* part, const float* s, const float* b,
                          void* ov, int m, int n, int split, int act,
                          cudaStream_t st) {
  T* o = static_cast<T*>(ov);
  const long long mn = (long long)m * n;
  const bool vec = n % 4 == 0 && aligned16(o) && aligned16(part);
  const long long nv = vec ? mn / 4 : mn;
  long long blocks = (nv + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (vec)
    mm_splitk_reduce_kernel<T, 4><<<(unsigned)blocks, 256, 0, st>>>(
        part, s, b, o, mn, n, split, act);
  else
    mm_splitk_reduce_kernel<T, 1><<<(unsigned)blocks, 256, 0, st>>>(
        part, s, b, o, mn, n, split, act);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mxt

// x, y: (rows, c) row-major contiguous; scale, shift: (c,) f32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int mxt_scale_shift_act(const void* x, const void* scale,
                                   const void* shift, void* y, long long rows,
                                   int c, int act, int dtype, int device,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows <= 0 || c <= 0) return 0;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mxt::kFloat32:
      return (int)mxt::launch_ssa<float>(x, s, b, y, rows, c, act, st);
    case mxt::kBFloat16:
      return (int)mxt::launch_ssa<__nv_bfloat16>(x, s, b, y, rows, c, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// x: (m, k), w: (k, n), out: (m, n), all row-major contiguous and of one
// dtype; scale, shift: (n,) f32. The plan: `split` K ranges of `kchunk` (a
// multiple of the k-tile depth, 16 f32 or 32 bf16; the last range ends at
// k), each computed in 128 x 64 block tiles. With split 1
// the kernel writes act(x @ w * scale + shift) to out and `partial` is
// unused; with split > 1 it writes range s's f32 sums to partial (split, m,
// n) and mxt_mm_splitk_reduce finishes. Returns the CUDA error of the
// launch (0 on success).
extern "C" int mxt_mm_epilogue(const void* x, const void* w, const void* scale,
                               const void* shift, void* out, void* partial,
                               int m, int n, int k, int act, int dtype,
                               int split, int kchunk, int device,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (m <= 0 || n <= 0) return 0;
  if (act < mxt::kNone || act > mxt::kRelu6 || k < 0 || split < 1 ||
      split > mxt::kMaxSplit)
    return (int)cudaErrorInvalidValue;
  const int bk = dtype == mxt::kBFloat16 ? 32 : 16;
  if (split == 1) {
    kchunk = k;
    partial = nullptr;
  } else if (!partial || kchunk <= 0 || kchunk % bk != 0 ||
             (long long)(split - 1) * kchunk >= k) {
    return (int)cudaErrorInvalidValue;       // an empty or unaligned range
  }
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  float* p = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mxt::kFloat32:
      return (int)mxt::launch_mm<float>(x, w, s, b, out, p, m, n, k, kchunk,
                                        split, act, st);
    case mxt::kBFloat16:
      return (int)mxt::launch_mm<__nv_bfloat16>(x, w, s, b, out, p, m, n, k,
                                                kchunk, split, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// partial: (split, m, n) f32; out: (m, n) of `dtype`; scale, shift: (n,)
// f32. out = act(sum over s in order of partial[s] * scale + shift).
// Returns the CUDA error of the launch.
extern "C" int mxt_mm_splitk_reduce(const void* partial, const void* scale,
                                    const void* shift, void* out, int m,
                                    int n, int split, int act, int dtype,
                                    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (m <= 0 || n <= 0) return 0;
  if (act < mxt::kNone || act > mxt::kRelu6 || split < 1)
    return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(partial);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mxt::kFloat32:
      return (int)mxt::launch_reduce<float>(p, s, b, out, m, n, split, act,
                                            st);
    case mxt::kBFloat16:
      return (int)mxt::launch_reduce<__nv_bfloat16>(p, s, b, out, m, n,
                                                    split, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
