// The bf16 and f16 fused 1x1-conv GEMM on Hopper's tensor cores (sm_90a):
// wgmma fed by TMA.
//
// Replaces: `_mm_kernel` of incubator_mxnet_tpu/ops/pallas/conv_bn_relu.py
// (called from `_mm_epilogue`) for bf16 and f16 inputs:
//   out = act((x @ w) * scale[n] + shift[n])
// for x (M, K) and w (K, N), both row-major of one 16-bit type T, act in
// {none, relu, relu6}. `_mm_kernel` widens them to f32 before `jnp.dot`; a
// product of two bf16 (or two f16) values is exact in f32, so a
// tensor-core product with f32 accumulation computes the same function up
// to the order of the sums. The epilogue runs on the f32 sums, the product
// and the sum rounded separately (__fmul_rn, __fadd_rn) as in the f32
// kernel of conv_bn_relu.cu, and the result is rounded once to T (in f16,
// past 65504 to inf). One template serves both types: the tiles move the
// same bytes, and only the wgmma's operand type, the tensor maps' element
// type and the final rounding differ.
//
// What bounds it on the card: bytes. In bf16, ResNet-50's 1x1 convolutions
// at bucket 32 do 32 to 330 flops per byte moved (each input read once,
// the output written once), below the ~295 at which the H100's 989 TFLOP/s
// would take over from its 3.35 TB/s at every shape but stage 4's two; a
// forward's 30 are bound by bytes as a whole (s1_conv3_ds, M = 100,352, K
// = 64, N = 256, moves 64 MB for 3.3 GFLOP). So the kernel has to move
// each byte once, at full bandwidth, and keep the tensor cores out of the
// way.
//
// What the design does about it:
// - A block computes a 128 x BN tile of out (BN = 64 or 128, chosen by the
//   Python wrapper's plan from the shape: 128 only where N > 64 and the
//   grid still has a block for each SM, so that N = 64 does not pay for a
//   128-wide tile). Two consumer warpgroups own 64 rows each and issue
//   `wgmma.mma_async.m64nBNk16` with f32 accumulators in registers; a
//   ninth warp is the producer.
// - The producer's one thread keeps a ring of k-tiles (64 values deep, one
//   128-byte row of x, 4 stages for BN = 64 and 3 for BN = 128: 96 KB of
//   dynamic shared memory, two blocks an SM) filled with
//   `cp.async.bulk.tensor` (TMA) loads, each completing on the stage's
//   full mbarrier; a consumer warpgroup releases a stage through its
//   empty mbarrier once its wgmma has read it. No thread computes an
//   address or spends a register on a copy.
// - Layouts: TMA writes both tiles with the 128-byte swizzle. x's tile is
//   K-major A (a 64-deep row is one 128-byte swizzle row; a k16 step
//   advances the descriptor by 32 bytes). w (K, N) row-major is an
//   MN-major B: it is loaded as 64-wide column boxes of 64 k-rows, and
//   wgmma reads it through its transpose bit (imm-trans-b = 1; the
//   descriptor's leading offset is the distance between the column boxes,
//   its stride offset the 1024 bytes between groups of 8 k-rows), so w is
//   never copied or transposed per call.
// - Order of blocks: the column tiles of one row tile are neighbours in
//   blockIdx.x, so the blocks that read one slab of x run together and x
//   comes from DRAM once; w (at most 2 MB in ResNet-50) stays in L2.
// - Edges: TMA zero-fills rows past M and k past K (and columns past N),
//   so a tail adds zeros to the sums; the stores are masked.
// - Epilogue: the f32 sums get scale, shift and the activation, round to
//   T into shared memory (the ring is free by then) and leave in
//   16-byte stores, consecutive threads on consecutive 16 bytes of a row.
// - Split-K, for grids under half the SMs whose blocks would walk 16
//   k-tiles or more (stages 3 and 4 at buckets 1-16; measured against
//   every other plan by tools/sweep_mm_plans.py, a split costs more in f32
//   partials than it gains anywhere else): a block sums only its K range
//   (a multiple of 64 long) and writes its f32 partial tile to a (split,
//   M, N) workspace; `mm_splitk_reduce_kernel` of conv_bn_relu.cu sums the
//   ranges in order, with no atomics, so two calls give the same bits.
// - Tensor maps are encoded on the host per call with
//   cuTensorMapEncodeTiled, looked up through the CUDA runtime (nothing
//   links libcuda), and passed by value as
//   __grid_constant__ parameters: a CUDA graph captures them with the
//   launch, which is right as long as the graph's buffers stay put.
//
// The wrapper sends a bf16 or f16 call here when K and N are multiples of 8
// (row strides of 16 bytes, as TMA needs) and x, w and out are 16-byte
// aligned; any other such call runs the SIMT kernel of conv_bn_relu.cu.
#include "common.cuh"
#include "hopper.cuh"

namespace mxt {
namespace {

enum Act : int { kNone = 0, kRelu = 1, kRelu6 = 2 };

constexpr int kBM = 128;               // rows a block: two warpgroups of 64
constexpr int kBK = 64;                // k-tile depth: 128 bytes of T
constexpr int kRowBytes = kBK * 2;     // one swizzled row of a tile
constexpr int kConsumers = 256;        // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kMaxSplit = 65535;       // K ranges, on gridDim.y

template <int BN>
struct WgTile {
  static constexpr int STAGES = BN == 64 ? 4 : 3;
  static constexpr int A_BYTES = kBM * kRowBytes;        // 16 KB
  static constexpr int B_BYTES = kBK * BN * 2;           // 8 or 16 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int OUT_LD = BN + 8;    // a staged output row, in values
  // the ring, its 2 x STAGES mbarriers, and slack to align the ring to the
  // 1024-byte period of the 128-byte swizzle
  static constexpr int SMEM = RING + 2 * STAGES * 8 + 1024;
  static_assert(kBM * OUT_LD * 2 <= RING, "the output tile fits the ring");
};

template <typename T, int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a,
                                           uint64_t b) {
  if constexpr (BN == 64) wgmma_m64n64<T, 1>(d, a, b);
  else wgmma_m64n128<T, 1>(d, a, b);
}

__device__ __forceinline__ float act_of(float y, int act) {
  if (act == kRelu) return fmaxf(y, 0.f);
  if (act == kRelu6) return fminf(fmaxf(y, 0.f), 6.f);
  return y;
}

// Block (blockIdx.x, blockIdx.y) computes row tile blockIdx.x / col_tiles
// and column tile blockIdx.x % col_tiles over K range blockIdx.y: [y *
// kchunk, min(k, (y + 1) * kchunk)). With `partial` null it applies the
// epilogue and writes `out`; otherwise it writes its f32 sums to
// partial[blockIdx.y] (M, N). T is __nv_bfloat16 or __half: the kernel's
// name carries its type, as every kernel of this directory's does.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 2)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw,
                const float* __restrict__ scale,
                const float* __restrict__ shift, T* __restrict__ out,
                float* __restrict__ partial, int m, int n, int k, int kchunk,
                int col_tiles, int act) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  using Tile = WgTile<BN>;
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + Tile::RING);
  uint64_t* const empty = full + STAGES;

  const int m0 = (int)(blockIdx.x / col_tiles) * kBM;
  const int n0 = (int)(blockIdx.x % col_tiles) * BN;
  const int kbeg = (int)blockIdx.y * kchunk;
  const int kend = (int)min((long long)k, (long long)kbeg + kchunk);
  const int ntiles = (kend - kbeg + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrive, plus the bytes
      mbar_init(&empty[s], 2);     // one arrive a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == kConsumers / 32) {
    // the producer: one thread keeps the ring full
    if (threadIdx.x % 32 == 0) {
      int stage = 0, phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* const a = smem + stage * Tile::STAGE_BYTES;
        unsigned char* const b = a + Tile::A_BYTES;
        const int k0 = kbeg + t * kBK;
        mbar_expect_tx(&full[stage], Tile::STAGE_BYTES);
        tma_load(a, &tx, k0, m0, &full[stage]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(b + j * kBK * kRowBytes, &tw, n0 + 64 * j, k0,
                   &full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int stage = 0, phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    mbar_wait(&full[stage], phase);
    __syncwarp();                  // wgmma is issued by converged warps
    const unsigned a = smem_u32(smem + stage * Tile::STAGE_BYTES) +
                       wg * 64 * kRowBytes;
    const unsigned b = smem_u32(smem + stage * Tile::STAGE_BYTES +
                                Tile::A_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s)
      // A: 32 bytes a k16 step along its swizzled rows, 8-row groups 1024
      // bytes apart. B: 16 k-rows (2048 bytes) a step; its 64-wide column
      // boxes kBK rows apart
      wgmma_tile<T, BN>(acc, wg_desc(a + 32 * s, 16, 1024),
                     wg_desc(b + 2048 * s, kBK * kRowBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // A thread holds, for each 8-column group j, columns 8j + 2 (lane % 4)
  // + {0, 1} of rows r and r + 8 (r = 16 warp + lane / 4 within the
  // warpgroup): acc[4j + {0, 1}] and acc[4j + {2, 3}].
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int rows = m0 + wg * 64;
  if (partial) {
    float* const p = partial + (size_t)blockIdx.y * m * n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rows + r0 + 8 * h;
        if (r < m && c < n)
          *reinterpret_cast<float2*>(p + (size_t)r * n + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }

  // both warpgroups are done with the ring before it holds the output
  named_sync(1, kConsumers);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  T* const o = reinterpret_cast<T*>(smem) + wg * 64 * Tile::OUT_LD;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + cq;
    const bool in = c < n;
    const float s0 = in ? scale[c] : 0.f, s1 = in ? scale[c + 1] : 0.f;
    const float b0 = in ? shift[c] : 0.f, b1 = in ? shift[c + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = act_of(
          __fadd_rn(__fmul_rn(acc[4 * j + 2 * h], s0), b0), act);
      const float v1 = act_of(
          __fadd_rn(__fmul_rn(acc[4 * j + 2 * h + 1], s1), b1), act);
      *reinterpret_cast<unsigned*>(
          o + (r0 + 8 * h) * Tile::OUT_LD + 8 * j + cq) = pack2<T>(v0, v1);
    }
  }
  named_sync(2 + wg, 128);
  // 16-byte stores: consecutive threads on consecutive chunks of a row
  constexpr int CPR = BN / 8;
#pragma unroll 4
  for (int i = tid; i < 64 * CPR; i += 128) {
    const int r = i / CPR, c = (i % CPR) * 8;
    if (rows + r < m && n0 + c < n)
      *reinterpret_cast<uint4*>(out + (size_t)(rows + r) * n + n0 + c) =
          *reinterpret_cast<const uint4*>(o + r * Tile::OUT_LD + c);
  }
}

// a (rows, cols) row-major matrix of T (bf16 or f16), read in boxes of
// (box_rows, box_cols = 64: 128 bytes) with the 128-byte swizzle;
// out-of-range elements read as zeros
template <typename T>
bool encode(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, kMapType<T>, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BN>
cudaError_t launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tw,
                         const float* s, const float* b, T* o,
                         float* part, int m, int n, int k, int kchunk,
                         int split, int act, int device, cudaStream_t st) {
  using Tile = WgTile<BN>;
  // above 48 KB of dynamic shared memory only after opting in, once a
  // device (before any capture: the wrappers' first call runs eagerly)
  static bool opted[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        mm_wgmma_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile::SMEM);
    if (e != cudaSuccess) return e;
    opted[device] = true;
  }
  const long long col_tiles = (n + BN - 1) / BN;
  const long long blocks = ((long long)m + kBM - 1) / kBM * col_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  mm_wgmma_kernel<T, BN>
      <<<dim3((unsigned)blocks, (unsigned)split), kThreads, Tile::SMEM,
         st>>>(tx, tw, s, b, o, part, m, n, k, kchunk, (int)col_tiles, act);
  return cudaGetLastError();
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t run(const void* x, const void* w, const float* s, const float* b,
                void* out, float* p, int m, int n, int k, int act, int bn,
                int split, int kchunk, int device, cudaStream_t st) {
  CUtensorMap tx, tw;
  if (!encode<T>(&tx, x, m, k, kBM) || !encode<T>(&tw, w, k, n, kBK))
    return cudaErrorNotSupported;
  T* o = static_cast<T*>(out);
  if (bn == 64)
    return launch_wgmma<T, 64>(tx, tw, s, b, o, p, m, n, k, kchunk, split,
                               act, device, st);
  return launch_wgmma<T, 128>(tx, tw, s, b, o, p, m, n, k, kchunk, split,
                              act, device, st);
}

}  // namespace
}  // namespace mxt

// x: (m, k), w: (k, n), out: (m, n), of `dtype` (bf16 or f16, the codes of
// common.cuh), row-major contiguous, 16-byte aligned, k and n multiples of
// 8; scale, shift: (n,) f32. The plan: block
// tiles of 128 x `bn` (64 or 128) and `split` K ranges of `kchunk` (a
// multiple of 64; the last range ends at k). With split 1 the kernel writes
// act(x @ w * scale + shift) to out and `partial` is unused; with split > 1
// it writes range s's f32 sums to partial (split, m, n) and
// mxt_mm_splitk_reduce (conv_bn_relu.cu) finishes. Returns the CUDA error
// of the launch (0 on success); cudaErrorNotSupported where the tensor maps
// cannot be encoded.
extern "C" int mxt_mm_epilogue_wgmma(const void* x, const void* w,
                                     const void* scale, const void* shift,
                                     void* out, void* partial, int m, int n,
                                     int k, int act, int dtype, int bn,
                                     int split, int kchunk, int device,
                                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (m <= 0 || n <= 0) return 0;
  if (act < mxt::kNone || act > mxt::kRelu6 || k <= 0 || k % 8 != 0 ||
      n % 8 != 0 || (bn != 64 && bn != 128) || split < 1 ||
      split > mxt::kMaxSplit || !mxt::aligned16(x) || !mxt::aligned16(w))
    return (int)cudaErrorInvalidValue;
  if (split == 1) {
    kchunk = k;
    partial = nullptr;
    if (!mxt::aligned16(out)) return (int)cudaErrorInvalidValue;
  } else if (!partial || kchunk <= 0 || kchunk % mxt::kBK != 0 ||
             (long long)(split - 1) * kchunk >= k) {
    return (int)cudaErrorInvalidValue;       // an empty or unaligned range
  }
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  float* p = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mxt::kBFloat16:
      return (int)mxt::run<__nv_bfloat16>(x, w, s, b, out, p, m, n, k, act,
                                          bn, split, kchunk, device, st);
    case mxt::kFloat16:
      return (int)mxt::run<__half>(x, w, s, b, out, p, m, n, k, act, bn,
                                   split, kchunk, device, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
