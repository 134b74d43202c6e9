// The bf16 fused 1x1-conv GEMM on Hopper's tensor cores (sm_90a): wgmma
// fed by TMA.
//
// Replaces: `_mm_kernel` of incubator_mxnet_tpu/ops/pallas/conv_bn_relu.py
// (called from `_mm_epilogue`) for bf16 inputs:
//   out = act((x @ w) * scale[n] + shift[n])
// for x (M, K) and w (K, N), both row-major bf16, act in {none, relu,
// relu6}. `_mm_kernel` widens bf16 to f32 before `jnp.dot`; a product of
// two bf16 values is exact in f32, so a tensor-core product of bf16
// operands with f32 accumulation computes the same function up to the
// order of the sums. The epilogue runs on the f32 sums, the product and
// the sum rounded separately (__fmul_rn, __fadd_rn) as in the f32 kernel
// of conv_bn_relu.cu, and the result is rounded once to bf16.
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
// - The producer's one thread keeps a ring of k-tiles (64 bf16 deep, one
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
//   bf16 into shared memory (the ring is free by then) and leave in
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
// The wrapper sends a bf16 call here when K and N are multiples of 8 (row
// strides of 16 bytes, as TMA needs) and x, w and out are 16-byte aligned;
// any other bf16 call runs the SIMT kernel of conv_bn_relu.cu.
#include <cuda.h>   // CUtensorMap and its enums only; libcuda is not linked

#include "common.cuh"

namespace mxt {
namespace {

enum Act : int { kNone = 0, kRelu = 1, kRelu6 = 2 };

constexpr int kBM = 128;               // rows a block: two warpgroups of 64
constexpr int kBK = 64;                // k-tile depth: 128 bytes of bf16
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// a 2-D box of the tensor map at (c0, c1) (c0 the contiguous coordinate)
// into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)) : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// shared address `addr`: leading and stride byte offsets in bytes
__device__ __forceinline__ uint64_t wg_desc(unsigned addr, unsigned lbo,
                                            unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) |
         ((uint64_t)1 << 62);                      // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32, in registers) += A (64 x 16, K-major) * B (16 x N,
// MN-major: imm-trans-b = 1), both read from shared memory through their
// descriptors
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a,
                                           uint64_t b) {
  if constexpr (BN == 64) wgmma_m64n64(d, a, b);
  else wgmma_m64n128(d, a, b);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
// partial[blockIdx.y] (M, N). T is always __nv_bfloat16: the kernel's name
// carries its type, as every kernel of this directory's does.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 2)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw,
                const float* __restrict__ scale,
                const float* __restrict__ shift, T* __restrict__ out,
                float* __restrict__ partial, int m, int n, int k, int kchunk,
                int col_tiles, int act) {
  static_assert(sizeof(T) == 2, "bf16 operands");
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
      wgmma_tile<BN>(acc, wg_desc(a + 32 * s, 16, 1024),
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
      *reinterpret_cast<__nv_bfloat162*>(
          o + (r0 + 8 * h) * Tile::OUT_LD + 8 * j + cq) =
          __floats2bfloat162_rn(v0, v1);
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

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a (rows, cols) row-major bf16 matrix, read in boxes of (box_rows,
// box_cols = 64: 128 bytes) with the 128-byte swizzle; out-of-range
// elements read as zeros
bool encode(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tw,
                         const float* s, const float* b, __nv_bfloat16* o,
                         float* part, int m, int n, int k, int kchunk,
                         int split, int act, int device, cudaStream_t st) {
  using Tile = WgTile<BN>;
  // above 48 KB of dynamic shared memory only after opting in, once a
  // device (before any capture: the wrappers' first call runs eagerly)
  static bool opted[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        mm_wgmma_kernel<__nv_bfloat16, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile::SMEM);
    if (e != cudaSuccess) return e;
    opted[device] = true;
  }
  const long long col_tiles = (n + BN - 1) / BN;
  const long long blocks = ((long long)m + kBM - 1) / kBM * col_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  mm_wgmma_kernel<__nv_bfloat16, BN>
      <<<dim3((unsigned)blocks, (unsigned)split), kThreads, Tile::SMEM,
         st>>>(tx, tw, s, b, o, part, m, n, k, kchunk, (int)col_tiles, act);
  return cudaGetLastError();
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
}  // namespace mxt

// x: (m, k), w: (k, n), out: (m, n), bf16, row-major contiguous, 16-byte
// aligned, k and n multiples of 8; scale, shift: (n,) f32. The plan: block
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
                                     int k, int act, int bn, int split,
                                     int kchunk, int device, void* stream) {
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
  CUtensorMap tx, tw;
  if (!mxt::encode(&tx, x, m, k, mxt::kBM) ||
      !mxt::encode(&tw, w, k, n, mxt::kBK))
    return (int)cudaErrorNotSupported;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* p = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    return (int)mxt::launch_wgmma<64>(tx, tw, s, b, o, p, m, n, k, kchunk,
                                      split, act, device, st);
  return (int)mxt::launch_wgmma<128>(tx, tw, s, b, o, p, m, n, k, kchunk,
                                     split, act, device, st);
}
