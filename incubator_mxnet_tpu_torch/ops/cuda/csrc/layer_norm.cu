// LayerNorm forward over the last axis, written for Hopper (sm_90a).
//
// Replaces: incubator_mxnet_tpu/ops/pallas/layer_norm.py, `_ln_kernel`
// (called from `_ln_fwd_impl`). Same function: per row, f32 mean, biased
// variance mean((x - mean)^2), y = (x - mean) * rsqrt(var + eps) * gamma + beta,
// cast to x's dtype. gamma and beta arrive as f32, as the TPU kernel casts them.
//
// What bounds it on the card: bytes. Per element it reads x once and writes
// y once and does about 8 flops, far below the ~20 flop/byte (f32) at which the
// H100's 67 TFLOP/s f32 rate would take over from its 3.35 TB/s.
//
// What the design does about it: x is read from device memory exactly once.
// `ln_warp_kernel` gives each row to one warp and keeps the whole row in
// registers (16-byte loads and stores, up to 8 vectors a lane: D <= 1024 in
// f32, <= 2048 in bf16), so the two reductions and the write need no second
// read; the reductions are warp shuffles, with no shared memory and no block
// barrier. The TPU kernel's padding of rows to a multiple of 8 (a sublane
// tiling artifact) is gone: a warp past the last row returns. Rows that are
// wider, unaligned or of a width that is not a multiple of 16 bytes take
// `ln_block_kernel`: one block per row, the row staged once in shared memory
// as f32.
#include "common.cuh"

namespace mxt {
namespace {

constexpr int kWarpRowsPerBlock = 4;   // 128 threads, one row per warp
constexpr int kBlockThreads = 256;     // wide-row kernel

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

template <typename T, int NV>
__global__ void __launch_bounds__(32 * kWarpRowsPerBlock)
ln_warp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ y, int rows,
               int d, float eps) {
  constexpr int VN = VecWidth<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = d / VN;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);

  float v[NV][VN];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      const uint4 raw = xr[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        v[i][j] = to_f32(e[j]);
        sum += v[i][j];
      }
    }
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        const float c = v[i][j] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);

  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + i * 32;
    if (c < nvec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        const int col = c * VN + j;
        e[j] = from_f32<T>((v[i][j] - mean) * rstd * gamma[col] + beta[col]);
      }
      yr[c] = raw;
    }
  }
}

// Sum over the block; every thread gets the total. `red` holds one partial
// per warp; the leading barrier lets a second call reuse it safely.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  return warp_sum(lane < nw ? red[lane] : 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
ln_block_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y, int d,
                float eps) {
  extern __shared__ float srow[];
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * d;
  float sum = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float f = to_f32(x[base + c]);
    srow[c] = f;
    sum += f;
  }
  const float mean = block_sum(sum, red) / d;
  float sq = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float t = srow[c] - mean;
    sq += t * t;
  }
  const float rstd = rsqrtf(block_sum(sq, red) / d + eps);
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    y[base + c] = from_f32<T>((srow[c] - mean) * rstd * gamma[c] + beta[c]);
}

template <typename T, int NV>
void launch_warp(const T* x, const float* g, const float* b, T* y, int rows,
                 int d, float eps, cudaStream_t s) {
  const int blocks = (rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock;
  ln_warp_kernel<T, NV><<<blocks, 32 * kWarpRowsPerBlock, 0, s>>>(
      x, g, b, y, rows, d, eps);
}

template <typename T>
cudaError_t launch(const void* xv, const float* g, const float* b, void* yv,
                   int rows, int d, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  constexpr int VN = VecWidth<T>::N;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                       (d % VN == 0);
  const int nv = (d / VN + 31) / 32;
  if (aligned && nv <= 8) {
    switch (nv) {
      case 1: launch_warp<T, 1>(x, g, b, y, rows, d, eps, s); break;
      case 2: launch_warp<T, 2>(x, g, b, y, rows, d, eps, s); break;
      case 3: launch_warp<T, 3>(x, g, b, y, rows, d, eps, s); break;
      case 4: launch_warp<T, 4>(x, g, b, y, rows, d, eps, s); break;
      case 5: launch_warp<T, 5>(x, g, b, y, rows, d, eps, s); break;
      case 6: launch_warp<T, 6>(x, g, b, y, rows, d, eps, s); break;
      case 7: launch_warp<T, 7>(x, g, b, y, rows, d, eps, s); break;
      default: launch_warp<T, 8>(x, g, b, y, rows, d, eps, s); break;
    }
    return cudaGetLastError();
  }
  const size_t smem = (size_t)d * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ln_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  ln_block_kernel<T><<<rows, kBlockThreads, smem, s>>>(x, g, b, y, d, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mxt

// x, y: (rows, d) row-major contiguous; gamma, beta: (d,) f32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int mxt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, int rows, int d,
                                  float eps, int dtype, int device,
                                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows <= 0 || d <= 0) return 0;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mxt::kFloat32:
      return (int)mxt::launch<float>(x, g, b, y, rows, d, eps, s);
    case mxt::kBFloat16:
      return (int)mxt::launch<__nv_bfloat16>(x, g, b, y, rows, d, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
