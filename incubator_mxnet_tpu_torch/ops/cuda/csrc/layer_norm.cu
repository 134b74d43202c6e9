// LayerNorm forward over the last axis, written for Hopper (sm_90a).
//
// Replaces: incubator_mxnet_tpu/ops/pallas/layer_norm.py, `_ln_kernel`
// (called from `_ln_fwd_impl`). Same function: per row, f32 mean, biased
// variance mean((x - mean)^2), y = (x - mean) * rsqrt(var + eps) * gamma + beta
// in f32, cast to x's dtype (f32, bf16 or f16; f16 rounds past 65504 to inf,
// as the cast does). gamma and beta are read in their own dtype (f32, bf16 or
// f16, a dtype code each) and widened to f32 in registers: the TPU kernel
// casts them to f32 before its call, and widening bf16 or f16 to f32 is
// exact, so the function is the same and nothing runs on the card before
// the kernel.
//
// What bounds it on the card: bytes. Per element it reads x once and writes
// y once and does about 8 flops, far below the ~20 flop/byte (f32) at which the
// H100's 67 TFLOP/s f32 rate would take over from its 3.35 TB/s.
//
// What held the earlier design back: one row a warp, one block of four warps
// for every four rows, and gamma[col] and beta[col] read as 4-byte scalars
// for every element of every row. A lane owns 16 consecutive bytes of x (8
// bf16 or 4 f32 columns), so the 32 lanes of one such load sat 32 (16) bytes
// apart and touched 32 (16) sectors to use 128 bytes: at D = 768 in bf16, 48
// loads a row at about 8 L1 cycles each, ~384 cycles against the ~212 cycles
// of one SM's share of device-memory bandwidth that the row's 3 KB take. In
// bf16 the L1 set the pace, not HBM (26-40% of the byte bound; f32 54%).
//
// The design, one template for every dtype (`ln_rows_kernel`; f16 is bf16's
// code with its own pack and unpack):
// 1. A persistent grid. As many blocks of kWarps warps as fill the SMs once
//    (the occupancy API for the instance times the SM count, cached per
//    device, so that a CUDA-graph capture after a first eager call queries
//    nothing). Warp w of W walks rows w, w + W, w + 2W, ...; every row is
//    reduced by one warp in a fixed order, so every call gives the same bits.
// 2. gamma and beta read once a warp, as 16-byte vectors in their own dtype
//    (lane l reads the values of its own columns, neighbouring lanes
//    neighbouring addresses), widened to f32 and kept in registers for every
//    row the warp takes, while a lane holds at most kRegParams columns (D <=
//    1024). Wider rows stage them once a block in shared memory as f32 and
//    read them back as 16-byte vectors.
// 3. The next row's x in flight while this row reduces: the 16-byte loads of
//    row r + W are issued into registers, kept packed (raw uint4), before the
//    two warp-shuffle reductions and the 16-byte stores of row r. Two such
//    register sets take turns in a loop unrolled by two, so that no register
//    move waits on a load.
// x is read from device memory once and y written once; the reductions are
// warp shuffles, with no shared memory and no block barrier on the way.
// f32 takes this design too: it beat the row-per-warp kernel at every shape
// measured, 8 rows to 4096 x 1024 (PERF.md, section 6). A per-warp 2-stage
// ring of rows in shared memory, filled by one 1-D bulk copy (TMA) a row,
// was measured in place of item 3 and lost at every D = 768 shape but bf16
// at 4096 rows (1% ahead there, 6 of 8 rounds): at 4096 rows a warp takes
// at most two rows, so a ring has little to hide, and it adds an mbarrier
// wait a row.
//
// Rows that are unaligned, of a width that is not a multiple of 16 bytes or
// wider than 8 vectors a lane take `ln_block_kernel`: one block a row, the
// row staged once in shared memory as f32, with an instance for each pair
// of gamma and beta dtypes (3 x 3 an x dtype).
#include <atomic>

#include "common.cuh"

namespace mxt {
namespace {

constexpr int kWarps = 4;            // warps a block of ln_rows_kernel
constexpr int kRegParams = 32;       // columns a lane keeps gamma, beta for
constexpr int kBlockThreads = 256;   // wide-row kernel
constexpr int kMaxDevices = 64;      // devices whose grid size is cached

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct VecWidth<__half> { static constexpr int N = 8; };

// the VN values of T packed in 16 bytes, widened to f32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& q,
                                       float (&v)[VecWidth<T>::N]) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
  } else {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = widen2<T>(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// VN f32 values rounded to T (to nearest even) and packed in 16 bytes
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[VecWidth<T>::N]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    return make_uint4(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]),
                      pack2<T>(v[4], v[5]), pack2<T>(v[6], v[7]));
  }
}

// VN consecutive 16-bit values of type P from column `col`, widened to f32:
// one 16-byte load (VN = 8) or one 8-byte load (VN = 4)
template <typename P, int VN>
__device__ __forceinline__ void load_param16(const void* p, int col,
                                             float (&v)[VN]) {
  const P* b = static_cast<const P*>(p) + col;
  if constexpr (VN == 8) {
    unpack<P>(*reinterpret_cast<const uint4*>(b), v);
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(b);
    const float2 lo = widen2<P>(q.x), hi = widen2<P>(q.y);
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
}

// VN consecutive values of a parameter vector from column `col` (a multiple
// of VN), widened to f32: f32 (`pdt` kFloat32) as VN / 4 16-byte loads, bf16
// and f16 by load_param16
template <int VN>
__device__ __forceinline__ void load_param(const void* p, int pdt, int col,
                                           float (&v)[VN]) {
  if (pdt == kBFloat16) {
    load_param16<__nv_bfloat16, VN>(p, col, v);
  } else if (pdt == kFloat16) {
    load_param16<__half, VN>(p, col, v);
  } else {
    const float4* f =
        reinterpret_cast<const float4*>(static_cast<const float*>(p) + col);
#pragma unroll
    for (int k = 0; k < VN / 4; ++k) {
      const float4 q = f[k];
      v[4 * k] = q.x; v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z; v[4 * k + 3] = q.w;
    }
  }
}

// issue the 16-byte loads of one row of x (the lane's vectors c = lane + 32 i
// below nvec) into `raw`
template <int NV>
__device__ __forceinline__ void load_row(const uint4* __restrict__ xr,
                                         int lane, int nvec,
                                         uint4 (&raw)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + i * 32 < nvec) raw[i] = xr[lane + i * 32];
}

template <typename T, int NV, bool kSmem>
struct RowNorm {
  static constexpr int VN = VecWidth<T>::N;
  static constexpr int PV = kSmem ? 1 : NV;   // parameter vectors a lane

  float g[PV][VN], b[PV][VN];   // the lane's gamma and beta (registers)
  const float* sg;              // or the block's, in shared memory
  const float* sb;

  // normalise the row in `raw` and store it at `yr`
  __device__ __forceinline__ void run(const uint4 (&raw)[NV], uint4* yr,
                                      int lane, int nvec, int d,
                                      float eps) const {
    float v[NV][VN];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + i * 32 < nvec) {
        unpack<T>(raw[i], v[i]);
#pragma unroll
        for (int j = 0; j < VN; ++j) sum += v[i][j];
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
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + i * 32;
      if (c < nvec) {
        float gv[VN], bv[VN], o[VN];
        if constexpr (kSmem) {
#pragma unroll
          for (int k = 0; k < VN; k += 4) {
            const float4 q = *reinterpret_cast<const float4*>(sg + c * VN + k);
            const float4 r = *reinterpret_cast<const float4*>(sb + c * VN + k);
            gv[k] = q.x; gv[k + 1] = q.y; gv[k + 2] = q.z; gv[k + 3] = q.w;
            bv[k] = r.x; bv[k + 1] = r.y; bv[k + 2] = r.z; bv[k + 3] = r.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < VN; ++j) {
            gv[j] = g[i][j];
            bv[j] = b[i][j];
          }
        }
#pragma unroll
        for (int j = 0; j < VN; ++j)
          o[j] = (v[i][j] - mean) * rstd * gv[j] + bv[j];
        yr[c] = pack<T>(o);
      }
    }
  }
};

template <typename T, int NV, bool kSmem>
__global__ void __launch_bounds__(32 * kWarps)
ln_rows_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
               int gdt, const void* __restrict__ beta, int bdt,
               T* __restrict__ y, int rows, int d, float eps) {
  constexpr int VN = VecWidth<T>::N;
  extern __shared__ float4 sparams[];   // kSmem: gamma, then beta, as f32
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  const int nvec = d / VN;
  RowNorm<T, NV, kSmem> norm;
  if constexpr (kSmem) {
    float* sg = reinterpret_cast<float*>(sparams);
    float* sb = sg + d;
    for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
      float t[VN];
      load_param<VN>(gamma, gdt, c * VN, t);
#pragma unroll
      for (int k = 0; k < VN; k += 4)
        *reinterpret_cast<float4*>(sg + c * VN + k) =
            make_float4(t[k], t[k + 1], t[k + 2], t[k + 3]);
      load_param<VN>(beta, bdt, c * VN, t);
#pragma unroll
      for (int k = 0; k < VN; k += 4)
        *reinterpret_cast<float4*>(sb + c * VN + k) =
            make_float4(t[k], t[k + 1], t[k + 2], t[k + 3]);
    }
    __syncthreads();
    norm.sg = sg;
    norm.sb = sb;
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + i * 32;
      if (c < nvec) {
        load_param<VN>(gamma, gdt, c * VN, norm.g[i]);
        load_param<VN>(beta, bdt, c * VN, norm.b[i]);
      }
    }
  }

  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const auto xrow = [&](int r) {
    return reinterpret_cast<const uint4*>(x + (size_t)r * d);
  };
  const auto yrow = [&](int r) {
    return reinterpret_cast<uint4*>(y + (size_t)r * d);
  };
  uint4 a[NV], b[NV];
  load_row<NV>(xrow(row), lane, nvec, a);
  for (;;) {
    int next = row + warps;
    if (next < rows) load_row<NV>(xrow(next), lane, nvec, b);
    norm.run(a, yrow(row), lane, nvec, d, eps);
    if (next >= rows) return;
    row = next;
    next = row + warps;
    if (next < rows) load_row<NV>(xrow(next), lane, nvec, a);
    norm.run(b, yrow(row), lane, nvec, d, eps);
    if (next >= rows) return;
    row = next;
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

// one block a row; gamma of type G and beta of type B (f32, bf16 or f16)
template <typename T, typename G, typename B>
__global__ void __launch_bounds__(kBlockThreads)
ln_block_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                const B* __restrict__ beta, T* __restrict__ y, int d,
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
    y[base + c] = from_f32<T>((srow[c] - mean) * rstd * to_f32(gamma[c]) +
                              to_f32(beta[c]));
}

template <typename T, typename G, typename B>
cudaError_t launch_block(const T* x, const void* g, const void* b, T* y,
                         int rows, int d, float eps, cudaStream_t s) {
  const size_t smem = (size_t)d * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      ln_block_kernel<T, G, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  ln_block_kernel<T, G, B><<<rows, kBlockThreads, smem, s>>>(
      x, static_cast<const G*>(g), static_cast<const B*>(b), y, d, eps);
  return cudaGetLastError();
}

// launch_block with gamma of type G and beta of dtype code `bdt`
template <typename T, typename G>
cudaError_t launch_block_g(const T* x, const void* g, const void* b, int bdt,
                           T* y, int rows, int d, float eps, cudaStream_t s) {
  switch (bdt) {
    case kBFloat16:
      return launch_block<T, G, __nv_bfloat16>(x, g, b, y, rows, d, eps, s);
    case kFloat16:
      return launch_block<T, G, __half>(x, g, b, y, rows, d, eps, s);
    default:
      return launch_block<T, G, float>(x, g, b, y, rows, d, eps, s);
  }
}

// Blocks of ln_rows_kernel<T, NV, S> that fill the SMs of `device` once:
// resident blocks an SM (for the instance's widest row's shared memory)
// times the SM count. Cached per device after the first query.
template <typename T, int NV, bool S>
cudaError_t persistent_blocks(int device, int* blocks) {
  static std::atomic<int> cache[kMaxDevices];
  if (device < kMaxDevices) {
    const int c = cache[device].load(std::memory_order_relaxed);
    if (c > 0) {
      *blocks = c;
      return cudaSuccess;
    }
  }
  const size_t smem =
      S ? 2 * sizeof(float) * NV * 32 * VecWidth<T>::N : 0;
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ln_rows_kernel<T, NV, S>, 32 * kWarps, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (device < kMaxDevices)
    cache[device].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, int NV>
cudaError_t launch_rows(const T* x, const void* g, int gdt, const void* b,
                        int bdt, T* y, int rows, int d, float eps, int device,
                        cudaStream_t s) {
  constexpr bool S = NV * VecWidth<T>::N > kRegParams;
  int blocks = 0;
  const cudaError_t e = persistent_blocks<T, NV, S>(device, &blocks);
  if (e != cudaSuccess) return e;
  const int needed = (rows + kWarps - 1) / kWarps;
  const size_t smem = S ? 2 * sizeof(float) * (size_t)d : 0;
  ln_rows_kernel<T, NV, S><<<needed < blocks ? needed : blocks, 32 * kWarps,
                             smem, s>>>(x, g, gdt, b, bdt, y, rows, d, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* xv, const void* g, int gdt, const void* b,
                   int bdt, void* yv, int rows, int d, float eps, int device,
                   cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  constexpr int VN = VecWidth<T>::N;
  const bool aligned = aligned16(x) && aligned16(y) && aligned16(g) &&
                       aligned16(b) && d % VN == 0;
  const int nv = (d / VN + 31) / 32;
  if (aligned && nv <= 8) {
    switch (nv) {
      case 1: return launch_rows<T, 1>(x, g, gdt, b, bdt, y, rows, d, eps, device, s);
      case 2: return launch_rows<T, 2>(x, g, gdt, b, bdt, y, rows, d, eps, device, s);
      case 3: return launch_rows<T, 3>(x, g, gdt, b, bdt, y, rows, d, eps, device, s);
      case 4: return launch_rows<T, 4>(x, g, gdt, b, bdt, y, rows, d, eps, device, s);
      case 5: return launch_rows<T, 5>(x, g, gdt, b, bdt, y, rows, d, eps, device, s);
      case 6: return launch_rows<T, 6>(x, g, gdt, b, bdt, y, rows, d, eps, device, s);
      case 7: return launch_rows<T, 7>(x, g, gdt, b, bdt, y, rows, d, eps, device, s);
      default: return launch_rows<T, 8>(x, g, gdt, b, bdt, y, rows, d, eps, device, s);
    }
  }
  switch (gdt) {
    case kBFloat16:
      return launch_block_g<T, __nv_bfloat16>(x, g, b, bdt, y, rows, d, eps, s);
    case kFloat16:
      return launch_block_g<T, __half>(x, g, b, bdt, y, rows, d, eps, s);
    default:
      return launch_block_g<T, float>(x, g, b, bdt, y, rows, d, eps, s);
  }
}

}  // namespace
}  // namespace mxt

// x, y: (rows, d) row-major contiguous, of dtype `dtype`; gamma, beta: (d,)
// contiguous, of dtypes `gamma_dtype` and `beta_dtype` (each f32, bf16 or
// f16, the codes of common.cuh). Returns the CUDA error of the launch (0 on
// success).
extern "C" int mxt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, int rows, int d,
                                  float eps, int dtype, int gamma_dtype,
                                  int beta_dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows <= 0 || d <= 0) return 0;
  const auto known = [](int p) {
    return p == mxt::kFloat32 || p == mxt::kBFloat16 || p == mxt::kFloat16;
  };
  if (!known(gamma_dtype) || !known(beta_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mxt::kFloat32:
      return (int)mxt::launch<float>(x, gamma, gamma_dtype, beta, beta_dtype,
                                     y, rows, d, eps, device, s);
    case mxt::kBFloat16:
      return (int)mxt::launch<__nv_bfloat16>(x, gamma, gamma_dtype, beta,
                                             beta_dtype, y, rows, d, eps,
                                             device, s);
    case mxt::kFloat16:
      return (int)mxt::launch<__half>(x, gamma, gamma_dtype, beta, beta_dtype,
                                      y, rows, d, eps, device, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
