// The two kernels of the fused conv + BatchNorm + activation path, written
// for Hopper (sm_90a).
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
//    What bounds it on the card: operations in f32 (2MNK flops at 67 TFLOP/s
//    on the FMA units; ResNet-50's 1x1 convolutions do 64-1024 flops per byte
//    moved), bytes in bf16 where it is measured against the tensor cores'
//    989 TFLOP/s.
//
//    What the design does about it: a first, simple, correct version. Each
//    block computes a 128 x 128 tile of the output with 256 threads, each
//    thread an 8 x 8 piece of it in registers, so every value read from
//    shared memory feeds 8 FMAs. K is walked in steps of 8: the block stages
//    an (8 x 128) slice of x (transposed, so that a thread reads its 8 rows
//    as two float4s) and an (8 x 128) slice of w in shared memory, as f32,
//    with guarded loads that zero-fill past the edges, so any M, K and N
//    work. The TPU kernel's f32 accumulator in VMEM scratch, carried across
//    a sequential grid axis over K, is the register tile here; its last
//    k-block's epilogue is the loop's tail. No tensor cores, TMA or wgmma:
//    those are the work of a later version.
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

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kTM = 8;            // rows of the output a thread computes
constexpr int kTN = 8;            // columns of the output a thread computes
constexpr int kMmThreads = (kBM / kTM) * (kBN / kTN);   // 256

template <typename T, int ACT>
__global__ void __launch_bounds__(kMmThreads)
mm_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, T* __restrict__ out,
                   int m, int n, int k) {
  // x's slice transposed: as[kk][row]; w's slice as it is: bs[kk][col]
  __shared__ __align__(16) float as[kBK][kBM];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  // staging: each thread brings 4 values of x (one row, 4 consecutive k)
  // and 4 of w (one k, 4 consecutive columns)
  const int a_row = t / 2, a_k = (t % 2) * 4;
  const int b_k = t / 32, b_col = (t % 32) * 4;
  // compute: thread (ty, tx) owns rows ty*8.. and columns tx*8..
  const int ty = t / (kBN / kTN), tx = t % (kBN / kTN);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int gm = m0 + a_row;
  const T* xrow = x + (size_t)gm * k;
  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + a_k + i;
      as[a_k + i][a_row] = (gm < m && kk < k) ? to_f32(xrow[kk]) : 0.f;
    }
    {
      const int kk = k0 + b_k;
      const T* wrow = w + (size_t)kk * n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gn = n0 + b_col + i;
        bs[b_k][b_col + i] = (kk < k && gn < n) ? to_f32(wrow[gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * kTN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][tx * kTN + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the epilogue, once, on the finished f32 sums
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int gn = n0 + tx * kTN + j;
    if (gn >= n) break;
    const float s = scale[gn], b = shift[gn];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = m0 + ty * kTM + i;
      if (row < m)
        out[(size_t)row * n + gn] = from_f32<T>(
            apply_act<ACT>(__fadd_rn(__fmul_rn(acc[i][j], s), b)));
    }
  }
}

template <typename T>
cudaError_t launch_mm(const void* xv, const void* wv, const float* s,
                      const float* b, void* ov, int m, int n, int k, int act,
                      cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* o = static_cast<T*>(ov);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  switch (act) {
    case kNone:
      mm_epilogue_kernel<T, kNone><<<grid, kMmThreads, 0, st>>>(x, w, s, b, o, m, n, k);
      break;
    case kRelu:
      mm_epilogue_kernel<T, kRelu><<<grid, kMmThreads, 0, st>>>(x, w, s, b, o, m, n, k);
      break;
    case kRelu6:
      mm_epilogue_kernel<T, kRelu6><<<grid, kMmThreads, 0, st>>>(x, w, s, b, o, m, n, k);
      break;
    default:
      return cudaErrorInvalidValue;
  }
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
// dtype; scale, shift: (n,) f32. Returns the CUDA error of the launch.
extern "C" int mxt_mm_epilogue(const void* x, const void* w, const void* scale,
                               const void* shift, void* out, int m, int n,
                               int k, int act, int dtype, int device,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (m <= 0 || n <= 0) return 0;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mxt::kFloat32:
      return (int)mxt::launch_mm<float>(x, w, s, b, out, m, n, k, act, st);
    case mxt::kBFloat16:
      return (int)mxt::launch_mm<__nv_bfloat16>(x, w, s, b, out, m, n, k, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
