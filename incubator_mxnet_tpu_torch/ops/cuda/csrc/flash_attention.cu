// FlashAttention-2 forward, written for Hopper (sm_90a).
//
// Replaces: incubator_mxnet_tpu/ops/pallas/flash_attention.py, `_fwd_kernel`
// (called from `_fwd`). Same function: O = softmax(scale * Q K^T) V with an
// online softmax over key tiles in f32, the per-row logsumexp written beside
// O, bottom-right causal masking (row r sees keys c <= r + lk - lq), keys at
// or past `kv_len` masked, and a row that sees no key gives O = 0 (and
// lse = -inf). O has the input dtype, lse is f32.
//
// What bounds it on the card: at the shapes BERT-base serves (L = 128,
// D = 64) the two products cost 4*L*L*D flops per (batch, head) against
// 4*L*D elements moved: 128 flop per element, 32 flop/byte in f32. The H100
// moves 3.35 TB/s and does 67 TFLOP/s on f32 outside the tensor cores, so in
// f32 the bound is the f32 operations (~20 flop/byte is the ridge); in bf16
// the tensor-core rate (989 TFLOP/s) would make it bytes.
//
// What the design does about it, in this first version: one block of 128
// threads per (batch*head, 64-row Q tile). The TPU kernel's sequential grid
// axis over key blocks (which carried m, l and acc in scratch from one grid
// step to the next) becomes a loop over 64-key tiles inside the block, with
// m, l and the O accumulator in registers. Q (pre-scaled by scale*log2(e)),
// the K tile and the V tile are staged in shared memory as f32; the score
// tile S never reaches device memory. Each thread owns a 4x8 block of S and
// the matching 4 rows of O, so the softmax rescale factor of a row is local
// to the threads that apply it; the row max and row sum are 8-lane shuffles.
// The products run on the f32 FMA units (no tensor cores, so f32 stays exact
// to f32 rounding; bf16 inputs are widened to f32), and causal blocks skip
// the key tiles wholly above the diagonal. wgmma, TMA and warp specialisation
// are later work. The TPU kernel padded L to the block and D to 128 lanes;
// here ragged tiles are masked in place and D is a template argument
// (64 or 128), so nothing is padded or copied.
//
// Q, K, V and O are read and written through (batch, head, row) strides with
// a unit stride on the head dimension, so the (B, L, H, D) views that
// multi-head attention cuts out of one fused QKV projection go in without a
// transpose copy, and O can be written straight into (B, L, H, D).
#include "common.cuh"

namespace mxt {
namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kPad = kBQ + 1;  // padded leading dim of the transposed tiles
constexpr float kNeg = -1e30f;

struct Strides {
  long long b, h, l;
};

template <int D>
constexpr size_t smem_bytes() {
  // Qs [D][kBQ+1], Ks [D][kBK+1], Vs [kBK][D], Ps [kBQ][kBK+1], all f32
  return sizeof(float) *
         ((size_t)D * kPad + (size_t)D * (kBK + 1) + (size_t)kBK * D +
          (size_t)kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int lq, int lk, Strides sq,
                 Strides sk, Strides sv, Strides so, float qscale, int causal,
                 int kv_len) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [D][kPad], transposed
  float* Ks = Qs + D * kPad;             // [D][kBK + 1], transposed
  float* Vs = Ks + D * (kBK + 1);        // [kBK][D]
  float* Ps = Vs + kBK * D;              // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int tr = tid >> 3;               // row group: rows tr + 16*i
  const int tc = tid & 7;                // column group: cols tc + 8*j
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int offset = lk - lq;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = q0 + r;
    Qs[c * kPad + r] = row < lq ? to_f32(qb[row * sq.l + c]) * qscale : 0.f;
  }

  // key tiles this Q tile needs: up to kv_len, and for causal up to the
  // diagonal of its last real row
  const int kv_lim = min(kv_len, lk);
  int n_kv = (kv_lim + kBK - 1) / kBK;
  if (causal) {
    const int last_col = min(q0 + kBQ, lq) - 1 + offset;
    n_kv = min(n_kv, last_col < 0 ? 0 : last_col / kBK + 1);
  }

  constexpr int NJ = D / 8;              // O columns per thread
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int key = k0 + r;
      const bool in = key < lk;
      Ks[c * (kBK + 1) + r] = in ? to_f32(kb[key * sk.l + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[key * sv.l + c]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[c * kPad + tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[c * (kBK + 1) + tc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
      bool ok[8];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tc + 8 * j;
        ok[j] = col < kv_lim && (!causal || col <= row + offset);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? exp2f(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(tr + 16 * i) * (kBK + 1) + tc + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * D + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= lq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[row * so.l + tc + 8 * j] = from_f32<T>(acc[i][j] * inv);
    if (tc == 0)
      lse[(size_t)bh * lq + row] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * 0.69314718055994531f
                     : __int_as_float((int)0xff800000u);  // -inf
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int lq, int lk, Strides sq,
                   Strides sk, Strides sv, Strides so, float scale, int causal,
                   int kv_len, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (lq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, lq, lk, sq, sk, sv,
      so, scale * 1.4426950408889634f, causal, kv_len);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mxt

// q: (B, H, lq, d), k and v: (B, H, lk, d), o: (B, H, lq, d), each given by
// its (batch, head, row) strides in elements with a unit stride on d;
// lse: (B, H, lq) contiguous f32. Returns the CUDA error of the launch.
extern "C" int mxt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int lq, int lk, int d, int dtype, long long sqb, long long sqh,
    long long sql, long long skb, long long skh, long long skl, long long svb,
    long long svh, long long svl, long long sob, long long soh, long long sol,
    float scale, int causal, int kv_len, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || H <= 0 || lq <= 0) return 0;
  const mxt::Strides sq{sqb, sqh, sql}, sk{skb, skh, skl}, sv{svb, svh, svl},
      so{sob, soh, sol};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MXT_FA_LAUNCH(T, D)                                                   \
  return (int)mxt::launch<T, D>(q, k, v, o, l, B, H, lq, lk, sq, sk, sv, so, \
                                scale, causal, kv_len, s)
  if (dtype == mxt::kFloat32 && d == 64) MXT_FA_LAUNCH(float, 64);
  if (dtype == mxt::kFloat32 && d == 128) MXT_FA_LAUNCH(float, 128);
  if (dtype == mxt::kBFloat16 && d == 64) MXT_FA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == mxt::kBFloat16 && d == 128) MXT_FA_LAUNCH(__nv_bfloat16, 128);
#undef MXT_FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
