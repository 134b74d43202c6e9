// FlashAttention-2 backward, written for Hopper (sm_90a): two kernels, dQ
// and dK/dV.
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
// instead of inf * 0 = NaN.
//
// What bounds it on the card: operations. At B=8, H=12, L=512, D=64 causal
// (131,328 (query, key) pairs a head) the dQ kernel does 6*pairs*D flops
// (S, dP, dQ) and the dK/dV kernel 8*pairs*D (S, dP, dV, dK) against
// 4*L*D inputs and 1-2*L*D outputs a head: over 500 flop per f32 element
// moved, far above the H100's ridge of about 20 flop/byte between 67 TFLOP/s
// f32 (outside the tensor cores) and 3.35 TB/s.
//
// What the design does about it, in this first version: keep the TPU
// kernels' split, which needs no atomics and is deterministic. The TPU
// kernels carried dQ (resp. dK, dV) in scratch across a sequential grid axis;
// blocks on the card run in no order, so that axis becomes a loop inside the
// block with the accumulators in registers:
//   dQ:    one block of 128 threads per (batch*head, 64-row query tile)
//          loops over 64-key tiles (causal: up to the diagonal of its last
//          row);
//   dK/dV: one block per (batch*head, 64-key tile) loops over 64-row query
//          tiles, starting (causal) at the first tile that sees its keys,
//          as `first` does in `_dkv_kernel`.
// Both tiles of each product are staged in shared memory as f32, transposed
// with a padded leading dimension so that neither the staging stores nor the
// product reads conflict on banks. Each thread owns a 4x8 piece of the
// (64 x 64) score tile, computes S and dP for it in one pass over D, turns
// them into P and dS in registers, and writes dS (and P) to shared memory for
// the second product. The products run on the f32 FMA units (no tensor
// cores), so f32 matches the plain version to f32 rounding; bf16 inputs are
// widened to f32 and the gradients rounded once at the end. wgmma, TMA and
// a fused single-pass kernel with atomics are later work. Nothing is padded:
// D is a template argument (64 or 128), L is masked in place.
//
// Q, K, V and dO are read, and dQ, dK and dV written, through (batch, head,
// row) strides with a unit stride on the head dimension, so the (B, L, H, D)
// views that multi-head attention cuts out of one fused QKV projection go in
// without a copy, and the gradients can be written as (B, L, H, D).
#include "common.cuh"

namespace mxt {
namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kLd = 65;        // padded leading dim of every staged tile
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, l;
};

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

// Stage rows [r0, r0 + 64) of a (n, D) matrix, read through row stride `ld`,
// into shared memory as f32, transposed: dst[c * kLd + r]. Rows at or past
// `n` become 0.
template <typename T, int D>
__device__ __forceinline__ void stage_t(float* dst, const T* src, long long ld,
                                        int r0, int n) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[c * kLd + r] = row < n ? to_f32(src[row * ld + c]) : 0.f;
  }
}

// lse (scaled to log2 units) and delta of query rows [q0, q0 + 64).
__device__ __forceinline__ void stage_rows(float* lse_s, float* dl_s,
                                           const float* lse,
                                           const float* delta, size_t base,
                                           int q0, int lq) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const int row = q0 + i;
    lse_s[i] = row < lq ? lse[base + row] * kLog2e : 0.f;
    dl_s[i] = row < lq ? delta[base + row] : 0.f;
  }
}

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs, Ks, Vs [D][kLd]; dSs [kBQ][kLd]
  return sizeof(float) * (4 * (size_t)D * kLd + (size_t)kBQ * kLd);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  float* Qs = smem;            // [D][kLd], query rows of this block
  float* dOs = Qs + D * kLd;   // [D][kLd]
  float* Ks = dOs + D * kLd;   // [D][kLd], the current key tile
  float* Vs = Ks + D * kLd;    // [D][kLd]
  float* dSs = Vs + D * kLd;   // [kBQ][kLd]
  __shared__ float lse_s[kBQ], dl_s[kBQ];

  const int tid = threadIdx.x;
  const int tr = tid >> 3;     // rows tr + 16*i
  const int tc = tid & 7;      // keys tc + 8*j (S), columns tc + 8*j (dQ)
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kBQ;
  const int lq = a.lq, lk = a.lk;
  const int offset = lk - lq;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;

  stage_t<T, D>(Qs, qb, a.sq.l, q0, lq);
  stage_t<T, D>(dOs, dob, a.sdo.l, q0, lq);
  stage_rows(lse_s, dl_s, a.lse, a.delta, (size_t)bh * lq, q0, lq);

  // key tiles this query tile sees: up to kv_len, and for causal up to the
  // diagonal of its last real row
  const int kv_lim = min(a.kv_len, lk);
  int n_kv = (kv_lim + kBK - 1) / kBK;
  if (a.causal) {
    const int last_col = min(q0 + kBQ, lq) - 1 + offset;
    n_kv = min(n_kv, last_col < 0 ? 0 : last_col / kBK + 1);
  }
  const float sl2 = a.scale * kLog2e;

  constexpr int NJ = D / 8;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ks/Vs/dSs reads are done
    stage_t<T, D>(Ks, kb, a.sk.l, k0, lk);
    stage_t<T, D>(Vs, vb, a.sv.l, k0, lk);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; ++c) {
      float qv[4], dov[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[c * kLd + tr + 16 * i];
        dov[i] = dOs[c * kLd + tr + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = Ks[c * kLd + tc + 8 * j];
        vv[j] = Vs[c * kLd + tc + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tc + 8 * j;
        const bool ok = row < lq && col < kv_lim &&
                        (!a.causal || col <= row + offset);
        const float p = ok ? exp2f(s[i][j] * sl2 - lse_s[r]) : 0.f;
        dSs[r * kLd + tc + 8 * j] = p * (dp[i][j] - dl_s[r]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(tr + 16 * i) * kLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kk = Ks[(tc + 8 * j) * kLd + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kk, acc[i][j]);
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= lq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dqb[row * a.sdq.l + tc + 8 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  // Ks, Vs, Qs, dOs [D][kLd]; Ps, dSs [kBK][kLd]
  return sizeof(float) * (4 * (size_t)D * kLd + 2 * (size_t)kBK * kLd);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  float* Ks = smem;            // [D][kLd], keys of this block
  float* Vs = Ks + D * kLd;    // [D][kLd]
  float* Qs = Vs + D * kLd;    // [D][kLd], the current query tile
  float* dOs = Qs + D * kLd;   // [D][kLd]
  float* Ps = dOs + D * kLd;   // [kBK][kLd], P^T
  float* dSs = Ps + kBK * kLd; // [kBK][kLd], dS^T
  __shared__ float lse_s[kBQ], dl_s[kBQ];

  const int tid = threadIdx.x;
  const int tr = tid >> 3;     // keys tr + 16*i
  const int tc = tid & 7;      // query rows tc + 8*j (S), columns (dK, dV)
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kBK;
  const int lq = a.lq, lk = a.lk;
  const int offset = lk - lq;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;

  stage_t<T, D>(Ks, kb, a.sk.l, k0, lk);
  stage_t<T, D>(Vs, vb, a.sv.l, k0, lk);

  // query tiles that see these keys: none if every key is at or past
  // kv_len; for causal from the first row r with k0 <= r + offset
  const int kv_lim = min(a.kv_len, lk);
  const int n_q = (lq + kBQ - 1) / kBQ;
  int first = 0;
  if (a.causal) first = max(0, k0 - offset) / kBQ;
  if (k0 >= kv_lim) first = n_q;
  const float sl2 = a.scale * kLog2e;

  constexpr int NJ = D / 8;
  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs reads are done
    stage_t<T, D>(Qs, qb, a.sq.l, q0, lq);
    stage_t<T, D>(dOs, dob, a.sdo.l, q0, lq);
    stage_rows(lse_s, dl_s, a.lse, a.delta, (size_t)bh * lq, q0, lq);
    __syncthreads();

    // S^T and dP^T for keys tr + 16*i, query rows tc + 8*j
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; ++c) {
      float kv[4], vv[4], qv[8], dov[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[c * kLd + tr + 16 * i];
        vv[i] = Vs[c * kLd + tr + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qv[j] = Qs[c * kLd + tc + 8 * j];
        dov[j] = dOs[c * kLd + tc + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const int key = k0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qr = tc + 8 * j;
        const int row = q0 + qr;
        const bool ok = row < lq && key < kv_lim &&
                        (!a.causal || key <= row + offset);
        const float p = ok ? exp2f(s[i][j] * sl2 - lse_s[qr]) : 0.f;
        Ps[r * kLd + qr] = p;
        dSs[r * kLd + qr] = p * (dp[i][j] - dl_s[qr]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBQ; ++c) {
      float pv[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(tr + 16 * i) * kLd + c];
        ds[i] = dSs[(tr + 16 * i) * kLd + c];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float dov = dOs[(tc + 8 * j) * kLd + c];
        const float qv = Qs[(tc + 8 * j) * kLd + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][j] = fmaf(pv[i], dov, acc_v[i][j]);
          acc_k[i][j] = fmaf(ds[i], qv, acc_k[i][j]);
        }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  T* dvb = static_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr + 16 * i;
    if (key >= lk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkb[key * a.sdk.l + tc + 8 * j] = from_f32<T>(acc_k[i][j]);
      dvb[key * a.sdv.l + tc + 8 * j] = from_f32<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, int B, cudaStream_t s) {
  constexpr size_t smem = dq_smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.H, (a.lq + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, cudaStream_t s) {
  constexpr size_t smem = dkv_smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.H, (a.lk + kBK - 1) / kBK);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dkv, const BwdArgs& a, int B, int d,
                     cudaStream_t s) {
  if (d == 64)
    return dkv ? launch_dkv<T, 64>(a, B, s) : launch_dq<T, 64>(a, B, s);
  if (d == 128)
    return dkv ? launch_dkv<T, 128>(a, B, s) : launch_dq<T, 128>(a, B, s);
  return cudaErrorInvalidValue;
}

int run(bool dkv, const BwdArgs& a, int B, int d, int dtype, int device,
        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || a.H <= 0 || (dkv ? a.lk : a.lq) <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)dispatch<float>(dkv, a, B, d, s);
  if (dtype == kBFloat16) return (int)dispatch<__nv_bfloat16>(dkv, a, B, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mxt

// q: (B, H, lq, d); k, v: (B, H, lk, d); dout and dq: (B, H, lq, d), each
// given by its (batch, head, row) strides in elements with a unit stride on
// d; lse and delta: (B, H, lq) contiguous f32. Returns the CUDA error of the
// launch.
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

// As above, with dk and dv: (B, H, lk, d) given by their strides.
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
