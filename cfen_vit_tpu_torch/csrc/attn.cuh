// Block attention core shared by K1 (csrc/attn.cu) and K2 (csrc/vit.cu):
// non-causal softmax(Q K^T / sqrt(dh)) V for all heads of [N,S,E] tokens.
//
// The two callers round at different places, and the kernel follows each:
//   K1 (kFused false) as models/vit.py attention_core: q scaled in T, the
//      exp values and their sum rounded to T, their quotient rounded again;
//   K2 (kFused true) as pallas_vit.py _kernel (:86-93): q cast to float32
//      before the scale, the softmax divided in float32 and rounded once.
// q, k and v are read with the row stride ld_in (K2 reads them out of one
// packed [rows, 3E] projection), the output written with ld_out.
//
// Bound on Hopper: shared-memory traffic.  S <= 256 and dh is 24 or 96, so
// the S x S logits of one head are small, but every logit and every P V
// term reads two shared-memory floats for one FMA.  Design: one block per
// (row n, head, 32-query chunk), 128 threads; the chunks of one (row,
// head) run as separate blocks so that the GViT blocks (4 rows x 4 heads
// at batch 4) still give the 132 SMs work.  Pass 1 streams K through
// shared memory in 64-key tiles and writes the chunk's logits into shared
// memory ([32, S] floats, 32 KB at S = 256; with the tiles that exceeds
// the default 48 KB, so the launch raises the kernel's dynamic shared
// memory limit); a warp per row then takes the exact row max, the exp
// values and their sum, and the probabilities.
// Pass 2 streams V the same way and accumulates P V in registers (dh/4 per
// thread).  Two passes over the keys, no online rescaling, so bf16 rounds
// where the plain versions round.  Tiles are padded to dh+1 floats (odd)
// so the lanes of a warp hit distinct banks.  Nothing uses the tensor
// cores yet: dh = 24 is not a multiple of wgmma's 16-wide k step, which a
// later wgmma version has to pad.
#pragma once

#include <math.h>

#include "common.cuh"

namespace cfen {
namespace attn {

constexpr int kThreads = 128;
constexpr int kQB = 32;  // query rows per block
constexpr int kTK = 64;  // keys per shared-memory tile

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int DH, bool kFused>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int s, int ld_in, int ld_out, int heads, float scale) {
  static_assert(DH % 4 == 0, "kQB * DH must be a multiple of kThreads");
  constexpr int LD = DH + 1;
  extern __shared__ float smem[];
  float* qs = smem;             // [kQB][LD] scaled queries
  float* kv = qs + kQB * LD;    // [kTK][LD] K tile, then V tile
  float* ps = kv + kTK * LD;    // [kQB][s]  logits, then probabilities

  const int n = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kQB;
  const int rows = min(kQB, s - q0);
  const size_t in_base = static_cast<size_t>(n) * s * ld_in + static_cast<size_t>(h) * DH;
  const size_t out_base = static_cast<size_t>(n) * s * ld_out + static_cast<size_t>(h) * DH;
  const int tid = threadIdx.x;

  for (int i = tid; i < kQB * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float val = 0.f;
    if (r < rows) val = to_f(q[in_base + static_cast<size_t>(q0 + r) * ld_in + d]);
    qs[r * LD + d] = kFused ? val * scale : round_to<T>(val * scale);
  }

  // pass 1: logits of the chunk against every key
  for (int k0 = 0; k0 < s; k0 += kTK) {
    const int kn = min(kTK, s - k0);
    __syncthreads();
    for (int i = tid; i < kn * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      kv[r * LD + d] = to_f(k[in_base + static_cast<size_t>(k0 + r) * ld_in + d]);
    }
    __syncthreads();
    for (int i = tid; i < rows * kn; i += kThreads) {
      const int r = i / kn, c = i % kn;
      const float* qr = qs + r * LD;
      const float* kc = kv + c * LD;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(qr[d], kc[d], acc);
      ps[r * s + k0 + c] = acc;
    }
  }
  __syncthreads();

  // softmax, one warp per row: f32 max, exp and sum
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* row = ps + r * s;
    float m = -INFINITY;
    for (int j = lane; j < s; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < s; j += 32) {
      const float ex = expf(row[j] - m);
      row[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    if (kFused) {
      for (int j = lane; j < s; j += 32) row[j] = round_to<T>(row[j] / sum);
    } else {
      const float den = round_to<T>(sum);
      for (int j = lane; j < s; j += 32) row[j] = round_to<T>(round_to<T>(row[j]) / den);
    }
  }

  // pass 2: P V, each thread owning DH/4 outputs of the chunk
  constexpr int kAcc = kQB * DH / kThreads;
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  for (int k0 = 0; k0 < s; k0 += kTK) {
    const int kn = min(kTK, s - k0);
    __syncthreads();
    for (int i = tid; i < kn * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      kv[r * LD + d] = to_f(v[in_base + static_cast<size_t>(k0 + r) * ld_in + d]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int i = tid + a * kThreads;
      const int r = i / DH, d = i % DH;
      const float* pr = ps + r * s + k0;
      float sum = acc[a];
      for (int c = 0; c < kn; ++c) sum = fmaf(pr[c], kv[c * LD + d], sum);
      acc[a] = sum;
    }
  }
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int i = tid + a * kThreads;
    const int r = i / DH, d = i % DH;
    if (r < rows) o[out_base + static_cast<size_t>(q0 + r) * ld_out + d] = from_f<T>(acc[a]);
  }
}

template <typename T, int DH, bool kFused>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, int n, int s, int ld_in,
                   int ld_out, int heads, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kQB + kTK) * (DH + 1) + static_cast<size_t>(kQB) * s);
  cudaError_t err = allow_smem(attn_kernel<T, DH, kFused>, smem);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  dim3 grid(n * heads, (s + kQB - 1) / kQB);
  attn_kernel<T, DH, kFused><<<grid, kThreads, smem, stream>>>(q, k, v, o, s, ld_in, ld_out,
                                                               heads, scale);
  return cudaGetLastError();
}

// head dims of the v3 model: 24 (LViT) and 96 (GViT) at n_feats 24,
// 16 and 64 at the tests' tiny geometry
template <typename T, bool kFused>
cudaError_t dispatch_dh(const T* q, const T* k, const T* v, T* o, int n, int s, int ld_in,
                        int ld_out, int heads, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16, kFused>(q, k, v, o, n, s, ld_in, ld_out, heads, stream);
    case 24: return launch<T, 24, kFused>(q, k, v, o, n, s, ld_in, ld_out, heads, stream);
    case 64: return launch<T, 64, kFused>(q, k, v, o, n, s, ld_in, ld_out, heads, stream);
    case 96: return launch<T, 96, kFused>(q, k, v, o, n, s, ld_in, ld_out, heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace cfen
