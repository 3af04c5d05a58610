// K1: block attention, softmax(Q K^T / sqrt(dh)) V for all heads of [N,S,E].
//
// Replaces cfen_vit_tpu/ops/pallas_attn.py fused_block_attention (kernel
// _attn_kernel); computes what models/vit.py attention_core computes,
// including its bf16 rounding: exp values stored in bf16 and divided by the
// bf16 denominator, the quotient rounded to bf16 before P V.
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
// where attention_core rounds.  Tiles are padded to dh+1 floats (odd) so
// the lanes of a warp hit distinct banks.  Nothing uses the tensor cores
// yet: dh = 24 is not a multiple of wgmma's 16-wide k step, which a later
// wgmma version has to pad.
#include <math.h>

#include "common.cuh"

namespace {

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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int s, int e, int heads, float scale) {
  static_assert(DH % 4 == 0, "kQB * DH must be a multiple of kThreads");
  constexpr int LD = DH + 1;
  extern __shared__ float smem[];
  float* qs = smem;             // [kQB][LD] scaled queries
  float* kv = qs + kQB * LD;    // [kTK][LD] K tile, then V tile
  float* ps = kv + kTK * LD;    // [kQB][s]  logits, then probabilities

  const int n = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kQB;
  const int rows = min(kQB, s - q0);
  const size_t base = static_cast<size_t>(n) * s * e + static_cast<size_t>(h) * DH;
  const int tid = threadIdx.x;

  // attention_core scales q in its own dtype before the f32 dot
  for (int i = tid; i < kQB * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float val = 0.f;
    if (r < rows) val = cfen::to_f(q[base + static_cast<size_t>(q0 + r) * e + d]);
    qs[r * LD + d] = cfen::round_to<T>(val * scale);
  }

  // pass 1: logits of the chunk against every key
  for (int k0 = 0; k0 < s; k0 += kTK) {
    const int kn = min(kTK, s - k0);
    __syncthreads();
    for (int i = tid; i < kn * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      kv[r * LD + d] = cfen::to_f(k[base + static_cast<size_t>(k0 + r) * e + d]);
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

  // softmax, one warp per row: f32 max, exp and sum; probabilities are
  // ex / sum in f32, or bf16(bf16(ex) / bf16(sum)) in bf16
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
    const float den = cfen::round_to<T>(warp_sum(sum));
    for (int j = lane; j < s; j += 32)
      row[j] = cfen::round_to<T>(cfen::round_to<T>(row[j]) / den);
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
      kv[r * LD + d] = cfen::to_f(v[base + static_cast<size_t>(k0 + r) * e + d]);
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
    if (r < rows)
      o[base + static_cast<size_t>(q0 + r) * e + d] = cfen::from_f<T>(acc[a]);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int n, int s,
                   int e, int heads, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kQB + kTK) * (DH + 1) + static_cast<size_t>(kQB) * s);
  cudaError_t err = cfen::allow_smem(attn_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  dim3 grid(n * heads, (s + kQB - 1) / kQB);
  attn_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, e, heads, scale);
  return cudaGetLastError();
}

// head dims of the v3 model: 24 (LViT) and 96 (GViT) at n_feats 24,
// 16 and 64 at the tests' tiny geometry
template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o, int n, int s,
                        int e, int heads, cudaStream_t stream) {
  switch (e / heads) {
    case 16: return launch<T, 16>(q, k, v, o, n, s, e, heads, stream);
    case 24: return launch<T, 24>(q, k, v, o, n, s, e, heads, stream);
    case 64: return launch<T, 64>(q, k, v, o, n, s, e, heads, stream);
    case 96: return launch<T, 96>(q, k, v, o, n, s, e, heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous [n, s, e]; heads divides e; dtype per cfen::DType.
extern "C" int cfen_attn_fwd(const void* q, const void* k, const void* v, void* o, int n,
                             int s, int e, int heads, int dtype, void* stream) {
  if (n <= 0 || s <= 0 || heads <= 0 || e % heads != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32) return dispatch_dh<float>(q, k, v, o, n, s, e, heads, st);
  if (dtype == cfen::kBFloat16)
    return dispatch_dh<__nv_bfloat16>(q, k, v, o, n, s, e, heads, st);
  return cudaErrorInvalidValue;
}
