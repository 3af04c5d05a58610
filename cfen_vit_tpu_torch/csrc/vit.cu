// K2: the whole ViT token block on [N,S,E] tokens.
//
// Replaces cfen_vit_tpu/ops/pallas_vit.py _run (kernel _kernel :50-106):
// for every token block [S, E]
//   t1  = (lin(t, enc) + t) + pos
//   src = t1 + lin(attention(lin(ln1(t1), wq|wk|wv)), wo)
//   src = src + lin(relu(lin(ln2(src), l1)), l2)
//   out = lin(relu(lin(src, mh1)), mh2) + src
// with the TPU kernel's rounding points: every linear accumulates in
// float32, adds its bias in float32 and rounds to T once; each residual or
// positional add rounds to T; LayerNorm runs in float32 (biased variance,
// eps 1e-5) and rounds its output to T; the attention scales q (or,
// under bf16, the float32 logits) by 1/sqrt(dh) and rounds p only once,
// after the float32 quotient (attn.cuh, kFused, on the tensor cores).  ops/cuda_vit.py fused_tokens_plain is the same
// arithmetic in plain PyTorch.
//
// Bound on Hopper: operations.  At LViT L3 of the canonical model at batch
// 4 ([16, 256, 384], hidden 1536) the block is 27 GFLOP against 13 MB of
// tokens and weights.  The TPU kernel keeps a whole token block and all of
// its weights in VMEM; on Hopper one [256, 384] block is 393 KB in float32
// against 227 KB of shared memory per SM, the [S, H] MLP hidden 1.5 MB,
// and attention needs every key of its block before any row can go on.
// So this first version cuts the block at its data dependences and keeps
// the intermediates in global scratch (L2-resident at these sizes): eight
// launches on the caller's stream,
//   1. t1   = linear(t,  enc) with epilogue + bias, + t, + pos
//   2. qkv  = linear(t1, [wq; wk; wv]) with the LN1 prologue
//   3. att  = attention over qkv (attn.cuh)
//   4. src  = linear(att, wo) with epilogue + t1
//   5. hid  = linear(src, l1) with the LN2 prologue, epilogue + bias, relu
//   6. src2 = linear(hid, l2) with epilogue + bias, + src   (into t1's slot)
//   7. hid  = linear(src2, mh1) with epilogue + bias, relu
//   8. out  = linear(hid, mh2) with epilogue + bias, + src2
// The linears are one hand-written tiled kernel: 64x64 output tiles, k in
// steps of 16 through shared memory, a 4x4 register tile per thread with
// strided rows and columns (conflict-free shared reads, coalesced
// stores), scalar float32 FMA in both dtypes.  The pre-norm LayerNorm runs
// in the linear's prologue: the block takes the float32 mean and variance
// of its 64 rows first, then normalises each A element as it loads it.
// Tensor cores (wgmma from a TMA-fed ring), thread-block clusters and
// fusing the MLP hidden into column chunks are later work.
#include "attn.cuh"
#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr float kLnEps = 1e-5f;

// One linear c = a w^T (w in torch's [out, in] layout) with its prologue
// and epilogue; a null pointer switches a stage off.
template <typename T>
struct Linear {
  const T* a;
  int lda;
  const T* w;
  T* c;
  int ldc, m, n, k;
  const T* ln_g;   // LayerNorm of a's rows (over k) before the product
  const T* ln_b;
  const T* bias;   // [n], added in float32 before the rounding
  bool relu;
  const T* res;    // [m, n] residual added after the rounding, row stride ldc
  const T* pos;    // [seq, n] positional rows, row r % seq
  int seq;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) linear_kernel(const Linear<T> p) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float ws[kBK][kBN + 4];
  __shared__ float mu[kBM], rstd[kBM];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const bool ln = p.ln_g != nullptr;

  if (ln) {  // one warp per row: float32 mean, then the biased variance
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < kBM; r += kThreads / 32) {
      const int gr = row0 + r;
      float mean = 0.f, var = 0.f;
      if (gr < p.m) {
        const T* x = p.a + static_cast<size_t>(gr) * p.lda;
        float sum = 0.f;
        for (int j = lane; j < p.k; j += 32) sum += cfen::to_f(x[j]);
        mean = cfen::attn::warp_sum(sum) / p.k;
        float sq = 0.f;
        for (int j = lane; j < p.k; j += 32) {
          const float d = cfen::to_f(x[j]) - mean;
          sq = fmaf(d, d, sq);
        }
        var = cfen::attn::warp_sum(sq) / p.k;
      }
      if (lane == 0) {
        mu[r] = mean;
        rstd[r] = rsqrtf(var + kLnEps);
      }
    }
    __syncthreads();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      float val = 0.f;
      if (gr < p.m && gk < p.k) {
        val = cfen::to_f(p.a[static_cast<size_t>(gr) * p.lda + gk]);
        if (ln) {
          const float y = (val - mu[r]) * rstd[r];
          val = cfen::round_to<T>(y * cfen::to_f(p.ln_g[gk]) + cfen::to_f(p.ln_b[gk]));
        }
      }
      as[kk][r] = val;
    }
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int c = i / kBK, kk = i % kBK;
      const int gc = col0 + c, gk = k0 + kk;
      ws[kk][c] = (gc < p.n && gk < p.k)
                      ? cfen::to_f(p.w[static_cast<size_t>(gc) * p.k + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= p.n) continue;
      float y = acc[i][j];
      if (p.bias) y += cfen::to_f(p.bias[c]);
      y = cfen::round_to<T>(y);
      if (p.relu) y = fmaxf(y, 0.f);
      const size_t at = static_cast<size_t>(r) * p.ldc + c;
      if (p.res) y = cfen::round_to<T>(y + cfen::to_f(p.res[at]));
      if (p.pos) y = cfen::round_to<T>(y + cfen::to_f(p.pos[static_cast<size_t>(r % p.seq) * p.n + c]));
      p.c[at] = cfen::from_f<T>(y);
    }
  }
}

template <typename T>
cudaError_t linear(const T* a, int lda, const T* w, T* c, int m, int n, int k,
                   cudaStream_t stream, const T* ln_g = nullptr, const T* ln_b = nullptr,
                   const T* bias = nullptr, bool relu = false, const T* res = nullptr,
                   const T* pos = nullptr, int seq = 1) {
  const Linear<T> p{a, lda, w, c, n, m, n, k, ln_g, ln_b, bias, relu, res, pos, seq};
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  linear_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// w: the 17 weights in ops/cuda_vit.py FusedWeights order; scratch holds
// n*s*(6e + h) elements of T (plus 3 n s (e + heads) at an odd bf16 head
// dim: the padded q, k and v).
template <typename T>
cudaError_t vit_forward(const T* t, const void* const* wp, T* out, T* scratch, int n, int s,
                        int e, int h, int heads, cudaStream_t st) {
  const T* w[17];
  for (int i = 0; i < 17; ++i) w[i] = static_cast<const T*>(wp[i]);
  const T *enc_w = w[0], *enc_b = w[1], *pos = w[2], *ln1g = w[3], *ln1b = w[4];
  const T *in_proj = w[5], *wo = w[6], *ln2g = w[7], *ln2b = w[8];
  const T *l1w = w[9], *l1b = w[10], *l2w = w[11], *l2b = w[12];
  const T *mh1w = w[13], *mh1b = w[14], *mh2w = w[15], *mh2b = w[16];
  const int m = n * s;
  const size_t me = static_cast<size_t>(m) * e;
  T* t1 = scratch;         // [m, e], later src2
  T* qkv = t1 + me;        // [m, 3e]
  T* att = qkv + 3 * me;   // [m, e]
  T* src = att + me;       // [m, e]
  T* hid = src + me;       // [m, h]
  cudaError_t err;
#define CFEN_TRY(call)                  \
  if ((err = (call)) != cudaSuccess) {  \
    return err;                         \
  }
  CFEN_TRY(linear<T>(t, e, enc_w, t1, m, e, e, st, nullptr, nullptr, enc_b, false, t, pos, s));
  CFEN_TRY(linear<T>(t1, e, in_proj, qkv, m, 3 * e, e, st, ln1g, ln1b));
  const int dh = e / heads;
  if (sizeof(T) == 2 && dh % 2 == 1) {
    // an odd bf16 head dim: each head of q, k and v padded by one zero
    // column, so cp.async's 4-byte chunks divide its rows
    T* qkvp = hid + static_cast<size_t>(m) * h;   // [m, 3 heads (dh + 1)]
    const int hs = dh + 1, ld = 3 * heads * hs;
    CFEN_TRY(cfen::attn::pad_heads<T>(qkv, qkvp, m, 3 * e, 3 * heads, dh, st));
    CFEN_TRY((cfen::attn::dispatch_dh<T, true>(qkvp, qkvp + heads * hs, qkvp + 2 * heads * hs,
                                               att, n, s, ld, e, heads, dh, hs, st)));
  } else {
    CFEN_TRY((cfen::attn::dispatch_dh<T, true>(qkv, qkv + e, qkv + 2 * e, att, n, s, 3 * e, e,
                                               heads, dh, dh, st)));
  }
  CFEN_TRY(linear<T>(att, e, wo, src, m, e, e, st, nullptr, nullptr, nullptr, false, t1));
  CFEN_TRY(linear<T>(src, e, l1w, hid, m, h, e, st, ln2g, ln2b, l1b, true));
  CFEN_TRY(linear<T>(hid, h, l2w, t1, m, e, h, st, nullptr, nullptr, l2b, false, src));
  CFEN_TRY(linear<T>(t1, e, mh1w, hid, m, h, e, st, nullptr, nullptr, mh1b, true));
  CFEN_TRY(linear<T>(hid, h, mh2w, out, m, e, h, st, nullptr, nullptr, mh2b, false, t1));
#undef CFEN_TRY
  return cudaSuccess;
}

}  // namespace

// t, out: contiguous [n, s, e]; w: 17 weight pointers (see vit_forward);
// scratch: n*s*(6e + h) elements (plus n*s*3*(e + heads) at an odd bf16
// head dim); heads divides e; dtype per cfen::DType.
extern "C" int cfen_vit_fwd(const void* t, const void* const* w, void* out, void* scratch,
                            int n, int s, int e, int h, int heads, int dtype, void* stream) {
  if (n <= 0 || s <= 0 || e <= 0 || h <= 0 || heads <= 0 || e % heads != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32)
    return vit_forward<float>(static_cast<const float*>(t), w, static_cast<float*>(out),
                              static_cast<float*>(scratch), n, s, e, h, heads, st);
  if (dtype == cfen::kBFloat16)
    return vit_forward<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(t), w,
                                      static_cast<__nv_bfloat16*>(out),
                                      static_cast<__nv_bfloat16*>(scratch), n, s, e, h,
                                      heads, st);
  return cudaErrorInvalidValue;
}
