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
// eps 1e-5) and rounds its output to T; the attention scales q (or, under
// bf16, the float32 logits) by 1/sqrt(dh) and rounds p only once, after
// the float32 quotient (attn.cuh, kFused).  ops/cuda_vit.py
// fused_tokens_plain is the same arithmetic in plain PyTorch.
//
// Bound on Hopper: operations.  The four blocks chip_smoke.py times (the
// canonical model at batch 4) are 94.1 GFLOP against 14 MB of tokens and
// weights; 82.5 GFLOP of it are the linears, the rest QK^T and PV.  The
// TPU kernel keeps a whole token block and its weights in VMEM; on Hopper
// one [256, 384] block is 393 KB in float32 against 227 KB of shared
// memory per SM, the [S, H] MLP hidden 1.5 MB, and attention needs every
// key of its block before any row can go on.  So the block is cut at its
// data dependences, the intermediates in global scratch (L2-resident at
// these sizes): ten launches on the caller's stream,
//   1. t1   = linear(t,  enc) with epilogue + bias, + t, + pos
//   2. ln   = layernorm(t1, ln1)
//   3. qkv  = linear(ln, [wq; wk; wv])
//   4. att  = attention over qkv (attn.cuh, K1's kernel)
//   5. src  = linear(att, wo) with epilogue + t1
//   6. ln   = layernorm(src, ln2)
//   7. hid  = linear(ln, l1) with epilogue + bias, relu
//   8. src2 = linear(hid, l2) with epilogue + bias, + src   (into t1's slot)
//   9. hid  = linear(src2, mh1) with epilogue + bias, relu
//  10. out  = linear(hid, mh2) with epilogue + bias, + src2
//
// The linears run on the tensor cores: one kernel, c = a w^T with a [m, k]
// rows (`row` operand) and w in torch's [out, in] layout, which is already
// the `col` operand of mma.sync, so no weight is transposed.  A block is
// 128 x 128 (8 warps of 64 x 32), 128 x 64 (4 of 64 x 32), 64 x 64 (4 of
// 32 x 32) or 64 x 32 (4 of 32 x 16) outputs, chosen per linear from (m,
// n) and the card's SM count (`pick`): the least padded work over the
// tile's measured rate, scaled up where the grid leaves SMs idle (GViT's
// m 1024, LViT L1's n 96).  k goes in stages of 128 bytes of a row (64 bf16,
// 32 float32) through a ring of three shared-memory stages fed by cp.async
// (16-byte chunks, or 8, 4 or, for an odd bf16 row, 2-byte elements
// through registers).  bf16: ldmatrix fragments into m16n8k16 with
// float32 accumulators; a bf16 product is exact in float32, so only the
// summation order differs from the plain version.  float32: 3xTF32 on
// m16n8k8 (cfen::mma::split at fragment load): one TF32 pass misses K2's
// float32 tolerance (tests/test_torch_port_mma_k2_k6.py); each stage's
// products go into a zero accumulator, added to the sum in
// round-to-nearest, since the tensor cores' accumulate truncates.  The
// epilogue stages the float32 tile through shared memory and writes 16
// bytes a thread, reading bias, residual and positional rows alike.
//   The pre-norm LayerNorm is a launch of its own (one warp a row,
// float32 statistics, the normalised row rounded to T into scratch) in
// front of its linear.  In the linear's prologue, normalising each landed
// A stage in place, every column block normalised the same rows again (9
// to 12 times at LViT L3) and the pass held up the product: on the H100
// those two linears took over twice as long as the others of their size.
//   Later work: the MLP hidden fused in column chunks (so [m, H] never
// leaves the SM), fusing the launches, wgmma from a TMA-fed ring, split-k
// for the long-k linears at small m (GViT's k 1536 at m 1024).
#include <algorithm>

#include "attn.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kStages = 3;    // the cp.async ring
constexpr float kLnEps = 1e-5f;

// k a stage: 128 bytes of a row (64 bf16, 32 float32)
template <typename T>
constexpr int kBK = 128 / static_cast<int>(sizeof(T));
// a stage row: kBK elements plus 16 bytes, which keeps rows 16-byte
// aligned and the 8 rows of an ldmatrix (bf16) or of a fragment's scalar
// loads (float32), 144 bytes apart, in distinct banks
template <typename T>
constexpr int kLd = kBK<T> + 16 / static_cast<int>(sizeof(T));

// One linear c = a w^T (a [m, k] and w [n, k], row stride k; c row stride
// n) with its prologue and epilogue; a null pointer switches a stage off.
template <typename T>
struct Linear {
  const T* a;
  const T* w;
  T* c;
  int m, n, k;
  const T* bias;      // [n], added in float32 before the rounding
  bool relu;
  const T* res;       // [m, n] residual added after the rounding
  const T* pos;       // [seq, n] positional rows, row r % seq
  int seq;
  int a_shift, w_shift;   // cp.async chunk 16 >> shift bytes; 3: bf16 elements
  bool vec;               // the epilogue in 16-byte vectors (n and pointers allow it)
};

// The pre-norm LayerNorm of each row of a [m, k] into y, one warp a row:
// the float32 mean, the biased variance about it, then each element
// normalised and its affine applied in float32, rounded to T
template <typename T>
__global__ void __launch_bounds__(256)
layernorm_kernel(const T* __restrict__ a, const T* __restrict__ g, const T* __restrict__ b,
                 int m, int k, T* __restrict__ y) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  if (r >= m) return;
  const T* x = a + static_cast<size_t>(r) * k;
  float sum = 0.f;
  for (int j = lane; j < k; j += 32) sum += cfen::to_f(x[j]);
  const float mean = cfen::attn::warp_sum(sum) / k;
  float sq = 0.f;
  for (int j = lane; j < k; j += 32) {
    const float d = cfen::to_f(x[j]) - mean;
    sq = fmaf(d, d, sq);
  }
  const float rstd = rsqrtf(cfen::attn::warp_sum(sq) / k + kLnEps);
  T* yr = y + static_cast<size_t>(r) * k;
  for (int j = lane; j < k; j += 32) {
    const float v = (cfen::to_f(x[j]) - mean) * rstd;
    yr[j] = cfen::from_f<T>(v * cfen::to_f(g[j]) + cfen::to_f(b[j]));
  }
}

template <typename T>
cudaError_t layernorm(const T* a, const T* g, const T* b, int m, int k, T* y,
                      cudaStream_t stream) {
  layernorm_kernel<T><<<(m + 7) / 8, 256, 0, stream>>>(a, g, b, m, k, y);
  return cudaGetLastError();
}

// rows [0, rows) x k [k0, k0 + kBK) of src (row stride k) into dst, zero
// past `valid` rows and past k
template <typename T, int kThr>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows, int valid, int k0,
                                           int k, int shift, int tid) {
  if (shift == 3) {   // a 2-byte row (odd bf16 k): through registers
    for (int i = tid; i < rows * kBK<T>; i += kThr) {
      const int r = i / kBK<T>, c = i % kBK<T>;
      const bool ok = r < valid && k0 + c < k;
      dst[r * kLd<T> + c] = ok ? src[static_cast<size_t>(r) * k + k0 + c] : cfen::from_f<T>(0.f);
    }
    return;
  }
  const int lg = 4 - shift - (sizeof(T) == 2 ? 1 : 2);   // log2 of the elements a chunk
  const int lc = 3 + shift;                              // log2 of the chunks a row
  for (int i = tid; i < rows << lc; i += kThr) {
    const int r = i >> lc, c = (i & ((1 << lc) - 1)) << lg;
    const bool ok = r < valid && k0 + c < k;   // a chunk lies wholly inside k or past it
    const T* s = ok ? src + static_cast<size_t>(r) * k + k0 + c : src;
    cfen::mma::cp_async_chunk(dst + r * kLd<T> + c, s, ok, shift);
  }
}

// WM x WN warps, each an (16 MT) x (8 NT) tile of c (NT even)
template <typename T, int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(32 * WM * WN) linear_kernel(const Linear<T> p) {
  constexpr int kThr = 32 * WM * WN, BM = 16 * MT * WM, BN = 8 * NT * WN, LD = kLd<T>;
  static_assert(NT % 2 == 0, "B fragments load in pairs of n8 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);   // [kStages][BM][LD]
  T* ws = as + kStages * BM * LD;           // [kStages][BN][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const T* a = p.a + static_cast<size_t>(row0) * p.k;
  const T* w = p.w + static_cast<size_t>(col0) * p.k;
  const int a_valid = min(BM, p.m - row0), w_valid = min(BN, p.n - col0);
  const int steps = (p.k + kBK<T> - 1) / kBK<T>;

  auto load = [&](int kt) {
    const int s = kt % kStages;
    stage_rows<T, kThr>(as + s * BM * LD, a, BM, a_valid, kt * kBK<T>, p.k, p.a_shift, tid);
    stage_rows<T, kThr>(ws + s * BN * LD, w, BN, w_valid, kt * kBK<T>, p.k, p.w_shift, tid);
  };
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < steps) load(kt);
    cfen::mma::cp_async_commit();
  }

  float acc[MT][NT][4] = {};
  for (int kt = 0; kt < steps; ++kt) {
    cfen::mma::cp_async_wait<kStages - 2>();
    __syncthreads();   // step kt has landed; every warp is done with step kt - 1
    const T* at = as + (kt % kStages) * BM * LD;
    const T* wt = ws + (kt % kStages) * BN * LD;
    if (kt + kStages - 1 < steps) load(kt + kStages - 1);   // into step kt - 1's slot
    cfen::mma::cp_async_commit();

    const T* am = at + wm * 16 * MT * LD;
    const T* wn_ = wt + wn * 8 * NT * LD;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < kBK<T>; kk += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          cfen::mma::ldmatrix_x4(af[mt], am + (mt * 16 + (lane & 15)) * LD + kk + 8 * (lane >> 4));
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          // lanes 0-7: n rows 8j.., k kk; 8-15: k kk + 8; 16-31: the next n8 tile
          uint32_t bf[4];
          cfen::mma::ldmatrix_x4(
              bf, wn_ + (j * 8 + (lane & 7) + 8 * (lane >> 4)) * LD + kk + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            cfen::mma::bf16_16816(acc[mt][j], af[mt], bf);
            cfen::mma::bf16_16816(acc[mt][j + 1], af[mt], bf + 2);
          }
        }
      }
    } else {
      float part[MT][NT][4] = {};   // the stage's products (mma::add_rn)
#pragma unroll
      for (int kk = 0; kk < kBK<T>; kk += 8) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const T* r0 = am + (mt * 16 + g) * LD + kk + t;
          const T* r1 = r0 + 8 * LD;
          const float av[4] = {r0[0], r1[0], r0[4], r1[4]};
          cfen::mma::split_n<4>(av, ah[mt], al[mt]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const T* wb = wn_ + (j * 8 + g) * LD + kk + t;
          const float bv[2] = {wb[0], wb[4]};
          uint32_t bh[2], bl[2];
          cfen::mma::split_n<2>(bv, bh, bl);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            cfen::mma::tf32x3_1688(part[mt][j], ah[mt], al[mt], bh, bl);
        }
      }
      cfen::mma::add_rn<MT * NT * 4>(&acc[0][0][0], &part[0][0][0]);
    }
  }

  // The epilogue through shared memory: each warp's float32 sums into a
  // [BM][BN + 4] tile over the stages, then the block sweeps it a row at a
  // time, 16 bytes of T a thread (8 bf16 or 4 float32 columns), so that the
  // bias, residual and positional reads and the output writes coalesce.
  constexpr int CLD = BN + 4;
  float* cs = reinterpret_cast<float*>(smem_raw);
  cfen::mma::cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int j = 0; j < NT; ++j)   // c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
        *reinterpret_cast<float2*>(cs + (wm * 16 * MT + mt * 16 + g + 8 * hr) * CLD +
                                   wn * 8 * NT + j * 8 + 2 * t) =
            make_float2(acc[mt][j][2 * hr], acc[mt][j][2 * hr + 1]);
  __syncthreads();
  constexpr int VE = 16 / sizeof(T);
  // bias in float32, round, relu, then the residual and positional adds
  auto finish = [&](float v, float b, float res, float pos) {
    v = cfen::round_to<T>(v + b);
    if (p.relu) v = fmaxf(v, 0.f);
    if (p.res) v = cfen::round_to<T>(v + res);
    if (p.pos) v = cfen::round_to<T>(v + pos);
    return v;
  };
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < BM * (BN / VE); i += kThr) {
    const int lr = i / (BN / VE), lc = i % (BN / VE) * VE;
    const int r = row0 + lr, c = col0 + lc;
    if (r >= p.m || c >= p.n) continue;
    const size_t at = static_cast<size_t>(r) * p.n + c;
    const size_t pat = p.pos ? static_cast<size_t>(r % p.seq) * p.n + c : 0;
    const float* src = cs + lr * CLD + lc;
    if (p.vec) {   // VE columns inside n, every pointer 16-byte aligned
      const uint4 bv = p.bias ? *reinterpret_cast<const uint4*>(p.bias + c) : zero;
      const uint4 rv = p.res ? *reinterpret_cast<const uint4*>(p.res + at) : zero;
      const uint4 pv = p.pos ? *reinterpret_cast<const uint4*>(p.pos + pat) : zero;
      float v[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e)
        v[e] = finish(src[e], cfen::vec_elem<T>(bv, e), cfen::vec_elem<T>(rv, e),
                      cfen::vec_elem<T>(pv, e));
      uint4 out;
      if constexpr (sizeof(T) == 2)
        out = make_uint4(cfen::mma::pack_bf16(v[0], v[1]), cfen::mma::pack_bf16(v[2], v[3]),
                         cfen::mma::pack_bf16(v[4], v[5]), cfen::mma::pack_bf16(v[6], v[7]));
      else
        out = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                         __float_as_uint(v[3]));
      *reinterpret_cast<uint4*>(p.c + at) = out;
    } else {
      for (int e = 0; e < VE && c + e < p.n; ++e)
        p.c[at + e] = cfen::from_f<T>(
            finish(src[e], p.bias ? cfen::to_f(p.bias[c + e]) : 0.f,
                   p.res ? cfen::to_f(p.res[at + e]) : 0.f,
                   p.pos ? cfen::to_f(p.pos[pat + e]) : 0.f));
    }
  }
}

// the block tiles: warps along m and along n, m16 and n8 tiles a warp,
// and the tile's rate of outputs against the first's, float32 and bf16:
// the first's time over the tile's at LViT L1's four linears (m 65536,
// where every tile fills the card), the geometric mean, as `python -m
// cfen_vit_tpu_torch.bench_conv --mode tiles` measured it on an H100 80GB
// HBM3 at 700 W (PERF.md).  In float32 the 3xTF32 products bound
// every tile alike; in bf16 the larger tile rereads fewer bytes
struct Tile {
  int wm, wn, mt, nt;
  double rate[2];   // float32, bf16
};
constexpr Tile kTiles[] = {{2, 4, 4, 4, {1.0, 1.0}},       // 128 x 128
                           {2, 2, 4, 4, {1.084, 0.744}},   // 128 x 64
                           {2, 2, 2, 4, {1.046, 0.83}},    // 64 x 64
                           {2, 2, 2, 2, {0.907, 0.706}}};  // 64 x 32
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

// the current device's SM count, read once a device
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (counts[dev] == 0) {
    int c = 0;
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = c > 0 ? c : 1;
  }
  return counts[dev];
}

// the tile for an m x n output in T: the least padded work over the
// tile's rate, scaled up where the grid leaves SMs short (an 8-warp block
// a SM, or two 4-warp blocks); ties go to the larger tile
template <typename T>
int pick(int m, int n) {
  const int sms = sm_count();
  int best = 0;
  double best_cost = 0.0;
  for (int i = 0; i < kNumTiles; ++i) {
    const Tile& tl = kTiles[i];
    const int bm = 16 * tl.mt * tl.wm, bn = 8 * tl.nt * tl.wn;
    const double rows = (m + bm - 1) / bm, cols = (n + bn - 1) / bn;
    const double padded = rows * bm * cols * bn / (static_cast<double>(m) * n);
    const double want = sms * 8.0 / (tl.wm * tl.wn);
    const double cost = padded / tl.rate[sizeof(T) == 2] * fmax(1.0, want / (rows * cols));
    if (i == 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best;
}

// the largest cp.async chunk (16 >> shift bytes) that divides a row of k
// elements and p's address; 3 for 2-byte bf16 elements
template <typename T>
inline int chunk_shift(const T* p, int k) {
  const size_t row = static_cast<size_t>(k) * sizeof(T);
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  for (int s = 0; s < 3; ++s) {
    const size_t b = 16 >> s;
    if (row % b == 0 && at % b == 0) return s;
  }
  return 3;
}

template <typename T, int WM, int WN, int MT, int NT>
cudaError_t launch_linear(const Linear<T>& p, cudaStream_t stream) {
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  static bool allowed[64] = {};
  cudaError_t err = cfen::allow_smem_once(linear_kernel<T, WM, WN, MT, NT>, allowed);
  if (err != cudaSuccess) return err;
  const size_t smem = std::max(sizeof(T) * kStages * (BM + BN) * kLd<T>,
                              sizeof(float) * BM * (BN + 4));   // the stages, then the tile
  dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  linear_kernel<T, WM, WN, MT, NT><<<grid, 32 * WM * WN, smem, stream>>>(p);
  return cudaGetLastError();
}

// c = a w^T with its epilogue, on kTiles[tile] (pick's when tile < 0)
template <typename T>
cudaError_t linear(const T* a, const T* w, T* c, int m, int n, int k, cudaStream_t stream,
                   const T* bias = nullptr, bool relu = false, const T* res = nullptr,
                   const T* pos = nullptr, int seq = 1, int tile = -1) {
  const bool vec = n % (16 / sizeof(T)) == 0 && cfen::aligned16(c) &&
                   (!bias || cfen::aligned16(bias)) && (!res || cfen::aligned16(res)) &&
                   (!pos || cfen::aligned16(pos));
  const Linear<T> p{a,   w,   c,   m, n, k, bias, relu, res, pos, seq, chunk_shift(a, k),
                    chunk_shift(w, k), vec};
  switch (tile < 0 ? pick<T>(m, n) : tile) {
#define CFEN_TILE(I)                                                                 \
  case I:                                                                            \
    return launch_linear<T, kTiles[I].wm, kTiles[I].wn, kTiles[I].mt, kTiles[I].nt>( \
        p, stream)
    CFEN_TILE(0);
    CFEN_TILE(1);
    CFEN_TILE(2);
    default:
      CFEN_TILE(3);
#undef CFEN_TILE
  }
}

// w: the 17 weights in ops/cuda_vit.py FusedWeights order; scratch holds
// the intermediates below, each rounded up to 8 elements (ops/cuda_vit.py
// scratch_elems).
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
  // each intermediate starts on 16 bytes, so cp.async takes its rows in
  // the widest chunk the row allows
  T* next = scratch;
  auto take = [&](size_t elems) {
    T* p = next;
    next += (elems + 7) / 8 * 8;
    return p;
  };
  T* t1 = take(me);                               // [m, e], later src2
  T* qkv = take(3 * me);                          // [m, 3e]
  T* att = take(me);                              // [m, e]
  T* src = take(me);                              // [m, e]
  T* hid = take(static_cast<size_t>(m) * h);      // [m, h]
  cudaError_t err;
#define CFEN_TRY(call)                  \
  if ((err = (call)) != cudaSuccess) {  \
    return err;                         \
  }
  CFEN_TRY(linear<T>(t, enc_w, t1, m, e, e, st, enc_b, false, t, pos, s));
  CFEN_TRY(layernorm<T>(t1, ln1g, ln1b, m, e, att, st));   // att is free until step 3
  CFEN_TRY(linear<T>(att, in_proj, qkv, m, 3 * e, e, st));
  const int dh = e / heads;
  if (sizeof(T) == 2 && dh % 2 == 1) {
    // an odd bf16 head dim: each head of q, k and v padded by one zero
    // column, so cp.async's 4-byte chunks divide its rows
    const int hs = dh + 1, ld = 3 * heads * hs;
    T* qkvp = take(static_cast<size_t>(m) * ld);  // [m, 3 heads (dh + 1)]
    CFEN_TRY(cfen::attn::pad_heads<T>(qkv, qkvp, m, 3 * e, 3 * heads, dh, st));
    CFEN_TRY((cfen::attn::dispatch_dh<T, true>(qkvp, qkvp + heads * hs, qkvp + 2 * heads * hs,
                                               att, n, s, ld, e, heads, dh, hs, st)));
  } else {
    CFEN_TRY((cfen::attn::dispatch_dh<T, true>(qkv, qkv + e, qkv + 2 * e, att, n, s, 3 * e, e,
                                               heads, dh, dh, st)));
  }
  CFEN_TRY(linear<T>(att, wo, src, m, e, e, st, nullptr, false, t1));
  CFEN_TRY(layernorm<T>(src, ln2g, ln2b, m, e, att, st));   // and again after step 4
  CFEN_TRY(linear<T>(att, l1w, hid, m, h, e, st, l1b, true));
  CFEN_TRY(linear<T>(hid, l2w, t1, m, e, h, st, l2b, false, src));
  CFEN_TRY(linear<T>(t1, mh1w, hid, m, h, e, st, mh1b, true));
  CFEN_TRY(linear<T>(hid, mh2w, out, m, e, h, st, mh2b, false, t1));
#undef CFEN_TRY
  return cudaSuccess;
}

}  // namespace

// One of K2's linears alone, out = relu(a w^T + bias) (bias may be null)
// on kTiles[tile], or on pick's tile when tile is -1; *used gets the tile.
// a [m, k], w [n, k], out [m, n], contiguous.  For timing the tiles
// (bench_conv --mode tiles).
extern "C" int cfen_vit_linear(const void* a, const void* w, const void* bias, void* out,
                               int m, int n, int k, int tile, int dtype, int* used,
                               void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || tile < -1 || tile >= kNumTiles)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32) {
    *used = tile < 0 ? pick<float>(m, n) : tile;
    return linear<float>(static_cast<const float*>(a), static_cast<const float*>(w),
                         static_cast<float*>(out), m, n, k, st,
                         static_cast<const float*>(bias), true, nullptr, nullptr, 1, *used);
  }
  if (dtype == cfen::kBFloat16) {
    using B = __nv_bfloat16;
    *used = tile < 0 ? pick<B>(m, n) : tile;
    return linear<B>(static_cast<const B*>(a), static_cast<const B*>(w), static_cast<B*>(out),
                     m, n, k, st, static_cast<const B*>(bias), true, nullptr, nullptr, 1,
                     *used);
  }
  return cudaErrorInvalidValue;
}

// t, out: contiguous [n, s, e]; w: 17 weight pointers (see vit_forward);
// scratch: ops/cuda_vit.py scratch_elems elements (6e + h a row, plus 3
// heads (dh + 1) at an odd bf16 head dim, each buffer rounded up to 8);
// heads divides e; dtype per cfen::DType.
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
