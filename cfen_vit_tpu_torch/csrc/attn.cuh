// Block attention core shared by K1 (csrc/attn.cu) and K2 (csrc/vit.cu):
// non-causal softmax(Q K^T / sqrt(dh)) V for all heads of [N,S,E] tokens.
// A redesign of the port's first K1 kernel (scalar float32 FMA from shared
// memory, two shared reads per FMA) that puts both products on the tensor
// cores.
//
// The two callers round at different places, and the kernel follows each:
//   K1 (kFused false) as models/vit.py attention_core: q scaled and
//      rounded to T before the product; logits, max, exp and sum float32;
//      under bf16 the exp values and their sum rounded to bf16 and their
//      quotient rounded again;
//   K2 (kFused true) as pallas_vit.py _kernel (:86-93): q cast to float32
//      before the scale, the softmax divided in float32 and rounded once.
//      A bf16 product cannot take the unrounded float32 q * scale, so
//      under bf16 K2 multiplies raw q by k and scales the float32 logits
//      (the same value up to one float32 rounding); in float32 it scales q
//      first, as the TPU kernel does.
// q, k and v are read with the row stride ld_in (K2 reads them out of one
// packed [rows, 3E] projection), the output written with ld_out.
//
// Bound on Hopper: QK^T and PV are 4 N S^2 E operations against 4 N S E
// elements of traffic, so at the model's shapes (S <= 256) the tensor
// cores' rate and the latency of one short product per head bound it,
// not device memory.
//
// Design: FlashAttention-2's warp layout on mma.sync.  A block of 4 warps
// owns 64 query rows of one (row n, head); each warp owns 16 of them.
// K and V come into shared memory in tiles of TK keys (64, or 32 where
// two 64-key slots each of K and V do not fit: float32 at dh above 128)
// with cp.async (zero-filled past S, so the ragged edge adds nothing).
// When every tile has a slot (S <= kSlots TK: 256 keys up to dh 96 and
// bf16 dh 192, fewer above as shared memory allows) the raw queries with
// all of K, then all of V, are requested at once (each warp scales its
// queries as it reads their fragments), and the two passes below run
// without a barrier between tiles.  Longer S streams two slots each of K
// and V, double-buffered, once per pass; any S runs that way.
// Head dims: the kernel is instantiated at DH in {8, 16, 24, 32, 48, 64,
// 96, 128, 192, 256}; a head dim dh <= 256 runs in the smallest DH >= dh,
// its columns past dh zero in shared memory (they add nothing to Q K^T, and
// the output's are not stored), with the scale 1/sqrt(dh) of the true dh
// from the launcher.  A wider head runs in attn_wide_kernel (below).
// Every load is a cp.async, in chunks of 16 bytes, or of 8 or 4 where a
// head's row, the row stride or the address of q, k or v is not a 16-byte
// multiple (bf16 dh 6 and 12; K2's packed projection at such an E); the
// zero fill past S and past dh is cp.async's own.  The inputs' heads lie
// hs >= dh elements apart: an odd bf16 dh, whose rows no chunk of 4 bytes
// divides, comes as a copy with each head padded by one zero column
// (hs = dh + 1; the K1 wrapper pads, K2 runs pad_heads), and the
// launcher refuses what 4 bytes still do not divide.  The K1 wrapper
// copies an input that does not start on 16 bytes.
// The softmax must see the final row max and sum before any probability
// is rounded (the bf16 rounding points above), so the output cannot be
// rescaled online; instead pass 1 runs QK^T over every tile and keeps the
// row max and an online-rescaled float32 sum (the sum only, which no
// rounding point sees before it is final), and pass 2 forms the same
// logits again, rounds the probabilities where the plain version does,
// and feeds them from the accumulator registers straight into the A
// fragments of the PV product.  No logit touches shared memory.  The
// exponentials run in base 2 on the logits times log2(e) (one MUFU ex2
// each, about 2 ulp), and the quotient is a product with the rounded
// reciprocal of the sum (within an ulp of the division, before the
// rounding to T): the per-logit work, not the products, is what the
// short dh leaves to be bound by.
//   bf16: m16n8k16 products with float32 accumulation; dh 24 takes one
//   k16 and one k8 step; V's B fragments come from ldmatrix.trans.
//   float32: 3xTF32 (x = hi + lo, both TF32; hi*hi + hi*lo + lo*hi on
//   m16n8k8).  One TF32 pass keeps 11 bits of each operand and misses
//   K1's float32 tolerance (atol 1e-4, rtol 1e-5; see
//   tests/test_torch_port_tf32_split.py); the split keeps about 22 bits,
//   within float32 summation-order noise, at three times the TF32 work,
//   still under the FFMA cost of the old kernel.  In PV the 8 keys of a
//   k8 step are taken in the order (0, 2, 4, 6, 1, 3, 5, 7), so that the
//   accumulator layout of the logits is the A fragment as it stands.
// wgmma is not used: its 64-row warpgroup tile and 16-deep k step give a
// k-extent of 24 (LViT) and S <= 256 keys per head little to pipeline,
// while mma.sync's 16-row tiles fit one warp's share of a head.
// Shared-memory rows are padded to 4 mod 8 32-bit words, so the fragment
// loads of a warp (8 rows x 4 words) hit 32 distinct banks.
#pragma once

#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace cfen {
namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQB = 16 * kWarps;  // query rows per block
constexpr int kMaxDH = 256;       // the largest head dim dispatch_dh takes

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// across the 4 lanes of a quad (the lanes that share accumulator rows)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// bytes of the queries and `slots` tiles of `tk` keys each of K and V, in
// rows of ld elements of elt bytes
constexpr size_t smem_bytes(size_t elt, int ld, int slots, int tk) {
  return elt * ld * (static_cast<size_t>(kQB) + 2 * static_cast<size_t>(slots) * tk);
}

template <typename T, int DH>
struct Layout {
  static constexpr int kWords = DH * static_cast<int>(sizeof(T)) / 4;
  static constexpr int kLdWords = kWords - kWords % 8 + 4;  // 4 mod 8
  static constexpr int LD = kLdWords * 4 / static_cast<int>(sizeof(T));
  // keys per tile: 64, or 32 where two 64-key slots each of K and V do not fit
  static constexpr int TK = smem_bytes(sizeof(T), LD, 2, 64) <= kSmemMax ? 64 : 32;
  static constexpr int kNT = TK / 8;     // 8-key n-tiles of the logits per tile
  static constexpr int kTile = TK * LD;  // elements of one K or V tile
  // K and V tiles held at once when every tile has a slot
  static constexpr int kSlots = smem_bytes(sizeof(T), LD, 4, TK) <= kSmemMax   ? 4
                                : smem_bytes(sizeof(T), LD, 3, TK) <= kSmemMax ? 3
                                                                               : 2;
  static constexpr size_t smem(int slots) { return smem_bytes(sizeof(T), LD, slots, TK); }
};

// Two bf16 queries as the A operand: raw (kScaleQ false) or times the
// scale and rounded to bf16, as the plain version's q * scale is.
template <bool kScaleQ>
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* p, float scale) {
  if (!kScaleQ) return mma::lds32(p);
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return mma::pack_bf16(x.x * scale, x.y * scale);
}

// One warp's logits tile: s[j][.] = q rows (row0 + g, + 8) against the 8
// keys 8j + 2t, 8j + 2t + 1 of the tile kt; the raw queries qs are scaled
// as they are read when kScaleQ.
template <typename T, int DH, bool kScaleQ>
__device__ __forceinline__ void logits_tile(const T* qs, const T* kt, int row0, int g, int t,
                                            float scale, float s[Layout<T, DH>::kNT][4]) {
  constexpr int LD = Layout<T, DH>::LD, kNT = Layout<T, DH>::kNT;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk + 16 <= DH; kk += 16) {
      const T* qa = qs + (row0 + g) * LD + kk + 2 * t;
      const uint32_t a[4] = {q_pair<kScaleQ>(qa, scale), q_pair<kScaleQ>(qa + 8 * LD, scale),
                             q_pair<kScaleQ>(qa + 8, scale),
                             q_pair<kScaleQ>(qa + 8 * LD + 8, scale)};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const T* kb = kt + (8 * j + g) * LD + kk + 2 * t;
        const uint32_t b[2] = {mma::lds32(kb), mma::lds32(kb + 8)};
        mma::bf16_16816(s[j], a, b);
      }
    }
    if constexpr (DH % 16 == 8) {
      constexpr int kk = DH - 8;
      const T* qa = qs + (row0 + g) * LD + kk + 2 * t;
      const uint32_t a[2] = {q_pair<kScaleQ>(qa, scale), q_pair<kScaleQ>(qa + 8 * LD, scale)};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mma::bf16_1688(s[j], a, mma::lds32(kt + (8 * j + g) * LD + kk + 2 * t));
    }
  } else {
    const float qscale = kScaleQ ? scale : 1.f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 8) {
      const float* qa = qs + (row0 + g) * LD + kk + t;
      const float a[4] = {qa[0] * qscale, qa[8 * LD] * qscale, qa[4] * qscale,
                          qa[8 * LD + 4] * qscale};
      uint32_t ah[4], al[4];
      mma::split_n<4>(a, ah, al);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* kb = kt + (8 * j + g) * LD + kk + t;
        const float b[2] = {kb[0], kb[4]};
        uint32_t bh[2], bl[2];
        mma::split_n<2>(b, bh, bl);
        mma::tf32x3_1688(s[j], ah, al, bh, bl);
      }
    }
  }
}

// acc[jd] += p (16 x TK, in the logits' accumulator layout) times the V
// tile vt (TK x DH); under bf16 p is rounded to bf16 as it is packed
template <typename T, int DH>
__device__ __forceinline__ void pv_tile(const float p[Layout<T, DH>::kNT][4], const T* vt,
                                        int lane, int g, int t, float acc[DH / 8][4]) {
  constexpr int LD = Layout<T, DH>::LD, kNT = Layout<T, DH>::kNT;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t a[4] = {mma::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             mma::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             mma::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             mma::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      const T* vrow = vt + (16 * kk + (lane & 15)) * LD;
#pragma unroll
      for (int jd = 0; jd < DH / 8; ++jd) {
        uint32_t b[2];
        mma::ldmatrix_x2_trans(b, vrow + 8 * jd);
        mma::bf16_16816(acc[jd], a, b);
      }
    }
  } else {
#pragma unroll
    for (int jk = 0; jk < kNT; ++jk) {
      // k slot t is key 2t, slot t + 4 is key 2t + 1 of this 8-key step
      const float a[4] = {p[jk][0], p[jk][2], p[jk][1], p[jk][3]};
      uint32_t ah[4], al[4];
      mma::split_n<4>(a, ah, al);
      const float* v0 = vt + (8 * jk + 2 * t) * LD + g;
#pragma unroll
      for (int jd = 0; jd < DH / 8; ++jd) {
        const float b[2] = {v0[8 * jd], v0[LD + 8 * jd]};
        uint32_t bh[2], bl[2];
        mma::split_n<2>(b, bh, bl);
        mma::tf32x3_1688(acc[jd], ah, al, bh, bl);
      }
    }
  }
}

// 2^x, one MUFU instruction (about 2 ulp); -inf gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// dh: the true head dim (<= DH); the loads move 16 >> shift bytes each
template <typename T, int DH, bool kFused>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int s, int ld_in, int ld_out, int heads, int dh, int hs,
            float scale, int slots, int shift) {
  using L = Layout<T, DH>;
  constexpr int LD = L::LD, TK = L::TK, kNT = L::kNT;
  constexpr bool kScaleLogits = kFused && sizeof(T) == 2;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kQB][LD] queries
  T* ks = qs + kQB * LD;                   // [slots][TK][LD] K tiles
  T* vs = ks + slots * L::kTile;           // [slots][TK][LD] V tiles

  const int n = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kQB;
  const size_t in_base = static_cast<size_t>(n) * s * ld_in + static_cast<size_t>(h) * hs;
  const size_t out_base = static_cast<size_t>(n) * s * ld_out + static_cast<size_t>(h) * dh;
  const T* kn = k + in_base;
  const T* vn = v + in_base;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;            // the warp's rows within the block
  const bool active = q0 + row0 < s;     // warp-uniform
  const int tiles = (s + TK - 1) / TK;
  // every K and V tile has a slot (S <= slots * TK): each is loaded once,
  // up front; else two slots each, streamed per pass
  const bool resident = tiles <= slots;

  // rows [key0, key0 + rows) of src into dst; zeros past s and in the
  // columns past dh
  auto load = [&](T* dst, const T* src, int key0, int rows) {
    constexpr int kPer16 = DH * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a row
    const int per = kPer16 << shift, elems = (16 / static_cast<int>(sizeof(T))) >> shift;
    for (int i = tid; i < rows * per; i += kThreads) {
      const int r = (i >> shift) / kPer16, c = (i - r * per) * elems;
      const bool ok = key0 + r < s && c < dh;
      mma::cp_async_chunk(dst + r * LD + c,
                          ok ? src + static_cast<size_t>(key0 + r) * ld_in + c : src, ok,
                          shift);
    }
  };
  // the raw queries with the first K group; each warp scales its own as
  // it reads them
  load(qs, q + in_base, q0, kQB);
  if (resident) {
    for (int it = 0; it < tiles; ++it) load(ks + it * L::kTile, kn, it * TK, TK);
    mma::cp_async_commit();
    for (int it = 0; it < tiles; ++it) load(vs + it * L::kTile, vn, it * TK, TK);
  } else {
    load(ks, kn, 0, TK);
  }
  mma::cp_async_commit();

  // the warp's logits against tile it in kt, -inf past s; exp(l - m) is
  // then 2^(l c - m c) with c = log2(e) (K2 under bf16: times the scale),
  // one FFMA and one ex2
  const float c = kScaleLogits ? scale * kLog2e : kLog2e;
  auto logits = [&](int it, const T* kt, float sc[kNT][4]) {
    logits_tile<T, DH, !kScaleLogits>(qs, kt, row0, g, t, scale, sc);
    if ((it + 1) * TK <= s) return;   // no key past s in this tile
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (it * TK + 8 * j + 2 * t + (e & 1) >= s) sc[j][e] = -INFINITY;
  };

  // pass 1: row max and online-rescaled sum of exp, rows g and g + 8
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int it = 0; it < tiles; ++it) {
    if (!resident) {
      if (it + 1 < tiles) load(ks + ((it + 1) & 1) * L::kTile, kn, (it + 1) * TK, TK);
      mma::cp_async_commit();
    }
    if (!resident || it == 0) {   // resident: the K group, not V's
      mma::cp_async_wait<1>();
      __syncthreads();
    }
    if (active) {
      float sc[kNT][4];
      logits(it, ks + (resident ? it : it & 1) * L::kTile, sc);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float part[kNT];   // pairwise trees: short dependence chains
#pragma unroll
        for (int j = 0; j < kNT; ++j) part[j] = fmaxf(sc[j][2 * hr], sc[j][2 * hr + 1]);
#pragma unroll
        for (int w = kNT / 2; w > 0; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) part[j] = fmaxf(part[j], part[j + w]);
        const float mnew = fmaxf(mx[hr], quad_max(part[0]));
        const float mc = mnew * c;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          part[j] = ex2(fmaf(sc[j][2 * hr], c, -mc)) + ex2(fmaf(sc[j][2 * hr + 1], c, -mc));
#pragma unroll
        for (int w = kNT / 2; w > 0; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) part[j] += part[j + w];
        sum[hr] = sum[hr] * ex2((mx[hr] - mnew) * c) + part[0];
        mx[hr] = mnew;
      }
    }
    if (!resident) __syncthreads();
  }
  // the quotient as a product with the rounded reciprocal: within an ulp
  // of float32 division, before the rounding to T
  float rden[2], mc[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float total = quad_sum(sum[hr]);
    rden[hr] = __frcp_rn(kFused ? total : round_to<T>(total));
    mc[hr] = mx[hr] * c;
  }

  // pass 2: the same logits, probabilities rounded as the plain version
  // rounds them, and P V
  float acc[DH / 8][4];
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;
  if (resident) {
    mma::cp_async_wait<0>();
    __syncthreads();
  } else {
    load(ks, kn, 0, TK);
    load(vs, vn, 0, TK);
    mma::cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    if (!resident) {
      if (it + 1 < tiles) {
        load(ks + ((it + 1) & 1) * L::kTile, kn, (it + 1) * TK, TK);
        load(vs + ((it + 1) & 1) * L::kTile, vn, (it + 1) * TK, TK);
      }
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
      __syncthreads();
    }
    const int slot = resident ? it : it & 1;
    if (active) {
      float p[kNT][4];
      logits(it, ks + slot * L::kTile, p);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the rounding to T is pv_tile's packing (bf16 round to nearest)
          const int hr = e >> 1;
          const float ex = ex2(fmaf(p[j][e], c, -mc[hr]));
          p[j][e] = (kFused ? ex : round_to<T>(ex)) * rden[hr];
        }
      pv_tile<T, DH>(p, vs + slot * L::kTile, lane, g, t, acc);
    }
    if (!resident) __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + row0 + g + 8 * hr;
    if (r >= s) continue;
    T* orow = o + out_base + static_cast<size_t>(r) * ld_out;
#pragma unroll
    for (int jd = 0; jd < DH / 8; ++jd) {
      const int col = 8 * jd + 2 * t;   // dh columns of DH are stored
      if (col < dh) orow[col] = from_f<T>(acc[jd][2 * hr]);
      if (col + 1 < dh) orow[col + 1] = from_f<T>(acc[jd][2 * hr + 1]);
    }
  }
}

// the largest cp.async chunk (16, 8 or 4 bytes, as a shift of 16) that
// divides a head's row stride hs, the row stride and the addresses of q, k
// and v; -1 if none does
template <typename T>
int chunk_shift(const T* q, const T* k, const T* v, int ld_in, int hs) {
  const uintptr_t bits = static_cast<uintptr_t>(hs) * sizeof(T) |
                         static_cast<uintptr_t>(ld_in) * sizeof(T) |
                         reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  return bits % 16 == 0 ? 0 : bits % 8 == 0 ? 1 : bits % 4 == 0 ? 2 : -1;
}

template <typename T, int DH, bool kFused>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, int n, int s, int ld_in,
                   int ld_out, int heads, int dh, int hs, cudaStream_t stream) {
  using L = Layout<T, DH>;
  const int tiles = (s + L::TK - 1) / L::TK;
  const int slots = tiles <= L::kSlots ? tiles : 2;
  // the shared-memory limit is raised once per device
  static bool allowed[64] = {};
  cudaError_t err = allow_smem_once(attn_kernel<T, DH, kFused>, allowed);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  const int shift = chunk_shift(q, k, v, ld_in, hs);
  if (shift < 0) return cudaErrorMisalignedAddress;
  dim3 grid(n * heads, (s + kQB - 1) / kQB);
  attn_kernel<T, DH, kFused><<<grid, kThreads, L::smem(slots), stream>>>(
      q, k, v, o, s, ld_in, ld_out, heads, dh, hs, scale, slots, shift);
  return cudaGetLastError();
}

// Heads wider than kMaxDH.  The head dim goes through shared memory in
// chunks of kWide columns: for each key tile the block stages the queries'
// and the keys' chunk and sums the chunk's QK^T into the logits registers,
// so Q K^T streams the head dim; the output's columns are split into
// groups of kWide (grid z), each block recomputing the logits for its
// group's P V.  The two passes, the rounding points and the fragment code
// (logits_tile, pv_tile at DH kWide) are attn_kernel's; nothing stays
// resident, and every stage waits for its copies.  No geometry of the
// model has such a head: this path is for what the JAX package's
// attention takes (any dh), not for speed.
constexpr int kWide = 128;

template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
attn_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int s, int ld_in, int ld_out, int heads, int dh, int hs,
                 float scale, int shift) {
  using L = Layout<T, kWide>;
  constexpr int LD = L::LD, TK = L::TK, kNT = L::kNT;
  constexpr bool kScaleLogits = kFused && sizeof(T) == 2;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kQB][LD] a chunk of the queries
  T* ks = qs + kQB * LD;                   // [TK][LD] a chunk of a K tile
  T* vs = ks + L::kTile;                   // [TK][LD] a column group of a V tile

  const int n = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kQB, col0 = blockIdx.z * kWide;
  const size_t in_base = static_cast<size_t>(n) * s * ld_in + static_cast<size_t>(h) * hs;
  const size_t out_base = static_cast<size_t>(n) * s * ld_out + static_cast<size_t>(h) * dh;
  const T* qn = q + in_base;
  const T* kn = k + in_base;
  const T* vn = v + in_base;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;
  const bool active = q0 + row0 < s;
  const int tiles = (s + TK - 1) / TK;

  // rows [key0, key0 + rows), columns [c0, c0 + kWide) of src into dst;
  // zeros past s and past dh
  auto load = [&](T* dst, const T* src, int key0, int rows, int c0) {
    constexpr int kPer16 = kWide * static_cast<int>(sizeof(T)) / 16;
    const int per = kPer16 << shift, elems = (16 / static_cast<int>(sizeof(T))) >> shift;
    for (int i = tid; i < rows * per; i += kThreads) {
      const int r = (i >> shift) / kPer16, c = (i - r * per) * elems;
      const bool ok = key0 + r < s && c0 + c < dh;
      mma::cp_async_chunk(dst + r * LD + c,
                          ok ? src + static_cast<size_t>(key0 + r) * ld_in + c0 + c : src, ok,
                          shift);
    }
  };
  // the warp's logits against key tile it, summed over the head dim's
  // chunks, -inf past s (block-wide: every thread takes part in the loads)
  auto logits = [&](int it, float sc[kNT][4]) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += kWide) {
      __syncthreads();   // the last chunk's reads are done
      load(qs, qn, q0, kQB, c0);
      load(ks, kn, it * TK, TK, c0);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
      if (active) {
        float part[kNT][4];
        logits_tile<T, kWide, !kScaleLogits>(qs, ks, row0, g, t, scale, part);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += part[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (it * TK + 8 * j + 2 * t + (e & 1) >= s) sc[j][e] = -INFINITY;
  };
  const float c = kScaleLogits ? scale * kLog2e : kLog2e;

  // pass 1: row max and online-rescaled sum of exp, as attn_kernel
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int it = 0; it < tiles; ++it) {
    float sc[kNT][4];
    logits(it, sc);
    if (!active) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNT; ++j) m = fmaxf(m, fmaxf(sc[j][2 * hr], sc[j][2 * hr + 1]));
      const float mnew = fmaxf(mx[hr], quad_max(m)), mc = mnew * c;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        part += ex2(fmaf(sc[j][2 * hr], c, -mc)) + ex2(fmaf(sc[j][2 * hr + 1], c, -mc));
      sum[hr] = sum[hr] * ex2((mx[hr] - mnew) * c) + part;
      mx[hr] = mnew;
    }
  }
  float rden[2], mc[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float total = quad_sum(sum[hr]);
    rden[hr] = __frcp_rn(kFused ? total : round_to<T>(total));
    mc[hr] = mx[hr] * c;
  }

  // pass 2: the same logits, the rounded probabilities and P V for the
  // block's column group; the V tile's copy joins the logits' first wait
  float acc[kWide / 8][4];
#pragma unroll
  for (int jd = 0; jd < kWide / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;
  for (int it = 0; it < tiles; ++it) {
    __syncthreads();   // the last tile's P V reads are done
    load(vs, vn, it * TK, TK, col0);
    float p[kNT][4];
    logits(it, p);
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float ex = ex2(fmaf(p[j][e], c, -mc[hr]));
        p[j][e] = (kFused ? ex : round_to<T>(ex)) * rden[hr];
      }
    pv_tile<T, kWide>(p, vs, lane, g, t, acc);
  }

  if (!active) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + row0 + g + 8 * hr;
    if (r >= s) continue;
    T* orow = o + out_base + static_cast<size_t>(r) * ld_out;
#pragma unroll
    for (int jd = 0; jd < kWide / 8; ++jd) {
      const int col = col0 + 8 * jd + 2 * t;
      if (col < dh) orow[col] = from_f<T>(acc[jd][2 * hr]);
      if (col + 1 < dh) orow[col + 1] = from_f<T>(acc[jd][2 * hr + 1]);
    }
  }
}

template <typename T, bool kFused>
cudaError_t launch_wide(const T* q, const T* k, const T* v, T* o, int n, int s, int ld_in,
                        int ld_out, int heads, int dh, int hs, cudaStream_t stream) {
  using L = Layout<T, kWide>;
  static_assert(L::TK == kQB, "the wide kernel's key tile is its query block");
  const size_t smem = sizeof(T) * L::LD * (static_cast<size_t>(kQB) + 2 * L::TK);
  static bool allowed[64] = {};
  cudaError_t err = allow_smem_once(attn_wide_kernel<T, kFused>, allowed);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  const int shift = chunk_shift(q, k, v, ld_in, hs);
  if (shift < 0) return cudaErrorMisalignedAddress;
  dim3 grid(n * heads, (s + kQB - 1) / kQB, (dh + kWide - 1) / kWide);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  attn_wide_kernel<T, kFused><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, s, ld_in, ld_out, heads, dh, hs, scale, shift);
  return cudaGetLastError();
}

// Every head dim: up to kMaxDH in the smallest instantiated DH >= dh, 24
// (LViT) and 96 (GViT) at n_feats 24, 32 and 128 at the defaults (n_feats
// 32), 8 to 256 at the JAX package's other head counts and widths; wider
// heads in attn_wide_kernel.  q, k, v hold each row's heads hs >= dh
// elements apart, ld_in elements a row; o holds them dh apart.
template <typename T, bool kFused>
cudaError_t dispatch_dh(const T* q, const T* k, const T* v, T* o, int n, int s, int ld_in,
                        int ld_out, int heads, int dh, int hs, cudaStream_t stream) {
#define CFEN_ATTN_DH(D)                                                                   \
  if (dh <= D)                                                                            \
  return launch<T, D, kFused>(q, k, v, o, n, s, ld_in, ld_out, heads, dh, hs, stream)
  if (dh <= 0 || hs < dh) return cudaErrorInvalidValue;
  CFEN_ATTN_DH(8);
  CFEN_ATTN_DH(16);
  CFEN_ATTN_DH(24);
  CFEN_ATTN_DH(32);
  CFEN_ATTN_DH(48);
  CFEN_ATTN_DH(64);
  CFEN_ATTN_DH(96);
  CFEN_ATTN_DH(128);
  CFEN_ATTN_DH(192);
  CFEN_ATTN_DH(kMaxDH);
#undef CFEN_ATTN_DH
  return launch_wide<T, kFused>(q, k, v, o, n, s, ld_in, ld_out, heads, dh, hs, stream);
}

// rows x (groups heads of dh) at row stride ld_src -> rows x (groups heads
// of dh + 1), each head's last column zero: an odd bf16 head dim made
// even for cp.async's 4-byte chunks (K2's packed projection)
template <typename T>
__global__ void pad_heads_kernel(const T* __restrict__ src, T* __restrict__ dst, int rows,
                                 int ld_src, int groups, int dh) {
  const int hs = dh + 1, width = groups * hs;
  const size_t total = static_cast<size_t>(rows) * width;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / width;
    const int col = static_cast<int>(i - r * width), head = col / hs, j = col - head * hs;
    dst[i] = j < dh ? src[r * ld_src + static_cast<size_t>(head) * dh + j] : from_f<T>(0.f);
  }
}

template <typename T>
cudaError_t pad_heads(const T* src, T* dst, int rows, int ld_src, int groups, int dh,
                      cudaStream_t stream) {
  const size_t total = static_cast<size_t>(rows) * groups * (dh + 1);
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 65535));
  pad_heads_kernel<T><<<blocks, 256, 0, stream>>>(src, dst, rows, ld_src, groups, dh);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace cfen
