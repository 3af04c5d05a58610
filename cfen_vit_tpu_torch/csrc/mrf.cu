// K5: flash-MRF, the ID-MRF divergence of L2-normalised VGG features o, t
// of shape [N, P, C], as three kernels that never hold the [P, P] matrix in
// device memory.
//
// Replaces cfen_vit_tpu/ops/pallas_mrf.py: `_fw_kernel` (via
// `_mrf_forward_stats` :152), `_bwd_do_kernel` and `_bwd_dt_kernel` (via
// `_mrf_backward` :248).  Per batch row n, with cos = o t^T summed in f32:
//
//   cd = max(0.5 - 0.5 cos, 0)    m[q] = min_p cd, p*[q] its first argmin
//   be = exp(2 - 2 cd / (m + 1e-5)),  z[q] = sum_p be,  cs = be / z
//   K[p] = max_q cs, q*[p] its first argmax
//   do-kernel:  do = dcos t,  dm[q] = sum_p 2 be B cd / (m + eps)^2
//   dt-kernel:  dt = dcos^T o
//   dcos = be B / (m + eps) where cos < 1, else 0;
//   B[q,p] = dk [q == q*[p]] / z[q] + dz[q]
//
// Bound on Hopper: operations.  The forward is 2 N P^2 C multiply-adds
// (550 GFLOP for relu3_1 at batch 4), each backward kernel twice that; the
// bytes (o, t and O(N P) statistics) are negligible.
//
// This is a redesign of the port's first K5 kernels, which formed every
// cos tile in scalar float32 FMA from shared memory (six shared reads per
// eight FMAs).  Every cos tile now comes from one routine, `cos_sweep`,
// on the tensor cores with mma.sync: a block's A rows (o) and B rows (t)
// stream through a 4-stage cp.async ring in chunks of 64 bytes of C (32
// bf16 or 16 float32 channels), like a GEMM's k-loop, since a C = 512
// strip does not fit in shared memory; the ring runs on across tiles, so
// a tile's epilogue overlaps the next tile's loads.  bf16 inputs take
// m16n8k16 products with float32 accumulation (the products are exact, as
// before).  float32 inputs take 3xTF32 (hi*hi + hi*lo + lo*hi of TF32
// parts, m16n8k8): one TF32 pass keeps 11 bits of each operand, and when
// o is near t the row min m is small and 1/(m + 1e-5) magnifies cos's
// error past the statistics' 1e-4 bar; tests/test_torch_port_tf32_split.py
// shows both.  mma.sync and not wgmma: one routine has to serve the
// forward's 128-row strips and the backward's 32-row strips, and mma.sync
// reaches the tensor cores from any warp tile without the warpgroup's
// shared-memory descriptors; wgmma is the next step for the forward.
//
// Every kernel forms the same cos bits.  The backward's masks (cos < 1)
// and its exp term must agree with the forward's m and z: when m is near
// 0, a one-ulp disagreement is multiplied by 1/(m + 1e-5).  So every
// kernel calls cos_sweep in one orientation, A = o rows, B = t rows, with
// the same chunk order and the same products per element, whatever its
// tile sizes: dt's strip is t, so it forms the [o tile, t strip] tile and
// transposes it through shared memory.
//
// The exponent divides by the row min, so online (rescaled) sums do not
// apply: m must be final before any of z is summed, and z before any cs.
// The TPU kernel keeps a whole [Sq, P] f32 strip in its 96 MB of VMEM; a
// Hopper block has 227 KB of shared memory.  The forward therefore
// RECOMPUTES the cos tiles in three passes over t (min, then sum, then
// column max) instead of spilling the strip ([N, P, P] f32, 4.3 GB for
// relu3_1 at batch 4) to a global scratch buffer.  A forward block owns
// 128 o rows (8 warps of 32 x 32 in a 128 x 64 tile), and each pass's
// epilogue works on the accumulator fragments: the row min with its index
// and the row sum are taken across the 4 lanes of a quad and the 2 warps
// that share rows; minima compare (value, index) pairs and keep the
// smaller index on a tie, since the fragment layout visits columns out of
// order.
//
// Column max across blocks: blocks run in no order, so the TPU's
// sequential running max over strips does not carry over.  cs >= 0, so
// its float bits order like unsigned ints, and one 64-bit atomicMax on
// (bits(cs) << 32) | (0xFFFFFFFF - q) keeps the max and, on ties, the
// first q.  The wrapper zeroes that buffer and unpacks it.  A block first
// reduces its 128 rows (across the 8 lanes that share a column, then the
// 4 warps) and issues 64 atomics per tile.
//
// The backward kernels keep a strip of 32 rows; their cos tile comes from
// cos_sweep into shared memory, and their dcos product is unchanged: the
// [32, 64] dcos tile stays in shared memory and multiplies the 64-row tile
// held there as float32, scalar FMA, each thread accumulating 4 rows x
// C/32 columns of do (dt) in registers.  do and dt are written in the
// input dtype; the glue adds the rank-1 argmin terms in f32
// (ops/cuda_mrf.py).
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using cfen::mma::cp_async16;
using cfen::mma::lds32;

constexpr int kThreads = 256;  // 8 warps
constexpr int kR = 32;         // backward strip rows per block
constexpr int kT = 64;         // rows of the other operand per tile
constexpr int kRM = kR / 16;   // backward strip rows per thread: ty + 16 i
constexpr int kTN = kT / 16;   // backward tile rows per thread: tx + 16 j
constexpr int kFwdRows = 128;  // forward strip rows per block
constexpr int kStages = 4;     // cp.async ring depth
constexpr int kRowBytes = 80;  // a ring row: 64 bytes of C and 16 of padding
constexpr float kEps = 1e-5f;

// The three expressions every pass and kernel must evaluate identically.
__device__ __forceinline__ float cdist(float cos) {
  return fmaxf(fmaf(-0.5f, cos, 0.5f), 0.f);
}
__device__ __forceinline__ float exp_term(float cd, float m) {
  return expf(fmaf(-2.f, __fdiv_rn(cd, m + kEps), 2.f));
}

// (value, index) a replaces (v, i): smaller value, or the smaller index on
// a tie
__device__ __forceinline__ bool better_min(float a, int ai, float v, int i) {
  return a < v || (a == v && ai < i);
}

// rows [row0, row0 + rows) of src [P, C] into dst [rows][C + 1] as f32;
// rows at or past P are zero
template <typename T, int C>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int row0,
                                          int rows, int p) {
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    float v = 0.f;
    if (row0 + r < p) v = cfen::to_f(src[static_cast<size_t>(row0 + r) * C + c]);
    dst[r * (C + 1) + c] = v;
  }
}

__host__ __device__ constexpr size_t ring_bytes(int bm, int bn) {
  return static_cast<size_t>(kStages) * (bm + bn) * kRowBytes;
}

// The accumulator element e of fragment (mi, nj) of this thread sits at
// tile row frag_row and column frag_col; warps tile [BM, BN] as
// (BM / WM) x (BN / WN), warp-major along the rows.
template <int BM, int WM>
__device__ __forceinline__ int frag_row(int mi, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % (BM / WM)) * WM + 16 * mi + lane / 4 + 8 * (e >> 1);
}
template <int BM, int WM, int WN>
__device__ __forceinline__ int frag_col(int nj, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / (BM / WM)) * WN + 8 * nj + 2 * (lane % 4) + (e & 1);
}

// The one routine that forms cos tiles, on the tensor cores.  Tile i is
// A rows [a_row0 + i a_step, + BM) of a (o, [P, C]) against B rows
// [b_row0 + i b_step, + BN) of b (t, [P, C]), rows at or past P zero,
// summed over c = 0..C-1 in chunks of 64 bytes in order; each element's
// products and their order depend on neither the tile sizes nor its
// position, so every kernel forms the same bits.  After tile i's product,
// epi(i, acc) runs with acc[mi][nj][e] at (frag_row, frag_col); all
// threads call it, so it may synchronise.  The ring runs on across tiles.
template <typename T, int C, int BM, int BN, int WM, int WN, class Epi>
__device__ __forceinline__ void cos_sweep(T* ring, const T* __restrict__ a, int a_row0,
                                          int a_step, const T* __restrict__ b, int b_row0,
                                          int b_step, int p, int tiles, Epi&& epi) {
  constexpr int kElt = static_cast<int>(sizeof(T));
  constexpr int BK = 64 / kElt, LD = kRowBytes / kElt, NK = C / BK;
  constexpr int MI = WM / 16, NJ = WN / 8;
  constexpr int kStage = (BM + BN) * LD;
  static_assert((BM / WM) * (BN / WN) * 32 == kThreads, "one warp tile per warp");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp % (BM / WM), wn = warp / (BM / WM);
  const int total = tiles * NK;

  auto issue = [&](int it) {
    if (it < total) {
      const int tile = it / NK, k0 = (it % NK) * BK;
      T* st = ring + (it % kStages) * kStage;
      const int ar = a_row0 + tile * a_step, br = b_row0 + tile * b_step;
      constexpr int kChunk = 16 / kElt;
      for (int i = tid; i < (BM + BN) * 4; i += kThreads) {
        const int r = i / 4, c = (i % 4) * kChunk;
        const bool is_a = r < BM;
        const int row = is_a ? ar + r : br + r - BM;
        const T* src = is_a ? a : b;
        const bool ok = row < p;
        cp_async16(st + r * LD + c, src + static_cast<size_t>(ok ? row : 0) * C + k0 + c, ok);
      }
    }
    cfen::mma::cp_async_commit();
  };

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  float acc[MI][NJ][4];
  for (int it = 0; it < total; ++it) {
    cfen::mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it % NK == 0) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    }
    const T* as = ring + (it % kStages) * kStage + wm * WM * LD;
    const T* bs = ring + (it % kStages) * kStage + (BM + wn * WN) * LD;
    if constexpr (kElt == 2) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[MI][4], bf[NJ][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const T* pa = as + (16 * mi + g) * LD + kk + 2 * t;
          af[mi][0] = lds32(pa);
          af[mi][1] = lds32(pa + 8 * LD);
          af[mi][2] = lds32(pa + 8);
          af[mi][3] = lds32(pa + 8 * LD + 8);
        }
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          const T* pb = bs + (8 * nj + g) * LD + kk + 2 * t;
          bf[nj][0] = lds32(pb);
          bf[nj][1] = lds32(pb + 8);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) cfen::mma::bf16_16816(acc[mi][nj], af[mi], bf[nj]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[MI][4], al[MI][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const float* pa = as + (16 * mi + g) * LD + kk + t;
          const float x[4] = {pa[0], pa[8 * LD], pa[4], pa[8 * LD + 4]};
          cfen::mma::split_n<4>(x, ah[mi], al[mi]);
        }
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          const float* pb = bs + (8 * nj + g) * LD + kk + t;
          const float x[2] = {pb[0], pb[4]};
          cfen::mma::split_n<2>(x, bh[nj], bl[nj]);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj)
            cfen::mma::tf32x3_1688(acc[mi][nj], ah[mi], al[mi], bh[nj], bl[nj]);
      }
    }
    issue(it + kStages - 1);   // into the stage every thread finished with
    if (it % NK == NK - 1) epi(it / NK, acc);
  }
  cfen::mma::cp_async_wait<0>();
  __syncthreads();
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
mrf_fwd_kernel(const T* __restrict__ o, const T* __restrict__ t, int p, float* __restrict__ m_out,
               float* __restrict__ z_out, long long* __restrict__ pstar_out,
               unsigned long long* __restrict__ colmax) {
  constexpr int BM = kFwdRows, BN = kT, WM = 32, WN = 32, MI = WM / 16, NJ = WN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* red_v = reinterpret_cast<float*>(smem_raw + ring_bytes(BM, BN));  // [2][BM]
  int* red_i = reinterpret_cast<int*>(red_v + 2 * BM);                    // [2][BM]
  float* row_m = reinterpret_cast<float*>(red_i + 2 * BM);                // [BM]
  float* row_z = row_m + BM;                                              // [BM]
  unsigned long long* red_k =                                             // [BM / WM][BN]
      reinterpret_cast<unsigned long long*>(row_z + BM);

  const int n = blockIdx.y, q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid % 32, wn = (tid / 32) / (BM / WM);
  const int wm = (tid / 32) % (BM / WM);
  const size_t base = static_cast<size_t>(n) * p;
  const T* on = o + base * C;
  const T* tn = t + base * C;
  const int tiles = (p + BN - 1) / BN;
  using Acc = float[MI][NJ][4];

  // pass 1: row min of cd and its first argmin
  float mn[MI][2];
  int arg[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) { mn[mi][h] = INFINITY; arg[mi][h] = p; }
  cos_sweep<T, C, BM, BN, WM, WN>(ring, on, q0, 0, tn, 0, BN, p, tiles, [&](int tile, Acc& acc) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = tile * BN + frag_col<BM, WM, WN>(nj, e);
          const float cd = cdist(acc[mi][nj][e]);
          if (col < p && better_min(cd, col, mn[mi][e >> 1], arg[mi][e >> 1])) {
            mn[mi][e >> 1] = cd;
            arg[mi][e >> 1] = col;
          }
        }
  });
  // the 4 lanes of a quad share rows, then the BN / WN warps along the row
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (int off = 1; off < 4; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, mn[mi][h], off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg[mi][h], off);
        if (better_min(om, oa, mn[mi][h], arg[mi][h])) { mn[mi][h] = om; arg[mi][h] = oa; }
      }
      if (lane % 4 == 0) {
        const int r = frag_row<BM, WM>(mi, 2 * h);
        red_v[wn * BM + r] = mn[mi][h];
        red_i[wn * BM + r] = arg[mi][h];
      }
    }
  __syncthreads();
  if (tid < BM) {
    float v = red_v[tid];
    int i = red_i[tid];
    if (better_min(red_v[BM + tid], red_i[BM + tid], v, i)) { v = red_v[BM + tid]; i = red_i[BM + tid]; }
    row_m[tid] = v;
    if (q0 + tid < p) pstar_out[base + q0 + tid] = i;
  }
  __syncthreads();
  float mrow[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) mrow[mi][h] = row_m[frag_row<BM, WM>(mi, 2 * h)];

  // pass 2: z = sum_p be
  float zs[MI][2] = {};
  cos_sweep<T, C, BM, BN, WM, WN>(ring, on, q0, 0, tn, 0, BN, p, tiles, [&](int tile, Acc& acc) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tile * BN + frag_col<BM, WM, WN>(nj, e) < p)
            zs[mi][e >> 1] += exp_term(cdist(acc[mi][nj][e]), mrow[mi][e >> 1]);
  });
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = zs[mi][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (lane % 4 == 0) red_v[wn * BM + frag_row<BM, WM>(mi, 2 * h)] = v;
    }
  __syncthreads();
  if (tid < BM) {
    const float z = red_v[tid] + red_v[BM + tid];
    row_z[tid] = z;
    if (q0 + tid < p) {
      m_out[base + q0 + tid] = row_m[tid];
      z_out[base + q0 + tid] = z;
    }
  }
  __syncthreads();
  float zrow[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) zrow[mi][h] = row_z[frag_row<BM, WM>(mi, 2 * h)];

  // pass 3: cs = be / z; column max over the strip, first q on ties
  cos_sweep<T, C, BM, BN, WM, WN>(ring, on, q0, 0, tn, 0, BN, p, tiles, [&](int tile, Acc& acc) {
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        unsigned long long best = 0ull;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned q = static_cast<unsigned>(q0 + frag_row<BM, WM>(mi, 2 * h));
            if (q >= static_cast<unsigned>(p)) continue;
            const float cs = __fdiv_rn(exp_term(cdist(acc[mi][nj][2 * h + c]), mrow[mi][h]),
                                       zrow[mi][h]);
            const unsigned long long key =
                (static_cast<unsigned long long>(__float_as_uint(cs)) << 32) | (0xFFFFFFFFu - q);
            best = key > best ? key : best;
          }
        // the 8 lanes that share a column (lane bits 2-4)
        for (int off = 4; off < 32; off <<= 1) {
          const unsigned long long v = __shfl_xor_sync(0xffffffffu, best, off);
          best = v > best ? v : best;
        }
        if (lane < 4) red_k[wm * BN + frag_col<BM, WM, WN>(nj, c)] = best;
      }
    __syncthreads();
    if (tid < BN && tile * BN + tid < p) {
      unsigned long long best = 0ull;
#pragma unroll
      for (int w = 0; w < BM / WM; ++w) {
        const unsigned long long v = red_k[w * BN + tid];
        best = v > best ? v : best;
      }
      atomicMax(colmax + base + tile * BN + tid, best);
    }
  });
}

// kRowsQ: the strip is o (rows q), tiles are t (rows p): writes do and dm.
// !kRowsQ: the strip is t (rows p), tiles are o (rows q): writes dt.
template <typename T, int C, bool kRowsQ>
__global__ void __launch_bounds__(kThreads)
mrf_bwd_kernel(const T* __restrict__ strip, const T* __restrict__ tiles, int p,
               const float* __restrict__ m, const float* __restrict__ z,
               const float* __restrict__ dz, const long long* __restrict__ qstar,
               const float* __restrict__ dk, T* __restrict__ grad, float* __restrict__ dm_out) {
  constexpr int LD = C + 1;
  constexpr int LG = kT + 1;
  constexpr int kCols = C / 32;          // grad columns per thread: lane + 32 k
  // the cos tile, A = o rows, B = t rows: [strip, tile] for do, [tile,
  // strip] for dt
  constexpr int BM = kRowsQ ? kR : kT, BN = kRowsQ ? kT : kR, WM = 16, WN = 16;
  constexpr int MI = WM / 16, NJ = WN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* b_s = reinterpret_cast<float*>(smem_raw + ring_bytes(BM, BN));  // [kT][LD] tile
  float* g_s = b_s + kT * LD;            // [kR][LG] dcos (rows: strip)
  float* c_s = g_s + kR * LG;            // [kR][LG] cos (rows: strip)

  const int n = blockIdx.y, r0 = blockIdx.x * kR;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const size_t base = static_cast<size_t>(n) * p;
  const T* sn = strip + base * C;
  const T* tl = tiles + base * C;
  const float dkn = dk[n];

  // statistics of the strip's own rows
  float rm[kRM], rz[kRM], rdz[kRM];
  long long rq[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = r0 + ty + 16 * i;
    const bool ok = r < p;
    if (kRowsQ) {
      rm[i] = ok ? m[base + r] : 0.f;
      rz[i] = ok ? z[base + r] : 1.f;
      rdz[i] = ok ? dz[base + r] : 0.f;
    } else {
      rq[i] = ok ? qstar[base + r] : -1;
    }
  }

  float acc2[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc2[r][k] = 0.f;
  float dm_acc[kRM] = {};

  auto epi = [&](int tile, float (&acc)[MI][NJ][4]) {
    const int c0 = tile * kT;
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = frag_row<BM, WM>(0, e), cc = frag_col<BM, WM, WN>(nj, e);
        if (kRowsQ) c_s[rr * LG + cc] = acc[0][nj][e];
        else c_s[cc * LG + rr] = acc[0][nj][e];
      }
    // statistics of the tile's rows
    float cm[kTN], cz[kTN], cdz[kTN];
    long long cq[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = c0 + tx + 16 * j;
      const bool ok = c < p;
      if (kRowsQ) {
        cq[j] = ok ? qstar[base + c] : -1;
      } else {
        cm[j] = ok ? m[base + c] : 0.f;
        cz[j] = ok ? z[base + c] : 1.f;
        cdz[j] = ok ? dz[base + c] : 0.f;
      }
    }
    __syncthreads();
    load_rows<T, C>(b_s, tl, c0, kT, p);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = c0 + tx + 16 * j;
        float dc = 0.f;
        if (r < p && c < p) {
          const float mm = kRowsQ ? rm[i] : cm[j];
          const float zz = kRowsQ ? rz[i] : cz[j];
          const float dzz = kRowsQ ? rdz[i] : cdz[j];
          const bool hit = kRowsQ ? (cq[j] == r) : (rq[i] == c);
          const float cos = c_s[(ty + 16 * i) * LG + tx + 16 * j];
          const float cd = cdist(cos);
          const float den = mm + kEps;
          const float beb = exp_term(cd, mm) * ((hit ? __fdiv_rn(dkn, zz) : 0.f) + dzz);
          if (kRowsQ) dm_acc[i] += 2.f * beb * cd;
          dc = cos < 1.f ? __fdiv_rn(beb, den) : 0.f;
        }
        g_s[(ty + 16 * i) * LG + tx + 16 * j] = dc;
      }
    }
    __syncthreads();
    // grad[strip rows] += dcos [kR, kT] @ tile [kT, C]
#pragma unroll 4
    for (int jj = 0; jj < kT; ++jj) {
      float g[4], b[kCols];
#pragma unroll
      for (int r = 0; r < 4; ++r) g[r] = g_s[(4 * warp + r) * LG + jj];
#pragma unroll
      for (int k = 0; k < kCols; ++k) b[k] = b_s[jj * LD + lane + 32 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc2[r][k] = fmaf(g[r], b[k], acc2[r][k]);
    }
  };
  const int n_tiles = (p + kT - 1) / kT;
  if (kRowsQ)
    cos_sweep<T, C, BM, BN, WM, WN>(ring, sn, r0, 0, tl, 0, kT, p, n_tiles, epi);
  else
    cos_sweep<T, C, BM, BN, WM, WN>(ring, tl, 0, kT, sn, r0, 0, p, n_tiles, epi);

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * warp + r;
    if (row >= p) continue;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      grad[(base + row) * C + lane + 32 * k] = cfen::from_f<T>(acc2[r][k]);
  }
  if (kRowsQ) {
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      for (int off = 8; off > 0; off >>= 1)
        dm_acc[i] += __shfl_xor_sync(0xffffffffu, dm_acc[i], off);
      const int r = r0 + ty + 16 * i;
      if (tx == 0 && r < p) {
        const float den = rm[i] + kEps;
        dm_out[base + r] = __fdiv_rn(dm_acc[i], den * den);
      }
    }
  }
}

constexpr size_t fwd_smem() {
  return ring_bytes(kFwdRows, kT) + sizeof(float) * 6 * kFwdRows +
         sizeof(unsigned long long) * (kFwdRows / 32) * kT;
}
template <int C>
constexpr size_t bwd_smem() {
  return ring_bytes(kR, kT) + sizeof(float) * (kT * (C + 1) + 2 * kR * (kT + 1));
}

template <typename T, int C>
cudaError_t launch_fwd(const void* o, const void* t, void* m, void* z, void* pstar, void* colmax,
                       int n, int p, cudaStream_t stream) {
  // cp.async moves 16-byte chunks: both operands must start on 16 bytes
  // (the wrapper copies one that does not; rows of C >= 128 elements keep
  // every chunk aligned after that)
  if (!cfen::aligned16(o) || !cfen::aligned16(t)) return cudaErrorMisalignedAddress;
  cudaError_t err = cfen::allow_smem(mrf_fwd_kernel<T, C>, fwd_smem());
  if (err != cudaSuccess) return err;
  dim3 grid((p + kFwdRows - 1) / kFwdRows, n);
  mrf_fwd_kernel<T, C><<<grid, kThreads, fwd_smem(), stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(t), p, static_cast<float*>(m),
      static_cast<float*>(z), static_cast<long long*>(pstar),
      static_cast<unsigned long long*>(colmax));
  return cudaGetLastError();
}

template <typename T, int C, bool kRowsQ>
cudaError_t launch_bwd(const void* strip, const void* tiles, const void* m, const void* z,
                       const void* dz, const void* qstar, const void* dk, void* grad, void* dm,
                       int n, int p, cudaStream_t stream) {
  if (!cfen::aligned16(strip) || !cfen::aligned16(tiles)) return cudaErrorMisalignedAddress;
  cudaError_t err = cfen::allow_smem(mrf_bwd_kernel<T, C, kRowsQ>, bwd_smem<C>());
  if (err != cudaSuccess) return err;
  dim3 grid((p + kR - 1) / kR, n);
  mrf_bwd_kernel<T, C, kRowsQ><<<grid, kThreads, bwd_smem<C>(), stream>>>(
      static_cast<const T*>(strip), static_cast<const T*>(tiles), p,
      static_cast<const float*>(m), static_cast<const float*>(z), static_cast<const float*>(dz),
      static_cast<const long long*>(qstar), static_cast<const float*>(dk), static_cast<T*>(grad),
      static_cast<float*>(dm));
  return cudaGetLastError();
}

// C: the channel counts of the VGG taps (relu3_1 256, relu4_1 512) and 128
template <typename T>
cudaError_t fwd_c(const void* o, const void* t, void* m, void* z, void* pstar, void* colmax,
                  int n, int p, int c, cudaStream_t st) {
  switch (c) {
    case 128: return launch_fwd<T, 128>(o, t, m, z, pstar, colmax, n, p, st);
    case 256: return launch_fwd<T, 256>(o, t, m, z, pstar, colmax, n, p, st);
    case 512: return launch_fwd<T, 512>(o, t, m, z, pstar, colmax, n, p, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool kRowsQ>
cudaError_t bwd_c(const void* strip, const void* tiles, const void* m, const void* z,
                  const void* dz, const void* qstar, const void* dk, void* grad, void* dm, int n,
                  int p, int c, cudaStream_t st) {
  switch (c) {
    case 128:
      return launch_bwd<T, 128, kRowsQ>(strip, tiles, m, z, dz, qstar, dk, grad, dm, n, p, st);
    case 256:
      return launch_bwd<T, 256, kRowsQ>(strip, tiles, m, z, dz, qstar, dk, grad, dm, n, p, st);
    case 512:
      return launch_bwd<T, 512, kRowsQ>(strip, tiles, m, z, dz, qstar, dk, grad, dm, n, p, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kRowsQ>
int bwd_entry(const void* strip, const void* tiles, const void* m, const void* z, const void* dz,
              const void* qstar, const void* dk, void* grad, void* dm, int n, int p, int c,
              int dtype, void* stream) {
  if (n <= 0 || p <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32)
    return bwd_c<float, kRowsQ>(strip, tiles, m, z, dz, qstar, dk, grad, dm, n, p, c, st);
  if (dtype == cfen::kBFloat16)
    return bwd_c<__nv_bfloat16, kRowsQ>(strip, tiles, m, z, dz, qstar, dk, grad, dm, n, p, c,
                                        st);
  return cudaErrorInvalidValue;
}

}  // namespace

// o, t: contiguous [n, p, c] of one dtype.  m, z: f32 [n, p]; pstar: int64
// [n, p]; colmax: uint64 [n, p], zeroed by the caller, packed K and q*.
extern "C" int cfen_mrf_fwd(const void* o, const void* t, void* m, void* z, void* pstar,
                            void* colmax, int n, int p, int c, int dtype, void* stream) {
  if (n <= 0 || p <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32) return fwd_c<float>(o, t, m, z, pstar, colmax, n, p, c, st);
  if (dtype == cfen::kBFloat16)
    return fwd_c<__nv_bfloat16>(o, t, m, z, pstar, colmax, n, p, c, st);
  return cudaErrorInvalidValue;
}

// m, z, dz: f32 [n, p] (per q); qstar: int64 [n, p] (per p); dk: f32 [n].
// do: [n, p, c] in the inputs' dtype; dm: f32 [n, p].
extern "C" int cfen_mrf_bwd_do(const void* o, const void* t, const void* m, const void* z,
                               const void* dz, const void* qstar, const void* dk, void* d_o,
                               void* dm, int n, int p, int c, int dtype, void* stream) {
  return bwd_entry<true>(o, t, m, z, dz, qstar, dk, d_o, dm, n, p, c, dtype, stream);
}

// as cfen_mrf_bwd_do; dt: [n, p, c] in the inputs' dtype.
extern "C" int cfen_mrf_bwd_dt(const void* o, const void* t, const void* m, const void* z,
                               const void* dz, const void* qstar, const void* dk, void* dt,
                               int n, int p, int c, int dtype, void* stream) {
  return bwd_entry<false>(t, o, m, z, dz, qstar, dk, dt, nullptr, n, p, c, dtype, stream);
}
