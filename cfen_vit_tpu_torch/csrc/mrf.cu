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
// Every cos tile comes from one sequence of tensor-core products,
// `cos_chunk`: one 64-byte chunk of C (32 bf16 or 16 float32 channels) of
// mma.sync products, chunk after chunk from c = 0.  bf16 inputs take
// m16n8k16 products with float32 accumulation (the products are exact).
// float32 inputs take 3xTF32 (hi*hi + hi*lo + lo*hi of TF32 parts,
// m16n8k8): one TF32 pass keeps 11 bits of each operand, and when o is
// near t the row min m is small and 1/(m + 1e-5) magnifies cos's error past
// the statistics' 1e-4 bar; tests/test_torch_port_tf32_split.py shows both.
// mma.sync and not wgmma: one routine has to serve the forward's 128-row
// strips and the backward's 32-row strips from two feeders, and mma.sync
// reaches the tensor cores from any warp tile without the warpgroup's
// shared-memory descriptors; wgmma is the next step for the forward.
//
// Every kernel forms the same cos bits.  The backward's masks (cos < 1)
// and its exp term must agree with the forward's m and z: when m is near
// 0, a one-ulp disagreement is multiplied by 1/(m + 1e-5).  So every
// kernel calls cos_chunk in one orientation, A = o rows, B = t rows, with
// the same chunk order and the same products per element, whatever its
// tile sizes: dt's strip is t, so it forms the [o tile, t strip] tile and
// transposes it through shared memory.
//
// The forward (`_fw_kernel`).  The exponent divides by the row min, so
// online (rescaled) sums do not apply: m must be final before any of z is
// summed, and z before any cs.  The TPU kernel keeps a whole [Sq, P] f32
// strip in its 96 MB of VMEM; a Hopper block has 227 KB of shared memory.
// The forward therefore RECOMPUTES the cos tiles in three passes over t
// (min, then sum, then column max) instead of spilling the strip ([N, P,
// P] f32, 4.3 GB for relu3_1 at batch 4) to a global scratch buffer.  A
// forward block owns 128 o rows (8 warps of 32 x 32 in a 128 x 64 tile);
// its A rows (o) and B rows (t) stream through a 4-stage cp.async ring in
// 64-byte chunks of C (`cos_sweep`: a C = 512 strip of 128 rows does not
// fit beside its tiles), and the ring runs on across tiles, so a tile's
// epilogue overlaps the next tile's loads.  Each pass's epilogue works on
// the accumulator fragments: the row min with its index and the row sum
// are taken across the 4 lanes of a quad and the 2 warps that share rows;
// minima compare (value, index) pairs and keep the smaller index on a tie,
// since the fragment layout visits columns out of order.
//
// Column max across blocks: blocks run in no order, so the TPU's
// sequential running max over strips does not carry over.  cs >= 0, so
// its float bits order like unsigned ints, and one 64-bit atomicMax on
// (bits(cs) << 32) | (0xFFFFFFFF - q) keeps the max and, on ties, the
// first q.  The wrapper zeroes that buffer and unpacks it.  A block first
// reduces its 128 rows (across the 8 lanes that share a column, then the
// 4 warps) and issues 64 atomics per tile.
//
// The backward (`_bwd_do_kernel`, `_bwd_dt_kernel`): per 64-row tile of
// the other operand, a cos product ([32, 64] over C) and the dcos product
// (dcos [32, 64] times the tile [64, C]), 2 N P^2 C multiply-adds each.
// What bounds them on this card is the tensor cores' rate and feeding
// them: a block's 32-row strip meets every tile of its batch row, so at
// relu3_1 each block reads 8 MB (bf16) of tiles from L2, 16 GB a kernel,
// about 3 ms of L2 traffic beside some 10 ms of products.  The design (a
// redesign of one that staged each tile twice, through the ring and then
// as a float32 copy, for a scalar-FMA dcos product):
//   - the block's strip stays in shared memory for its life, in the input
//     type; each tile comes in whole, once, by cp.async, the next tile's
//     copy overlapping this tile's products where two tiles fit (all but
//     float32 C = 512, which stages one at a time; see BwdLayout);
//   - both products read the staged rows: the cos tile through cos_chunk
//     (the forward's products, fed from the tile instead of the ring), the
//     dcos product from the same rows on the tensor cores (dcos_product:
//     bf16 hi + lo parts of the float32 dcos against the exact bf16 tile,
//     ldmatrix and ldmatrix.trans; float32 3xTF32), since the plain twin
//     and the JAX kernel multiply a float32 dcos.  In bf16 the epilogue
//     splits each dcos element once as it stores it (DcosTile), where the
//     8 warps that read it as their A operand would split it 8 times;
//   - 32-row strips, 8 warps each owning C / 8 output columns of all 32
//     rows (64 float32 accumulators a thread at C = 512).  64-row strips
//     would halve the L2 traffic but double the accumulators to 128 and
//     leave one block an SM at every C, where 32 rows allow two at bf16
//     C = 256 (relu3_1, most of the work), and the double buffer overlaps
//     the L2 reads with the products.
// The epilogue between the products is the forward's expressions
// (cdist, exp_term, the cos < 1 mask) with the hit test for the argmax
// term; do and dt are written in the input dtype; the glue adds the
// rank-1 argmin terms in f32 (ops/cuda_mrf.py).
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using cfen::mma::cp_async16;
using cfen::mma::lds32;

constexpr int kThreads = 256;  // 8 warps
constexpr int kR = 32;         // backward strip rows per block
constexpr int kT = 64;         // rows of the other operand per tile
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

// One 64-byte chunk of C (BK = 64 / sizeof(T) channels) of the cos
// product: acc[mi][nj] += A rows [16 mi, + 16) times B rows [8 nj, + 8)
// over the chunk, from as and bs (the chunk's first channel of the warp's
// first A and B row, row strides lda and ldb in shared memory).  Every
// cos element any kernel forms is the sum of these products, chunk after
// chunk from c = 0, so every kernel forms the same bits.
template <typename T, int MI, int NJ>
__device__ __forceinline__ void cos_chunk(float (&acc)[MI][NJ][4], const T* as, int lda,
                                          const T* bs, int ldb) {
  constexpr int kElt = static_cast<int>(sizeof(T));
  constexpr int BK = 64 / kElt;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (kElt == 2) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4], bf[NJ][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const T* pa = as + (16 * mi + g) * lda + kk + 2 * t;
        af[mi][0] = lds32(pa);
        af[mi][1] = lds32(pa + 8 * lda);
        af[mi][2] = lds32(pa + 8);
        af[mi][3] = lds32(pa + 8 * lda + 8);
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const T* pb = bs + (8 * nj + g) * ldb + kk + 2 * t;
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
        const float* pa = as + (16 * mi + g) * lda + kk + t;
        const float x[4] = {pa[0], pa[8 * lda], pa[4], pa[8 * lda + 4]};
        cfen::mma::split_n<4>(x, ah[mi], al[mi]);
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const float* pb = bs + (8 * nj + g) * ldb + kk + t;
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
}

// The forward's cos tiles, fed through a cp.async ring.  Tile i is A rows
// [a_row0 + i a_step, + BM) of a (o, [P, C]) against B rows [b_row0 + i
// b_step, + BN) of b (t, [P, C]), rows at or past P zero, summed over c =
// 0..C-1 by cos_chunk.  After tile i's product, epi(i, acc) runs with
// acc[mi][nj][e] at (frag_row, frag_col); all threads call it, so it may
// synchronise.  The ring runs on across tiles.
template <typename T, int C, int BM, int BN, int WM, int WN, class Epi>
__device__ __forceinline__ void cos_sweep(T* ring, const T* __restrict__ a, int a_row0,
                                          int a_step, const T* __restrict__ b, int b_row0,
                                          int b_step, int p, int tiles, Epi&& epi) {
  constexpr int kElt = static_cast<int>(sizeof(T));
  constexpr int BK = 64 / kElt, LD = kRowBytes / kElt, NK = C / BK;
  constexpr int MI = WM / 16, NJ = WN / 8;
  constexpr int kStage = (BM + BN) * LD;
  static_assert((BM / WM) * (BN / WN) * 32 == kThreads, "one warp tile per warp");
  const int tid = threadIdx.x, warp = tid / 32;
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
    cos_chunk<T, MI, NJ>(acc, as, LD, bs, LD);
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

// The dcos tile as the dcos product's A operand.  bf16: split once as
// the epilogue writes it, into hi and lo bf16 tiles that ldmatrix reads
// (the 8 warps that read it would each split it again); rows of kT + 8
// elements, 36 words (4 mod 8), for ldmatrix's 8 rows of 16 bytes.
// float32: one float32 tile, split into TF32 parts as it is read (two
// pre-split TF32 tiles measured slower: twice the shared-memory reads);
// rows of 72 words (8 mod 32) for its float2 loads (per half-warp 4 rows
// x 8 words).  Conflict-free either way.
template <typename T>
struct DcosTile {
  static constexpr bool kSplit = sizeof(T) == 2;
  using E = typename std::conditional<kSplit, __nv_bfloat16, float>::type;
  static constexpr int kParts = kSplit ? 2 : 1;   // tiles: hi (and lo)
  static constexpr int LD = kT + 8;
  static __device__ __forceinline__ void put(E* d, int row, int col, float x) {
    if constexpr (kSplit) {
      const __nv_bfloat16 h = __float2bfloat16(x);
      d[row * LD + col] = h;
      d[kR * LD + row * LD + col] = __float2bfloat16(x - __bfloat162float(h));
    } else {
      d[row * LD + col] = x;
    }
  }
};

// The backward's shared memory: the strip [kR][LD] and kBufs tiles
// [kT][LD] in the input type, the dcos tile (DcosTile: bf16 hi and lo
// [2][kR][kT + 8], or float32 [kR][kT + 8]) and the dm partials [4][kR] in
// float32.  Rows are padded by 16 bytes to 4 mod 32 words (C a multiple
// of 128), so the cos fragment loads (8 rows x 4 words), the float32 dcos
// product's B loads (rows 2t, 2t + 1 x 8 columns) and ldmatrix's 8 rows
// of 16 bytes each hit 32 distinct banks.  Two tiles where they fit, so
// that the next tile's cp.async overlaps this tile's products: every case
// but float32 at C = 512 (66 KB strip + 2 x 132 KB), which stages one
// tile at a time.
template <typename T, int C>
struct BwdLayout {
  static constexpr int LD = C + 16 / static_cast<int>(sizeof(T));
  static constexpr size_t kStrip = sizeof(T) * kR * LD;
  static constexpr size_t kTile = sizeof(T) * kT * LD;
  static constexpr size_t kRest =
      sizeof(typename DcosTile<T>::E) * DcosTile<T>::kParts * kR * DcosTile<T>::LD +
      sizeof(float) * 4 * kR;
  static constexpr int kBufs = kStrip + 2 * kTile + kRest <= cfen::kSmemMax ? 2 : 1;
  static constexpr size_t kBytes = kStrip + kBufs * kTile + kRest;
  // two blocks an SM where two fit in its 228 KB (1 KB each reserved)
  static constexpr int kMinBlocks = 2 * (kBytes + 1024) <= 233472 ? 2 : 1;
};

// acc[mi][nj] += D rows [16 mi, + 16) x tb columns [8 nj, + 8) over the
// tile's kT rows: D the dcos tile d (DcosTile; rows: the strip), tb the
// staged tile [kT][LD] at the warp's first output column.  bf16: D's hi
// and lo bf16 parts against the exact bf16 tile, two m16n8k16 products;
// float32: 3xTF32 on m16n8k8.  So no rounding of dcos is added beyond
// about 2^-16 (bf16) or 2^-22 of each product.  The float32 k8 step takes
// tile rows 2t and 2t + 1 for k slots t and t + 4 (D's columns the same),
// which keeps its B loads off shared bank conflicts.
template <typename T, int C>
__device__ __forceinline__ void dcos_product(float (&acc)[2][C / 64][4],
                                             const typename DcosTile<T>::E* d, const T* tb,
                                             int lane) {
  constexpr int LD = BwdLayout<T, C>::LD, LDD = DcosTile<T>::LD, NO = C / 64;
  const int g = lane / 4, t = lane % 4;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int at = (16 * mi + (lane & 15)) * LDD + kk + 8 * (lane >> 4);
        cfen::mma::ldmatrix_x4(ah[mi], d + at);
        cfen::mma::ldmatrix_x4(al[mi], d + kR * LDD + at);
      }
      const T* pb = tb + (kk + (lane & 15)) * LD + 8 * (lane >> 4);
#pragma unroll
      for (int nj = 0; nj < NO; nj += 2) {
        uint32_t b[4];
        cfen::mma::ldmatrix_x4_trans(b, pb + 8 * nj);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          cfen::mma::bf16_16816(acc[mi][nj], al[mi], b);
          cfen::mma::bf16_16816(acc[mi][nj], ah[mi], b);
          cfen::mma::bf16_16816(acc[mi][nj + 1], al[mi], b + 2);
          cfen::mma::bf16_16816(acc[mi][nj + 1], ah[mi], b + 2);
        }
      }
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < kT; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* pa = d + (16 * mi + g) * LDD + kk + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(pa);
        const float2 x1 = *reinterpret_cast<const float2*>(pa + 8 * LDD);
        const float a[4] = {x0.x, x1.x, x0.y, x1.y};
        cfen::mma::split_n<4>(a, ah[mi], al[mi]);
      }
      const float* pb = tb + (kk + 2 * t) * LD + g;
#pragma unroll
      for (int nj = 0; nj < NO; ++nj) {
        const float b[2] = {pb[8 * nj], pb[LD + 8 * nj]};
        uint32_t bh[2], bl[2];
        cfen::mma::split_n<2>(b, bh, bl);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          cfen::mma::tf32x3_1688(acc[mi][nj], ah[mi], al[mi], bh, bl);
      }
    }
  }
}

// kRowsQ: the strip is o (rows q), tiles are t (rows p): writes do and dm.
// !kRowsQ: the strip is t (rows p), tiles are o (rows q): writes dt.
template <typename T, int C, bool kRowsQ>
__global__ void __launch_bounds__(kThreads, BwdLayout<T, C>::kMinBlocks)
mrf_bwd_kernel(const T* __restrict__ strip, const T* __restrict__ tiles, int p,
               const float* __restrict__ m, const float* __restrict__ z,
               const float* __restrict__ dz, const long long* __restrict__ qstar,
               const float* __restrict__ dk, T* __restrict__ grad, float* __restrict__ dm_out) {
  using L = BwdLayout<T, C>;
  using D = DcosTile<T>;
  constexpr int LD = L::LD;
  constexpr int BK = 64 / static_cast<int>(sizeof(T));
  // the cos tile, A = o rows, B = t rows: [strip, tile] for do, [tile,
  // strip] for dt, in 16 x 16 warp tiles
  constexpr int BM = kRowsQ ? kR : kT, WM = 16, WN = 16, NJ = WN / 8;
  constexpr int NO = C / 64;   // n8 tiles of a warp's C / 8 output columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ss = reinterpret_cast<T*>(smem_raw);                          // [kR][LD] strip
  T* ts = ss + kR * LD;                                            // [kBufs][kT][LD]
  auto* ds = reinterpret_cast<typename D::E*>(ts + L::kBufs * kT * LD);  // dcos
  float* red = reinterpret_cast<float*>(ds + D::kParts * kR * D::LD);   // [4][kR] dm

  const int n = blockIdx.y, r0 = blockIdx.x * kR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp % (BM / WM), wn = warp / (BM / WM);
  const size_t base = static_cast<size_t>(n) * p;
  const T* sn = strip + base * C;
  const T* tl = tiles + base * C;
  const float dkn = dk[n];
  const int n_tiles = (p + kT - 1) / kT;

  // rows [row0, row0 + rows) of src into dst, zero at or past P
  auto stage = [&](T* dst, const T* src, int row0, int rows) {
    constexpr int kChunk = 16 / static_cast<int>(sizeof(T)), kPer = C / kChunk;
    for (int i = tid; i < rows * kPer; i += kThreads) {
      const int r = i / kPer, c = (i % kPer) * kChunk;
      const bool ok = row0 + r < p;
      cp_async16(dst + r * LD + c, src + static_cast<size_t>(ok ? row0 + r : 0) * C + c, ok);
    }
  };
  stage(ss, sn, r0, kR);
  stage(ts, tl, 0, kT);
  cfen::mma::cp_async_commit();

  // cos fragment element e of n-tile nj: tile row wm WM + g + 8 (e >> 1),
  // column wn WN + 8 nj + 2 t + (e & 1).  The strip's statistics stay: do
  // m, z, dz of its rows (q); dt q* of its columns (p)
  float sm[2] = {0.f, 0.f}, sz[2] = {1.f, 1.f}, sdz[2] = {0.f, 0.f};
  long long sq[NJ][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = r0 + wm * WM + g + 8 * h;
    if (kRowsQ && q < p) {
      sm[h] = m[base + q];
      sz[h] = z[base + q];
      sdz[h] = dz[base + q];
    }
  }
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int pc = r0 + wn * WN + 8 * nj + 2 * t + e1;
      sq[nj][e1] = !kRowsQ && pc < p ? qstar[base + pc] : -1;
    }

  float acc_o[2][NO][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NO; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_o[mi][nj][e] = 0.f;
  float dm_acc[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int c0 = j * kT;
    const T* tb = ts + (L::kBufs == 2 ? (j & 1) : 0) * kT * LD;
    cfen::mma::cp_async_wait<0>();
    __syncthreads();   // tile j staged; the last tile's reads of ds and its buffer done
    if (L::kBufs == 2 && j + 1 < n_tiles) {
      stage(ts + ((j + 1) & 1) * kT * LD, tl, c0 + kT, kT);
      cfen::mma::cp_async_commit();
    }
    // the tile's statistics: do q* of its columns (p); dt m, z, dz of its
    // rows (q)
    float tm[2] = {0.f, 0.f}, tz[2] = {1.f, 1.f}, tdz[2] = {0.f, 0.f};
    long long tq[NJ][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = c0 + wm * WM + g + 8 * h;
      if (!kRowsQ && q < p) {
        tm[h] = m[base + q];
        tz[h] = z[base + q];
        tdz[h] = dz[base + q];
      }
    }
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int pc = c0 + wn * WN + 8 * nj + 2 * t + e1;
        tq[nj][e1] = kRowsQ && pc < p ? qstar[base + pc] : -1;
      }

    // cos = o t^T over C, chunk by chunk as the forward's
    float acc[1][NJ][4];
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][nj][e] = 0.f;
    const T* as = (kRowsQ ? ss : tb) + wm * WM * LD;
    const T* bs = (kRowsQ ? tb : ss) + wn * WN * LD;
#pragma unroll 4
    for (int k0 = 0; k0 < C; k0 += BK) cos_chunk<T, 1, NJ>(acc, as + k0, LD, bs + k0, LD);

    // dcos with the forward's expressions, into ds with the strip's rows
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, e1 = e & 1;
        const int rr = wm * WM + g + 8 * h, cc = wn * WN + 8 * nj + 2 * t + e1;
        const int q = kRowsQ ? r0 + rr : c0 + rr, pc = kRowsQ ? c0 + cc : r0 + cc;
        float dc = 0.f;
        if (q < p && pc < p) {
          const float mm = kRowsQ ? sm[h] : tm[h];
          const float zz = kRowsQ ? sz[h] : tz[h];
          const float dzz = kRowsQ ? sdz[h] : tdz[h];
          const bool hit = (kRowsQ ? tq[nj][e1] : sq[nj][e1]) == q;
          const float cos = acc[0][nj][e];
          const float cd = cdist(cos);
          const float den = mm + kEps;
          const float beb = exp_term(cd, mm) * ((hit ? __fdiv_rn(dkn, zz) : 0.f) + dzz);
          if (kRowsQ) dm_acc[h] += 2.f * beb * cd;
          dc = cos < 1.f ? __fdiv_rn(beb, den) : 0.f;
        }
        if (kRowsQ) D::put(ds, rr, cc, dc);
        else D::put(ds, cc, rr, dc);
      }
    __syncthreads();
    // grad[strip rows, the warp's columns] += dcos [kR, kT] . tile [kT, C]
    dcos_product<T, C>(acc_o, ds, tb + warp * (C / 8), lane);
    if (L::kBufs == 1) {
      __syncthreads();   // the one buffer is free
      if (j + 1 < n_tiles) {
        stage(ts, tl, c0 + kT, kT);
        cfen::mma::cp_async_commit();
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * mi + g + 8 * h;
      if (row >= p) continue;
      T* out = grad + (base + row) * C + warp * (C / 8) + 2 * t;
#pragma unroll
      for (int nj = 0; nj < NO; ++nj) {
        out[8 * nj] = cfen::from_f<T>(acc_o[mi][nj][2 * h]);
        out[8 * nj + 1] = cfen::from_f<T>(acc_o[mi][nj][2 * h + 1]);
      }
    }
  if (kRowsQ) {
    // the 4 lanes of a quad share rows, then the 4 warps along the tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = dm_acc[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) red[wn * kR + wm * WM + g + 8 * h] = v;
    }
    __syncthreads();
    const int r = r0 + tid;
    if (tid < kR && r < p) {
      const float v = red[tid] + red[kR + tid] + red[2 * kR + tid] + red[3 * kR + tid];
      const float den = m[base + r] + kEps;
      dm_out[base + r] = __fdiv_rn(v, den * den);
    }
  }
}

constexpr size_t fwd_smem() {
  return ring_bytes(kFwdRows, kT) + sizeof(float) * 6 * kFwdRows +
         sizeof(unsigned long long) * (kFwdRows / 32) * kT;
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
  constexpr size_t smem = BwdLayout<T, C>::kBytes;
  if (!cfen::aligned16(strip) || !cfen::aligned16(tiles)) return cudaErrorMisalignedAddress;
  cudaError_t err = cfen::allow_smem(mrf_bwd_kernel<T, C, kRowsQ>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p + kR - 1) / kR, n);
  mrf_bwd_kernel<T, C, kRowsQ><<<grid, kThreads, smem, stream>>>(
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
