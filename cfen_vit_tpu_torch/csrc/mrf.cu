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
// Design.  A block owns a strip of 32 rows of one operand (o rows for the
// forward and do, t rows for dt) and walks the other operand in 64-row
// tiles; both live in shared memory as f32 with an odd row stride (C + 1),
// so the 16 lanes that read 16 different tile rows hit 16 different banks.
// Each thread owns a 2 x 4 block of cos, summed over c = 0..C-1 in one
// sequential fmaf chain: every kernel and every pass forms the same cos
// bits (fmaf is commutative in its factors, so dt's t.o equals o.t), and
// the cos < 1 masks and the statistics agree between passes.
//
// The exponent divides by the row min, so online (rescaled) sums do not
// apply: m must be final before any of z is summed, and z before any cs.
// The TPU kernel keeps a whole [Sq, P] f32 strip in its 96 MB of VMEM; a
// Hopper block has 227 KB of shared memory.  The forward therefore
// RECOMPUTES the cos tiles in three passes over t (min, then sum, then
// column max) instead of spilling the strip ([N, P, P] f32, 4.3 GB for
// relu3_1 at batch 4) to a global scratch buffer: it keeps the memory of
// the loss O(N P), and the recompute is the same code three times.
//
// Column max across blocks: blocks run in no order, so the TPU's
// sequential running max over strips does not carry over.  cs >= 0, so
// its float bits order like unsigned ints, and one 64-bit atomicMax on
// (bits(cs) << 32) | (0xFFFFFFFF - q) keeps the max and, on ties, the
// first q.  The wrapper zeroes that buffer and unpacks it.  Rows within a
// block are reduced in shared memory first, so each block issues 64
// atomics per tile.
//
// The backward kernels keep the [32, 64] dcos tile in shared memory and
// multiply it into the 64-row tile already resident there, so the second
// product costs no extra loads; each thread accumulates 4 rows x C/32
// columns of do (dt) in registers.  do and dt are written in the input
// dtype; the glue adds the rank-1 argmin terms in f32 (ops/cuda_mrf.py).
// Nothing uses the tensor cores yet: that is wgmma work for a later change.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kR = 32;       // strip rows per block
constexpr int kT = 64;       // rows of the other operand per tile
constexpr int kRM = kR / 16; // strip rows per thread: ty + 16 i
constexpr int kTN = kT / 16; // tile rows per thread: tx + 16 j
constexpr float kEps = 1e-5f;

// The three expressions every pass and kernel must evaluate identically.
__device__ __forceinline__ float cdist(float cos) {
  return fmaxf(fmaf(-0.5f, cos, 0.5f), 0.f);
}
__device__ __forceinline__ float exp_term(float cd, float m) {
  return expf(fmaf(-2.f, __fdiv_rn(cd, m + kEps), 2.f));
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

// acc[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c], c in order
template <int C>
__device__ __forceinline__ void cos_tile(const float* a_s, const float* b_s, int ty, int tx,
                                         float acc[kRM][kTN]) {
  constexpr int LD = C + 1;
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float a[kRM], b[kTN];
#pragma unroll
    for (int i = 0; i < kRM; ++i) a[i] = a_s[(ty + 16 * i) * LD + c];
#pragma unroll
    for (int j = 0; j < kTN; ++j) b[j] = b_s[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
mrf_fwd_kernel(const T* __restrict__ o, const T* __restrict__ t, int p, float* __restrict__ m_out,
               float* __restrict__ z_out, long long* __restrict__ pstar_out,
               unsigned long long* __restrict__ colmax) {
  constexpr int LD = C + 1;
  extern __shared__ float smem[];
  float* a_s = smem;                      // [kR][LD] o strip
  float* b_s = a_s + kR * LD;             // [kT][LD] t tile
  unsigned long long* red =               // [16][kT] packed column maxima
      reinterpret_cast<unsigned long long*>(b_s + kT * LD);

  const int n = blockIdx.y, q0 = blockIdx.x * kR;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t base = static_cast<size_t>(n) * p;
  const T* on = o + base * C;
  const T* tn = t + base * C;
  load_rows<T, C>(a_s, on, q0, kR, p);

  // pass 1: row min of cd and its first argmin
  float mn[kRM];
  int arg[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) { mn[i] = INFINITY; arg[i] = p; }
  for (int p0 = 0; p0 < p; p0 += kT) {
    __syncthreads();
    load_rows<T, C>(b_s, tn, p0, kT, p);
    __syncthreads();
    float acc[kRM][kTN];
    cos_tile<C>(a_s, b_s, ty, tx, acc);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = p0 + tx + 16 * j;   // increasing in j and over tiles
      if (col >= p) continue;
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float cd = cdist(acc[i][j]);
        if (cd < mn[i]) { mn[i] = cd; arg[i] = col; }
      }
    }
  }
  // the 16 lanes of a half-warp share ty: combine, smaller index on ties
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mn[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
      if (om < mn[i] || (om == mn[i] && oa < arg[i])) { mn[i] = om; arg[i] = oa; }
    }
  }

  // pass 2: z = sum_p be
  float zs[kRM] = {};
  for (int p0 = 0; p0 < p; p0 += kT) {
    __syncthreads();
    load_rows<T, C>(b_s, tn, p0, kT, p);
    __syncthreads();
    float acc[kRM][kTN];
    cos_tile<C>(a_s, b_s, ty, tx, acc);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      if (p0 + tx + 16 * j >= p) continue;
#pragma unroll
      for (int i = 0; i < kRM; ++i) zs[i] += exp_term(cdist(acc[i][j]), mn[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRM; ++i)
    for (int off = 8; off > 0; off >>= 1) zs[i] += __shfl_xor_sync(0xffffffffu, zs[i], off);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q < p) {
        m_out[base + q] = mn[i];
        z_out[base + q] = zs[i];
        pstar_out[base + q] = arg[i];
      }
    }
  }

  // pass 3: cs = be / z; column max over the strip, first q on ties
  for (int p0 = 0; p0 < p; p0 += kT) {
    __syncthreads();
    load_rows<T, C>(b_s, tn, p0, kT, p);
    __syncthreads();
    float acc[kRM][kTN];
    cos_tile<C>(a_s, b_s, ty, tx, acc);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      unsigned long long best = 0ull;
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const unsigned q = static_cast<unsigned>(q0 + ty + 16 * i);
        if (q >= static_cast<unsigned>(p)) continue;
        const float cs = __fdiv_rn(exp_term(cdist(acc[i][j]), mn[i]), zs[i]);
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(cs)) << 32) | (0xFFFFFFFFu - q);
        best = key > best ? key : best;
      }
      red[ty * kT + tx + 16 * j] = best;
    }
    __syncthreads();
    if (tid < kT && p0 + tid < p) {
      unsigned long long best = 0ull;
      for (int r = 0; r < 16; ++r) {
        const unsigned long long v = red[r * kT + tid];
        best = v > best ? v : best;
      }
      atomicMax(colmax + base + p0 + tid, best);
    }
  }
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
  extern __shared__ float smem[];
  float* a_s = smem;                     // [kR][LD] strip
  float* b_s = a_s + kR * LD;            // [kT][LD] tile
  float* g_s = b_s + kT * LD;            // [kR][LG] dcos (rows: strip)

  const int n = blockIdx.y, r0 = blockIdx.x * kR;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const size_t base = static_cast<size_t>(n) * p;
  load_rows<T, C>(a_s, strip + base * C, r0, kR, p);
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

  for (int c0 = 0; c0 < p; c0 += kT) {
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
    load_rows<T, C>(b_s, tiles + base * C, c0, kT, p);
    __syncthreads();
    float acc[kRM][kTN];
    cos_tile<C>(a_s, b_s, ty, tx, acc);
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
          const float cos = acc[i][j];
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
  }

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

template <int C>
constexpr size_t fwd_smem() {
  return sizeof(float) * (kR + kT) * (C + 1) + sizeof(unsigned long long) * 16 * kT;
}
template <int C>
constexpr size_t bwd_smem() {
  return sizeof(float) * ((kR + kT) * (C + 1) + kR * (kT + 1));
}

template <typename T, int C>
cudaError_t launch_fwd(const void* o, const void* t, void* m, void* z, void* pstar, void* colmax,
                       int n, int p, cudaStream_t stream) {
  cudaError_t err = cfen::allow_smem(mrf_fwd_kernel<T, C>, fwd_smem<C>());
  if (err != cudaSuccess) return err;
  dim3 grid((p + kR - 1) / kR, n);
  mrf_fwd_kernel<T, C><<<grid, kThreads, fwd_smem<C>(), stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(t), p, static_cast<float*>(m),
      static_cast<float*>(z), static_cast<long long*>(pstar),
      static_cast<unsigned long long*>(colmax));
  return cudaGetLastError();
}

template <typename T, int C, bool kRowsQ>
cudaError_t launch_bwd(const void* strip, const void* tiles, const void* m, const void* z,
                       const void* dz, const void* qstar, const void* dk, void* grad, void* dm,
                       int n, int p, cudaStream_t stream) {
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
