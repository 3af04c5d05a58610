// K6: modulated deformable convolution (DCNv2) forward, NCHW.
//
// Replaces cfen_vit_tpu/ops/pallas_deform.py modulated_deform_conv_pallas
// (kernel _kernel); computes what ops/deform_conv.py deform_plain computes,
// the exact function without the TPU kernel's |offset| <= 12 clamp: for each
// output pixel p and tap t, a bilinear sample of x at the float32 coordinate
// oy*stride - pad + ky*dil + dy (x likewise; a neighbour outside the image
// reads 0), times the mask, rounded to T; then out[o, p] = the float32 sum
// over taps and channels of patch * w[o, c, t], rounded to T, plus the bias
// added in T.
//
// The TPU kernel avoids gathers (the TPU has no usable one) by a one-hot
// MXU contraction over a clamped window.  Hopper gathers natively, so this
// is the bilinear im2col form as an implicit GEMM: M output pixels, N the
// output channels, K (tap, input channel).  Bound on the H100: at the
// benchmark geometries (C, O 48-256) the bytes moved (x, offset, mask, out
// once each) in bf16, the product's 2 N OH OW K^2 C O operations on the
// tensor cores in float32 (three TF32 passes).  Once the product is on the
// tensor cores the sampling sets the pace: four neighbour reads, mostly
// L2 hits, for each of N OH OW K^2 C patch elements.
//
// Design.  Two small passes first, into the caller's scratch: x to
// channel-last (NHWC, channels padded with zeros to a multiple of 8), so
// each bilinear neighbour is a contiguous run of channels read as 16-byte
// vectors; and the weights repacked K-major, wp[o][tap][c] with c padded
// with zeros to a multiple of kCC (32), so a stage's weights are 16-byte
// cp.async copies.  Then one block of 8 warps owns 64 output pixels of one
// image and all of O up to 256 channels (64, 128 or 256 wide), or 32
// pixels and all of O in chunks of 512; the warps split the channels (2 x
// 4 pixels x channels at O 128).  Each patch element is sampled once per
// pixel tile, whatever O is: above 512 channels the first chunk also
// writes each stage's patches, as the tensor cores take them, to the
// block's slice of scratch, and every later chunk loads them back by
// cp.async in place of the gather.  K runs tap-major
// in stages of kCC channels, double-buffered: while the tensor cores take
// stage s, the block's neighbour reads for stage s + 1 are in flight into
// registers and its weights into shared memory (cp.async); after the
// product the block forms stage s + 1's patches and writes them to shared
// memory in T (the plain version's rounded value), one barrier a stage.
// Each thread keeps the sampling plan (four neighbour indices and float32
// weights, and the mask) of its pixels for the current tap in registers.
// The sampling arithmetic is the plain version's operations in its order,
// rounded alike (__fadd_rn/__fmul_rn: no contraction), so patches equal
// the plain version's bit for bit and only the product's summation order
// differs.
//   bf16: ldmatrix A fragments into mma.sync m16n8k16, float32 sums.
//   float32: 3xTF32 on m16n8k8, each stage's products added to the sum in
//   round-to-nearest (the tensor cores' accumulate truncates; vit.cu); the
//   patches are split into TF32 hi and lo parts once, as they are written
//   (every warp reads every patch), the weights at fragment load.
//   Output: round the float32 sum to T, then add the bias in T (add_bias).
// Later work: wgmma, stores through shared memory (the epilogue writes
// 8-pixel runs), and a col2im backward in place of the plain recompute.
#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kCC = 32;   // input channels a stage

// a stage row: kCC elements plus 16 bytes, which keeps rows 16-byte
// aligned and a fragment's 8 rows (80 or 144 bytes apart) in distinct banks
template <typename T>
constexpr int kLd = kCC + 16 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));   // elements a 16-byte vector

struct Geo {
  int c, cs, cp;   // input channels; NHWC channel stride (c to 8); packed (c to kCC)
  int h, wd, o, k, ow, npix, stride, pad, dil;
};

// the sampling plan of one pixel at one tap: neighbours (y0,x0), (y0,x0+1),
// (y0+1,x0), (y0+1,x0+1) as pixel indices into one image (-1 outside),
// their bilinear weights and the mask
struct Plan {
  int id[4];
  float wt[4];
  float m;
};

template <typename T>
__device__ __forceinline__ Plan plan_of(const T* offn, const T* mn, int p, int tap,
                                        const Geo& g) {
  Plan pl;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pl.id[q] = -1;
    pl.wt[q] = 0.f;
  }
  pl.m = 0.f;
  if (p >= g.npix) return pl;
  const int oy = p / g.ow, ox = p % g.ow, ky = tap / g.k, kx = tap % g.k;
  const float dy = cfen::to_f(offn[static_cast<size_t>(2 * tap) * g.npix + p]);
  const float dx = cfen::to_f(offn[static_cast<size_t>(2 * tap + 1) * g.npix + p]);
  pl.m = cfen::to_f(mn[static_cast<size_t>(tap) * g.npix + p]);
  const float ys = __fadd_rn(static_cast<float>(oy * g.stride - g.pad + ky * g.dil), dy);
  const float xs = __fadd_rn(static_cast<float>(ox * g.stride - g.pad + kx * g.dil), dx);
  const float y0 = floorf(ys), x0 = floorf(xs);
  const float fy = __fsub_rn(ys, y0), fx = __fsub_rn(xs, x0);
  const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
  pl.wt[0] = __fmul_rn(gy, gx);
  pl.wt[1] = __fmul_rn(gy, fx);
  pl.wt[2] = __fmul_rn(fy, gx);
  pl.wt[3] = __fmul_rn(fy, fx);
  // bounds compared in float, so a far-off sample never becomes an
  // out-of-range int
  const float y1 = __fadd_rn(y0, 1.f), x1 = __fadd_rn(x0, 1.f);
  const float hmax = static_cast<float>(g.h - 1), wmax = static_cast<float>(g.wd - 1);
  const float yy[2] = {y0, y1}, xx[2] = {x0, x1};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float yq = yy[q >> 1], xq = xx[q & 1];
    if (yq >= 0.f && yq <= hmax && xq >= 0.f && xq <= wmax)
      pl.id[q] = static_cast<int>(yq) * g.wd + static_cast<int>(xq);
  }
  return pl;
}

// x [n][c][hw] -> xs [n][hw][cs], zero for channels c..cs-1; 32 x 32 tiles
template <typename T>
__global__ void nhwc_kernel(const T* __restrict__ x, T* __restrict__ xs, int c, int cs,
                            int hw) {
  __shared__ __align__(4) unsigned char raw[32 * 33 * sizeof(T)];
  T(*tile)[33] = reinterpret_cast<T(*)[33]>(raw);
  const int n = blockIdx.z, p0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const T* xn = x + static_cast<size_t>(n) * c * hw;
  T* xsn = xs + static_cast<size_t>(n) * hw * cs;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int ch = c0 + i, p = p0 + threadIdx.x;
    tile[i][threadIdx.x] =
        ch < c && p < hw ? xn[static_cast<size_t>(ch) * hw + p] : cfen::from_f<T>(0.f);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int p = p0 + i, ch = c0 + threadIdx.x;
    if (p < hw && ch < cs) xsn[static_cast<size_t>(p) * cs + ch] = tile[threadIdx.x][i];
  }
}

// w [o][c][kk] -> wp [o][kk][cp], zero for channels c..cp-1
template <typename T>
__global__ void pack_kernel(const T* __restrict__ w, T* __restrict__ wp, int o, int c, int kk,
                            int cp) {
  const size_t total = static_cast<size_t>(o) * kk * cp;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(i % cp);
    const size_t r = i / cp;
    const int tap = static_cast<int>(r % kk);
    const size_t oc = r / kk;
    wp[i] = ch < c ? w[(oc * c + ch) * kk + tap] : cfen::from_f<T>(0.f);
  }
}

// one block: BM = 16 MT WM pixels of image blockIdx.z, and every output
// channel, BN = 8 NT WN at a time; WM x WN warps (WN = 8 / WM), each MT m16
// tiles of pixels by NT n8 tiles of channels.  CHUNKED: O may exceed BN;
// with more than one chunk of BN channels, the first chunk writes each
// stage's patches to the block's slice of ps as well, and the later chunks
// load them back from there.  Without it the chunk loop runs once and its
// branches fold away at compile time.
template <typename T, int WM, int MT, int NT, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
deform_kernel(const T* __restrict__ xs, const T* __restrict__ offset,
              const T* __restrict__ mask, const T* __restrict__ wp,
              const T* __restrict__ bias, T* __restrict__ out, T* __restrict__ ps,
              const Geo geo) {
  constexpr int WN = kWarps / WM, BM = 16 * MT * WM, BN = 8 * NT * WN;
  constexpr int LD = kLd<T>, VE = kVec<T>;
  constexpr int VPP = kCC / VE;                 // vectors a pixel a stage
  constexpr int ITEMS = BM * VPP;               // (pixel, vector) pairs a stage
  constexpr int IT = (ITEMS + kThreads - 1) / kThreads;
  constexpr int CPR = kCC * static_cast<int>(sizeof(T)) / 16;   // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the patches, pixel-major: [2][BM][LD] in T; in float32 their TF32 hi
  // parts there and the lo parts in [2][BM][LD] after them, split once as
  // they are written (every warp reads every patch)
  constexpr int PARTS = sizeof(T) == 4 ? 2 : 1, ATILES = 2 * PARTS;
  constexpr int PSTAGE = PARTS * BM * kCC;   // a stage's patches in ps, compact
  T* as = reinterpret_cast<T*>(smem_raw);
  T* bs = as + ATILES * BM * LD;            // [2][BN][LD]: weights, channel-major
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int p0 = blockIdx.x * BM, n = blockIdx.z;
  const int kk = geo.k * geo.k, chunks = geo.cp / kCC, stages = kk * chunks;
  const int nch = CHUNKED ? (geo.o + BN - 1) / BN : 1;   // chunks of output channels
  const T* xn = xs + static_cast<size_t>(n) * geo.h * geo.wd * geo.cs;
  const T* offn = offset + static_cast<size_t>(n) * 2 * kk * geo.npix;
  const T* mn = mask + static_cast<size_t>(n) * kk * geo.npix;
  const int ob = warp % WN * 8 * NT, pb = warp / WN * 16 * MT;
  const size_t krow = static_cast<size_t>(kk) * geo.cp;   // a packed weight row
  // the block's patches, every stage, when a later chunk reads them back
  T* pt = CHUNKED && nch > 1
              ? ps + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * stages * PSTAGE
              : nullptr;

  Plan plan[IT];
  uint4 nb[IT][4];   // the four neighbours' vectors of each item
  auto make_plan = [&](int tap) {
#pragma unroll
    for (int j = 0; j < IT; ++j) {
      const int i = tid + j * kThreads;
      plan[j] = plan_of(offn, mn, i < ITEMS ? p0 + i / VPP : geo.npix, tap, geo);
    }
  };
  auto gather = [&](int c0) {   // the neighbour reads, in flight until store_a
#pragma unroll
    for (int j = 0; j < IT; ++j) {
      const int i = tid + j * kThreads, ch = c0 + i % VPP * VE;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int id = plan[j].id[q];
        nb[j][q] = id >= 0 && ch < geo.cs
                       ? *reinterpret_cast<const uint4*>(xn + static_cast<size_t>(id) * geo.cs + ch)
                       : make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto store_a = [&](T* a, int stage) {
    T* kept = pt ? pt + static_cast<size_t>(stage) * PSTAGE : nullptr;
#pragma unroll
    for (int j = 0; j < IT; ++j) {
      const int i = tid + j * kThreads;
      if (i >= ITEMS) continue;
      const Plan& pl = plan[j];
      float v[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        // ((w00 g00 + w01 g01) + w10 g10) + w11 g11, then times the mask
        float s = __fadd_rn(__fmul_rn(pl.wt[0], cfen::vec_elem<T>(nb[j][0], e)),
                            __fmul_rn(pl.wt[1], cfen::vec_elem<T>(nb[j][1], e)));
        s = __fadd_rn(s, __fmul_rn(pl.wt[2], cfen::vec_elem<T>(nb[j][2], e)));
        s = __fadd_rn(s, __fmul_rn(pl.wt[3], cfen::vec_elem<T>(nb[j][3], e)));
        v[e] = __fmul_rn(s, pl.m);
      }
      uint4 part[PARTS];
      if constexpr (sizeof(T) == 4) {
        uint32_t hi[4], lo[4];
        cfen::mma::split_n<4>(v, hi, lo);
        part[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        part[PARTS - 1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else {   // rounded to bf16 to nearest even, as from_f rounds
        part[0] = make_uint4(cfen::mma::pack_bf16(v[0], v[1]), cfen::mma::pack_bf16(v[2], v[3]),
                             cfen::mma::pack_bf16(v[4], v[5]), cfen::mma::pack_bf16(v[6], v[7]));
      }
      const int r = i / VPP, c = i % VPP * VE;
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        *reinterpret_cast<uint4*>(a + q * 2 * BM * LD + r * LD + c) = part[q];
        if (kept) *reinterpret_cast<uint4*>(kept + q * BM * kCC + r * kCC + c) = part[q];
      }
    }
  };
  auto load_a = [&](T* a, int stage) {   // a later chunk: the patches back from ps
    const T* kept = pt + static_cast<size_t>(stage) * PSTAGE;
    for (int i = tid; i < PARTS * BM * CPR; i += kThreads) {
      const int q = i / (BM * CPR), r = i / CPR % BM, c = i % CPR * VE;
      cfen::mma::cp_async16(a + q * 2 * BM * LD + r * LD + c,
                            kept + q * BM * kCC + r * kCC + c, true);
    }
  };
  auto load_b = [&](T* b, int stage, const T* wb, int o_valid) {   // wb: the chunk's rows
    const size_t koff = static_cast<size_t>(stage / chunks) * geo.cp + stage % chunks * kCC;
    for (int i = tid; i < BN * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR * VE;
      const bool ok = r < o_valid;
      cfen::mma::cp_async16(b + r * LD + c, ok ? wb + r * krow + koff + c : wb, ok);
    }
  };

  for (int oc = 0; oc < nch; ++oc) {
    // the first chunk samples the patches; a later one loads them back
    const bool fresh = oc == 0;
    const int o0 = oc * BN, o_valid = min(BN, geo.o - o0);
    const T* wb = wp + static_cast<size_t>(o0) * krow;
    float acc[MT][NT][4] = {};
    if (fresh) {
      make_plan(0);
      gather(0);
    } else {
      load_a(as, 0);
    }
    load_b(bs, 0, wb, o_valid);
    cfen::mma::cp_async_commit();
    if (fresh) store_a(as, 0);
    cfen::mma::cp_async_wait<0>();
    __syncthreads();
    for (int s = 0; s < stages; ++s) {
      const int cur = s & 1;
      const bool more = s + 1 < stages;
      if (more) {   // stage s + 1's reads, in flight over this stage's product
        if (!fresh) {
          load_a(as + (cur ^ 1) * BM * LD, s + 1);
        } else {
          if ((s + 1) % chunks == 0) make_plan((s + 1) / chunks);
          gather((s + 1) % chunks * kCC);
        }
        load_b(bs + (cur ^ 1) * BN * LD, s + 1, wb, o_valid);
        cfen::mma::cp_async_commit();
      }
      const T* a = as + cur * BM * LD + pb * LD;   // the warp's pixels
      const T* b = bs + cur * BN * LD;
      if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int kq = 0; kq < kCC; kq += 16) {
          uint32_t af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            cfen::mma::ldmatrix_x4(af[mt], a + (mt * 16 + (lane & 15)) * LD + kq + 8 * (lane >> 4));
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (ob + 8 * j >= o_valid) break;   // the warp's tiles past O
            const T* br = b + (ob + 8 * j + g) * LD + kq + 2 * t4;
            const uint32_t bf[2] = {cfen::mma::lds32(br), cfen::mma::lds32(br + 8)};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) cfen::mma::bf16_16816(acc[mt][j], af[mt], bf);
          }
        }
      } else {
        float part[MT][NT][4] = {};   // the stage's products (mma::add_rn)
#pragma unroll
        for (int kq = 0; kq < kCC; kq += 8) {
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {   // the split parts, as store_a wrote them
            const uint32_t* r0 = reinterpret_cast<const uint32_t*>(a) + (mt * 16 + g) * LD + kq + t4;
            const uint32_t* r1 = r0 + 8 * LD;
            const uint32_t* l0 = r0 + 2 * BM * LD;
            const uint32_t* l1 = r1 + 2 * BM * LD;
            const uint32_t* rows[4] = {r0, r1, r0 + 4, r1 + 4};   // a0..a3
            const uint32_t* lows[4] = {l0, l1, l0 + 4, l1 + 4};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              ah[mt][q] = *rows[q];
              al[mt][q] = *lows[q];
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (ob + 8 * j >= o_valid) break;
            const T* br = b + (ob + 8 * j + g) * LD + kq + t4;
            const float bv[2] = {br[0], br[4]};
            uint32_t bh[2], bl[2];
            cfen::mma::split_n<2>(bv, bh, bl);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              cfen::mma::tf32x3_1688(part[mt][j], ah[mt], al[mt], bh, bl);
          }
        }
        cfen::mma::add_rn<MT * NT * 4>(&acc[0][0][0], &part[0][0][0]);
      }
      if (more && fresh) store_a(as + (cur ^ 1) * BM * LD, s + 1);
      cfen::mma::cp_async_wait<0>();
      __syncthreads();   // stage s + 1 is written; every warp is done with stage s
    }

    // c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1): rows are pixels
    T* on = out + static_cast<size_t>(n) * geo.o * geo.npix;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = p0 + pb + mt * 16 + g + 8 * hr;
        if (p >= geo.npix) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = o0 + ob + 8 * j + 2 * t4 + e;
            if (o >= geo.o) continue;
            const float v = acc[mt][j][2 * hr + e];
            on[static_cast<size_t>(o) * geo.npix + p] =
                cfen::from_f<T>(bias ? cfen::add_bias<T>(v, cfen::to_f(bias[o])) : v);
          }
      }
  }
}

template <typename T, int WM, int MT, int NT, bool CHUNKED = false>
cudaError_t launch(const T* xs, const T* off, const T* m, const T* wp, const T* b, T* o, T* ps,
                   int n, const Geo& geo, cudaStream_t st) {
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * (kWarps / WM);
  static bool allowed[64] = {};
  cudaError_t err = cfen::allow_smem_once(deform_kernel<T, WM, MT, NT, CHUNKED>, allowed);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(T) * ((sizeof(T) == 4 ? 4 : 2) * BM + 2 * BN) * kLd<T>;
  const dim3 grid((geo.npix + BM - 1) / BM, 1, n);
  deform_kernel<T, WM, MT, NT, CHUNKED><<<grid, kThreads, smem, st>>>(xs, off, m, wp, b, o, ps,
                                                                      geo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const T* x, const T* off, const T* m, const T* w, const T* b, T* o,
                T* scratch, int n, const Geo& geo, cudaStream_t st) {
  const int kk = geo.k * geo.k, hw = geo.h * geo.wd;
  T* xs = scratch;                                                   // [n][hw][cs]
  T* wp = xs + static_cast<size_t>(n) * hw * geo.cs;                 // [o][kk][cp]
  // above 512 output channels: [n][pixel tiles of 32][kk cp / kCC][parts][32][kCC]
  T* ps = wp + static_cast<size_t>(geo.o) * kk * geo.cp;
  nhwc_kernel<T><<<dim3((hw + 31) / 32, (geo.cs + 31) / 32, n), dim3(32, 8), 0, st>>>(
      x, xs, geo.c, geo.cs, hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t packed = static_cast<size_t>(geo.o) * kk * geo.cp;
  pack_kernel<T><<<static_cast<int>(std::min<size_t>((packed + 255) / 256, 4096)), 256, 0, st>>>(
      w, wp, geo.o, geo.c, kk, geo.cp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // (WM, MT, NT): 64 pixels by 64, 128 or 256 channels, else 32 by 512 at
  // a time
  if (geo.o <= 64) return launch<T, 1, 4, 1>(xs, off, m, wp, b, o, nullptr, n, geo, st);
  if (geo.o <= 128) return launch<T, 2, 2, 4>(xs, off, m, wp, b, o, nullptr, n, geo, st);
  if (geo.o <= 256) return launch<T, 1, 4, 4>(xs, off, m, wp, b, o, nullptr, n, geo, st);
  return launch<T, 1, 2, 8, true>(xs, off, m, wp, b, o, ps, n, geo, st);
}

}  // namespace

// x: [n, c, h, wd]; offset: [n, 2 k^2, oh, ow] ((dy, dx) per tap); mask:
// [n, k^2, oh, ow]; w: [o_out, c, k, k]; b: [o_out] or null; out: [n, o_out,
// oh, ow]; all contiguous, one dtype.  scratch: n h wd c8 + o_out k^2 c32
// elements, 16-byte aligned (c rounded up to 8, and to kCC), and above 512
// output channels n ceil(oh ow / 32) 32 k^2 c32 more, twice that in
// float32 (ops/cuda_deform.py scratch_elems).
extern "C" int cfen_deform_fwd(const void* x, const void* offset, const void* mask,
                               const void* w, const void* b, void* out, void* scratch, int n,
                               int c, int h, int wd, int o_out, int k, int oh, int ow,
                               int stride, int pad, int dil, int dtype, void* stream) {
  if (n <= 0 || n > 65535 || c <= 0 || h <= 0 || wd <= 0 || o_out <= 0 ||
      (k != 3 && k != 5) || stride <= 0 || pad < 0 || dil <= 0)
    return cudaErrorInvalidValue;
  const int span_y = h + 2 * pad - (dil * (k - 1) + 1);
  const int span_x = wd + 2 * pad - (dil * (k - 1) + 1);
  if (span_y < 0 || span_x < 0 || oh != span_y / stride + 1 || ow != span_x / stride + 1)
    return cudaErrorInvalidValue;
  if (!cfen::aligned16(scratch)) return cudaErrorMisalignedAddress;
  const Geo geo{c, (c + 7) / 8 * 8, (c + kCC - 1) / kCC * kCC, h, wd, o_out, k, ow, oh * ow,
                stride, pad, dil};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32)
    return run<float>(static_cast<const float*>(x), static_cast<const float*>(offset),
                      static_cast<const float*>(mask), static_cast<const float*>(w),
                      static_cast<const float*>(b), static_cast<float*>(out),
                      static_cast<float*>(scratch), n, geo, st);
  if (dtype == cfen::kBFloat16)
    return run<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(offset),
        static_cast<const __nv_bfloat16*>(mask), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(scratch), n, geo, st);
  return cudaErrorInvalidValue;
}
