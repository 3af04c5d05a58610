// K4: stem, h = conv5x5(x) 3 -> cm (zero pad 2), then
// out = h + conv3x3(relu(conv3x3(h))) cm -> cm (zero pad 1), NCHW, for any
// stem width cm up to 146 (stem_plan: the largest tile that fits; the
// wrapper's MAX_STEM_WIDTH in ops/cuda_stem.py).
//
// Replaces cfen_vit_tpu/ops/pallas_stem.py fused_stem (kernel _kstem);
// computes what models/generator.py _stem_plain computes.
//
// Bound on Hopper: per output pixel 75 cm + 2 x 9 cm^2 multiply-adds (3492
// at cm 12) over 3 input and cm output channels of device traffic; the
// plain version also writes and rereads two cm-channel intermediates.
// Fused, the function is bound by device memory in bf16 (about 0.009 ms
// at [4,3,512,512] -> 12) and by the FFMA rate in float32 (0.11 ms).  The
// port's first kernel was scalar float32 FFMA with one shared weight load
// per FMA in both dtypes (0.72 ms), and recomputed h on a halo.
//
// Design: one block of 8 warps per output tile.  The block stages x with a
// halo of 4 (zero outside the image) and keeps h (on the tile plus a halo
// of 2) and r1 = relu(conv3x3(h) + b1) (on the tile plus 1) for all cm
// channels channel-last in shared memory in the input type (bf16 is where
// the plain version stores them, so the rounding point holds and the
// tiles halve), each stored as ZERO outside the image, not computed from
// the zero-padded x: the 3x3 convolutions zero-pad h and r1 themselves
// (pallas_stem.py masks them the same way).  Output channels go in N
// chunks of 8 NT (NT 1-4, as fits); only a chunk's weights are in shared
// memory, zero past cm.
//   The two 3x3 convs (2 x 9 cm^2 of the 75 cm + 18 cm^2 multiply-adds a
//   pixel: 74% at cm 12) are implicit GEMMs on the tensor cores: M is
//   positions of the region in 16-position strips (a warp takes them in
//   turn, each against the chunk's NT n8 tiles), K is 9 taps x cpad,
//   tap-major, N the chunk.  A position's row holds cpad channels (cm
//   rounded up to the k step, the padding zero) plus 8 (bf16) or 4
//   (float32) elements, so the 8 rows of one fragment load fall in
//   distinct banks; A is 16 shared rows of contiguous channels (ldmatrix.x4
//   in bf16), B the chunk's weights as [8 NT][9 cpad + pad].
//   The 5x5 head conv (3 -> cm, K 75) is FFMA, a thread up to three
//   positions and the chunk's channels, weights as float [75][8 NT] read
//   as 16-byte broadcasts (each serving 4 FMAs a position), each
//   sum taken over k = (c, dy, dx) in order from zero.  That is how the
//   plain version's convolution of 3 channels sums in both dtypes, so h
//   matches it bit for bit.  On the tensor cores (K 75 padded to 80 in the
//   weights' own order, A gathered from the planar x tile: 5 k16 products a
//   strip and n8 tile, against 25 for per-tap k16 over 3 of 16 live
//   channels) h differed from the plain version's at 134-161 of 17M values,
//   and one such flip, doubly rounded (the sum at a higher binade than the
//   sum plus bias), moved a phase-8 output by 0.0625 against the bf16
//   tolerance of 0.02 + 0.01 |ref| (PERF.md, Findings).
// The tile is 16x32, 16x16, 8x16 or 8x8: the largest whose shared memory
// fits in half of an SM's (two blocks an SM), else the largest that fits at
// all (cm up to 146 at 8x8).
//   bf16: mma.sync m16n8k16 with float32 accumulation; cpad is cm rounded
//   up to 16.  Design bound: the head's 75 cm FFMAs a position at 67
//   TFLOP/s beside the 3x3s' padded products, 2 x 9 cpad x 8 NT-rounded N
//   multiply-adds a position at 989, halos and whole strips included.
//   float32: the 3x3s as 3xTF32 on m16n8k8 (split as read, as K1 does);
//   cpad is cm rounded up to 8.  By count (PERF.md, Findings), at cm
//   12 the padded K and N give 2 x 144 x 16 x 3 = 13824 TF32 multiply-adds
//   a pixel for 2592 useful: 56 fs at 495 TFLOP/s against 77 for FFMA at
//   67.
// Loads: x is 3 planar channels with a zero border; float32 stages it with
// cp.async, one 4-byte element per copy (zero-filled outside the image);
// bf16 elements are 2 bytes, under cp.async's smallest copy, so bf16
// stages through registers.  In bf16 each stage rounds where the plain
// version stores a bf16 tensor: the conv sum, then the sum plus bias
// (F.conv2d adds its bias after), and the residual sum.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kCin = 3, kThreads = 256, kWarps = kThreads / 32;
constexpr int kHeadK = kCin * 25;  // 75
constexpr int kTiles[4][2] = {{16, 32}, {16, 16}, {8, 16}, {8, 8}};  // (rows, cols)

// The launch geometry for a stem of cm channels in elements of elt bytes.
struct Plan {
  int th = 0, tw = 0, nt = 0;  // tile; n8 tiles an N chunk
  int cpad = 0, cph = 0;       // channels of a position's row, and its stride
  int ks = 0;                  // a weight row's stride (k)
  size_t smem = 0;
};

inline size_t plan_smem(const Plan& p, int cm, size_t elt) {
  const size_t xs = static_cast<size_t>(kCin) * (p.th + 8) * (p.tw + 8);
  const size_t hs = static_cast<size_t>(p.th + 4) * (p.tw + 4) * p.cph;
  const size_t rs = static_cast<size_t>(p.th + 2) * (p.tw + 2) * p.cph;
  const size_t ws = static_cast<size_t>(8) * p.nt * p.ks;
  return elt * (hs + rs + ws + xs) + sizeof(float) * 3 * cm;
}

// the largest tile (then the widest N chunk) whose shared memory fits in
// half of kSmemMax, else in kSmemMax; th 0 if none fits
inline Plan stem_plan(int cm, size_t elt) {
  Plan p;
  const int kstep = elt == 2 ? 16 : 8, pad = elt == 2 ? 8 : 4;
  p.cpad = (cm + kstep - 1) / kstep * kstep;
  p.cph = p.cpad + pad;
  // a weight row holds the 3x3's K; the buffer also holds the head's
  // float [75][8 NT] (ks elt >= 300: bf16 ks >= 152, float32 ks >= 84)
  const int k = 9 * p.cpad > kHeadK ? 9 * p.cpad : kHeadK;
  p.ks = (k + kstep - 1) / kstep * kstep + pad;
  const int nt_max = cm <= 24 ? (cm + 7) / 8 : 4;
  for (size_t limit : {cfen::kSmemMax / 2, cfen::kSmemMax})
    for (const auto& tile : kTiles)
      for (int nt = nt_max; nt >= 1; --nt) {
        p.th = tile[0];
        p.tw = tile[1];
        p.nt = nt;
        p.smem = plan_smem(p, cm, elt);
        if (p.smem <= limit) return p;
      }
  p.th = 0;
  return p;
}

using bf16 = __nv_bfloat16;

// S of one warp's 16-position strips of a 3x3 conv times NT n8 tiles of
// the staged weights wt, accumulated into acc: A (p, (tap, c)) = src[pos +
// (dy sw + dx) cph + c], K 9 cpad; the strips share each B fragment.
// pos_l[s] is the source offset of strip s's row lane % 16 (bf16's
// ldmatrix rows), pos_g0[s] and pos_g1[s] those of rows g and g + 8
// (float32's).
template <typename T, int NT, int S>
__device__ __forceinline__ void strip_product(const T* src, const T* wt, int ks, int cpad,
                                              int cph, int sw, int lane, const int* pos_l,
                                              const int* pos_g0, const int* pos_g1,
                                              float acc[S][NT][4]) {
  const int g = lane / 4, t = lane % 4;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3 * sw + tap % 3) * cph + 8 * (lane >> 4);
      for (int c = 0; c < cpad; c += 16) {
        uint32_t a[S][4];
#pragma unroll
        for (int q = 0; q < S; ++q) cfen::mma::ldmatrix_x4(a[q], src + pos_l[q] + toff + c);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const T* wb = wt + (8 * j + g) * ks + tap * cpad + c + 2 * t;
          const uint32_t b[2] = {cfen::mma::lds32(wb), cfen::mma::lds32(wb + 8)};
#pragma unroll
          for (int q = 0; q < S; ++q) cfen::mma::bf16_16816(acc[q][j], a[q], b);
        }
      }
    }
  } else {
    // a tap at a time: the split operands of more taps would not fit the
    // 128 registers of two blocks an SM
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3 * sw + tap % 3) * cph + t;
      for (int c = 0; c < cpad; c += 8) {
        uint32_t ah[S][4], al[S][4];
#pragma unroll
        for (int q = 0; q < S; ++q) {
          const T* r0 = src + pos_g0[q] + toff + c;
          const T* r1 = src + pos_g1[q] + toff + c;
          const float av[4] = {r0[0], r1[0], r0[4], r1[4]};
          cfen::mma::split_n<4>(av, ah[q], al[q]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const T* wb = wt + (8 * j + g) * ks + tap * cpad + c + t;
          const float bv[2] = {wb[0], wb[4]};
          uint32_t bh[2], bl[2];
          cfen::mma::split_n<2>(bv, bh, bl);
#pragma unroll
          for (int q = 0; q < S; ++q) cfen::mma::tf32x3_1688(acc[q][j], ah[q], al[q], bh, bl);
        }
      }
    }
  }
}

// two blocks an SM: at most 128 registers a thread
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 2)
stem_kernel(const T* __restrict__ x, const T* __restrict__ w5, const T* __restrict__ b5,
            const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
            const T* __restrict__ b2, T* __restrict__ out, int h, int wd, int cm, Plan p) {
  const int th = p.th, tw = p.tw, cpad = p.cpad, cph = p.cph, ks = p.ks;
  const int xh = th + 8, xw = tw + 8;  // x tile, halo 4
  const int hh = th + 4, hw = tw + 4;  // h region, halo 2
  const int rh = th + 2, rw = tw + 2;  // r1 region, halo 1
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);  // [hh * hw][cph]
  T* rs = hs + hh * hw * cph;              // [rh * rw][cph]
  T* wt = rs + rh * rw * cph;              // [8 NT][ks]: one N chunk's weights
  T* xs = wt + 8 * NT * ks;                // [kCin][xh][xw]
  float* bs = reinterpret_cast<float*>(xs + kCin * xh * xw);  // b5, b1, b2: [3][cm]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int x0 = blockIdx.x * tw, y0 = blockIdx.y * th, n = blockIdx.z;
  const T zero = cfen::from_f<T>(0.f);

  const T* xn = x + static_cast<size_t>(n) * kCin * h * wd;
  // a warp per row of the x tile (its planes' rows in turn), a lane per column
#pragma unroll 3
  for (int row = warp; row < kCin * xh; row += kWarps) {
    const int c = row / xh, gy = y0 - 4 + row % xh;
    const bool row_in = gy >= 0 && gy < h;
    for (int xx = lane; xx < xw; xx += 32) {
      const int gx = x0 - 4 + xx;
      const bool inside = row_in && gx >= 0 && gx < wd;
      const T* src = inside ? xn + (static_cast<size_t>(c) * h + gy) * wd + gx : xn;
      if constexpr (sizeof(T) == 4)
        cfen::mma::cp_async_chunk(xs + row * xw + xx, src, inside, 2);
      else
        xs[row * xw + xx] = inside ? *src : zero;
    }
  }
  if constexpr (sizeof(T) == 4) cfen::mma::cp_async_commit();
  // h and r1 start zero: their channels past cm stay so (the 3x3 products
  // read cpad)
  for (int i = tid; i < (hh * hw + rh * rw) * cph * static_cast<int>(sizeof(T)) / 16;
       i += kThreads)
    reinterpret_cast<uint4*>(hs)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < cm; i += kThreads) {
    bs[i] = cfen::to_f(b5[i]);
    bs[cm + i] = cfen::to_f(b1[i]);
    bs[2 * cm + i] = cfen::to_f(b2[i]);
  }
  if constexpr (sizeof(T) == 4) cfen::mma::cp_async_wait<0>();

  // one N chunk's weights for out channels [n0, n0 + 8 NT), zero past cm:
  // the head's as float [k][8 NT], k = (c, dy, dx); a 3x3's as [n][ks], k =
  // tap cpad + c.  The live weights are read in their own order, so the loads
  // coalesce.
  auto stage = [&](const T* w, int n0, bool head) {
    const int rows = min(8 * NT, cm - n0), per = head ? kHeadK : 9 * cm;
    __syncthreads();   // the previous stage's writes and chunk's reads are done
    for (int i = tid; i < 8 * NT * ks * static_cast<int>(sizeof(T)) / 16; i += kThreads)
      reinterpret_cast<uint4*>(wt)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    const T* wn = w + static_cast<size_t>(n0) * per;
#pragma unroll 4
    for (int i = tid; i < rows * per; i += kThreads) {
      const int m = i / per, rem = i % per;
      if (head)
        reinterpret_cast<float*>(wt)[rem * 8 * NT + m] = cfen::to_f(wn[i]);
      else   // a 3x3 weight [oc][c][tap] goes to k = tap cpad + c
        wt[m * ks + rem % 9 * cpad + rem / 9] = wn[i];
    }
    __syncthreads();
  };
  // the 16-position strips of a region of rows x cols positions, whose
  // position (py, px) reads src at element (py sw + px) cph (the source's
  // tap (0, 0)): a warp takes its strips two at a time (one where only one
  // is left), then epi(py, px, v) for rows g and g + 8 of each where inside
  // the region, v[j][e] the value of out channel n0 + 8 j + 2 t + e
  auto sweep = [&](int rows, int cols, const T* src, int sw, auto&& epi) {
    const int count = rows * cols;
    auto run = [&](int s0, auto strips) {
      constexpr int S = decltype(strips)::value;
      int py[S][2], px[S][2], pl[S], pg0[S], pg1[S];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int base = s0 + 16 * kWarps * q;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {   // rows g and g + 8, clamped
          const int pos = min(base + g + 8 * hr, count - 1);
          py[q][hr] = pos / cols;
          px[q][hr] = pos - py[q][hr] * cols;
        }
        pg0[q] = (py[q][0] * sw + px[q][0]) * cph;
        pg1[q] = (py[q][1] * sw + px[q][1]) * cph;
        const int posl = min(base + (lane & 15), count - 1);
        pl[q] = (posl / cols * sw + posl % cols) * cph;
      }
      float acc[S][NT][4] = {};
      strip_product<T, NT, S>(src, wt, ks, cpad, cph, sw, lane, pl, pg0, pg1, acc);
#pragma unroll
      for (int q = 0; q < S; ++q)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (s0 + 16 * kWarps * q + g + 8 * hr >= count) continue;
          float v[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            v[j][0] = acc[q][j][2 * hr];
            v[j][1] = acc[q][j][2 * hr + 1];
          }
          epi(py[q][hr], px[q][hr], v);
        }
    };
    for (int s0 = 16 * warp; s0 < count; s0 += 32 * kWarps) {
      if (s0 + 16 * kWarps < count)
        run(s0, std::integral_constant<int, 2>());
      else
        run(s0, std::integral_constant<int, 1>());
    }
  };
  // the out channels this lane's accumulators hold: n0 + 8 j + 2 t + e
  auto each = [&](int n0, auto&& fn) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int oc = n0 + 8 * j + 2 * t + e;
        if (oc < cm) fn(j, e, oc);
      }
  };

  // h = conv5x5(x) + b5 on the tile plus halo 2; zero outside the image.
  // FFMA, a thread up to three positions and the chunk's 8 NT channels, each sum
  // taken over k = (c, dy, dx) in order from zero: the plain version's
  // float32 and bf16 convolution of 3 channels sums so, and h must match it
  // bit for bit (a rounding flip of h moves the output by up to two ulps
  // of h, beyond the bf16 tolerance; PERF.md, Findings)
  const int xplane = xh * xw;
  const float* wh = reinterpret_cast<const float*>(wt);
  for (int n0 = 0; n0 < cm; n0 += 8 * NT) {
    stage(w5, n0, true);
    // Q positions a thread (p, p + kThreads, ...; Q the rounds the block
    // needs, at most 3), so each weight load serves Q FMAs
    auto head = [&](auto positions) {
      constexpr int Q = decltype(positions)::value;
      for (int p0 = tid; p0 < hh * hw; p0 += Q * kThreads) {
        const T* xp[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int pq = min(p0 + q * kThreads, hh * hw - 1);
          xp[q] = xs + pq / hw * xw + pq % hw;
        }
        float acc[Q][8 * NT] = {};
        // k = (c, dy, dx) in order; c and dy not unrolled, which keeps the
        // live registers to the accumulators and one weight row
#pragma unroll 1
        for (int cdy = 0; cdy < kCin * 5; ++cdy) {
          const int off = cdy / 5 * xplane + cdy % 5 * xw;
          const float* wr = wh + cdy * 5 * 8 * NT;
#pragma unroll
          for (int dx = 0; dx < 5; ++dx) {
            float xv[Q];
#pragma unroll
            for (int q = 0; q < Q; ++q) xv[q] = cfen::to_f(xp[q][off + dx]);
#pragma unroll
            for (int m = 0; m < 8 * NT; m += 4) {
              if (n0 + m >= cm) break;   // the chunk's channels past cm
              const float4 w4 = *reinterpret_cast<const float4*>(wr + dx * 8 * NT + m);
#pragma unroll
              for (int q = 0; q < Q; ++q) {
                acc[q][m] = fmaf(w4.x, xv[q], acc[q][m]);
                acc[q][m + 1] = fmaf(w4.y, xv[q], acc[q][m + 1]);
                acc[q][m + 2] = fmaf(w4.z, xv[q], acc[q][m + 2]);
                acc[q][m + 3] = fmaf(w4.w, xv[q], acc[q][m + 3]);
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int pos = p0 + q * kThreads;
          if (pos >= hh * hw) break;
          const int yy = pos / hw, xx = pos - yy * hw;
          const int gy = y0 - 2 + yy, gx = x0 - 2 + xx;
          if (gy < 0 || gy >= h || gx < 0 || gx >= wd) continue;   // stays zero
#pragma unroll
          for (int m = 0; m < 8 * NT; ++m)
            if (n0 + m < cm)
              hs[pos * cph + n0 + m] = cfen::from_f<T>(cfen::add_bias<T>(acc[q][m], bs[n0 + m]));
        }
      }
    };
    // (8 NT Q accumulators a thread: Q 1 above NT 2, for the 128 registers)
    const int rounds = NT <= 2 ? (hh * hw + kThreads - 1) / kThreads : 1;
    if (rounds >= 3)
      head(std::integral_constant<int, NT <= 2 ? 3 : 1>());
    else if (rounds == 2)
      head(std::integral_constant<int, NT <= 2 ? 2 : 1>());
    else
      head(std::integral_constant<int, 1>());
  }
  // r1 = relu(conv3x3(h) + b1) on the tile plus halo 1; zero outside
  for (int n0 = 0; n0 < cm; n0 += 8 * NT) {
    stage(w1, n0, false);
    sweep(rh, rw, hs, hw, [&](int yy, int xx, float v[NT][2]) {
            const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
            const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
            T* dst = rs + (yy * rw + xx) * cph;
            each(n0, [&](int j, int e, int oc) {
              dst[oc] = inside
                            ? cfen::from_f<T>(fmaxf(cfen::add_bias<T>(v[j][e], bs[cm + oc]), 0.f))
                            : zero;
            });
          });
  }
  // out = h + conv3x3(r1) + b2 on the tile
  T* on = out + static_cast<size_t>(n) * cm * h * wd;
  const size_t plane = static_cast<size_t>(h) * wd;
  for (int n0 = 0; n0 < cm; n0 += 8 * NT) {
    stage(w2, n0, false);
    sweep(th, tw, rs, rw, [&](int yy, int xx, float v[NT][2]) {
            const int gy = y0 + yy, gx = x0 + xx;
            if (gy >= h || gx >= wd) return;
            const T* hrow = hs + ((yy + 2) * hw + xx + 2) * cph;
            T* dst = on + static_cast<size_t>(gy) * wd + gx;
            each(n0, [&](int j, int e, int oc) {
              dst[oc * plane] = cfen::from_f<T>(cfen::to_f(hrow[oc]) +
                                                cfen::add_bias<T>(v[j][e], bs[2 * cm + oc]));
            });
          });
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w5, const void* b5, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* o, int batch, int cm,
                   int h, int wd, cudaStream_t stream) {
  const Plan p = stem_plan(cm, sizeof(T));
  if (p.th == 0) return cudaErrorInvalidValue;
  dim3 grid((wd + p.tw - 1) / p.tw, (h + p.th - 1) / p.th, batch);
  auto run = [&](auto kernel, bool (&allowed)[64]) {
    cudaError_t err = cfen::allow_smem_once(kernel, allowed);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, p.smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w5), static_cast<const T*>(b5),
        static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<T*>(o), h, wd, cm, p);
    return cudaGetLastError();
  };
  static bool allowed[4][64] = {};
  switch (p.nt) {
    case 1: return run(stem_kernel<T, 1>, allowed[0]);
    case 2: return run(stem_kernel<T, 2>, allowed[1]);
    case 3: return run(stem_kernel<T, 3>, allowed[2]);
    default: return run(stem_kernel<T, 4>, allowed[3]);
  }
}

}  // namespace

// The launch geometry stem_plan picks for cm channels in dtype:
// plan[0..3] = tile rows, tile cols, n8 tiles an N chunk, shared bytes
// (for the design bound chip_smoke.py logs).  Returns non-zero if no tile fits.
extern "C" int cfen_stem_plan(int cm, int dtype, int* plan) {
  if (cm <= 0 || (dtype != cfen::kFloat32 && dtype != cfen::kBFloat16))
    return cudaErrorInvalidValue;
  const Plan p = stem_plan(cm, dtype == cfen::kFloat32 ? 4 : 2);
  if (p.th == 0) return cudaErrorInvalidValue;
  plan[0] = p.th;
  plan[1] = p.tw;
  plan[2] = p.nt;
  plan[3] = static_cast<int>(p.smem);
  return 0;
}

// x: [batch, 3, h, wd]; w5: [cm, 3, 5, 5]; w1, w2: [cm, cm, 3, 3]; biases [cm];
// o: [batch, cm, h, wd]; all contiguous, one dtype.
extern "C" int cfen_stem_fwd(const void* x, const void* w5, const void* b5, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* o,
                             int batch, int cin, int cmid, int h, int wd, int dtype,
                             void* stream) {
  if (batch <= 0 || batch > 65535 || cin != kCin || cmid <= 0 || h <= 0 || wd <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32)
    return launch<float>(x, w5, b5, w1, b1, w2, b2, o, batch, cmid, h, wd, st);
  if (dtype == cfen::kBFloat16)
    return launch<bf16>(x, w5, b5, w1, b1, w2, b2, o, batch, cmid, h, wd, st);
  return cudaErrorInvalidValue;
}
