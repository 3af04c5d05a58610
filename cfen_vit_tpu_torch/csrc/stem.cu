// K4: stem, h = conv5x5(x) 3 -> cm (zero pad 2), then
// out = h + conv3x3(relu(conv3x3(h))) cm -> cm (zero pad 1), NCHW, for any
// stem width cm up to 146 (stem_tile: the largest tile that fits; the
// wrapper's MAX_STEM_WIDTH in ops/cuda_stem.py).
//
// Replaces cfen_vit_tpu/ops/pallas_stem.py fused_stem (kernel _kstem);
// computes what models/generator.py _stem_plain computes.
//
// Bound on Hopper: the plain version writes and rereads two cm-channel
// full-resolution maps (h and the relu output), ~100 MB of device traffic
// per 4 images at 512x512 and cm 12; fused, only x is read and the output
// written.  Design: one 256-thread block per output tile.  The block
// stages x with a halo of 4 in shared memory (zero outside the image),
// computes h on the tile plus a halo of 2 and r1 = relu(conv3x3(h)) on the
// tile plus a halo of 1, both into shared memory, then the output.  h and
// r1 are stored as ZERO outside the image, not computed from the
// zero-padded x: the 3x3 convolutions zero-pad h and r1 themselves
// (pallas_stem.py masks them the same way).  Each thread computes G output
// channels of one position at a time (G = cm up to 16: 12 at n_feats 24,
// 16 at the defaults; above 16 the channels go in groups of 16 or 12), so
// every weight read is a warp-wide broadcast; only the weights of the
// current group are in shared memory.  The tile is 16x32 where h and r1
// for all cm channels fit (cm <= 32), else 16x16, 8x16 or 8x8.
// In bf16 each stage rounds where the plain version stores a bf16 tensor:
// the conv sum, then the sum plus bias (F.conv2d adds its bias after).
#include "common.cuh"

namespace {

constexpr int kCin = 3, kThreads = 256;
constexpr int kTiles[4][2] = {{16, 32}, {16, 16}, {8, 16}, {8, 8}};  // (rows, cols)

// output channels per thread for a stem of cm channels
inline int stem_group(int cm) {
  if (cm <= 16) return cm <= 4 ? 4 : cm <= 8 ? 8 : cm <= 12 ? 12 : 16;
  return cm % 16 != 0 && cm % 12 == 0 ? 12 : 16;
}

// floats of shared memory at a th x tw output tile
inline size_t stem_floats(int cm, int g, int th, int tw) {
  const int w_group = g * (9 * cm > kCin * 25 ? 9 * cm : kCin * 25);
  return static_cast<size_t>(kCin) * (th + 8) * (tw + 8) +
         static_cast<size_t>(cm) * ((th + 4) * (tw + 4) + (th + 2) * (tw + 2)) + w_group +
         3 * cm;
}

// the largest tile whose shared memory fits, as an index into kTiles; -1
// if none does
inline int stem_tile(int cm) {
  for (int i = 0; i < 4; ++i)
    if (stem_floats(cm, stem_group(cm), kTiles[i][0], kTiles[i][1]) * sizeof(float) <=
        cfen::kSmemMax)
      return i;
  return -1;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ x, const T* __restrict__ w5, const T* __restrict__ b5,
            const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
            const T* __restrict__ b2, T* __restrict__ out, int h, int wd, int cm, int th,
            int tw) {
  const int xh = th + 8, xw = tw + 8;  // x tile, halo 4
  const int hh = th + 4, hw = tw + 4;  // h tile, halo 2
  const int rh = th + 2, rw = tw + 2;  // r1 tile, halo 1
  extern __shared__ float smem[];
  float* xs = smem;                   // [kCin][xh][xw]
  float* hs = xs + kCin * xh * xw;    // [cm][hh][hw]
  float* rs = hs + cm * hh * hw;      // [cm][rh][rw]
  float* bs = rs + cm * rh * rw;      // b5, b1, b2: [3][cm]
  float* wg = bs + 3 * cm;            // one group's weights: [G][kCin][5][5] or [G][cm][3][3]
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * tw, y0 = blockIdx.y * th, n = blockIdx.z;

  for (int i = tid; i < cm; i += kThreads) {
    bs[i] = cfen::to_f(b5[i]);
    bs[cm + i] = cfen::to_f(b1[i]);
    bs[2 * cm + i] = cfen::to_f(b2[i]);
  }
  const T* xn = x + static_cast<size_t>(n) * kCin * h * wd;
  for (int i = tid; i < kCin * xh * xw; i += kThreads) {
    const int c = i / (xh * xw), rem = i % (xh * xw);
    const int gy = y0 - 4 + rem / xw, gx = x0 - 4 + rem % xw;
    float val = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
      val = cfen::to_f(xn[(static_cast<size_t>(c) * h + gy) * wd + gx]);
    xs[i] = val;
  }
  // the weights of output channels [g0, g0 + G) of a conv with `per`
  // weights per output channel; zero past cm
  auto stage_group = [&](const T* w, int g0, int per) {
    __syncthreads();   // the previous stage's writes and group's reads are done
    for (int i = tid; i < G * per; i += kThreads) {
      const int m = g0 + i / per;
      wg[i] = m < cm ? cfen::to_f(w[static_cast<size_t>(g0) * per + i]) : 0.f;
    }
    __syncthreads();
  };

  // h = conv5x5(x) + b5 on the tile plus halo 2; zero outside the image
  for (int g0 = 0; g0 < cm; g0 += G) {
    stage_group(w5, g0, kCin * 25);
    for (int i = tid; i < hh * hw; i += kThreads) {
      const int yy = i / hw, xx = i % hw;
      const int gy = y0 - 2 + yy, gx = x0 - 2 + xx;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
      float acc[G];
#pragma unroll
      for (int m = 0; m < G; ++m) acc[m] = 0.f;
      if (inside) {
        for (int c = 0; c < kCin; ++c) {
#pragma unroll
          for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 5; ++dx) {
              const float val = xs[(c * xh + yy + dy) * xw + xx + dx];
#pragma unroll
              for (int m = 0; m < G; ++m)
                acc[m] = fmaf(wg[((m * kCin + c) * 5 + dy) * 5 + dx], val, acc[m]);
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < G; ++m)
        if (g0 + m < cm)
          hs[((g0 + m) * hh + yy) * hw + xx] =
              inside ? cfen::add_bias<T>(acc[m], bs[g0 + m]) : 0.f;
    }
  }

  // r1 = relu(conv3x3(h) + b1) on the tile plus halo 1; zero outside
  for (int g0 = 0; g0 < cm; g0 += G) {
    stage_group(w1, g0, cm * 9);
    for (int i = tid; i < rh * rw; i += kThreads) {
      const int yy = i / rw, xx = i % rw;
      const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
      float acc[G];
#pragma unroll
      for (int m = 0; m < G; ++m) acc[m] = 0.f;
      if (inside) {
        for (int c = 0; c < cm; ++c) {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float val = hs[(c * hh + yy + dy) * hw + xx + dx];
#pragma unroll
              for (int m = 0; m < G; ++m)
                acc[m] = fmaf(wg[((m * cm + c) * 3 + dy) * 3 + dx], val, acc[m]);
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < G; ++m)
        if (g0 + m < cm)
          rs[((g0 + m) * rh + yy) * rw + xx] =
              inside ? fmaxf(cfen::add_bias<T>(acc[m], bs[cm + g0 + m]), 0.f) : 0.f;
    }
  }

  // out = h + conv3x3(r1) + b2 on the tile
  T* on = out + static_cast<size_t>(n) * cm * h * wd;
  for (int g0 = 0; g0 < cm; g0 += G) {
    stage_group(w2, g0, cm * 9);
    for (int i = tid; i < th * tw; i += kThreads) {
      const int yy = i / tw, xx = i % tw;
      const int gy = y0 + yy, gx = x0 + xx;
      if (gy >= h || gx >= wd) continue;
      float acc[G];
#pragma unroll
      for (int m = 0; m < G; ++m) acc[m] = 0.f;
      for (int c = 0; c < cm; ++c) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float val = rs[(c * rh + yy + dy) * rw + xx + dx];
#pragma unroll
            for (int m = 0; m < G; ++m)
              acc[m] = fmaf(wg[((m * cm + c) * 3 + dy) * 3 + dx], val, acc[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < G; ++m) {
        if (g0 + m >= cm) continue;
        const float hv = hs[((g0 + m) * hh + yy + 2) * hw + xx + 2];
        on[(static_cast<size_t>(g0 + m) * h + gy) * wd + gx] =
            cfen::from_f<T>(hv + cfen::add_bias<T>(acc[m], bs[2 * cm + g0 + m]));
      }
    }
  }
}

template <typename T, int G>
cudaError_t launch(const void* x, const void* w5, const void* b5, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* o, int batch, int cm,
                   int h, int wd, cudaStream_t stream) {
  const int tile = stem_tile(cm);
  if (tile < 0) return cudaErrorInvalidValue;
  const int th = kTiles[tile][0], tw = kTiles[tile][1];
  const size_t smem = stem_floats(cm, G, th, tw) * sizeof(float);
  cudaError_t err = cfen::allow_smem(stem_kernel<T, G>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((wd + tw - 1) / tw, (h + th - 1) / th, batch);
  stem_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w5), static_cast<const T*>(b5),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(o), h, wd, cm, th, tw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_group(const void* x, const void* w5, const void* b5, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* o, int batch,
                           int cm, int h, int wd, cudaStream_t st) {
  switch (stem_group(cm)) {
    case 4: return launch<T, 4>(x, w5, b5, w1, b1, w2, b2, o, batch, cm, h, wd, st);
    case 8: return launch<T, 8>(x, w5, b5, w1, b1, w2, b2, o, batch, cm, h, wd, st);
    case 12: return launch<T, 12>(x, w5, b5, w1, b1, w2, b2, o, batch, cm, h, wd, st);
    default: return launch<T, 16>(x, w5, b5, w1, b1, w2, b2, o, batch, cm, h, wd, st);
  }
}

}  // namespace

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
    return dispatch_group<float>(x, w5, b5, w1, b1, w2, b2, o, batch, cmid, h, wd, st);
  if (dtype == cfen::kBFloat16)
    return dispatch_group<__nv_bfloat16>(x, w5, b5, w1, b1, w2, b2, o, batch, cmid, h, wd,
                                         st);
  return cudaErrorInvalidValue;
}
