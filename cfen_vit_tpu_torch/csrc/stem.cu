// K4: stem, h = conv5x5(x) 3 -> 12 (zero pad 2), then
// out = h + conv3x3(relu(conv3x3(h))) 12 -> 12 (zero pad 1), NCHW.
//
// Replaces cfen_vit_tpu/ops/pallas_stem.py fused_stem (kernel _kstem);
// computes what models/generator.py _stem_plain computes.
//
// Bound on Hopper: the plain version writes and rereads two 12-channel
// full-resolution maps (h and the relu output), ~100 MB of device traffic
// per 4 images at 512x512; fused, only x is read and the output written.
// Design: one 256-thread block per 16x32 output tile.  The block stages x
// with a halo of 4 in shared memory (zero outside the image), computes h
// on the tile plus a halo of 2 and r1 = relu(conv3x3(h)) on the tile plus
// a halo of 1, both into shared memory, then the output.  h and r1 are
// stored as ZERO outside the image, not computed from the zero-padded x:
// the 3x3 convolutions zero-pad h and r1 themselves (pallas_stem.py masks
// them the same way).  Each thread computes all 12 channels of one
// position at a time, so every weight read is a warp-wide broadcast.
// In bf16 each stage rounds where the plain version stores a bf16 tensor:
// the conv sum, then the sum plus bias (F.conv2d adds its bias after).
#include "common.cuh"

namespace {

constexpr int kCin = 3, kCm = 12;
constexpr int kTH = 16, kTW = 32, kThreads = 256;
constexpr int kXH = kTH + 8, kXW = kTW + 8;  // x tile, halo 4
constexpr int kHH = kTH + 4, kHW = kTW + 4;  // h tile, halo 2
constexpr int kRH = kTH + 2, kRW = kTW + 2;  // r1 tile, halo 1
constexpr int kW5 = kCm * kCin * 25, kW3 = kCm * kCm * 9;
constexpr size_t kSmemFloats =
    kCin * kXH * kXW + kCm * kHH * kHW + kCm * kRH * kRW + kW5 + 2 * kW3 + 3 * kCm;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ x, const T* __restrict__ w5, const T* __restrict__ b5,
            const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
            const T* __restrict__ b2, T* __restrict__ out, int h, int wd) {
  extern __shared__ float smem[];
  float* xs = smem;                   // [kCin][kXH][kXW]
  float* hs = xs + kCin * kXH * kXW;  // [kCm][kHH][kHW]
  float* rs = hs + kCm * kHH * kHW;   // [kCm][kRH][kRW]
  float* w5s = rs + kCm * kRH * kRW;  // [kCm][kCin][5][5]
  float* w1s = w5s + kW5;             // [kCm][kCm][3][3]
  float* w2s = w1s + kW3;
  float* bs = w2s + kW3;              // b5, b1, b2
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH, n = blockIdx.z;

  for (int i = tid; i < kW5; i += kThreads) w5s[i] = cfen::to_f(w5[i]);
  for (int i = tid; i < kW3; i += kThreads) {
    w1s[i] = cfen::to_f(w1[i]);
    w2s[i] = cfen::to_f(w2[i]);
  }
  if (tid < kCm) {
    bs[tid] = cfen::to_f(b5[tid]);
    bs[kCm + tid] = cfen::to_f(b1[tid]);
    bs[2 * kCm + tid] = cfen::to_f(b2[tid]);
  }
  const T* xn = x + static_cast<size_t>(n) * kCin * h * wd;
  for (int i = tid; i < kCin * kXH * kXW; i += kThreads) {
    const int c = i / (kXH * kXW), rem = i % (kXH * kXW);
    const int gy = y0 - 4 + rem / kXW, gx = x0 - 4 + rem % kXW;
    float val = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
      val = cfen::to_f(xn[(static_cast<size_t>(c) * h + gy) * wd + gx]);
    xs[i] = val;
  }
  __syncthreads();

  // h = conv5x5(x) + b5 on the tile plus halo 2; zero outside the image
  for (int i = tid; i < kHH * kHW; i += kThreads) {
    const int yy = i / kHW, xx = i % kHW;
    const int gy = y0 - 2 + yy, gx = x0 - 2 + xx;
    float acc[kCm];
#pragma unroll
    for (int m = 0; m < kCm; ++m) acc[m] = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      for (int c = 0; c < kCin; ++c) {
#pragma unroll
        for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 5; ++dx) {
            const float val = xs[(c * kXH + yy + dy) * kXW + xx + dx];
#pragma unroll
            for (int m = 0; m < kCm; ++m)
              acc[m] = fmaf(w5s[((m * kCin + c) * 5 + dy) * 5 + dx], val, acc[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kCm; ++m)
        hs[(m * kHH + yy) * kHW + xx] = cfen::add_bias<T>(acc[m], bs[m]);
    } else {
#pragma unroll
      for (int m = 0; m < kCm; ++m) hs[(m * kHH + yy) * kHW + xx] = 0.f;
    }
  }
  __syncthreads();

  // r1 = relu(conv3x3(h) + b1) on the tile plus halo 1; zero outside
  for (int i = tid; i < kRH * kRW; i += kThreads) {
    const int yy = i / kRW, xx = i % kRW;
    const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
    float acc[kCm];
#pragma unroll
    for (int m = 0; m < kCm; ++m) acc[m] = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      for (int c = 0; c < kCm; ++c) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float val = hs[(c * kHH + yy + dy) * kHW + xx + dx];
#pragma unroll
            for (int m = 0; m < kCm; ++m)
              acc[m] = fmaf(w1s[((m * kCm + c) * 3 + dy) * 3 + dx], val, acc[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kCm; ++m)
        rs[(m * kRH + yy) * kRW + xx] =
            fmaxf(cfen::add_bias<T>(acc[m], bs[kCm + m]), 0.f);
    } else {
#pragma unroll
      for (int m = 0; m < kCm; ++m) rs[(m * kRH + yy) * kRW + xx] = 0.f;
    }
  }
  __syncthreads();

  // out = h + conv3x3(r1) + b2 on the tile
  T* on = out + static_cast<size_t>(n) * kCm * h * wd;
  for (int i = tid; i < kTH * kTW; i += kThreads) {
    const int yy = i / kTW, xx = i % kTW;
    const int gy = y0 + yy, gx = x0 + xx;
    if (gy >= h || gx >= wd) continue;
    float acc[kCm];
#pragma unroll
    for (int m = 0; m < kCm; ++m) acc[m] = 0.f;
    for (int c = 0; c < kCm; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float val = rs[(c * kRH + yy + dy) * kRW + xx + dx];
#pragma unroll
          for (int m = 0; m < kCm; ++m)
            acc[m] = fmaf(w2s[((m * kCm + c) * 3 + dy) * 3 + dx], val, acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kCm; ++m) {
      const float hv = hs[(m * kHH + yy + 2) * kHW + xx + 2];
      on[(static_cast<size_t>(m) * h + gy) * wd + gx] =
          cfen::from_f<T>(hv + cfen::add_bias<T>(acc[m], bs[2 * kCm + m]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w5, const void* b5, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* o, int batch, int h,
                   int wd, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cfen::allow_smem(stem_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((wd + kTW - 1) / kTW, (h + kTH - 1) / kTH, batch);
  stem_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w5), static_cast<const T*>(b5),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(o), h, wd);
  return cudaGetLastError();
}

}  // namespace

// x: [batch, 3, h, wd]; w5: [12, 3, 5, 5]; w1, w2: [12, 12, 3, 3]; biases [12];
// o: [batch, 12, h, wd]; all contiguous, one dtype.
extern "C" int cfen_stem_fwd(const void* x, const void* w5, const void* b5, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* o,
                             int batch, int cin, int cmid, int h, int wd, int dtype,
                             void* stream) {
  if (batch <= 0 || batch > 65535 || cin != kCin || cmid != kCm || h <= 0 || wd <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32)
    return launch<float>(x, w5, b5, w1, b1, w2, b2, o, batch, h, wd, st);
  if (dtype == cfen::kBFloat16)
    return launch<__nv_bfloat16>(x, w5, b5, w1, b1, w2, b2, o, batch, h, wd, st);
  return cudaErrorInvalidValue;
}
