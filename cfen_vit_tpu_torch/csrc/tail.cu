// K3: tail epilogue, tanh(conv7x7(reflect_pad(t2, 3)) + bias), c -> out_c
// channels at full resolution, NCHW, for any input channel count c.
//
// Replaces cfen_vit_tpu/ops/pallas_tail.py conv7_tail_epilogue (kernel
// _k2cf); computes what models/generator.py _tail_epilogue_plain computes.
//
// Bound on Hopper: at 512x512 each output pixel needs c * 49 * out_c FMAs
// over a c-channel input that is read once, so the kernel is bound by
// shared-memory reads of the input tile, not by device memory.  Design:
// one thread per output pixel, a 32x8 block over a shared-memory input tile
// with a 3-pixel halo and the weights in shared memory (read as
// broadcasts).  The channels go through the tile in chunks of kCB (16):
// 16 x 14 x 38 floats of input and 16 x 49 x out_c of weights, 43 KB of
// static shared memory whatever c is (12 at n_feats 24, 16 at the
// defaults' n_feats 32, 24 at the full-resolution trunk's); the pixel's
// float32 sums run on in registers from chunk to chunk, over the channels
// in order.  The reflect index is computed in the kernel as torch
// ReflectionPad2d does (edge excluded), so there is no separate pad pass
// and no padded copy of the input; the TPU kernel's alignment rows have
// no counterpart.  Neighbouring threads read neighbouring columns, so both
// the global loads and the tile reads are conflict-free.  bf16 rounds
// where the plain version stores bf16 tensors: the conv sum, the sum plus
// bias, the tanh.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kCB = 16;  // input channels per pass through the tile
constexpr int kK = 7;
constexpr int kR = kK / 2;
constexpr int kTW = 32, kTH = 8;  // output tile = block shape
constexpr int kSW = kTW + 2 * kR, kSH = kTH + 2 * kR;

// torch ReflectionPad2d index (edge not repeated), clamped for the parts of
// a border tile whose outputs are not stored
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

template <typename T, int OC>
__global__ void __launch_bounds__(kTW * kTH)
tail_kernel(const T* __restrict__ t2, const T* __restrict__ w, const T* __restrict__ bias,
            T* __restrict__ out, int cin, int h, int wd) {
  __shared__ float tile[kCB][kSH][kSW];
  __shared__ float ws[OC * kCB * kK * kK];  // [m][c of the chunk][7][7]
  __shared__ float bs[OC];
  const int tid = threadIdx.y * kTW + threadIdx.x;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH, n = blockIdx.z;
  if (tid < OC) bs[tid] = cfen::to_f(bias[tid]);
  const T* src = t2 + static_cast<size_t>(n) * cin * h * wd;
  const int ox = x0 + threadIdx.x, oy = y0 + threadIdx.y;
  float acc[OC];
#pragma unroll
  for (int m = 0; m < OC; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCB) {
    const int nc = min(kCB, cin - c0);
    if (c0 > 0) __syncthreads();   // the last chunk's reads are done
    for (int i = tid; i < OC * nc * kK * kK; i += kTW * kTH) {
      const int m = i / (nc * kK * kK), rem = i % (nc * kK * kK);
      ws[m * kCB * kK * kK + rem] =
          cfen::to_f(w[(static_cast<size_t>(m) * cin + c0) * kK * kK + rem]);
    }
    for (int i = tid; i < nc * kSH * kSW; i += kTW * kTH) {
      const int c = i / (kSH * kSW), rem = i % (kSH * kSW);
      const int yy = rem / kSW, xx = rem % kSW;
      const int gy = reflect(y0 + yy - kR, h), gx = reflect(x0 + xx - kR, wd);
      tile[c][yy][xx] = cfen::to_f(src[(static_cast<size_t>(c0 + c) * h + gy) * wd + gx]);
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int dy = 0; dy < kK; ++dy) {
#pragma unroll
        for (int dx = 0; dx < kK; ++dx) {
          const float val = tile[c][threadIdx.y + dy][threadIdx.x + dx];
#pragma unroll
          for (int m = 0; m < OC; ++m)
            acc[m] = fmaf(ws[((m * kCB + c) * kK + dy) * kK + dx], val, acc[m]);
        }
      }
    }
  }
  if (ox >= wd || oy >= h) return;
#pragma unroll
  for (int m = 0; m < OC; ++m)
    out[((static_cast<size_t>(n) * OC + m) * h + oy) * wd + ox] =
        cfen::from_f<T>(tanhf(cfen::add_bias<T>(acc[m], bs[m])));
}

template <typename T, int OC>
cudaError_t launch(const void* t2, const void* w, const void* b, void* o, int batch, int cin,
                   int h, int wd, cudaStream_t stream) {
  dim3 grid((wd + kTW - 1) / kTW, (h + kTH - 1) / kTH, batch);
  tail_kernel<T, OC><<<grid, dim3(kTW, kTH), 0, stream>>>(
      static_cast<const T*>(t2), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(o), cin, h, wd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_oc(const void* t2, const void* w, const void* b, void* o, int batch,
                        int cin, int h, int wd, int out_c, cudaStream_t stream) {
  if (out_c == 3) return launch<T, 3>(t2, w, b, o, batch, cin, h, wd, stream);
  if (out_c == 1) return launch<T, 1>(t2, w, b, o, batch, cin, h, wd, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// t2: [batch, cin, h, wd]; w: [out_c, cin, 7, 7]; b: [out_c];
// o: [batch, out_c, h, wd]; all contiguous, one dtype.
extern "C" int cfen_tail_fwd(const void* t2, const void* w, const void* b, void* o, int batch,
                             int cin, int h, int wd, int out_c, int dtype, void* stream) {
  // reflect padding by 3 needs at least 4 rows and columns
  if (batch <= 0 || cin <= 0 || h <= kR || wd <= kR || batch > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32)
    return dispatch_oc<float>(t2, w, b, o, batch, cin, h, wd, out_c, st);
  if (dtype == cfen::kBFloat16)
    return dispatch_oc<__nv_bfloat16>(t2, w, b, o, batch, cin, h, wd, out_c, st);
  return cudaErrorInvalidValue;
}
