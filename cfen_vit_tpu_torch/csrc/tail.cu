// K3: tail epilogue, tanh(conv7x7(reflect_pad(t2, 3)) + bias), 12 -> out_c
// channels at full resolution, NCHW.
//
// Replaces cfen_vit_tpu/ops/pallas_tail.py conv7_tail_epilogue (kernel
// _k2cf); computes what models/generator.py _tail_epilogue_plain computes.
//
// Bound on Hopper: at 512x512 each output pixel needs 12 * 49 * out_c FMAs
// over a 12-channel input that is read once, so the kernel is bound by
// shared-memory reads of the input tile, not by device memory.  Design:
// one thread per output pixel, a 32x8 block over a shared-memory input tile
// with a 3-pixel halo (12 x 14 x 38 floats) and the weights in shared
// memory (read as broadcasts).  The reflect index is computed in the
// kernel as torch ReflectionPad2d does (edge excluded), so there is no
// separate pad pass and no padded copy of the input; the TPU kernel's
// alignment rows have no counterpart.  Neighbouring threads read
// neighbouring columns, so both the global loads and the tile reads are
// conflict-free.  bf16 rounds where the plain version stores bf16
// tensors: the conv sum, the sum plus bias, the tanh.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kC = 12;  // input channels
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
            T* __restrict__ out, int h, int wd) {
  __shared__ float tile[kC][kSH][kSW];
  __shared__ float ws[OC * kC * kK * kK];
  __shared__ float bs[OC];
  const int tid = threadIdx.y * kTW + threadIdx.x;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH, n = blockIdx.z;

  for (int i = tid; i < OC * kC * kK * kK; i += kTW * kTH) ws[i] = cfen::to_f(w[i]);
  if (tid < OC) bs[tid] = cfen::to_f(bias[tid]);
  const T* src = t2 + static_cast<size_t>(n) * kC * h * wd;
  for (int i = tid; i < kC * kSH * kSW; i += kTW * kTH) {
    const int c = i / (kSH * kSW), rem = i % (kSH * kSW);
    const int yy = rem / kSW, xx = rem % kSW;
    const int gy = reflect(y0 + yy - kR, h), gx = reflect(x0 + xx - kR, wd);
    tile[c][yy][xx] = cfen::to_f(src[(static_cast<size_t>(c) * h + gy) * wd + gx]);
  }
  __syncthreads();

  const int ox = x0 + threadIdx.x, oy = y0 + threadIdx.y;
  if (ox >= wd || oy >= h) return;
  float acc[OC];
#pragma unroll
  for (int m = 0; m < OC; ++m) acc[m] = 0.f;
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int dy = 0; dy < kK; ++dy) {
#pragma unroll
      for (int dx = 0; dx < kK; ++dx) {
        const float val = tile[c][threadIdx.y + dy][threadIdx.x + dx];
#pragma unroll
        for (int m = 0; m < OC; ++m)
          acc[m] = fmaf(ws[((m * kC + c) * kK + dy) * kK + dx], val, acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < OC; ++m)
    out[((static_cast<size_t>(n) * OC + m) * h + oy) * wd + ox] =
        cfen::from_f<T>(tanhf(cfen::add_bias<T>(acc[m], bs[m])));
}

template <typename T, int OC>
cudaError_t launch(const void* t2, const void* w, const void* b, void* o, int batch, int h,
                   int wd, cudaStream_t stream) {
  dim3 grid((wd + kTW - 1) / kTW, (h + kTH - 1) / kTH, batch);
  tail_kernel<T, OC><<<grid, dim3(kTW, kTH), 0, stream>>>(
      static_cast<const T*>(t2), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(o), h, wd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_oc(const void* t2, const void* w, const void* b, void* o, int batch,
                        int h, int wd, int out_c, cudaStream_t stream) {
  if (out_c == 3) return launch<T, 3>(t2, w, b, o, batch, h, wd, stream);
  if (out_c == 1) return launch<T, 1>(t2, w, b, o, batch, h, wd, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// t2: [batch, cin = 12, h, wd]; w: [out_c, 12, 7, 7]; b: [out_c];
// o: [batch, out_c, h, wd]; all contiguous, one dtype.
extern "C" int cfen_tail_fwd(const void* t2, const void* w, const void* b, void* o, int batch,
                             int cin, int h, int wd, int out_c, int dtype, void* stream) {
  // reflect padding by 3 needs at least 4 rows and columns
  if (batch <= 0 || cin != kC || h <= kR || wd <= kR || batch > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32) return dispatch_oc<float>(t2, w, b, o, batch, h, wd, out_c, st);
  if (dtype == cfen::kBFloat16)
    return dispatch_oc<__nv_bfloat16>(t2, w, b, o, batch, h, wd, out_c, st);
  return cudaErrorInvalidValue;
}
