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
// is the direct bilinear im2col form.  Bound on the H100: the product's
// 2*N*OH*OW*K^2*C*O operations; at the benchmark geometries (C, O 48-256)
// the bytes moved (x, offset, mask, out once each) are far fewer than the
// operations over the float32 FMA rate.  Design: a block owns 64 output
// pixels (flattened OH*OW of one image) and up to 64 output channels.  Per
// tap, 64 threads form each pixel's four neighbour indices and float32
// weights once, into shared memory; per chunk of 16 input channels the
// block gathers the chunk's patches (4 loads each, mostly L2 hits) into
// shared memory with the weights' chunk beside it, so every gathered patch
// element feeds all of the block's output channels; each thread keeps a
// 4-pixel by up-to-4-channel tile of sums in registers (scalar float32
// FMA, no tensor cores yet: bf16 runs the same float32 path).  The sampling
// arithmetic uses the plain version's operations in its order, rounded
// alike (__fadd_rn/__fmul_rn: no contraction), so patches equal the plain
// version's bit for bit and only the product's summation order differs.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kP = 64;          // output pixels per block
constexpr int kCC = 16;         // input channels per chunk
constexpr int kThreads = 256;   // 16 x 16: pixel lane tx, channel lane ty

template <typename T, int JN>   // JN output channels per thread, 16 * JN per block
__global__ void __launch_bounds__(kThreads)
deform_kernel(const T* __restrict__ x, const T* __restrict__ offset,
              const T* __restrict__ mask, const T* __restrict__ w,
              const T* __restrict__ bias, T* __restrict__ out, int c_in, int h,
              int wd, int o_out, int k, int ow, int npix, int stride, int pad,
              int dil) {
  constexpr int kOT = 16 * JN;
  __shared__ float patch[kCC][kP];
  __shared__ float ws[kCC][kOT];
  __shared__ int nidx[4][kP];     // neighbour index into one channel, -1 outside
  __shared__ float nwt[4][kP];    // bilinear weights (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx
  __shared__ float msk[kP];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int p0 = blockIdx.x * kP, o0 = blockIdx.y * kOT, n = blockIdx.z;
  const int kk = k * k;
  const size_t hw = static_cast<size_t>(h) * wd;
  const T* xn = x + static_cast<size_t>(n) * c_in * hw;
  const T* offn = offset + static_cast<size_t>(n) * 2 * kk * npix;
  const T* mn = mask + static_cast<size_t>(n) * kk * npix;

  float acc[4][JN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < kk; ++t) {
    // the previous tap's last gather read nidx before the barrier ahead of
    // its product, so the tap's sampling plan can be written now
    if (tid < kP) {
      const int p = p0 + tid;
      int id[4] = {-1, -1, -1, -1};
      float wt[4] = {0.f, 0.f, 0.f, 0.f}, m = 0.f;
      if (p < npix) {
        const int oy = p / ow, ox = p % ow, ky = t / k, kx = t % k;
        const float dy = cfen::to_f(offn[static_cast<size_t>(2 * t) * npix + p]);
        const float dx = cfen::to_f(offn[static_cast<size_t>(2 * t + 1) * npix + p]);
        m = cfen::to_f(mn[static_cast<size_t>(t) * npix + p]);
        const float ys = __fadd_rn(static_cast<float>(oy * stride - pad + ky * dil), dy);
        const float xs = __fadd_rn(static_cast<float>(ox * stride - pad + kx * dil), dx);
        const float y0 = floorf(ys), x0 = floorf(xs);
        const float fy = __fsub_rn(ys, y0), fx = __fsub_rn(xs, x0);
        const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
        wt[0] = __fmul_rn(gy, gx);
        wt[1] = __fmul_rn(gy, fx);
        wt[2] = __fmul_rn(fy, gx);
        wt[3] = __fmul_rn(fy, fx);
        // bounds compared in float, so a far-off sample never becomes an
        // out-of-range int
        const float y1 = __fadd_rn(y0, 1.f), x1 = __fadd_rn(x0, 1.f);
        const float hmax = static_cast<float>(h - 1), wmax = static_cast<float>(wd - 1);
        const float yy[2] = {y0, y1}, xx[2] = {x0, x1};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float yq = yy[q >> 1], xq = xx[q & 1];
          if (yq >= 0.f && yq <= hmax && xq >= 0.f && xq <= wmax)
            id[q] = static_cast<int>(yq) * wd + static_cast<int>(xq);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        nidx[q][tid] = id[q];
        nwt[q][tid] = wt[q];
      }
      msk[tid] = m;
    }

    for (int c0 = 0; c0 < c_in; c0 += kCC) {
      __syncthreads();   // the plan is written; the last product's reads are done
      for (int e = tid; e < kCC * kP; e += kThreads) {
        const int c = e / kP, p = e % kP;
        float v = 0.f;
        if (c0 + c < c_in) {
          const T* xc = xn + static_cast<size_t>(c0 + c) * hw;
          float g[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int id = nidx[q][p];
            g[q] = id >= 0 ? cfen::to_f(xc[id]) : 0.f;
          }
          // ((w00 g00 + w01 g01) + w10 g10) + w11 g11, then times the mask
          float s = __fadd_rn(__fmul_rn(nwt[0][p], g[0]), __fmul_rn(nwt[1][p], g[1]));
          s = __fadd_rn(s, __fmul_rn(nwt[2][p], g[2]));
          s = __fadd_rn(s, __fmul_rn(nwt[3][p], g[3]));
          v = cfen::round_to<T>(__fmul_rn(s, msk[p]));
        }
        patch[c][p] = v;
      }
      for (int e = tid; e < kCC * kOT; e += kThreads) {
        const int c = e / kOT, o = e % kOT;
        ws[c][o] = (c0 + c < c_in && o0 + o < o_out)
                       ? cfen::to_f(w[(static_cast<size_t>(o0 + o) * c_in + c0 + c) * kk + t])
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kCC; ++c) {
        float pv[4], wv[JN];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = patch[c][tx + 16 * i];
#pragma unroll
        for (int j = 0; j < JN; ++j) wv[j] = ws[c][ty + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(pv[i], wv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < JN; ++j) {
    const int o = o0 + ty + 16 * j;
    if (o >= o_out) continue;
    const float b = bias ? cfen::to_f(bias[o]) : 0.f;
    T* dst = out + (static_cast<size_t>(n) * o_out + o) * npix;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + tx + 16 * i;
      if (p < npix)
        dst[p] = cfen::from_f<T>(bias ? cfen::add_bias<T>(acc[i][j], b) : acc[i][j]);
    }
  }
}

template <typename T, int JN>
cudaError_t launch(const void* x, const void* off, const void* m, const void* w,
                   const void* b, void* o, int n, int c, int h, int wd, int o_out,
                   int k, int ow, int npix, int stride, int pad, int dil,
                   cudaStream_t st) {
  dim3 grid((npix + kP - 1) / kP, (o_out + 16 * JN - 1) / (16 * JN), n);
  deform_kernel<T, JN><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(off), static_cast<const T*>(m),
      static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(o), c, h, wd,
      o_out, k, ow, npix, stride, pad, dil);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_jn(const void* x, const void* off, const void* m, const void* w,
                        const void* b, void* o, int n, int c, int h, int wd, int o_out,
                        int k, int ow, int npix, int stride, int pad, int dil,
                        cudaStream_t st) {
  switch (o_out >= 64 ? 4 : (o_out + 15) / 16) {
    case 1: return launch<T, 1>(x, off, m, w, b, o, n, c, h, wd, o_out, k, ow, npix, stride, pad, dil, st);
    case 2: return launch<T, 2>(x, off, m, w, b, o, n, c, h, wd, o_out, k, ow, npix, stride, pad, dil, st);
    case 3: return launch<T, 3>(x, off, m, w, b, o, n, c, h, wd, o_out, k, ow, npix, stride, pad, dil, st);
    default: return launch<T, 4>(x, off, m, w, b, o, n, c, h, wd, o_out, k, ow, npix, stride, pad, dil, st);
  }
}

}  // namespace

// x: [n, c, h, wd]; offset: [n, 2 k^2, oh, ow] ((dy, dx) per tap); mask:
// [n, k^2, oh, ow]; w: [o_out, c, k, k]; b: [o_out] or null; out: [n, o_out,
// oh, ow]; all contiguous, one dtype.
extern "C" int cfen_deform_fwd(const void* x, const void* offset, const void* mask,
                               const void* w, const void* b, void* out, int n, int c,
                               int h, int wd, int o_out, int k, int oh, int ow,
                               int stride, int pad, int dil, int dtype, void* stream) {
  if (n <= 0 || n > 65535 || c <= 0 || h <= 0 || wd <= 0 || o_out <= 0 ||
      (k != 3 && k != 5) || stride <= 0 || pad < 0 || dil <= 0)
    return cudaErrorInvalidValue;
  const int span_y = h + 2 * pad - (dil * (k - 1) + 1);
  const int span_x = wd + 2 * pad - (dil * (k - 1) + 1);
  if (span_y < 0 || span_x < 0 || oh != span_y / stride + 1 || ow != span_x / stride + 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cfen::kFloat32)
    return dispatch_jn<float>(x, offset, mask, w, b, out, n, c, h, wd, o_out, k, ow, oh * ow,
                              stride, pad, dil, st);
  if (dtype == cfen::kBFloat16)
    return dispatch_jn<__nv_bfloat16>(x, offset, mask, w, b, out, n, c, h, wd, o_out, k, ow,
                                      oh * ow, stride, pad, dil, st);
  return cudaErrorInvalidValue;
}
