// K3: tail epilogue, tanh(conv7x7(reflect_pad(t2, 3)) + bias), c -> out_c
// channels at full resolution, NCHW, for any input channel count c.
//
// Replaces cfen_vit_tpu/ops/pallas_tail.py conv7_tail_epilogue (kernel
// _k2cf); computes what models/generator.py _tail_epilogue_plain computes.
//
// Bound on Hopper: each output pixel needs 49 c out_c multiply-adds over a
// c-channel input read once from device memory (12 or 16 channels, 3 or 1
// out: 1764 or 588 at n_feats 24).  The function is bound by device memory
// in bf16 (about 0.017 ms at [4,12,512,512]) and by the float32 FFMA rate
// in float32 (about 0.07 ms).  The port's first kernel took one shared
// load per FMA, scalar float32 in both dtypes (0.59 / 0.56 ms), so it was
// bound by shared-memory loads, not by the card.
//
// bf16: an implicit GEMM on the tensor cores (mma.sync m16n8k16, float32
// accumulation).  M is output pixels, K is (tap, input channel) with the
// channels of a chunk padded to 16, N is out_c padded to 8 with zero
// weights.  A block of 8 warps owns a 16 x 32 output tile and stages its
// input with the 3-pixel halo channel-last in shared memory,
// [22][38][24] bf16 for a chunk of 16 channels (a pixel's 16 channels plus
// 8 of padding: 48-byte rows, so the 8 rows of an ldmatrix phase fall in
// 8 distinct 16-byte bank groups), reflect index computed at staging as
// torch ReflectionPad2d does (edge excluded).  The weights of the chunk
// sit beside it as [8][49 x 16 + 8] (out channel, tap-major k).  For tap
// (dy, dx) the A fragment of 16 consecutive output pixels of one row is 16
// shared rows of 16 contiguous channels, one ldmatrix.x4.  A warp owns 4
// output rows of 16 pixels; for each tap column dx it loads the 7 B
// fragments (two 32-bit loads each) and the A fragments of the 10 input
// rows its output rows read, each used by every output row it is a tap of:
// 70 ldmatrix for 196 products a chunk, where one ldmatrix a product would
// read 2.8 times the bytes.  Wider c (24 at the full-resolution trunk, any c) loops
// over chunks of 16.  Padding N to 8 leaves 5 of 8 columns (out_c 3, the R
// and D tails) or 7 of 8 (out_c 1, the S tail) zero; that costs no time,
// since the shared-memory reads of A and B, which N does not change, set
// the pace.  Design bound: the padded products, 49 x 16 x 8
// multiply-adds a pixel and chunk, at 989 TFLOP/s (0.013 ms at
// [4,12,512,512]); the shared-memory reads (70 ldmatrix of 512 bytes and
// 98 four-byte B loads a warp, chunk and 64 pixels, at 128 bytes a clock
// an SM) take about twice that.  The staging transposes NCHW to channel-last and
// reflects at the border element by element, so it goes through
// registers (8 channels of a pixel, one 16-byte shared store); cp.async
// copies bytes unchanged and at least 4 of them.  The epilogue rounds
// where the plain version stores bf16 tensors: the conv sum, the sum plus
// bias, the tanh.
//
// float32: a register-blocked FFMA loop.  By count (PERF.md, Findings)
// 3xTF32 would run 49 x 16 x 8 x 3 = 18816 TF32 multiply-adds a pixel
// for 1764 useful (588 at out_c 1): 76 fs a pixel at 495 TFLOP/s against
// 53 (18) for FFMA at 67.  Each thread owns 4 vertically adjacent output
// pixels of one column of a 32 x 32 tile; for each input channel and tap
// column dx it loads the 10 input values of its column once and the 7 x
// out_c weights of (channel, dx) as float4 broadcasts, and makes 28 out_c
// FMAs from them: 16 shared loads per 84 FMAs at out_c 3, where the first
// kernel took 4 per 3.  The input tile (8 channels a chunk, [8][38][38]
// floats) comes in with cp.async, one 4-byte element per copy at its
// reflected address.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kK = 7;
constexpr int kR = kK / 2;
constexpr int kTaps = kK * kK;
constexpr int kThreads = 256;

// torch ReflectionPad2d index (edge not repeated), clamped for the parts of
// a border tile whose outputs are not stored
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// ---- bf16: implicit GEMM on mma.sync ----

using bf16 = __nv_bfloat16;
constexpr int kMH = 16, kMW = 32;                       // output tile
constexpr int kSH = kMH + 2 * kR, kSW = kMW + 2 * kR;   // input tile, 22 x 38
constexpr int kCC = 16;                                 // channels a chunk: one k16 a tap
constexpr int kCPH = kCC + 8;                           // a pixel's row: 48 bytes
constexpr int kBK = kTaps * kCC + 8;                    // a weight row: 1584 bytes
constexpr size_t kMmaSmem = sizeof(bf16) * (static_cast<size_t>(kSH) * kSW * kCPH + 8 * kBK);

__device__ __forceinline__ uint32_t pair(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

template <int OC>
__global__ void __launch_bounds__(kThreads)
tail_mma_kernel(const bf16* __restrict__ t2, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, bf16* __restrict__ out, int cin, int h, int wd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);  // [kSH * kSW][kCPH]
  bf16* wt = tile + kSH * kSW * kCPH;               // [8][kBK]: [n][tap * 16 + c]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int x0 = blockIdx.x * kMW, y0 = blockIdx.y * kMH, n = blockIdx.z;
  const size_t plane = static_cast<size_t>(h) * wd;
  const bf16* src = t2 + static_cast<size_t>(n) * cin * plane;
  const bf16 zero = __float2bfloat16(0.f);
  // strip r of the warp: output row 4 (warp / 2) + r, columns 16 (warp %
  // 2) .. +15; this lane's ldmatrix row is column lane % 16 of it,
  // channels 8 (lane / 16) .. +7
  const int row0 = 4 * (warp >> 1), col0 = 16 * (warp & 1);
  const bf16* arow = tile + (row0 * kSW + col0 + (lane & 15)) * kCPH + 8 * (lane >> 4);
  float acc[4][4] = {};

  for (int c0 = 0; c0 < cin; c0 += kCC) {
    const int nc = min(kCC, cin - c0);
    __syncthreads();   // the last chunk's reads are done
    for (int i = tid; i < 8 * kBK / 8; i += kThreads)
      reinterpret_cast<uint4*>(wt)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    // the chunk's weights in their own order (coalesced), to [m][tap * 16 + c]
#pragma unroll 4
    for (int i = tid; i < OC * nc * kTaps; i += kThreads) {
      const int m = i / (nc * kTaps), rem = i % (nc * kTaps);
      wt[m * kBK + rem % kTaps * kCC + rem / kTaps] =
          w[(static_cast<size_t>(m) * cin + c0) * kTaps + rem];
    }
    // one pixel's 8 channels of the halo tile per item, one 16-byte store
#pragma unroll 2
    for (int i = tid; i < kSH * kSW * (kCC / 8); i += kThreads) {
      const int grp = i / (kSH * kSW), pix = i % (kSH * kSW);
      const int gy = reflect(y0 + pix / kSW - kR, h), gx = reflect(x0 + pix % kSW - kR, wd);
      const bf16* p = src + static_cast<size_t>(gy) * wd + gx;
      const int c = c0 + 8 * grp;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = pair(c + 2 * e < cin ? p[(c + 2 * e) * plane] : zero,
                    c + 2 * e + 1 < cin ? p[(c + 2 * e + 1) * plane] : zero);
      *reinterpret_cast<uint4*>(tile + pix * kCPH + 8 * grp) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    // for each tap column dx, each of the 10 input rows the warp's 4 output
    // rows read is one ldmatrix, shared by the output rows it is a tap of
#pragma unroll
    for (int dx = 0; dx < kK; ++dx) {
      uint32_t b[kK][2];
#pragma unroll
      for (int dy = 0; dy < kK; ++dy) {
        const bf16* wb = wt + g * kBK + (dy * kK + dx) * kCC + 2 * t;
        b[dy][0] = cfen::mma::lds32(wb);
        b[dy][1] = cfen::mma::lds32(wb + 8);
      }
#pragma unroll
      for (int ir = 0; ir < 4 + kK - 1; ++ir) {
        uint32_t a[4];
        cfen::mma::ldmatrix_x4(a, arow + (ir * kSW + dx) * kCPH);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (ir - r >= 0 && ir - r < kK) cfen::mma::bf16_16816(acc[r], a, b[ir - r]);
      }
    }
  }
  // accumulator e of strip r: pixel g + 8 (e / 2), out channel 2t + e % 2
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int oy = y0 + row0 + r;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * t + (e & 1), ox = x0 + col0 + g + 8 * (e >> 1);
      if (m < OC && oy < h && ox < wd)
        out[((static_cast<size_t>(n) * OC + m) * h + oy) * wd + ox] = cfen::from_f<bf16>(
            tanhf(cfen::add_bias<bf16>(acc[r][e], cfen::to_f(bias[m]))));
    }
  }
}

// ---- float32: register-blocked FFMA ----

constexpr int kFW = 32, kFH = 32, kRY = 4;               // output tile; rows a thread
constexpr int kFSH = kFH + 2 * kR, kFSW = kFW + 2 * kR;  // 38 x 38
constexpr int kFCB = 8;                                  // channels a chunk
// weights of one (channel, dx): [dy][m], padded to whole float4s
template <int OC> constexpr int kWP = (kK * OC + 3) / 4 * 4;
template <int OC>
constexpr size_t kFfmaSmem = sizeof(float) * kFCB * (kFSH * kFSW + kK * kWP<OC>);

template <int OC>
__global__ void __launch_bounds__(kThreads)
tail_ffma_kernel(const float* __restrict__ t2, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out, int cin, int h,
                 int wd) {
  constexpr int WP = kWP<OC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [kFCB][kK dx][WP]
  float* tile = ws + kFCB * kK * WP;                // [kFCB][kFSH][kFSW]
  const int tid = threadIdx.y * kFW + threadIdx.x, tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kFW, y0 = blockIdx.y * kFH, n = blockIdx.z;
  const float* src = t2 + static_cast<size_t>(n) * cin * h * wd;
  float acc[kRY][OC] = {};

  for (int c0 = 0; c0 < cin; c0 += kFCB) {
    const int nc = min(kFCB, cin - c0);
    __syncthreads();   // the last chunk's reads are done
    for (int i = tid; i < nc * kFSH * kFSW; i += kThreads) {
      const int c = i / (kFSH * kFSW), rem = i % (kFSH * kFSW);
      const int gy = reflect(y0 + rem / kFSW - kR, h), gx = reflect(x0 + rem % kFSW - kR, wd);
      cfen::mma::cp_async_chunk(tile + i,
                                src + (static_cast<size_t>(c0 + c) * h + gy) * wd + gx, true, 2);
    }
    cfen::mma::cp_async_commit();
    for (int i = tid; i < nc * kK * WP; i += kThreads) {
      const int c = i / (kK * WP), dx = i / WP % kK, j = i % WP, dy = j / OC, m = j % OC;
      ws[i] = j < kK * OC ? w[((static_cast<size_t>(m) * cin + c0 + c) * kK + dy) * kK + dx]
                          : 0.f;
    }
    cfen::mma::cp_async_wait<0>();
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const float* col = tile + (c * kFSH + ty * kRY) * kFSW + tx;
#pragma unroll
      for (int dx = 0; dx < kK; ++dx) {
        float in[kRY + kK - 1];
#pragma unroll
        for (int r = 0; r < kRY + kK - 1; ++r) in[r] = col[r * kFSW + dx];
        float wr[WP];
#pragma unroll
        for (int j = 0; j < WP; j += 4)
          *reinterpret_cast<float4*>(wr + j) =
              *reinterpret_cast<const float4*>(ws + (c * kK + dx) * WP + j);
#pragma unroll
        for (int dy = 0; dy < kK; ++dy)
#pragma unroll
          for (int m = 0; m < OC; ++m)
#pragma unroll
            for (int r = 0; r < kRY; ++r) acc[r][m] = fmaf(wr[dy * OC + m], in[r + dy], acc[r][m]);
      }
    }
  }
  const int ox = x0 + tx;
  if (ox >= wd) return;
#pragma unroll
  for (int r = 0; r < kRY; ++r) {
    const int oy = y0 + ty * kRY + r;
    if (oy >= h) break;
#pragma unroll
    for (int m = 0; m < OC; ++m)
      out[((static_cast<size_t>(n) * OC + m) * h + oy) * wd + ox] =
          tanhf(acc[r][m] + bias[m]);
  }
}

template <int OC>
cudaError_t launch(const void* t2, const void* w, const void* b, void* o, int batch, int cin,
                   int h, int wd, int dtype, cudaStream_t stream) {
  if (dtype == cfen::kBFloat16) {
    static bool allowed[64] = {};
    cudaError_t err = cfen::allow_smem_once(tail_mma_kernel<OC>, allowed);
    if (err != cudaSuccess) return err;
    dim3 grid((wd + kMW - 1) / kMW, (h + kMH - 1) / kMH, batch);
    tail_mma_kernel<OC><<<grid, kThreads, kMmaSmem, stream>>>(
        static_cast<const bf16*>(t2), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
        static_cast<bf16*>(o), cin, h, wd);
    return cudaGetLastError();
  }
  if (dtype == cfen::kFloat32) {
    static bool allowed[64] = {};
    cudaError_t err = cfen::allow_smem_once(tail_ffma_kernel<OC>, allowed);
    if (err != cudaSuccess) return err;
    dim3 grid((wd + kFW - 1) / kFW, (h + kFH - 1) / kFH, batch);
    tail_ffma_kernel<OC><<<grid, dim3(kFW, kThreads / kFW), kFfmaSmem<OC>, stream>>>(
        static_cast<const float*>(t2), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(o), cin, h, wd);
    return cudaGetLastError();
  }
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
  if (out_c == 3) return launch<3>(t2, w, b, o, batch, cin, h, wd, dtype, st);
  if (out_c == 1) return launch<1>(t2, w, b, o, batch, cin, h, wd, dtype, st);
  return cudaErrorInvalidValue;
}
