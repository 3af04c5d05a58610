// K1: block attention, softmax(Q K^T / sqrt(dh)) V for all heads of [N,S,E].
//
// Replaces cfen_vit_tpu/ops/pallas_attn.py fused_block_attention (kernel
// _attn_kernel); computes what models/vit.py attention_core computes,
// including its bf16 rounding: exp values stored in bf16 and divided by the
// bf16 denominator, the quotient rounded to bf16 before P V.  The kernel
// (a tensor-core redesign of the port's first, scalar K1), its bound and its design are in
// attn.cuh, which K2 (vit.cu) shares.
#include "attn.cuh"

// q, k, v: contiguous [n, s, heads * hs], each head's dh = e / heads
// columns hs >= dh apart (hs > dh: zero padding, for an odd bf16 dh);
// o: contiguous [n, s, e]; dtype per cfen::DType.
extern "C" int cfen_attn_fwd(const void* q, const void* k, const void* v, void* o, int n,
                             int s, int e, int heads, int hs, int dtype, void* stream) {
  if (n <= 0 || s <= 0 || heads <= 0 || e % heads != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dh = e / heads;
  if (dtype == cfen::kFloat32) {
    using T = float;
    return cfen::attn::dispatch_dh<T, false>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), n, s, heads * hs, e, heads, dh, hs, st);
  }
  if (dtype == cfen::kBFloat16) {
    using T = __nv_bfloat16;
    return cfen::attn::dispatch_dh<T, false>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), n, s, heads * hs, e, heads, dh, hs, st);
  }
  return cudaErrorInvalidValue;
}
