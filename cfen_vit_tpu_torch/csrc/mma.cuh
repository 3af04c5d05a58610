// Tensor-core fragment helpers shared by the kernels on the tensor cores:
// mma.sync products in bf16 and TF32 with float32 accumulation, the 3xTF32
// split that keeps a float32 product at float32 accuracy, ldmatrix and
// cp.async.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k*"), with
// g = lane / 4 and t = lane % 4:
//   m16n8k16 bf16  A: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..);  B: b0 (k 2t..2t+1, n g)
//                     b1 (k 2t+8.., n g)
//   m16n8k8  bf16  A: a0 (g, 2t..2t+1)  a1 (g+8, 2t..);  B: b0 (k 2t.., n g)
//   m16n8k8  tf32  A: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4);
//                  B: b0 (k t, n g)  b1 (k t+4, n g)
//   accumulator    c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// Each product adds into its accumulator in place.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

namespace cfen {
namespace mma {

__device__ __forceinline__ void bf16_16816(float c[4], const uint32_t a[4],
                                           const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void bf16_1688(float c[4], const uint32_t a[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void tf32_1688(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to TF32 (10 explicit mantissa bits, to nearest, ties away)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// 3xTF32: x = hi + lo to about 2^-22 of x, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// n values split into TF32 hi and lo parts
template <int N>
__device__ __forceinline__ void split_n(const float* x, uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

// c += a b in float32 accuracy from TF32 products of split operands: the
// two small cross terms first, then the large one; lo * lo (about 2^-22 of
// the product) is dropped
__device__ __forceinline__ void tf32x3_1688(float c[4], const uint32_t ah[4],
                                            const uint32_t al[4], const uint32_t bh[2],
                                            const uint32_t bl[2]) {
  tf32_1688(c, al, bh);
  tf32_1688(c, ah, bl);
  tf32_1688(c, ah, bh);
}

// acc += part for n values, each add rounded to nearest.  The 3xTF32
// kernels (K2's linears, K6) sum each k stage's products into a zero
// `part` and add it to the sum here: the tensor cores' own accumulate
// truncates, and a sum carried over a long k in one accumulator drifts
// toward zero by up to an ulp of itself a product (past K2's float32
// tolerance at k 5120)
template <int N>
__device__ __forceinline__ void add_rn(float* acc, const float* part) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// two bf16 values packed into one 32-bit register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 8x8 b16 matrices transposed: lanes 0-7 give the row addresses of the
// first, lanes 8-15 of the second (16-byte aligned rows).  Lane l gets
// elements (2t, g) and (2t+1, g) of each: the B fragment of a k16 product
// whose k runs along the stored rows.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// Four 8x8 b16 matrices as they are stored: lanes 0-7, 8-15, 16-23, 24-31
// give the rows of the first to the fourth.  With lane l pointing at row
// l % 16, column 8 (l / 16) of a 16x16 tile, r is the tile's A fragment of
// a m16n8k16 product.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Four such matrices transposed: lanes 0-7, 8-15, 16-23, 24-31 give the rows of the
// first to the fourth; r[0..1] and r[2..3] are then the B fragments of two
// k16 products when lanes 16-31 point 8 columns past lanes 0-15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes global -> shared without registers; zero-filled when !valid
// (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}

// 16 >> shift bytes (16, 8 or 4) global -> shared without registers;
// zero-filled when !valid (src must still be a mapped address); both
// addresses aligned to the chunk
__device__ __forceinline__ void cp_async_chunk(void* dst, const void* src, bool valid,
                                               int shift) {
  if (shift == 0) return cp_async16(dst, src, valid);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 >> shift : 0;
  if (shift == 1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma
}  // namespace cfen
