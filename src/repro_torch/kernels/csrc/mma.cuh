// Tensor-core and asynchronous-copy helpers shared by the bf16 kernels of
// K1 (flash attention) and K3 (the SSD scan), as inline PTX for sm_90a:
//
//   cp.async     16 bytes a thread from device to shared memory, bypassing
//                the registers; commit_group / wait_group mark the stages;
//   ldmatrix     four 8 x 8 tiles of 16-bit values from shared memory into
//                the fragment layout of mma.sync (.trans for the operand
//                whose rows run along the product's depth);
//   mma.sync     m16n8k16, bf16 operands, f32 accumulators.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A (16 x 16,
// row-major) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
// a3 = (g+8, 2t+8..); B (16 x 8, "col") b0 = (k 2t..2t+1, n g),
// b1 = (k 2t+8.., n g); C (16 x 8 f32) c0,c1 = (g, 2t..2t+1),
// c2,c3 = (g+8, 2t..2t+1).  The lower column of each pair sits in the
// lower half of its 32-bit register.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes, or write 16 zero bytes where `valid` is false (src is then
// not read, but must still be a device address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` committed groups are still in flight.
template <int pending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Lanes 8m..8m+7 give the row addresses of tile m (16 bytes each).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += t, fragment-wise, in f32 adds that round to nearest.  The tensor
// cores sum a product into its accumulator with truncation; a product
// taken into a zeroed fragment and then added here keeps that truncation
// away from a long running sum.
__device__ __forceinline__ void add_frag(float (&d)[4], const float (&t)[4]) {
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) rounded to a bf16 pair, x0 in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bf16_bits(__floats2bfloat162_rn(x0, x1));
}

// An f32 pair as three bf16 pairs, hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid) (each difference is exact in f32): hi + mid + lo
// carries x to about f32's precision, and products with an exact bf16
// operand, the three accumulated in f32, round like f32 operands would.
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16_bits(h);
  mid = bf16_bits(m);
  lo = pack_bf16(r0 - mf.x, r1 - mf.y);
}

}  // namespace repro
