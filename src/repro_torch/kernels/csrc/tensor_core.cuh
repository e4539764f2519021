// Warp-level tensor-core primitives shared by the kernels:
// ldmatrix loads of 8x8 bf16 tiles from shared memory, the m16n8k16
// bf16 x bf16 -> f32 multiply-accumulate (mma.sync), and 16-byte asynchronous
// copies from global to shared memory (cp.async).
//
// Fragment layouts (lane = 4*g + t, g in 0..7, t in 0..3):
//   A (16x16, row):  a0 = (row g,   cols 2t,2t+1)   a1 = (row g+8, cols 2t,2t+1)
//                    a2 = (row g,   cols 2t+8,+9)   a3 = (row g+8, cols 2t+8,+9)
//   B (16x8,  col):  b0 = (rows 2t,2t+1, col g)     b1 = (rows 2t+8,+9, col g)
//   C (16x8,  f32):  c0,c1 = (row g, cols 2t,2t+1)  c2,c3 = (row g+8, same cols)
// so two neighbouring C tiles, packed to bf16, are one A fragment.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&t);
}

// 16 bytes global -> shared without passing through registers; zeros when
// `valid` is false (the source is then not read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(bytes)
               : "memory");
}

// wait for every cp.async this thread has started
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// close the group of cp.async started since the last commit (a group may be
// empty), and wait until at most N of this thread's groups are in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
