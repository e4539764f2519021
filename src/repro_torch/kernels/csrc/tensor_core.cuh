// Warp-level tensor-core primitives shared by the kernels:
// ldmatrix loads of 8x8 bf16 tiles from shared memory, the m16n8k16
// bf16 x bf16 -> f32 multiply-accumulate (mma.sync), 16-byte asynchronous
// copies from global to shared memory (cp.async), and split TF32: float32
// products as three m16n8k8 TF32 products (the fragment loaders, the split,
// `mma3`), which the f32 routes of the atom matmul and of flash attention's
// forward and backward share.
//
// Fragment layouts (lane = 4*g + t, g in 0..7, t in 0..3):
//   A (16x16, row):  a0 = (row g,   cols 2t,2t+1)   a1 = (row g+8, cols 2t,2t+1)
//                    a2 = (row g,   cols 2t+8,+9)   a3 = (row g+8, cols 2t+8,+9)
//   B (16x8,  col):  b0 = (rows 2t,2t+1, col g)     b1 = (rows 2t+8,+9, col g)
//   C (16x8,  f32):  c0,c1 = (row g, cols 2t,2t+1)  c2,c3 = (row g+8, same cols)
// so two neighbouring C tiles, packed to bf16, are one A fragment.
//
// The m16n8k8 tf32 x tf32 -> f32 multiply (mma.sync) takes f32 words whose
// low 13 bits are zero (`tf32_rna` and `tf32_lo` make them):
//   A (16x8,  row):  a0 = (row g, col t)   a1 = (row g+8, col t)
//                    a2 = (row g, col t+4) a3 = (row g+8, col t+4)
//   B (8x8,   col):  b0 = (row t, col g)   b1 = (row t+4, col g)
//   C (16x8,  f32):  as above.
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

// c += a (16x8, row) * b (8x8, col), tf32 in, f32 out
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the TF32 value nearest x, ties away from zero, as an f32 bit pattern: the
// bit pattern plus half a TF32 step, capped (unsigned) at x's sign over
// FLT_MAX's bits, its low 13 bits cleared.  The cap keeps a finite x whose
// rounding would carry into the exponent (|x| >= 0x7F7FF000, ~3.4028e38)
// finite, hi = +-0x7F7FE000 with a finite lo, where the bare sum gave an
// infinity (ROADMAP C1); every other finite x rounds as cvt.rna.tf32.f32
// does, a conversion that held the split back (the f32 matmul 2.35 -> 2.21
// ms and forward 0.275 -> 0.243 with the integer form; PERF.md).  An
// infinity stays one; a NaN may come out as 0, an infinity or a NaN (the
// addition may carry through it): `tf32_lo` keeps it.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  const unsigned b = __float_as_uint(x);
  return min(b + 0x1000u, b | 0x7F7FFFFFu) & 0xffffe000u;
}

// the same rounding without the cap, two integer operations: the same bits
// for |x| < 0x7F7FF000, for values bounded by construction (Q scaled by
// log2(e) / sqrt(D) <= 0.18, probabilities) or computed (a score's
// gradient: a value that large has overflowed the plain version's sums too)
__device__ __forceinline__ unsigned tf32_rna_bare(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x's low part, x - hi, truncated to TF32 (its low 13 bits cleared, one
// operation): a NaN when x is one, whatever `hi` became, so a NaN operand
// gives NaN products, as in the plain f32 sums.  An infinity gives NaN too
// (inf - inf) where the plain sums give an infinity, a deliberate difference
// (ROADMAP): a select for it would cost as the NaN one did.  Truncated, the
// split leaves up to 2^-21 of x where rounding leaves 2^-22, well under the
// f32 sums' own error (the emulation in kernels/tf32.py reads the same,
// tests/test_torch_tf32_forward.py); a rounding that let NaN through cost
// 7-33 % (PERF.md).
__device__ __forceinline__ unsigned tf32_lo(float x, unsigned hi) {
  return __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
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

// close the group of cp.async started since the last commit (a group may be
// empty), and wait until at most N of this thread's groups are in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Split TF32: float32 products on the tensor cores.  An operand x is hi =
// tf32(x) and lo = x - hi truncated to TF32; a product is lo_a hi_b + hi_a
// lo_b + hi_a hi_b (lo_a lo_b, ~2^-22 of it, is dropped), about f32's
// precision at three TF32 products.
//
// A tile of R rows x C floats that is split once as it lands is two planes
// [R][P] of f32 words at t: hi, then lo = t + R*P.  cp.async lands the raw
// rows in the lo plane (`tf32_load_rows` or a loader that walks the same
// chunks); after its own cp.async groups have landed, each thread splits the
// chunks it loaded, in place (`tf32_split_rows`), so no barrier separates the
// landing from the split.
//
// The tensor cores add each product into its accumulator rounding toward
// zero, so a long chain of additions into one accumulator drifts (1-2e-5 of
// a result measured with chains of 2048 keys).  Callers keep chains short
// and add the short chains' sums on the CUDA cores, rounding to nearest.
// ---------------------------------------------------------------------------

// rows [row0, row0 + R) of a row-major f32 operand (C floats a row, row
// pitch `stride`) -> rows of pitch P at `dst`, zero-filled at or past
// `limit`; thread i takes 16-byte chunks i, i + NT, ...
template <int C, int P, int R, int NT>
__device__ __forceinline__ void tf32_load_rows(float* dst, const float* src,
                                               long long stride, int row0,
                                               int limit) {
  constexpr int CH = C / 4;
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = row0 + r < limit;
    cp_async_16(dst + r * P + c,
                ok ? src + (long long)(row0 + r) * stride + c : src, ok);
  }
}

// whether this thread's chunks of a raw R x C plane at `t` (pitch P, as
// `tf32_load_rows` walks them), once landed, hold a finite value that the
// cap rounds (|x| >= 0x7F7FF000): a tile without one may take the bare
// rounding, the same bits
template <int R, int C, int P, int NT>
__device__ __forceinline__ bool tf32_needs_cap(const float* t) {
  constexpr int CH = C / 4;
  bool big = false;
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const float4 x =
        *reinterpret_cast<const float4*>(t + (i / CH) * P + (i % CH) * 4);
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      big |= (__float_as_uint(v[j]) & 0x7fffffffu) - 0x7F7FF000u < 0x1000u;
  }
  return big;
}

// four raw f32 words at `hi + lo` -> hi = tf32(x) at `hi`, lo = x - hi
// truncated at `hi + lo`
__device__ __forceinline__ void tf32_split_chunk(float* hi, int lo) {
  const float4 x = *reinterpret_cast<const float4*>(hi + lo);
  float4 h, l;
  h.x = __uint_as_float(tf32_rna(x.x));
  h.y = __uint_as_float(tf32_rna(x.y));
  h.z = __uint_as_float(tf32_rna(x.z));
  h.w = __uint_as_float(tf32_rna(x.w));
  l.x = __uint_as_float(tf32_lo(x.x, __float_as_uint(h.x)));
  l.y = __uint_as_float(tf32_lo(x.y, __float_as_uint(h.y)));
  l.z = __uint_as_float(tf32_lo(x.z, __float_as_uint(h.z)));
  l.w = __uint_as_float(tf32_lo(x.w, __float_as_uint(h.w)));
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(hi + lo) = l;
}

// this thread's landed chunks (as `tf32_load_rows` walks them: chunks i, i
// + NT, ...) of the tile at `t`, raw in its lo plane: x -> hi, lo in place;
// every thread has as many, so the loop has a fixed count and unrolls (by
// 4: eight chunks at head_dim 256 unrolled whole spill the forward)
template <int R, int C, int P, int NT>
__device__ __forceinline__ void tf32_split_rows(float* t) {
  constexpr int CH = C / 4;
  static_assert(R * CH % NT == 0, "every thread splits as many chunks");
#pragma unroll 4
  for (int u = 0; u < R * CH / NT; ++u) {
    const int i = threadIdx.x + u * NT;
    tf32_split_chunk(t + (i / CH) * P + (i % CH) * 4, R * P);
  }
}

// four f32 values as split TF32: the capped rounding, or (CAP false) the
// bare one for values bounded by construction
template <bool CAP = true>
__device__ __forceinline__ void split4(unsigned (&hi)[4], unsigned (&lo)[4],
                                       const float (&x)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    hi[j] = CAP ? tf32_rna(x[j]) : tf32_rna_bare(x[j]);
    lo[j] = tf32_lo(x[j], hi[j]);
  }
}

// A fragment (16 x 8) of a raw plane stored [row][k] from row 0 of `p`,
// columns k0 ... k0 + 7 (pitch P = 4 mod 32: no bank conflicts), split
template <int P, bool CAP = true>
__device__ __forceinline__ void frag_a(unsigned (&hi)[4], unsigned (&lo)[4],
                                       const float* p, int k0, int g, int t) {
  const float x[4] = {p[g * P + k0 + t], p[(g + 8) * P + k0 + t],
                      p[g * P + k0 + t + 4], p[(g + 8) * P + k0 + t + 4]};
  split4<CAP>(hi, lo, x);
}

// A fragment (16 x 8) of a plane stored [row][k] (pitch P = 4 mod 8: each
// 8 rows of 16 bytes hit 32 banks) from row 0 of `p`, columns k0 ... k0 +
// 7, as stored, by one ldmatrix: its four 8 x 4-word matrices are a0 .. a3
template <int P>
__device__ __forceinline__ void frag_a_ldsm(unsigned (&r)[4], const float* p,
                                            int k0, int lane) {
  ldmatrix_x4(r, p + ((lane & 7) + (lane & 8)) * P + k0 + (lane >> 4) * 4);
}

// B fragment (8 x 8) of a plane stored [n][k]: rows n = 0..7 of `p`,
// columns k0 ... k0 + 7
template <int P>
__device__ __forceinline__ void frag_b_nk(unsigned (&r)[2], const float* p,
                                          int k0, int g, int t) {
  r[0] = __float_as_uint(p[g * P + k0 + t]);
  r[1] = __float_as_uint(p[g * P + k0 + t + 4]);
}

// B fragment of a plane stored [k][n]: rows k = 0..7 of `p`, columns n0 ...
// n0 + 7 (pitch P = 8 mod 32: no bank conflicts)
template <int P>
__device__ __forceinline__ void frag_b_kn(unsigned (&r)[2], const float* p,
                                          int n0, int g, int t) {
  r[0] = __float_as_uint(p[t * P + n0 + g]);
  r[1] = __float_as_uint(p[(t + 4) * P + n0 + g]);
}

// B fragment of a plane stored [k][n], k taken in the order (0, 2, 4, 6, 1,
// 3, 5, 7): the order in which `frag_of_acc` reads an accumulator's columns
// (pitch P = 4 mod 32: no bank conflicts)
template <int P>
__device__ __forceinline__ void frag_b_kn_acc(unsigned (&r)[2], const float* p,
                                              int n0, int g, int t) {
  r[0] = __float_as_uint(p[2 * t * P + n0 + g]);
  r[1] = __float_as_uint(p[(2 * t + 1) * P + n0 + g]);
}

// an accumulator tile (16 x 8) as an A fragment over its 8 columns, split
// (a computed value: the bare rounding)
__device__ __forceinline__ void frag_of_acc(unsigned (&hi)[4],
                                            unsigned (&lo)[4],
                                            const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split4<false>(hi, lo, x);
}

// c = a (16x8, row) * b (8x8, col), tf32 in, f32 out: a chain's first
// product, into no accumulator
__device__ __forceinline__ void mma_tf32_first(float (&c)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// c = a b in split TF32, starting a chain (c is not read)
__device__ __forceinline__ void mma3_first(float (&c)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32_first(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// c += a b in split TF32: lo_a hi_b + hi_a lo_b + hi_a hi_b
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4],
                                     const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

}  // namespace
