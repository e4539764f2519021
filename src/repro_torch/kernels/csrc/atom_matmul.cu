// Atomizable tiled matrix product C[M,N] = A[M,K] @ B[K,N] for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/atom_matmul/kernel.py
// (`_matmul_atom_kernel`, launched by `matmul_atom`).
//
// What it computes: output tiles (block_m, block_n) are flattened row-major,
// t -> (t / nn, t % nn) with nn = ceil(N / block_n).  One launch is one atom:
// it computes tiles [start, start+num_tiles) over the full K reduction, with
// an f32 accumulator and one cast at the store, in place into the running C.
// Every other element of C is left as it is, so atoms over disjoint ranges
// compose to A @ B in any order, bit for bit.
//
// What bounds it on this card: operations, at the shapes of a prefill (M in
// the hundreds or more): 2*M*N*K at 989 TFLOP/s (bf16 tensor cores) or
// 67 TFLOP/s (f32 outside them), against (M*K + K*N + M*N) elements at
// 3.35 TB/s.  For a few rows (decode, M = 4) the bytes of B.
//
// What the design does about it:
//   * an atom tile is covered by (block_m/128) * (block_n/128) thread blocks
//     of a fixed 128 x 128 CTA tile (a 256 x 256 f32 accumulator would fill
//     the SM's whole register file).  grid = (num_tiles * sub_tiles,); block
//     x runs sub-tile x % sub_tiles of atom tile start + x / sub_tiles.  So
//     the tile space, and what a (start, num_tiles) covers, is the TPU
//     kernel's for every block_m, block_n that is a multiple of 128;
//   * the TPU's sequential K grid axis is a loop inside the block, with the
//     accumulator in registers for the whole loop.  block_k only orders the
//     TPU's sum; this kernel steps K by 32 (bf16) or 16 (f32);
//   * bfloat16: mma.sync m16n8k16 with f32 accumulate, 8 warps each owning a
//     64 x 32 piece of the tile.  A and B tiles go through a 3-stage ring in
//     shared memory filled by cp.async, so the loads of step k+2 overlap the
//     products of step k.  Rows are padded by 16 bytes, which keeps ldmatrix
//     free of bank conflicts; B is [K,N] row-major and is read with
//     ldmatrix.trans;
//   * float32: full f32 FMA (no TF32), each thread an 8 x 8 piece of the
//     tile, through the same 3-stage ring;
//   * ragged M, N, K are masked at their true sizes: out-of-range operands are
//     zero-filled in shared memory and out-of-range outputs are not stored,
//     so no padded copy is made.  A row that is not a whole number of 16-byte
//     chunks (K = 65, N = 129, a pitch not a multiple of 8 bf16 / 4 f32) takes
//     a second instantiation of the same kernel whose loads are guarded
//     element loads instead of 16-byte cp.async.
// What holds it back: warp-level mma.sync does not reach Hopper's full
// tensor-core rate, which needs warpgroup wgmma fed by TMA and a persistent
// schedule over the tiles; that is a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int TM = 128, TN = 128;   // CTA tile
constexpr int NTHREADS = 256;
constexpr int STAGES = 3;

struct Args {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  long long lda, ldb, ldc;   // row pitches in elements
  int start, sub_tiles, sub_n, nn, block_m, block_n;
};

// origin of this block's 128 x 128 piece of C; false if it lies wholly
// outside C (the ragged edge of an atom tile larger than 128)
__device__ __forceinline__ bool cta_origin(const Args& p, int& row0,
                                           int& col0) {
  const int t = p.start + (int)(blockIdx.x / p.sub_tiles);
  const int s = (int)(blockIdx.x % p.sub_tiles);
  row0 = (t / p.nn) * p.block_m + (s / p.sub_n) * TM;
  col0 = (t % p.nn) * p.block_n + (s % p.sub_n) * TN;
  return row0 < p.M && col0 < p.N;
}

__device__ __forceinline__ void set_zero(float& x) { x = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& x) {
  x = __float2bfloat16(0.f);
}

// rows [r0, r0+R) x columns [c0, c0+C) of a row-major operand -> a shared
// tile of row pitch LD; elements outside [0, nrows) x [0, ncols) are zero.
// VEC: 16-byte cp.async (ncols, the pitch and the base are whole 16-byte
// chunks, so a chunk is wholly in range or wholly out); else guarded element
// loads.
template <typename T, int R, int C, int LD, bool VEC>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ld,
                                      int r0, int c0, int nrows, int ncols) {
  if constexpr (VEC) {
    constexpr int E = 16 / (int)sizeof(T);   // elements of a chunk
    constexpr int CH = C / E;                // chunks of a row
    for (int i = threadIdx.x; i < R * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * E;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async_16(dst + r * LD + c,
                  ok ? src + (long long)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += NTHREADS) {
      const int r = i / C, c = i % C;
      T x;
      if (r0 + r < nrows && c0 + c < ncols)
        x = src[(long long)(r0 + r) * ld + c0 + c];
      else
        set_zero(x);
      dst[r * LD + c] = x;
    }
  }
}

// C[r, c], C[r, c+1] <- x0, x1 where in range.  VEC: N and the pitch are
// even and C is 16-byte aligned, so the pair is wholly in range or out.
template <bool VEC>
__device__ __forceinline__ void store2(__nv_bfloat16* C, long long ldc, int r,
                                       int c, int M, int N, float x0,
                                       float x1) {
  if (r >= M) return;
  __nv_bfloat16* q = C + (long long)r * ldc + c;
  if (VEC) {
    if (c < N)
      *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < N) q[0] = __float2bfloat16(x0);
    if (c + 1 < N) q[1] = __float2bfloat16(x1);
  }
}

template <bool VEC>
__device__ __forceinline__ void store2(float* C, long long ldc, int r, int c,
                                       int M, int N, float x0, float x1) {
  if (r >= M) return;
  float* q = C + (long long)r * ldc + c;
  if (VEC) {
    if (c < N) *reinterpret_cast<float2*>(q) = make_float2(x0, x1);
  } else {
    if (c < N) q[0] = x0;
    if (c + 1 < N) q[1] = x1;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BK16 = 32;
constexpr int LDA16 = BK16 + 8;   // padded rows, in elements
constexpr int LDB16 = TN + 8;
constexpr int SA16 = TM * LDA16, SB16 = BK16 * LDB16;   // elements a stage
constexpr int SMEM16 = STAGES * (SA16 + SB16) * (int)sizeof(__nv_bfloat16);

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS, 2) matmul_bf16_kernel(Args p) {
  int row0, col0;
  if (!cta_origin(p, row0, col0)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + STAGES * SA16;
  const auto* A = static_cast<const __nv_bfloat16*>(p.a);
  const auto* B = static_cast<const __nv_bfloat16*>(p.b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // warp's piece
  const int nk = (p.K + BK16 - 1) / BK16;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  auto load = [&](int kt) {
    const int s = kt % STAGES;
    stage<__nv_bfloat16, TM, BK16, LDA16, VEC>(sA + s * SA16, A, p.lda, row0,
                                               kt * BK16, p.M, p.K);
    stage<__nv_bfloat16, BK16, TN, LDB16, VEC>(sB + s * SB16, B, p.ldb,
                                               kt * BK16, col0, p.K, p.N);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // step kt has landed ...
    __syncthreads();               // ... for every thread; step kt-1 is read
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* a_s = sA + (kt % STAGES) * SA16;
    const __nv_bfloat16* b_s = sB + (kt % STAGES) * SB16;
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      unsigned af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], a_s + (wm + i * 16 + (lane & 15)) * LDA16 + kk +
                               (lane >> 4) * 8);
      // (b0, b1) of column tile 2j, then of 2j+1
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(bf[j], b_s + (kk + (lane & 15)) * LDB16 + wn +
                                     j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2],
                   bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }

  auto* C = static_cast<__nv_bfloat16*>(p.c);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2<VEC>(C, p.ldc, row0 + wm + i * 16 + g + 8 * h,
                    col0 + wn + j * 8 + 2 * tq, p.M, p.N, acc[i][j][2 * h],
                    acc[i][j][2 * h + 1]);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, full f32
// ---------------------------------------------------------------------------

constexpr int BK32 = 16;
constexpr int LDA32 = BK32 + 4;   // padded rows, in elements
constexpr int LDB32 = TN + 4;
constexpr int SA32 = TM * LDA32, SB32 = BK32 * LDB32;
constexpr int SMEM32 = STAGES * (SA32 + SB32) * (int)sizeof(float);

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS, 2) matmul_f32_kernel(Args p) {
  int row0, col0;
  if (!cta_origin(p, row0, col0)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sA = reinterpret_cast<float*>(smem_raw);
  float* sB = sA + STAGES * SA32;
  const auto* A = static_cast<const float*>(p.a);
  const auto* B = static_cast<const float*>(p.b);
  // thread (ty, tx) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
  // tx*4 + {0..3} and 64 + tx*4 + {0..3} of the tile
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nk = (p.K + BK32 - 1) / BK32;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto load = [&](int kt) {
    const int s = kt % STAGES;
    stage<float, TM, BK32, LDA32, VEC>(sA + s * SA32, A, p.lda, row0,
                                       kt * BK32, p.M, p.K);
    stage<float, BK32, TN, LDB32, VEC>(sB + s * SB32, B, p.ldb, kt * BK32,
                                       col0, p.K, p.N);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_async_commit();
    const float* a_s = sA + (kt % STAGES) * SA32;
    const float* b_s = sB + (kt % STAGES) * SB32;
#pragma unroll
    for (int k = 0; k < BK32; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = a_s[((i >> 2) * 64 + ty * 4 + (i & 3)) * LDA32 + k];
      const float4 b0 =
          *reinterpret_cast<const float4*>(b_s + k * LDB32 + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b_s + k * LDB32 + 64 + tx * 4);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  auto* C = static_cast<float*>(p.c);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i >> 2) * 64 + ty * 4 + (i & 3);
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      store2<VEC>(C, p.ldc, r, col0 + (j >> 2) * 64 + tx * 4 + (j & 3), p.M,
                  p.N, acc[i][j], acc[i][j + 1]);
  }
}

using Kernel = void (*)(Args);

// the kernel for a dtype code and load path, with its shared memory
bool pick(int dtype, int vec, Kernel& k, int& smem) {
  if (dtype == 0) {
    k = vec ? matmul_f32_kernel<true> : matmul_f32_kernel<false>;
    smem = SMEM32;
    return true;
  }
  if (dtype == 1) {
    k = vec ? matmul_bf16_kernel<true> : matmul_bf16_kernel<false>;
    smem = SMEM16;
    return true;
  }
  return false;
}

}  // namespace

// The CTA tile this kernel was compiled for; the wrapper checks block sizes
// against it.
extern "C" int atom_matmul_cta_tile() { return TM; }

// Thread blocks of the kernel's 16-byte load path for a dtype that one SM
// holds at once, or minus a CUDA error code.
extern "C" int atom_matmul_ctas_per_sm(int dtype) {
  Kernel k;
  int smem;
  if (!pick(dtype, 1, k, smem)) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, NTHREADS, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// One atom: tiles [start, start+num_tiles) of the (block_m, block_n) tile
// space of C[M,N] = A[M,K] @ B[K,N], written in place into c.  Row-major
// operands with row pitches lda, ldb, ldc in elements.  dtype: 0 = float32,
// 1 = bfloat16.  vec: every operand's rows are whole 16-byte chunks (width,
// pitch and base), so the 16-byte cp.async path applies.  Returns the CUDA
// error code of the launch (0 = success), or -1 for what the kernel does not
// take.
extern "C" int atom_matmul_atom(const void* a, const void* b, void* c, int M,
                                int N, int K, long long lda, long long ldb,
                                long long ldc, int start, int num_tiles,
                                int block_m, int block_n, int dtype, int vec,
                                void* stream) {
  if (num_tiles <= 0) return 0;
  if (block_m <= 0 || block_n <= 0 || block_m % TM || block_n % TN) return -1;
  const int sub_n = block_n / TN;
  const Args p{a,     b,     c,   M,     N,
               K,     lda,   ldb, ldc,   start,
               (block_m / TM) * sub_n, sub_n, (N + block_n - 1) / block_n,
               block_m, block_n};
  const long long blocks = (long long)num_tiles * p.sub_tiles;
  if (blocks > 0x7fffffffLL) return -1;
  Kernel k;
  int smem;
  if (!pick(dtype, vec, k, smem)) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<(unsigned)blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
