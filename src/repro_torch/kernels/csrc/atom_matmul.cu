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
// 67 TFLOP/s (f32 outside them; the split-TF32 route's own floor is three
// TF32 products a product at 494.7 TFLOP/s, and mma.sync reaches ~320 of
// those on this card), against (M*K + K*N + M*N) elements at 3.35 TB/s.
// For a few rows (decode, M = 4) the bytes of B.
//
// What the design does about it:
//   * the atom tile is covered by CTA tiles of a fixed shape; one launch runs
//     the atom's CTA tiles, numbered c = 0 .. num_tiles * sub_tiles - 1: atom
//     tile start + c / sub_tiles, sub-tile c % sub_tiles (row-major within the
//     atom tile).  So the tile space, and what a (start, num_tiles) covers, is
//     the TPU kernel's for every block_m, block_n that is a multiple of 128;
//   * the TPU's sequential K grid axis is a loop inside the CTA, with the
//     accumulator in registers for the whole loop, in one fixed order per
//     output tile (no split-K): atoms over any partition are bit-equal to one
//     atom.  block_k only orders the TPU's sum;
//   * bfloat16 whose rows TMA can address (width, pitch and base whole
//     16-byte chunks): Hopper's warpgroup multiplies (wgmma, f32 accumulate)
//     fed by TMA.  CTA tile 128 x 256 x 64 where block_n % 256 == 0, else
//     128 x 128 x 64.  384 threads: one producer warpgroup, of which one
//     thread issues every TMA load (its registers given up to the others with
//     setmaxnreg), and two consumer warpgroups, each owning 64 rows of the
//     tile as one m64n256k16 (m64n128k16) wgmma chain.  A ring of 4 stages in
//     128-byte-swizzled shared memory, with full and empty mbarriers, keeps
//     the loads of the next three K steps in flight under the products.  A
//     [M,K] is K-major; B [K,N] is read as it lies (MN-major, the transpose
//     bit set), in boxes of 64 columns.  The schedule is persistent: grid =
//     min(CTA tiles, SMs x CTAs an SM), CTA x runs CTA tiles x, x + gridDim.x,
//     ..., so the next tile's loads overlap this tile's epilogue.  TMA
//     zero-fills what lies outside A and B, so ragged M, N, K need no mask
//     in the main loop; the epilogue stores bf16 pairs from registers, masked
//     at M and N;
//   * bfloat16 rows that TMA cannot address (K = 65, N = 129, a pitch not a
//     multiple of 8): 128 x 128 CTA tiles, one CTA each, mma.sync m16n8k16
//     with guarded element loads through a 3-stage ring;
//   * float32 rows of whole 16-byte chunks: split TF32 on the tensor cores
//     (wgmma takes TF32 only K-major, and B lies N-major): each operand is hi
//     = tf32(x) and lo = x - hi truncated, each product lo_a hi_b + hi_a lo_b
//     + hi_a hi_b on mma.sync m16n8k8.  128 x 128 CTA tiles of 8 warps (64 x
//     32 each), one CTA an SM; A and B K steps of 32 land by cp.async in a
//     ring of 3 and are split once into hi and lo planes, the next step's
//     split interleaved with this step's products (A [m][k], fragments by
//     ldmatrix; B [k][n] as it lies, pitch 8 mod 32 words).  The tensor
//     cores add into an accumulator rounding toward zero, so each K step's
//     12-product chains go to fresh accumulators, added to the running sums
//     on the CUDA cores in K order: still one fixed sum an output element;
//   * float32 rows that are not whole 16-byte chunks (K = 65, N = 129): full
//     f32 FMA on the CUDA cores, each thread an 8 x 8 piece of a 128 x 128
//     tile, guarded element loads through a 3-stage ring.
// What holds it back: the K loop of a CTA tile is not split (the atom
// contract), so a grid of few CTA tiles leaves SMs idle, and the last wave of
// a large one is partial; consumer warpgroups wait for their own products
// before the epilogue, whose stores from registers use half of each 32-byte
// sector.  B is re-read from device memory once per row of atom tiles that
// the L2 cannot hold.  The split-TF32 route runs at about 2.8x its TF32
// floor at the projection shape (PERF.md §6): one CTA an SM (252
// registers, 215 KB of ring), a barrier and 64 fresh-accumulator adds a K
// step; a producer/consumer split of the warps measured no faster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
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

// origin of the atom's CTA tile c (of shape CM x CN) in C; false if it lies
// wholly outside C (the ragged edge of an atom tile larger than the CTA tile)
template <int CM, int CN>
__device__ __forceinline__ bool cta_origin(const Args& p, int c, int& row0,
                                           int& col0) {
  const int t = p.start + c / p.sub_tiles;
  const int s = c % p.sub_tiles;
  row0 = (t / p.nn) * p.block_m + (s / p.sub_n) * CM;
  col0 = (t % p.nn) * p.block_n + (s % p.sub_n) * CN;
  return row0 < p.M && col0 < p.N;
}

__device__ __forceinline__ void set_zero(float& x) { x = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& x) {
  x = __float2bfloat16(0.f);
}

// rows [r0, r0+R) x columns [c0, c0+C) of a row-major operand -> a shared
// tile of row pitch LD by guarded element loads; elements outside [0,
// nrows) x [0, ncols) are zero.
template <typename T, int R, int C, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ld,
                                      int r0, int c0, int nrows, int ncols) {
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

__global__ void __launch_bounds__(NTHREADS, 2) matmul_bf16_kernel(Args p) {
  int row0, col0;
  if (!cta_origin<TM, TN>(p, (int)blockIdx.x, row0, col0)) return;
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
    stage<__nv_bfloat16, TM, BK16, LDA16>(sA + s * SA16, A, p.lda, row0,
                                          kt * BK16, p.M, p.K);
    stage<__nv_bfloat16, BK16, TN, LDB16>(sB + s * SB16, B, p.ldb, kt * BK16,
                                          col0, p.K, p.N);
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
        store2<false>(C, p.ldc, row0 + wm + i * 16 + g + 8 * h,
                    col0 + wn + j * 8 + 2 * tq, p.M, p.N, acc[i][j][2 * h],
                    acc[i][j][2 * h + 1]);
}

// ---------------------------------------------------------------------------
// float32 rows that are not whole 16-byte chunks: CUDA cores, full f32
// ---------------------------------------------------------------------------

constexpr int BK32 = 16;
constexpr int LDA32 = BK32 + 4;   // padded rows, in elements
constexpr int LDB32 = TN + 4;
constexpr int SA32 = TM * LDA32, SB32 = BK32 * LDB32;
constexpr int SMEM32 = STAGES * (SA32 + SB32) * (int)sizeof(float);

__global__ void __launch_bounds__(NTHREADS, 2) matmul_f32_kernel(Args p) {
  int row0, col0;
  if (!cta_origin<TM, TN>(p, (int)blockIdx.x, row0, col0)) return;
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
    stage<float, TM, BK32, LDA32>(sA + s * SA32, A, p.lda, row0, kt * BK32,
                                  p.M, p.K);
    stage<float, BK32, TN, LDB32>(sB + s * SB32, B, p.ldb, kt * BK32, col0,
                                  p.K, p.N);
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
      store2<false>(C, p.ldc, r, col0 + (j >> 2) * 64 + tx * 4 + (j & 3), p.M,
                    p.N, acc[i][j], acc[i][j + 1]);
  }
}

// ---------------------------------------------------------------------------
// float32 rows of whole 16-byte chunks: split TF32 on the tensor cores
// (mma.sync m16n8k8, three products a product), 128 x 128 CTA tiles
// ---------------------------------------------------------------------------

constexpr int BKT = 32;                    // K step: one stage of the ring
constexpr int PAT = BKT + 4;               // A [m][k] planes: 4 mod 8 words
constexpr int PBT = TN + 8;                // B [k][n] planes: 8 mod 32 words
constexpr int PLANE_A = TM * PAT, PLANE_B = BKT * PBT;   // floats a plane
constexpr int STAGE_T = 2 * (PLANE_A + PLANE_B);         // hi, lo of each
constexpr int SMEM_T = STAGES * STAGE_T * (int)sizeof(float);
static_assert(SMEM_T <= 232448, "227 KB of shared memory a block");
static_assert(TM * BKT / 4 % NTHREADS == 0 && BKT * TN / 4 % NTHREADS == 0 &&
                  (TM + TN) * BKT / 4 / NTHREADS % (BKT / 8) == 0,
              "every thread lands and splits as many chunks, as many a k-step");

// rows [r0, r0+R) x columns [c0, c0+C) of a row-major f32 operand whose
// rows are whole 16-byte chunks -> rows of pitch LD at `dst` by cp.async,
// zero outside [0, nrows) x [0, ncols); thread i lands chunks i, i +
// NTHREADS, ... (a fixed count, unrolled), as `split_chunk` splits them
template <int R, int C, int LD>
__device__ __forceinline__ void land(float* dst, const float* src,
                                     long long ld, int r0, int c0, int nrows,
                                     int ncols) {
  constexpr int CH = C / 4;
#pragma unroll
  for (int u = 0; u < R * CH / NTHREADS; ++u) {
    const int i = threadIdx.x + u * NTHREADS;
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = r0 + r < nrows && c0 + c < ncols;
    cp_async_16(dst + r * LD + c,
                ok ? src + (long long)(r0 + r) * ld + c0 + c : src, ok);
  }
}

constexpr int CA = TM * BKT / 4 / NTHREADS, CB = BKT * TN / 4 / NTHREADS;

// this thread's chunk u of stage s (A's CA chunks, then B's CB, as `land`
// walks them), raw in the lo plane -> hi, lo in place
__device__ __forceinline__ void split_chunk(float* s, int u) {
  if (u < CA) {
    const int i = threadIdx.x + u * NTHREADS;
    tf32_split_chunk(s + (i / (BKT / 4)) * PAT + (i % (BKT / 4)) * 4,
                     PLANE_A);
  } else {
    const int i = threadIdx.x + (u - CA) * NTHREADS;
    tf32_split_chunk(s + 2 * PLANE_A + (i / (TN / 4)) * PBT + (i % (TN / 4)) * 4,
                     PLANE_B);
  }
}

// A stage of the ring is A's hi and lo planes [TM][PAT], then B's [BKT][PBT];
// cp.async lands the raw rows in the lo planes, two steps ahead, and each
// thread splits its own chunks of step k+1 a few at a time between step k's
// products (split as a block of their own, they left the tensor cores idle:
// 2.21 against 2.01 ms).  Warp w owns rows 64 (w / 4) ... and columns 32 (w
// % 4) ... of the tile: 4 x 4 accumulator tiles of 16 x 8, A fragments by
// ldmatrix from [m][k], B fragments read from [k][n] as B lies.  Each step's
// products go to a fresh accumulator (chains of 3 BKT / 8 = 12 products),
// added to the running one on the CUDA cores in K order, so every output
// element is one fixed sum whatever the atom.
__global__ void __launch_bounds__(NTHREADS, 1) matmul_tf32_kernel(Args p) {
  int row0, col0;
  if (!cta_origin<TM, TN>(p, (int)blockIdx.x, row0, col0)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const auto* A = static_cast<const float*>(p.a);
  const auto* B = static_cast<const float*>(p.b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int nk = (p.K + BKT - 1) / BKT;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  auto load = [&](int kt) {
    float* s = ring + (kt % STAGES) * STAGE_T;
    land<TM, BKT, PAT>(s + PLANE_A, A, p.lda, row0, kt * BKT, p.M, p.K);
    land<BKT, TN, PBT>(s + 2 * PLANE_A + PLANE_B, B, p.ldb, kt * BKT, col0,
                       p.K, p.N);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();   // this thread's chunks of step 0 ...
  if (nk > 0) {
#pragma unroll
    for (int u = 0; u < CA + CB; ++u) split_chunk(ring, u);   // ... split
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const float* s = ring + (kt % STAGES) * STAGE_T;
    float* next = ring + ((kt + 1) % STAGES) * STAGE_T;
    // step kt+2 lands (zeros past K) in the slot step kt-1 left; step kt+1
    // has landed and is split a chunk at a time between step kt's products
    load(kt + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 2>();

    const float* ah_s = s + wm * PAT;
    const float* al_s = ah_s + PLANE_A;
    const float* bh_s = s + 2 * PLANE_A + wn;
    const float* bl_s = bh_s + PLANE_B;
    float x[4][4][4];
#pragma unroll
    for (int kk = 0; kk < BKT; kk += 8) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        frag_b_kn<PBT>(bh[j], bh_s + kk * PBT, j * 8, g, t);
        frag_b_kn<PBT>(bl[j], bl_s + kk * PBT, j * 8, g, t);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned ah[4], al[4];
        frag_a_ldsm<PAT>(ah, ah_s + i * 16 * PAT, kk, lane);
        frag_a_ldsm<PAT>(al, al_s + i * 16 * PAT, kk, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kk == 0)
            mma3_first(x[i][j], ah, al, bh[j], bl[j]);
          else
            mma3(x[i][j], ah, al, bh[j], bl[j]);
        }
      }
      constexpr int PER = (CA + CB) / (BKT / 8);   // chunks a k-step
#pragma unroll
      for (int v = 0; v < PER; ++v) split_chunk(next, kk / 8 * PER + v);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += x[i][j][c];
    __syncthreads();   // step kt+1 is split for every thread; kt is read
  }
  cp_async_wait<0>();   // no copy (of a step past K) outlives the CTA

  auto* C = static_cast<float*>(p.c);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2<true>(C, p.ldc, row0 + wm + i * 16 + g + 8 * h,
                     col0 + wn + j * 8 + 2 * t, p.M, p.N, acc[i][j][2 * h],
                     acc[i][j][2 * h + 1]);
}

// ---------------------------------------------------------------------------
// bfloat16 rows that TMA can address: wgmma fed by TMA, warp-specialised,
// persistent over the atom's CTA tiles
// ---------------------------------------------------------------------------

constexpr int WM = 128, WK = 64;   // CTA tile rows, K step
constexpr int WSTAGES = 4;
constexpr int WTHREADS = 384;      // producer warpgroup + 2 consumer warpgroups

template <int BN>
struct WTile {
  static constexpr int A_BYTES = WM * WK * 2;   // 16 KB: 128 rows of 128 B
  static constexpr int B_BYTES = WK * BN * 2;   // BN/64 boxes of 64 rows x 128 B
  static constexpr int BOX_B = WK * 128;        // one 64-column box of B
  // ring + barriers + room to align the ring to 1024 bytes
  static constexpr int SMEM =
      1024 + WSTAGES * (A_BYTES + B_BYTES) + 2 * WSTAGES * 8;
};

template <int BN>
__device__ __forceinline__ void mma_step(float (&acc)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    wgmma_m64n256k16_ss<1>(acc, da, db, scale_d);
  else
    wgmma_m64n128k16_ss<1>(acc, da, db, scale_d);
}

template <int BN>
__global__ void __launch_bounds__(WTHREADS, 1)
matmul_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b, Args p,
                         int n_ctas) {
  using T = WTile<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sA = ring;                          // [stage][128][64]
  unsigned char* sB = ring + WSTAGES * T::A_BYTES;   // [stage][box][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + WSTAGES * T::B_BYTES);
  uint64_t* empty = full + WSTAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx
      mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int nk = (p.K + WK - 1) / WK;

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int c = blockIdx.x; c < n_ctas; c += gridDim.x) {
        int row0, col0;
        if (!cta_origin<WM, BN>(p, c, row0, col0)) continue;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], T::A_BYTES + T::B_BYTES);
          tma_load_2d(sA + stage * T::A_BYTES, &map_a, &full[stage], kt * WK,
                      row0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(sB + stage * T::B_BYTES + j * T::BOX_B, &map_b,
                        &full[stage], col0 + 64 * j, kt * WK);
          if (++stage == WSTAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: rows [64 wg, 64 wg + 64) of each CTA tile
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    auto* C = static_cast<__nv_bfloat16*>(p.c);
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int c = blockIdx.x; c < n_ctas; c += gridDim.x) {
      int row0, col0;
      if (!cta_origin<WM, BN>(p, c, row0, col0)) continue;
      int prev = -1;   // the stage whose products may still be running
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* a = sA + stage * T::A_BYTES + wg * 64 * 128;
        const unsigned char* b = sB + stage * T::B_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < WK / 16; ++ks)
          mma_step<BN>(acc, wgmma_desc(a + 32 * ks, 16, 1024),
                       wgmma_desc(b + 2048 * ks, T::BOX_B, 1024),
                       (kt | ks) != 0);
        wgmma_commit();
        wgmma_wait<1>();   // the previous step's products are done ...
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);   // ... free it
        prev = stage;
        if (++stage == WSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      const int r = row0 + wg * 64 + warp * 16 + (lane >> 2);
      const int c0 = col0 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        store2<true>(C, p.ldc, r, c0 + 8 * i, p.M, p.N, acc[4 * i],
                     acc[4 * i + 1]);
        store2<true>(C, p.ldc, r + 8, c0 + 8 * i, p.M, p.N, acc[4 * i + 2],
                     acc[4 * i + 3]);
      }
    }
  }
}

// CTAs of the wgmma kernel that one SM holds (cached), or minus a CUDA
// error code
template <int BN>
int wgmma_ctas_per_sm() {
  static int n = [] {
    auto k = matmul_bf16_wgmma_kernel<BN>;
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, WTile<BN>::SMEM);
    if (err != cudaSuccess) return -(int)err;
    int m = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&m, k, WTHREADS,
                                                        WTile<BN>::SMEM);
    return err == cudaSuccess ? m : -(int)err;
  }();
  return n;
}

template <int BN>
int launch_wgmma(Args p, int num_tiles, cudaStream_t stream) {
  p.sub_n = p.block_n / BN;
  p.sub_tiles = (p.block_m / WM) * p.sub_n;
  const long long n_ctas = (long long)num_tiles * p.sub_tiles;
  if (n_ctas > 0x7fffffffLL) return -1;
  CUtensorMap map_a, map_b;
  {   // A [M, K]: boxes of 64 (K) x 128 rows
    const uint64_t dims[2] = {(uint64_t)p.K, (uint64_t)p.M};
    const uint64_t strides[1] = {(uint64_t)p.lda * 2};
    const uint32_t box[2] = {WK, WM};
    if (int e = encode_bf16_map(&map_a, p.a, 2, dims, strides, box)) return e;
  }
  {   // B [K, N]: boxes of 64 columns x 64 rows (K), as B lies
    const uint64_t dims[2] = {(uint64_t)p.N, (uint64_t)p.K};
    const uint64_t strides[1] = {(uint64_t)p.ldb * 2};
    const uint32_t box[2] = {64, WK};
    if (int e = encode_bf16_map(&map_b, p.b, 2, dims, strides, box)) return e;
  }
  const int per_sm = wgmma_ctas_per_sm<BN>();
  if (per_sm <= 0) return per_sm < 0 ? -per_sm : -1;
  const int sms = sm_count();
  if (sms <= 0) return -1;
  const int grid = (int)(n_ctas < (long long)sms * per_sm ? n_ctas
                                                          : sms * per_sm);
  matmul_bf16_wgmma_kernel<BN><<<grid, WTHREADS, WTile<BN>::SMEM, stream>>>(
      map_a, map_b, p, (int)n_ctas);
  return (int)cudaGetLastError();
}

// the CTA tile of each path: the wgmma path (bf16 rows that TMA can
// address) is 128 x 256 where block_n % 256 == 0, else 128 x 128; the
// others 128 x 128.  (K = 0 has no K step for TMA to load: it takes the
// guarded kernel, which writes the zeros.)
bool wgmma_path(int dtype, int vec) { return dtype == 1 && vec; }
int cta_n(int dtype, int block_n, int vec) {
  return wgmma_path(dtype, vec) && block_n % 256 == 0 ? 256 : TN;
}

using Kernel = void (*)(Args);

// the one-CTA-a-tile kernel for a dtype code and load path, with its shared
// memory
bool pick(int dtype, int vec, Kernel& k, int& smem) {
  if (dtype == 0) {
    k = vec ? matmul_tf32_kernel : matmul_f32_kernel;
    smem = vec ? SMEM_T : SMEM32;
    return true;
  }
  if (dtype == 1) {   // rows TMA cannot address, or K = 0
    k = matmul_bf16_kernel;
    smem = SMEM16;
    return true;
  }
  return false;
}

}  // namespace

// The CTA tile (*m x *n) of the path for a dtype code, block_n and whether
// every operand's rows are whole 16-byte chunks; the wrapper mirrors it.
// Returns 0, or -1 for a dtype the kernel does not take.
extern "C" int atom_matmul_cta_shape(int dtype, int block_n, int vec, int* m,
                                     int* n) {
  if (dtype != 0 && dtype != 1) return -1;
  *m = TM;
  *n = cta_n(dtype, block_n, vec);
  return 0;
}

// CTAs of the path for (dtype, block_n) on operands whose rows are whole
// 16-byte chunks that one SM holds at once, or minus a CUDA error code.
extern "C" int atom_matmul_ctas_per_sm(int dtype, int block_n) {
  if (wgmma_path(dtype, 1))
    return block_n % 256 == 0 ? wgmma_ctas_per_sm<256>()
                              : wgmma_ctas_per_sm<128>();
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
// pitch and base), so TMA (bf16) or 16-byte cp.async (f32) applies.
// Returns the CUDA error code of the launch (0 = success), -1 for what the
// kernel does not take, or -2 if a tensor map cannot be encoded.
extern "C" int atom_matmul_atom(const void* a, const void* b, void* c, int M,
                                int N, int K, long long lda, long long ldb,
                                long long ldc, int start, int num_tiles,
                                int block_m, int block_n, int dtype, int vec,
                                void* stream) {
  if (num_tiles <= 0) return 0;
  if (block_m <= 0 || block_n <= 0 || block_m % TM || block_n % TN) return -1;
  Args p{a,     b,     c,     M,   N,   K,  lda, ldb, ldc, start,
         0,     0,     (N + block_n - 1) / block_n,     block_m, block_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma_path(dtype, vec) && K > 0)
    return block_n % 256 == 0 ? launch_wgmma<256>(p, num_tiles, s)
                              : launch_wgmma<128>(p, num_tiles, s);
  p.sub_n = block_n / TN;
  p.sub_tiles = (block_m / TM) * p.sub_n;
  const long long blocks = (long long)num_tiles * p.sub_tiles;
  if (blocks > 0x7fffffffLL) return -1;
  Kernel k;
  int smem;
  if (!pick(dtype, vec, k, smem)) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<(unsigned)blocks, NTHREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}
