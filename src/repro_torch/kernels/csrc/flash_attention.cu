// Atomizable causal / non-causal GQA flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`_flash_kernel`, launched by `flash_attention_atom`).
//
// What bounds it on this card: operations, once the sequence is a few hundred
// tokens long (each K/V byte of a head is reused by every query row of the
// tile and by the G query heads that share it); for very short prompts the
// bytes of q, k, v, o.  The least time is the larger of 4*D*(unmasked
// query-key pairs) / tensor-core rate and those bytes / memory rate.
//
// What the design does about it:
//   * the schedulable space is the flat tile index t over (B*Hq) x
//     ceil(Sq/BQ), as in the TPU kernel: bh = t / n_qblocks, qi = t %
//     n_qblocks, kv head = (bh % Hq) / G.  grid = (num_tiles,) with the block
//     index offset by `start`: an atom runs tiles [start, start+num_tiles)
//     and writes only their rows of o, in place, so atoms over disjoint
//     ranges compose in any order;
//   * one thread block per tile with the loop over KV blocks inside it (the
//     TPU kernel's sequential second grid axis).  The loop ends at the causal
//     frontier of the tile's last row, so fully masked KV blocks are never
//     loaded;
//   * q, k, v, o are addressed in the model's [B,S,H,D] strides, and the
//     ragged edges (Sq, Sk not multiples of the tile) are masked: no padded or
//     transposed copy is made.  The causal mask is aligned to the END of the
//     keys (kpos <= Sk - Sq + qrow), which covers chunked prefill (Sq < Sk);
//   * bfloat16 inputs run both products on Hopper's warpgroup multiplies
//     (wgmma, f32 accumulate) fed by TMA.  One consumer warpgroup owns the
//     tile's 64 query rows; one producer warp issues every TMA load.  q, k, v
//     are 4-D tensor maps {D, H, S, B} over the model's layout, boxes of 64
//     head-dim values (128 bytes, 128-byte swizzle) x 1 head x 64 rows; TMA
//     zero-fills rows past Sq or Sk.  Q is loaded once; K and V blocks of 64
//     keys go through a 2-stage ring with full and empty mbarriers, so block
//     j+1 loads while block j computes.  S = Q K^T is m64n64k16 from shared
//     memory; P never leaves registers (the accumulator layout of S is the A
//     fragment of O += P V, m64nDk16 with V MN-major, the transpose bit set).
//     83 KB of shared memory at head_dim 128, so two CTAs share an SM and
//     one's softmax overlaps the other's products.  Within an atom, CTA x
//     runs tile start + num_tiles - 1 - x: a head's longest causal tiles
//     start first;
//   * float32 inputs take both products in split TF32 on the tensor cores
//     (hi = tf32(x), lo = x - hi truncated; three mma.sync m16n8k8 a product:
//     wgmma takes TF32 only K-major, and V would need a transposed split
//     copy).  128 threads, warp w owning 16 of the tile's rows; Q pre-scaled
//     and resident as loaded, split in registers as its fragments load; K
//     and V blocks of 16 keys land by cp.async in a ring of two and are split
//     once into hi and lo planes; S in four short chains over D (two at 256),
//     P from registers as the A fragment of P V, each block's P V into fresh
//     accumulators added on the CUDA cores (the tensor cores round toward
//     zero).  101 KB at head_dim 128, two CTAs an SM; an atom of whole heads
//     runs its q blocks from the last, every head's in turn, so the longest
//     causal tiles start first across heads;
//   * a sliding window (window > 0, the reference model's
//     `blocked_attention(window=)`, which the TPU kernel lacks) masks kpos <=
//     qpos - window as well, and the KV loop starts at the block of the
//     tile's first row's first visible key, so blocks left behind the window
//     are never loaded either;
//   * head_dim 256 (RecurrentGemma) runs the same bf16 design at one CTA an
//     SM: Q 32 KB and a 2-stage K/V ring of 128 KB (161 KB), O += P V as one
//     m64n256k16 a k-step, 128 accumulator registers a thread;
//   * a row with no unmasked key gives zeros (l == 0 -> 1), never NaN.
// What holds it back: one warpgroup a CTA, so the softmax of a block and its
// products are serialised within a CTA (the two CTAs of an SM overlap them;
// issuing S of block j+1 before P V of block j, as FlashAttention-3 does,
// measured slower here); BK = 64 keeps two CTAs an SM but halves the work a barrier round
// trip carries; the output is stored from registers as bf16 pairs, half of
// each 32-byte sector.  The f32 path (PERF.md §6: about half its f32 bound
// and a fifth of its TF32 floor at llama3-8b's 1000-token prefill) has 8
// warps an SM, each splitting Q's fragments again for every block of 16
// keys and waiting at a barrier per block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;    // query rows of a tile

struct Strides {
  long long q_b, q_s, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;
};

// ---------------------------------------------------------------------------
// float32: both products in split TF32 on the tensor cores (mma.sync
// m16n8k8).  128 threads: warp w owns the tile's query rows [16w, 16w+16).
// Q is resident in shared memory as loaded (pre-scaled by sm_scale log2 e)
// and split in registers as its fragments load; K and V blocks of FBK keys
// land by cp.async in a ring of two and are split once, as they land, into
// hi and lo planes [key][d] of P words a row.  S = Q K^T is taken in KC
// short chains over D; P never leaves registers: each 8-key column tile of
// S is an A fragment of O += P V (V read [key][d] as it lies).  Each block's
// P V goes to fresh accumulators (chains of 3 FBK / 8 products), added to
// the running output on the CUDA cores after the rescale.
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 128;
constexpr int FBK = 16;    // keys of a KV block

template <int D>
struct F32Tile {
  static constexpr int P = D + 4;          // floats a row: 4 mod 32
  static constexpr int Q = BQ * P;         // the Q tile, as loaded
  static constexpr int PLANE = FBK * P;    // one plane of a block
  static constexpr int STAGE = 4 * PLANE;  // K hi, K lo, V hi, V lo
  static constexpr int BYTES = 4 * (Q + 2 * STAGE);
  // a score's chains over D: 4 of D / 32 k-steps; 2 at head_dim 256, whose
  // output accumulators leave no registers for more
  static constexpr int KC = D == 256 ? 2 : 4;
};
// CTAs an SM the f32 kernel is built for: two where their shared memory
// fits an SM's 228 KB (1 KB of it reserved a CTA), else one
template <int D>
constexpr int f32_ctas() {
  return 2 * (F32Tile<D>::BYTES + 1024) <= 233472 ? 2 : 1;
}
static_assert(F32Tile<256>::BYTES <= 232448, "227 KB of shared memory a block");

// the block at stage `st` of keys [k0, k0 + FBK): K, V rows land raw in
// their lo planes (zero past Sk)
template <int D>
__device__ __forceinline__ void land_kv(float* st, const float* kb,
                                        const float* vb, long long ks,
                                        long long vs, int k0, int Sk) {
  using F = F32Tile<D>;
  tf32_load_rows<D, F::P, FBK, F_THREADS>(st + F::PLANE, kb, ks, k0, Sk);
  tf32_load_rows<D, F::P, FBK, F_THREADS>(st + 3 * F::PLANE, vb, vs, k0, Sk);
}

template <int D>
__global__ void __launch_bounds__(F_THREADS, f32_ctas<D>())
flash_attn_tf32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int start, int num_tiles,
                       int n_qblocks, int Hq, int G, int Sq, int Sk,
                       int causal, int window, Strides st, float scale_log2e) {
  using F = F32Tile<D>;
  constexpr int P = F::P, KC = F::KC;
  constexpr int NS = FBK / 8;     // 8-key column tiles of S
  constexpr int DT = D / 8;       // 8-column tiles of the output; k-steps
  // fragments by ldmatrix: Q's raw, both key tiles' of K at once (at head
  // dim 256 the extra registers spill)
  constexpr bool LDSM = D <= 128;
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;                // [BQ][P]
  float* ring = sQ + F::Q;        // [stage]: K hi, K lo, V hi, V lo

  // longest causal tiles first: an atom of whole heads runs its q blocks
  // from the last, every head's in turn; any other atom from its end
  int bh, qi;
  if (start % n_qblocks == 0 && num_tiles % n_qblocks == 0) {
    const int heads = num_tiles / n_qblocks;
    bh = start / n_qblocks + (int)blockIdx.x % heads;
    qi = n_qblocks - 1 - (int)blockIdx.x / heads;
  } else {
    const int tile = start + num_tiles - 1 - (int)blockIdx.x;
    bh = tile / n_qblocks;
    qi = tile % n_qblocks;
  }
  const int b = bh / Hq, h = bh % Hq, hk = h / G;
  const int q0 = qi * BQ;
  const int off = Sk - Sq;        // qpos = off + query row
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, off + q_last + 1) : Sk;
  const int nblocks = k_end > 0 ? (k_end + FBK - 1) / FBK : 0;
  // the first block the window lets the tile's first row see
  const int blk0 = window > 0 ? max(0, off + q0 - window + 1) / FBK : 0;
  const float* kb = k + b * st.k_b + hk * st.k_h;
  const float* vb = v + b * st.v_b + hk * st.v_h;

  if (blk0 < nblocks) {   // block blk0's K and V, then Q (scaled) meanwhile
    land_kv<D>(ring, kb, vb, st.k_s, st.v_s, blk0 * FBK, Sk);
    cp_async_commit();
  }
  const float* qb = q + b * st.q_b + h * st.q_h;
  for (int i = threadIdx.x; i < BQ * (D / 4); i += F_THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = *reinterpret_cast<const float4*>(qb + (long long)(q0 + r) * st.q_s +
                                           c);
      x.x *= scale_log2e; x.y *= scale_log2e;
      x.z *= scale_log2e; x.w *= scale_log2e;
    }
    *reinterpret_cast<float4*>(sQ + r * P + c) = x;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // row within 8, column pair
  const int row_lo = off + q0 + warp * 16;  // qpos of the warp's first row
  const float* qw = sQ + warp * 16 * P;
  // rows g and g+8 of the warp's slice; scores in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int blk = blk0; blk < nblocks; ++blk) {
    const int k0 = blk * FBK;
    float* ks = ring + ((blk - blk0) & 1) * F::STAGE;
    const float* vs = ks + 2 * F::PLANE;
    cp_async_wait<0>();   // this thread's chunks of block blk have landed
    tf32_split_rows<FBK, D, P, F_THREADS>(ks);
    tf32_split_rows<FBK, D, P, F_THREADS>(ks + 2 * F::PLANE);
    __syncthreads();   // block blk is split (and Q stored); blk-1 is not read
    if (blk + 1 < nblocks) {
      land_kv<D>(ring + ((blk + 1 - blk0) & 1) * F::STAGE, kb, vb, st.k_s,
                 st.v_s, k0 + FBK, Sk);
      cp_async_commit();
    }

    // S = Q K^T for the warp's 16 rows x FBK keys, in KC chains over D
    float c[KC][NS][4];
#pragma unroll 4
    for (int j1 = 0; j1 < DT; j1 += KC)
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const int j = j1 + u;     // k-step: columns 8j ... 8j + 7 of Q, K
        unsigned ah[4], al[4];
        unsigned kh[2 * NS], kl[2 * NS];   // (b0, b1) of each key tile
        if constexpr (LDSM) {
          static_assert(NS == 2, "one ldmatrix covers two key tiles");
          unsigned r[4];
          frag_a_ldsm<P>(r, qw, 8 * j, lane);
          const float xq[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]),
                               __uint_as_float(r[2]), __uint_as_float(r[3])};
          split4<false>(ah, al, xq);   // Q scaled: below the cap
          // lanes 8m ... 8m+7 address matrix m: keys 8 (m / 2) ..., d 8j +
          // 4 (m % 2) ...: b0, b1 of key tile 0, then of key tile 1
          const float* kr = ks + ((lane & 7) + ((lane >> 4) << 3)) * P +
                            8 * j + ((lane >> 3) & 1) * 4;
          ldmatrix_x4(kh, kr);
          ldmatrix_x4(kl, kr + F::PLANE);
        } else {
          frag_a<P, false>(ah, al, qw, 8 * j, g, t);
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            frag_b_nk<P>(*reinterpret_cast<unsigned(*)[2]>(kh + 2 * n),
                         ks + n * 8 * P, 8 * j, g, t);
            frag_b_nk<P>(*reinterpret_cast<unsigned(*)[2]>(kl + 2 * n),
                         ks + F::PLANE + n * 8 * P, 8 * j, g, t);
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const unsigned bh[2] = {kh[2 * n], kh[2 * n + 1]};
          const unsigned bl[2] = {kl[2 * n], kl[2 * n + 1]};
          if (j1 == 0)
            mma3_first(c[u][n], ah, al, bh, bl);
          else
            mma3(c[u][n], ah, al, bh, bl);
        }
      }
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = c[0][n][e];
#pragma unroll
        for (int u = 1; u < KC; ++u) s[n][e] += c[u][n][e];
      }

    // mask (only where the block touches an edge), online softmax
    const bool edge = (k0 + FBK > Sk) || (causal && k0 + FBK - 1 > row_lo) ||
                      (window > 0 && k0 < row_lo + 16 - window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row_lo + g + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * r + e];
          if (edge) {
            const int kpos = k0 + n * 8 + 2 * t + e;
            if (kpos >= Sk || (causal && kpos > qpos) ||
                (window > 0 && kpos <= qpos - window))
              x = -INFINITY;
          }
          s[n][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // a row with no unmasked key so far: exponents relative to 0, all p = 0
      const float m_ref = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = exp2f(m[r] - m_ref);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[n][2 * r + e] - m_ref);
          s[n][2 * r + e] = p;
          psum += p;
        }
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * r] *= corr;
        acc[dt][2 * r + 1] *= corr;
      }
    }

    // O += P V: each 8-key column tile of P is an A fragment; fresh
    // accumulators for each 8 output columns, added on the CUDA cores
    unsigned ph[NS][4], pl[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) frag_of_acc(ph[n], pl[n], s[n]);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      float x[4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        unsigned bh[2], bl[2];
        frag_b_kn_acc<P>(bh, vs + n * 8 * P, dt * 8, g, t);
        frag_b_kn_acc<P>(bl, vs + F::PLANE + n * 8 * P, dt * 8, g, t);
        if (n == 0)
          mma3_first(x, ph[n], pl[n], bh, bl);
        else
          mma3(x, ph[n], pl[n], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] += x[e];
    }
  }

  // normalise and store the rows below Sq, f32 pairs
  float* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qrow = q0 + warp * 16 + g + 8 * r;
    if (qrow >= Sq) continue;
    // natural-base log-sum-exp of the row's scaled scores (m is in log2
    // units of them); +inf for a row that saw no key
    if (lse != nullptr && t == 0)
      lse[(long long)bh * Sq + qrow] =
          sum == 0.f ? INFINITY : (m[r] + log2f(sum)) * 0.6931471805599453f;
    const float inv = 1.f / (sum == 0.f ? 1.f : sum);
    float* orow = ob + (long long)qrow * st.o_s + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(orow + dt * 8) =
          make_float2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: both products on wgmma, K and V blocks fed by TMA.  160 threads:
// one consumer warpgroup owns the tile's 64 query rows (warp w rows
// [16w, 16w+16)); warp 4 is the producer, one thread of which issues every
// TMA load.  Q is loaded once; K and V blocks of TBK keys go through a ring
// of 2 stages with full and empty mbarriers, so block j+1 loads while block
// j computes.  S = Q K^T is m64n64k16 with both operands in shared memory
// (K-major); P stays in registers: the accumulator layout of S is the A
// fragment of O += P V (m64nDk16, A from registers; V is MN-major, the
// transpose bit set).  Row sums are kept per thread and reduced over the
// four lanes of a row once, at the end.
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 160;   // consumer warpgroup + producer warp
constexpr int TBK = 64;           // keys of a KV block on the wgmma path
constexpr int TSTAGES = 2;

template <int D>
struct TcTile {
  static constexpr int BOX_Q = BQ * 128;     // 64 rows of 64 bf16
  static constexpr int BOX_KV = TBK * 128;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = TBK * D * 2;
  // Q, the K and V rings, barriers, and room to align Q to 1024 bytes
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * TSTAGES * KV_BYTES +
                              (2 * TSTAGES + 1) * 8;
};

template <int D>
__device__ __forceinline__ void pv_step(float (&acc)[D / 2],
                                        const unsigned (&a)[4], uint64_t db) {
  if constexpr (D == 256)
    wgmma_m64n256k16_rs<1>(acc, a, db, 1);
  else if constexpr (D == 128)
    wgmma_m64n128k16_rs<1>(acc, a, db, 1);
  else
    wgmma_m64n64k16_rs<1>(acc, a, db, 1);
}

// CTAs an SM the bf16 kernel is built for: two up to head_dim 128; one at
// 256, whose 161 KB of shared memory and 128 accumulator registers a thread
// leave room for no second
template <int D>
constexpr int tc_ctas() { return D == 256 ? 1 : 2; }
static_assert(TcTile<256>::SMEM <= 232448, "227 KB of shared memory a block");

// WIN: a sliding window is applied (window > 0); the kernel without it is
// compiled apart, so the window's tests cost the common case nothing
template <int D, bool WIN>
__global__ void __launch_bounds__(TC_THREADS, tc_ctas<D>())
flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int start, int num_tiles,
                       int n_qblocks, int Hq, int G, int Sq, int Sk,
                       int causal, int window, long long o_b, long long o_s,
                       long long o_h, float scale_log2e) {
  using T = TcTile<D>;
  constexpr int NB = D / 64;       // 64-wide boxes of the head dim
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int NT = TBK / 8;      // 8-key column tiles of S
  constexpr int DT = D / 8;        // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + T::Q_BYTES;                 // [stage][box][TBK][64]
  unsigned char* sV = sK + TSTAGES * T::KV_BYTES;      // [stage][box][TBK][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + TSTAGES * T::KV_BYTES);
  uint64_t* empty = full + TSTAGES;
  uint64_t* qbar = empty + TSTAGES;

  // longest causal tiles first: CTA x runs the atom's tiles from the end
  const int t = start + num_tiles - 1 - (int)blockIdx.x;
  const int bh = t / n_qblocks, qi = t % n_qblocks;
  const int b = bh / Hq, h = bh % Hq, hk = h / G;
  const int q0 = qi * BQ;
  const int off = Sk - Sq;        // qpos = off + query row
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, off + q_last + 1) : Sk;
  const int nblocks = k_end > 0 ? (k_end + TBK - 1) / TBK : 0;
  // the first block the window lets the tile's first row see
  const int blk0 = WIN ? max(0, off + q0 - window + 1) / TBK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TSTAGES; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx
      mbar_init(&empty[s], 4);   // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp
    if (threadIdx.x == 128) {
      mbar_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load_4d(sQ + j * T::BOX_Q, &map_q, qbar, 64 * j, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int blk = blk0; blk < nblocks; ++blk) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * T::KV_BYTES);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(sK + stage * T::KV_BYTES + j * T::BOX_KV, &map_k,
                      &full[stage], 64 * j, hk, blk * TBK, b);
          tma_load_4d(sV + stage * T::KV_BYTES + j * T::BOX_KV, &map_v,
                      &full[stage], 64 * j, hk, blk * TBK, b);
        }
        if (++stage == TSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;   // row within 8, column pair
  const int row_lo = off + q0 + warp * 16;  // qpos of the warp's first row
  // rows g and g+8 of the warp's slice
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int blk = blk0; blk < nblocks; ++blk) {
    const int k0 = blk * TBK;
    mbar_wait(&full[stage], phase);
    const unsigned char* kt = sK + stage * T::KV_BYTES;
    const unsigned char* vt = sV + stage * T::KV_BYTES;

    // S = Q K^T for the tile's 64 rows x TBK keys
    float s[TBK / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n64k16_ss<0>(
          s, wgmma_desc(sQ + (ks / 4) * T::BOX_Q + (ks % 4) * 32, 16, 1024),
          wgmma_desc(kt + (ks / 4) * T::BOX_KV + (ks % 4) * 32, 16, 1024),
          ks > 0);
    wgmma_commit();
    wgmma_wait<0>();

    // scale, mask (only where the block touches an edge), online softmax
    const bool edge = (k0 + TBK > Sk) || (causal && k0 + TBK - 1 > row_lo) ||
                      (WIN && k0 < row_lo + 16 - window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row_lo + g + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * nt + 2 * r + c] * scale_log2e;
          if (edge) {
            const int kpos = k0 + nt * 8 + 2 * tq + c;
            if (kpos >= Sk || (causal && kpos > qpos) ||
                (WIN && kpos <= qpos - window))
              x = -INFINITY;
          }
          s[4 * nt + 2 * r + c] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // a row with no unmasked key so far: exponents relative to 0, all p = 0
      const float m_ref = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = exp2f(m[r] - m_ref);
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[4 * nt + 2 * r + c] - m_ref);
          s[4 * nt + 2 * r + c] = p;
          psum += p;
        }
      }
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[4 * dt + 2 * r] *= corr;
        acc[4 * dt + 2 * r + 1] *= corr;
      }
    }

    // O += P V: two 8-key column tiles of S are one A fragment
    unsigned pf[TBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk)
      pv_step<D>(acc, pf[kk], wgmma_desc(vt + kk * 2048, T::BOX_KV, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[stage]);   // this warp is done with it
    if (++stage == TSTAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // normalise and store the rows below Sq, bf16 pairs
  __nv_bfloat16* ob = o + b * o_b + h * o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / (sum == 0.f ? 1.f : sum);
    const int qrow = q0 + warp * 16 + g + 8 * r;
    // natural-base log-sum-exp of the row's scaled scores (m is in log2
    // units of them); +inf for a row that saw no key
    if (lse != nullptr && tq == 0 && qrow < Sq)
      lse[(long long)bh * Sq + qrow] =
          sum == 0.f ? INFINITY : (m[r] + log2f(sum)) * 0.6931471805599453f;
    if (qrow < Sq) {
      __nv_bfloat16* orow = ob + (long long)qrow * o_s + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<unsigned*>(orow + dt * 8) =
            pack_bf16(acc[4 * dt + 2 * r] * inv, acc[4 * dt + 2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int start, int num_tiles, int n_qblocks, int B,
                int Hq, int G, int Sq, int Sk, int causal, int window,
                const Strides& st, cudaStream_t stream) {
  // [B, S, H, D] as 4-D maps {D, H, S, B}: boxes of 64 (D) x 1 head x rows
  const uint64_t esz = 2;
  CUtensorMap map_q, map_k, map_v;
  {
    const uint64_t dims[4] = {D, (uint64_t)Hq, (uint64_t)Sq, (uint64_t)B};
    const uint64_t strides[3] = {st.q_h * esz, st.q_s * esz, st.q_b * esz};
    const uint32_t box[4] = {64, 1, BQ, 1};
    if (int e = encode_bf16_map(&map_q, q, 4, dims, strides, box)) return e;
  }
  {
    const uint64_t dims[4] = {D, (uint64_t)(Hq / G), (uint64_t)Sk,
                              (uint64_t)B};
    const uint32_t box[4] = {64, 1, TBK, 1};
    const uint64_t ks[3] = {st.k_h * esz, st.k_s * esz, st.k_b * esz};
    if (int e = encode_bf16_map(&map_k, k, 4, dims, ks, box)) return e;
    const uint64_t vs[3] = {st.v_h * esz, st.v_s * esz, st.v_b * esz};
    if (int e = encode_bf16_map(&map_v, v, 4, dims, vs, box)) return e;
  }
  auto kernel = window > 0 ? flash_attn_bf16_kernel<D, true>
                            : flash_attn_bf16_kernel<D, false>;
  constexpr int smem = TcTile<D>::SMEM;   // above 48 KB: dynamic, opted in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<num_tiles, TC_THREADS, smem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), lse, start,
      num_tiles, n_qblocks, Hq, G, Sq, Sk, causal, window, st.o_b, st.o_s,
      st.o_h, scale_log2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int start, int num_tiles, int n_qblocks, int Hq,
               int G, int Sq, int Sk, int causal, int window,
               const Strides& st, cudaStream_t stream) {
  auto kernel = flash_attn_tf32_kernel<D>;
  constexpr int smem = F32Tile<D>::BYTES;   // above 48 KB: dynamic, opted in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, start,
      num_tiles, n_qblocks, Hq, G, Sq, Sk, causal, window, st,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// The tile of q rows this kernel was compiled for; the wrapper sizes the
// tile space with it.
extern "C" int flash_attention_block_q() { return BQ; }

// The keys of a KV block a bf16 tile visits; the cost model pads to it.
extern "C" int flash_attention_key_block() { return TBK; }

// Thread blocks (one a tile) of the kernel for (D, dtype) that one SM holds
// at once, or minus a CUDA error code (-1: a shape the kernel does not take).
extern "C" int flash_attention_ctas_per_sm(int D, int dtype) {
  const void* k = nullptr;
  int threads = 0, smem = 0;
  if (dtype == 1) {
    threads = TC_THREADS;
    if (D == 64) {
      k = (const void*)flash_attn_bf16_kernel<64, false>;
      smem = TcTile<64>::SMEM;
    } else if (D == 128) {
      k = (const void*)flash_attn_bf16_kernel<128, false>;
      smem = TcTile<128>::SMEM;
    } else if (D == 256) {
      k = (const void*)flash_attn_bf16_kernel<256, false>;
      smem = TcTile<256>::SMEM;
    }
  } else if (dtype == 0) {
    threads = F_THREADS;
    if (D == 64) {
      k = (const void*)flash_attn_tf32_kernel<64>;
      smem = F32Tile<64>::BYTES;
    } else if (D == 128) {
      k = (const void*)flash_attn_tf32_kernel<128>;
      smem = F32Tile<128>::BYTES;
    } else if (D == 256) {
      k = (const void*)flash_attn_tf32_kernel<256>;
      smem = F32Tile<256>::BYTES;
    }
  }
  if (k == nullptr) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Tiles [start, start+num_tiles) of the flat tile space (B*Hq) x
// ceil(Sq/BQ), written in place into o.  q, o: [B,Sq,Hq,D]; k, v:
// [B,Sk,Hk,D]; strides in elements, last stride 1.  A query row at position
// qpos = Sk - Sq + row sees key kpos if kpos <= qpos (causal) and kpos >
// qpos - window (window > 0: a sliding window of `window` keys).  dtype:
// 0 = float32, 1 = bfloat16.  `lse` (nullptr: none) receives each row's
// natural-base log-sum-exp of its scaled scores, f32 [B,Hq,Sq] contiguous,
// +inf for a row with no visible key; only the atom's rows are written.
// Returns the CUDA error code of the launch (0 = success), -1 for a shape
// the kernel does not take, or -2 if a tensor map cannot be encoded.
extern "C" int flash_attention_atom(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int start, int num_tiles, int n_qblocks, int B, int Hq, int G, int Sq,
    int Sk, int D, int causal, int window, int dtype,
    long long q_b, long long q_s, long long q_h,
    long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h,
    long long o_b, long long o_s, long long o_h, void* stream) {
  if (num_tiles <= 0) return 0;
  const Strides st{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS \
  q, k, v, o, static_cast<float*>(lse), start, num_tiles, n_qblocks
#define FLASH_TAIL G, Sq, Sk, causal, window, st, s
  if (dtype == 0 && D == 64) return launch_f32<64>(FLASH_ARGS, Hq, FLASH_TAIL);
  if (dtype == 0 && D == 128) return launch_f32<128>(FLASH_ARGS, Hq, FLASH_TAIL);
  if (dtype == 0 && D == 256) return launch_f32<256>(FLASH_ARGS, Hq, FLASH_TAIL);
  if (dtype == 1 && D == 64) return launch_bf16<64>(FLASH_ARGS, B, Hq, FLASH_TAIL);
  if (dtype == 1 && D == 128) return launch_bf16<128>(FLASH_ARGS, B, Hq, FLASH_TAIL);
  if (dtype == 1 && D == 256) return launch_bf16<256>(FLASH_ARGS, B, Hq, FLASH_TAIL);
#undef FLASH_ARGS
#undef FLASH_TAIL
  return -1;
}
