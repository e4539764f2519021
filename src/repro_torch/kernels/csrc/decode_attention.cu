// Atomizable GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (`_decode_attn_kernel`, launched by `decode_attention_atom`): one new token
// per batch row against that row's KV stripe, masked to kpos < len[b].
//
// What bounds it on this card: bytes.  Every valid K and V element is read
// once and used for G multiply-adds, far below the ~295 operations a byte the
// H100 needs before its arithmetic is the limit.  The least time is
// (valid K/V bytes + q + o) / memory rate.  To reach it the card's 132 SMs
// must all stream, but a decode step has few rows: R = B*Hk is 32 for 4
// slots of llama3-8b and 8 for one, so one thread block a row leaves most
// SMs idle and sets the time by the longest row streamed through one SM.
//
// The atom contract, on every path: the schedulable unit is the row
// r = b*Hk + hk (the TPU kernel's row); an atom runs rows [start,
// start+num_rows) and writes only their outputs, in place, so atoms over
// disjoint ranges compose in any order, bit for bit.  K/V are read in the
// cache's own [B,S,Hk,D] strides (no transposed or padded copy); len[b] is
// clamped to [0,S], nothing past the valid prefix contributes, and a row of
// length 0 gives zeros (l == 0 -> 1).
//
// bfloat16 (decode_split_bf16_kernel): split-KV over a thread block cluster.
// The caches must have 16-byte pitches and 16-byte aligned data, which TMA
// addresses; the wrapper raises for others, as it did before this design.
//   * grid (nsplit, num_rows), a cluster of nsplit CTAs a row.  CTA j takes
//     keys [j*chunk, min((j+1)*chunk, len)).  nsplit in {1, 2, 4, 8} and
//     chunk (a multiple of the 64-key block) come from kv_split(R_total, S,
//     fit): the largest nsplit whose R_total clusters the card runs at once,
//     so every row is in flight in one round (a second round costs more
//     than the shorter splits save).  They depend on the whole call's
//     R_total = B*Hk and the card, never on the atom, so every atom runs a
//     row's arithmetic the same way.  A CTA whose split starts at or past
//     len loads nothing;
//   * inside a CTA one producer warp issues TMA loads of 64-key blocks of K
//     and V (4-D tensor maps {D, Hk, S, B} over the cache as it lies, boxes
//     of 64 columns x 64 keys, 128-byte swizzle) into a ring of stages with
//     full / empty mbarriers (3 at head_dim 128, 6 at 64: 96 KB), so loads
//     stay in flight while the four consumer warps compute.  Each consumer
//     takes 16 keys of every block: S = Q K^T and O += P V on the tensor
//     cores (mma.sync m16n8k16, the G heads padded to 16 rows, 16 a pass),
//     online softmax in f32 in the base-2 domain, fragments read with
//     ldmatrix at the swizzled addresses (16-byte chunk index XOR row % 8);
//   * at the end of a pass the ring is idle: each warp parks its partial
//     (m, l, O) there, and the consumers merge the four in warp order, four
//     columns a thread, into the CTA's partial (rows padded by 8 floats:
//     no bank conflicts).  After a cluster barrier each CTA merges D/nsplit
//     columns of the row, reading the peers' partials through distributed
//     shared memory and summing in split order 0..nsplit-1 (deterministic),
//     and writes them.  A second cluster barrier keeps
//     every CTA's shared memory alive until its peers have read it;
//   * 106 KB of shared memory at head_dim 128: two CTAs an SM.  At 256
//     (RecurrentGemma's MQA: G = 16 heads on one KV row fill the 16 rows of
//     a pass) a key row is four 64-column boxes, the ring two stages, 146 KB:
//     one CTA an SM, whose 255-register budget holds the 128 accumulators
//     and 64 Q fragment registers a consumer thread keeps.  A sliding-window
//     layer's ring-buffer cache needs nothing more: softmax is order-free
//     and RoPE is applied before caching, so the caller passes
//     lens = min(pos + 1, window).
// What holds it back (PERF.md): a fixed cost beyond launching at any length
// (prologue, two cluster barriers, two merges), and, at a few dozen rows,
// clusters of 8 that do not all fit the card at once.
// float32 (decode_split_f32_kernel): the same split-KV schedule over a
// cluster (kv_split over the f32 kernel's own cluster fit, the same chunk),
// producer warp, ring and merges, with full f32 products on the CUDA cores:
// the route is held to 2e-5, which TF32 would not meet, and it is bytes-bound
// (G <= 8 multiply-adds a loaded float each for Q K^T and P V, where an SM
// streams ~15 bytes a cycle at the card's memory rate).  What holds it back
// (PERF.md): the fixed cost of the bf16 kernel's (~0.010 ms), and the
// arithmetic, which four warps do not hide entirely behind the loads.
//   * a stage is 16 KB of K and 16 KB of V: 4096 / D keys (64, 32 or 16) in
//     one unswizzled TMA box each, rows of D floats; three stages, 96 KB, and
//     the CTA's partial: two CTAs an SM at every head dim;
//   * a consumer warp takes a quarter of each stage's keys, several keys a
//     warp step: a lane holds 16 columns of a key row (8 lanes a row at head
//     dim 128; 4 or 8 columns with 8 heads a pass, whose registers would
//     spill) as float4s 4*LPK columns apart, so each load of a step reads
//     whole 128-byte pieces of rows (free of bank conflicts at head dim 128
//     and 256; two-way at 64, 64 bytes a row a piece); q's heads (up
//     to 8 a pass) and their accumulators sit in registers at the same
//     columns.  A score is the lane's dot product summed over the key's
//     lanes with shuffles (three rounds at 8 lanes, where 32 lanes a row
//     took five and ran 1.5x slower); the online softmax runs in the base-2
//     domain over a batch of steps, its running max shared by the warp's
//     keys, and a key past the split's end is not read for P V;
//   * the warps' partials are merged in warp order, then the splits' in
//     split order over distributed shared memory, l == 0 -> 1: the
//     arithmetic of decode_attention_split_ref.
// Both routes optionally write each query row's lse, m + log(l) in f32
// (-inf for a row of length 0), from the split merge that already holds
// the row's m and l: the CTA that stores a row's first columns stores it.
// With it the bf16 route may write an f32 output.  A caller that splits a
// cache into parts (sequence shards over ranks) combines their (o, lse)
// rounding once (merge.py).  A null lse pointer writes none: the launch
// and its arithmetic are the same.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

struct Strides {
  long long q_b, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_h;
  long long lse_b, lse_h;
};

constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bfloat16, split-KV over a thread block cluster, fed by TMA (the header
// says why).  160 threads: warps 0-3 consume, warp 4 produces.
// ---------------------------------------------------------------------------

constexpr int SPLIT_CONSUMERS = 4;                          // consumer warps
constexpr int SPLIT_THREADS = (SPLIT_CONSUMERS + 1) * 32;   // + the producer
constexpr int KEY_BLOCK = 64;    // keys of a TMA block (one stage of the ring)
constexpr int WKEYS = KEY_BLOCK / SPLIT_CONSUMERS;   // a consumer's keys of it
constexpr int MAX_SPLIT = 8;     // the portable cluster size
constexpr int QROWS = 16;        // query heads a pass (the M of mma)

struct KvSplit {
  int nsplit, chunk;
};

// The split schedule of a call over R_total = B*Hk rows of S keys: the
// largest nsplit in {1, 2, 4, 8}, at most the 64-key blocks of S, whose
// R_total clusters the card runs at once (fit[i]: clusters of 2^i CTAs that
// it runs at once, from cudaOccupancyMaxActiveClusters), so that every
// row's cluster is in flight in one round; chunk, the keys of a split, a
// multiple of 64.  ops.kv_split mirrors it.
inline int key_blocks(int S) {
  return S > 0 ? (S + KEY_BLOCK - 1) / KEY_BLOCK : 1;
}

inline int kv_split_chunk(int S, int nsplit) {
  return (key_blocks(S) + nsplit - 1) / nsplit * KEY_BLOCK;
}

inline KvSplit kv_split(int R_total, int S, const int* fit) {
  const int nb = key_blocks(S);
  int n = 1;
  for (int i = 1; (1 << i) <= MAX_SPLIT && (1 << i) <= nb; ++i)
    if (fit[i] >= R_total) n = 1 << i;
  return {n, kv_split_chunk(S, n)};
}

template <int D>
struct SplitTile {
  static constexpr int NB = D / 64;                  // 64-column boxes a row
  static constexpr int BOX = KEY_BLOCK * 128;        // 64 keys x 128 bytes
  static constexpr int KV_BYTES = KEY_BLOCK * D * 2;     // a block of K or V
  // 96 KB of ring up to head_dim 128; two stages (128 KB) at 256, so that
  // a block loads while the one before it computes
  static constexpr int STAGES = D == 256 ? 2 : 384 / D;
  // the CTA's partial O rows are padded by 8 floats, so that the float2
  // accesses of a warp's accumulator fragments are free of bank conflicts
  static constexpr int LDP = D + 8;
  static constexpr int PART = QROWS * LDP + 2 * QROWS;   // floats: O, m, l
  // the K and V rings, the CTA's partial, barriers, and room to align the
  // rings to 1024 bytes
  static constexpr int SMEM =
      1024 + 2 * STAGES * KV_BYTES + PART * 4 + 2 * STAGES * 8;
  // the consumer warps park their partials in the idle ring
  static_assert(SPLIT_CONSUMERS * PART * 4 <= 2 * STAGES * KV_BYTES,
                "the ring holds the warps' partials");
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
};

// CTAs an SM the split kernel is built for: two up to head_dim 128; one at
// 256, whose 146 KB of shared memory and 128 accumulator registers a thread
// (and 64 of Q fragments) leave room for no second
template <int D>
constexpr int split_ctas() { return D == 256 ? 1 : 2; }

// byte offset, in a block that TMA wrote with 128-byte swizzle, of the
// 16-byte chunk holding columns [col, col+8) of key row `row`
__device__ __forceinline__ int swizzled(int row, int col) {
  return (col >> 6) * (KEY_BLOCK * 128) + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4);
}

// barrier of the four consumer warps alone (the producer is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(SPLIT_CONSUMERS * 32) : "memory");
}

// A partial (O, m, l) of ROWS heads: O [ROWS][LD] floats, then m [ROWS]
// and l [ROWS].  The consumer warps' partials of a pass, parked in the idle
// ring one every `slot` floats, merged in warp order into the CTA's at
// `part`, four columns a consumer thread: the pass's ng heads.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void merge_warps(const float* ring, int slot,
                                            float* part, int ng) {
  for (int idx = threadIdx.x; idx < ng * (D / 4);
       idx += SPLIT_CONSUMERS * 32) {
    const int row = idx / (D / 4), col = (idx % (D / 4)) * 4;
    float mw[SPLIT_CONSUMERS], lw[SPLIT_CONSUMERS];
    float4 aw[SPLIT_CONSUMERS];
#pragma unroll
    for (int w = 0; w < SPLIT_CONSUMERS; ++w) {
      const float* pw = ring + w * slot;
      mw[w] = pw[ROWS * LD + row];
      lw[w] = pw[ROWS * LD + ROWS + row];
      aw[w] = *reinterpret_cast<const float4*>(pw + row * LD + col);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < SPLIT_CONSUMERS; ++w) mx = fmaxf(mx, mw[w]);
    const float m_ref = (mx == -INFINITY) ? 0.f : mx;
    float lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < SPLIT_CONSUMERS; ++w) {
      const float f = exp2f(mw[w] - m_ref);
      lsum += f * lw[w];
      a.x += f * aw[w].x;
      a.y += f * aw[w].y;
      a.z += f * aw[w].z;
      a.w += f * aw[w].w;
    }
    *reinterpret_cast<float4*>(part + row * LD + col) = a;
    if (col == 0) {
      part[ROWS * LD + row] = mx;
      part[ROWS * LD + ROWS + row] = lsum;
    }
  }
}

// After a cluster barrier every CTA's partial at `part` is complete; CTA
// `split` merges columns [split*cw, (split+1)*cw) of the pass's ng heads
// over the splits, four columns a consumer thread: f_j = 2^(m_j - m), O =
// sum_j f_j O_j / sum_j f_j l_j in split order, and hands each four
// columns to store(row, col, O).  With `lse` (the pass's first head's, rows
// lse_h apart) the thread of a row's column 0 also writes its lse, (m +
// log2(sum_j f_j l_j)) ln 2 in the base-2 domain's units, -inf without a
// valid key.
template <int D, int ROWS, int LD, class Store>
__device__ __forceinline__ void merge_splits(const float* part, int ng,
                                             int split, int nsplit,
                                             float* lse, long long lse_h,
                                             Store store) {
  const int cw4 = D / nsplit / 4;   // 4-column groups this CTA merges
  for (int idx = threadIdx.x; idx < ng * cw4; idx += SPLIT_CONSUMERS * 32) {
    const int row = idx / cw4, col = split * cw4 * 4 + (idx % cw4) * 4;
    // the peers' maxima first; then each split's l and O, loaded and
    // summed in split order (holding every split's O at once spills)
    float mj[MAX_SPLIT];
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j)
      mj[j] = j < nsplit
                  ? ld_cluster_f32(cluster_map(part + ROWS * LD + row, j))
                  : -INFINITY;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) mx = fmaxf(mx, mj[j]);
    const float m_ref = (mx == -INFINITY) ? 0.f : mx;   // no key at all
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) {
      if (j < nsplit) {
        const float lv =
            ld_cluster_f32(cluster_map(part + ROWS * LD + ROWS + row, j));
        const float4 av =
            ld_cluster_f32x4(cluster_map(part + row * LD + col, j));
        const float f = exp2f(mj[j] - m_ref);   // 0 for an empty split
        den += f * lv;
        num.x += f * av.x;
        num.y += f * av.y;
        num.z += f * av.z;
        num.w += f * av.w;
      }
    }
    if (lse != nullptr && col == 0)
      lse[row * lse_h] = den == 0.f ? -INFINITY : (m_ref + log2f(den)) * LN2;
    if (den == 0.f) den = 1.f;   // no valid key: zeros, as the reference
    store(row, col,
          make_float4(num.x / den, num.y / den, num.z / den, num.w / den));
  }
}

// OutT: __nv_bfloat16, or float for a partial that a combine rounds once
template <int D, class OutT>
__global__ void __launch_bounds__(SPLIT_THREADS, split_ctas<D>())
decode_split_bf16_kernel(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __nv_bfloat16* __restrict__ q,
                         const int* __restrict__ lens, OutT* __restrict__ o,
                         float* __restrict__ lse, int start, int Hk, int G,
                         int S, int chunk, long long q_b, long long q_h,
                         long long o_b, long long o_h, long long lse_b,
                         long long lse_h, float scale_log2e) {
  using T = SplitTile<D>;
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr int DT = D / 8;      // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + T::STAGES * T::KV_BYTES;
  float* part = reinterpret_cast<float*>(sV + T::STAGES * T::KV_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + T::PART);
  uint64_t* empty = full + T::STAGES;

  const int split = blockIdx.x;     // the CTA's rank in its cluster
  const int nsplit = gridDim.x;     // the cluster spans x
  const int r = start + blockIdx.y;
  const int b = r / Hk, hk = r % Hk;
  const int len = min(max(lens[b], 0), S);
  const int k_begin = split * chunk;
  const int k_end = min(k_begin + chunk, len);
  const int nblocks =
      k_end > k_begin ? (k_end - k_begin + KEY_BLOCK - 1) / KEY_BLOCK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == SPLIT_CONSUMERS && lane == 0 && nblocks > 0) {
    tma_prefetch_map(&map_k);
    tma_prefetch_map(&map_v);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);                  // the producer's expect_tx
      mbar_init(&empty[s], SPLIT_CONSUMERS);   // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // ring position: both sides walk the same sequence of blocks
  int stage = 0;
  uint32_t phase = 0;
  for (int g0 = 0; g0 < G; g0 += QROWS) {
    const int ng = min(QROWS, G - g0);
    if (warp == SPLIT_CONSUMERS) {
      if (lane == 0) {
        for (int blk = 0; blk < nblocks; ++blk) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * T::KV_BYTES);
          const int key = k_begin + blk * KEY_BLOCK;
#pragma unroll
          for (int j = 0; j < T::NB; ++j) {
            tma_load_4d(sK + stage * T::KV_BYTES + j * T::BOX, &map_k,
                        &full[stage], 64 * j, hk, key, b);
            tma_load_4d(sV + stage * T::KV_BYTES + j * T::BOX, &map_v,
                        &full[stage], 64 * j, hk, key, b);
          }
          if (++stage == T::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else {
      const int g = lane >> 2, tq = lane & 3;   // row within 8, column pair
      // this pass's heads as the A fragments of Q K^T, rows >= ng zero
      unsigned qf[KS][4];
      const __nv_bfloat16* qb = q + b * q_b + (long long)(hk * G + g0) * q_h;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = g + (i & 1) * 8, col = ks * 16 + 2 * tq + (i >> 1) * 8;
          qf[ks][i] = row < ng ? *reinterpret_cast<const unsigned*>(
                                     qb + row * q_h + col)
                               : 0u;
        }
      }
      // heads g and g+8 of this pass
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float acc[DT][4];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
      }
      const int kr0 = warp * WKEYS;   // this warp's first key row of a block

      for (int blk = 0; blk < nblocks; ++blk) {
        mbar_wait(&full[stage], phase);
        const unsigned char* kt = sK + stage * T::KV_BYTES;
        const unsigned char* vt = sV + stage * T::KV_BYTES;

        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < KS; ks += 2) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            unsigned kf[4];   // (b0, b1) of k-step ks, then of ks+1
            ldmatrix_x4(kf, kt + swizzled(kr0 + nt * 8 + (lane & 7),
                                          ks * 16 + (lane >> 3) * 8));
            mma_bf16(s[nt], qf[ks], kf[0], kf[1]);
            mma_bf16(s[nt], qf[ks + 1], kf[2], kf[3]);
          }
        }

        const int kpos0 = k_begin + blk * KEY_BLOCK + kr0;
        const bool edge = kpos0 + WKEYS > k_end;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float x = s[nt][2 * rr + c] * scale_log2e;
              if (edge && kpos0 + nt * 8 + 2 * tq + c >= k_end) x = -INFINITY;
              s[nt][2 * rr + c] = x;
              mx = fmaxf(mx, x);
            }
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[rr], mx);
          // no valid key so far: exponents relative to 0, all p = 0
          const float m_ref = (m_new == -INFINITY) ? 0.f : m_new;
          const float corr = exp2f(m[rr] - m_ref);
          float psum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float p = exp2f(s[nt][2 * rr + c] - m_ref);
              s[nt][2 * rr + c] = p;
              psum += p;
            }
          }
          l[rr] = l[rr] * corr + psum;
          m[rr] = m_new;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            acc[dt][2 * rr] *= corr;
            acc[dt][2 * rr + 1] *= corr;
          }
        }

        // O += P V: the two 8-key tiles of S are one A fragment
        unsigned pf[4];
        pf[0] = pack_bf16(s[0][0], s[0][1]);
        pf[1] = pack_bf16(s[0][2], s[0][3]);
        pf[2] = pack_bf16(s[1][0], s[1][1]);
        pf[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          unsigned vf[4];   // (b0, b1) of column tile dt, then of dt+1
          ldmatrix_x4_trans(vf, vt + swizzled(kr0 + (lane & 7) +
                                                  ((lane >> 3) & 1) * 8,
                                              dt * 8 + (lane >> 4) * 8));
          mma_bf16(acc[dt], pf, vf[0], vf[1]);
          mma_bf16(acc[dt + 1], pf, vf[2], vf[3]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);   // this warp is done
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // the warps' partials -> the ring, idle once every warp is done with
      // its last block (every load of the pass has landed; the producer
      // waits at the cluster barrier), one slot a warp; then the CTA's
      // (O, m, l) of the pass's ng heads, merged over the warps in warp
      // order, four columns a thread
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      }
      consumers_sync();   // no warp still reads the ring's last blocks
      float* wpart = reinterpret_cast<float*>(sK) + warp * T::PART;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = g + 8 * rr;
        if (row >= ng) continue;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
          *reinterpret_cast<float2*>(wpart + row * T::LDP + dt * 8 + 2 * tq) =
              make_float2(acc[dt][2 * rr], acc[dt][2 * rr + 1]);
        if (tq == 0) {
          wpart[QROWS * T::LDP + row] = m[rr];
          wpart[QROWS * T::LDP + QROWS + row] = l[rr];
        }
      }
      consumers_sync();
      merge_warps<D, QROWS, T::LDP>(reinterpret_cast<const float*>(sK),
                                    T::PART, part, ng);
      fence_proxy_async();   // TMA writes the ring again in the next pass
    }

    cluster_sync();   // every CTA's partial is complete
    if (warp < SPLIT_CONSUMERS)
      merge_splits<D, QROWS, T::LDP>(
          part, ng, split, nsplit,
          lse ? lse + b * lse_b + (hk * G + g0) * lse_h : nullptr, lse_h,
          [&](int row, int col, float4 x) {
            OutT* dst = o + b * o_b + (hk * G + g0 + row) * o_h + col;
            if constexpr (sizeof(OutT) == 4)
              *reinterpret_cast<float4*>(dst) = x;
            else
              *reinterpret_cast<uint2*>(dst) =
                  make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
          });
    // no CTA overwrites its partial (next pass) or exits while a peer may
    // still read it
    cluster_sync();
  }
}

// the split kernels' launch configuration: clusters of nsplit CTAs along x,
// `rows` clusters along y
inline cudaLaunchConfig_t cluster_config(int nsplit, int rows, int smem,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, rows, 1);
  cfg.blockDim = dim3(SPLIT_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D, class OutT>
int launch_split(const void* q, const void* k, const void* v,
                 const void* lens, void* o, void* lse, int start,
                 int num_rows, int B, int Hk, int G, int S, int nsplit,
                 const Strides& st, cudaStream_t stream) {
  using T = SplitTile<D>;
  if (num_rows > 65535) return -1;   // grid y
  // [B, S, Hk, D] as 4-D maps {D, Hk, S, B}: boxes of 64 (D) x 1 x 64 keys
  const uint64_t esz = 2;
  const uint64_t dims[4] = {D, (uint64_t)Hk, (uint64_t)S, (uint64_t)B};
  const uint32_t box[4] = {64, 1, KEY_BLOCK, 1};
  CUtensorMap map_k, map_v;
  const uint64_t ks[3] = {st.k_h * esz, st.k_s * esz, st.k_b * esz};
  if (int e = encode_bf16_map(&map_k, k, 4, dims, ks, box)) return e;
  const uint64_t vs[3] = {st.v_h * esz, st.v_s * esz, st.v_b * esz};
  if (int e = encode_bf16_map(&map_v, v, 4, dims, vs, box)) return e;

  auto kernel = decode_split_bf16_kernel<D, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int chunk = kv_split_chunk(S, nsplit);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(nsplit, num_rows, T::SMEM, attr, stream);
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)D);
  err = cudaLaunchKernelEx(&cfg, kernel, map_k, map_v,
                           static_cast<const __nv_bfloat16*>(q),
                           static_cast<const int*>(lens),
                           static_cast<OutT*>(o), static_cast<float*>(lse),
                           start, Hk, G, S, chunk, st.q_b, st.q_h, st.o_b,
                           st.o_h, st.lse_b, st.lse_h, scale_log2e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// clusters of `nsplit` CTAs of the split kernel for head dim D (its bf16
// output's instance) that the current GPU runs at once, or minus a CUDA
// error code (-1: a D the kernel does not take)
template <int D>
int max_active_clusters(int nsplit) {
  using T = SplitTile<D>;
  auto kernel = decode_split_bf16_kernel<D, __nv_bfloat16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(nsplit, 1, T::SMEM, attr, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// ---------------------------------------------------------------------------
// float32, split-KV over a thread block cluster, fed by TMA: the bf16
// kernel's schedule (kv_split, its cluster of nsplit CTAs a row, a producer
// warp and four consumer warps on a ring of mbarrier'd stages, the merges in
// warp and then split order) with full f32 products on the CUDA cores (the
// header says why).
// ---------------------------------------------------------------------------

// columns a lane holds at GC heads a pass: 16 up to 4 heads (4 lanes a key
// row at head_dim 64, 8 at 128, 16 at 256: fewer shuffles a score), fewer
// at 8 heads, whose Q and accumulators would spill
template <int D, int GC>
constexpr int f32_cpl() {
  return GC <= (D == 256 ? 2 : 4) ? 16 : (D / 32 > 4 ? D / 32 : 4);
}

template <int D, int GC>
struct F32Tile {
  static constexpr int CPL = f32_cpl<D, GC>();        // columns a lane holds
  static constexpr int LPK = D / CPL;                 // lanes of a key row
  static constexpr int KPW = 32 / LPK;                // keys a warp step
  static constexpr int BK = 4096 / D;                 // keys a stage
  static constexpr int KW = BK / SPLIT_CONSUMERS;       // a consumer's of them
  static constexpr int STEPS = KW / KPW;              // its warp steps
  // warp steps whose scores are taken together (registers at D = 256)
  static constexpr int BATCH_MAX = D == 256 ? 2 : 4;
  static constexpr int BATCH = STEPS < BATCH_MAX ? STEPS : BATCH_MAX;
  static constexpr int KV_BYTES = BK * D * 4;         // 16 KB of K or of V
  static constexpr int STAGES = 3;
  static_assert(STEPS >= 1 && STEPS % BATCH == 0 && KPW * LPK == 32,
                "the lane layout");
  static_assert(KEY_BLOCK % BK == 0, "a split's chunk is whole stages");
};

// the CTA's partial (O [GC][D], m [GC], l [GC]) in floats, and the shared
// memory of the kernel at GC heads a pass: the K and V rings (aligned to
// 128 bytes for TMA), the partial, barriers
template <int D, int GC>
struct F32Smem {
  using T = F32Tile<D, GC>;
  // m and l padded to whole float4s: each warp's slot starts on 16 bytes
  static constexpr int PART = GC * D + (2 * GC + 3) / 4 * 4;
  static constexpr int BYTES =
      128 + 2 * T::STAGES * T::KV_BYTES + PART * 4 + 2 * T::STAGES * 8;
  // the consumer warps park their partials in the idle ring
  static_assert(SPLIT_CONSUMERS * PART * 4 <= 2 * T::STAGES * T::KV_BYTES,
                "the ring holds the warps' partials");
  static_assert(2 * (BYTES + 1024) <= 233472, "two CTAs an SM");
};

// column of float j of lane `gl` of a key row: the lane's float4s lie 4*LPK
// columns apart, so a warp step reads whole rows, 16 bytes a lane
template <int LPK>
__device__ __forceinline__ int f32_col(int gl, int j) {
  return (j >> 2) * 4 * LPK + 4 * gl + (j & 3);
}

template <int D, int GC>
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
decode_split_f32_kernel(const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const float* __restrict__ q,
                        const int* __restrict__ lens, float* __restrict__ o,
                        float* __restrict__ lse, int start, int Hk, int G,
                        int S, int chunk, long long q_b, long long q_h,
                        long long o_b, long long o_h, long long lse_b,
                        long long lse_h, float scale_log2e) {
  using T = F32Tile<D, GC>;
  using M = F32Smem<D, GC>;
  constexpr int CPL = T::CPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  float* sV = sK + T::STAGES * T::BK * D;
  float* part = sV + T::STAGES * T::BK * D;   // O [GC][D], m [GC], l [GC]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + M::PART);
  uint64_t* empty = full + T::STAGES;

  const int split = blockIdx.x;     // the CTA's rank in its cluster
  const int nsplit = gridDim.x;     // the cluster spans x
  const int r = start + blockIdx.y;
  const int b = r / Hk, hk = r % Hk;
  const int len = min(max(lens[b], 0), S);
  const int k_begin = split * chunk;
  const int k_end = min(k_begin + chunk, len);
  const int nblocks =
      k_end > k_begin ? (k_end - k_begin + T::BK - 1) / T::BK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == SPLIT_CONSUMERS && lane == 0 && nblocks > 0) {
    tma_prefetch_map(&map_k);
    tma_prefetch_map(&map_v);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);                  // the producer's expect_tx
      mbar_init(&empty[s], SPLIT_CONSUMERS);   // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  for (int g0 = 0; g0 < G; g0 += GC) {
    const int ng = min(GC, G - g0);
    if (warp == SPLIT_CONSUMERS) {
      if (lane == 0) {
        for (int blk = 0; blk < nblocks; ++blk) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * T::KV_BYTES);
          const int key = k_begin + blk * T::BK;
          tma_load_4d(sK + stage * T::BK * D, &map_k, &full[stage], 0, hk,
                      key, b);
          tma_load_4d(sV + stage * T::BK * D, &map_v, &full[stage], 0, hk,
                      key, b);
          if (++stage == T::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else {
      // lanes [grp*LPK, (grp+1)*LPK) take key grp of a warp step
      const int grp = lane / T::LPK, gl = lane % T::LPK;
      // this pass's heads, in the base-2 domain; heads >= ng zero
      float qr[GC][CPL];
      const float* qb = q + b * q_b + (long long)(hk * G + g0) * q_h;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
#pragma unroll
        for (int j = 0; j < CPL; j += 4) {
          float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
          if (g < ng)
            t = *reinterpret_cast<const float4*>(qb + g * q_h +
                                                 f32_col<T::LPK>(gl, j));
          qr[g][j] = t.x * scale_log2e;
          qr[g][j + 1] = t.y * scale_log2e;
          qr[g][j + 2] = t.z * scale_log2e;
          qr[g][j + 3] = t.w * scale_log2e;
        }
      }
      float m[GC], l[GC], acc[GC][CPL];
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        m[g] = -INFINITY;
        l[g] = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[g][j] = 0.f;
      }
      const int kw0 = warp * T::KW;   // this warp's first key row of a stage

      for (int blk = 0; blk < nblocks; ++blk) {
        mbar_wait(&full[stage], phase);
        const float* kt = sK + stage * T::BK * D;
        const float* vt = sV + stage * T::BK * D;
        const int kpos0 = k_begin + blk * T::BK;
#pragma unroll
        for (int s0 = 0; s0 < T::STEPS; s0 += T::BATCH) {
          // scores of BATCH warp steps: each lane's columns, then summed
          // over the key's LPK lanes (every one of them holds the sum)
          float sc[T::BATCH][GC];
          bool valid[T::BATCH];
#pragma unroll
          for (int i = 0; i < T::BATCH; ++i) {
            const int row = kw0 + (s0 + i) * T::KPW + grp;
            valid[i] = kpos0 + row < k_end;
            float kr[CPL];
#pragma unroll
            for (int j = 0; j < CPL; j += 4)
              *reinterpret_cast<float4*>(&kr[j]) =
                  *reinterpret_cast<const float4*>(kt + row * D +
                                                   f32_col<T::LPK>(gl, j));
#pragma unroll
            for (int g = 0; g < GC; ++g) {
              float d = 0.f;
#pragma unroll
              for (int j = 0; j < CPL; ++j) d = fmaf(qr[g][j], kr[j], d);
              sc[i][g] = d;
            }
          }
#pragma unroll
          for (int off = T::LPK / 2; off > 0; off >>= 1) {
#pragma unroll
            for (int i = 0; i < T::BATCH; ++i) {
#pragma unroll
              for (int g = 0; g < GC; ++g)
                sc[i][g] += __shfl_xor_sync(0xffffffffu, sc[i][g], off);
            }
          }
          // online softmax; the warp's key groups share one running max
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            float mx = -INFINITY;
#pragma unroll
            for (int i = 0; i < T::BATCH; ++i)
              if (valid[i]) mx = fmaxf(mx, sc[i][g]);
#pragma unroll
            for (int off = T::LPK; off < 32; off <<= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[g], mx);
            // no valid key so far: exponents relative to 0, all p = 0
            const float m_ref = (m_new == -INFINITY) ? 0.f : m_new;
            const float corr = exp2f(m[g] - m_ref);
            float psum = 0.f;
#pragma unroll
            for (int i = 0; i < T::BATCH; ++i) {
              const float p = valid[i] ? exp2f(sc[i][g] - m_ref) : 0.f;
              sc[i][g] = p;
              psum += p;
            }
            l[g] = l[g] * corr + psum;
            m[g] = m_new;
#pragma unroll
            for (int j = 0; j < CPL; ++j) acc[g][j] *= corr;
          }
          // O += P V; a key past the split's end is not read, so stale
          // values there (a NaN, say) cannot reach the sums
#pragma unroll
          for (int i = 0; i < T::BATCH; ++i) {
            if (!valid[i]) continue;
            const int row = kw0 + (s0 + i) * T::KPW + grp;
            float vr[CPL];
#pragma unroll
            for (int j = 0; j < CPL; j += 4)
              *reinterpret_cast<float4*>(&vr[j]) =
                  *reinterpret_cast<const float4*>(vt + row * D +
                                                   f32_col<T::LPK>(gl, j));
#pragma unroll
            for (int g = 0; g < GC; ++g) {
#pragma unroll
              for (int j = 0; j < CPL; ++j)
                acc[g][j] = fmaf(sc[i][g], vr[j], acc[g][j]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);   // this warp is done
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // the warp's key groups into one partial (they share m)
#pragma unroll
      for (int off = T::LPK; off < 32; off <<= 1) {
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        }
      }
      // the warps' partials -> the ring, idle once every warp is done with
      // its last block (the producer waits at the cluster barrier), one
      // slot a warp; then the CTA's (O, m, l) of the pass's ng heads,
      // merged over the warps in warp order, four columns a thread
      consumers_sync();
      float* wpart = sK + warp * M::PART;
      if (grp == 0) {
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          if (g >= ng) continue;
#pragma unroll
          for (int j = 0; j < CPL; j += 4)
            *reinterpret_cast<float4*>(wpart + g * D + f32_col<T::LPK>(gl, j)) =
                make_float4(acc[g][j], acc[g][j + 1], acc[g][j + 2],
                            acc[g][j + 3]);
          if (gl == 0) {
            wpart[GC * D + g] = m[g];
            wpart[GC * D + GC + g] = l[g];
          }
        }
      }
      consumers_sync();
      merge_warps<D, GC, D>(sK, M::PART, part, ng);
      fence_proxy_async();   // TMA writes the ring again in the next pass
    }

    cluster_sync();   // every CTA's partial is complete
    if (warp < SPLIT_CONSUMERS)
      merge_splits<D, GC, D>(
          part, ng, split, nsplit,
          lse ? lse + b * lse_b + (hk * G + g0) * lse_h : nullptr, lse_h,
          [&](int row, int col, float4 x) {
            *reinterpret_cast<float4*>(o + b * o_b +
                                       (hk * G + g0 + row) * o_h + col) = x;
          });
    // no CTA overwrites its partial (next pass) or exits while a peer may
    // still read it
    cluster_sync();
  }
}

template <int D, int GC>
int launch_split_f32(const void* q, const void* k, const void* v,
                     const void* lens, void* o, void* lse, int start,
                     int num_rows, int B, int Hk, int G, int S, int nsplit,
                     const Strides& st, cudaStream_t stream) {
  using T = F32Tile<D, GC>;
  using M = F32Smem<D, GC>;
  if (num_rows > 65535) return -1;   // grid y
  // [B, S, Hk, D] as 4-D maps {D, Hk, S, B}: boxes of D x 1 x BK keys, the
  // rows unswizzled (a warp reads a whole row, 16 bytes a lane)
  const uint64_t esz = 4;
  const uint64_t dims[4] = {D, (uint64_t)Hk, (uint64_t)S, (uint64_t)B};
  const uint32_t box[4] = {D, 1, T::BK, 1};
  CUtensorMap map_k, map_v;
  const uint64_t ks[3] = {st.k_h * esz, st.k_s * esz, st.k_b * esz};
  if (int e = encode_map(&map_k, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         CU_TENSOR_MAP_SWIZZLE_NONE, k, 4, dims, ks, box))
    return e;
  const uint64_t vs[3] = {st.v_h * esz, st.v_s * esz, st.v_b * esz};
  if (int e = encode_map(&map_v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         CU_TENSOR_MAP_SWIZZLE_NONE, v, 4, dims, vs, box))
    return e;

  auto kernel = decode_split_f32_kernel<D, GC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, M::BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(nsplit, num_rows, M::BYTES, attr, stream);
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)D);
  err = cudaLaunchKernelEx(&cfg, kernel, map_k, map_v,
                           static_cast<const float*>(q),
                           static_cast<const int*>(lens),
                           static_cast<float*>(o), static_cast<float*>(lse),
                           start, Hk, G, S, kv_split_chunk(S, nsplit), st.q_b,
                           st.q_h, st.o_b, st.o_h, st.lse_b, st.lse_h,
                           scale_log2e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// heads a pass: G itself up to 8 (1, 2, 4 or 8 registers' worth), passes of
// 8 above (RecurrentGemma's MQA: G = 16)
template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* lens,
               void* o, void* lse, int start, int num_rows, int B, int Hk,
               int G, int S, int nsplit, const Strides& st,
               cudaStream_t stream) {
#define F32_GC(GC)                                                       \
  launch_split_f32<D, GC>(q, k, v, lens, o, lse, start, num_rows, B, Hk, \
                          G, S, nsplit, st, stream)
  return G == 1 ? F32_GC(1) : G == 2 ? F32_GC(2) : G <= 4 ? F32_GC(4)
                                                          : F32_GC(8);
#undef F32_GC
}

// clusters of `nsplit` CTAs of the f32 kernel for head dim D that the current
// GPU runs at once, from its instance of 8 heads a pass: the most shared
// memory and registers (every instance is built for two CTAs an SM)
template <int D>
int max_active_clusters_f32(int nsplit) {
  using M = F32Smem<D, 8>;
  auto kernel = decode_split_f32_kernel<D, 8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, M::BYTES);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(nsplit, 1, M::BYTES, attr, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// The split schedule of a call (see kv_split; fit has 4 entries): the
// wrapper's mirror is checked against it when the library loads.  Returns 0.
extern "C" int decode_attention_kv_split(int R_total, int S, const int* fit,
                                         int* nsplit, int* chunk) {
  const KvSplit ks = kv_split(R_total, S, fit);
  *nsplit = ks.nsplit;
  *chunk = ks.chunk;
  return 0;
}

// Clusters of `nsplit` CTAs of the split kernel of `dtype` (0 = float32, 1 =
// bfloat16) for head dim D that the current GPU runs at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code (-1: a D,
// dtype or nsplit the kernels do not take).
extern "C" int decode_attention_max_active_clusters(int D, int dtype,
                                                    int nsplit) {
  if (nsplit < 1 || nsplit > MAX_SPLIT || (nsplit & (nsplit - 1))) return -1;
  if (dtype == 0) {
    if (D == 64) return max_active_clusters_f32<64>(nsplit);
    if (D == 128) return max_active_clusters_f32<128>(nsplit);
    if (D == 256) return max_active_clusters_f32<256>(nsplit);
  } else if (dtype == 1) {
    if (D == 64) return max_active_clusters<64>(nsplit);
    if (D == 128) return max_active_clusters<128>(nsplit);
    if (D == 256) return max_active_clusters<256>(nsplit);
  }
  return -1;
}

// Rows [start, start+num_rows) of the R_total = B*Hk rows of decode
// attention, written in place into o and, unless lse is null, lse.  q, o:
// [B,Hq,D] (strides in elements, last stride 1); lse: [B,Hq] float32; k, v:
// [B,S,Hk,D]; lens: [B] int32.  dtype (q and the caches) and out_dtype (o):
// 0 = float32, 1 = bfloat16; a bfloat16 call may write a float32 o.  route:
// 0 = the f32 split kernel, 1 = the bf16 split kernel, each over clusters of
// nsplit CTAs (1, 2, 4 or 8: the wrapper passes kv_split's for the whole
// call and the kernel's cluster fit).  Returns the CUDA error code of the
// launch (0 = success), -1 for a shape, route or output type the kernel does
// not take, or -2 if a tensor map cannot be encoded.
extern "C" int decode_attention_atom(
    const void* q, const void* k, const void* v, const void* lens, void* o,
    void* lse, int start, int num_rows, int R_total, int Hk, int G, int S,
    int D, int dtype, int route, int nsplit, int out_dtype,
    long long q_b, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long o_b, long long o_h,
    long long lse_b, long long lse_h, void* stream) {
  if (num_rows <= 0) return 0;
  if (Hk <= 0 || R_total % Hk || start < 0 || start + num_rows > R_total ||
      (D != 64 && D != 128 && D != 256) || nsplit < 1 ||
      nsplit > MAX_SPLIT || (nsplit & (nsplit - 1)) || dtype != route ||
      (out_dtype != dtype && out_dtype != 0))
    return -1;
  const Strides st{q_b, q_h, k_b, k_s, k_h, v_b,   v_s,
                   v_h, o_b, o_h, lse_b, lse_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = R_total / Hk;
#define DECODE(FN, ...) \
  FN<__VA_ARGS__>(q, k, v, lens, o, lse, start, num_rows, B, Hk, G, S, \
                  nsplit, st, s)
  if (dtype == 0)
    return D == 64 ? DECODE(launch_f32, 64) : D == 128 ? DECODE(launch_f32, 128)
                                                       : DECODE(launch_f32, 256);
  if (dtype == 1 && out_dtype == 1)
    return D == 64 ? DECODE(launch_split, 64, __nv_bfloat16)
                   : D == 128 ? DECODE(launch_split, 128, __nv_bfloat16)
                              : DECODE(launch_split, 256, __nv_bfloat16);
  if (dtype == 1)
    return D == 64 ? DECODE(launch_split, 64, float)
                   : D == 128 ? DECODE(launch_split, 128, float)
                              : DECODE(launch_split, 256, float);
#undef DECODE
  return -1;
}
