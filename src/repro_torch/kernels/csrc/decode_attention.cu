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
// float32 (decode_attn_kernel): full f32 products on the CUDA cores, one
// block a row; each warp streams whole key rows with one vector load a lane,
// KEYS keys in flight, and reduces each score over the warp with shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int KEYS = 4;   // keys in flight per warp and iteration

// N consecutive elements -> N floats, one vector load.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N == 8) {
    float4 t = *reinterpret_cast<const float4*>(p);
    float4 u = *reinterpret_cast<const float4*>(p + 4);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
    out[4] = u.x; out[5] = u.y; out[6] = u.z; out[7] = u.w;
  } else if constexpr (N == 4) {
    float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    static_assert(N == 2, "2, 4 or 8 elements a lane");
    float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }

struct Strides {
  long long q_b, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_h;
};

template <typename T, int D, int GC>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lens,
                   T* __restrict__ o, int start, int Hk, int G, int S,
                   Strides st, float scale_log2e) {
  constexpr int EPL = D / 32;   // elements of a row held by one lane
  __shared__ float sm_m[NWARPS][GC];
  __shared__ float sm_l[NWARPS][GC];
  __shared__ float sm_acc[NWARPS][GC][D];

  const int r = start + blockIdx.x;
  const int b = r / Hk, hk = r % Hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(lens[b], 0), S);

  const T* kb = k + b * st.k_b + hk * st.k_h + lane * EPL;
  const T* vb = v + b * st.v_b + hk * st.v_h + lane * EPL;

  for (int g0 = 0; g0 < G; g0 += GC) {
    float qr[GC][EPL];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g0 + g < G) {
        load_vec<EPL>(q + b * st.q_b + (hk * G + g0 + g) * st.q_h + lane * EPL,
                      qr[g]);
#pragma unroll
        for (int e = 0; e < EPL; ++e) qr[g][e] *= scale_log2e;
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
      }
    }

    float m[GC], l[GC], acc[GC][EPL];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    }

    for (int s0 = warp * KEYS; s0 < len; s0 += NWARPS * KEYS) {
      float kr[KEYS][EPL], vr[KEYS][EPL];
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        if (s0 + j < len) {
          load_vec<EPL>(kb + (long long)(s0 + j) * st.k_s, kr[j]);
          load_vec<EPL>(vb + (long long)(s0 + j) * st.v_s, vr[j]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) { kr[j][e] = 0.f; vr[j][e] = 0.f; }
        }
      }
      float sc[KEYS][GC];
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) d += qr[g][e] * kr[j][e];
          sc[j][g] = d;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
#pragma unroll
          for (int g = 0; g < GC; ++g)
            sc[j][g] += __shfl_xor_sync(0xffffffffu, sc[j][g], off);
        }
      }

#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int j = 0; j < KEYS; ++j)
          if (s0 + j < len) m_new = fmaxf(m_new, sc[j][g]);
        const float corr = exp2f(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
          const float p = (s0 + j < len) ? exp2f(sc[j][g] - m_new) : 0.f;
          psum += p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += p * vr[j][e];
        }
        l[g] = l[g] * corr + psum;
        m[g] = m_new;
      }
    }

    // merge the warps' partial (m, l, acc)
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (lane == 0) { sm_m[warp][g] = m[g]; sm_l[warp][g] = l[g]; }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < GC * D; idx += NTHREADS) {
      const int g = idx / D, d = idx % D;
      if (g0 + g < G) {
        float mx = NEG_INF;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) {
          const float f = exp2f(sm_m[w][g] - mx);
          num += f * sm_acc[w][g][d];
          den += f * sm_l[w][g];
        }
        if (den == 0.f) den = 1.f;   // no valid key: zeros, as the reference
        store_one(o + b * st.o_b + (hk * G + g0 + g) * st.o_h + d, num / den);
      }
    }
    __syncthreads();
  }
}

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

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, split_ctas<D>())
decode_split_bf16_kernel(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __nv_bfloat16* __restrict__ q,
                         const int* __restrict__ lens,
                         __nv_bfloat16* __restrict__ o, int start, int Hk,
                         int G, int S, int chunk, long long q_b, long long q_h,
                         long long o_b, long long o_h, float scale_log2e) {
  using T = SplitTile<D>;
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr int DT = D / 8;      // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + T::STAGES * T::KV_BYTES;
  float* part = reinterpret_cast<float*>(sV + T::STAGES * T::KV_BYTES);
  float* part_m = part + QROWS * T::LDP;     // [QROWS]
  float* part_l = part_m + QROWS;            // [QROWS]
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
      const float* ring = reinterpret_cast<const float*>(sK);
      for (int idx = threadIdx.x; idx < ng * (D / 4);
           idx += SPLIT_CONSUMERS * 32) {
        const int row = idx / (D / 4), col = (idx % (D / 4)) * 4;
        float mw[SPLIT_CONSUMERS], lw[SPLIT_CONSUMERS];
        float4 aw[SPLIT_CONSUMERS];
#pragma unroll
        for (int w = 0; w < SPLIT_CONSUMERS; ++w) {
          const float* pw = ring + w * T::PART;
          mw[w] = pw[QROWS * T::LDP + row];
          lw[w] = pw[QROWS * T::LDP + QROWS + row];
          aw[w] = *reinterpret_cast<const float4*>(pw + row * T::LDP + col);
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
        *reinterpret_cast<float4*>(part + row * T::LDP + col) = a;
        if (col == 0) {
          part_m[row] = mx;
          part_l[row] = lsum;
        }
      }
      fence_proxy_async();   // TMA writes the ring again in the next pass
    }

    // every CTA's partial is complete; CTA `split` merges columns
    // [split*cw, (split+1)*cw) of the pass's heads over the splits, four
    // columns a thread: f_j = 2^(m_j - m), O = sum_j f_j O_j / sum_j f_j l_j
    // in split order
    cluster_sync();
    if (warp < SPLIT_CONSUMERS) {
      const int cw4 = D / nsplit / 4;   // 4-column groups this CTA merges
      for (int idx = threadIdx.x; idx < ng * cw4;
           idx += SPLIT_CONSUMERS * 32) {
        const int row = idx / cw4, col = split * cw4 * 4 + (idx % cw4) * 4;
        // the peers' maxima first; then each split's l and O, loaded and
        // summed in split order (holding every split's O at once spills)
        float mj[MAX_SPLIT];
#pragma unroll
        for (int j = 0; j < MAX_SPLIT; ++j)
          mj[j] = j < nsplit ? ld_cluster_f32(cluster_map(part_m + row, j))
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
            const float lv = ld_cluster_f32(cluster_map(part_l + row, j));
            const float4 av =
                ld_cluster_f32x4(cluster_map(part + row * T::LDP + col, j));
            const float f = exp2f(mj[j] - m_ref);   // 0 for an empty split
            den += f * lv;
            num.x += f * av.x;
            num.y += f * av.y;
            num.z += f * av.z;
            num.w += f * av.w;
          }
        }
        if (den == 0.f) den = 1.f;   // no valid key: zeros, as the reference
        *reinterpret_cast<uint2*>(o + b * o_b + (hk * G + g0 + row) * o_h +
                                  col) =
            make_uint2(pack_bf16(num.x / den, num.y / den),
                       pack_bf16(num.z / den, num.w / den));
      }
    }
    // no CTA overwrites its partial (next pass) or exits while a peer may
    // still read it
    cluster_sync();
  }
}

template <int D>
int launch_split(const void* q, const void* k, const void* v,
                 const void* lens, void* o, int start, int num_rows, int B,
                 int Hk, int G, int S, int nsplit, const Strides& st,
                 cudaStream_t stream) {
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

  auto kernel = decode_split_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int chunk = kv_split_chunk(S, nsplit);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, num_rows, 1);
  cfg.blockDim = dim3(SPLIT_THREADS, 1, 1);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)D);
  err = cudaLaunchKernelEx(&cfg, kernel, map_k, map_v,
                           static_cast<const __nv_bfloat16*>(q),
                           static_cast<const int*>(lens),
                           static_cast<__nv_bfloat16*>(o), start, Hk, G, S,
                           chunk, st.q_b, st.q_h, st.o_b, st.o_h, scale_log2e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// clusters of `nsplit` CTAs of the split kernel for head dim D that the
// current GPU runs at once, or minus a CUDA error code (-1: a D the kernel
// does not take)
template <int D>
int max_active_clusters(int nsplit) {
  using T = SplitTile<D>;
  auto kernel = decode_split_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, 1, 1);
  cfg.blockDim = dim3(SPLIT_THREADS, 1, 1);
  cfg.dynamicSmemBytes = T::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* lens,
             void* o, int start, int num_rows, int Hk, int G, int S,
             const Strides& st, cudaStream_t stream) {
  // scores are kept in the base-2 domain: exp(x) = exp2(x * log2(e))
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)D);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int* lp = static_cast<const int*>(lens);
  T* op = static_cast<T*>(o);
  // heads a pass: up to 4; 2 at head_dim 256, whose partials of 4 heads
  // would pass the 48 KB of static shared memory
  constexpr int GMAX = D == 256 ? 2 : 4;
  if (G == 1)
    decode_attn_kernel<T, D, 1><<<num_rows, NTHREADS, 0, stream>>>(
        qp, kp, vp, lp, op, start, Hk, G, S, st, scale_log2e);
  else if (G == 2)
    decode_attn_kernel<T, D, 2><<<num_rows, NTHREADS, 0, stream>>>(
        qp, kp, vp, lp, op, start, Hk, G, S, st, scale_log2e);
  else
    decode_attn_kernel<T, D, GMAX><<<num_rows, NTHREADS, 0, stream>>>(
        qp, kp, vp, lp, op, start, Hk, G, S, st, scale_log2e);
  return (int)cudaGetLastError();
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

// Clusters of `nsplit` CTAs of the split kernel for head dim D that the
// current GPU runs at once (cudaOccupancyMaxActiveClusters), or minus a CUDA
// error code (-1: a D or nsplit the kernel does not take).
extern "C" int decode_attention_max_active_clusters(int D, int nsplit) {
  if (nsplit < 1 || nsplit > MAX_SPLIT || (nsplit & (nsplit - 1))) return -1;
  if (D == 64) return max_active_clusters<64>(nsplit);
  if (D == 128) return max_active_clusters<128>(nsplit);
  if (D == 256) return max_active_clusters<256>(nsplit);
  return -1;
}

// Rows [start, start+num_rows) of the R_total = B*Hk rows of decode
// attention, written in place into o.  q, o: [B,Hq,D] (strides in elements,
// last stride 1); k, v: [B,S,Hk,D]; lens: [B] int32.  dtype: 0 = float32,
// 1 = bfloat16.  route: 0 = the f32 kernel, 1 = bf16 split-KV over clusters
// of nsplit CTAs (1, 2, 4 or 8: the wrapper passes kv_split's for the whole
// call).  Returns the CUDA error code of the launch (0 = success), -1 for a shape or route the kernel does not take, or -2 if
// a tensor map cannot be encoded.
extern "C" int decode_attention_atom(
    const void* q, const void* k, const void* v, const void* lens, void* o,
    int start, int num_rows, int R_total, int Hk, int G, int S, int D,
    int dtype, int route, int nsplit,
    long long q_b, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long o_b, long long o_h,
    void* stream) {
  if (num_rows <= 0) return 0;
  if (Hk <= 0 || R_total % Hk || start < 0 || start + num_rows > R_total ||
      (D != 64 && D != 128 && D != 256))
    return -1;
  const Strides st{q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && route == 0) {
#define DECODE_F32(DIM) \
  launch_d<float, DIM>(q, k, v, lens, o, start, num_rows, Hk, G, S, st, s)
    return D == 64 ? DECODE_F32(64) : D == 128 ? DECODE_F32(128)
                                               : DECODE_F32(256);
#undef DECODE_F32
  }
  if (dtype == 1 && route == 1) {
    if (nsplit < 1 || nsplit > MAX_SPLIT || (nsplit & (nsplit - 1))) return -1;
    const int B = R_total / Hk;
#define DECODE_SPLIT(DIM)                                                   \
  launch_split<DIM>(q, k, v, lens, o, start, num_rows, B, Hk, G, S, nsplit, \
                    st, s)
    return D == 64 ? DECODE_SPLIT(64) : D == 128 ? DECODE_SPLIT(128)
                                                 : DECODE_SPLIT(256);
#undef DECODE_SPLIT
  }
  return -1;
}
