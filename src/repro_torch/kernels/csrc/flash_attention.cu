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
//   * bfloat16 inputs run both products on the tensor cores (mma.sync
//     m16n8k16, f32 accumulate): 4 warps a tile, each owning 16 query rows
//     whose Q fragments stay in registers; K and V blocks of 64 keys are
//     staged in shared memory as bf16 and read with ldmatrix; scores, the
//     online-softmax state and the output accumulator never leave registers
//     (the accumulator layout of Q K^T is the A-operand layout of P V).  52 KB
//     of shared memory a block at head_dim 128, so several blocks share an SM
//     and one block's loads overlap another's arithmetic;
//   * float32 inputs keep full f32 products on the CUDA cores: the Q tile
//     (pre-scaled) and each K and V block of 32 keys are staged in shared
//     memory, scores and the accumulator live in registers, P goes through
//     shared memory once for the second product; 75 KB a block, two blocks
//     an SM; shared rows are padded so the 16-byte reads of both products are
//     free of bank conflicts;
//   * a row with no unmasked key gives zeros (l == 0 -> 1), never NaN.
// What holds it back: the bf16 path uses warp-level mma.sync with synchronous
// global->shared copies; Hopper's full tensor-core rate needs warpgroup
// multiplies (wgmma) fed by TMA through a ring of tiles, which is the next
// step.  The f32 path is limited by its shared-memory reads, well below the
// 67 TFLOP/s f32 peak of an H100 SXM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NTHREADS = 256;
constexpr int BQ = 64;    // query rows of a tile
constexpr int BK = 32;    // keys of a KV block
constexpr int PP = BK + 4;  // padded row of the P tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 t = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 t;
  t.x = *reinterpret_cast<unsigned int*>(&a);
  t.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

struct Strides {
  long long q_b, q_s, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;
};

template <int D>
constexpr int smem_bytes() {
  return (int)sizeof(float) * ((BQ + 2 * BK) * (D + 4) + BQ * PP);
}

// rows [row0, row0+rows) of a [*, D] operand -> f32 tile in shared memory,
// zero beyond `limit`, scaled by `scale`
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           long long row_stride, int row0,
                                           int rows, int limit, float scale) {
  constexpr int DP = D + 4;
  for (int idx = threadIdx.x; idx < rows * (D / 4); idx += NTHREADS) {
    const int row = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < limit) {
      x = load4(src + (long long)(row0 + row) * row_stride + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + row * DP + c) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int start,
                  int n_qblocks, int Hq, int G, int Sq, int Sk, int causal,
                  Strides st, float sm_scale) {
  constexpr int DP = D + 4;
  constexpr int NG = D / 64;   // 64-wide column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;               // [BQ][DP]
  float* sK = sQ + BQ * DP;       // [BK][DP]
  float* sV = sK + BK * DP;       // [BK][DP]
  float* sP = sV + BK * DP;       // [BQ][PP]

  const int t = start + blockIdx.x;
  const int bh = t / n_qblocks, qi = t % n_qblocks;
  const int b = bh / Hq, h = bh % Hq, hk = h / G;
  const int q0 = qi * BQ;
  const int off = Sk - Sq;        // qpos = off + query row
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + hk * st.k_h;
  const T* vb = v + b * st.v_b + hk * st.v_h;

  stage_tile<T, D>(sQ, qb, st.q_s, q0, BQ, Sq, sm_scale);

  // thread (ty, tx) owns score rows ty+16i (i<4), score columns tx+16j (j<2)
  // and output columns g*64 + tx*4 .. +3 (g<NG)
  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
    }
  }

  // one past the last key any row of this tile may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, off + q_last + 1) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous block's sK, sV, sP are no longer read
    stage_tile<T, D>(sK, kb, st.k_s, k0, BK, Sk, 1.f);
    stage_tile<T, D>(sV, vb, st.v_s, k0, BK, Sk, 1.f);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) { s[i][0] = 0.f; s[i][1] = 0.f; }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * DP + d);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          s[i][j] += qv.x * kv[j].x + qv.y * kv[j].y + qv.z * kv[j].z +
                     qv.w * kv[j].w;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = off + q0 + ty + 16 * i;
      bool valid[2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < Sk && (!causal || kpos <= qpos);
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        sP[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, w);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= corr;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float p4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * PP + kk);
        p4[i][0] = pv.x; p4[i][1] = pv.y; p4[i][2] = pv.z; p4[i][3] = pv.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              sV + (kk + c) * DP + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g][0] += p4[i][c] * vv.x;
            acc[i][g][1] += p4[i][c] * vv.y;
            acc[i][g][2] += p4[i][c] * vv.z;
            acc[i][g][3] += p4[i][c] * vv.w;
          }
        }
      }
    }
  }

  T* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow < Sq) {
      const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
      for (int g = 0; g < NG; ++g)
        store4(ob + (long long)qrow * st.o_s + g * 64 + tx * 4,
               make_float4(acc[i][g][0] * inv, acc[i][g][1] * inv,
                           acc[i][g][2] * inv, acc[i][g][3] * inv));
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: both products on the tensor cores (mma.sync m16n8k16, f32
// accumulate).  128 threads: warp w owns query rows [16w, 16w+16) of the
// tile.  Q fragments stay in registers for the whole KV loop; K and V blocks
// of TBK keys are staged in shared memory as bf16 (rows padded by 16 bytes,
// which keeps ldmatrix free of bank conflicts); S and P never leave
// registers: the accumulator layout of S = Q K^T is the A-operand layout of
// P V, two 8-key tiles at a time.  Row sums are kept per thread and reduced
// over the four lanes of a row once, at the end.
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;
constexpr int TBK = 64;   // keys of a KV block on the tensor-core path

template <int D>
constexpr int tc_smem_bytes() {
  return (int)sizeof(__nv_bfloat16) * (BQ + 2 * TBK) * (D + 8);
}

// rows [row0, row0+rows) of a [*, D] bf16 operand -> shared memory, zero
// beyond `limit`; 16 bytes a thread
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int row0,
                                           int rows, int limit) {
  constexpr int LD = D + 8;
  for (int idx = threadIdx.x; idx < rows * (D / 8); idx += TC_THREADS) {
    const int row = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < limit)
      x = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + row) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + row * LD + c) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int start, int n_qblocks,
                       int Hq, int G, int Sq, int Sk, int causal, Strides st,
                       float scale_log2e) {
  constexpr int LD = D + 8;      // padded row, in elements
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr int NT = TBK / 8;    // 8-key tiles of a KV block
  constexpr int DT = D / 8;      // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* sK = sQ + BQ * LD;                                // [TBK][LD]
  __nv_bfloat16* sV = sK + TBK * LD;                               // [TBK][LD]

  const int t = start + blockIdx.x;
  const int bh = t / n_qblocks, qi = t % n_qblocks;
  const int b = bh / Hq, h = bh % Hq, hk = h / G;
  const int q0 = qi * BQ;
  const int off = Sk - Sq;        // qpos = off + query row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;   // row within 8, column pair

  const __nv_bfloat16* qb = q + b * st.q_b + h * st.q_h;
  const __nv_bfloat16* kb = k + b * st.k_b + hk * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + hk * st.v_h;

  stage_bf16<D>(sQ, qb, st.q_s, q0, BQ, Sq);
  __syncthreads();

  // this warp's 16 x D slice of Q as A fragments
  unsigned qf[KS][4];
  {
    const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(qf[ks], sQ + row * LD + ks * 16 + col);
  }

  // rows g and g+8 of the warp's slice
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, off + q_last + 1) : Sk;
  const int row_lo = off + q0 + warp * 16;   // qpos of the warp's first row

  for (int k0 = 0; k0 < k_end; k0 += TBK) {
    __syncthreads();   // the previous block's sK, sV are no longer read
    stage_bf16<D>(sK, kb, st.k_s, k0, TBK, Sk);
    stage_bf16<D>(sV, vb, st.v_s, k0, TBK, Sk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x TBK keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ks += 2) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        unsigned kf[4];   // (b0, b1) of k-step ks, then of ks+1
        ldmatrix_x4(kf, sK + (nt * 8 + (lane & 7)) * LD + ks * 16 +
                            (lane >> 3) * 8);
        mma_bf16(s[nt], qf[ks], kf[0], kf[1]);
        mma_bf16(s[nt], qf[ks + 1], kf[2], kf[3]);
      }
    }

    // scale, mask (only where the block touches an edge), online softmax
    const bool edge = (k0 + TBK > Sk) || (causal && k0 + TBK - 1 > row_lo);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row_lo + g + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[nt][2 * r + c] * scale_log2e;
          if (edge) {
            const int kpos = k0 + nt * 8 + 2 * tq + c;
            if (kpos >= Sk || (causal && kpos > qpos)) x = -INFINITY;
          }
          s[nt][2 * r + c] = x;
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
          const float p = exp2f(s[nt][2 * r + c] - m_ref);
          s[nt][2 * r + c] = p;
          psum += p;
        }
      }
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * r] *= corr;
        acc[dt][2 * r + 1] *= corr;
      }
    }

    // O += P V: P's accumulator layout is the A layout, two key tiles a step
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      unsigned pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        unsigned vf[4];   // (b0, b1) of column tile dt, then of dt+1
        ldmatrix_x4_trans(vf, sV + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  dt * 8 + (lane >> 4) * 8);
        mma_bf16(acc[dt], pf, vf[0], vf[1]);
        mma_bf16(acc[dt + 1], pf, vf[2], vf[3]);
      }
    }
  }

  // normalise, stage this warp's rows through its own slice of sQ (its Q
  // fragments are in registers), then 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = 1.f / (sum == 0.f ? 1.f : sum);
  }
  __syncwarp();
  __nv_bfloat16* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<unsigned*>(sO + (g + 8 * r) * LD + dt * 8 + 2 * tq) =
          pack_bf16(acc[dt][2 * r] * inv[r], acc[dt][2 * r + 1] * inv[r]);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + b * st.o_b + h * st.o_h;
  for (int idx = lane; idx < 16 * (D / 8); idx += 32) {
    const int row = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int qrow = q0 + warp * 16 + row;
    if (qrow < Sq)
      *reinterpret_cast<uint4*>(ob + (long long)qrow * st.o_s + c) =
          *reinterpret_cast<const uint4*>(sO + row * LD + c);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int start, int num_tiles, int n_qblocks, int Hq, int G, int Sq,
                int Sk, int causal, const Strides& st, cudaStream_t stream) {
  auto kernel = flash_attn_bf16_kernel<D>;
  constexpr int smem = tc_smem_bytes<D>();   // above 48 KB: dynamic, opted in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<num_tiles, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      start, n_qblocks, Hq, G, Sq, Sk, causal, st, scale_log2e);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int start,
           int num_tiles, int n_qblocks, int Hq, int G, int Sq, int Sk,
           int causal, const Strides& st, cudaStream_t stream) {
  auto kernel = flash_attn_kernel<T, D>;
  constexpr int smem = smem_bytes<D>();   // above 48 KB: dynamic, opted in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), start, n_qblocks, Hq, G,
      Sq, Sk, causal, st, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// The tile of q rows this kernel was compiled for; the wrapper sizes the
// tile space with it.
extern "C" int flash_attention_block_q() { return BQ; }

// Thread blocks (one a tile) of the kernel for (D, dtype) that one SM holds
// at once, or minus a CUDA error code (-1: a shape the kernel does not take).
extern "C" int flash_attention_ctas_per_sm(int D, int dtype) {
  const void* k = nullptr;
  int threads = 0, smem = 0;
  if (dtype == 1) {
    threads = TC_THREADS;
    if (D == 64) {
      k = (const void*)flash_attn_bf16_kernel<64>;
      smem = tc_smem_bytes<64>();
    } else if (D == 128) {
      k = (const void*)flash_attn_bf16_kernel<128>;
      smem = tc_smem_bytes<128>();
    }
  } else if (dtype == 0) {
    threads = NTHREADS;
    if (D == 64) {
      k = (const void*)flash_attn_kernel<float, 64>;
      smem = smem_bytes<64>();
    } else if (D == 128) {
      k = (const void*)flash_attn_kernel<float, 128>;
      smem = smem_bytes<128>();
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
// [B,Sk,Hk,D]; strides in elements, last stride 1.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the CUDA error code of the launch (0 = success), or
// -1 for a shape the kernel does not take.
extern "C" int flash_attention_atom(
    const void* q, const void* k, const void* v, void* o, int start,
    int num_tiles, int n_qblocks, int Hq, int G, int Sq, int Sk, int D,
    int causal, int dtype,
    long long q_b, long long q_s, long long q_h,
    long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h,
    long long o_b, long long o_s, long long o_h, void* stream) {
  if (num_tiles <= 0) return 0;
  const Strides st{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, start, num_tiles, n_qblocks, Hq, G, Sq, Sk, causal, st, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, start, num_tiles, n_qblocks, Hq, G, Sq, Sk, causal, st, s);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, o, start, num_tiles, n_qblocks, Hq, G, Sq, Sk, causal, st, s);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, o, start, num_tiles, n_qblocks, Hq, G, Sq, Sk, causal, st, s);
  return -1;
}
