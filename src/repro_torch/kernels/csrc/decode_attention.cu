// Atomizable GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (`_decode_attn_kernel`, launched by `decode_attention_atom`): one new token
// per batch row against that row's KV stripe, masked to kpos < len[b].
//
// What bounds it on this card: bytes.  Every valid K and V element is read
// once and used for G multiply-adds, far below the ~295 operations a byte the
// H100 needs before its arithmetic is the limit.  The least time is
// (valid K/V bytes + q + o) / memory rate.
//
// What the design does about it:
//   * one thread block per schedulable row r = b*Hk + hk (the TPU kernel's
//     row), grid = (num_rows,) with the block index offset by `start`: an
//     atom runs rows [start, start+num_rows) and writes only their outputs,
//     in place, so atoms over disjoint ranges compose in any order;
//   * K/V are read in the cache's own [B,S,Hk,D] strides: no transposed or
//     padded copy of the cache is made;
//   * the loop over keys ends at len[b] (clamped to [0,S]); nothing beyond
//     the valid prefix is read, and a row with len 0 writes zeros;
//   * the block's warps split the keys of the row and each keeps its own f32
//     online-softmax state (base-2 domain, one exp2 a score) in registers;
//     the partial results are merged through shared memory at the end;
//   * all G query heads of the row share each K/V load (that is the point of
//     grouping);
//   * bfloat16 inputs: both products on the tensor cores (mma.sync), the G
//     heads padded to the 16 rows of a tile; each warp brings its blocks of
//     32 keys into its own stripe of shared memory with cp.async, so bytes in
//     flight cost no registers and the key loop has no block-wide barrier;
//   * float32 inputs: full f32 products on the CUDA cores; each warp streams
//     whole key rows with one vector load a lane, KEYS keys in flight, and
//     reduces each score over the warp with shuffles.  K/V elements are used
//     once, so this path takes them straight to registers.
// What holds it back: the grid has B*Hk blocks (32 for 4 slots of llama3-8b),
// a quarter of the card's 132 SMs.  Splitting the keys of a row over several
// blocks (split-KV with a merge pass) is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int KEYS = 4;   // keys in flight per warp and iteration

// N consecutive elements -> N floats, one vector load.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    static_assert(N == 2, "2 or 4 elements a lane");
    float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&out)[N]) {
  if constexpr (N == 4) {
    uint2 t = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&t.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    static_assert(N == 2, "2 or 4 elements a lane");
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  }
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
// bfloat16: scores and the weighted sum on the tensor cores (mma.sync
// m16n8k16, f32 accumulate).  The G query heads of the row are the M
// dimension of both products, padded with zero rows to 16 (16 heads a pass).
// The block's 8 warps split the keys: warp w takes the TBK-key blocks w,
// w+8, ...; it copies its block of K and V into its own stripe of shared
// memory with cp.async (no registers spent on bytes in flight, no block-wide
// barrier in the loop), runs S = Q K^T, the online softmax on the
// accumulator registers and O += P V, and keeps its own (m, l, O).  The
// warps' partial results are merged through shared memory at the end.
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TBK = 32;    // keys of a warp's block
constexpr int QROWS = 16;  // query heads a pass (the M of mma)

template <int D>
constexpr int tc_smem_bytes() {
  return (int)sizeof(__nv_bfloat16) * (QROWS + TC_WARPS * 2 * TBK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
decode_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lens,
                        __nv_bfloat16* __restrict__ o, int start, int Hk,
                        int G, int S, Strides st, float scale_log2e) {
  constexpr int LD = D + 8;      // padded row, in elements
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr int NT = TBK / 8;    // 8-key tiles of a block
  constexpr int DT = D / 8;      // 8-column tiles of the output
  constexpr int CH = D / 8;      // 16-byte chunks of a row
  static_assert(2 * TBK * LD * sizeof(__nv_bfloat16) >=
                    (QROWS * D + 2 * QROWS) * sizeof(float),
                "a warp's stripe must hold its partial result for the merge");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16][LD]

  const int r = start + blockIdx.x;
  const int b = r / Hk, hk = r % Hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;   // row within 8, column pair
  const int len = min(max(lens[b], 0), S);

  __nv_bfloat16* sK = sQ + QROWS * LD + warp * 2 * TBK * LD;   // [TBK][LD]
  __nv_bfloat16* sV = sK + TBK * LD;                           // [TBK][LD]
  float* part = reinterpret_cast<float*>(sQ + QROWS * LD);     // merge area
  constexpr int PART = TBK * LD;   // floats between two warps' stripes

  const __nv_bfloat16* kb = k + b * st.k_b + hk * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + hk * st.v_h;

  for (int g0 = 0; g0 < G; g0 += QROWS) {
    const int ng = min(QROWS, G - g0);
    __syncthreads();   // the previous pass's sQ and merge area are done with
    for (int idx = threadIdx.x; idx < QROWS * CH; idx += TC_THREADS) {
      const int row = idx / CH, c = (idx % CH) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < ng)
        x = *reinterpret_cast<const uint4*>(
            q + b * st.q_b + (hk * G + g0 + row) * st.q_h + c);
      *reinterpret_cast<uint4*>(sQ + row * LD + c) = x;
    }
    __syncthreads();

    unsigned qf[KS][4];
    {
      const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], sQ + row * LD + ks * 16 + col);
    }

    // heads g and g+8 of this pass
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
    }

    for (int k0 = warp * TBK; k0 < len; k0 += TC_WARPS * TBK) {
      // this warp's block of K and V -> its stripe of shared memory
      for (int idx = lane; idx < TBK * CH; idx += 32) {
        const int row = idx / CH, c = (idx % CH) * 8;
        const bool valid = k0 + row < len;
        const long long key = valid ? k0 + row : 0;
        cp_async_16(sK + row * LD + c, kb + key * st.k_s + c, valid);
        cp_async_16(sV + row * LD + c, vb + key * st.v_s + c, valid);
      }
      cp_async_wait_all();
      __syncwarp();

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

      const bool edge = k0 + TBK > len;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = s[nt][2 * rr + c] * scale_log2e;
            if (edge && k0 + nt * 8 + 2 * tq + c >= len) x = -INFINITY;
            s[nt][2 * rr + c] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rr], mx);   // finite: key k0 is valid
        const float corr = exp2f(m[rr] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(s[nt][2 * rr + c] - m_new);
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
      __syncwarp();   // the stripe is free for the next block
    }

    // this warp's partial (O, m, l) -> its own stripe, as f32
    float* pacc = part + warp * PART;      // [QROWS][D]
    float* pm = pacc + QROWS * D;          // [QROWS]
    float* pl = pm + QROWS;                // [QROWS]
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float sum = l[rr];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (tq == 0) { pm[g + 8 * rr] = m[rr]; pl[g + 8 * rr] = sum; }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(pacc + (g + 8 * rr) * D + dt * 8 + 2 * tq) =
            make_float2(acc[dt][2 * rr], acc[dt][2 * rr + 1]);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < ng * D; idx += TC_THREADS) {
      const int row = idx / D, d = idx % D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < TC_WARPS; ++w)
        mx = fmaxf(mx, part[w * PART + QROWS * D + row]);
      const float m_ref = (mx == -INFINITY) ? 0.f : mx;   // no key at all
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < TC_WARPS; ++w) {
        const float* pw = part + w * PART;
        const float f = exp2f(pw[QROWS * D + row] - m_ref);
        num += f * pw[row * D + d];
        den += f * pw[QROWS * D + QROWS + row];
      }
      if (den == 0.f) den = 1.f;   // no valid key: zeros, as the reference
      o[b * st.o_b + (hk * G + g0 + row) * st.o_h + d] =
          __float2bfloat16(num / den);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* lens,
                void* o, int start, int num_rows, int Hk, int G, int S,
                const Strides& st, cudaStream_t stream) {
  auto kernel = decode_attn_bf16_kernel<D>;
  constexpr int smem = tc_smem_bytes<D>();   // above 48 KB: dynamic, opted in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<num_rows, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(o), start, Hk, G, S, st, scale_log2e);
  return (int)cudaGetLastError();
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
  if (G == 1)
    decode_attn_kernel<T, D, 1><<<num_rows, NTHREADS, 0, stream>>>(
        qp, kp, vp, lp, op, start, Hk, G, S, st, scale_log2e);
  else if (G == 2)
    decode_attn_kernel<T, D, 2><<<num_rows, NTHREADS, 0, stream>>>(
        qp, kp, vp, lp, op, start, Hk, G, S, st, scale_log2e);
  else
    decode_attn_kernel<T, D, 4><<<num_rows, NTHREADS, 0, stream>>>(
        qp, kp, vp, lp, op, start, Hk, G, S, st, scale_log2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows [start, start+num_rows) of decode attention, written in place into o.
// q, o: [B,Hq,D] (strides in elements, last stride 1); k, v: [B,S,Hk,D];
// lens: [B] int32.  dtype: 0 = float32, 1 = bfloat16.  Returns the CUDA
// error code of the launch (0 = success), or -1 for a shape the kernel does
// not take.
extern "C" int decode_attention_atom(
    const void* q, const void* k, const void* v, const void* lens, void* o,
    int start, int num_rows, int Hk, int G, int S, int D, int dtype,
    long long q_b, long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long o_b, long long o_h,
    void* stream) {
  if (num_rows <= 0) return 0;
  const Strides st{q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_d<float, 64>(q, k, v, lens, o, start, num_rows, Hk, G, S, st, s);
  if (dtype == 0 && D == 128)
    return launch_d<float, 128>(q, k, v, lens, o, start, num_rows, Hk, G, S, st, s);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, lens, o, start, num_rows, Hk, G, S, st, s);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, lens, o, start, num_rows, Hk, G, S, st, s);
  return -1;
}
