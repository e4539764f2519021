// Atomizable flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// causal / non-causal / windowed GQA attention from the forward's output O
// and its per-row log-sum-exp.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of the
// jnp `blocked_attention` (src/repro/models/attention.py:141).  The port's
// forward is the hand-written kernel of csrc/flash_attention.cu, which
// autograd cannot see through, so its gradient is this kernel.
//
// What bounds it on this card: operations.  Each unmasked (query, key) pair
// costs five products of 2*D flops (S = Q K^T and dP = dO V^T recomputed,
// then dV += P^T dO, dK += dS^T Q, dQ += dS K): 10*D flops a pair against the
// forward's 4*D.  The least time is 10*D*(unmasked pairs) / tensor-core rate.
//
// What the design does about it, as a first, simple kernel:
//   * a `delta` pass: delta[b,h,s] = sum_d dO*O in f32, one warp a row;
//   * one atom kernel over a flat tile space of two parts: dQ tiles t in
//     [0, B*Hq*ceil(Sq/64)) as the forward's (bh = t / n_qblocks, 64 query
//     rows), then dK/dV tiles u = t - that in [0, B*Hk*ceil(Sk/64)) (bhk =
//     u / n_kblocks, 64 keys).  grid = (num_tiles,) with the block index
//     offset by `start`; every output tile is owned by one thread block, so
//     no atomics are needed, and atoms over disjoint ranges compose bit for
//     bit in any order;
//   * a dQ block loops over the K/V blocks its rows see (the forward's
//     causal frontier and window start); a dK/dV block loops over the G query
//     heads of its KV head, in order, and over their q blocks that see its
//     keys: the sum over heads is taken in a fixed order;
//   * both recompute P = exp(S*scale - lse) from the saved lse (natural
//     base; the exponent is taken as exp2 with log2(e) folded into the scale
//     and the lse) and take dS = P * (dP - delta).  A row with no unmasked
//     key has lse = +inf, so its P is 0, never NaN;
//   * products are mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//     fragments from ldmatrix (tensor_core.cuh).  Tiles are staged in shared
//     memory by cp.async, rows padded by 16 bytes so ldmatrix is free of bank
//     conflicts; rows past Sq / Sk are zero-filled and masked.  P and dS are
//     rounded to bf16 for the second products, as the forward rounds P;
//   * 4 warps a block, each owning 16 rows (dQ: query rows; dK/dV: keys); a
//     dK/dV block takes its q blocks 16 query columns at a time to keep its
//     dK and dV accumulators (2 x D/2 floats a thread) in registers.
// What holds it back: single-buffered loads (a block waits for each K/V or
// Q/dO block), mma.sync instead of wgmma, and the recomputation of S and dP
// in both kernels.  bfloat16 at head_dim 64 and 128 only; float32 and
// head_dim 256 return -1 (ROADMAP B4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 128;   // 4 warps
constexpr int BM = 64;          // rows of a tile: query rows or keys
constexpr float LOG2E = 1.4426950408889634f;
// query columns a dK/dV block takes at a time: its dK and dV accumulators
// (D/2 floats a thread each) leave room for S^T and dP^T of 16 columns only
// at head_dim 128 (32 spill)
constexpr int QC = 16;

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;     // [B, Hq, Sq], contiguous
  bf16 *dq, *dk, *dv;
  int start, n_dq_tiles, n_qblocks, n_kblocks, Hq, G, Sq, Sk, causal, window;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h;
  long long dq_b, dq_s, dq_h, dk_b, dk_s, dk_h, dv_b, dv_s, dv_h;
  float scale, scale_log2e;
};

// a padded row of a shared tile, in elements
template <int D>
__host__ __device__ constexpr int pitch() { return D + 8; }

template <int D>
constexpr int smem_bytes() {
  return 4 * BM * pitch<D>() * (int)sizeof(bf16) + 2 * BM * (int)sizeof(float);
}

// rows [row0, row0+BM) of a [*, D] operand -> shared tile, zeros at or past
// `limit`; the caller commits and waits
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int limit) {
  constexpr int CH = D / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < BM * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < limit;
    const bf16* s = ok ? src + (long long)(row0 + r) * row_stride + c : src;
    cp_async_16(dst + r * pitch<D>() + c, s, ok);
  }
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int Sk, int causal,
                                        int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// A fragment (16 x 16, row-major) at (r0, c0) of a padded tile
template <int D>
__device__ __forceinline__ void load_a(unsigned (&r)[4], const bf16* t, int r0,
                                       int c0, int lane) {
  ldmatrix_x4(r, t + (r0 + (lane & 15)) * pitch<D>() + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-wide n-tiles (n0, n0+8) x 16 k from a tile stored
// [n][k] (the rows of K, V, Q or dO as the second operand of X Y^T)
template <int D>
__device__ __forceinline__ void load_b_nk(unsigned (&r)[4], const bf16* t,
                                          int n0, int k0, int lane) {
  ldmatrix_x4(r, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch<D>() +
                     k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-wide n-tiles (n0, n0+8) x 16 k from a tile stored
// [k][n] (K, Q or dO as the second operand of X Y)
template <int D>
__device__ __forceinline__ void load_b_kn(unsigned (&r)[4], const bf16* t,
                                          int k0, int n0, int lane) {
  ldmatrix_x4_trans(r, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               pitch<D>() + n0 + (lane >> 4) * 8);
}

// two neighbouring 16x8 f32 accumulator tiles as one bf16 A fragment
__device__ __forceinline__ void c_to_a(unsigned (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc[16 x D] += a[16 x 16] * tile rows [k0, k0+16) (stored [k][n])
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const unsigned (&a)[4], const bf16* t,
                                         int k0, int lane) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    unsigned b[4];
    load_b_kn<D>(b, t, k0, n * 16, lane);
    mma_bf16(acc[2 * n], a, b[0], b[1]);
    mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
  }
}

// store a warp's 16 rows of a [16 x D] accumulator, times `mul`, as bf16
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride,
                                           int row0, int limit,
                                           const float (&acc)[D / 8][4],
                                           float mul, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < limit) {
      bf16* p = base + (long long)row * row_stride + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<unsigned*>(p + dt * 8) =
            pack_bf16(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
    }
  }
}

// dQ of 64 query rows of one head
template <int D>
__device__ void dq_tile(const BwdArgs& a, int t, bf16* smem) {
  constexpr int P = pitch<D>();
  bf16* sQ = smem;
  bf16* sO = sQ + BM * P;   // dO
  bf16* sK = sO + BM * P;
  bf16* sV = sK + BM * P;
  const int bh = t / a.n_qblocks, qi = t % a.n_qblocks;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  const int q0 = qi * BM, off = a.Sk - a.Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* kb = a.k + b * a.k_b + hk * a.k_h;
  const bf16* vb = a.v + b * a.v_b + hk * a.v_h;

  load_tile<D>(sQ, a.q + b * a.q_b + h * a.q_h, a.q_s, q0, a.Sq);
  load_tile<D>(sO, a.dout + b * a.do_b + h * a.do_h, a.do_s, q0, a.Sq);
  cp_async_commit();

  float lse2[2], dlt[2];   // rows g and g+8 of the warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const bool in = row < a.Sq;
    lse2[r] = in ? a.lse[(long long)bh * a.Sq + row] * LOG2E : INFINITY;
    dlt[r] = in ? a.delta[(long long)bh * a.Sq + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int q_last = min(q0 + BM, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, off + q_last + 1) : a.Sk;
  const int k_lo = a.window > 0 ? max(0, off + q0 - a.window + 1) : 0;
  for (int k0 = k_lo / BM * BM; k0 < k_end; k0 += BM) {
    __syncthreads();   // the previous block's sK, sV are no longer read
    load_tile<D>(sK, kb, a.k_s, k0, a.Sk);
    load_tile<D>(sV, vb, a.v_s, k0, a.Sk);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      unsigned qa[4], oa[4];
      load_a<D>(qa, sQ, warp * 16, ks * 16, lane);
      load_a<D>(oa, sO, warp * 16, ks * 16, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        unsigned kf[4], vf[4];
        load_b_nk<D>(kf, sK, n * 16, ks * 16, lane);
        load_b_nk<D>(vf, sV, n * 16, ks * 16, lane);
        mma_bf16(s[2 * n], qa, kf[0], kf[1]);
        mma_bf16(s[2 * n + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * n], oa, vf[0], vf[1]);
        mma_bf16(dp[2 * n + 1], oa, vf[2], vf[3]);
      }
    }
    // P from the saved lse, then dS = P (dP - delta), kept in s
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + nt * 8 + 2 * tq + (e & 1);
        const int qrow = q0 + warp * 16 + g + 8 * r;
        const bool ok = qrow < a.Sq &&
                        visible(kpos, off + qrow, a.Sk, a.causal, a.window);
        const float p = ok ? exp2f(s[nt][e] * a.scale_log2e - lse2[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dlt[r]);
      }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned af[4];
      c_to_a(af, s[2 * kk], s[2 * kk + 1]);
      mma_rows<D>(acc, af, sK, kk * 16, lane);
    }
  }
  cp_async_wait<0>();   // a tile with no visible key never waited
  store_rows<D>(a.dq + b * a.dq_b + h * a.dq_h, a.dq_s, q0 + warp * 16, a.Sq,
                acc, a.scale, lane);
}

// dK and dV of 64 keys of one KV head
template <int D>
__device__ void dkv_tile(const BwdArgs& a, int u, bf16* smem) {
  constexpr int P = pitch<D>();
  bf16* sK = smem;
  bf16* sV = sK + BM * P;
  bf16* sQ = sV + BM * P;
  bf16* sO = sQ + BM * P;   // dO
  float* sL = reinterpret_cast<float*>(sO + BM * P);   // lse * log2(e)
  float* sD = sL + BM;                                 // delta
  const int Hk = a.Hq / a.G;
  const int bhk = u / a.n_kblocks, kj = u % a.n_kblocks;
  const int b = bhk / Hk, hk = bhk % Hk;
  const int kv0 = kj * BM, off = a.Sk - a.Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  load_tile<D>(sK, a.k + b * a.k_b + hk * a.k_h, a.k_s, kv0, a.Sk);
  load_tile<D>(sV, a.v + b * a.v_b + hk * a.v_h, a.v_s, kv0, a.Sk);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  // the query rows that see any key of this tile
  const int kv_last = min(kv0 + BM, a.Sk) - 1;
  const int q_lo = a.causal ? max(0, kv0 - off) : 0;
  const int q_hi = a.window > 0 ? min(a.Sq, kv_last + a.window - off) : a.Sq;
  for (int hh = 0; hh < a.G; ++hh) {
    const int h = hk * a.G + hh;
    const long long bh = (long long)b * a.Hq + h;
    for (int q0 = q_lo / BM * BM; q0 < q_hi; q0 += BM) {
      __syncthreads();   // the previous block's sQ, sO, sL, sD are read
      load_tile<D>(sQ, a.q + b * a.q_b + h * a.q_h, a.q_s, q0, a.Sq);
      load_tile<D>(sO, a.dout + b * a.do_b + h * a.do_h, a.do_s, q0, a.Sq);
      cp_async_commit();
      if (threadIdx.x < BM) {
        const int row = q0 + threadIdx.x;
        const bool in = row < a.Sq;
        sL[threadIdx.x] = in ? a.lse[bh * a.Sq + row] * LOG2E : INFINITY;
        sD[threadIdx.x] = in ? a.delta[bh * a.Sq + row] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

#pragma unroll
      for (int c0 = 0; c0 < BM; c0 += QC) {   // QC query columns at a time
        float st[QC / 8][4], dpt[QC / 8][4];   // S^T, dP^T: 16 keys x QC
#pragma unroll
        for (int i = 0; i < QC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          unsigned ka[4], va[4];
          load_a<D>(ka, sK, warp * 16, ks * 16, lane);
          load_a<D>(va, sV, warp * 16, ks * 16, lane);
#pragma unroll
          for (int n = 0; n < QC / 16; ++n) {
            unsigned qf[4], of[4];
            load_b_nk<D>(qf, sQ, c0 + n * 16, ks * 16, lane);
            load_b_nk<D>(of, sO, c0 + n * 16, ks * 16, lane);
            mma_bf16(st[2 * n], ka, qf[0], qf[1]);
            mma_bf16(st[2 * n + 1], ka, qf[2], qf[3]);
            mma_bf16(dpt[2 * n], va, of[0], of[1]);
            mma_bf16(dpt[2 * n + 1], va, of[2], of[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < QC / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kv0 + warp * 16 + g + 8 * (e >> 1);
            const int col = c0 + nt * 8 + 2 * tq + (e & 1);
            const int qrow = q0 + col;
            const bool ok = qrow < a.Sq &&
                            visible(key, off + qrow, a.Sk, a.causal, a.window);
            const float p =
                ok ? exp2f(st[nt][e] * a.scale_log2e - sL[col]) : 0.f;
            st[nt][e] = p;
            dpt[nt][e] = p * (dpt[nt][e] - sD[col]);
          }
        // dV += P^T dO, dK += dS^T Q over these QC query rows
#pragma unroll
        for (int kk = 0; kk < QC / 16; ++kk) {
          unsigned pa[4], sa[4];
          c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
          c_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
          mma_rows<D>(dv, pa, sO, c0 + kk * 16, lane);
          mma_rows<D>(dk, sa, sQ, c0 + kk * 16, lane);
        }
      }
    }
  }
  cp_async_wait<0>();   // a tile no query row sees never waited
  store_rows<D>(a.dk + b * a.dk_b + hk * a.dk_h, a.dk_s, kv0 + warp * 16,
                a.Sk, dk, a.scale, lane);
  store_rows<D>(a.dv + b * a.dv_b + hk * a.dv_h, a.dv_s, kv0 + warp * 16,
                a.Sk, dv, 1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_attn_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int t = a.start + (int)blockIdx.x;
  if (t < a.n_dq_tiles)
    dq_tile<D>(a, t, smem);
  else
    dkv_tile<D>(a, t - a.n_dq_tiles, smem);
}

// delta[row] = sum_d dO[row, d] * O[row, d] (f32), row = (b*Hq + h)*Sq + s;
// one warp a row
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             float* __restrict__ delta, int rows, int Hq, int Sq, int D,
             long long o_b, long long o_s, long long o_h, long long do_b,
             long long do_s, long long do_h) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int s = row % Sq, bh = row / Sq, b = bh / Hq, h = bh % Hq;
  const bf16* op = o + b * o_b + s * o_s + h * o_h;
  const bf16* dp = dout + b * do_b + s * do_s + h * do_h;
  float acc = 0.f;
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(op + d));
    const float2 y = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dp + d));
    acc += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

template <int D>
int launch(const BwdArgs& a, int num_tiles, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();   // above 48 KB: dynamic, opted in
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  flash_attn_bwd_kernel<D><<<num_tiles, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of a tile (query rows of a dQ tile, keys of a dK/dV tile); the
// wrapper sizes the tile space with it.
extern "C" int flash_attention_bwd_block() { return BM; }

// delta [B, Hq, Sq] f32 (contiguous) = rowsum(dO * O); o, dout [B,Sq,Hq,D]
// bf16, strides in elements.  Returns the CUDA error of the launch, or -1
// for a shape or type the kernel does not take.
extern "C" int flash_attention_bwd_delta(
    const void* o, const void* dout, void* delta, int B, int Hq, int Sq,
    int D, int dtype, long long o_b, long long o_s, long long o_h,
    long long do_b, long long do_s, long long do_h, void* stream) {
  if (dtype != 1 || D % 64 != 0) return -1;
  const int rows = B * Hq * Sq;
  if (rows <= 0) return 0;
  delta_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), rows, Hq, Sq, D, o_b, o_s, o_h, do_b, do_s,
      do_h);
  return (int)cudaGetLastError();
}

// Tiles [start, start+num_tiles) of the backward's flat tile space: dQ tiles
// (B*Hq) x n_qblocks first, then dK/dV tiles (B*Hq/G) x n_kblocks, written
// in place into dq [B,Sq,Hq,D] and dk, dv [B,Sk,Hk,D].  q, dout
// [B,Sq,Hq,D]; k, v [B,Sk,Hk,D]; lse, delta [B,Hq,Sq] f32 contiguous (lse
// in natural base, +inf for a row that sees no key).  Masks as the
// forward's: qpos = Sk - Sq + row sees kpos if kpos < Sk, kpos <= qpos
// (causal) and kpos > qpos - window (window > 0).  Strides in elements,
// last stride 1.  Returns the CUDA error of the launch (0 = success), or -1
// for a shape or type the kernel does not take (bfloat16 at head_dim 64 or
// 128 only).
extern "C" int flash_attention_bwd_atom(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int start, int num_tiles, int n_qblocks, int n_kblocks, int B, int Hq,
    int G, int Sq, int Sk, int D, int causal, int window, int dtype,
    long long q_b, long long q_s, long long q_h,
    long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h,
    long long do_b, long long do_s, long long do_h,
    long long dq_b, long long dq_s, long long dq_h,
    long long dk_b, long long dk_s, long long dk_h,
    long long dv_b, long long dv_s, long long dv_h, void* stream) {
  if (dtype != 1 || (D != 64 && D != 128)) return -1;
  if (num_tiles <= 0) return 0;
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.start = start;
  a.n_dq_tiles = B * Hq * n_qblocks;
  a.n_qblocks = n_qblocks;
  a.n_kblocks = n_kblocks;
  a.Hq = Hq;
  a.G = G;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.q_b = q_b; a.q_s = q_s; a.q_h = q_h;
  a.k_b = k_b; a.k_s = k_s; a.k_h = k_h;
  a.v_b = v_b; a.v_s = v_s; a.v_h = v_h;
  a.do_b = do_b; a.do_s = do_s; a.do_h = do_h;
  a.dq_b = dq_b; a.dq_s = dq_s; a.dq_h = dq_h;
  a.dk_b = dk_b; a.dk_s = dk_s; a.dk_h = dk_h;
  a.dv_b = dv_b; a.dv_s = dv_s; a.dv_h = dv_h;
  a.scale = 1.f / sqrtf((float)D);
  a.scale_log2e = LOG2E * a.scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(a, num_tiles, s) : launch<128>(a, num_tiles, s);
}
