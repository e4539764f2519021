// AdamW for the port's optimizer on Hopper (sm_90a): the gradients' global
// norm as one multi-tensor sum of squares, and one update pass a leaf.
//
// Replaces no TPU kernel.  The reference's update
// (src/repro/optim/optimizers.py, `adamw_update`) is jnp that XLA fuses; the
// port's plain route (src/repro_torch/optim/optimizers.py, `adamw_leaf` and
// `global_norm`) runs ~20 separate f32 elementwise passes a leaf, each
// reading and writing whole f32 temporaries.  These two kernels take the
// update to one read and one write of each operand.
//
// What bounds it on this card: bytes.  A parameter costs a read of p, g, mu
// and nu and a write of p, mu and nu, plus a read of g for the norm: 24 bytes
// with bf16 p and g and f32 moments, 28 with f32 g, a few flops each, far
// below the ~295 operations a byte the H100 needs before arithmetic is the
// limit.  The least time is those bytes at 3.35 TB/s.
//
// What the design does about it:
//   * grad-norm (`sumsq_kernel`, then `sumsq_final_kernel`): the leaves of
//     one launch (up to MAX_LEAVES; more take further launches into the same
//     buffer of partials) are cut into chunks of CHUNK_VEC 16-byte vectors,
//     numbered leaf after leaf.  A block of the persistent grid (SMs x blocks
//     an SM) takes chunks x, x + gridDim.x, ...; a thread squares the 4 (f32)
//     or 8 (bf16) values of each vector in f32, sums them in f32 and adds
//     that to its own f64 sum.  The elements before a leaf's first 16-byte
//     boundary and after its last whole vector are read one by one by the
//     block that takes the leaf's first chunk.  Each block writes one f64
//     partial; the final stage, one block, sums the partials in a fixed
//     order and writes sqrt as f32.  No atomics: the result is the same bits
//     at every call;
//   * update (`adamw_kernel<P, G, M>`): a grid-stride loop over packs of 8
//     elements, each operand read with 16-byte streaming loads (`__ldcs`:
//     nothing is read twice) and written with 16-byte streaming stores
//     (`__stcs`), 8 elements a thread in flight per operand; an operand whose
//     data is not 16-byte aligned (a view into a larger buffer) takes element
//     loads or stores for the same packs; the last numel % 8 elements are one
//     element a thread.  lr, clip and the bias corrections c1, c2 are read
//     from device memory, so the step needs no host sync;
//   * the arithmetic is the plain route's, operation for operation and in its
//     order, each product, sum, quotient and root rounded on its own
//     (`__fmul_rn` etc., which nvcc never contracts into an FMA), the
//     constants the f32 rounding of the plain route's Python expressions.
//     Given the same clip, the new parameters and moments equal the plain
//     route's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_LEAVES = 64;                // leaves one norm launch takes
constexpr int CHUNK_VEC = 4 * NTHREADS;       // 16-byte vectors a chunk
constexpr int FINAL_THREADS = 1024;

// dtype codes of the C interface (build.DTYPE_CODES)
constexpr int F32 = 0;
constexpr int BF16 = 1;

__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// ---------------------------------------------------------------------------
// global norm
// ---------------------------------------------------------------------------

struct NormLeaves {
  const void* ptr[MAX_LEAVES];
  long long n[MAX_LEAVES];             // elements
  long long head[MAX_LEAVES];          // elements before the first 16-byte
                                       // boundary (at most n)
  long long nvec[MAX_LEAVES];          // whole 16-byte vectors after them
  long long first[MAX_LEAVES + 1];     // first chunk of each leaf; [count]: all
  int bf16[MAX_LEAVES];
  int count;
};

__device__ __forceinline__ float vec_sumsq(uint4 u, bool bf16) {
  float s[8];
  if (bf16) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float lo = __uint_as_float(w[k] << 16);
      const float hi = __uint_as_float(w[k] & 0xffff0000u);
      s[2 * k] = lo * lo;
      s[2 * k + 1] = hi * hi;
    }
  } else {
    const float f[4] = {__uint_as_float(u.x), __uint_as_float(u.y),
                        __uint_as_float(u.z), __uint_as_float(u.w)};
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = f[k] * f[k];
#pragma unroll
    for (int k = 4; k < 8; ++k) s[k] = 0.f;
  }
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

__device__ __forceinline__ double elem_sq(const void* p, long long i,
                                          bool bf16) {
  const float x =
      bf16 ? bf16_bits_to_float(static_cast<const unsigned short*>(p)[i])
           : static_cast<const float*>(p)[i];
  return static_cast<double>(x * x);
}

// sum of a block's values, in a fixed order; the result in thread 0
template <int THREADS>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w];
  return s;
}

__global__ void __launch_bounds__(NTHREADS)
    sumsq_kernel(const __grid_constant__ NormLeaves L, double* partial) {
  double acc = 0.0;
  const long long total = L.first[L.count];
  int leaf = 0;
  for (long long c = blockIdx.x; c < total; c += gridDim.x) {
    while (c >= L.first[leaf + 1]) ++leaf;
    const bool bf16 = L.bf16[leaf];
    const int es = bf16 ? 2 : 4;
    const void* p = L.ptr[leaf];
    const long long n = L.n[leaf], head = L.head[leaf], nvec = L.nvec[leaf];
    const uint4* v = reinterpret_cast<const uint4*>(
        static_cast<const char*>(p) + head * es);
    const long long k = c - L.first[leaf];
    const long long end = (k + 1) * CHUNK_VEC < nvec ? (k + 1) * CHUNK_VEC
                                                     : nvec;
    for (long long i = k * CHUNK_VEC + threadIdx.x; i < end; i += NTHREADS)
      acc += static_cast<double>(vec_sumsq(v[i], bf16));
    if (k == 0) {                     // the leaf's head and tail elements
      const long long tail = head + nvec * (16 / es);
      if (threadIdx.x < head) acc += elem_sq(p, threadIdx.x, bf16);
      if (tail + threadIdx.x < n) acc += elem_sq(p, tail + threadIdx.x, bf16);
    }
  }
  const double s = block_sum<NTHREADS>(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(FINAL_THREADS)
    sumsq_final_kernel(const double* partial, int n, float* out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += FINAL_THREADS) acc += partial[i];
  const double s = block_sum<FINAL_THREADS>(acc);
  if (threadIdx.x == 0) out[0] = static_cast<float>(sqrt(s));
}

// SMs of the current device (cached a device)
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!sms[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return sms[dev];
}

template <typename K>
int blocks_per_sm(K kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NTHREADS, 0)
          != cudaSuccess || n < 1)
    return 1;
  return n;
}

int sumsq_grid() {
  static int per_sm = blocks_per_sm(sumsq_kernel);
  return sm_count() * per_sm;
}

// ---------------------------------------------------------------------------
// update
// ---------------------------------------------------------------------------

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

struct UpdateArgs {
  const void* p;
  const void* g;
  const void* mu;
  const void* nu;
  void* p_out;
  void* mu_out;
  void* nu_out;
  long long n;
  const float* lr;
  const float* clip;
  const float* c1;
  const float* c2;
  Consts k;
  int decay;
  int vec;          // bit i: operand i (p, g, mu, nu, p', mu', nu') is aligned
};

__device__ __forceinline__ void load8(const float* s, long long i, bool vec,
                                      float (&x)[8]) {
  if (vec) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(s) + 2 * i);
    const float4 b = __ldcs(reinterpret_cast<const float4*>(s) + 2 * i + 1);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __ldcs(s + 8 * i + j);
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* s, long long i,
                                      bool vec, float (&x)[8]) {
  if (vec) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(s) + i);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
    const unsigned short* b = reinterpret_cast<const unsigned short*>(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = bf16_bits_to_float(__ldcs(b + 8 * i + j));
  }
}

__device__ __forceinline__ void store8(float* d, long long i, bool vec,
                                       const float (&x)[8]) {
  if (vec) {
    __stcs(reinterpret_cast<float4*>(d) + 2 * i,
           make_float4(x[0], x[1], x[2], x[3]));
    __stcs(reinterpret_cast<float4*>(d) + 2 * i + 1,
           make_float4(x[4], x[5], x[6], x[7]));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) __stcs(d + 8 * i + j, x[j]);
  }
}

__device__ __forceinline__ unsigned short to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store8(__nv_bfloat16* d, long long i, bool vec,
                                       const float (&x)[8]) {
  if (vec) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = static_cast<unsigned>(to_bf16_bits(x[2 * k])) |
             (static_cast<unsigned>(to_bf16_bits(x[2 * k + 1])) << 16);
    __stcs(reinterpret_cast<uint4*>(d) + i, make_uint4(w[0], w[1], w[2], w[3]));
  } else {
    unsigned short* b = reinterpret_cast<unsigned short*>(d);
#pragma unroll
    for (int j = 0; j < 8; ++j) __stcs(b + 8 * i + j, to_bf16_bits(x[j]));
  }
}

__device__ __forceinline__ float load1(const float* s, long long i) {
  return __ldcs(s + i);
}
__device__ __forceinline__ float load1(const __nv_bfloat16* s, long long i) {
  return bf16_bits_to_float(
      __ldcs(reinterpret_cast<const unsigned short*>(s) + i));
}
__device__ __forceinline__ void store1(float* d, long long i, float x) {
  __stcs(d + i, x);
}
__device__ __forceinline__ void store1(__nv_bfloat16* d, long long i, float x) {
  __stcs(reinterpret_cast<unsigned short*>(d) + i, to_bf16_bits(x));
}

struct Scalars {
  float lr, clip, c1, c2;
};

// One element, as the plain route computes it (optim/optimizers.adamw_leaf):
//   g = g * clip
//   mu = b1 * mu + (1 - b1) * g
//   nu = b2 * nu + ((1 - b2) * g) * g
//   upd = (mu / c1) / (sqrt(nu / c2) + eps)  [+ wd * p]
//   p = p - lr * upd
__device__ __forceinline__ void adamw_elem(float& p, float g, float& mu,
                                           float& nu, const Consts& k,
                                           const Scalars& s, bool decay) {
  g = __fmul_rn(g, s.clip);
  mu = __fadd_rn(__fmul_rn(k.b1, mu), __fmul_rn(k.omb1, g));
  nu = __fadd_rn(__fmul_rn(k.b2, nu), __fmul_rn(__fmul_rn(k.omb2, g), g));
  float upd = __fdiv_rn(__fdiv_rn(mu, s.c1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, s.c2)), k.eps));
  if (decay) upd = __fadd_rn(upd, __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, upd));
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(NTHREADS) adamw_kernel(const UpdateArgs a) {
  const P* p_in = static_cast<const P*>(a.p);
  const G* g_in = static_cast<const G*>(a.g);
  const M* mu_in = static_cast<const M*>(a.mu);
  const M* nu_in = static_cast<const M*>(a.nu);
  P* p_out = static_cast<P*>(a.p_out);
  M* mu_out = static_cast<M*>(a.mu_out);
  M* nu_out = static_cast<M*>(a.nu_out);
  const Scalars s{*a.lr, *a.clip, *a.c1, *a.c2};
  const bool decay = a.decay;
  const long long npack = a.n / 8;
  const long long stride = static_cast<long long>(gridDim.x) * NTHREADS;
  const long long first = static_cast<long long>(blockIdx.x) * NTHREADS +
                          threadIdx.x;
  for (long long i = first; i < npack; i += stride) {
    float p[8], g[8], mu[8], nu[8];
    load8(p_in, i, a.vec & 1, p);
    load8(g_in, i, a.vec & 2, g);
    load8(mu_in, i, a.vec & 4, mu);
    load8(nu_in, i, a.vec & 8, nu);
#pragma unroll
    for (int j = 0; j < 8; ++j) adamw_elem(p[j], g[j], mu[j], nu[j], a.k, s,
                                           decay);
    store8(p_out, i, a.vec & 16, p);
    store8(mu_out, i, a.vec & 32, mu);
    store8(nu_out, i, a.vec & 64, nu);
  }
  const long long t = npack * 8 + first;   // the last n % 8 elements
  if (t < a.n) {
    float p = load1(p_in, t), mu = load1(mu_in, t), nu = load1(nu_in, t);
    adamw_elem(p, load1(g_in, t), mu, nu, a.k, s, decay);
    store1(p_out, t, p);
    store1(mu_out, t, mu);
    store1(nu_out, t, nu);
  }
}

template <typename P, typename G, typename M>
int launch_update(const UpdateArgs& a, cudaStream_t stream) {
  static int per_sm = blocks_per_sm(adamw_kernel<P, G, M>);
  const long long want = (a.n / 8 + NTHREADS) / NTHREADS;   // >= 1
  const long long cap = static_cast<long long>(sm_count()) * per_sm;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  adamw_kernel<P, G, M><<<grid, NTHREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename P, typename G>
int pick_m(const UpdateArgs& a, int m, cudaStream_t s) {
  if (m == F32) return launch_update<P, G, float>(a, s);
  if (m == BF16) return launch_update<P, G, __nv_bfloat16>(a, s);
  return -1;
}

template <typename P>
int pick_g(const UpdateArgs& a, int g, int m, cudaStream_t s) {
  if (g == F32) return pick_m<P, float>(a, m, s);
  if (g == BF16) return pick_m<P, __nv_bfloat16>(a, m, s);
  return -1;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// Blocks of one launch of the norm's first stage: the partials it writes.
extern "C" int adamw_sumsq_blocks() { return sumsq_grid(); }

// Leaves one launch of the norm's first stage takes.
extern "C" int adamw_max_leaves() { return MAX_LEAVES; }

// The global norm of `count` leaves (pointers `ptrs`, `numel` elements,
// dtype codes `dtypes`) into the f32 scalar `out`: ceil(count /
// adamw_max_leaves()) launches of the first stage, then the final one.
// `partial` holds that many times adamw_sumsq_blocks() doubles.  Returns the
// CUDA error code of the launches (0 = success), or -1 for a dtype the
// kernel does not take.

extern "C" int adamw_grad_norm(const void* const* ptrs,
                               const long long* numel, const int* dtypes,
                               int count, double* partial, float* out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = sumsq_grid();
  int blocks = 0;
  for (int base = 0; base < count; base += MAX_LEAVES) {
    NormLeaves L;
    L.count = count - base < MAX_LEAVES ? count - base : MAX_LEAVES;
    L.first[0] = 0;
    for (int j = 0; j < L.count; ++j) {
      const int d = dtypes[base + j];
      if (d != F32 && d != BF16) return -1;
      const int es = d == BF16 ? 2 : 4;
      L.ptr[j] = ptrs[base + j];
      L.n[j] = numel[base + j];
      L.bf16[j] = d == BF16;
      const long long mis = reinterpret_cast<unsigned long long>(L.ptr[j]) & 15;
      L.head[j] = mis ? (16 - mis) / es : 0;
      if (L.head[j] > L.n[j]) L.head[j] = L.n[j];
      L.nvec[j] = (L.n[j] - L.head[j]) / (16 / es);
      const long long chunks = (L.nvec[j] + CHUNK_VEC - 1) / CHUNK_VEC;
      L.first[j + 1] = L.first[j] + (chunks > 0 ? chunks : 1);
    }
    sumsq_kernel<<<grid, NTHREADS, 0, s>>>(L, partial + blocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    blocks += grid;
  }
  sumsq_final_kernel<<<1, FINAL_THREADS, 0, s>>>(partial, blocks, out);
  return (int)cudaGetLastError();
}

// One leaf's AdamW update: new p, mu, nu (n elements each) into p_out,
// mu_out, nu_out from p, g, mu, nu; dtype codes of p, g and of both moments;
// lr, clip, c1, c2 f32 scalars in device memory; the constants b1, 1 - b1,
// b2, 1 - b2, eps and the weight decay (applied where `decay`).  Returns the
// CUDA error code of the launch (0 = success), or -1 for a dtype the kernel
// does not take.
extern "C" int adamw_update_leaf(const void* p, const void* g, const void* mu,
                                 const void* nu, void* p_out, void* mu_out,
                                 void* nu_out, long long n, int p_dtype,
                                 int g_dtype, int m_dtype, const float* lr,
                                 const float* clip, const float* c1,
                                 const float* c2, float b1, float omb1,
                                 float b2, float omb2, float eps, float wd,
                                 int decay, void* stream) {
  if (n <= 0) return 0;
  UpdateArgs a{p, g, mu, nu, p_out, mu_out, nu_out, n, lr, clip, c1, c2,
               Consts{b1, omb1, b2, omb2, eps, wd}, decay, 0};
  const void* ops[7] = {p, g, mu, nu, p_out, mu_out, nu_out};
  for (int i = 0; i < 7; ++i) a.vec |= aligned16(ops[i]) << i;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == F32) return pick_g<float>(a, g_dtype, m_dtype, s);
  if (p_dtype == BF16) return pick_g<__nv_bfloat16>(a, g_dtype, m_dtype, s);
  return -1;
}
