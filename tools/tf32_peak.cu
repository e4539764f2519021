// The rate of mma.sync m16n8k8 TF32 on the card: each warp of a block of
// `threads` runs NC independent chains of `iters` products on registers.
// Built and run by tools/f32_ab.py --peak; the package does not use it.
#include <cuda_runtime.h>

#include "../src/repro_torch/kernels/csrc/tensor_core.cuh"

namespace {

template <int NC>
__global__ void peak_kernel(float* out, int iters) {
  float c[NC][4];
  unsigned a[4];
  for (int j = 0; j < 4; ++j) a[j] = tf32_rna(threadIdx.x * 0.001f + j);
  const unsigned b0 = tf32_rna(threadIdx.x * 0.002f);
  const unsigned b1 = tf32_rna(threadIdx.x * 0.003f);
  for (int i = 0; i < NC; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NC; ++i) mma_tf32(c[i], a, b0, b1);
  }
  float s = 0.f;
  for (int i = 0; i < NC; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// NC in {4, 8, 16}; returns the CUDA error of the launch
extern "C" int tf32_peak(int nc, int blocks, int threads, int iters,
                         float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc == 4)
    peak_kernel<4><<<blocks, threads, 0, s>>>(out, iters);
  else if (nc == 8)
    peak_kernel<8><<<blocks, threads, 0, s>>>(out, iters);
  else
    peak_kernel<16><<<blocks, threads, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
