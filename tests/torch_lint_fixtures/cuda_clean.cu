// Kernels and launchers that keep the port's CUDA contracts: stream-ordered
// launches with their errors returned, 64-bit offsets, integer atomics
// only, an alignment test before 16-byte accesses, and one reviewed
// suppression. Never compiled: parsed by tests/test_torch_lint.py only.
#include <cuda_runtime.h>

#include "cuda_clean.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sum_rows(const float* x, float* partials, int* count, int n,
                         int d) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  float s = 0.f;
  for (int k = 0; k < d; ++k) s += x[(size_t)row * d + k];
  partials[row] = s;
  atomicAdd(count, 1);
}

__global__ void copy4(const float* x, float* y, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (4 * i < n) store4(y + 4 * (size_t)i, load4(x + 4 * (size_t)i));
}

__global__ void histogram(const int* codes, float* hist, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // reviewed: the histogram is a display, never summed into a result
  if (i < n) atomicAdd(&hist[codes[i]], 1.f);  // fedlint: disable=cuda-fp32-atomic
}

__global__ void zero(float* y, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) y[i] = 0.f;
}

}  // namespace

extern "C" int sum_rows_launch(const void* x, void* partials, void* count,
                               int n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sum_rows<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(partials),
      static_cast<int*>(count), n, d);
  return (int)cudaGetLastError();
}

extern "C" int copy4_launch(const void* x, void* y, int n, void* stream) {
  if (misaligned16(x) || misaligned16(y) || n % 4)
    return (int)cudaErrorInvalidValue;
  copy4<<<(n / 4 + kThreads - 1) / kThreads, kThreads, 0,
          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}

extern "C" int histogram_launch(const void* codes, void* hist, int n,
                                int clear, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clear) {
    zero<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<float*>(hist), n);
  } else {
    histogram<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const int*>(codes), static_cast<float*>(hist), n);
  }
  return (int)cudaGetLastError();
}

extern "C" int copy4_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, copy4, kThreads, 0);
}
