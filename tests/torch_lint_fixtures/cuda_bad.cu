// Seeded violations of the port's CUDA kernel contracts (SEED markers give
// the expected rule and line). Never compiled: parsed by
// tests/test_torch_lint.py only.
#include <cuda_runtime.h>

__global__ void sum_rows(const float* x, float* sums, int n, int d) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  for (int k = 0; k < d; ++k)
    atomicAdd(&sums[k], x[row * d + k]);  // SEED: cuda-fp32-atomic,cuda-int-index
}

__global__ void staged(const float* x, float* y) {  // SEED: cuda-smem-budget
  __shared__ float tile[128 * 128];
  tile[threadIdx.x] = x[threadIdx.x];
  __syncthreads();
  y[threadIdx.x] = tile[threadIdx.x];
}

__global__ void copy4(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * i < n)
    reinterpret_cast<float4*>(y)[i] = reinterpret_cast<const float4*>(x)[i];
}

__global__ void reduce_ptx(float* out, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(out), "f"(v));  // SEED: cuda-fp32-atomic
}

extern "C" void sum_rows_launch(const void* x, void* sums, int n, int d) {  // SEED: cuda-launcher-contract
  float* scratch;
  cudaMalloc(&scratch, sizeof(float) * n);  // SEED: cuda-launcher-alloc-sync
  sum_rows<<<(n + 255) / 256, 256>>>(static_cast<const float*>(x), static_cast<float*>(sums), n, d);  // SEED: cuda-launcher-contract
  cudaDeviceSynchronize();  // SEED: cuda-launcher-alloc-sync
  cudaFree(scratch);  // SEED: cuda-launcher-alloc-sync
}

extern "C" int copy4_launch(const void* x, void* y, int n, void* stream) {  // SEED: cuda-vector-alignment
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  copy4<<<(n / 4 + 255) / 256, 256, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}

extern "C" int staged_launch(const void* x, void* y, void* stream) {
  staged<<<1, 128, 0, 0>>>(static_cast<const float*>(x), static_cast<float*>(y));  // SEED: cuda-launcher-contract
  return (int)cudaGetLastError();
}

extern "C" int reduce_launch(void* out, float v, void* stream) {
  reduce_ptx<<<1, 1, 300000, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out), v);  // SEED: cuda-smem-budget
  return (int)cudaGetLastError();
}
