// pq_quantize: the fused final PQ encode for P problems.
//
// Replaces the TPU kernel src/repro/kernels/pq_quantize.py:
// _fused_kernel / pq_quantize_kernel (pl.pallas_call at line 55).
//
// For every problem p and row i, from one read of x:
//   codes[i] = argmax_l (2·x_i·c_l − ‖c_l‖²) over valid centroids (int32)
//   zt[i]    = c[codes[i]]                                       (f32)
//   resid[i] = x_i − zt[i]                                       (f32)
// x (P, N, D) f32, c (P, L, D) f32, lmask (L,) f32.
//
// What bounds it on the H100: bytes. It reads x once and writes z̃ and the
// residual (two arrays the size of x) and the codes: 23 MB on the FEMNIST
// step, against L·D FMAs per row.
//
// What the design does about it and about the TPU original:
//  * One block per tile of kThreads rows of one problem; the tile is read
//    with coalesced loads into shared memory, and z̃ and the residual are
//    written back with coalesced stores, element by element.
//  * The TPU kernel gathers the centroid with a one-hot matmul, an MXU
//    idiom. Here the codebook sits in shared memory and the gather is an
//    indexed read of it; the assignment is FMAs (assign.cuh).
//  * z̃ is the centroid's value and the residual is the single f32
//    subtraction x − z̃, so both are bitwise those of the plain version
//    wherever the codes agree.
#include <cuda_runtime.h>

#include "assign.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;  // rows per block

__global__ void __launch_bounds__(kThreads)
pq_quantize_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ lmask, float* __restrict__ zt,
                   float* __restrict__ resid, int* __restrict__ codes, int n,
                   int l, int d) {
  extern __shared__ float smem[];
  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - t0);
  const int xstride = row_stride(d);
  float* cs = smem;                     // [l][d]
  float* cn = cs + l * d;               // [l]
  float* ms = cn + l;                   // [l]
  float* xs = ms + l;                   // [kThreads][xstride]
  int* cd = reinterpret_cast<int*>(xs + kThreads * xstride);  // [kThreads]

  const size_t base = ((size_t)p * n + t0) * d;
  load_tile(x + base, xs, rows, d);
  load_codebook(c + (size_t)p * l * d, lmask, cs, cn, ms, l, d);  // syncs
  if (tid < rows) {
    const int code = assign_row(xs + tid * xstride, cs, cn, ms, l, d);
    cd[tid] = code;
    codes[(size_t)p * n + t0 + tid] = code;
  }
  __syncthreads();
  for (int e = tid; e < rows * d; e += kThreads) {
    const int r = e / d, k = e % d;
    const float z = cs[cd[r] * d + k];
    zt[base + e] = z;
    resid[base + e] = xs[r * xstride + k] - z;
  }
}

}  // namespace

extern "C" int pq_quantize_launch(const void* x, const void* c,
                                  const void* lmask, void* zt, void* resid,
                                  void* codes, int p, int n, int l, int d,
                                  void* stream) {
  if (p == 0 || n == 0) return 0;
  const size_t smem =
      sizeof(float) * ((size_t)l * d + 2 * l +
                       (size_t)kThreads * row_stride(d)) +
      sizeof(int) * kThreads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pq_quantize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + kThreads - 1) / kThreads, p);
  pq_quantize_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(
                                                 stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<const float*>(lmask), static_cast<float*>(zt),
      static_cast<float*>(resid), static_cast<int*>(codes), n, l, d);
  return (int)cudaGetLastError();
}
