// kmeans_assign: nearest-centroid codes and squared distances for P problems.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign.py:
// _assign_kernel / kmeans_assign_kernel (pl.pallas_call at line 58).
//
// For every problem p and row i, over valid centroids:
//   codes[i]  = argmax_l (2·x_i·c_l − ‖c_l‖²)                  (int32)
//   sqdist[i] = max(‖x_i‖² − max_l (2·x_i·c_l − ‖c_l‖²), 0)     (f32)
// x (P, N, D) f32, c (P, L, D) f32, lmask (L,) f32 or null (every centroid
// valid).
//
// What bounds it on the H100: bytes. It reads x once and writes a code and
// a distance per row (9.2 MB on the FEMNIST grouping, 10 x 23040 x 8),
// against L·D FMAs per row.
//
// What the design does about it and about the TPU original:
//  * One thread per row, one block per tile of kThreads rows of one
//    problem; the tile is read with coalesced loads into shared memory,
//    where the codebook and mask sit too.
//  * The TPU kernel takes the cross term as an MXU matmul; D and L are far
//    below tensor-core tiles here, so the scores are FMAs against the
//    codebook in shared memory. The code comes from assign.cuh, the routine
//    lloyd_update and pq_quantize use, so all three agree on every row.
#include <cuda_runtime.h>

#include "assign.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;  // rows per block

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ lmask, int* __restrict__ codes,
                     float* __restrict__ sqdist, int n, int l, int d) {
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

  load_tile(x + ((size_t)p * n + t0) * d, xs, rows, d);
  load_codebook(c + (size_t)p * l * d, lmask, cs, cn, ms, l, d);  // syncs
  if (tid < rows) {
    const float* xr = xs + tid * xstride;
    float best;
    const int code = assign_row_best(xr, cs, cn, ms, l, d, &best);
    float xn = 0.f;
    for (int k = 0; k < d; ++k) xn = fmaf(xr[k], xr[k], xn);
    const size_t i = (size_t)p * n + t0 + tid;
    codes[i] = code;
    sqdist[i] = fmaxf(xn - best, 0.f);
  }
}

}  // namespace

extern "C" int kmeans_assign_launch(const void* x, const void* c,
                                    const void* lmask, void* codes,
                                    void* sqdist, int p, int n, int l, int d,
                                    void* stream) {
  if (p == 0 || n == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)l * d + 2 * l +
                                       (size_t)kThreads * row_stride(d));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + kThreads - 1) / kThreads, p);
  kmeans_assign_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<const float*>(lmask), static_cast<int*>(codes),
      static_cast<float*>(sqdist), n, l, d);
  return (int)cudaGetLastError();
}
