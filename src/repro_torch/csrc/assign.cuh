// Nearest-centroid assignment shared by lloyd_update.cu, pq_quantize.cu and
// kmeans_assign.cu, so that all three pick the same code for the same row.
//
// Score form, as the TPU kernels and the plain versions compute it:
//   code = argmax_l (2·x·c_l − ‖c_l‖²)   over l with lmask[l] > 0,
// which is the argmin of ‖x − c_l‖² (‖x‖² does not depend on l). Masked
// centroids score kNeg and never win; ties go to the first index, as
// jnp.argmax and torch.argmax do. D and L are small (D = 8, L <= 16 on the
// FEMNIST path), below any tensor-core tile, so the dot products are plain
// FMAs over a row and a codebook that sit in shared memory.
#pragma once

#include <cmath>

namespace repro_torch {

constexpr float kNeg = -1e30f;

// Odd row stride (in floats) for a tile of rows in shared memory: one thread
// per row then reads its row without bank conflicts.
__host__ __device__ __forceinline__ int row_stride(int d) { return d | 1; }

// Loads the (l, d) codebook and the (l,) mask into shared memory and computes
// the squared norms. Call with the whole block; ends with a barrier.
__device__ __forceinline__ void load_codebook(const float* __restrict__ c,
                                              const float* __restrict__ lmask,
                                              float* cs, float* cn, float* ms,
                                              int l, int d) {
  for (int e = threadIdx.x; e < l * d; e += blockDim.x) cs[e] = c[e];
  for (int e = threadIdx.x; e < l; e += blockDim.x) ms[e] = lmask[e];
  __syncthreads();
  for (int li = threadIdx.x; li < l; li += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s = fmaf(cs[li * d + k], cs[li * d + k], s);
    cn[li] = s;
  }
  __syncthreads();
}

// Copies rows [0, rows) of a contiguous (rows, d) tile into shared memory
// with row stride row_stride(d); consecutive threads read consecutive floats.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          float* xs, int rows, int d) {
  const int stride = row_stride(d);
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x)
    xs[(e / d) * stride + e % d] = src[e];
}

// The row's code, and its best score in *best_score (kmeans_assign.cu turns
// it into the squared distance ‖x‖² − best).
__device__ __forceinline__ int assign_row_best(const float* xr,
                                               const float* cs,
                                               const float* cn,
                                               const float* ms, int l, int d,
                                               float* best_score) {
  float best = -INFINITY;
  int code = 0;
  for (int li = 0; li < l; ++li) {
    float dot = 0.f;
    for (int k = 0; k < d; ++k) dot = fmaf(xr[k], cs[li * d + k], dot);
    float s = 2.f * dot - cn[li];
    if (!(ms[li] > 0.f)) s = kNeg;
    if (s > best) {
      best = s;
      code = li;
    }
  }
  *best_score = best;
  return code;
}

__device__ __forceinline__ int assign_row(const float* xr, const float* cs,
                                          const float* cn, const float* ms,
                                          int l, int d) {
  float best;
  return assign_row_best(xr, cs, cn, ms, l, d, &best);
}

}  // namespace repro_torch
