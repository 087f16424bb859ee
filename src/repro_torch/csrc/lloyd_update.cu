// lloyd_update: one Lloyd iteration's statistics for P k-means problems.
//
// Replaces the TPU kernel src/repro/kernels/lloyd_update.py:
// _update_kernel / lloyd_update_kernel (pl.pallas_call at line 87).
//
// For every problem p (one client's codebook group), over valid centroids:
//   codes[i]  = argmax_l (2·x_i·c_l − ‖c_l‖²)
//   dsums[l]  = Σ_i w_i·1[codes_i = l]·(x_i − c_l)      (f32)
//   counts[l] = Σ_i w_i·1[codes_i = l]
// x (P, N, D) f32, w (P, N) f32, c (P, L, D) f32, lmask (L,) f32;
// dsums (P, L, D) f32, counts (P, L) f32.
//
// What bounds it on the H100: bytes. A launch reads x and w once
// (P·N·(D+1)·4 bytes, 8.85 MB on the FEMNIST step) and does L·D FMAs per
// row, far below the ~20 flop/byte at which f32 FMAs would bound it.
//
// What the design does about it and about the TPU original:
//  * The Pallas kernel accumulates into one output block that every grid
//    step revisits, which is right only because TPU grid steps run in order.
//    CUDA blocks run in parallel, so each block writes its own partial sums
//    and a second, small kernel adds a problem's partials in block order.
//    There are no floating-point atomics, so a run is bitwise the same as
//    the run before it.
//  * Each block streams its rows through shared memory in tiles of
//    kThreads rows, read with coalesced loads (one read of x).
//  * D and L are below tensor-core sizes: the distances are FMAs against a
//    codebook in shared memory (assign.cuh), and the TPU kernel's one-hot
//    matmul becomes an indexed read of the chosen centroid.
//  * Inside a block every output element (l, k) has one owner thread that
//    adds the tile's rows in row order: a fixed order, no atomics.
//  * Deviations x − c_l are accumulated, not raw sums, so a cluster that
//    covers its points exactly gets an update of exactly 0; rows of weight
//    0 (padding) add exactly 0.
#include <cuda_runtime.h>

#include "assign.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;  // rows per tile = threads per block

__global__ void __launch_bounds__(kThreads)
lloyd_partials(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ c, const float* __restrict__ lmask,
               float* __restrict__ partials, int n, int l, int d,
               int rows_per_block) {
  extern __shared__ float smem[];
  const int p = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int tid = threadIdx.x;
  const int xstride = row_stride(d);
  const int nout = l * (d + 1);  // per centroid: d deviation sums + 1 count
  float* cs = smem;                      // [l][d]
  float* cn = cs + l * d;                // [l]
  float* ms = cn + l;                    // [l]
  float* acc = ms + l;                   // [nout]
  float* xs = acc + nout;                // [kThreads][xstride]
  float* ws = xs + kThreads * xstride;   // [kThreads]
  int* cd = reinterpret_cast<int*>(ws + kThreads);  // [kThreads]

  for (int o = tid; o < nout; o += kThreads) acc[o] = 0.f;
  load_codebook(c + (size_t)p * l * d, lmask, cs, cn, ms, l, d);

  const float* xp = x + (size_t)p * n * d;
  const float* wp = w + (size_t)p * n;
  const int row_end = min((b + 1) * rows_per_block, n);
  for (int t0 = b * rows_per_block; t0 < row_end; t0 += kThreads) {
    const int rows = min(kThreads, row_end - t0);
    load_tile(xp + (size_t)t0 * d, xs, rows, d);
    __syncthreads();
    if (tid < rows) {
      cd[tid] = assign_row(xs + tid * xstride, cs, cn, ms, l, d);
      ws[tid] = wp[t0 + tid];
    }
    __syncthreads();
    for (int o = tid; o < nout; o += kThreads) {
      const int li = o / (d + 1), k = o % (d + 1);
      float s = acc[o];
      if (k < d) {
        const float ck = cs[li * d + k];
        for (int r = 0; r < rows; ++r)
          if (cd[r] == li) s += ws[r] * (xs[r * xstride + k] - ck);
      } else {
        for (int r = 0; r < rows; ++r)
          if (cd[r] == li) s += ws[r];
      }
      acc[o] = s;
    }
    __syncthreads();  // the next tile overwrites xs, ws and cd
  }
  float* out = partials + ((size_t)p * nb + b) * nout;
  for (int o = tid; o < nout; o += kThreads) out[o] = acc[o];
}

// One block per problem: adds the nb partials of each output in block order.
__global__ void lloyd_reduce(const float* __restrict__ partials,
                             float* __restrict__ dsums,
                             float* __restrict__ counts, int l, int d,
                             int nb) {
  const int p = blockIdx.x;
  const int nout = l * (d + 1);
  for (int o = threadIdx.x; o < nout; o += blockDim.x) {
    const float* src = partials + (size_t)p * nb * nout + o;
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += src[(size_t)b * nout];
    const int li = o / (d + 1), k = o % (d + 1);
    if (k < d)
      dsums[((size_t)p * l + li) * d + k] = s;
    else
      counts[(size_t)p * l + li] = s;
  }
}

}  // namespace

// partials: scratch of nblocks·P·L·(D+1) floats, allocated by the caller;
// nblocks = ceil(n / rows_per_block), rows_per_block a multiple of kThreads.
extern "C" int lloyd_update_launch(const void* x, const void* w,
                                   const void* c, const void* lmask,
                                   void* partials, void* dsums, void* counts,
                                   int p, int n, int l, int d,
                                   int rows_per_block, int nblocks,
                                   void* stream) {
  if (p == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      sizeof(float) * ((size_t)l * d + 2 * l + (size_t)l * (d + 1) +
                       (size_t)kThreads * row_stride(d) + kThreads) +
      sizeof(int) * kThreads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lloyd_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (nblocks > 0) {
    lloyd_partials<<<dim3(nblocks, p), kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(c), static_cast<const float*>(lmask),
        static_cast<float*>(partials), n, l, d, rows_per_block);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  lloyd_reduce<<<p, 128, 0, s>>>(static_cast<const float*>(partials),
                                 static_cast<float*>(dsums),
                                 static_cast<float*>(counts), l, d, nblocks);
  return (int)cudaGetLastError();
}
