// kmeans_assign: nearest-centroid codes and squared distances for P problems.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign.py:
// _assign_kernel / kmeans_assign_kernel (pl.pallas_call at line 58).
//
// For every problem p and row i, over valid centroids:
//   codes[i]  = argmax_l (2·x_i·c_l − ‖c_l‖²)                  (int32)
//   sqdist[i] = max(‖x_i‖² − max_l (2·x_i·c_l − ‖c_l‖²), 0)     (f32)
// x (P, N, D) f32 or bf16, read in its own dtype and upcast in registers
// (exactly), as the TPU kernel upcasts its block: no f32 copy of x is made.
// c (P, L, D) f32, lmask (L,) f32 or null (every centroid valid).
//
// What bounds it on the H100: bytes. It reads x once and writes a code and
// a distance per row (9.2 MB on the FEMNIST grouping, 10 x 23040 x 8 f32;
// 100.7 MB at the serve cut, 4 x 1048576 x 8 bf16, 167.8 MB in f32),
// against L·D FMAs per row. At L = 16 the 128 FFMAs of a row come close to
// its bytes: they are what the design keeps few.
//
// What the design does about it and about the TPU original:
//  * Route d8 (D = 8, L in {2, 4, 8, 16}, no mask, x 16-byte aligned): a
//    grid of persistent blocks (the card's resident blocks, shared among
//    the problems) streams the rows (stream.cuh: bulk asynchronous copies
//    into a ring in shared memory, kD8Rows rows per thread per tile, upcast
//    in registers). The codebook and its norms are read into shared memory
//    once per block and from there into registers: 144 of them at L = 16,
//    where __launch_bounds__ holds the instance to 168 registers a thread,
//    2 blocks and 8 consumer warps per SM. Each row's code and best score
//    come from assign_row_reg, ‖x‖² from one fmaf chain over k ascending.
//    Each code and distance is one 4-byte streaming store, coalesced: a
//    warp's store covers 128 contiguous bytes. (Staging a warp's outputs in
//    shared memory for 16-byte stores, and a codebook left in shared
//    memory, were both slower on an H100: PERF.md.)
//  * Route generic (any D <= 64, any L, a mask, any alignment): one block
//    per tile of kThreads rows of one problem, read with coalesced loads
//    into shared memory; the codebook streams through shared memory
//    kLTile centroids at a time (assign.cuh's assign_row_streamed), so
//    the block's shared memory does not grow with L.
//  * The TPU kernel takes the cross term as an MXU matmul. Here the scores
//    stay FMAs (no TF32 or bf16 mma, which would round the codebook): the
//    code comes from assign.cuh, the routine lloyd_update and pq_quantize
//    use, so all three agree on every row, and both routes give the same
//    codes and distances bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "assign.cuh"
#include "stream.cuh"

namespace {

using namespace repro_torch;

// ---------------------------------------------------------------------------
// route d8
// ---------------------------------------------------------------------------

constexpr int kD8Threads = 128;  // consumer threads
constexpr int kD8Rows = 4;       // rows per thread per tile
constexpr int kD8Stages = 2;     // tiles in the ring
constexpr int kD8BlocksPerSM = 2;

template <typename T, int L>
__global__ void __launch_bounds__(kD8Threads + 32, kD8BlocksPerSM)
assign_d8(const T* __restrict__ x, const float* __restrict__ c,
          int* __restrict__ codes, float* __restrict__ sqdist, int n) {
  constexpr int D = 8;
  __shared__ float cs[L * D], cn[L], ms[L];
  __shared__ RowRing<T, kD8Threads, kD8Rows, kD8Stages> ring;
  const int p = blockIdx.y;
  load_codebook(c + (size_t)p * L * D, nullptr, cs, cn, ms, L, D);  // syncs
  float cr[L * D], cnr[L];
#pragma unroll
  for (int e = 0; e < L * D; ++e) cr[e] = cs[e];
#pragma unroll
  for (int li = 0; li < L; ++li) cnr[li] = cn[li];
  const size_t base = (size_t)p * n;
  stream_rows(x + base * D, (size_t)n, blockIdx.x, gridDim.x, ring,
              [&](size_t row0, int nr, const float (&xr)[kD8Rows][D]) {
#pragma unroll
                for (int r = 0; r < kD8Rows; ++r) {
                  if (r >= nr) break;
                  float best;
                  const int code = assign_row_reg<L, D, false>(
                      xr[r], cr, cnr, nullptr, &best);
                  float xn = 0.f;
#pragma unroll
                  for (int k = 0; k < D; ++k)
                    xn = fmaf(xr[r][k], xr[r][k], xn);
                  const size_t i = base + row0 + (size_t)r * kD8Threads;
                  __stcs(codes + i, code);
                  __stcs(sqdist + i, fmaxf(xn - best, 0.f));
                }
              });
}

// ---------------------------------------------------------------------------
// route generic
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
assign_generic(const T* __restrict__ x, const float* __restrict__ c,
               const float* __restrict__ lmask, int* __restrict__ codes,
               float* __restrict__ sqdist, int n, int l, int d) {
  extern __shared__ float smem[];
  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - t0);
  const int xstride = row_stride(d);
  float* cs = smem;                     // [kLTile][d]
  float* cn = cs + kLTile * d;          // [kLTile]
  float* ms = cn + kLTile;              // [kLTile]
  float* xs = ms + kLTile;              // [kThreads][xstride]

  load_tile(x + ((size_t)p * n + t0) * d, xs, rows, d);
  const float* xr = tid < rows ? xs + tid * xstride : nullptr;
  float best;
  const int code = assign_row_streamed(xr, c + (size_t)p * l * d, lmask, cs,
                                       cn, ms, l, d, &best);
  if (xr) {
    float xn = 0.f;
    for (int k = 0; k < d; ++k) xn = fmaf(xr[k], xr[k], xn);
    const size_t i = (size_t)p * n + t0 + tid;
    codes[i] = code;
    sqdist[i] = fmaxf(xn - best, 0.f);
  }
}

template <typename T, int L>
cudaError_t launch_d8(const void* x, const void* c, void* codes, void* sqdist,
                      int p, int n, int nblocks, cudaStream_t s) {
  assign_d8<T, L><<<dim3(nblocks, p), kD8Threads + 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<int*>(codes), static_cast<float*>(sqdist), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d8_l(const void* x, const void* c, void* codes,
                        void* sqdist, int p, int n, int l, int nb,
                        cudaStream_t s) {
  switch (l) {
    case 2: return launch_d8<T, 2>(x, c, codes, sqdist, p, n, nb, s);
    case 4: return launch_d8<T, 4>(x, c, codes, sqdist, p, n, nb, s);
    case 8: return launch_d8<T, 8>(x, c, codes, sqdist, p, n, nb, s);
    case 16: return launch_d8<T, 16>(x, c, codes, sqdist, p, n, nb, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
const void* d8_kernel(int l) {
  switch (l) {
    case 2: return reinterpret_cast<const void*>(assign_d8<T, 2>);
    case 4: return reinterpret_cast<const void*>(assign_d8<T, 4>);
    case 8: return reinterpret_cast<const void*>(assign_d8<T, 8>);
    case 16: return reinterpret_cast<const void*>(assign_d8<T, 16>);
    default: return nullptr;
  }
}

template <typename T>
cudaError_t launch_generic(const void* x, const void* c, const void* lmask,
                           void* codes, void* sqdist, int p, int n, int l,
                           int d, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)kLTile * d + 2 * kLTile +
                                       (size_t)kThreads * row_stride(d));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        assign_generic<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + kThreads - 1) / kThreads, p);
  assign_generic<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const float*>(lmask), static_cast<int*>(codes),
      static_cast<float*>(sqdist), n, l, d);
  return cudaGetLastError();
}

}  // namespace

// Resident blocks per SM of the d8 instance for (l, bf16), for the caller's
// grid (0 where there is no such instance).
extern "C" int kmeans_assign_d8_occupancy(int l, int bf16) {
  const void* k = bf16 ? d8_kernel<__nv_bfloat16>(l) : d8_kernel<float>(l);
  int blocks = 0;
  if (k == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                    kD8Threads + 32, 0) !=
          cudaSuccess)
    return 0;
  return blocks;
}

// route 1 = d8 (no lmask; rows must be its kD8Threads·kD8Rows rows per
// tile, nblocks blocks per problem), 0 = generic (rows and nblocks unused;
// lmask may be null).
extern "C" int kmeans_assign_launch(const void* x, const void* c,
                                    const void* lmask, void* codes,
                                    void* sqdist, int p, int n, int l, int d,
                                    int route, int bf16, int rows,
                                    int nblocks, void* stream) {
  if (p == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (d != 8 || lmask != nullptr || rows != kD8Threads * kD8Rows ||
        nblocks < 1)
      return (int)cudaErrorInvalidValue;
    return (int)(bf16 ? launch_d8_l<__nv_bfloat16>(x, c, codes, sqdist, p,
                                                   n, l, nblocks, s)
                      : launch_d8_l<float>(x, c, codes, sqdist, p, n, l,
                                           nblocks, s));
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? launch_generic<__nv_bfloat16>(x, c, lmask, codes,
                                                    sqdist, p, n, l, d, s)
                    : launch_generic<float>(x, c, lmask, codes, sqdist, p, n,
                                            l, d, s));
}
