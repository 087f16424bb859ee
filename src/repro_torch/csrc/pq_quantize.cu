// pq_quantize: the fused final PQ encode for P problems.
//
// Replaces the TPU kernel src/repro/kernels/pq_quantize.py:
// _fused_kernel / pq_quantize_kernel (pl.pallas_call at line 55).
//
// For every problem p and row i, from one read of x:
//   codes[i] = argmax_l (2·x_i·c_l − ‖c_l‖²) over valid centroids (int32)
//   zt[i]    = c[codes[i]] stored in x's type (RNE for bf16)
//   resid[i] = x_i − c[codes[i]]                       (f32, the f32 centroid)
// x (P, N, D) f32 or bf16 (upcast in registers), c (P, L, D) f32, lmask (L,)
// f32 or null (every centroid valid).
//
// What bounds it on the H100: bytes. It reads x once and writes z̃, the f32
// residual and the codes (23 MB on the FEMNIST step in f32, 419 MB at the
// serve cut in f32 and 285 MB in bf16), against L·D FMAs per row.
//
// What the design does about it and about the TPU original:
//  * Route d8 (D = 8, L in {2, 4, 8, 16}, x 16-byte aligned): a grid of a
//    few persistent blocks per SM streams the rows (stream.cuh), the
//    codebook loaded into shared memory once per block; each thread writes
//    its rows' z̃ and residual from registers as 16-byte streaming stores
//    and each code as one int32, coalesced across the warp. Nothing goes
//    through shared memory on the way out, and there is no barrier per
//    tile.
//  * Route generic (any D, any L, any alignment): one block per tile of
//    kThreads rows of one problem; the codebook streams through shared
//    memory kLTile centroids at a time and the rows kDTile dims at a time
//    (assign.cuh's assign_tile, each row's dot products in registers), so
//    the block's shared memory grows with neither L nor D. z̃ and the
//    residual are written element by element, the chosen centroid read
//    from shared memory where the codebook is one tile of one chunk, else
//    from device memory (L2-resident: at L = 960, D = 32 a problem's
//    codebook is 123 KB), and x from shared memory where a row is one
//    chunk, else read again from device memory (where a block's 256 rows
//    of D = 9216 f32 values, 9.4 MB, were read a moment before).
//  * The TPU kernel gathers the centroid with a one-hot matmul, an MXU
//    idiom. Here the codebook sits in shared memory and the gather is an
//    indexed read of it; the assignment is FMAs (assign.cuh).
//  * z̃ is the centroid's value and the residual is the single f32
//    subtraction x − c, so both are bitwise those of the plain version
//    wherever the codes agree.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "assign.cuh"
#include "stream.cuh"

namespace {

using namespace repro_torch;

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// route d8
// ---------------------------------------------------------------------------

constexpr int kD8Threads = 128;  // consumer threads
constexpr int kD8Rows = 2;       // rows per thread per tile
constexpr int kD8Stages = 4;     // tiles in the ring

template <typename T, int L>
__global__ void __launch_bounds__(kD8Threads + 32)
pq_d8(const T* __restrict__ x, const float* __restrict__ c,
      const float* __restrict__ lmask, T* __restrict__ zt,
      float* __restrict__ resid, int* __restrict__ codes, int n) {
  constexpr int D = 8;
  __shared__ float cs[L * D], cn[L], ms[L];
  __shared__ RowRing<T, kD8Threads, kD8Rows, kD8Stages> ring;
  const int p = blockIdx.y;
  load_codebook(c + (size_t)p * L * D, lmask, cs, cn, ms, L, D);
  const bool masked = lmask != nullptr;
  const size_t base = (size_t)p * n;
  stream_rows(x + base * D, (size_t)n, blockIdx.x, gridDim.x, ring,
              [&](size_t row0, int nr, const float (&xr)[kD8Rows][D]) {
                int code[kD8Rows];
#pragma unroll
                for (int r = 0; r < kD8Rows; ++r)
                  code[r] = assign_row_reg<L, D>(xr[r], cs, cn, ms, masked);
#pragma unroll
                for (int r = 0; r < kD8Rows; ++r) {
                  if (r >= nr) break;
                  float z[D], e[D];
#pragma unroll
                  for (int k = 0; k < D; ++k) {
                    z[k] = cs[code[r] * D + k];
                    e[k] = xr[r][k] - z[k];
                  }
                  const size_t i = base + row0 + (size_t)r * kD8Threads;
                  row8_store(zt + i * D, z);
                  row8_store(resid + i * D, e);
                  __stcs(codes + i, code[r]);
                }
              });
}

// ---------------------------------------------------------------------------
// route generic
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
pq_generic(const T* __restrict__ x, const float* __restrict__ c,
           const float* __restrict__ lmask, T* __restrict__ zt,
           float* __restrict__ resid, int* __restrict__ codes, int n, int l,
           int d) {
  extern __shared__ float smem[];
  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - t0);
  const bool whole = d <= kDTile;
  const int dc = chunk_dims(d), xstride = row_stride(dc);
  float* cs = smem;                     // [kLTile][dc]
  float* cn = cs + kLTile * dc;         // [kLTile]
  float* ms = cn + kLTile;              // [kLTile]
  float* xs = ms + kLTile;              // [kThreads][xstride]
  int* cd = reinterpret_cast<int*>(xs + kThreads * xstride);  // [kThreads]

  const size_t base = ((size_t)p * n + t0) * d;
  const float* cp = c + (size_t)p * l * d;
  float best;
  const int code = assign_tile(x + base, rows, cp, lmask, l, d, xs, cs, cn,
                               ms, &best);
  if (tid < rows) {
    cd[tid] = code;
    codes[(size_t)p * n + t0 + tid] = code;
  }
  __syncthreads();
  // a codebook of one tile and one chunk is still in cs (c's values), and
  // rows of one chunk are still in xs
  const float* zc = whole && l <= kLTile ? cs : cp;
  for (int e = tid; e < rows * d; e += kThreads) {
    const int r = e / d, k = e % d;
    const float z = zc[(size_t)cd[r] * d + k];
    const float xv = whole ? xs[r * xstride + k] : to_f32(x[base + e]);
    store_one(zt + base + e, z);
    resid[base + e] = xv - z;
  }
}

template <typename T, int L>
cudaError_t launch_d8(const void* x, const void* c, const void* lmask,
                      void* zt, void* resid, void* codes, int p, int n,
                      int nblocks, cudaStream_t s) {
  pq_d8<T, L><<<dim3(nblocks, p), kD8Threads + 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const float*>(lmask), static_cast<T*>(zt),
      static_cast<float*>(resid), static_cast<int*>(codes), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d8_l(const void* x, const void* c, const void* lmask,
                        void* zt, void* resid, void* codes, int p, int n,
                        int l, int nb, cudaStream_t s) {
  switch (l) {
    case 2: return launch_d8<T, 2>(x, c, lmask, zt, resid, codes, p, n, nb, s);
    case 4: return launch_d8<T, 4>(x, c, lmask, zt, resid, codes, p, n, nb, s);
    case 8: return launch_d8<T, 8>(x, c, lmask, zt, resid, codes, p, n, nb, s);
    case 16:
      return launch_d8<T, 16>(x, c, lmask, zt, resid, codes, p, n, nb, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
const void* d8_kernel(int l) {
  switch (l) {
    case 2: return reinterpret_cast<const void*>(pq_d8<T, 2>);
    case 4: return reinterpret_cast<const void*>(pq_d8<T, 4>);
    case 8: return reinterpret_cast<const void*>(pq_d8<T, 8>);
    case 16: return reinterpret_cast<const void*>(pq_d8<T, 16>);
    default: return nullptr;
  }
}

template <typename T>
cudaError_t launch_generic(const void* x, const void* c, const void* lmask,
                           void* zt, void* resid, void* codes, int p, int n,
                           int l, int d, cudaStream_t s) {
  const int dc = chunk_dims(d);
  const size_t smem =
      sizeof(float) * ((size_t)kLTile * dc + 2 * kLTile +
                       (size_t)kThreads * row_stride(dc)) +
      sizeof(int) * kThreads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pq_generic<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + kThreads - 1) / kThreads, p);
  pq_generic<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const float*>(lmask), static_cast<T*>(zt),
      static_cast<float*>(resid), static_cast<int*>(codes), n, l, d);
  return cudaGetLastError();
}

}  // namespace

// Resident blocks per SM of the d8 instance for (l, bf16), for the caller's
// grid (0 where there is no such instance).
extern "C" int pq_quantize_d8_occupancy(int l, int bf16) {
  const void* k = bf16 ? d8_kernel<__nv_bfloat16>(l) : d8_kernel<float>(l);
  int blocks = 0;
  if (k == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                    kD8Threads + 32, 0) !=
          cudaSuccess)
    return 0;
  return blocks;
}

// route 1 = d8 (rows must be its kD8Threads·kD8Rows rows per tile, nblocks
// blocks per problem), 0 = generic (rows and nblocks unused); lmask may be
// null.
extern "C" int pq_quantize_launch(const void* x, const void* c,
                                  const void* lmask, void* zt, void* resid,
                                  void* codes, int p, int n, int l, int d,
                                  int route, int bf16, int rows, int nblocks,
                                  void* stream) {
  if (p == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (d != 8 || rows != kD8Threads * kD8Rows || nblocks < 1 ||
        misaligned16(x) || misaligned16(zt) || misaligned16(resid))
      return (int)cudaErrorInvalidValue;
    return (int)(bf16 ? launch_d8_l<__nv_bfloat16>(x, c, lmask, zt, resid,
                                                   codes, p, n, l, nblocks, s)
                      : launch_d8_l<float>(x, c, lmask, zt, resid, codes, p,
                                           n, l, nblocks, s));
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? launch_generic<__nv_bfloat16>(x, c, lmask, zt, resid,
                                                    codes, p, n, l, d, s)
                    : launch_generic<float>(x, c, lmask, zt, resid, codes, p,
                                            n, l, d, s));
}
