// lloyd_update: one Lloyd iteration's statistics for P k-means problems.
//
// Replaces the TPU kernel src/repro/kernels/lloyd_update.py:
// _update_kernel / lloyd_update_kernel (pl.pallas_call at line 87).
//
// For every problem p (one client's codebook group), over valid centroids:
//   codes[i]  = argmax_l (2·x_i·c_l − ‖c_l‖²)
//   dsums[l]  = Σ_i w_i·1[codes_i = l]·(x_i − c_l)      (f32)
//   counts[l] = Σ_i w_i·1[codes_i = l]
// x (P, N, D) f32 or bf16 (upcast in registers, as the TPU kernel upcasts
// its block), w (P, N) f32 or null (every weight 1; no weights are read),
// c (P, L, D) f32, lmask (L,) f32 or null (every centroid valid);
// dsums (P, L, D) f32, counts (P, L) f32.
//
// What bounds it on the H100: bytes. A launch reads x once (P·N·D·4 bytes
// in f32: 7.4 MB on the FEMNIST step, 134 MB at the serve cut; half that
// in bf16) against L·D FMAs of assignment and D+1 adds per row. At L = 16
// the instructions per row come close to the bytes: they are what the
// design keeps few.
//
// What the design does about it and about the TPU original:
//  * The Pallas kernel accumulates into one output block that every grid
//    step revisits, which is right only because TPU grid steps run in order.
//    CUDA blocks run in parallel, so each block writes its own partial sums
//    and a second, small kernel adds a problem's partials in block order.
//    There are no floating-point atomics, so a run is bitwise the same as
//    the run before it.
//  * Route d8 (D = 8, L in {2, 4, 8, 16}, x 16-byte aligned): a grid of a
//    few persistent blocks per SM streams the rows (stream.cuh: bulk
//    asynchronous copies into a ring in shared memory, kD8Rows rows per
//    thread per tile, upcast in registers). Each thread adds its strided
//    rows in row order into its own column of L·(D+1) sums in shared
//    memory, indexed by the row's code: D+1 adds a row, where sums held in
//    registers would take L·(D+1) predicated adds and every register at
//    L = 16. At the end a warp adds its lanes by an xor-shuffle tree, the
//    warps' sums are added in warp order, and the block writes one partial
//    per output. The codebook and its norms are read into shared memory
//    once per block, and from there into registers for the scores.
//  * Route generic (any D, L up to the caller's threshold, any
//    alignment): each block takes rows_per_block rows in tiles of kThreads
//    rows through shared memory, and every output element (l, k) has one
//    owner thread that adds the tile's rows in row order. At D <= kDTile
//    the block holds the codebook and the L·(D+1) sums in shared memory
//    (generic_smem), and a row tile is read once. Above kDTile a block
//    takes one chunk of kDTile dims (the grid's z): it finds each row's
//    code with assign.cuh's assign_tile (the rows and the codebook
//    streamed in chunks, the dot products in registers), then reads its
//    chunk of the tile and sums L·(kDTile+1) outputs. A block's shared
//    memory is then that of D = kDTile at any D, so the caller's
//    threshold, the largest L at which the card keeps two blocks resident
//    per SM at D = kDTile (lloyd_update_generic_max_l: 89 on an H100),
//    holds at every D and the route depends on L alone.
//  * Route tiled (any D, any L; the caller takes it above that
//    threshold, where the generic block's shared memory would crowd the
//    SM: 123 KB of sums alone at L = 960, D = 32). Three kernels:
//    lloyd_tiled_codes writes every row's code to a scratch array
//    (assign.cuh's assign_tile, the codebook streamed in tiles of kLTile
//    centroids and the rows in chunks of kDTile dims); lloyd_tiled_stats
//    gives each block a tile of kLTile centroids, a chunk of kDTile dims
//    and a range of rows_per_block rows, so it holds at most
//    kLTile·(kDTile+1) sums; in each row tile it buckets the rows whose
//    code falls in its centroid tile by a stable counting sort in shared
//    memory, and each output's owner thread adds only its bucket's rows,
//    in row order (the generic owner tests every row of the tile for
//    every output); lloyd_reduce adds the row ranges' partials in block
//    order. Each sum is the generic route's, term for term and in the same
//    order, for the same rows_per_block.
//  * Splitting D into chunks splits outputs, never a sum: every output
//    still adds its rows in row order, and every dot product runs k
//    ascending in one chain, so each route's sums at any D are those of
//    the order lloyd_update_in_kernel_order writes out.
//  * D and L are below tensor-core sizes: the distances are FMAs against a
//    codebook in shared memory (assign.cuh), and the TPU kernel's one-hot
//    matmul becomes an indexed read of the chosen centroid.
//  * Deviations x − c_l are accumulated, not raw sums, so a cluster that
//    covers its points exactly gets an update of exactly 0; rows of weight
//    0 add exactly 0. A weight multiplies with __fmul_rn, so no FMA
//    contraction rounds a weighted term differently from the plain
//    version's w·(x − c).
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
constexpr int kD8Warps = kD8Threads / 32;
constexpr int kD8Stages = 2;     // tiles in the ring

// A d8 block's dynamic shared memory: each consumer thread's L·(D+1) sums,
// output o of thread t at [o·kD8Threads + t] (a warp's 32 threads hit 32
// banks whatever their codes).
template <int L>
constexpr size_t d8_sums_bytes() {
  return sizeof(float) * L * 9 * kD8Threads;
}

template <typename T, int L>
__global__ void __launch_bounds__(kD8Threads + 32, 2)
lloyd_d8(const T* __restrict__ x, const float* __restrict__ w,
         const float* __restrict__ c, const float* __restrict__ lmask,
         float* __restrict__ partials, int n) {
  constexpr int D = 8, NOUT = L * (D + 1);
  __shared__ float cs[L * D], cn[L], ms[L];
  __shared__ float red[kD8Warps][NOUT];
  __shared__ RowRing<T, kD8Threads, kD8Rows, kD8Stages> ring;
  extern __shared__ float sums[];  // [NOUT][kD8Threads]
  const int p = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int tid = threadIdx.x;
  for (int e = tid; e < NOUT * kD8Threads; e += blockDim.x) sums[e] = 0.f;
  load_codebook(c + (size_t)p * L * D, lmask, cs, cn, ms, L, D);  // syncs
  // the scores read the codebook from registers, the deviations from
  // shared memory (indexed by the code)
  float cr[L * D], cnr[L];
#pragma unroll
  for (int e = 0; e < L * D; ++e) cr[e] = cs[e];
#pragma unroll
  for (int li = 0; li < L; ++li) cnr[li] = cn[li];
  const bool masked = lmask != nullptr;
  const float* wp = w ? w + (size_t)p * n : nullptr;
  float* mine = sums + tid;

  const bool consumer = stream_rows(
      x + (size_t)p * n * D, (size_t)n, b, nb, ring,
      [&](size_t row0, int nr, const float (&xr)[kD8Rows][D]) {
        int code[kD8Rows];
#pragma unroll
        for (int r = 0; r < kD8Rows; ++r)
          code[r] = assign_row_reg<L, D>(xr[r], cr, cnr, ms, masked);
#pragma unroll
        for (int r = 0; r < kD8Rows; ++r) {
          if (r >= nr) break;
          float dv[D];
#pragma unroll
          for (int k = 0; k < D; ++k)
            dv[k] = xr[r][k] - cs[code[r] * D + k];
          float wi = 1.f;
          if (wp) {
            wi = wp[row0 + (size_t)r * kD8Threads];
#pragma unroll
            for (int k = 0; k < D; ++k) dv[k] = __fmul_rn(wi, dv[k]);
          }
          float* a = mine + code[r] * (D + 1) * kD8Threads;
#pragma unroll
          for (int k = 0; k < D; ++k) a[k * kD8Threads] += dv[k];
          a[D * kD8Threads] += wi;
        }
      });
  if (!consumer) return;

  // lanes: an xor-shuffle tree (every lane ends with the warp's sum), then
  // the warps in warp order, then one partial per output
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll 4
  for (int o = 0; o < NOUT; ++o) {
    float v = mine[o * kD8Threads];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][o] = v;
  }
  consumers_sync<kD8Threads>();
  float* out = partials + ((size_t)p * nb + b) * NOUT;
  for (int o = tid; o < NOUT; o += kD8Threads) {
    float s = red[0][o];
#pragma unroll
    for (int wi = 1; wi < kD8Warps; ++wi) s += red[wi][o];
    out[o] = s;
  }
}

// ---------------------------------------------------------------------------
// route generic
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // rows per tile = threads per block

// Block (b, p, z) adds rows [b·rows_per_block, (b+1)·rows_per_block) of
// problem p into the sums of dims [z·kDTile, (z+1)·kDTile) and the counts
// (z = 0 writes those), with one chunk, z = 0, at D <= kDTile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lloyd_generic(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ c, const float* __restrict__ lmask,
              float* __restrict__ partials, int n, int l, int d,
              int rows_per_block) {
  extern __shared__ float smem[];
  const int p = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int tid = threadIdx.x;
  const bool whole = d <= kDTile;
  const int dc = chunk_dims(d), xstride = row_stride(dc);
  const int k0 = blockIdx.z * kDTile, kc = min(dc, d - k0);
  const int nout = l * (kc + 1);  // per centroid: kc deviation sums + 1 count
  float* cs = smem;                      // [l][dc]
  float* cn = cs + l * dc;               // [l]
  float* ms = cn + l;                    // [l]
  float* acc = ms + l;                   // [l][kc+1]
  float* xs = acc + l * (dc + 1);        // [kThreads][xstride]
  float* ws = xs + kThreads * xstride;   // [kThreads]
  int* cd = reinterpret_cast<int*>(ws + kThreads);  // [kThreads]

  for (int o = tid; o < nout; o += kThreads) acc[o] = 0.f;
  const float* cp = c + (size_t)p * l * d;
  if (whole) load_codebook(cp, lmask, cs, cn, ms, l, d);

  const T* xp = x + (size_t)p * n * d;
  const float* wp = w ? w + (size_t)p * n : nullptr;
  const int row_end = min((b + 1) * rows_per_block, n);
  for (int t0 = b * rows_per_block; t0 < row_end; t0 += kThreads) {
    const int rows = min(kThreads, row_end - t0);
    const T* xt = xp + (size_t)t0 * d;
    if (whole) {
      load_cols(xt, d, xs, rows, d, xstride);
      __syncthreads();
      if (tid < rows)
        cd[tid] = assign_row(xs + tid * xstride, cs, cn, ms, l, d);
    } else {
      float best;  // assign_tile ends with a barrier: xs is free again
      const int code = assign_tile(xt, rows, cp, lmask, l, d, xs, cs, cn, ms,
                                   &best);
      load_cols(xt + k0, d, xs, rows, kc, xstride);
      if (tid < rows) cd[tid] = code;
    }
    if (tid < rows) ws[tid] = wp ? wp[t0 + tid] : 1.f;
    __syncthreads();
    for (int o = tid; o < nout; o += kThreads) {
      const int li = o / (kc + 1), k = o % (kc + 1);
      float s = acc[o];
      if (k < kc) {
        const float ck = whole ? cs[li * d + k] : cp[(size_t)li * d + k0 + k];
        for (int r = 0; r < rows; ++r)
          if (cd[r] == li) s += __fmul_rn(ws[r], xs[r * xstride + k] - ck);
      } else {
        for (int r = 0; r < rows; ++r)
          if (cd[r] == li) s += ws[r];
      }
      acc[o] = s;
    }
    __syncthreads();  // the next tile overwrites xs, ws and cd
  }
  float* out = partials + ((size_t)p * nb + b) * l * (d + 1);
  for (int o = tid; o < nout; o += kThreads) {
    const int li = o / (kc + 1), k = o % (kc + 1);
    if (k < kc)
      out[(size_t)li * (d + 1) + k0 + k] = acc[o];
    else if (k0 == 0)
      out[(size_t)li * (d + 1) + d] = acc[o];
  }
}

// ---------------------------------------------------------------------------
// route tiled
// ---------------------------------------------------------------------------

// Every row's code, into the scratch array codes (P, N): one block per
// tile of kThreads rows of one problem, as pq_quantize's generic route.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lloyd_tiled_codes(const T* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ lmask, int* __restrict__ codes,
                  int n, int l, int d) {
  extern __shared__ float smem[];
  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - t0);
  const int dc = chunk_dims(d);
  float* cs = smem;                     // [kLTile][dc]
  float* cn = cs + kLTile * dc;         // [kLTile]
  float* ms = cn + kLTile;              // [kLTile]
  float* xs = ms + kLTile;              // [kThreads][row_stride(dc)]

  float best;
  const int code = assign_tile(x + ((size_t)p * n + t0) * d, rows,
                               c + (size_t)p * l * d, lmask, l, d, xs, cs, cn,
                               ms, &best);
  if (tid < rows) codes[(size_t)p * n + t0 + tid] = code;
}

// Block (b, t, p·chunks + z) adds rows [b·rows_per_block, (b+1)·
// rows_per_block) of problem p into the sums of centroids [t·kLTile, ...)
// over dims [z·kDTile, (z+1)·kDTile) and their counts (z = 0 writes
// those), and writes them to its partial, laid out as lloyd_reduce reads
// it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lloyd_tiled_stats(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ c, const int* __restrict__ codes,
                  float* __restrict__ partials, int n, int l, int d,
                  int rows_per_block) {
  extern __shared__ float smem[];
  const int chunks = (d + kDTile - 1) / kDTile;
  const int b = blockIdx.x, nb = gridDim.x, p = blockIdx.z / chunks;
  const int l0 = blockIdx.y * kLTile, lt = min(kLTile, l - l0);
  const int dc = chunk_dims(d), k0 = (blockIdx.z % chunks) * kDTile;
  const int kc = min(dc, d - k0);
  const int tid = threadIdx.x;
  const int xstride = row_stride(dc);
  const int nout = lt * (kc + 1);  // this block's outputs
  float* cs = smem;                            // [kLTile][kc]
  float* acc = cs + kLTile * dc;               // [kLTile][kc+1]
  float* xs = acc + kLTile * (dc + 1);         // [kThreads][xstride]
  float* ws = xs + kThreads * xstride;         // [kThreads]
  int* cd = reinterpret_cast<int*>(ws + kThreads);  // [kThreads], local
  int* order = cd + kThreads;                  // [kThreads] rows by code
  int* cnt = order + kThreads;                 // [kLTile] bucket sizes
  int* start = cnt + kLTile;                   // [kLTile] bucket offsets

  for (int e = tid; e < lt * kc; e += kThreads)
    cs[e] = c[((size_t)p * l + l0 + e / kc) * d + k0 + e % kc];
  for (int o = tid; o < nout; o += kThreads) acc[o] = 0.f;

  const T* xp = x + (size_t)p * n * d;
  const float* wp = w ? w + (size_t)p * n : nullptr;
  const int* cp = codes + (size_t)p * n;
  const int row_end = min((b + 1) * rows_per_block, n);
  for (int t0 = b * rows_per_block; t0 < row_end; t0 += kThreads) {
    const int rows = min(kThreads, row_end - t0);
    if (tid < rows) {
      cd[tid] = cp[t0 + tid] - l0;  // in [0, lt) for this block's rows
      ws[tid] = wp ? wp[t0 + tid] : 1.f;
    }
    load_cols(xp + (size_t)t0 * d + k0, d, xs, rows, kc, xstride);
    __syncthreads();
    // stable counting sort: thread j lists the tile's rows of local code j
    // in row order, after the rows of codes 0 .. j−1
    if (tid < lt) {
      int m = 0;
      for (int r = 0; r < rows; ++r) m += cd[r] == tid;
      cnt[tid] = m;
    }
    __syncthreads();
    if (tid < lt) {
      int i = 0;
      for (int j = 0; j < tid; ++j) i += cnt[j];
      start[tid] = i;
      for (int r = 0; r < rows; ++r)
        if (cd[r] == tid) order[i++] = r;
    }
    __syncthreads();
    for (int o = tid; o < nout; o += kThreads) {
      const int j = o / (kc + 1), k = o % (kc + 1);
      const int* rs = order + start[j];
      const int m = cnt[j];
      float s = acc[o];
      if (k < kc) {
        const float ck = cs[j * kc + k];
        for (int i = 0; i < m; ++i) {
          const int r = rs[i];
          s += __fmul_rn(ws[r], xs[r * xstride + k] - ck);
        }
      } else {
        for (int i = 0; i < m; ++i) s += ws[rs[i]];
      }
      acc[o] = s;
    }
    __syncthreads();  // the next tile overwrites xs, ws, cd and the buckets
  }
  float* out = partials + ((size_t)p * nb + b) * l * (d + 1) +
               (size_t)l0 * (d + 1);
  for (int o = tid; o < nout; o += kThreads) {
    const int j = o / (kc + 1), k = o % (kc + 1);
    if (k < kc)
      out[(size_t)j * (d + 1) + k0 + k] = acc[o];
    else if (k0 == 0)
      out[(size_t)j * (d + 1) + d] = acc[o];
  }
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

// Lets the instance take its dynamic shared memory (above the default 48
// KB at L = 16), once per device; the first call comes before any launch,
// from lloyd_update_d8_occupancy.
template <typename T, int L>
cudaError_t prepare_d8() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 64 || done[dev]) return e;
  e = cudaFuncSetAttribute(lloyd_d8<T, L>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)d8_sums_bytes<L>());
  done[dev] = e == cudaSuccess;
  return e;
}

template <typename T, int L>
cudaError_t launch_d8(const void* x, const void* w, const void* c,
                      const void* lmask, void* partials, int p, int n,
                      int nblocks, cudaStream_t s) {
  cudaError_t e = prepare_d8<T, L>();
  if (e != cudaSuccess) return e;
  lloyd_d8<T, L><<<dim3(nblocks, p), kD8Threads + 32, d8_sums_bytes<L>(),
                   s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(c), static_cast<const float*>(lmask),
      static_cast<float*>(partials), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d8_l(const void* x, const void* w, const void* c,
                        const void* lmask, void* partials, int p, int n,
                        int l, int nblocks, cudaStream_t s) {
  switch (l) {
    case 2: return launch_d8<T, 2>(x, w, c, lmask, partials, p, n, nblocks, s);
    case 4: return launch_d8<T, 4>(x, w, c, lmask, partials, p, n, nblocks, s);
    case 8: return launch_d8<T, 8>(x, w, c, lmask, partials, p, n, nblocks, s);
    case 16:
      return launch_d8<T, 16>(x, w, c, lmask, partials, p, n, nblocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of the d8 instance (T, L), 0 on an error.
template <typename T, int L>
int d8_occupancy() {
  int blocks = 0;
  if (prepare_d8<T, L>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, lloyd_d8<T, L>, kD8Threads + 32, d8_sums_bytes<L>()) !=
          cudaSuccess)
    return 0;
  return blocks;
}

template <typename T>
int d8_occupancy_l(int l) {
  switch (l) {
    case 2: return d8_occupancy<T, 2>();
    case 4: return d8_occupancy<T, 4>();
    case 8: return d8_occupancy<T, 8>();
    case 16: return d8_occupancy<T, 16>();
    default: return 0;
  }
}

// Sets a kernel's dynamic shared memory limit where it needs more than the
// default 48 KB.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// A generic block's dynamic shared memory: the codebook (at D > kDTile a
// chunk of a tile of it), its norms and mask, the sums, a tile of kThreads
// rows (a chunk of each at D > kDTile) at an odd stride, their weights and
// codes. It does not grow with D above kDTile.
size_t generic_smem(int l, int d) {
  const int dc = chunk_dims(d);
  return sizeof(float) * ((size_t)l * dc + 2 * l + (size_t)l * (dc + 1) +
                          (size_t)kThreads * row_stride(dc) + kThreads) +
         sizeof(int) * kThreads;
}

// Resident generic blocks per SM of the instance T at (l, d), 0 where a
// block does not fit.
template <typename T>
int generic_occupancy(int l, int d) {
  const size_t smem = generic_smem(l, d);
  const void* k = reinterpret_cast<const void*>(lloyd_generic<T>);
  int blocks = 0;
  if (allow_smem(k, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                    smem) != cudaSuccess)
    return 0;
  return blocks;
}

template <typename T>
cudaError_t launch_generic(const void* x, const void* w, const void* c,
                           const void* lmask, void* partials, int p, int n,
                           int l, int d, int rows_per_block, int nblocks,
                           cudaStream_t s) {
  const size_t smem = generic_smem(l, d);
  cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(lloyd_generic<T>), smem);
  if (e != cudaSuccess) return e;
  const int chunks = (d + kDTile - 1) / kDTile;
  lloyd_generic<T><<<dim3(nblocks, p, chunks), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(c), static_cast<const float*>(lmask),
      static_cast<float*>(partials), n, l, d, rows_per_block);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled(const void* x, const void* w, const void* c,
                         const void* lmask, void* codes, void* partials,
                         int p, int n, int l, int d, int rows_per_block,
                         int nblocks, cudaStream_t s) {
  const int dc = chunk_dims(d), chunks = (d + kDTile - 1) / kDTile;
  const size_t smem_codes =
      sizeof(float) * ((size_t)kLTile * dc + 2 * kLTile +
                       (size_t)kThreads * row_stride(dc));
  const size_t smem_stats =
      sizeof(float) * ((size_t)kLTile * dc + (size_t)kLTile * (dc + 1) +
                       (size_t)kThreads * row_stride(dc) + kThreads) +
      sizeof(int) * (2 * kThreads + 2 * kLTile);
  cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(lloyd_tiled_codes<T>), smem_codes);
  if (e == cudaSuccess)
    e = allow_smem(reinterpret_cast<const void*>(lloyd_tiled_stats<T>),
                   smem_stats);
  if (e != cudaSuccess) return e;
  lloyd_tiled_codes<T><<<dim3((n + kThreads - 1) / kThreads, p), kThreads,
                         smem_codes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const float*>(lmask), static_cast<int*>(codes), n, l, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(nblocks, (l + kLTile - 1) / kLTile, p * chunks);
  lloyd_tiled_stats<T><<<grid, kThreads, smem_stats, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(c), static_cast<const int*>(codes),
      static_cast<float*>(partials), n, l, d, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// Resident blocks per SM of the d8 instance for (l, bf16), for the caller's
// grid (0 where there is no such instance).
extern "C" int lloyd_update_d8_occupancy(int l, int bf16) {
  return bf16 ? d8_occupancy_l<__nv_bfloat16>(l) : d8_occupancy_l<float>(l);
}

// The largest L at which a generic block at D = d, f32 or bf16, still
// leaves min_blocks resident blocks per SM on the current device (0 where
// none does at L = 1): what the caller compares L with to choose between
// the generic and the tiled route.
extern "C" int lloyd_update_generic_max_l(int d, int min_blocks) {
  int l = 0;
  while (l < (1 << 16) &&
         min(generic_occupancy<float>(l + 1, d),
             generic_occupancy<__nv_bfloat16>(l + 1, d)) >= min_blocks)
    ++l;
  cudaGetLastError();  // clears the error of the probe that did not fit
  return l;
}

// route 1 = d8 (rows = its kD8Threads·kD8Rows rows per tile), 0 = generic
// and 2 = tiled (rows = rows per block, a multiple of kThreads); w and
// lmask may be null. partials: scratch of nblocks·P·L·(D+1) floats; codes:
// scratch of P·N ints for the tiled route (null for the others); both
// allocated by the caller.
extern "C" int lloyd_update_launch(const void* x, const void* w,
                                   const void* c, const void* lmask,
                                   void* codes, void* partials, void* dsums,
                                   void* counts, int p, int n, int l, int d,
                                   int route, int bf16, int rows,
                                   int nblocks, void* stream) {
  if (p == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks > 0) {
    cudaError_t e;
    if (route == 1) {
      if (d != 8 || rows != kD8Threads * kD8Rows || misaligned16(x))
        return (int)cudaErrorInvalidValue;
      e = bf16 ? launch_d8_l<__nv_bfloat16>(x, w, c, lmask, partials, p, n,
                                             l, nblocks, s)
               : launch_d8_l<float>(x, w, c, lmask, partials, p, n, l,
                                    nblocks, s);
    } else if (route == 2) {
      if (rows % kThreads != 0 || codes == nullptr)
        return (int)cudaErrorInvalidValue;
      e = bf16 ? launch_tiled<__nv_bfloat16>(x, w, c, lmask, codes, partials,
                                              p, n, l, d, rows, nblocks, s)
               : launch_tiled<float>(x, w, c, lmask, codes, partials, p, n,
                                     l, d, rows, nblocks, s);
    } else {
      if (rows % kThreads != 0) return (int)cudaErrorInvalidValue;
      e = bf16 ? launch_generic<__nv_bfloat16>(x, w, c, lmask, partials, p,
                                                n, l, d, rows, nblocks, s)
               : launch_generic<float>(x, w, c, lmask, partials, p, n, l, d,
                                       rows, nblocks, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  lloyd_reduce<<<p, 128, 0, s>>>(static_cast<const float*>(partials),
                                 static_cast<float*>(dsums),
                                 static_cast<float*>(counts), l, d, nblocks);
  return (int)cudaGetLastError();
}
