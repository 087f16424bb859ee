// adafactor: one leaf's Adafactor update (Shazeer & Stern, 2018; no
// momentum) in three streaming passes over its gradient.
//
// Replaces no TPU kernel: the reference's Adafactor (src/repro/optim/
// optimizers.py) is jnp that XLA fuses into a few loops. The port's plain
// version (kernels/ref.py: adafactor_update_ref) is eager PyTorch: some 15
// full-size f32 passes a factored leaf, about 104 bytes of traffic per
// element.
//
// What it computes. A leaf of rank >= 2, in the reference's layout, is nmat
// matrices (R, C) over its leading dims; g is f32 or bf16:
//   g2   = g·g + eps
//   row  = β·row + (1 − β)·(Σ_c g2 / C)                      (nmat, R)
//   col  = β·col + (1 − β)·(Σ_r g2 / R)                      (nmat, C)
//   mean = Σ_r row / R                                       (nmat,)
//   u    = g / max(sqrt(row_r·col_c / max(mean, eps)), eps)
//   d    = max(sqrt(Σ u² / N + eps) / clip, 1)         (the whole leaf)
//   out  = T((u / d)·(−lr))
// A leaf of rank <= 1 keeps its second moment whole: v = β·v + (1 − β)·g2
// and u = g / max(sqrt(v), eps). row, col and v are written as new f32
// tensors in the reference's layout; out in g's type.
//
// Stages. Each launcher below is one stage; between stages the caller may
// add the stage's sums over the ranks that hold the leaf's other blocks
// (kernels/adafactor.py does so for a DTensor's local block; C, R and N
// are then the whole leaf's counts, passed in as divisors):
//   adafactor_sums_launch      pass 1: Σ_c g2 and Σ_r g2 over the block
//   adafactor_factors_launch   the new row and col from those sums, and
//                              Σ_r row a matrix
//   adafactor_squares_launch   pass 2: Σ u² over the block
//   adafactor_apply_launch     pass 3: out
// and for the whole form adafactor_full_squares_launch (the new v and Σ u²)
// and adafactor_full_apply_launch.
//
// What bounds it on the H100: bytes, then the f32 pipes. Three reads of g
// and one write of out are 8 bytes per element in bf16 (43 GB a step of
// the Mixtral cell's 5.41e9 parameters, 13 ms at 3.35 TB/s); passes 2 and
// 3 spend two IEEE divisions and a square root per element (three
// divisions where the clip engages), each behind nvcc's range check.
//
// What the design does about it:
//  * Pass 1 (adafactor_factor_sums): a block takes a tile of kTileRows rows
//    by one warp's width of columns (32 lanes of one 16-byte load: 256
//    bf16 or 128 f32 columns) of one matrix. Each warp walks its rows,
//    kUnroll loads in flight a lane, and keeps the column sums of its
//    lanes in registers; a row's sum over the tile is a warp butterfly.
//    The block writes one partial a row and a column (the columns' over
//    its 8 warps in shared memory, in warp order): (nmat, C/tile, R) and
//    (nmat, R/kTileRows, C) floats, under 1 % of g; adafactor_factor_reduce
//    sums each row's and column's partials in order.
//  * adafactor_factor_ema forms the new factors, one block a matrix's rows
//    (which also sums them, for the mean) and the rest its columns.
//  * Passes 2 and 3 (adafactor_factored_u) walk g's tiles as pass 1 does,
//    each lane with its columns' col values in registers, and recompute u
//    from g rather than keep it: a full-size f32 u would cost 8 bytes an
//    element more than the third read of g. Pass 2 sums u² per block and
//    adafactor_sum adds those partials in order; pass 3 forms d from the sum
//    and writes out as one 16-byte store a lane.
//  * Numerics: each element goes through the plain version's operations in
//    its order, each rounded once (the _rn intrinsics, which nvcc never
//    contracts into an FMA; IEEE division and square root: the build has
//    no fast-math flags, and denormals are kept). A clamp keeps a NaN, as
//    torch's clamp_min does. Two things differ from the plain version: the
//    order of the f32 sums, and the means, which divide a sum by its count
//    where torch's mean multiplies it by 1/count (another rounding).
//  * Determinism: every sum across threads and blocks is a fixed tree or a
//    fixed-order loop over per-block partials; no atomics. The grid depends
//    on the shape alone, so two launches on the same inputs give the same
//    bits.
//  * A vector route where C is a multiple of the 16-byte load's values (g
//    and out 16-byte aligned, which the launchers check); otherwise each
//    lane reads its values one at a time (ragged C: small leaves).
//  * A block with no values (a rank's empty shard) is allowed: its sums
//    are written as 0 and its passes launch nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 256;                     // rows of a tile
constexpr int kRowsPerWarp = kTileRows / kWarps;   // 32
constexpr int kUnroll = 2;         // rows a lane loads before using any
constexpr int kFullPer = 16;       // values a thread of the whole form takes
constexpr int kReduceThreads = 1024;

// values of T in one 16-byte load
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// torch's clamp_min: lo where x < lo, else x (a NaN stays a NaN)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
// g·g + eps, as g32.square() + eps
__device__ __forceinline__ float sq_eps(float g, float eps) {
  return __fadd_rn(__fmul_rn(g, g), eps);
}
// β·old + (1 − β)·mean
__device__ __forceinline__ float ema(float beta, float old, float one_minus,
                                     float mean) {
  return __fadd_rn(__fmul_rn(beta, old), __fmul_rn(one_minus, mean));
}
// g / max(rms, eps)
__device__ __forceinline__ float unit(float g, float rms, float eps) {
  return __fdiv_rn(g, clamp_min(rms, eps));
}
// sqrt(row·col / m), m = max(mean, eps)
__device__ __forceinline__ float factored_rms(float row, float col,
                                              float m) {
  return __fsqrt_rn(__fdiv_rn(__fmul_rn(row, col), m));
}

// A lane's vector of values: one 16-byte load where kVec (every value in
// the row), else the first `valid` values one at a time and 0 past them.
template <bool kVec>
__device__ __forceinline__ void load_vec(const float* p, int valid,
                                         float (&v)[4]) {
  if (kVec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < valid ? p[e] : 0.f;
  }
}
// a bf16 is the top half of an f32, so the upcast is exact
template <bool kVec>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, int valid,
                                         float (&v)[8]) {
  if (kVec) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = e < valid ? __bfloat162float(p[e]) : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_vec(float* p, int valid,
                                          const float (&w)[4]) {
  if (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < valid) p[e] = w[e];
  }
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
template <bool kVec>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, int valid,
                                          const float (&w)[8]) {
  if (kVec) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16_pair(w[0], w[1]), bf16_pair(w[2], w[3]),
                   bf16_pair(w[4], w[5]), bf16_pair(w[6], w[7]));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < valid) p[e] = __float2bfloat16_rn(w[e]);
  }
}

// A butterfly: every lane ends with the same sum, in a fixed order.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}
// The block's sum, valid on thread 0: its warps' sums added in warp order.
// Called once a kernel.
template <int kN>
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float warps[kN / 32];
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = s;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x < 32) {
    t = threadIdx.x < kN / 32 ? warps[threadIdx.x] : 0.f;
    t = warp_sum(t);
  }
  return t;
}

// The tile of block blockIdx.x: matrix b, row tile rt, column tile ct.
struct Tile {
  int b, rt, ct;
};
__device__ __forceinline__ Tile tile_of(int nrt, int nct) {
  const int rest = (int)blockIdx.x / nct;
  return {rest / nrt, rest % nrt, (int)blockIdx.x % nct};
}


// d = max(sqrt(Σu² / count + eps) / clip, 1)
__device__ __forceinline__ float clip_divisor(float sumsq, float count,
                                              float eps, float clip) {
  const float urms = __fsqrt_rn(__fadd_rn(__fdiv_rn(sumsq, count), eps));
  return clamp_min(__fdiv_rn(urms, clip), 1.f);
}

// ---------------------------------------------------------------------------
// factored form
// ---------------------------------------------------------------------------

// Pass 1: row_part[b, ct, r] = Σ over the tile's columns of g2[b, r, c],
// col_part[b, rt, c] = Σ over the tile's rows.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
adafactor_factor_sums(const T* __restrict__ g, float* __restrict__ row_part,
                      float* __restrict__ col_part, int rows, int cols,
                      int nrt, int nct, float eps) {
  constexpr int n = Vec<T>::n;
  constexpr int kTileCols = 32 * n;
  __shared__ float s_row[kTileRows];
  __shared__ float s_col[kWarps][kTileCols];
  const Tile t = tile_of(nrt, nct);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = t.ct * kTileCols + lane * n;
  const int valid = cols - c0;  // the lane's values inside the row
  const T* gm = g + (size_t)t.b * rows * cols;
  float col_acc[n];
#pragma unroll
  for (int e = 0; e < n; ++e) col_acc[e] = 0.f;
  for (int i0 = 0; i0 < kRowsPerWarp; i0 += kUnroll) {
    float v[kUnroll][n];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int r = t.rt * kTileRows + warp + (i0 + k) * kWarps;
      if (r < rows && valid > 0)
        load_vec<kVec>(gm + (size_t)r * cols + c0, valid, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int r = t.rt * kTileRows + warp + (i0 + k) * kWarps;
      float s = 0.f;
      if (r < rows && valid > 0) {
#pragma unroll
        for (int e = 0; e < n; ++e) {
          if (!kVec && e >= valid) continue;
          const float q = sq_eps(v[k][e], eps);
          col_acc[e] += q;
          s += q;
        }
      }
      s = warp_sum(s);
      if (lane == 0) s_row[warp + (i0 + k) * kWarps] = s;
    }
  }
#pragma unroll
  for (int e = 0; e < n; ++e) s_col[warp][lane * n + e] = col_acc[e];
  __syncthreads();
  for (int i = threadIdx.x; i < kTileCols; i += kThreads) {
    const int c = t.ct * kTileCols + i;
    if (c >= cols) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_col[w][i];
    col_part[((size_t)t.b * nrt + t.rt) * cols + c] = s;
  }
  for (int i = threadIdx.x; i < kTileRows; i += kThreads) {
    const int r = t.rt * kTileRows + i;
    if (r < rows) row_part[((size_t)t.b * nct + t.ct) * rows + r] = s_row[i];
  }
}

// Each row's and column's partials summed in order: thread i < nmat·R takes
// row i, the rest column i − nmat·R.
__global__ void __launch_bounds__(kThreads)
adafactor_factor_reduce(const float* __restrict__ row_part,
                        const float* __restrict__ col_part,
                        float* __restrict__ row_sum,
                        float* __restrict__ col_sum, int nmat, int rows,
                        int cols, int nrt, int nct) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t nrow = (size_t)nmat * rows;
  if (i < nrow) {
    const size_t b = i / rows, r = i % rows;
    float s = 0.f;
    for (int ct = 0; ct < nct; ++ct) s += row_part[(b * nct + ct) * rows + r];
    row_sum[i] = s;
  } else if (i < nrow + (size_t)nmat * cols) {
    const size_t j = i - nrow;
    const size_t b = j / cols, c = j % cols;
    float s = 0.f;
    for (int rt = 0; rt < nrt; ++rt) s += col_part[(b * nrt + rt) * cols + c];
    col_sum[j] = s;
  }
}

// The new factors from the sums: block b < nmat takes matrix b's rows and
// writes total[b] = Σ_r row_new[b, r]; the blocks past it take columns.
__global__ void __launch_bounds__(kReduceThreads)
adafactor_factor_ema(const float* __restrict__ row_sum,
                     const float* __restrict__ col_sum,
                     const float* __restrict__ row_old,
                     const float* __restrict__ col_old,
                     float* __restrict__ row_new, float* __restrict__ col_new,
                     float* __restrict__ total, int nmat, int rows, int cols,
                     float row_div, float col_div, float beta,
                     float one_minus) {
  if ((int)blockIdx.x < nmat) {
    const size_t base = (size_t)blockIdx.x * rows;
    float s = 0.f;
    for (int r = threadIdx.x; r < rows; r += kReduceThreads) {
      const float v = ema(beta, row_old[base + r], one_minus,
                          __fdiv_rn(row_sum[base + r], row_div));
      row_new[base + r] = v;
      s += v;
    }
    s = block_sum<kReduceThreads>(s);
    if (threadIdx.x == 0) total[blockIdx.x] = s;
  } else {
    const size_t j =
        (size_t)(blockIdx.x - nmat) * kReduceThreads + threadIdx.x;
    if (j < (size_t)nmat * cols)
      col_new[j] = ema(beta, col_old[j], one_minus,
                       __fdiv_rn(col_sum[j], col_div));
  }
}

// Pass 2 (kApply false): part[block] = Σ u² over the tile. Pass 3 (kApply
// true): out = T((u / d)·neg_lr), d from *sumsq. A matrix's mean is
// total[b] / mean_div.
template <typename T, bool kVec, bool kApply>
__global__ void __launch_bounds__(kThreads)
adafactor_factored_u(const T* __restrict__ g, const float* __restrict__ row,
                     const float* __restrict__ col,
                     const float* __restrict__ total,
                     float* __restrict__ part,
                     const float* __restrict__ sumsq, T* __restrict__ out,
                     int rows, int cols, int nrt, int nct, float mean_div,
                     float count, float eps, float clip, float neg_lr) {
  constexpr int n = Vec<T>::n;
  constexpr int kTileCols = 32 * n;
  const Tile t = tile_of(nrt, nct);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = t.ct * kTileCols + lane * n;
  const int valid = cols - c0;
  const size_t mat = (size_t)t.b * rows * cols;
  const T* gm = g + mat;
  const float* rowm = row + (size_t)t.b * rows;
  const float m = clamp_min(__fdiv_rn(total[t.b], mean_div), eps);
  const float d = kApply ? clip_divisor(*sumsq, count, eps, clip) : 1.f;
  float cv[n];
#pragma unroll
  for (int e = 0; e < n; ++e)
    cv[e] = e < valid ? col[(size_t)t.b * cols + c0 + e] : 0.f;
  float acc = 0.f;
  for (int i0 = 0; i0 < kRowsPerWarp; i0 += kUnroll) {
    float v[kUnroll][n];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int r = t.rt * kTileRows + warp + (i0 + k) * kWarps;
      if (r < rows && valid > 0)
        load_vec<kVec>(gm + (size_t)r * cols + c0, valid, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int r = t.rt * kTileRows + warp + (i0 + k) * kWarps;
      if (r >= rows || valid <= 0) continue;
      const float rv = rowm[r];
      float w[n];
#pragma unroll
      for (int e = 0; e < n; ++e) {
        if (!kVec && e >= valid) {
          w[e] = 0.f;
          continue;
        }
        float u = unit(v[k][e], factored_rms(rv, cv[e], m), eps);
        if (kApply) {
          if (d != 1.f) u = __fdiv_rn(u, d);
          w[e] = __fmul_rn(u, neg_lr);
        } else {
          acc += __fmul_rn(u, u);
        }
      }
      if (kApply) store_vec<kVec>(out + mat + (size_t)r * cols + c0, valid, w);
    }
  }
  if (!kApply) {
    acc = block_sum<kThreads>(acc);
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
  }
}

// *sum = Σ part, in order over a fixed tree; one block
__global__ void __launch_bounds__(kReduceThreads)
adafactor_sum(const float* __restrict__ part, int nparts,
              float* __restrict__ sum) {
  float s = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kReduceThreads) s += part[i];
  s = block_sum<kReduceThreads>(s);
  if (threadIdx.x == 0) *sum = s;
}

// ---------------------------------------------------------------------------
// whole form (rank <= 1)
// ---------------------------------------------------------------------------

// Pass 2 (kApply false): v_new = β·v_old + (1 − β)·g2 and part[block] = Σ
// u²; pass 3 (kApply true): out from v_new and d from *sumsq.
template <typename T, bool kApply>
__global__ void __launch_bounds__(kThreads)
adafactor_full_u(const T* __restrict__ g, const float* __restrict__ v_old,
                 float* __restrict__ v_new, float* __restrict__ part,
                 const float* __restrict__ sumsq, T* __restrict__ out,
                 long long count, float total_count, float beta,
                 float one_minus, float eps, float clip, float neg_lr) {
  const size_t n = (size_t)count;
  const size_t base = (size_t)blockIdx.x * kThreads * kFullPer + threadIdx.x;
  const float d = kApply ? clip_divisor(*sumsq, total_count, eps, clip) : 1.f;
  float acc = 0.f;
  for (int k = 0; k < kFullPer; ++k) {
    const size_t i = base + (size_t)k * kThreads;
    if (i >= n) break;
    const float gv = to_f32(g[i]);
    float vn;
    if (kApply) {
      vn = v_new[i];
    } else {
      vn = ema(beta, v_old[i], one_minus, sq_eps(gv, eps));
      v_new[i] = vn;
    }
    float u = unit(gv, __fsqrt_rn(vn), eps);
    if (kApply) {
      if (d != 1.f) u = __fdiv_rn(u, d);
      store_one(out + i, __fmul_rn(u, neg_lr));
    } else {
      acc += __fmul_rn(u, u);
    }
  }
  if (!kApply) {
    acc = block_sum<kThreads>(acc);
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

long long div_up(long long a, long long b) { return (a + b - 1) / b; }

// The factored form's grid: row tiles, column tiles, blocks (0 where the
// block has no values), or -1 where the shape is out of range.
struct Grid {
  int nrt, nct;
  long long nblocks;
};
Grid grid_of(int nmat, int rows, int cols, int bf16) {
  const int per = bf16 ? Vec<__nv_bfloat16>::n : Vec<float>::n;
  if (nmat < 0 || rows < 0 || cols < 0) return {0, 0, -1};
  const int nrt = (int)div_up(rows, kTileRows);
  const int nct = (int)div_up(cols, 32 * per);
  const long long nblocks = (long long)nmat * nrt * nct;
  return {nrt, nct, nblocks > 0x7fffffffLL ? -1 : nblocks};
}

bool vec_ok(int vec, int cols, int bf16, const void* g, const void* out) {
  const int per = bf16 ? Vec<__nv_bfloat16>::n : Vec<float>::n;
  return !vec || (cols % per == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0);
}

// Floats of scratch adafactor_sums_launch takes (the row and column
// partials); adafactor_squares_launch takes one a block.
long long sums_scratch(int nmat, int rows, int cols, const Grid& gr) {
  return (long long)nmat * gr.nct * rows + (long long)nmat * gr.nrt * cols;
}
// The whole form's blocks on count values (and its floats of scratch).
long long full_blocks(long long count) {
  return div_up(count, (long long)kThreads * kFullPer);
}

template <typename T, bool kVec>
cudaError_t run_sums(const void* g, float* row_sum, float* col_sum,
                     float* scratch, int nmat, int rows, int cols,
                     const Grid& gr, float eps, cudaStream_t s) {
  float* row_part = scratch;
  float* col_part = row_part + (size_t)nmat * gr.nct * rows;
  adafactor_factor_sums<T, kVec><<<(int)gr.nblocks, kThreads, 0, s>>>(
      static_cast<const T*>(g), row_part, col_part, rows, cols, gr.nrt,
      gr.nct, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nfactors = (long long)nmat * rows + (long long)nmat * cols;
  adafactor_factor_reduce<<<(int)div_up(nfactors, kThreads), kThreads, 0,
                            s>>>(row_part, col_part, row_sum, col_sum, nmat,
                                 rows, cols, gr.nrt, gr.nct);
  return cudaGetLastError();
}

template <typename T, bool kVec, bool kApply>
cudaError_t run_u(const void* g, const float* row, const float* col,
                  const float* total, float* part, float* sumsq, void* out,
                  int rows, int cols, const Grid& gr, float mean_div,
                  float count, float eps, float clip, float neg_lr,
                  cudaStream_t s) {
  adafactor_factored_u<T, kVec, kApply><<<(int)gr.nblocks, kThreads, 0, s>>>(
      static_cast<const T*>(g), row, col, total, part, sumsq,
      static_cast<T*>(out), rows, cols, gr.nrt, gr.nct, mean_div, count, eps,
      clip, neg_lr);
  cudaError_t err = cudaGetLastError();
  if (kApply || err != cudaSuccess) return err;
  adafactor_sum<<<1, kReduceThreads, 0, s>>>(part, (int)gr.nblocks, sumsq);
  return cudaGetLastError();
}

template <typename T, bool kApply>
cudaError_t run_full(const void* g, const float* v_old, float* v_new,
                     float* part, const float* sumsq, void* out,
                     long long count, long long nblocks, float total_count,
                     float beta, float one_minus, float eps, float clip,
                     float neg_lr, cudaStream_t s) {
  adafactor_full_u<T, kApply><<<(int)nblocks, kThreads, 0, s>>>(
      static_cast<const T*>(g), v_old, v_new, part, sumsq,
      static_cast<T*>(out), count, total_count, beta, one_minus, eps, clip,
      neg_lr);
  return cudaGetLastError();
}

}  // namespace

// Pass 1 on nmat matrices (rows, cols) of g (bf16 1 = bf16 values, 0 =
// f32): row_sum (nmat, rows) = Σ_c g2 and col_sum (nmat, cols) = Σ_r g2,
// f32. vec 1 = the 16-byte route (cols a multiple of the load's values, g
// 16-byte aligned).
extern "C" int adafactor_sums_launch(const void* g, void* row_sum,
                                     void* col_sum, void* scratch,
                                     long long scratch_floats, int nmat,
                                     int rows, int cols, int bf16, int vec,
                                     float eps, void* stream) {
  const Grid gr = grid_of(nmat, rows, cols, bf16);
  if (gr.nblocks < 0 || !vec_ok(vec, cols, bf16, g, g) ||
      scratch_floats < sums_scratch(nmat, rows, cols, gr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rs = static_cast<float*>(row_sum);
  float* cs = static_cast<float*>(col_sum);
  if (gr.nblocks == 0) {  // an empty block: its sums are 0
    const cudaError_t err =
        cudaMemsetAsync(rs, 0, sizeof(float) * (size_t)nmat * rows, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(cs, 0, sizeof(float) * (size_t)nmat * cols,
                                s);
  }
  float* sc = static_cast<float*>(scratch);
#define ADAFACTOR_SUMS(T, V) \
  run_sums<T, V>(g, rs, cs, sc, nmat, rows, cols, gr, eps, s)
  const cudaError_t err =
      bf16 ? (vec ? ADAFACTOR_SUMS(__nv_bfloat16, true)
                  : ADAFACTOR_SUMS(__nv_bfloat16, false))
           : (vec ? ADAFACTOR_SUMS(float, true) : ADAFACTOR_SUMS(float, false));
#undef ADAFACTOR_SUMS
  return (int)err;
}

// The new factors: row_new = β·row_old + (1 − β)·row_sum / row_div (the
// leaf's C), col_new likewise over col_div (its R); total (nmat,) = Σ_r
// row_new. rows or cols may be 0.
extern "C" int adafactor_factors_launch(
    const void* row_sum, const void* col_sum, const void* row_old,
    const void* col_old, void* row_new, void* col_new, void* total, int nmat,
    int rows, int cols, float row_div, float col_div, float beta,
    float one_minus, void* stream) {
  if (nmat < 0 || rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  if (nmat == 0) return 0;
  const long long nblocks =
      nmat + div_up((long long)nmat * cols, kReduceThreads);
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  adafactor_factor_ema<<<(int)nblocks, kReduceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(row_sum), static_cast<const float*>(col_sum),
      static_cast<const float*>(row_old), static_cast<const float*>(col_old),
      static_cast<float*>(row_new), static_cast<float*>(col_new),
      static_cast<float*>(total), nmat, rows, cols, row_div, col_div, beta,
      one_minus);
  return (int)cudaGetLastError();
}

// Pass 2: *sumsq = Σ u² over the block, the means total / mean_div (the
// leaf's R).
extern "C" int adafactor_squares_launch(
    const void* g, const void* row, const void* col, const void* total,
    void* sumsq, void* scratch, long long scratch_floats, int nmat, int rows,
    int cols, int bf16, int vec, float mean_div, float eps, void* stream) {
  const Grid gr = grid_of(nmat, rows, cols, bf16);
  if (gr.nblocks < 0 || !vec_ok(vec, cols, bf16, g, g) ||
      scratch_floats < gr.nblocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ss = static_cast<float*>(sumsq);
  if (gr.nblocks == 0) {
    return (int)cudaMemsetAsync(ss, 0, sizeof(float), s);
  }
  const float* r = static_cast<const float*>(row);
  const float* c = static_cast<const float*>(col);
  const float* tt = static_cast<const float*>(total);
  float* part = static_cast<float*>(scratch);
#define ADAFACTOR_SQUARES(T, V)                                              \
  run_u<T, V, false>(g, r, c, tt, part, ss, nullptr, rows, cols, gr,        \
                     mean_div, 1.f, eps, 1.f, 0.f, s)
  const cudaError_t err =
      bf16 ? (vec ? ADAFACTOR_SQUARES(__nv_bfloat16, true)
                  : ADAFACTOR_SQUARES(__nv_bfloat16, false))
           : (vec ? ADAFACTOR_SQUARES(float, true)
                  : ADAFACTOR_SQUARES(float, false));
#undef ADAFACTOR_SQUARES
  return (int)err;
}

// Pass 3: out (g's shape and type) = (u / d)·neg_lr, d = max(sqrt(*sumsq /
// count + eps) / clip, 1), count the leaf's values.
extern "C" int adafactor_apply_launch(
    const void* g, const void* row, const void* col, const void* total,
    const void* sumsq, void* out, int nmat, int rows, int cols, int bf16,
    int vec, float mean_div, float count, float eps, float clip,
    float neg_lr, void* stream) {
  const Grid gr = grid_of(nmat, rows, cols, bf16);
  if (gr.nblocks < 0 || !vec_ok(vec, cols, bf16, g, out))
    return (int)cudaErrorInvalidValue;
  if (gr.nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(row);
  const float* c = static_cast<const float*>(col);
  const float* tt = static_cast<const float*>(total);
  float* ss = const_cast<float*>(static_cast<const float*>(sumsq));
#define ADAFACTOR_APPLY(T, V)                                                \
  run_u<T, V, true>(g, r, c, tt, nullptr, ss, out, rows, cols, gr, mean_div, \
                    count, eps, clip, neg_lr, s)
  const cudaError_t err =
      bf16 ? (vec ? ADAFACTOR_APPLY(__nv_bfloat16, true)
                  : ADAFACTOR_APPLY(__nv_bfloat16, false))
           : (vec ? ADAFACTOR_APPLY(float, true) : ADAFACTOR_APPLY(float, false));
#undef ADAFACTOR_APPLY
  return (int)err;
}

// The whole form's pass 2 on count values of g: v_new = β·v_old + (1 −
// β)·g2 (count f32 values each) and *sumsq = Σ u².
extern "C" int adafactor_full_squares_launch(
    const void* g, const void* v_old, void* v_new, void* sumsq, void* scratch,
    long long scratch_floats, long long count, int bf16, float beta,
    float one_minus, float eps, void* stream) {
  const long long nblocks = full_blocks(count);
  if (count < 0 || nblocks > 0x7fffffffLL || scratch_floats < nblocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ss = static_cast<float*>(sumsq);
  if (nblocks == 0) {
    return (int)cudaMemsetAsync(ss, 0, sizeof(float), s);
  }
  const float* vo = static_cast<const float*>(v_old);
  float* vn = static_cast<float*>(v_new);
  float* part = static_cast<float*>(scratch);
  const cudaError_t err =
      bf16 ? run_full<__nv_bfloat16, false>(g, vo, vn, part, nullptr,
                                            nullptr, count, nblocks, 1.f,
                                            beta, one_minus, eps, 1.f, 0.f, s)
           : run_full<float, false>(g, vo, vn, part, nullptr, nullptr, count,
                                    nblocks, 1.f, beta, one_minus, eps, 1.f,
                                    0.f, s);
  if (err != cudaSuccess) return (int)err;
  adafactor_sum<<<1, kReduceThreads, 0, s>>>(part, (int)nblocks, ss);
  return (int)cudaGetLastError();
}

// The whole form's pass 3: out from v_new and d, total_count the leaf's
// values.
extern "C" int adafactor_full_apply_launch(const void* g, const void* v_new,
                                           const void* sumsq, void* out,
                                           long long count, int bf16,
                                           float total_count, float eps,
                                           float clip, float neg_lr,
                                           void* stream) {
  const long long nblocks = full_blocks(count);
  if (count < 0 || nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* vn = const_cast<float*>(static_cast<const float*>(v_new));
  const float* ss = static_cast<const float*>(sumsq);
  return (int)(bf16 ? run_full<__nv_bfloat16, true>(
                          g, nullptr, vn, nullptr, ss, out, count, nblocks,
                          total_count, 0.f, 0.f, eps, clip, neg_lr, s)
                    : run_full<float, true>(g, nullptr, vn, nullptr, ss, out,
                                            count, nblocks, total_count, 0.f,
                                            0.f, eps, clip, neg_lr, s));
}
