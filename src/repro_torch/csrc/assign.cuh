// Nearest-centroid assignment shared by lloyd_update.cu, pq_quantize.cu and
// kmeans_assign.cu, so that all three pick the same code for the same row.
//
// Score form, as the TPU kernels and the plain versions compute it:
//   code = argmax_l (2·x·c_l − ‖c_l‖²)   over l with lmask[l] > 0,
// which is the argmin of ‖x − c_l‖² (‖x‖² does not depend on l). Masked
// centroids score kNeg and never win; ties go to the first index, as
// jnp.argmax and torch.argmax do. A null lmask means every centroid is
// valid. D is small (D <= 64; D = 8 and L <= 16 on the FEMNIST and serve
// paths, D <= 32 and L <= 960 on the text tasks), below any tensor-core
// tile, so the dot products are plain FMAs over a row and a codebook that
// sits in shared memory, whole or a tile at a time.
//
// Three forms of the same arithmetic: assign_row_best reads the row from
// shared memory at run-time D and L (lloyd_update's generic route),
// assign_row_reg reads it from registers at compile-time D and L (the d8
// routes), and assign_row_streamed streams a codebook of any L through
// shared memory in tiles of kLTile centroids (the generic routes of
// kmeans_assign and pq_quantize, lloyd_update's tiled route). All run k
// ascending in one fmaf chain per centroid, then 2·dot − ‖c‖² as one fmaf
// (2·dot is exact, so this is the rounding of the subtraction alone), then
// a strict > over l ascending, so they give the same code and best score
// bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include <cmath>

namespace repro_torch {

constexpr float kNeg = -1e30f;

// Odd row stride (in floats) for a tile of rows in shared memory: one thread
// per row then reads its row without bank conflicts.
__host__ __device__ __forceinline__ int row_stride(int d) { return d | 1; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Loads the (l, d) codebook and the (l,) mask (all 1 when lmask is null)
// into shared memory and computes the squared norms. Call with the whole
// block; ends with a barrier.
__device__ __forceinline__ void load_codebook(const float* __restrict__ c,
                                              const float* __restrict__ lmask,
                                              float* cs, float* cn, float* ms,
                                              int l, int d) {
  for (int e = threadIdx.x; e < l * d; e += blockDim.x) cs[e] = c[e];
  for (int e = threadIdx.x; e < l; e += blockDim.x)
    ms[e] = lmask ? lmask[e] : 1.f;
  __syncthreads();
  for (int li = threadIdx.x; li < l; li += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s = fmaf(cs[li * d + k], cs[li * d + k], s);
    cn[li] = s;
  }
  __syncthreads();
}

// Copies rows [0, rows) of a contiguous (rows, d) tile into shared memory
// as f32 with row stride row_stride(d); consecutive threads read consecutive
// elements.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* xs, int rows, int d) {
  const int stride = row_stride(d);
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x)
    xs[(e / d) * stride + e % d] = to_f32(src[e]);
}

// Folds centroids l0 .. l0 + lt − 1, held in shared memory as cs [lt][d],
// cn and ms [lt], into a row's running (best, code), l ascending, by a
// strict >: the first index of the maximum wins, and a NaN score never
// does.
__device__ __forceinline__ void assign_row_fold(const float* xr,
                                                const float* cs,
                                                const float* cn,
                                                const float* ms, int l0,
                                                int lt, int d, float* best,
                                                int* code) {
  for (int li = 0; li < lt; ++li) {
    float dot = 0.f;
    for (int k = 0; k < d; ++k) dot = fmaf(xr[k], cs[li * d + k], dot);
    float s = fmaf(2.f, dot, -cn[li]);  // 2·dot is exact: one rounding
    if (!(ms[li] > 0.f)) s = kNeg;
    if (s > *best) {
      *best = s;
      *code = l0 + li;
    }
  }
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
  assign_row_fold(xr, cs, cn, ms, 0, l, d, &best, &code);
  *best_score = best;
  return code;
}

__device__ __forceinline__ int assign_row(const float* xr, const float* cs,
                                          const float* cn, const float* ms,
                                          int l, int d) {
  float best;
  return assign_row_best(xr, cs, cn, ms, l, d, &best);
}

// ---------------------------------------------------------------------------
// Any L: the codebook streams through shared memory.
// ---------------------------------------------------------------------------

constexpr int kLTile = 64;  // centroids a tile

// A block's rows against a codebook of any L: the (l, d) codebook c and
// the (l,) lmask (null: every centroid valid) pass through cs [kLTile][d],
// cn and ms [kLTile] in tiles of kLTile centroids, each with its norms
// from load_codebook, and every thread with a row (xr not null) folds each
// tile into its running best and code. Over the tiles this is
// assign_row_best's scan, so the code and best score are bit for bit
// those of a codebook held whole. Call with the whole block; it ends with a barrier,
// after which cs may be reused.
__device__ __forceinline__ int assign_row_streamed(
    const float* xr, const float* __restrict__ c,
    const float* __restrict__ lmask, float* cs, float* cn, float* ms, int l,
    int d, float* best_score) {
  float best = -INFINITY;
  int code = 0;
  for (int l0 = 0; l0 < l; l0 += kLTile) {
    const int lt = min(kLTile, l - l0);
    load_codebook(c + (size_t)l0 * d, lmask ? lmask + l0 : nullptr, cs, cn,
                  ms, lt, d);  // ends with a barrier
    if (xr) assign_row_fold(xr, cs, cn, ms, l0, lt, d, &best, &code);
    __syncthreads();  // the next tile overwrites cs, cn and ms
  }
  *best_score = best;
  return code;
}

// assign_row's arithmetic on a row held in registers, at compile-time L and
// D, against a codebook and norms held in registers or shared memory;
// kMasked false skips the mask (every centroid valid). The scan runs over
// groups of 4 consecutive centroids, each from -inf as assign_row runs,
// and the groups' (best, code) merge left to right by the same strict >
// (the right group wins only if its best is greater): this is assign_row's
// result in every case (first index of the maximum; NaN scores never win),
// with a shorter chain of dependent compares. Where best_score is given it
// receives the winning score, assign_row_best's *best_score bit for bit.
template <int L, int D, bool kMasked>
__device__ __forceinline__ int assign_row_reg(const float (&xr)[D],
                                              const float (&cs)[L * D],
                                              const float (&cn)[L],
                                              const float* ms,
                                              float* best_score = nullptr) {
  constexpr int G = L < 4 ? L : 4;  // centroids per group
  constexpr int NG = L / G;
  static_assert(NG * G == L && (NG & (NG - 1)) == 0,
                "L must be a power of two");
  float gb[NG];
  int gc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    float best = -INFINITY;
    int code = g * G;
#pragma unroll
    for (int li = g * G; li < (g + 1) * G; ++li) {
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) dot = fmaf(xr[k], cs[li * D + k], dot);
      float s = fmaf(2.f, dot, -cn[li]);  // 2·dot is exact: one rounding
      if (kMasked && !(ms[li] > 0.f)) s = kNeg;
      if (s > best) {
        best = s;
        code = li;
      }
    }
    gb[g] = best;
    gc[g] = code;
  }
#pragma unroll
  for (int step = 1; step < NG; step *= 2)
#pragma unroll
    for (int g = 0; g + step < NG; g += 2 * step)
      if (gb[g + step] > gb[g]) {
        gb[g] = gb[g + step];
        gc[g] = gc[g + step];
      }
  if (best_score) *best_score = gb[0];
  return gc[0];
}

template <int L, int D>
__device__ __forceinline__ int assign_row_reg(const float (&xr)[D],
                                              const float (&cs)[L * D],
                                              const float (&cn)[L],
                                              const float* ms, bool masked) {
  return masked ? assign_row_reg<L, D, true>(xr, cs, cn, ms)
                : assign_row_reg<L, D, false>(xr, cs, cn, ms);
}

// ---------------------------------------------------------------------------
// Rows of 8 values in registers: one 32-byte f32 row is two 16-byte loads,
// one 16-byte bf16 row is one. The address must be 16-byte aligned.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void row8_from(const float* p, float (&r)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ void row8_from(const __nv_bfloat16* p,
                                          float (&r)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the top half of an f32: the upcast is exact
    r[2 * i] = __uint_as_float(w[i] << 16);
    r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Streaming stores (evict-first): nothing re-reads them in this kernel.
__device__ __forceinline__ void row8_store(float* p, const float (&r)[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(r[0], r[1], r[2], r[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(r[4], r[5], r[6], r[7]));
}

__device__ __forceinline__ void row8_store(__nv_bfloat16* p,
                                           const float (&r)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(r[2 * i]));
    const uint32_t hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(r[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}

}  // namespace repro_torch
