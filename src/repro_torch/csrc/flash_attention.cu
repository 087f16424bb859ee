// flash_attention: causal grouped-query attention, forward only, with an
// optional sliding window, for P = B·H query rows of S positions.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// _flash_kernel / flash_attention (pl.pallas_call at line 104).
//
// For every query row bh (KV row (bh / H)·Kv + (bh % H) / G, G = H / Kv)
// and position i:
//   s_ij = (q_i · k_j)·scale        kept iff j <= i and (window <= 0 or
//                                   i − j < window), else −1e30
//   o_i  = Σ_j softmax(s_i)_j · v_j
// q (B·H, S, hd), k and v (B·Kv, S, hd), o like q; f32 or bf16; hd <= 128;
// any S. Scores, the online softmax (running max m, running sum l) and the
// accumulator are f32; the output is acc / max(l, 1e-30) in the input type.
//
// What bounds it on the H100: operations. At the Llama-3 8B prefill
// (B·H = 128, S = 2048, hd = 128, bf16) it does 1.4e11 FLOP on 168 MB, far
// above the card's balance point. On the bf16 tensor cores that is 139 us;
// this kernel computes in f32 on the CUDA cores (2.05 ms at their peak), to
// keep the reference's f32 numerics: the tensor-core redesign is later
// work.
//
// What the design does about it and about the TPU original:
//  * The TPU kernel's grid runs its last axis (KV blocks) in order and
//    carries m, l and acc in VMEM scratch from one grid step to the next.
//    CUDA blocks run in no order, so here one block owns one (bh, tile of
//    64 query rows) and walks the KV tiles in a loop, carrying m, l and acc
//    in registers: each of the 256 threads owns 4 query rows (ty + 16·i)
//    and, of the accumulator, the columns tx + 16·j.
//  * Q, K and V tiles are converted to f32 in shared memory (about 113 KB
//    at hd = 128, dynamic shared memory); rows are padded to hd + 1 floats
//    so that the 16 threads of a row group read 16 different banks.
//  * The 64 x 64 score tile is computed with FMAs, 4 x 4 scores a thread;
//    a row's max and sum are reduced across its 16 threads with shuffles.
//    The probabilities go through shared memory to the P·V product.
//  * Masking is by index, so the ragged last tile needs no padded copy.
//    KV tiles that are wholly masked for every row of the block (past the
//    diagonal, or before the window) are skipped; a masked score adds an
//    exact 0, so the output is unchanged.
//  * Blocks are launched from the last query tile down: the longest rows
//    start first and the short ones fill the tail.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kRows = 4;        // query rows per thread: ty + 16·i
constexpr int kCols = 4;        // keys per thread in a score tile: tx + 16·j
constexpr int kPStride = kTile + 1;
constexpr int kMaxHd = 128;
constexpr int kNJ = kMaxHd / 16;  // accumulator columns per thread: tx + 16·j
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

// rows [0, valid) of a (kTile, hd) tile into shared memory as f32 with the
// given row stride; rows past `valid` become 0
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* dst, int valid, int hd,
                                          int stride, int tx, int ty) {
  for (int r = ty; r < kTile; r += 16) {
    for (int c = tx; c < hd; c += 16) {
      dst[r * stride + c] = r < valid ? to_f32(src[(size_t)r * hd + c]) : 0.f;
    }
  }
}

__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ bool keep(int qpos, int kpos, int s, int window) {
  return kpos <= qpos && kpos < s && (window <= 0 || qpos - kpos < window);
}

// one instance per dtype serves every hd <= kMaxHd: columns d >= hd are
// guarded in the P·V product and the store
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int s,
                       int hd, int h, int kvh, float scale, int window) {
  extern __shared__ float smem[];
  const int stride = hd + 1;
  float* qs = smem;                      // [kTile][hd + 1]
  float* ks = qs + kTile * stride;       // [kTile][hd + 1]
  float* vs = ks + kTile * stride;       // [kTile][hd]
  float* ps = vs + kTile * hd;           // [kTile][kPStride]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int kvrow = (bh / h) * kvh + (bh % h) / (h / kvh);
  const T* kg = k + (size_t)kvrow * s * hd;
  const T* vg = v + (size_t)kvrow * s * hd;

  load_tile(q + ((size_t)bh * s + q0) * hd, qs, min(kTile, s - q0), hd,
            stride, tx, ty);

  float m[kRows], l[kRows], acc[kRows][kNJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  }

  const int last_q = min(q0 + kTile, s) - 1;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kTile : 0;
  const int kt_end = last_q / kTile;
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile(kg + (size_t)k0 * hd, ks, min(kTile, s - k0), hd, stride, tx,
              ty);
    load_tile(vg + (size_t)k0 * hd, vs, min(kTile, s - k0), hd, hd, tx, ty);
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * stride + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * stride + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        sc[i][j] = keep(qpos, kpos, s, window) ? sc[i][j] * scale : kNeg;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(rmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p =
            keep(qpos, kpos, s, window) ? expf(sc[i][j] - m_new) : 0.f;
        rsum += p;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + row_sum16(rsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kTile; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < hd ? vs[c * hd + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * s + qpos) * hd;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(acc[i][j] / den, orow + d);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int hd, int h, int kvh, float scale, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * kTile * (hd + 1) +
                                       (size_t)kTile * hd +
                                       (size_t)kTile * kPStride);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(bh, (s + kTile - 1) / kTile);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, hd, h, kvh, scale,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// window <= 0: no window; is_bf16: 0 for f32 tensors, 1 for bf16
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int s,
                                      int hd, int h, int kvh, float scale,
                                      int window, int is_bf16,
                                      void* stream) {
  if (bh == 0 || s == 0) return 0;
  if (hd < 1 || hd > kMaxHd || h < 1 || kvh < 1 || h % kvh != 0 ||
      bh % h != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, bh, s, hd, h, kvh, scale,
                                         window, st)
                 : launch<float>(q, k, v, o, bh, s, hd, h, kvh, scale, window,
                                 st);
}
