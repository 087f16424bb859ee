// moe_dispatch: the MoE layer's dispatch (each kept (token, choice) pair's
// row into its expert slot) and combine (the slots' rows back into their
// tokens, weighted by the gate), each the other's backward.
//
// Replaces no TPU kernel: the reference's dispatch and combine
// (src/repro/models/moe.py) are jnp scatters and gathers that XLA fuses.
// The port's plain version (kernels/ref.py: moe_dispatch_ref,
// moe_combine_ref) takes one choice at a time: an index_put_ of the whole
// (Ng, D) group into a zero-filled buffer with dump rows, and for the
// combine a gather, a product and a sum over (Ng, D) a choice. Every pass
// moves every pair, the dropped ones too (through the dump rows), and its
// autograd backward moves more again.
//
// What it computes. G groups of Ng tokens, k choices a token, `slots`
// (H·C) expert slots a group, rows of D values of T (bf16 or f32). dest
// (G, Ng, k) int64 is each pair's slot and keep (G, Ng, k) its flag; kept
// slots are unique within a group (models/moe.py: dispatch_slots), so no
// sum runs over atomics. A pair q = t·k + j.
//   moe_slot_map      src[g, dest[g, q]] = q for every kept pair; src starts
//                     at −1 (cudaMemsetAsync), an empty slot
//   moe_slot_gather   out[g, s] = src < 0 ? 0 : w·in[g, src / k]
//                       the dispatch:          in = x, w = 1 (a copy)
//                       the combine's backward: in = dy, w = T(gate_w[src]),
//                       and dw[g, src] = Σ_d obuf[g, s, d]·dy[g, t, d]
//   moe_token_reduce  y[g, t] = Σ_{kept j} w_j·in[g, dest[g, t, j]]
//                       the combine:           in = the experts' output,
//                       w_j = T(gate_w), the plain version's rounding chain
//                       the dispatch's backward: in = d(expert buffer),
//                       w = 1, summed in f32 and rounded once
//
// What bounds it on the H100: bytes. At Granite's cut (Ng 32768, k 10, D
// 4096 bf16, 18 of 72 experts held: 102528 slots, about 81900 kept pairs)
// the dispatch reads the kept rows (671 MB) and writes the slots (840 MB),
// 0.45 ms at 3.35 TB/s; the combine reads the kept rows and writes y (268
// MB), 0.28 ms. A dropped pair moves no row.
//
// What the design does about it:
//  * One block a row (a slot's or a token's); each thread takes 16-byte
//    loads and stores of the row, a stride of the block apart. A token's
//    pair metadata is read once, into shared memory.
//  * Numerics: the combine repeats the plain version's chain, p =
//    T(f32(row)·f32(w_j)), y = T(f32(y) + f32(p)) in choice order, a dropped
//    pair adding +0, so its output is bitwise the plain version's (the _rn
//    intrinsics, which nvcc never contracts into an FMA). The combine's
//    backward writes d(expert output) = T(f32(dy)·f32(w)), bitwise the
//    plain version's too; dw and the dispatch's backward sum in f32 and
//    round once, where the plain version rounds each term to T.
//  * Determinism: no atomics; each kept slot has one pair and each pair at
//    most one slot; dw's sum over a row is a fixed tree (each thread's
//    values in order, a warp's butterfly, then the warps in order). The
//    grid depends on the shapes alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 128;  // a block: one row
constexpr int kWarps = kThreads / 32;
constexpr int kMapThreads = 256;
constexpr int kMaxK = 1024;  // choices a token (shared memory: 12 B each)
constexpr int kMaxGroups = 65535;

typedef __nv_bfloat16 bf16;

// values of T in one 16-byte load
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<bf16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, as a float
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&f)[Vec<T>::n]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) f[i] = to_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&f)[Vec<T>::n]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) e[i] = from_f32<T>(f[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

// src[g, dest[g, q]] = q for every kept pair q of group g (blockIdx.y).
__global__ void __launch_bounds__(kMapThreads)
    moe_slot_map(const long long* __restrict__ dest,
                 const unsigned char* __restrict__ keep, int* __restrict__ src,
                 long long pairs, long long slots) {
  const long long q = (long long)blockIdx.x * kMapThreads + threadIdx.x;
  if (q >= pairs) return;
  const long long g = blockIdx.y;
  const long long at = g * pairs + q;
  const long long d = dest[at];
  if (keep[at] && d >= 0 && d < slots) src[g * slots + d] = (int)q;
}

// Row blockIdx.x of group blockIdx.y's slots: out = src < 0 ? 0 : w·in[t]
// (kGrad false: w = 1, a copy of the bits). kGrad: w = T(gate_w[pair]) and
// dw[pair] = Σ_d obuf[row, d]·in[t, d].
template <typename T, bool kGrad>
__global__ void __launch_bounds__(kThreads)
    moe_slot_gather(const T* __restrict__ in, const int* __restrict__ src,
                    const float* __restrict__ gate_w,
                    const T* __restrict__ obuf, T* __restrict__ out,
                    float* __restrict__ dw, long long ntok, int k,
                    long long slots, int vecs) {
  constexpr int V = Vec<T>::n;
  const long long g = blockIdx.y;
  const long long row = g * slots + blockIdx.x;
  const long long D = (long long)vecs * V;
  T* o = out + row * D;
  const int q = src[row];
  if (q < 0) {  // an empty slot: the whole block leaves here
    for (int v = threadIdx.x; v < vecs; v += kThreads)
      *reinterpret_cast<uint4*>(o + (long long)v * V) = make_uint4(0, 0, 0, 0);
    return;
  }
  const T* x = in + (g * ntok + q / k) * D;
  if (!kGrad) {
    for (int v = threadIdx.x; v < vecs; v += kThreads)
      *reinterpret_cast<uint4*>(o + (long long)v * V) =
          __ldg(reinterpret_cast<const uint4*>(x + (long long)v * V));
    return;
  }
  const long long pair = g * ntok * k + q;
  const float w = rnd<T>(gate_w[pair]);
  const T* b = obuf + row * D;
  float part = 0.f;
  for (int v = threadIdx.x; v < vecs; v += kThreads) {
    float dy[V], ob[V], d[V];
    load16(x + (long long)v * V, dy);
    load16(b + (long long)v * V, ob);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      d[i] = __fmul_rn(dy[i], w);
      part = __fmaf_rn(ob[i], dy[i], part);
    }
    store16(o + (long long)v * V, d);
  }
  // the row's sum: a warp's butterfly, then the warps in order
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, m));
  __shared__ float warp_sum[kWarps];
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = warp_sum[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) s = __fadd_rn(s, warp_sum[i]);
    dw[pair] = s;
  }
}

// Token blockIdx.x of group blockIdx.y: y = Σ_{kept j} w_j·in[dest_j].
// kChain: w_j = T(gate_w), p = T(f32(row)·w_j), y = T(y + p) in choice
// order, a dropped pair adding +0 (the plain version's chain). Else w = 1,
// summed in f32 and rounded once.
template <typename T, bool kChain>
__global__ void __launch_bounds__(kThreads)
    moe_token_reduce(const T* __restrict__ in,
                     const long long* __restrict__ dest,
                     const unsigned char* __restrict__ keep,
                     const float* __restrict__ gate_w, T* __restrict__ y,
                     long long ntok, int k, long long slots, int vecs) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* slot = reinterpret_cast<long long*>(smem);
  float* wt = reinterpret_cast<float*>(slot + k);
  const long long g = blockIdx.y;
  const long long tok = g * ntok + blockIdx.x;
  const long long D = (long long)vecs * V;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const long long at = tok * k + j;
    const long long d = dest[at];
    slot[j] = keep[at] && d >= 0 && d < slots ? g * slots + d : -1;
    wt[j] = kChain ? rnd<T>(gate_w[at]) : 1.f;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < vecs; v += kThreads) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int j = 0; j < k; ++j) {
      const long long s = slot[j];
      if (s < 0) {
        if (kChain) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], 0.f);
        }
        continue;
      }
      float r[V];
      load16(in + s * D + (long long)v * V, r);
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[i] = kChain ? rnd<T>(__fadd_rn(acc[i],
                                           rnd<T>(__fmul_rn(r[i], wt[j]))))
                        : __fadd_rn(acc[i], r[i]);
    }
    store16(y + tok * D + (long long)v * V, acc);
  }
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

struct Geo {
  int G;
  long long ntok;  // tokens a group
  int k;
  long long slots;  // expert slots a group
  int vecs;         // 16-byte vectors a row
};

// the launchers' shapes, or vecs = −1 where the kernels do not take them
Geo geo_of(int G, long long ntok, int k, long long slots, int D,
           int is_bf16) {
  const int V = is_bf16 ? Vec<bf16>::n : Vec<float>::n;
  Geo g{G, ntok, k, slots, D / V};
  if (G < 1 || G > kMaxGroups || ntok < 0 || ntok > 0x7fffffffLL || k < 1 ||
      k > kMaxK || ntok * k > 0x7fffffffLL || slots < 0 ||
      slots > 0x7fffffffLL || D < 1 || D % V != 0)
    g.vecs = -1;
  return g;
}

#define MOE_CHECK(expr)            \
  do {                             \
    const int e_ = (int)(expr);    \
    if (e_ != 0) return e_;        \
  } while (0)

// src = −1, then the kept pairs' slots
int slot_map(const long long* dest, const unsigned char* keep, int* src,
             const Geo& g, cudaStream_t s) {
  MOE_CHECK(cudaMemsetAsync(src, 0xff, sizeof(int) * g.slots * g.G, s));
  const long long pairs = g.ntok * g.k;
  if (pairs == 0 || g.slots == 0) return 0;
  const unsigned nb = (unsigned)((pairs + kMapThreads - 1) / kMapThreads);
  moe_slot_map<<<dim3(nb, g.G), kMapThreads, 0, s>>>(dest, keep, src, pairs,
                                                     g.slots);
  return (int)cudaGetLastError();
}

template <typename T, bool kGrad>
int slot_gather(const void* in, const int* src, const float* gate_w,
                const void* obuf, void* out, float* dw, const Geo& g,
                cudaStream_t s) {
  if (g.slots == 0) return 0;
  moe_slot_gather<T, kGrad><<<dim3((unsigned)g.slots, g.G), kThreads, 0, s>>>(
      static_cast<const T*>(in), src, gate_w, static_cast<const T*>(obuf),
      static_cast<T*>(out), dw, g.ntok, g.k, g.slots, g.vecs);
  return (int)cudaGetLastError();
}

template <typename T, bool kChain>
int token_reduce(const void* in, const long long* dest,
                 const unsigned char* keep, const float* gate_w, void* y,
                 const Geo& g, cudaStream_t s) {
  if (g.ntok == 0) return 0;
  const size_t smem = (size_t)g.k * (sizeof(long long) + sizeof(float));
  moe_token_reduce<T, kChain><<<dim3((unsigned)g.ntok, g.G), kThreads, smem,
                                 s>>>(
      static_cast<const T*>(in), dest, keep, gate_w, static_cast<T*>(y),
      g.ntok, g.k, g.slots, g.vecs);
  return (int)cudaGetLastError();
}

}  // namespace

// The dispatch. x (G, ntok, D) and out (G, slots, D) in T (bf16 where
// is_bf16 is nonzero, else f32), 16-byte aligned; dest (G, ntok, k) int64, keep
// (G, ntok, k) bool; src (G, slots) int32 scratch. Writes out: each kept
// pair's x row at its slot, zeros at the empty slots.
extern "C" int moe_dispatch_launch(const void* x, const void* dest,
                                   const void* keep, void* src, void* out,
                                   int G, long long ntok, int k,
                                   long long slots, int D, int is_bf16,
                                   void* stream) {
  const Geo g = geo_of(G, ntok, k, slots, D, is_bf16);
  if (g.vecs < 0 || !aligned16({x, out})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* d = static_cast<const long long*>(dest);
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  int* sm = static_cast<int*>(src);
  MOE_CHECK(slot_map(d, kp, sm, g, s));
  return is_bf16 ? slot_gather<bf16, false>(x, sm, nullptr, nullptr, out,
                                            nullptr, g, s)
                 : slot_gather<float, false>(x, sm, nullptr, nullptr, out,
                                             nullptr, g, s);
}

// The dispatch's backward. dout (G, slots, D) and dx (G, ntok, D) in T,
// 16-byte aligned. Writes dx[t] = Σ_{kept j} dout[dest_j], summed in f32.
extern "C" int moe_dispatch_bwd_launch(const void* dout, const void* dest,
                                       const void* keep, void* dx, int G,
                                       long long ntok, int k, long long slots,
                                       int D, int is_bf16, void* stream) {
  const Geo g = geo_of(G, ntok, k, slots, D, is_bf16);
  if (g.vecs < 0 || !aligned16({dout, dx})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* d = static_cast<const long long*>(dest);
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  return is_bf16 ? token_reduce<bf16, false>(dout, d, kp, nullptr, dx, g, s)
                 : token_reduce<float, false>(dout, d, kp, nullptr, dx, g, s);
}

// The combine. obuf (G, slots, D) and y (G, ntok, D) in T, 16-byte
// aligned; gate_w (G, ntok, k) f32. Writes y[t] = Σ_{kept j}
// T(gate_w)·obuf[dest_j] in the plain version's rounding chain.
extern "C" int moe_combine_launch(const void* obuf, const void* dest,
                                  const void* keep, const void* gate_w,
                                  void* y, int G, long long ntok, int k,
                                  long long slots, int D, int is_bf16,
                                  void* stream) {
  const Geo g = geo_of(G, ntok, k, slots, D, is_bf16);
  if (g.vecs < 0 || !aligned16({obuf, y})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* d = static_cast<const long long*>(dest);
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  const float* w = static_cast<const float*>(gate_w);
  return is_bf16 ? token_reduce<bf16, true>(obuf, d, kp, w, y, g, s)
                 : token_reduce<float, true>(obuf, d, kp, w, y, g, s);
}

// The combine's backward. dy (G, ntok, D), obuf and dobuf (G, slots, D) in
// T, 16-byte aligned; gate_w and dgate (G, ntok, k) f32; src (G, slots)
// int32 scratch. Writes dobuf[s] = T(dy[t]·T(gate_w)) (zeros at the empty
// slots), dgate at each kept pair Σ_d obuf[s, d]·dy[t, d] and 0 elsewhere.
extern "C" int moe_combine_bwd_launch(const void* dy, const void* obuf,
                                      const void* dest, const void* keep,
                                      const void* gate_w, void* src,
                                      void* dobuf, void* dgate, int G,
                                      long long ntok, int k, long long slots,
                                      int D, int is_bf16, void* stream) {
  const Geo g = geo_of(G, ntok, k, slots, D, is_bf16);
  if (g.vecs < 0 || !aligned16({dy, obuf, dobuf}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* d = static_cast<const long long*>(dest);
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  const float* w = static_cast<const float*>(gate_w);
  int* sm = static_cast<int*>(src);
  float* dw = static_cast<float*>(dgate);
  MOE_CHECK(cudaMemsetAsync(dw, 0, sizeof(float) * g.ntok * g.k * g.G, s));
  MOE_CHECK(slot_map(d, kp, sm, g, s));
  return is_bf16 ? slot_gather<bf16, true>(dy, sm, w, obuf, dobuf, dw, g, s)
                 : slot_gather<float, true>(dy, sm, w, obuf, dobuf, dw, g, s);
}
