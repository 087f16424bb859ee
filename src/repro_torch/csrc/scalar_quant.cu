// scalar_quant: uniform b-bit scalar quantization and b-bit code packing for
// P problems (one per client).
//
// Replaces the TPU kernels of src/repro/kernels/scalar_quant.py:
//   _quantize_kernel / scalar_quantize_kernel (pl.pallas_call at line 49),
//   _pack_kernel / pack_codes_kernel          (pl.pallas_call at line 86),
//   _unpack_kernel / unpack_codes_kernel      (pl.pallas_call at line 111).
//
// scalar_quantize: x (P, N) f32 or bf16, lo (P,), scale (P,) f32 ->
//   codes[i] = clip(rint((x_i − lo)/scale), 0, 2^b − 1)      (int32)
//   recon[i] = lo + codes[i]·scale                           (f32)
// x is read in its own dtype and upcast in registers (exactly), as the TPU
// kernel upcasts its block: no f32 copy of x is made.
// pack_codes: codes (P, N) int32 -> words (P, W) uint32, W = ceil(N·b/32);
//   code j of a word sits at bits [j·b, (j+1)·b), little-endian, the
//   LSB-first bit stream of the wire format; b in {1, 2, 4, 8, 16}.
// unpack_codes: the inverse, words (P, W) -> codes (P, count).
//
// What bounds them on the H100: bytes. Each is one elementwise sweep with a
// handful of operations per element: scalar_quantize reads 4 (f32) or 2
// (bf16) and writes 8 bytes per value (2.2 MB on the FEMNIST chain
// downlink, 10 x 18432 f32; 335.5 MB for a Llama-3 8B cut's bf16
// gradient, 4 x 8388608), pack reads 4 bytes per code and writes b/8.
//
// What the design does about it and about the TPU original:
//  * The TPU kernels take a (1, 1) lo/scale operand for one tensor; here
//    every problem (client) has its own range, and blockIdx.y is the
//    problem, so one launch quantizes every client.
//  * scalar_quantize, route vec (every problem's values start aligned for
//    4-value loads: x's address a multiple of 4·sizeof(x), N a multiple of
//    4): a persistent grid that the caller sizes to the card (its SMs
//    times the resident blocks of the instance, shared among the problems,
//    and no more blocks than a problem fills at one load a thread: the
//    policy of the d8 grids, kernels/lloyd_update.py), a grid-stride loop in
//    which each thread moves 4 values per load (16 bytes of f32, 8 of
//    bf16) and writes the 4 codes and the 4 recon values as one 16-byte
//    streaming store each, so that a warp's store covers 512 contiguous
//    bytes. lo and scale are read once per thread. What the design runs
//    on an H100 showed (PERF.md): 8 resident blocks of 256 threads keep
//    enough bytes in flight, so issuing 2, 4 or 8 loads a thread before
//    using any gained nothing at the large shapes and lost up to 5 % at
//    the chain's small carrier; a bulk-copy ring (stream.cuh) was slower
//    at every shape; 16-byte bf16 loads (8 values a thread) leave each
//    warp store at a 32-byte stride, half of every sector, and ran far
//    slower.
//  * scalar_quantize, route scalar (ragged N, misaligned views): a
//    grid-stride loop with one value per thread per step, coalesced.
//  * The reference demands codes bitwise equal to its jnp formula, and a
//    recon that is a multiply and then an add. nvcc would contract lo +
//    q·scale into one FMA (one rounding instead of two), so the arithmetic
//    is written with the _rn intrinsics, which it never contracts, and the
//    rounding is rintf: half to even, as jnp.round and torch.round. Both
//    routes share it, so they agree bit for bit.
//  * The TPU pack kernel is a multiply-accumulate over a (BLOCK_N, 32/b)
//    tile on the VPU; here one thread builds one 32-bit word with shifts
//    and ORs, and codes past a problem's count read as 0, so each
//    problem's stream is padded to whole words without a padded copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One value's code and reconstruction, bitwise the jnp formula.
__device__ __forceinline__ void quantize_one(float v, float l0, float sc,
                                             float levels, int& code,
                                             float& rec) {
  const float t = rintf(__fdiv_rn(__fsub_rn(v, l0), sc));
  const float q = fminf(fmaxf(t, 0.f), levels);
  code = static_cast<int>(q);
  rec = __fadd_rn(l0, __fmul_rn(q, sc));
}

// 4 values of x, one load: 16 bytes of f32 or 8 of bf16 (a bf16 is the
// top half of an f32, so the upcast is exact).
__device__ __forceinline__ uint4 load4(const float* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint4 load4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16,
                    v.y & 0xffff0000u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scalar_quantize_vec(const T* __restrict__ x, const float* __restrict__ lo,
                    const float* __restrict__ scale, int* __restrict__ codes,
                    float* __restrict__ recon, int n, float levels) {
  const int p = blockIdx.y;
  const float l0 = lo[p], sc = scale[p];
  const size_t base = (size_t)p * n;
  const int nv = n / 4;  // loads of the problem
  for (int v = blockIdx.x * kThreads + threadIdx.x; v < nv;
       v += gridDim.x * kThreads) {
    const size_t o = base + 4 * (size_t)v;
    const uint4 raw = load4(x + o);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    int q[4];
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      quantize_one(__uint_as_float(w[e]), l0, sc, levels, q[e], r[e]);
    __stcs(reinterpret_cast<int4*>(codes + o),
           make_int4(q[0], q[1], q[2], q[3]));
    __stcs(reinterpret_cast<float4*>(recon + o),
           make_float4(r[0], r[1], r[2], r[3]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scalar_quantize_scalar(const T* __restrict__ x, const float* __restrict__ lo,
                       const float* __restrict__ scale,
                       int* __restrict__ codes, float* __restrict__ recon,
                       int n, float levels) {
  __shared__ float s_lo, s_scale;
  const int p = blockIdx.y;
  if (threadIdx.x == 0) {
    s_lo = lo[p];
    s_scale = scale[p];
  }
  __syncthreads();
  const float l0 = s_lo, sc = s_scale;
  const size_t base = (size_t)p * n;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    quantize_one(to_f32(x[base + i]), l0, sc, levels, codes[base + i],
                 recon[base + i]);
}

template <typename T>
cudaError_t launch_quantize(const void* x, const void* lo, const void* scale,
                            void* codes, void* recon, int p, int n,
                            float levels, int nblocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* lt = static_cast<const float*>(lo);
  const float* st = static_cast<const float*>(scale);
  int* ct = static_cast<int*>(codes);
  float* rt = static_cast<float*>(recon);
  if (nblocks > 0) {
    scalar_quantize_vec<T><<<dim3(nblocks, p), kThreads, 0, s>>>(
        xt, lt, st, ct, rt, n, levels);
  } else {
    const int bx = std::min((n + kThreads - 1) / kThreads, kMaxBlocksX);
    scalar_quantize_scalar<T><<<dim3(bx, p), kThreads, 0, s>>>(
        xt, lt, st, ct, rt, n, levels);
  }
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
pack_codes_kernel(const int* __restrict__ codes,
                  uint32_t* __restrict__ words, int n, int nwords,
                  int bits) {
  const int p = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= nwords) return;
  const int per_word = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const int* src = codes + (size_t)p * n;
  uint32_t word = 0;
  for (int j = 0, i = w * per_word; j < per_word; ++j, ++i)
    if (i < n) word |= (static_cast<uint32_t>(src[i]) & mask) << (j * bits);
  words[(size_t)p * nwords + w] = word;
}

__global__ void __launch_bounds__(kThreads)
unpack_codes_kernel(const uint32_t* __restrict__ words,
                    int* __restrict__ codes, int count, int nwords,
                    int bits) {
  const int p = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= nwords) return;
  const int per_word = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const uint32_t word = words[(size_t)p * nwords + w];
  int* dst = codes + (size_t)p * count;
  for (int j = 0, i = w * per_word; j < per_word && i < count; ++j, ++i)
    dst[i] = static_cast<int>((word >> (j * bits)) & mask);
}

bool packable(int bits) {
  return bits == 1 || bits == 2 || bits == 4 || bits == 8 || bits == 16;
}

}  // namespace

// Resident blocks per SM of the vec instance for bf16 (1) or f32 (0), for
// the caller's grid.
extern "C" int scalar_quantize_vec_occupancy(int bf16) {
  const void* k =
      bf16 ? reinterpret_cast<const void*>(scalar_quantize_vec<__nv_bfloat16>)
           : reinterpret_cast<const void*>(scalar_quantize_vec<float>);
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return blocks;
}

// route 1 = vec (x's address a multiple of 4·sizeof(x), n of 4; nblocks
// blocks per problem, at least 1), 0 = scalar (nblocks unused); bf16 1 = x
// holds bf16 values, 0 = f32.
extern "C" int scalar_quantize_launch(const void* x, const void* lo,
                                      const void* scale, void* codes,
                                      void* recon, int p, int n, int bits,
                                      int route, int bf16, int nblocks,
                                      void* stream) {
  if (p == 0 || n == 0) return 0;
  if (bits < 1 || bits > 16) return (int)cudaErrorInvalidValue;
  const int size = bf16 ? 2 : 4;
  const bool vec = route == 1;
  if (vec && (reinterpret_cast<uintptr_t>(x) % (4 * size) != 0 || n % 4 ||
              nblocks < 1))
    return (int)cudaErrorInvalidValue;
  const float levels = static_cast<float>((1 << bits) - 1);
  const int nb = vec ? nblocks : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_quantize<__nv_bfloat16>(x, lo, scale, codes,
                                                     recon, p, n, levels,
                                                     nb, s)
                    : launch_quantize<float>(x, lo, scale, codes, recon, p,
                                             n, levels, nb, s));
}

extern "C" int pack_codes_launch(const void* codes, void* words, int p,
                                 int n, int nwords, int bits, void* stream) {
  if (p == 0 || nwords == 0) return 0;
  if (!packable(bits)) return (int)cudaErrorInvalidValue;
  const dim3 grid((nwords + kThreads - 1) / kThreads, p);
  pack_codes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), static_cast<uint32_t*>(words), n,
      nwords, bits);
  return (int)cudaGetLastError();
}

extern "C" int unpack_codes_launch(const void* words, void* codes, int p,
                                   int count, int nwords, int bits,
                                   void* stream) {
  if (p == 0 || nwords == 0) return 0;
  if (!packable(bits)) return (int)cudaErrorInvalidValue;
  const dim3 grid((nwords + kThreads - 1) / kThreads, p);
  unpack_codes_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int*>(codes), count,
      nwords, bits);
  return (int)cudaGetLastError();
}
