// scalar_quant: uniform b-bit scalar quantization and b-bit code packing for
// P problems (one per client).
//
// Replaces the TPU kernels of src/repro/kernels/scalar_quant.py:
//   _quantize_kernel / scalar_quantize_kernel (pl.pallas_call at line 49),
//   _pack_kernel / pack_codes_kernel          (pl.pallas_call at line 86),
//   _unpack_kernel / unpack_codes_kernel      (pl.pallas_call at line 111).
//
// scalar_quantize: x (P, N) f32, lo (P,), scale (P,) f32 ->
//   codes[i] = clip(rint((x_i − lo)/scale), 0, 2^b − 1)      (int32)
//   recon[i] = lo + codes[i]·scale                           (f32)
// pack_codes: codes (P, N) int32 -> words (P, W) uint32, W = ceil(N·b/32);
//   code j of a word sits at bits [j·b, (j+1)·b), little-endian, the
//   LSB-first bit stream of the wire format; b in {1, 2, 4, 8, 16}.
// unpack_codes: the inverse, words (P, W) -> codes (P, count).
//
// What bounds them on the H100: bytes. Each is one elementwise sweep with a
// handful of operations per element: scalar_quantize reads 4 and writes 8
// bytes per value (2.2 MB on the FEMNIST chain downlink, 10 x 18432), pack
// reads 4 bytes per code and writes b/8.
//
// What the design does about it and about the TPU original:
//  * The TPU kernels take a (1, 1) lo/scale operand for one tensor; here
//    every problem (client) has its own range, read once per block into
//    shared memory, and blockIdx.y is the problem, so one launch quantizes
//    every client.
//  * scalar_quantize is a grid-stride loop with coalesced loads and stores.
//    The reference demands codes bitwise equal to its jnp formula, and a
//    recon that is a multiply and then an add. nvcc would contract lo +
//    q·scale into one FMA (one rounding instead of two), so the arithmetic
//    is written with the _rn intrinsics, which it never contracts, and the
//    rounding is rintf: half to even, as jnp.round and torch.round.
//  * The TPU pack kernel is a multiply-accumulate over a (BLOCK_N, 32/b)
//    tile on the VPU; here one thread builds one 32-bit word with shifts
//    and ORs, and codes past a problem's count read as 0, so each
//    problem's stream is padded to whole words without a padded copy.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

__global__ void __launch_bounds__(kThreads)
scalar_quantize_kernel(const float* __restrict__ x,
                       const float* __restrict__ lo,
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
       i += gridDim.x * kThreads) {
    const float t = rintf(__fdiv_rn(__fsub_rn(x[base + i], l0), sc));
    const float q = fminf(fmaxf(t, 0.f), levels);
    codes[base + i] = static_cast<int>(q);
    recon[base + i] = __fadd_rn(l0, __fmul_rn(q, sc));
  }
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

extern "C" int scalar_quantize_launch(const void* x, const void* lo,
                                      const void* scale, void* codes,
                                      void* recon, int p, int n, int bits,
                                      void* stream) {
  if (p == 0 || n == 0) return 0;
  if (bits < 1 || bits > 16) return (int)cudaErrorInvalidValue;
  const int bx = std::min((n + kThreads - 1) / kThreads, kMaxBlocksX);
  scalar_quantize_kernel<<<dim3(bx, p), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(lo),
      static_cast<const float*>(scale), static_cast<int*>(codes),
      static_cast<float*>(recon), n, static_cast<float>((1 << bits) - 1));
  return (int)cudaGetLastError();
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
