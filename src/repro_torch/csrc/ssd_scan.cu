// ssd_scan: the Mamba-2 SSD chunked scan (state-space duality,
// arXiv:2405.21060 §7), forward and backward, with every (Cs x Cs) quantity
// kept on chip.
//
// Replaces no TPU kernel: the reference's scan (src/repro/models/ssm.py)
// is jnp that XLA fuses. The port's plain version (models/ssm.py:
// _plain_scan) is a chunk loop of eager PyTorch that builds each chunk's
// decay L[i,j] = exp(cum_i − cum_j) as a (B, H, Cs, Cs) f32 tensor in four
// full passes (diff, where, exp, cast), multiplies it by C·Bᵀ and runs the
// inter-chunk einsums: some 2.5 GB of device traffic a chunk forward at
// Granite's (8, 128, 256, 256), about twice that backward.
//
// What it computes, per batch row b, head h and chunk c of Cs positions
// (x (B, S, H, P), B and C (B, S, N) one group shared by the heads, dt
// (B, S, H) and A (H,) f32; P = 64, N = 64 or 128):
//   cum_i   = Σ_{t≤i} dt_t·A                        (f32, in the chunk)
//   y_i     = Σ_{j≤i} (C_i·B_j)·exp(cum_i − cum_j)·dt_j·x_j
//             + exp(cum_i)·C_i·h_c                  (f32 sums, y in bf16)
//   h_{c+1} = exp(cum_E)·h_c + Σ_j exp(cum_E − cum_j)·dt_j·x_j ⊗ B_j
// from h_0 = h0 (or 0), in f32; E the chunk's last position. The backward
// takes dy and the gradient of the final state and gives dx, ddt, dA, dB,
// dC and dh0, with the reverse recurrence dh_c = exp(cum_E)·dh_{c+1} +
// Σ_i exp(cum_i)·dy_i ⊗ C_i carried in f32. The decay's gradient is
//   ∂L/∂cum_k = Σ_j Q[k][j] − Σ_i Q[i][k] + exp(cum_k)·dy_k·(C_k·h_c) − u_k
//               (+ Σ_j u_j + exp(cum_E)·⟨dh_{c+1}, h_c⟩ at k = E)
// with Q[i][j] = (dy_i·x_j)·(C_i·B_j)·exp(cum_i − cum_j)·dt_j in f32 and
// u_j = dt_j·exp(cum_E − cum_j)·x_j·(dh_{c+1} B_j): each Q[i][j] enters its
// row and its column as the same f32 value, so in Σ_{k≥t} ∂L/∂cum_k it
// cancels to f32 rounding wherever i and j lie on one side of t (the sum
// is small where the terms are large; a bf16 rounding of either side would
// not cancel).
//
// Kernels, in launch order (forward: ssd_fwd_launch; backward:
// ssd_bwd_launch):
//   ssd_cumsum        cum (B, H, nc, Cs) f32
//   ssd_cb            C·Bᵀ per (b, c), f32, and its transpose, lower tiles
//   ssd_state_pass    per (b, h), over the chunks in order: each chunk's
//                     state as a (P x Cs)·(Cs x N) product, the carried h
//                     in f32 registers, the entry states (B, nc, H, P, N)
//                     f32 kept for the backward and the output. Backward:
//                     the same kernel in reverse gives dh (the gradient
//                     leaving each chunk), dh0 and exp(cum_E)·⟨dh, h_c⟩
//   ssd_output        per (b, c, h): y, written into its (B, S, H, P) place
//   ssd_bwd_inter     per (b, c, 64 rows), over the heads in order: dC's
//                     and dB's parts through the states (sums over heads)
//   ssd_bwd_dcb       per (b, c, 64 x 64 tile), over the heads in order:
//                     Σ_h L·dt·(dy·xᵀ), the gradient of C·Bᵀ, and its
//                     transpose
//   ssd_bwd_chunk     per (b, c, h): dx, ddt, and the head's dA partial
//   ssd_bwd_bc        per (b, c, 64 rows): dC and dB
//   ssd_da_sum        dA: the partials over (b, c), in order
//
// What bounds it on the H100: bytes. Per layer forward at Granite's shape
// the products are about 0.2 TFLOP (0.2 ms at 989 TFLOP/s), while x and y
// are 537 MB each and the entry states 537 MB in f32. The design keeps the
// (Cs x Cs) decay, C·Bᵀ·L and their gradients in registers: each element
// of S = (C·Bᵀ)∘L∘dt is made where a warp needs it as an mma operand.
//
// What the design does about it:
//  * The products are mma.sync m16n8k16 with bf16 operands and f32
//    accumulators; operands come from shared memory through ldmatrix
//    (rows padded by 8 values, so the eight rows of a load hit distinct
//    banks), or are built in registers (S, Mᵀ, the gradient of C·Bᵀ).
//  * C·Bᵀ is computed once per (b, c) and read by the 128 heads' blocks
//    from L2, not recomputed per head (128 x its products); a warp loads
//    the next k-step's (C·Bᵀ) operands while it multiplies this one's.
//  * Tiles reach shared memory by cp.async (16 bytes a copy, all in flight
//    at once, the states' f32 tiles kBatch loads a thread at a time); the
//    copies one load at a time through registers left the scan about
//    twice as slow (an H100 at Granite's shape: forward 4.8 ms, not 2.5).
//  * The chunk recurrence runs in one block per (b, h) that keeps the state
//    (64 x 128 f32) in registers across the chunks; the chunk's state
//    product accumulates onto exp(cum_E)·h.
//  * Sums over the heads (dB, dC, the gradient of C·Bᵀ) are loops over the
//    heads inside a block, in order; dA's sums over positions are a warp's
//    fixed tree and a fixed-order loop over per-(b, c) partials. No
//    atomics: two launches on the same inputs give the same bits.
//  * Row groups of 16 are dealt to the 4 warps in a snake (0 1 2 3 3 2 1 0
//    ...), so each warp gets the same share of the causal products.
//  * Numerics: the decay, the carried state and every sum stay in f32; the
//    operands of the products are rounded to bf16 once (S, x, C, B, dy,
//    the states as operands, as the plain version rounds h for C·h);
//    exp(cum_i − cum_j) ≤ 1 inside the products uses __expf, the decays
//    that scale f32 sums use expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kP = 64;          // head dim
constexpr int kT = 64;          // rows of a tile
constexpr int kThreads = 128;   // 4 warps
constexpr int kMaxCs = 256;
constexpr int kLdP = kP + 8;    // smem row stride of a (rows, P) bf16 tile
// ssd_bwd_chunk's column sums of Q, (Cs / 16) x Cs f32, fit in the space of
// its two (P, N + 8) bf16 tiles at N = 64
static_assert(kMaxCs / 16 * kMaxCs * 4 <= 2 * kP * (64 + 8) * 2,
              "column sums overflow their shared memory");

struct Geo {
  int B, S, H, Cs, nc;
  long long sb, ss;  // B's and C's batch and position strides (elements)
};

// --- mma and fragments ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a·b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf(const bf16* p) {
  return __bfloat162float(*p);
}

// A (16 x 16 at m0, k0) of a row-major [m][k] tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int m0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm4(a, s + (m0 + (q & 1) * 8 + r) * ld + k0 + (q >> 1) * 8);
}

// A (16 x 16 at m0, k0) of a [k][m] tile
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* s,
                                         int ld, int m0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm4t(a, s + (k0 + (q >> 1) * 8 + r) * ld + m0 + (q & 1) * 8);
}

// B of the n-tiles n0 and n0 + 8 at k0 (b[0], b[1] the first's; b[2], b[3]
// the second's) of an [n][k] tile
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* s,
                                       int ld, int n0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm4(b, s + (n0 + (q >> 1) * 8 + r) * ld + k0 + (q & 1) * 8);
}

// the same of a [k][n] tile
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4], const bf16* s,
                                         int ld, int n0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm4t(b, s + (k0 + (q & 1) * 8 + r) * ld + n0 + (q >> 1) * 8);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// A (16 x 16 at k0) of a bf16 row-major matrix in device memory; p at the
// tile's first row, ld its row stride
__device__ __forceinline__ void frag_a_global(uint32_t (&a)[4], const bf16* p,
                                              long long ld, int k0,
                                              int lane) {
  const bf16* r0 = p + (long long)(lane >> 2) * ld + k0 + 2 * (lane & 3);
  const bf16* r1 = r0 + 8 * ld;
  a[0] = ldg32(r0);
  a[1] = ldg32(r1);
  a[2] = ldg32(r0 + 8);
  a[3] = ldg32(r1 + 8);
}

// the same of an f32 matrix, rounded to bf16
__device__ __forceinline__ void frag_a_global_f32(uint32_t (&a)[4],
                                                  const float* p, int ld,
                                                  int k0, int lane) {
  const float* r0 = p + (long long)(lane >> 2) * ld + k0 + 2 * (lane & 3);
  const float* r1 = r0 + 8 * ld;
  const float2 v0 = *reinterpret_cast<const float2*>(r0);
  const float2 v1 = *reinterpret_cast<const float2*>(r1);
  const float2 v2 = *reinterpret_cast<const float2*>(r0 + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(r1 + 8);
  a[0] = pack(v0.x, v0.y);
  a[1] = pack(v1.x, v1.y);
  a[2] = pack(v2.x, v2.y);
  a[3] = pack(v3.x, v3.y);
}

// --- tiles ------------------------------------------------------------------

// rows [0, rows) x cols (a multiple of 8) of src (row stride sld) into s
// (row stride ld) by asynchronous 16-byte copies; rows [rows, rows_pad)
// zeroed. The copies land after async_wait() (then a barrier for the
// block's other threads).
__device__ void load_tile(bf16* s, int ld, const bf16* src, long long sld,
                          int rows, int rows_pad, int cols) {
  const int per = cols / 8;
  for (int idx = threadIdx.x; idx < rows_pad * per; idx += blockDim.x) {
    const int r = idx / per, c = (idx % per) * 8;
    const bool valid = r < rows;
    const bf16* from = valid ? src + (long long)r * sld + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(s + r * ld + c)),
                 "l"(from), "r"(valid ? 16 : 0));
  }
}

__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// rows [0, rows) x cols of a tile in place: row r scaled by w[r] in f32,
// rounded to bf16
__device__ void scale_rows(bf16* s, int ld, int rows, int cols,
                           const float* w) {
  const int per = cols / 8;
  for (int idx = threadIdx.x; idx < rows * per; idx += blockDim.x) {
    const int r = idx / per, c = (idx % per) * 8;
    uint4* p = reinterpret_cast<uint4*>(s + r * ld + c);
    const uint4 v = *p;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float wr = w[r];
    uint4 out;
    float2 f;
    f = __bfloat1622float2(h[0]);
    out.x = pack(f.x * wr, f.y * wr);
    f = __bfloat1622float2(h[1]);
    out.y = pack(f.x * wr, f.y * wr);
    f = __bfloat1622float2(h[2]);
    out.z = pack(f.x * wr, f.y * wr);
    f = __bfloat1622float2(h[3]);
    out.w = pack(f.x * wr, f.y * wr);
    *p = out;
  }
}

// rows x cols of a contiguous f32 matrix, rounded to bf16; each thread
// has kBatch loads in flight before it stores
constexpr int kBatch = 4;
__device__ void load_tile_f32(bf16* s, int ld, const float* src, int rows,
                              int cols) {
  const int per = cols / 8, total = rows * per;
  for (int first = threadIdx.x; first < total;
       first += kBatch * blockDim.x) {
    float4 a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = first + u * blockDim.x;
      if (idx < total) {
        const float* p = src + (long long)(idx / per) * cols + (idx % per) * 8;
        a[u] = __ldg(reinterpret_cast<const float4*>(p));
        b[u] = __ldg(reinterpret_cast<const float4*>(p + 4));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = first + u * blockDim.x;
      if (idx < total) {
        uint4 out;
        out.x = pack(a[u].x, a[u].y);
        out.y = pack(a[u].z, a[u].w);
        out.z = pack(b[u].x, b[u].y);
        out.w = pack(b[u].z, b[u].w);
        *reinterpret_cast<uint4*>(s + (idx / per) * ld + (idx % per) * 8) =
            out;
      }
    }
  }
}

// the k-th row group (of 16) of warp w: a snake over the four warps
__device__ __forceinline__ int snake(int k, int w) {
  return 4 * k + ((k & 1) ? 3 - w : w);
}

// (it, jt), jt <= it, of the lower-triangle tile pair idx
__device__ __forceinline__ void tile_pair(int idx, int& it, int& jt) {
  it = 0;
  while ((it + 1) * (it + 2) / 2 <= idx) ++it;
  jt = idx - it * (it + 1) / 2;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// --- forward ----------------------------------------------------------------

// cum[b, h, c, i] = Σ_{t≤i} dt·A, one block per (c, b, 32 heads)
__global__ void __launch_bounds__(256)
    ssd_cumsum(const float* __restrict__ dt, const float* __restrict__ A,
               float* __restrict__ cum, Geo g) {
  __shared__ float s[kMaxCs][33];
  const int c = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * 32;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < g.Cs * 32; idx += 256) {
    const int i = idx >> 5, hh = idx & 31, h = h0 + hh;
    float v = 0.f;
    if (h < g.H)
      v = __fmul_rn(dt[((long long)b * g.S + (long long)c * g.Cs + i) * g.H + h], A[h]);
    s[i][hh] = v;
  }
  __syncthreads();
  if (tid < 32) {
    float acc = 0.f;
    for (int i = 0; i < g.Cs; ++i) {
      acc = __fadd_rn(acc, s[i][tid]);
      s[i][tid] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g.Cs * 32; idx += 256) {
    const int hh = idx / g.Cs, i = idx % g.Cs, h = h0 + hh;
    if (h < g.H)
      cum[(((long long)b * g.H + h) * g.nc + c) * g.Cs + i] = s[i][hh];
  }
}

// C·Bᵀ of one (b, c) tile pair (it, jt <= it), and its transpose
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_cb(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
           float* __restrict__ cb, float* __restrict__ cbt, Geo g) {
  constexpr int LD = N + 8;
  __shared__ __align__(16) bf16 sC[kT * LD];
  __shared__ __align__(16) bf16 sB[kT * LD];
  int it, jt;
  tile_pair(blockIdx.x, it, jt);
  const int c = blockIdx.y, b = blockIdx.z, Cs = g.Cs;
  const int i0 = it * kT, j0 = jt * kT;
  const long long base = b * g.sb + (long long)c * Cs * g.ss;
  load_tile(sC, LD, Cm + base + i0 * g.ss, g.ss, min(kT, Cs - i0), kT, N);
  load_tile(sB, LD, Bm + base + j0 * g.ss, g.ss, min(kT, Cs - j0), kT, N);
  async_wait();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3, m0 = warp * 16;
  float acc[8][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 16) {
    uint32_t a[4];
    frag_a(a, sC, LD, m0, k0, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[4];
      frag_b(bb, sB, LD, np * 16, k0, lane);
      mma(acc[2 * np], a, bb[0], bb[1]);
      mma(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
  const long long off = ((long long)b * g.nc + c) * Cs * Cs;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = j0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + m0 + gg + 8 * half;
      if (i < Cs && j < Cs) {
        const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
        *reinterpret_cast<float2*>(cb + off + (long long)i * Cs + j) =
            make_float2(v0, v1);
        cbt[off + (long long)j * Cs + i] = v0;
        cbt[off + (long long)(j + 1) * Cs + i] = v1;
      }
    }
  }
}

// The chunk recurrence of one (b, h), in f32 registers: rows p of warp w
// are [16w, 16w + 16), every n.
//   forward  (BWD false): for c = 0 .. nc−1: states[c] = h;
//            h = exp(cum_E)·h + Σ_j (exp(cum_E − cum_j)·dt_j·x_j) ⊗ B_j;
//            last = h (the final state). init = h0 or none (0).
//   backward (BWD true):  for c = nc−1 .. 0: states[c] = dh (the gradient
//            leaving chunk c); t4[c] = exp(cum_E)·⟨dh, hin[c]⟩;
//            dh = exp(cum_E)·dh + Σ_i (exp(cum_i)·dy_i) ⊗ C_i;
//            last = dh (dh0). init = the final state's gradient or none.
template <int N, bool BWD>
__global__ void __launch_bounds__(kThreads)
    ssd_state_pass(const bf16* __restrict__ Y, const float* __restrict__ dt,
                   const bf16* __restrict__ V, const float* __restrict__ cum,
                   const float* __restrict__ init,
                   const float* __restrict__ hin, float* __restrict__ states,
                   float* __restrict__ last, float* __restrict__ t4, Geo g) {
  constexpr int LDV = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cs = g.Cs;
  bf16* sY = reinterpret_cast<bf16*>(smem);            // [Cs][kLdP], [k][m]
  bf16* sV = sY + Cs * kLdP;                            // [Cs][LDV], [k][n]
  float* sW = reinterpret_cast<float*>(sV + Cs * LDV);  // [Cs]
  __shared__ float sRed[4];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3, m0 = warp * 16;
  const long long hoff = ((long long)b * g.H + h) * kP * N;
  float acc[N / 8][4];
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = m0 + gg + (e >> 1) * 8, n = nt * 8 + 2 * t + (e & 1);
      acc[nt][e] = init ? init[hoff + p * N + n] : 0.f;
    }
  for (int step = 0; step < g.nc; ++step) {
    const int c = BWD ? g.nc - 1 - step : step;
    const float* cm = cum + (((long long)b * g.H + h) * g.nc + c) * Cs;
    const float cend = cm[Cs - 1];
    for (int i = threadIdx.x; i < Cs; i += kThreads)
      sW[i] = BWD ? expf(cm[i])
                  : expf(cend - cm[i]) *
                        dt[((long long)b * g.S + (long long)c * Cs + i) * g.H +
                           h];
    load_tile(sY, kLdP,
              Y + (((long long)b * g.S + (long long)c * Cs) * g.H + h) * kP,
              (long long)g.H * kP, Cs, Cs, kP);
    load_tile(sV, LDV, V + b * g.sb + (long long)c * Cs * g.ss, g.ss, Cs, Cs,
              N);
    // while the copies fly: write the state entering (forward) or the
    // gradient leaving (backward) this chunk, then decay it
    const long long soff = (((long long)b * g.nc + c) * g.H + h) * kP * N;
    float dot = 0.f;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + gg + 8 * half, n = nt * 8 + 2 * t;
        const long long o = soff + p * N + n;
        const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
        *reinterpret_cast<float2*>(states + o) = make_float2(v0, v1);
        if (BWD) {
          const float2 hv = *reinterpret_cast<const float2*>(hin + o);
          dot += v0 * hv.x + v1 * hv.y;
        }
      }
    const float decay = expf(cend);
    if (BWD) {
      dot = warp_sum(dot);
      if (lane == 0) sRed[warp] = dot;
    }
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= decay;
    async_wait();
    __syncthreads();
    scale_rows(sY, kLdP, Cs, kP, sW);
    __syncthreads();
    if (BWD && threadIdx.x == 0)
      t4[((long long)b * g.nc + c) * g.H + h] =
          decay * (((sRed[0] + sRed[1]) + sRed[2]) + sRed[3]);
    for (int k0 = 0; k0 < Cs; k0 += 16) {
      uint32_t a[4];
      frag_a_t(a, sY, kLdP, m0, k0, lane);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bb[4];
        frag_b_t(bb, sV, LDV, np * 16, k0, lane);
        mma(acc[2 * np], a, bb[0], bb[1]);
        mma(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + gg + 8 * half, n = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(last + hoff + p * N + n) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
}

// Two values of S[i][j..j+1] = (C·Bᵀ)[i][j]·exp(cum_i − cum_j)·dt_j (0 where
// j > i), packed as an mma operand; v the two (C·Bᵀ)[i][j..j+1]
__device__ __forceinline__ uint32_t s_pair(float2 v, int i, int j, float ci,
                                           const float* sCum,
                                           const float* sDt) {
  const float s0 = j <= i ? v.x * __expf(ci - sCum[j]) * sDt[j] : 0.f;
  const float s1 = j + 1 <= i ? v.y * __expf(ci - sCum[j + 1]) * sDt[j + 1]
                              : 0.f;
  return pack(s0, s1);
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// acc (16 rows from r0, 64 columns p) = y of those rows in f32:
// exp(cum_i)·C_i·h_cᵀ + Σ_{j≤i} S[i][j]·x_j
template <int N>
__device__ __forceinline__ void y_rows(float (&acc)[8][4], int r0,
                                       const bf16* crow, long long ss,
                                       const bf16* sH, const bf16* sX,
                                       const float* cbm, int Cs,
                                       const float* sCum, const float* sDt,
                                       int lane) {
  constexpr int LDV = N + 8;
  const int gg = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 16) {
    uint32_t a[4];
    frag_a_global(a, crow, ss, k0, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[4];
      frag_b(bb, sH, LDV, np * 16, k0, lane);
      mma(acc[2 * np], a, bb[0], bb[1]);
      mma(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
  const int ia = r0 + gg, ib = ia + 8;
  const float ca = sCum[ia], cb = sCum[ib];
  const float ea = expf(ca), eb = expf(cb);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] *= ea;
    acc[nt][1] *= ea;
    acc[nt][2] *= eb;
    acc[nt][3] *= eb;
  }
  // the (C·Bᵀ) operands of the next step load while this one multiplies
  const float* ra = cbm + (long long)ia * Cs + 2 * t;
  const float* rb = cbm + (long long)ib * Cs + 2 * t;
  float2 n0 = ldg2(ra), n1 = ldg2(rb), n2 = ldg2(ra + 8), n3 = ldg2(rb + 8);
  for (int k0 = 0; k0 <= r0; k0 += 16) {
    const float2 v0 = n0, v1 = n1, v2 = n2, v3 = n3;
    if (k0 + 16 <= r0) {
      n0 = ldg2(ra + k0 + 16);
      n1 = ldg2(rb + k0 + 16);
      n2 = ldg2(ra + k0 + 24);
      n3 = ldg2(rb + k0 + 24);
    }
    const int j = k0 + 2 * t;
    uint32_t a[4];
    a[0] = s_pair(v0, ia, j, ca, sCum, sDt);
    a[1] = s_pair(v1, ib, j, cb, sCum, sDt);
    a[2] = s_pair(v2, ia, j + 8, ca, sCum, sDt);
    a[3] = s_pair(v3, ib, j + 8, cb, sCum, sDt);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[4];
      frag_b_t(bb, sX, kLdP, np * 16, k0, lane);
      mma(acc[2 * np], a, bb[0], bb[1]);
      mma(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// y of one (b, c, h), in place in (B, S, H, P)
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_output(const bf16* __restrict__ x, const float* __restrict__ dt,
               const bf16* __restrict__ Cm, const float* __restrict__ cum,
               const float* __restrict__ cb,
               const float* __restrict__ states, bf16* __restrict__ y,
               Geo g) {
  constexpr int LDV = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cs = g.Cs;
  bf16* sX = reinterpret_cast<bf16*>(smem);               // [Cs][kLdP]
  bf16* sH = sX + Cs * kLdP;                               // [kP][LDV]
  float* sCum = reinterpret_cast<float*>(sH + kP * LDV);   // [Cs]
  float* sDt = sCum + Cs;                                  // [Cs]
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const long long row0 = (long long)b * g.S + (long long)c * Cs;   // first position
  load_tile(sX, kLdP, x + (row0 * g.H + h) * kP, (long long)g.H * kP, Cs, Cs,
            kP);
  load_tile_f32(sH, LDV,
                states + (((long long)b * g.nc + c) * g.H + h) * kP * N, kP,
                N);
  const float* cm = cum + (((long long)b * g.H + h) * g.nc + c) * Cs;
  for (int i = threadIdx.x; i < Cs; i += kThreads) {
    sCum[i] = cm[i];
    sDt[i] = dt[(row0 + i) * g.H + h];
  }
  async_wait();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3;
  const float* cbm = cb + ((long long)b * g.nc + c) * Cs * Cs;
  const bf16* crow = Cm + b * g.sb + (long long)c * Cs * g.ss;
  const int ng = Cs / 16;
  for (int k = 0; 4 * k < ng; ++k) {
    const int rg = snake(k, warp);
    if (rg >= ng) continue;
    const int r0 = rg * 16;
    float acc[8][4];
    y_rows<N>(acc, r0, crow + r0 * g.ss, g.ss, sH, sX, cbm, Cs, sCum, sDt,
              lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long i = row0 + r0 + gg + 8 * half;
        *reinterpret_cast<uint32_t*>(y + (i * g.H + h) * kP + nt * 8 +
                                     2 * t) =
            pack(acc[nt][2 * half], acc[nt][2 * half + 1]);
      }
  }
}

// --- backward ---------------------------------------------------------------

// out[b, r, n] (64 rows r of chunk c) = Σ_h Σ_p (w_r·Y[r, h, p])·Hs[c, h, p, n]
//   C side (BSIDE false): Y = dy, w_r = exp(cum_r), Hs the entry states:
//                         dC's part through the states
//   B side (BSIDE true):  Y = x, w_r = exp(cum_E − cum_r)·dt_r, Hs the
//                         gradients leaving the chunks: dB's
template <int N, bool BSIDE>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_inter(const bf16* __restrict__ Y, const float* __restrict__ dt,
                  const float* __restrict__ cum,
                  const float* __restrict__ Hs, float* __restrict__ out,
                  Geo g) {
  constexpr int LDV = N + 8;
  __shared__ __align__(16) bf16 sY[kT * kLdP];   // [r][p]
  __shared__ __align__(16) bf16 sH[kP * LDV];    // [p][n]
  __shared__ float sW[kT];
  const int c = blockIdx.y, b = blockIdx.z, Cs = g.Cs;
  const int r0 = blockIdx.x * kT, rows = min(kT, Cs - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3, m0 = warp * 16;
  const long long row0 = (long long)b * g.S + (long long)c * Cs + r0;
  float acc[N / 8][4] = {};
  for (int h = 0; h < g.H; ++h) {
    const float* cm = cum + (((long long)b * g.H + h) * g.nc + c) * Cs;
    load_tile(sY, kLdP, Y + (row0 * g.H + h) * kP, (long long)g.H * kP,
              rows, kT, kP);
    load_tile_f32(sH, LDV,
                  Hs + (((long long)b * g.nc + c) * g.H + h) * kP * N, kP, N);
    if (threadIdx.x < kT) {
      const int r = threadIdx.x;
      float w = 0.f;
      if (r < rows)
        w = BSIDE ? expf(cm[Cs - 1] - cm[r0 + r]) * dt[(row0 + r) * g.H + h]
                  : expf(cm[r0 + r]);
      sW[r] = w;
    }
    async_wait();
    __syncthreads();
    scale_rows(sY, kLdP, rows, kP, sW);
    __syncthreads();
    if (m0 < rows) {
#pragma unroll
      for (int k0 = 0; k0 < kP; k0 += 16) {
        uint32_t a[4];
        frag_a(a, sY, kLdP, m0, k0, lane);
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
          uint32_t bb[4];
          frag_b_t(bb, sH, LDV, np * 16, k0, lane);
          mma(acc[2 * np], a, bb[0], bb[1]);
          mma(acc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }
  if (m0 >= rows) return;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = row0 + m0 + gg + 8 * half;
      *reinterpret_cast<float2*>(out + r * N + nt * 8 + 2 * t) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
}

// dcb[b, c, i, j] = Σ_h exp(cum_i − cum_j)·dt_j·(dy_i·x_j) for j <= i (0
// above the diagonal), the gradient of C·Bᵀ, on one tile pair (it, jt <=
// it), and its transpose dcbt
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dcb(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ cum,
                float* __restrict__ dcb, float* __restrict__ dcbt, Geo g) {
  __shared__ __align__(16) bf16 sA[kT * kLdP];   // dy rows i: [i][p]
  __shared__ __align__(16) bf16 sB[kT * kLdP];   // x rows j: [j][p]
  __shared__ float sCi[kT], sCj[kT], sDj[kT];
  int it, jt;
  tile_pair(blockIdx.x, it, jt);
  const int c = blockIdx.y, b = blockIdx.z, Cs = g.Cs;
  const int i0 = it * kT, j0 = jt * kT;
  const int ri = min(kT, Cs - i0), rj = min(kT, Cs - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3, m0 = warp * 16;
  const long long row0 = (long long)b * g.S + (long long)c * Cs;
  float acc[8][4] = {};
  for (int h = 0; h < g.H; ++h) {
    const float* cm = cum + (((long long)b * g.H + h) * g.nc + c) * Cs;
    load_tile(sA, kLdP, dy + ((row0 + i0) * g.H + h) * kP,
              (long long)g.H * kP, ri, kT, kP);
    load_tile(sB, kLdP, x + ((row0 + j0) * g.H + h) * kP,
              (long long)g.H * kP, rj, kT, kP);
    if (threadIdx.x < kT) {
      const int r = threadIdx.x;
      sCi[r] = r < ri ? cm[i0 + r] : 0.f;
      sCj[r] = r < rj ? cm[j0 + r] : 0.f;
      sDj[r] = r < rj ? dt[(row0 + j0 + r) * g.H + h] : 0.f;
    }
    async_wait();
    __syncthreads();
    float tmp[8][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kP; k0 += 16) {
      uint32_t a[4];
      frag_a(a, sA, kLdP, m0, k0, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        frag_b(bb, sB, kLdP, np * 16, k0, lane);
        mma(tmp[2 * np], a, bb[0], bb[1]);
        mma(tmp[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = m0 + gg + (e >> 1) * 8, jl = nt * 8 + 2 * t + (e & 1);
        if (j0 + jl <= i0 + il)
          acc[nt][e] += tmp[nt][e] * (__expf(sCi[il] - sCj[jl]) * sDj[jl]);
      }
    __syncthreads();
  }
  const long long off = ((long long)b * g.nc + c) * Cs * Cs;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = j0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + m0 + gg + 8 * half;
      if (i < Cs && j < Cs) {
        const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
        *reinterpret_cast<float2*>(dcb + off + (long long)i * Cs + j) =
            make_float2(v0, v1);
        dcbt[off + (long long)j * Cs + i] = v0;
        dcbt[off + (long long)(j + 1) * Cs + i] = v1;
      }
    }
  }
}

// Two values of Mᵀ[j][i..i+1] = (C·Bᵀ)[i][j]·exp(cum_i − cum_j) (0 where
// i < j), packed; v the two ((C·Bᵀ)ᵀ)[j][i..i+1]
__device__ __forceinline__ uint32_t mt_pair(float2 v, int j, int i, float cj,
                                            const float* sCum) {
  const float m0 = i >= j ? v.x * __expf(sCum[i] - cj) : 0.f;
  const float m1 = i + 1 >= j ? v.y * __expf(sCum[i + 1] - cj) : 0.f;
  return pack(m0, m1);
}

// dx, ddt and the head's dA partial of one (b, c, h), in two phases over
// the row groups.
//  1. Rows j: v_j = Σ_{i≥j} M[i][j]·dy_i + exp(cum_E − cum_j)·(G B_j) (G
//     the gradient leaving the chunk), dx_j = dt_j·v_j, z_j = x_j·v_j (the
//     direct part of ddt_j), u_j = dt_j·exp(cum_E − cum_j)·x_j·(G B_j) (the
//     state's part of ∂/∂cum), and dy_j·y_j's part through the entry state,
//     exp(cum_j)·dy_j·(C_j·h_c).
//  2. Q[i][j] = (dy_i·x_j)·(C·Bᵀ)[i][j]·exp(cum_i − cum_j)·dt_j (j <= i),
//     in f32, summed by rows and by columns from the same values, so each
//     entry cancels where it should (its row and column differ only in
//     cum_i − cum_j): ∂/∂cum_k = Σ_j Q[k][j] − Σ_i Q[i][k] + the entry
//     state's part − u_k (+ Σ_j u_j + exp(cum_E)·⟨G, h_c⟩ at k = E).
// Then da_t = Σ_{k≥t} ∂/∂cum_k, ddt = z + A·da and Σ dt·da.
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_chunk(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const float* __restrict__ cum,
                  const float* __restrict__ cb, const float* __restrict__ cbt,
                  const float* __restrict__ hin, const float* __restrict__ G,
                  const float* __restrict__ t4, const bf16* __restrict__ dy,
                  bf16* __restrict__ dx, float* __restrict__ ddt,
                  float* __restrict__ dapart, Geo g) {
  constexpr int LDV = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cs = g.Cs;
  bf16* sDY = reinterpret_cast<bf16*>(smem);               // [Cs][kLdP]
  bf16* sX = sDY + Cs * kLdP;                               // [Cs][kLdP]
  bf16* sG = sX + Cs * kLdP;                                // [kP][LDV]
  bf16* sH = sG + kP * LDV;                                 // [kP][LDV]
  // phase 2: each row group's column sums of Q, [Cs / 16][Cs], over sG, sH
  float* sCol = reinterpret_cast<float*>(sG);
  float* sCum = reinterpret_cast<float*>(sH + kP * LDV);    // [Cs] each
  float* sDt = sCum + Cs;
  float* sZ = sDt + Cs;
  float* sYI = sZ + Cs;
  float* sU = sYI + Cs;
  float* sRow = sU + Cs;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const long long row0 = (long long)b * g.S + (long long)c * Cs;
  const long long soff = (((long long)b * g.nc + c) * g.H + h) * kP * N;
  load_tile(sDY, kLdP, dy + (row0 * g.H + h) * kP, (long long)g.H * kP, Cs,
            Cs, kP);
  load_tile(sX, kLdP, x + (row0 * g.H + h) * kP, (long long)g.H * kP, Cs, Cs,
            kP);
  load_tile_f32(sG, LDV, G + soff, kP, N);
  load_tile_f32(sH, LDV, hin + soff, kP, N);
  const float* cm = cum + (((long long)b * g.H + h) * g.nc + c) * Cs;
  for (int i = threadIdx.x; i < Cs; i += kThreads) {
    sCum[i] = cm[i];
    sDt[i] = dt[(row0 + i) * g.H + h];
  }
  async_wait();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3;
  const float cE = sCum[Cs - 1];
  const float* cbm = cb + ((long long)b * g.nc + c) * Cs * Cs;
  const float* cbtm = cbt + ((long long)b * g.nc + c) * Cs * Cs;
  const bf16* brow = Bm + b * g.sb + (long long)c * Cs * g.ss;
  const bf16* crow = Cm + b * g.sb + (long long)c * Cs * g.ss;
  const int ng = Cs / 16;
  for (int k = 0; 4 * k < ng; ++k) {
    const int rg = snake(k, warp);
    if (rg >= ng) continue;
    const int r0 = rg * 16, ra = r0 + gg, rb = ra + 8;
    // Σ_{i≥j} M[i][j]·dy_i
    float acc1[8][4] = {};
    {
      const float ja = sCum[ra], jb = sCum[rb];
      const float* pa = cbtm + (long long)ra * Cs + 2 * t;
      const float* pb = cbtm + (long long)rb * Cs + 2 * t;
      float2 n0 = ldg2(pa + r0), n1 = ldg2(pb + r0), n2 = ldg2(pa + r0 + 8),
             n3 = ldg2(pb + r0 + 8);
      for (int k0 = r0; k0 < Cs; k0 += 16) {
        const float2 v0 = n0, v1 = n1, v2 = n2, v3 = n3;
        if (k0 + 16 < Cs) {
          n0 = ldg2(pa + k0 + 16);
          n1 = ldg2(pb + k0 + 16);
          n2 = ldg2(pa + k0 + 24);
          n3 = ldg2(pb + k0 + 24);
        }
        const int i = k0 + 2 * t;
        uint32_t a[4];
        a[0] = mt_pair(v0, ra, i, ja, sCum);
        a[1] = mt_pair(v1, rb, i, jb, sCum);
        a[2] = mt_pair(v2, ra, i + 8, ja, sCum);
        a[3] = mt_pair(v3, rb, i + 8, jb, sCum);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          frag_b_t(bb, sDY, kLdP, np * 16, k0, lane);
          mma(acc1[2 * np], a, bb[0], bb[1]);
          mma(acc1[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    // G B_j
    float acc2[8][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t a[4];
      frag_a_global(a, brow + r0 * g.ss, g.ss, k0, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        frag_b(bb, sG, LDV, np * 16, k0, lane);
        mma(acc2[2 * np], a, bb[0], bb[1]);
        mma(acc2[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    {
      const float ea = expf(cE - sCum[ra]), eb = expf(cE - sCum[rb]);
      const float da = sDt[ra], db = sDt[rb];
      float za = 0.f, zb = 0.f, ua = 0.f, ub = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = nt * 8 + 2 * t;
        const float xa0 = bf(sX + ra * kLdP + p);
        const float xa1 = bf(sX + ra * kLdP + p + 1);
        const float xb0 = bf(sX + rb * kLdP + p);
        const float xb1 = bf(sX + rb * kLdP + p + 1);
        const float va0 = acc1[nt][0] + ea * acc2[nt][0];
        const float va1 = acc1[nt][1] + ea * acc2[nt][1];
        const float vb0 = acc1[nt][2] + eb * acc2[nt][2];
        const float vb1 = acc1[nt][3] + eb * acc2[nt][3];
        za += xa0 * va0 + xa1 * va1;
        zb += xb0 * vb0 + xb1 * vb1;
        ua += xa0 * acc2[nt][0] + xa1 * acc2[nt][1];
        ub += xb0 * acc2[nt][2] + xb1 * acc2[nt][3];
        *reinterpret_cast<uint32_t*>(dx + ((row0 + ra) * g.H + h) * kP + p) =
            pack(da * va0, da * va1);
        *reinterpret_cast<uint32_t*>(dx + ((row0 + rb) * g.H + h) * kP + p) =
            pack(db * vb0, db * vb1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        za += __shfl_xor_sync(0xffffffffu, za, off);
        zb += __shfl_xor_sync(0xffffffffu, zb, off);
        ua += __shfl_xor_sync(0xffffffffu, ua, off);
        ub += __shfl_xor_sync(0xffffffffu, ub, off);
      }
      if (t == 0) {
        sZ[ra] = za;
        sZ[rb] = zb;
        sU[ra] = da * ea * ua;
        sU[rb] = db * eb * ub;
      }
    }
    // exp(cum_k)·dy_k·(C_k·h_c)
    {
      float acc3[8][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        uint32_t a[4];
        frag_a_global(a, crow + r0 * g.ss, g.ss, k0, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          frag_b(bb, sH, LDV, np * 16, k0, lane);
          mma(acc3[2 * np], a, bb[0], bb[1]);
          mma(acc3[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      float ya = 0.f, yb = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = nt * 8 + 2 * t;
        ya += bf(sDY + ra * kLdP + p) * acc3[nt][0] +
              bf(sDY + ra * kLdP + p + 1) * acc3[nt][1];
        yb += bf(sDY + rb * kLdP + p) * acc3[nt][2] +
              bf(sDY + rb * kLdP + p + 1) * acc3[nt][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ya += __shfl_xor_sync(0xffffffffu, ya, off);
        yb += __shfl_xor_sync(0xffffffffu, yb, off);
      }
      if (t == 0) {
        sYI[ra] = expf(sCum[ra]) * ya;
        sYI[rb] = expf(sCum[rb]) * yb;
      }
    }
  }
  __syncthreads();   // sG and sH are free: sCol takes their place
  for (int k = 0; 4 * k < ng; ++k) {
    const int rg = snake(k, warp);
    if (rg >= ng) continue;
    const int r0 = rg * 16, ia = r0 + gg, ib = ia + 8;
    const float ca = sCum[ia], cb2 = sCum[ib];
    const float* qa = cbm + (long long)ia * Cs;
    const float* qb = cbm + (long long)ib * Cs;
    float rsa = 0.f, rsb = 0.f;
    for (int j0 = 0; j0 <= r0; j0 += kT) {
      const int nnt = min(8, (r0 + 16 - j0) / 8);   // even: columns < r0 + 16
      float2 va[8], vb[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        if (nt < nnt) {
          va[nt] = ldg2(qa + j0 + nt * 8 + 2 * t);
          vb[nt] = ldg2(qb + j0 + nt * 8 + 2 * t);
        }
      float tmp[8][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < kP; k0 += 16) {
        uint32_t a[4];
        frag_a(a, sDY, kLdP, r0, k0, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (2 * np >= nnt) break;
          uint32_t bb[4];
          frag_b(bb, sX, kLdP, j0 + np * 16, k0, lane);
          mma(tmp[2 * np], a, bb[0], bb[1]);
          mma(tmp[2 * np + 1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= nnt) break;
        const int j = j0 + nt * 8 + 2 * t;
        const float w0 = sDt[j], w1 = sDt[j + 1];
        const float c0 = sCum[j], c1 = sCum[j + 1];
        const float qa0 =
            j <= ia ? tmp[nt][0] * va[nt].x * __expf(ca - c0) * w0 : 0.f;
        const float qa1 =
            j + 1 <= ia ? tmp[nt][1] * va[nt].y * __expf(ca - c1) * w1 : 0.f;
        const float qb0 =
            j <= ib ? tmp[nt][2] * vb[nt].x * __expf(cb2 - c0) * w0 : 0.f;
        const float qb1 =
            j + 1 <= ib ? tmp[nt][3] * vb[nt].y * __expf(cb2 - c1) * w1 : 0.f;
        rsa += qa0 + qa1;
        rsb += qb0 + qb1;
        float s0 = qa0 + qb0, s1 = qa1 + qb1;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (gg == 0) {
          sCol[rg * Cs + j] = s0;
          sCol[rg * Cs + j + 1] = s1;
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rsa += __shfl_xor_sync(0xffffffffu, rsa, off);
      rsb += __shfl_xor_sync(0xffffffffu, rsb, off);
    }
    if (t == 0) {
      sRow[ia] = rsa;
      sRow[ib] = rsb;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  // ∂/∂cum_k, then da_t = Σ_{k≥t} ∂/∂cum_k: each lane a run of positions
  const int per = (Cs + 31) / 32, base = lane * per;
  float us = 0.f;
  for (int q = 0; q < per; ++q)
    if (base + q < Cs) us += sU[base + q];
  us = warp_sum(us);
  const float tail = us + t4[((long long)b * g.nc + c) * g.H + h];
  float dc[8];
  float run = 0.f;
  for (int q = per - 1; q >= 0; --q) {
    const int kk = base + q;
    float v = 0.f;
    if (kk < Cs) {
      float col = 0.f;
      for (int rg = kk / 16; rg < ng; ++rg) col += sCol[rg * Cs + kk];
      v = sRow[kk] - col + sYI[kk] - sU[kk];
      if (kk == Cs - 1) v += tail;
    }
    run += v;
    dc[q] = run;
  }
  // suffix sums of the lanes' totals: lanes above this one
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += v;
  }
  float above = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) above = 0.f;
  const float Ah = A[h];
  float dA = 0.f;
  for (int q = 0; q < per; ++q) {
    const int kk = base + q;
    if (kk >= Cs) break;
    const float da_t = dc[q] + above;
    ddt[(row0 + kk) * g.H + h] = sZ[kk] + Ah * da_t;
    dA += sDt[kk] * da_t;
  }
  dA = warp_sum(dA);
  if (lane == 0) dapart[((long long)b * g.nc + c) * g.H + h] = dA;
}

// dC (rows i of a 64-row tile) = Σ_{j≤i} dcb[i][j]·B_j + the part through
// the states; then dB (rows j) = Σ_{i≥j} dcbt[j][i]·C_i + its part
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_bc(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
               const float* __restrict__ dcb, const float* __restrict__ dcbt,
               const float* __restrict__ dc_inter,
               const float* __restrict__ db_inter, bf16* __restrict__ dB,
               bf16* __restrict__ dC, Geo g) {
  constexpr int LDV = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sV = reinterpret_cast<bf16*>(smem);   // [Cs][LDV], [k][n]
  const int c = blockIdx.y, b = blockIdx.z, Cs = g.Cs;
  const int t0 = blockIdx.x * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3, r0 = t0 + warp * 16;
  const long long base = b * g.sb + (long long)c * Cs * g.ss;
  const long long row0 = (long long)b * g.S + (long long)c * Cs;
  const long long off = ((long long)b * g.nc + c) * Cs * Cs;
  for (int side = 0; side < 2; ++side) {
    // side 0: dC, B rows [0, t0 + 64); side 1: dB, C rows [t0, Cs)
    const int v0 = side ? t0 : 0;
    const int vrows = side ? Cs - t0 : min(t0 + kT, Cs);
    if (side) __syncthreads();
    load_tile(sV, LDV, (side ? Cm : Bm) + base + (long long)v0 * g.ss, g.ss,
              vrows, vrows, N);
    async_wait();
    __syncthreads();
    if (r0 >= Cs) continue;
    const float* m = (side ? dcbt : dcb) + off + (long long)r0 * Cs;
    float acc[N / 8][4] = {};
    const int kbeg = side ? r0 : 0, kend = side ? Cs : r0 + 16;
    for (int k0 = kbeg; k0 < kend; k0 += 16) {
      uint32_t a[4];
      frag_a_global_f32(a, m, Cs, k0, lane);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bb[4];
        frag_b_t(bb, sV, LDV, np * 16, k0 - v0, lane);
        mma(acc[2 * np], a, bb[0], bb[1]);
        mma(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    const float* inter = side ? db_inter : dc_inter;
    bf16* out = side ? dB : dC;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = row0 + r0 + gg + 8 * half;
        const int n = nt * 8 + 2 * t;
        const float2 p = *reinterpret_cast<const float2*>(inter + r * N + n);
        *reinterpret_cast<uint32_t*>(out + r * N + n) =
            pack(acc[nt][2 * half] + p.x, acc[nt][2 * half + 1] + p.y);
      }
  }
}

__global__ void ssd_da_sum(const float* __restrict__ part,
                           float* __restrict__ dA, int bc, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int q = 0; q < bc; ++q) s += part[(long long)q * H + h];
  dA[h] = s;
}

// --- launchers ----------------------------------------------------------------

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

bool geo_ok(const Geo& g, int N) {
  return g.B > 0 && g.S > 0 && g.H > 0 && g.Cs >= 16 && g.Cs <= kMaxCs &&
         g.Cs % 16 == 0 && g.S % g.Cs == 0 && (N == 64 || N == 128) &&
         g.ss % 8 == 0 && g.sb % 8 == 0 && g.B <= 65535 && g.nc <= 65535;
}

int pairs(int Cs) {
  const int nt = (Cs + kT - 1) / kT;
  return nt * (nt + 1) / 2;
}

template <typename K>
cudaError_t with_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

#define SSD_CHECK(expr)                                 \
  do {                                                  \
    const cudaError_t e_ = (expr);                      \
    if (e_ != cudaSuccess) return (int)e_;              \
  } while (0)

template <int N>
int fwd(const bf16* x, const float* dt, const float* A, const bf16* Bm,
        const bf16* Cm, const float* h0, float* cum, float* cb, float* cbt,
        float* states, float* hlast, bf16* y, const Geo& g, cudaStream_t s) {
  constexpr int LDV = N + 8;
  ssd_cumsum<<<dim3(g.nc, g.B, (g.H + 31) / 32), 256, 0, s>>>(dt, A, cum, g);
  SSD_CHECK(cudaGetLastError());
  ssd_cb<N><<<dim3(pairs(g.Cs), g.nc, g.B), kThreads, 0, s>>>(Bm, Cm, cb,
                                                              cbt, g);
  SSD_CHECK(cudaGetLastError());
  const size_t pass_smem =
      (size_t)g.Cs * kLdP * 2 + (size_t)g.Cs * LDV * 2 + (size_t)g.Cs * 4;
  SSD_CHECK(with_smem(ssd_state_pass<N, false>, pass_smem));
  ssd_state_pass<N, false><<<dim3(g.H, g.B), kThreads, pass_smem, s>>>(
      x, dt, Bm, cum, h0, nullptr, states, hlast, nullptr, g);
  SSD_CHECK(cudaGetLastError());
  const size_t out_smem =
      (size_t)g.Cs * kLdP * 2 + (size_t)kP * LDV * 2 + (size_t)g.Cs * 8;
  SSD_CHECK(with_smem(ssd_output<N>, out_smem));
  ssd_output<N><<<dim3(g.H, g.nc, g.B), kThreads, out_smem, s>>>(
      x, dt, Cm, cum, cb, states, y, g);
  SSD_CHECK(cudaGetLastError());
  return 0;
}

template <int N>
int bwd(const bf16* x, const float* dt, const float* A, const bf16* Bm,
        const bf16* Cm, const float* cum, const float* cb, const float* cbt,
        const float* states, const bf16* dy, const float* dhlast, float* G,
        float* t4, float* dc_inter, float* db_inter, float* dcb, float* dcbt,
        float* dh0, bf16* dx, float* ddt, float* dapart, float* dA, bf16* dB,
        bf16* dC, const Geo& g, cudaStream_t s) {
  constexpr int LDV = N + 8;
  const int ntile = (g.Cs + kT - 1) / kT;
  const size_t pass_smem =
      (size_t)g.Cs * kLdP * 2 + (size_t)g.Cs * LDV * 2 + (size_t)g.Cs * 4;
  SSD_CHECK(with_smem(ssd_state_pass<N, true>, pass_smem));
  ssd_state_pass<N, true><<<dim3(g.H, g.B), kThreads, pass_smem, s>>>(
      dy, nullptr, Cm, cum, dhlast, states, G, dh0, t4, g);
  SSD_CHECK(cudaGetLastError());
  ssd_bwd_inter<N, false><<<dim3(ntile, g.nc, g.B), kThreads, 0, s>>>(
      dy, dt, cum, states, dc_inter, g);
  SSD_CHECK(cudaGetLastError());
  ssd_bwd_inter<N, true><<<dim3(ntile, g.nc, g.B), kThreads, 0, s>>>(
      x, dt, cum, G, db_inter, g);
  SSD_CHECK(cudaGetLastError());
  ssd_bwd_dcb<<<dim3(pairs(g.Cs), g.nc, g.B), kThreads, 0, s>>>(dy, x, dt, cum,
                                                                dcb, dcbt, g);
  SSD_CHECK(cudaGetLastError());
  const size_t chunk_smem = (size_t)g.Cs * kLdP * 2 * 2 +
                            (size_t)kP * LDV * 2 * 2 + (size_t)g.Cs * 4 * 6;
  SSD_CHECK(with_smem(ssd_bwd_chunk<N>, chunk_smem));
  ssd_bwd_chunk<N><<<dim3(g.H, g.nc, g.B), kThreads, chunk_smem, s>>>(
      x, dt, A, Bm, Cm, cum, cb, cbt, states, G, t4, dy, dx, ddt, dapart, g);
  SSD_CHECK(cudaGetLastError());
  const size_t bc_smem = (size_t)g.Cs * LDV * 2;
  SSD_CHECK(with_smem(ssd_bwd_bc<N>, bc_smem));
  ssd_bwd_bc<N><<<dim3(ntile, g.nc, g.B), kThreads, bc_smem, s>>>(
      Bm, Cm, dcb, dcbt, dc_inter, db_inter, dB, dC, g);
  SSD_CHECK(cudaGetLastError());
  ssd_da_sum<<<(g.H + 127) / 128, 128, 0, s>>>(dapart, dA, g.B * g.nc, g.H);
  SSD_CHECK(cudaGetLastError());
  return 0;
}

Geo geo(int B, int S, int H, int Cs, long long sb, long long ss) {
  Geo g;
  g.B = B;
  g.S = S;
  g.H = H;
  g.Cs = Cs;
  g.nc = Cs > 0 ? S / Cs : 0;
  g.sb = sb;
  g.ss = ss;
  return g;
}

}  // namespace

// The forward. x (B, S, H, 64) bf16; dt (B, S, H), A (H,) f32; Bm, Cm (B, S,
// N) bf16 with unit last stride, batch stride sb and position stride ss
// (multiples of 8); h0 (B, H, 64, N) f32 or null. Writes cum (B, H, nc,
// Cs), cb and cbt (B, nc, Cs, Cs), states (B, nc, H, 64, N) (the entry
// state of each chunk), hlast (B, H, 64, N) f32, and y (B, S, H, 64) bf16.
extern "C" int ssd_fwd_launch(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* cum, void* cb, void* cbt, void* states,
                              void* hlast, void* y, int B, int S, int H, int N,
                              int Cs, long long sb, long long ss,
                              void* stream) {
  const Geo g = geo(B, S, H, Cs, sb, ss);
  if (!geo_ok(g, N) ||
      !aligned16({x, dt, A, Bm, Cm, h0, cum, cb, cbt, states, hlast, y}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_FWD(NN)                                                          \
  fwd<NN>(static_cast<const bf16*>(x), static_cast<const float*>(dt),        \
          static_cast<const float*>(A), static_cast<const bf16*>(Bm),        \
          static_cast<const bf16*>(Cm), static_cast<const float*>(h0),       \
          static_cast<float*>(cum), static_cast<float*>(cb),                 \
          static_cast<float*>(cbt), static_cast<float*>(states),             \
          static_cast<float*>(hlast), static_cast<bf16*>(y), g, s)
  return N == 128 ? SSD_FWD(128) : SSD_FWD(64);
#undef SSD_FWD
}

// The backward, from the forward's inputs and its saved cum, cb, cbt and
// states; dy (B, S, H, 64) bf16 contiguous, dhlast (B, H, 64, N) f32 or
// null. Scratch: G (as states), t4 and dapart (B, nc, H), dc_inter and
// db_inter (B, S, N) f32, dcb and dcbt (as cb). Writes dh0 (as h0), dx (as
// x), ddt (as dt), dA (H,), dB and dC (B, S, N) bf16 contiguous.
extern "C" int ssd_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* cum, const void* cb, const void* cbt,
    const void* states, const void* dy, const void* dhlast, void* G, void* t4,
    void* dc_inter, void* db_inter, void* dcb, void* dcbt, void* dh0, void* dx,
    void* ddt, void* dapart, void* dA, void* dB, void* dC, int B, int S, int H,
    int N, int Cs, long long sb, long long ss, void* stream) {
  const Geo g = geo(B, S, H, Cs, sb, ss);
  if (!geo_ok(g, N) ||
      !aligned16({x, dt, A, Bm, Cm, cum, cb, cbt, states, dy, dhlast, G, t4,
                  dc_inter, db_inter, dcb, dcbt, dh0, dx, ddt, dapart, dA, dB,
                  dC}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_BWD(NN)                                                          \
  bwd<NN>(static_cast<const bf16*>(x), static_cast<const float*>(dt),        \
          static_cast<const float*>(A), static_cast<const bf16*>(Bm),        \
          static_cast<const bf16*>(Cm), static_cast<const float*>(cum),      \
          static_cast<const float*>(cb), static_cast<const float*>(cbt),     \
          static_cast<const float*>(states), static_cast<const bf16*>(dy),   \
          static_cast<const float*>(dhlast), static_cast<float*>(G),         \
          static_cast<float*>(t4), static_cast<float*>(dc_inter),            \
          static_cast<float*>(db_inter), static_cast<float*>(dcb),           \
          static_cast<float*>(dcbt), static_cast<float*>(dh0),               \
          static_cast<bf16*>(dx), static_cast<float*>(ddt),                  \
          static_cast<float*>(dapart), static_cast<float*>(dA),              \
          static_cast<bf16*>(dB), static_cast<bf16*>(dC), g, s)
  return N == 128 ? SSD_BWD(128) : SSD_BWD(64);
#undef SSD_BWD
}
