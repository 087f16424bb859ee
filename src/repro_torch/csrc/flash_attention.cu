// flash_attention: causal grouped-query attention, forward only, with an
// optional sliding window, for B·H query rows of S positions.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// _flash_kernel / flash_attention (pl.pallas_call at line 104).
//
// For batch b, query head h (KV head h / G, G = H / Kv) and position i:
//   s_ij = (q_i · k_j)·scale        kept iff j <= i and (window <= 0 or
//                                   i − j < window), else masked
//   o_i  = Σ_j softmax(s_i)_j · v_j
// Each of q, o (B, H, S, hd) and k, v (B, Kv, S, hd) is addressed through
// element strides for its batch, head and sequence axes, with the head
// dimension contiguous: the (B·H, S, hd) layout of the reference and the
// projections' (B, S, H, hd) views are both taken without a copy. f32 or
// bf16; hd <= 128; any S (the ragged last tile is masked by index). The
// online softmax (running max m, running sum l) and the accumulator are
// f32; the output is acc / max(l, 1e-30) in the input type. A masked score
// contributes an exact 0.
//
// What bounds it on the H100: operations. At the Llama-3 8B prefill
// (B·H = 128, S = 2048, hd = 128, bf16, causal) it does 1.4e11 FLOP on
// 168 MB, far above the card's balance point: 139 us on the bf16 tensor
// cores, 2.05 ms at the f32 CUDA-core peak. So bf16 runs on the tensor
// cores, and the design keeps them fed.
//
// Two instances; flash_route() in kernels/flash_attention.py picks one by
// dtype and hd:
//
// tensor_core (bf16, hd a multiple of 16): flash_attention_tc_launch.
//  * One CTA owns one (b·h, tile of 128 query rows): two consumer
//    warpgroups of 64 rows each and one producer warp.
//  * The producer issues TMA copies (one thread; 4-d tensor maps over the
//    operands' own strides, so no layout is copied): Q once, then K/V
//    tiles of 64 keys into a ring of 4 shared-memory stages, each with a
//    "landed" and a "free" mbarrier. Rows past S and columns past hd come
//    in as zeros. Tiles t+1.. load while tile t computes.
//  * Shared memory is in the 128-byte swizzle that both the tensor maps
//    and the wgmma descriptors name (16-byte chunk c of row r at
//    c ^ (r % 8)), head dims padded to 64 or 128 in 64-column blocks.
//  * S = Q·Kᵀ is wgmma m64n64k16 (bf16 x bf16 -> f32), Q and K read from
//    shared memory; the products of two bf16 values are exact in f32, so
//    the scores are the reference's up to summation order.
//  * The online softmax runs in f32 registers on the accumulator fragment
//    (a row's max across the 4 lanes that hold it by shuffles; l is kept
//    per thread and reduced once at the end), in base 2 with
//    scale·log2(e) folded into one FMA before ex2.
//  * P is rounded to bf16 in registers, where the S fragment already has
//    the layout of wgmma's register A operand, and O += P·V is wgmma with
//    A from registers and V (keys x hd, hd contiguous) as the MN-major B
//    operand (the descriptor's transpose bit). That rounding of P is the
//    one the reference's model path makes (probs.astype(v.dtype)).
//  * Per tile, S_t and the previous tile's P·V are issued together and
//    the softmax of S_t runs while that P·V is on the tensor cores; the
//    two warpgroups take turns at issuing, so that one's softmax overlaps
//    the other's products.
//  * Tiles wholly past the diagonal or before the window are skipped per
//    warpgroup; only tiles that cross the diagonal, the window edge or S
//    apply the index mask.
//
// cuda_core (f32, and bf16 with hd not a multiple of 16):
// flash_attention_cc_launch. Keeps the reference's f32 numerics (f32
// products and P·V):
//  * One block owns one (b·h, 64 query rows) and walks the KV tiles in a
//    loop, carrying m, l and acc in registers: each of the 256 threads
//    owns 4 query rows (ty + 16·i) and the accumulator columns tx + 16·j.
//  * Q, K and V tiles are converted to f32 in shared memory; rows are
//    padded to hd + 1 floats so that the 16 threads of a row group read
//    16 different banks. The 64 x 64 score tile is FMAs, 4 x 4 a thread;
//    the probabilities go through shared memory to the P·V product.
//
// Both: the TPU kernel runs the KV blocks as its sequential last grid axis
// and carries m, l and acc in VMEM scratch; CUDA blocks run in no order,
// so a block loops over the KV tiles itself. Blocks are launched from the
// last query tile down: the longest rows start first and the short ones
// fill the tail.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxHd = 128;

// element strides of one operand; the head dimension is contiguous
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ bool keep(int qpos, int kpos, int s, int window) {
  return kpos <= qpos && kpos < s && (window <= 0 || qpos - kpos < window);
}

// ---------------------------------------------------------------------------
// tensor_core: bf16, hd a multiple of 16, padded to HDP = 64 or 128
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWGs = 2;           // consumer warpgroups, 64 query rows each
constexpr int kRows = 64 * kWGs;  // query rows per CTA
constexpr int kKeys = 64;         // keys per K/V tile
constexpr int kThreads = 128 * kWGs + 32;  // and one producer warp
constexpr int kStages = 4;        // the K/V ring

template <int HDP>
struct Layout {
  static constexpr int kQBytes = kRows * HDP * 2;
  static constexpr int kTileBytes = kKeys * HDP * 2;     // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;     // K then V
  // the mbarriers: Q landed, tile landed [kStages], stage free [kStages]
  static constexpr int kBars = kQBytes + kStages * kStageBytes;
  // + 1024: the base is rounded up to the swizzle atom
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(bar)
      : "memory");
}
// arrives, and makes the phase wait for `bytes` more of TMA copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// 2^x on the special function unit (flushes denormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Which of a tensor map's dimensions 1..3 hold the sequence, the head and
// the batch axis (dimension 0 is the head dim): the host orders them by
// stride.
struct MapOrder {
  int seq, head, batch;
};

// one TMA box (64 columns x the map's rows, 128-byte swizzled) into shared
// memory at `dst`, completing on `bar`; the copy fills rows past S and
// columns past hd with zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         MapOrder o, int col, int row,
                                         int head, int batch, uint32_t bar) {
  int c[4] = {col, 0, 0, 0};
  c[o.seq] = row;
  c[o.head] = head;
  c[o.batch] = batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c[0]), "r"(c[1]), "r"(c[2]),
      "r"(c[3]), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across the async wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

#define WG_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16) · B (16 x 64): A and B from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) · B (16 x 64)
// with B MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D32
#undef WG_OUT32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The fragment of a 64 x 64 f32 wgmma accumulator held by a thread of the
// warpgroup (warp w, lane = 4·g + t): element i sits at row
// 16·w + g + 8·((i >> 1) & 1) and column 8·(i >> 2) + 2·t + (i & 1).
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, MapOrder oq,
                MapOrder okv, bf16* __restrict__ o, int s, int hd, int h,
                int kvh, float scale_log2, int window, Strides os) {
  using L = Layout<HDP>;
  constexpr int kBlocks = HDP / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t skv = sq + L::kQBytes;
  const uint32_t q_full = sq + L::kBars;        // Q landed
  const uint32_t full = q_full + 8;             // [stage]: its tile landed
  const uint32_t empty = full + 8 * kStages;    // [stage]: free again

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const int kvhh = hh / (h / kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int q_last = min(q0 + kRows, s) - 1;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kKeys : 0;
  const int kt_end = q_last / kKeys;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);   // the producer, then the copies' bytes
      mbar_init(empty + 8 * i, 4 * kWGs);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, read through a shuffle so that the compiler sees it uniform
  // across the warp and keeps the wgmma pipeline behind it asynchronous
  const int wg = __shfl_sync(~0u, tid / 128, 0);
  if (wg == kWGs) {
    // the producer: one thread of the last warp issues the TMA copies, Q
    // once, then the K/V tiles through the ring
    if (lane != 0) return;
    mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb)
      tma_load(sq + cb * (kRows * 128), &tq, oq, cb * 64, q0, hh, b, q_full);
    for (int kt = kt_begin; kt <= kt_end; ++kt) {
      const int i = kt - kt_begin, stage = i % kStages;
      if (i >= kStages) mbar_wait(empty + 8 * stage, (i / kStages - 1) & 1);
      const uint32_t bar = full + 8 * stage;
      const uint32_t dst = skv + stage * L::kStageBytes;
      mbar_expect_tx(bar, L::kStageBytes);
#pragma unroll
      for (int cb = 0; cb < kBlocks; ++cb) {
        tma_load(dst + cb * (kKeys * 128), &tk, okv, cb * 64, kt * kKeys,
                 kvhh, b, bar);
        tma_load(dst + L::kTileBytes + cb * (kKeys * 128), &tv, okv,
                 cb * 64, kt * kKeys, kvhh, b, bar);
      }
    }
    return;
  }

  // a consumer warpgroup: rows r0..r0+63 (those below S: r0..r_hi), and
  // tiles wt_begin..wt_end; the others are wholly past the diagonal, past
  // S or before the window for all its rows. This thread's rows are row_a
  // and row_a + 8.
  const int r0 = q0 + wg * 64;
  const int r_hi = min(r0 + 63, s - 1);
  const int wt_begin =
      window > 0 ? max(kt_begin, max(0, r0 - window + 1) / kKeys) : kt_begin;
  const int wt_end = r0 > s - 1 ? wt_begin - 1 : min(kt_end, r_hi / kKeys);
  const int row_a = r0 + (tid % 128) / 32 * 16 + lane / 4;
  const int col_t = 2 * (lane % 4);

  float acc[kBlocks][32];
#pragma unroll
  for (int cb = 0; cb < kBlocks; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  uint32_t pa[4][4];  // P of the tile whose P·V is next, bf16 pairs
  float sc[32];       // S of the current tile, then its P in f32
  float alpha[2];

  auto stage_of = [&](int kt) { return (kt - kt_begin) % kStages; };
  auto wait_full = [&](int kt) {
    mbar_wait(full + 8 * stage_of(kt), (kt - kt_begin) / kStages & 1);
  };
  auto release = [&](int kt) {
    if (lane == 0) mbar_arrive(empty + 8 * stage_of(kt));
  };
  auto issue_s = [&](int kt) {
    const uint32_t sk = skv + stage_of(kt) * L::kStageBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t a = sq + (kk / 4) * (kRows * 128) + wg * (64 * 128) +
                         (kk % 4) * 32;
      const uint32_t bk = sk + (kk / 4) * (kKeys * 128) + (kk % 4) * 32;
      wgmma_ss(sc, desc(a, 16, 1024), desc(bk, 16, 1024), kk > 0);
    }
    wg_commit();
    fence_regs(sc);
  };
  auto issue_pv = [&](int kt) {
    const uint32_t sv = skv + stage_of(kt) * L::kStageBytes + L::kTileBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int cb = 0; cb < kBlocks; ++cb) {
        // 16 keys x 64 columns of V: 16 rows of 128 bytes; the 8-row
        // groups are 1024 bytes apart
        const uint32_t bv = sv + cb * (kKeys * 128) + kk * (16 * 128);
        wgmma_rs_t(acc[cb], pa[kk], desc(bv, 1024, 1024));
      }
    }
    wg_commit();
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb) fence_regs(acc[cb]);
  };
  // S of tile kt -> p = 2^(s·scale·log2 e − m) in sc, m and l updated, and
  // the factor alpha that rescales what came before
  auto softmax = [&](int kt) {
    const int k0 = kt * kKeys;
    // the index mask only where the tile crosses the diagonal, S or the
    // window edge
    const bool masked = k0 + kKeys - 1 > r0 || k0 + kKeys > s ||
                        (window > 0 && r0 + 63 - k0 >= window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (masked) {
        const int row = row_a + 8 * ((i >> 1) & 1);
        const int key = k0 + 8 * (i >> 2) + col_t + (i & 1);
        sc[i] = keep(row, key, s, window) ? sc[i] : -INFINITY;
      }
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
      // m in base-2 units; a row with no kept key yet keeps p = 0 and
      // alpha = 0
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = ex2(fmaf(sc[i], scale_log2, -base[(i >> 1) & 1]));
      l[(i >> 1) & 1] += sc[i];
    }
  };
  auto to_pa = [&]() {
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(sc[i], sc[i + 1]);
  };

  // The two warpgroups take turns at issuing their wgmmas (named barriers
  // 1 and 2), so that one's softmax runs while the other's products hold
  // the tensor cores. Each takes one turn per tile of the CTA and one for
  // its last P·V; the second warpgroup opens with an arrival that lets the
  // first one go first, and leaves out its last one, which nobody awaits.
  static_assert(kWGs == 2, "the turns alternate between two warpgroups");
  auto turn_begin = [&]() { named_sync(1 + wg); };
  auto turn_end = [&](bool last) {
    if (!(last && wg == 1)) named_arrive(2 - wg);
  };
  if (wg == 1) named_arrive(1);

  mbar_wait(q_full, 0);
  // tiles of the CTA before this warpgroup's: free them as they land
  for (int kt = kt_begin; kt < min(wt_begin, kt_end + 1); ++kt) {
    wait_full(kt);
    turn_begin();
    turn_end(false);
    release(kt);
  }
  if (wt_begin <= wt_end) {
    wait_full(wt_begin);
    turn_begin();
    issue_s(wt_begin);
    turn_end(false);
    wg_wait<0>();
    fence_regs(sc);
    softmax(wt_begin);
    to_pa();
    // per tile: S_t and the previous tile's P·V are issued together; the
    // softmax of S_t runs while P·V is on the tensor cores, and O is
    // rescaled by S_t's alpha once P·V is done
    for (int kt = wt_begin + 1; kt <= wt_end; ++kt) {
      wait_full(kt);
      turn_begin();
      issue_s(kt);
      issue_pv(kt - 1);
      turn_end(false);
      wg_wait<1>();  // S_t is done; P·V may still run
      fence_regs(sc);
      softmax(kt);
      wg_wait<0>();
#pragma unroll
      for (int cb = 0; cb < kBlocks; ++cb) fence_regs(acc[cb]);
      release(kt - 1);
#pragma unroll
      for (int cb = 0; cb < kBlocks; ++cb)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[cb][i] *= alpha[(i >> 1) & 1];
      to_pa();
    }
  }
  // tiles of the CTA after this warpgroup's
  for (int kt = wt_end + 1; kt <= kt_end; ++kt) {
    wait_full(kt);
    turn_begin();
    turn_end(false);
    release(kt);
  }
  if (wt_begin <= wt_end) {
    turn_begin();
    issue_pv(wt_end);
    turn_end(true);
    wg_wait<0>();
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb) fence_regs(acc[cb]);
    release(wt_end);
  } else {
    turn_begin();
    turn_end(true);
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(~0u, sum, 1);
    sum += __shfl_xor_sync(~0u, sum, 2);
    den[r] = fmaxf(sum, 1e-30f);
  }
  bf16* og = o + b * os.b + hh * os.h;
#pragma unroll
  for (int cb = 0; cb < kBlocks; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const int row = row_a + 8 * r;
      const int col = cb * 64 + 8 * (i >> 2) + col_t;
      if (row < s && col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(og + row * os.s + col) =
            __floats2bfloat162_rn(acc[cb][i] / den[r],
                                  acc[cb][i + 1] / den[r]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, heads, S, hd) bf16 operand as a 4-d tensor map with boxes of 64
// columns x `rows` positions, 128-byte swizzled. Dimension 0 is the head
// dim; the sequence, head and batch axes follow in the order of their
// strides, and `order` says where each went.
int make_map(CUtensorMap* map, MapOrder* order, const void* ptr, int bsz,
             int heads, int s, int hd, Strides st, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  struct Axis {
    long long stride;
    int dim, box, which;
  } ax[3] = {{st.s, s, rows, 0}, {st.h, heads, 1, 1}, {st.b, bsz, 1, 2}};
  for (int i = 1; i < 3; ++i)  // order by stride (ties keep their order)
    for (int j = i; j > 0 && ax[j].stride < ax[j - 1].stride; --j) {
      const Axis t = ax[j];
      ax[j] = ax[j - 1];
      ax[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)hd, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int* slot[3] = {&order->seq, &order->head, &order->batch};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)ax[i].dim;
    // a stride of an axis of extent 1 is never used; keep it legal
    strides[i] = (cuuint64_t)(ax[i].dim == 1 && ax[i].stride == 0
                                  ? 16
                                  : ax[i].stride * 2);
    box[i + 1] = (cuuint32_t)ax[i].box;
    *slot[ax[i].which] = i + 1;
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int bsz,
           int s, int hd, int h, int kvh, float scale, int window,
           Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  MapOrder oq, ok, ov;
  int e = make_map(&tq, &oq, q, bsz, h, s, hd, qs, kRows);
  if (e == 0) e = make_map(&tk, &ok, k, bsz, kvh, s, hd, ks, kKeys);
  if (e == 0) e = make_map(&tv, &ov, v, bsz, kvh, s, hd, vs, kKeys);
  if (e != 0) return e;
  if (ok.seq != ov.seq || ok.head != ov.head || ok.batch != ov.batch)
    return (int)cudaErrorInvalidValue;  // k and v must share a layout
  const int smem = Layout<HDP>::kSmem;
  cudaError_t ce = cudaFuncSetAttribute(
      flash_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid(bsz * h, (s + kRows - 1) / kRows);
  flash_tc_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, oq, ok, static_cast<bf16*>(o), s, hd, h, kvh,
      scale * 1.4426950408889634f, window, os);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// cuda_core: f32, or bf16 with any hd <= 128, on the CUDA cores
// ---------------------------------------------------------------------------
namespace cc {

constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kRows = 4;        // query rows per thread: ty + 16·i
constexpr int kCols = 4;        // keys per thread in a score tile: tx + 16·j
constexpr int kPStride = kTile + 1;
constexpr int kNJ = kMaxHd / 16;  // accumulator columns per thread: tx + 16·j
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, bf16* o) {
  *o = __float2bfloat16(v);
}

// rows [0, valid) of a (kTile, hd) tile with row stride `src_stride` into
// shared memory as f32 with row stride `stride`; rows past `valid` become 0
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long src_stride, float* dst,
                                          int valid, int hd, int stride,
                                          int tx, int ty) {
  for (int r = ty; r < kTile; r += 16) {
    for (int c = tx; c < hd; c += 16) {
      dst[r * stride + c] =
          r < valid ? to_f32(src[r * src_stride + c]) : 0.f;
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

// one instance per dtype serves every hd <= kMaxHd: columns d >= hd are
// guarded in the P·V product and the store
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int s, int hd,
                int h, int kvh, float scale, int window, Strides qs,
                Strides ks, Strides vs, Strides os) {
  extern __shared__ float smem[];
  const int stride = hd + 1;
  float* qsm = smem;                     // [kTile][hd + 1]
  float* ksm = qsm + kTile * stride;     // [kTile][hd + 1]
  float* vsm = ksm + kTile * stride;     // [kTile][hd]
  float* ps = vsm + kTile * hd;          // [kTile][kPStride]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const int kvhh = hh / (h / kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const T* kg = k + b * ks.b + kvhh * ks.h;
  const T* vg = v + b * vs.b + kvhh * vs.h;

  load_tile(q + b * qs.b + hh * qs.h + q0 * qs.s, qs.s, qsm,
            min(kTile, s - q0), hd, stride, tx, ty);

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
    load_tile(kg + k0 * ks.s, ks.s, ksm, min(kTile, s - k0), hd, stride, tx,
              ty);
    load_tile(vg + k0 * vs.s, vs.s, vsm, min(kTile, s - k0), hd, hd, tx,
              ty);
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qsm[(ty + 16 * i) * stride + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ksm[(tx + 16 * j) * stride + d];
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
        const float vv = d < hd ? vsm[c * hd + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* og = o + b * os.b + hh * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(acc[i][j] / den, og + qpos * os.s + d);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bsz,
           int s, int hd, int h, int kvh, float scale, int window,
           Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * kTile * (hd + 1) +
                                       (size_t)kTile * hd +
                                       (size_t)kTile * kPStride);
  cudaError_t e = cudaFuncSetAttribute(
      flash_cc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(bsz * h, (s + kTile - 1) / kTile);
  flash_cc_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, hd, h, kvh, scale,
      window, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

}  // namespace cc

bool bad_shape(int bsz, int s, int hd, int h, int kvh) {
  return bsz < 0 || s < 0 || hd < 1 || hd > kMaxHd || h < 1 || kvh < 1 ||
         h % kvh != 0;
}

}  // namespace

// Both launchers take q, o as (B, H, S, hd) and k, v as (B, Kv, S, hd),
// each through its batch, head and sequence element strides (the head
// dimension contiguous); window <= 0: no window.

// bf16 on the tensor cores: hd a multiple of 16; every stride a multiple
// of 8 and every pointer 16-byte aligned (the 16-byte copies)
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int bsz, int s,
    int hd, int h, int kvh, float scale, int window, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  if (bad_shape(bsz, s, hd, h, kvh) || hd % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || s == 0) return 0;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 64 ? tc::launch<64>(q, k, v, o, bsz, s, hd, h, kvh, scale,
                                   window, qs, ks, vs, os, st)
                  : tc::launch<128>(q, k, v, o, bsz, s, hd, h, kvh, scale,
                                    window, qs, ks, vs, os, st);
}

// f32 (is_bf16 = 0) or bf16 (1) on the CUDA cores, any hd <= 128
extern "C" int flash_attention_cc_launch(
    const void* q, const void* k, const void* v, void* o, int bsz, int s,
    int hd, int h, int kvh, float scale, int window, int is_bf16,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    void* stream) {
  if (bad_shape(bsz, s, hd, h, kvh)) return (int)cudaErrorInvalidValue;
  if (bsz == 0 || s == 0) return 0;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? cc::launch<bf16>(q, k, v, o, bsz, s, hd, h, kvh, scale,
                                    window, qs, ks, vs, os, st)
                 : cc::launch<float>(q, k, v, o, bsz, s, hd, h, kvh, scale,
                                     window, qs, ks, vs, os, st);
}
