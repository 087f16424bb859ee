// Row streaming for the d8 routes of lloyd_update.cu, pq_quantize.cu and
// kmeans_assign.cu: each of a block's kThreads consumer threads takes whole
// rows of 8 values into registers, kRows rows per tile.
//
// Row order. Block b of nb blocks of one problem visits tiles b, b + nb,
// b + 2·nb, ... of kThreads·kRows rows each, and thread t takes rows
// t, t + kThreads, ..., t + (kRows − 1)·kThreads of each tile: its rows in
// increasing order. lloyd_update's plain version in kernel order
// (kernels/lloyd_update.py) sums in exactly this order.
//
// How the bytes arrive: one thread of an extra producer warp copies each
// tile (one contiguous run of rows) into a ring of kStages tiles in shared
// memory with Hopper's 1-D bulk asynchronous copy (cp.async.bulk,
// completion counted in bytes on an mbarrier, no tensor map); consumers
// wait on the tile's "full" barrier, move their rows into registers, and
// release the slot on its "empty" barrier, lane 0 for the warp. Loads of
// later tiles stay in flight while the consumers compute. Addresses and
// sizes are multiples of 16 bytes: the caller routes a misaligned x
// elsewhere, and the launchers refuse one (misaligned16).
#pragma once

#include <cstdint>

#include "assign.cuh"

namespace repro_torch {

// Host side: true where p cannot take the d8 routes' 16-byte accesses.
inline bool misaligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

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
// arrives, and makes the phase wait for `bytes` more of asynchronous copies
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
// `bytes` (a multiple of 16) from global `src` to shared `dst`, completing
// on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// consumer threads only (the producer warp has left): named barrier 1
template <int kThreads>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// A row of a tile in shared memory into registers. An f32 row is 32 bytes,
// read as two 16-byte halves; threads 4..7 of each group of 8 read the
// second half first, so that the 8 threads of a phase hit 32 distinct
// banks.
__device__ __forceinline__ void row8_from_tile(const float* p,
                                               float (&r)[8]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const int h = (threadIdx.x >> 2) & 1;
  const float4 a = q[h], b = q[h ^ 1];
  const float4 lo = h ? b : a, hi = h ? a : b;
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}
__device__ __forceinline__ void row8_from_tile(const __nv_bfloat16* p,
                                               float (&r)[8]) {
  row8_from(p, r);  // 16 bytes a thread, consecutive: conflict-free
}

template <typename T, int kThreads, int kRows, int kStages>
struct RowRing {
  static constexpr int kTileRows = kThreads * kRows;
  alignas(128) T tiles[kStages][kTileRows * 8];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// Streams the rows of one problem (xp, n rows of 8) that block b of nb owns
// through `ring`. Each consumer thread calls op(row0, nr, xr) once per
// tile: xr[r] holds row row0 + r·kThreads for r < nr (nr <= kRows; the
// rest are not rows). blockDim.x must be kThreads + 32. Returns true on
// consumer threads and false on the producer warp, which has nothing left
// to do.
template <typename T, int kThreads, int kRows, int kStages, typename Op>
__device__ __forceinline__ bool stream_rows(
    const T* __restrict__ xp, size_t n, int b, int nb,
    RowRing<T, kThreads, kRows, kStages>& ring, Op&& op) {
  constexpr int kTile = kThreads * kRows;
  const uint32_t full0 = smem_u32(&ring.full[0]);
  const uint32_t empty0 = smem_u32(&ring.empty[0]);
  const size_t ntiles = (n + kTile - 1) / kTile;
  const size_t mine =
      (size_t)b < ntiles ? (ntiles - 1 - b) / (size_t)nb + 1 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrive
      mbar_init(empty0 + 8 * s, kThreads / 32);    // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {
    if (threadIdx.x == kThreads) {
      for (size_t j = 0; j < mine; ++j) {
        const int s = (int)(j % kStages);
        if (j >= (size_t)kStages)
          mbar_wait(empty0 + 8 * s, (int)((j / kStages - 1) & 1));
        const size_t t0 = (b + j * nb) * (size_t)kTile;
        const size_t rows = n - t0 < kTile ? n - t0 : kTile;
        const uint32_t bytes = (uint32_t)(rows * 8 * sizeof(T));
        mbar_expect_tx(full0 + 8 * s, bytes);
        bulk_load(smem_u32(ring.tiles[s]), xp + t0 * 8, bytes, full0 + 8 * s);
      }
    }
    return false;
  }
  for (size_t j = 0; j < mine; ++j) {
    const int s = (int)(j % kStages);
    mbar_wait(full0 + 8 * s, (int)((j / kStages) & 1));
    const size_t row0 = (b + j * nb) * (size_t)kTile + threadIdx.x;
    const size_t left = row0 >= n ? 0 : (n - row0 + kThreads - 1) / kThreads;
    const int nr = (int)(left < (size_t)kRows ? left : kRows);
    float xr[kRows][8];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr)
        row8_from_tile(ring.tiles[s] + (r * kThreads + threadIdx.x) * 8,
                       xr[r]);
      else
#pragma unroll
        for (int k = 0; k < 8; ++k) xr[r][k] = 0.f;
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * s);
    if (nr > 0) op(row0, nr, xr);
  }
  return true;
}

}  // namespace repro_torch
