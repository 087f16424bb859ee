// Shared helpers of cuda_clean.cu: the 16-byte accesses, and the host test
// its launcher makes before reaching them. Never compiled.
#pragma once

#include <cstdint>

inline bool misaligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
