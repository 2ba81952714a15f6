// What every path of the bilateral kernel shares (csrc/bilateral.cu; path 4
// in csrc/bilateral_circle.cuh): the block's shape, the range LUT's size,
// the border fold, the halo tile's words, the store, and a block's dynamic
// shared memory above 48 KB.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kLanes * kRowsPerBlock;
constexpr int kLutSize = 256 * 3;

constexpr int kBorderReplicate = 0;
constexpr int kRoundingRint = 1;

// Source index of padded index i on an n-element axis.
__device__ __forceinline__ int fold(int i, int n, int border) {
  if (border == kBorderReplicate) return min(max(i, 0), n - 1);
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  int j = i % period;
  if (j < 0) j += period;
  return j >= n ? period - j : j;
}

__device__ __forceinline__ uint32_t load_pixel(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16);
}

// A halo tile word: the guide pixel, and for the joint filter the source
// pixel after it.
template <bool kJoint>
struct TileWord {
  using type = uint32_t;
};
template <>
struct TileWord<true> {
  using type = uint2;
};

__device__ __forceinline__ uint32_t guide_of(uint32_t w) { return w; }
__device__ __forceinline__ uint32_t source_of(uint32_t w) { return w; }
__device__ __forceinline__ uint32_t guide_of(uint2 w) { return w.x; }
__device__ __forceinline__ uint32_t source_of(uint2 w) { return w.y; }

template <bool kJoint>
__device__ __forceinline__ typename TileWord<kJoint>::type tile_word(const uint8_t* guide,
                                                                     const uint8_t* src) {
  if constexpr (kJoint) {
    return make_uint2(load_pixel(guide), load_pixel(src));
  } else {
    return load_pixel(guide);
  }
}

// Byte c of a packed pixel as an exact float: 2^23 + b, less 2^23.
template <int kChannel>
__device__ __forceinline__ float channel(uint32_t word) {
  const uint32_t biased = __byte_perm(word, 0x4B000000u, 0x7540 + kChannel);
  return __fsub_rn(__uint_as_float(biased), 8388608.0f);
}

__device__ __forceinline__ uint8_t store_u8(float sum, float sumk, int rounding) {
  const float v = __fdiv_rn(sum, sumk);
  const float r = rounding == kRoundingRint ? rintf(v) : floorf(__fadd_rn(v, 0.5f));
  return static_cast<uint8_t>(static_cast<int>(r));
}

inline int set_smem(const void* kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace
