// Gradient magnitude for Hopper (sm_90a).
//
// Replaces the TPU kernel various_image_processings_tpu/ops/pallas/gradient.py
// ::_make_kernel (:20), behind gradient_pallas (:99).  Per pixel of an
// (H, W, C) image, u8 or f32, with the border replicated (clamped
// coordinates, which is what the reference's one-sided edge differences
// are):
//   hd_c = s(y, x+1, c) - s(y, x-1, c),  vd_c = s(y+1, x, c) - s(y-1, x, c)
//   out  = sqrt(sum_c (hd_c*hd_c + vd_c*vd_c))          -> (H, W) f32
// The sum runs over c in order, from 0.  u8 differences are exact integers
// (the TPU kernel subtracts in int); f32 subtracts in f32.  Every f32
// product and sum is rounded on its own (__fmul_rn / __fadd_rn, which nvcc
// never contracts into FMAs) and sqrtf is IEEE (no fast math), so the
// result is bit-equal to the plain PyTorch version, and for u8 to
// golden/gradient.py.
//
// What bounds it on the card: memory.  At 4K with 3 u8 channels it reads
// 24.9 MB and writes 33.2 MB (17 us at 3.35 TB/s) for ~19 f32 operations a
// pixel (2.3 us at 67 TFLOP/s).  Two kernels:
//   gradient_words_kernel, u8 with 1 or 3 channels and width % 4 == 0 (the
//     2-D op's (H, W) and the BTF path's (H, W, 3)): each row of a lane's
//     4 adjacent pixels is C whole words.  A warp takes 128 adjacent pixels
//     over a strip of 2 rows and loads the 4 rows it needs once, all before
//     it computes (2 rows a strip, not 8: more warps in flight, ahead at
//     600x900 and no slower at 4K, where the halo rows come from L2).  The
//     neighbours across a lane's edges come from the adjacent lanes by
//     shuffles.  Bytes become floats 2^23 + b by a byte permute, whose
//     differences are the exact integer differences, and the 4 magnitudes
//     go out as one 16-byte store: 0.025 ms at 4K, 1.45x the byte bound
//     (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//   gradient_kernel, everything else (f32, other channel counts, rows that
//     are not whole words, an image off a word boundary): one thread a
//     pixel reads its four neighbours from global memory, the 3x3 reuse
//     served by L1.  Its byte-wide loads at a C-byte stride made it 3.4x
//     its byte bound on the BTF path, which is why u8 takes the word
//     kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kWordPix = 4;     // word kernel: adjacent pixels a lane
constexpr int kStrip = 2;       // word kernel: rows a lane
constexpr int kStripWarps = 4;  // word kernel: warps a block, each a strip of its own
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int clamp_index(int i, int n) { return min(max(i, 0), n - 1); }

__device__ __forceinline__ float difference(const uint8_t* p, int64_t a, int64_t b) {
  return static_cast<float>(static_cast<int>(p[a]) - static_cast<int>(p[b]));
}

__device__ __forceinline__ float difference(const float* p, int64_t a, int64_t b) {
  return __fsub_rn(p[a], p[b]);
}

template <typename T>
__global__ void __launch_bounds__(kTileW * kTileH)
gradient_kernel(const T* __restrict__ src, float* __restrict__ out, int height, int width,
                int channels) {
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= width || y >= height) return;
  const int64_t row = static_cast<int64_t>(width) * channels;
  const int64_t up = max(y - 1, 0) * row + static_cast<int64_t>(x) * channels;
  const int64_t down = min(y + 1, height - 1) * row + static_cast<int64_t>(x) * channels;
  const int64_t left = y * row + static_cast<int64_t>(max(x - 1, 0)) * channels;
  const int64_t right = y * row + static_cast<int64_t>(min(x + 1, width - 1)) * channels;
  float total = 0.0f;
  for (int c = 0; c < channels; ++c) {
    const float hd = difference(src, right + c, left + c);
    const float vd = difference(src, down + c, up + c);
    total = __fadd_rn(total, __fadd_rn(__fmul_rn(hd, hd), __fmul_rn(vd, vd)));
  }
  out[static_cast<int64_t>(y) * width + x] = sqrtf(total);
}

// Byte n of a word as the float 2^23 + byte.  The difference of two such
// floats is exact: the integer difference of the bytes, as a float.
__device__ __forceinline__ float biased(uint32_t word, int n) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + n));
}

// Byte b of a lane's kC words.
template <int kC>
__device__ __forceinline__ float byte_of(const uint32_t (&w)[kC], int b) {
  return biased(w[b / 4], b % 4);
}

// u8, kC channels, width % 4 == 0 and a 4-byte aligned image, so that a
// lane's 4 pixels of a row are kC words, all inside the image or all
// outside it.  Lane l of a warp takes pixels x = 4 l .. 4 l + 3 of the
// warp's 128 over kStrip rows.
template <int kC>
__global__ void __launch_bounds__(kLanes * kStripWarps)
gradient_words_kernel(const uint8_t* __restrict__ src, float* __restrict__ out, int height,
                      int width) {
  static_assert(kC >= 1 && kC <= 4, "4 pixels of kC bytes are kC words");
  const int lane = threadIdx.x;
  const int x = (blockIdx.x * kLanes + lane) * kWordPix;
  const int y0 = (blockIdx.y * kStripWarps + threadIdx.y) * kStrip;
  if (y0 >= height) return;  // the whole warp
  const bool inside = x < width;
  const int64_t row_words = static_cast<int64_t>(width / 4) * kC;
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(src) + static_cast<int64_t>(x / 4) * kC;

  // rows y0 - 1 .. y0 + kStrip, clamped, all loaded before any is used
  uint32_t w[kStrip + 2][kC];
#pragma unroll
  for (int i = 0; i < kStrip + 2; ++i) {
    const int64_t r = clamp_index(y0 - 1 + i, height) * row_words;
#pragma unroll
    for (int j = 0; j < kC; ++j) w[i][j] = inside ? words[r + j] : 0u;
  }
#pragma unroll
  for (int i = 1; i <= kStrip; ++i) {
    const int y = y0 + i - 1;
    // pixel x - 1 is the last kC bytes of the word before the lane's, pixel
    // x + 4 the first kC bytes of the word after them: from the adjacent
    // lanes, or loaded at the warp's edges
    uint32_t left = __shfl_up_sync(kFullMask, w[i][kC - 1], 1);
    uint32_t right = __shfl_down_sync(kFullMask, w[i][0], 1);
    if (y >= height) break;  // the whole warp
    const int64_t r = static_cast<int64_t>(y) * row_words;
    if (lane == 0 && inside && x > 0) left = words[r - 1];
    if (lane == kLanes - 1 && inside && x + kWordPix < width) right = words[r + kC];
    // the image's edges are replicated: the lane's own first or last pixel
    if (x == 0) left = w[i][0] << (8 * (4 - kC));
    if (x + kWordPix >= width) right = w[i][kC - 1] >> (8 * (4 - kC));
    if (!inside) continue;
    float total[kWordPix];
#pragma unroll
    for (int p = 0; p < kWordPix; ++p) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int b = p * kC + c;
        const float l = p == 0 ? biased(left, 4 - kC + c) : byte_of<kC>(w[i], b - kC);
        const float rt = p == kWordPix - 1 ? biased(right, c) : byte_of<kC>(w[i], b + kC);
        const float hd = __fsub_rn(rt, l);
        const float vd = __fsub_rn(byte_of<kC>(w[i + 1], b), byte_of<kC>(w[i - 1], b));
        const float sq = __fadd_rn(__fmul_rn(hd, hd), __fmul_rn(vd, vd));
        total[p] = c == 0 ? sq : __fadd_rn(total[p], sq);
      }
    }
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(y) * width + x) =
        make_float4(sqrtf(total[0]), sqrtf(total[1]), sqrtf(total[2]), sqrtf(total[3]));
  }
}

template <typename T>
int launch(const void* src, void* out, int height, int width, int channels,
           cudaStream_t stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  gradient_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(src),
                                                 static_cast<float*>(out), height, width,
                                                 channels);
  return static_cast<int>(cudaGetLastError());
}

template <int kC>
int launch_words(const void* src, void* out, int height, int width, cudaStream_t stream) {
  const dim3 block(kLanes, kStripWarps);
  const dim3 grid((width + kLanes * kWordPix - 1) / (kLanes * kWordPix),
                  (height + kStrip * kStripWarps - 1) / (kStrip * kStripWarps));
  gradient_words_kernel<kC><<<grid, block, 0, stream>>>(static_cast<const uint8_t*>(src),
                                                        static_cast<float*>(out), height, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// src: (height, width, channels) contiguous, u8 (is_float == 0) or f32.
// out: (height, width) f32.  Returns the launch's cudaError_t.  The kernel
// is chosen by dtype, channel count, width and alignment.
int vip_gradient(const void* src, void* out, int height, int width, int channels,
                 int is_float, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const bool words = !is_float && width % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (words && channels == 1) return launch_words<1>(src, out, height, width, st);
  if (words && channels == 3) return launch_words<3>(src, out, height, width, st);
  if (is_float) return launch<float>(src, out, height, width, channels, st);
  return launch<uint8_t>(src, out, height, width, channels, st);
}

}  // extern "C"
