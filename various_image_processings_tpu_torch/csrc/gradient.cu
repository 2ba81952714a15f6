// Gradient magnitude for Hopper (sm_90a).
//
// Replaces the TPU kernel various_image_processings_tpu/ops/pallas/gradient.py
// ::_make_kernel (:20), behind gradient_pallas (:99).  Per pixel of an
// (H, W, C) image, u8 or f32, with the border replicated (clamped
// coordinates, which is what the reference's one-sided edge differences
// are):
//   hd_c = s(y, x+1, c) - s(y, x-1, c),  vd_c = s(y+1, x, c) - s(y-1, x, c)
//   out  = sqrt(sum_c (hd_c*hd_c + vd_c*vd_c))          -> (H, W) f32
// The channel count is a runtime loop and the sum runs over c in order,
// from 0.  u8 subtracts in int and converts the difference (exact, as the
// TPU kernel does); f32 subtracts in f32.  Every f32 product and sum is
// rounded on its own (__fmul_rn / __fadd_rn, which nvcc never contracts
// into FMAs) and sqrtf is IEEE (no fast math), so the result is bit-equal
// to the plain PyTorch version, and for u8 to golden/gradient.py.
//
// What bounds it on the card: memory.  At 4K with 3 u8 channels it reads
// 24.9 MB and writes 33.2 MB (17 us at 3.35 TB/s) for ~19 f32 operations a
// pixel (2.3 us at 67 TFLOP/s).  One thread a pixel reads its four
// neighbours straight from global memory; the 3x3 reuse is served by L1,
// so no shared-memory tile is needed.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;

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

}  // namespace

extern "C" {

// src: (height, width, channels) contiguous, u8 (is_float == 0) or f32.
// out: (height, width) f32.  Returns the launch's cudaError_t.
int vip_gradient(const void* src, void* out, int height, int width, int channels,
                 int is_float, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_float) return launch<float>(src, out, height, width, channels, st);
  return launch<uint8_t>(src, out, height, width, channels, st);
}

}  // extern "C"
