// Bilateral texture filter stages for Hopper (sm_90a): blur + mRTV, and the
// guide.  With the gradient (gradient.cu) and the joint bilateral filter
// (bilateral.cu) they make one BTF iteration, four launches.
//
// Replaces two TPU kernels in
// various_image_processings_tpu/ops/pallas/bilateral_texture.py:
//   _make_blur_rtv_kernel (:39)   -> blur_rtv_kernel
//   _make_guide_kernel    (:137)  -> guide_kernel
// Both read a k x k window with the border replicated.  Per block, a
// (TH+2r) x (TW+2r) halo tile goes to shared memory with the border clamped
// in the load (no pad pass), one thread per output pixel.
//
// blur_rtv_kernel: (H, W, 3) u8 image + (H, W) f32 gradient magnitude G ->
//   blurred_c = (sum of the window's u8 values, an exact int) / k^2
//   I         = (b + g + r) / 3, computed once per tile pixel in the load
//   rtv       = (max I - min I) * max G / (sum G + eps)
// The window sum of G is order-sensitive in f32 and runs in the reference's
// (ky, kx) scan order; the int sums and min/max are exact in any order.
//
// guide_kernel: blurred (H, W, 3) f32 + rtv (H, W) f32 -> (H, W, 3) u8:
//   the first minimum of rtv over the window in (ky, kx) order (strict <),
//   alpha = 2 / (1 + exp(sigma_alpha * (rtv_center - rtv_min))) - 1,
//   guide_c = clamp(trunc(alpha * blurred_c[argmin]
//                         + (1 - alpha) * blurred_c[center] + 0.5), 0, 255).
// Only rtv is tiled: the blurred values are read once per pixel from global
// memory, at the centre and at the argmin.
//
// Exactness (PARITY.md D1b/D1c: each of these moved the JAX side by tens
// of u8 once the guide's argmin flipped):
//   - every division is a true IEEE division (__fdiv_rn: /3, /k^2, the rtv
//     quotient and 2/(1+e)), never a multiply by a reciprocal;
//   - every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
//     __fsub_rn, which nvcc never contracts into FMAs);
//   - exp is expf without fast math, what PyTorch's torch.exp computes on
//     the card, so the kernel is bit-equal to the plain version there;
//   - eps and sigma_alpha = f32(1) / f32(5k) are f32 values made on the host.
//
// What bounds them on the card: memory.  At 4K (8.29 MP) blur+mRTV moves
// 190.8 MB (57 us at 3.35 TB/s) and the guide 157.6 MB (47 us).  This
// first version loops over all k^2 taps per pixel, so it is bound by
// instruction issue instead (~12 instructions a tap at k = 9); the
// separable passes the TPU kernel uses for the box sums, min/max and the
// argmin are exact and are left for later.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;

__device__ __forceinline__ int clamp_index(int i, int n) { return min(max(i, 0), n - 1); }

__global__ void __launch_bounds__(kThreads)
blur_rtv_kernel(const uint8_t* __restrict__ img, const float* __restrict__ mag,
                float* __restrict__ blurred, float* __restrict__ rtv, int height, int width,
                int ksize, float epsilon) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int radius = ksize / 2;
  const int tile_w = kTileW + 2 * radius;
  const int tile_n = tile_w * (kTileH + 2 * radius);
  uint32_t* s_pix = reinterpret_cast<uint32_t*>(smem);
  float* s_int = reinterpret_cast<float*>(s_pix + tile_n);
  float* s_mag = s_int + tile_n;

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int x0 = blockIdx.x * kTileW - radius;
  const int y0 = blockIdx.y * kTileH - radius;
  for (int i = tid; i < tile_n; i += kThreads) {
    const int ly = i / tile_w;
    const int lx = i - ly * tile_w;
    const int64_t p = static_cast<int64_t>(clamp_index(y0 + ly, height)) * width +
                      clamp_index(x0 + lx, width);
    const uint32_t b = img[3 * p], g = img[3 * p + 1], r = img[3 * p + 2];
    s_pix[i] = b | (g << 8) | (r << 16);
    s_int[i] = __fdiv_rn(static_cast<float>(b + g + r), 3.0f);
    s_mag[i] = mag[p];
  }
  __syncthreads();

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= width || y >= height) return;

  const int base = threadIdx.y * tile_w + threadIdx.x;
  int sum0 = 0, sum1 = 0, sum2 = 0;
  float i_max = 0.0f, i_min = 256.0f, m_max = 0.0f, m_sum = 0.0f;
  for (int ky = 0; ky < ksize; ++ky) {
    const int row = base + ky * tile_w;
    for (int kx = 0; kx < ksize; ++kx) {
      const uint32_t pix = s_pix[row + kx];
      sum0 += pix & 0xffu;
      sum1 += (pix >> 8) & 0xffu;
      sum2 += pix >> 16;
      const float iw = s_int[row + kx];
      i_max = fmaxf(i_max, iw);
      i_min = fminf(i_min, iw);
      const float mw = s_mag[row + kx];
      m_max = fmaxf(m_max, mw);
      m_sum = __fadd_rn(m_sum, mw);
    }
  }
  const int64_t p = static_cast<int64_t>(y) * width + x;
  const float k2 = static_cast<float>(ksize * ksize);
  blurred[3 * p] = __fdiv_rn(static_cast<float>(sum0), k2);
  blurred[3 * p + 1] = __fdiv_rn(static_cast<float>(sum1), k2);
  blurred[3 * p + 2] = __fdiv_rn(static_cast<float>(sum2), k2);
  rtv[p] = __fdiv_rn(__fmul_rn(__fsub_rn(i_max, i_min), m_max), __fadd_rn(m_sum, epsilon));
}

__device__ __forceinline__ uint8_t blend(float alpha, float one_m, float bmin, float bctr) {
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(alpha, bmin), __fmul_rn(one_m, bctr)), 0.5f);
  return static_cast<uint8_t>(static_cast<int>(fminf(fmaxf(truncf(v), 0.0f), 255.0f)));
}

__global__ void __launch_bounds__(kThreads)
guide_kernel(const float* __restrict__ blurred, const float* __restrict__ rtv,
             uint8_t* __restrict__ guide, int height, int width, int ksize, float sigma_alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int radius = ksize / 2;
  const int tile_w = kTileW + 2 * radius;
  const int tile_n = tile_w * (kTileH + 2 * radius);
  float* s_rtv = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int x0 = blockIdx.x * kTileW - radius;
  const int y0 = blockIdx.y * kTileH - radius;
  for (int i = tid; i < tile_n; i += kThreads) {
    const int ly = i / tile_w;
    const int lx = i - ly * tile_w;
    s_rtv[i] = rtv[static_cast<int64_t>(clamp_index(y0 + ly, height)) * width +
                   clamp_index(x0 + lx, width)];
  }
  __syncthreads();

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= width || y >= height) return;

  const int base = threadIdx.y * tile_w + threadIdx.x;
  float best = FLT_MAX;
  int best_ky = -1, best_kx = 0;
  for (int ky = 0; ky < ksize; ++ky) {
    const int row = base + ky * tile_w;
    for (int kx = 0; kx < ksize; ++kx) {
      const float v = s_rtv[row + kx];
      if (v < best) {  // strict: the first minimum in (ky, kx) order wins
        best = v;
        best_ky = ky;
        best_kx = kx;
      }
    }
  }
  const float center = s_rtv[base + radius * tile_w + radius];
  const float e = expf(__fmul_rn(sigma_alpha, __fsub_rn(center, best)));
  const float alpha = __fsub_rn(__fdiv_rn(2.0f, __fadd_rn(1.0f, e)), 1.0f);
  const float one_m = __fsub_rn(1.0f, alpha);

  const int64_t p = static_cast<int64_t>(y) * width + x;
  const int64_t q = static_cast<int64_t>(clamp_index(y + best_ky - radius, height)) * width +
                    clamp_index(x + best_kx - radius, width);
  for (int c = 0; c < 3; ++c) {
    // no window value below FLT_MAX: the blend takes 0, as the plain version does
    const float bmin = best_ky < 0 ? 0.0f : blurred[3 * q + c];
    guide[3 * p + c] = blend(alpha, one_m, bmin, blurred[3 * p + c]);
  }
}

int set_smem(const void* kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

long long tile_pixels(int radius) {
  return static_cast<long long>(kTileW + 2 * radius) * (kTileH + 2 * radius);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: the pixel word, intensity and
// magnitude of each halo-tile pixel.
long long vip_blur_rtv_smem_bytes(int radius) { return tile_pixels(radius) * 12; }

// Dynamic shared memory of one block: rtv of each halo-tile pixel.
long long vip_guide_smem_bytes(int radius) { return tile_pixels(radius) * 4; }

// img: (height, width, 3) u8; magnitude: (height, width) f32.
// blurred: (height, width, 3) f32; rtv: (height, width) f32.
// Returns the launch's cudaError_t.
int vip_blur_rtv(const void* img, const void* magnitude, void* blurred, void* rtv, int height,
                 int width, int ksize, float epsilon, long long smem, void* stream) {
  const int err = set_smem(reinterpret_cast<const void*>(blur_rtv_kernel), smem);
  if (err != 0) return err;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  blur_rtv_kernel<<<grid, block, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const float*>(magnitude),
      static_cast<float*>(blurred), static_cast<float*>(rtv), height, width, ksize, epsilon);
  return static_cast<int>(cudaGetLastError());
}

// blurred: (height, width, 3) f32; rtv: (height, width) f32;
// guide: (height, width, 3) u8.  Returns the launch's cudaError_t.
int vip_guide(const void* blurred, const void* rtv, void* guide, int height, int width,
              int ksize, float sigma_alpha, long long smem, void* stream) {
  const int err = set_smem(reinterpret_cast<const void*>(guide_kernel), smem);
  if (err != 0) return err;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  guide_kernel<<<grid, block, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blurred), static_cast<const float*>(rtv),
      static_cast<uint8_t*>(guide), height, width, ksize, sigma_alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
