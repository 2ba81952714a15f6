// Bilateral / joint bilateral filter for Hopper (sm_90a): one kernel for
// every ksize, border and rounding mode.
//
// Replaces three TPU kernels in various_image_processings_tpu/ops/pallas/bilateral.py,
// which all compute this one function:
//   _make_kernel         (:117)  taps <= 120, fully unrolled pair-symmetric stencil
//   _make_partial_kernel (:177)  120 < taps <= 480, partial sums added outside
//   _make_chunked_kernel (:296)  taps > 480, a grid axis over tap rows
// They are three only because Mosaic keeps every unrolled tap alive in VMEM.
// Here the tap loop is rolled over a host-built tap table, so one kernel
// covers every k, and the host side of ops/pallas/_stencil.py (tiling,
// padding, planar relayout) becomes this kernel's own halo load.
//
// Per block: a (TH+2r) x (TW+2r) halo tile of the guide (and of the source,
// for the joint filter) is read straight from the HWC u8 image into shared
// memory, one 32-bit word per pixel (b, g, r, 0), with the border folded in
// the load: clamped for replicate, reflected (repeatedly, as
// cv::borderInterpolate) for reflect-101.  So there is no separate pad pass.
// The 768-entry f32 range LUT goes to shared memory beside it.
//
// Per pixel, for each tap (dy, dx, ws) in the reference's (ky, kx) order:
//   d  = sum_c |g(p+t) - g(p)|     (one __vsadu4 on the packed words)
//   wk = ws * lut[d]
//   sum_c += s_c(p+t) * wk;  sumk += wk
// and the store is u8(floor(sum_c / sumk + 0.5)) or u8(rint(sum_c / sumk)).
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, which
// nvcc never contracts into FMAs) and the division is a true IEEE division
// (__fdiv_rn): contraction and reciprocal-multiplies are what flipped u8
// results on the JAX side (PARITY.md D1b/D1c).
//
// Why the LUT and not the TPU's exp: the TPU kernels recompute the range
// weight as exp2(d^2 * coeff * log2e + log2 ws) because gathers serialize
// on its vector unit, which costs them up to one u8 against the golden
// layer.  On Hopper a shared-memory gather is one instruction, it is what
// the reference's own CUDA kernel does, and with the same f64-built table
// and the same op order the result is bit-exact to golden/bilateral.py.
//
// What bounds it on the card: at 4K and k=9, 49 taps x ~20 instructions x
// 8.29 M pixels is about 8 G thread-instructions against ~50 MB of device
// memory traffic, so it is bound by instruction issue (ALU, byte-to-float
// conversions, two shared-memory loads per tap), not by bandwidth.  Pair
// symmetry, several pixels per thread and TMA halo loads are left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
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

__device__ __forceinline__ float channel(uint32_t word, int c) {
  return static_cast<float>((word >> (8 * c)) & 0xffu);
}

__device__ __forceinline__ uint8_t store_u8(float sum, float sumk, int rounding) {
  const float v = __fdiv_rn(sum, sumk);
  const float r = rounding == kRoundingRint ? rintf(v) : floorf(__fadd_rn(v, 0.5f));
  return static_cast<uint8_t>(static_cast<int>(r));
}

template <bool kJoint>
__global__ void __launch_bounds__(kThreads)
bilateral_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ guide,
                 uint8_t* __restrict__ out, int height, int width,
                 const int4* __restrict__ taps, int n_taps,
                 const float* __restrict__ lut, int radius, int border, int rounding) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  uint32_t* s_guide = reinterpret_cast<uint32_t*>(s_lut + kLutSize);
  const int tile_w = kTileW + 2 * radius;
  const int tile_n = tile_w * (kTileH + 2 * radius);
  uint32_t* s_src = kJoint ? s_guide + tile_n : s_guide;

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kLutSize; i += kThreads) s_lut[i] = lut[i];

  const int x0 = blockIdx.x * kTileW - radius;
  const int y0 = blockIdx.y * kTileH - radius;
  for (int i = tid; i < tile_n; i += kThreads) {
    const int ly = i / tile_w;
    const int lx = i - ly * tile_w;
    const size_t p = (static_cast<size_t>(fold(y0 + ly, height, border)) * width +
                      fold(x0 + lx, width, border)) * 3;
    s_guide[i] = load_pixel(guide + p);
    if (kJoint) s_src[i] = load_pixel(src + p);
  }
  __syncthreads();

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= width || y >= height) return;

  const int base = threadIdx.y * tile_w + threadIdx.x;
  const uint32_t center = s_guide[base + radius * tile_w + radius];
  float sum0 = 0.0f, sum1 = 0.0f, sum2 = 0.0f, sumk = 0.0f;
  for (int t = 0; t < n_taps; ++t) {
    const int4 tap = __ldg(taps + t);  // (dy, dx, bits of ws, 0), same for every thread
    const int off = base + tap.x * tile_w + tap.y;
    const uint32_t g = s_guide[off];
    const float wk = __fmul_rn(__int_as_float(tap.z), s_lut[__vsadu4(g, center)]);
    const uint32_t s = kJoint ? s_src[off] : g;
    sum0 = __fadd_rn(sum0, __fmul_rn(channel(s, 0), wk));
    sum1 = __fadd_rn(sum1, __fmul_rn(channel(s, 1), wk));
    sum2 = __fadd_rn(sum2, __fmul_rn(channel(s, 2), wk));
    sumk = __fadd_rn(sumk, wk);
  }
  uint8_t* o = out + (static_cast<size_t>(y) * width + x) * 3;
  o[0] = store_u8(sum0, sumk, rounding);
  o[1] = store_u8(sum1, sumk, rounding);
  o[2] = store_u8(sum2, sumk, rounding);
}

template <bool kJoint>
int launch(const uint8_t* src, const uint8_t* guide, uint8_t* out, int height, int width,
           const int4* taps, int n_taps, const float* lut, int radius, int border,
           int rounding, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bilateral_kernel<kJoint>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  bilateral_kernel<kJoint><<<grid, block, static_cast<size_t>(smem), stream>>>(
      src, guide, out, height, width, taps, n_taps, lut, radius, border, rounding);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: the LUT and one (self) or two (joint)
// halo tiles of 32-bit pixels.
long long vip_bilateral_smem_bytes(int radius, int joint) {
  const long long tile = static_cast<long long>(kTileW + 2 * radius) * (kTileH + 2 * radius);
  return kLutSize * 4LL + (joint ? 2 : 1) * tile * 4;
}

// guide == nullptr: the self filter.  taps: n_taps int4 (dy, dx, f32 bits of
// ws, 0) in (ky, kx) order, dy/dx in [0, 2*radius].  lut: 768 f32.
// Returns the launch's cudaError_t (0 on success).
int vip_bilateral_u8(const void* src, const void* guide, void* out, int height, int width,
                     const void* taps, int n_taps, const void* lut, int radius, int border,
                     int rounding, long long smem, void* stream) {
  const auto* s = static_cast<const uint8_t*>(src);
  const auto* t = static_cast<const int4*>(taps);
  const auto* l = static_cast<const float*>(lut);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (guide == nullptr) {
    return launch<false>(s, s, o, height, width, t, n_taps, l, radius, border, rounding, smem, st);
  }
  return launch<true>(s, static_cast<const uint8_t*>(guide), o, height, width, t, n_taps, l,
                      radius, border, rounding, smem, st);
}

const char* vip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
