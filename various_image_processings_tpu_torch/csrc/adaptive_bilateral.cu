// Adaptive bilateral filter for Hopper (sm_90a): one kernel for every ksize
// whose halo tile fits in a block's shared memory.
//
// Replaces the TPU kernel various_image_processings_tpu/ops/pallas/adaptive_bilateral.py
// ::_make_kernel (:74).  That kernel recomputes each range weight as
// exp2(d^2 * coeff * log2e + 64) with add-subtract grid rounding, because
// gathers serialize on the TPU's vector unit, and it is unrolled over at
// most 120 taps because Mosaic keeps every unrolled tap alive in VMEM.
// Here the weight is a shared-memory gather from the reference's own
// f64-built, f32-stored 1536-entry table (the reference's CUDA design,
// src/adaptive_bilateral_filter_impl.cu), the tap loop is rolled over a
// host-built tap table, and the result is bit-exact to
// golden/adaptive_bilateral.py, subnormal weights included.
//
// Per block (32 x 8 output pixels, one a thread):
//   1. a (TH+2r) x (TW+2r) halo tile of the HWC u8 image goes to shared
//      memory, one 32-bit word per pixel (b, g, r, 0), with the replicate
//      border folded into the load; the LUT goes beside it;
//   2. box sums of the (2r+1)^2 window, separable and in integers (exact in
//      any order): a row pass over (TH+2r) x TW into shared memory, then a
//      column pass per thread.  The window of the box mean is the window of
//      the taps, so the one tile serves both (the TPU kernel's in-tile box(),
//      the reference CUDA kernel's first pass);
//   3. per pixel, offset o_c = c_c - box_c / k^2 (a true IEEE division), and
//      for each tap (dy, dx, ws) in the reference's (ky, kx) order:
//        a_c  = |(p_c - c_c) - o_c|          (p_c - c_c is exact)
//        idx  = trunc((a_0 + a_1) + a_2)      (<= 1530, the C++ order)
//        wk   = ws * lut[idx]
//        sum_c += p_c * wk;  sumk += wk
//   4. store u8(floor(sum_c / sumk + 0.5)), or 0 where sumk == 0: there every
//      weight underflowed, the reference divides 0/0 and its NaN casts to 0.
// Every op is an _rn intrinsic, which nvcc never contracts into an FMA, and
// the build has no -use_fast_math, so subnormals are kept (-ftz=false):
// contraction, reciprocal multiplies and flushed weights are what cost the
// JAX side tens of u8 (PARITY.md D2/D2b/D2c).
//
// What bounds it on the card: at 4K and k=9, 49 taps x ~19 f32 operations
// plus ~6k+20 a pixel for the box sums and the store, ~1000 operations a
// pixel x 8.29 M pixels, against ~50 MB of device memory traffic; so it is
// bound by instruction issue (byte extracts and conversions, the shared LUT
// gather, the sums), not by bandwidth.  Several pixels a thread, pair
// symmetry of the spatial weights and cheaper byte-to-float conversion are
// left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kLutSize = 512 * 3;

__device__ __forceinline__ uint32_t byte_of(uint32_t word, int c) {
  return (word >> (8 * c)) & 0xffu;
}

__device__ __forceinline__ uint8_t store_u8(float sum, float sumk) {
  if (sumk == 0.0f) return 0;
  return static_cast<uint8_t>(static_cast<int>(floorf(__fadd_rn(__fdiv_rn(sum, sumk), 0.5f))));
}

__global__ void __launch_bounds__(kThreads)
adaptive_bilateral_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
                          int height, int width, const int4* __restrict__ taps, int n_taps,
                          const float* __restrict__ lut, int radius) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ksize = 2 * radius + 1;
  const int tile_w = kTileW + 2 * radius;
  const int tile_h = kTileH + 2 * radius;
  const int row_n = tile_h * kTileW;  // entries of one channel's row-sum plane
  float* s_lut = reinterpret_cast<float*>(smem);
  uint32_t* s_tile = reinterpret_cast<uint32_t*>(s_lut + kLutSize);
  int* s_row = reinterpret_cast<int*>(s_tile + tile_w * tile_h);  // 3 planes of row_n

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kLutSize; i += kThreads) s_lut[i] = lut[i];

  const int x0 = blockIdx.x * kTileW - radius;
  const int y0 = blockIdx.y * kTileH - radius;
  for (int i = tid; i < tile_w * tile_h; i += kThreads) {
    const int ly = i / tile_w;
    const int lx = i - ly * tile_w;
    const int gy = min(max(y0 + ly, 0), height - 1);
    const int gx = min(max(x0 + lx, 0), width - 1);
    const uint8_t* p = src + (static_cast<size_t>(gy) * width + gx) * 3;
    s_tile[i] = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
                (static_cast<uint32_t>(p[2]) << 16);
  }
  __syncthreads();

  // box sums, row pass: each tile row, each output column, ksize columns
  for (int i = tid; i < row_n; i += kThreads) {
    const int ly = i / kTileW;
    const uint32_t* row = s_tile + ly * tile_w + (i - ly * kTileW);
    int b0 = 0, b1 = 0, b2 = 0;
    for (int dx = 0; dx < ksize; ++dx) {
      const uint32_t v = row[dx];
      b0 += byte_of(v, 0);
      b1 += byte_of(v, 1);
      b2 += byte_of(v, 2);
    }
    s_row[i] = b0;
    s_row[row_n + i] = b1;
    s_row[2 * row_n + i] = b2;
  }
  __syncthreads();

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= width || y >= height) return;

  // box sums, column pass: exact integers <= 255 k^2 < 2^24
  int b0 = 0, b1 = 0, b2 = 0;
  for (int dy = 0; dy < ksize; ++dy) {
    const int i = (threadIdx.y + dy) * kTileW + threadIdx.x;
    b0 += s_row[i];
    b1 += s_row[row_n + i];
    b2 += s_row[2 * row_n + i];
  }
  const int base = threadIdx.y * tile_w + threadIdx.x;
  const uint32_t center = s_tile[base + radius * tile_w + radius];
  const float c0 = __uint2float_rn(byte_of(center, 0));
  const float c1 = __uint2float_rn(byte_of(center, 1));
  const float c2 = __uint2float_rn(byte_of(center, 2));
  const float k2 = __int2float_rn(ksize * ksize);
  const float o0 = __fsub_rn(c0, __fdiv_rn(__int2float_rn(b0), k2));
  const float o1 = __fsub_rn(c1, __fdiv_rn(__int2float_rn(b1), k2));
  const float o2 = __fsub_rn(c2, __fdiv_rn(__int2float_rn(b2), k2));

  float sum0 = 0.0f, sum1 = 0.0f, sum2 = 0.0f, sumk = 0.0f;
  for (int t = 0; t < n_taps; ++t) {
    const int4 tap = __ldg(taps + t);  // (dy, dx, bits of ws, 0), same for every thread
    const uint32_t p = s_tile[base + tap.x * tile_w + tap.y];
    const float p0 = __uint2float_rn(byte_of(p, 0));
    const float p1 = __uint2float_rn(byte_of(p, 1));
    const float p2 = __uint2float_rn(byte_of(p, 2));
    const float a0 = fabsf(__fsub_rn(__fsub_rn(p0, c0), o0));
    const float a1 = fabsf(__fsub_rn(__fsub_rn(p1, c1), o1));
    const float a2 = fabsf(__fsub_rn(__fsub_rn(p2, c2), o2));
    const int idx = __float2int_rz(__fadd_rn(__fadd_rn(a0, a1), a2));
    const float wk = __fmul_rn(__int_as_float(tap.z), s_lut[idx]);
    sum0 = __fadd_rn(sum0, __fmul_rn(p0, wk));
    sum1 = __fadd_rn(sum1, __fmul_rn(p1, wk));
    sum2 = __fadd_rn(sum2, __fmul_rn(p2, wk));
    sumk = __fadd_rn(sumk, wk);
  }
  uint8_t* o = out + (static_cast<size_t>(y) * width + x) * 3;
  o[0] = store_u8(sum0, sumk);
  o[1] = store_u8(sum1, sumk);
  o[2] = store_u8(sum2, sumk);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: the LUT, the halo tile of 32-bit
// pixels and three planes of int row sums.
long long vip_adaptive_bilateral_smem_bytes(int radius) {
  const long long tile_h = kTileH + 2 * radius;
  return kLutSize * 4LL + (kTileW + 2 * radius) * tile_h * 4 + 3 * tile_h * kTileW * 4;
}

// taps: n_taps int4 (dy, dx, f32 bits of ws, 0) in (ky, kx) order, dy/dx in
// [0, 2*radius].  lut: 1536 f32.  Returns the launch's cudaError_t (0 on
// success).
int vip_adaptive_bilateral_u8(const void* src, void* out, int height, int width,
                              const void* taps, int n_taps, const void* lut, int radius,
                              long long smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        adaptive_bilateral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  adaptive_bilateral_kernel<<<grid, block, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out), height, width,
      static_cast<const int4*>(taps), n_taps, static_cast<const float*>(lut), radius);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
