// Adaptive bilateral filter for Hopper (sm_90a): one kernel for every ksize.
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
// Per block: 8 rows of 128 pixels, 4 a thread, 32 columns apart (so a
// warp's shared-memory reads of one tap stay on 32 distinct banks).
//   1. a halo tile of the HWC u8 image goes to shared memory, one 32-bit
//      word per pixel (b, g, r, 0), with the replicate border folded into
//      the load; the LUT goes beside it;
//   2. box sums of the (2r+1)^2 window, separable and in integers (exact in
//      any order): a row pass over the tile rows into shared memory, then a
//      column pass per thread.  The window of the box mean is the window of
//      the taps, so one tile serves both (the TPU kernel's in-tile box(),
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
// The taps are staged in shared memory, 256 at a time, as (byte offset in
// the tile, ws) pairs: one broadcast 8-byte load a tap for 4 pixels.  No
// int-float conversion runs in the tap loop: __byte_perm puts a channel
// byte under the exponent of 2^23 (0x4B0000pp is 2^23 + p), so
// (2^23 + p) - (2^23 + c) is p - c in one exact FADD, and
// fma(2^23 + p, wk, -2^23 wk) is p wk rounded once; __fadd_rz(x, 2^23) is
// 2^23 + trunc(x) for x in [0, 2^23), so its bits less 0x4B000000 are the
// LUT index.
//
// Every radius: where the whole halo tile does not fit in shared memory,
// it is streamed through in bands of tap rows (or, past a few thousand
// columns, segments of one tap row), in (ky, kx) order.  The box sums take
// one pass over the bands (integers: any order) and the taps a second,
// with the accumulators held in registers; each band takes the taps before
// its end, so the taps are added in the one-tile order, bit for bit.
//
// What bounds it on the card: at 4K and k=9, 49 taps x ~19 f32 operations
// plus ~6k+20 a pixel, against ~50 MB of device memory traffic: instruction
// issue, not bandwidth.  Per tap and pixel the loop runs ~26 instructions
// (a tile word and a LUT gather from shared memory, 3 byte permutes, 8
// subtractions and sums to the index, the index add and its address, 2
// products, 3 FMAs and 4 sums); the first version ran ~30 with four
// quarter-rate conversions (3 I2F, 1 F2I), a 16-byte tap load per thread
// and the loop overhead of one pixel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kRows = 8;
constexpr int kPix = 4;                  // pixels a thread, kLanes apart
constexpr int kTileW = kLanes * kPix;    // output columns of a block
constexpr int kThreads = kLanes * kRows;
constexpr int kLutSize = 512 * 3;
constexpr int kTapChunk = 256;           // taps staged in shared memory at a time
constexpr long long kMaxSmem = 232448;   // dynamic shared memory one block can use (227 KB)

// LUT, tap chunk, then for a band of `rows` tap rows and `cols` tap columns
// the tile of (rows + 7) x (cols + 127) words and three planes of
// (rows + 7) x 128 int row sums.
long long band_bytes(int rows, int cols) {
  const long long tile_rows = rows + kRows - 1;
  return kLutSize * 4LL + kTapChunk * 8LL + tile_rows * (cols + kTileW - 1) * 4 +
         3 * tile_rows * kTileW * 4;
}

// A band covers every column of its tap rows where (rows + 7) full tile
// rows fit; else one tap row, cut into segments of `cols` columns.
struct BandPlan {
  int rows;
  int cols;
  long long smem;
};

BandPlan band_plan(int radius) {
  const int ksize = 2 * radius + 1;
  int rows = ksize, cols = ksize;
  if (band_bytes(rows, cols) > kMaxSmem) {
    const long long per_row = band_bytes(1, cols) - band_bytes(0, cols);
    rows = static_cast<int>((kMaxSmem - band_bytes(0, cols)) / per_row);
    if (rows < 1) {
      rows = 1;
      // band_bytes(1, c) grows by kRows * 4 bytes a column
      cols = static_cast<int>((kMaxSmem - band_bytes(1, 0)) / (kRows * 4));
    }
  }
  return {rows, cols, band_bytes(rows, cols)};
}

// 2^23 + byte c of a packed pixel, as a float.
template <int kChannel>
__device__ __forceinline__ float biased(uint32_t word) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + kChannel));
}

__device__ __forceinline__ uint32_t load_pixel(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16);
}

__device__ __forceinline__ uint8_t store_u8(float sum, float sumk) {
  if (sumk == 0.0f) return 0;
  return static_cast<uint8_t>(static_cast<int>(floorf(__fadd_rn(__fdiv_rn(sum, sumk), 0.5f))));
}

__global__ void __launch_bounds__(kThreads, 3)
adaptive_bilateral_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
                          int height, int width, const int4* __restrict__ taps, int n_taps,
                          const float* __restrict__ lut, int radius, int band_rows,
                          int band_cols) {
  static_assert(kThreads == kTapChunk, "each thread stages one tap of a chunk");
  extern __shared__ __align__(16) unsigned char smem[];
  const int ksize = 2 * radius + 1;
  const int tile_w = kTileW - 1 + band_cols;
  const int tile_h = band_rows + kRows - 1;
  const int plane = tile_h * kTileW;  // entries of one channel's row-sum plane
  float* s_lut = reinterpret_cast<float*>(smem);
  int2* s_taps = reinterpret_cast<int2*>(s_lut + kLutSize);
  uint32_t* s_tile = reinterpret_cast<uint32_t*>(s_taps + kTapChunk);
  int* s_row = reinterpret_cast<int*>(s_tile + tile_h * tile_w);  // 3 planes

  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < kLutSize; i += kThreads) s_lut[i] = lut[i];

  const int lane = threadIdx.x;  // pixel k of this thread is column lane + 32 k of the block
  const int bx = blockIdx.x * kTileW;
  const int by = blockIdx.y * kRows;
  const int y = by + threadIdx.y;
  const bool one_band = band_rows >= ksize && band_cols >= ksize;

  // tile rows d0 .. d1 + 6 and columns e0 .. e1 + 126 of the block's halo
  auto load_tile = [&](int d0, int d1, int e0, int e1) {
    const int rows = d1 - d0 + kRows - 1;
    const int cols = e1 - e0 + kTileW - 1;
    const int gy0 = by - radius + d0;
    const int gx0 = bx - radius + e0;
    for (int ly = threadIdx.y; ly < rows; ly += kRows) {
      const size_t row = static_cast<size_t>(min(max(gy0 + ly, 0), height - 1)) * width;
      for (int lx = threadIdx.x; lx < cols; lx += kLanes) {
        s_tile[ly * tile_w + lx] = load_pixel(src + (row + min(max(gx0 + lx, 0), width - 1)) * 3);
      }
    }
  };

  // pass 1: box sums, exact integers (<= 255 k^2), in any band order
  int box0[kPix], box1[kPix], box2[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) box0[k] = box1[k] = box2[k] = 0;
  for (int d0 = 0; d0 < ksize; d0 += band_rows) {
    const int d1 = min(d0 + band_rows, ksize);
    for (int e0 = 0; e0 < ksize; e0 += band_cols) {
      const int e1 = min(e0 + band_cols, ksize);
      __syncthreads();  // every thread is done with the previous band
      load_tile(d0, d1, e0, e1);
      __syncthreads();
      // row pass: each tile row, each output column, the band's tap columns
      const int n_rows = d1 - d0 + kRows - 1;
      const int n_cols = e1 - e0;
      for (int i = tid; i < n_rows * kTileW; i += kThreads) {
        const int ly = i / kTileW;
        const uint32_t* row = s_tile + ly * tile_w + (i - ly * kTileW);
        int s0 = 0, s1 = 0, s2 = 0;
        for (int dx = 0; dx < n_cols; ++dx) {
          const uint32_t v = row[dx];
          s0 += v & 0xffu;
          s1 += (v >> 8) & 0xffu;
          s2 += v >> 16;
        }
        s_row[i] = s0;
        s_row[plane + i] = s1;
        s_row[2 * plane + i] = s2;
      }
      __syncthreads();
      // column pass: the band's tap rows below each of the thread's pixels
      for (int dy = 0; dy < d1 - d0; ++dy) {
        const int i = (threadIdx.y + dy) * kTileW + lane;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          box0[k] += s_row[i + kLanes * k];
          box1[k] += s_row[plane + i + kLanes * k];
          box2[k] += s_row[2 * plane + i + kLanes * k];
        }
      }
    }
  }

  // centres (2^23 + c_c) and offsets o_c = c_c - box_c / k^2; a thread past
  // the image's edge reads an in-range pixel and stores nothing
  const float k2 = __int2float_rn(ksize * ksize);
  const size_t crow = static_cast<size_t>(min(y, height - 1)) * width;
  float cb0[kPix], cb1[kPix], cb2[kPix], o0[kPix], o1[kPix], o2[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int x = min(bx + lane + kLanes * k, width - 1);
    const uint32_t c = load_pixel(src + (crow + x) * 3);
    cb0[k] = biased<0>(c);
    cb1[k] = biased<1>(c);
    cb2[k] = biased<2>(c);
    o0[k] = __fsub_rn(__fsub_rn(cb0[k], 8388608.0f), __fdiv_rn(__int2float_rn(box0[k]), k2));
    o1[k] = __fsub_rn(__fsub_rn(cb1[k], 8388608.0f), __fdiv_rn(__int2float_rn(box1[k]), k2));
    o2[k] = __fsub_rn(__fsub_rn(cb2[k], 8388608.0f), __fdiv_rn(__int2float_rn(box2[k]), k2));
  }

  // pass 2: the taps, band by band in (ky, kx) order (one tile: the tile
  // of pass 1 is still in place)
  float sum0[kPix], sum1[kPix], sum2[kPix], sumk[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) sum0[k] = sum1[k] = sum2[k] = sumk[k] = 0.0f;
  const uint32_t* at0 = s_tile + threadIdx.y * tile_w + lane;
  int t0 = 0;  // first tap not yet added
  for (int d0 = 0; d0 < ksize; d0 += band_rows) {
    const int d1 = min(d0 + band_rows, ksize);
    for (int e0 = 0; e0 < ksize; e0 += band_cols) {
      const int e1 = min(e0 + band_cols, ksize);
      if (!one_band) {
        __syncthreads();  // every thread is done with the previous band
        load_tile(d0, d1, e0, e1);
      }
      for (;;) {
        // the band's taps, those before (d1 - 1, e1) in (ky, kx) order, as
        // (byte offset in the band's tile, bits of ws)
        int in_band = 0;
        if (t0 + tid < n_taps) {
          const int4 tap = __ldg(taps + t0 + tid);  // (dy, dx, bits of ws, 0)
          in_band = tap.x < d1 - 1 || (tap.x == d1 - 1 && tap.y < e1);
          if (in_band) s_taps[tid] = make_int2(((tap.x - d0) * tile_w + tap.y - e0) * 4, tap.z);
        }
        // the taps are sorted, so the band's are the first n; the barrier
        // also makes the tile and the staged taps visible
        const int n = __syncthreads_count(in_band);
#pragma unroll 2
        for (int t = 0; t < n; ++t) {
          const int2 tap = s_taps[t];  // the same for every thread: a broadcast
          const float ws = __int_as_float(tap.y);
          const uint32_t* at = reinterpret_cast<const uint32_t*>(
              reinterpret_cast<const unsigned char*>(at0) + tap.x);
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            const uint32_t w = at[kLanes * k];
            const float q0 = biased<0>(w), q1 = biased<1>(w), q2 = biased<2>(w);
            const float a0 = fabsf(__fsub_rn(__fsub_rn(q0, cb0[k]), o0[k]));
            const float a1 = fabsf(__fsub_rn(__fsub_rn(q1, cb1[k]), o1[k]));
            const float a2 = fabsf(__fsub_rn(__fsub_rn(q2, cb2[k]), o2[k]));
            const float dist = __fadd_rn(__fadd_rn(a0, a1), a2);
            const uint32_t idx = __float_as_uint(__fadd_rz(dist, 8388608.0f)) - 0x4B000000u;
            const float wk = __fmul_rn(ws, s_lut[idx]);
            // p wk rounded once: (2^23 + p) wk - 2^23 wk is p wk exactly, and
            // -2^23 wk is exact (a power of two), so the FMA rounds p wk alone
            const float nw = __fmul_rn(wk, -8388608.0f);
            sum0[k] = __fadd_rn(sum0[k], __fmaf_rn(q0, wk, nw));
            sum1[k] = __fadd_rn(sum1[k], __fmaf_rn(q1, wk, nw));
            sum2[k] = __fadd_rn(sum2[k], __fmaf_rn(q2, wk, nw));
            sumk[k] = __fadd_rn(sumk[k], wk);
          }
        }
        t0 += n;
        if (n < kTapChunk) break;
        __syncthreads();  // every thread is done with this chunk
      }
    }
  }

  if (y >= height) return;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int x = bx + lane + kLanes * k;
    if (x >= width) continue;
    uint8_t* o = out + (static_cast<size_t>(y) * width + x) * 3;
    o[0] = store_u8(sum0[k], sumk[k]);
    o[1] = store_u8(sum1[k], sumk[k]);
    o[2] = store_u8(sum2[k], sumk[k]);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at this radius: the whole tile, or
// one band of it.
long long vip_adaptive_bilateral_smem_bytes(int radius) { return band_plan(radius).smem; }

// Tap rows (which == 0) or tap columns (which == 1) a band covers; 2r + 1
// of both where the whole tile fits.
int vip_adaptive_bilateral_band(int radius, int which) {
  const BandPlan plan = band_plan(radius);
  return which == 0 ? plan.rows : plan.cols;
}

// taps: n_taps >= 1 int4 (dy, dx, f32 bits of ws, 0) in (ky, kx) order,
// dy/dx in [0, 2*radius].  lut: 1536 f32.  Returns the launch's
// cudaError_t (0 on success).
int vip_adaptive_bilateral_u8(const void* src, void* out, int height, int width,
                              const void* taps, int n_taps, const void* lut, int radius,
                              void* stream) {
  const BandPlan plan = band_plan(radius);
  if (plan.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        adaptive_bilateral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kLanes, kRows);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kRows - 1) / kRows);
  adaptive_bilateral_kernel<<<grid, block, static_cast<size_t>(plan.smem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out), height, width,
      static_cast<const int4*>(taps), n_taps, static_cast<const float*>(lut), radius,
      plan.rows, plan.cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
