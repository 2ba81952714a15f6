// Bilateral texture filter stages for Hopper (sm_90a): blur + mRTV, and the
// guide.  With the gradient (gradient.cu) and the joint bilateral filter
// (bilateral.cu) they make one BTF iteration, four launches.
//
// Replaces two TPU kernels in
// various_image_processings_tpu/ops/pallas/bilateral_texture.py:
//   _make_blur_rtv_kernel (:39)   -> blur_rtv_kernel
//   _make_guide_kernel    (:137)  -> guide_kernel, guide_band_kernel
// Both read a k x k window with the border replicated, from a halo tile in
// shared memory with the border clamped in the load (no pad pass).
//
// blur_rtv_kernel: (H, W, 3) u8 image + (H, W) f32 gradient magnitude G ->
//   blurred_c = (sum of the window's u8 values) / k^2
//   I         = (b + g + r) / 3
//   rtv       = (max I - min I) * max G / (sum G + eps)
// 8 rows of 128 pixels a block, 4 adjacent pixels a thread.  Separable, as
// the TPU kernel is: a row pass over the tile rows (k columns each) into
// shared-memory planes, then a column pass (k rows) per thread, for the
// int box sums (exact in any order while 255 k^2 < 2^24), the max and min
// of b + g + r (max/min of I are those divided by 3: a correctly rounded
// division is monotonic, so 2 divisions a pixel instead of one per tile
// pixel) and max G.  For the BTF's k = 9 the window is compiled in and the
// row pass takes 4 adjacent columns an item: its sums slide along the row
// and its max/min share the middle of the 4 windows.  The window sum of G
// is order-sensitive in f32 and runs in the reference's (ky, kx) order:
// one chain a pixel, fed from 16-byte reads of a tile row that serve the
// chains of the thread's 4 pixels.  Past k = 255 the box sums are f32
// chains in (ky, kx) order as well, as the plain version adds them.  The
// outputs go through shared memory so that each warp stores its row of the
// block contiguously.
//
// guide_kernel: blurred (H, W, 3) f32 + rtv (H, W) f32 -> (H, W, 3) u8:
//   the first minimum of rtv over the window in (ky, kx) order (strict <),
//   alpha = 2 / (1 + exp(sigma_alpha * (rtv_center - rtv_min))) - 1,
//   guide_c = clamp(trunc(alpha * blurred_c[argmin]
//                         + (1 - alpha) * blurred_c[center] + 0.5), 0, 255).
// One pixel a thread, all k^2 taps.  Only rtv is tiled: the blurred values
// are read once per pixel from global memory, at the centre and at the
// argmin.
//
// Every window: where a whole halo tile does not fit in shared memory
// (blur + mRTV past k = 119, the guide past k = 221), the tile is streamed
// through in bands of tap rows (past a few thousand columns, segments of
// one tap row), in (ky, kx) order, with every accumulator in registers: the
// ordered sums and the strict-< argmin see their taps in the one-tile order.
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
// What bounds them on the card: at 4K (8.29 MP) blur + mRTV moves 190.8 MB
// (57 us at 3.35 TB/s) and the guide 157.6 MB (47 us).  Blur + mRTV now
// runs ~380 instructions a pixel at k = 9 (the first version ran all k^2
// taps, ~12 instructions each): the row pass ~40 an item of 4 columns, the
// column pass and the 81-add chain of sum G ~20 a pixel and tap row, the
// tile load and the divisions the rest; so instruction issue and the
// latency of the tile load still bind, not bandwidth.  The guide still
// walks all k^2 taps (~6 instructions each).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kRows = 8;
constexpr int kThreads = kLanes * kRows;
constexpr int kBlurPix = 4;                   // blur + mRTV: adjacent pixels a thread
constexpr int kBlurW = kLanes * kBlurPix;     // blur + mRTV: output columns of a block
constexpr long long kMaxSmem = 232448;        // dynamic shared memory one block can use (227 KB)
constexpr int kMaxIntBoxK = 255;              // 255 k^2 < 2^24: the f32 box sum is exact

__device__ __forceinline__ int clamp_index(int i, int n) { return min(max(i, 0), n - 1); }

__device__ __forceinline__ uint32_t load_pixel(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16);
}

// Byte c of a packed pixel as an exact float: 2^23 + b, less 2^23.
template <int kChannel>
__device__ __forceinline__ float channel(uint32_t word) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + kChannel)),
                   8388608.0f);
}

// A band covers tap rows [d0, d0 + rows) and tap columns [e0, e0 + cols):
// every column where (rows + 7) full tile rows fit, else one tap row cut
// into column segments.
struct BandPlan {
  int rows;
  int cols;
  long long smem;
};

// bytes(rows, cols) grows linearly in rows (by bytes(1, c) - bytes(0, c))
// and, at one row, with cols: the widest segment that fits is found by
// bisection (1 column at least).
template <class Bytes>
BandPlan band_plan(int ksize, Bytes bytes) {
  int rows = ksize, cols = ksize;
  if (bytes(rows, cols) > kMaxSmem) {
    rows = static_cast<int>((kMaxSmem - bytes(0, cols)) / (bytes(1, cols) - bytes(0, cols)));
    if (rows < 1) {
      rows = 1;
      int lo = 1, hi = ksize;  // bytes(1, hi) does not fit
      while (hi - lo > 1) {
        const int mid = lo + (hi - lo) / 2;
        (bytes(1, mid) <= kMaxSmem ? lo : hi) = mid;
      }
      cols = lo;
    }
  }
  return {rows, cols, bytes(rows, cols)};
}

// blur + mRTV: the band's tile rows hold pitch(cols) pixel words and as
// many magnitudes (the 4-wide reads of the ordered sums run up to 3
// columns past the 127 + cols a row needs; a multiple of 4 keeps every row
// 16-byte aligned), then six planes of 128 row-pass results a tile row.
__host__ __device__ constexpr int blur_pitch(int cols) { return (cols + kBlurW + 2 + 3) / 4 * 4; }

long long blur_bytes(int rows, int cols) {
  return static_cast<long long>(rows + kRows - 1) * (blur_pitch(cols) * 8LL + 6LL * kBlurW * 4);
}

BandPlan blur_plan(int ksize) { return band_plan(ksize, blur_bytes); }

// guide: the band's tile of (rows + 7) x (cols + 31) rtv values.
long long guide_bytes(int rows, int cols) {
  return static_cast<long long>(rows + kRows - 1) * (cols + kLanes - 1) * 4;
}

BandPlan guide_plan(int ksize) { return band_plan(ksize, guide_bytes); }

// kK: the window at compile time (0: taken from ksize at run time, in
// bands).  kOrderedBox: the box sums as f32 sums in (ky, kx) order, as the
// plain version takes them, for windows where 255 k^2 passes 2^24 and an
// f32 sum rounds; below that they are integers, exact in any order.
template <int kK, bool kOrderedBox>
__global__ void __launch_bounds__(kThreads, 3)
blur_rtv_kernel(const uint8_t* __restrict__ img, const float* __restrict__ mag,
                float* __restrict__ blurred, float* __restrict__ rtv, int height, int width,
                int ksize, float epsilon, int band_rows, int band_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (kK != 0) ksize = kK;
  const int radius = ksize / 2;
  const int pitch = blur_pitch(band_cols);
  const int tile_h = band_rows + kRows - 1;
  const int plane = tile_h * kBlurW;
  uint32_t* s_pix = reinterpret_cast<uint32_t*>(smem);
  float* s_mag = reinterpret_cast<float*>(s_pix + tile_h * pitch);
  int* s_row = reinterpret_cast<int*>(s_mag + tile_h * pitch);  // sum b, g, r; max, min of b+g+r
  float* s_gmax = reinterpret_cast<float*>(s_row + 5 * plane);

  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int bx = blockIdx.x * kBlurW;
  const int by = blockIdx.y * kRows;

  // pixel p of this thread is column bx + 4 lane + p
  int box0[kBlurPix], box1[kBlurPix], box2[kBlurPix], s_max[kBlurPix], s_min[kBlurPix];
  float g_max[kBlurPix], g_sum[kBlurPix], fbox0[kBlurPix], fbox1[kBlurPix], fbox2[kBlurPix];
#pragma unroll
  for (int p = 0; p < kBlurPix; ++p) {
    box0[p] = box1[p] = box2[p] = s_max[p] = 0;
    s_min[p] = 765;
    g_max[p] = g_sum[p] = fbox0[p] = fbox1[p] = fbox2[p] = 0.0f;
  }
  for (int d0 = 0; d0 < ksize; d0 += band_rows) {
    const int d1 = min(d0 + band_rows, ksize);
    for (int e0 = 0; e0 < ksize; e0 += band_cols) {
      const int n_cols = kK != 0 ? kK : min(band_cols, ksize - e0);
      const int n_rows = d1 - d0 + kRows - 1;
      __syncthreads();  // every thread is done with the previous band
      const int gy0 = by - radius + d0;
      const int gx0 = bx - radius + e0;
      for (int ly = ty; ly < n_rows; ly += kRows) {
        const int64_t row = static_cast<int64_t>(clamp_index(gy0 + ly, height)) * width;
        for (int lx = lane; lx < pitch; lx += kLanes) {
          const int64_t q = row + clamp_index(gx0 + lx, width);
          s_pix[ly * pitch + lx] = load_pixel(img + 3 * q);
          s_mag[ly * pitch + lx] = mag[q];
        }
      }
      __syncthreads();
      // row pass: each tile row, each output column, the band's tap columns.
      // max and min of I = (b + g + r) / 3 are those of b + g + r, divided
      // at the end: a correctly rounded division is monotonic.
      if constexpr (kK != 0) {
        // 4 adjacent output columns an item, read as 16-byte vectors: the
        // sums slide along the row, and the max/min share the window's
        // middle, the tap columns [3, kK) every one of the 4 windows holds
        constexpr int kVals = kK + kBlurPix - 1;
        constexpr int kVec = (kVals + 3) / 4;
        static_assert(kK >= 3 && kBlurPix == 4, "the 4 windows share columns [3, kK)");
        for (int i = tid; i < n_rows * kLanes; i += kThreads) {
          const int ly = i / kLanes;
          const int oc = (i - ly * kLanes) * kBlurPix;
          const int at = ly * pitch + oc;
          int c0[4 * kVec], c1[4 * kVec], c2[4 * kVec], sv[4 * kVec];
          float gv[4 * kVec];
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            const uint4 w4 = *reinterpret_cast<const uint4*>(s_pix + at + 4 * v);
            const float4 g4 = *reinterpret_cast<const float4*>(s_mag + at + 4 * v);
            const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
            const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              c0[4 * v + u] = w[u] & 0xffu;
              c1[4 * v + u] = (w[u] >> 8) & 0xffu;
              c2[4 * v + u] = w[u] >> 16;
              sv[4 * v + u] = c0[4 * v + u] + c1[4 * v + u] + c2[4 * v + u];
              gv[4 * v + u] = g[u];
            }
          }
          int s0[4], s1[4], s2[4], mx[4], mn[4];
          float gm[4];
          s0[0] = s1[0] = s2[0] = 0;
#pragma unroll
          for (int j = 0; j < kK; ++j) {
            s0[0] += c0[j];
            s1[0] += c1[j];
            s2[0] += c2[j];
          }
          int mid_x = 0, mid_n = 765;
          float mid_g = 0.0f;
#pragma unroll
          for (int j = 3; j < kK; ++j) {
            mid_x = max(mid_x, sv[j]);
            mid_n = min(mid_n, sv[j]);
            mid_g = fmaxf(mid_g, gv[j]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q > 0) {
              s0[q] = s0[q - 1] + c0[q + kK - 1] - c0[q - 1];
              s1[q] = s1[q - 1] + c1[q + kK - 1] - c1[q - 1];
              s2[q] = s2[q - 1] + c2[q + kK - 1] - c2[q - 1];
            }
            mx[q] = mid_x;
            mn[q] = mid_n;
            gm[q] = mid_g;
#pragma unroll
            for (int j = q; j < q + kK; ++j) {
              if (j < 3 || j >= kK) {
                mx[q] = max(mx[q], sv[j]);
                mn[q] = min(mn[q], sv[j]);
                gm[q] = fmaxf(gm[q], gv[j]);
              }
            }
          }
          const int e = ly * kBlurW + oc;
          *reinterpret_cast<int4*>(s_row + e) = make_int4(s0[0], s0[1], s0[2], s0[3]);
          *reinterpret_cast<int4*>(s_row + plane + e) = make_int4(s1[0], s1[1], s1[2], s1[3]);
          *reinterpret_cast<int4*>(s_row + 2 * plane + e) = make_int4(s2[0], s2[1], s2[2], s2[3]);
          *reinterpret_cast<int4*>(s_row + 3 * plane + e) = make_int4(mx[0], mx[1], mx[2], mx[3]);
          *reinterpret_cast<int4*>(s_row + 4 * plane + e) = make_int4(mn[0], mn[1], mn[2], mn[3]);
          *reinterpret_cast<float4*>(s_gmax + e) = make_float4(gm[0], gm[1], gm[2], gm[3]);
        }
      } else {  // one output column an item
        for (int i = tid; i < n_rows * kBlurW; i += kThreads) {
          const int ly = i / kBlurW;
          const int at = ly * pitch + (i - ly * kBlurW);
          int s0 = 0, s1 = 0, s2 = 0, mx = 0, mn = 765;
          float gm = 0.0f;
          for (int dx = 0; dx < n_cols; ++dx) {
            const uint32_t v = s_pix[at + dx];
            const int c0 = v & 0xffu, c1 = (v >> 8) & 0xffu, c2 = v >> 16;
            s0 += c0;
            s1 += c1;
            s2 += c2;
            const int sum = c0 + c1 + c2;
            mx = max(mx, sum);
            mn = min(mn, sum);
            gm = fmaxf(gm, s_mag[at + dx]);
          }
          s_row[i] = s0;
          s_row[plane + i] = s1;
          s_row[2 * plane + i] = s2;
          s_row[3 * plane + i] = mx;
          s_row[4 * plane + i] = mn;
          s_gmax[i] = gm;
        }
      }
      __syncthreads();
      for (int dy = 0; dy < d1 - d0; ++dy) {
        // column pass: one 16-byte read of each plane for the 4 pixels
        const int i = (ty + dy) * kBlurW + 4 * lane;
        const int4 r0 = *reinterpret_cast<const int4*>(s_row + i);
        const int4 r1 = *reinterpret_cast<const int4*>(s_row + plane + i);
        const int4 r2 = *reinterpret_cast<const int4*>(s_row + 2 * plane + i);
        const int4 rx = *reinterpret_cast<const int4*>(s_row + 3 * plane + i);
        const int4 rn = *reinterpret_cast<const int4*>(s_row + 4 * plane + i);
        const float4 rg = *reinterpret_cast<const float4*>(s_gmax + i);
        const int v0[4] = {r0.x, r0.y, r0.z, r0.w}, v1[4] = {r1.x, r1.y, r1.z, r1.w};
        const int v2[4] = {r2.x, r2.y, r2.z, r2.w}, vx[4] = {rx.x, rx.y, rx.z, rx.w};
        const int vn[4] = {rn.x, rn.y, rn.z, rn.w};
        const float vg[4] = {rg.x, rg.y, rg.z, rg.w};
#pragma unroll
        for (int p = 0; p < kBlurPix; ++p) {
          box0[p] += v0[p];
          box1[p] += v1[p];
          box2[p] += v2[p];
          s_max[p] = max(s_max[p], vx[p]);
          s_min[p] = min(s_min[p], vn[p]);
          g_max[p] = fmaxf(g_max[p], vg[p]);
        }
        // the ordered sums: value j of the row segment is tap column
        // e0 + j - p of pixel p; each pixel's chain takes its values in j
        // order, so in (ky, kx) order over the bands
        const float* g = s_mag + (ty + dy) * pitch + 4 * lane;
        const uint32_t* w = s_pix + (ty + dy) * pitch + 4 * lane;
#pragma unroll
        for (int j0 = 0; j0 < n_cols + 3; j0 += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(g + j0);
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
          uint32_t wv[4] = {0, 0, 0, 0};
          if constexpr (kOrderedBox) {
            const uint4 w4 = *reinterpret_cast<const uint4*>(w + j0);
            wv[0] = w4.x;
            wv[1] = w4.y;
            wv[2] = w4.z;
            wv[3] = w4.w;
          }
          const bool inside = j0 >= kBlurPix - 1 && j0 + 3 < n_cols;  // every pixel takes all 4
#pragma unroll
          for (int v = 0; v < 4; ++v) {
#pragma unroll
            for (int p = 0; p < kBlurPix; ++p) {
              if (inside || static_cast<unsigned>(j0 + v - p) < static_cast<unsigned>(n_cols)) {
                g_sum[p] = __fadd_rn(g_sum[p], gv[v]);
                if constexpr (kOrderedBox) {
                  fbox0[p] = __fadd_rn(fbox0[p], channel<0>(wv[v]));
                  fbox1[p] = __fadd_rn(fbox1[p], channel<1>(wv[v]));
                  fbox2[p] = __fadd_rn(fbox2[p], channel<2>(wv[v]));
                }
              }
            }
          }
        }
      }
    }
  }

  // the outputs go through shared memory (the planes' room), so that each
  // warp writes its row of the block contiguously
  __syncthreads();  // every thread is done with the planes
  float* s_blur = reinterpret_cast<float*>(s_row) + ty * kBlurW * 3;
  float* s_rtv = reinterpret_cast<float*>(s_row) + kRows * kBlurW * 3 + ty * kBlurW;
  const float k2 = __int2float_rn(ksize * ksize);
#pragma unroll
  for (int p = 0; p < kBlurPix; ++p) {
    const int c = 4 * lane + p;
    s_blur[3 * c] = __fdiv_rn(kOrderedBox ? fbox0[p] : __int2float_rn(box0[p]), k2);
    s_blur[3 * c + 1] = __fdiv_rn(kOrderedBox ? fbox1[p] : __int2float_rn(box1[p]), k2);
    s_blur[3 * c + 2] = __fdiv_rn(kOrderedBox ? fbox2[p] : __int2float_rn(box2[p]), k2);
    // the plain version's start values: i_max 0, i_min 256, m_max 0
    const float i_max = fmaxf(0.0f, __fdiv_rn(__int2float_rn(s_max[p]), 3.0f));
    const float i_min = fminf(256.0f, __fdiv_rn(__int2float_rn(s_min[p]), 3.0f));
    s_rtv[c] = __fdiv_rn(__fmul_rn(__fsub_rn(i_max, i_min), g_max[p]),
                         __fadd_rn(g_sum[p], epsilon));
  }
  __syncwarp();  // a warp writes the row it staged
  const int y = by + ty;
  if (y >= height) return;
  const int n = min(kBlurW, width - bx);
  float* b_out = blurred + (static_cast<int64_t>(y) * width + bx) * 3;
  for (int i = lane; i < 3 * n; i += kLanes) b_out[i] = s_blur[i];
  float* r_out = rtv + static_cast<int64_t>(y) * width + bx;
  for (int i = lane; i < n; i += kLanes) r_out[i] = s_rtv[i];
}

__device__ __forceinline__ uint8_t blend(float alpha, float one_m, float bmin, float bctr) {
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(alpha, bmin), __fmul_rn(one_m, bctr)), 0.5f);
  return static_cast<uint8_t>(static_cast<int>(fminf(fmaxf(truncf(v), 0.0f), 255.0f)));
}

// The blend of one pixel, from the window's first minimum of rtv.
__device__ __forceinline__ void guide_pixel(const float* __restrict__ blurred,
                                            uint8_t* __restrict__ guide, int height, int width,
                                            int radius, float sigma_alpha, int x, int y,
                                            float center, float best, int best_ky, int best_kx) {
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

// Windows whose (8 + 2r) x (32 + 2r) tile fits: the whole tile at once.
__global__ void __launch_bounds__(kThreads)
guide_kernel(const float* __restrict__ blurred, const float* __restrict__ rtv,
             uint8_t* __restrict__ guide, int height, int width, int ksize, float sigma_alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int radius = ksize / 2;
  const int tile_w = kLanes + 2 * radius;
  const int tile_n = tile_w * (kRows + 2 * radius);
  float* s_rtv = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int x0 = blockIdx.x * kLanes - radius;
  const int y0 = blockIdx.y * kRows - radius;
  for (int i = tid; i < tile_n; i += kThreads) {
    const int ly = i / tile_w;
    const int lx = i - ly * tile_w;
    s_rtv[i] = rtv[static_cast<int64_t>(clamp_index(y0 + ly, height)) * width +
                   clamp_index(x0 + lx, width)];
  }
  __syncthreads();

  const int x = blockIdx.x * kLanes + threadIdx.x;
  const int y = blockIdx.y * kRows + threadIdx.y;
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
  guide_pixel(blurred, guide, height, width, radius, sigma_alpha, x, y,
              s_rtv[base + radius * tile_w + radius], best, best_ky, best_kx);
}

// Larger windows: the tile in bands (guide_plan), scanned in (ky, kx)
// order, so the strict < still keeps the first minimum.
__global__ void __launch_bounds__(kThreads)
guide_band_kernel(const float* __restrict__ blurred, const float* __restrict__ rtv,
                  uint8_t* __restrict__ guide, int height, int width, int ksize,
                  float sigma_alpha, int band_rows, int band_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int radius = ksize / 2;
  const int tile_w = kLanes - 1 + band_cols;
  float* s_rtv = reinterpret_cast<float*>(smem);

  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const float* at0 = s_rtv + ty * tile_w + lane;
  float best = FLT_MAX;
  int best_ky = -1, best_kx = 0;
  for (int d0 = 0; d0 < ksize; d0 += band_rows) {
    const int d1 = min(d0 + band_rows, ksize);
    for (int e0 = 0; e0 < ksize; e0 += band_cols) {
      const int e1 = min(e0 + band_cols, ksize);
      __syncthreads();  // every thread is done with the previous band
      const int n_rows = d1 - d0 + kRows - 1;
      const int n_cols = e1 - e0 + kLanes - 1;
      const int gy0 = blockIdx.y * kRows - radius + d0;
      const int gx0 = blockIdx.x * kLanes - radius + e0;
      for (int ly = ty; ly < n_rows; ly += kRows) {
        const int64_t row = static_cast<int64_t>(clamp_index(gy0 + ly, height)) * width;
        for (int lx = lane; lx < n_cols; lx += kLanes) {
          s_rtv[ly * tile_w + lx] = rtv[row + clamp_index(gx0 + lx, width)];
        }
      }
      __syncthreads();
      for (int ky = d0; ky < d1; ++ky) {
        const float* row = at0 + (ky - d0) * tile_w;
        for (int kx = e0; kx < e1; ++kx) {
          const float v = row[kx - e0];
          if (v < best) {  // strict: the first minimum in (ky, kx) order wins
            best = v;
            best_ky = ky;
            best_kx = kx;
          }
        }
      }
    }
  }

  const int x = blockIdx.x * kLanes + lane;
  const int y = blockIdx.y * kRows + ty;
  if (x >= width || y >= height) return;
  guide_pixel(blurred, guide, height, width, radius, sigma_alpha, x, y,
              rtv[static_cast<int64_t>(y) * width + x], best, best_ky, best_kx);
}

int set_smem(const void* kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int kK, bool kOrderedBox>
int launch_blur_rtv(const uint8_t* img, const float* magnitude, float* blurred, float* rtv,
                    int height, int width, int ksize, float epsilon, cudaStream_t stream) {
  const BandPlan plan = blur_plan(ksize);
  const int err =
      set_smem(reinterpret_cast<const void*>(blur_rtv_kernel<kK, kOrderedBox>), plan.smem);
  if (err != 0) return err;
  const dim3 block(kLanes, kRows);
  const dim3 grid((width + kBlurW - 1) / kBlurW, (height + kRows - 1) / kRows);
  blur_rtv_kernel<kK, kOrderedBox><<<grid, block, static_cast<size_t>(plan.smem), stream>>>(
      img, magnitude, blurred, rtv, height, width, ksize, epsilon, plan.rows, plan.cols);
  return static_cast<int>(cudaGetLastError());
}

int band_of(const BandPlan& plan, int which) { return which == 0 ? plan.rows : plan.cols; }

}  // namespace

extern "C" {

// Dynamic shared memory of one block: the whole tile, or one band of it.
long long vip_blur_rtv_smem_bytes(int radius) { return blur_plan(2 * radius + 1).smem; }
long long vip_guide_smem_bytes(int radius) { return guide_plan(2 * radius + 1).smem; }

// Tap rows (which == 0) or tap columns (which == 1) a band covers; 2r + 1
// of both where the whole tile fits.
int vip_blur_rtv_band(int radius, int which) { return band_of(blur_plan(2 * radius + 1), which); }
int vip_guide_band(int radius, int which) { return band_of(guide_plan(2 * radius + 1), which); }

// img: (height, width, 3) u8; magnitude: (height, width) f32.
// blurred: (height, width, 3) f32; rtv: (height, width) f32.
// Returns the launch's cudaError_t.
int vip_blur_rtv(const void* img, const void* magnitude, void* blurred, void* rtv, int height,
                 int width, int ksize, float epsilon, void* stream) {
  const auto* i = static_cast<const uint8_t*>(img);
  const auto* m = static_cast<const float*>(magnitude);
  auto* b = static_cast<float*>(blurred);
  auto* r = static_cast<float*>(rtv);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ksize == 9 && blur_plan(9).cols == 9) {  // the BTF's window: its columns at compile time
    return launch_blur_rtv<9, false>(i, m, b, r, height, width, ksize, epsilon, st);
  }
  if (ksize <= kMaxIntBoxK) {
    return launch_blur_rtv<0, false>(i, m, b, r, height, width, ksize, epsilon, st);
  }
  return launch_blur_rtv<0, true>(i, m, b, r, height, width, ksize, epsilon, st);
}

// blurred: (height, width, 3) f32; rtv: (height, width) f32;
// guide: (height, width, 3) u8.  Returns the launch's cudaError_t.
int vip_guide(const void* blurred, const void* rtv, void* guide, int height, int width,
              int ksize, float sigma_alpha, void* stream) {
  const BandPlan plan = guide_plan(ksize);
  const dim3 block(kLanes, kRows);
  const dim3 grid((width + kLanes - 1) / kLanes, (height + kRows - 1) / kRows);
  const auto* b = static_cast<const float*>(blurred);
  const auto* r = static_cast<const float*>(rtv);
  auto* g = static_cast<uint8_t*>(guide);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool one_tile = plan.rows == ksize && plan.cols == ksize;
  const int err = set_smem(one_tile ? reinterpret_cast<const void*>(guide_kernel)
                                    : reinterpret_cast<const void*>(guide_band_kernel),
                           plan.smem);
  if (err != 0) return err;
  if (one_tile) {
    guide_kernel<<<grid, block, static_cast<size_t>(plan.smem), st>>>(b, r, g, height, width,
                                                                       ksize, sigma_alpha);
  } else {
    guide_band_kernel<<<grid, block, static_cast<size_t>(plan.smem), st>>>(
        b, r, g, height, width, ksize, sigma_alpha, plan.rows, plan.cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
