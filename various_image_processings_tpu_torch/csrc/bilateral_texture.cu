// Bilateral texture filter stages for Hopper (sm_90a): blur + mRTV, and the
// guide.  With the gradient (gradient.cu) and the joint bilateral filter
// (bilateral.cu) they make one BTF iteration, four launches.
//
// Replaces two TPU kernels in
// various_image_processings_tpu/ops/pallas/bilateral_texture.py:
//   _make_blur_rtv_kernel (:39)   -> blur_rtv_kernel
//   _make_guide_kernel    (:137)  -> guide_kernel
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
// 8 rows of 128 pixels a block, 4 adjacent pixels a thread.  Separable, as
// the TPU kernel is: a row pass over the tile rows keeps, for each output
// column, the row's first minimum over the window's k columns (strict <,
// kx order) and its column; a column pass takes those k results in ky
// order with strict <.  Strict < in both passes picks the tap the (ky, kx)
// scan picks: ties keep the earlier row, within a row the earlier column,
// and the passes only select, so the values are the plain version's.  For
// the BTF's k = 9 the window is compiled in and the row pass takes 4
// adjacent columns an item, sharing the first minimum of the columns the 4
// windows have in common.  Only rtv is tiled: the blurred values are read
// from global memory, the centre's as 16-byte vectors, the argmin's once a
// pixel.  The output bytes go through shared memory so that each warp
// stores its row of the block in whole words.
//
// Every window: where a whole halo tile does not fit in shared memory
// (blur + mRTV past k = 119, the guide past k = 109), the tile is streamed
// through in bands of tap rows (past a few thousand columns, segments of
// one tap row), in (ky, kx) order, with every accumulator in registers: the
// ordered sums and the strict-< argmin see their taps in the one-tile order
// (the guide's column pass carries its best across bands and segments).
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
// latency of the tile load still bind, not bandwidth.  The guide's first
// version walked all k^2 taps (~6 instructions each, 6.6x its byte bound);
// separable, at k = 9 the row pass takes 22 compare-and-selects an item of
// 4 columns and tile row (87 SASS instructions), the column pass one a
// pixel and tap row, so the exp, the division, the blend and the argmin's
// gather (~60 instructions a pixel) are much of what is left: 0.083 ms at
// 4K, 1.77x its byte bound (NVIDIA H100 80GB HBM3, 700 W; PERF.md).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kRows = 8;
constexpr int kThreads = kLanes * kRows;
constexpr int kBlurPix = 4;                   // blur + mRTV: adjacent pixels a thread
constexpr int kBlurW = kLanes * kBlurPix;     // blur + mRTV: output columns of a block
constexpr int kGuidePix = 4;                  // guide: adjacent pixels a thread
constexpr int kGuideW = kLanes * kGuidePix;   // guide: output columns of a block
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

// guide: the band's tile rows hold guide_pitch(cols) rtv values (the
// 4-wide reads of the k=9 row pass run up to 3 columns past the 127 + cols
// a row needs; a multiple of 4 keeps every row 16-byte aligned), then two
// planes of 128 row-pass results a tile row: the first minimum and its tile
// column.
__host__ __device__ constexpr int guide_pitch(int cols) {
  return (cols + kGuideW - 1 + 3) / 4 * 4;
}

long long guide_bytes(int rows, int cols) {
  return static_cast<long long>(rows + kRows - 1) * (guide_pitch(cols) * 4LL + kGuideW * 8LL);
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

// Strict <: a later value replaces the best only if it is smaller, so the
// first minimum in scan order is kept, with its value (only selects).
__device__ __forceinline__ void take_first_min(float v, int at, float& best, int& best_at) {
  if (v < best) {
    best = v;
    best_at = at;
  }
}

// kK: the window at compile time (0: taken from ksize at run time, in
// bands).  vec: width % 4 == 0 and 16-byte aligned planes, so the tile and
// the centres are read as 16-byte vectors and the output stored in words.
template <int kK>
__global__ void __launch_bounds__(kThreads)
guide_kernel(const float* __restrict__ blurred, const float* __restrict__ rtv,
             uint8_t* __restrict__ guide, int height, int width, int ksize, float sigma_alpha,
             int band_rows, int band_cols, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (kK != 0) ksize = band_rows = band_cols = kK;  // one tile, one pass
  const int radius = ksize / 2;
  const int pitch = guide_pitch(band_cols);
  const int groups = pitch / 4;  // 4-value groups a tile row
  const int tile_h = band_rows + kRows - 1;
  float* s_rtv = reinterpret_cast<float*>(smem);
  float* s_min = s_rtv + tile_h * pitch;                               // row pass: first minimum
  int* s_col = reinterpret_cast<int*>(s_min + tile_h * kGuideW);       // and its tile column

  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int bx = blockIdx.x * kGuideW;
  const int by = blockIdx.y * kRows;

  // pixel p of this thread is column bx + 4 lane + p of row by + ty
  float best[kGuidePix];
  int best_ky[kGuidePix], best_kx[kGuidePix];
#pragma unroll
  for (int p = 0; p < kGuidePix; ++p) {
    best[p] = FLT_MAX;  // no value below FLT_MAX: best_ky stays -1
    best_ky[p] = -1;
    best_kx[p] = 0;
  }
  for (int d0 = 0; d0 < ksize; d0 += band_rows) {
    const int d1 = min(d0 + band_rows, ksize);
    for (int e0 = 0; e0 < ksize; e0 += band_cols) {
      const int n_cols = min(band_cols, ksize - e0);
      const int n_rows = d1 - d0 + kRows - 1;
      __syncthreads();  // every thread is done with the previous band
      // tile column lx holds image column gx0 + lx: tap column e0 + lx - c
      // of output column c of the block
      const int gy0 = by - radius + d0;
      const int gx0 = bx - radius + e0;
      const bool vec_tile = vec && gx0 % 4 == 0;
      for (int i = tid; i < n_rows * groups; i += kThreads) {
        const int ly = i / groups;
        const int gx = gx0 + 4 * (i - ly * groups);
        const float* row = rtv + static_cast<int64_t>(clamp_index(gy0 + ly, height)) * width;
        float4 v;
        if (vec_tile && gx >= 0 && gx + 3 < width) {
          v = *reinterpret_cast<const float4*>(row + gx);
        } else {
          v = make_float4(row[clamp_index(gx, width)], row[clamp_index(gx + 1, width)],
                          row[clamp_index(gx + 2, width)], row[clamp_index(gx + 3, width)]);
        }
        *reinterpret_cast<float4*>(s_rtv + ly * pitch + (gx - gx0)) = v;
      }
      __syncthreads();
      // row pass: for each tile row and output column, the first minimum
      // over the band's tap columns and its tile column
      if constexpr (kK != 0) {
        // 4 adjacent output columns an item, read as 16-byte vectors: the 4
        // windows share the tap columns [3, kK), whose first minimum is
        // taken once; each window then folds its columns left of it, that
        // minimum and its columns right of it, in kx order
        constexpr int kVals = kK + kGuidePix - 1;
        constexpr int kVec = (kVals + 3) / 4;
        static_assert(kK >= 3 && kGuidePix == 4, "the 4 windows share columns [3, kK)");
        for (int i = tid; i < n_rows * kLanes; i += kThreads) {
          const int ly = i / kLanes;
          const int oc = (i - ly * kLanes) * kGuidePix;
          float v[4 * kVec];
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            const float4 f = *reinterpret_cast<const float4*>(s_rtv + ly * pitch + oc + 4 * u);
            v[4 * u] = f.x;
            v[4 * u + 1] = f.y;
            v[4 * u + 2] = f.z;
            v[4 * u + 3] = f.w;
          }
          float mid = FLT_MAX;
          int mid_at = 0;
#pragma unroll
          for (int j = 3; j < kK; ++j) take_first_min(v[j], j, mid, mid_at);
          float m[kGuidePix];
          int at[kGuidePix];
#pragma unroll
          for (int q = 0; q < kGuidePix; ++q) {
            m[q] = FLT_MAX;
            at[q] = 0;
#pragma unroll
            for (int j = q; j < 3; ++j) take_first_min(v[j], j, m[q], at[q]);
            take_first_min(mid, mid_at, m[q], at[q]);
#pragma unroll
            for (int j = kK; j < q + kK; ++j) take_first_min(v[j], j, m[q], at[q]);
          }
          const int e = ly * kGuideW + oc;
          *reinterpret_cast<float4*>(s_min + e) = make_float4(m[0], m[1], m[2], m[3]);
          *reinterpret_cast<int4*>(s_col + e) =
              make_int4(oc + at[0], oc + at[1], oc + at[2], oc + at[3]);
        }
      } else {  // one output column an item
        for (int i = tid; i < n_rows * kGuideW; i += kThreads) {
          const int ly = i / kGuideW;
          const int c = i - ly * kGuideW;
          const float* row = s_rtv + ly * pitch + c;
          float m = FLT_MAX;
          int at = 0;
          for (int j = 0; j < n_cols; ++j) take_first_min(row[j], j, m, at);
          s_min[i] = m;
          s_col[i] = c + at;
        }
      }
      __syncthreads();
      // column pass: the band's tap rows in ky order, one 16-byte read for
      // the 4 pixels; the tap column is read once a band, for the pixels
      // whose best moved into it
      int sel[kGuidePix];
#pragma unroll
      for (int p = 0; p < kGuidePix; ++p) sel[p] = -1;
#pragma unroll
      for (int dy = 0; dy < d1 - d0; ++dy) {
        const float4 f =
            *reinterpret_cast<const float4*>(s_min + (ty + dy) * kGuideW + kGuidePix * lane);
        take_first_min(f.x, dy, best[0], sel[0]);
        take_first_min(f.y, dy, best[1], sel[1]);
        take_first_min(f.z, dy, best[2], sel[2]);
        take_first_min(f.w, dy, best[3], sel[3]);
      }
#pragma unroll
      for (int p = 0; p < kGuidePix; ++p) {
        if (sel[p] >= 0) {
          const int c = kGuidePix * lane + p;
          best_ky[p] = d0 + sel[p];
          best_kx[p] = e0 + s_col[(ty + sel[p]) * kGuideW + c] - c;
        }
      }
    }
  }

  // the centres: three 16-byte reads of blurred and one of rtv for the 4
  // pixels where the rows are whole vectors
  const int y = by + ty;
  const int x0 = bx + kGuidePix * lane;
  const int64_t at0 = static_cast<int64_t>(min(y, height - 1)) * width;
  float c_rtv[kGuidePix], c_blur[3 * kGuidePix];
  if (vec && x0 < width) {  // width % 4 == 0: the 4 pixels are inside
    const float4 r4 = *reinterpret_cast<const float4*>(rtv + at0 + x0);
    const float4* b4 = reinterpret_cast<const float4*>(blurred + 3 * (at0 + x0));
    const float4 b0 = b4[0], b1 = b4[1], b2 = b4[2];
    const float rv[kGuidePix] = {r4.x, r4.y, r4.z, r4.w};
    const float bv[3 * kGuidePix] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y,
                                      b1.z, b1.w, b2.x, b2.y, b2.z, b2.w};
#pragma unroll
    for (int p = 0; p < kGuidePix; ++p) c_rtv[p] = rv[p];
#pragma unroll
    for (int i = 0; i < 3 * kGuidePix; ++i) c_blur[i] = bv[i];
  } else {
#pragma unroll
    for (int p = 0; p < kGuidePix; ++p) {
      const int64_t q = at0 + clamp_index(x0 + p, width);
      c_rtv[p] = rtv[q];
#pragma unroll
      for (int c = 0; c < 3; ++c) c_blur[3 * p + c] = blurred[3 * q + c];
    }
  }
  // the blend of each pixel, from its window's first minimum; the 12 bytes
  // of the 4 pixels as 3 words
  uint32_t words[3] = {0u, 0u, 0u};
#pragma unroll
  for (int p = 0; p < kGuidePix; ++p) {
    const float e = expf(__fmul_rn(sigma_alpha, __fsub_rn(c_rtv[p], best[p])));
    const float alpha = __fsub_rn(__fdiv_rn(2.0f, __fadd_rn(1.0f, e)), 1.0f);
    const float one_m = __fsub_rn(1.0f, alpha);
    const int64_t q = static_cast<int64_t>(clamp_index(y + best_ky[p] - radius, height)) * width +
                      clamp_index(x0 + p + best_kx[p] - radius, width);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // no window value below FLT_MAX: the blend takes 0, as the plain version does
      const float bmin = best_ky[p] < 0 ? 0.0f : blurred[3 * q + c];
      const uint32_t u = blend(alpha, one_m, bmin, c_blur[3 * p + c]);
      words[(3 * p + c) / 4] |= u << (8 * ((3 * p + c) % 4));
    }
  }
  // the outputs go through shared memory (the planes' room), so that each
  // warp writes its row of the block contiguously
  __syncthreads();  // every thread is done with the planes
  uint32_t* s_out = reinterpret_cast<uint32_t*>(s_min) + ty * (3 * kGuideW / 4);
#pragma unroll
  for (int j = 0; j < 3; ++j) s_out[3 * lane + j] = words[j];
  __syncwarp();  // a warp writes the row it staged
  if (y >= height) return;
  const int n = min(kGuideW, width - bx);
  uint8_t* g_out = guide + (static_cast<int64_t>(y) * width + bx) * 3;
  if (vec) {  // 3n bytes from a 4-byte aligned start: whole words
    for (int i = lane; i < 3 * n / 4; i += kLanes) reinterpret_cast<uint32_t*>(g_out)[i] = s_out[i];
  } else {
    const uint8_t* s_bytes = reinterpret_cast<const uint8_t*>(s_out);
    for (int i = lane; i < 3 * n; i += kLanes) g_out[i] = s_bytes[i];
  }
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kK>
int launch_guide(const float* blurred, const float* rtv, uint8_t* guide, int height, int width,
                 int ksize, float sigma_alpha, cudaStream_t stream) {
  const BandPlan plan = guide_plan(ksize);
  const int err = set_smem(reinterpret_cast<const void*>(guide_kernel<kK>), plan.smem);
  if (err != 0) return err;
  const bool vec = width % 4 == 0 && aligned16(blurred) && aligned16(rtv) && aligned16(guide);
  const dim3 block(kLanes, kRows);
  const dim3 grid((width + kGuideW - 1) / kGuideW, (height + kRows - 1) / kRows);
  guide_kernel<kK><<<grid, block, static_cast<size_t>(plan.smem), stream>>>(
      blurred, rtv, guide, height, width, ksize, sigma_alpha, plan.rows, plan.cols, vec);
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
  const auto* b = static_cast<const float*>(blurred);
  const auto* r = static_cast<const float*>(rtv);
  auto* g = static_cast<uint8_t*>(guide);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ksize == 9 && guide_plan(9).rows == 9) {  // the BTF's window: its columns at compile time
    return launch_guide<9>(b, r, g, height, width, ksize, sigma_alpha, st);
  }
  return launch_guide<0>(b, r, g, height, width, ksize, sigma_alpha, st);
}

}  // extern "C"
