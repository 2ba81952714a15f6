// Path 4 of the bilateral kernel (csrc/bilateral.cu, whose header note
// describes all four paths): the inscribed circle of a radius up to 4
// unrolled at compile time.  Its 16 instantiations (4 radii, self and
// joint, 1 or 2 rows a thread) are compiled in four files,
// csrc/bilateral_circle_r<R>.cu, one a radius, beside the other sources,
// so that the straight code of each compiles in parallel.

#pragma once

#include "bilateral_common.cuh"

namespace vip_bilateral {

// One launch's arguments, as vip_bilateral_u8 takes them (for the self
// filter guide is src).
struct Launch {
  bool joint;
  const uint8_t* src;
  const uint8_t* guide;
  uint8_t* out;
  int height;
  int width;
  const int4* taps;
  int n_taps;
  const float* lut;
  int border;
  int rounding;
  cudaStream_t stream;
};

// Path 4 at radius R, defined in csrc/bilateral_circle_r<R>.cu.
int launch_circle_r1(const Launch& a);
int launch_circle_r2(const Launch& a);
int launch_circle_r3(const Launch& a);
int launch_circle_r4(const Launch& a);

}  // namespace vip_bilateral

namespace {

constexpr int kCircleMaxRadius = 4;
// A thread's outputs: V adjacent columns (a warp's 32 lanes side by side)
// of H adjacent rows (the block's 8 warps stacked), or of 1 row where H
// rows would give the H100's 132 SMs fewer than 2 blocks each.
constexpr int kCircleCols = 4;
constexpr int kCircleRows = 2;
constexpr int kCircleMinBlocks = 264;
constexpr int kCircleBlockCols = kLanes * kCircleCols;

// Tap (ky, kx) of the window of radius r lies in its inscribed circle, as
// core/luts.py::space_kernel keeps it.
__host__ __device__ constexpr bool in_circle(int r, int ky, int kx) {
  return ky >= 0 && ky <= 2 * r && kx >= 0 && kx <= 2 * r &&
         (ky - r) * (ky - r) + (kx - r) * (kx - r) <= r * r;
}

// Output (h, u) of a thread of H rows adds word j of its source row s as
// tap (s - h, j - u); a word is loaded where it serves any output.
__host__ __device__ constexpr bool serves(int r, int rows, int s, int j) {
  for (int h = 0; h < rows; ++h) {
    for (int u = 0; u < kCircleCols; ++u) {
      if (in_circle(r, s - h, j - u)) return true;
    }
  }
  return false;
}

// Where tile column c lies in its row: a pad word after every V, so the 32
// lanes of a warp, whose first words are V columns apart, start V + 1 words
// apart and read 32 distinct banks (8-byte words: 16 distinct bank pairs a
// half warp).
__host__ __device__ constexpr int circle_col(int c) { return c + c / kCircleCols; }

__host__ __device__ constexpr int circle_stride(int radius) {
  return circle_col(kCircleBlockCols + 2 * radius - 1) + 1;
}

// Output rows a thread on path 4: H, or 1 on frames too small to give
// every SM 2 blocks of H rows.
inline int circle_rows(int height, int width) {
  constexpr int kBlockRows = kRowsPerBlock * kCircleRows;
  const long long blocks = static_cast<long long>((width + kCircleBlockCols - 1) /
                                                  kCircleBlockCols) *
                           ((height + kBlockRows - 1) / kBlockRows);
  return blocks >= kCircleMinBlocks ? kCircleRows : 1;
}

// The LUT; the weights, (2r + 1)^2 f32 padded to 16 bytes; the halo tile
// of a block of 8 x rows x 32 V outputs.
inline long long circle_smem_bytes(int radius, bool joint, int rows) {
  const long long taps = (2 * radius + 1) * (2 * radius + 1);
  return kLutSize * 4LL + (taps + 3) / 4 * 16 +
         (joint ? 8 : 4) * static_cast<long long>(circle_stride(radius)) *
             (kRowsPerBlock * rows + 2 * radius);
}

// Path 4: the radius a template parameter, so the circle's taps, which
// outputs each tile word serves and every tile offset are known to the
// compiler and the tap loop is straight code.  A thread holds kRows x V
// outputs; it walks the kRows + 2R source rows its windows cover, top to
// bottom, and each row's words left to right, loads and converts a word
// once and adds it to every output whose circle holds it.  Output (h, u)
// thus still adds its taps in (ky, kx) order: a later row is a larger ky,
// a later word a larger kx.  The tap table becomes a dense (2R + 1)^2 array
// of weights, 0 where it has no tap: such a tap adds exactly +0 to sums
// that are >= 0, so every sum is the one the table's taps alone give.
template <int R, bool kJoint, int kRows>
__global__ void __launch_bounds__(kThreads, 3)
bilateral_circle_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ guide,
                        uint8_t* __restrict__ out, int height, int width,
                        const int4* __restrict__ taps, int n_taps,
                        const float* __restrict__ lut, int border, int rounding) {
  using Word = typename TileWord<kJoint>::type;
  constexpr int kSize = 2 * R + 1;
  constexpr int kBlockRows = kRowsPerBlock * kRows;
  constexpr int kTileW = kCircleBlockCols + 2 * R;
  constexpr int kTileH = kBlockRows + 2 * R;
  constexpr int kStride = circle_stride(R);
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  float* s_w = s_lut + kLutSize;  // ws of tap (ky, kx) at ky * (2R + 1) + kx
  Word* s_tile = reinterpret_cast<Word*>(s_w + (kSize * kSize + 3) / 4 * 4);

  const int tid = threadIdx.y * kLanes + threadIdx.x;
  // this thread's tap, read now so that its latency hides behind the
  // staging: (dy, dx, bits of ws, 0)
  const int4 tap = tid < n_taps ? __ldg(taps + tid) : make_int4(0, 0, 0, 0);
  for (int i = tid; i < kLutSize; i += kThreads) s_lut[i] = lut[i];
  for (int i = tid; i < kSize * kSize; i += kThreads) s_w[i] = 0.0f;
  const int x0 = blockIdx.x * kCircleBlockCols - R;
  const int y0 = blockIdx.y * kBlockRows - R;
  for (int ly = threadIdx.y; ly < kTileH; ly += kRowsPerBlock) {
    const size_t row = static_cast<size_t>(fold(y0 + ly, height, border)) * width;
    for (int lx = threadIdx.x; lx < kTileW; lx += kLanes) {
      const size_t p = (row + fold(x0 + lx, width, border)) * 3;
      s_tile[ly * kStride + circle_col(lx)] = tile_word<kJoint>(guide + p, src + p);
    }
  }
  __syncthreads();  // the weights are zero
  if (tid < n_taps) s_w[tap.x * kSize + tap.y] = __int_as_float(tap.z);
  __syncthreads();

  // this thread's outputs: block rows H threadIdx.y + h, columns
  // V threadIdx.x + u; word j of its source row s is tile word
  // (H threadIdx.y + s, V threadIdx.x + j)
  const Word* at = s_tile + kRows * threadIdx.y * kStride + (kCircleCols + 1) * threadIdx.x;
  uint32_t center[kRows][kCircleCols];
  float sum0[kRows][kCircleCols], sum1[kRows][kCircleCols];
  float sum2[kRows][kCircleCols], sumk[kRows][kCircleCols];
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
#pragma unroll
    for (int u = 0; u < kCircleCols; ++u) {
      center[h][u] = guide_of(at[(R + h) * kStride + circle_col(R + u)]);
      sum0[h][u] = sum1[h][u] = sum2[h][u] = sumk[h][u] = 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < kSize + kRows - 1; ++s) {
#pragma unroll
    for (int j = 0; j < kSize + kCircleCols - 1; ++j) {
      if (!serves(R, kRows, s, j)) continue;
      const Word word = at[s * kStride + circle_col(j)];
      const uint32_t sw = source_of(word);
      const float c0 = channel<0>(sw);
      const float c1 = channel<1>(sw);
      const float c2 = channel<2>(sw);
#pragma unroll
      for (int h = 0; h < kRows; ++h) {
#pragma unroll
        for (int u = 0; u < kCircleCols; ++u) {
          if (!in_circle(R, s - h, j - u)) continue;
          const float wk = __fmul_rn(s_w[(s - h) * kSize + j - u],
                                     s_lut[__vsadu4(guide_of(word), center[h][u])]);
          sum0[h][u] = __fadd_rn(sum0[h][u], __fmul_rn(c0, wk));
          sum1[h][u] = __fadd_rn(sum1[h][u], __fmul_rn(c1, wk));
          sum2[h][u] = __fadd_rn(sum2[h][u], __fmul_rn(c2, wk));
          sumk[h][u] = __fadd_rn(sumk[h][u], wk);
        }
      }
    }
  }

  const int x = blockIdx.x * kCircleBlockCols + kCircleCols * threadIdx.x;
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    const int y = blockIdx.y * kBlockRows + kRows * threadIdx.y + h;
    if (y >= height) break;
    uint8_t* o = out + (static_cast<size_t>(y) * width + x) * 3;
    if (width % 4 == 0) {
      // x and the row start are multiples of 4 pixels: each 4 pixels are 3
      // aligned words, inside the frame whole or not at all
#pragma unroll
      for (int g = 0; g < kCircleCols / 4; ++g) {
        if (x + 4 * g >= width) break;
        uint32_t word[3] = {0, 0, 0};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int v = 4 * g + u;
          const uint32_t b0 = store_u8(sum0[h][v], sumk[h][v], rounding);
          const uint32_t b1 = store_u8(sum1[h][v], sumk[h][v], rounding);
          const uint32_t b2 = store_u8(sum2[h][v], sumk[h][v], rounding);
          word[3 * u / 4] |= b0 << 3 * u % 4 * 8;
          word[(3 * u + 1) / 4] |= b1 << (3 * u + 1) % 4 * 8;
          word[(3 * u + 2) / 4] |= b2 << (3 * u + 2) % 4 * 8;
        }
        uint32_t* ow = reinterpret_cast<uint32_t*>(o + 12 * g);
#pragma unroll
        for (int k = 0; k < 3; ++k) ow[k] = word[k];
      }
      continue;
    }
#pragma unroll
    for (int u = 0; u < kCircleCols; ++u) {
      if (x + u >= width) break;
      o[3 * u] = store_u8(sum0[h][u], sumk[h][u], rounding);
      o[3 * u + 1] = store_u8(sum1[h][u], sumk[h][u], rounding);
      o[3 * u + 2] = store_u8(sum2[h][u], sumk[h][u], rounding);
    }
  }
}

template <int R, bool kJoint, int kRows>
int launch_circle_rows(const vip_bilateral::Launch& a) {
  const long long smem = circle_smem_bytes(R, kJoint, kRows);
  const auto kernel = bilateral_circle_kernel<R, kJoint, kRows>;
  const int err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != 0) return err;
  const dim3 grid((a.width + kCircleBlockCols - 1) / kCircleBlockCols,
                  (a.height + kRowsPerBlock * kRows - 1) / (kRowsPerBlock * kRows));
  kernel<<<grid, dim3(kLanes, kRowsPerBlock), static_cast<size_t>(smem), a.stream>>>(
      a.src, a.guide, a.out, a.height, a.width, a.taps, a.n_taps, a.lut, a.border, a.rounding);
  return static_cast<int>(cudaGetLastError());
}

// What csrc/bilateral_circle_r<R>.cu defines as vip_bilateral::launch_circle_r<R>.
template <int R>
int launch_circle(const vip_bilateral::Launch& a) {
  const bool rows_h = circle_rows(a.height, a.width) == kCircleRows;
  if (a.joint) {
    return rows_h ? launch_circle_rows<R, true, kCircleRows>(a) : launch_circle_rows<R, true, 1>(a);
  }
  return rows_h ? launch_circle_rows<R, false, kCircleRows>(a) : launch_circle_rows<R, false, 1>(a);
}

}  // namespace
