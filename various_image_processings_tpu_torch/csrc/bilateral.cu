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
// Four paths, the first that is taken and fits one block's shared memory:
//
// 4. The unrolled circle (k from 3 to 9, radius 1 to 4, every frame;
//    csrc/bilateral_circle.cuh, compiled a radius a file in
//    csrc/bilateral_circle_r<R>.cu), taken first: the radius is a
//    template parameter, so the circle's taps are a list the compiler
//    knows and the tap loop is straight code, with every tile offset an
//    immediate and no tap table walked.  A thread holds 4 adjacent output
//    columns of 2 adjacent rows (1 row where 2 would give the card's SMs
//    fewer than 2 blocks each, as at 512 x 512); a warp is 32 threads side
//    by side, a block 8 warps stacked.  The halo tile is one
//    packed word a pixel (or guide and source side by side) with a pad word
//    after every 4, so the 32 lanes, 4 columns apart, read 32 distinct banks.
//    A thread walks its windows' source rows top to bottom and each row's
//    words left to right, loads and converts each word once and adds it to
//    every output whose circle holds it, so each output still adds its taps
//    in (ky, kx) order.  The weights are a dense (2r + 1)^2 array the block
//    scatters from the tap table, 0 where it has none; such a tap adds
//    exactly +0.
// 1. Four columns (k from 11 to 63, on frames more than 16 rows high): a
//    thread computes 4 adjacent output pixels of one row; a warp is 32 rows
//    of 4 columns, a lane a row, and a block 8 warps side by side, 32 x 32.
//    The halo tile holds a 16-byte word a pixel: the packed guide pixel,
//    then the three source channels already turned into floats, so a word
//    is one LDS.128 and no conversion; its rows are padded to an odd number
//    of words, so the 8 rows of a quarter warp never share a bank.  For
//    each tap row, in order, a thread walks the words of its tile row once,
//    left to right: word c is output u's tap (ky, c - u).  A run of n taps
//    of a tap row (the circle's rows are one run each; the block finds the
//    runs from a 64-bit mask of each row's taps) is n + 3 words: the first
//    3 serve outputs 0, 0..1 and 0..2, the last 3 outputs 1..3, 2..3 and 3,
//    and the n - 3 between all four, so a run is two ramps of straight code
//    around one loop with no test inside (a run shorter than 4 is straight
//    code), and each output still adds its taps in (ky, kx) order.  The
//    weights of a word, one for each output, are one broadcast float4 load
//    from a table the block builds from the tap table.  A whole block's
//    output goes out through shared memory as whole 32-bit words.
// 2. P = 4 (k up to 177 self, 111 joint): 8 rows of 32 x 4 pixels a block,
//    4 pixels a thread along x (32 apart, so a warp's shared-memory reads of
//    one tap stay on 32 distinct banks), a tile of packed words (below).
// 3. P = 1 (k up to 219 self, 149 joint), then bands: where the P = 1 tile
//    does not fit either, it is streamed through shared memory in bands of
//    tap rows (past k ~ 3521 joint, 7073 self, segments of one tap row), in
//    (ky, kx) order: each band takes the taps before its end, with the sums
//    held in registers, so every pixel adds its taps in the same order and
//    every bit stays the same.
// In paths 2 and 3 a (8 + 2r) x (32 P + 2r) halo tile of the guide is read
// straight from the HWC u8 image into shared memory, one 32-bit word per
// pixel (b, g, r, 0); the joint filter keeps each guide word beside the
// source pixel's, so one 8-byte load brings both.  Every path folds the
// border into its load: clamped for replicate, reflected (repeatedly, as
// cv::borderInterpolate) for reflect-101, so there is no separate pad pass.
// The 768-entry f32 range LUT goes to shared memory beside the tile; in
// paths 2 and 3 the tap table follows in chunks of 256 taps as (byte offset
// in the tile, ws) pairs: each tap is one broadcast 8-byte shared load for
// P pixels.
//
// Per pixel, for each tap (dy, dx, ws) in the reference's (ky, kx) order:
//   d  = sum_c |g(p+t) - g(p)|     (one __vsadu4 on the packed words)
//   wk = ws * lut[d]
//   sum_c += s_c(p+t) * wk;  sumk += wk
// and the store is u8(floor(sum_c / sumk + 0.5)) or u8(rint(sum_c / sumk)).
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, which
// nvcc never contracts into FMAs) and the division is a true IEEE division
// (__fdiv_rn): contraction and reciprocal-multiplies are what flipped u8
// results on the JAX side (PARITY.md D1b/D1c).  A channel byte becomes a
// float exactly and without I2F: __byte_perm puts it under the exponent of
// 2^23 (0x4B0000bb is 2^23 + b) and one subtraction of 2^23 leaves b.  The
// TPU kernel's pair symmetry (one weight for the taps t and -t, added to
// both pixels) is left out: it adds each pixel's taps in another order, and
// f32 sums in another order are other bits.
//
// Why the LUT and not the TPU's exp: the TPU kernels recompute the range
// weight as exp2(d^2 * coeff * log2e + log2 ws) because gathers serialize
// on its vector unit, which costs them up to one u8 against the golden
// layer.  On Hopper a shared-memory gather is one instruction, it is what
// the reference's own CUDA kernel does, and with the same f64-built table
// and the same op order the result is bit-exact to golden/bilateral.py.
//
// What bounds it on the card: instruction issue.  At 4K and k=9, 49 taps x
// 8.29 M pixels is ~7 G thread-instructions against ~50 MB of device memory
// traffic.  The bound counts 8 f32 operations a tap and pixel; exactness
// forbids FMAs, so these 8 are 8 instructions, and with __vsadu4, the LUT
// address and its gather a (tap, pixel) pair can issue no fewer than 11.
// Path 2 issues about 18: the pair also loads its tile word and turns 3
// channel bytes into floats (6 instructions), and each of a thread's 4
// pixels pays that again for the same word, since its pixels lie 32
// columns apart.  Path 4 issues 12.66 a pair at k=9 (2 x 4 outputs a
// thread; 13.88 with 1 x 4): a word and its conversion serve 4.45 pairs,
// the weights stay in registers, and no loop or dispatch is left (measured
// on the card; PERF.md §6).  Path 1 converts each word once, at staging,
// and loads it once for the outputs that use it: a word and its weights (2
// loads) serve 2.6 pairs at k=9, 3.2 at k=17 (the union of 4 shifted
// circles), and the loop over the words that serve all 4 outputs issues
// 11.75 a pair.  What it adds is fixed work a block: the tap table turned
// into weights and runs, 16-byte staging, and the output through shared
// memory, about 0.035 ms a 4K frame more than path 2's.  So below k = 11
// path 2 was as fast (k = 9) or faster (k <= 7), and path 1 is taken from
// k = 11 (measured on the card; PERF.md §6); path 4 now takes k <= 9.  Blocking along y (4 rows
// of one column a thread) at run time costs more than it saves: there the
// window's edges cut each source row into runs serving different sets of
// outputs, varying from row to row, and dispatching each run takes ~40
// issue slots; path 4 blocks along y at no cost, its runs unrolled.  The
// LUT gather's bank conflicts do not bind on photographs; on noise, where
// neighbours' distances differ, they make path 1 no faster than path 2 at
// k = 17.  The first version spent ~30 instructions a tap and pixel: a
// 16-byte tap load per thread, an I2F per channel (a quarter-rate
// conversion) and loop overhead for one pixel.

#include <cstdint>
#include <utility>

#include "bilateral_circle.cuh"
#include "bilateral_common.cuh"

namespace {

constexpr int kTapChunk = 256;           // taps staged in shared memory at a time
constexpr long long kMaxSmem = 232448;   // dynamic shared memory one block can use (227 KB)

__host__ __device__ constexpr long long tile_words(int radius, int pixels) {
  return static_cast<long long>(kLanes * pixels + 2 * radius) * (kRowsPerBlock + 2 * radius);
}

// LUT, tap chunk and the halo tile of 32-bit (self) or 64-bit (joint) words.
long long smem_bytes(int radius, bool joint, int pixels) {
  return kLutSize * 4LL + kTapChunk * 8LL + (joint ? 2 : 1) * tile_words(radius, pixels) * 4;
}

int pixels_per_thread(int radius, bool joint) {
  return smem_bytes(radius, joint, 4) <= kMaxSmem ? 4 : 1;
}

// The one-pixel path's halo tile in bands.  A band covers tap rows
// [d0, d0 + rows) and tap columns [e0, e0 + cols): every column of a tap
// row where (rows + 7) full tile rows fit, else one tap row cut into
// column segments.  Its tile is (rows + 7) x (cols + 31) words.
struct BandPlan {
  int rows;
  int cols;
  long long smem;
};

BandPlan band_plan(int radius, bool joint) {
  const long long word = joint ? 8 : 4;
  const long long fixed = kLutSize * 4LL + kTapChunk * 8LL;
  const int ksize = 2 * radius + 1;
  auto bytes = [&](int rows, int cols) {
    return fixed + static_cast<long long>(rows + kRowsPerBlock - 1) * (cols + kLanes - 1) * word;
  };
  int rows = ksize, cols = ksize;
  if (bytes(rows, cols) > kMaxSmem) {
    rows = static_cast<int>((kMaxSmem - fixed) / ((cols + kLanes - 1) * word)) -
           (kRowsPerBlock - 1);
    if (rows < 1) {
      rows = 1;
      cols = static_cast<int>((kMaxSmem - fixed) / (kRowsPerBlock * word)) - (kLanes - 1);
    }
  }
  return {rows, cols, bytes(rows, cols)};
}

template <bool kJoint, int kPix>
__global__ void __launch_bounds__(kThreads, 4)
bilateral_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ guide,
                 uint8_t* __restrict__ out, int height, int width,
                 const int4* __restrict__ taps, int n_taps,
                 const float* __restrict__ lut, int radius, int border, int rounding) {
  using Word = typename TileWord<kJoint>::type;
  constexpr int kTileW = kLanes * kPix;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  int2* s_taps = reinterpret_cast<int2*>(s_lut + kLutSize);
  Word* s_tile = reinterpret_cast<Word*>(s_taps + kTapChunk);
  const int tile_w = kTileW + 2 * radius;
  const int tile_h = kRowsPerBlock + 2 * radius;

  const int tid = threadIdx.y * kLanes + threadIdx.x;
  // taps t0 .. t0 + n - 1 as (byte offset in the tile, bits of ws)
  auto stage_taps = [&](int t0, int n) {
    for (int i = tid; i < n; i += kThreads) {
      const int4 tap = __ldg(taps + t0 + i);  // (dy, dx, bits of ws, 0)
      s_taps[i] = make_int2((tap.x * tile_w + tap.y) * static_cast<int>(sizeof(Word)), tap.z);
    }
  };
  for (int i = tid; i < kLutSize; i += kThreads) s_lut[i] = lut[i];
  stage_taps(0, min(kTapChunk, n_taps));

  const int x0 = blockIdx.x * kTileW - radius;
  const int y0 = blockIdx.y * kRowsPerBlock - radius;
  for (int ly = threadIdx.y; ly < tile_h; ly += kRowsPerBlock) {
    const size_t row = static_cast<size_t>(fold(y0 + ly, height, border)) * width;
    for (int lx = threadIdx.x; lx < tile_w; lx += kLanes) {
      const size_t p = (row + fold(x0 + lx, width, border)) * 3;
      s_tile[ly * tile_w + lx] = tile_word<kJoint>(guide + p, src + p);
    }
  }
  __syncthreads();

  // pixel k of this thread is column threadIdx.x + 32 k of the block
  const int base = threadIdx.y * tile_w + threadIdx.x;
  uint32_t center[kPix];
  float sum0[kPix], sum1[kPix], sum2[kPix], sumk[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    center[k] = guide_of(s_tile[base + radius * tile_w + radius + kLanes * k]);
    sum0[k] = sum1[k] = sum2[k] = sumk[k] = 0.0f;
  }
  for (int t0 = 0;;) {
    const int n = min(kTapChunk, n_taps - t0);
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      const int2 tap = s_taps[t];  // the same for every thread: a broadcast
      const float ws = __int_as_float(tap.y);
      const Word* at = reinterpret_cast<const Word*>(
          reinterpret_cast<const unsigned char*>(s_tile + base) + tap.x);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const Word word = at[kLanes * k];
        const float wk = __fmul_rn(ws, s_lut[__vsadu4(guide_of(word), center[k])]);
        const uint32_t sw = source_of(word);
        sum0[k] = __fadd_rn(sum0[k], __fmul_rn(channel<0>(sw), wk));
        sum1[k] = __fadd_rn(sum1[k], __fmul_rn(channel<1>(sw), wk));
        sum2[k] = __fadd_rn(sum2[k], __fmul_rn(channel<2>(sw), wk));
        sumk[k] = __fadd_rn(sumk[k], wk);
      }
    }
    t0 += kTapChunk;
    if (t0 >= n_taps) break;
    __syncthreads();  // every thread is done with this chunk
    stage_taps(t0, min(kTapChunk, n_taps - t0));
    __syncthreads();
  }

  const int y = blockIdx.y * kRowsPerBlock + threadIdx.y;
  if (y >= height) return;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int x = blockIdx.x * kTileW + threadIdx.x + kLanes * k;
    if (x >= width) continue;
    uint8_t* o = out + (static_cast<size_t>(y) * width + x) * 3;
    o[0] = store_u8(sum0[k], sumk[k], rounding);
    o[1] = store_u8(sum1[k], sumk[k], rounding);
    o[2] = store_u8(sum2[k], sumk[k], rounding);
  }
}

// Radii whose 4-pixel tile does not fit: one pixel a thread, the halo tile
// streamed through shared memory band by band (BandPlan).  Bands go in
// (ky, kx) order, and each takes the taps before its end in that order,
// so every sum adds the same taps in the same order as the one-tile path.
template <bool kJoint>
__global__ void __launch_bounds__(kThreads)
bilateral_band_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ guide,
                      uint8_t* __restrict__ out, int height, int width,
                      const int4* __restrict__ taps, int n_taps,
                      const float* __restrict__ lut, int radius, int border, int rounding,
                      int band_rows, int band_cols) {
  using Word = typename TileWord<kJoint>::type;
  static_assert(kThreads == kTapChunk, "each thread stages one tap of a chunk");
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  int2* s_taps = reinterpret_cast<int2*>(s_lut + kLutSize);
  Word* s_tile = reinterpret_cast<Word*>(s_taps + kTapChunk);
  const int ksize = 2 * radius + 1;
  const int tile_w = kLanes - 1 + band_cols;

  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < kLutSize; i += kThreads) s_lut[i] = lut[i];

  const int x = blockIdx.x * kLanes + threadIdx.x;
  const int y = blockIdx.y * kRowsPerBlock + threadIdx.y;
  // the centre may lie in any band: read it from the image (folded, so a
  // thread past the edge reads a pixel too)
  const uint32_t center =
      load_pixel(guide + (static_cast<size_t>(fold(y, height, border)) * width +
                          fold(x, width, border)) * 3);
  const Word* at0 = s_tile + threadIdx.y * tile_w + threadIdx.x;
  float sum0 = 0.0f, sum1 = 0.0f, sum2 = 0.0f, sumk = 0.0f;
  int t0 = 0;  // first tap not yet added
  for (int d0 = 0; d0 < ksize; d0 += band_rows) {
    const int d1 = min(d0 + band_rows, ksize);
    for (int e0 = 0; e0 < ksize; e0 += band_cols) {
      const int e1 = min(e0 + band_cols, ksize);
      __syncthreads();  // every thread is done with the previous band's tile and taps
      const int rows = d1 - d0 + kRowsPerBlock - 1;
      const int cols = e1 - e0 + kLanes - 1;
      const int gy0 = blockIdx.y * kRowsPerBlock - radius + d0;
      const int gx0 = blockIdx.x * kLanes - radius + e0;
      for (int ly = threadIdx.y; ly < rows; ly += kRowsPerBlock) {
        const size_t row = static_cast<size_t>(fold(gy0 + ly, height, border)) * width;
        for (int lx = threadIdx.x; lx < cols; lx += kLanes) {
          const size_t p = (row + fold(gx0 + lx, width, border)) * 3;
          s_tile[ly * tile_w + lx] = tile_word<kJoint>(guide + p, src + p);
        }
      }
      // the band's taps, those before (d1 - 1, e1) in (ky, kx) order, a
      // chunk at a time
      for (;;) {
        int in_band = 0;
        if (t0 + tid < n_taps) {
          const int4 tap = __ldg(taps + t0 + tid);  // (dy, dx, bits of ws, 0)
          in_band = tap.x < d1 - 1 || (tap.x == d1 - 1 && tap.y < e1);
          if (in_band) {
            s_taps[tid] = make_int2(
                ((tap.x - d0) * tile_w + tap.y - e0) * static_cast<int>(sizeof(Word)), tap.z);
          }
        }
        // the taps are sorted, so the band's are the first n; the barrier
        // also makes the tile and the staged taps visible
        const int n = __syncthreads_count(in_band);
#pragma unroll 2
        for (int t = 0; t < n; ++t) {
          const int2 tap = s_taps[t];
          const Word word = *reinterpret_cast<const Word*>(
              reinterpret_cast<const unsigned char*>(at0) + tap.x);
          const float wk = __fmul_rn(__int_as_float(tap.y),
                                     s_lut[__vsadu4(guide_of(word), center)]);
          const uint32_t sw = source_of(word);
          sum0 = __fadd_rn(sum0, __fmul_rn(channel<0>(sw), wk));
          sum1 = __fadd_rn(sum1, __fmul_rn(channel<1>(sw), wk));
          sum2 = __fadd_rn(sum2, __fmul_rn(channel<2>(sw), wk));
          sumk = __fadd_rn(sumk, wk);
        }
        t0 += n;
        if (n < kTapChunk) break;
        __syncthreads();  // every thread is done with this chunk
      }
    }
  }
  if (x >= width || y >= height) return;
  uint8_t* o = out + (static_cast<size_t>(y) * width + x) * 3;
  o[0] = store_u8(sum0, sumk, rounding);
  o[1] = store_u8(sum1, sumk, rounding);
  o[2] = store_u8(sum2, sumk, rounding);
}

// ---- path 1: 4 output columns a thread ----

constexpr int kCols = 4;        // output columns a thread
constexpr int kBlockCols = 32;  // a block: 8 warps side by side, 4 columns each ...
constexpr int kBlockRows = 32;  // ... of 32 rows, a lane a row
constexpr int kMinColsRadius = 5;  // below k = 11 path 2 was as fast or faster (PERF.md §6)
constexpr int kOutWords = kBlockCols * 3 / 4;  // u32 of a block's output row
constexpr int kOutStride = kOutWords + 1;      // padded so the 32 lanes write 32 banks

// A row of the halo tile in 16-byte words: its width padded to odd, so the
// 8 lanes (8 rows) of a quarter warp reading one column of it fall on 8
// distinct 16-byte slots.
__host__ __device__ constexpr int tile_stride(int radius) { return kBlockCols + 2 * radius + 1; }

// Runs of consecutive taps a tap row can hold.
__host__ __device__ constexpr int max_runs(int ksize) { return (ksize + 1) / 2; }

// The LUT; the halo tile, a 16-byte word a pixel (the packed guide pixel,
// then each source channel as a float); the weights, one float4 a (tap
// row, word column: tap columns 0 .. 2r + 3 of a thread's first output); a
// 64-bit mask of the taps of each tap row, its runs and their count.
long long cols_smem_bytes(int radius) {
  const long long ksize = 2 * radius + 1;
  const long long tile = static_cast<long long>(tile_stride(radius)) * (kBlockRows + 2 * radius);
  return kLutSize * 4LL + tile * 16 + ksize * (ksize + kCols - 1) * 16 +
         ksize * (8 + 4 * max_runs(ksize) + 4);
}

// Output columns a thread computes on path 1, 0 where it is not taken: from
// k = 11 to the 63 taps a row mask holds, on frames more than 16 rows high
// (a block is 32).
int cols_per_thread(int radius, int height) {
  return radius >= kMinColsRadius && 2 * radius + 1 <= 63 && height > kBlockRows / 2 &&
                 cols_smem_bytes(radius) <= kMaxSmem
             ? kCols
             : 0;
}

// A thread's outputs, left to right: the guide's centre words and the sums.
struct ColSums {
  uint32_t center[kCols];
  float sum0[kCols], sum1[kCols], sum2[kCols], sumk[kCols];
};

__device__ __forceinline__ float weight(float4 w, int u) {
  return u == 0 ? w.x : u == 1 ? w.y : u == 2 ? w.z : w.w;
}

// The tile word at index at, added to the outputs in kSet (bit u: output u)
// with output u's weight ws[u].
template <int kSet>
__device__ __forceinline__ void add_word(ColSums& acc, const uint4* tile, int at, float4 ws,
                                         const float* s_lut) {
  const uint4 word = tile[at];  // guide, then the source's channels as floats
  const float c0 = __uint_as_float(word.y);
  const float c1 = __uint_as_float(word.z);
  const float c2 = __uint_as_float(word.w);
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    if (kSet >> u & 1) {
      const float wk = __fmul_rn(weight(ws, u), s_lut[__vsadu4(word.x, acc.center[u])]);
      acc.sum0[u] = __fadd_rn(acc.sum0[u], __fmul_rn(c0, wk));
      acc.sum1[u] = __fadd_rn(acc.sum1[u], __fmul_rn(c1, wk));
      acc.sum2[u] = __fadd_rn(acc.sum2[u], __fmul_rn(c2, wk));
      acc.sumk[u] = __fadd_rn(acc.sumk[u], wk);
    }
  }
}

// Words kJ... of a run of kN taps (kN <= 4) whose word 0 is at index at and
// whose weights start at w, as straight code: word j serves the outputs u
// with 0 <= j - u < kN.
template <int kN, int... kJ>
__device__ __forceinline__ void add_words(ColSums& acc, const uint4* tile, int at,
                                          const float4* w, const float* s_lut,
                                          std::integer_sequence<int, kJ...>) {
  (add_word<((2 << (kJ < kCols - 1 ? kJ : kCols - 1)) - 1) &
            ~((1 << (kJ >= kN ? kJ - kN + 1 : 0)) - 1)>(acc, tile, at + kJ, w[kJ], s_lut),
   ...);
}

// A run of n taps of a tap row, [a, a + n): its n + 3 words [a, a + n + 3)
// of the thread's tile row (index row + c), word c serving output u as its
// tap c - u.  A run shorter than 4 is straight code; a longer one a ramp of
// 3 words, a loop over the words that serve all 4 outputs, and a ramp.
__device__ __forceinline__ void add_run(ColSums& acc, const uint4* tile, int row,
                                        const float4* w, int a, int n, const float* s_lut) {
  const int at = row + a;
  w += a;
  switch (n) {
    case 1:
      add_words<1>(acc, tile, at, w, s_lut, std::make_integer_sequence<int, 4>{});
      return;
    case 2:
      add_words<2>(acc, tile, at, w, s_lut, std::make_integer_sequence<int, 5>{});
      return;
    case 3:
      add_words<3>(acc, tile, at, w, s_lut, std::make_integer_sequence<int, 6>{});
      return;
  }
  add_words<kCols>(acc, tile, at, w, s_lut, std::make_integer_sequence<int, kCols - 1>{});
#pragma unroll 4
  for (int c = kCols - 1; c < n; ++c) add_word<(1 << kCols) - 1>(acc, tile, at + c, w[c], s_lut);
  // the last 3 words: words 4..6 of a run of 4 taps that ends where this one does
  add_words<kCols>(acc, tile, at + n - kCols, w + n - kCols, s_lut,
                   std::integer_sequence<int, kCols, kCols + 1, kCols + 2>{});
}

// Path 1: a thread computes 4 adjacent output columns of one row.
template <bool kJoint>
__global__ void __launch_bounds__(kThreads, 4)
bilateral_cols_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ guide,
                      uint8_t* __restrict__ out, int height, int width,
                      const int4* __restrict__ taps, int n_taps,
                      const float* __restrict__ lut, int radius, int border, int rounding) {
  const int ksize = 2 * radius + 1;
  const int wcols = ksize + kCols - 1;  // word columns of a tap row
  const int stride = tile_stride(radius);
  const int tile_w = kBlockCols + 2 * radius;
  const int tile_h = kBlockRows + 2 * radius;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  uint4* s_tile = reinterpret_cast<uint4*>(s_lut + kLutSize);
  float4* s_w = reinterpret_cast<float4*>(s_tile + stride * tile_h);
  unsigned long long* s_mask = reinterpret_cast<unsigned long long*>(s_w + ksize * wcols);
  uint32_t* s_run = reinterpret_cast<uint32_t*>(s_mask + ksize);  // (first tap, length)
  int* s_runs = reinterpret_cast<int*>(s_run + ksize * max_runs(ksize));

  const int tid = threadIdx.y * kLanes + threadIdx.x;
  // this thread's first tap, read now so that its latency hides behind the
  // staging: (dy, dx, bits of ws, 0)
  const int4 tap0 = tid < n_taps ? __ldg(taps + tid) : make_int4(0, 0, 0, 0);
  for (int i = tid; i < kLutSize; i += kThreads) s_lut[i] = lut[i];
  for (int i = tid; i < ksize; i += kThreads) s_mask[i] = 0;
  const int x0 = blockIdx.x * kBlockCols - radius;
  const int y0 = blockIdx.y * kBlockRows - radius;
  for (int ly = threadIdx.y; ly < tile_h; ly += kRowsPerBlock) {
    const size_t row = static_cast<size_t>(fold(y0 + ly, height, border)) * width;
    for (int lx = threadIdx.x; lx < tile_w; lx += kLanes) {
      const size_t p = (row + fold(x0 + lx, width, border)) * 3;
      const uint32_t g = load_pixel(guide + p);
      const uint32_t s = kJoint ? load_pixel(src + p) : g;
      s_tile[ly * stride + lx] =
          make_uint4(g, __float_as_uint(channel<0>(s)), __float_as_uint(channel<1>(s)),
                     __float_as_uint(channel<2>(s)));
    }
  }
  __syncthreads();  // the masks are zero
  // tap (dy, dx) is output u's at word column dx + u of tap row dy
  for (int i = tid; i < n_taps; i += kThreads) {
    const int4 tap = i == tid ? tap0 : __ldg(taps + i);
    float* w = reinterpret_cast<float*>(s_w + tap.x * wcols + tap.y);
#pragma unroll
    for (int u = 0; u < kCols; ++u) w[u * 4 + u] = __int_as_float(tap.z);
    atomicOr(s_mask + tap.x, 1ull << tap.y);
  }
  __syncthreads();
  // each tap row's runs of consecutive taps, in column order
  for (int ky = tid; ky < ksize; ky += kThreads) {
    uint32_t* runs = s_run + ky * max_runs(ksize);
    int n = 0;
    for (unsigned long long m = s_mask[ky]; m != 0; ++n) {
      const int a = __ffsll(m) - 1;
      const int len = __ffsll(~(m >> a)) - 1;
      runs[n] = a | static_cast<uint32_t>(len) << 16;
      m &= ~0ull << (a + len);
    }
    s_runs[ky] = n;
  }
  __syncthreads();

  // this thread's outputs: block row threadIdx.x, columns 4 threadIdx.y + u
  const int rb = threadIdx.x;
  const int cb = kCols * threadIdx.y;
  ColSums acc;
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    acc.center[u] = s_tile[(rb + radius) * stride + cb + u + radius].x;
    acc.sum0[u] = acc.sum1[u] = acc.sum2[u] = acc.sumk[u] = 0.0f;
  }
  for (int ky = 0; ky < ksize; ++ky) {
    const int row = (rb + ky) * stride + cb;  // word column c is at row + c
    const float4* w = s_w + ky * wcols;
    const uint32_t* runs = s_run + ky * max_runs(ksize);
    const int n = s_runs[ky];
    for (int e = 0; e < n; ++e) add_run(acc, s_tile, row, w, runs[e] & 0xFFFF, runs[e] >> 16, s_lut);
  }

  const int y = blockIdx.y * kBlockRows + rb;
  const int x = blockIdx.x * kBlockCols + cb;
  if (width % 4 == 0 && (blockIdx.x + 1) * kBlockCols <= width &&
      (blockIdx.y + 1) * kBlockRows <= height) {
    // a whole block on rows of whole words: its 32 rows of 96 bytes go out
    // through shared memory as whole words, a warp on 128 consecutive bytes
    uint32_t word[3] = {0, 0, 0};
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const uint32_t b0 = store_u8(acc.sum0[u], acc.sumk[u], rounding);
      const uint32_t b1 = store_u8(acc.sum1[u], acc.sumk[u], rounding);
      const uint32_t b2 = store_u8(acc.sum2[u], acc.sumk[u], rounding);
      word[3 * u / 4] |= b0 << 3 * u % 4 * 8;
      word[(3 * u + 1) / 4] |= b1 << (3 * u + 1) % 4 * 8;
      word[(3 * u + 2) / 4] |= b2 << (3 * u + 2) % 4 * 8;
    }
    __syncthreads();  // every thread is done with the tile
    uint32_t* s_out = reinterpret_cast<uint32_t*>(s_tile);
#pragma unroll
    for (int j = 0; j < 3; ++j) s_out[rb * kOutStride + 3 * threadIdx.y + j] = word[j];
    __syncthreads();
    uint32_t* o = reinterpret_cast<uint32_t*>(
        out + (static_cast<size_t>(blockIdx.y) * kBlockRows * width + x - cb) * 3);
    for (int i = tid; i < kBlockRows * kOutWords; i += kThreads) {
      const int r = i / kOutWords, c = i % kOutWords;
      o[static_cast<size_t>(r) * width * 3 / 4 + c] = s_out[r * kOutStride + c];
    }
    return;
  }
  if (y >= height || x >= width) return;
  uint8_t* o = out + (static_cast<size_t>(y) * width + x) * 3;
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    if (x + u >= width) break;
    o[3 * u] = store_u8(acc.sum0[u], acc.sumk[u], rounding);
    o[3 * u + 1] = store_u8(acc.sum1[u], acc.sumk[u], rounding);
    o[3 * u + 2] = store_u8(acc.sum2[u], acc.sumk[u], rounding);
  }
}

template <bool kJoint>
int launch_cols(const uint8_t* src, const uint8_t* guide, uint8_t* out, int height, int width,
                const int4* taps, int n_taps, const float* lut, int radius, int border,
                int rounding, cudaStream_t stream) {
  const long long smem = cols_smem_bytes(radius);
  const int err = set_smem(reinterpret_cast<const void*>(bilateral_cols_kernel<kJoint>), smem);
  if (err != 0) return err;
  const dim3 grid((width + kBlockCols - 1) / kBlockCols, (height + kBlockRows - 1) / kBlockRows);
  bilateral_cols_kernel<kJoint><<<grid, dim3(kLanes, kRowsPerBlock), static_cast<size_t>(smem),
                                  stream>>>(src, guide, out, height, width, taps, n_taps, lut,
                                            radius, border, rounding);
  return static_cast<int>(cudaGetLastError());
}

// The path a launch takes, the first that is taken: 4 the unrolled circle
// (radius 1 to 4), 1 four adjacent columns a thread, 2 four pixels 32
// apart, 3 one pixel a thread (in bands where its tile does not fit).
int path_of(int radius, bool joint, int height) {
  if (radius >= 1 && radius <= kCircleMaxRadius) return 4;
  if (cols_per_thread(radius, height) != 0) return 1;
  return pixels_per_thread(radius, joint) == 4 ? 2 : 3;
}

template <bool kJoint>
int launch(const uint8_t* src, const uint8_t* guide, uint8_t* out, int height, int width,
           const int4* taps, int n_taps, const float* lut, int radius, int border,
           int rounding, cudaStream_t stream) {
  const vip_bilateral::Launch a{kJoint, src,    guide, out,    height,   width,
                                taps,   n_taps, lut,   border, rounding, stream};
  switch (radius) {
    case 1:
      return vip_bilateral::launch_circle_r1(a);
    case 2:
      return vip_bilateral::launch_circle_r2(a);
    case 3:
      return vip_bilateral::launch_circle_r3(a);
    case 4:
      return vip_bilateral::launch_circle_r4(a);
  }
  static_assert(kCircleMaxRadius == 4, "one file a radius of path 4");
  if (cols_per_thread(radius, height) != 0) {
    return launch_cols<kJoint>(src, guide, out, height, width, taps, n_taps, lut, radius, border,
                               rounding, stream);
  }
  const dim3 block(kLanes, kRowsPerBlock);
  const int grid_y = (height + kRowsPerBlock - 1) / kRowsPerBlock;
  if (pixels_per_thread(radius, kJoint) == 4) {
    constexpr int kPix = 4;
    const long long smem = smem_bytes(radius, kJoint, kPix);
    const int err = set_smem(reinterpret_cast<const void*>(bilateral_kernel<kJoint, kPix>), smem);
    if (err != 0) return err;
    const int tile_w = kLanes * kPix;
    const dim3 grid((width + tile_w - 1) / tile_w, grid_y);
    bilateral_kernel<kJoint, kPix><<<grid, block, static_cast<size_t>(smem), stream>>>(
        src, guide, out, height, width, taps, n_taps, lut, radius, border, rounding);
    return static_cast<int>(cudaGetLastError());
  }
  const BandPlan plan = band_plan(radius, kJoint);
  const int err = set_smem(reinterpret_cast<const void*>(bilateral_band_kernel<kJoint>), plan.smem);
  if (err != 0) return err;
  const dim3 grid((width + kLanes - 1) / kLanes, grid_y);
  bilateral_band_kernel<kJoint><<<grid, block, static_cast<size_t>(plan.smem), stream>>>(
      src, guide, out, height, width, taps, n_taps, lut, radius, border, rounding, plan.rows,
      plan.cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at this radius and height: path 4's
// (of its 2-row block, the larger), path 1's, the 4-pixel tile's, or one
// band of the 1-pixel path's tile.
long long vip_bilateral_smem_bytes(int radius, int joint, int height) {
  switch (path_of(radius, joint != 0, height)) {
    case 4:
      return circle_smem_bytes(radius, joint != 0, kCircleRows);
    case 1:
      return cols_smem_bytes(radius);
    case 2:
      return smem_bytes(radius, joint != 0, 4);
  }
  return band_plan(radius, joint != 0).smem;
}

// The path a launch at this radius and height takes: 4 (the unrolled
// circle), 1 (four adjacent columns a thread), 2 (four pixels 32 apart) or
// 3 (one pixel a thread, in bands where its tile does not fit).
int vip_bilateral_path(int radius, int joint, int height) {
  return path_of(radius, joint != 0, height);
}

// Output columns each thread computes on path 1 at this radius and height
// (the same for both forms): 4, or 0 where the launch takes a path below.
int vip_bilateral_columns_per_thread(int radius, int height) {
  return cols_per_thread(radius, height);
}

// Pixels each thread computes on paths 2 and 3: 4, or 1 where a 4-pixel
// halo tile would not fit in shared memory.
int vip_bilateral_pixels_per_thread(int radius, int joint) {
  return pixels_per_thread(radius, joint != 0);
}

// The 1-pixel path's band: tap rows (which == 0) or tap columns (which ==
// 1) a band covers; 2r + 1 of both where the whole tile fits.
int vip_bilateral_band(int radius, int joint, int which) {
  const BandPlan plan = band_plan(radius, joint != 0);
  return which == 0 ? plan.rows : plan.cols;
}

// guide == nullptr: the self filter.  taps: n_taps >= 1 int4 (dy, dx, f32
// bits of ws, 0) in (ky, kx) order, each (dy, dx) once, dy/dx in [0,
// 2*radius]; at radius 1 to 4 (path 4) every tap inside the inscribed
// circle, (dy - r)^2 + (dx - r)^2 <= r^2, as core.luts.tap_table gives
// them (path 4 adds the circle's taps, with weight 0 where the table has
// none, and no other).  lut: 768 finite f32 >= 0.
// Returns the launch's cudaError_t (0 on success).
int vip_bilateral_u8(const void* src, const void* guide, void* out, int height, int width,
                     const void* taps, int n_taps, const void* lut, int radius, int border,
                     int rounding, void* stream) {
  const auto* s = static_cast<const uint8_t*>(src);
  const auto* t = static_cast<const int4*>(taps);
  const auto* l = static_cast<const float*>(lut);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (guide == nullptr) {
    return launch<false>(s, s, o, height, width, t, n_taps, l, radius, border, rounding, st);
  }
  return launch<true>(s, static_cast<const uint8_t*>(guide), o, height, width, t, n_taps, l,
                          radius, border, rounding, st);
}

const char* vip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
