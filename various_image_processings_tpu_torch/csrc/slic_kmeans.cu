// SLIC k-means for Hopper (sm_90a): one iteration in three kernels, for
// each of the three colour metrics.
//
// Replaces no Pallas kernel: the JAX package runs its whole k-means as one
// jitted XLA program (various_image_processings_tpu/models/slic.py:129,
// slic_device, a lax.while_loop at :353-369).  These kernels are the card's
// counterpart of that device program, and compute what the port's plain
// version (models/slic.py::_Grid) computes, bit for bit:
//
//   slic_association_kernel  every pixel takes the candidate centers of its
//     cell's (2R + 1)^2 cell neighbourhood in ascending id, against the
//     persistent (labels, dists) map, strictly-smaller winning: R = 2 (25
//     candidates, the JAX package's gather) while the image's largest drift
//     so far (its state row 0) is at most one cell, else R = 1 + that drift,
//     since a center D cells from home scans pixels up to D + 1 cells from
//     it (associate_wide).  At each
//     candidate's turn a pixel that the candidate scans (|x - cx| <= S and
//     |y - cy| <= S) and whose running label is that candidate adds
//     (x, y, l, a, b, 1) to the candidate's sums: a pixel stolen by a later
//     center still counts in the earlier one's mean.  Any pixel whose
//     distance fell sets the iteration's "changed" flag.
//   slic_snap_keys_kernel    each center's mean is floor(f32(sum) /
//     f32(count)), or its state where it had no pixel; each labelled pixel's
//     key is floor(colour distance to its center's mean) * 2^32 + raster
//     index (a signed int64: a squared CIEDE2000 difference may round to a
//     tiny negative value, whose floor is -1), and each center keeps the
//     least key of its pixels (a center that drifted past the tile's
//     window takes its pixels' keys from global memory).
//   slic_update_kernel       one thread a center: it moves to the pixel of
//     its least key (or keeps its state), the running Chebyshev drift in
//     cells takes the max, the iteration count is stored, the next
//     iteration's active flag is this one's "changed", and the sums and
//     keys are cleared for the next iteration.
//
// The association and snap-key kernels are templates on the metric (models/
// slic.py::_color_dist_fn): the reference's euclidean distance, CIEDE2000
// and the reference's pi-scaled CIEDE2000 variant (core/ciede2000.py).  The
// update kernel needs no metric.  slic_delta_e_kernel evaluates the squared
// CIEDE2000 difference of arrays of pairs with the same device function, so
// the function can be held to core/ciede2000.py on its own.
//
// A batch of images of one shape runs in the same launches, as the JAX
// package vmaps its k-means: grid.y is the image, whose planes, centers,
// sums, keys and state row are its own, at 64-bit offsets (the raster index
// in a key stays the image's, in 32 bits).
//
// Early exit on the device: the host enqueues every iteration; each kernel
// reads its image's active flag for the iteration first and returns at once
// when it is clear (the JAX loop's cond, (it < n) & (num_updated > 0); in
// a batch the vmapped loop's masking: an image that stopped stays as it
// was while the others go on).  Nothing is read by the host.
//
// Exactness: the sums are integers, added with 64-bit atomics, so their
// order does not matter.  Every float product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into FMAs)
// in the plain version's order:
//   d = space_norm * (dx*dx + dy*dy) + color_norm * colour(center, pixel),
//   euclidean colour = (dl*dl + da*da) + db*db, dl = (l_c - l_p) * 2.55f,
// and the mean's quotient is __fdiv_rn of two round-to-nearest conversions.
// The CIEDE2000 function repeats core/ciede2000.py::_square operation by
// operation, with IEEE divisions and square roots and the CUDA math
// library's sinf, cosf, expf, atan2f and powf, which PyTorch's CUDA ops call
// too (no fast math, no intrinsics such as __sinf).
//
// What bounds it on the card.  Euclidean: memory.  An iteration reads the
// Lab image, the labels and the distances (11 B a pixel) and writes labels
// and distances where they changed (8 B), then reads labels and Lab again
// (7 B): ~26 B a pixel, 6.8 MB at 512x512 (2 us at 3.35 TB/s), 216 MB at 4K.
// CIEDE2000: operations, ~100 a (pixel, candidate) pair of which 11 are
// calls of the math library, each tens of instructions.  Every block keeps
// its window of candidate centers (for the CIEDE2000 metrics with their
// chroma sqrt(a^2 + b^2), computed once a center) and their sums or least
// keys in shared memory.
//
// The association's own geometry: a block of 8 warps takes a 32 x 8 pixel
// tile (1024 blocks at 512x512 for 132 SMs, whatever S), and a warp an 8 x
// 4 piece of it, so that a warp's pixels mostly share their cell, their
// candidates and the outcome of the window test.  A warp first finds, from
// its piece's pixel bounds, the candidate cells whose window may reach one
// of its pixels (~5 of the 25 at S = 26); only those are visited, in
// ascending id.  The ΔE metrics then gather the warp's (pixel, candidate)
// pairs that pass the window into a list and evaluate the colour distance
// over it with every lane busy (~4 pairs a pixel), keeping the values in
// shared memory; the euclidean distance is short and is computed in the
// scan.  The strict-< scan takes two candidates a turn (their distances
// are independent) and notes each pixel's in-scan memberships; the warp
// then sums the members of each center by warp reductions of packed
// fields, and the block relative to its tile's origin in 32-bit shared
// accumulators, which it adds, with count x origin, to the int64 sums with
// one global atomic a center and field.  The snap-key kernel keeps square
// tiles of whole cells (S <= 64; 64 x 64 pixels past that), and its warp
// reductions.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 20;  // cells a side of a block's candidate window, at most
constexpr int kSlots = kWindow * kWindow;
constexpr int kLargeTile = 64;  // tile side past S = 64
constexpr int kMaxBatch = 65535;  // images a launch: grid.y's extent
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNoKey = LLONG_MAX;  // torch.iinfo(int64).max
// x ^ kSignBit orders signed 64-bit keys as unsigned ones (the shared atomics)
constexpr unsigned long long kSignBit = 0x8000000000000000ull;

// The metrics, as core/ciede2000.py's f32 constants: the hue period kFull,
// the half period kHalf and the degree map (_deg, or the reference's _deg_ref
// which multiplies by pi) at 30, 6, 63, 275 and 25 degrees.
struct Euclidean {
  static constexpr bool kDeltaE = false;
};
struct Ciede2000 {
  static constexpr bool kDeltaE = true;
  static constexpr float kFull = 0x1.921fb6p+2f;    // f32(2 pi)
  static constexpr float kHalf = 0x1.921fb6p+1f;    // f32(pi)
  static constexpr float kDeg30 = 0x1.0c1524p-1f;   // f32(deg2rad(30))
  static constexpr float kDeg6 = 0x1.aceea0p-4f;    // f32(deg2rad(6))
  static constexpr float kDeg63 = 0x1.197c98p+0f;   // f32(deg2rad(63))
  static constexpr float kDeg275 = 0x1.332d8ep+2f;  // f32(deg2rad(275))
  static constexpr float kDeg25 = 0x1.becde6p-2f;   // f32(deg2rad(25))
};
struct Ciede2000Ref {
  static constexpr bool kDeltaE = true;
  static constexpr float kFull = 0x1.1abe4cp+10f;   // f32(360 * f32(pi))
  static constexpr float kHalf = 0x1.1abe4cp+9f;    // f32(180 * f32(pi))
  static constexpr float kDeg30 = 0x1.78fdbap+6f;   // f32(30 * f32(pi))
  static constexpr float kDeg6 = 0x1.2d97c8p+4f;    // f32(6 * f32(pi))
  static constexpr float kDeg63 = 0x1.8bd738p+7f;   // f32(63 * f32(pi))
  static constexpr float kDeg275 = 0x1.aff810p+9f;  // f32(275 * f32(pi))
  static constexpr float kDeg25 = 0x1.3a28c6p+6f;   // f32(25 * f32(pi))
};
constexpr float kPow25To7 = 6103515625.0f;  // 25^7, rounded to f32 as PyTorch rounds it

// Tile side in pixels: whole cells for S <= 64 (S * ceil(32 / S), so the
// window is ceil(32 / S) + 4 <= 20 cells a side), 64 past that (a tile then
// spans at most two cells a side: a window of 6).
int tile_side(int s) { return s <= kLargeTile ? s * ((32 + s - 1) / s) : kLargeTile; }
static_assert((32 + 1) / 2 + 4 <= kWindow, "the window at s = 2 fits the shared arrays");

// The association's tile: 32 x 8 pixels, 4 x 2 warp pieces of 8 x 4 (lane
// l at (l % 8, l / 8) of its warp's piece).  The tile spans at most 16 x 4
// cells (S = 2, tiles start at even coordinates; fewer past that), so its
// window of candidate cells is at most 20 x 8.
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kPieceW = 8;
constexpr int kPieceH = 4;
static_assert(kTileW * kTileH == kThreads && kPieceW * kPieceH == 32, "a pixel a thread");
constexpr int kAssocSlots = (kTileW / 2 + 4) * (kTileH / 2 + 4);
constexpr int kCandidates = 25;  // the 5 x 5 cell neighbourhood

// A block's pixel rectangle, clipped to the image, and its window of
// candidate cells [wy0, wy0 + wh) x [wx0, wx0 + ww), which may run past the
// cell grid: every candidate of every pixel of the tile lies in it.
struct Tile {
  int y0, x0, th, tw;
  int wy0, wx0, wh, ww;
};

__device__ __forceinline__ Tile tile_of(int side, int tiles_x, int height, int width, int s) {
  Tile t;
  t.y0 = (blockIdx.x / tiles_x) * side;
  t.x0 = (blockIdx.x % tiles_x) * side;
  t.th = min(side, height - t.y0);
  t.tw = min(side, width - t.x0);
  t.wy0 = t.y0 / s - 2;
  t.wx0 = t.x0 / s - 2;
  t.wh = (t.y0 + t.th - 1) / s + 3 - t.wy0;
  t.ww = (t.x0 + t.tw - 1) / s + 3 - t.wx0;
  return t;
}

// sqrt(a^2 + b^2): core/ciede2000.py's c1 and c2, which depend on one side
// of a pair only, so the kernels take them once a center and once a pixel.
__device__ __forceinline__ float chroma(float a, float b) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
}

// A hue angle in [0, kFull): 0 where b and a' are both 0, atan2 otherwise.
template <class M>
__device__ __forceinline__ float hue(float b, float ap) {
  const float h = (b == 0.0f && ap == 0.0f) ? 0.0f : atan2f(b, ap);
  return h < 0.0f ? __fadd_rn(h, M::kFull) : h;
}

// core/ciede2000.py::_square(l1, a1, b1, l2, a2, b2) with c1 = chroma(a1,
// b1) and c2 = chroma(a2, b2) given: the same operations in the same order,
// each rounded alone, each torch.where a select of both values.  Divisions
// by 2 are products by 0.5 (exact).
template <class M>
__device__ __forceinline__ float delta_e_square(float l1, float a1, float b1, float c1,
                                                float l2, float a2, float b2, float c2) {
  const float bar_c = __fmul_rn(__fadd_rn(c1, c2), 0.5f);
  const float bar_c7 = powf(bar_c, 7.0f);
  const float g = __fmul_rn(
      0.5f, __fsub_rn(1.0f, __fsqrt_rn(__fdiv_rn(bar_c7, __fadd_rn(bar_c7, kPow25To7)))));
  const float scale = __fadd_rn(1.0f, g);
  const float a1p = __fmul_rn(scale, a1);
  const float a2p = __fmul_rn(scale, a2);
  const float c1p = __fsqrt_rn(__fadd_rn(__fmul_rn(a1p, a1p), __fmul_rn(b1, b1)));
  const float c2p = __fsqrt_rn(__fadd_rn(__fmul_rn(a2p, a2p), __fmul_rn(b2, b2)));
  const float h1p = hue<M>(b1, a1p);
  const float h2p = hue<M>(b2, a2p);

  const float dl = __fsub_rn(l2, l1);
  const float dc = __fsub_rn(c2p, c1p);
  const float prod = __fmul_rn(c1p, c2p);
  float dh = __fsub_rn(h2p, h1p);
  dh = dh > M::kHalf ? __fsub_rn(dh, M::kFull) : dh;
  dh = dh < -M::kHalf ? __fadd_rn(dh, M::kFull) : dh;
  dh = prod == 0.0f ? 0.0f : dh;
  const float d_h = __fmul_rn(__fmul_rn(2.0f, __fsqrt_rn(prod)), sinf(__fmul_rn(dh, 0.5f)));

  const float bar_l = __fmul_rn(__fadd_rn(l1, l2), 0.5f);
  const float bar_cp = __fmul_rn(__fadd_rn(c1p, c2p), 0.5f);
  const float hsum = __fadd_rn(h1p, h2p);
  const float habs = fabsf(__fsub_rn(h1p, h2p));
  const float wrapped = hsum < M::kFull ? __fmul_rn(__fadd_rn(hsum, M::kFull), 0.5f)
                                        : __fmul_rn(__fsub_rn(hsum, M::kFull), 0.5f);
  float bar_h = habs <= M::kHalf ? __fmul_rn(hsum, 0.5f) : wrapped;
  bar_h = prod == 0.0f ? hsum : bar_h;

  float t = __fsub_rn(1.0f, __fmul_rn(0.17f, cosf(__fsub_rn(bar_h, M::kDeg30))));
  t = __fadd_rn(t, __fmul_rn(0.24f, cosf(__fmul_rn(2.0f, bar_h))));
  t = __fadd_rn(t, __fmul_rn(0.32f, cosf(__fadd_rn(__fmul_rn(3.0f, bar_h), M::kDeg6))));
  t = __fsub_rn(t, __fmul_rn(0.20f, cosf(__fsub_rn(__fmul_rn(4.0f, bar_h), M::kDeg63))));
  const float ratio = __fdiv_rn(__fsub_rn(bar_h, M::kDeg275), M::kDeg25);
  const float dtheta = __fmul_rn(M::kDeg30, expf(-__fmul_rn(ratio, ratio)));
  const float bar_cp7 = powf(bar_cp, 7.0f);
  const float r_c =
      __fmul_rn(2.0f, __fsqrt_rn(__fdiv_rn(bar_cp7, __fadd_rn(bar_cp7, kPow25To7))));
  const float dl50 = __fsub_rn(bar_l, 50.0f);
  const float s_l = __fadd_rn(1.0f, __fdiv_rn(__fmul_rn(0.015f, __fmul_rn(dl50, dl50)),
                                              __fsqrt_rn(__fadd_rn(20.0f, __fmul_rn(dl50, dl50)))));
  const float s_c = __fadd_rn(1.0f, __fmul_rn(0.045f, bar_cp));
  const float s_h = __fadd_rn(1.0f, __fmul_rn(__fmul_rn(0.015f, bar_cp), t));
  const float r_t = __fmul_rn(-sinf(__fmul_rn(2.0f, dtheta)), r_c);

  const float fl = __fdiv_rn(dl, s_l);
  const float fc = __fdiv_rn(dc, s_c);
  const float fh = __fdiv_rn(d_h, s_h);
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(fl, fl), __fmul_rn(fc, fc)), __fmul_rn(fh, fh)),
                   __fmul_rn(__fmul_rn(r_t, fc), fh));
}

// The colour distance of (center or mean, pixel), in the plain version's
// argument order.  c1, c2: the two sides' chroma (read by the ΔE metrics only).
// The euclidean one is the reference's (include/cpp/slic.hpp:8-13): L scaled
// by 2.55, each operation rounded on its own.
template <class M>
__device__ __forceinline__ float color_distance(float l1, float a1, float b1, float c1, float l2,
                                                float a2, float b2, float c2) {
  if constexpr (M::kDeltaE) {
    return delta_e_square<M>(l1, a1, b1, c1, l2, a2, b2, c2);
  } else {
    const float dl = __fmul_rn(__fsub_rn(l1, l2), 2.55f);
    const float da = __fsub_rn(a1, a2);
    const float db = __fsub_rn(b1, b2);
    return __fadd_rn(__fadd_rn(__fmul_rn(dl, dl), __fmul_rn(da, da)), __fmul_rn(db, db));
  }
}

// A 32-bit add to a shared counter, as one instruction (atomicAdd from a
// single lane would be rewritten as a warp-aggregated add).
__device__ __forceinline__ void shared_add(unsigned* counter, unsigned v) {
  asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(counter))),
               "r"(v)
               : "memory");
}

// Colour k (0 l, 1 a, 2 b) of center c's mean: floor(f32(sum) / f32(count)),
// the JAX package's mean (an f32 quotient just below an integer may round up
// before the floor), or its state where it had no pixel.
__device__ __forceinline__ float center_mean(const float* centers, const long long* sums,
                                             int64_t c, int k) {
  const long long count = sums[c * 6 + 5];
  return count > 0 ? floorf(__fdiv_rn(__ll2float_rn(sums[c * 6 + 2 + k]), __ll2float_rn(count)))
                   : centers[c * 5 + 2 + k];
}

// The association once a center has drifted two cells or more from its home
// cell (reach = 1 + that drift): each thread its pixel of the block's tile,
// the candidates of its cell's (2 reach + 1)^2 neighbourhood in ascending id
// read from global memory (an image's centers sit in the L2), the same
// window test, distance and strict-< scan as the 5 x 5 path, and each
// candidate's members added by warp reductions of tile-relative fields (a
// sum of 32 stays below 2^13), one global atomic a field.
template <class M>
__device__ __forceinline__ void associate_wide(
    const uint8_t* __restrict__ lab, const float* __restrict__ centers,
    int32_t* __restrict__ labels, float* __restrict__ dists, unsigned long long* __restrict__ sums,
    int32_t* __restrict__ flags, int height, int width, int s, int per_col, int per_row,
    float space_norm, float color_norm, int reach, int y0, int x0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int x = x0 + (warp % (kTileW / kPieceW)) * kPieceW + lane % kPieceW;
  const int y = y0 + (warp / (kTileW / kPieceW)) * kPieceH + lane / kPieceW;
  const bool valid = x < width && y < height;
  const int64_t idx = static_cast<int64_t>(y) * width + x;
  int run_l = -1;
  float run_d = 0.0f;
  unsigned pl = 0, pa = 0, pb = 0;
  if (valid) {
    run_l = labels[idx];
    run_d = dists[idx];
    pl = lab[idx * 3];
    pa = lab[idx * 3 + 1];
    pb = lab[idx * 3 + 2];
  }
  const float old_d = run_d;
  const float xf = static_cast<float>(x), yf = static_cast<float>(y), sf = static_cast<float>(s);
  const float lf = static_cast<float>(pl), af = static_cast<float>(pa),
              bf = static_cast<float>(pb);
  const float pc = M::kDeltaE ? chroma(af, bf) : 0.0f;
  const int cy = min(y, height - 1) / s, cx = min(x, width - 1) / s;
  for (int dy = -reach; dy <= reach; ++dy) {
    for (int dx = -reach; dx <= reach; ++dx) {
      const int gy = cy + dy, gx = cx + dx;
      const int id = gy * per_row + gx;
      bool hit = false;
      if (valid && gy >= 0 && gy < per_col && gx >= 0 && gx < per_row) {
        const float ddx = __fsub_rn(xf, centers[static_cast<int64_t>(id) * 5]);
        const float ddy = __fsub_rn(yf, centers[static_cast<int64_t>(id) * 5 + 1]);
        hit = fabsf(ddx) <= sf && fabsf(ddy) <= sf;  // the reference's window (:243-246)
        if (hit) {
          const float* c = centers + static_cast<int64_t>(id) * 5;
          const float spatial = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
          const float color = color_distance<M>(c[2], c[3], c[4],
                                                M::kDeltaE ? chroma(c[3], c[4]) : 0.0f, lf, af,
                                                bf, pc);
          const float d = __fadd_rn(__fmul_rn(space_norm, spatial), __fmul_rn(color_norm, color));
          if (d < run_d) {  // strict: the lowest center id wins ties
            run_d = d;
            run_l = id;
          }
        }
      }
      // the members at this candidate's turn, summed a candidate at a time
      const bool member = hit && run_l == id;
      unsigned pending = __ballot_sync(kFull, member);
      while (pending) {
        const int target = __shfl_sync(kFull, id, __ffs(pending) - 1);
        const bool mine = member && id == target;
        const unsigned field[6] = {static_cast<unsigned>(x - x0), static_cast<unsigned>(y - y0),
                                   pl, pa, pb, 1u};
        unsigned total[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) total[k] = __reduce_add_sync(kFull, mine ? field[k] : 0u);
        if (lane < 6) {
          unsigned long long v = total[0] + static_cast<unsigned long long>(total[5]) *
                                                static_cast<unsigned>(x0);
          v = lane == 1 ? total[1] + static_cast<unsigned long long>(total[5]) *
                                         static_cast<unsigned>(y0)
                        : v;
#pragma unroll
          for (int k = 2; k < 6; ++k) v = lane == k ? total[k] : v;
          if (v != 0ull) atomicAdd(&sums[static_cast<int64_t>(target) * 6 + lane], v);
        }
        pending &= ~__ballot_sync(kFull, mine);
      }
    }
  }
  const bool changed = valid && run_d < old_d;
  if (changed) {  // run_l changes only where run_d fell
    labels[idx] = run_l;
    dists[idx] = run_d;
  }
  if (__any_sync(kFull, changed) && lane == 0) flags[1] = 1;
}

// 4 blocks an SM (ΔE: 54 registers, 46 KB of shared memory a block) or 5
// (euclidean: 48 registers, no spill)
template <class M>
__global__ void __launch_bounds__(kThreads, M::kDeltaE ? 4 : 5)
slic_association_kernel(const uint8_t* __restrict__ lab, const float* __restrict__ centers,
                        int32_t* __restrict__ labels, float* __restrict__ dists,
                        unsigned long long* __restrict__ sums, int32_t* __restrict__ flags,
                        const int32_t* __restrict__ stats, int flag_stride, int height,
                        int width, int s, int per_col, int per_row, int tiles_x,
                        float space_norm, float color_norm) {
  // this block's image: its flags, planes, centers and sums
  const int64_t image = blockIdx.y;
  flags += image * flag_stride;
  if (flags[0] == 0) return;  // the iteration is not active for this image
  const int64_t pixels = static_cast<int64_t>(height) * width;
  const int64_t n = static_cast<int64_t>(per_col) * per_row;
  lab += image * pixels * 3;
  labels += image * pixels;
  dists += image * pixels;
  centers += image * n * 5;
  sums += image * n * 6;
  const int y0 = static_cast<int>(blockIdx.x / tiles_x) * kTileH;
  const int x0 = static_cast<int>(blockIdx.x % tiles_x) * kTileW;
  // the image's largest drift so far, in cells
  const int drift = stats[image * flag_stride];
  if (drift >= 2) {  // the 5 x 5 neighbourhood no longer holds every window
    associate_wide<M>(lab, centers, labels, dists, sums, flags, height, width, s, per_col,
                      per_row, space_norm, color_norm, 1 + drift, y0, x0);
    return;
  }

  // this thread's pixel, loaded before the window so the two loads overlap
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int px0 = (warp % (kTileW / kPieceW)) * kPieceW;  // the warp's piece in the tile
  const int py0 = (warp / (kTileW / kPieceW)) * kPieceH;
  const int xr = px0 + lane % kPieceW, yr = py0 + lane / kPieceW;
  const int x = x0 + xr, y = y0 + yr;
  const bool valid = x < width && y < height;
  const int64_t idx = static_cast<int64_t>(y) * width + x;
  int run_l = -1;
  float run_d = 0.0f;
  unsigned pl = 0, pa = 0, pb = 0;
  if (valid) {
    run_l = labels[idx];
    run_d = dists[idx];
    pl = lab[idx * 3];
    pa = lab[idx * 3 + 1];
    pb = lab[idx * 3 + 2];
  }

  // x, y, l, a, b of each window slot's center, and its chroma for ΔE; the
  // block's sums of (x - x0, y - y0, l, a, b, 1) of each slot's members: a
  // slot has at most one member a pixel (a candidate is visited once), so
  // each sum stays below 256 x 255 < 2^16 (32 bits would hold a tile of
  // 64 x 64 pixels at any image width: the coordinates are the tile's own)
  constexpr int kPlanes = M::kDeltaE ? 6 : 5;
  __shared__ float cen[kPlanes][kAssocSlots];
  __shared__ unsigned acc[6][kAssocSlots];
  const int wy0 = y0 / s - 2, wx0 = x0 / s - 2;
  const int wh = (min(y0 + kTileH, height) - 1) / s + 3 - wy0;
  const int ww = (min(x0 + kTileW, width) - 1) / s + 3 - wx0;
  // a thread a slot: window row warp, column lane (wh <= 8, ww <= 20)
  const int wi = warp * ww + lane;
  const bool window_slot = warp < wh && lane < ww;
  if (window_slot) {
    const int gy = wy0 + warp, gx = wx0 + lane;
    const bool in = gy >= 0 && gy < per_col && gx >= 0 && gx < per_row;
    const int64_t c = static_cast<int64_t>(gy) * per_row + gx;
#pragma unroll
    for (int k = 0; k < 5; ++k) cen[k][wi] = in ? centers[c * 5 + k] : 0.0f;
    if constexpr (M::kDeltaE) cen[5][wi] = chroma(cen[3][wi], cen[4][wi]);
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[k][wi] = 0u;
  }
  __syncthreads();

  const float xf = static_cast<float>(x), yf = static_cast<float>(y), sf = static_cast<float>(s);
  const float lf = static_cast<float>(pl), af = static_cast<float>(pa),
              bf = static_cast<float>(pb);
  const float pc = M::kDeltaE ? chroma(af, bf) : 0.0f;
  const float old_d = run_d;
  const int cy = y / s, cx = x / s;
  const int own = (cy - wy0) * ww + (cx - wx0);  // the slot of the pixel's own cell

  // The piece's prefilter.  Its pixels' cells span [cya, cyb] x [cxa, cxb]:
  // at most 4 x 2 (8 columns from a multiple of 8, 4 rows from a multiple
  // of 4, S >= 2), so their candidates lie in a box of at most 8 x 6 cells
  // from (cya - 2, cxa - 2), bit 8 row + column of `near`.  A lane passes a
  // candidate only where fl(x - cx) lies in [-S, S] for its x in [xa, xb]
  // (and y alike), and fl(. - cx) is monotone, so a candidate with
  // fl(xb - cx) < -S or fl(xa - cx) > S passes no lane of the piece: `near`
  // holds the cells on the grid that may pass one.  A lane's candidates k
  // then come from its 5 x 5 block of `near`, and the loops below visit the
  // candidates some lane may pass, in ascending k.
  const int xa = x0 + px0, ya = y0 + py0;
  const int xb = min(xa + kPieceW, width) - 1, yb = min(ya + kPieceH, height) - 1;
  unsigned cand = 0;  // bit k: candidate k may scan this pixel
  if (xa < width && ya < height) {  // a warp-uniform test: the piece has a pixel
    const int cya = ya / s, cxa = xa / s;
    const int uh = yb / s - cya + 5, uw = xb / s - cxa + 5;  // <= 6, <= 8
    const float xaf = static_cast<float>(xa), xbf = static_cast<float>(xb);
    const float yaf = static_cast<float>(ya), ybf = static_cast<float>(yb);
    unsigned long long near = 0ull;
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      const int row = round * 4 + lane / 8, col = lane % 8;
      const int gy = cya - 2 + row, gx = cxa - 2 + col;
      bool hit = false;
      if (row < uh && col < uw && gy >= 0 && gy < per_col && gx >= 0 && gx < per_row) {
        const int slot = (gy - wy0) * ww + (gx - wx0);
        const float ccx = cen[0][slot], ccy = cen[1][slot];
        hit = __fsub_rn(xbf, ccx) >= -sf && __fsub_rn(xaf, ccx) <= sf &&
              __fsub_rn(ybf, ccy) >= -sf && __fsub_rn(yaf, ccy) <= sf;
      }
      near |= static_cast<unsigned long long>(__ballot_sync(kFull, hit)) << (round * 32);
    }
    if (valid) {
      const int base = (cy - cya) * 8 + (cx - cxa);  // candidate k = 0's cell
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        cand |= static_cast<unsigned>(near >> (base + r * 8) & 0x1full) << (5 * r);
      }
    }
  }

  // ΔE: the warp's scanned (pixel, candidate) pairs, k-major, as k * 32 +
  // lane; each pair's colour distance evaluated 32 at a time into
  // delta[warp][k * 32 + lane]
  constexpr int kLists = M::kDeltaE ? kWarps : 1;
  __shared__ uint16_t pairs[kLists][kCandidates * 32];
  __shared__ float delta[kLists][kCandidates * 32];
  if constexpr (M::kDeltaE) {
    uint16_t* list = pairs[warp];
    int count = 0;
    unsigned scanned = 0;
    // candidate k = 5 (dy + 2) + (dx + 2), in ascending center id: does it
    // scan the pixel (the reference's window, :243-246)?
    auto scans = [&](int k) -> bool {
      const int slot = own + (k / 5 - 2) * ww + (k % 5 - 2);
      return fabsf(__fsub_rn(xf, cen[0][slot])) <= sf && fabsf(__fsub_rn(yf, cen[1][slot])) <= sf;
    };
    for (unsigned todo = __reduce_or_sync(kFull, cand); todo != 0u; todo &= todo - 1u) {
      const int k = __ffs(todo) - 1;
      const bool hit = (cand >> k & 1u) != 0u && scans(k);
      const unsigned ballot = __ballot_sync(kFull, hit);
      if (hit) {
        list[count + __popc(ballot & ((1u << lane) - 1u))] = static_cast<uint16_t>(k * 32 + lane);
        scanned |= 1u << k;
      }
      count += __popc(ballot);
    }
    cand = scanned;  // from here on: the candidates that do scan the pixel
    __syncwarp();
    // one copy of the long ΔE body, not one a round
#pragma unroll 1
    for (int e0 = 0; e0 < count; e0 += 32) {
      const int e = e0 + lane;
      const int pair = e < count ? list[e] : lane;
      const int src = pair % 32, k = pair / 32;
      // the pair's pixel: its colour and own slot, from its lane
      const float sl = __shfl_sync(kFull, lf, src), sa = __shfl_sync(kFull, af, src);
      const float sb = __shfl_sync(kFull, bf, src), sc = __shfl_sync(kFull, pc, src);
      const int slot = __shfl_sync(kFull, own, src) + (k / 5 - 2) * ww + (k % 5 - 2);
      if (e < count) {
        delta[warp][pair] = color_distance<M>(cen[2][slot], cen[3][slot], cen[4][slot],
                                              cen[5][slot], sl, sa, sb, sc);
      }
    }
    __syncwarp();
  }

  // the scan: the candidates some lane may pass, in ascending k, two a turn
  // (their distances are independent of each other and of the running
  // pair; the strict-< updates then run in order).  Each lane notes the
  // candidates whose turn found it a member; the warp adds them after.
  // A lane's own slot is in the window (a lane past the image reads a slot
  // near the window's middle, and uses nothing it reads).
  const int home = valid ? own : 2 * ww + 2;
  auto turn = [&](int k, bool& hit, int& id) -> float {
    const int dy = k / 5 - 2, dx = k % 5 - 2;
    const int slot = home + dy * ww + dx;
    const float ddx = __fsub_rn(xf, cen[0][slot]);
    const float ddy = __fsub_rn(yf, cen[1][slot]);
    hit = (cand >> k & 1u) != 0u && fabsf(ddx) <= sf && fabsf(ddy) <= sf;
    id = (cy + dy) * per_row + (cx + dx);
    const float spatial = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
    float color;
    if constexpr (M::kDeltaE) {
      color = delta[warp][k * 32 + lane];  // written where hit
    } else {
      color = color_distance<M>(cen[2][slot], cen[3][slot], cen[4][slot], 0.0f, lf, af, bf,
                                0.0f);
    }
    return __fadd_rn(__fmul_rn(space_norm, spatial), __fmul_rn(color_norm, color));
  };
  unsigned joined = 0;  // bit k: this pixel is a member at candidate k's turn
  for (unsigned todo = __reduce_or_sync(kFull, cand); todo != 0u;) {
    const int ka = __ffs(todo) - 1;
    todo &= todo - 1u;
    const bool two = todo != 0u;
    const int kb = two ? __ffs(todo) - 1 : ka;
    if (two) todo &= todo - 1u;
    bool hit_a, hit_b;
    int id_a, id_b;
    const float d_a = turn(ka, hit_a, id_a);
    const float d_b = turn(kb, hit_b, id_b);
    hit_b = hit_b && two;
    if (hit_a && d_a < run_d) {  // strict: the lowest center id wins ties
      run_d = d_a;
      run_l = id_a;
    }
    if (hit_a && run_l == id_a) joined |= 1u << ka;
    if (hit_b && d_b < run_d) {
      run_d = d_b;
      run_l = id_b;
    }
    if (hit_b && run_l == id_b) joined |= 1u << kb;
  }
  // the members of each slot in this warp (usually one slot: the piece
  // lies in one cell) summed by warp reductions of packed fields: 32
  // pixels' x - x0 < 2^11 and y - y0 < 2^11, count < 2^6, l and a < 2^13;
  // lanes 0-5 add one field each
  const unsigned packed_xy = static_cast<unsigned>(xr) | static_cast<unsigned>(yr) << 11 |
                             1u << 22;
  const unsigned packed_la = pl | pa << 13;
  for (unsigned todo = __reduce_or_sync(kFull, joined); todo != 0u; todo &= todo - 1u) {
    const int k = __ffs(todo) - 1;
    const bool member = (joined >> k & 1u) != 0u;
    const int slot = home + (k / 5 - 2) * ww + (k % 5 - 2);
    unsigned pending = __ballot_sync(kFull, member);
    while (pending) {
      const int leader = __ffs(pending) - 1;
      const int target = __shfl_sync(kFull, slot, leader);
      const bool mine = member && slot == target;
      const unsigned sxy = __reduce_add_sync(kFull, mine ? packed_xy : 0u);
      const unsigned sla = __reduce_add_sync(kFull, mine ? packed_la : 0u);
      const unsigned sb = __reduce_add_sync(kFull, mine ? pb : 0u);
      if (lane < 6) {
        const unsigned field = lane == 0   ? sxy & 0x7ffu
                               : lane == 1 ? sxy >> 11 & 0x7ffu
                               : lane == 2 ? sla & 0x1fffu
                               : lane == 3 ? sla >> 13
                               : lane == 4 ? sb
                                           : sxy >> 22;
        shared_add(&acc[lane][target], field);
      }
      pending &= ~__ballot_sync(kFull, mine);
    }
  }
  const bool changed = valid && run_d < old_d;
  if (changed) {  // run_l changes only where run_d fell
    labels[idx] = run_l;
    dists[idx] = run_d;
  }
  // a barrier too: every shared sum is complete after it
  if (__syncthreads_or(changed) && threadIdx.x == 0) flags[1] = 1;
  const unsigned members = window_slot ? acc[5][wi] : 0u;
  if (members != 0u) {  // a center with members lies on the grid
    const int64_t c = static_cast<int64_t>(wy0 + warp) * per_row + (wx0 + lane);
    const unsigned long long add[6] = {
        acc[0][wi] + static_cast<unsigned long long>(members) * static_cast<unsigned>(x0),
        acc[1][wi] + static_cast<unsigned long long>(members) * static_cast<unsigned>(y0),
        acc[2][wi], acc[3][wi], acc[4][wi], members};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (add[k] != 0ull) atomicAdd(&sums[c * 6 + k], add[k]);
    }
  }
}

template <class M>
__global__ void __launch_bounds__(kThreads)
slic_snap_keys_kernel(const uint8_t* __restrict__ lab, const float* __restrict__ centers,
                      const int32_t* __restrict__ labels, const long long* __restrict__ sums,
                      long long* __restrict__ keys, const int32_t* __restrict__ flags,
                      int flag_stride, int height, int width, int s, int per_col, int per_row,
                      int side, int tiles_x) {
  const int64_t image = blockIdx.y;
  if (flags[image * flag_stride] == 0) return;
  const int64_t pixels = static_cast<int64_t>(height) * width;
  const int64_t n = static_cast<int64_t>(per_col) * per_row;
  lab += image * pixels * 3;
  labels += image * pixels;
  centers += image * n * 5;
  sums += image * n * 6;
  keys += image * n;
  // l, a, b of each window slot's mean, and its chroma for ΔE
  constexpr int kPlanes = M::kDeltaE ? 4 : 3;
  __shared__ float mean[kPlanes][kSlots];
  __shared__ unsigned long long best[kSlots];  // keys ^ kSignBit
  const Tile t = tile_of(side, tiles_x, height, width, s);
  const int slots = t.wh * t.ww;
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    const int gy = t.wy0 + i / t.ww, gx = t.wx0 + i % t.ww;
    best[i] = kNoKey ^ kSignBit;
    if (gy < 0 || gy >= per_col || gx < 0 || gx >= per_row) continue;
    const int64_t c = static_cast<int64_t>(gy) * per_row + gx;
#pragma unroll
    for (int k = 0; k < 3; ++k) mean[k][i] = center_mean(centers, sums, c, k);
    if constexpr (M::kDeltaE) mean[3][i] = chroma(mean[1][i], mean[2][i]);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int npix = t.th * t.tw;
  for (int base = 0; base < npix; base += kThreads) {
    const int p = base + threadIdx.x;
    const bool valid = p < npix;
    const int y = valid ? t.y0 + p / t.tw : 0;
    const int x = valid ? t.x0 + p % t.tw : 0;
    const int64_t idx = static_cast<int64_t>(y) * width + x;
    const int label = valid ? labels[idx] : -1;
    int slot = -1;
    int key = 0;
    if (label >= 0) {
      const int ly = label / per_row - t.wy0, lx = label % per_row - t.wx0;
      const float lf = static_cast<float>(lab[idx * 3]);
      const float af = static_cast<float>(lab[idx * 3 + 1]);
      const float bf = static_cast<float>(lab[idx * 3 + 2]);
      const float pc = M::kDeltaE ? chroma(af, bf) : 0.0f;
      if (ly >= 0 && ly < t.wh && lx >= 0 && lx < t.ww) {
        slot = ly * t.ww + lx;
        const float d = color_distance<M>(mean[0][slot], mean[1][slot], mean[2][slot],
                                          mean[kPlanes - 1][slot], lf, af, bf, pc);
        key = static_cast<int>(floorf(d));  // >= -1: a ΔE² may round below 0
      } else {
        // a center more than two cells from the pixel's cell (one that
        // drifted): its mean from global memory, the key taken in alone
        float m[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) m[k] = center_mean(centers, sums, label, k);
        const float d = color_distance<M>(m[0], m[1], m[2], M::kDeltaE ? chroma(m[1], m[2]) : 0.0f,
                                          lf, af, bf, pc);
        const long long own = static_cast<long long>(
            static_cast<unsigned long long>(static_cast<long long>(static_cast<int>(floorf(d))))
                << 32 |
            static_cast<unsigned>(idx));
        atomicMin(&keys[label], own);
      }
    }
    // (key, raster) least in lexical order: the least key, then the least
    // raster index among its pixels (H * W < 2^31)
    const unsigned raster = static_cast<unsigned>(idx);
    unsigned pending = __ballot_sync(kFull, slot >= 0);
    while (pending) {
      const int leader = __ffs(pending) - 1;
      const int target = __shfl_sync(kFull, slot, leader);
      const bool mine = slot == target;
      const int kmin = __reduce_min_sync(kFull, mine ? key : INT_MAX);
      const unsigned rmin = __reduce_min_sync(kFull, mine && key == kmin ? raster : kFull);
      if (lane == leader) {
        // key * 2^32 + raster, as the plain version packs it, sign included
        const unsigned long long packed =
            (static_cast<unsigned long long>(static_cast<long long>(kmin)) << 32) | rmin;
        atomicMin(&best[target], packed ^ kSignBit);
      }
      pending &= ~__ballot_sync(kFull, mine);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    const long long key = static_cast<long long>(best[i] ^ kSignBit);
    if (key == kNoKey) continue;
    const int64_t c = static_cast<int64_t>(t.wy0 + i / t.ww) * per_row + (t.wx0 + i % t.ww);
    atomicMin(&keys[c], key);
  }
}

__global__ void __launch_bounds__(kThreads)
slic_update_kernel(const uint8_t* __restrict__ lab, float* __restrict__ centers,
                   long long* __restrict__ keys, unsigned long long* __restrict__ sums,
                   int32_t* __restrict__ stats, const int32_t* __restrict__ flags,
                   int32_t* __restrict__ next_flags, int flag_stride, int n, int height,
                   int width, int s, int per_row, int iteration) {
  const int64_t image = blockIdx.y;
  flags += image * flag_stride;
  if (flags[0] == 0) return;
  stats += image * flag_stride;
  next_flags += image * flag_stride;
  lab += image * static_cast<int64_t>(height) * width * 3;
  centers += image * n * 5;
  keys += image * n;
  sums += image * n * 6;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int drift = 0;
  if (c < n) {
    const long long key = keys[c];
    float cx = centers[c * 5], cy = centers[c * 5 + 1];
    if (key != kNoKey) {  // it has pixels: it moves to the first of least key
      const unsigned first = static_cast<unsigned>(key & 0xffffffffll);
      cx = static_cast<float>(first % static_cast<unsigned>(width));
      cy = static_cast<float>(first / static_cast<unsigned>(width));
      centers[c * 5] = cx;
      centers[c * 5 + 1] = cy;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        centers[c * 5 + 2 + k] = static_cast<float>(lab[static_cast<int64_t>(first) * 3 + k]);
      }
    }
    // Chebyshev distance, in cells, of its current cell from its home cell
    const int gx = static_cast<int>(c % per_row), gy = static_cast<int>(c / per_row);
    drift = max(abs(static_cast<int>(cx) / s - gx), abs(static_cast<int>(cy) / s - gy));
    keys[c] = kNoKey;
#pragma unroll
    for (int k = 0; k < 6; ++k) sums[c * 6 + k] = 0ull;
  }
  drift = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(drift)));
  if (threadIdx.x % 32 == 0 && drift > 0) atomicMax(&stats[0], drift);
  if (c == 0) {  // once an image
    next_flags[0] = flags[1];  // the next iteration runs if a pixel of it changed
    stats[1] = iteration + 1;  // iterations run
  }
}

// core/ciede2000.py's ciede2000_square (M = Ciede2000) or
// ciede2000_ref_square (Ciede2000Ref) of n pairs, elementwise.
template <class M>
__global__ void __launch_bounds__(kThreads)
slic_delta_e_kernel(const float* __restrict__ l1, const float* __restrict__ a1,
                    const float* __restrict__ b1, const float* __restrict__ l2,
                    const float* __restrict__ a2, const float* __restrict__ b2,
                    float* __restrict__ out, int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    out[i] = delta_e_square<M>(l1[i], a1[i], b1[i], chroma(a1[i], b1[i]), l2[i], a2[i], b2[i],
                               chroma(a2[i], b2[i]));
  }
}

// The association's blocks an image: one a 32 x 8 tile.
int association_blocks(int height, int width) {
  return ((width + kTileW - 1) / kTileW) * ((height + kTileH - 1) / kTileH);
}

int tiles(int height, int width, int s, int* tiles_x) {
  const int side = tile_side(s);
  *tiles_x = (width + side - 1) / side;
  return *tiles_x * ((height + side - 1) / side);
}

template <class M>
int launch_association(const void* lab, const void* centers, void* labels, void* dists,
                       void* sums, void* flags, const void* stats, int flag_stride, int batch,
                       int height, int width, int s, int per_col, int per_row,
                       float space_norm, float color_norm, cudaStream_t stream) {
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const dim3 grid(association_blocks(height, width), batch);
  slic_association_kernel<M><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(lab), static_cast<const float*>(centers),
      static_cast<int32_t*>(labels), static_cast<float*>(dists),
      static_cast<unsigned long long*>(sums), static_cast<int32_t*>(flags),
      static_cast<const int32_t*>(stats), flag_stride, height, width, s, per_col, per_row,
      tiles_x, space_norm, color_norm);
  return static_cast<int>(cudaGetLastError());
}

template <class M>
int launch_snap_keys(const void* lab, const void* centers, const void* labels, const void* sums,
                     void* keys, const void* flags, int flag_stride, int batch, int height,
                     int width, int s, int per_col, int per_row, cudaStream_t stream) {
  int tiles_x = 0;
  const dim3 grid(tiles(height, width, s, &tiles_x), batch);
  slic_snap_keys_kernel<M><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(lab), static_cast<const float*>(centers),
      static_cast<const int32_t*>(labels), static_cast<const long long*>(sums),
      static_cast<long long*>(keys), static_cast<const int32_t*>(flags), flag_stride, height,
      width, s, per_col, per_row, tile_side(s), tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <class M>
int launch_delta_e(const void* l1, const void* a1, const void* b1, const void* l2,
                   const void* a2, const void* b2, void* out, int64_t n, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  slic_delta_e_kernel<M><<<static_cast<int>(blocks < 65535 ? blocks : 65535), kThreads, 0,
                           stream>>>(
      static_cast<const float*>(l1), static_cast<const float*>(a1),
      static_cast<const float*>(b1), static_cast<const float*>(l2),
      static_cast<const float*>(a2), static_cast<const float*>(b2), static_cast<float*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// metric: 0 euclidean, 1 ciede2000, 2 ciede2000_ref (ops/cuda/slic.py::METRICS);
// any other value, or a batch outside [1, 65535], launches nothing and
// returns cudaErrorInvalidValue.
//
// Every k-means entry point takes a batch of images of one shape, one after
// another in memory: lab (B, H, W, 3) u8; centers (B, N, 5) f32 x, y, l, a,
// b with N = per_col * per_row; labels (B, H, W) int32; dists (B, H, W) f32;
// sums (B, N, 6) int64; keys (B, N) int64; and the state, int32 (B, T, 2):
// image b's row 0 (max drift in cells, iterations run) and its rows 1 + it
// (active, changed), flag_stride = 2 T int32 values from one image's to the
// next.  flags and stats point at image 0's.
extern "C" {

// labels and dists are updated in place; sums are added to; flags: the
// iteration's (active, changed) pair of image 0; stats: image 0's row 0,
// whose drift widens the neighbourhood.  Returns the launch's cudaError_t (0
// on success).
int vip_slic_association(const void* lab, const void* centers, void* labels, void* dists,
                         void* sums, void* flags, const void* stats, int flag_stride, int batch,
                         int height, int width, int s, int per_col, int per_row,
                         float space_norm, float color_norm, int metric, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  switch (metric) {
    case 0:
      return launch_association<Euclidean>(lab, centers, labels, dists, sums, flags, stats,
                                           flag_stride, batch, height, width, s, per_col,
                                           per_row, space_norm, color_norm, st);
    case 1:
      return launch_association<Ciede2000>(lab, centers, labels, dists, sums, flags, stats,
                                           flag_stride, batch, height, width, s, per_col,
                                           per_row, space_norm, color_norm, st);
    case 2:
      return launch_association<Ciede2000Ref>(lab, centers, labels, dists, sums, flags, stats,
                                              flag_stride, batch, height, width, s, per_col,
                                              per_row, space_norm, color_norm, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// keys: all int64 max before the first iteration; each center's least
// packed key is taken in with atomicMin.
int vip_slic_snap_keys(const void* lab, const void* centers, const void* labels,
                       const void* sums, void* keys, const void* flags, int flag_stride,
                       int batch, int height, int width, int s, int per_col, int per_row,
                       int metric, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  switch (metric) {
    case 0:
      return launch_snap_keys<Euclidean>(lab, centers, labels, sums, keys, flags, flag_stride,
                                         batch, height, width, s, per_col, per_row, st);
    case 1:
      return launch_snap_keys<Ciede2000>(lab, centers, labels, sums, keys, flags, flag_stride,
                                         batch, height, width, s, per_col, per_row, st);
    case 2:
      return launch_snap_keys<Ciede2000Ref>(lab, centers, labels, sums, keys, flags,
                                            flag_stride, batch, height, width, s, per_col,
                                            per_row, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// stats: image 0's row 0; next_flags: image 0's pair of the next iteration,
// whose active is set here for each image.
int vip_slic_update(const void* lab, void* centers, void* keys, void* sums, void* stats,
                    const void* flags, void* next_flags, int flag_stride, int batch, int n,
                    int height, int width, int s, int per_row, int iteration, void* stream) {
  if (batch < 1 || batch > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  slic_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lab), static_cast<float*>(centers),
      static_cast<long long*>(keys), static_cast<unsigned long long*>(sums),
      static_cast<int32_t*>(stats), static_cast<const int32_t*>(flags),
      static_cast<int32_t*>(next_flags), flag_stride, n, height, width, s, per_row, iteration);
  return static_cast<int>(cudaGetLastError());
}

// The association's launch shape: blocks an image, and blocks of the
// metric's instantiation an SM can hold at once (-1 for an unknown metric
// or a failed query).
int vip_slic_association_blocks(int height, int width) {
  return association_blocks(height, width);
}

int vip_slic_association_occupancy(int metric) {
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (metric) {
    case 0:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, slic_association_kernel<Euclidean>, kThreads, 0);
      break;
    case 1:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, slic_association_kernel<Ciede2000>, kThreads, 0);
      break;
    case 2:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, slic_association_kernel<Ciede2000Ref>, kThreads, 0);
      break;
    default:
      break;
  }
  return err == cudaSuccess ? blocks : -1;
}

// out[i] = the squared ΔE of (l1, a1, b1)[i] and (l2, a2, b2)[i], n f32
// values each; metric 1 or 2 (the euclidean metric has no pair kernel).
int vip_slic_delta_e(const void* l1, const void* a1, const void* b1, const void* l2,
                     const void* a2, const void* b2, void* out, long long n, int metric,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (metric) {
    case 1:
      return launch_delta_e<Ciede2000>(l1, a1, b1, l2, a2, b2, out, n, st);
    case 2:
      return launch_delta_e<Ciede2000Ref>(l1, a1, b1, l2, a2, b2, out, n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
