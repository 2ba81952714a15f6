// SLIC k-means for Hopper (sm_90a): one iteration in three kernels, for
// each of the three colour metrics.
//
// Replaces no Pallas kernel: the JAX package runs its whole k-means as one
// jitted XLA program (various_image_processings_tpu/models/slic.py:129,
// slic_device, a lax.while_loop at :353-369).  These kernels are the card's
// counterpart of that device program, and compute what the port's plain
// version (models/slic.py::_Grid) computes, bit for bit:
//
//   slic_association_kernel  every pixel takes the <= 25 candidate centers
//     of its cell's 5x5 cell neighbourhood in ascending id, against the
//     persistent (labels, dists) map, strictly-smaller winning.  At each
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
//     least key of its pixels.
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
// calls of the math library, each tens of instructions.  A block takes a
// square tile of pixels (whole cells for S <= 64, a piece of one or two
// cells past that) and keeps its window of candidate centers (for the
// CIEDE2000 metrics with their chroma sqrt(a^2 + b^2), computed once a
// center), their sums and their least keys in shared memory.  Within a
// warp, the pixels that add to the same center are summed by warp
// reductions first, so the shared atomics are one a center and warp, and
// the global atomics one a center and block.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
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

template <class M>
__global__ void __launch_bounds__(kThreads)
slic_association_kernel(const uint8_t* __restrict__ lab, const float* __restrict__ centers,
                        int32_t* __restrict__ labels, float* __restrict__ dists,
                        unsigned long long* __restrict__ sums, int32_t* __restrict__ flags,
                        int flag_stride, int height, int width, int s, int per_col, int per_row,
                        int side, int tiles_x, float space_norm, float color_norm) {
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
  // x, y, l, a, b of each window slot's center, and its chroma for ΔE
  constexpr int kPlanes = M::kDeltaE ? 6 : 5;
  __shared__ float cen[kPlanes][kSlots];
  __shared__ unsigned long long acc[6][kSlots];
  const Tile t = tile_of(side, tiles_x, height, width, s);
  const int slots = t.wh * t.ww;
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    const int gy = t.wy0 + i / t.ww, gx = t.wx0 + i % t.ww;
    const bool in = gy >= 0 && gy < per_col && gx >= 0 && gx < per_row;
    const int64_t c = static_cast<int64_t>(gy) * per_row + gx;
#pragma unroll
    for (int k = 0; k < 5; ++k) cen[k][i] = in ? centers[c * 5 + k] : 0.0f;
    if constexpr (M::kDeltaE) cen[5][i] = chroma(cen[3][i], cen[4][i]);
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[k][i] = 0ull;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int npix = t.th * t.tw;
  const float sf = static_cast<float>(s);
  bool changed = false;
  // the trip count is the block's, so every warp stays converged for its
  // shuffles; lanes past the tile carry no pixel
  for (int base = 0; base < npix; base += kThreads) {
    const int p = base + threadIdx.x;
    const bool valid = p < npix;
    const int y = valid ? t.y0 + p / t.tw : 0;
    const int x = valid ? t.x0 + p % t.tw : 0;
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
    const float xf = static_cast<float>(x), yf = static_cast<float>(y);
    const float lf = static_cast<float>(pl), af = static_cast<float>(pa),
                bf = static_cast<float>(pb);
    const float pc = M::kDeltaE ? chroma(af, bf) : 0.0f;
    const int cy = y / s, cx = x / s;
    // one candidate's turn, in ascending center id
    auto visit = [&](int dy, int dx) {
      const int ny = cy + dy, nx = cx + dx;
      int slot = -1;
      if (valid && ny >= 0 && ny < per_col && nx >= 0 && nx < per_row) {
        const int i = (ny - t.wy0) * t.ww + (nx - t.wx0);
        const float ddx = __fsub_rn(xf, cen[0][i]);
        const float ddy = __fsub_rn(yf, cen[1][i]);
        if (fabsf(ddx) <= sf && fabsf(ddy) <= sf) {  // the reference's window (:243-246)
          const int id = ny * per_row + nx;
          const float spatial = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
          const float d = __fadd_rn(
              __fmul_rn(space_norm, spatial),
              __fmul_rn(color_norm, color_distance<M>(cen[2][i], cen[3][i], cen[4][i],
                                                      cen[kPlanes - 1][i], lf, af, bf, pc)));
          if (d < run_d) {  // strict: the lowest center id wins ties
            run_d = d;
            run_l = id;
          }
          if (run_l == id) slot = i;  // a member at this center's turn
        }
      }
      // the members of each slot in this warp, summed by warp reductions
      // (32 pixels of x < 2^27 fit 32 bits), then one shared atomic each
      unsigned pending = __ballot_sync(kFull, slot >= 0);
      while (pending) {
        const int leader = __ffs(pending) - 1;
        const int target = __shfl_sync(kFull, slot, leader);
        const bool mine = slot == target;
        const unsigned sx = __reduce_add_sync(kFull, mine ? static_cast<unsigned>(x) : 0u);
        const unsigned sy = __reduce_add_sync(kFull, mine ? static_cast<unsigned>(y) : 0u);
        const unsigned sl = __reduce_add_sync(kFull, mine ? pl : 0u);
        const unsigned sa = __reduce_add_sync(kFull, mine ? pa : 0u);
        const unsigned sb = __reduce_add_sync(kFull, mine ? pb : 0u);
        const unsigned members = __ballot_sync(kFull, mine);
        if (lane == leader) {
          atomicAdd(&acc[0][target], static_cast<unsigned long long>(sx));
          atomicAdd(&acc[1][target], static_cast<unsigned long long>(sy));
          atomicAdd(&acc[2][target], static_cast<unsigned long long>(sl));
          atomicAdd(&acc[3][target], static_cast<unsigned long long>(sa));
          atomicAdd(&acc[4][target], static_cast<unsigned long long>(sb));
          atomicAdd(&acc[5][target], static_cast<unsigned long long>(__popc(members)));
        }
        pending &= ~members;
      }
    };
    if constexpr (M::kDeltaE) {
      // one copy of the long ΔE body, not 25
#pragma unroll 1
      for (int k = 0; k < 25; ++k) visit(k / 5 - 2, k % 5 - 2);
    } else {
      for (int dy = -2; dy <= 2; ++dy) {
        for (int dx = -2; dx <= 2; ++dx) visit(dy, dx);
      }
    }
    if (valid && run_d < old_d) {  // run_l changes only where run_d fell
      labels[idx] = run_l;
      dists[idx] = run_d;
      changed = true;
    }
  }
  // a barrier too: every shared sum is complete after it
  if (__syncthreads_or(changed) && threadIdx.x == 0) flags[1] = 1;
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    if (acc[5][i] == 0ull) continue;  // a center with members lies on the grid
    const int64_t c = static_cast<int64_t>(t.wy0 + i / t.ww) * per_row + (t.wx0 + i % t.ww);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (acc[k][i] != 0ull) atomicAdd(&sums[c * 6 + k], acc[k][i]);
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
    const long long count = sums[c * 6 + 5];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // floor(f32(sum) / f32(count)), the JAX package's mean (an f32
      // quotient just below an integer may round up before the floor)
      mean[k][i] = count > 0 ? floorf(__fdiv_rn(__ll2float_rn(sums[c * 6 + 2 + k]),
                                                __ll2float_rn(count)))
                             : centers[c * 5 + 2 + k];
    }
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
      // association gives a pixel only a center of its cell's 5x5
      // neighbourhood, all of which lie in the window
      if (ly < 0 || ly >= t.wh || lx < 0 || lx >= t.ww) __trap();
      slot = ly * t.ww + lx;
      const float af = static_cast<float>(lab[idx * 3 + 1]);
      const float bf = static_cast<float>(lab[idx * 3 + 2]);
      const float d = color_distance<M>(mean[0][slot], mean[1][slot], mean[2][slot],
                                        mean[kPlanes - 1][slot],
                                        static_cast<float>(lab[idx * 3]), af, bf,
                                        M::kDeltaE ? chroma(af, bf) : 0.0f);
      key = static_cast<int>(floorf(d));  // >= -1: a ΔE² may round below 0
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

int tiles(int height, int width, int s, int* tiles_x) {
  const int side = tile_side(s);
  *tiles_x = (width + side - 1) / side;
  return *tiles_x * ((height + side - 1) / side);
}

template <class M>
int launch_association(const void* lab, const void* centers, void* labels, void* dists,
                       void* sums, void* flags, int flag_stride, int batch, int height,
                       int width, int s, int per_col, int per_row, float space_norm,
                       float color_norm, cudaStream_t stream) {
  int tiles_x = 0;
  const dim3 grid(tiles(height, width, s, &tiles_x), batch);
  slic_association_kernel<M><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(lab), static_cast<const float*>(centers),
      static_cast<int32_t*>(labels), static_cast<float*>(dists),
      static_cast<unsigned long long*>(sums), static_cast<int32_t*>(flags), flag_stride, height,
      width, s, per_col, per_row, tile_side(s), tiles_x, space_norm, color_norm);
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
// iteration's (active, changed) pair of image 0.  Returns the launch's
// cudaError_t (0 on success).
int vip_slic_association(const void* lab, const void* centers, void* labels, void* dists,
                         void* sums, void* flags, int flag_stride, int batch, int height,
                         int width, int s, int per_col, int per_row, float space_norm,
                         float color_norm, int metric, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  switch (metric) {
    case 0:
      return launch_association<Euclidean>(lab, centers, labels, dists, sums, flags, flag_stride,
                                           batch, height, width, s, per_col, per_row,
                                           space_norm, color_norm, st);
    case 1:
      return launch_association<Ciede2000>(lab, centers, labels, dists, sums, flags, flag_stride,
                                           batch, height, width, s, per_col, per_row,
                                           space_norm, color_norm, st);
    case 2:
      return launch_association<Ciede2000Ref>(lab, centers, labels, dists, sums, flags,
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
