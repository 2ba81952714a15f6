// The Wexler fill loop for Hopper (sm_90a): one iteration of a fill pass in
// four kernels, with the exemplar search (wexler_search.cu) between the
// second and the fourth, and the multi-start beam's diffusion start.
//
// Replaces no Pallas kernel: the JAX package runs each fill pass as one XLA
// lax.while_loop (various_image_processings_tpu/models/inpainting.py:414,
// _pass_core), the energy loop as another around it (:528,
// _energy_loops_device) and the diffusion start as a fori_loop (:568,
// _alt_init_device).  These kernels compute what the port's plain pieces
// (models/inpainting.py::_FillPass and _alt_init_device) compute, bit for
// bit:
//
//   wexler_ring_pick_kernel   the loop's cond and the body's ring: over the
//     (bh, bw) hole box, the energy passes take every remaining pixel, the
//     onion-peel passes the remaining pixels with a known 8-neighbour (the
//     box edge counts as known), seeded only from border-connected known
//     pixels and this pass's fills where the mask has known islands, and
//     from every known pixel when that ring is empty.  The first cap ring
//     pixels in raster order become the targets (the rest padded with the
//     box origin), min(count, cap) the count, count > 0 the iteration's
//     active flag, and the search's keys go back to all ones.
//   wexler_filters_kernel     the target side of the search: per target the
//     13 x 13 x 9 filter (256 m, m, -2 m b) straight into the search's
//     target-major (13, Tp, 128) bf16 buffer and b2 = sum m b^2; and the
//     candidate validity map recounted over the box dilated by 12 (the
//     only windows whose hole count can change: the remaining mask only
//     shrinks, and only inside the box).
//   wexler_commit_kernel      the body's scatters: decodes the search keys,
//     fails the iteration where a valid target got +inf, copies each
//     pick's pixel onto its target, clears the target's remaining bit,
//     rewrites the 13 x 9 entries p117[ty, tx - kx, 9 kx + c] the pixel
//     feeds (each depends on that pixel alone, so this is exact and
//     replaces the strip re-pack), and adds the iteration's sum of
//     e * weight to the pass energy.
//   wexler_diffusion_kernel   the diffusion start: a thread-block cluster
//     a channel (up to 16 CTAs, one a row strip of the box) keeps the box
//     double-buffered in its CTAs' shared memory for the bh + bw Jacobi
//     sweeps of the 3 x 3 edge-padded mean, then the dither and the clamp.
//
// The state of a pass is an int32 vector (models/inpainting.py and
// ops/cuda/wexler_fill.py name its slots): active, fail, live (the energy
// loop has not stopped), count, energy (f32 bits), iterations run.  The host
// enqueues iterations without reading anything; every kernel but the ring
// pick writes nothing when active is 0, and the ring pick clears active
// once the pass failed or its energy loop stopped.  No kernel reads a flag
// that its own grid writes: the ring pick and the commit are one block each.
//
// Exactness: every value the loop moves is an integer (u8 pixel values, 0/1
// masks), so the copies and the planes are exact; the two float sums have a
// fixed order that the plain pieces repeat with elementwise adds: b2 a
// halving tree over 512 slots (the 507 products in (c, ky, kx) order, then
// zeros), the energy a halving tree over the cap slots padded to a power of
// two, then one add a iteration.  Products are __fmul_rn and sums
// __fadd_rn, so nothing contracts into an FMA.  No float atomics.
//
// What bounds them on the card: the latency of a launch and of one block.
// The ring pick reads the box once (4 B a pixel), the filters write 13 x 128
// x 2 B a target, the commit ~0.5 KB a target; at 402 x 700 (5a) that is
// well under a megabyte an iteration, microseconds of bandwidth.  The ring
// pick and the commit are one block by design (a block-wide scan and a
// fixed-order tree; the commit's fail test must precede every write), so
// they take a few microseconds each however small the ring.  So the ring
// pick holds the box as bit masks, 32 pixels a word from a warp's ballot
// over coalesced loads, finds the ring with funnel shifts across words and
// rows, and scans the words' popcounts once a band of rows (one band up to
// ~1000 rows at a 128-pixel width), where one pixel a thread took a scan
// and three barriers every 1024 pixels.  The filters read each target's
// window once into shared memory (its warp's) and write each filter row as
// 8-byte stores, with no division in the store loop; the validity recount
// stages a tile's window of the mask as "rem == 0" bits and takes the
// 13-wide runs by shifts, then the 13-tall AND of the run words, where a
// thread read its candidate's 169 mask values.  The diffusion start is a chain of bh + bw dependent
// sweeps of ~10 operations a hole pixel: what bounds it is the latency of a
// sweep.  So each channel's box is spread over a cluster's SMs (48 SMs at a
// 128 x 128 box, where one block a channel used 3), each strip's edge rows
// go into the neighbours' halo rows through distributed shared memory
// (st.async, completing on the receiver's mbarrier: a point-to-point
// exchange, where a cluster barrier's release is a GPU-wide fence), and
// everything that does not change (the hole mask, the known pixels in
// both copies, the offsets) is set before the first sweep.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

// slots of the pass state (ops/cuda/wexler_fill.py)
constexpr int kActive = 0;
constexpr int kFail = 1;
constexpr int kLive = 2;
constexpr int kCount = 3;
constexpr int kEnergy = 4;
constexpr int kIterations = 5;

constexpr int kWindow = 13;
constexpr int kHalf = kWindow / 2;
constexpr int kPlanes = 9;                  // hi, lo, a of three channels
constexpr int kPacked = kWindow * kPlanes;  // 117 channels of p117
constexpr int kChannels = 128;              // padded, as the search reads them
constexpr int kPatch = 3 * kWindow * kWindow;  // 507 products of b2
constexpr int kTree = 512;                  // b2's tree, zero-padded: 16 slots a lane

constexpr int kPickThreads = 1024;
constexpr int kPickWords = 4096;            // words of each of a band's two masks (16 KB)
constexpr int kPickWordsPerThread = (kPickWords + kPickThreads - 1) / kPickThreads;
// rows of a word column a warp loads at once (a quarter with the seed masks:
// three loads a row, and no spill at 64 registers a thread)
constexpr int kPickBatch = 16;
// 9 targets a block: at cap 1024 and a 128 x 128 box, 114 target blocks and
// 15 validity tiles, one block an SM of the 132
constexpr int kFilterThreads = 288;
constexpr int kTargetsPerBlock = kFilterThreads / 32;  // a warp a target
constexpr int kArea = kWindow * kWindow;    // 169 taps of a window
constexpr int kWindowFloats = 3 * kArea;    // 507: its pixels' channels
constexpr int kRowFloats = 3 * kWindow;     // 39: a window row of the image, contiguous
// a validity tile: kTileRows x 32 kTileWords candidates, from the staged bits
// of their (kTileRows + 12) x (32 kTileWords + 12) window of the mask, held in
// kTileWords + 1 words a row
constexpr int kTileRows = 32;
constexpr int kTileWords = 2;
constexpr int kTileCols = 32 * kTileWords;
constexpr int kStagedRows = kTileRows + kWindow - 1;
constexpr int kStagedWords = kTileWords + 1;
constexpr int kTileChunks = kTileCols / 4 + 1;  // 4-byte words a tile row of `valid` meets
constexpr int kMaxCap = 1024;               // the commit's one block
constexpr int kDiffuseThreads = 1024;       // a strip's CTA
constexpr int kMaxCluster = 16;             // strips a channel (non-portable on Hopper)
constexpr int kMaxOwned = 64;               // pixels a diffusion thread: a 64-bit hole mask
constexpr int kMaxDiffusionPixels = 128 * 128;  // a box (ops/cuda/wexler_fill.py)
// two copies of the largest strip: a one-row box (or two rows of half as many)
constexpr int kMaxDiffusionSmem = 2 * kMaxDiffusionPixels * static_cast<int>(sizeof(float));
constexpr int kMaxDevices = 64;

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

enum Mode { kEnergyMode = 0, kRingMode = 1, kIslandMode = 2 };

// Rows of a band of the ring pick: its masks' words fit kPickWords, the
// known mask with a halo row above and below (onion peels only).
__host__ __device__ inline int pick_band_rows(int bw, int mode) {
  return kPickWords / ((bw + 31) / 32) - (mode == kEnergyMode ? 0 : 2);
}

// Word w of a known-mask row dilated across: bit i is set where the left or
// right neighbour of pixel 32 w + i is known, or (with `centre`) the pixel
// itself.  Funnel shifts carry the neighbours across word boundaries; the
// box's left and right edges count as known (the bits past bw are set at
// the load).
__device__ __forceinline__ unsigned across(const unsigned* __restrict__ row, int w, int words,
                                           bool centre) {
  const unsigned c = row[w];
  const unsigned left = w > 0 ? row[w - 1] : kFull;
  const unsigned right = w + 1 < words ? row[w + 1] : kFull;
  const unsigned sides = __funnelshift_l(left, c, 1) | __funnelshift_r(c, right, 1);
  return centre ? sides | c : sides;
}

// Rows y0, y0 + per_col, ... (kBatch of them) of word column w of a ring-pick
// band's masks, a ballot a word: lane u < kBatch gets the u-th row's
// remaining and known words.  Every load from an address clamped into the
// box, all issued before any is used, so that they are in flight together.
template <int kBatch, bool kRestricted>
__device__ __forceinline__ void ballot_rows(const float* __restrict__ rem,
                                            const float* __restrict__ rem0,
                                            const float* __restrict__ island, size_t column,
                                            bool in_x, int y0, int per_col, int bh, int width,
                                            bool peel, unsigned& r_word, unsigned& k_word) {
  const int lane = threadIdx.x & 31;
  float rn[kBatch], seed0[kBatch], seed1[kBatch];
  bool in[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int y = y0 + u * per_col;
    in[u] = in_x && y >= 0 && y < bh;
    const size_t at = column + static_cast<size_t>(min(max(y, 0), bh - 1)) * width;
    rn[u] = rem[at];
    if (kRestricted) {
      seed0[u] = rem0[at];
      seed1[u] = island[at];
    }
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    // known = 1 - rem; the seed: a known pixel filled in this pass or not on
    // an island; outside the box every pixel is known (no short circuit:
    // every load is used)
    const bool kn =
        !in[u] | (kRestricted ? (rn[u] == 0.0f) & ((seed0[u] > 0.0f) | (seed1[u] == 0.0f))
                              : __fsub_rn(1.0f, rn[u]) > 0.0f);
    const unsigned r_bits = __ballot_sync(kFull, in[u] & (rn[u] > 0.0f));
    const unsigned k_bits = peel ? __ballot_sync(kFull, kn) : 0u;
    if (lane == u) {
      r_word = r_bits;
      k_word = k_bits;
    }
  }
}

// The position of the r-th (from 0) set bit of v, which has more than r.
__device__ __forceinline__ int nth_bit(unsigned v, int r) {
  int b = 0;
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    const int low = __popc(v & ((1u << step) - 1u));
    if (r >= low) {
      r -= low;
      v >>= step;
      b += step;
    }
  }
  return b;
}

__global__ void __launch_bounds__(kPickThreads)
wexler_ring_pick_kernel(const float* __restrict__ rem, const float* __restrict__ rem0,
                        const float* __restrict__ island, int* __restrict__ tyx,
                        unsigned long long* __restrict__ keys, int* __restrict__ state, int bh,
                        int bw, int by0, int bx0, int width, int cap, int tp, int mode) {
  // a band of box rows as 32-pixel words, bit i of word w pixel 32 w + i:
  // remaining (rem > 0) and, with a halo row on each side, known
  __shared__ unsigned remaining[kPickWords];
  __shared__ unsigned known[kPickWords];
  // each thread's first ring pixel in the band (a band-relative slot)
  __shared__ int thread_base[kPickThreads];
  __shared__ int warp_base[32];
  __shared__ int band_total;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // read here, tested once the first band's loads are in flight (reading
  // the mask of a pass that has stopped writes nothing)
  const bool go = state[kLive] != 0 && state[kFail] == 0;
  const bool peel = mode != kEnergyMode;
  const int words = (bw + 31) >> 5;
  const int band = pick_band_rows(bw, mode);
  // the warps of a word column: a column each, or 32 / words of them taking
  // every (32 / words)-th row; this warp's columns start at column `col0`
  // and row `phase`
  const int per_col = words < 32 ? 32 / words : 1;
  const int col0 = warp / per_col, phase = warp - col0 * per_col;
  const int col_step = 32 / per_col;
  int base = 0;
  // the seed-restricted ring first where there are islands; the plain ring
  // when there are none or that ring is empty
  for (int restricted = mode == kIslandMode; restricted >= 0; --restricted) {
    base = 0;
    // bands of rows, a block-wide exclusive scan of the ring's words each,
    // until cap targets are taken (base is the same in every thread)
    for (int r0 = 0; r0 < bh && base < cap; r0 += band) {
      const int rows = min(band, bh - r0);
      // the masks, a ballot a word: known row k is box row r0 - 1 + k, and
      // outside the box every pixel is known
      const int mask_rows = peel ? rows + 2 : rows;
      const int batch = restricted ? kPickBatch / 4 : kPickBatch;
      for (int w = col0; w < words; w += col_step) {
        const int x = (w << 5) + lane;
        const size_t column = static_cast<size_t>(by0) * width + bx0 + min(x, bw - 1);
        for (int k0 = phase; k0 < mask_rows; k0 += batch * per_col) {
          unsigned r_word = 0u, k_word = 0u;
          if (restricted) {
            ballot_rows<kPickBatch / 4, true>(rem, rem0, island, column, x < bw, r0 + k0 - peel,
                                              per_col, bh, width, peel, r_word, k_word);
          } else {
            ballot_rows<kPickBatch, false>(rem, rem0, island, column, x < bw, r0 + k0 - peel,
                                           per_col, bh, width, peel, r_word, k_word);
          }
          const int k = k0 + lane * per_col;
          if (lane < batch && k < mask_rows) {
            if (!peel) {
              remaining[k * words + w] = r_word;
            } else {
              known[k * words + w] = k_word;
              if (k >= 1 && k <= rows) remaining[(k - 1) * words + w] = r_word;
            }
          }
        }
      }
      if (!go) {  // the pass failed or its energy loop stopped: active to 0
        if (tid == 0) state[kActive] = 0;
        return;
      }
      __syncthreads();
      // this thread's words of the band, contiguous in raster order:
      // remaining pixels (energy passes), or those with a known 8-neighbour
      // (onion peels)
      const int n = rows * words;
      const int per = (n + kPickThreads - 1) / kPickThreads;
      const int first = tid * per;
      const int k_first = first / words, w_first = first - k_first * words;
      unsigned ring[kPickWordsPerThread];
      int own = 0;
#pragma unroll
      for (int q = 0, k = k_first, w = w_first; q < kPickWordsPerThread; ++q) {
        const int i = first + q;
        ring[q] = 0u;
        if (q < per && i < n) {
          ring[q] = remaining[i];
          if (peel) {
            const unsigned* up = known + k * words;
            ring[q] &= across(up, w, words, true) | across(up + words, w, words, false) |
                       across(up + 2 * words, w, words, true);
          }
          own += __popc(ring[q]);
        }
        if (++w == words) {
          w = 0;
          ++k;
        }
      }
      int incl = own;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      if (lane == 31) warp_base[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int total = warp_base[lane];
        int sum = total;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
          const int up = __shfl_up_sync(kFull, sum, d);
          if (lane >= d) sum += up;
        }
        warp_base[lane] = sum - total;
        if (lane == 31) band_total = sum;
      }
      __syncthreads();
      // the ring words in place of the remaining ones (each thread's own),
      // and each thread's first slot
#pragma unroll
      for (int q = 0; q < kPickWordsPerThread; ++q) {
        if (q < per && first + q < n) remaining[first + q] = ring[q];
      }
      thread_base[tid] = warp_base[warp] + incl - own;
      __syncthreads();
      // the targets, a slot a thread: the thread whose words hold the slot
      // (the last whose first slot is at most it), its word, the bit
      const int taken = min(band_total, cap - base);
      for (int j = tid; j < taken; j += kPickThreads) {
        int t = 0;
#pragma unroll
        for (int step = kPickThreads / 2; step >= 1; step >>= 1) {
          if (thread_base[t + step] <= j) t += step;
        }
        int r = j - thread_base[t], i = t * per;
        unsigned word = remaining[i];
        while (r >= __popc(word)) {
          r -= __popc(word);
          word = remaining[++i];
        }
        const int k = i / words;
        tyx[base + j] = by0 + r0 + k;
        tyx[cap + base + j] = bx0 + ((i - k * words) << 5) + nth_bit(word, r);
      }
      base += band_total;
      __syncthreads();  // the masks, warp_base and band_total are rewritten next band
    }
    if (base > 0) break;
  }
  // the slots past the count: the box origin
  const int count = base < cap ? base : cap;
  for (int t = count + tid; t < cap; t += kPickThreads) {
    tyx[t] = by0;
    tyx[cap + t] = bx0;
  }
  for (int t = tid; t < tp; t += kPickThreads) keys[t] = kNoKey;
  if (tid == 0) {
    state[kCount] = count;
    state[kActive] = count > 0;
    state[kIterations] += count > 0;
  }
}

// Bit x: bits x .. x + 12 of v are all set (x < 52).
__device__ __forceinline__ unsigned long long run13(unsigned long long v) {
  const unsigned long long a2 = v & (v >> 1);    // x .. x + 1
  const unsigned long long a4 = a2 & (a2 >> 2);  // x .. x + 3
  const unsigned long long a8 = a4 & (a4 >> 4);  // x .. x + 7
  return a8 & (a4 >> 8) & (v >> 12);            // x .. x + 11, and x + 12
}

// Validity of the candidates (cy, cx) of tile `tile` of the region [vy0, vy0
// + vh) x [vx0, vx0 + vw): a window with no remaining pixel.
__device__ void validity_tile(const float* __restrict__ rem, uint8_t* __restrict__ valid,
                              bool active, int tile, int height, int width, int vy0, int vx0, int vh,
                              int vw) {
  // the staged "rem == 0" bits, each row's 13-wide runs, and the tile's
  // valid candidates, kTileCols to a row
  __shared__ unsigned known[kStagedRows][kStagedWords];
  __shared__ unsigned run[kStagedRows][kTileWords];
  __shared__ unsigned ok[kTileRows][kTileWords];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tiles_x = (vw + kTileCols - 1) / kTileCols;
  const int cy0 = vy0 + (tile / tiles_x) * kTileRows;
  const int cx0 = vx0 + (tile % tiles_x) * kTileCols;
  // the window's "rem == 0" bits, a ballot over a warp's 32 coalesced loads,
  // all of a warp's loads in flight at once (past the image: set; no
  // candidate written reads them)
  constexpr int kWarps = kFilterThreads / 32;
  constexpr int kTasks = (kStagedRows * kStagedWords + kWarps - 1) / kWarps;
  // (each load from an address clamped into the image, issued before any
  // is used, so that they are in flight together)
  float v[kTasks];
  bool in[kTasks];
#pragma unroll
  for (int u = 0; u < kTasks; ++u) {
    const int j = (tid >> 5) + u * kWarps;
    const int r = j / kStagedWords, w = j - r * kStagedWords;
    const int y = cy0 + r, x = cx0 + (w << 5) + lane;
    in[u] = j < kStagedRows * kStagedWords && y < height && x < width;
    v[u] = rem[static_cast<size_t>(min(y, height - 1)) * width + min(x, width - 1)];
  }
#pragma unroll
  for (int u = 0; u < kTasks; ++u) {
    const int j = (tid >> 5) + u * kWarps;
    const unsigned bits = __ballot_sync(kFull, !in[u] || v[u] == 0.0f);
    if (lane == 0 && j < kStagedRows * kStagedWords) {
      const int r = j / kStagedWords;
      known[r][j - r * kStagedWords] = bits;
    }
  }
  if (!active) return;  // the whole block
  __syncthreads();
  for (int j = tid; j < kStagedRows * kTileWords; j += kFilterThreads) {
    const int r = j / kTileWords, w = j - r * kTileWords;
    const unsigned long long v =
        known[r][w] | static_cast<unsigned long long>(known[r][w + 1]) << 32;
    run[r][w] = static_cast<unsigned>(run13(v));
  }
  __syncthreads();
  for (int j = tid; j < kTileRows * kTileWords; j += kFilterThreads) {
    const int r = j / kTileWords, w = j - r * kTileWords;
    unsigned a = run[r][w];
#pragma unroll
    for (int k = 1; k < kWindow; ++k) a &= run[r + k][w];
    ok[r][w] = a;
  }
  __syncthreads();
  // one byte a candidate, row stride width - 12: a 4-byte store where the
  // word lies inside the tile row, bytes at its ends
  const int n_cx = width - 2 * kHalf;
  const int cols = min(kTileCols, vx0 + vw - cx0);
  for (int j = tid; j < kTileRows * kTileChunks; j += kFilterThreads) {
    const int r = j / kTileChunks, q = j - r * kTileChunks;
    const int cy = cy0 + r;
    if (cy >= vy0 + vh) continue;
    const size_t start = static_cast<size_t>(cy) * n_cx + cx0;  // byte of candidate cx0
    const size_t at = (start & ~static_cast<size_t>(3)) + 4 * static_cast<size_t>(q);
    const int c = static_cast<int>(at - start);  // the word's first candidate, from -3
    if (c >= cols) continue;
    const unsigned long long both = ok[r][0] | static_cast<unsigned long long>(ok[r][1]) << 32;
    const unsigned long long bits = c >= 0 ? both >> c : both << -c;  // bit i: candidate c + i
    if (c >= 0 && c + 4 <= cols) {
      *reinterpret_cast<unsigned*>(valid + at) = (bits & 1u) | (bits >> 1 & 1u) << 8 |
                                                 (bits >> 2 & 1u) << 16 | (bits >> 3 & 1u) << 24;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i >= 0 && c + i < cols) valid[at + i] = static_cast<uint8_t>(bits >> i & 1u);
    }
  }
}

__global__ void __launch_bounds__(kFilterThreads)
wexler_filters_kernel(const float* __restrict__ img, const float* __restrict__ rem,
                      const int* __restrict__ tyx, const int* __restrict__ state,
                      __nv_bfloat16* __restrict__ f, float* __restrict__ b2,
                      uint8_t* __restrict__ valid, int height, int width, int cap, int tp,
                      int initial, int target_blocks, int vy0, int vx0, int vh, int vw) {
  // a target's window, staged by its warp: m (0 outside the image and, in
  // onion peels, on the target's own unknown pixels) and the three channels
  // of the image (0 outside), channel-major: b[169 c + 13 ky + kx]
  __shared__ float win_m[kTargetsPerBlock][kArea];
  __shared__ float win_b[kTargetsPerBlock][kWindowFloats];
  // read here, tested once the first loads are in flight: an inactive
  // iteration reads the buffers and writes nothing
  const bool active = state[kActive] != 0;
  if (static_cast<int>(blockIdx.x) >= target_blocks) {
    validity_tile(rem, valid, active, blockIdx.x - target_blocks, height, width, vy0, vx0, vh, vw);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kTargetsPerBlock + warp;
  if (t >= cap) return;  // a whole warp
  const int ty = tyx[t], tx = tyx[cap + t];
  float* m_s = win_m[warp];
  float* b_s = win_b[warp];
  // the window, read once: the image 39 contiguous floats a row, and the
  // mask in onion peels; every load from an address clamped into the image,
  // all issued before any is used, so that they are in flight together
  constexpr int kImgLoads = (kWindowFloats + 31) / 32, kRemLoads = (kArea + 31) / 32;
  float bv[kImgLoads], rv[kRemLoads] = {};
#pragma unroll
  for (int i = 0; i < kImgLoads; ++i) {
    const int e = min(lane + 32 * i, kWindowFloats - 1);
    const int ky = e / kRowFloats, q = e - ky * kRowFloats;
    const int kx = q / 3;
    const int y = min(max(ty + ky - kHalf, 0), height - 1);
    const int x = min(max(tx + kx - kHalf, 0), width - 1);
    bv[i] = img[(static_cast<size_t>(y) * width + x) * 3 + q - 3 * kx];
  }
  if (initial) {
#pragma unroll
    for (int i = 0; i < kRemLoads; ++i) {
      const int e = min(lane + 32 * i, kArea - 1);
      const int ky = e / kWindow;
      const int y = min(max(ty + ky - kHalf, 0), height - 1);
      const int x = min(max(tx + e - ky * kWindow - kHalf, 0), width - 1);
      rv[i] = rem[static_cast<size_t>(y) * width + x];
    }
  }
#pragma unroll
  for (int i = 0; i < kRemLoads; ++i) {
    const int e = lane + 32 * i;
    if (e < kArea) {
      const int ky = e / kWindow, kx = e - ky * kWindow;
      const int y = ty + ky - kHalf, x = tx + kx - kHalf;
      const bool in = y >= 0 && y < height && x >= 0 && x < width;
      m_s[e] = in && !(initial && rv[i] != 0.0f) ? 1.0f : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kImgLoads; ++i) {
    const int e = lane + 32 * i;
    if (e < kWindowFloats) {
      const int ky = e / kRowFloats, q = e - ky * kRowFloats;
      const int kx = q / 3, c = q - 3 * kx;
      const int y = ty + ky - kHalf, x = tx + kx - kHalf;
      const bool in = y >= 0 && y < height && x >= 0 && x < width;
      b_s[c * kArea + ky * kWindow + kx] = in ? bv[i] : 0.0f;
    }
  }
  if (!active) return;  // the whole warp
  __syncwarp();
  // filter row (ky, t): lane l writes columns 4 l .. 4 l + 3 as 8 bytes;
  // column 9 kx + j of plane j is 256 m, m or -2 m b of channel j % 3 at
  // (ky, kx): scale * m, or -2 (b m); columns 117 .. 127 are 0 * m = 0
  int m_at[4], b_at[4];
  float scale[4];
  bool use_b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int col = 4 * lane + k;
    const int kx = col / kPlanes, j = col - kPlanes * kx;
    const bool zero = col >= kPacked;
    use_b[k] = !zero && j >= 6;
    scale[k] = zero ? 0.0f : j < 3 ? 256.0f : j < 6 ? 1.0f : -2.0f;
    m_at[k] = zero ? 0 : kx;
    b_at[k] = use_b[k] ? (j - 6) * kArea + kx : 0;
  }
  __nv_bfloat16* row = f + static_cast<size_t>(t) * kChannels + 4 * lane;
#pragma unroll
  for (int ky = 0; ky < kWindow; ++ky) {
    const int o = ky * kWindow;
    unsigned short h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float m = m_s[o + m_at[k]];
      const float bm = __fmul_rn(b_s[o + b_at[k]], m);
      h[k] = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(scale[k], use_b[k] ? bm : m)));
    }
    uint2 out;
    out.x = h[0] | static_cast<unsigned>(h[1]) << 16;
    out.y = h[2] | static_cast<unsigned>(h[3]) << 16;
    *reinterpret_cast<uint2*>(row + static_cast<size_t>(ky) * tp * kChannels) = out;
  }
  // b2: lane l holds slots l + 32 i of the (c, ky, kx) products, then the
  // halving tree x[i] + x[i + h] for h = 256 .. 1
  float v[kTree / 32];
#pragma unroll
  for (int i = 0; i < kTree / 32; ++i) {
    const int s = lane + 32 * i;
    v[i] = 0.0f;
    if (s < kPatch) {
      const int r = s - (s >= 2 * kArea ? 2 * kArea : s >= kArea ? kArea : 0);
      const float b = b_s[s];
      v[i] = __fmul_rn(__fmul_rn(b, m_s[r]), b);
    }
  }
  // (each level written out, so that v stays in registers)
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], v[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __fadd_rn(v[i], v[i + 4]);
#pragma unroll
  for (int i = 0; i < 2; ++i) v[i] = __fadd_rn(v[i], v[i + 2]);
  float s = __fadd_rn(v[0], v[1]);
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
  if (lane == 0) b2[t] = s;
}

__global__ void __launch_bounds__(kMaxCap)
wexler_commit_kernel(float* __restrict__ img, float* __restrict__ rem,
                     __nv_bfloat16* __restrict__ p, const unsigned long long* __restrict__ keys,
                     const float* __restrict__ b2, const int* __restrict__ tyx,
                     const float* __restrict__ weight, int* __restrict__ state, int width,
                     int n_cx, int cap) {
  __shared__ float tree[kMaxCap];
  if (state[kActive] == 0) return;
  const int t = threadIdx.x;
  const bool target = t < state[kCount];  // the count is at most cap
  float e = 0.0f;
  unsigned idx = 0;
  if (target) {
    const unsigned long long key = keys[t];
    float emin = __int_as_float(0x7f800000);  // +inf: no valid candidate
    if (key != kNoKey) {
      const unsigned ordered = static_cast<unsigned>(key >> 32);
      emin = __uint_as_float((ordered & 0x80000000u) ? (ordered & 0x7fffffffu) : ~ordered);
      idx = static_cast<unsigned>(key);
    }
    e = __fadd_rn(emin, b2[t]);
  }
  const bool fail_now = __syncthreads_or(target && !isfinite(e));
  float w = 0.0f;
  if (target && !fail_now) {
    const int ty = tyx[t], tx = tyx[cap + t];
    const int sy = static_cast<int>(idx / n_cx) + kHalf, sx = static_cast<int>(idx % n_cx) + kHalf;
    // the pick lies in a valid window, so it is never a target: the copy
    // reads the ring-start image
    const float* src = img + (static_cast<size_t>(sy) * width + sx) * 3;
    const size_t at = static_cast<size_t>(ty) * width + tx;
    float val[3], planes[kPlanes];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      val[c] = src[c];
      const float sq = __fmul_rn(val[c], val[c]);
      const float hi = floorf(__fmul_rn(sq, 1.0f / 256.0f));
      planes[c] = hi;
      planes[3 + c] = __fsub_rn(sq, __fmul_rn(hi, 256.0f));
      planes[6 + c] = val[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) img[at * 3 + c] = val[c];
    rem[at] = 0.0f;
#pragma unroll
    for (int kx = 0; kx < kWindow; ++kx) {
      const int xp = tx - kx;
      if (xp < 0 || xp >= n_cx) continue;
      __nv_bfloat16* dst = p + (static_cast<size_t>(ty) * n_cx + xp) * kChannels + kPlanes * kx;
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) dst[j] = __float2bfloat16_rn(planes[j]);
    }
    w = __fmul_rn(e, weight[at]);
  }
  tree[t] = w;
  __syncthreads();
  for (int h = blockDim.x / 2; h >= 1; h /= 2) {
    if (t < h) tree[t] = __fadd_rn(tree[t], tree[t + h]);
    __syncthreads();
  }
  if (t == 0) {
    state[kEnergy] = __float_as_int(__fadd_rn(__int_as_float(state[kEnergy]), tree[0]));
    if (fail_now) state[kFail] = 1;
  }
}

// The diffusion start's strips: a channel's box split into `cluster` row
// strips, one a CTA of a thread-block cluster (at most 16, and no more than
// the box has rows).  A strip is held in shared memory twice (the sweep's
// source and destination), each copy with a halo row above and below where
// a neighbouring strip lies there.  Threads take the strip's pixels as a
// (ty, tx) grid of stride (kDiffuseThreads / tx, tx), tx the least power of
// two >= min(bw, kDiffuseThreads): at most kMaxOwned pixels a thread.
struct Strips {
  int cluster;    // CTAs a channel
  int rows_max;   // rows of the tallest strip
  int halos;      // halo rows a strip copy reserves
  int tx, ty;     // the thread grid's columns and rows
  int cols, rows; // a thread's pixels: columns and rows of them
  int smem;       // dynamic shared memory a CTA, in bytes
};

__host__ __device__ inline Strips strips_of(int bh, int bw) {
  Strips g;
  g.cluster = bh < kMaxCluster ? bh : kMaxCluster;
  g.rows_max = (bh + g.cluster - 1) / g.cluster;
  g.halos = g.cluster - 1 < 2 ? g.cluster - 1 : 2;
  g.tx = 1;
  while (g.tx < bw && g.tx < kDiffuseThreads) g.tx *= 2;
  g.ty = kDiffuseThreads / g.tx;
  g.cols = (bw + g.tx - 1) / g.tx;
  g.rows = (g.rows_max + g.ty - 1) / g.ty;
  g.smem = 2 * (g.rows_max + g.halos) * bw * static_cast<int>(sizeof(float));
  return g;
}

// Distributed shared memory, point to point: a 32-bit shared::cluster
// address of another CTA's variable, an mbarrier of this CTA, and a store
// into another CTA that completes its bytes on that CTA's mbarrier.
__device__ __forceinline__ unsigned shared_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_address(unsigned local, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbarrier_init(unsigned bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbarrier_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbarrier_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void store_remote(unsigned address, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   address),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

__global__ void __launch_bounds__(kDiffuseThreads)
wexler_diffusion_kernel(const uint8_t* __restrict__ src, const float* __restrict__ rem0,
                        uint8_t* __restrict__ out, int bh, int bw, int by0, int bx0, int width,
                        int dither, float ninth) {
  extern __shared__ float plane[];  // two strip copies, halo rows included
  __shared__ float warp_sum[kDiffuseThreads / 32], warp_known[kDiffuseThreads / 32];
  __shared__ float partial[2];      // this strip's (sum, known), read by the cluster
  __shared__ float box_mean;
  // received[c]: the neighbours' edge rows of a sweep, written into this
  // strip's halo rows of copy c (one phase every other sweep)
  __shared__ alignas(8) unsigned long long received[2];
  cg::cluster_group cluster = cg::this_cluster();
  const Strips g = strips_of(bh, bw);
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int r0 = rank * bh / g.cluster;
  const int rows = (rank + 1) * bh / g.cluster - r0;  // >= 1: cluster <= bh
  const int top = rank > 0;                           // a halo row above
  const bool has_up = rank > 0, has_down = rank < g.cluster - 1;
  const int copy = (g.rows_max + g.halos) * bw;       // floats a strip copy
  const int tx = tid % g.tx, ty = tid / g.tx;
  if (tid == 0) {
    mbarrier_init(shared_u32(&received[0]), 1);
    mbarrier_init(shared_u32(&received[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // the strip's pixels into both copies; its known pixels' sums; this
  // thread's hole pixels as a mask, bit k * cols + j for pixel (ty + k ty_,
  // tx + j tx_)
  unsigned long long hole = 0ull;
  float sum = 0.0f, known = 0.0f;
  for (int k = 0; k < g.rows; ++k) {
    const int lr = ty + k * g.ty;
    if (lr >= rows) break;
    for (int j = 0; j < g.cols; ++j) {
      const int x = tx + j * g.tx;
      if (x >= bw) break;
      const size_t at = static_cast<size_t>(by0 + r0 + lr) * width + bx0 + x;
      const float r = rem0[at];
      const float v = static_cast<float>(src[at * 3 + c]);
      const float kn = __fsub_rn(1.0f, r);
      sum = __fadd_rn(sum, __fmul_rn(v, kn));
      known = __fadd_rn(known, kn);
      plane[(lr + top) * bw + x] = v;
      plane[copy + (lr + top) * bw + x] = v;
      if (r > 0.0f) hole |= 1ull << (k * g.cols + j);
    }
  }
  // the box's mean of its known pixels over the cluster: integer sums below
  // 2^24, exact in any order
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) {
    sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
    known = __fadd_rn(known, __shfl_xor_sync(kFull, known, off));
  }
  if ((tid & 31) == 0) {
    warp_sum[tid >> 5] = sum;
    warp_known[tid >> 5] = known;
  }
  __syncthreads();
  if (tid == 0) {
    sum = known = 0.0f;
    for (int w = 0; w < kDiffuseThreads / 32; ++w) {
      sum = __fadd_rn(sum, warp_sum[w]);
      known = __fadd_rn(known, warp_known[w]);
    }
    partial[0] = sum;
    partial[1] = known;
  }
  cluster.sync();  // every CTA runs, its partial and its mbarriers are set
  if (tid < 32) {
    sum = known = 0.0f;
    if (tid < g.cluster) {
      const float* other = cluster.map_shared_rank(partial, tid);
      sum = other[0];
      known = other[1];
    }
#pragma unroll
    for (int off = 16; off >= 1; off /= 2) {
      sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
      known = __fadd_rn(known, __shfl_xor_sync(kFull, known, off));
    }
    if (tid == 0) box_mean = __fdiv_rn(sum, fmaxf(known, 1.0f));
  }
  __syncthreads();
  const float mean = box_mean;

  // the neighbours' halo rows that this strip's edge rows feed (the upper
  // strip's row below its own, the lower strip's row 0; copy 0, copy 1 is
  // `copy` floats on) and their mbarriers, as shared::cluster addresses
  const int up_halo = has_up ? ((rank - 1 > 0) + r0 - (rank - 1) * bh / g.cluster) * bw : 0;
  unsigned up = 0, down = 0, up_bar = 0, down_bar = 0;
  if (has_up) {
    up = cluster_address(shared_u32(plane + up_halo), rank - 1);
    up_bar = cluster_address(shared_u32(&received[0]), rank - 1);
  }
  if (has_down) {
    down = cluster_address(shared_u32(plane), rank + 1);
    down_bar = cluster_address(shared_u32(&received[0]), rank + 1);
  }
  // the start: hole pixels take the mean in copy 0; the edge rows go to the
  // neighbours' halos in both copies (known pixels keep them from then on)
  float* up_far = has_up ? cluster.map_shared_rank(plane, rank - 1) + up_halo : nullptr;
  float* down_far = has_down ? cluster.map_shared_rank(plane, rank + 1) : nullptr;
  for (int k = 0; k < g.rows; ++k) {
    const int lr = ty + k * g.ty;
    if (lr >= rows) break;
    const int rm = (lr + top) * bw;
    for (int j = 0; j < g.cols; ++j) {
      const int x = tx + j * g.tx;
      if (x >= bw) break;
      if (hole >> (k * g.cols + j) & 1ull) plane[rm + x] = mean;
      const float v = plane[rm + x];
      if (lr == 0 && has_up) up_far[x] = up_far[copy + x] = v;
      if (lr == rows - 1 && has_down) down_far[x] = down_far[copy + x] = v;
    }
  }
  cluster.sync();

  // bh + bw Jacobi sweeps of the 3 x 3 mean, clamped at the box's edges:
  // only hole pixels are written.  A sweep waits for the neighbours' edge
  // rows of the last one, computes its strip, and (after its CTA barrier:
  // no thread reads the source copy any more, whose halos the neighbours
  // write next) sends its own edge rows into the neighbours' halo rows of
  // the copy just written, each store completing its bytes on the
  // receiver's mbarrier.  No neighbour runs two sweeps ahead: each needs
  // the other's last edge rows.  The last sweep sends nothing.
  const int sweeps = bh + bw;
  const unsigned edge_bytes = (has_up + has_down) * bw * static_cast<unsigned>(sizeof(float));
  // before a sweep: the neighbours' edge rows of the last one
  auto receive = [&](int sweep) {
    if (sweep > 0 && edge_bytes > 0) {
      mbarrier_wait(shared_u32(&received[sweep & 1]), ((sweep - 1) >> 1) & 1);
    }
  };
  // after it: this strip's edge rows of copy `to` into the neighbours' halos
  auto send = [&](int sweep) {
    __syncthreads();
    if (sweep + 1 == sweeps || edge_bytes == 0) return;
    const int to = (sweep & 1) ^ 1;
    if (tid == 0) mbarrier_expect(shared_u32(&received[to]), edge_bytes);
    const float* nxt = plane + to * copy;
    const unsigned half = to * copy * static_cast<unsigned>(sizeof(float));
    const unsigned bar = to * static_cast<unsigned>(sizeof(unsigned long long));
    for (int x = tid; x < bw; x += kDiffuseThreads) {
      const unsigned offset = half + x * static_cast<unsigned>(sizeof(float));
      if (has_up) store_remote(up + offset, nxt[top * bw + x], up_bar + bar);
      if (has_down) store_remote(down + offset, nxt[(top + rows - 1) * bw + x], down_bar + bar);
    }
  };
  // one hole pixel's new value: the nine terms in (dy, dx) order
  auto mean9 = [&](const float* cur, int ru, int rm, int rd, int x) {
    const int xl = max(x - 1, 0), xr = min(x + 1, bw - 1);
    float v = 0.0f;
    v = __fadd_rn(v, cur[ru + xl]);
    v = __fadd_rn(v, cur[ru + x]);
    v = __fadd_rn(v, cur[ru + xr]);
    v = __fadd_rn(v, cur[rm + xl]);
    v = __fadd_rn(v, cur[rm + x]);
    v = __fadd_rn(v, cur[rm + xr]);
    v = __fadd_rn(v, cur[rd + xl]);
    v = __fadd_rn(v, cur[rd + x]);
    v = __fadd_rn(v, cur[rd + xr]);
    return __fmul_rn(v, ninth);
  };
  if (g.rows == 1 && g.cols == 1) {
    // at most one pixel a thread (a 128 x 128 box in 16 strips): its offsets
    // once, then a load-free test a sweep
    const bool mine = (hole & 1ull) != 0ull;  // implies ty < rows and tx < bw
    const int rm = (ty + top) * bw;
    const int ru = ty == 0 && !has_up ? rm : rm - bw;
    const int rd = ty == rows - 1 && !has_down ? rm : rm + bw;
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      receive(sweep);
      const int from = sweep & 1;
      if (mine) plane[(from ^ 1) * copy + rm + tx] = mean9(plane + from * copy, ru, rm, rd, tx);
      send(sweep);
    }
  } else {
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      receive(sweep);
      const int from = sweep & 1;
      const float* cur = plane + from * copy;
      float* nxt = plane + (from ^ 1) * copy;
      for (int k = 0; k < g.rows; ++k) {
        const int lr = ty + k * g.ty;
        if (lr >= rows) break;
        const int rm = (lr + top) * bw;
        const int ru = lr == 0 && !has_up ? rm : rm - bw;
        const int rd = lr == rows - 1 && !has_down ? rm : rm + bw;
        for (int j = 0; j < g.cols; ++j) {
          const int x = tx + j * g.tx;
          if (x >= bw) break;
          if (hole >> (k * g.cols + j) & 1ull) nxt[rm + x] = mean9(cur, ru, rm, rd, x);
        }
      }
      send(sweep);
    }
  }
  cluster.sync();  // no CTA leaves while a neighbour may still write into it

  // the dither and the clamp into the hole pixels of the output
  const float* cur = plane + (sweeps & 1) * copy;
  for (int k = 0; k < g.rows; ++k) {
    const int lr = ty + k * g.ty;
    if (lr >= rows) break;
    for (int j = 0; j < g.cols; ++j) {
      const int x = tx + j * g.tx;
      if (x >= bw) break;
      if (!(hole >> (k * g.cols + j) & 1ull)) continue;  // known pixels keep the source's
      const int gy = by0 + r0 + lr, gx = bx0 + x;
      float v = cur[(lr + top) * bw + x];
      if (dither) {
        // the JAX package's int32 coordinate hash with wrap-around
        const unsigned h = static_cast<unsigned>(gy) * 92837111u ^
                           static_cast<unsigned>(gx) * 689287499u;
        v = __fadd_rn(v, static_cast<float>(static_cast<int>((h >> 8) % 25u) - 12));
      }
      v = fminf(fmaxf(v, 0.0f), 255.0f);
      out[(static_cast<size_t>(gy) * width + gx) * 3 + c] = static_cast<uint8_t>(__float2int_rz(v));
    }
  }
}

int round_pow2(int n) {
  int p = 32;
  while (p < n) p *= 2;
  return p;
}

// The diffusion kernel's attributes, set once a device: its dynamic shared
// memory past 48 KB and clusters of 16.
cudaError_t diffusion_attributes() {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(wexler_diffusion_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDiffusionSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(wexler_diffusion_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  done[device] = err == cudaSuccess;
  return err;
}

// A box the diffusion kernel takes: 1 <= bh, bw and bh * bw <= 128 * 128.
bool diffusion_box(int bh, int bw) {
  if (bh < 1 || bw < 1 || bh > kMaxDiffusionPixels / bw) return false;
  const Strips g = strips_of(bh, bw);
  return g.rows * g.cols <= kMaxOwned && g.smem <= kMaxDiffusionSmem;
}

}  // namespace

extern "C" {

// Targets a commit takes at most (one block).
int vip_wexler_fill_max_cap() { return kMaxCap; }

// A diffusion start's launch shape over a (bh, bw) box: CTAs a channel (a
// cluster; 3 clusters a launch) and dynamic shared memory a CTA; -1 for a
// box it does not take.
int vip_wexler_diffusion_cluster(int bh, int bw) {
  return diffusion_box(bh, bw) ? strips_of(bh, bw).cluster : -1;
}

int vip_wexler_diffusion_smem_bytes(int bh, int bw) {
  return diffusion_box(bh, bw) ? strips_of(bh, bw).smem : -1;
}

// rem, rem0: (H, W) f32 (1 = hole); island: (H, W) f32 or null (mode 2
// only); tyx: (2, cap) int32 targets (ty row, tx row); keys: (tp,) int64;
// state: the pass's int32 vector.  mode: 0 energy pass, 1 onion peel, 2
// onion peel seeded from outside the known islands.  A box too wide for a
// band of one row (bw > 32 * (kPickWords / 3)) launches nothing and returns
// cudaErrorInvalidValue.
int vip_wexler_ring_pick(const void* rem, const void* rem0, const void* island, void* tyx,
                         void* keys, void* state, int bh, int bw, int by0, int bx0, int width,
                         int cap, int tp, int mode, void* stream) {
  if (bw < 1 || pick_band_rows(bw, mode) < 1) return static_cast<int>(cudaErrorInvalidValue);
  wexler_ring_pick_kernel<<<1, kPickThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rem), static_cast<const float*>(rem0),
      static_cast<const float*>(island), static_cast<int*>(tyx),
      static_cast<unsigned long long*>(keys), static_cast<int*>(state), bh, bw, by0, bx0, width,
      cap, tp, mode);
  return static_cast<int>(cudaGetLastError());
}

// img: (H, W, 3) f32; f: (13, tp, 128) bf16, columns 0..116 of rows 0..cap-1
// written; b2: (cap,) f32; valid: (H - 12, W - 12) u8, rewritten over the
// candidates [vy0, vy0 + vh) x [vx0, vx0 + vw).
int vip_wexler_filters(const void* img, const void* rem, const void* tyx, const void* state,
                       void* f, void* b2, void* valid, int height, int width, int cap, int tp,
                       int initial, int vy0, int vx0, int vh, int vw, void* stream) {
  if (vh < 1 || vw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int target_blocks = (cap + kTargetsPerBlock - 1) / kTargetsPerBlock;
  const int tiles = ((vh + kTileRows - 1) / kTileRows) * ((vw + kTileCols - 1) / kTileCols);
  wexler_filters_kernel<<<target_blocks + tiles, kFilterThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(rem),
      static_cast<const int*>(tyx), static_cast<const int*>(state),
      static_cast<__nv_bfloat16*>(f), static_cast<float*>(b2), static_cast<uint8_t*>(valid),
      height, width, cap, tp, initial, target_blocks, vy0, vx0, vh, vw);
  return static_cast<int>(cudaGetLastError());
}

// p: (H, n_cx, 128) bf16, rewritten where a target's pixel feeds it;
// weight: (H, W) f32.  cap <= vip_wexler_fill_max_cap().
int vip_wexler_commit(void* img, void* rem, void* p, const void* keys, const void* b2,
                      const void* tyx, const void* weight, void* state, int width, int n_cx,
                      int cap, void* stream) {
  if (cap < 1 || cap > kMaxCap) return static_cast<int>(cudaErrorInvalidValue);
  wexler_commit_kernel<<<1, round_pow2(cap), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(img), static_cast<float*>(rem), static_cast<__nv_bfloat16*>(p),
      static_cast<const unsigned long long*>(keys), static_cast<const float*>(b2),
      static_cast<const int*>(tyx), static_cast<const float*>(weight), static_cast<int*>(state),
      width, n_cx, cap);
  return static_cast<int>(cudaGetLastError());
}

// src: (H, W, 3) u8; rem0: (H, W) f32; out: (H, W, 3) u8, a copy of src
// whose box hole pixels are written.  ninth: f32(1 / 9).  A box of more than
// 128 * 128 pixels launches nothing and returns cudaErrorInvalidValue; a
// cluster shape the runtime refuses returns its error.
int vip_wexler_diffusion(const void* src, const void* rem0, void* out, int bh, int bw, int by0,
                         int bx0, int width, int dither, float ninth, void* stream) {
  if (!diffusion_box(bh, bw)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = diffusion_attributes();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strips g = strips_of(bh, bw);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = g.cluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(g.cluster, 3, 1);  // a cluster a channel
  config.blockDim = dim3(kDiffuseThreads, 1, 1);
  config.dynamicSmemBytes = g.smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, wexler_diffusion_kernel, static_cast<const uint8_t*>(src),
      static_cast<const float*>(rem0), static_cast<uint8_t*>(out), bh, bw, by0, bx0, width,
      dither, ninth);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
