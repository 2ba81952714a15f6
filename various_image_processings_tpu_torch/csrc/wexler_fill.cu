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
// pick returns at once when active is 0, and the ring pick clears active
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
// The ring pick reads at most the box (<= 4 B a pixel plus 8 neighbours
// from L1), the filters write 13 x 128 x 2 B a target, the commit ~0.5 KB a
// target; at 402 x 700 (5a) that is well under a megabyte an iteration,
// microseconds of bandwidth.  The ring pick and the commit are one block by
// design (a block-wide scan and a fixed-order tree; the commit's fail test
// must precede every write), so they take a few microseconds each however
// small the ring.  The diffusion start is a chain of bh + bw dependent
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
constexpr int kTree = 512;                  // b2's tree, zero-padded

constexpr int kPickThreads = 1024;
constexpr int kFilterThreads = 256;
constexpr int kTargetsPerBlock = kFilterThreads / 32;  // a warp a target
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

// Is box pixel (y, x) on this iteration's ring?
__device__ __forceinline__ bool on_ring(const float* __restrict__ rem,
                                        const float* __restrict__ rem0,
                                        const float* __restrict__ island, int mode,
                                        bool restricted, int y, int x, int bh, int bw, int by0,
                                        int bx0, int width) {
  const float r = rem[static_cast<size_t>(by0 + y) * width + bx0 + x];
  if (!(r > 0.0f)) return false;
  if (mode == kEnergyMode) return true;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int ny = y + dy, nx = x + dx;
      if (ny < 0 || ny >= bh || nx < 0 || nx >= bw) return true;  // the box edge is known
      const size_t j = static_cast<size_t>(by0 + ny) * width + bx0 + nx;
      const float rn = rem[j];
      // known = 1 - rem; the seed: a known pixel filled in this pass or
      // not on an island
      const bool known = restricted ? (rn == 0.0f && (rem0[j] > 0.0f || island[j] == 0.0f))
                                    : __fsub_rn(1.0f, rn) > 0.0f;
      if (known) return true;
    }
  return false;
}

__global__ void __launch_bounds__(kPickThreads)
wexler_ring_pick_kernel(const float* __restrict__ rem, const float* __restrict__ rem0,
                        const float* __restrict__ island, int* __restrict__ tyx,
                        unsigned long long* __restrict__ keys, int* __restrict__ state, int bh,
                        int bw, int by0, int bx0, int width, int cap, int tp, int mode) {
  __shared__ int warp_offsets[32];
  __shared__ int chunk_total;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (state[kLive] == 0 || state[kFail] != 0) {
    if (tid == 0) state[kActive] = 0;
    return;
  }
  int* ty = tyx;
  int* tx = tyx + cap;
  const int n = bh * bw;
  int base = 0;
  // the seed-restricted ring first where there are islands; the plain ring
  // when there are none or that ring is empty
  for (int restricted = mode == kIslandMode; restricted >= 0; --restricted) {
    base = 0;
    // raster chunks of the box, a block-wide exclusive scan each, until
    // cap targets are taken (base is the same in every thread)
    for (int c0 = 0; c0 < n && base < cap; c0 += kPickThreads) {
      const int p = c0 + tid;
      const bool ring = p < n && on_ring(rem, rem0, island, mode, restricted != 0, p / bw,
                                         p % bw, bh, bw, by0, bx0, width);
      const unsigned ballot = __ballot_sync(kFull, ring);
      if (lane == 0) warp_offsets[warp] = __popc(ballot);
      __syncthreads();
      if (warp == 0) {
        const int own = warp_offsets[lane];
        int incl = own;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
          const int up = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += up;
        }
        warp_offsets[lane] = incl - own;
        if (lane == 31) chunk_total = incl;
      }
      __syncthreads();
      const int slot = base + warp_offsets[warp] + __popc(ballot & ((1u << lane) - 1));
      if (ring && slot < cap) {
        ty[slot] = by0 + p / bw;
        tx[slot] = bx0 + p % bw;
      }
      base += chunk_total;
      __syncthreads();  // warp_offsets and chunk_total are rewritten next chunk
    }
    if (base > 0) break;
  }
  const int count = base < cap ? base : cap;
  for (int t = count + tid; t < cap; t += kPickThreads) {
    ty[t] = by0;
    tx[t] = bx0;
  }
  for (int t = tid; t < tp; t += kPickThreads) keys[t] = kNoKey;
  if (tid == 0) {
    state[kCount] = count;
    state[kActive] = count > 0;
    state[kIterations] += count > 0;
  }
}

__global__ void __launch_bounds__(kFilterThreads)
wexler_filters_kernel(const float* __restrict__ img, const float* __restrict__ rem,
                      const int* __restrict__ tyx, const int* __restrict__ state,
                      __nv_bfloat16* __restrict__ f, float* __restrict__ b2,
                      uint8_t* __restrict__ valid, int height, int width, int cap, int tp,
                      int initial, int target_blocks, int vy0, int vx0, int vh, int vw) {
  if (state[kActive] == 0) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (static_cast<int>(blockIdx.x) >= target_blocks) {
    // validity: candidate (cy, cx) is valid when its window holds no
    // remaining pixel
    const int q = (blockIdx.x - target_blocks) * kFilterThreads + tid;
    if (q >= vh * vw) return;
    const int cy = vy0 + q / vw, cx = vx0 + q % vw;
    bool ok = true;
    for (int ky = 0; ky < kWindow && ok; ++ky) {
      const float* row = rem + static_cast<size_t>(cy + ky) * width + cx;
#pragma unroll
      for (int kx = 0; kx < kWindow; ++kx) ok = ok && row[kx] == 0.0f;
    }
    valid[static_cast<size_t>(cy) * (width - 2 * kHalf) + cx] = ok;
    return;
  }
  const int t = blockIdx.x * kTargetsPerBlock + tid / 32;
  if (t >= cap) return;  // a whole warp
  const int ty = tyx[t], tx = tyx[cap + t];
  // filter entry (ky, kx * 9 + j) of plane j: 256 m, m or -2 m b of channel j % 3
  for (int e = lane; e < kWindow * kPacked; e += 32) {
    const int ky = e / kPacked, col = e % kPacked;
    const int kx = col / kPlanes, j = col % kPlanes;
    const int y = ty + ky - kHalf, x = tx + kx - kHalf;
    const bool in = y >= 0 && y < height && x >= 0 && x < width;
    const size_t at = static_cast<size_t>(y) * width + x;
    const float m = in && !(initial && rem[at] != 0.0f) ? 1.0f : 0.0f;
    float v;
    if (j < 3) {
      v = __fmul_rn(m, 256.0f);
    } else if (j < 6) {
      v = m;
    } else {
      const float b = in ? img[at * 3 + (j - 6)] : 0.0f;
      v = __fmul_rn(-2.0f, __fmul_rn(b, m));
    }
    f[(static_cast<size_t>(ky) * tp + t) * kChannels + col] = __float2bfloat16_rn(v);
  }
  // b2: lane l holds slots l + 32 i of the (c, ky, kx) products, then the
  // halving tree x[i] + x[i + h] for h = 256 .. 1
  float v[kTree / 32];
#pragma unroll
  for (int i = 0; i < kTree / 32; ++i) {
    const int s = lane + 32 * i;
    v[i] = 0.0f;
    if (s < kPatch) {
      const int c = s / (kWindow * kWindow), r = s % (kWindow * kWindow);
      const int y = ty + r / kWindow - kHalf, x = tx + r % kWindow - kHalf;
      const bool in = y >= 0 && y < height && x >= 0 && x < width;
      const size_t at = static_cast<size_t>(y) * width + x;
      const float m = in && !(initial && rem[at] != 0.0f) ? 1.0f : 0.0f;
      const float b = in ? img[at * 3 + c] : 0.0f;
      v[i] = __fmul_rn(__fmul_rn(b, m), b);
    }
  }
#pragma unroll
  for (int h = kTree / 64; h >= 1; h /= 2)
#pragma unroll
    for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
  float s = v[0];
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
// onion peel seeded from outside the known islands.
int vip_wexler_ring_pick(const void* rem, const void* rem0, const void* island, void* tyx,
                         void* keys, void* state, int bh, int bw, int by0, int bx0, int width,
                         int cap, int tp, int mode, void* stream) {
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
  const int target_blocks = (cap + kTargetsPerBlock - 1) / kTargetsPerBlock;
  const int valid_blocks = (vh * vw + kFilterThreads - 1) / kFilterThreads;
  wexler_filters_kernel<<<target_blocks + valid_blocks, kFilterThreads, 0,
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
