// SLIC's connectivity pass on the card (reference include/cpp/slic.hpp:386-458,
// the euclidean metric): 4-connected components of a label map, their sizes
// and truncated Lab means, the merge of every component smaller than
// min_area into the neighbouring region of the nearest mean, and the regions
// numbered by their first pixel in raster order.  The labels never leave the
// card; one C call enqueues every kernel on one stream and never
// synchronizes.
//
// It replaces no TPU kernel: the JAX package runs this pass on the host
// (native C++ or NumPy), as the port did, with the labels and Lab image
// downloaded for it and the result uploaded.  Its bound is bytes: the labels
// and Lab read and the region ids written once, 11 B a pixel (0.027 ms for a
// 4K frame at 3.35 TB/s).  Most of its time goes to passes over the
// components that chase pointers, and to the merge, whose order is
// sequential within a cluster; what the design does about it is below.
//
// The merge is the host's rule (native/src/vip_native.cpp::
// vip_slic_connectivity, pass 3): components in id order, each small one at
// its turn taking the root of its region's neighbours whose mean is nearest
// (double arithmetic, ties to the lowest id), with the components' own sizes
// and means.  A small component is still its own root at its turn, and the
// roots it can meet are small components adjacent to small ones or big
// components, which never merge.  So the small components fall into
// clusters, joined by small-small adjacency, whose merges read nothing of
// another cluster's but the big components' fixed means; each cluster is
// merged by one group of threads (a warp, or a block for a cluster of more
// than kWarpMembers), independently of the others.  The block is for the
// cluster of nearly every component that SLIC leaves on noise: its window of
// 1,024 needs fewer rounds than a warp's 32 (on an H100, SLIC labels of 512²
// noise at S = 26: 16,985 rounds and 0.28 s against 59,655 and 0.59 s on
// warps alone; of 4K noise 2.35 s against 17.2 s; 256 threads: 0.30 s).
//
// Inside a cluster the group takes its members in ascending id, a window of
// as many as it has threads at a time, in rounds: each member of the window
// resolves its candidates against the committed state, and commits only if
// no resolution passed an uncommitted member of lower id (its decision is
// then the one the sequential loop makes at its turn: every member that
// could change it is committed).  The lowest member of the window always
// commits.  A member's region is its committed subtree of the merge forest;
// its neighbours come from its own list and from the candidate roots its
// committed children stored when they merged into it (resolved again at
// its turn), or, where a child could not store them (the arena full), from
// a walk of the subtree's members' own lists.

#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileW = 32;      // cc_tiles: one block of kTileW x kTileH threads a tile
constexpr int kTileH = 16;
constexpr int kBlock = 1024;    // the element-wise kernels: one element a thread
constexpr int kBlockShift = 10;
constexpr int kWarpMembers = 256;  // larger clusters are merged by a block
constexpr int kMergeWarps = 8;     // warps a block of cc_merge_warps
constexpr int kCache = 8;          // the candidates a member remembers to store each once
constexpr int kOpen = -2;          // par[] of a small component not yet committed

// the header: int32 slots; the first eight are counts a caller may read
// (ops/cuda/connectivity.py's HEADER), the rest the pass's own cursors
enum Slot {
  kComponents, kSmall, kClusters, kLargest, kRegions, kListEntries, kRounds, kOverflows,
  kArenaTop, kWarpQueue, kBlockQueue, kHeaderInts = 16
};

struct Layout {
  size_t comp, parent, lrank, acc_cnt, acc_lab, root_px, info, loff, lcnt, cpar, ccount, par,
      next, tail, pend, flag, regmin, bsum_a, bsum_b, bsum_d, lists, end;
  long long arena_ints;
};

// The workspace's regions, each on a 256-byte boundary.  Arrays of
// components are as long as the pixels (the most components a map can have).
// The five from parent to root_px are dead by the merge, which takes them as
// its arena (40 bytes a pixel); after it the pixels' roots become the
// regions' roots, and their ranks the regions' flags' ranks.
Layout layout(int height, int width) {
  const size_t n = static_cast<size_t>(height) * width;
  const size_t blocks = (n + kBlock - 1) / kBlock;
  Layout l{};
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t start = (at + 255) / 256 * 256;
    at = start + bytes;
    return start;
  };
  l.comp = take(4 * n);
  l.parent = take(4 * n);
  l.lrank = take(4 * n);
  l.acc_cnt = take(4 * n);
  l.acc_lab = take(24 * n);
  l.root_px = take(4 * n);
  l.info = take(16 * n);
  l.loff = take(4 * n);
  l.lcnt = take(4 * n);
  l.cpar = take(4 * n);
  l.ccount = take(4 * n);
  l.par = take(4 * n);
  l.next = take(4 * n);
  l.tail = take(4 * n);
  l.pend = take(4 * n);
  l.flag = take(4 * n);
  l.regmin = take(4 * n);
  l.bsum_a = take(4 * blocks);
  l.bsum_b = take(4 * blocks);
  l.bsum_d = take(4 * blocks);
  l.lists = take(16 * n + 256);  // the own lists: at most 2 size + 2 entries a component
  l.end = at;
  // chunk offsets and the arena's top are int32: at most 2^30 ints
  l.arena_ints = static_cast<long long>((l.root_px + 4 * n - l.parent) / 4);
  if (l.arena_ints > (1LL << 30)) l.arena_ints = 1LL << 30;
  return l;
}

// --- union-find with hooks of the larger root under the smaller (atomicMin):
// every pointer leads to a lower index, and a tree's root is its least index
__device__ __forceinline__ int find_root(const int* p, int x) {
  const volatile int* v = p;
  while (true) {
    const int q = v[x];
    if (q == x) return x;
    x = q;
  }
}

__device__ __forceinline__ void unite(int* p, int a, int b) {
  while (true) {
    a = find_root(p, a);
    b = find_root(p, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&p[a], b);
    if (old == a) return;
    a = old;  // a was hooked meanwhile: join its new parent to b
  }
}

// --- an exclusive sum over a 1D block (one value a thread); *total the sum
template <typename T>
__device__ T block_exclusive_sum(T v, T* total) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < warps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const T before = (warp > 0 ? warp_sums[warp - 1] : T(0)) + x - v;
  *total = warp_sums[warps - 1];
  __syncthreads();
  return before;
}

// Component ids are ranks among roots by raster index: root r's id is the
// exclusive sum over the blocks before r's (scanned in place) plus its rank
// in its block.
__device__ __forceinline__ int rank_of(const int* bscan, const int* lrank, int r) {
  return bscan[r >> kBlockShift] + lrank[r];
}

// The reference's euclidean distance between two components' truncated
// means, in double and rounded op by op as the host computes it: no FMA.
__device__ __forceinline__ double color_distance(int4 a, int4 b) {
  const double dl = __dmul_rn(static_cast<double>(a.x - b.x), 2.55);
  const double da = static_cast<double>(a.y - b.y);
  const double db = static_cast<double>(a.z - b.z);
  return __dadd_rn(__dadd_rn(__dmul_rn(dl, dl), __dmul_rn(da, da)), __dmul_rn(db, db));
}

// ---------------------------------------------------------------------------
// components
// ---------------------------------------------------------------------------

// Union-find of a tile's pixels in shared memory; each pixel's tree root, as
// a raster index, to parent.  A warp is a tile row: each pixel starts at the
// first pixel of its run of equal labels (by ballot), and only the first
// pixel of each stretch of a run that matches the row above is joined to
// it.  Block (0, 0) also clears the header.
__global__ void __launch_bounds__(kTileW * kTileH)
cc_tiles(const int* __restrict__ labels, int* __restrict__ parent, int* __restrict__ header,
         int height, int width) {
  __shared__ int lbl[kTileW * kTileH];
  __shared__ int p[kTileW * kTileH];
  const int lx = threadIdx.x, ly = threadIdx.y, l = ly * kTileW + lx;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + lx, y = y0 + ly;
  const bool inside = x < width && y < height;
  const int i = y * width + x;
  if (blockIdx.x == 0 && blockIdx.y == 0 && l < kHeaderInts) header[l] = 0;
  const int v = inside ? labels[i] : 0;
  lbl[l] = v;
  const int left = __shfl_up_sync(0xffffffffu, v, 1);
  const unsigned starts = __ballot_sync(0xffffffffu, !inside || lx == 0 || left != v);
  p[l] = ly * kTileW + 31 - __clz(starts & (0xffffffffu >> (31 - lx)));
  __syncthreads();
  if (inside && ly > 0 && lbl[l - kTileW] == v &&
      !(lx > 0 && left == v && lbl[l - kTileW - 1] == v))
    unite(p, l, l - kTileW);
  __syncthreads();
  if (inside) {
    const int r = find_root(p, l);
    parent[i] = (y0 + r / kTileW) * width + x0 + r % kTileW;
  }
}

// Union of equal-label neighbours across the tiles' left and top edges,
// skipping a pair whose neighbours along the edge (above, or to the left)
// are joined across it already through their own tiles.
__global__ void __launch_bounds__(kTileW * kTileH)
cc_border(const int* __restrict__ labels, int* parent, int height, int width) {
  const int x = blockIdx.x * kTileW + threadIdx.x, y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= width || y >= height || (threadIdx.x != 0 && threadIdx.y != 0)) return;
  const int i = y * width + x;
  const int v = labels[i];
  if (threadIdx.x == 0 && x > 0 && labels[i - 1] == v &&
      !(threadIdx.y > 0 && labels[i - width] == v && labels[i - width - 1] == v))
    unite(parent, i, i - 1);
  if (threadIdx.y == 0 && y > 0 && labels[i - width] == v &&
      !(threadIdx.x > 0 && labels[i - 1] == v && labels[i - width - 1] == v))
    unite(parent, i, i - width);
}

// Every pixel's root (the component's first pixel); each root's rank in its
// block, the block's count of roots, and the root's sums cleared.
__global__ void __launch_bounds__(kBlock)
cc_roots(int* parent, int* __restrict__ lrank, int* __restrict__ bsum, int* __restrict__ acc_cnt,
         unsigned long long* __restrict__ acc_lab, int n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  int is_root = 0;
  if (i < n) {
    const int r = find_root(parent, i);
    parent[i] = r;
    is_root = r == i;
    if (is_root) {
      acc_cnt[i] = 0;
      acc_lab[3LL * i] = acc_lab[3LL * i + 1] = acc_lab[3LL * i + 2] = 0;
    }
  }
  int total;
  const int before = block_exclusive_sum(is_root, &total);
  if (is_root) lrank[i] = before;
  if (threadIdx.x == 0) bsum[blockIdx.x] = total;
}

// An exclusive sum of count ints in place, one block; the sum to *total.
__global__ void __launch_bounds__(kBlock) cc_scan(int* vals, int count, int* total_out) {
  const int per = (count + kBlock - 1) / kBlock;
  const int begin = min(count, static_cast<int>(threadIdx.x) * per);
  const int end = min(count, begin + per);
  int s = 0;
  for (int j = begin; j < end; ++j) s += vals[j];
  int total;
  int at = block_exclusive_sum(s, &total);
  for (int j = begin; j < end; ++j) {
    const int v = vals[j];
    vals[j] = at;
    at += v;
  }
  if (threadIdx.x == 0) *total_out = total;
}

// Each pixel's component id; each component's first pixel; the pixel count
// and Lab sums of each root, summed first over the warp's pixels of one
// component (fields of 8 and 16 bits hold 32 pixels' counts and values).
__global__ void __launch_bounds__(kBlock)
cc_sums(const int* __restrict__ parent, const int* __restrict__ lrank,
        const int* __restrict__ bscan, const unsigned char* __restrict__ lab,
        int* __restrict__ comp, int* __restrict__ root_px, int* __restrict__ acc_cnt,
        unsigned long long* __restrict__ acc_lab, int n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  int key = -1;
  unsigned long long packed = 0;
  if (i < n) {
    const int r = parent[i];
    const int c = rank_of(bscan, lrank, r);
    comp[i] = c;
    if (r == i) root_px[c] = i;
    key = r;
    const unsigned char* px = lab + 3LL * i;
    packed = 1ull | (static_cast<unsigned long long>(px[0]) << 8) |
             (static_cast<unsigned long long>(px[1]) << 24) |
             (static_cast<unsigned long long>(px[2]) << 40);
  }
  const auto warp = cg::tiled_partition<32>(cg::this_thread_block());
  const auto group = cg::labeled_partition(warp, key);
  const unsigned long long s = cg::reduce(group, packed, cg::plus<unsigned long long>());
  if (group.thread_rank() == 0 && key >= 0) {
    atomicAdd(&acc_cnt[key], static_cast<int>(s & 0xff));
    atomicAdd(&acc_lab[3LL * key], (s >> 8) & 0xffff);
    atomicAdd(&acc_lab[3LL * key + 1], (s >> 24) & 0xffff);
    atomicAdd(&acc_lab[3LL * key + 2], (s >> 40) & 0xffff);
  }
}

// ---------------------------------------------------------------------------
// small components, their neighbours and clusters
// ---------------------------------------------------------------------------

struct State {
  int4* info;  // truncated Lab means and size
  int* loff;   // own list offset in its block (then + the block's scanned base)
  int* lbase;  // the scanned bases of the list offsets, a block each
  int* lcnt;   // own list entries
  int* lists;
  int* cpar;    // cluster union-find; members point at the cluster's root after cc_clusters
  int* ccount;  // members of each cluster, at its root
  int* par;     // merge forest: kOpen, -1 (a root for good) or the component merged into
  int* next;    // each region's chain of members, for the arena's fallback
  int* tail;
  int* pend;  // the first of the chunks stored for a member by its children, or -1
  int* flag;  // a child could not store its chunk: walk the subtree
  int* arena;
  long long arena_ints;
  int* header;
  int ncomp;
  long long min_area;
};

// Each component's size and means, small flag, list room (2 size + 2: a
// small component's perimeter), its rank among the block's list rooms, and
// the merge state cleared.
__global__ void __launch_bounds__(kBlock)
cc_small(const int* __restrict__ root_px, const int* __restrict__ acc_cnt,
         const unsigned long long* __restrict__ acc_lab, State s, int* __restrict__ regmin,
         int* __restrict__ bsum) {
  const int c = blockIdx.x * kBlock + threadIdx.x;
  const int ncomp = s.header[kComponents];
  int room = 0, small = 0;
  if (c < ncomp) {
    const int r = root_px[c];
    const int size = acc_cnt[r];
    const unsigned long long sz = static_cast<unsigned long long>(size);
    s.info[c] = make_int4(static_cast<int>(acc_lab[3LL * r] / sz),
                          static_cast<int>(acc_lab[3LL * r + 1] / sz),
                          static_cast<int>(acc_lab[3LL * r + 2] / sz), size);
    small = size < s.min_area;
    room = small ? 2 * size + 2 : 0;
    s.cpar[c] = c;
    s.ccount[c] = 0;
    s.lcnt[c] = 0;
    s.par[c] = small ? kOpen : -1;
    s.next[c] = -1;
    s.tail[c] = c;
    s.pend[c] = -1;
    s.flag[c] = 0;
    regmin[c] = INT_MAX;
  }
  int total;
  const int before = block_exclusive_sum(room, &total);
  if (c < ncomp) s.loff[c] = before;
  if (threadIdx.x == 0) bsum[blockIdx.x] = total;
  int smalls;
  block_exclusive_sum(small, &smalls);
  if (threadIdx.x == 0 && smalls) atomicAdd(&s.header[kSmall], smalls);
}

__device__ __forceinline__ bool is_small(const State& s, int c) {
  return s.info[c].w < s.min_area;
}

__device__ __forceinline__ void append(const State& s, int c, int v) {
  const int slot = s.lbase[c >> kBlockShift] + s.loff[c] + atomicAdd(&s.lcnt[c], 1);
  s.lists[slot] = v;
}

// For each pair of 4-neighbours in different components: each small one
// lists the other (once a boundary edge), and two small ones join a cluster.
__global__ void __launch_bounds__(kBlock)
cc_edges(const int* __restrict__ comp, State s, int height, int width) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= height * width) return;
  const int c = comp[i];
  const bool sc = is_small(s, c);
  const int x = i % width;
  const int y = i / width;
  int nb[2], k = 0;
  if (x + 1 < width) nb[k++] = comp[i + 1];
  if (y + 1 < height) nb[k++] = comp[i + width];
  for (int j = 0; j < k; ++j) {
    const int d = nb[j];
    if (d == c) continue;
    const bool sd = is_small(s, d);
    if (sc) append(s, c, d);
    if (sd) append(s, d, c);
    if (sc && sd) unite(s.cpar, c, d);
  }
}

// Each small component's cluster root (its least member), and the members
// counted at the root.
__global__ void __launch_bounds__(kBlock) cc_clusters(State s) {
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= s.header[kComponents] || !is_small(s, c)) return;
  const int k = find_root(s.cpar, c);
  s.cpar[c] = k;
  atomicAdd(&s.ccount[k], 1);
}

// ---------------------------------------------------------------------------
// the merge
// ---------------------------------------------------------------------------

// A group of threads that merges one cluster: a warp or a block, with its
// shared memory for the window (kSize ints) and two more ints.
struct WarpGroup {
  static constexpr int kSize = 32;
  int rank;
  int* smem;
  __device__ void sync() const { __syncwarp(); }
  __device__ int exclusive_sum(int v, int* total) const {
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (rank >= o) x += y;
    }
    *total = __shfl_sync(0xffffffffu, x, 31);
    return x - v;
  }
  __device__ int broadcast(int v, int from) const { return __shfl_sync(0xffffffffu, v, from); }
};

struct BlockGroup {
  static constexpr int kSize = kBlock;
  int rank;
  int* smem;
  __device__ void sync() const { __syncthreads(); }
  __device__ int exclusive_sum(int v, int* total) const { return block_exclusive_sum(v, total); }
  __device__ int broadcast(int v, int from) const {
    if (rank == from) smem[kSize] = v;
    __syncthreads();
    const int got = smem[kSize];
    __syncthreads();
    return got;
  }
};

struct Decision {
  bool blocked;
  int blocker;  // the uncommitted component that blocked
  int best;
  double best_d;
  int count;  // distinct candidates, as the store pass writes them
};

// Resolve every neighbour of me's committed region against the committed
// state, as the sequential loop would at me's turn: a neighbour's root is
// the first component on its path that is me or later, a big component, or
// a small one that found no neighbour.  A path through an uncommitted
// component before me blocks me (d.blocker).  Paths are shortened through
// components before lo, the window's least, which every later reader passes
// too.
// kStore: write the distinct candidates (as far as the last kCache tell) to
// out, in the order the count pass met them.
template <bool kStore>
__device__ void resolve(const State& s, int me, int lo, Decision& d, int* out) {
  const int4 mine = s.info[me];
  int cache[kCache];
#pragma unroll
  for (int j = 0; j < kCache; ++j) cache[j] = -1;
  d.blocked = false;
  d.blocker = -1;
  d.best = -1;
  d.best_d = 0.0;
  d.count = 0;
  auto visit = [&](int v) -> bool {
    int r = v;
    while (r < me) {
      const int pr = s.par[r];
      if (pr == kOpen) {
        d.blocker = r;
        return false;
      }
      if (pr < 0) break;
      if (pr < lo) {
        const int pp = s.par[pr];
        if (pp >= 0) s.par[r] = pp;
      }
      r = pr;
    }
    if (r == me) return true;
    bool seen = false;
#pragma unroll
    for (int j = 0; j < kCache; ++j) seen |= cache[j] == r;
    if (!seen) {
#pragma unroll
      for (int j = kCache - 1; j > 0; --j) cache[j] = cache[j - 1];
      cache[0] = r;
      if (kStore) out[d.count] = r;
      ++d.count;
    }
    if (!kStore) {
      const double dist = color_distance(mine, s.info[r]);
      if (d.best < 0 || dist < d.best_d || (dist == d.best_d && r < d.best)) {
        d.best_d = dist;
        d.best = r;
      }
    }
    return true;
  };
  auto own = [&](int m) -> bool {
    const int* list = s.lists + s.lbase[m >> kBlockShift] + s.loff[m];
    const int cnt = s.lcnt[m];
    for (int j = 0; j < cnt; ++j)
      if (!visit(list[j])) return false;
    return true;
  };
  if (s.flag[me]) {
    for (int m = me; m != -1; m = s.next[m])
      if (!own(m)) {
        d.blocked = true;
        return;
      }
    return;
  }
  if (!own(me)) {
    d.blocked = true;
    return;
  }
  for (int ch = s.pend[me]; ch != -1; ch = s.arena[ch]) {
    const int cnt = s.arena[ch + 1];
    const int* entries = s.arena + ch + 2;
    for (int j = 0; j < cnt; ++j)
      if (!visit(entries[j])) {
        d.blocked = true;
        return;
      }
  }
}

// Merge the cluster rooted at k (n members) with the group g.
template <typename Group>
__device__ void merge_cluster(const Group& g, const State& s, int k, int n) {
  constexpr int W = Group::kSize;
  int* win = g.smem;  // W ints: the window's exchange; [W + 1] the next id to scan
  if (g.rank == 0) {
    atomicAdd(&s.header[kClusters], 1);
    atomicMax(&s.header[kLargest], n);
  }
  // each thread's member of the window, and what blocked it last: while
  // that is uncommitted, the member is still blocked (its path to it
  // neither changes nor is shortened past it)
  int mine = -1, blocker = -1, w = 0, found = 0, cursor = k, rounds = 0;
  while (true) {
    // refill the window with the next members in ascending id
    while (w < W && found < n && cursor < s.ncomp) {
      const int id = cursor + g.rank;
      const int is = id < s.ncomp && s.cpar[id] == k;
      int nfound;
      const int pos = g.exclusive_sum(is, &nfound);
      const int take = min(nfound, W - w);
      if (is && pos < take) win[w + pos] = id;
      if (is && nfound > take && pos == take - 1) win[W + 1] = id + 1;
      g.sync();
      if (g.rank >= w && g.rank < w + take) {
        mine = win[g.rank];
        blocker = -1;
      }
      // past the last member taken, or past the ids read
      cursor = nfound > take ? win[W + 1] : cursor + W;
      g.sync();
      found += take;
      w += take;
    }
    if (w == 0) break;
    ++rounds;
    const int lo = g.broadcast(mine, 0);
    const bool active = g.rank < w;
    Decision d{true, blocker, -1, 0.0, 0};
    if (active && (blocker < 0 || s.par[blocker] != kOpen))
      resolve<false>(s, mine, lo, d, nullptr);
    const bool commits = active && !d.blocked;
    const bool stores = commits && d.best >= 0 && d.best > mine && is_small(s, d.best);
    g.sync();
    // the arena: one allocation for the group's stored chunks of the round
    const int need = stores ? d.count + 2 : 0;
    int total;
    const int off = g.exclusive_sum(need, &total);
    int base = 0;
    if (g.rank == 0 && total > 0) {
      // past the arena's end nothing more is taken: the top cannot wrap
      const int top = *static_cast<volatile int*>(&s.header[kArenaTop]);
      base = top < s.arena_ints ? atomicAdd(&s.header[kArenaTop], total) : top;
    }
    base = g.broadcast(base, 0);
    const long long at = static_cast<long long>(base) + off;
    const bool stored = stores && at + need <= s.arena_ints;
    if (stored) {
      Decision again;
      resolve<true>(s, mine, lo, again, s.arena + at + 2);
      s.arena[at + 1] = again.count;
    }
    g.sync();
    // commit
    if (commits) {
      s.par[mine] = d.best;
      if (stores) {
        const int old = atomicExch(&s.next[d.best], mine);
        s.next[s.tail[mine]] = old;
        if (old == -1) s.tail[d.best] = s.tail[mine];
        if (stored) {
          s.arena[at] = atomicExch(&s.pend[d.best], static_cast<int>(at));
        } else {
          s.flag[d.best] = 1;
          atomicAdd(&s.header[kOverflows], 1);
        }
      }
    }
    g.sync();
    // keep the blocked members, in order
    const int keep = active && d.blocked;
    int kept;
    const int pos = g.exclusive_sum(keep, &kept);
    if (keep) win[pos] = mine;
    g.sync();
    mine = g.rank < kept ? win[g.rank] : -1;
    g.sync();
    if (keep) win[pos] = d.blocker;
    g.sync();
    blocker = g.rank < kept ? win[g.rank] : -1;
    w = kept;
    g.sync();
  }
  if (g.rank == 0) atomicMax(&s.header[kRounds], rounds);
}

// Clusters of at most kWarpMembers, a warp each; warps take 32 component ids
// at a time from a queue and merge the cluster roots among them in order.
// A cluster of one (a small component with no small neighbour: its
// candidates are big, so nothing can block it) is merged by its own lane,
// all of the chunk's at once.
__global__ void __launch_bounds__(32 * kMergeWarps) cc_merge_warps(State s) {
  __shared__ int smem[kMergeWarps][WarpGroup::kSize + 2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const WarpGroup g{lane, smem[warp]};
  s.ncomp = s.header[kComponents];
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&s.header[kWarpQueue], 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= s.ncomp) return;
    const int id = base + lane;
    bool root = false;
    int n = 0;
    if (id < s.ncomp && s.cpar[id] == id && is_small(s, id)) {
      n = s.ccount[id];
      root = n <= kWarpMembers;
    }
    const bool single = root && n == 1;
    if (single) {
      Decision d;
      resolve<false>(s, id, id, d, nullptr);
      s.par[id] = d.best;
    }
    const unsigned singles = __ballot_sync(0xffffffffu, single);
    if (lane == 0 && singles) {
      atomicAdd(&s.header[kClusters], __popc(singles));
      atomicMax(&s.header[kLargest], 1);
      atomicMax(&s.header[kRounds], 1);
    }
    unsigned roots = __ballot_sync(0xffffffffu, root && !single);
    while (roots) {
      const int j = __ffs(roots) - 1;
      roots &= roots - 1;
      merge_cluster(g, s, base + j, __shfl_sync(0xffffffffu, n, j));
    }
  }
}

// Clusters of more than kWarpMembers, a block each.
__global__ void __launch_bounds__(kBlock) cc_merge_blocks(State s) {
  __shared__ int smem[kBlock + 2];
  __shared__ int roots[kBlock];
  __shared__ int sizes[kBlock];
  __shared__ int queued;
  const BlockGroup g{static_cast<int>(threadIdx.x), smem};
  s.ncomp = s.header[kComponents];
  while (true) {
    if (threadIdx.x == 0) queued = atomicAdd(&s.header[kBlockQueue], kBlock);
    __syncthreads();
    const int base = queued;
    __syncthreads();
    if (base >= s.ncomp) return;
    const int id = base + threadIdx.x;
    int n = 0;
    if (id < s.ncomp && s.cpar[id] == id && is_small(s, id)) n = s.ccount[id];
    const int root = n > kWarpMembers;
    int count;
    const int pos = block_exclusive_sum(root, &count);
    if (root) {
      roots[pos] = id;
      sizes[pos] = n;
    }
    __syncthreads();
    for (int j = 0; j < count; ++j) merge_cluster(g, s, roots[j], sizes[j]);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the regions
// ---------------------------------------------------------------------------

// Each component's region root, and each region's least member.
__global__ void __launch_bounds__(kBlock)
cc_region_roots(int* par, const int* __restrict__ header, int* __restrict__ regroot,
                int* __restrict__ regmin) {
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= header[kComponents]) return;
  int r = c;
  while (par[r] >= 0) r = par[r];
  if (r != c) par[c] = r;
  regroot[c] = r;
  atomicMin(&regmin[r], c);
}

// Each region's least member flagged and ranked in its block.
__global__ void __launch_bounds__(kBlock)
cc_region_flags(const int* __restrict__ header, const int* __restrict__ regroot,
                const int* __restrict__ regmin, int* __restrict__ lrank,
                int* __restrict__ bsum) {
  const int c = blockIdx.x * kBlock + threadIdx.x;
  const int first = c < header[kComponents] && regmin[regroot[c]] == c;
  int total;
  const int before = block_exclusive_sum(first, &total);
  if (first) lrank[c] = before;
  if (threadIdx.x == 0) bsum[blockIdx.x] = total;
}

// Each pixel's region id: the rank of its region's least member.
__global__ void __launch_bounds__(kBlock)
cc_relabel(const int* __restrict__ comp, const int* __restrict__ regroot,
           const int* __restrict__ regmin, const int* __restrict__ lrank,
           const int* __restrict__ bscan, int* __restrict__ out, int n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  out[i] = rank_of(bscan, lrank, regmin[regroot[comp[i]]]);
}

}  // namespace

extern "C" {

// Bytes of the workspace vip_cc_pass takes for a height x width map.
long long vip_cc_workspace_bytes(int height, int width) {
  return static_cast<long long>(layout(height, width).end);
}

// labels: (height, width) int32; lab: (height, width, 3) u8; out: (height,
// width) int32 region ids; header: 16 int32 (ncomp, small components,
// clusters, the largest cluster's members, regions, list entries, the most
// rounds a cluster took, children that found the arena full, then the
// pass's own counters); workspace: vip_cc_workspace_bytes.  height * width
// must be below 2^29.  Stops at the first launch that fails and returns its
// cudaError_t (0 when every launch went in); *launched is the number of
// kernels enqueued.
int vip_cc_pass(const void* labels, const void* lab, void* out, void* header, void* workspace,
                int height, int width, long long min_area, void* stream, int* launched) {
  *launched = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout l = layout(height, width);
  char* ws = static_cast<char*>(workspace);
  const int n = height * width;
  const int blocks = (n + kBlock - 1) / kBlock;
  int* hdr = static_cast<int*>(header);
  int* parent = reinterpret_cast<int*>(ws + l.parent);
  int* lrank = reinterpret_cast<int*>(ws + l.lrank);
  int* comp = reinterpret_cast<int*>(ws + l.comp);
  int* acc_cnt = reinterpret_cast<int*>(ws + l.acc_cnt);
  auto* acc_lab = reinterpret_cast<unsigned long long*>(ws + l.acc_lab);
  int* root_px = reinterpret_cast<int*>(ws + l.root_px);
  int* regmin = reinterpret_cast<int*>(ws + l.regmin);
  int* bsum_a = reinterpret_cast<int*>(ws + l.bsum_a);
  int* bsum_b = reinterpret_cast<int*>(ws + l.bsum_b);
  int* bsum_d = reinterpret_cast<int*>(ws + l.bsum_d);
  State s{};
  s.info = reinterpret_cast<int4*>(ws + l.info);
  s.loff = reinterpret_cast<int*>(ws + l.loff);
  s.lbase = bsum_b;
  s.lcnt = reinterpret_cast<int*>(ws + l.lcnt);
  s.lists = reinterpret_cast<int*>(ws + l.lists);
  s.cpar = reinterpret_cast<int*>(ws + l.cpar);
  s.ccount = reinterpret_cast<int*>(ws + l.ccount);
  s.par = reinterpret_cast<int*>(ws + l.par);
  s.next = reinterpret_cast<int*>(ws + l.next);
  s.tail = reinterpret_cast<int*>(ws + l.tail);
  s.pend = reinterpret_cast<int*>(ws + l.pend);
  s.flag = reinterpret_cast<int*>(ws + l.flag);
  s.arena = reinterpret_cast<int*>(ws + l.parent);  // dead by the merge, to root_px's end
  s.arena_ints = l.arena_ints;
  s.header = hdr;
  s.ncomp = 0;  // each kernel reads it from the header
  const long long most = static_cast<long long>(n) + 1;
  s.min_area = min_area < 0 ? 0 : (min_area > most ? most : min_area);

  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cc_merge_warps,
                                                         32 * kMergeWarps, 0);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 tiles((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  const dim3 tile_threads(kTileW, kTileH);
  auto step = [&]() -> int {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    return 0;
  };
  int e;
  cc_tiles<<<tiles, tile_threads, 0, st>>>(static_cast<const int*>(labels), parent, hdr, height,
                                          width);
  if ((e = step())) return e;
  cc_border<<<tiles, tile_threads, 0, st>>>(static_cast<const int*>(labels), parent, height,
                                           width);
  if ((e = step())) return e;
  cc_roots<<<blocks, kBlock, 0, st>>>(parent, lrank, bsum_a, acc_cnt, acc_lab, n);
  if ((e = step())) return e;
  cc_scan<<<1, kBlock, 0, st>>>(bsum_a, blocks, hdr + kComponents);
  if ((e = step())) return e;
  cc_sums<<<blocks, kBlock, 0, st>>>(parent, lrank, bsum_a,
                                     static_cast<const unsigned char*>(lab), comp, root_px,
                                     acc_cnt, acc_lab, n);
  if ((e = step())) return e;
  cc_small<<<blocks, kBlock, 0, st>>>(root_px, acc_cnt, acc_lab, s, regmin, bsum_b);
  if ((e = step())) return e;
  cc_scan<<<1, kBlock, 0, st>>>(bsum_b, blocks, hdr + kListEntries);
  if ((e = step())) return e;
  cc_edges<<<blocks, kBlock, 0, st>>>(comp, s, height, width);
  if ((e = step())) return e;
  cc_clusters<<<blocks, kBlock, 0, st>>>(s);
  if ((e = step())) return e;
  cc_merge_warps<<<sms * (per_sm > 0 ? per_sm : 1), 32 * kMergeWarps, 0, st>>>(s);
  if ((e = step())) return e;
  cc_merge_blocks<<<sms, kBlock, 0, st>>>(s);
  if ((e = step())) return e;
  int* regroot = parent;  // the pixels' roots are dead by now
  int* lrank2 = lrank;
  cc_region_roots<<<blocks, kBlock, 0, st>>>(s.par, hdr, regroot, regmin);
  if ((e = step())) return e;
  cc_region_flags<<<blocks, kBlock, 0, st>>>(hdr, regroot, regmin, lrank2, bsum_d);
  if ((e = step())) return e;
  cc_scan<<<1, kBlock, 0, st>>>(bsum_d, blocks, hdr + kRegions);
  if ((e = step())) return e;
  cc_relabel<<<blocks, kBlock, 0, st>>>(comp, regroot, regmin, lrank2, bsum_d,
                                        static_cast<int*>(out), n);
  if ((e = step())) return e;
  return 0;
}

}  // extern "C"
