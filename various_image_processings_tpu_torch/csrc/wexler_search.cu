// Wexler exemplar search for Hopper (sm_90a): a bf16 tensor-core product
// with a fused min / first-argmin epilogue.
//
// Replaces the TPU kernel various_image_processings_tpu/ops/pallas/wexler_search.py
// ::_make_kernel (:63).  For each target t it finds, over the candidates c
// (window top-lefts (cy, cx), flat index cy * n_cx + cx) whose 13 x 13 window
// misses the hole, the least
//     E'[c, t] = sum_ky sum_ch p[cy + ky, cx, ch] * f[ky, ch, t]
// and the lowest flat index that reaches it.  p holds the kx-packed planes
// of the image (models/inpainting.py::_build_p117, 117 channels zero-padded
// to 128), f the per-target filters.  Every entry is an integer of at most 9
// significant bits, so every product is exact in f32.
//
// What differs from the TPU kernel: the TPU version carries the validity in
// a 1e30 penalty channel, a Mosaic layout trick, and folds its blocks into
// one output block it revisits in grid order.  Here each CTA reads the
// validity map itself and skips invalid candidates, and CTAs, which run in
// no order, combine through one 64-bit atomicMin per target and candidate
// row: the key is (order-preserving bits of the energy) << 32 | flat index,
// so the minimum key is the lexicographic (energy, index) minimum whatever
// the order.  -0.0 is made +0.0 before packing (x + 0.0f): the two compare
// equal in the plain version, whose tie then goes to the lower index.
//
// Per CTA: 2 candidate rows x 64 candidates (128 rows of the product) by 128
// targets, 8 warps of 32 x 64, nvcuda::wmma bf16 16x16x16 fragments with
// f32 accumulators.  The reduction runs over ky = 0..12 and, for each, 8
// steps of 16 channels; the A tile for ky is the 64 contiguous pixels
// p[cy + ky, cx0 .. cx0 + 63, :] of each row, the B tile f[ky, :, t0 .. t0 + 127],
// both staged in shared memory with a padded pitch (272 B, so the 8 rows of
// a fragment load fall on distinct banks).  The accumulator tile then goes
// through shared memory, and each thread scans one target column of one
// candidate row in raster order.  The (ncand, T) energy matrix never
// reaches device memory.
//
// What bounds it on the card: at 402 x 700 and T = 1024, 2 * 268,320 * 1024 *
// 1521 = 8.4e11 useful FLOP against ~74 MB of p and f: the tensor cores
// (0.85 ms at the dense bf16 peak), not memory.  This first version stages
// each tile with plain loads and one barrier a step, with no pipelining, and
// uses mma.sync-class wmma, not wgmma; TMA, a multistage ring and wgmma are
// left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kChannels = 128;                     // 117 packed channels, zero-padded
constexpr int kRowsPerCta = 2;                     // candidate rows (cy)
constexpr int kColsPerCta = 64;                    // candidates (cx) of each row
constexpr int kTileM = kRowsPerCta * kColsPerCta;  // 128 candidates
constexpr int kTileN = 128;                        // targets
constexpr int kThreads = 256;                      // 8 warps: 4 along M x 2 along N
constexpr int kWarpM = 32;
constexpr int kWarpN = 64;
constexpr int kFragM = kWarpM / 16;
constexpr int kFragN = kWarpN / 16;
constexpr int kLdA = kChannels + 8;  // bf16 pitch of the A tile
constexpr int kLdB = kTileN + 8;     // bf16 pitch of the B tile
constexpr int kLdC = kTileN + 4;     // f32 pitch of the staged accumulators
constexpr int kBytesAB = (kTileM * kLdA + kChannels * kLdB) * 2;
constexpr int kBytesC = kTileM * kLdC * 4;
constexpr int kBytesTiles = kBytesAB > kBytesC ? kBytesAB : kBytesC;
constexpr int kSmemBytes = kBytesTiles + kTileM;  // + one validity byte a candidate
constexpr int kVec = 8;                           // bf16 in one 16-byte load

static_assert(kThreads == kRowsPerCta * kTileN, "one thread per (candidate row, target)");
static_assert(kWarpM * 4 == kTileM && kWarpN * 2 == kTileN, "8 warps cover the tile");

__device__ __forceinline__ unsigned long long pack_key(float e, unsigned idx) {
  const unsigned bits = __float_as_uint(__fadd_rn(e, 0.0f));  // -0.0 -> +0.0
  const unsigned ordered = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<unsigned long long>(ordered) << 32) | idx;
}

__global__ void __launch_bounds__(kThreads, 2)
wexler_search_kernel(const __nv_bfloat16* __restrict__ p,   // (height, n_cx, 128)
                     const __nv_bfloat16* __restrict__ f,   // (window, 128, tp)
                     const uint8_t* __restrict__ valid,     // (n_cy, n_cx)
                     unsigned long long* __restrict__ keys, // (tp,), all ones at entry
                     int window, int n_cy, int n_cx, int tp) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + kTileM * kLdA;
  float* c_s = reinterpret_cast<float*>(smem);  // reuses the A/B tiles after the loop
  uint8_t* ok_s = smem + kBytesTiles;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % 4;
  const int wn = warp / 4;
  const int t0 = blockIdx.x * kTileN;
  const int cx0 = blockIdx.y * kColsPerCta;
  const int cy0 = blockIdx.z * kRowsPerCta;

  int ok = 0;
  if (tid < kTileM) {
    const int cy = cy0 + tid / kColsPerCta;
    const int cx = cx0 + tid % kColsPerCta;
    ok = (cy < n_cy && cx < n_cx) ? valid[static_cast<size_t>(cy) * n_cx + cx] : 0;
    ok_s[tid] = static_cast<uint8_t>(ok != 0);
  }
  if (!__syncthreads_or(ok)) return;  // no valid candidate in this CTA

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int ky = 0; ky < window; ++ky) {
    // A: 128 candidates x 128 channels; padding candidates read as zeros
    for (int i = tid; i < kTileM * (kChannels / kVec); i += kThreads) {
      const int r = i / (kChannels / kVec);
      const int q = i % (kChannels / kVec);
      const int cy = cy0 + r / kColsPerCta;
      const int cx = cx0 + r % kColsPerCta;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (cy < n_cy && cx < n_cx) {
        v = __ldg(reinterpret_cast<const uint4*>(
            p + (static_cast<size_t>(cy + ky) * n_cx + cx) * kChannels + q * kVec));
      }
      *reinterpret_cast<uint4*>(a_s + r * kLdA + q * kVec) = v;
    }
    // B: 128 channels x 128 targets
    for (int i = tid; i < kChannels * (kTileN / kVec); i += kThreads) {
      const int k = i / (kTileN / kVec);
      const int q = i % (kTileN / kVec);
      *reinterpret_cast<uint4*>(b_s + k * kLdB + q * kVec) = __ldg(reinterpret_cast<const uint4*>(
          f + (static_cast<size_t>(ky) * kChannels + k) * tp + t0 + q * kVec));
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kChannels; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(a[i], a_s + (wm * kWarpM + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(b[j], b_s + kk * kLdB + wn * kWarpN + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j)
      wmma::store_matrix_sync(c_s + (wm * kWarpM + i * 16) * kLdC + wn * kWarpN + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();

  // one target column of one candidate row, in raster order: strict < keeps
  // the first minimum; the key's index breaks ties across rows and CTAs
  const int n = tid % kTileN;
  const int row = tid / kTileN;
  float best = 0.0f;
  int best_c = -1;
  for (int c = 0; c < kColsPerCta; ++c) {
    const int r = row * kColsPerCta + c;
    if (!ok_s[r]) continue;
    const float e = c_s[r * kLdC + n];
    if (best_c < 0 || e < best) {
      best = e;
      best_c = c;
    }
  }
  if (best_c >= 0) {
    const unsigned idx = static_cast<unsigned>((cy0 + row) * n_cx + cx0 + best_c);
    const unsigned long long key = pack_key(best, idx);
    unsigned long long* dst = keys + t0 + n;
    // keys only fall, so a stale read is never below the current minimum
    if (key < *reinterpret_cast<volatile unsigned long long*>(dst)) atomicMin(dst, key);
  }
}

}  // namespace

extern "C" {

// Targets per block: tp must be a multiple of it.
int vip_wexler_search_target_tile() { return kTileN; }

// p: (n_cy + window - 1, n_cx, 128) bf16; f: (window, 128, tp) bf16;
// valid: (n_cy, n_cx) u8; keys: (tp,) u64, every bit set.  Returns the
// launch's cudaError_t (0 on success).
int vip_wexler_search(const void* p, const void* f, const void* valid, void* keys, int window,
                      int n_cy, int n_cx, int tp, void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      wexler_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(tp / kTileN, (n_cx + kColsPerCta - 1) / kColsPerCta,
                  (n_cy + kRowsPerCta - 1) / kRowsPerCta);
  wexler_search_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(f),
      static_cast<const uint8_t*>(valid), static_cast<unsigned long long*>(keys), window,
      n_cy, n_cx, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
