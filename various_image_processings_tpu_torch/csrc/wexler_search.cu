// Wexler exemplar search for Hopper (sm_90a): a bf16 wgmma product fed by
// TMA through an mbarrier ring, with a fused min / first-argmin epilogue.
//
// Replaces the TPU kernel various_image_processings_tpu/ops/pallas/wexler_search.py
// ::_make_kernel (:63).  For each target t it finds, over the candidates c
// (window top-lefts (cy, cx), flat index cy * n_cx + cx) whose 13 x 13 window
// misses the hole, the least
//     E'[c, t] = sum_ky sum_ch p[cy + ky, cx, ch] * f[ky, ch, t]
// and the lowest flat index that reaches it.  p holds the kx-packed planes
// of the image (models/inpainting.py::_build_p117, 117 channels zero-padded
// to 128), f the per-target filters, stored here target-major (ky, t, ch) so
// that both operands are K-major.  Every entry is an integer of at most 9
// significant bits, so every product is exact in f32.
//
// What differs from the TPU kernel: the TPU version carries the validity in
// a 1e30 penalty channel, a Mosaic layout trick, and folds its blocks into
// one output block it revisits in grid order.  Here each CTA reads the
// validity map itself and skips invalid candidates, and CTAs, which run in
// no order, combine through one 64-bit atomicMin per target: the key is
// (order-preserving bits of the energy) << 32 | flat index, so the minimum
// key is the lexicographic (energy, index) minimum whatever the order.
// -0.0 is made +0.0 before packing (x + 0.0f): the two compare equal in the
// plain version, whose tie then goes to the lower index.  A CTA whose
// candidates are all invalid returns before it loads anything, and so does
// every CTA when the fill loop's active flag (csrc/wexler_fill.cu) is 0.
//
// Per CTA: R = 4 candidate rows x 64 candidates by N = 128 targets.  Like the
// TPU kernel, which stages ROW_BLK + window - 1 image rows once, the CTA
// reuses image rows across ky: candidate row r at step ky reads the A slice
// p[cy0 + r + ky, cx0 .. cx0 + 63, :] (16 KB), which row r + 1 read at step
// ky - 1.  So a ring of R - 1 + stages slices stays in shared memory, each
// ky step loads ONE new slice (R at the first step) and the B tile
// f[ky, t0 .. t0 + 127, :] (32 KB), and each candidate row points its wgmma
// A descriptor at ring slot (r + ky) mod ring.  One producer warp issues the
// TMA loads (128-byte swizzle, two 64-channel boxes a tile, out-of-range
// rows and columns zero-filled) up to 3 steps ahead, behind full / empty
// mbarriers; two consumer warpgroups each run m64n128k16 wgmma for 2
// candidate rows (2 x 64 f32 accumulators a thread) straight from shared
// memory, 16 products a ky step, and release the step's stage when they
// are done.  The (ncand, T) energy matrix never leaves the
// registers: each thread scans its 4 candidates of each of its 32 target
// columns in raster order, the warp reduces the packed keys with shuffles,
// the CTA with shared-memory atomicMin, and one thread a target combines
// with the other CTAs in global memory.
//
// Why R = 4 and N = 128: the accumulators of R x 64 x N pairs have to fit in
// the registers of two warpgroups (R x N = 512 at 128 a thread), and the
// ring of R - 1 + 3 slices plus 3 B stages in the 227 KB of shared memory
// (192 KB here).  Per CTA the tiles bring (R + 12) x 16 KB of A and 13 x 32 KB
// of B from L2 for R x 64 x N pairs: 20.5 bytes a pair, so at 402 x 700 and
// T = 1024 (8,624 CTAs) about 5.8 GB of L2-to-SM traffic a call, against
// ~14 GB for the first version (2 rows a CTA, A reloaded for each row at
// every ky).  N = 128 keeps wgmma's shared-memory reads (2 KB of A and 4 KB
// of B per 64 x 128 x 16 product) under the SM's 128 bytes a clock, which a
// narrower N would not.  Targets are padded to 128, so T = 16 does the work
// of T = 128.
//
// What bounds it on the card: at 402 x 700 and T = 1024, 2 * 268,320 * 1024 *
// 1521 = 8.4e11 useful FLOP against ~74 MB of p and f: the tensor cores
// (0.85 ms at the dense bf16 peak), not device memory.  Padding K from 1521
// to 1664 and the zero rows of partial tiles add ~10% of products; the
// shared-memory reads of wgmma, the L2 traffic above and the epilogue
// (~10% of a CTA's time, not overlapped: one CTA an SM) keep it below that
// peak.

#include <cuda.h>  // CUtensorMap and the driver's types; the entry point comes through the runtime
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 128;                // 117 packed channels, zero-padded
constexpr int kHalfK = 64;                    // channels in one 128-byte swizzle row
constexpr int kCols = 64;                     // candidates (cx) of a candidate row: wgmma M
constexpr int kRows = 4;                      // candidate rows (cy) of a CTA
constexpr int kTileN = 128;                   // targets of a CTA: wgmma N
constexpr int kStages = 3;                    // ky steps in flight
constexpr int kRing = kRows - 1 + kStages;    // A slices resident
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kRowsPerGroup = kRows / kConsumers;
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 32;  // + one producer warp
constexpr int kAccum = kTileN / 2;            // f32 accumulators a thread per candidate row
constexpr int kKSteps = kChannels / 16;       // wgmma k16 steps a ky step

constexpr int kSliceBytes = kCols * kChannels * 2;      // 16 KB
constexpr int kBTileBytes = kTileN * kChannels * 2;     // 32 KB
constexpr int kOffB = kRing * kSliceBytes;
constexpr int kOffKeys = kOffB + kStages * kBTileBytes;
constexpr int kOffBars = kOffKeys + kTileN * 8;
constexpr int kOffOk = kOffBars + 2 * kStages * 8;
constexpr int kSmemBytes = kOffOk + kRows * kCols + 1024;  // + slack to align the base to 1024

static_assert(kRows * kCols <= kThreads, "one thread loads each candidate's validity");
static_assert(kTileN <= 128, "the first consumer warpgroup writes one key a target");
static_assert(kSliceBytes % 1024 == 0 && kBTileBytes % 1024 == 0, "swizzle atoms stay aligned");

constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)  // start address
         | (1ull << 16)                                 // leading offset (unused here)
         | (static_cast<uint64_t>(1024 >> 4) << 32)    // stride between 8-row atoms
         | (1ull << 62);                                // 128-byte swizzle
}

__device__ __forceinline__ void fence_accum(float (&d)[kAccum]) {
#pragma unroll
  for (int i = 0; i < kAccum; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kAccum], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ unsigned long long pack_key(float e, unsigned idx) {
  const unsigned bits = __float_as_uint(__fadd_rn(e, 0.0f));  // -0.0 -> +0.0
  const unsigned ordered = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<unsigned long long>(ordered) << 32) | idx;
}

__global__ void __launch_bounds__(kThreads, 1)
wexler_search_kernel(const __grid_constant__ CUtensorMap map_p,  // (height, n_cx, 128) bf16
                     const __grid_constant__ CUtensorMap map_f,  // (window, tp, 128) bf16
                     const uint8_t* __restrict__ valid,          // (n_cy, n_cx)
                     unsigned long long* __restrict__ keys,      // (tp,), all ones at entry
                     const int* __restrict__ active,             // null, or 0: return at once
                     int window, int n_cy, int n_cx) {
  if (active != nullptr && *active == 0) return;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t a_base = smem_u32(smem);
  const uint32_t b_base = a_base + kOffB;
  auto* keys_s = reinterpret_cast<unsigned long long*>(smem + kOffKeys);
  const uint32_t full_bar = a_base + kOffBars;             // kStages barriers, 8 bytes each
  const uint32_t empty_bar = full_bar + kStages * 8;
  uint8_t* ok_s = smem + kOffOk;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t0 = blockIdx.x * kTileN;
  const int cx0 = blockIdx.y * kCols;
  const int cy0 = blockIdx.z * kRows;

  int ok = 0;
  if (tid < kRows * kCols) {
    const int cy = cy0 + tid / kCols;
    const int cx = cx0 + tid % kCols;
    ok = (cy < n_cy && cx < n_cx) ? valid[static_cast<size_t>(cy) * n_cx + cx] != 0 : 0;
    ok_s[tid] = static_cast<uint8_t>(ok);
  }
  if (tid < kTileN) keys_s[tid] = kNoKey;
  if (tid == 0) {
    for (int q = 0; q < kStages; ++q) {
      mbar_init(full_bar + 8 * q, 1);                   // the producer's arrive + bytes
      mbar_init(empty_bar + 8 * q, kConsumerThreads / 32);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (!__syncthreads_or(ok)) return;  // no valid candidate in this CTA

  if (warp == kConsumerThreads / 32) {
    // producer: one thread issues every load
    if (lane == 0) {
      for (int j = 0; j < window; ++j) {
        const int q = j % kStages;
        if (j >= kStages) mbar_wait(empty_bar + 8 * q, ((j / kStages) + 1) & 1);
        const int first = j == 0 ? 0 : j + kRows - 1;  // A slices of this step
        const int last = j + kRows - 1;
        mbar_expect_tx(full_bar + 8 * q, (last - first + 1) * kSliceBytes + kBTileBytes);
        for (int s = first; s <= last; ++s) {
          const uint32_t dst = a_base + (s % kRing) * kSliceBytes;
          tma_load(dst, &map_p, full_bar + 8 * q, 0, cx0, cy0 + s);
          tma_load(dst + kSliceBytes / 2, &map_p, full_bar + 8 * q, kHalfK, cx0, cy0 + s);
        }
        const uint32_t dst = b_base + q * kBTileBytes;
        tma_load(dst, &map_f, full_bar + 8 * q, 0, t0, j);
        tma_load(dst + kBTileBytes / 2, &map_f, full_bar + 8 * q, kHalfK, t0, j);
      }
    }
    return;
  }

  // consumers: warpgroup g takes candidate rows g * kRowsPerGroup + rr
  const int g = warp / 4;
  float acc[kRowsPerGroup][kAccum];
#pragma unroll
  for (int rr = 0; rr < kRowsPerGroup; ++rr)
#pragma unroll
    for (int i = 0; i < kAccum; ++i) acc[rr][i] = 0.0f;

  for (int j = 0; j < window; ++j) {
    const int q = j % kStages;
    mbar_wait(full_bar + 8 * q, (j / kStages) & 1);
#pragma unroll
    for (int rr = 0; rr < kRowsPerGroup; ++rr) fence_accum(acc[rr]);
    wgmma_fence();
#pragma unroll
    for (int rr = 0; rr < kRowsPerGroup; ++rr) {
      const uint32_t a = a_base + ((g * kRowsPerGroup + rr + j) % kRing) * kSliceBytes;
      const uint32_t b = b_base + q * kBTileBytes;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        // k16 step kk: 64-channel half kk / 4, 32 bytes into its swizzled rows
        const uint32_t k_off = (kk % 4) * 32;
        wgmma_m64n128k16(acc[rr], smem_desc(a + (kk / 4) * (kSliceBytes / 2) + k_off),
                         smem_desc(b + (kk / 4) * (kBTileBytes / 2) + k_off));
      }
    }
    wgmma_commit();
    // wait for this step's products before the accumulators are touched
    // again (a group left in flight across the fences would make ptxas
    // serialize every wgmma); the other warpgroup keeps the tensor cores busy
    wgmma_wait<0>();
#pragma unroll
    for (int rr = 0; rr < kRowsPerGroup; ++rr) fence_accum(acc[rr]);
    if (lane == 0) mbar_arrive(empty_bar + 8 * q);  // release this step's stage
  }

  // accumulator layout: register 4i + 2h + c holds row 16 (warp % 4) + lane / 4
  // + 8h, column 8i + 2 (lane % 4) + c.  The thread's 4 candidates of a
  // column, in raster order: (rr 0, h 0), (rr 0, h 1), (rr 1, h 0), (rr 1, h 1)
  const int m0 = (warp % 4) * 16 + lane / 4;
  bool cand_ok[kRowsPerGroup][2];
  unsigned cand_idx[kRowsPerGroup][2];
#pragma unroll
  for (int rr = 0; rr < kRowsPerGroup; ++rr)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g * kRowsPerGroup + rr;
      cand_ok[rr][h] = ok_s[r * kCols + m0 + 8 * h] != 0;
      cand_idx[rr][h] = static_cast<unsigned>((cy0 + r) * n_cx + cx0 + m0 + 8 * h);
    }
#pragma unroll
  for (int i = 0; i < kAccum / 4; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // strict < keeps the first minimum; the key's index breaks ties elsewhere
      float best = 0.0f;
      unsigned best_idx = 0;
      bool any = false;
#pragma unroll
      for (int rr = 0; rr < kRowsPerGroup; ++rr)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float e = acc[rr][4 * i + 2 * h + c];
          if (cand_ok[rr][h] && (!any || e < best)) {
            best = e;
            best_idx = cand_idx[rr][h];
            any = true;
          }
        }
      unsigned long long key = any ? pack_key(best, best_idx) : kNoKey;
#pragma unroll
      for (int mask = 4; mask < 32; mask *= 2) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, mask);
        key = other < key ? other : key;
      }
      if (lane < 4 && key != kNoKey) atomicMin(&keys_s[8 * i + 2 * lane + c], key);
    }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");  // consumers only

  if (tid < kTileN) {
    const unsigned long long key = keys_s[tid];
    unsigned long long* dst = keys + t0 + tid;
    // keys only fall, so a stale read is never below the current minimum
    if (key != kNoKey && key < *reinterpret_cast<volatile unsigned long long*>(dst)) {
      atomicMin(dst, key);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A bf16 (d2, d1, 128) tensor read in boxes of 64 channels x box_rows x 1,
// in the 128-byte swizzle; out-of-range boxes are zero-filled.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int d1, int d2, int box_rows) {
  const cuuint64_t dims[3] = {kChannels, static_cast<cuuint64_t>(d1), static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {kChannels * 2, static_cast<cuuint64_t>(d1) * kChannels * 2};
  const cuuint32_t box[3] = {kHalfK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Targets per block: tp must be a multiple of it.
int vip_wexler_search_target_tile() { return kTileN; }

// Candidate rows per block.
int vip_wexler_search_row_tile() { return kRows; }

// Dynamic shared memory of one block.
int vip_wexler_search_smem_bytes() { return kSmemBytes; }

// p: (n_cy + window - 1, n_cx, 128) bf16; f: (window, tp, 128) bf16, both
// 16-byte aligned; valid: (n_cy, n_cx) u8; keys: (tp,) u64, every bit set;
// active: null, or an int32 the kernel reads first and returns on if 0.
// Returns the launch's cudaError_t (0 on success); cudaErrorNotSupported if
// the driver has no cuTensorMapEncodeTiled, cudaErrorInvalidValue if it
// refuses a tensor map.
int vip_wexler_search(const void* p, const void* f, const void* valid, void* keys,
                      const void* active, int window, int n_cy, int n_cx, int tp, void* stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_p, map_f;
  if (!encode(fn, &map_p, p, n_cx, n_cy + window - 1, kCols) ||
      !encode(fn, &map_f, f, tp, window, kTileN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      wexler_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(tp / kTileN, (n_cx + kCols - 1) / kCols, (n_cy + kRows - 1) / kRows);
  wexler_search_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_p, map_f, static_cast<const uint8_t*>(valid), static_cast<unsigned long long*>(keys),
      static_cast<const int*>(active), window, n_cy, n_cx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
