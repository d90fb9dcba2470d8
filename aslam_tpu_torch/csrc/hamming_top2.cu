// Masked 256-bit Hamming 2-NN for Hopper (sm_90a).
//
// Replaces aslam_tpu/ops/pallas_kernels.py::hamming_top2 (body _top2_kernel),
// the TPU kernel of the frame-to-frame matcher (ops/matching.py
// knn_ratio_match).  For every query row i it returns d1 = the smallest
// Hamming distance to a target, i1 = the lowest index attaining it, and d2 =
// the second value of the row sorted ascending (so d2 == d1 on a tie): the
// result of the reference's default path, masked_distance_matrix followed by
// lax.top_k, exactly.  A pair with an invalid query or target scores exactly
// INVALID_DIST (1e6).  The Pallas kernel scores a masked pair 1e6 + d instead;
// that differs only on rows with no valid target, which knn_ratio_match
// rejects either way.  Such rows give d1 = d2 = 1e6 and i1 = 0 here.
//
// What bounds it: operations.  One 256-deep 1-bit product per pair is
// 2*N*M*256 operations.  The data sheet gives no 1-bit rate for this card;
// the probe at the end of this file (mma_peak_kernel, run by `python -m
// aslam_tpu_torch.kernels.bench_top2`) measures what the scoring instruction
// sustains, about 4.9 times the int8 rate of 1,979 TOP/s (PERF.md has the
// reading), and at that rate the work is 0.06 us at the main path's 1024 x
// 1024 and 3.5 us at 8192 x 8192.  The bytes (each descriptor and mask read
// once, three outputs written once) are 78 KB, 0.02 us of HBM time.  Outside
// the tensor cores the same work is N*M*8 __popc at 16 per clock per SM, 2.0
// us and 128 us: a design on XOR and __popc, with the same staging and merge,
// spent 1.9 of its 4.8 us at 1024 x 1024 on scoring, the popcount bound
// itself, on an H100 at 700 W (PERF.md).  Hence the tensor cores.  This
// kernel does not come near their bound: at 1024 x 1024 what is left is
// latency (a launch, one round of loads, the stores), and at large shapes
// the integer min / max of the key updates and the staging of every target
// once per 8 query rows set the time, far above the product's own.
//
// Design.
//  * Scoring on the tensor cores.  mma.sync m16n8k256 .b1 .and.popc is one
//    SASS instruction on this card (BMMA.168256.AND.POPC); .xor.popc still
//    compiles for sm_90a, but into a longer and slower sequence.  So a pair's
//    distance is popc(a & ~q) + popc(~a & q), two chained AND products: 16
//    targets against 8 query rows, 256 bits deep, per instruction.
//  * Staging.  Thread 0 copies the targets into shared memory with 1-D bulk
//    asynchronous copies (cp.async.bulk, TMA without a tensor map: rows are
//    32 contiguous, aligned bytes), kChunk = 512 targets (16 KB) a copy, each
//    completing on its own mbarrier.  Up to kSlots chunks (6144 targets, 192
//    KB) are started before anything else, so all of a block's targets are
//    resident where they fit and scoring chunk 0 overlaps the arrival of the
//    rest.  Beyond that the slots form a ring: a warp that has taken its
//    targets out of a slot arrives on the slot's "empty" mbarrier, and thread
//    0 refills the slot with the chunk kSlots further on.  No __syncthreads()
//    in the target loop.  A thread's part of an mma operand is words 2t, 2t +
//    1 of a target: one 8-byte shared load, the warp's 32 of them on 256
//    contiguous bytes, free of bank conflicts.
//  * Reuse.  A block owns 8 query rows, one mma operand held in registers
//    with its complement (4 registers).  Every target word read from shared
//    memory is scored against all 8 rows by the instruction itself, and a
//    thread has 2 independent pairs of chained mma and 8 key updates on 2
//    rows in flight per chunk.  More rows a block would divide the bytes
//    staged per query row; the main path's 1024 rows would then fill fewer
//    SMs, and no caller sends more.
//  * The mask.  A thread reads its targets' valid bytes one chunk ahead and
//    folds them into the per-target word `jpen` = index | masked << 31;
//    nothing branches per pair.  A target beyond M counts as masked.
//  * Top-2 without compares.  key = distance << 22 | index (+ 512 << 22 for a
//    masked target) orders pairs as (distance, index), so the two smallest
//    keys of a row give d1, i1 (lowest index on a tie) and d2: per pair
//    k2 = min(k2, max(k1, key)); k1 = min(k1, key).  Keys of distinct targets
//    are distinct, so partial results merge as m1 = min over k1, m2 = min
//    over (k1 == m1 ? k2 : k1): by three shuffle steps over the 8 lanes that
//    hold a row, then by two redux.sync over the 16 warps' partials through
//    shared memory.  One launch, no atomics.  The index has 22 bits: M <= 4,194,304.
//    These min / max are what the scoring loop now spends its time on.
//  * Occupancy.  The 16 warps of a block split the targets, 16 at a time, so
//    N = 1024 gives 128 blocks of 16 warps on 128 of the 132 SMs.  A larger N
//    only adds blocks.
//  * Batch.  Batched VO (models/batch_vo.py) matches B independent frame
//    pairs per step, [B,N,8] x [B,M,8] -> [B,3,N], in one launch: the grid's
//    y is the lane, and each block offsets its five pointers by it.  A
//    lane's strides are multiples of 32 bytes, so the bulk copies keep their
//    16-byte alignment; the mbarrier ring and the shared memory are per
//    block and do not change.  B = 1 is the unbatched call.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// The wrapper module (ops/hamming_top2.py) exports the same constants for its
// numpy model of this partition; a test holds the two files together.
constexpr int kWords = 8;         // 256 bits
constexpr int kTileRows = 8;      // query rows per mma (its n) and per block
constexpr int kGroup = 16;        // targets per mma (its m)
constexpr int kWarps = 16;        // warps per block; they split the targets
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = kThreads;  // targets per bulk copy and mbarrier
constexpr int kSlots = 12;        // chunks of shared memory
constexpr int kKeyShift = 22;     // key = distance << 22 | index
constexpr int kMasked = 512;      // added to a masked target's distance

constexpr int kSteps = kChunk / (kGroup * kWarps);  // mma groups per warp and chunk
constexpr int kChunkBytes = kChunk * kWords * 4;
constexpr int kMaxSmem = kSlots * kChunkBytes;
constexpr uint32_t kNoKey = 0xffffffffu;
constexpr float kInvalidDist = 1e6f;
constexpr int kMaxDevices = 64;

static_assert(kChunk % (kGroup * kWarps) == 0, "a chunk is whole groups for every warp");
static_assert(kWarps <= 32, "the final merge reads the warps' partials with one warp");
static_assert(kTileRows <= kWarps, "warp w writes the result of the block's row w");
static_assert(256 + kMasked < (1 << (32 - kKeyShift)), "the distance fits above the index");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One bulk copy of chunk c of the targets into its slot; `full` completes
// when its bytes have landed.
__device__ __forceinline__ void copy_chunk(int c, const int32_t* desc_b, int m,
                                            unsigned char* slots, uint64_t* full) {
  const int slot = c % kSlots;
  const uint32_t bytes =
      static_cast<uint32_t>(min(kChunk, m - c * kChunk)) * kWords * 4;
  const uint32_t bar = smem_addr(&full[slot]);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(slots + slot * kChunkBytes)),
         "l"(desc_b + static_cast<size_t>(c) * kChunk * kWords), "r"(bytes),
         "r"(bar)
      : "memory");
}

// d += popc(a & b) for 16 targets (a) against 8 query rows (b), 256 bits
// deep, in one tensor-core instruction (BMMA.168256.AND.POPC).  With g =
// lane / 4 and t = lane % 4 a thread gives words 2t and 2t + 1 of targets g
// (a_lo) and g + 8 (a_hi) and of query row g (b), and holds targets g (d[0],
// d[1]) and g + 8 (d[2], d[3]) against query rows 2t and 2t + 1.  (The
// instruction numbers the bits of a row in another order; a sum over all 256
// does not care, as long as a and b agree.)
__device__ __forceinline__ void mma_and_popc(int (&d)[4], int2 a_lo, int2 a_hi, int2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a_lo.x), "r"(a_hi.x), "r"(a_lo.y), "r"(a_hi.y), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ int2 complement(int2 v) { return make_int2(~v.x, ~v.y); }

__device__ __forceinline__ void keep_top2(uint32_t& k1, uint32_t& k2, uint32_t key) {
  k2 = min(k2, max(k1, key));
  k1 = min(k1, key);
}

// (m1, m2) = the two smallest of the keys held as (k1 <= k2) pairs by the
// lanes of a warp; keys other than kNoKey are distinct.
__device__ __forceinline__ uint2 warp_top2(uint32_t k1, uint32_t k2) {
  const uint32_t m1 = __reduce_min_sync(0xffffffffu, k1);
  const uint32_t m2 = __reduce_min_sync(0xffffffffu, k1 == m1 ? k2 : k1);
  return make_uint2(m1, m2);
}

// The same over the 8 lanes that hold the same query rows (equal lane % 4),
// by shuffles: redux.sync over part of a warp takes a slow path.
__device__ __forceinline__ void same_rows_top2(uint32_t& k1, uint32_t& k2) {
#pragma unroll
  for (int offset = 4; offset < 32; offset *= 2) {
    const uint32_t o1 = __shfl_xor_sync(0xffffffffu, k1, offset);
    const uint32_t o2 = __shfl_xor_sync(0xffffffffu, k2, offset);
    k2 = min(max(k1, o1), min(k2, o2));
    k1 = min(k1, o1);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
hamming_top2_kernel(const int32_t* __restrict__ desc_a,
                    const uint8_t* __restrict__ valid_a,
                    const int32_t* __restrict__ desc_b,
                    const uint8_t* __restrict__ valid_b,
                    int n, int m, int32_t* __restrict__ out) {
  // lane blockIdx.y of a batch: its own rows of every operand
  const size_t problem = blockIdx.y;
  desc_a += problem * n * kWords;
  valid_a += problem * n;
  desc_b += problem * m * kWords;
  valid_b += problem * m;
  out += problem * 3 * n;

  extern __shared__ __align__(128) unsigned char slots[];
  __shared__ __align__(8) uint64_t full[kSlots];
  __shared__ __align__(8) uint64_t empty[kSlots];
  __shared__ uint2 partial[kTileRows][kWarps];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_chunks = (m + kChunk - 1) / kChunk;
  const bool ring = n_chunks > kSlots;

  if (tid == 0) {
    const int n_slots = min(n_chunks, kSlots);
    for (int s = 0; s < n_slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int c = 0; c < n_slots; ++c) copy_chunk(c, desc_b, m, slots, full);
  }

  // the block's query rows as an mma operand: words 2t, 2t + 1 of row g
  const int row0 = static_cast<int>(blockIdx.x) * kTileRows;
  const int2 q = __ldg(reinterpret_cast<const int2*>(desc_a) +
                       static_cast<size_t>(min(row0 + g, n - 1)) * 4 + t);
  const int2 not_q = complement(q);
  // warp w < kTileRows writes the result of row row0 + w at the end
  const int out_row = row0 + warp;
  const bool writes = warp < kTileRows && out_row < n;
  const bool row_valid = writes && valid_a[out_row] != 0;

  // the two least keys of query rows 2t and 2t + 1
  uint32_t k1[2] = {kNoKey, kNoKey}, k2[2] = {kNoKey, kNoKey};

  __syncthreads();  // the mbarriers are initialised

  // of every chunk c the warp takes the groups of 16 targets warp, warp +
  // kWarps, ...; the thread scores targets g and g + 8 of each.  A target at
  // or beyond m counts as masked.
  uint32_t valid_next[kSteps][2];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int j = (s * kWarps + warp) * kGroup + g;
    valid_next[s][0] = j < m ? valid_b[j] : 0;
    valid_next[s][1] = j + 8 < m ? valid_b[j + 8] : 0;
  }
  for (int c = 0; c < n_chunks; ++c) {
    uint32_t jpen[kSteps][2];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int j = c * kChunk + (s * kWarps + warp) * kGroup + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        jpen[s][h] = static_cast<uint32_t>(j + 8 * h) |
                     (valid_next[s][h] ? 0u : static_cast<uint32_t>(kMasked) << kKeyShift);
        const int j_next = j + 8 * h + kChunk;
        valid_next[s][h] = j_next < m ? valid_b[j_next] : 0;
      }
    }

    const int slot = c % kSlots;
    mbar_wait(&full[slot], (c / kSlots) & 1);
    int2 a_lo[kSteps], a_hi[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int2* src = reinterpret_cast<const int2*>(
          slots + slot * kChunkBytes + ((s * kWarps + warp) * kGroup + g) * (kWords * 4));
      a_lo[s] = src[t];
      a_hi[s] = src[8 * (kWords / 2) + t];  // 8 targets further on
    }
    if (ring) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }

#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int2 not_lo = complement(a_lo[s]), not_hi = complement(a_hi[s]);
      // popc(a ^ q) = popc(a & ~q) + popc(~a & q)
      int d[4] = {0, 0, 0, 0};
      mma_and_popc(d, a_lo[s], a_hi[s], not_q);
      mma_and_popc(d, not_lo, not_hi, q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        keep_top2(k1[0], k2[0], (static_cast<uint32_t>(d[2 * h]) << kKeyShift) + jpen[s][h]);
        keep_top2(k1[1], k2[1], (static_cast<uint32_t>(d[2 * h + 1]) << kKeyShift) + jpen[s][h]);
      }
    }

    if (tid == 0 && c + kSlots < n_chunks) {
      // refill the slot once every warp has taken its targets out of it
      mbar_wait(&empty[slot], (c / kSlots) & 1);
      copy_chunk(c + kSlots, desc_b, m, slots, full);
    }
  }

  // merge: the 8 lanes that hold the same rows, then the warps of the block
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    same_rows_top2(k1[r], k2[r]);
    if (g == 0) partial[2 * t + r][warp] = make_uint2(k1[r], k2[r]);
  }
  __syncthreads();
  if (warp < kTileRows) {
    const uint2 p = lane < kWarps ? partial[warp][lane] : make_uint2(kNoKey, kNoKey);
    const uint2 top = warp_top2(p.x, p.y);
    if (lane == 0 && writes) {
      const int d1 = static_cast<int>(top.x >> kKeyShift);
      const int d2 = static_cast<int>(top.y >> kKeyShift);
      const bool found = row_valid && d1 < kMasked;
      const float f1 = found ? static_cast<float>(d1) : kInvalidDist;
      const float f2 = found && d2 < kMasked ? static_cast<float>(d2) : kInvalidDist;
      const size_t stride = static_cast<size_t>(n);
      out[out_row] = __float_as_int(f1);
      out[stride + out_row] = found ? static_cast<int>(top.x & ((1u << kKeyShift) - 1)) : 0;
      out[2 * stride + out_row] = __float_as_int(f2);
    }
  }
}

// The same grid, block and shared memory with nothing to do: the least a
// launch of this shape takes.
__global__ void __launch_bounds__(kThreads, 1) hamming_top2_empty_kernel() {}

// Nothing but the scoring instruction, 8 independent chains a warp on made-up
// operands: with 16 warps on every SM, the rate the card sustains for it.
constexpr int kPeakChains = 8;
constexpr long long kOpsPerMma = 2LL * kGroup * kTileRows * 256;

__global__ void __launch_bounds__(kThreads, 1) mma_peak_kernel(int32_t* out, int iters) {
  const int x = static_cast<int>(threadIdx.x * 2654435761u);
  const int2 a_lo = make_int2(x, x ^ 0x9e3779b9), a_hi = make_int2(x * 3, x * 5);
  int d[kPeakChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kPeakChains; ++u) {
      mma_and_popc(d[u], a_lo, a_hi, make_int2(x + 7 + u, x + 11));
    }
  }
  int sum = 0;
#pragma unroll
  for (int u = 0; u < kPeakChains; ++u) sum += d[u][0] + d[u][1] + d[u][2] + d[u][3];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

int smem_bytes(int m) {
  return std::min((m + kChunk - 1) / kChunk, kSlots) * kChunkBytes;
}

int grid_for(int n) { return (n + kTileRows - 1) / kTileRows; }

// Allows the kernels more than 48 KB of dynamic shared memory, once per card.
cudaError_t configure() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(hamming_top2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(hamming_top2_empty_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  done[dev] = true;
  return cudaSuccess;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  All pointers are device pointers
// (desc_a and desc_b 16-byte aligned).  A launch takes b problems: desc_a
// [b, n, 8], valid_a [b, n], desc_b [b, m, 8], valid_b [b, m], and `out`
// int32 [b, 3, n]: per problem row 0 the bits of d1 (float32), row 1 i1, row
// 2 the bits of d2 (b = 1: one [n] x [m] problem).  The launch goes on
// `stream` of the current device and does not synchronise.  Returns the
// cudaError_t of the set-up or the launch (0 = success).
extern "C" int hamming_top2_launch(const int32_t* desc_a, const uint8_t* valid_a,
                                   const int32_t* desc_b, const uint8_t* valid_b,
                                   int b, int n, int m, int32_t* out,
                                   cudaStream_t stream) {
  if (n <= 0 || b <= 0) return 0;
  if (m < 0 || m > (1 << kKeyShift) || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  hamming_top2_kernel<<<dim3(grid_for(n), b), kThreads, smem_bytes(m), stream>>>(
      desc_a, valid_a, desc_b, valid_b, n, m, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hamming_top2_empty_launch(int b, int n, int m, cudaStream_t stream) {
  if (n <= 0 || b <= 0) return 0;
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  hamming_top2_empty_kernel<<<dim3(grid_for(n), b), kThreads, smem_bytes(m),
                              stream>>>();
  return static_cast<int>(cudaGetLastError());
}

// `blocks` blocks of the probe, `iters` rounds of 8 products a warp; `out`
// holds blocks * 512 int32.  `*ops` gets the 1-bit operations of the launch.
extern "C" int hamming_top2_mma_peak_launch(int32_t* out, int blocks, int iters,
                                            long long* ops, cudaStream_t stream) {
  *ops = kOpsPerMma * kPeakChains * iters * kWarps * blocks;
  mma_peak_kernel<<<blocks, kThreads, 0, stream>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
