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
// What bounds it: at the main path's 1024 x 1024 the work is 8M XOR+popcount
// pairs (~64M integer ops) over 64 KB of descriptors, far below what the
// card's integer units or HBM sustain, so launch latency dominates, not bytes
// or operations.  Every block reads all targets, from L2 after the first.
//
// Design: XOR + __popc over the 8 words is exact and cheap on Hopper; the TPU's
// ±1 bf16 matmul was a workaround for its matrix unit.  One warp per query
// row, 8 rows per 256-thread block.  Targets are staged through shared memory
// in tiles of 256 descriptors (8 KB, stored word-major so that a warp reads 32
// consecutive words, free of bank conflicts).  Each lane keeps (d1, i1, d2)
// over targets j == lane (mod 32), visited in ascending order with a strict <,
// so i1 is the lowest index among equal minima.  Five shuffle steps then merge
// the lanes lexicographically on (d, i): the winner's (d1, i1) is kept and
// d2 = min(loser.d1, winner.d2).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kThreads;   // one target row staged per thread
constexpr int kWords = 8;         // 256 bits
constexpr int kInvalid = 1000000;

__device__ __forceinline__ void merge(int& d1, int& i1, int& d2,
                                      int od1, int oi1, int od2) {
  const bool other_wins = od1 < d1 || (od1 == d1 && oi1 < i1);
  const int win_d2 = other_wins ? od2 : d2;
  const int lose_d1 = other_wins ? d1 : od1;
  if (other_wins) {
    d1 = od1;
    i1 = oi1;
  }
  d2 = min(win_d2, lose_d1);
}

__global__ void __launch_bounds__(kThreads)
hamming_top2_kernel(const int32_t* __restrict__ desc_a,
                    const uint8_t* __restrict__ valid_a,
                    const int32_t* __restrict__ desc_b,
                    const uint8_t* __restrict__ valid_b,
                    int n, int m,
                    float* __restrict__ d1_out,
                    int32_t* __restrict__ i1_out,
                    float* __restrict__ d2_out) {
  __shared__ uint32_t tile[kWords][kTile];
  __shared__ uint8_t tile_valid[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool has_row = row < n;

  uint32_t q[kWords];
  bool q_valid = false;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    q[w] = has_row ? static_cast<uint32_t>(desc_a[row * kWords + w]) : 0u;
  }
  if (has_row) q_valid = valid_a[row] != 0;

  int d1 = INT_MAX, i1 = INT_MAX, d2 = INT_MAX;
  for (int base = 0; base < m; base += kTile) {
    __syncthreads();  // the previous tile has been read by every warp
    const int j = base + threadIdx.x;
    if (j < m) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        tile[w][threadIdx.x] = static_cast<uint32_t>(desc_b[j * kWords + w]);
      }
      tile_valid[threadIdx.x] = valid_b[j];
    }
    __syncthreads();
    const int count = min(kTile, m - base);
    for (int jj = lane; jj < count; jj += 32) {
      int v = kInvalid;
      if (q_valid && tile_valid[jj]) {
        v = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) v += __popc(q[w] ^ tile[w][jj]);
      }
      if (v < d1) {
        d2 = d1;
        d1 = v;
        i1 = base + jj;
      } else if (v < d2) {
        d2 = v;
      }
    }
  }

#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const int od1 = __shfl_xor_sync(0xffffffffu, d1, offset);
    const int oi1 = __shfl_xor_sync(0xffffffffu, i1, offset);
    const int od2 = __shfl_xor_sync(0xffffffffu, d2, offset);
    merge(d1, i1, d2, od1, oi1, od2);
  }
  if (has_row && lane == 0) {
    d1_out[row] = static_cast<float>(min(d1, kInvalid));
    i1_out[row] = i1 == INT_MAX ? 0 : i1;
    d2_out[row] = static_cast<float>(min(d2, kInvalid));
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All pointers are device pointers;
// the launch goes on `stream` and does not synchronise.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int hamming_top2_launch(const int32_t* desc_a, const uint8_t* valid_a,
                                   const int32_t* desc_b, const uint8_t* valid_b,
                                   int n, int m, float* d1, int32_t* i1,
                                   float* d2, cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kWarps - 1) / kWarps);
  hamming_top2_kernel<<<grid, kThreads, 0, stream>>>(
      desc_a, valid_a, desc_b, valid_b, n, m, d1, i1, d2);
  return static_cast<int>(cudaGetLastError());
}
