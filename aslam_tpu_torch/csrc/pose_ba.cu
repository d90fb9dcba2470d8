// Motion-only bundle adjustment for Hopper (sm_90a): a whole call in one
// launch.
//
// Replaces aslam_tpu/ops/ba.py::pose_only_ba, an XLA fori_loop in the
// reference (not a Pallas kernel), whose PyTorch version
// (aslam_tpu_torch/ops/ba.py::pose_only_ba_plain) is ~420 small launches per
// Levenberg-Marquardt iteration.  One block solves one problem: pose_rounds x
// pose_iters iterations (4 x 10 on every caller) of
//   per edge   the (u, v, uR) reprojection residual of a fixed world point, its
//              3x6 Jacobian w.r.t. the left-multiplied twist [rho, phi], the
//              information 1/z^2 (or 1), chi2, a Huber weight in every round
//              but the last, and the mask valid & inlier & depth_ok;
//   per block  H = sum J^T W J and b = sum J^T W r, the prior edge
//              (H += w diag(1,1,1,4,4,4), b += H_prior se3_log(T T_init^-1)),
//              Hd = H + 1e-4 diag(H) + 1e-9 I, the clamped Cholesky solve of
//              ops/linalg.py, a step zeroed when not finite, T <- exp(xi) T;
// and after each round chi2 at the new pose, inlier = chi2 <= threshold.  The
// arithmetic is the plain version's, operation for operation, in float32,
// with its clamps and its small-angle and near-pi branches (utils/se3.py),
// with one exception: the 27 sums (H's lower triangle and b) are taken in
// float64 and rounded once to float32.  Each product Jw_i * J_j of two
// float32 values is exact in float64, so H and b are the float32 values
// nearest the exact sums of the float32 edge terms, whatever the order of the
// sum; the plain version's float32 matrix product rounds at every step in an
// order that the library picks.  No TF32 and no bf16 anywhere.
//
// What bounds it: operations, and far from it, latency.  A pass over N = 1024
// edges is ~95 float32 and ~162 float64 operations an edge (the 27 products
// of the three rows in float64); 40 passes and 4 chi2 passes are 4.1 M
// float32 and 6.6 M float64 operations, 0.06 us at 67 TFLOP/s and 0.19 us at
// the 34 TFLOP/s of float64 outside the tensor cores (the bound is the larger,
// ops/pose_ba_kernel.py::pose_ba_bound).  The inputs and outputs are 35 KB,
// 0.01 us of HBM time.  The kernel cannot come near: its 40 iterations form a
// chain, each a pass over the edges, a reduction across the block and a 6x6
// solve with an SE(3) update in one thread, and the next pass needs the new
// pose.  What the design does about it is to keep the whole chain inside one
// launch (the eager version pays ~18,500 launches of host time per call) and
// to keep each link short:
//  * One block of 256 threads per problem, grid = B (batched VO's lanes run
//    side by side on B SMs).  Thread t owns edges t, t + 256, ...  for the
//    whole call, so the inlier mask of an edge is read back by the thread that
//    wrote it (from the chi2 output, chi2 <= threshold) and never crosses
//    threads.  The block's inputs (29 bytes an edge, 30 KB at N = 1024) come
//    from device memory in the first pass and from L1 after it.
//  * The reduction: 27 float64 partial sums a thread, a shuffle tree in each
//    warp, then the 8 warps' partials in shared memory summed in warp order by
//    27 threads.  A fixed order and no atomics: two runs, and a lane of a
//    batch against the same problem alone, give the same bits.
//  * The solve and the pose update run in thread 0; the new pose goes to the
//    block through shared memory.  Three barriers an iteration.
//  * No allocation, no host read, no synchronisation: the call can be captured
//    in a CUDA graph.  The prior weight comes as a float or as a pointer to a
//    device scalar read in the kernel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTri = 21;             // H's lower triangle, row by row
constexpr int kSums = kTri + 6;      // and b
constexpr float kLambda = 1e-4f;     // the fixed Levenberg-Marquardt damping
constexpr float kCholEps = 1e-30f;   // ops/linalg.py _EPS
constexpr float kSe3Eps = 1e-8f;     // utils/se3.py _EPS

static_assert(kSums <= kThreads, "one thread per sum in the cross-warp step");

struct Camera {
  float fx, fy, cx, cy, bf;
};

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// C = A @ B for 4x4 row-major matrices
__device__ __forceinline__ void matmul4(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = A[4 * i] * B[j];
#pragma unroll
      for (int k = 1; k < 4; ++k) s += A[4 * i + k] * B[4 * k + j];
      C[4 * i + j] = s;
    }
  }
}

// I + a K + b K @ K with K = hat(phi)  (utils/se3.py so3_exp and the left
// Jacobian share this form)
__device__ __forceinline__ void rodrigues(const float* phi, float a, float b, float* M) {
  const float K[9] = {0.f, -phi[2], phi[1], phi[2], 0.f, -phi[0], -phi[1], phi[0], 0.f};
  float KK[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      KK[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    M[k] = ((k % 4 == 0) ? 1.f : 0.f) + a * K[k] + b * KK[k];
  }
}

// the coefficients of the left Jacobian I + a K + b K^2 of rotation vector phi
__device__ __forceinline__ void left_jacobian(const float* phi, float* Jl) {
  const float theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float theta = sqrtf(theta2 + kSe3Eps);
  const bool big = theta2 > kSe3Eps;
  const float a = big ? (1.f - cosf(theta)) / (theta2 + kSe3Eps) : 0.5f - theta2 / 24.f;
  const float b = big ? (theta - sinf(theta)) / (theta2 * theta + kSe3Eps)
                      : 1.f / 6.f - theta2 / 120.f;
  rodrigues(phi, a, b, Jl);
}

// se(3) twist [rho, phi] -> 4x4 transform (utils/se3.py se3_exp)
__device__ void se3_exp(const float* xi, float* E) {
  const float* phi = xi + 3;
  const float theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float theta = sqrtf(theta2 + kSe3Eps);
  const bool big = theta2 > kSe3Eps;
  const float a = big ? sinf(theta) / theta : 1.f - theta2 / 6.f;
  const float b = big ? (1.f - cosf(theta)) / (theta2 + kSe3Eps) : 0.5f - theta2 / 24.f;
  float R[9], V[9];
  rodrigues(phi, a, b, R);
  left_jacobian(phi, V);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    E[4 * i] = R[3 * i];
    E[4 * i + 1] = R[3 * i + 1];
    E[4 * i + 2] = R[3 * i + 2];
    E[4 * i + 3] = V[3 * i] * xi[0] + V[3 * i + 1] * xi[1] + V[3 * i + 2] * xi[2];
  }
  E[12] = 0.f;
  E[13] = 0.f;
  E[14] = 0.f;
  E[15] = 1.f;
}

// rotation part of a 4x4 transform -> rotation vector (utils/se3.py so3_log)
__device__ void so3_log(const float* T, float* phi) {
  const float trace = T[0] + T[5] + T[10];
  float c = (trace - 1.f) * 0.5f;
  c = c < -1.f ? -1.f : (c > 1.f ? 1.f : c);
  const float theta = acosf(c);
  const float w[3] = {T[9] - T[6], T[2] - T[8], T[4] - T[1]};
  const float s = sinf(theta);
  const float scale = fabsf(s) < 1e-5f ? 0.5f + theta * theta / 12.f
                                       : theta / (2.f * s + kSe3Eps);
  if (c < -1.f + 1e-4f) {
    // near theta = pi |w| ~ 0: the axis from the diagonal
    float axis[3];
    const float diag[3] = {T[0], T[5], T[10]};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float q = (diag[k] + 1.f) * 0.5f;
      q = q < 0.f ? 0.f : (q > 1.f ? 1.f : q);
      axis[k] = sqrtf(q) * (w[k] < 0.f ? -1.f : 1.f);
    }
    const float norm = sqrtf(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) phi[k] = theta * axis[k] / (norm + kSe3Eps);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) phi[k] = scale * w[k];
  }
}

// 4x4 transform -> twist [rho, phi] (utils/se3.py se3_log: the left Jacobian
// inverted by its adjugate)
__device__ void se3_log(const float* T, float* xi) {
  float* phi = xi + 3;
  so3_log(T, phi);
  float A[9];
  left_jacobian(phi, A);
  const float a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5], g = A[6],
              h = A[7], i = A[8];
  const float adj[9] = {e * i - f * h, c * h - b * i, b * f - c * e,
                        f * g - d * i, a * i - c * g, c * d - a * f,
                        d * h - e * g, b * g - a * h, a * e - b * d};
  const float det = a * adj[0] + b * adj[3] + c * adj[6];
  const float inv_det = 1.f / (fabsf(det) > 1e-20f ? det : 1e-20f);
  const float t[3] = {T[3], T[7], T[11]};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    xi[r] = adj[3 * r] * inv_det * t[0] + adj[3 * r + 1] * inv_det * t[1] +
            adj[3 * r + 2] * inv_det * t[2];
  }
}

// One Levenberg-Marquardt step from the block's sums: T <- exp(xi) T.
// `sums` holds H's lower triangle (row i, columns 0..i) then b.
__device__ void lm_step(const float* sums, const float* Tpi, float w_prior, float* T) {
  float H[6][6], b[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) H[i][j] = sums[k++];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = sums[kTri + i];

  // the prior edge: r_p = log(T T_init^-1), information w diag(1,1,1,4,4,4)
  float M[16], rp[6];
  matmul4(T, Tpi, M);
  se3_log(M, rp);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float hp = w_prior * (i < 3 ? 1.f : 4.f);
    H[i][i] += hp;
    b[i] += hp * rp[i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) H[i][i] = (H[i][i] + kLambda * H[i][i]) + 1e-9f;

  // Cholesky-Crout with the pivot clamped at kCholEps (ops/linalg.py)
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) s = s - L[j][q] * L[j][q];
    const float dj = sqrtf(clamp_min(s, kCholEps));
    L[j][j] = dj;
    const float inv_d = 1.f / dj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) t = t - L[i][q] * L[j][q];
      L[i][j] = t * inv_d;
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s = s - L[i][q] * y[q];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) s = s - L[q][i] * x[q];
    x[i] = s / L[i][i];
  }
  bool finite = true;
  float xi[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    xi[i] = -x[i];
    finite = finite && isfinite(xi[i]);
  }
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 6; ++i) xi[i] = 0.f;
  }
  float E[16], Tn[16];
  se3_exp(xi, E);
  matmul4(E, T, Tn);
#pragma unroll
  for (int q = 0; q < 16; ++q) T[q] = Tn[q];
}

// What an edge contributes at pose T: residual r (uR row zeroed for a mono
// edge), chi2, depth_ok and, if `jac`, the 3x6 Jacobian
// (ops/ba.py project_residual_jac).
struct EdgeEval {
  float r[3];
  float J[3][6];
  float chi2;
  bool depth_ok;
};

template <bool kJac>
__device__ __forceinline__ void eval_edge(const float* T, const Camera& cam, float X, float Y,
                                          float Z, float ou, float ov, float our, bool stereo,
                                          float info, EdgeEval& e) {
  const float x = T[0] * X + T[1] * Y + T[2] * Z + T[3];
  const float y = T[4] * X + T[5] * Y + T[6] * Z + T[7];
  const float z = T[8] * X + T[9] * Y + T[10] * Z + T[11];
  const float zs = z > 1e-6f ? z : 1e-6f;
  const float iz = 1.f / zs;
  const float iz2 = iz * iz;
  const float u = cam.fx * x * iz + cam.cx;
  const float v = cam.fy * y * iz + cam.cy;
  const float ur = u - cam.bf * iz;
  e.r[0] = u - ou;
  e.r[1] = v - ov;
  e.r[2] = stereo ? ur - our : 0.f;
  e.chi2 = (e.r[0] * e.r[0] + e.r[1] * e.r[1] + e.r[2] * e.r[2]) * info;
  e.depth_ok = z > 1e-3f;
  if (kJac) {
    // dproj rows (du, dv, duR) times dp/dxi = [I | -p^]
    const float d[3][3] = {{cam.fx * iz, 0.f, -cam.fx * x * iz2},
                           {0.f, cam.fy * iz, -cam.fy * y * iz2},
                           {cam.fx * iz, 0.f, -cam.fx * x * iz2 + cam.bf * iz2}};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      e.J[r][0] = d[r][0];
      e.J[r][1] = d[r][1];
      e.J[r][2] = d[r][2];
      e.J[r][3] = d[r][1] * -z + d[r][2] * y;
      e.J[r][4] = d[r][0] * z + d[r][2] * -x;
      e.J[r][5] = d[r][0] * -y + d[r][1] * x;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pose_ba_kernel(const float* __restrict__ T_init, const float* __restrict__ pts,
               const float* __restrict__ uv, const float* __restrict__ ur,
               const float* __restrict__ obs_z, const uint8_t* __restrict__ valid, int n,
               Camera cam, int rounds, int iters, float chi2_mono, float chi2_stereo,
               int info_constant, float prior_weight, const float* __restrict__ prior_ptr,
               float* __restrict__ T_out, uint8_t* __restrict__ inliers,
               int32_t* __restrict__ n_inliers, float* __restrict__ chi2_out) {
  // lane blockIdx.x of a batch: its own rows of every operand
  const size_t problem = blockIdx.x;
  T_init += problem * 16;
  pts += problem * n * 3;
  uv += problem * n * 2;
  ur += problem * n;
  obs_z += problem * n;
  valid += problem * n;
  T_out += problem * 16;
  inliers += problem * n;
  chi2_out += problem * n;

  __shared__ float sT[16];
  __shared__ double part[kWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ int counts[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // thread 0 keeps T_init^-1 and the prior weight; the pose lives in sT
  float Tpi[16];
  float w_prior = prior_weight;
  if (tid == 0) {
    float T0[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) T0[q] = T_init[q];
    // [R^T | -R^T t]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Tpi[4 * i + j] = T0[4 * j + i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Tpi[4 * i + 3] = -(Tpi[4 * i] * T0[3] + Tpi[4 * i + 1] * T0[7] + Tpi[4 * i + 2] * T0[11]);
    }
    Tpi[12] = 0.f;
    Tpi[13] = 0.f;
    Tpi[14] = 0.f;
    Tpi[15] = 1.f;
    if (prior_ptr != nullptr) w_prior = *prior_ptr;
#pragma unroll
    for (int q = 0; q < 16; ++q) sT[q] = T0[q];
  }
  __syncthreads();

  int count = 0;
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool robust = rnd < rounds - 1;   // the kernel dropped in the last round
    for (int it = 0; it < iters; ++it) {
      float T[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) T[q] = sT[q];
      double acc[kSums];
#pragma unroll
      for (int q = 0; q < kSums; ++q) acc[q] = 0.0;

      for (int i = tid; i < n; i += kThreads) {
        const float our = __ldg(ur + i);
        const bool stereo = our >= 0.f;
        const float oz = __ldg(obs_z + i);
        const float cz = clamp_min(oz, 1e-3f);
        const float info = info_constant ? 1.f : (oz > 1e-3f ? 1.f / (cz * cz) : 0.f);
        const float th = stereo ? chi2_stereo : chi2_mono;
        const bool inlier = rnd == 0 || chi2_out[i] <= th;
        EdgeEval e;
        eval_edge<true>(T, cam, __ldg(pts + 3 * i), __ldg(pts + 3 * i + 1),
                        __ldg(pts + 3 * i + 2), __ldg(uv + 2 * i), __ldg(uv + 2 * i + 1), our,
                        stereo, info, e);
        float w_huber = 1.f;
        if (robust && !(e.chi2 <= th)) {
          w_huber = sqrtf(th) / sqrtf(clamp_min(e.chi2, 1e-12f));
        }
        const bool on = __ldg(valid + i) != 0 && inlier && e.depth_ok;
        // multiplied, not branched on: a NaN edge poisons the sums as in the
        // plain version, whose guard then zeroes the step
        const float w = info * w_huber * (on ? 1.f : 0.f);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          float Jw[6];
#pragma unroll
          for (int c = 0; c < 6; ++c) Jw[c] = e.J[r][c] * w;
          int k = 0;
#pragma unroll
          for (int a = 0; a < 6; ++a) {
#pragma unroll
            for (int c = 0; c <= a; ++c) {
              acc[k] = fma(static_cast<double>(Jw[a]), static_cast<double>(e.J[r][c]), acc[k]);
              ++k;
            }
          }
#pragma unroll
          for (int a = 0; a < 6; ++a) {
            acc[kTri + a] = fma(static_cast<double>(Jw[a]), static_cast<double>(e.r[r]),
                                acc[kTri + a]);
          }
        }
      }

      // the block's sums in a fixed order: a shuffle tree per warp, then the
      // warps in order
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
        double s = acc[q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) part[warp][q] = s;
      }
      __syncthreads();
      if (tid < kSums) {
        double s = part[0][tid];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += part[w][tid];
        sums[tid] = static_cast<float>(s);
      }
      __syncthreads();
      if (tid == 0) {
        float Tc[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) Tc[q] = sT[q];
        lm_step(sums, Tpi, w_prior, Tc);
#pragma unroll
        for (int q = 0; q < 16; ++q) sT[q] = Tc[q];
      }
      __syncthreads();
    }

    // chi2 at the round's pose; it classifies the edges for the next round
    float T[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) T[q] = sT[q];
    const bool last = rnd == rounds - 1;
    for (int i = tid; i < n; i += kThreads) {
      const float our = __ldg(ur + i);
      const bool stereo = our >= 0.f;
      const float oz = __ldg(obs_z + i);
      const float cz = clamp_min(oz, 1e-3f);
      const float info = info_constant ? 1.f : (oz > 1e-3f ? 1.f / (cz * cz) : 0.f);
      EdgeEval e;
      eval_edge<false>(T, cam, __ldg(pts + 3 * i), __ldg(pts + 3 * i + 1),
                       __ldg(pts + 3 * i + 2), __ldg(uv + 2 * i), __ldg(uv + 2 * i + 1), our,
                       stereo, info, e);
      chi2_out[i] = e.chi2;
      if (last) {
        const bool in = __ldg(valid + i) != 0 && e.chi2 <= (stereo ? chi2_stereo : chi2_mono);
        inliers[i] = in ? 1 : 0;
        count += in ? 1 : 0;
      }
    }
  }

  count = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(count)));
  if (lane == 0) counts[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += counts[w];
    n_inliers[problem] = total;
#pragma unroll
    for (int q = 0; q < 16; ++q) T_out[q] = sT[q];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All pointers are device pointers
// of one card, contiguous, for b problems of n edges: T_init [b,4,4], pts
// [b,n,3], uv [b,n,2], ur [b,n], obs_z [b,n] (float32), valid [b,n] (bytes
// 0/1); outputs T_out [b,4,4], inliers [b,n] (bytes 0/1), n_inliers [b]
// int32, chi2 [b,n] float32.  `prior_ptr`, if not null, points to a float32
// device scalar that replaces `prior_weight`.  rounds >= 1, iters >= 0.  The
// launch goes on `stream` of the current device and does not synchronise.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int pose_ba_launch(const float* T_init, const float* pts, const float* uv,
                              const float* ur, const float* obs_z, const uint8_t* valid, int b,
                              int n, float fx, float fy, float cx, float cy, float bf,
                              int rounds, int iters, float chi2_mono, float chi2_stereo,
                              int info_constant, float prior_weight, const float* prior_ptr,
                              float* T_out, uint8_t* inliers, int32_t* n_inliers, float* chi2,
                              cudaStream_t stream) {
  if (b <= 0) return 0;
  if (n < 0 || rounds < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Camera cam{fx, fy, cx, cy, bf};
  pose_ba_kernel<<<b, kThreads, 0, stream>>>(T_init, pts, uv, ur, obs_z, valid, n, cam, rounds,
                                             iters, chi2_mono, chi2_stereo, info_constant,
                                             prior_weight, prior_ptr, T_out, inliers, n_inliers,
                                             chi2);
  return static_cast<int>(cudaGetLastError());
}
