// Fused pose-optimization edge terms for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_kernel` in pslam_tpu/ops/pallas_pose.py
// (launched by `pose_terms_fused`). For E point edges at one pose it
// transforms each world point, forms the mono or RGB-D stereo reprojection
// residual (obs_ur < 0 marks mono), chi2 with the per-octave 1/sigma^2, the
// Huber weight at sqrt(5.991) / sqrt(7.815) when Huber is on, and the
// analytic 3x6 SE3 Jacobians, and returns the 6x6 normal matrix H,
// b = -sum w J^T r, the robust cost sum w r^2 and chi2 for every edge.
//
// What bounds it on this card: one call at E = 4096 reads 8 x 4096 floats
// (128 KB) and writes 16 KB of chi2, ~0.04 us at the card's memory rate, and
// does ~265 flops per edge (~0.02 us of f32). So its time is latency: the
// load of one edge, the chain of its arithmetic and a 28-way reduction. The
// pose solve calls it 49 times in a dependent chain. The TPU kernel formed
// H, b and the cost from one S S^T product on the MXU; that is a matrix-unit
// design and is not carried over.
//
// Design: one thread block cluster of 8 blocks x 512 threads (8 SMs). At
// E = 4096 each thread owns one edge; larger E strides. Each thread keeps the
// 21 upper-triangle entries of H, the 6 of b and the cost in registers. A
// warp reduce-scatter (5 halving steps, 31 shuffles) leaves lane k with the
// warp's sum k; one pass over the 16 warps gives the block's row of 28 sums in
// shared memory; after a cluster barrier, block 0 reads the 8 rows through
// distributed shared memory in rank order and writes H, b and the cost. Every
// sum is taken in an order fixed by E alone: no atomics, no global scratch,
// one launch, bit-reproducible. The formulas follow pallas_pose.py:53-97.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 8;  // one cluster, the portable cluster size
constexpr int kSums = 28;   // 21 (H upper triangle) + 6 (b) + 1 (cost)

// Sum v[0..2*half) of every lane of the warp so that lane bit `half` picks
// the half it keeps: afterwards v[0..half) holds this lane's kept half,
// summed with the partner's.
template <int half>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = lane & half;
#pragma unroll
  for (int k = 0; k < half; ++k) {
    const float keep = upper ? v[k + half] : v[k];
    const float send = upper ? v[k] : v[k + half];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, half);
  }
}

// par: [T_cw row-major (16), fx, fy, cx, cy, bf, use_huber, 0...] (128)
// data rows: [X0, X1, X2, obs_u, obs_v, obs_ur, inv_sigma2, active] (8, E)
__global__ void __launch_bounds__(kThreads) pose_terms(
    const float* __restrict__ data, const float* __restrict__ par, int E,
    float* __restrict__ H_out, float* __restrict__ b_out,
    float* __restrict__ cost_out, float* __restrict__ chi2_out) {
  __shared__ float s_part[kWarps][kSums];
  __shared__ float s_row[kSums];
  cg::cluster_group cluster = cg::this_cluster();

  const float R00 = par[0], R01 = par[1], R02 = par[2], t0 = par[3];
  const float R10 = par[4], R11 = par[5], R12 = par[6], t1 = par[7];
  const float R20 = par[8], R21 = par[9], R22 = par[10], t2 = par[11];
  const float fx = par[16], fy = par[17], cx = par[18], cy = par[19], bf = par[20];
  const bool use_huber = par[21] > 0.5f;
  const float delta_mono = sqrtf(5.991f);
  const float delta_stereo = sqrtf(7.815f);

  // 28 sums, padded to 32 for the reduce-scatter.
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;

#pragma unroll 1
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < E; e += kBlocks * kThreads) {
    const float X0 = data[0 * E + e], X1 = data[1 * E + e], X2 = data[2 * E + e];
    const float obs_u = data[3 * E + e], obs_v = data[4 * E + e];
    const float obs_r = data[5 * E + e], inv_s2 = data[6 * E + e];
    const float act = data[7 * E + e];

    const float x = R00 * X0 + R01 * X1 + R02 * X2 + t0;
    const float y = R10 * X0 + R11 * X1 + R12 * X2 + t1;
    const float z = R20 * X0 + R21 * X1 + R22 * X2 + t2;
    const float z_safe = fabsf(z) < 1e-9f ? 1e-9f : z;
    const float iz = 1.0f / z_safe;
    const float iz2 = iz * iz;
    const float u = fx * x * iz + cx;
    const float v = fy * y * iz + cy;
    const float urr = u - bf * iz;
    const bool stereo = obs_r >= 0.0f;
    const float sm = stereo ? 1.0f : 0.0f;
    const float r0 = obs_u - u;
    const float r1 = obs_v - v;
    const float r2 = (obs_r - urr) * sm;
    const float rr = r0 * r0 + r1 * r1 + r2 * r2;
    const float chi2 = rr * inv_s2;
    chi2_out[e] = chi2;

    const float delta = stereo ? delta_stereo : delta_mono;
    const float en = sqrtf(fmaxf(chi2, 1e-12f));
    const float w_rob = (use_huber && en > delta) ? delta / en : 1.0f;
    const float w = w_rob * inv_s2 * act;

    const float a = fx * iz;
    const float b = -fx * x * iz2;
    const float c = fy * iz;
    const float d = -fy * y * iz2;
    const float be = b + bf * iz2;
    const float J0[6] = {-(b * y), -(a * z - b * x), a * y, -a, 0.f, -b};
    const float J1[6] = {-(d * y - c * z), d * x, -(c * x), 0.f, -c, -d};
    const float J2[6] = {-(be * y) * sm, -(a * z - be * x) * sm, a * y * sm,
                         -a * sm, 0.f, -be * sm};

    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) {
        acc[k++] += w * (J0[i] * J0[j] + J1[i] * J1[j] + J2[i] * J2[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] -= w * (J0[i] * r0 + J1[i] * r1 + J2[i] * r2);
    acc[27] += w * rr;
  }

  // Warp reduce-scatter: lane k ends with the warp's sum k in acc[0].
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  halve<16>(acc, lane);
  halve<8>(acc, lane);
  halve<4>(acc, lane);
  halve<2>(acc, lane);
  halve<1>(acc, lane);
  if (lane < kSums) s_part[warp][lane] = acc[0];
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_part[w][threadIdx.x];
    s_row[threadIdx.x] = s;
  }
  cluster.sync();  // every block's row is written

  if (cluster.block_rank() == 0 && threadIdx.x < kSums) {
    const int k = threadIdx.x;
    float s = 0.f;
    for (int r = 0; r < kBlocks; ++r) s += cluster.map_shared_rank(s_row, r)[k];
    if (k < 21) {
      // Upper-triangle index k -> (i, j); write both halves of H.
      int i = 0, rem = k;
      while (rem >= 6 - i) {
        rem -= 6 - i;
        ++i;
      }
      const int j = i + rem;
      H_out[i * 6 + j] = s;
      H_out[j * 6 + i] = s;
    } else if (k < 27) {
      b_out[k - 21] = s;
    } else {
      cost_out[0] = s;
    }
  }
  cluster.sync();  // keep every block's shared row alive until block 0 has read it
}

// ---------------------------------------------------------------------------
// The LM step: all the work of one Levenberg-Marquardt iteration of the pose
// solve (solver/pose_opt.py) that falls between two K2 calls, in one launch.
// It takes in the evaluation K2 just wrote (plus the LIL terms when the solve
// has them), accepts or rejects it, updates lambda, and then either proposes
// the next pose into the parameter row the next K2 call reads, or (the last
// step of a round) writes the round's pose into that row and the classify
// call's row and resets lambda and the first-evaluation flag for the next
// round. The
// formulas are those of ops/fused_pose.py lm_step_plain and geometry/lie.py,
// in f32.
//
// What bounds it: nothing but latency. It reads ~100 floats and solves one
// 6x6 system; one warp runs it, every lane computing the same values from
// the same loads (no shuffles, no shared memory), and lane 0 stores.
//
// state (128 floats, 61 used): [T row-major (16), lambda, cost, H (36), b (6),
// first]. first != 0 marks the round's first evaluation, which is taken
// whatever its cost (so a NaN first cost is kept, as the plain loop keeps it).

constexpr int kLmT = 0, kLmLam = 16, kLmCost = 17, kLmH = 18, kLmB = 54, kLmFirst = 60;

// (1 - cos x) / x^2, sin x / x and (x - sin x) / x^3, with the series below
// 1e-2 (geometry/lie.py _cosc, _sinc, _sincc).
__device__ __forceinline__ float lm_sinc(float x) {
  const float x2 = x * x;
  return x < 1e-2f ? 1.0f - x2 / 6.0f + x2 * x2 / 120.0f : sinf(x) / x;
}
__device__ __forceinline__ float lm_cosc(float x) {
  const float x2 = x * x;
  return x < 1e-2f ? 0.5f - x2 / 24.0f + x2 * x2 / 720.0f : (1.0f - cosf(x)) / (x * x);
}
__device__ __forceinline__ float lm_sincc(float x) {
  const float x2 = x * x;
  return x < 1e-2f ? 1.0f / 6.0f - x2 / 120.0f + x2 * x2 / 5040.0f
                   : (x - sinf(x)) / (x * x * x);
}

// x = (H + lam diag(H) + 1e-8 I)^-1 b by LU with partial pivoting (the
// first row of largest magnitude, as LAPACK's getrf picks it). A zero pivot
// gives inf or NaN, never a fault, as torch.linalg.solve_ex without its info.
__device__ __forceinline__ void lm_solve(const float (&H)[36], const float (&b)[6], float lam,
                                         float (&x)[6]) {
  float A[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = H[i * 6 + j];
    // H + lam * diag(diag(H)) + 1e-8 * I, rounded op by op as the plain step.
    A[i][i] = __fadd_rn(__fadd_rn(H[i * 6 + i], __fmul_rn(lam, H[i * 6 + i])), 1e-8f);
    x[i] = b[i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float s = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = s;
        }
        const float s = x[k];
        x[k] = x[i];
        x[i] = s;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      x[i] -= l * x[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
}

// out = se3_exp(xi) @ T (geometry/lie.py se3_exp: Rodrigues R, the left
// Jacobian V, t = V u; xi = [omega, upsilon]).
__device__ __forceinline__ void lm_exp_times(const float (&xi)[6], const float (&T)[16],
                                             float (&out)[16]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float theta = sqrtf(w0 * w0 + w1 * w1 + w2 * w2 + 1e-24f);
  const float K[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float K2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) K2[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
  }
  const float a = lm_sinc(theta), bc = lm_cosc(theta), c = lm_sincc(theta);
  float E[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.f : 0.f;
      E[i][j] = id + a * K[i][j] + bc * K2[i][j];
      t += (id + bc * K[i][j] + c * K2[i][j]) * xi[3 + j];
    }
    E[i][3] = t;
  }
  E[3][0] = 0.f;
  E[3][1] = 0.f;
  E[3][2] = 0.f;
  E[3][3] = 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[i * 4 + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                       E[i][3] * T[12 + j];
    }
  }
}

// H_lil, b_lil, cost_lil: null, or the LIL terms at the same pose. par_in:
// the row K2 just evaluated (its first 16 floats are the pose). par_out: the
// next proposal's row, or with close the classify row; with close par_in
// receives the round's pose too, where the next round starts.
__global__ void __launch_bounds__(32) lm_step(
    const float* __restrict__ H_new, const float* __restrict__ b_new,
    const float* __restrict__ cost_new, const float* __restrict__ H_lil,
    const float* __restrict__ b_lil, const float* __restrict__ cost_lil, float* par_in,
    float* state, float* par_out, int close) {
  const bool first = state[kLmFirst] != 0.f;
  float cost_e = cost_new[0];
  if (cost_lil != nullptr) cost_e = cost_e + cost_lil[0];
  const float cost_old = state[kLmCost];
  // A NaN cost_e compares false: rejected, unless it is the first.
  const bool accept = first || cost_e < cost_old;
  const bool move = !first && accept;

  float T[16], H[36], b[6];
#pragma unroll
  for (int i = 0; i < 16; ++i) T[i] = move ? par_in[i] : state[kLmT + i];
#pragma unroll
  for (int i = 0; i < 36; ++i) {
    float h = H_new[i];
    if (H_lil != nullptr) h = h + H_lil[i];
    H[i] = accept ? h : state[kLmH + i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = b_new[i];
    if (b_lil != nullptr) v = v + b_lil[i];
    b[i] = accept ? v : state[kLmB + i];
  }
  float lam = state[kLmLam];
  if (!first) lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-10f), 1e6f);
  const float cost = accept ? cost_e : cost_old;
  __syncwarp();  // every lane has read state and par_in before lane 0 writes them

  float P[16];
  if (!close) {
    float dx[6];
    lm_solve(H, b, lam, dx);
    lm_exp_times(dx, T, P);
  }
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    state[kLmT + i] = T[i];
    par_out[i] = close ? T[i] : P[i];
    if (close) par_in[i] = T[i];
  }
#pragma unroll
  for (int i = 0; i < 36; ++i) state[kLmH + i] = H[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) state[kLmB + i] = b[i];
  state[kLmCost] = cost;
  state[kLmLam] = close ? 1e-4f : lam;
  state[kLmFirst] = close ? 1.f : 0.f;
}
}  // namespace

// data (8, E) f32, par (128,) f32 -> H (6, 6), b (6,), cost (1,), chi2 (E,) f32.
// One cluster of kBlocks blocks. Returns the launch's error code (0 on success).
extern "C" int pslam_fused_pose(const void* data, const void* par, int E, void* H,
                                void* b, void* cost, void* chi2, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBlocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pose_terms, static_cast<const float*>(data), static_cast<const float*>(par), E,
      static_cast<float*>(H), static_cast<float*>(b), static_cast<float*>(cost),
      static_cast<float*>(chi2));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One LM step of the pose solve (see lm_step above): H_new (6, 6), b_new (6,),
// cost_new (1,) from K2; H_lil, b_lil, cost_lil the LIL terms or all null;
// par_in, par_out (1, 128) rows; state (128,) f32 updated in place. One
// warp. Returns the launch's error code.
extern "C" int pslam_lm_step(const void* H_new, const void* b_new, const void* cost_new,
                             const void* H_lil, const void* b_lil, const void* cost_lil,
                             void* par_in, void* state, void* par_out, int close,
                             void* stream) {
  lm_step<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(H_new), static_cast<const float*>(b_new),
      static_cast<const float*>(cost_new), static_cast<const float*>(H_lil),
      static_cast<const float*>(b_lil), static_cast<const float*>(cost_lil),
      static_cast<float*>(par_in), static_cast<float*>(state), static_cast<float*>(par_out),
      close);
  return static_cast<int>(cudaGetLastError());
}
