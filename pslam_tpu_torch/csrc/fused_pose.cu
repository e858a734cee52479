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
// What bounds it on this card: one call reads 8 x 4096 floats (128 KB) and
// does ~100 flops per edge, so it is latency-bound: the pose solve calls it
// 49 times in a dependent chain, and each call is a launch plus a block-wide
// reduction. The TPU kernel formed H, b and the cost from one S S^T product
// on the MXU; that is a matrix-unit device and is not carried over.
//
// Design: a single block of 512 threads strides over the edges; each thread
// accumulates the 21 upper-triangle entries of H, the 6 entries of b and the
// cost in registers (f32), then a fixed warp-shuffle tree and a shared-memory
// pass over the 16 warps reduce them in a fixed order, so the result is
// deterministic (no atomics). The formulas follow pallas_pose.py:53-97.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;  // 21 (H upper triangle) + 6 (b) + 1 (cost)

// par: [T_cw row-major (16), fx, fy, cx, cy, bf, use_huber, 0...] (128)
// data rows: [X0, X1, X2, obs_u, obs_v, obs_ur, inv_sigma2, active] (8, E)
__global__ void __launch_bounds__(kThreads) pose_terms(
    const float* __restrict__ data, const float* __restrict__ par, int E,
    float* __restrict__ H_out, float* __restrict__ b_out,
    float* __restrict__ cost_out, float* __restrict__ chi2_out) {
  __shared__ float s_part[kWarps][kSums];

  const float R00 = par[0], R01 = par[1], R02 = par[2], t0 = par[3];
  const float R10 = par[4], R11 = par[5], R12 = par[6], t1 = par[7];
  const float R20 = par[8], R21 = par[9], R22 = par[10], t2 = par[11];
  const float fx = par[16], fy = par[17], cx = par[18], cy = par[19], bf = par[20];
  const bool use_huber = par[21] > 0.5f;
  const float delta_mono = sqrtf(5.991f);
  const float delta_stereo = sqrtf(7.815f);

  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;

  for (int e = threadIdx.x; e < E; e += kThreads) {
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

  // Fixed-order reduction: warp shuffle tree, then warp 0 over the warps.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) s_part[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_part[w][threadIdx.x];
    const int k = threadIdx.x;
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
}

}  // namespace

// data (8, E) f32, par (128,) f32 -> H (6, 6), b (6,), cost (1,), chi2 (E,) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int pslam_fused_pose(const void* data, const void* par, int E, void* H,
                                void* b, void* cost, void* chi2, void* stream) {
  pose_terms<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(par), E,
      static_cast<float*>(H), static_cast<float*>(b), static_cast<float*>(cost),
      static_cast<float*>(chi2));
  return static_cast<int>(cudaGetLastError());
}
