// Fused projection matcher for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_match_kernel` in
// pslam_tpu/ops/pallas_match.py (launched by `fused_projection_match`).
// For every pair of a projected map point (row, A side) and a frame feature
// (column, B side) it applies the box window |du|,|dv| <= per-row radius, the
// octave window [lev_lo, lev_hi] and both validity flags, then takes the
// 256-bit Hamming distance. It keeps per row the best distance, the
// second-best distance and the best column, and per column the min and
// argmin (for the mutual check). Ties go to the lowest index, as on the TPU.
// Ratio, max-distance and mutual acceptance stay outside.
//
// What bounds it on this card: at the main-path shape (4096 rows x 1000
// columns) the inputs are ~200 KB, so it is neither memory- nor
// FLOP-bound; it is bound by the per-pair window test (4M pairs) and by
// launch latency. The TPU computed the Hamming distance as a +/-1 MXU dot on
// 128x128 tiles; here the descriptors stay packed as 8 uint32 words and the
// distance is 8 popcounts, computed only for the few pairs that pass the
// window (the window keeps well under 1% of pairs on real frames).
//
// Design: one thread per row, 128 rows per block. Column descriptors and
// parameters are staged through shared memory in chunks of 256 columns, so
// every thread of a block reads the same shared word (a broadcast, no bank
// conflicts). Each thread scans columns in increasing order and updates its
// row state on strict `<`, which reproduces the TPU merge including
// equal-distance seconds. Columns reduce across blocks with one 64-bit
// atomicMin of (dist << 32 | row) per surviving pair, so ties go to the
// lowest row; a second small kernel unpacks the keys. The window test is
// plain f32 subtraction and comparison (no FMA), bit-identical to PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;       // "no candidate" distance
constexpr int kRows = 128;          // threads per block, one row each
constexpr int kChunk = 256;         // columns staged per shared-memory step
constexpr int kWords = 8;           // 256-bit descriptor as uint32 words
constexpr unsigned long long kEmpty = ~0ull;

__global__ void init_cols(unsigned long long* __restrict__ col_key, int nb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < nb) col_key[j] = kEmpty;
}

// a_par rows: [u, v, radius, lev_lo, lev_hi, valid, 0, 0] (8, na)
// b_par rows: [u, v, level, valid, 0, 0, 0, 0]           (8, nb)
__global__ void __launch_bounds__(kRows) match_rows(
    const uint32_t* __restrict__ a_words, const float* __restrict__ a_par, int na,
    const uint32_t* __restrict__ b_words, const float* __restrict__ b_par, int nb,
    int* __restrict__ best_out, int* __restrict__ second_out,
    int* __restrict__ bestj_out, unsigned long long* __restrict__ col_key) {
  __shared__ uint32_t s_words[kChunk * kWords];
  __shared__ float s_u[kChunk];
  __shared__ float s_v[kChunk];
  __shared__ float s_l[kChunk];
  __shared__ float s_ok[kChunk];

  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool row_in = i < na;
  float au = 0.f, av = 0.f, ar = 0.f, alo = 0.f, ahi = 0.f;
  bool aok = false;
  uint32_t aw[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) aw[k] = 0u;
  if (row_in) {
    au = a_par[0 * na + i];
    av = a_par[1 * na + i];
    ar = a_par[2 * na + i];
    alo = a_par[3 * na + i];
    ahi = a_par[4 * na + i];
    aok = a_par[5 * na + i] > 0.5f;
#pragma unroll
    for (int k = 0; k < kWords; ++k) aw[k] = a_words[i * kWords + k];
  }

  int best = kBig, second = kBig, bestj = -1;
  for (int j0 = 0; j0 < nb; j0 += kChunk) {
    const int n = min(kChunk, nb - j0);
    __syncthreads();  // previous chunk fully consumed
    for (int t = threadIdx.x; t < n * kWords; t += kRows)
      s_words[t] = b_words[j0 * kWords + t];
    for (int t = threadIdx.x; t < n; t += kRows) {
      s_u[t] = b_par[0 * nb + j0 + t];
      s_v[t] = b_par[1 * nb + j0 + t];
      s_l[t] = b_par[2 * nb + j0 + t];
      s_ok[t] = b_par[3 * nb + j0 + t];
    }
    __syncthreads();
    if (!aok) continue;
    for (int t = 0; t < n; ++t) {
      const float bl = s_l[t];
      const bool cand = (fabsf(au - s_u[t]) <= ar) && (fabsf(av - s_v[t]) <= ar) &&
                        (bl >= alo) && (bl <= ahi) && (s_ok[t] > 0.5f);
      if (!cand) continue;
      int d = 0;
#pragma unroll
      for (int k = 0; k < kWords; ++k) d += __popc(aw[k] ^ s_words[t * kWords + k]);
      const int j = j0 + t;
      if (d < best) {
        second = best;
        best = d;
        bestj = j;
      } else if (d < second) {
        second = d;
      }
      atomicMin(&col_key[j],
                (static_cast<unsigned long long>(d) << 32) | static_cast<unsigned>(i));
    }
  }
  if (row_in) {
    best_out[i] = best;
    second_out[i] = second;
    bestj_out[i] = bestj;
  }
}

__global__ void finish_cols(const unsigned long long* __restrict__ col_key, int nb,
                            int* __restrict__ col_min, int* __restrict__ col_arg) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nb) return;
  const unsigned long long key = col_key[j];
  if (key == kEmpty) {
    col_min[j] = kBig;
    col_arg[j] = 0;
  } else {
    col_min[j] = static_cast<int>(key >> 32);
    col_arg[j] = static_cast<int>(key & 0xffffffffull);
  }
}

}  // namespace

// a_words: (na, 8) uint32 (packed (na, 32) uint8 descriptors), a_par (8, na) f32
// b_words: (nb, 8) uint32, b_par (8, nb) f32
// outputs: best, second, bestj (na,) int32; col_min, col_arg (nb,) int32
// col_key: (nb,) uint64 scratch. Returns cudaGetLastError() after the launches.
extern "C" int pslam_fused_match(const void* a_words, const void* a_par, int na,
                                 const void* b_words, const void* b_par, int nb,
                                 void* best, void* second, void* bestj,
                                 void* col_min, void* col_arg, void* col_key,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* key = static_cast<unsigned long long*>(col_key);
  const int col_blocks = (nb + 255) / 256;
  if (nb > 0) init_cols<<<col_blocks, 256, 0, s>>>(key, nb);
  if (na > 0)
    match_rows<<<(na + kRows - 1) / kRows, kRows, 0, s>>>(
        static_cast<const uint32_t*>(a_words), static_cast<const float*>(a_par), na,
        static_cast<const uint32_t*>(b_words), static_cast<const float*>(b_par), nb,
        static_cast<int*>(best), static_cast<int*>(second), static_cast<int*>(bestj), key);
  if (nb > 0)
    finish_cols<<<col_blocks, 256, 0, s>>>(key, nb, static_cast<int*>(col_min),
                                           static_cast<int*>(col_arg));
  return static_cast<int>(cudaGetLastError());
}
