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
// columns) the inputs and outputs are ~0.4 MB (~0.1 us at the memory rate);
// the per-pair window test (4.1M pairs x ~9 f32 operations, ~0.55 us) sets
// the bound. The TPU computed the Hamming distance as a +/-1 MXU dot on
// 128x128 tiles; here the descriptors stay packed as 8 uint32 words and the
// distance is 8 popcounts, computed only for the few pairs that pass the
// window (well under 1% of pairs on real frames), so tensor cores would not
// help.
//
// Design: a 2D grid of row tiles (128 rows, one thread per row, its 8
// descriptor words in registers) x column slabs (128 columns staged in
// shared memory; every thread of a block reads the same shared word, a
// broadcast). At 4096 x 1000 that is 32 x 8 = 256 blocks, so every SM has
// work and each thread's dependent loop is 128 steps. Each thread scans its
// slab in increasing column order and updates (best, second, best column)
// on strict `<`, then writes the triple to a (3, slabs, na) scratch. The
// finish kernel merges a row's slabs in slab order: best = the smaller, the
// lower slab winning ties; second = min(max(b1, b2), min(s1, s2)), the
// second-smallest of the multiset, equal-distance seconds included. That
// reproduces the serial scan exactly. Columns reduce across blocks with one
// 64-bit atomicMin of (dist << 32 | row) per surviving pair, which does not
// depend on order, so ties go to the lowest row; the finish kernel unpacks
// the keys. Three launches: init, match, finish. The window test is plain f32
// subtraction and comparison (no FMA), bit-identical to PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;  // "no candidate" distance
constexpr int kRows = 128;     // threads per block, one row each
constexpr int kSlab = 128;     // columns per block, staged in shared memory
constexpr int kWords = 8;      // 256-bit descriptor as uint32 words
constexpr int kFinish = 256;   // threads per block of the init / finish kernels
constexpr unsigned long long kEmpty = ~0ull;

__global__ void init_cols(unsigned long long* __restrict__ col_key, int nb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < nb) col_key[j] = kEmpty;
}

// a_par rows: [u, v, radius, lev_lo, lev_hi, valid, 0, 0] (8, na)
// b_par rows: [u, v, level, valid, 0, 0, 0, 0]           (8, nb)
// row_part: (3, slabs, na) int32 -- best, second, best column per slab.
__global__ void __launch_bounds__(kRows) match_slab(
    const uint32_t* __restrict__ a_words, const float* __restrict__ a_par, int na,
    const uint32_t* __restrict__ b_words, const float* __restrict__ b_par, int nb,
    int* __restrict__ row_part, unsigned long long* __restrict__ col_key) {
  __shared__ uint32_t s_words[kSlab * kWords];
  __shared__ float s_u[kSlab];
  __shared__ float s_v[kSlab];
  __shared__ float s_l[kSlab];
  __shared__ float s_ok[kSlab];

  const int slab = blockIdx.y;
  const int slabs = gridDim.y;
  const int j0 = slab * kSlab;
  const int n = min(kSlab, nb - j0);
  for (int t = threadIdx.x; t < n * kWords; t += kRows) s_words[t] = b_words[j0 * kWords + t];
  for (int t = threadIdx.x; t < n; t += kRows) {
    s_u[t] = b_par[0 * nb + j0 + t];
    s_v[t] = b_par[1 * nb + j0 + t];
    s_l[t] = b_par[2 * nb + j0 + t];
    s_ok[t] = b_par[3 * nb + j0 + t];
  }
  __syncthreads();

  const int i = blockIdx.x * kRows + threadIdx.x;
  if (i >= na) return;
  int best = kBig, second = kBig, bestj = -1;
  if (a_par[5 * na + i] > 0.5f) {
    const float au = a_par[0 * na + i], av = a_par[1 * na + i], ar = a_par[2 * na + i];
    const float alo = a_par[3 * na + i], ahi = a_par[4 * na + i];
    uint32_t aw[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) aw[k] = a_words[i * kWords + k];
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
  const size_t plane = static_cast<size_t>(slabs) * na;
  const size_t at = static_cast<size_t>(slab) * na + i;
  row_part[at] = best;
  row_part[plane + at] = second;
  row_part[2 * plane + at] = bestj;
}

// Thread t merges row t's slabs (t < na) and unpacks column t's key (t < nb).
__global__ void finish(const int* __restrict__ row_part, int na, int slabs,
                       const unsigned long long* __restrict__ col_key, int nb,
                       int* __restrict__ best_out, int* __restrict__ second_out,
                       int* __restrict__ bestj_out, int* __restrict__ col_min,
                       int* __restrict__ col_arg) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < na) {
    const size_t plane = static_cast<size_t>(slabs) * na;
    int best = kBig, second = kBig, bestj = -1;
    for (int s = 0; s < slabs; ++s) {
      const size_t at = static_cast<size_t>(s) * na + t;
      const int b2 = row_part[at], s2 = row_part[plane + at];
      if (b2 < best) {  // strictly smaller: an earlier slab keeps a tie
        second = min(best, s2);
        best = b2;
        bestj = row_part[2 * plane + at];
      } else {
        second = min(second, b2);
      }
    }
    best_out[t] = best;
    second_out[t] = second;
    bestj_out[t] = bestj;
  }
  if (t < nb) {
    const unsigned long long key = col_key[t];
    if (key == kEmpty) {
      col_min[t] = kBig;
      col_arg[t] = 0;
    } else {
      col_min[t] = static_cast<int>(key >> 32);
      col_arg[t] = static_cast<int>(key & 0xffffffffull);
    }
  }
}

}  // namespace

// Column slabs of one call: the first dimension of the row_part scratch.
extern "C" int pslam_fused_match_slabs(int nb) { return (nb + kSlab - 1) / kSlab; }

// a_words: (na, 8) uint32 (packed (na, 32) uint8 descriptors), a_par (8, na) f32
// b_words: (nb, 8) uint32, b_par (8, nb) f32
// outputs: best, second, bestj (na,) int32; col_min, col_arg (nb,) int32
// scratch: row_part (3, pslam_fused_match_slabs(nb), na) int32, col_key (nb,)
// uint64. Returns cudaGetLastError() after the launches.
extern "C" int pslam_fused_match(const void* a_words, const void* a_par, int na,
                                 const void* b_words, const void* b_par, int nb,
                                 void* best, void* second, void* bestj,
                                 void* col_min, void* col_arg, void* row_part,
                                 void* col_key, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* key = static_cast<unsigned long long*>(col_key);
  auto* part = static_cast<int*>(row_part);
  const int slabs = pslam_fused_match_slabs(nb);
  if (nb > 0) init_cols<<<(nb + kFinish - 1) / kFinish, kFinish, 0, s>>>(key, nb);
  if (na > 0 && nb > 0)
    match_slab<<<dim3((na + kRows - 1) / kRows, slabs), kRows, 0, s>>>(
        static_cast<const uint32_t*>(a_words), static_cast<const float*>(a_par), na,
        static_cast<const uint32_t*>(b_words), static_cast<const float*>(b_par), nb, part,
        key);
  const int n = na > nb ? na : nb;
  if (n > 0)
    finish<<<(n + kFinish - 1) / kFinish, kFinish, 0, s>>>(
        part, na, slabs, key, nb, static_cast<int*>(best), static_cast<int*>(second),
        static_cast<int*>(bestj), static_cast<int*>(col_min), static_cast<int*>(col_arg));
  return static_cast<int>(cudaGetLastError());
}
