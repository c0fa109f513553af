// Fused windowed Hamming matcher for Hopper (sm_90a).
//
// Replaces the TPU kernel structure_plp_slam_tpu/ops/pallas_matching.py
// (_kernel, launched by fused_match). For every landmark row it finds the
// best and second-best Hamming distance, and the argmin, over the
// keypoints inside the row's window:
//   |u - x| <= radius, |v - y| <= radius, |level - kp_level| <= 1.5,
// distances outside the window count as 1024 (HAMMING_MASKED). Ties give
// the lowest keypoint index; second-best removes only the argmin column,
// so duplicate minima give second == best; an all-masked row gives
// (1024, 1024, 0). This is exactly fused_match_reference / the plain
// version in ops/fused_match.py.
//
// What bounds it. The TPU kernel computes every landmark-keypoint distance
// as a bf16 bit-plane matmul on the MXU. Here a distance is 8 x
// popc(a ^ b) on the packed 32-bit words; the popcount unit (16 per SM per
// clock) is the limit when every pair is in a window. The inputs are small
// (48 B per landmark, 44 B per keypoint) and the output is 12 B per row,
// so device-memory bytes never bound it. Most pairs lie outside their
// row's window, and most rows in the fuse call are inactive (radius <= 0).
//
// Design. One warp per landmark row, 8 rows per block. Keypoints stream
// through shared memory in tiles of 256 (descriptor words stored
// word-major, so a warp reads 32 consecutive keypoints bank-conflict free).
// Each lane keeps the row's 8 words in registers, tests the window first
// and runs the 8 popcounts only inside it, and keeps a running
// (best, second, idx) over its keypoints in increasing index order. The
// warp then merges the 32 partial results with __shfl_xor_sync under the
// Pallas kernel's merge rule (pallas_matching.py:94-96) with the index as
// tie-breaker. A block whose 8 rows are all inactive skips the keypoint
// loop. The [L, N] distance matrix is never written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kTile = 256;
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kMasked = 1024;

__device__ __forceinline__ void merge(int& best, int& second, int& idx,
                                      int ob, int os, int oi) {
  const bool take = (ob < best) || (ob == best && oi < idx);
  const int nb = min(best, ob);
  second = min(min(second, os), max(best, ob));
  idx = take ? oi : idx;
  best = nb;
}

__global__ void __launch_bounds__(kThreads)
fused_match_kernel(const int32_t* __restrict__ lm_desc,   // [L, 8]
                   const float* __restrict__ lm_meta,     // [L, 4]
                   const int32_t* __restrict__ kp_desc,   // [N, 8]
                   const float* __restrict__ kp_meta,     // [N, 3]
                   float* __restrict__ out_best,          // [L]
                   float* __restrict__ out_second,        // [L]
                   int32_t* __restrict__ out_idx,         // [L]
                   int L, int N) {
  __shared__ uint32_t s_desc[8][kTile];
  __shared__ float s_x[kTile];
  __shared__ float s_y[kTile];
  __shared__ float s_l[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;

  float u = 0.f, v = 0.f, rad = -1.f, lvl = 0.f;
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = 0u;
  if (row < L) {
    const float4 m = reinterpret_cast<const float4*>(lm_meta)[row];
    u = m.x; v = m.y; rad = m.z; lvl = m.w;
    const uint4* d = reinterpret_cast<const uint4*>(lm_desc + 8 * (size_t)row);
    const uint4 a = d[0], b = d[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
  // radius < 0 (and NaN-free) admits no keypoint: |du| >= 0 > radius.
  const bool active = (row < L) && !(rad < 0.f);
  const bool any_active = __syncthreads_or(active) != 0;

  int best = kMasked, second = kMasked, idx = 0;
  if (any_active) {
    for (int base = 0; base < N; base += kTile) {
      const int j = base + threadIdx.x;
      if (j < N) {
        const uint4* d = reinterpret_cast<const uint4*>(kp_desc + 8 * (size_t)j);
        const uint4 a = d[0], b = d[1];
        s_desc[0][threadIdx.x] = a.x; s_desc[1][threadIdx.x] = a.y;
        s_desc[2][threadIdx.x] = a.z; s_desc[3][threadIdx.x] = a.w;
        s_desc[4][threadIdx.x] = b.x; s_desc[5][threadIdx.x] = b.y;
        s_desc[6][threadIdx.x] = b.z; s_desc[7][threadIdx.x] = b.w;
        s_x[threadIdx.x] = kp_meta[3 * (size_t)j + 0];
        s_y[threadIdx.x] = kp_meta[3 * (size_t)j + 1];
        s_l[threadIdx.x] = kp_meta[3 * (size_t)j + 2];
      }
      __syncthreads();
      if (active) {
        const int count = min(kTile, N - base);
        for (int t = lane; t < count; t += 32) {
          const bool in_win = (fabsf(u - s_x[t]) <= rad) &&
                              (fabsf(v - s_y[t]) <= rad) &&
                              (fabsf(lvl - s_l[t]) <= 1.5f);
          if (in_win) {
            int dist = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) dist += __popc(w[k] ^ s_desc[k][t]);
            if (dist < best) {
              second = best;
              best = dist;
              idx = base + t;
            } else if (dist < second) {
              second = dist;
            }
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int os = __shfl_xor_sync(0xffffffffu, second, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    merge(best, second, idx, ob, os, oi);
  }
  if (lane == 0 && row < L) {
    out_best[row] = (float)best;
    out_second[row] = (float)second;
    out_idx[row] = idx;
  }
}

}  // namespace

extern "C" int fused_match_launch(const void* lm_desc, const void* lm_meta,
                                  const void* kp_desc, const void* kp_meta,
                                  void* out_best, void* out_second,
                                  void* out_idx, int L, int N, void* stream) {
  if (L <= 0) return 0;
  const int blocks = (L + kRowsPerBlock - 1) / kRowsPerBlock;
  fused_match_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)lm_desc, (const float*)lm_meta, (const int32_t*)kp_desc,
      (const float*)kp_meta, (float*)out_best, (float*)out_second,
      (int32_t*)out_idx, L, N);
  return (int)cudaGetLastError();
}
