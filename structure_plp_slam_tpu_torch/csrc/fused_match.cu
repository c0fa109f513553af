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
// (1024, 1024, 0). A row is active unless radius < 0 (radius 0 admits a
// keypoint at exactly its pixel; a NaN radius is active and admits
// nothing). This is exactly fused_match_reference / the plain version in
// ops/fused_match.py.
//
// What bounds it, by regime (times: chip_smoke.py on an H100, PERF.md).
// - Sparse calls (the tracker's: a few hundred active rows among 1-8 k,
//   about 2% of their pairs in a window): latency. The arithmetic is well
//   under a microsecond of the card; the time is the launch, the chain of
//   dependent loads and barriers before the keypoints are in shared
//   memory, and a short walk over the tiles.
// - All-inactive calls (fuse on the main path): the launch and one pass
//   over the rows' meta and the outputs.
// - Dense calls (most rows active, ~20% of pairs in a window): issue rate
//   on the CUDA cores. A distance as 8 x POPC per pair would be limited by
//   the popcount unit (16 per SM per clock); on the binary tensor cores a
//   whole 16 x 8 tile is one instruction, and the window tests and the
//   top-2 fold around it (about 60 instructions a tile) are the limit.
//
// Design.
// - Strips and active-row compaction. A block of 8 warps takes a strip of
//   16-64 landmark rows (16, doubled while the grid would exceed 4 blocks
//   per SM). It reads the strip's meta in one coalesced pass, writes
//   (1024, 1024, 0) for its inactive rows, ballots the active ones and
//   packs them, with their meta and descriptors, into shared memory. A
//   strip with no active row exits before any keypoint load.
// - The keypoints stay in shared memory. One thread starts a TMA bulk copy
//   (cp.async.bulk on an mbarrier) of all N descriptors while the others
//   load the keypoint meta, eight keypoints a thread in flight, into one
//   float4 per keypoint (x, y, level, key term; packed here, so the
//   caller's [N, 3] layout stays). After the barrier that ends this
//   set-up no block-wide barrier remains in the keypoint loop. Above kResident keypoints a two-stage ring of
//   kChunk-keypoint chunks takes the single load's place (one barrier a
//   chunk, there only).
// - Work items. The active rows form groups of 16; the 8 warps split the
//   keypoint tiles of each group into 8 / groups slices, so every warp has
//   work even when a strip holds a handful of active rows.
// - Distances on the binary tensor cores. A warp walks its slice 8
//   keypoints at a time, the next tile's operands loading during this
//   one. Each thread tests the windows of its 2 rows x 2 keypoints of the
//   16 x 8 tile; a tile with no pair in any window is skipped
//   (__any_sync). Otherwise one
//   mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc gives
//   z = popc(~a & b), and popc(a ^ b) = 2 z + popc(a) - popc(b) exactly
//   (the .xor.popc form is deprecated on sm_90). A candidate is one 32-bit
//   key, distance << 21 | column, so the smaller key is the smaller
//   distance and then the lower column; popc(b) and the column sit in the
//   keypoint's meta (written, once the descriptors land, by the warps
//   whose slice holds it), popc(a) in a register. Out-of-window pairs get no key, and each thread
//   keeps the two smallest keys per row with two min/max. The 4 threads of
//   a row, then the warps of a group, merge their two smallest keys. The
//   best key gives the distance and the argmin (the lowest column on
//   ties); the second key gives second-best over the other columns, which
//   equals best on a tie, as the Pallas kernel's merge
//   (pallas_matching.py:92-96) gives. The [L, N] matrix is never written.
// - One route. The b1 mma takes every tile with a pair in a window; a
//   per-lane popcount route for sparse groups would save nothing here,
//   since a sparse tile costs the same window tests either way.
// - Counting the route. The kernel is built twice from this source: as is,
//   and with kCount, where each warp counts the tiles it walks and those
//   it sends to the mma in two shared-memory slots (lane 0) and adds them
//   at its end to two device counters. It is a build of its own because
//   a register counter spilled at the 64-register cap and the slots
//   slowed the dense case.
//   fused_match_count_tiles switches the launches that follow to the
//   counting build and reads the counters, so the route a call took is
//   measured; every other launch takes the build without counters.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStrip = 64;       // rows per block, at most
constexpr int kMinStrip = 16;
constexpr int kMaxBlocks = 4 * 132; // H100 SXM: 132 SMs
constexpr int kResident = 2048;     // keypoints held whole in shared memory
constexpr int kChunk = 1024;        // ring chunk above kResident
constexpr int kKpBytes = 32 + 16;   // descriptor + float4 meta
// Keypoint slots in one buffer: the set (or chunk) rounded up to whole
// tiles, plus one tile that the loop's prefetch may read past the end.
__host__ __device__ constexpr int slots(int n) { return ((n + 7) & ~7) + 8; }
constexpr int kMaxDynSmem = 2 * slots(kChunk) * kKpBytes;
static_assert(slots(kResident) <= 2 * slots(kChunk), "resident set exceeds the ring");
static_assert(kMaxStrip <= 64 && kMaxStrip / 16 <= kWarps, "a warp per group at least");
constexpr int kMasked = 1024;
// A candidate is one key, distance << kColBits | column: the smaller key
// is the smaller distance, then the lower column. kNone sorts last.
constexpr int kColBits = 21;
constexpr uint32_t kNone = 0xffffffffu;

// Tiles walked by warps with active rows, and tiles sent to the b1 mma,
// summed over launches until read with reset.
__device__ unsigned long long g_tiles[2];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One thread: expect `bytes` on `bar`, then copy them global -> shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// d = popc over k of (a & b) for a 16 x 256 bit tile of rows (A) and a
// 256 x 8 bit tile of keypoints (B). Fragments: thread (g = lane / 4,
// t = lane % 4) holds a = {row g word 2t, row g+8 word 2t, row g word
// 2t+1, row g+8 word 2t+1}, b = {keypoint g word 2t, word 2t+1}, and
// d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

__device__ __forceinline__ bool in_window(const float4& r, const float4& k) {
  return (fabsf(r.x - k.x) <= r.z) & (fabsf(r.y - k.y) <= r.z) & (fabsf(r.w - k.z) <= 1.5f);
}

// The two smallest keys seen: best = k1, second-best = k2's distance.
// With z = popc(~a & b), popc(a ^ b) = 2 z + popc(a) - popc(b), so a key
// is z << (kColBits + 1) plus a row term, popc(a) << kColBits, plus a
// keypoint term, col - (popc(b) << kColBits), kept in the keypoint's meta.
struct Top2 {
  uint32_t k1 = kNone, k2 = kNone;

  __device__ __forceinline__ void fold(uint32_t key) {
    k2 = min(k2, max(k1, key));
    k1 = min(k1, key);
  }

  // Merge the top two of a disjoint set of columns.
  __device__ __forceinline__ void merge(uint32_t o1, uint32_t o2) {
    k2 = min(min(k2, o2), max(k1, o1));
    k1 = min(k1, o1);
  }

  __device__ __forceinline__ void merge_quad() {  // the 4 threads of a row
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const uint32_t o1 = __shfl_xor_sync(0xffffffffu, k1, off);
      const uint32_t o2 = __shfl_xor_sync(0xffffffffu, k2, off);
      merge(o1, o2);
    }
  }
};

__device__ __forceinline__ uint32_t key(bool in, int z, int row_term, float kp_term) {
  return in ? ((uint32_t)z << (kColBits + 1)) + (uint32_t)(row_term + __float_as_int(kp_term))
            : kNone;
}

__device__ __forceinline__ int popc8(uint4 a, uint4 b) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w) + __popc(b.x) + __popc(b.y) +
         __popc(b.z) + __popc(b.w);
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads, 4)
fused_match_kernel(const int32_t* __restrict__ lm_desc,   // [L, 8]
                   const float* __restrict__ lm_meta,     // [L, 4]
                   const int32_t* __restrict__ kp_desc,   // [N, 8]
                   const float* __restrict__ kp_meta,     // [N, 3]
                   float* __restrict__ out_best,          // [L]
                   float* __restrict__ out_second,        // [L]
                   int32_t* __restrict__ out_idx,         // [L]
                   int L, int N, int strip) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t s_bar[2];
  __shared__ uint32_t s_mask[kMaxStrip / 32];
  __shared__ int s_rows[kMaxStrip];
  __shared__ float4 s_lmeta[kMaxStrip];
  __shared__ uint4 s_ldesc[kMaxStrip][2];
  __shared__ uint2 s_part[kWarps][16];
  __shared__ int s_walked[kWarps];  // tiles walked, per warp
  __shared__ int s_issued[kWarps];  // ... and sent to the mma

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // ---- the strip: meta, inactive rows out, ballot of the active ones ----
  const int row = blockIdx.x * strip + tid;
  const bool mine = tid < strip && row < L;
  float4 m = make_float4(0.f, 0.f, -1.f, 0.f);
  if (mine) m = reinterpret_cast<const float4*>(lm_meta)[row];
  const bool active = mine && N > 0 && !(m.z < 0.f);
  uint4 d0 = make_uint4(0u, 0u, 0u, 0u), d1 = d0;  // an active row's words, in
  if (active) {                                    // flight over the barrier
    d0 = reinterpret_cast<const uint4*>(lm_desc)[2 * (size_t)row];
    d1 = reinterpret_cast<const uint4*>(lm_desc)[2 * (size_t)row + 1];
  }
  if (mine && !active) {
    out_best[row] = (float)kMasked;
    out_second[row] = (float)kMasked;
    out_idx[row] = 0;
  }
  const uint32_t ballot = __ballot_sync(0xffffffffu, active);
  if (lane == 0 && warp < kMaxStrip / 32) s_mask[warp] = ballot;
  if (kCount && tid < kWarps) s_walked[tid] = s_issued[tid] = 0;
  if (tid == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int A = 0, before = 0;  // active rows in the strip, and in warps below this one
#pragma unroll
  for (int w = 0; w < kMaxStrip / 32; ++w) {
    const int n = __popc(s_mask[w]);
    before += w < warp ? n : 0;
    A += n;
  }
  if (A == 0) return;  // no keypoint load at all

  // ---- keypoints into shared memory: [bufs][nslot][8] words, then
  // [bufs][nslot] float4 meta (x, y, level, key term); the slots past the
  // set have NaN meta, which no window admits ----
  const bool ring = N > kResident;
  const int cap = ring ? kChunk : N;
  const int nslot = slots(cap);
  const int nchunks = (N + cap - 1) / cap;
  uint32_t* s_kdesc = reinterpret_cast<uint32_t*>(smem);
  float4* s_kmeta = reinterpret_cast<float4*>(smem + (ring ? 2 : 1) * nslot * 32);

  auto load_chunk = [&](int c) {
    const int b = c & 1, start = c * cap, len = min(cap, N - start);
    if (tid == 0)
      bulk_load(s_kdesc + (size_t)b * nslot * 8, kp_desc + 8 * (size_t)start,
                (uint32_t)len * 32u, &s_bar[b]);
    float4* meta = s_kmeta + (size_t)b * nslot;
    // Eight keypoints a thread in flight at once: one trip to memory for
    // up to 2048 keypoints.
    for (int j0 = tid; j0 < nslot; j0 += 8 * kThreads) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + u * kThreads;
        const float nan = __int_as_float(0x7fffffff);
        v[u] = make_float4(nan, nan, nan, 0.f);
        if (j < len) {
          const float* p = kp_meta + 3 * ((size_t)start + j);
          v[u].x = p[0];
          v[u].y = p[1];
          v[u].z = p[2];
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u * kThreads < nslot) meta[j0 + u * kThreads] = v[u];
    }
  };
  load_chunk(0);

  // ---- compaction: active rows packed in strip order ----
  if (active) {
    const int pos = before + __popc(ballot & ((1u << lane) - 1u));
    s_rows[pos] = row;
    s_lmeta[pos] = m;
    s_ldesc[pos][0] = d0;
    s_ldesc[pos][1] = d1;
  }
  __syncthreads();

  // ---- this warp's work item: group q of 16 active rows, slice s of the
  // keypoint tiles ----
  const int groups = (A + 15) >> 4;
  const int slices = kWarps / groups;
  const bool has_item = warp < groups * slices;
  const int q = warp / slices, s = warp % slices;
  const int g = lane >> 2, t = lane & 3;
  float4 r0 = make_float4(0.f, 0.f, -1.f, 0.f), r1 = r0;  // radius -1: no window
  uint32_t na[4] = {~0u, ~0u, ~0u, ~0u};  // ~a: the rows' words, complemented
  int term0 = 0, term1 = 0;               // the rows' key terms, popc(a) << kColBits
  if (has_item) {
    const int i0 = 16 * q + g, i1 = i0 + 8;
    if (i0 < A) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(s_ldesc[i0]);
      r0 = s_lmeta[i0];
      na[0] = ~w[2 * t];
      na[2] = ~w[2 * t + 1];
      term0 = popc8(s_ldesc[i0][0], s_ldesc[i0][1]) << kColBits;
    }
    if (i1 < A) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(s_ldesc[i1]);
      r1 = s_lmeta[i1];
      na[1] = ~w[2 * t];
      na[3] = ~w[2 * t + 1];
      term1 = popc8(s_ldesc[i1][0], s_ldesc[i1][1]) << kColBits;
    }
  }

  Top2 top0, top1;  // rows g and g + 8 of the group
  for (int c = 0; c < nchunks; ++c) {
    const int b = c & 1;
    // Ring only: chunk c's meta is stored and chunk c-1 is consumed.
    if (c > 0) __syncthreads();
    mbar_wait(&s_bar[b], (uint32_t)(c >> 1) & 1u);
    if (c + 1 < nchunks) load_chunk(c + 1);
    if (!has_item) continue;
    const int start = c * cap, len = min(cap, N - start), tiles = (len + 7) >> 3;
    const int lo = s * tiles / slices, hi = (s + 1) * tiles / slices;
    if (kCount && lane == 0) s_walked[warp] += hi - lo;
    const uint32_t* kd = s_kdesc + (size_t)b * nslot * 8;
    float4* km = s_kmeta + (size_t)b * nslot;
    // The key terms of this slice's keypoints, from the descriptors just
    // landed. Every warp of the slice writes the same values, so no block
    // barrier is needed, only this warp's own.
    for (int j = 8 * lo + lane; j < min(8 * hi, len); j += 32) {
      const uint4* w = reinterpret_cast<const uint4*>(kd + 8 * j);
      km[j].w = __int_as_float(start + j - (popc8(w[0], w[1]) << kColBits));
    }
    __syncwarp();
    // Software pipeline: the next tile's operands load during this one
    // (the buffer has a spare tile past its end).
    const float4* kmp = km + 8 * lo + 2 * t;
    const uint32_t* kdp = kd + 64 * lo + 8 * g + 2 * t;
    float4 k0 = kmp[0], k1 = kmp[1];
    uint2 bw = *reinterpret_cast<const uint2*>(kdp);
#pragma unroll 2
    for (int tile = lo; tile < hi; ++tile) {
      const float4 c0 = k0, c1 = k1;
      const uint2 cb = bw;
      kmp += 8;
      kdp += 64;
      k0 = kmp[0];
      k1 = kmp[1];
      bw = *reinterpret_cast<const uint2*>(kdp);
      const bool w00 = in_window(r0, c0), w01 = in_window(r0, c1);
      const bool w10 = in_window(r1, c0), w11 = in_window(r1, c1);
      if (!__any_sync(0xffffffffu, w00 | w01 | w10 | w11)) continue;
      int z[4];
      mma_and_popc(z, na, cb.x, cb.y);
      if (kCount && lane == 0) atomicAdd(&s_issued[warp], 1);
      top0.fold(key(w00, z[0], term0, c0.w));
      top0.fold(key(w01, z[1], term0, c1.w));
      top1.fold(key(w10, z[2], term1, c0.w));
      top1.fold(key(w11, z[3], term1, c1.w));
    }
  }
  top0.merge_quad();
  top1.merge_quad();
  if (kCount && has_item && lane == 0) {
    atomicAdd(&g_tiles[0], (unsigned long long)s_walked[warp]);
    atomicAdd(&g_tiles[1], (unsigned long long)s_issued[warp]);
  }
  if (has_item && t == 0) {
    s_part[warp][g] = make_uint2(top0.k1, top0.k2);
    s_part[warp][g + 8] = make_uint2(top1.k1, top1.k2);
  }
  __syncthreads();

  // ---- merge the slices of each active row, write it out ----
  if (tid < A) {
    const int w0 = (tid >> 4) * slices, r = tid & 15;
    Top2 top;
    for (int k = 0; k < slices; ++k) top.merge(s_part[w0 + k][r].x, s_part[w0 + k][r].y);
    const bool hit = top.k1 != kNone;
    const int out_row = s_rows[tid];
    out_best[out_row] = hit ? (float)(top.k1 >> kColBits) : (float)kMasked;
    out_second[out_row] = top.k2 != kNone ? (float)(top.k2 >> kColBits) : (float)kMasked;
    out_idx[out_row] = hit ? (int)(top.k1 & ((1u << kColBits) - 1u)) : 0;
  }
}

bool g_counting = false;  // launch fused_match_kernel<true>

}  // namespace

extern "C" int fused_match_launch(const void* lm_desc, const void* lm_meta,
                                  const void* kp_desc, const void* kp_meta,
                                  void* out_best, void* out_second,
                                  void* out_idx, int L, int N, void* stream) {
  if (L <= 0) return 0;
  if (N > (1 << kColBits)) return (int)cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per device.
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(fused_match_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_match_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in[dev] = true;
  }
  int strip = kMinStrip;
  while (strip < kMaxStrip && (L + strip - 1) / strip > kMaxBlocks) strip <<= 1;
  const size_t smem =
      N > kResident ? 2 * slots(kChunk) * kKpBytes : (N > 0 ? slots(N) * kKpBytes : 0);
  auto kernel = g_counting ? fused_match_kernel<true> : fused_match_kernel<false>;
  kernel<<<(L + strip - 1) / strip, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)lm_desc, (const float*)lm_meta, (const int32_t*)kp_desc,
      (const float*)kp_meta, (float*)out_best, (float*)out_second, (int32_t*)out_idx, L, N,
      strip);
  return (int)cudaGetLastError();
}

// Waits for the current device, reads its tile counters into out[0]
// (walked) and out[1] (sent to the b1 mma), host memory, zeroes them, and
// has the launches that follow take the counting build if `on`.
extern "C" int fused_match_count_tiles(int on, unsigned long long* out) {
  static const unsigned long long zero[2] = {0ull, 0ull};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_tiles, sizeof(g_tiles));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_tiles, zero, sizeof(g_tiles));
  g_counting = on != 0;
  return (int)err;
}
