// Similarity top-k over the CoIC edge-cache keys, for NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels of src/repro/kernels/similarity/kernel.py:
//   similarity_topk_batched_kernel (_topk_batched_kernel, _topk_tile)
//   similarity_lookup_kernel       (_lookup_kernel)
//   similarity_topk_touch_kernel   (_topk_touch_kernel)
// with ONE kernel: the lookup is its k = 1, N = 1 launch, and the touch
// variant adds an epilogue in the same launch.
//
// What bounds it on the H100: reading the keys.  One probe streams the
// (C, D) fp32 key matrix of each group once (C * D * 4 bytes, 4 MiB at
// C = 512, D = 2048: about 1.3 us at 3.35 TB/s); the dot products are a few
// million FMAs, far below the card's rate.  The TPU kernel held a
// (BLOCK_C, D) key tile in VMEM; one 64-row fp32 tile at D = 2048 is already
// 512 KiB, more than a block's shared memory, so nothing here stages keys.
//
// Design, simple and right first:
//   * one block per (group n, query row q); the query row sits in shared
//     memory; 8 warps split the cache rows c = warp, warp + 8, ...;
//   * a warp scores one key row at a time: each lane reads a strided D/32
//     slice (neighbouring lanes on neighbouring addresses), a shuffle
//     reduction gives the dot, and an invalid slot scores -1e30;
//   * lane 0 keeps a sorted top-k in registers.  Candidates are ordered by
//     score descending, then index ascending, so ties go to the lower cache
//     index (lax.top_k order) whatever warp saw them; thread 0 merges the 8
//     warp lists with the same order.  Every slot, valid or not, is a
//     candidate, so an all-invalid row returns indices 0..k-1 at -1e30 (the
//     TPU kernel's iota init) and the k = 1 lookup returns idx 0, -1e30;
//   * touch epilogue (N == 1): once a query's top-1 is final, thread 0 adds
//     one to freq[idx] and raises last_used[idx] to clock when the query is
//     masked in and its score >= threshold.  Atomics over the Q winners
//     replace the TPU kernel's second pass over C; the integer result is the
//     same in any atomic order.  The wrapper passes clones of last_used and
//     freq, since the reference op is functional.
// Keys are read once per query row (from L2 after the first block); a
// later PR can tile queries per block and split C across blocks.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr float kNegInf = -1e30f;   // score of an invalid slot

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// insert (s, i) into the sorted list (ls, li) of length k, best first
__device__ __forceinline__ void insert_topk(float* ls, int* li, int k,
                                            float s, int i) {
  if (!better(s, i, ls[k - 1], li[k - 1])) return;
  int j = k - 1;
  while (j > 0 && better(s, i, ls[j - 1], li[j - 1])) {
    ls[j] = ls[j - 1];
    li[j] = li[j - 1];
    --j;
  }
  ls[j] = s;
  li[j] = i;
}

template <int KM>
__global__ void __launch_bounds__(kWarps * 32)
topk_kernel(const float* __restrict__ q, const float* __restrict__ keys,
            const uint8_t* __restrict__ valid, int Q, int C, int D, int k,
            int* __restrict__ out_idx, float* __restrict__ out_score,
            const uint8_t* __restrict__ qmask, int* last_used, int* freq,
            const int* __restrict__ clock, float threshold, int touch) {
  extern __shared__ float smem[];
  float* qs = smem;                                   // (D,) query row
  float* cand_s = smem + D;                           // (kWarps, KM)
  int* cand_i = reinterpret_cast<int*>(cand_s + kWarps * KM);

  const int qi = blockIdx.x, n = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* qrow = q + (static_cast<size_t>(n) * Q + qi) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) qs[d] = qrow[d];
  __syncthreads();

  float ls[KM];
  int li[KM];
  for (int j = 0; j < KM; ++j) {
    ls[j] = -INFINITY;                                // sentinel, loses to
    li[j] = INT_MAX;                                  // every real slot
  }
  const float* kbase = keys + static_cast<size_t>(n) * C * D;
  const uint8_t* vbase = valid + static_cast<size_t>(n) * C;
  for (int c = warp; c < C; c += kWarps) {
    const float* krow = kbase + static_cast<size_t>(c) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(qs[d], krow[d], acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) insert_topk(ls, li, k, vbase[c] ? acc : kNegInf, c);
  }
  if (lane == 0) {
    for (int j = 0; j < k; ++j) {
      cand_s[warp * KM + j] = ls[j];
      cand_i[warp * KM + j] = li[j];
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  float fs[KM];
  int fi[KM];
  for (int j = 0; j < KM; ++j) {
    fs[j] = -INFINITY;
    fi[j] = INT_MAX;
  }
  for (int w = 0; w < kWarps; ++w)
    for (int j = 0; j < k; ++j)
      insert_topk(fs, fi, k, cand_s[w * KM + j], cand_i[w * KM + j]);
  const size_t o = (static_cast<size_t>(n) * Q + qi) * k;
  for (int j = 0; j < k; ++j) {
    out_idx[o + j] = fi[j];
    out_score[o + j] = fs[j];
  }
  if (touch && qmask[qi] && fs[0] >= threshold) {
    atomicAdd(&freq[fi[0]], 1);
    atomicMax(&last_used[fi[0]], *clock);
  }
}

template <int KM>
int launch(const void* q, const void* keys, const void* valid, int N, int Q,
           int C, int D, int k, void* out_idx, void* out_score,
           const void* qmask, void* last_used, void* freq, const void* clock,
           float threshold, int touch, cudaStream_t stream) {
  const size_t smem = D * sizeof(float) + kWarps * KM * (sizeof(float) +
                                                         sizeof(int));
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(topk_kernel<KM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  topk_kernel<KM><<<dim3(Q, N), kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(keys),
      static_cast<const uint8_t*>(valid), Q, C, D, k,
      static_cast<int*>(out_idx), static_cast<float*>(out_score),
      static_cast<const uint8_t*>(qmask), static_cast<int*>(last_used),
      static_cast<int*>(freq), static_cast<const int*>(clock), threshold,
      touch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (N, Q, D) f32, keys (N, C, D) f32, valid (N, C) u8 -> out_idx (N, Q, k)
// i32, out_score (N, Q, k) f32; 1 <= k <= min(32, C).  touch != 0 (N == 1
// only): qmask (Q,) u8, last_used/freq (C,) i32 updated in place, clock
// (1,) i32 on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int similarity_topk_launch(const void* q, const void* keys,
                                      const void* valid, int N, int Q, int C,
                                      int D, int k, void* out_idx,
                                      void* out_score, const void* qmask,
                                      void* last_used, void* freq,
                                      const void* clock, float threshold,
                                      int touch,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1)
    return launch<1>(q, keys, valid, N, Q, C, D, k, out_idx, out_score, qmask,
                     last_used, freq, clock, threshold, touch, s);
  if (k <= 8)
    return launch<8>(q, keys, valid, N, Q, C, D, k, out_idx, out_score, qmask,
                     last_used, freq, clock, threshold, touch, s);
  return launch<32>(q, keys, valid, N, Q, C, D, k, out_idx, out_score, qmask,
                    last_used, freq, clock, threshold, touch, s);
}

extern "C" const char* similarity_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
