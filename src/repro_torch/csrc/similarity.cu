// Similarity top-k over the CoIC edge-cache keys, for NVIDIA Hopper (sm_90a).
//
// Replaces four TPU kernels of src/repro/kernels/similarity/kernel.py:
//   similarity_topk_batched_kernel (_topk_batched_kernel, _topk_tile)
//   similarity_lookup_kernel       (_lookup_kernel)
//   similarity_topk_touch_kernel   (_topk_touch_kernel)
//   similarity_topk_kernel         (_topk_kernel, _topk_tile)
// with ONE pair of kernels: the single-matrix top-k is its N = 1 launch (its
// own C entry, similarity_topk_single_launch), the lookup its k = 1, N = 1
// launch, and the touch variant adds an epilogue to the merge.
//
// What bounds it on the H100: reading the keys.  One probe streams the
// (C, D) fp32 key matrix of each group once (C * D * 4 bytes, 4 MiB at
// C = 512, D = 2048: about 1.3 us at 3.35 TB/s); the dot products are a few
// million FMAs, far below the card's rate.  A probe that short is bound by
// the latency of its loads, so the whole key matrix should be in flight at
// once, spread over every SM, and the queries (Q x D, 128 KiB at Q = 16)
// must not be re-read by every block either:
//
//   * Score pass, grid (C tiles of kTile rows, D splits, query chunks x key
//     matrices).  A block of kWarps warps scores kTile key rows against a
//     chunk of kQChunk queries over one split of D, walked in slices of
//     kSlice values (one slice a split at D = 2048, whatever C).  The
//     chunk's query slice is
//     staged in shared memory; each lane loads its share of the warp's
//     kRowsPerWarp key rows with 16-byte loads (4-byte loads when D % 4 !=
//     0), all of them issued before the first product, and keeps
//     kRowsPerWarp x kQChunk partial sums in registers.  Splitting D as well
//     as C (into kMaxSplit splits whatever C: 128 blocks at C = 512, 512 at
//     C = 2048) fills the card while each block reads only its split of
//     the queries: each key row is read once per probe, and the queries
//     once per C tile.  The split count depends on D alone, so a key's
//     score does not depend on the rows launched beside it.
//   * The warp reduces its sums once per row, 16 queries across 32 lanes by
//     a butterfly that halves the values at each step (16 shuffles, not
//     80), and the block writes its partial dot products, coalesced, to a
//     workspace (D splits, N * Q, C).  Every (query, row) pair is summed in
//     the same order, so equal keys score bit-identically.
//   * A key matrix shared by every group (shared_keys != 0, the
//     federation's digest board probed under per-group validity masks) is
//     one matrix for all N * Q queries, so the board is read once, not once
//     per group.
//   * Merge pass, one block per query: sums the D splits of each row in a
//     fixed order, masks invalid slots to -1e30 (every slot, valid or not,
//     is a candidate: an all-invalid row returns indices 0..k-1 at -1e30,
//     the TPU kernel's iota init, and the k = 1 lookup idx 0, -1e30), keeps
//     the scores in the workspace and takes k rounds, each picking the best
//     row that comes after the previous winner in the (score desc, index
//     asc) order: lax.top_k's order, exact whatever the split.
//   * Touch epilogue (N == 1): once a query's top-1 is final, its merge
//     block adds one to freq[idx] and raises last_used[idx] to clock when
//     the query is masked in and its score >= threshold.  Atomics over the
//     Q winners replace the TPU kernel's second pass over C; the integer
//     result is the same in any atomic order.  The reference op is
//     functional, so the epilogue updates new arrays: the score pass's
//     first D split copies its tile of last_used and freq into them
//     (stream order puts every copy before the merge's atomics), which
//     spares the wrapper two clones.
// Arithmetic stays in fp32 FMAs (TF32 is off by the parity contract, and
// the tensor cores would buy nothing at a few MFLOP).  The kernels launch
// on the caller's stream, allocate nothing (the wrapper allocates the
// workspace) and never synchronise.
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;                       // warps of a score block
constexpr int kRowsPerWarp = 4;                 // key rows a warp scores
constexpr int kTile = kWarps * kRowsPerWarp;    // key rows of a block
constexpr int kQChunk = 16;                     // queries of a block
constexpr int kSlice = 256;                     // D values staged at once
constexpr int kMaxSplit = 8;                    // most D splits of a probe
constexpr int kMergeThreads = 512;
constexpr float kNegInf = -1e30f;               // score of an invalid slot

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// V = 4: float4 loads (D % 4 == 0, 16-byte aligned rows); V = 1: floats
template <int V> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float fma(T a, T b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float fma(T a, T b, float acc) {
    return fmaf(a, b, acc);
  }
};

// One step of a butterfly over the warp: each lane keeps HALF of its 2 *
// HALF values (the upper half when its lane bit 2 * HALF is set), summed
// with the partner lane's copy of them.
template <int HALF>
__device__ __forceinline__ void butterfly(float (&v)[kQChunk], int lane) {
  const bool upper = lane & (2 * HALF);
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = upper ? v[j] : v[j + HALF];
    const float keep = upper ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// The sum over the warp of each of a lane's 16 values in 16 shuffles:
// lanes 2 * j and 2 * j + 1 return the sum of value j.
__device__ __forceinline__ float warp_sum16(float (&v)[kQChunk], int lane) {
  static_assert(kQChunk == 16, "the butterfly halves 16 values 4 times");
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// Score pass.  Queries are rows g * QG + qq of the flat (N * Q, D) query
// matrix, scored against key matrix g (keys + g * C * D) over the D split
// blockIdx.y (span values each); partial dots to ws[split][query][row].
// With lu_out set (touch), the blocks of split 0 and chunk 0 also copy
// their tile's rows of lu_in/fr_in to lu_out/fr_out.
template <int V>
__global__ void __launch_bounds__(kWarps * 32, 2)
score_kernel(const float* __restrict__ q, const float* __restrict__ keys,
             int QG, int NQ, int C, int D, int span, int qchunks,
             float* __restrict__ ws, const int* __restrict__ lu_in,
             const int* __restrict__ fr_in, int* __restrict__ lu_out,
             int* __restrict__ fr_out) {
  using VT = typename Vec<V>::T;
  constexpr int SV = kSlice / V;                // vectors of a row slice
  constexpr int kPerLane = SV / 32;
  __shared__ VT qs[kQChunk][SV];
  __shared__ float sc[kQChunk][kTile];

  const int tile = blockIdx.x, split = blockIdx.y;
  const int g = blockIdx.z / qchunks, q0 = (blockIdx.z % qchunks) * kQChunk;
  const int nq = min(kQChunk, QG - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* kbase = keys + static_cast<size_t>(g) * C * D;
  const float* qbase = q + (static_cast<size_t>(g) * QG + q0) * D;
  const int row0 = tile * kTile + warp * kRowsPerWarp;
  const int d_end = min(D, (split + 1) * span);
  if (lu_out != nullptr && split == 0 && blockIdx.z == 0 &&
      threadIdx.x < kTile && tile * kTile + threadIdx.x < C) {
    const int c = tile * kTile + threadIdx.x;
    lu_out[c] = lu_in[c];
    fr_out[c] = fr_in[c];
  }

  float acc[kRowsPerWarp][kQChunk];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int qq = 0; qq < kQChunk; ++qq) acc[r][qq] = 0.f;

  for (int d0 = split * span; d0 < d_end; d0 += kSlice) {
    const int v0 = d0 / V, sv = min(SV, (d_end - d0) / V);
    // this slice's keys, every load issued before the first product
    VT kr[kRowsPerWarp][kPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int c = row0 + r;
      const VT* src = reinterpret_cast<const VT*>(
          kbase + static_cast<size_t>(min(c, C - 1)) * D) + v0;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = lane + 32 * i;
        kr[r][i] = (c < C && j < sv) ? __ldg(src + j) : Vec<V>::zero();
      }
    }
    __syncthreads();                            // the last slice consumed
    static_assert(kQChunk * SV % (kWarps * 32) == 0, "whole staging rounds");
#pragma unroll
    for (int it = 0; it < kQChunk * SV / (kWarps * 32); ++it) {
      const int e = threadIdx.x + it * kWarps * 32, qq = e / SV, j = e % SV;
      qs[qq][j] = (qq < nq && j < sv)
                      ? __ldg(reinterpret_cast<const VT*>(qbase + qq * D) +
                              v0 + j)
                      : Vec<V>::zero();
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + 32 * i;
#pragma unroll
      for (int qq = 0; qq < kQChunk; ++qq) {
        const VT a = qs[qq][j];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][qq] = Vec<V>::fma(a, kr[r][i], acc[r][qq]);
      }
    }
  }

  // one reduction per row; lane 2 * qq writes query qq's sum
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float x = warp_sum16(acc[r], lane);
    if (!(lane & 1)) sc[lane >> 1][warp * kRowsPerWarp + r] = x;
  }
  __syncthreads();
  const int c0 = tile * kTile;
  for (int e = threadIdx.x; e < kQChunk * kTile; e += kWarps * 32) {
    const int qq = e / kTile, r = e % kTile;
    if (qq < nq && c0 + r < C)
      ws[(static_cast<size_t>(split) * NQ + g * QG + q0 + qq) * C + c0 + r] =
          sc[qq][r];
  }
}

// Merge pass: block gq sums its query's D splits of every row, masks the
// invalid slots and picks the k best rows, one round per place; then the
// touch epilogue.  The summed scores overwrite split 0 of the workspace.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(float* ws, const uint8_t* __restrict__ valid, int NQ, int Q,
             int C, int nsplit, int k, int* __restrict__ out_idx,
             float* __restrict__ out_score, const uint8_t* __restrict__ qmask,
             int* last_used, int* freq, const int* __restrict__ clock,
             float threshold, int touch) {
  __shared__ float ws_w[kMergeThreads / 32];
  __shared__ int wi_w[kMergeThreads / 32];
  const int gq = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sc = ws + static_cast<size_t>(gq) * C;
  const uint8_t* vrow = valid + static_cast<size_t>(gq / Q) * C;
  const size_t plane = static_cast<size_t>(NQ) * C;
  float ps = INFINITY;                          // the last winner: every
  int pi = -1;                                  // row comes after it
  for (int j = 0; j < k; ++j) {
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int c = threadIdx.x; c < C; c += kMergeThreads) {
      float s;
      if (j == 0) {
        float part[kMaxSplit];                  // all loads in flight
#pragma unroll
        for (int sp = 0; sp < kMaxSplit; ++sp)
          part[sp] = sp < nsplit ? sc[sp * plane + c] : 0.f;
        s = part[0];
#pragma unroll
        for (int sp = 1; sp < kMaxSplit; ++sp)
          if (sp < nsplit) s += part[sp];
        s = vrow[c] ? s : kNegInf;
        sc[c] = s;
      } else {
        s = sc[c];
      }
      if (better(ps, pi, s, c) && better(s, c, bs, bi)) {
        bs = s;
        bi = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, bs, off);
      const int i = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
    if (lane == 0) {
      ws_w[warp] = bs;
      wi_w[warp] = bi;
    }
    __syncthreads();                            // also: sc written above
    bs = ws_w[0];
    bi = wi_w[0];
    for (int w = 1; w < kMergeThreads / 32; ++w)
      if (better(ws_w[w], wi_w[w], bs, bi)) {
        bs = ws_w[w];
        bi = wi_w[w];
      }
    __syncthreads();                            // ws_w/wi_w read by all
    ps = bs;
    pi = bi;
    if (threadIdx.x == 0) {
      out_idx[static_cast<size_t>(gq) * k + j] = bi;
      out_score[static_cast<size_t>(gq) * k + j] = bs;
      if (j == 0 && touch && qmask[gq] && bs >= threshold) {
        atomicAdd(&freq[bi], 1);
        atomicMax(&last_used[bi], *clock);
      }
    }
  }
}

// D splits of a probe: kMaxSplit (fewer when D has fewer slices), each
// spanning whole slices.  The split depends on D alone, never on C, so a
// (query, row) pair is summed in one order in every launch: a key scores
// the same in a launch over its own shard as over the pooled shards, and
// the cache-axis collective's merge of per-shard top-k equals one pooled
// launch bit for bit.  Returns the split count and sets *span to its width.
int splits_of(int C, int D, int* span) {
  (void)C;
  const int slices = (D + kSlice - 1) / kSlice;
  const int want = std::min(kMaxSplit, slices);
  const int per = (slices + want - 1) / want;   // slices of a split
  *span = per * kSlice;
  return (slices + per - 1) / per;
}

int dispatch(const void* q, const void* keys, const void* valid, int N, int Q,
             int C, int D, int k, void* ws, void* out_idx, void* out_score,
             const void* qmask, const void* last_used_in,
             const void* freq_in, void* last_used, void* freq,
             const void* clock, float threshold, int touch, int shared_keys,
             cudaStream_t stream) {
  const int G = shared_keys ? 1 : N;            // key matrices
  const int QG = shared_keys ? N * Q : Q;       // queries per key matrix
  int span;
  const int nsplit = splits_of(C, D, &span);
  const int qchunks = (QG + kQChunk - 1) / kQChunk;
  const dim3 grid((C + kTile - 1) / kTile, nsplit, qchunks * G);
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(keys);
  auto wf = static_cast<float*>(ws);
  auto lu_in = static_cast<const int*>(touch ? last_used_in : nullptr);
  auto fr_in = static_cast<const int*>(touch ? freq_in : nullptr);
  auto lu = static_cast<int*>(touch ? last_used : nullptr);
  auto fr = static_cast<int*>(touch ? freq : nullptr);
  if (vec)
    score_kernel<4><<<grid, kWarps * 32, 0, stream>>>(
        qf, kf, QG, N * Q, C, D, span, qchunks, wf, lu_in, fr_in, lu, fr);
  else
    score_kernel<1><<<grid, kWarps * 32, 0, stream>>>(
        qf, kf, QG, N * Q, C, D, span, qchunks, wf, lu_in, fr_in, lu, fr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<N * Q, kMergeThreads, 0, stream>>>(
      wf, static_cast<const uint8_t*>(valid), N * Q, Q, C, nsplit, k,
      static_cast<int*>(out_idx), static_cast<float*>(out_score),
      static_cast<const uint8_t*>(qmask), lu, fr,
      static_cast<const int*>(clock), threshold, touch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 entries of the workspace a launch over N * Q queries, C keys and
// D dimensions needs: (D splits, N * Q, C) partial dot products.
extern "C" long long similarity_workspace_size(int NQ, int C, int D) {
  int span;
  return static_cast<long long>(splits_of(C, D, &span)) * NQ * C;
}

// q (N, Q, D) f32, keys (N, C, D) f32 (or (C, D) shared by every group when
// shared_keys != 0), valid (N, C) u8, workspace ws f32 of
// similarity_workspace_size(N * Q, C, D) entries -> out_idx (N, Q, k) i32,
// out_score (N, Q, k) f32; 1 <= k <= C.  touch != 0 (N == 1 only): qmask
// (Q,) u8, last_used_in/freq_in (C,) i32 read, last_used/freq (C,) i32
// written (the inputs, then the touches), clock one i32 on the device.
// Two launches (score, merge); returns the first CUDA error.
extern "C" int similarity_topk_launch(const void* q, const void* keys,
                                      const void* valid, int N, int Q, int C,
                                      int D, int k, void* ws, void* out_idx,
                                      void* out_score, const void* qmask,
                                      const void* last_used_in,
                                      const void* freq_in, void* last_used,
                                      void* freq, const void* clock,
                                      float threshold, int touch,
                                      int shared_keys, void* stream) {
  return dispatch(q, keys, valid, N, Q, C, D, k, ws, out_idx, out_score,
                  qmask, last_used_in, freq_in, last_used, freq, clock,
                  threshold, touch, shared_keys,
                  static_cast<cudaStream_t>(stream));
}

// The single-matrix top-k (K4): q (Q, D) f32, keys (C, D) f32, valid (C,)
// u8, workspace as above -> out_idx (Q, k) i32, out_score (Q, k) f32;
// 1 <= k <= C.  Returns the first CUDA error of its two launches.
extern "C" int similarity_topk_single_launch(const void* q, const void* keys,
                                             const void* valid, int Q, int C,
                                             int D, int k, void* ws,
                                             void* out_idx, void* out_score,
                                             void* stream) {
  return dispatch(q, keys, valid, 1, Q, C, D, k, ws, out_idx, out_score,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0.f,
                  0, 0, static_cast<cudaStream_t>(stream));
}

extern "C" const char* similarity_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
