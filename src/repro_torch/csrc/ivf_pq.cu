// Two-stage IVF-PQ probe over the federation's region digest board, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ivf_pq/kernel.py:
//   ivf_pq_probe_kernel (_ivfpq_kernel, _merge_topk).
// Per query row: stage 1 scores the L coarse centroids and keeps the
// n_probe best lists (invalid lists at -1e30, ties to the lower list id);
// stage 2 scores every live slot of those lists whose owner differs from
// the query's home cluster as q . (centroid_j + decode(codes)), and keeps
// the top k over the flat index list * cap + slot (ties to the lower index).
//
// What bounds it on the H100: at board scale (L = 1024 lists of cap = 984
// slots, D = 2048, S = 8 subspaces) the bytes it must read are the
// centroids (8 MiB), the codebook (2 MiB) and the probed lists' codes,
// validity and owners (13 bytes a slot: 13 MB if the queries together
// probe every list); the operations are the coarse scores (Q * L * D * 2)
// and the lookup table (Q * 256 * D * 2).  At Q = 256 the operations
// (1.3 GFLOP) outweigh the bytes, so the card's fp32 rate (67 TFLOP/s
// outside the tensor cores) is the bound.
//
// The TPU kernel walked the lists in its sequential grid and decoded each
// probed list to full (cap, D) keys with a one-hot matmul on the MXU.  A
// decoded list is 8 MiB at D = 2048, so nothing here decodes keys: the
// design is query-major and uses an asymmetric distance table instead.
//   * one block per query row; the query sits in shared memory;
//   * stage 1: warps score the lists (lanes stride over D, a shuffle
//     reduction gives the dot) into a shared table of raw q . c_j; then
//     n_probe block-wide arg-max passes pick the lists in (masked score
//     desc, list id asc) order, each pass taking the best entry strictly
//     after the previous pick in that order, so no list is taken twice;
//   * stage 2: a shared table lut[s][c] = q_s . codebook[s][c] (S * 256
//     floats, 8 KiB at S = 8), one warp per entry;
//   * stage 3: threads stride over the probed slots; a live slot whose owner
//     is not the home cluster scores q . c_j + sum_s lut[s][code_s], so the
//     sum reassociates the reference's single dot (the scores agree within
//     a tolerance, not bit for bit); each thread keeps a sorted top k by
//     (score desc, index asc), and a tree of pairwise merges in shared
//     memory combines the 256 lists;
//   * places left after the real candidates take the lowest flat indices
//     not already taken, at -1e30: exactly what lax.top_k returns over the
//     masked row.  (The TPU kernel's iota-initialised carry can instead
//     return a duplicate index when a real candidate has a flat index < k.)
// Every block reads all L centroids and the whole codebook (from L2 after
// the first blocks); a later PR can score several queries per block.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;   // score of a masked list or slot
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory a block may use

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

// the better of two (score, index) pairs across a warp
__device__ __forceinline__ void warp_best(float& s, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

template <int KM>
__global__ void __launch_bounds__(kThreads)
ivf_pq_kernel(const float* __restrict__ q, const int* __restrict__ home,
              const float* __restrict__ centroids,
              const uint8_t* __restrict__ cent_valid,
              const uint8_t* __restrict__ codes,
              const uint8_t* __restrict__ slot_valid,
              const int* __restrict__ slot_owner,
              const float* __restrict__ codebook, int L, int cap, int S,
              int D, int k, int n_probe, int* __restrict__ out_idx,
              float* __restrict__ out_score, int* __restrict__ out_sel) {
  extern __shared__ float smem[];
  float* qs = smem;                                  // (D,) query row
  float* qc = qs + D;                                // (L,) raw q . c_j
  float* lut = qc + L;                               // (S, 256)
  float* sel_qc = lut + S * 256;                     // (n_probe,)
  int* sel = reinterpret_cast<int*>(sel_qc + n_probe);   // (n_probe,)
  float* red_s = reinterpret_cast<float*>(sel + n_probe);  // (kWarps,)
  int* red_i = reinterpret_cast<int*>(red_s + kWarps);     // (kWarps,)
  float* cand_s = reinterpret_cast<float*>(red_i + kWarps);  // (T, KM)
  int* cand_i = reinterpret_cast<int*>(cand_s + kThreads * KM);

  const int qi = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qrow = q + static_cast<size_t>(qi) * D;
  for (int d = tid; d < D; d += kThreads) qs[d] = qrow[d];
  __syncthreads();

  // stage 1: raw coarse scores, one warp per list
  for (int j = warp; j < L; j += kWarps) {
    const float* crow = centroids + static_cast<size_t>(j) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(qs[d], crow[d], acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) qc[j] = acc;
  }
  __syncthreads();

  // n_probe arg-max passes; pass m takes the best list strictly after pick
  // m - 1 in (masked score desc, id asc) order
  float prev_s = INFINITY;
  int prev_i = -1;
  for (int m = 0; m < n_probe; ++m) {
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < L; j += kThreads) {
      const float s = cent_valid[j] ? qc[j] : kNegInf;
      if (better(prev_s, prev_i, s, j) && better(s, j, bs, bi)) {
        bs = s;
        bi = j;
      }
    }
    warp_best(bs, bi);
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < kWarps ? red_s[lane] : -INFINITY;
      bi = lane < kWarps ? red_i[lane] : INT_MAX;
      warp_best(bs, bi);
      if (lane == 0) {
        sel[m] = bi;
        sel_qc[m] = qc[bi];
      }
    }
    __syncthreads();
    prev_s = cent_valid[sel[m]] ? sel_qc[m] : kNegInf;
    prev_i = sel[m];
  }
  for (int m = tid; m < n_probe; m += kThreads)
    out_sel[static_cast<size_t>(qi) * n_probe + m] = sel[m];

  // stage 2: the asymmetric distance table, one warp per entry
  const int dsub = D / S;
  for (int e = warp; e < S * 256; e += kWarps) {
    const int s = e >> 8;
    const float* crow = codebook + static_cast<size_t>(e) * dsub;
    const float* qsub = qs + s * dsub;
    float acc = 0.f;
    for (int d = lane; d < dsub; d += 32) acc = fmaf(qsub[d], crow[d], acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) lut[e] = acc;
  }
  __syncthreads();

  // stage 3: score the probed slots into per-thread sorted lists
  float ls[KM];
  int li[KM];
  for (int j = 0; j < KM; ++j) {
    ls[j] = -INFINITY;                               // sentinel: loses to
    li[j] = INT_MAX;                                 // every real candidate
  }
  const int h = home[qi];
  const int n_items = n_probe * cap;
  for (int t = tid; t < n_items; t += kThreads) {
    const int p = t / cap, slot = t - p * cap;
    const int j = sel[p];
    const size_t flat = static_cast<size_t>(j) * cap + slot;
    if (!slot_valid[flat] || slot_owner[flat] == h) continue;
    const uint8_t* code = codes + flat * S;
    float s = sel_qc[p];
    for (int u = 0; u < S; ++u) s += lut[(u << 8) + code[u]];
    insert_topk(ls, li, k, s, static_cast<int>(flat));
  }
  for (int j = 0; j < k; ++j) {
    cand_s[tid * KM + j] = ls[j];
    cand_i[tid * KM + j] = li[j];
  }
  __syncthreads();

  // tree merge of the per-thread lists: thread t folds in t + stride
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      const float* as = cand_s + tid * KM;
      const int* ai = cand_i + tid * KM;
      const float* bs = cand_s + (tid + stride) * KM;
      const int* bi = cand_i + (tid + stride) * KM;
      float ms[KM];
      int mi[KM];
      int a = 0, b = 0;
      for (int j = 0; j < k; ++j) {
        if (better(as[a], ai[a], bs[b], bi[b])) {
          ms[j] = as[a];
          mi[j] = ai[a++];
        } else {
          ms[j] = bs[b];
          mi[j] = bi[b++];
        }
      }
      for (int j = 0; j < k; ++j) {
        cand_s[tid * KM + j] = ms[j];
        cand_i[tid * KM + j] = mi[j];
      }
    }
    __syncthreads();
  }

  if (tid != 0) return;
  // fill the places no candidate took with the lowest free flat indices
  int real = 0;
  while (real < k && cand_i[real] != INT_MAX) ++real;
  const size_t o = static_cast<size_t>(qi) * k;
  for (int j = 0; j < real; ++j) {
    out_idx[o + j] = cand_i[j];
    out_score[o + j] = cand_s[j];
  }
  int f = 0;
  for (int j = real; j < k; ++j) {
    bool taken = true;
    while (taken) {
      taken = false;
      for (int r = 0; r < real; ++r) taken |= (cand_i[r] == f);
      if (taken) ++f;
    }
    out_idx[o + j] = f++;
    out_score[o + j] = kNegInf;
  }
}

template <int KM>
int launch(const void* q, const void* home, const void* centroids,
           const void* cent_valid, const void* codes, const void* slot_valid,
           const void* slot_owner, const void* codebook, int Q, int L,
           int cap, int S, int D, int k, int n_probe, void* out_idx,
           void* out_score, void* out_sel, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(D) + L + S * 256 + n_probe) *
                          sizeof(float) +
                      n_probe * sizeof(int) +
                      kWarps * (sizeof(float) + sizeof(int)) +
                      static_cast<size_t>(kThreads) * KM *
                          (sizeof(float) + sizeof(int));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_pq_kernel<KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ivf_pq_kernel<KM><<<Q, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int*>(home),
      static_cast<const float*>(centroids),
      static_cast<const uint8_t*>(cent_valid),
      static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(slot_valid),
      static_cast<const int*>(slot_owner),
      static_cast<const float*>(codebook), L, cap, S, D, k, n_probe,
      static_cast<int*>(out_idx), static_cast<float*>(out_score),
      static_cast<int*>(out_sel));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (Q, D) f32, home (Q,) i32, centroids (L, D) f32, cent_valid (L,) u8,
// codes (L, cap, S) u8, slot_valid (L, cap) u8, slot_owner (L, cap) i32,
// codebook (S, 256, D / S) f32 -> out_idx (Q, k) i32, out_score (Q, k) f32,
// out_sel (Q, n_probe) i32.  1 <= k <= min(32, L * cap), 1 <= n_probe <= L,
// D % S == 0.  Returns cudaErrorInvalidValue, launching nothing, when the
// block's shared memory (the query, the L coarse scores, the table, the
// probed lists and the per-thread top-k lists) would exceed 227 KiB; else
// cudaGetLastError() after the launch.
extern "C" int ivf_pq_probe_launch(const void* q, const void* home,
                                   const void* centroids,
                                   const void* cent_valid, const void* codes,
                                   const void* slot_valid,
                                   const void* slot_owner,
                                   const void* codebook, int Q, int L,
                                   int cap, int S, int D, int k, int n_probe,
                                   void* out_idx, void* out_score,
                                   void* out_sel, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 1)
    return launch<1>(q, home, centroids, cent_valid, codes, slot_valid,
                     slot_owner, codebook, Q, L, cap, S, D, k, n_probe,
                     out_idx, out_score, out_sel, st);
  if (k <= 8)
    return launch<8>(q, home, centroids, cent_valid, codes, slot_valid,
                     slot_owner, codebook, Q, L, cap, S, D, k, n_probe,
                     out_idx, out_score, out_sel, st);
  return launch<32>(q, home, centroids, cent_valid, codes, slot_valid,
                    slot_owner, codebook, Q, L, cap, S, D, k, n_probe,
                    out_idx, out_score, out_sel, st);
}

extern "C" const char* ivf_pq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
