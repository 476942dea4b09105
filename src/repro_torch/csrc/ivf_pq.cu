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
// What bounds it on the H100: at board scale (Q = 256 queries, L = 1024
// lists of cap = 984 slots, D = 2048, S = 8 subspaces) the operations: the
// coarse scores (Q * L * D * 2 = 1.07 GFLOP) and the lookup table (Q * 256
// * D * 2 = 0.27 GFLOP), counted at the card's fp32 rate (67 TFLOP/s
// outside the tensor cores); the bytes it must read (the centroids, 8 MiB;
// the codebook, 2 MiB; the probed lists' codes, validity and owners, 13
// bytes a slot) take less.  Plain TF32 would round q and c_j to 10 bits of
// mantissa, about 5e-4 on a score near 1: above the 1e-4 the probe is held
// to, and enough to reorder probed lists.  So the GEMMs run 3xTF32 on the
// tensor cores (each operand split into a TF32 value and its TF32
// remainder, three products summed in fp32), which keeps the scores within
// a few 1e-6 of the fp32 reference and measured faster than fp32 FMAs.
//
// The TPU kernel walked the lists in its sequential grid and decoded each
// probed list to full (cap, D) keys with a one-hot matmul on the MXU.  A
// decoded list is 8 MiB at D = 2048, so nothing here decodes keys: the
// scores use an asymmetric distance table, lut[q][s][c] = q_s .
// codebook[s][c], and four launches on the caller's stream do the work:
//   1. ivf_gemm_kernel: two GEMMs, C = A . B^T with both operands
//      K-contiguous, in 64 x 64 tiles of (query, list or code), 4 warps of
//      32 x 32 on m16n8k8 TF32 mma.sync.  k-steps of 32 arrive by cp.async
//      in a 4-stage ring (rows padded to 36 floats, so a fragment's 32
//      lanes read 32 banks).  Problem 0 is the coarse table q . c_j, its
//      depth D cut into k_split splits that each write a partial (Q, L)
//      plane, so that a few query tiles still fill the card; problem 1 is
//      the lookup table, a batch of S products (Q x dsub) . (256 x dsub)^T
//      written as (Q, S, 256).  One launch covers both (blockIdx.x over
//      their tiles), and each centroid and codeword is read once per query
//      tile.
//   2. ivf_select_kernel: a block per query sums the coarse partials in
//      split order into its row (in shared memory up to 8k lists), and its
//      first warp picks the n_probe lists: each lane keeps its best lists
//      sorted in registers, and pick m is a warp arg-max (two warp
//      reductions) over the lanes' heads, the best list strictly after pick
//      m - 1 in (masked score desc, id asc) order, so no list is taken
//      twice.  L is bounded by nothing but the workspace.
//   3. ivf_scan_kernel: a block per (query, span of its probed slots); the
//      host cuts each query's n_probe * cap probed slots into spans
//      (kernels/ivf_pq/kernel.py: ivf_pq_plan) so that a batch of any size
//      gives a few waves of blocks.  The block stages its query's table in
//      shared memory (S * 1 KiB) once for all its lists; each thread loads
//      4 slots' validity, owner and codes (one vector load, 8 bytes at S =
//      8) before it scores them, a live slot not owned by the home cluster
//      as q . c_j + sum_s lut[s][code_s] (the sum reassociates the
//      reference's single dot: the scores agree within a tolerance, not bit
//      for bit); it keeps a sorted top k in registers, the warps merge
//      theirs by arg-max rounds, and the block writes k (score, flat index)
//      pairs.  (The table reads of 32 lanes hit random banks; all-zero
//      codes, one bank, measured no faster.)
//   4. ivf_merge_kernel: a warp per query merges its n_split partial
//      lists in k arg-max rounds; places left after the real
//      candidates take the lowest flat indices not already taken, at -1e30:
//      exactly what lax.top_k returns over the masked row.  (The TPU
//      kernel's iota-initialised carry can instead return a duplicate index
//      when a real candidate has a flat index < k.)
// Launches 2-4 are programmatic dependent launches: each may start while
// the one before it finishes, and waits for it (griddepcontrol) before it
// reads its output, which hides most of the gap between short kernels.
// The only limit is the scan block's table, S * 256 fp32 in shared memory:
// a launch with S above 226 is refused before anything runs.  Allocates
// nothing (the wrapper passes the workspace); never synchronises.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>
#include <utility>

namespace {

constexpr float kNegInf = -1e30f;        // score of a masked list or slot
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory a block may use
constexpr int kCodes = 256;              // codewords per subspace

constexpr int kTile = 64;                // GEMM tile: queries x columns
constexpr int kBK = 32;                  // GEMM k-step
constexpr int kLd = kBK + 4;             // padded shared row, floats
constexpr int kStages = 4;               // GEMM cp.async ring depth
constexpr int kGemmThreads = 128;        // 2 x 2 warps of 32 x 32
constexpr size_t kGemmSmem = kStages * 2 * kTile * kLd * sizeof(float);

constexpr int kSelThreads = 256;         // a select block's threads
constexpr int kRowSmem = 8 * 1024;       // coarse scores a select block holds
constexpr int kSelKeep = 8;              // lists a select lane keeps sorted
constexpr int kRowWarps = 8;             // queries of a merge block
constexpr int kScanThreads = 128;
constexpr int kBatch = 4;                // items a thread loads at once
constexpr int kScanWarps = kScanThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// a key that orders scores as floats do (-0 taken as +0)
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the best of the lanes' (score, index) pairs, in every lane: the highest
// score, then the lowest index (two warp reductions)
__device__ __forceinline__ void warp_best(float& s, int& i) {
  const unsigned key = score_key(s);
  const unsigned best = __reduce_max_sync(kFull, key);
  i = __reduce_min_sync(kFull, key == best ? i : INT_MAX);
  s = key_score(best);
}

// programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// previous kernel on the stream runs; it waits here, before reading that
// kernel's output, until the previous kernel has finished and its writes
// are visible.  The previous kernel lets it start once all its blocks run.
__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// ---------------------------------------------------------------------------
// 1. the coarse table and the lookup table
// ---------------------------------------------------------------------------

// C[b][m][n] = sum_k A[m][b * kb + k] * B[b][n][k] for k < min(kb, K - b kb)
struct Gemm {
  const float* a;          // (M, K), row stride lda
  const float* b;          // batch b at b + b * b_batch, rows of stride ldb
  float* c;                // batch b at c + b * c_batch, rows of stride ldc
  long long b_batch, c_batch;
  int lda, ldb, ldc;
  int M, N, K, kb;
  int tiles_m, tiles_n, batches;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? BYTES : 0;          // 0: zero-fill, nothing read
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to 2^-22 of x, both TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Both GEMMs in one launch: blockIdx.x runs over problem 0's tiles, then
// problem 1's.  A block computes a kTile x kTile tile of C; its 2 x 2 warps
// each 32 x 32 outputs as 2 x 4 m16n8k8 tiles.  k-steps of kBK arrive in a
// ring of kStages (A's rows, then B's, kLd floats each; rows and columns
// past the edge zero-filled).  VEC floats a copy: 4 when every row and
// batch offset is 16-byte aligned.
template <int VEC>
__global__ void __launch_bounds__(kGemmThreads)
ivf_gemm_kernel(Gemm g0, Gemm g1) {
  constexpr int kStage = 2 * kTile * kLd;
  extern __shared__ float4 gemm_smem[];
  float* sm = reinterpret_cast<float*>(gemm_smem);
  let_next_start();
  int t = blockIdx.x;
  const int n0 = g0.tiles_m * g0.tiles_n * g0.batches;
  const Gemm g = t < n0 ? g0 : g1;
  if (t >= n0) t -= n0;
  const int tn = t % g.tiles_n;
  t /= g.tiles_n;
  const int tm = t % g.tiles_m;
  const int bt = t / g.tiles_m;
  const int m0 = tm * kTile, c0 = tn * kTile;
  const int kbeg = bt * g.kb;
  const int kb = min(g.kb, g.K - kbeg);
  const float* A = g.a + kbeg;
  const float* B = g.b + bt * g.b_batch;

  auto load = [&](int st, int k0) {
    constexpr int kPerRow = kBK / VEC;
    float* dst = sm + st * kStage;
#pragma unroll
    for (int c = threadIdx.x; c < 2 * kTile * kPerRow; c += kGemmThreads) {
      const int r = c / kPerRow, col = (c - r * kPerRow) * VEC;
      const bool in_a = r < kTile;
      const int x = (in_a ? m0 : c0 - kTile) + r;
      const bool ok = k0 + col < kb && x < (in_a ? g.M : g.N);
      const float* src = in_a ? A : B;   // a copy lies wholly in or out
      if (ok) src += static_cast<size_t>(x) * (in_a ? g.lda : g.ldb) + k0 + col;
      cp_async<VEC * 4>(dst + r * kLd + col, src, ok);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1, gr = lane >> 2, q = lane & 3;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int steps = (kb + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s * kBK);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();        // k-step s has landed
    __syncthreads();                     // and step s - 1's slot is free
    const int nx = s + kStages - 1;
    if (nx < steps) load(nx % kStages, nx * kBK);
    cp_async_commit();
    const float* a_sh = sm + (s % kStages) * kStage + (wm * 32 + gr) * kLd + q;
    const float* b_sh =
        sm + (s % kStages) * kStage + (kTile + wn * 32 + gr) * kLd + q;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      // fragments (PTX m16n8k8 .tf32): a (row gr [+8], col q [+4]), b (row
      // q [+4], col gr); the rows' 36-float stride puts the 32 lanes on 32
      // banks
      unsigned ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = a_sh + i * 16 * kLd + kk;
        split_tf32(p[0], ab[i][0], as[i][0]);
        split_tf32(p[8 * kLd], ab[i][1], as[i][1]);
        split_tf32(p[4], ab[i][2], as[i][2]);
        split_tf32(p[8 * kLd + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = b_sh + j * 8 * kLd + kk;
        split_tf32(p[0], bb[j][0], bs[j][0]);
        split_tf32(p[4], bb[j][1], bs[j][1]);
      }
      // the small terms first; consecutive products go to distinct tiles
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], as[i], bb[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ab[i], bs[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ab[i], bb[j]);
    }
  }
  // c (PTX m16n8k8): element e at row gr + 8 (e / 2), column 2 q + e % 2
  float* C = g.c + bt * g.c_batch;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + i * 16 + gr + (e >> 1) * 8;
        const int n = c0 + wn * 32 + j * 8 + 2 * q + (e & 1);
        if (m < g.M && n < g.N)
          C[static_cast<size_t>(m) * g.ldc + n] = acc[i][j][e];
      }
}

// sorted (score desc, index asc) lists of KM in registers
template <int KM>
__device__ __forceinline__ void insert_topk(float (&ls)[KM], int (&li)[KM],
                                            float s, int i) {
  if (!better(s, i, ls[KM - 1], li[KM - 1])) return;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (better(s, i, ls[j], li[j])) {
      const float ts = ls[j];
      const int ti = li[j];
      ls[j] = s;
      li[j] = i;
      s = ts;
      i = ti;
    }
  }
}

template <int KM>
__device__ __forceinline__ void pop_topk(float (&ls)[KM], int (&li)[KM]) {
#pragma unroll
  for (int j = 0; j + 1 < KM; ++j) {
    ls[j] = ls[j + 1];
    li[j] = li[j + 1];
  }
  ls[KM - 1] = -INFINITY;
  li[KM - 1] = INT_MAX;
}

// ---------------------------------------------------------------------------
// 2. the probed lists
// ---------------------------------------------------------------------------

// a block per query.  coarse: (k_split, Q, L) partial q . c_j.  The
// block sums the partials in split order into its raw row, kept in shared
// memory with the lists' validity when L <= kRowSmem (else plane 0 holds
// it), and its first warp picks the lists: each lane keeps a sorted list
// of its best kSelKeep lists (of L / 32), a pick is a warp arg-max over
// the lanes' heads, and a lane whose list runs out scans its lists again
// for the next kSelKeep after its last pick.
__global__ void __launch_bounds__(kSelThreads)
ivf_select_kernel(float* __restrict__ coarse,
                  const uint8_t* __restrict__ cent_valid, int Q, int L,
                  int k_split, int n_probe, int* __restrict__ out_sel,
                  float* __restrict__ sel_qc) {
  extern __shared__ float4 sel_smem[];   // (L,) raw, (L,) valid
  let_next_start();
  const int qi = blockIdx.x, lane = threadIdx.x & 31;
  const bool in_smem = L <= kRowSmem;
  float* row = coarse + static_cast<size_t>(qi) * L;
  float* raw = in_smem ? reinterpret_cast<float*>(sel_smem) : row;
  uint8_t* flags = reinterpret_cast<uint8_t*>(raw + L);
  const uint8_t* valid = in_smem ? flags : cent_valid;
  const size_t plane = static_cast<size_t>(Q) * L;
  wait_previous();
  // kBatch lists a thread, so that their partials' loads are in flight
  // together
  for (int j0 = threadIdx.x; j0 < L; j0 += kBatch * kSelThreads) {
    float s[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kSelThreads;
      s[u] = j < L ? row[j] : 0.f;
    }
#pragma unroll 4
    for (int p = 1; p < k_split; ++p)
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * kSelThreads;
        if (j < L) s[u] += row[p * plane + j];
      }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kSelThreads;
      if (j >= L) break;
      raw[j] = s[u];
      if (in_smem) flags[j] = cent_valid[j];
    }
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  float ls[kSelKeep];
  int li[kSelKeep];
  float last_s = INFINITY;               // the lane's last pick
  int last_i = -1;
  auto refill = [&]() {                  // the next kSelKeep after it
#pragma unroll
    for (int r = 0; r < kSelKeep; ++r) {
      ls[r] = -INFINITY;
      li[r] = INT_MAX;
    }
    for (int j = lane; j < L; j += 32) {
      const float s = valid[j] ? raw[j] : kNegInf;
      if (better(last_s, last_i, s, j)) insert_topk<kSelKeep>(ls, li, s, j);
    }
  };
  refill();
  const size_t o = static_cast<size_t>(qi) * n_probe;
  for (int m = 0; m < n_probe; ++m) {
    float bs = ls[0];
    int bi = li[0];
    warp_best(bs, bi);                   // indices are distinct: one lane
    if (li[0] == bi) {                   // holds the pick
      last_s = ls[0];
      last_i = bi;
      pop_topk<kSelKeep>(ls, li);
      if (li[0] == INT_MAX) refill();
    }
    if (lane == 0) {
      out_sel[o + m] = bi;
      sel_qc[o + m] = raw[bi];           // an invalid list's slots still
    }                                    // score with its centroid
  }
}

// ---------------------------------------------------------------------------
// 3. the probed slots
// ---------------------------------------------------------------------------

// grid: Q * n_split blocks, split fastest.  Block (q, split) scores the
// query's probed slots p * cap + slot in [split * chunk, (split + 1) *
// chunk) of n_probe * cap, and writes its k best (score, flat index)
// pairs, (-inf, INT_MAX) where it has fewer.  VEC: S is 8 and the codes
// are 8-byte aligned, so a slot's codes come in one 8-byte load; else a
// byte a load.
template <int KM, bool VEC>
__global__ void __launch_bounds__(kScanThreads)
ivf_scan_kernel(const float* __restrict__ lut_ws,
                const int* __restrict__ sel,
                const float* __restrict__ sel_qc,
                const int* __restrict__ home,
                const uint8_t* __restrict__ codes,
                const uint8_t* __restrict__ slot_valid,
                const int* __restrict__ slot_owner, int cap, int S,
                int n_probe, int n_split, int chunk, int k,
                float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  float* lut = reinterpret_cast<float*>(smem4);          // (S, 256)
  float* red_s = lut + S * kCodes;                       // (warps, KM)
  int* red_i = reinterpret_cast<int*>(red_s + kScanWarps * KM);

  let_next_start();
  const int b = blockIdx.x;
  const int qi = b / n_split, split = b - qi * n_split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = home[qi];
  const int i0 = split * chunk, i1 = min(n_probe * cap, i0 + chunk);
  wait_previous();
  const float4* src =
      reinterpret_cast<const float4*>(lut_ws + static_cast<size_t>(qi) * S *
                                                   kCodes);
  for (int e = tid; e < S * (kCodes / 4); e += kScanThreads) smem4[e] = src[e];
  const int* qsel = sel + static_cast<size_t>(qi) * n_probe;
  const float* qc = sel_qc + static_cast<size_t>(qi) * n_probe;
  __syncthreads();

  float ls[KM];
  int li[KM];
#pragma unroll
  for (int r = 0; r < KM; ++r) {
    ls[r] = -INFINITY;                   // sentinel: loses to every
    li[r] = INT_MAX;                     // real candidate
  }
  for (int base = i0 + tid; base < i1; base += kBatch * kScanThreads) {
    // kBatch slots' loads in flight together, then their scores
    int flat[kBatch];
    bool live[kBatch];
    float c[kBatch];
    uint2 cw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = base + u * kScanThreads;
      live[u] = false;
      flat[u] = 0;
      if (it < i1) {
        const int p = it / cap;
        flat[u] = qsel[p] * cap + (it - p * cap);
        c[u] = qc[p];
        live[u] = (slot_valid[flat[u]] != 0) & (slot_owner[flat[u]] != h);
        if constexpr (VEC)
          cw[u] = *reinterpret_cast<const uint2*>(
              codes + static_cast<size_t>(flat[u]) * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!live[u]) continue;
      float s = c[u];
      if constexpr (VEC) {
#pragma unroll
        for (int v = 0; v < 8; ++v)
          s += lut[(v << 8) +
                   (((v < 4 ? cw[u].x : cw[u].y) >> (8 * (v & 3))) & 0xffu)];
      } else {
        const uint8_t* code = codes + static_cast<size_t>(flat[u]) * S;
        for (int v = 0; v < S; ++v) s += lut[(v << 8) + code[v]];
      }
      insert_topk<KM>(ls, li, s, flat[u]);
    }
  }

  // each warp's k best, then warp 0 merges the warps' lists
  for (int r = 0; r < k; ++r) {
    float s = ls[0];
    int i = li[0];
    warp_best(s, i);
    if (i != INT_MAX && li[0] == i) pop_topk<KM>(ls, li);
    if (lane == 0) {
      red_s[warp * KM + r] = s;
      red_i[warp * KM + r] = i;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  const bool mine = lane < kScanWarps;
  int pos = 0;
  float* os = part_s + static_cast<size_t>(b) * k;
  int* oi = part_i + static_cast<size_t>(b) * k;
  for (int r = 0; r < k; ++r) {
    float s = -INFINITY;
    int i = INT_MAX;
    if (mine && pos < k) {
      s = red_s[lane * KM + pos];
      i = red_i[lane * KM + pos];
    }
    const int head = i;
    warp_best(s, i);
    if (mine && i != INT_MAX && head == i) ++pos;
    if (lane == 0) {
      os[r] = s;
      oi[r] = i;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. the query's top k
// ---------------------------------------------------------------------------

// part_*: (Q, n_lists, k) sorted lists, (-inf, INT_MAX) past their end
__global__ void __launch_bounds__(kRowWarps * 32)
ivf_merge_kernel(const float* __restrict__ part_s,
                 const int* __restrict__ part_i, int Q, int n_lists, int k,
                 int* __restrict__ out_idx, float* __restrict__ out_score) {
  wait_previous();
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (qi >= Q) return;
  const size_t base = static_cast<size_t>(qi) * n_lists * k;
  const float* ps = part_s + base;
  const int* pi = part_i + base;
  const size_t o = static_cast<size_t>(qi) * k;
  // round r takes the best pair strictly after pick r - 1; in a sorted
  // list that is the first such entry
  float prev_s = INFINITY;
  int prev_i = -1, real = 0;
  for (; real < k; ++real) {
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int l = lane; l < n_lists; l += 32) {
      for (int e = l * k; e < (l + 1) * k; ++e) {
        const int i = pi[e];
        if (i == INT_MAX) break;
        const float s = ps[e];
        if (better(prev_s, prev_i, s, i)) {
          if (better(s, i, bs, bi)) {
            bs = s;
            bi = i;
          }
          break;
        }
      }
    }
    warp_best(bs, bi);
    if (bi == INT_MAX) break;
    if (lane == 0) {
      out_idx[o + real] = bi;
      out_score[o + real] = bs;
    }
    prev_s = bs;
    prev_i = bi;
  }
  if (lane != 0) return;
  // fill the places no candidate took with the lowest free flat indices
  int f = 0;
  for (int j = real; j < k; ++j) {
    bool taken = true;
    while (taken) {
      taken = false;
      for (int r = 0; r < real; ++r) taken |= (out_idx[o + r] == f);
      if (taken) ++f;
    }
    out_idx[o + j] = f++;
    out_score[o + j] = kNegInf;
  }
}

template <int KM>
size_t scan_smem(int S) {
  return static_cast<size_t>(S) * kCodes * sizeof(float) +
         kScanWarps * KM * (sizeof(float) + sizeof(int));
}

// cudaFuncSetAttribute for more than 48 KiB of dynamic shared memory,
// once per kernel, device and size (the call costs host time)
int allow_smem(const void* fn, size_t smem) {
  struct Done {
    const void* fn;
    int device;
    size_t smem;
  };
  static Done done[32];
  static int n_done = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < n_done; ++i)
    if (done[i].fn == fn && done[i].device == device && done[i].smem >= smem)
      return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_done < 32) done[n_done++] = Done{fn, device, smem};
  return 0;
}

// launch kernel on st; pdl: it may start while the previous kernel on st
// runs (it waits for it in wait_previous)
template <typename... P, typename... A>
int launch(void (*kernel)(P...), int grid, int threads, size_t smem,
           cudaStream_t st, bool pdl, A&&... args) {
  if (smem > 48 * 1024) {
    const int err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (err) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...));
}

template <int KM>
int launch_scan(int blocks, size_t smem, cudaStream_t st, const float* lut,
                const int* sel, const float* sel_qc, const void* home,
                const void* codes, const void* slot_valid,
                const void* slot_owner, int cap, int S, int n_probe,
                int n_split, int chunk, int k, float* part_s, int* part_i) {
#define IVF_SCAN(VEC)                                                       \
  launch(ivf_scan_kernel<KM, VEC>, blocks, kScanThreads, smem, st, true, lut, \
         sel, sel_qc, static_cast<const int*>(home),                        \
         static_cast<const uint8_t*>(codes),                                \
         static_cast<const uint8_t*>(slot_valid),                           \
         static_cast<const int*>(slot_owner), cap, S, n_probe, n_split,     \
         chunk, k, part_s, part_i)
  if (S == 8 && !(reinterpret_cast<uintptr_t>(codes) & 7))
    return IVF_SCAN(true);
  return IVF_SCAN(false);
#undef IVF_SCAN
}

}  // namespace

// q (Q, D) f32, home (Q,) i32, centroids (L, D) f32, cent_valid (L,) u8,
// codes (L, cap, S) u8, slot_valid (L, cap) u8, slot_owner (L, cap) i32,
// codebook (S, 256, D / S) f32 -> out_idx (Q, k) i32, out_score (Q, k) f32,
// out_sel (Q, n_probe) i32.  1 <= k <= min(32, L * cap), 1 <= n_probe <= L,
// D % S == 0.  The plan (kernels/ivf_pq/kernel.py: ivf_pq_plan) gives the
// cuts and owns the fp32 scratch's layout: k_split splits of D, split_depth
// deep each (a multiple of 32), for the coarse partials (k_split, Q, L);
// chunk probed slots per scan block, n_split blocks per query; and the
// regions coarse, lut (Q, S, 256), sel_qc (Q, n_probe), part_s and part_i
// (Q * n_split * k each), disjoint and 16-byte aligned.  Returns
// cudaErrorInvalidValue, launching nothing, when the scan block's table
// (S * 1 KiB) would not fit a block's 227 KiB, an argument is out of
// range or the cuts do not cover D and the probed slots once; else the
// first launch error.
extern "C" int ivf_pq_probe_launch(
    const void* q, const void* home, const void* centroids,
    const void* cent_valid, const void* codes, const void* slot_valid,
    const void* slot_owner, const void* codebook, int Q, int L, int cap,
    int S, int D, int k, int n_probe, int k_split, int split_depth,
    int chunk, int n_split, void* coarse_ws, void* lut_ws, void* sel_qc_ws,
    void* part_s_ws, void* part_i_ws, void* out_idx, void* out_score,
    void* out_sel, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int KM = k <= 1 ? 1 : k <= 8 ? 8 : 32;
  const size_t smem = KM == 1 ? scan_smem<1>(S)
                      : KM == 8 ? scan_smem<8>(S) : scan_smem<32>(S);
  const long long items = static_cast<long long>(n_probe) * cap;
  const long long blocks = static_cast<long long>(Q) * n_split;
  if (smem > kMaxSmem || k < 1 || k > 32 || n_probe < 1 || n_probe > L ||
      D % S || k_split < 1 || split_depth < 1 || split_depth % kBK ||
      static_cast<long long>(k_split - 1) * split_depth >= D ||
      static_cast<long long>(k_split) * split_depth < D || chunk < 1 ||
      n_split < 1 || static_cast<long long>(n_split - 1) * chunk >= items ||
      static_cast<long long>(n_split) * chunk < items || items > INT_MAX ||
      blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);

  const int dsub = D / S;
  float* coarse = static_cast<float*>(coarse_ws);
  float* lut = static_cast<float*>(lut_ws);
  float* sel_qc = static_cast<float*>(sel_qc_ws);
  float* part_s = static_cast<float*>(part_s_ws);
  int* part_i = static_cast<int*>(part_i_ws);
  int* sel = static_cast<int*>(out_sel);

  const int tiles_m = (Q + kTile - 1) / kTile;
  const Gemm g0{static_cast<const float*>(q),
                static_cast<const float*>(centroids), coarse, split_depth,
                static_cast<long long>(Q) * L, D, D, L, Q, L, D, split_depth,
                tiles_m, (L + kTile - 1) / kTile, k_split};
  const Gemm g1{static_cast<const float*>(q),
                static_cast<const float*>(codebook), lut,
                static_cast<long long>(kCodes) * dsub, kCodes, D, dsub,
                S * kCodes, Q, kCodes, D, dsub, tiles_m, kCodes / kTile, S};
  const int gemm_blocks =
      tiles_m * (g0.tiles_n * g0.batches + g1.tiles_n * g1.batches);
  const bool aligned =
      D % 4 == 0 && dsub % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(centroids)
        | reinterpret_cast<uintptr_t>(codebook)) & 15) == 0;
  int err = aligned ? launch(ivf_gemm_kernel<4>, gemm_blocks, kGemmThreads,
                             kGemmSmem, st, false, g0, g1)
                    : launch(ivf_gemm_kernel<1>, gemm_blocks, kGemmThreads,
                             kGemmSmem, st, false, g0, g1);
  if (err) return err;
  err = launch(ivf_select_kernel, Q, kSelThreads,
               L <= kRowSmem ? L * (sizeof(float) + 1) : 0, st, true, coarse,
               static_cast<const uint8_t*>(cent_valid), Q, L, k_split,
               n_probe, sel, static_cast<float*>(sel_qc));
  if (err) return err;
  err = KM == 1 ? launch_scan<1>(static_cast<int>(blocks), smem, st, lut,
                                 sel, sel_qc, home, codes, slot_valid,
                                 slot_owner, cap, S, n_probe, n_split, chunk,
                                 k, part_s, part_i)
        : KM == 8 ? launch_scan<8>(static_cast<int>(blocks), smem, st, lut,
                                   sel, sel_qc, home, codes, slot_valid,
                                   slot_owner, cap, S, n_probe, n_split,
                                   chunk, k, part_s, part_i)
                  : launch_scan<32>(static_cast<int>(blocks), smem, st, lut,
                                    sel, sel_qc, home, codes, slot_valid,
                                    slot_owner, cap, S, n_probe, n_split,
                                    chunk, k, part_s, part_i);
  if (err) return err;
  return launch(ivf_merge_kernel, (Q + kRowWarps - 1) / kRowWarps,
                kRowWarps * 32, 0, st, true,
                static_cast<const float*>(part_s),
                static_cast<const int*>(part_i), Q, n_split, k,
                static_cast<int*>(out_idx), static_cast<float*>(out_score));
}

extern "C" const char* ivf_pq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
