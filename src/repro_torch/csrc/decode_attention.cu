// Flash-decode: one query token per row against a dense KV cache, GQA, for
// NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_attention/kernel.py:
//   decode_attention_kernel (_decode_kernel).
//
// What bounds it on the H100: reading the cache.  Each row streams its
// kv_len valid slots of K and V once per KV head (h2o-danube3-4b at B = 8,
// a full 4096-slot ring, K = 8, head_dim 120, bf16: 125.8 MB, 37.6 us at
// 3.35 TB/s); the products are G * head_dim multiply-adds per slot and
// operand, far below the card's rates.  So the design keeps the memory
// busy and the arithmetic out of its way.
//
// Design:
//   * The TPU kernel walks the cache in its sequential kv grid axis with
//     (m, l, acc) in VMEM scratch, one (b, kv head) per grid row.  B * K is
//     64 at the main path's shape, half the card's 132 SMs, so here the cache
//     is also split along S (flash-decoding): grid (NS, K * RT, B), RT tiles
//     of query rows cover the G heads of a KV head (any G).  Split s takes
//     the 32-slot tiles s, s + NS, s + 2 NS, ... below kv_len, so the NS
//     blocks of a row stream neighbouring tiles at the same time and a
//     short row still spreads over all of them (measured faster than
//     contiguous spans of NS tiles).  The caller sets NS from the shapes
//     (kernels/decode_attention/kernel.py: decode_plan): about one wave of
//     blocks for a full cache.  A split with no tile below kv_len exits at
//     once and writes nothing: the merge reads only the splits that hold a
//     valid slot.
//   * K and V tiles of 32 slots stay in the input type in shared memory and
//     arrive by 16-byte cp.async from the sequence-major (B, S, K, D) cache
//     (no transpose copy) in a ring of 3 stages: tiles i + 1 and i + 2 are
//     in flight while tile i is used; one barrier a tile.  head_dim is
//     padded to 32, 64 or 128 and rows are 16 bytes longer than that, so
//     that the 8 rows an ldmatrix or a 16-byte read spans fall on distinct
//     banks.  Pad columns and slots past kv_len are zero-filled by a source
//     size of 0 (stale shared memory may hold NaN, and 0 * NaN is NaN), and
//     slots past kv_len are masked to -1e30, so they give p = 0 exactly.
//   * Each of the 4 warps takes 8 slots of a tile and keeps its own online
//     softmax (m, l, acc) of the block's rows, fp32, base 2 (scores scaled
//     by scale * log2 e); after the last tile the warps combine through
//     shared memory.  With one split the block finalizes acc / l itself;
//     otherwise it writes (m, l, acc) in fp32 to the workspace and a merge
//     pass (a block per (head, row), a thread per pair of dims) combines a
//     row's splits in split order in one online pass.  A row with no valid
//     slot (kv_len == 0) has l == 0 and finalizes to exact zeros, as the TPU
//     kernel's l == 0 -> 1 does.
//   * With an lse buffer (the sequence-sharded decode, whose ranks each
//     hold a range of the slots and merge their partial softmaxes), the
//     pass that finalizes a row (the merge, or the split pass itself when
//     NS == 1) also writes lse = log sum_s exp(scale q.k_s) over the valid
//     slots in natural log, (m + log2 l) * ln 2 from the base-2 (m, l), and
//     -inf for a row with no valid slot.  Without it nothing else changes.
//   * bf16 route (decode_mma_kernel): tensor cores, one m16 tile of query
//     rows a block (G = 4 pads 12 rows with zeros; G = 48 is 3 tiles).
//   * fp32 route (decode_fma_kernel): fp32 FMAs (TF32 is off by the parity
//     contract), 4 query rows a block; each lane holds 4 dims of a slot, so
//     a warp dots several slots at once and reduces them with shuffles.
// Launched on the caller's stream; allocates nothing (the wrapper passes
// the workspace); never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // slots of a shared-memory tile
constexpr int kWarpSlots = kTile / kWarps; // slots of a tile per warp
constexpr int kStages = 3;                 // cp.async ring depth
constexpr int kFmaRows = 4;                // query rows of an FMA block
constexpr int kMmaRows = 16;               // query rows of an mma block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct VecN;         // values per 16-byte load
template <> struct VecN<float> { static constexpr int N = 4; };
template <> struct VecN<bf16> { static constexpr int N = 8; };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  float* ml;                               // [B][K][NS][G][2]: (m, l)
  float* acc;                              // [B][K][NS][G][D]
  void* out;
  float* lse;                              // [B][H] or nullptr
  int S, H, K, D, G, NS;
  float scale2;                            // softmax scale * log2(e)
};

// 16 bytes global -> shared, the L2 fetching the whole 128-byte line (a
// slot's row is 240 bytes at head_dim 120); ok == false writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d),
      "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ld4(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ size_t partial_row(const Params& p, int b, int kh,
                                              int split, int g) {
  return ((static_cast<size_t>(b) * p.K + kh) * p.NS + split) * p.G + g;
}

__device__ __forceinline__ int valid_len(const Params& p, int b) {
  return min(max(p.kv_len[b], 0), p.S);
}

// the natural-log lse of a row from its base-2 (m, l); -inf when l == 0
__device__ __forceinline__ float lse_of(float m, float l) {
  return l == 0.f ? __int_as_float(0xff800000) : (m + log2f(l)) * kLn2;
}

// a shared-memory row: DP values and 16 bytes of padding
template <typename T, int DP>
__host__ __device__ constexpr int row_ld() {
  return DP + VecN<T>::N;
}

// the ring, or the warps' combine after it, whichever is larger
template <typename T, int DP, int ROWS>
__host__ __device__ constexpr size_t smem_bytes() {
  const size_t ring = static_cast<size_t>(kStages) * 2 * kTile *
                      row_ld<T, DP>() * sizeof(T);
  const size_t comb = static_cast<size_t>(kWarps) * ROWS * (2 + DP) *
                      sizeof(float);
  return ring > comb ? ring : comb;
}

// The block's tiles of row b, KV head kh: tile i starts at slot k_lo + i *
// step; slots at or past k_hi (kv_len) are not read.
struct Span {
  int b, kh, k_lo, step, k_hi, n_tiles;
};

// The block's tile `it` into ring stage it % kStages: slots past k_hi and
// the pad columns are zeros.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(const Params& p, T* ks, T* vs,
                                          const Span& sp, int it) {
  constexpr int VN = VecN<T>::N, CH = DP / VN, LD = row_ld<T, DP>();
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int nc = p.D / VN, t0 = sp.k_lo + it * sp.step;
  const int base = (it % kStages) * kTile * LD;
  for (int e = threadIdx.x; e < kTile * CH; e += kThreads) {
    const int j = e / CH, c = e % CH, slot = t0 + j;
    const bool ok = slot < sp.k_hi && c < nc;
    const size_t off =
        ok ? ((static_cast<size_t>(sp.b) * p.S + slot) * p.K + sp.kh) * p.D +
                 c * VN
           : 0;
    const int dst = base + j * LD + c * VN;
    cp_async16(ks + dst, k + off, ok);
    cp_async16(vs + dst, v + off, ok);
  }
}

// The first kStages - 1 tiles in flight (one commit group each, maybe
// empty, so that the wait counts hold).
template <typename T, int DP>
__device__ __forceinline__ void ring_prologue(const Params& p, T* ks, T* vs,
                                              const Span& sp) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < sp.n_tiles) load_tile<T, DP>(p, ks, vs, sp, s);
    cp_async_commit();
  }
}

// Before tile `it` is used: wait for it, then put tile it + kStages - 1 in
// flight into the stage that tile it - 1 left (the barrier says every warp
// is done with it).
template <typename T, int DP>
__device__ __forceinline__ void ring_advance(const Params& p, T* ks, T* vs,
                                             const Span& sp, int it) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  if (it + kStages - 1 < sp.n_tiles)
    load_tile<T, DP>(p, ks, vs, sp, it + kStages - 1);
  cp_async_commit();
}

// The block's split of (row b, KV head kh, query rows r0 ...); n_tiles < 0
// when the split has no tile below kv_len and the merge will not read it.
__device__ __forceinline__ Span block_span(const Params& p, int rows,
                                           int& r0) {
  const int RT = (p.G + rows - 1) / rows;
  Span sp;
  sp.b = blockIdx.z;
  sp.kh = blockIdx.y / RT;
  r0 = (blockIdx.y % RT) * rows;
  const int split = blockIdx.x;
  sp.k_lo = split * kTile;
  sp.step = p.NS * kTile;
  sp.k_hi = valid_len(p, sp.b);
  const int tiles = (sp.k_hi + kTile - 1) / kTile;
  sp.n_tiles = split < tiles ? (tiles - split + p.NS - 1) / p.NS
                             : (p.NS > 1 ? -1 : 0);
  return sp;
}

// After the last tile: wm[w][r], wl[w][r], wo[w][r][DP] hold warp w's
// (m, l, acc) of row r.  Combines the warps and writes the output (one
// split) or the partials (several).
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void finish(const Params& p, const float* wsm,
                                       const Span& sp, int r0) {
  const float* wm = wsm;
  const float* wl = wm + kWarps * ROWS;
  const float* wo = wl + kWarps * ROWS;
  const int rows = min(ROWS, p.G - r0), half = p.D / 2;
  for (int e = threadIdx.x; e < rows * half; e += kThreads) {
    const int r = e / half, d = 2 * (e % half), g = r0 + r;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * ROWS + r]);
    float L = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = exp2f(wm[w * ROWS + r] - M);
      const float* o = wo + (w * ROWS + r) * DP + d;
      L += wl[w * ROWS + r] * x;
      o0 += o[0] * x;
      o1 += o[1] * x;
    }
    if (p.NS == 1) {
      const float inv = 1.f / (L == 0.f ? 1.f : L);
      const size_t row = static_cast<size_t>(sp.b) * p.H + sp.kh * p.G + g;
      store2(static_cast<T*>(p.out) + row * p.D + d, o0 * inv, o1 * inv);
      if (p.lse != nullptr && d == 0) p.lse[row] = lse_of(M, L);
    } else {
      const size_t row = partial_row(p, sp.b, sp.kh, blockIdx.x, g);
      if (d == 0) store2(p.ml + row * 2, M, L);
      store2(p.acc + row * p.D + d, o0, o1);
    }
  }
}

// ---------------------------------------------------------------------------
// FMA route: 4 query rows a block, fp32 FMAs
// ---------------------------------------------------------------------------

// Sums v[i] over the 2 * H lanes that differ in the bits below 2 * H and
// leaves lane l with the sum of value l % (2 * H) in v[0]: each step sends
// half of the values to the partner lane, keeps the other half and adds.
template <int H, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (H > 0) {
    const bool up = (lane & H) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, H);
    }
    reduce_scatter<H / 2>(v, lane);
  }
}

// DP: head_dim padded to 32, 64 or 128.  q's 4 rows are read once into
// registers.  Lane (kg, pp) = (lane / NP, lane % NP) holds dims 4 pp .. 4 pp
// + 3 of slot kg of each round of KG slots, for all 4 rows: a warp scores
// its 8 slots x 4 rows as 32 partial dot products per lane and reduces them
// with one reduce-scatter over the NP lanes of a slot, so each lane ends
// with one score.  P V accumulates per lane over its own slots; the KG slot
// groups' sums are added once, after the last tile.
template <int DP>
__global__ void __launch_bounds__(kThreads, 4)
decode_fma_kernel(Params p) {
  using T = float;
  constexpr int LD = row_ld<T, DP>();
  constexpr int NP = DP / 4;                 // lanes of a slot
  constexpr int KG = 32 / NP;                // slots a warp scores at once
  constexpr int NR = kWarpSlots / KG;        // rounds over a warp's slots
  static_assert(NR * kFmaRows == NP, "one score per lane");
  extern __shared__ uint4 smem_u4[];
  T* ks = reinterpret_cast<T*>(smem_u4);     // [kStages][kTile][LD]
  T* vs = ks + kStages * kTile * LD;         // [kStages][kTile][LD]

  int r0;
  const Span sp = block_span(p, kFmaRows, r0);
  if (sp.n_tiles < 0) return;
  ring_prologue<T, DP>(p, ks, vs, sp);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kg = lane / NP, pp = lane % NP;
  // q rows r0 .. r0 + 3 at my dims (zeros past the group and past D)
  float qr[kFmaRows][4];
  const T* q = static_cast<const T*>(p.q);
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) {
    if (r0 + r < p.G && 4 * pp < p.D) {
      ld4(q + (static_cast<size_t>(sp.b) * p.H + sp.kh * p.G + r0 + r) *
                  p.D + 4 * pp,
          qr[r]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) qr[r][c] = 0.f;
    }
  }

  // my score is row pp % 4 of slot (pp / 4) * KG + kg of the warp's 8
  const int my_slot = (pp >> 2) * KG + kg;
  float m = kNegInf, l = 0.f;                // my row's max, my part of l
  float acc[kFmaRows][4];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int it = 0; it < sp.n_tiles; ++it) {
    ring_advance<T, DP>(p, ks, vs, sp, it);
    const int row0 = ((it % kStages) * kTile + warp * kWarpSlots) * LD;
    const T* kt = ks + row0;
    const T* vt = vs + row0;
    // partial dots: sc[rd * 4 + r] = q_r . k(slot rd * KG + kg) at my dims
    float sc[NP];
#pragma unroll
    for (int rd = 0; rd < NR; ++rd) {
      float kv[4];
      ld4(kt + (rd * KG + kg) * LD + 4 * pp, kv);
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        float s = qr[r][0] * kv[0];
        s = fmaf(qr[r][1], kv[1], s);
        s = fmaf(qr[r][2], kv[2], s);
        sc[rd * kFmaRows + r] = fmaf(qr[r][3], kv[3], s);
      }
    }
    reduce_scatter<NP / 2>(sc, lane);        // lane pp keeps value pp
    const int slot = sp.k_lo + it * sp.step + warp * kWarpSlots + my_slot;
    const float x = slot < sp.k_hi ? sc[0] * p.scale2 : kNegInf;
    // online softmax of my row over the warp's 8 slots (lanes sharing
    // lane & 3); a row with no visible slot yet keeps m == -1e30, p == 0
    float mx = fmaxf(x, __shfl_xor_sync(kFull, x, 4));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
    const float m_new = fmaxf(m, mx);
    const float pr = x > kNegInf / 2 ? exp2f(x - m_new) : 0.f;
    const float alpha = exp2f(m - m_new);
    l = l * alpha + pr;
    m = m_new;
    // acc = acc * alpha + p v over my slots (lane r holds row r's alpha)
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
      const float a = __shfl_sync(kFull, alpha, r);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= a;
    }
#pragma unroll
    for (int rd = 0; rd < NR; ++rd) {
      float vv[4];
      ld4(vt + (rd * KG + kg) * LD + 4 * pp, vv);
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        const float pt = __shfl_sync(kFull, pr, kg * NP + rd * kFmaRows + r);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pt, vv[c], acc[r][c]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                           // the ring is free

  // the warp's (m, l, acc): l sums over the lanes of a row, acc over the
  // KG slot groups
  l += __shfl_xor_sync(kFull, l, 4);
  l += __shfl_xor_sync(kFull, l, 8);
  l += __shfl_xor_sync(kFull, l, 16);
#pragma unroll
  for (int s = NP; s < 32; s *= 2)
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] += __shfl_xor_sync(kFull, acc[r][c], s);
  float* wsm = reinterpret_cast<float*>(smem_u4);
  float* wm = wsm;
  float* wl = wm + kWarps * kFmaRows;
  float* wo = wl + kWarps * kFmaRows;
  if (lane < kFmaRows) {
    wm[warp * kFmaRows + lane] = m;
    wl[warp * kFmaRows + lane] = l;
  }
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r)
      *reinterpret_cast<float4*>(wo + (warp * kFmaRows + r) * DP + 4 * pp) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  finish<T, DP, kFmaRows>(p, wsm, sp, r0);
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync, bf16 in, fp32 accumulate)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16x8 f32) += a (16x8 bf16, row) * b (8x8 bf16, col)
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[2],
                                        uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One m16 tile of query rows (the G heads of a KV head, 16 at a time; rows
// past G are zeros and never stored).  Per tile a warp multiplies its 8
// slots: S = Q K^T is DP / 16 m16n8k16 products (q's A fragments held in
// registers from global memory, K's B fragments by ldmatrix), and O += P V
// is DP / 8 m16n8k8 products whose A operand is the S accumulator rounded
// to bf16 in registers and whose B fragments come by ldmatrix.trans; the
// row sum l is kept from the unrounded fp32 P.
template <int DP>
__global__ void __launch_bounds__(kThreads, 4)
decode_mma_kernel(Params p) {
  constexpr int LD = row_ld<bf16, DP>();
  constexpr int KS = DP / 16;                // k16 steps of a score
  constexpr int NT = DP / 8;                 // n8 tiles of an output row
  extern __shared__ uint4 smem_u4[];
  bf16* ks = reinterpret_cast<bf16*>(smem_u4);   // [kStages][kTile][LD]
  bf16* vs = ks + kStages * kTile * LD;          // [kStages][kTile][LD]

  int r0;
  const Span sp = block_span(p, kMmaRows, r0);
  if (sp.n_tiles < 0) return;
  ring_prologue<bf16, DP>(p, ks, vs, sp);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;     // mma fragment coordinates
  // q's A fragments: rows r0 + g and r0 + g + 8 (zeros past G and past D)
  uint32_t qa[KS][4];
  const bf16* q = static_cast<const bf16*>(p.q) +
                  (static_cast<size_t>(sp.b) * p.H + sp.kh * p.G) * p.D;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i & 1), d = kk * 16 + 2 * t + 8 * (i >> 1);
      qa[kk][i] = r < p.G && d < p.D
                      ? *reinterpret_cast<const uint32_t*>(q + r * p.D + d)
                      : 0u;
    }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // this lane's ldmatrix row: slot lane % 8 of the warp's, 16-byte chunk
  // lane / 8 of each group of four
  const int ld_off = (warp * kWarpSlots + (lane & 7)) * LD + (lane >> 3) * 8;

  for (int it = 0; it < sp.n_tiles; ++it) {
    ring_advance<bf16, DP>(p, ks, vs, sp, it);
    const int base = (it % kStages) * kTile * LD + ld_off;
    // s = q k^T: 16 rows x the warp's 8 slots
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c4 = 0; c4 < DP / 32; ++c4) {
      uint32_t bb[4];
      ldsm_x4(bb, ks + base + c4 * 32);
      mma16816(s, qa[2 * c4], bb[0], bb[1]);
      mma16816(s, qa[2 * c4 + 1], bb[2], bb[3]);
    }
    // slots past k_hi masked; online softmax of rows g and g + 8 (base 2)
    const int slot = sp.k_lo + it * sp.step + warp * kWarpSlots + 2 * t;
    float x[4], alpha[2];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = slot + (e & 1) < sp.k_hi ? s[e] * p.scale2 : kNegInf;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(x[2 * h], x[2 * h + 1]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = x[e] > kNegInf / 2 ? exp2f(x[e] - m[e >> 1]) : 0.f;
      l[e >> 1] += x[e];                     // this lane's two slots
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // o += p v
    const uint32_t pa[2] = {pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3])};
#pragma unroll
    for (int c4 = 0; c4 < DP / 32; ++c4) {
      uint32_t bb[4];
      ldsm_x4_t(bb, vs + base + c4 * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma1688(o[4 * c4 + i], pa, bb[i]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                           // the ring is free

  // the warp's (m, l, o): l sums over the 4 lanes of a row
  float* wsm = reinterpret_cast<float*>(smem_u4);
  float* wm = wsm;
  float* wl = wm + kWarps * kMmaRows;
  float* wo = wl + kWarps * kMmaRows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h] + __shfl_xor_sync(kFull, l[h], 1);
    lr += __shfl_xor_sync(kFull, lr, 2);
    const int r = warp * kMmaRows + g + 8 * h;
    if (t == 0) {
      wm[r] = m[h];
      wl[r] = lr;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store2(wo + r * DP + j * 8 + 2 * t, o[j][2 * h], o[j][2 * h + 1]);
  }
  __syncthreads();
  finish<bf16, DP, kMmaRows>(p, wsm, sp, r0);
}

// ---------------------------------------------------------------------------
// the merge and the launch
// ---------------------------------------------------------------------------

// One block per (head, batch row); thread i merges dims 2i, 2i + 1 over the
// splits that hold a valid slot, in split order, in one online pass whose
// loads do not wait on the previous split.  kv_len == 0: exact zeros.
template <typename T>
__global__ void decode_merge_kernel(Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = 2 * threadIdx.x;
  const int kh = h / p.G, g = h % p.G;
  const int n = min(p.NS, (valid_len(p, b) + kTile - 1) / kTile);
  float mx = kNegInf, lsum = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const size_t row = partial_row(p, b, kh, s, g);
    const float2 ml = *reinterpret_cast<const float2*>(p.ml + row * 2);
    const float2 a = *reinterpret_cast<const float2*>(p.acc + row * p.D + d);
    const float m_new = fmaxf(mx, ml.x);
    const float alpha = exp2f(mx - m_new);
    const float w = ml.y > 0.f ? exp2f(ml.x - m_new) : 0.f;
    lsum = lsum * alpha + ml.y * w;
    o0 = o0 * alpha + a.x * w;
    o1 = o1 * alpha + a.y * w;
    mx = m_new;
  }
  const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
  store2(static_cast<T*>(p.out) + (static_cast<size_t>(b) * p.H + h) * p.D +
             d,
         o0 * inv, o1 * inv);
  if (p.lse != nullptr && d == 0)
    p.lse[static_cast<size_t>(b) * p.H + h] = lse_of(mx, lsum);
}

template <typename Kern>
cudaError_t launch_split(Kern kern, size_t smem, int rows, const Params& p,
                         int B, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int RT = (p.G + rows - 1) / rows;
  kern<<<dim3(p.NS, p.K * RT, B), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// bf16 on the tensor cores, fp32 on the FMA route
template <typename T, int DP>
cudaError_t launch_route(const Params& p, int B, cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16>)
    return launch_split(decode_mma_kernel<DP>,
                        smem_bytes<bf16, DP, kMmaRows>(), kMmaRows, p, B, s);
  else
    return launch_split(decode_fma_kernel<DP>,
                        smem_bytes<float, DP, kFmaRows>(), kFmaRows, p, B, s);
}

template <typename T>
cudaError_t launch_dtype(const Params& p, int B, cudaStream_t s) {
  cudaError_t err;
  if (p.D <= 32)
    err = launch_route<T, 32>(p, B, s);
  else if (p.D <= 64)
    err = launch_route<T, 64>(p, B, s);
  else
    err = launch_route<T, 128>(p, B, s);
  if (err != cudaSuccess || p.NS == 1) return err;
  decode_merge_kernel<T><<<dim3(p.H, B), p.D / 2, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, D), k/v (B, S, K, D), same dtype (f32 or bf16), contiguous,
// 16-byte aligned; kv_len (B,) i32; n_split >= 1 splits; ws the fp32
// workspace of B * K * n_split * G * (2 + D) entries when n_split > 1
// (else unused) -> out (B, H, D) in q's dtype and, when lse is not null,
// lse (B, H) fp32 in natural log.  H % K == 0, D % 8 == 0, D <= 128.
// Returns the first CUDA error of the launches
// (cudaErrorInvalidValue for n_split < 1, or no workspace for several).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* ws, void* out, void* lse,
                                       int B, int S,
                                       int H, int K, int D, int n_split,
                                       float scale, int is_bf16,
                                       void* stream) {
  if (n_split < 1 || (n_split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = static_cast<const int*>(kv_len);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.S = S; p.H = H; p.K = K; p.D = D;
  p.G = H / K;
  p.NS = n_split;
  p.scale2 = scale * kLog2e;
  p.ml = static_cast<float*>(ws);
  p.acc = ws == nullptr
              ? nullptr
              : p.ml + static_cast<size_t>(B) * K * n_split * p.G * 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_dtype<bf16>(p, B, s)
                                  : launch_dtype<float>(p, B, s);
  return static_cast<int>(err);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
