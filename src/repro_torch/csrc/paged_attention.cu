// Paged GQA attention for decode and chunked prefill, for NVIDIA Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/paged_attention/kernel.py:
//   paged_attention_kernel (_paged_kernel).
//
// What bounds it on the H100: reading the KV pages.  A dispatch reads every
// mapped page of every row once per KV head group (bytes of
// attention_kv_bytes_per_step(..., impl="paged")), at 3.35 TB/s; the
// score and PV products are small (head_dim 64, G = 4 query heads per KV
// head), so decode is far below the card's compute rate and waits on
// latency: a few microseconds of dependent loads (lengths, block table,
// pages) against a sub-microsecond byte bound.  Chunked prefill (C = 128
// chunk queries x G = 4 heads = 512 rows per KV group) has more arithmetic
// per byte but stays small next to the model's matmuls.
//
// Design.  The TPU kernel walks a row's pages in its sequential grid axis
// with (m, l, acc) in VMEM scratch, one (b, kv head) per grid row, all C*G
// query rows of the group in one (C*G, D) tile.  Here the key axis is split
// across blocks (flash-decoding over pages):
//   * grid (NS, K * RT, B): split s covers the table's key positions
//     [s * span, (s + 1) * span), RT tiles of query rows cover the group's
//     C*G rows.  Row r is chunk offset c = r / G of query head kh*G + r % G
//     at absolute position lengths[b] + c; q is read and the output written
//     in the model's (B, C, H, D) layout, so the wrapper needs no transpose;
//   * a block reads its keys through its block-table row: a key at position
//     t lives in page bt[b][t / page], slot t % page.  An entry >= P (the
//     INVALID sink) is skipped wherever it stands, and no key past the last
//     position the block's rows can see (lengths[b] + c of its last row) is
//     read.  The causal mask is k_pos <= lengths[b] + c; the online softmax
//     is fp32, in base 2 (scores pre-scaled by log2 e);
//   * K/V rows arrive by 16-byte cp.async from the (P, page, K, D) pool
//     (rows of D values strided by K * D); a skipped or unread key is
//     zero-filled (a source size of 0), so shared memory never holds stale
//     values, and masked.  A tile with no loaded key (an idle decode slot, a
//     pad row of a prefill chunk: an all-INVALID table) reads nothing and
//     skips its products, which would leave (m, l, acc) as they were;
//   * with one split (NS == 1) a block finalizes acc / l itself.  Otherwise
//     it writes its (m, l, acc) in fp32 to the workspace, and a merge pass
//     (a second launch, a block per (head, chunk offset, batch row))
//     combines a row's splits s = 0, 1, ... in that fixed order, online:
//     out = sum acc_s 2^(m_s - M) / sum l_s 2^(m_s - M), M = max m_s, over
//     the splits with l_s > 0.  The result is the same from run to run, with no
//     atomics.  A row that saw no key (l == 0 everywhere) finalizes to exact
//     zeros.  (Merging in the split pass's last block to arrive, on an
//     integer ticket, saved the second launch but measured slower on the
//     card: 64 blocks merge what the merge pass spreads over thousands.)
// Two routes:
//   * FMA split kernel (fp32, and bf16 with C*G <= 16: decode).  A block
//     holds up to 4 or 16 query rows, so at decode it owns all G heads of
//     its KV head and reads each page row once per group.  Keys are staged
//     64 at a time: thread t scores key t % 64 against its rows with 16-byte
//     shared-memory reads (rows padded by 16 bytes: conflict-free), a warp
//     per row takes the tile's softmax, and thread i accumulates (row, dim
//     pair) i of PV.  At decode every split is one such tile of 64 keys;
//   * bf16 chunk (C*G > 16): tensor cores.  A block holds 64 query rows of
//     one KV head, 16 per warp; S = Q K^T and O += P V run on
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with ldmatrix (.trans for
//     V); K/V tiles of 32 keys (two 16-token pages) arrive through the block
//     table by cp.async in a 2-stage ring; P is rounded to bf16 in registers
//     as PV's A operand.  Only tiles that cross the causal diagonal of the
//     block's rows, or hold a key that was not loaded, are masked.  A chunk
//     of one or two rows (the serve path's usual launch) splits its keys
//     too, so that it fills the card.
// The plan (route, NS, span) depends on the shapes alone:
// paged_attention_workspace_size gives the wrapper the workspace it needs.
// Launched on the caller's stream; allocates nothing; never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kKT = 64;               // keys per FMA tile
constexpr int kFmaRowsMax = 16;       // C*G up to this: the FMA split route
constexpr int kMmaRows = 64;          // query rows of an mma block, 16/warp
constexpr int kMmaKeys = 32;          // keys per mma tile (two 16-token pages)
constexpr int kFullBlocks = 264;      // 2 per SM: enough blocks, no split
constexpr int kTargetBlocks = 528;    // 4 per SM when the keys are split
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct VecN;    // values per 16-byte load
template <> struct VecN<float> { static constexpr int N = 4; };
template <> struct VecN<bf16> { static constexpr int N = 8; };

struct Params {
  const void* q;
  const void* kp;
  const void* vp;
  const int* bt;
  const int* lengths;
  float* ml;                          // [B][K][NS][CG][2]: (m, l) partials
  float* acc;                         // [B][K][NS][CG][D]: acc partials
  void* out;
  int B, C, H, K, D, P, page, n_pages, G, CG, NS, span;
  float scale2;                       // softmax scale * log2(e)
};

// 16 bytes global -> shared; ok == false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void unpack16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void unpack16(const bf16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 g = __bfloat1622float2(h[i]);
    f[2 * i] = g.x;
    f[2 * i + 1] = g.y;
  }
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool page_ok(int pid, int P) {
  return pid >= 0 && pid < P;
}

__device__ __forceinline__ size_t out_offset(const Params& p, int b, int kh,
                                             int r) {
  return ((static_cast<size_t>(b) * p.C + r / p.G) * p.H + kh * p.G +
          r % p.G) * p.D;
}
__device__ __forceinline__ size_t partial_row(const Params& p, int b, int kh,
                                              int split, int r) {
  return ((static_cast<size_t>(b) * p.K + kh) * p.NS + split) * p.CG + r;
}

// One block per (head, chunk offset, batch row); thread i merges dims 2i,
// 2i + 1 over the splits the row sees, in split order, in one online pass
// whose loads do not wait on the previous split (a split with l == 0
// counts with weight 0).
template <typename T>
__global__ void paged_merge_kernel(Params p) {
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.G, r = c * p.G + h % p.G, d = 2 * threadIdx.x;
  const int s_last = min(p.NS - 1, (p.lengths[b] + c) / p.span);
  float mx = kNegInf, lsum = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll 4
  for (int s = 0; s <= s_last; ++s) {
    const size_t row = partial_row(p, b, kh, s, r);
    const float2 ml = *reinterpret_cast<const float2*>(p.ml + row * 2);
    const float2 a =
        *reinterpret_cast<const float2*>(p.acc + row * p.D + d);
    const float m_new = ml.y > 0.f ? fmaxf(mx, ml.x) : mx;
    const float alpha = exp2f(mx - m_new);
    const float w = ml.y > 0.f ? exp2f(ml.x - m_new) : 0.f;
    lsum = lsum * alpha + ml.y * w;
    o0 = o0 * alpha + a.x * w;
    o1 = o1 * alpha + a.y * w;
    mx = m_new;
  }
  const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
  store2(static_cast<T*>(p.out) + out_offset(p, b, kh, r) + d, o0 * inv,
         o1 * inv);
}

// ---------------------------------------------------------------------------
// FMA split route: fp32, and bf16 decode (C*G <= 16)
// ---------------------------------------------------------------------------

template <typename T, int R>
size_t fma_smem_bytes(int D) {
  const size_t kv =
      2 * static_cast<size_t>(kKT) * (D + VecN<T>::N) * sizeof(T);
  return kv + sizeof(float) * (R * D + R * (kKT + 1) + R) +
         sizeof(int) * kKT;
}

// R: query rows per block (4 or 16).  Warp w owns the softmax state of rows
// w, w + 4, ...; thread i accumulates (row, dim pair) items i, i + 128, ...
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(Params p) {
  constexpr int VN = VecN<T>::N;
  constexpr int RW = R / 4;           // softmax rows per warp
  constexpr int NI = R / 2;           // PV items per thread (D <= 128)
  constexpr int SLD = kKT + 1;        // score row stride
  extern __shared__ uint4 smem_u4[];
  const int D = p.D, LD = D + VN;
  T* ks = reinterpret_cast<T*>(smem_u4);                // [kKT][LD]
  T* vs = ks + kKT * LD;                                // [kKT][LD]
  float* qs = reinterpret_cast<float*>(vs + kKT * LD);  // [R][D]
  float* ss = qs + R * D;                               // [R][SLD]
  float* rs = ss + R * SLD;                             // [R]: alpha, then l
  int* kok = reinterpret_cast<int*>(rs + R);            // [kKT]

  const int split = blockIdx.x, b = blockIdx.z;
  const int RT = (p.CG + R - 1) / R;
  const int kh = blockIdx.y / RT, r0 = (blockIdx.y % RT) * R;
  const int r_end = min(r0 + R, p.CG);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = p.lengths[b];
  const int kpos_max = length + (r_end - 1) / p.G;
  const int k_lo = split * p.span;
  if (k_lo > kpos_max && p.NS > 1) return;   // no row here sees this split
  const int k_hi = min(min(k_lo + p.span, p.n_pages * p.page) - 1, kpos_max);

  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.kp);
  const T* vp = static_cast<const T*>(p.vp);
  const int* bt_row = p.bt + static_cast<size_t>(b) * p.n_pages;
  const int nv = D / VN;

  // keys t0 .. t0 + 63: unmapped pages and keys past k_hi are zeros
  auto stage = [&](int t0) {
    for (int e = tid; e < kKT * nv; e += kThreads) {
      const int j = e / nv, c = e % nv, pos = t0 + j;
      const int pid = pos <= k_hi ? bt_row[pos / p.page] : -1;
      const bool ok = page_ok(pid, p.P);
      const size_t off =
          ok ? ((static_cast<size_t>(pid) * p.page + pos % p.page) * p.K +
                kh) * D + c * VN
             : 0;
      cp_async16(ks + j * LD + c * VN, kp + off, ok);
      cp_async16(vs + j * LD + c * VN, vp + off, ok);
      if (c == 0) kok[j] = ok;
    }
    cp_async_commit();
  };
  if (k_lo <= k_hi) stage(k_lo);     // in flight while q is staged
  for (int e = tid; e < R * nv; e += kThreads) {
    const int rr = e / nv, c = e % nv, r = r0 + rr;
    float f[VN];
#pragma unroll
    for (int i = 0; i < VN; ++i) f[i] = 0.f;
    if (r < r_end) unpack16(q + out_offset(p, b, kh, r) + c * VN, f);
#pragma unroll
    for (int i = 0; i < VN; i += 4)
      *reinterpret_cast<float4*>(qs + rr * D + c * VN + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }

  float m[RW], l[RW], acc[NI][2];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) acc[k][0] = acc[k][1] = 0.f;
  const int half = D / 2, items = R * half;

  for (int t0 = k_lo; t0 <= k_hi; t0 += kKT) {
    if (t0 != k_lo) stage(t0);
    cp_async_wait_all();
    __syncthreads();
    // a tile with no loaded key changes nothing: skip its products
    if (__any_sync(0xffffffffu, (kok[lane] | kok[lane + 32]) != 0)) {
      // scores: thread (t, row group) dots key t with rows rg, rg + 2, ...
      {
        const int t = tid % kKT, rg = tid / kKT;
        float dot[R / 2];
#pragma unroll
        for (int i = 0; i < R / 2; ++i) dot[i] = 0.f;
        for (int c = 0; c < nv; ++c) {
          float kf[VN];
          unpack16(ks + t * LD + c * VN, kf);
#pragma unroll
          for (int i = 0; i < R / 2; ++i) {
            const float* qr = qs + (rg + 2 * i) * D + c * VN;
#pragma unroll
            for (int v = 0; v < VN; v += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qr + v);
              dot[i] = fmaf(qq.x, kf[v], dot[i]);
              dot[i] = fmaf(qq.y, kf[v + 1], dot[i]);
              dot[i] = fmaf(qq.z, kf[v + 2], dot[i]);
              dot[i] = fmaf(qq.w, kf[v + 3], dot[i]);
            }
          }
        }
        const bool loaded = kok[t] != 0;
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          const int rr = rg + 2 * i;
          const bool vis = loaded && t0 + t <= length + (r0 + rr) / p.G;
          ss[rr * SLD + t] = vis ? dot[i] * p.scale2 : kNegInf;
        }
      }
      __syncthreads();

      // online softmax of the tile, a warp per row (base 2); a row with no
      // visible key yet keeps m == -1e30 and p == 0
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int rr = warp + 4 * i;
        float* srow = ss + rr * SLD;
        const float x0 = srow[lane], x1 = srow[lane + 32];
        const float m_new = fmaxf(m[i], warp_max(fmaxf(x0, x1)));
        const float p0 = x0 > kNegInf / 2 ? exp2f(x0 - m_new) : 0.f;
        const float p1 = x1 > kNegInf / 2 ? exp2f(x1 - m_new) : 0.f;
        const float alpha = exp2f(m[i] - m_new);
        l[i] = l[i] * alpha + warp_sum(p0 + p1);
        m[i] = m_new;
        srow[lane] = p0;
        srow[lane + 32] = p1;
        if (lane == 0) rs[rr] = alpha;
      }
      __syncthreads();

      // acc = acc * alpha + p v, item (row, dim pair) per thread
#pragma unroll
      for (int k = 0; k < NI; ++k) {
        const int it = tid + kThreads * k;
        if (it < items) {
          const int rr = it / half, d = 2 * (it % half);
          const float a = rs[rr];
          float o0 = acc[k][0] * a, o1 = acc[k][1] * a;
          const float* prow = ss + rr * SLD;
          const T* vcol = vs + d;
#pragma unroll 8
          for (int t = 0; t < kKT; ++t) {
            const float pt = prow[t];
            const float2 vv = load2(vcol + t * LD);
            o0 = fmaf(pt, vv.x, o0);
            o1 = fmaf(pt, vv.y, o1);
          }
          acc[k][0] = o0;
          acc[k][1] = o1;
        }
      }
    }
    __syncthreads();                  // tile consumed
  }

  // finalize (one split) or write the partials for the merge pass
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int rr = warp + 4 * i, r = r0 + rr;
    if (lane == 0) {
      rs[rr] = l[i];
      if (p.NS > 1 && r < r_end) {
        const size_t row = partial_row(p, b, kh, split, r);
        p.ml[row * 2] = m[i];
        p.ml[row * 2 + 1] = l[i];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int it = tid + kThreads * k;
    if (it >= items) break;
    const int rr = it / half, d = 2 * (it % half), r = r0 + rr;
    if (r >= r_end) continue;
    if (p.NS == 1) {
      const float lr = rs[rr];
      const float inv = 1.f / (lr == 0.f ? 1.f : lr);
      store2(static_cast<T*>(p.out) + out_offset(p, b, kh, r) + d,
             acc[k][0] * inv, acc[k][1] * inv);
    } else {
      store2(p.acc + partial_row(p, b, kh, split, r) * D + d, acc[k][0],
             acc[k][1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 chunk route (C*G > 16): tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate)
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int DP>
constexpr size_t mma_smem_bytes() {   // q, 2 stages of k and v, key flags
  return static_cast<size_t>(kMmaRows + 4 * kMmaKeys) * (DP + 8) *
             sizeof(bf16) +
         2 * kMmaKeys * sizeof(int);
}

// DP: head_dim rounded up to 32, 64 or 128 (pad columns are zeros).  Shared
// rows are DP + 8 values long (16 bytes of padding), so the 8 rows an
// ldmatrix reads fall on distinct banks.  kok flags the keys of a stage
// that were loaded; a warp reads a tile's 32 flags with one ballot.
template <int DP>
__global__ void __launch_bounds__(kThreads)
paged_mma_kernel(Params p) {
  constexpr int LD = DP + 8;
  constexpr int CH = DP / 8;          // 16-byte chunks of a row
  constexpr int NT = DP / 8;          // n8 tiles of an output row
  constexpr int NJ = kMmaKeys / 8;    // n8 tiles of a score row
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);          // [kMmaRows][LD]
  bf16* ks = qs + kMmaRows * LD;                        // [2][kMmaKeys][LD]
  bf16* vs = ks + 2 * kMmaKeys * LD;                    // [2][kMmaKeys][LD]
  int* kok = reinterpret_cast<int*>(vs + 2 * kMmaKeys * LD);  // [2][keys]

  const int split = blockIdx.x, b = blockIdx.z;
  const int RT = (p.CG + kMmaRows - 1) / kMmaRows;
  const int kh = blockIdx.y / RT, r0 = (blockIdx.y % RT) * kMmaRows;
  const int r_end = min(r0 + kMmaRows, p.CG);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int length = p.lengths[b];
  const int kpos_max = length + (r_end - 1) / p.G;
  const int k_lo = split * p.span;
  if (k_lo > kpos_max && p.NS > 1) return;   // no row here sees this split
  const int k_hi = min(min(k_lo + p.span, p.n_pages * p.page) - 1, kpos_max);

  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* kp = static_cast<const bf16*>(p.kp);
  const bf16* vp = static_cast<const bf16*>(p.vp);
  const int* bt_row = p.bt + static_cast<size_t>(b) * p.n_pages;
  const int D = p.D, G = p.G, nc = D / 8;

  // q tile: rows past the group's end and the pad columns are zeros
  for (int e = tid; e < kMmaRows * CH; e += kThreads) {
    const int rr = e / CH, c = e % CH, r = r0 + rr;
    const bool ok = r < r_end && c < nc;
    cp_async16(qs + rr * LD + c * 8,
               ok ? q + out_offset(p, b, kh, r) + c * 8 : q, ok);
  }
  // k and v of keys t0 .. t0 + 31 through the block table
  auto load_kv = [&](int t0, int stage) {
    for (int e = tid; e < kMmaKeys * CH; e += kThreads) {
      const int j = e / CH, c = e % CH, pos = t0 + j;
      const int pid = pos <= k_hi ? bt_row[pos / p.page] : -1;
      const bool row_ok = page_ok(pid, p.P);
      const bool ok = row_ok && c < nc;
      const size_t off =
          ok ? ((static_cast<size_t>(pid) * p.page + pos % p.page) * p.K +
                kh) * D + c * 8
             : 0;
      const int dst = (stage * kMmaKeys + j) * LD + c * 8;
      cp_async16(ks + dst, kp + off, ok);
      cp_async16(vs + dst, vp + off, ok);
      if (c == 0) kok[stage * kMmaKeys + j] = row_ok;
    }
  };
  if (k_lo <= k_hi) load_kv(k_lo, 0);
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's m16 tile
  const int row_w = r0 + warp * 16 + g;
  const int qp[2] = {length + row_w / G, length + (row_w + 8) / G};
  const int qpos_min = length + r0 / G;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const int n_tiles = k_lo <= k_hi ? (k_hi - k_lo) / kMmaKeys + 1 : 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_lo + it * kMmaKeys, stage = it & 1;
    if (it + 1 < n_tiles) load_kv(t0 + kMmaKeys, stage ^ 1);
    cp_async_commit();                // maybe empty: keeps the counts
    cp_async_wait1();                 // this tile (and q) landed
    __syncthreads();
    const bf16* kt = ks + stage * kMmaKeys * LD;
    const bf16* vt = vs + stage * kMmaKeys * LD;
    const int* okt = kok + stage * kMmaKeys;
    const bool key_ok = okt[lane] != 0;
    // a tile with no loaded key changes nothing: skip its products
    if (__any_sync(0xffffffffu, key_ok)) {
      // mask only a tile past the diagonal of a row, or with a missing key
      const bool edge = !__all_sync(0xffffffffu, key_ok) ||
                        t0 + kMmaKeys - 1 > qpos_min;

      // s = q k^T: 16 rows x 32 keys per warp
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                       (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t bb[4];
          ldsm_x4(bb, kt + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma16816(s[2 * jp], a, bb[0], bb[1]);
          mma16816(s[2 * jp + 1], a, bb[2], bb[3]);
        }
      }

      // mask (edge tiles only), online softmax (base 2); masked keys give
      // p = 0 exactly
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = s[j][e] * p.scale2;
          if (edge) {
            const int col = j * 8 + 2 * t + (e & 1);
            x = okt[col] && t0 + col <= qp[h] ? x : kNegInf;
          }
          s[j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float x = s[j][e];
          const float pr = x > kNegInf / 2 ? exp2f(x - m[h]) : 0.f;
          s[j][e] = pr;
          l[h] += pr;                 // this thread's columns
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // o += p v: p (bf16, from registers) is the A operand, 2 k16 steps
#pragma unroll
      for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t bb[4];
          ldsm_x4_t(bb, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD + dp * 16 + (lane >> 4) * 8);
          mma16816(o[2 * dp], a, bb[0], bb[1]);
          mma16816(o[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                  // this stage consumed
  }
  cp_async_wait_all();                // no tile: q's copies still land

  // finalize (one split) or write the partials for the merge pass; a row's
  // l sums over the 4 threads that hold its columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = row_w + 8 * h;
    if (r >= r_end) continue;
    if (p.NS == 1) {
      const float inv = 1.f / (lr == 0.f ? 1.f : lr);
      bf16* dst = static_cast<bf16*>(p.out) + out_offset(p, b, kh, r);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < D) store2(dst + d, o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
      }
    } else {
      const size_t row = partial_row(p, b, kh, split, r);
      if (t == 0) {
        p.ml[row * 2] = m[h];
        p.ml[row * 2 + 1] = lr;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < D) store2(p.acc + row * D + d, o[j][2 * h], o[j][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the plan and the launch
// ---------------------------------------------------------------------------

enum Route { kFma4 = 0, kFma16 = 1, kMma = 2 };

struct Plan {
  Route route;
  int RT, NS, span;
};

// The route and the key split for these shapes: a split when the blocks of
// one split would not fill the card (fewer than two per SM), into spans of
// whole tiles that bring the grid near four blocks per SM.
Plan make_plan(int B, int C, int H, int K, int n_pages, int page,
               int is_bf16) {
  const int CG = C * (H / K);
  Plan pl;
  int rows, keys;
  if (is_bf16 && CG > kFmaRowsMax) {
    pl.route = kMma;
    rows = kMmaRows;
    keys = kMmaKeys;
  } else {
    pl.route = CG <= 4 ? kFma4 : kFma16;
    rows = CG <= 4 ? 4 : kFmaRowsMax;
    keys = kKT;
  }
  pl.RT = (CG + rows - 1) / rows;
  const int base = B * K * pl.RT;
  const int tiles = max(1, (n_pages * page + keys - 1) / keys);
  const int ns = base >= kFullBlocks
                     ? 1
                     : min(tiles, (kTargetBlocks + base - 1) / base);
  const int per = (tiles + ns - 1) / ns;      // tiles per split
  pl.NS = (tiles + per - 1) / per;
  pl.span = per * keys;
  return pl;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename Kern>
cudaError_t launch(Kern kern, size_t smem, const Params& p, const Plan& pl,
                   cudaStream_t s) {
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.NS, p.K * pl.RT, p.B), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_split(const Params& p, const Plan& pl, cudaStream_t s) {
  if (pl.route == kMma) {
    if (p.D <= 32)
      return launch(paged_mma_kernel<32>, mma_smem_bytes<32>(), p, pl, s);
    if (p.D <= 64)
      return launch(paged_mma_kernel<64>, mma_smem_bytes<64>(), p, pl, s);
    return launch(paged_mma_kernel<128>, mma_smem_bytes<128>(), p, pl, s);
  }
  if (pl.route == kFma4)
    return launch(paged_split_kernel<T, 4>, fma_smem_bytes<T, 4>(p.D), p, pl,
                  s);
  return launch(paged_split_kernel<T, 16>, fma_smem_bytes<T, 16>(p.D), p, pl,
                s);
}

template <typename T>
cudaError_t launch_dtype(const Params& p, const Plan& pl, cudaStream_t s) {
  const cudaError_t err = launch_split<T>(p, pl, s);
  if (err != cudaSuccess || p.NS == 1) return err;
  paged_merge_kernel<T><<<dim3(p.H, p.C, p.B), p.D / 2, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// fp32 entries of the workspace a launch of these shapes needs: (m, l) and
// D accumulators per (row, split) when the keys are split, else 0.
extern "C" long long paged_attention_workspace_size(int B, int C, int H,
                                                    int K, int D,
                                                    int n_pages, int page,
                                                    int is_bf16) {
  const Plan pl = make_plan(B, C, H, K, n_pages, page, is_bf16);
  if (pl.NS == 1) return 0;
  return static_cast<long long>(B) * K * pl.NS * C * (H / K) * (2 + D);
}

// q (B, C, H, D), k/v pages (P, page, K, D), same dtype (f32 or bf16),
// 16-byte aligned; bt (B, n_pages) i32, lengths (B,) i32; ws the fp32
// workspace of paged_attention_workspace_size entries (null when that is
// 0) -> out (B, C, H, D) in q's dtype.  D % 8 == 0, D <= 128, H % K == 0.
// Returns the first CUDA error of the launches.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* bt,
                                      const void* lengths, void* ws,
                                      void* out, int B, int C, int H, int K,
                                      int D, int P, int page, int n_pages,
                                      float scale, int is_bf16,
                                      void* stream) {
  const Plan pl = make_plan(B, C, H, K, n_pages, page, is_bf16);
  Params p;
  p.q = q;
  p.kp = k_pages;
  p.vp = v_pages;
  p.bt = static_cast<const int*>(bt);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.B = B; p.C = C; p.H = H; p.K = K; p.D = D; p.P = P; p.page = page;
  p.n_pages = n_pages;
  p.G = H / K;
  p.CG = C * p.G;
  p.NS = pl.NS;
  p.span = pl.span;
  p.scale2 = scale * kLog2e;
  p.ml = static_cast<float*>(ws);
  p.acc = ws == nullptr
              ? nullptr
              : p.ml + static_cast<size_t>(B) * K * pl.NS * p.CG * 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_dtype<bf16>(p, pl, s)
                                  : launch_dtype<float>(p, pl, s);
  return static_cast<int>(err);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
