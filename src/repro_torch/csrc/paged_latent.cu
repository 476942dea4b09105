// Absorbed MLA decode over the paged latent, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes MLA with XLA einsums
// (src/repro/models/layers.py: mla_attention), expanding the latent into
// per-head K and V over each row's whole cache.  It was added because the
// port's paged decode did the same over each row's whole block table (4160
// latent rows of DeepSeek-V2-Lite in each of 27 layers, every step), most
// of it masked.  In the absorbed form (DeepSeek-V2, arXiv:2405.04434
// section 2.1.2) w_uk folds into the query and w_uv into the output, so all
// H heads attend to the same latent row, as in multi-query attention with
// one (r + dr)-wide key [c_kv | k_rope] and the r-wide value c_kv:
//   o_lat[b, h] = softmax_t(scale * (q_lat[b, h] . c_kv[t]
//                                    + q_rope[b, h] . k_rope[t])) @ c_kv
// over the keys t < n_vis[b] that lie in mapped pages of row b's table.
//
// What bounds it on the H100: reading the latent.  A visible key is
// (r + dr) x 2 bytes (1152 at r 512, dr 64) and costs 2 H (r + dr) + 2 H r
// FLOPs, about 8.9 FLOPs a byte at H = 16 against the 295 that the tensor
// cores need: the kernel streams pages and keeps the products out of the way.
//
// Design.
//   * grid (NS, ceil(H / 16), B): block (s, hg, b) takes query heads
//     16 hg .. 16 hg + 15 of row b (the M = 16 of mma.sync m16n8k16; heads
//     past H are zero rows) against split s of the row's visible pages:
//     the row's ceil(n_vis / page) pages cut into NS page-aligned runs of
//     equal length, so no split of a row with NS pages or more is empty.
//     NS comes from the wrapper (B x NS at least four blocks per SM, so
//     that rows of unequal length balance); a block reads its split's
//     table entries once, into shared memory;
//   * keys arrive 32 at a time through the block table by 16-byte cp.async
//     into a 2-stage ring, each key row [c_kv | k_rope | zeros up to a
//     multiple of 16], warp w copying keys w, w + 8, ... (one table lookup
//     a key, the lanes along the row); a key in an unmapped page (an entry
//     >= P, the INVALID sink) or past n_vis is zero-filled, reads nothing
//     and is masked; a tile with no mapped key (an idle or mid-prefill row)
//     is skipped, so such a row writes zeros;
//   * bf16: 8 warps.  The block's q tile [q_lat | q_rope] moves to
//     registers as mma A fragments, warp w taking the k16 steps w, w + 8,
//     ...; each warp computes the 16 x 32 scores over its steps, the eight
//     partials meet in shared memory (over the q tile's bytes), warp w
//     takes the online softmax (fp32, base 2) of heads w and w + 8 with one
//     key a lane, the probabilities are rounded to bf16 as the P V operand,
//     and warp w accumulates output columns [w r / 8, (w + 1) r / 8) of
//     P c_kv in fp32 registers (ldmatrix.trans of the same key rows: V is
//     the c_kv page itself);
//   * fp32 (the port's fp32 configurations): the same loads and softmax,
//     with FMA products (warp w scores its 2 heads against key `lane` over
//     the whole width; thread i accumulates columns 2i and 2i + 1);
//   * with NS == 1 a block finalizes acc / l itself.  Otherwise it writes
//     its (m, l, acc) in fp32 to the workspace, and a merge pass (a block
//     per (head, row)) combines the row's non-empty splits in split order,
//     so the result is the same from run to run.  A row that saw no key
//     finalizes to exact zeros.
// Launched on the caller's stream; allocates nothing; never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kHeads = 16;            // query heads of a block: mma's M
constexpr int kKeys = 32;             // keys per tile
constexpr int kSP = kKeys + 4;        // partial score row stride (floats)
constexpr int kKsw = 5;               // k16 steps of q a warp holds (576/128)
constexpr int kNtw = 8;               // n8 output tiles a warp owns (512/64)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q_lat;                  // (B, H, R)
  const void* q_rope;                 // (B, H, DR)
  const void* ckv;                    // (P, page, R)
  const void* krope;                  // (P, page, DR)
  const int* bt;                      // (B, n_pages)
  const int* n_vis;                   // (B,)
  float* ml;                          // [B][HG][NS][16][2]: (m, l) partials
  float* acc;                         // [B][HG][NS][16][R]: acc partials
  void* out;                          // (B, H, R)
  int B, H, R, DR, P, page, n_pages, HG, NS, KP, LDK;
  int per_max;                        // pages of a split at most
  float scale2;                       // softmax scale * log2(e)
};

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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(bf16* p, float a) {
  *p = __float2bfloat16_rn(a);
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
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// Keys of row b that a launch reads (its visible count, at most the table's
// width), the pages of each split and how many splits hold a page; the
// split pass and the merge pass both plan from these.
__device__ __forceinline__ void row_plan(const Params& p, int b, int& n,
                                         int& per, int& n_split) {
  n = max(0, min(p.n_vis[b], p.n_pages * p.page));
  const int np = (n + p.page - 1) / p.page;
  per = (np + p.NS - 1) / p.NS;
  n_split = per > 0 ? (np + per - 1) / per : 0;
}

__device__ __forceinline__ size_t partial_row(const Params& p, int b, int hg,
                                              int split, int hh) {
  return ((static_cast<size_t>(b) * p.HG + hg) * p.NS + split) * kHeads + hh;
}

template <typename T>
__host__ __device__ constexpr int vec_n() {   // values per 16-byte copy
  return 16 / static_cast<int>(sizeof(T));
}

// Shared memory of a split block: the q tile, then (bf16) the score
// partials over the same bytes once q sits in registers; the 2-stage key
// ring; the probabilities; (alpha) and (m, l) of each head; key flags; the
// split's block-table entries.
template <typename T>
__host__ __device__ size_t head_bytes(int LDK) {
  const size_t q = static_cast<size_t>(kHeads) * LDK * sizeof(T);
  const size_t sp = sizeof(float) * kWarps * kHeads * kSP;
  return std::is_same<T, bf16>::value && sp > q ? sp : q;
}

template <typename T>
size_t split_smem_bytes(int LDK, int per_max) {
  constexpr int LDP = kKeys + vec_n<T>();
  return head_bytes<T>(LDK) +
         static_cast<size_t>(2 * kKeys) * LDK * sizeof(T) +
         static_cast<size_t>(kHeads) * LDP * sizeof(T) +
         sizeof(float) * 2 * kHeads + sizeof(int) * (2 * kKeys + per_max);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
latent_split_kernel(Params p) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int VN = vec_n<T>();
  constexpr int LDP = kKeys + VN;     // probability row stride
  constexpr int kRows = kHeads / kWarps;   // softmax heads of a warp
  constexpr int kOR = kMma ? kNtw : kHeads, kOC = kMma ? 4 : 2;
  extern __shared__ uint4 smem_u4[];
  const int LDK = p.LDK;
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_u4);
  T* qs = reinterpret_cast<T*>(base);                        // [16][LDK]
  float* sp = reinterpret_cast<float*>(base);                // [8][16][kSP]
  T* ks = reinterpret_cast<T*>(base + head_bytes<T>(LDK));   // [2][32][LDK]
  T* ps = ks + 2 * kKeys * LDK;                              // [16][LDP]
  float* rs = reinterpret_cast<float*>(ps + kHeads * LDP);   // [2 * 16]
  int* kok = reinterpret_cast<int*>(rs + 2 * kHeads);        // [2][32]
  int* pg = kok + 2 * kKeys;                                 // [per_max]

  const int split = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment coordinates
  int n, per, n_split;
  row_plan(p, b, n, per, n_split);
  if (p.NS > 1 && split >= n_split) return;  // no page of the row here
  const int k_lo = split * per * p.page;
  const int k_hi = min(k_lo + per * p.page, n);  // keys [k_lo, k_hi)
  const int h0 = hg * kHeads;

  const T* ql = static_cast<const T*>(p.q_lat);
  const T* qr = static_cast<const T*>(p.q_rope);
  const T* ckv = static_cast<const T*>(p.ckv);
  const T* kr = static_cast<const T*>(p.krope);
  const int* bt_row = p.bt + static_cast<size_t>(b) * p.n_pages;
  // 16-byte chunks of a row: c_kv's, then k_rope's, then zeros up to KP
  const int cr = p.R / VN, crd = (p.R + p.DR) / VN, ch = p.KP / VN;

  // one row of [a | b | zeros]: a warp's lanes copy its chunks
  auto copy_row = [&](T* dst, const T* a, const T* bb, bool ok) {
    for (int c = lane; c < ch; c += 32) {
      const bool in = ok && c < crd;
      cp_async16(dst + c * VN,
                 in ? (c < cr ? a + c * VN : bb + (c - cr) * VN) : ckv, in);
    }
  };
#pragma unroll
  for (int i = 0; i < kRows; ++i) {          // q: heads warp + 8 i
    const int hh = warp + kWarps * i, h = h0 + hh;
    const size_t row = static_cast<size_t>(b) * p.H + (h < p.H ? h : 0);
    copy_row(qs + hh * LDK, ql + row * p.R, qr + row * p.DR, h < p.H);
  }
  // the split's table entries, read once: no tile waits on the table
  const int pg0 = k_lo / p.page;
  for (int i = tid; i < (k_hi - k_lo + p.page - 1) / p.page; i += kThreads)
    pg[i] = bt_row[pg0 + i];
  __syncthreads();
  // keys t0 .. t0 + 31 through the block table into ring stage `stage`:
  // warp w copies keys w, w + 8, ..., a page lookup a key
  auto load_tile = [&](int t0, int stage) {
    T* dst = ks + stage * kKeys * LDK;
#pragma unroll
    for (int i = 0; i < kKeys / kWarps; ++i) {
      const int j = warp + kWarps * i, pos = t0 + j;
      const int pid = pos < k_hi ? pg[pos / p.page - pg0] : -1;
      const bool mapped = pid >= 0 && pid < p.P;
      const size_t slot =
          mapped ? static_cast<size_t>(pid) * p.page + pos % p.page : 0;
      copy_row(dst + j * LDK, ckv + slot * p.R, kr + slot * p.DR, mapped);
      if (lane == 0) kok[stage * kKeys + j] = mapped;
    }
  };

  const int KS = p.KP / 16;                // k16 steps of a key row
  const int NT = p.R / 8;                  // n8 tiles of an output row
  const int ntw = (NT + kWarps - 1) / kWarps;
  float m[kRows], l[kRows];                // heads warp + 8 i (every lane)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float o[kOR][kOC];                       // bf16: n8 tiles; fp32: heads
#pragma unroll
  for (int j = 0; j < kOR; ++j)
#pragma unroll
    for (int e = 0; e < kOC; ++e) o[j][e] = 0.f;
  uint32_t qa[kKsw][4];

  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;
  if (n_tiles > 0) load_tile(k_lo, 0);
  cp_async_commit();                       // q and the first tile
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_lo + it * kKeys, stage = it & 1;
    if (it + 1 < n_tiles) load_tile(t0 + kKeys, stage ^ 1);
    cp_async_commit();                     // maybe empty: keeps the counts
    cp_async_wait1();                      // this tile (and q) landed
    __syncthreads();
    const T* kt = ks + stage * kKeys * LDK;
    const bool key_ok = kok[stage * kKeys + lane] != 0;
    if constexpr (kMma) {
      if (it == 0) {                       // q to registers; then its
#pragma unroll                             // bytes take the partials
        for (int i = 0; i < kKsw; ++i) {
          const int kk = warp + kWarps * i;
          if (kk < KS)
            ldsm_x4(qa[i], qs + (lane & 15) * LDK + kk * 16 + (lane >> 4) * 8);
        }
        __syncthreads();
      }
    }
    // a tile with no mapped key changes nothing (the flags are the block's,
    // so every warp takes the same branch)
    if (__any_sync(0xffffffffu, key_ok)) {
      float s[kRows];                      // heads warp + 8 i, key `lane`
      if constexpr (kMma) {
        float c[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
        for (int i = 0; i < kKsw; ++i) {
          const int kk = warp + kWarps * i;
          if (kk < KS) {
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              uint32_t bb[4];
              ldsm_x4(bb, kt + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LDK +
                              kk * 16 + ((lane >> 3) & 1) * 8);
              mma16816(c[2 * jp], qa[i], bb[0], bb[1]);
              mma16816(c[2 * jp + 1], qa[i], bb[2], bb[3]);
            }
          }
        }
        float* spw = sp + warp * kHeads * kSP;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          store2(spw + g * kSP + j * 8 + 2 * t4, c[j][0], c[j][1]);
          store2(spw + (g + 8) * kSP + j * 8 + 2 * t4, c[j][2], c[j][3]);
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = (warp + kWarps * i) * kSP + lane;
          float x = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) x += sp[w * kHeads * kSP + r];
          s[i] = x;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i] = 0.f;
        const float* krow = reinterpret_cast<const float*>(kt) + lane * LDK;
        const float* qf = reinterpret_cast<const float*>(qs);
        for (int d = 0; d < p.KP; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float4 qq = *reinterpret_cast<const float4*>(
                qf + (warp + kWarps * i) * LDK + d);
            s[i] = fmaf(qq.x, kv.x, s[i]);
            s[i] = fmaf(qq.y, kv.y, s[i]);
            s[i] = fmaf(qq.z, kv.z, s[i]);
            s[i] = fmaf(qq.w, kv.w, s[i]);
          }
        }
      }
      // online softmax (base 2); a masked key gives p = 0 exactly
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int hh = warp + kWarps * i;
        const float x = key_ok ? s[i] * p.scale2 : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(x));
        const float pr = key_ok ? exp2f(x - m_new) : 0.f;
        const float alpha = exp2f(m[i] - m_new);
        l[i] = l[i] * alpha + warp_sum(pr);
        m[i] = m_new;
        store1(ps + hh * LDP + lane, pr);
        if (lane == 0) rs[hh] = alpha;
      }
      __syncthreads();
      // o = o * alpha + p v
      if constexpr (kMma) {
        const float a0 = rs[g], a1 = rs[g + 8];
#pragma unroll
        for (int j = 0; j < kNtw; ++j) {
          o[j][0] *= a0;
          o[j][1] *= a0;
          o[j][2] *= a1;
          o[j][3] *= a1;
        }
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          uint32_t pa[4];
          ldsm_x4(pa, ps + (lane & 15) * LDP + kk * 16 + (lane >> 4) * 8);
          const T* vrow =
              kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK;
#pragma unroll
          for (int jj = 0; jj < kNtw; jj += 2) {
            const int j0 = warp * ntw + jj;
            if (jj < ntw && j0 < NT) {
              if (jj + 1 < ntw && j0 + 1 < NT) {
                uint32_t bb[4];
                ldsm_x4_t(bb, vrow + j0 * 8 + (lane >> 4) * 8);
                mma16816(o[jj], pa, bb[0], bb[1]);
                mma16816(o[jj + 1], pa, bb[2], bb[3]);
              } else {
                uint32_t bb[2];
                ldsm_x2_t(bb, vrow + j0 * 8);
                mma16816(o[jj], pa, bb[0], bb[1]);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          const float a = rs[hh];
          o[hh][0] *= a;
          o[hh][1] *= a;
        }
        const float* pf = reinterpret_cast<const float*>(ps);
        const float* kf = reinterpret_cast<const float*>(kt);
        const int col = 2 * tid;             // columns 2 tid, 2 tid + 1
        if (col < p.R) {
          for (int k = 0; k < kKeys; ++k) {
            const float2 v = load2(kf + k * LDK + col);
#pragma unroll
            for (int hh = 0; hh < kHeads; ++hh) {
              const float pk = pf[hh * LDP + k];
              o[hh][0] = fmaf(pk, v.x, o[hh][0]);
              o[hh][1] = fmaf(pk, v.y, o[hh][1]);
            }
          }
        }
      }
    }
    __syncthreads();                       // this stage consumed
  }
  cp_async_wait_all();                     // no tile: q's copies still land

  // finalize (one split) or write the partials for the merge pass
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      rs[2 * (warp + kWarps * i)] = m[i];
      rs[2 * (warp + kWarps * i) + 1] = l[i];
    }
  }
  __syncthreads();
  if (p.NS > 1 && tid < kHeads && h0 + tid < p.H) {
    const size_t row = partial_row(p, b, hg, split, tid);
    p.ml[row * 2] = rs[2 * tid];
    p.ml[row * 2 + 1] = rs[2 * tid + 1];
  }
  auto put = [&](int hh, int col, float v0, float v1) {
    if (h0 + hh >= p.H) return;
    if (p.NS == 1) {
      const float lr = rs[2 * hh + 1];
      const float inv = 1.f / (lr == 0.f ? 1.f : lr);
      store2(static_cast<T*>(p.out) +
                 (static_cast<size_t>(b) * p.H + h0 + hh) * p.R + col,
             v0 * inv, v1 * inv);
    } else {
      store2(p.acc + partial_row(p, b, hg, split, hh) * p.R + col, v0, v1);
    }
  };
  if constexpr (kMma) {
#pragma unroll
    for (int jj = 0; jj < kNtw; ++jj) {
      const int j0 = warp * ntw + jj;
      if (jj < ntw && j0 < NT) {
        put(g, j0 * 8 + 2 * t4, o[jj][0], o[jj][1]);
        put(g + 8, j0 * 8 + 2 * t4, o[jj][2], o[jj][3]);
      }
    }
  } else {
    if (2 * tid < p.R) {
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh)
        put(hh, 2 * tid, o[hh][0], o[hh][1]);
    }
  }
}

// One block per (head, batch row); thread i merges columns 2i, 2i + 1 over
// the row's non-empty splits in split order, online.
template <typename T>
__global__ void latent_merge_kernel(Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = 2 * threadIdx.x;
  const int hg = h / kHeads, hh = h % kHeads;
  int n, per, n_split;
  row_plan(p, b, n, per, n_split);
  float mx = kNegInf, lsum = 0.f, o0 = 0.f, o1 = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t row = partial_row(p, b, hg, s, hh);
    const float2 ml = load2(p.ml + row * 2);
    if (ml.y > 0.f) {                      // a split that saw a key
      const float2 a = load2(p.acc + row * p.R + d);
      const float m_new = fmaxf(mx, ml.x);
      const float alpha = exp2f(mx - m_new), w = exp2f(ml.x - m_new);
      lsum = lsum * alpha + ml.y * w;
      o0 = o0 * alpha + a.x * w;
      o1 = o1 * alpha + a.y * w;
      mx = m_new;
    }
  }
  const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
  store2(static_cast<T*>(p.out) + (static_cast<size_t>(b) * p.H + h) * p.R +
             d,
         o0 * inv, o1 * inv);
}

template <typename T>
cudaError_t launch_dtype(const Params& p, cudaStream_t s) {
  const size_t smem = split_smem_bytes<T>(p.LDK, p.per_max);
  cudaError_t err = cudaFuncSetAttribute(
      latent_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  latent_split_kernel<T><<<dim3(p.NS, p.HG, p.B), kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.NS == 1) return err;
  latent_merge_kernel<T><<<dim3(p.H, p.B), p.R / 2, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// fp32 entries of the workspace a launch of NS splits needs: (m, l) and R
// accumulators per (row, head slot, split) when NS > 1, else 0.
extern "C" long long paged_latent_workspace_size(int B, int H, int R,
                                                 int NS) {
  if (NS <= 1) return 0;
  const long long HG = (H + kHeads - 1) / kHeads;
  return static_cast<long long>(B) * HG * NS * kHeads * (2 + R);
}

// q_lat (B, H, R), q_rope (B, H, DR), ckv pages (P, page, R), krope pages
// (P, page, DR), one dtype (bf16 or fp32), 16-byte aligned; bt (B, n_pages)
// i32, n_vis (B,) i32; ws the fp32 workspace of
// paged_latent_workspace_size entries (null when that is 0) -> out (B, H,
// R) in q's dtype.  R and DR multiples of 8, R <= 512, DR <= 64.  Returns
// the first CUDA error of the launches.
extern "C" int paged_latent_launch(const void* q_lat, const void* q_rope,
                                   const void* ckv, const void* krope,
                                   const void* bt, const void* n_vis,
                                   void* ws, void* out, int B, int H, int R,
                                   int DR, int P, int page, int n_pages,
                                   int NS, float scale, int is_bf16,
                                   void* stream) {
  Params p;
  p.q_lat = q_lat;
  p.q_rope = q_rope;
  p.ckv = ckv;
  p.krope = krope;
  p.bt = static_cast<const int*>(bt);
  p.n_vis = static_cast<const int*>(n_vis);
  p.out = out;
  p.B = B; p.H = H; p.R = R; p.DR = DR; p.P = P; p.page = page;
  p.n_pages = n_pages;
  p.HG = (H + kHeads - 1) / kHeads;
  p.NS = NS;
  p.per_max = (n_pages + NS - 1) / NS;
  p.KP = (R + DR + 15) / 16 * 16;
  p.LDK = p.KP + (is_bf16 ? vec_n<bf16>() : vec_n<float>());
  p.scale2 = scale * kLog2e;
  p.ml = static_cast<float*>(ws);
  p.acc = ws == nullptr
              ? nullptr
              : p.ml + static_cast<size_t>(B) * p.HG * NS * kHeads * 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dtype<bf16>(p, s) : launch_dtype<float>(p, s);
  return static_cast<int>(err);
}

extern "C" const char* paged_latent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
