// Causal GQA flash attention for prefill, with an optional sliding window,
// for NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
//   flash_attention_kernel (_flash_kernel).
//
// What bounds it on the H100: operations.  One row of S = 4608 under a
// 4096-key window at 32 heads x head_dim 120 does 161 GFLOP of score and PV
// products against 1.1 MB of q/k/v/out, so the bytes are nothing next to the
// arithmetic, and the products belong on the tensor cores (989 TFLOP/s
// bf16, against 67 TFLOP/s of fp32 FMAs).
//
// Shared by both routes:
//   * The TPU kernel walks the kv blocks in its sequential grid, carrying
//     (m, l, acc) in VMEM scratch.  Here one block owns a tile of query
//     rows of one KV head group and loops over the key tiles itself.  Row r
//     of group kh is position r / G of query head kh * G + r % G, so the G
//     heads that share a KV head sit in one tile and each K/V tile is read
//     once per group (any G, any head_dim <= 128 with head_dim % 8 == 0).
//   * The loop runs only over the keys the tile's rows can see: from
//     max(0, first position - window + 1) to the last position (causal), so
//     blocks above the diagonal and left of the window are never touched.
//     Keys inside the range but outside a row's band are masked to -1e30
//     and contribute p = 0 exactly.  S need not be a multiple of anything:
//     the ragged edge is masked, not padded.
//   * fp32 (m, l, acc) online softmax as in the TPU kernel; finalize
//     acc / l (l == 0 -> 1), written in q's dtype.
//
// bf16 route (flash_mma_kernel), the FlashAttention-2 shape:
//   * 4 warps, 32 query rows each as two m16 tiles (128 rows a block), so
//     every k or v fragment read from shared memory feeds two products;
//     64 keys a tile.  S = QK^T and O += PV are mma.sync.m16n8k16 with bf16
//     operands and fp32 accumulators; q and k fragments come from shared
//     memory through ldmatrix, v's through ldmatrix.trans.  Only the tiles
//     at the diagonal, the window's edge or the end of the range are
//     masked: a tile that every row of the block sees whole is not.  P is
//     rounded to bf16 in registers and fed as the A operand of PV without
//     touching shared memory (the C fragment of two n8 tiles is the A
//     fragment of a k16 step); the row sum l is kept from the unrounded
//     fp32 P.
//   * K/V tiles arrive by cp.async in a ring of 2 stages: tile i + 1 is in
//     flight while tile i is multiplied.  head_dim is padded to 32, 64 or
//     128 in shared memory; cp.async with a source size of 0 zero-fills the
//     pad columns of q, k and v and the key rows past the range (0 * NaN
//     from stale shared memory would poison the scores); rows are 16 bytes
//     longer than the padded head_dim, so the 8 rows an ldmatrix reads fall
//     on distinct banks.  The pad columns of O and the rows past S are not
//     stored.
//   * wgmma with TMA-fed tiles and warp specialisation is the next step.
//
// fp32 route (flash_kernel): fp32 FMAs from shared memory (TF32 is off by
// the parity contract):
//   * q, k and v are read in the model's sequence-major layout (B, S, H, D)
//     / (B, S, K, D) with 16-byte loads (4 fp32 values) and staged in
//     shared memory: q and k transposed ([d][row], [d][key]) so the score
//     product reads float4s, v as [key][d].
//   * 256 threads as a 16 x 16 grid: thread (ty, tx) owns score rows
//     4ty..4ty+3 and columns 4tx..4tx+3 of a 64 x 64 tile, and output rows
//     4ty..4ty+3 at dims tx * DP/16 .. .  The same thread owns a row's
//     scores and outputs, so the online-softmax rescale stays in registers;
//     row max and sum reduce over the 16 lanes that share ty.
// Launched on the caller's stream; allocates nothing; never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;            // query rows (position x group head)
constexpr int kKeys = 64;            // keys per shared-memory tile
constexpr int kLd = 68;              // padded row of 64 (float4-aligned)
constexpr float kNegInf = -1e30f;

template <typename T> struct VecN;   // values per 16-byte load
template <> struct VecN<float> { static constexpr int N = 4; };

__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// CT consecutive floats of shared memory (16-byte aligned when CT % 4 == 0,
// 8-byte aligned when CT == 2)
template <int CT>
__device__ __forceinline__ void lds(const float* p, float* f) {
  if constexpr (CT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CT; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      f[c] = x.x; f[c + 1] = x.y; f[c + 2] = x.z; f[c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CT; c += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + c);
      f[c] = x.x; f[c + 1] = x.y;
    }
  }
}

template <int DP>
constexpr size_t smem_floats() {
  return static_cast<size_t>(DP) * kLd      // qs [DP][kLd]
         + static_cast<size_t>(DP) * kLd    // ks [DP][kLd]
         + static_cast<size_t>(kKeys) * DP  // vs [kKeys][DP]
         + static_cast<size_t>(kKeys) * kLd;  // ps [kKeys][kLd]
}

// DP: head_dim rounded up to 32, 64 or 128
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             int K, int D, int G, int causal, int window, float scale) {
  constexpr int VN = VecN<T>::N;
  constexpr int CT = DP / 16;                    // output dims per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [DP][kLd]  q^T
  float* ks = qs + DP * kLd;                     // [DP][kLd]  k^T
  float* vs = ks + DP * kLd;                     // [kKeys][DP]
  float* ps = vs + kKeys * DP;                   // [kKeys][kLd] p^T

  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_rows = S * G;
  const int r0 = blockIdx.x * kRows;
  const int r_end = min(r0 + kRows, n_rows);
  const int p_lo = r0 / G, p_hi = (r_end - 1) / G;
  const int k_hi = causal ? p_hi : S - 1;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int nv = D / VN;                         // 16-byte vectors per row

  // q tile, transposed: qs[d][rr]; rows past the end are zeros
  for (int e = tid; e < nv * kRows; e += kThreads) {
    const int vi = e / kRows, rr = e % kRows, r = r0 + rr;
    float f[VN];
    if (r < n_rows) {
      const int p = r / G, h = kh * G + r % G;
      load16(q + ((static_cast<size_t>(b) * S + p) * H + h) * D + vi * VN, f);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) qs[(vi * VN + i) * kLd + rr] = f[i];
  }

  float m[4], l[4], o[4][CT];
  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qp[i] = (r0 + ty * 4 + i) / G;
#pragma unroll
    for (int c = 0; c < CT; ++c) o[i][c] = 0.f;
  }

  for (int t0 = k_lo; t0 <= k_hi; t0 += kKeys) {
    const int nt = min(kKeys, k_hi - t0 + 1);
    __syncthreads();                   // the last tile's ks/vs/ps consumed
    // k tile, transposed (consecutive threads on consecutive keys)
    for (int e = tid; e < nv * kKeys; e += kThreads) {
      const int vi = e / kKeys, t = e % kKeys;
      if (t < nt) {
        float f[VN];
        load16(k + ((static_cast<size_t>(b) * S + t0 + t) * K + kh) * D +
                   vi * VN, f);
#pragma unroll
        for (int i = 0; i < VN; ++i) ks[(vi * VN + i) * kLd + t] = f[i];
      }
    }
    // v tile, as [key][d] (consecutive threads on consecutive vectors)
    for (int e = tid; e < nv * nt; e += kThreads) {
      const int t = e / nv, vi = e % nv;
      float f[VN];
      load16(v + ((static_cast<size_t>(b) * S + t0 + t) * K + kh) * D +
                 vi * VN, f);
      float* dst = vs + t * DP + vi * VN;
#pragma unroll
      for (int i = 0; i < VN; i += 4)
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
    __syncthreads();

    // scores s[i][j] = q[row 4ty+i] . k[key 4tx+j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * kLd + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(ks + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, online softmax; p^T to shared memory for the PV product
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + j, kp = t0 + col;
        const bool ok = col < nt && (!causal || kp <= qp[i]) &&
                        (window <= 0 || kp > qp[i] - window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > kNegInf / 2 ? expf(s[i][j] - m_new) : 0.f;
        ps[(tx * 4 + j) * kLd + ty * 4 + i] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CT; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // o[i][c] += sum_t p[row 4ty+i][t] * v[t][tx*CT + c]
    for (int t = 0; t < nt; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(ps + t * kLd + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float vv[CT];
      lds<CT>(vs + t * DP + tx * CT, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) o[i][c] = fmaf(av[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= n_rows) continue;
    const int p = r / G, h = kh * G + r % G;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* dst = out + ((static_cast<size_t>(b) * S + p) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int d = tx * CT + c;
      if (d < D) dst[d] = from_f32<T>(o[i][c] / denom);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int K, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<DP>() * sizeof(float);
  auto kern = flash_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / K;
  dim3 grid((S * G + kRows - 1) / kRows, K, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, K, D, G, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int K, int D, int causal, int window,
               float scale, cudaStream_t s) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, out, B, S, H, K, D, causal, window, scale,
                         s);
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, S, H, K, D, causal, window, scale,
                         s);
  return launch<T, 128>(q, k, v, out, B, S, H, K, D, causal, window, scale,
                        s);
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kWarpRows = 32;                // query rows of a warp
constexpr int kMmaRows = kMmaWarps * kWarpRows;   // query rows of a block
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
constexpr size_t mma_smem_bytes() {            // q, then 2 stages of k, v
  return static_cast<size_t>(kMmaRows + 4 * kKeys) * (DP + 8) * sizeof(bf16);
}

// DP: head_dim rounded up to 32, 64 or 128.  Shared rows are DP + 8 values
// long (16 bytes of padding), so the 8 rows an ldmatrix reads fall on
// distinct banks.  scale2 = softmax scale * log2(e): the online softmax
// runs in base 2.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                 int H, int K, int D, int G, int causal, int window,
                 float scale2) {
  constexpr int LD = DP + 8;
  constexpr int CH = DP / 8;                   // 16-byte chunks of a row
  constexpr int NT = DP / 8;                   // n8 tiles of an output row
  constexpr int MT = kWarpRows / 16;           // m16 tiles of a warp
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);            // [kMmaRows][LD]
  bf16* ks = qs + kMmaRows * LD;                          // [2][kKeys][LD]
  bf16* vs = ks + 2 * kKeys * LD;                         // [2][kKeys][LD]

  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int n_rows = S * G;
  const int r0 = blockIdx.x * kMmaRows;
  const int r_end = min(r0 + kMmaRows, n_rows);
  const int p_lo = r0 / G, p_hi = (r_end - 1) / G;
  const int k_hi = causal ? p_hi : S - 1;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int nc = D / 8;                        // real chunks of a row

  // q tile: rows past the end and the pad columns are zeros
  for (int e = tid; e < kMmaRows * CH; e += kMmaThreads) {
    const int rr = e / CH, c = e % CH, r = r0 + rr;
    const bool ok = r < n_rows && c < nc;
    const bf16* src = q;
    if (ok)
      src = q + ((static_cast<size_t>(b) * S + r / G) * H + kh * G + r % G) *
                    D + c * 8;
    cp_async16(qs + rr * LD + c * 8, src, ok);
  }
  // k and v tiles of keys t0..t0+63; keys past k_hi and pad columns zeros
  auto load_kv = [&](int t0, int stage) {
    const int nt = min(kKeys, k_hi - t0 + 1);
    for (int e = tid; e < kKeys * CH; e += kMmaThreads) {
      const int j = e / CH, c = e % CH;
      const bool ok = j < nt && c < nc;
      const size_t off =
          ok ? ((static_cast<size_t>(b) * S + t0 + j) * K + kh) * D + c * 8
             : 0;
      const int dst = (stage * kKeys + j) * LD + c * 8;
      cp_async16(ks + dst, k + off, ok);
      cp_async16(vs + dst, v + off, ok);
    }
  };
  load_kv(k_lo, 0);
  cp_async_commit();

  // this thread's rows: g and g + 8 of each of the warp's m16 tiles
  const int row_w = r0 + warp * kWarpRows + g;
  int qp[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    qp[mt][0] = (row_w + 16 * mt) / G;
    qp[mt][1] = (row_w + 16 * mt + 8) / G;
  }
  float m[MT][2], l[MT][2];
  float o[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = kNegInf;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
  }

  const int n_tiles = (k_hi - k_lo) / kKeys + 1;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_lo + it * kKeys, stage = it & 1;
    if (it + 1 < n_tiles) load_kv(t0 + kKeys, stage ^ 1);
    cp_async_commit();                         // maybe empty: keeps counts
    cp_async_wait1();                          // this tile (and q) landed
    __syncthreads();
    const bf16* kt = ks + stage * kKeys * LD;
    const bf16* vt = vs + stage * kKeys * LD;
    const int nt = min(kKeys, k_hi - t0 + 1);
    // a tile every row of the block sees whole needs no mask
    const bool edge = nt < kKeys || (causal && t0 + kKeys - 1 > p_lo) ||
                      (window > 0 && t0 <= p_hi - window);

    // s = q k^T: kWarpRows rows x 64 keys per warp, 8 n8 tiles per m16
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], qs + (warp * kWarpRows + mt * 16 + (lane & 15)) * LD +
                           kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bb[4];
        ldsm_x4(bb, kt + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][2 * jp], a[mt], bb[0], bb[1]);
          mma16816(s[mt][2 * jp + 1], a[mt], bb[2], bb[3]);
        }
      }
    }

    // mask (edge tiles only), online softmax (base 2); masked keys give
    // p = 0 exactly
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = s[mt][j][e] * scale2;
          if (edge) {
            const int col = j * 8 + 2 * t + (e & 1), kp = t0 + col;
            const bool ok = col < nt && (!causal || kp <= qp[mt][h]) &&
                            (window <= 0 || kp > qp[mt][h] - window);
            x = ok ? x : kNegInf;
          }
          s[mt][j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[mt][h], mx[h]);
        alpha[h] = exp2f(m[mt][h] - m_new);
        m[mt][h] = m_new;
        l[mt][h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float x = s[mt][j][e];
          const float p = x > kNegInf / 2 ? exp2f(x - m[mt][h]) : 0.f;
          s[mt][j][e] = p;
          l[mt][h] += p;                       // this thread's columns
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[mt][j][0] *= alpha[0];
        o[mt][j][1] *= alpha[0];
        o[mt][j][2] *= alpha[1];
        o[mt][j][3] *= alpha[1];
      }
    }

    // o += p v: p (bf16, from registers) is the A operand, 4 k16 steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(o[mt][2 * dp], a[mt], bb[0], bb[1]);
          mma16816(o[mt][2 * dp + 1], a[mt], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                           // this stage consumed
  }

  // finalize: the row sums over the 4 threads of a row; l == 0 -> 1
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lr = l[mt][h];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int r = row_w + 16 * mt + 8 * h;
      if (r >= n_rows) continue;
      const float inv = 1.f / (lr == 0.f ? 1.f : lr);
      bf16* dst = out + ((static_cast<size_t>(b) * S + r / G) * H + kh * G +
                         r % G) * D;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(
              o[mt][j][2 * h] * inv, o[mt][j][2 * h + 1] * inv);
      }
    }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int K, int D, int causal, int window,
               float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>();
  auto kern = flash_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / K;
  dim3 grid((S * G + kMmaRows - 1) / kMmaRows, K, B);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, K, D, G,
      causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma_dim(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int K, int D, int causal, int window,
                   float scale, cudaStream_t s) {
  if (D <= 32)
    return launch_mma<32>(q, k, v, out, B, S, H, K, D, causal, window, scale,
                          s);
  if (D <= 64)
    return launch_mma<64>(q, k, v, out, B, S, H, K, D, causal, window, scale,
                          s);
  return launch_mma<128>(q, k, v, out, B, S, H, K, D, causal, window, scale,
                         s);
}

}  // namespace

// q (B, S, H, D), k/v (B, S, K, D), same dtype (f32 or bf16), contiguous,
// 16-byte aligned -> out (B, S, H, D) in q's dtype.  H % K == 0, D <= 128,
// D % 8 == 0; window 0 means no window.  bf16 runs on the tensor cores
// (flash_mma_kernel), f32 on the FMA kernel (flash_kernel).  Returns the
// first CUDA error of the attribute call or the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int K, int D, int causal,
                                      int window, float scale, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma_dim(q, k, v, out, B, S, H, K, D, causal, window, scale,
                          s);
  return launch_dim<float>(q, k, v, out, B, S, H, K, D, causal, window,
                           scale, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
