// Causal GQA flash attention for prefill, with an optional sliding window,
// for NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
//   flash_attention_kernel (_flash_kernel).
//
// What bounds it on the H100: operations.  One row of S = 4608 under a
// 4096-key window at 32 heads x head_dim 120 does 161 GFLOP of score and PV
// products against 1.1 MB of q/k/v/out, so the bytes are nothing next to the
// arithmetic.  This first version does that arithmetic with fp32 FMAs from
// shared memory (67 TFLOP/s peak), not with the tensor cores (989 TFLOP/s
// bf16): wgmma/TMA tiles are later work.
//
// Design:
//   * The TPU kernel walks the kv blocks in its sequential grid, carrying
//     (m, l, acc) in VMEM scratch.  Here one block owns a tile of kRows = 64
//     query rows of one KV head group and loops over the key tiles itself.
//     Row r of group kh is position r / G of query head kh * G + r % G, so
//     the G heads that share a KV head sit in one tile and each K/V tile is
//     read once per group (any G, any head_dim <= 128 with head_dim % 8 == 0).
//   * The loop runs only over the keys the tile's rows can see: from
//     max(0, first position - window + 1) to the last position (causal), so
//     blocks above the diagonal and left of the window are never touched.
//     Keys inside the range but outside a row's band are masked to -1e30
//     and contribute p = 0.  S need not be a multiple of anything: the
//     ragged edge is masked, not padded.
//   * q, k and v are read in the model's sequence-major layout (B, S, H, D)
//     / (B, S, K, D) with 16-byte loads (8 bf16 or 4 fp32 values) and staged
//     in shared memory as fp32: q and k transposed ([d][row], [d][key]) so
//     the score product reads float4s, v as [key][d].
//   * 256 threads as a 16 x 16 grid: thread (ty, tx) owns score rows
//     4ty..4ty+3 and columns 4tx..4tx+3 of a 64 x 64 tile, and output rows
//     4ty..4ty+3 at dims tx * DP/16 .. .  The same thread owns a row's
//     scores and outputs, so the online-softmax rescale stays in registers;
//     row max and sum reduce over the 16 lanes that share ty.
//   * fp32 (m, l, acc) online softmax as in the TPU kernel; finalize
//     acc / l (l == 0 -> 1), written in q's dtype.
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
template <> struct VecN<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 g = __bfloat1622float2(h[i]);
    f[2 * i] = g.x;
    f[2 * i + 1] = g.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

}  // namespace

// q (B, S, H, D), k/v (B, S, K, D), same dtype (f32 or bf16), contiguous,
// 16-byte aligned -> out (B, S, H, D) in q's dtype.  H % K == 0, D <= 128,
// D % 8 == 0; window 0 means no window.  Returns the first CUDA error of the
// attribute call or the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int K, int D, int causal,
                                      int window, float scale, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dim<__nv_bfloat16>(q, k, v, out, B, S, H, K, D, causal,
                                     window, scale, s);
  return launch_dim<float>(q, k, v, out, B, S, H, K, D, causal, window,
                           scale, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
