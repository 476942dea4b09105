// Flash-decode: one query token per row against a dense KV cache, GQA, for
// NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_attention/kernel.py:
//   decode_attention_kernel (_decode_kernel).
//
// What bounds it on the H100: reading the cache.  Each row streams its
// kv_len valid slots of K and V once per KV head (h2o-danube3-4b at B = 8,
// a full 4096-slot ring, K = 8, head_dim 120, bf16: 125.8 MB, 37.6 us at
// 3.35 TB/s); the products are G * head_dim multiply-adds per slot.
//
// Design:
//   * The TPU kernel walks the cache in its sequential kv grid axis with
//     (m, l, acc) in VMEM scratch, one (b, kv head) per grid row.  B * K is
//     64 at the main path's shape, half the card's 132 SMs, so here the cache
//     is also split along S (flash-decoding): grid (S / kChunk, K, B), each
//     block scores slots [s0, s0 + kChunk) clipped to kv_len and writes its
//     partial (m, l, acc) in fp32 to scratch; a second kernel merges the
//     partials of a row.  Splits at or past kv_len write the empty partial
//     (m = -1e30, l = 0, acc = 0), which the merge weights by 0.
//   * All G query heads of the group share one block, so each slot is read
//     once per group, the point of the TPU kernel's (G, D) query tile: 4
//     warps, warp w owning heads w, w + 4, ... (G <= 16).
//   * Slots are staged kTile = 32 at a time in shared memory as fp32 from
//     16-byte loads of the sequence-major (B, S, K, D) cache (no transpose
//     copy); K rows padded by one float so that lane t's dot product over
//     slot t is free of bank conflicts.  Lane l keeps acc for dims l, l + 32,
//     ...; the online softmax is the TPU kernel's, in fp32.
//   * The merge: M = max m_s, out = sum_s acc_s e^(m_s - M) / sum_s l_s
//     e^(m_s - M); a row with no valid slot (kv_len == 0) has l == 0 and
//     finalizes to exact zeros, as the TPU kernel's l == 0 -> 1 does.
// Launched on the caller's stream; allocates nothing (the wrapper passes
// the scratch); never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;            // slots staged per shared-memory tile
constexpr int kChunk = 256;          // slots per split
constexpr int kGMax = 16;            // query heads per KV head
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// NCH: ceil(D / 32) dims per lane; RW: heads per warp.  Partials go to
// ml[((b * K + kh) * NS + split) * G + g][2] and acc[... ][D].
template <typename T, int NCH, int RW>
__global__ void __launch_bounds__(kWarps * 32)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kv_len,
             float* __restrict__ ml, float* __restrict__ acc_out, int S,
             int H, int K, int D, int G, float scale) {
  constexpr int VN = VecN<T>::N;
  constexpr int kDMax = NCH * 32;
  __shared__ float ks[kTile][kDMax + 1];
  __shared__ __align__(16) float vs[kTile][kDMax];
  __shared__ float qs[kGMax][kDMax];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = min(kv_len[b], S);
  const int s0 = split * kChunk, s1 = min(s0 + kChunk, len);
  const int nv = D / VN;

  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    qs[g][d] = to_f32(q[(static_cast<size_t>(b) * H + kh * G + g) * D + d]);
  }

  float m[RW], l[RW], acc[RW][NCH];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) acc[i][ch] = 0.f;
  }

  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int nt = min(kTile, s1 - t0);
    __syncthreads();                     // qs written / last tile consumed
    for (int e = threadIdx.x; e < nt * nv; e += blockDim.x) {
      const int t = e / nv, vi = e % nv;
      const size_t off =
          ((static_cast<size_t>(b) * S + t0 + t) * K + kh) * D + vi * VN;
      float f[VN];
      load16(k + off, f);
#pragma unroll
      for (int i = 0; i < VN; ++i) ks[t][vi * VN + i] = f[i];
      load16(v + off, f);
#pragma unroll
      for (int i = 0; i < VN; i += 4)
        *reinterpret_cast<float4*>(&vs[t][vi * VN + i]) =
            make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int g = warp + kWarps * i;
      if (g >= G) break;                 // warp-uniform
      float s = kNegInf;
      if (lane < nt) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qs[g][d], ks[lane][d], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = lane < nt ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) acc[i][ch] *= alpha;
      for (int t = 0; t < nt; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int d = lane + 32 * ch;
          if (d < D) acc[i][ch] = fmaf(pt, vs[t][d], acc[i][ch]);
        }
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int g = warp + kWarps * i;
    if (g >= G) break;
    const size_t row = ((static_cast<size_t>(b) * K + kh) * NS + split) * G + g;
    if (lane == 0) {
      ml[row * 2] = m[i];
      ml[row * 2 + 1] = l[i];
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int d = lane + 32 * ch;
      if (d < D) acc_out[row * D + d] = acc[i][ch];
    }
  }
}

// one block per (head, b); thread d merges dim d over the NS splits
template <typename T>
__global__ void merge_kernel(const float* __restrict__ ml,
                             const float* __restrict__ acc, T* __restrict__ out,
                             int H, int K, int D, int G, int NS) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kh = h / G, g = h % G;
  const size_t row0 = (static_cast<size_t>(b) * K + kh) * NS * G + g;
  float mx = kNegInf;
  for (int s = 0; s < NS; ++s) mx = fmaxf(mx, ml[(row0 + s * G) * 2]);
  float lsum = 0.f, o = 0.f;
  for (int s = 0; s < NS; ++s) {
    const size_t row = row0 + static_cast<size_t>(s) * G;
    const float w = expf(ml[row * 2] - mx);
    lsum += ml[row * 2 + 1] * w;
    if (d < D) o += acc[row * D + d] * w;
  }
  if (d < D)
    out[(static_cast<size_t>(b) * H + h) * D + d] =
        from_f32<T>(o / (lsum == 0.f ? 1.f : lsum));
}

template <typename T, int NCH>
void launch_split(const void* q, const void* k, const void* v,
                  const int* kv_len, float* ml, float* acc, int B, int S,
                  int H, int K, int D, int NS, float scale, cudaStream_t s) {
  const int G = H / K;
  dim3 grid(NS, K, B);
  if (G <= kWarps)
    split_kernel<T, NCH, 1><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), kv_len, ml, acc, S, H, K, D, G, scale);
  else if (G <= 2 * kWarps)
    split_kernel<T, NCH, 2><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), kv_len, ml, acc, S, H, K, D, G, scale);
  else
    split_kernel<T, NCH, 4><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), kv_len, ml, acc, S, H, K, D, G, scale);
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v,
                 const int* kv_len, float* ml, float* acc, void* out, int B,
                 int S, int H, int K, int D, int NS, float scale,
                 cudaStream_t s) {
  if (D <= 32)
    launch_split<T, 1>(q, k, v, kv_len, ml, acc, B, S, H, K, D, NS, scale, s);
  else if (D <= 64)
    launch_split<T, 2>(q, k, v, kv_len, ml, acc, B, S, H, K, D, NS, scale, s);
  else
    launch_split<T, 4>(q, k, v, kv_len, ml, acc, B, S, H, K, D, NS, scale, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<T><<<dim3(H, B), 128, 0, s>>>(ml, acc, static_cast<T*>(out), H,
                                            K, D, H / K, NS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Slots per split: the wrapper sizes the scratch as (B, K, ceil(S /
// chunk), G) rows of (m, l) and of D accumulators.
extern "C" int decode_attention_chunk() { return kChunk; }

// q (B, H, D), k/v (B, S, K, D), same dtype (f32 or bf16), contiguous,
// 16-byte aligned; kv_len (B,) i32; ml/acc fp32 scratch as above -> out
// (B, H, D) in q's dtype.  H % K == 0, H / K <= 16, D <= 128, D % 8 == 0.
// Returns the first CUDA error of the two launches.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* ml, void* acc, void* out, int B,
                                       int S, int H, int K, int D, float scale,
                                       int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NS = (S + kChunk - 1) / kChunk;
  const int* len = static_cast<const int*>(kv_len);
  float* ml_f = static_cast<float*>(ml);
  float* acc_f = static_cast<float*>(acc);
  if (is_bf16)
    return launch_dtype<__nv_bfloat16>(q, k, v, len, ml_f, acc_f, out, B, S,
                                       H, K, D, NS, scale, s);
  return launch_dtype<float>(q, k, v, len, ml_f, acc_f, out, B, S, H, K, D,
                             NS, scale, s);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
