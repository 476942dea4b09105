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
// head), so decode is far below the card's compute rate.  Chunked prefill
// (C = 128 chunk queries x G = 4 heads = 512 rows per KV group) has more
// arithmetic per byte but stays small next to the model's matmuls.
//
// Design:
//   * grid (B, K, ceil(C*G / ROWS)); a block owns ROWS query rows of KV group
//     k of batch row b.  Row r is chunk offset c = r / G of query head
//     k*G + r % G at absolute position lengths[b] + c; the kernel reads q and
//     writes the output in the model's (B, C, H, D) layout, so the wrapper
//     needs no transpose.  The TPU kernel held all C*G rows of a group in one
//     VMEM tile; 512 rows do not fit a block's registers, so rows are tiled;
//   * the block reads its own block-table row and walks the pages j in
//     order, skipping entries >= P (the INVALID sink) and stopping at the
//     first page past the last key position its rows can see;
//   * a page is staged 32 tokens at a time in shared memory as fp32 (bf16
//     pools convert with __bfloat162float); K rows are padded by one float
//     so the per-token dot products are free of bank conflicts;
//   * each warp owns ROWS / 4 rows: lane t scores token t, the causal mask
//     k_pos <= lengths[b] + c applies, and the per-row (m, l, acc) fp32 online
//     softmax advances as in the TPU kernel (a row that has seen no visible
//     key keeps p = 0); lane l keeps acc for dims l, l + 32, ...;
//   * finalize acc / l, with l == 0 (a row that saw no visible key: an idle
//     slot or a pad row) giving exact zeros.  The output has q's dtype.
// Launched on the caller's stream; allocates nothing; never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;            // tokens staged per shared-memory tile
constexpr float kNegInf = -1e30f;

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

// NCH: ceil(D / 32) dims per lane; RW: rows per warp
template <typename T, int NCH, int RW>
__global__ void __launch_bounds__(kWarps * 32)
paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
             const T* __restrict__ v_pages, const int* __restrict__ bt,
             const int* __restrict__ lengths, T* __restrict__ out, int C,
             int H, int K, int D, int P, int page, int n_pages, int G,
             float scale) {
  constexpr int kDMax = NCH * 32;
  constexpr int kRows = kWarps * RW;
  __shared__ float ks[kTile][kDMax + 1];
  __shared__ float vs[kTile][kDMax];
  __shared__ float qs[kRows][kDMax];

  const int b = blockIdx.x, kh = blockIdx.y;
  const int CG = C * G;
  const int row0 = blockIdx.z * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int length = lengths[b];

  for (int e = threadIdx.x; e < kRows * D; e += blockDim.x) {
    const int rr = e / D, d = e % D, r = row0 + rr;
    float v = 0.f;
    if (r < CG) {
      const int c = r / G, h = kh * G + r % G;
      v = to_f32(q[((static_cast<size_t>(b) * C + c) * H + h) * D + d]);
    }
    qs[rr][d] = v;
  }

  float m[RW], l[RW], acc[RW][NCH];
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    for (int ch = 0; ch < NCH; ++ch) acc[i][ch] = 0.f;
  }
  // the last key position any row of this block may see
  const int r_last = min(row0 + kRows, CG) - 1;
  const int kpos_max = length + r_last / G;
  const int* bt_row = bt + static_cast<size_t>(b) * n_pages;

  for (int j = 0; j < n_pages && j * page <= kpos_max; ++j) {
    const int pid = bt_row[j];
    if (pid < 0 || pid >= P) continue;              // INVALID sink: skip
    for (int t0 = 0; t0 < page; t0 += kTile) {
      const int nt = min(kTile, page - t0);
      __syncthreads();                              // last tile consumed
      for (int e = threadIdx.x; e < nt * D; e += blockDim.x) {
        const int t = e / D, d = e % D;
        const size_t off =
            ((static_cast<size_t>(pid) * page + t0 + t) * K + kh) * D + d;
        ks[t][d] = to_f32(k_pages[off]);
        vs[t][d] = to_f32(v_pages[off]);
      }
      __syncthreads();
      const int kpos = j * page + t0 + lane;
      for (int i = 0; i < RW; ++i) {
        const int rr = warp * RW + i, r = row0 + rr;
        if (r >= CG) break;                         // warp-uniform
        const int qpos = length + r / G;
        float s = kNegInf;
        if (lane < nt) {
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qs[rr][d], ks[lane][d], dot);
          s = kpos <= qpos ? dot * scale : kNegInf;
        }
        const float m_new = fmaxf(m[i], warp_max(s));
        // a row with no visible key yet keeps m == -1e30: zero its partials
        const float p =
            (lane < nt && m_new > kNegInf / 2) ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[i] - m_new);
        l[i] = l[i] * alpha + warp_sum(p);
        for (int ch = 0; ch < NCH; ++ch) acc[i][ch] *= alpha;
        for (int t = 0; t < nt; ++t) {
          const float pt = __shfl_sync(0xffffffffu, p, t);
          for (int ch = 0; ch < NCH; ++ch) {
            const int d = lane + 32 * ch;
            if (d < D) acc[i][ch] = fmaf(pt, vs[t][d], acc[i][ch]);
          }
        }
        m[i] = m_new;
      }
    }
  }

  for (int i = 0; i < RW; ++i) {
    const int r = row0 + warp * RW + i;
    if (r >= CG) break;
    const int c = r / G, h = kh * G + r % G;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* o = out + ((static_cast<size_t>(b) * C + c) * H + h) * D;
    for (int ch = 0; ch < NCH; ++ch) {
      const int d = lane + 32 * ch;
      if (d < D) o[d] = from_f32<T>(acc[i][ch] / denom);
    }
  }
}

template <typename T, int NCH>
void launch_rows(const void* q, const void* kp, const void* vp,
                 const int* bt, const int* lengths, void* out, int B, int C,
                 int H, int K, int D, int P, int page, int n_pages,
                 float scale, cudaStream_t stream) {
  const int G = H / K, CG = C * G;
  if (CG <= kWarps) {                               // decode: a row per warp
    dim3 grid(B, K, (CG + kWarps - 1) / kWarps);
    paged_kernel<T, NCH, 1><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), bt, lengths, static_cast<T*>(out), C, H,
        K, D, P, page, n_pages, G, scale);
  } else {
    dim3 grid(B, K, (CG + 4 * kWarps - 1) / (4 * kWarps));
    paged_kernel<T, NCH, 4><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), bt, lengths, static_cast<T*>(out), C, H,
        K, D, P, page, n_pages, G, scale);
  }
}

template <typename T>
void launch_dtype(const void* q, const void* kp, const void* vp,
                  const int* bt, const int* lengths, void* out, int B, int C,
                  int H, int K, int D, int P, int page, int n_pages,
                  float scale, cudaStream_t s) {
  if (D <= 32)
    launch_rows<T, 1>(q, kp, vp, bt, lengths, out, B, C, H, K, D, P, page,
                      n_pages, scale, s);
  else if (D <= 64)
    launch_rows<T, 2>(q, kp, vp, bt, lengths, out, B, C, H, K, D, P, page,
                      n_pages, scale, s);
  else
    launch_rows<T, 4>(q, kp, vp, bt, lengths, out, B, C, H, K, D, P, page,
                      n_pages, scale, s);
}

}  // namespace

// q (B, C, H, D), k/v pages (P, page, K, D), same dtype (f32 or bf16);
// bt (B, n_pages) i32, lengths (B,) i32 -> out (B, C, H, D) in q's dtype.
// D <= 128, H % K == 0.  Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* bt,
                                      const void* lengths, void* out, int B,
                                      int C, int H, int K, int D, int P,
                                      int page, int n_pages, float scale,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt_i = static_cast<const int*>(bt);
  const int* len_i = static_cast<const int*>(lengths);
  if (is_bf16)
    launch_dtype<__nv_bfloat16>(q, k_pages, v_pages, bt_i, len_i, out, B, C,
                                H, K, D, P, page, n_pages, scale, s);
  else
    launch_dtype<float>(q, k_pages, v_pages, bt_i, len_i, out, B, C, H, K, D,
                        P, page, n_pages, scale, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
