// Shared by the two split flash-decode kernels (decode_attention.cu over a
// contiguous cache, decode_attention_paged.cu over a page pool): the loads
// that read a ring tile's rows as f32, and the merge of the splits'
// partials.
//
// A split writes its partial of (b, g, split) as f32 at
// part + ((b * G + g) * splits + split) * Hg * (dh + 2): the unnormalised
// acc [Hg, dh], then the running max m [Hg], then the running sum l [Hg].
// A split that held no position of its row writes l = 0.
#pragma once
#include "common.cuh"

namespace {

// the kVW = 16 / sizeof(T) values of one 16-byte load, as f32
template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* d);
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* d) {
  d[0] = __uint_as_float(u.x);
  d[1] = __uint_as_float(u.y);
  d[2] = __uint_as_float(u.z);
  d[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u,
                                                               float* d) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    d[2 * j] = f.x;
    d[2 * j + 1] = f.y;
  }
}

// two neighbouring values as f32
template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One block per (g, b): out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30)
// with w_s = exp(m_s - max_s m_s) over the non-empty splits (l_s > 0).
// One warp per head finds the max and the weights and sums the
// denominator (lanes over splits, then the warp's fixed tree); each
// output sums its acc_s in split order. No atomics: the same partials
// give the same output bits. Shared memory: the partials' m, then l,
// then the weights, each [splits, Hg], then the denominators [Hg].
template <typename T>
__global__ void __launch_bounds__(1024)
decode_merge_kernel(const float* __restrict__ part, int H, int G, int dh,
                    int splits, T* __restrict__ out) {
  extern __shared__ float sm[];
  const int g = blockIdx.x, b = blockIdx.y, Hg = H / G;
  const int n = splits * Hg;
  float* m_s = sm;
  float* l_s = m_s + n;
  float* w_s = l_s + n;
  float* den = w_s + n;
  const size_t stride = (size_t)Hg * (dh + 2);
  const float* pb = part + ((size_t)b * G + g) * splits * stride;
  const size_t qbase = ((size_t)b * H + (size_t)g * Hg) * dh;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float* ps = pb + (e / Hg) * stride + Hg * dh + e % Hg;
    m_s[e] = ps[0];
    l_s[e] = ps[Hg];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int h = threadIdx.x >> 5; h < Hg; h += nw) {
    float mt = kMask;
    for (int s = lane; s < splits; s += 32)
      if (l_s[s * Hg + h] > 0.f) mt = fmaxf(mt, m_s[s * Hg + h]);
    mt = warp_max(mt);
    float lt = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float ls = l_s[s * Hg + h];
      const float w = ls > 0.f ? expf(m_s[s * Hg + h] - mt) : 0.f;
      w_s[s * Hg + h] = w;
      lt += ls * w;
    }
    lt = warp_sum(lt);
    if (lane == 0) den[h] = fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Hg * dh; e += blockDim.x) {
    const int h = e / dh;
    float at = 0.f;
#pragma unroll 16
    for (int s = 0; s < splits; ++s) at += pb[s * stride + e] * w_s[s * Hg + h];
    out[qbase + e] = from_f<T>(at / den[h]);
  }
}

// the merge launch over every (g, b) of a B-row batch
template <typename T>
cudaError_t launch_merge(const void* part, int B, int H, int G, int dh,
                         int splits, void* out, cudaStream_t st) {
  const int Hg = H / G;
  const size_t smem = (size_t)(3 * splits + 1) * Hg * sizeof(float);
  const int threads = min(1024, (Hg * dh + 31) / 32 * 32);
  decode_merge_kernel<T><<<dim3(G, B), threads, smem, st>>>(
      static_cast<const float*>(part), H, G, dh, splits, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace
