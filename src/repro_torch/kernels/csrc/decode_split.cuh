// Shared by the two split flash-decode kernels (decode_attention.cu over a
// contiguous cache, decode_attention_paged.cu over a page pool), each in a
// float cache and an int8 one: the loads that read a ring tile's rows as
// f32, the merge of the splits' partials (in the last split block of
// decode_attention.cu, in a second launch of decode_attention_paged.cu),
// the once-a-device shared-memory attribute, and the 4-byte cp.async of
// the int8 scales.
//
// A split writes its partial of (b, g, split) as f32 at
// part + ((b * G + g) * splits + split) * Hg * (dh + 2): the unnormalised
// acc [Hg, dh], then the running max m [Hg], then the running sum l [Hg]
// (a block of a head group writes the rows of its heads). A split that
// held no position of its row writes l = 0.
#pragma once
#include <atomic>
#include <type_traits>

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

template <> __device__ __forceinline__ void unpack<int8_t>(const uint4& u,
                                                        float* d) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[4 * j + i] = static_cast<float>(static_cast<signed char>(w[j] >> (8 * i)));
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

template <> __device__ __forceinline__ float2 load2<int8_t>(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// cp.async of 4 bytes (an int8 row's f32 scale) global -> shared; with
// in == false nothing is read and the 4 bytes are zero-filled
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}

// The merge of the partials of heads [h0, h0 + nh) of one (b, g), pb
// pointing at its first split's partial: out_h = sum_s acc_s w_s /
// max(sum_s l_s w_s, 1e-30) with w_s = exp(m_s - max_s m_s) over the
// non-empty splits (l_s > 0). The block reads every split's m and l at
// once into shared memory; one warp per head finds the max and the
// weights and sums the denominator (lanes over splits, then the warp's
// fixed tree); each output sums its acc_s in split order. No atomics: the
// same partials give the same output bits, whichever block merges. The
// partials are read through L2 (`__ldcg`): other blocks of the same
// launch may have written them (`decode_merge_kernel`, the paged kernel's
// second launch, is the same arithmetic over read-only partials). sm:
// shared m, l and weights [splits * nh] each, then the denominators [nh]
// (`merge_floats`); out: the output row of head h0. Contains barriers:
// call from every thread of the block.
__host__ __device__ constexpr int merge_floats(int splits, int nh) {
  return (3 * splits + 1) * nh;
}

template <typename T>
__device__ __forceinline__ void merge_heads(const float* pb, int Hg, int dh,
                                            int splits, int h0, int nh,
                                            float* sm, T* out) {
  const int n = splits * nh;
  float* m_s = sm;
  float* l_s = m_s + n;
  float* w_s = l_s + n;
  float* den = w_s + n;
  const size_t stride = (size_t)Hg * (dh + 2);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float* ml = pb + (e / nh) * stride + (size_t)Hg * dh + h0 + e % nh;
    m_s[e] = __ldcg(ml);
    l_s[e] = __ldcg(ml + Hg);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int h = threadIdx.x >> 5; h < nh; h += nw) {
    float mt = kMask;
    for (int s = lane; s < splits; s += 32)
      if (l_s[s * nh + h] > 0.f) mt = fmaxf(mt, m_s[s * nh + h]);
    mt = warp_max(mt);
    float lt = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float ls = l_s[s * nh + h];
      const float w = ls > 0.f ? expf(m_s[s * nh + h] - mt) : 0.f;
      w_s[s * nh + h] = w;
      lt += ls * w;
    }
    lt = warp_sum(lt);
    if (lane == 0) den[h] = fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  // two neighbouring outputs a thread (dh and the partials' stride are
  // even), each summed in split order
  for (int e = 2 * threadIdx.x; e < nh * dh; e += 2 * blockDim.x) {
    const int h = e / dh;
    const float* a = pb + (size_t)h0 * dh + e;
    float2 at = make_float2(0.f, 0.f);
#pragma unroll 16
    for (int s = 0; s < splits; ++s) {
      const float2 x = __ldcg(reinterpret_cast<const float2*>(a + s * stride));
      const float w = w_s[s * nh + h];
      at.x += x.x * w;
      at.y += x.y * w;
    }
    out[e] = from_f<T>(at.x / den[h]);
    out[e + 1] = from_f<T>(at.y / den[h]);
  }
}

// Called by every thread of a split block once its partial is written:
// after a barrier, thread 0 publishes the block's partial and takes the
// ticket of its (b, g, head group) (`__threadfence()` then `atomicAdd`,
// the pattern of a cooperative grid sync); the last of the `splits`
// blocks resets the ticket for the next launch and merges
// (`merge_heads`, its shared scratch `smem`, which the block no longer
// needs). So a call is one launch, and the merge order is the split
// order.
template <typename T>
__device__ __forceinline__ void finish_split(const float* pb, int Hg, int dh,
                                             int splits, int h0, int nh,
                                             int* ticket, float* smem,
                                             T* out) {
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    __threadfence();                  // the partial is visible before the ticket
    last = atomicAdd(ticket, 1) == splits - 1;
    if (last) {
      *ticket = 0;
      __threadfence();                // the other partials before the reads
    }
  }
  if (!__syncthreads_or(last)) return;
  merge_heads<T>(pb, Hg, dh, splits, h0, nh, smem, out);
}

// Let `kernel` take up to the 227 KB of dynamic shared memory a block can
// have, once a device (`done`: a bit a device, a static of the caller's
// instantiation; a launch's own size decides the occupancy)
template <typename K>
cudaError_t allow_smem(K* kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 32 && (done.load() >> dev & 1u))) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           227 * 1024);
  if (e == cudaSuccess && dev < 32) done.fetch_or(1u << dev);
  return e;
}

// One block per (g, b): out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30)
// with w_s = exp(m_s - max_s m_s) over the non-empty splits (l_s > 0).
// One warp per head finds the max and the weights and sums the
// denominator (lanes over splits, then the warp's fixed tree); each
// output sums its acc_s in split order. No atomics: the same partials
// give the same output bits. Shared memory: the partials' m, then l,
// then the weights, each [splits, Hg], then the denominators [Hg].
// decode_attention_paged's second launch. It is `merge_heads`'s
// arithmetic, kept apart: in a launch of its own the partials are
// read-only, so they are read through `__restrict__` pointers (the
// read-only path, about half the time of `merge_heads`'s L2 loads at
// h2o's 33 ring-page splits), which a merge inside the launch that
// writes them may not use.
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
