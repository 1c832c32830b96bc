// Shared by the two split flash-decode kernels (decode_body.cuh, which
// decode_attention.cu instantiates over a contiguous cache and
// decode_attention_paged.cu over a page pool), each in a float cache and
// an int8 one: the unpacking of a 16-byte row load as f32, the merge of
// the splits' partials in the last split block of each (row, kv head,
// head group), a split block that holds no position, the once-a-device
// shared-memory attribute, and the 4-byte cp.async of the int8 scales.
//
// A launch's partials are f32, for the pairs = B * G (row, kv head) pairs:
// first the unnormalised acc of every (b, g, split) [pairs, splits, Hg,
// dh] (`part_acc`), then the running max m and sum l of every (b, g,
// split) [pairs, splits, 2, Hg] (`part_ml`). A block of a head group
// writes the rows of its heads. A split that held no position of its row
// writes only m = -1e30 and l = 0, and the merge sums none of its acc.
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

// Where the partial of split sp of pair bg = b * G + g lies, among
// `pairs` pairs: its acc [Hg, dh], and its m [Hg] then l [Hg]
__device__ __forceinline__ float* part_acc(float* part, size_t bg, int sp,
                                          int splits, int Hg, int dh) {
  return part + (bg * splits + sp) * Hg * dh;
}
__device__ __forceinline__ float* part_ml(float* part, size_t pairs,
                                         size_t bg, int sp, int splits,
                                         int Hg, int dh) {
  return part + pairs * splits * Hg * dh + (bg * splits + sp) * 2 * Hg;
}

// The merge of the partials of heads [h0, h0 + nh) of one pair (acc, ml:
// its first split's, `part_acc` and `part_ml`): out_h = sum_s acc_s w_s /
// max(sum_s l_s w_s, 1e-30) with w_s = exp(m_s - max_s m_s) over the
// non-empty splits (l_s > 0). The block reads every split's m and l at
// once into shared memory; one warp per head finds the max and the
// weights and sums the denominator (lanes over splits, then the warp's
// fixed tree); each output sums its acc_s in split order, its loads
// issued together. No atomics: the same partials give the same output
// bits, whichever block merges. A split of weight 0 (an empty one, l = 0)
// adds nothing: its acc, which an empty split never writes, is loaded but
// not summed. The partials are read through L2 (`__ldcg`): other blocks
// of the same launch wrote them. (One round of cp.async of every split's
// acc rows into shared memory instead measured 1-5 us slower at the
// split path shapes: PERF.md.) sm: shared m, l and weights [splits * nh]
// each, then the denominators [nh] (`merge_floats`); out: the output row
// of head h0. Contains barriers: call from every thread of the block.
__host__ __device__ constexpr int merge_floats(int splits, int nh) {
  return (3 * splits + 1) * nh;
}

template <typename T>
__device__ __forceinline__ void merge_heads(const float* acc, const float* ml,
                                            int Hg, int dh, int splits,
                                            int h0, int nh, float* sm,
                                            T* out) {
  const int n = splits * nh;
  float* m_s = sm;
  float* l_s = m_s + n;
  float* w_s = l_s + n;
  float* den = w_s + n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float* mls = ml + (size_t)(e / nh) * 2 * Hg + h0 + e % nh;
    m_s[e] = __ldcg(mls);
    l_s[e] = __ldcg(mls + Hg);
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
  // two neighbouring outputs a thread (dh is even), each summed in split
  // order
  const size_t stride = (size_t)Hg * dh;       // a split's acc
  for (int e = 2 * threadIdx.x; e < nh * dh; e += 2 * blockDim.x) {
    const int h = e / dh;
    const float* a = acc + (size_t)h0 * dh + e;
    float2 at = make_float2(0.f, 0.f);
#pragma unroll 16
    for (int s = 0; s < splits; ++s) {
      const float w = w_s[s * nh + h];
      const float2 x = __ldcg(reinterpret_cast<const float2*>(a + s * stride));
      if (w != 0.f) {
        at.x += x.x * w;
        at.y += x.y * w;
      }
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
// order. acc, ml: the pair's first split's partial.
template <typename T>
__device__ __forceinline__ void finish_split(const float* acc,
                                             const float* ml, int Hg, int dh,
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
  merge_heads<T>(acc, ml, Hg, dh, splits, h0, nh, smem, out);
}

// A split block whose split holds none of its row's positions (it lies
// past the row's length): it loads nothing. With one split its output
// rows are 0 (the row has no position: W or S is 0); with more it writes
// its partial's m = -1e30 and l = 0 for its heads [h0, h0 + nh) (ml: its
// own split's) and takes its ticket (`finish_split`: it may be the last,
// and then it merges). acc, ml0: the pair's first split's partial; out:
// the output row of head h0. Contains barriers: call from every thread of
// the block.
template <typename T>
__device__ __forceinline__ void skip_split(const float* acc, const float* ml0,
                                           float* ml, int Hg, int dh,
                                           int splits, int h0, int nh,
                                           int* ticket, float* smem, T* out) {
  if (splits == 1) {
    for (int e = threadIdx.x; e < nh * dh; e += blockDim.x)
      out[e] = from_f<T>(0.f);
    return;
  }
  if (threadIdx.x < nh) {
    ml[h0 + threadIdx.x] = kMask;
    ml[Hg + h0 + threadIdx.x] = 0.f;
  }
  finish_split<T>(acc, ml0, Hg, dh, splits, h0, nh, ticket, smem, out);
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

}  // namespace
