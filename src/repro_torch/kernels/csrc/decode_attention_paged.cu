// Block-table flash-decode GQA attention on Hopper.
//
// Replaces the Pallas kernel
// src/repro/kernels/decode_attention.py::decode_attention_paged
// (pallas_call at :135): one query position per row b against K/V that
// live in a page pool [P, ps, G, dh] and are read through the row's page
// table [W]. Positions >= kv_len[b] are masked with -1e30; online softmax
// with scale 1/sqrt(dh) and scores in f32; probabilities are rounded to
// the value type before the PV product (as `p.astype(v.dtype)` does in
// the TPU kernel); the output is acc / max(l, 1e-30).
//
// Bound on the H100: each row reads its kv_len K and V positions once
// (2*kv_len*G*dh elements) for ~4*H*dh flops per position, so it is bound
// by memory bytes. Design: one block per (kv head g, row b) holds the
// Hg = H/G query heads of its group in shared memory (Hg = 7 at
// qwen2.5-0.5B's width, 2 in the reduced test config: any Hg <= 16) and
// walks only the pages that hold positions < kv_len. Per page, warps take
// positions and compute the Hg scores with one warp sum each; Hg threads
// update the running max/sum; then each thread updates its (head, dim)
// accumulators in f32 registers. The table entries are read by the block
// itself (the TPU kernel scalar-prefetched them).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHg = 16;                     // query heads per kv head
constexpr int kMaxOut = 8;                     // outputs per thread: Hg*dh <= 1024

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ kv_len,
                    const int* __restrict__ table, int H, int G, int dh, int ps,
                    int W, float scale, T* __restrict__ out) {
  extern __shared__ float sm[];
  const int Hg = H / G;
  float* qs = sm;                   // [Hg, dh]
  float* ss = qs + Hg * dh;         // [Hg, ps] scores, then probabilities
  float* m_s = ss + Hg * ps;        // [Hg] running max
  float* l_s = m_s + Hg;            // [Hg] running sum
  float* c_s = l_s + Hg;            // [Hg] this page's correction
  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const size_t qbase = ((size_t)b * H + (size_t)g * Hg) * dh;
  for (int e = tid; e < Hg * dh; e += blockDim.x) qs[e] = to_f<T>(q[qbase + e]);
  if (tid < Hg) { m_s[tid] = kMask; l_s[tid] = 0.f; }
  float acc[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) acc[o] = 0.f;
  const int len = kv_len[b];
  // pages past kv_len add exact zeros once one position is valid; with
  // kv_len <= 0 every position is masked and all W pages count (uniform)
  const int npg = len > 0 ? min(W, (len + ps - 1) / ps) : W;
  const size_t pos_stride = (size_t)G * dh;
  __syncthreads();
  for (int w = 0; w < npg; ++w) {
    const size_t page = static_cast<size_t>(table[b * W + w]);
    const T* kb = kp + page * ps * pos_stride + (size_t)g * dh;
    const T* vb = vp + page * ps * pos_stride + (size_t)g * dh;
    for (int t = warp; t < ps; t += nw) {
      const T* kr = kb + t * pos_stride;
      float part[kMaxHg];
#pragma unroll
      for (int h = 0; h < kMaxHg; ++h) part[h] = 0.f;
      for (int i = lane; i < dh; i += 32) {
        const float kv = to_f<T>(kr[i]);
#pragma unroll
        for (int h = 0; h < kMaxHg; ++h)
          if (h < Hg) part[h] = fmaf(qs[h * dh + i], kv, part[h]);
      }
      const bool valid = w * ps + t < len;
#pragma unroll
      for (int h = 0; h < kMaxHg; ++h) {
        if (h < Hg) {
          const float s = warp_sum(part[h]);
          if (lane == 0) ss[h * ps + t] = valid ? s * scale : kMask;
        }
      }
    }
    __syncthreads();
    if (tid < Hg) {
      float* row = ss + tid * ps;
      float mc = kMask;
      for (int t = 0; t < ps; ++t) mc = fmaxf(mc, row[t]);
      const float mp = m_s[tid];
      const float mn = fmaxf(mp, mc);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(row[t] - mn);
        row[t] = p;
        sum += p;
      }
      const float corr = expf(mp - mn);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = mn;
      c_s[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      const int e = tid + o * blockDim.x;
      if (e < Hg * dh) {
        const int h = e / dh, dd = e % dh;
        const float* prow = ss + h * ps;
        float pv = 0.f;
        for (int t = 0; t < ps; ++t)
          pv = fmaf(as_v<T>(prow[t]), to_f<T>(vb[t * pos_stride + dd]), pv);
        acc[o] = acc[o] * c_s[h] + pv;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    const int e = tid + o * blockDim.x;
    if (e < Hg * dh) {
      const int h = e / dh;
      out[qbase + e] = from_f<T>(acc[o] / fmaxf(l_s[h], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           const void* table, int B, int H, int G, int dh, int ps, int W,
           void* out, void* stream) {
  const int Hg = H / G;
  const size_t smem = (size_t)(Hg * dh + Hg * ps + 3 * Hg) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_paged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  decode_paged_kernel<T><<<dim3(G, B), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<const int*>(table), H, G, dh, ps, W, scale,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_paged_f32(const void* q, const void* k,
                                          const void* v, const void* kv_len,
                                          const void* table, int B, int H, int G,
                                          int dh, int ps, int W, void* out,
                                          void* stream) {
  return launch<float>(q, k, v, kv_len, table, B, H, G, dh, ps, W, out, stream);
}

extern "C" int decode_attention_paged_bf16(const void* q, const void* k,
                                           const void* v, const void* kv_len,
                                           const void* table, int B, int H, int G,
                                           int dh, int ps, int W, void* out,
                                           void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, table, B, H, G, dh, ps, W, out,
                               stream);
}
