// Flash-decode GQA attention over a contiguous KV cache on Hopper.
//
// Replaces the Pallas kernel
// src/repro/kernels/decode_attention.py::decode_attention
// (pallas_call at :188): one query position per row b against that row's
// cache k/v [B, S, G, dh]. Positions >= kv_len[b] are masked with -1e30;
// online softmax with scale 1/sqrt(dh) (a float from the caller) and
// scores in f32; probabilities are rounded to the value type before the
// PV product (`p.astype(v.dtype)` in the TPU kernel); the output is
// acc / max(l, 1e-30). A ring cache (`ring=True`, sliding window) masks
// min(kv_len, S) positions; over S positions that is the same mask as
// pos < kv_len, so the kernel needs no ring flag: it walks the first
// min(kv_len, S) positions (all S when kv_len <= 0, every position then
// masked: the uniform average, as the plain version gives).
//
// Bound on the H100: each row reads its min(kv_len, S) K and V positions
// once (2*n*G*dh elements) for ~4*H*dh flops per position, far below the
// card's 295 flops per byte in bf16, so it is bound by memory bytes.
// Design: the structure of the paged kernel without the table, with each
// tile of the cache staged in shared memory first. One block per (kv head
// g, row b) keeps the Hg = H/G query heads of its group in shared memory
// (Hg = 7 for qwen2.5-0.5B, 4 for h2o-danube-1.8b, 2 in the reduced
// configs) and walks the cache in tiles of 64 positions: all threads copy
// the tile's K and V to shared memory as f32 (16-byte loads, several in
// flight per thread, so dh must be a multiple of 8; K rows padded to dh + 1 floats so that a column read is free of bank
// conflicts); each thread then computes whole (head, position) scores;
// one warp per head updates the running max and sum; each thread updates
// its (head, dim) accumulators in f32 registers. Four barriers a tile.
// B*G blocks leave most of the 132 SMs idle at small batch, and a tile's
// loads do not overlap the previous tile's arithmetic: splitting the cache
// across blocks and double-buffering the tiles are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                      // positions per tile
constexpr int kMaxOut = 8;                     // outputs per thread: Hg*dh <= 2048

constexpr int kBatch = 4;                      // staging loads per thread

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

// shared memory of a block, in floats (ops.py checks the same formula)
inline size_t decode_smem_floats(int Hg, int dh) {
  return (size_t)Hg * dh + (size_t)kTile * (2 * dh + 1) + (size_t)Hg * kTile +
         3 * (size_t)Hg;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len, int S,
              int H, int G, int dh, float scale, T* __restrict__ out) {
  extern __shared__ float sm[];
  const int Hg = H / G;
  const int kr = dh + 1;            // padded K row
  float* qs = sm;                   // [Hg, dh]
  float* ks = qs + Hg * dh;         // [kTile, dh + 1]
  float* vs = ks + kTile * kr;      // [kTile, dh]
  float* ps = vs + kTile * dh;      // [Hg, kTile] scores, then probabilities
  float* m_s = ps + Hg * kTile;     // [Hg] running max
  float* l_s = m_s + Hg;            // [Hg] running sum
  float* c_s = l_s + Hg;            // [Hg] this tile's correction
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
  const int n = len > 0 ? min(len, S) : S;
  const size_t pos_stride = (size_t)G * dh;
  const T* kb = k + (size_t)b * S * pos_stride + (size_t)g * dh;
  const T* vb = v + (size_t)b * S * pos_stride + (size_t)g * dh;
  constexpr int kVW = 16 / sizeof(T);           // elements per 16-byte load
  const int rv = dh / kVW;                      // loads per cache row
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int nt = min(kTile, n - t0);
    // stage the tile: 16-byte loads, kBatch per thread in flight at once
    const int nvec = nt * rv;
    for (int e0 = tid; e0 < nvec; e0 += blockDim.x * kBatch) {
      uint4 kbuf[kBatch], vbuf[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < nvec) {
          const size_t off = (size_t)(t0 + e / rv) * pos_stride + (e % rv) * kVW;
          kbuf[u] = *reinterpret_cast<const uint4*>(kb + off);
          vbuf[u] = *reinterpret_cast<const uint4*>(vb + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < nvec) {
          const int t = e / rv, c = (e % rv) * kVW;
          unpack<T>(kbuf[u], ks + t * kr + c);
          unpack<T>(vbuf[u], vs + t * dh + c);
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < Hg * nt; e += blockDim.x) {
      const int h = e / nt, t = e % nt;
      const float* qh = qs + h * dh;
      const float* kt = ks + t * kr;
      float s = 0.f;
      for (int i = 0; i < dh; ++i) s = fmaf(qh[i], kt[i], s);
      ps[h * kTile + t] = t0 + t < len ? s * scale : kMask;
    }
    __syncthreads();
    for (int h = warp; h < Hg; h += nw) {
      float* row = ps + h * kTile;
      float mc = kMask;
      for (int t = lane; t < nt; t += 32) mc = fmaxf(mc, row[t]);
      mc = warp_max(mc);
      const float mp = m_s[h];
      const float mn = fmaxf(mp, mc);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(row[t] - mn);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(mp - mn);
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = mn;
        c_s[h] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      const int e = tid + o * blockDim.x;
      if (e < Hg * dh) {
        const int h = e / dh, dd = e % dh;
        const float* prow = ps + h * kTile;
        float pv = 0.f;
        for (int t = 0; t < nt; ++t)
          pv = fmaf(as_v<T>(prow[t]), vs[t * dh + dd], pv);
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
           int B, int S, int H, int G, int dh, float scale, void* out,
           void* stream) {
  const size_t smem = decode_smem_floats(H / G, dh) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_kernel<T><<<dim3(G, B), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len), S, H, G, dh,
      scale, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* kv_len, int B, int S, int H,
                                    int G, int dh, float scale, void* out,
                                    void* stream) {
  return launch<float>(q, k, v, kv_len, B, S, H, G, dh, scale, out, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* kv_len, int B, int S, int H,
                                     int G, int dh, float scale, void* out,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, B, S, H, G, dh, scale, out,
                               stream);
}
