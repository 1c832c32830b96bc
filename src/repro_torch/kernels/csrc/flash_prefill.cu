// Causal / sliding-window flash attention for prefill on Hopper.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_prefill.py::flash_prefill (pallas_call at :95),
// in the model's layout and with the two arguments the chunked prefill
// needs: q [B, Sq, H, dh], k/v [B, Sk, G, dh] with H % G == 0 (query head
// h reads kv head h / (H/G) directly; the TPU wrapper expanded KV to H
// heads first), query i at absolute position q_offset + i, keys at
// positions >= kv_len masked. A key is masked with -1e30 when it is past
// the query (causal) or `window` or more positions behind it. Online
// softmax with scale 1/sqrt(dh) (a float from the caller), scores in f32,
// probabilities rounded to v's type before the PV product (the TPU
// kernel's `p.astype(v.dtype)`), output acc / max(l, 1e-30).
//
// Bound on the H100: per (query, unmasked key) pair 4*dh flops against
// q, k, v and out each moved once, so at prefill lengths (hundreds to
// thousands of keys per query) it is bound by operations: the bf16
// tensor-core rate for bf16 inputs, the f32 rate for f32.
// Design (simple first; it runs on the CUDA cores in f32, not the tensor
// cores, so it stays far from that bound): one block per (query tile of
// 32 rows, head, batch) takes the place of the TPU's sequential third
// grid axis with a loop over key tiles of 32 inside the block. Each query
// row is held by 4 threads, each owning dh/4 of its columns of q and of
// the f32 accumulator in registers; a score is their partial dot products
// summed with two shuffles. Key and value tiles are staged in shared
// memory as f32. The loop covers only the key tiles that the causal band,
// the window and kv_len leave partly unmasked, in absolute positions, so
// masked tiles cost nothing; the ragged edges of Sq and Sk are masked,
// not padded. dh is a template parameter (32, 64, 80 or 128).
#include "common.cuh"

namespace {

constexpr int kBQ = 32;                        // query rows per block
constexpr int kTPR = 4;                        // threads per query row
constexpr int kTK = 32;                        // keys per tile
constexpr int kThreads = kBQ * kTPR;

template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <typename T> __device__ __forceinline__ void store4(T* p, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(
    __nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, int Sq, int Sk, int H, int G,
                     int causal, int window, int q_offset, int kv_len,
                     float scale, T* __restrict__ out) {
  constexpr int RW = DH / 4;                   // float4 per key row
  constexpr int NV = RW / kTPR;                // float4 per thread
  static_assert(RW % kTPR == 0, "dh must be a multiple of 16");
  __shared__ float4 ks[kTK * RW];
  __shared__ float4 vs[kTK * RW];
  const int tid = threadIdx.x, r = tid / kTPR, t = tid % kTPR;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int row = q0 + r;
  const bool live = row < Sq;
  const int qpos = q_offset + row;
  const size_t qoff = (((size_t)b * Sq + (live ? row : 0)) * H + h) * DH;
  float4 qr[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    qr[i] = load4<T>(q + qoff + (i * kTPR + t) * 4);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kMask, l = 0.f;
  // key tiles this block needs: [kbeg, kend) in absolute positions
  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + kBQ, Sq) - 1;
  const int kend = causal ? min(kv_len, qhi + 1) : kv_len;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) / kTK * kTK : 0;
  const size_t krow = (size_t)G * DH;
  const T* kbase = k + (size_t)b * Sk * krow + (size_t)g * DH;
  const T* vbase = v + (size_t)b * Sk * krow + (size_t)g * DH;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = kbeg; k0 < kend; k0 += kTK) {
    __syncthreads();                           // the previous tile is consumed
    for (int e = tid; e < kTK * RW; e += kThreads) {
      const int j = e / RW, c = (e % RW) * 4;
      const bool in = k0 + j < kend;
      ks[e] = in ? load4<T>(kbase + (size_t)(k0 + j) * krow + c) : zero;
      vs[e] = in ? load4<T>(vbase + (size_t)(k0 + j) * krow + c) : zero;
    }
    __syncthreads();
    float s[kTK];
    float mt = kMask;
#pragma unroll
    for (int j = 0; j < kTK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = ks[j * RW + i * kTPR + t];
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
      // the 4 threads of a row end with bit-identical sums
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      const bool ok = kp < kv_len && (!causal || kp <= qpos) &&
                      (window <= 0 || qpos - kp < window);
      s[j] = ok ? part * scale : kMask;
      mt = fmaxf(mt, s[j]);
    }
    const float mn = fmaxf(m, mt);
    const float corr = expf(m - mn);
    l *= corr;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < kTK; ++j) {
      const float p = expf(s[j] - mn);
      l += p;
      const float pr = as_v<T>(p);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = vs[j * RW + i * kTPR + t];
        acc[i].x = fmaf(pr, vv.x, acc[i].x);
        acc[i].y = fmaf(pr, vv.y, acc[i].y);
        acc[i].z = fmaf(pr, vv.z, acc[i].z);
        acc[i].w = fmaf(pr, vv.w, acc[i].w);
      }
    }
    m = mn;
  }
  if (live) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      store4<T>(out + qoff + (i * kTPR + t) * 4,
                make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                            acc[i].w / den));
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, int B, int Sq,
              int Sk, int H, int G, int causal, int window, int q_offset,
              int kv_len, float scale, void* out, void* stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel<T, DH><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), Sq, Sk, H, G, causal, window, q_offset, kv_len,
      scale, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, int B, int Sq, int Sk,
           int H, int G, int dh, int causal, int window, int q_offset,
           int kv_len, float scale, void* out, void* stream) {
  switch (dh) {
    case 32:
      return launch_dh<T, 32>(q, k, v, B, Sq, Sk, H, G, causal, window,
                              q_offset, kv_len, scale, out, stream);
    case 64:
      return launch_dh<T, 64>(q, k, v, B, Sq, Sk, H, G, causal, window,
                              q_offset, kv_len, scale, out, stream);
    case 80:
      return launch_dh<T, 80>(q, k, v, B, Sq, Sk, H, G, causal, window,
                              q_offset, kv_len, scale, out, stream);
    case 128:
      return launch_dh<T, 128>(q, k, v, B, Sq, Sk, H, G, causal, window,
                               q_offset, kv_len, scale, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 int B, int Sq, int Sk, int H, int G, int dh,
                                 int causal, int window, int q_offset,
                                 int kv_len, float scale, void* out,
                                 void* stream) {
  return launch<float>(q, k, v, B, Sq, Sk, H, G, dh, causal, window, q_offset,
                       kv_len, scale, out, stream);
}

extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  int B, int Sq, int Sk, int H, int G, int dh,
                                  int causal, int window, int q_offset,
                                  int kv_len, float scale, void* out,
                                  void* stream) {
  return launch<__nv_bfloat16>(q, k, v, B, Sq, Sk, H, G, dh, causal, window,
                               q_offset, kv_len, scale, out, stream);
}
