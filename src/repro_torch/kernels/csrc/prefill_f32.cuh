// flash_prefill's f32 route on the CUDA cores, the 1e-5 check (tensor
// cores would take f32 as TF32), shared by csrc/flash_prefill.cu (keys in
// a contiguous buffer) and csrc/flash_prefill_paged.cu (a chunk's history
// read through a page table, then the chunk's own keys): one body, so
// that the paged call sums in the same order, bit for bit, as the
// contiguous call on the gathered buffer.
//
// One block per (query tile of 32 rows, head, batch) with a loop over key
// tiles of 32; each query row is held by 4 threads, each owning dh/4 of
// its columns of q and of the f32 accumulator in registers, a score being
// their partial dot products summed with two shuffles; key and value
// tiles are staged in shared memory as f32. At dh 256 a row is held by 8
// threads and a key tile is 16 keys (`F32Tile`).
//
// `Src` says where the keys lie: `load(b, g, j, c, k, v)` sets k and v to
// columns [c, c + 4) of key j of kv head g in batch row b, as f32.
#pragma once
#include "common.cuh"
#include "prefill_keys.cuh"

namespace {

constexpr int kBQ = 32;                        // query rows per block
constexpr int kTPR = 4;                        // threads per query row
constexpr int kTK = 32;                        // keys per tile

// the tile at a head dim: dh 256 holds a row over 8 threads (q and the
// accumulator in 64 registers a thread) and takes key tiles of 16, so
// that the K and V tiles (32 KB) stay within 48 KB of static shared
// memory
template <int DH> struct F32Tile {
  static constexpr int TPR = DH > 128 ? 2 * kTPR : kTPR;
  static constexpr int TK = DH > 128 ? kTK / 2 : kTK;
  static constexpr int THREADS = kBQ * TPR;
};

template <int DH, typename Src>
__global__ void __launch_bounds__(F32Tile<DH>::THREADS)
flash_prefill_f32_kernel(const float* __restrict__ q, Src src, int Sq,
                         int Sk, int H, int G, int causal, int window,
                         int q_offset, int kv_len, float scale,
                         float* __restrict__ out) {
  constexpr int TPR = F32Tile<DH>::TPR, TK = F32Tile<DH>::TK;
  constexpr int THREADS = F32Tile<DH>::THREADS;
  constexpr int RW = DH / 4;                   // float4 per key row
  constexpr int NV = RW / TPR;                 // float4 per thread
  static_assert(RW % TPR == 0, "dh must be a multiple of 4 * TPR");
  __shared__ float4 ks[TK * RW];
  __shared__ float4 vs[TK * RW];
  const int tid = threadIdx.x, r = tid / TPR, t = tid % TPR;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int row = q0 + r;
  const bool live = row < Sq;
  const int qpos = q_offset + row;
  const size_t qoff = (((size_t)b * Sq + (live ? row : 0)) * H + h) * DH;
  float4 qr[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    qr[i] = *reinterpret_cast<const float4*>(q + qoff + (i * TPR + t) * 4);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kMask, l = 0.f;
  int kbeg, kend;
  key_range(q_offset + q0, q_offset + min(q0 + kBQ, Sq) - 1, Sk, causal,
            window, kv_len, TK, kbeg, kend);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    __syncthreads();                           // the previous tile is consumed
    for (int e = tid; e < TK * RW; e += THREADS) {
      const int j = e / RW, c = (e % RW) * 4;
      if (k0 + j < kend) {
        src.load(b, g, k0 + j, c, ks[e], vs[e]);
      } else {
        ks[e] = zero;
        vs[e] = zero;
      }
    }
    __syncthreads();
    float s[TK];
    float mt = kMask;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = ks[j * RW + i * TPR + t];
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
      // the TPR threads of a row end with bit-identical sums
#pragma unroll
      for (int w = 1; w < TPR; w *= 2)
        part += __shfl_xor_sync(0xffffffffu, part, w);
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
    for (int j = 0; j < TK; ++j) {
      const float p = k0 + j < Sk ? expf(s[j] - mn) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = vs[j * RW + i * TPR + t];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    m = mn;
  }
  if (live) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      *reinterpret_cast<float4*>(out + qoff + (i * TPR + t) * 4) =
          make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                      acc[i].w / den);
  }
}

// The launch of the f32 kernel over `src` for a runtime dh (32, 64, 80,
// 128 or 256): grid (ceil(Sq / 32), H, B).
template <typename Src>
int launch_f32(const float* q, const Src& src, int B, int Sq, int Sk, int H,
               int G, int dh, int causal, int window, int q_offset,
               int kv_len, float scale, float* out, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  switch (dh) {
#define FLASH_F32(D)                                                         \
  case D:                                                                    \
    flash_prefill_f32_kernel<D, Src><<<grid, F32Tile<D>::THREADS, 0,         \
                                       stream>>>(q, src, Sq, Sk, H, G,       \
                                                 causal, window, q_offset,   \
                                                 kv_len, scale, out);        \
    return static_cast<int>(cudaGetLastError());
    FLASH_F32(32) FLASH_F32(64) FLASH_F32(80) FLASH_F32(128) FLASH_F32(256)
#undef FLASH_F32
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
