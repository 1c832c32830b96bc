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
// pos < kv_len, so the kernel needs no ring flag: a row walks its first
// n = min(kv_len, S) positions (all S when kv_len <= 0, every position
// then masked: the uniform average, as the plain version gives).
//
// Bound on the H100: each row reads its n K and V positions once
// (2*n*G*dh elements) for ~4*H*dh flops per position, far below the
// card's 295 flops per byte in bf16, so it is bound by memory bytes.
// Design (flash-decoding): the cache is split across blocks, grid (splits,
// G, B), so that a small batch still fills the 132 SMs, four blocks to an
// SM; the wrapper's plan (`ops.decode_split_plan`) picks the splits from
// the host-known shapes, each split at least two tiles. A block keeps the
// Hg = H/G query heads of its kv group in shared memory and walks its
// split's tiles of 64 positions, computed from its row's kv_len on the
// device (no host sync). The tiles arrive by 16-byte cp.async copies into
// a ring of two stages, in the cache's type (rows padded to an odd number
// of 16 bytes, so the row-per-thread score reads are free of bank
// conflicts): tile j + 1 loads while tile j computes, three barriers a
// tile; rows past the split's end are zero-filled. Each thread computes
// whole (head, position) scores, one warp per head updates the running max
// and sum and rounds the probabilities to T, each thread updates its
// (head, dim pair) accumulators in f32 registers over four chains. With
// one split the block writes the output; with more it writes a partial
// (m[Hg], l[Hg], unnormalised acc[Hg, dh]) in f32, and a second small
// launch merges the partials of each (b, g) in split order (deterministic,
// no atomics; a split past the row's n is empty, l = 0, and skipped). A
// split still pays a few microseconds a tile for its serial chain of
// scores, softmax and PV between barriers, so more, shorter splits win
// until the merge grows. Next step: read the tiles with TMA from a
// producer warp, score several tiles between barriers, and fold the merge
// into the last block of each (b, g).
#include "decode_split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                      // positions per tile
constexpr int kMaxPair = 4;                    // output pairs a thread: Hg*dh <= 2048

// Shared memory (its size comes from ops.decode_smem_bytes): the K and V
// rings [2][kTile][dh + kVW] in T, then in f32 the group's queries
// [Hg, dh], the tile's scores [Hg, kTile] and the running max, sum and
// correction [Hg] each.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    int S, int H, int G, int dh, float scale, int splits,
                    T* __restrict__ out, float* __restrict__ part) {
  constexpr int kVW = 16 / sizeof(T);          // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hg = H / G;
  const int kr = dh + kVW;                     // padded cache row
  T* ks = reinterpret_cast<T*>(smem);          // [2][kTile][kr]
  T* vs = ks + 2 * kTile * kr;                 // [2][kTile][kr]
  float* qs = reinterpret_cast<float*>(vs + 2 * kTile * kr);  // [Hg, dh]
  float* ps = qs + Hg * dh;                    // [Hg, kTile]
  float* m_s = ps + Hg * kTile;                // [Hg] running max
  float* l_s = m_s + Hg;                       // [Hg] running sum
  float* c_s = l_s + Hg;                       // [Hg] this tile's correction
  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const size_t qbase = ((size_t)b * H + (size_t)g * Hg) * dh;
  for (int e = tid; e < Hg * dh; e += blockDim.x) qs[e] = to_f<T>(q[qbase + e]);
  if (tid < Hg) { m_s[tid] = kMask; l_s[tid] = 0.f; }
  float2 acc[kMaxPair];                        // (head, dim pair) outputs
#pragma unroll
  for (int o = 0; o < kMaxPair; ++o) acc[o] = make_float2(0.f, 0.f);
  const int npair = Hg * dh / 2;
  // this split's positions [p0, p1): tiles [sp*T/splits, (sp+1)*T/splits)
  // of the T tiles of S (ops.decode_split_ranges), cut at the row's n
  const int len = kv_len[b];
  const int n = len > 0 ? min(len, S) : S;
  const int tiles = (S + kTile - 1) / kTile;
  const int p0 = (int)((long long)sp * tiles / splits) * kTile;
  const int p1 = min(n, (int)((long long)(sp + 1) * tiles / splits) * kTile);
  const int ntl = p1 > p0 ? (p1 - p0 + kTile - 1) / kTile : 0;
  const size_t pos_stride = (size_t)G * dh;
  const T* kb = k + (size_t)b * S * pos_stride + (size_t)g * dh;
  const T* vb = v + (size_t)b * S * pos_stride + (size_t)g * dh;
  const int rv = dh / kVW;                     // 16-byte copies per row
  auto load = [&](int stage, int t0) {        // rows past p1 zero-filled
    T* kd = ks + stage * kTile * kr;
    T* vd = vs + stage * kTile * kr;
    for (int e = tid; e < kTile * rv; e += blockDim.x) {
      const int t = e / rv, c = (e % rv) * kVW;
      const bool in = t0 + t < p1;
      const size_t off = (in ? (size_t)(t0 + t) * pos_stride : 0) + c;
      cp_async16(smem_u32(kd + t * kr + c), kb + off, in);
      cp_async16(smem_u32(vd + t * kr + c), vb + off, in);
    }
  };
  if (ntl > 0) {
    load(0, p0);
    cp_async_commit();
  }
  for (int i = 0; i < ntl; ++i) {
    cp_async_wait<0>();                        // tile i has landed
    __syncthreads();                           // and tile i - 1 is consumed
    if (i + 1 < ntl) {
      load((i + 1) & 1, p0 + (i + 1) * kTile);
      cp_async_commit();
    }
    const int t0 = p0 + i * kTile, nt = min(kTile, p1 - t0);
    const T* kt = ks + (i & 1) * kTile * kr;
    const T* vt = vs + (i & 1) * kTile * kr;
    for (int e = tid; e < Hg * kTile; e += blockDim.x) {
      const int h = e / kTile, t = e % kTile;
      const float* qh = qs + h * dh;
      const T* krow = kt + t * kr;
      float s0 = 0.f, s1 = 0.f;                // even and odd dims
      for (int c = 0; c < dh; c += kVW) {
        float kf[kVW];
        unpack<T>(*reinterpret_cast<const uint4*>(krow + c), kf);
#pragma unroll
        for (int j = 0; j < kVW; j += 2) {
          s0 = fmaf(qh[c + j], kf[j], s0);
          s1 = fmaf(qh[c + j + 1], kf[j + 1], s1);
        }
      }
      ps[e] = t0 + t < len ? (s0 + s1) * scale : kMask;
    }
    __syncthreads();
    // per head: the tile's max, p = exp(s - max) summed unrounded and
    // stored rounded to T (0 past nt), the running max and sum
    for (int h = warp; h < Hg; h += nw) {
      float* row = ps + h * kTile;
      float mc = kMask;
      for (int t = lane; t < nt; t += 32) mc = fmaxf(mc, row[t]);
      mc = warp_max(mc);
      const float mp = m_s[h];
      const float mn = fmaxf(mp, mc);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = t < nt ? expf(row[t] - mn) : 0.f;
        row[t] = as_v<T>(p);
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
    for (int o = 0; o < kMaxPair; ++o) {
      const int u = tid + o * blockDim.x;
      if (u < npair) {
        const int h = 2 * u / dh, dd = 2 * u % dh;
        const float* prow = ps + h * kTile;
        const T* vcol = vt + dd;
        float2 a[4];                           // four chains over positions
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = make_float2(0.f, 0.f);
#pragma unroll 4
        for (int t = 0; t < kTile; t += 4) {
          const float4 p = *reinterpret_cast<const float4*>(prow + t);
          const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 vv = load2<T>(vcol + (t + j) * kr);
            a[j].x = fmaf(pj[j], vv.x, a[j].x);
            a[j].y = fmaf(pj[j], vv.y, a[j].y);
          }
        }
        const float c = c_s[h];
        acc[o].x = acc[o].x * c + ((a[0].x + a[1].x) + (a[2].x + a[3].x));
        acc[o].y = acc[o].y * c + ((a[0].y + a[1].y) + (a[2].y + a[3].y));
      }
    }
  }
  __syncthreads();                             // m_s, l_s final
  if (splits == 1) {
#pragma unroll
    for (int o = 0; o < kMaxPair; ++o) {
      const int u = tid + o * blockDim.x;
      if (u < npair) {
        const float den = fmaxf(l_s[2 * u / dh], 1e-30f);
        out[qbase + 2 * u] = from_f<T>(acc[o].x / den);
        out[qbase + 2 * u + 1] = from_f<T>(acc[o].y / den);
      }
    }
    return;
  }
  // partial of (b, g, sp): acc [Hg, dh], then m [Hg], then l [Hg]
  float* pb = part + (((size_t)b * G + g) * splits + sp) * Hg * (dh + 2);
#pragma unroll
  for (int o = 0; o < kMaxPair; ++o) {
    const int u = tid + o * blockDim.x;
    if (u < npair) *reinterpret_cast<float2*>(pb + 2 * u) = acc[o];
  }
  if (tid < Hg) {
    pb[Hg * dh + tid] = m_s[tid];
    pb[Hg * dh + Hg + tid] = l_s[tid];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           int B, int S, int H, int G, int dh, float scale, int splits,
           int smem, void* part, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_split_kernel<T><<<dim3(splits, G, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len), S, H, G, dh,
      scale, splits, static_cast<T*>(out), static_cast<float*>(part));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return static_cast<int>(launch_merge<T>(part, B, H, G, dh, splits, out, st));
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* kv_len, int B, int S, int H,
                                    int G, int dh, float scale, int splits,
                                    int smem, void* part, void* out,
                                    void* stream) {
  return launch<float>(q, k, v, kv_len, B, S, H, G, dh, scale, splits, smem,
                       part, out, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* kv_len, int B, int S, int H,
                                     int G, int dh, float scale, int splits,
                                     int smem, void* part, void* out,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, B, S, H, G, dh, scale, splits,
                               smem, part, out, stream);
}
