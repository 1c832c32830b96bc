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
//
// Wide groups (recurrentgemma: one kv head under 16 query heads at dh
// 256, Hg*dh 4096): each thread holds kWidePair (8) output pairs instead
// of kMaxPair (4), the block still 256 threads, so a block's 16 x 64
// scores and its 2,048 output pairs both fit one pass. In f32 at dh 256
// two stages of K and V rows (266,240 bytes) pass the 227 KB a block may
// take, so that shape runs one stage: the next tile loads after the
// current one's PV product, behind one more barrier (ops.decode_stages
// picks the stages from the shared memory they need).
//
// The int8 cache (`decode_attention_q8`, the plain jnp function
// src/repro/models/layers.py::decode_attention_q8 at :227, which the
// port runs on the card): the same kernel with int8 K/V rows (16 a
// 16-byte copy) and f32 scales k_scale, v_scale [B, S, G], one a position
// and kv head. The scales commute through the products, so the kernel
// reads int8 bytes and never writes a dequantized copy: a score is
// (q . kq) * scale * k_scale, and a probability enters the PV product as
// exp(s - max) * v_scale rounded to q's type (the reference's
// `p * vs` cast to q's dtype), while the running sum takes the unscaled
// probability. A tile's scales are loaded beside its rows into
// [2][kTile] f32 rings (0 past the split's end). Bound: bytes, now
// dh + 8 a position and kv head for K and V together with their scales.
#include "decode_split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                      // positions per tile
constexpr int kMaxPair = 4;                    // output pairs a thread: Hg*dh <= 2048
constexpr int kWidePair = 8;                   // Hg*dh <= 4096 (recurrentgemma)

// Shared memory (its size comes from ops.decode_smem_bytes): the K and V
// rings [kStages][kTile][dh + kVW] in C, then in f32 the group's queries
// [Hg, dh], the tile's scores [Hg, kTile], the running max, sum and
// correction [Hg] each, and with an int8 cache the K and V scale rings
// [2][kTile] each. T: the type of q and out; C: the cache's (T or int8).
// kPairs: output pairs a thread (kMaxPair, or kWidePair past Hg*dh
// 2048). kStages: 2 (tile j + 1 loads while tile j computes), or 1 where
// two stages do not fit 227 KB (f32 at dh 256: the tile loads after the
// previous one is consumed, one more barrier a tile).
template <typename T, typename C, int kPairs, int kStages>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ kv_len, int S, int H, int G,
                    int dh, float scale, int splits, T* __restrict__ out,
                    float* __restrict__ part) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  constexpr int kVW = 16 / sizeof(C);          // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hg = H / G;
  const int kr = dh + kVW;                     // padded cache row
  C* ks = reinterpret_cast<C*>(smem);          // [kStages][kTile][kr]
  C* vs = ks + kStages * kTile * kr;           // [kStages][kTile][kr]
  float* qs = reinterpret_cast<float*>(vs + kStages * kTile * kr);  // [Hg, dh]
  float* ps = qs + Hg * dh;                    // [Hg, kTile]
  float* m_s = ps + Hg * kTile;                // [Hg] running max
  float* l_s = m_s + Hg;                       // [Hg] running sum
  float* c_s = l_s + Hg;                       // [Hg] this tile's correction
  float* ksc = c_s + Hg;                       // [2][kTile] K scales (int8)
  float* vsc = ksc + 2 * kTile;                // [2][kTile] V scales (int8)
  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const size_t qbase = ((size_t)b * H + (size_t)g * Hg) * dh;
  for (int e = tid; e < Hg * dh; e += blockDim.x) qs[e] = to_f<T>(q[qbase + e]);
  if (tid < Hg) { m_s[tid] = kMask; l_s[tid] = 0.f; }
  float2 acc[kPairs];                          // (head, dim pair) outputs
#pragma unroll
  for (int o = 0; o < kPairs; ++o) acc[o] = make_float2(0.f, 0.f);
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
  const C* kb = k + (size_t)b * S * pos_stride + (size_t)g * dh;
  const C* vb = v + (size_t)b * S * pos_stride + (size_t)g * dh;
  const int rv = dh / kVW;                     // 16-byte copies per row
  auto load = [&](int stage, int t0) {        // rows past p1 zero-filled
    stage %= kStages;
    C* kd = ks + stage * kTile * kr;
    C* vd = vs + stage * kTile * kr;
    for (int e = tid; e < kTile * rv; e += blockDim.x) {
      const int t = e / rv, c = (e % rv) * kVW;
      const bool in = t0 + t < p1;
      const size_t off = (in ? (size_t)(t0 + t) * pos_stride : 0) + c;
      cp_async16(smem_u32(kd + t * kr + c), kb + off, in);
      cp_async16(smem_u32(vd + t * kr + c), vb + off, in);
    }
    if constexpr (kQ8) {                      // the tile's scales, 0 past p1
      for (int t = tid; t < kTile; t += blockDim.x) {
        const bool in = t0 + t < p1;
        const size_t o = ((size_t)b * S + (in ? t0 + t : 0)) * G + g;
        ksc[stage * kTile + t] = in ? k_scale[o] : 0.f;
        vsc[stage * kTile + t] = in ? v_scale[o] : 0.f;
      }
    }
  };
  if (ntl > 0) {
    load(0, p0);
    cp_async_commit();
  }
  for (int i = 0; i < ntl; ++i) {
    cp_async_wait<0>();                        // tile i has landed
    __syncthreads();                           // and tile i - 1 is consumed
    if (kStages > 1 && i + 1 < ntl) {
      load((i + 1) & 1, p0 + (i + 1) * kTile);
      cp_async_commit();
    }
    const int t0 = p0 + i * kTile, nt = min(kTile, p1 - t0);
    const C* kt = ks + (i % kStages) * kTile * kr;
    const C* vt = vs + (i % kStages) * kTile * kr;
    const float* kst = ksc + (i % kStages) * kTile;
    const float* vst = vsc + (i % kStages) * kTile;
    for (int e = tid; e < Hg * kTile; e += blockDim.x) {
      const int h = e / kTile, t = e % kTile;
      const float* qh = qs + h * dh;
      const C* krow = kt + t * kr;
      float s0 = 0.f, s1 = 0.f;                // even and odd dims
      for (int c = 0; c < dh; c += kVW) {
        float kf[kVW];
        unpack<C>(*reinterpret_cast<const uint4*>(krow + c), kf);
#pragma unroll
        for (int j = 0; j < kVW; j += 2) {
          s0 = fmaf(qh[c + j], kf[j], s0);
          s1 = fmaf(qh[c + j + 1], kf[j + 1], s1);
        }
      }
      float sc = (s0 + s1) * scale;
      if constexpr (kQ8) sc *= kst[t];
      ps[e] = t0 + t < len ? sc : kMask;
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
        if constexpr (kQ8) row[t] = as_v<T>(p * vst[t]);
        else row[t] = as_v<T>(p);
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
    for (int o = 0; o < kPairs; ++o) {
      const int u = tid + o * blockDim.x;
      if (u < npair) {
        const int h = 2 * u / dh, dd = 2 * u % dh;
        const float* prow = ps + h * kTile;
        const C* vcol = vt + dd;
        float2 a[4];                           // four chains over positions
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = make_float2(0.f, 0.f);
#pragma unroll 4
        for (int t = 0; t < kTile; t += 4) {
          const float4 p = *reinterpret_cast<const float4*>(prow + t);
          const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 vv = load2<C>(vcol + (t + j) * kr);
            a[j].x = fmaf(pj[j], vv.x, a[j].x);
            a[j].y = fmaf(pj[j], vv.y, a[j].y);
          }
        }
        const float c = c_s[h];
        acc[o].x = acc[o].x * c + ((a[0].x + a[1].x) + (a[2].x + a[3].x));
        acc[o].y = acc[o].y * c + ((a[0].y + a[1].y) + (a[2].y + a[3].y));
      }
    }
    if (kStages == 1 && i + 1 < ntl) {
      __syncthreads();                         // tile i is consumed
      load(0, p0 + (i + 1) * kTile);
      cp_async_commit();
    }
  }
  __syncthreads();                             // m_s, l_s final
  if (splits == 1) {
#pragma unroll
    for (int o = 0; o < kPairs; ++o) {
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
  for (int o = 0; o < kPairs; ++o) {
    const int u = tid + o * blockDim.x;
    if (u < npair) *reinterpret_cast<float2*>(pb + 2 * u) = acc[o];
  }
  if (tid < Hg) {
    pb[Hg * dh + tid] = m_s[tid];
    pb[Hg * dh + Hg + tid] = l_s[tid];
  }
}

template <typename T, typename C, int kPairs, int kStages>
cudaError_t launch_split(const void* q, const void* k, const void* k_scale,
                         const void* v, const void* v_scale,
                         const void* kv_len, int B, int S, int H, int G,
                         int dh, float scale, int splits, int smem,
                         void* part, void* out, cudaStream_t st) {
  auto kernel = decode_split_kernel<T, C, kPairs, kStages>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(splits, G, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(kv_len), S,
      H, G, dh, scale, splits, static_cast<T*>(out),
      static_cast<float*>(part));
  return cudaGetLastError();
}

// k_scale and v_scale: null for a float cache (C = T). `stages` (1 or 2)
// comes with `smem` from ops.decode_smem_bytes; wide groups (Hg*dh past
// 2 * kMaxPair * kThreads) take kWidePair pairs a thread
template <typename T, typename C>
int launch(const void* q, const void* k, const void* k_scale, const void* v,
           const void* v_scale, const void* kv_len, int B, int S, int H, int G,
           int dh, float scale, int splits, int stages, int smem, void* part,
           void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int npair = H / G * dh / 2;
  if (npair > kWidePair * kThreads || stages < 1 || stages > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = npair > kMaxPair * kThreads;
  cudaError_t e;
  if (stages == 2)
    e = wide ? launch_split<T, C, kWidePair, 2>(q, k, k_scale, v, v_scale,
                                                kv_len, B, S, H, G, dh, scale,
                                                splits, smem, part, out, st)
             : launch_split<T, C, kMaxPair, 2>(q, k, k_scale, v, v_scale,
                                               kv_len, B, S, H, G, dh, scale,
                                               splits, smem, part, out, st);
  else
    e = wide ? launch_split<T, C, kWidePair, 1>(q, k, k_scale, v, v_scale,
                                                kv_len, B, S, H, G, dh, scale,
                                                splits, smem, part, out, st)
             : launch_split<T, C, kMaxPair, 1>(q, k, k_scale, v, v_scale,
                                               kv_len, B, S, H, G, dh, scale,
                                               splits, smem, part, out, st);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return static_cast<int>(launch_merge<T>(part, B, H, G, dh, splits, out, st));
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* kv_len, int B, int S, int H,
                                    int G, int dh, float scale, int splits,
                                    int stages, int smem, void* part,
                                    void* out, void* stream) {
  return launch<float, float>(q, k, nullptr, v, nullptr, kv_len, B, S, H, G,
                              dh, scale, splits, stages, smem, part, out,
                              stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* kv_len, int B, int S, int H,
                                     int G, int dh, float scale, int splits,
                                     int stages, int smem, void* part,
                                     void* out, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(q, k, nullptr, v, nullptr,
                                              kv_len, B, S, H, G, dh, scale,
                                              splits, stages, smem, part, out,
                                              stream);
}

// int8 cache: k, v [B, S, G, dh] int8; k_scale, v_scale [B, S, G] f32
extern "C" int decode_attention_q8_f32(const void* q, const void* k,
                                       const void* k_scale, const void* v,
                                       const void* v_scale, const void* kv_len,
                                       int B, int S, int H, int G, int dh,
                                       float scale, int splits, int stages,
                                       int smem, void* part, void* out,
                                       void* stream) {
  return launch<float, int8_t>(q, k, k_scale, v, v_scale, kv_len, B, S, H, G,
                               dh, scale, splits, stages, smem, part, out,
                               stream);
}

extern "C" int decode_attention_q8_bf16(const void* q, const void* k,
                                        const void* k_scale, const void* v,
                                        const void* v_scale, const void* kv_len,
                                        int B, int S, int H, int G, int dh,
                                        float scale, int splits, int stages,
                                        int smem, void* part, void* out,
                                        void* stream) {
  return launch<__nv_bfloat16, int8_t>(q, k, k_scale, v, v_scale, kv_len, B,
                                       S, H, G, dh, scale, splits, stages,
                                       smem, part, out, stream);
}
