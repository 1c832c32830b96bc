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
//
// Design (flash-decoding): the cache is split across blocks, grid
// (splits, G * head_groups, B), so that a small batch still fills the 132
// SMs. The wrapper's plan (`ops.decode_split_plan`, host-known shapes
// only) takes splits of at least two tiles of 64 positions (none where
// that would give two or fewer: the merge costs about three tiles of
// time), and where the blocks still leave SMs idle it splits each
// group's Hg = H/G query heads into head_groups blocks of ceil(Hg /
// head_groups) heads (those blocks read the same K/V tile, the later
// ones from L2, and need no merge). A block walks its split's
// tiles, computed from its row's kv_len on the device (no host sync); the
// tiles arrive by 16-byte cp.async copies into a ring of two stages, in
// the cache's type (rows padded by 16 bytes, so that row reads are free
// of bank conflicts): tile j + 1 loads while tile j computes; rows past
// the split's end are zero-filled. With one split the block writes the
// output; with more it writes a partial (m, l, unnormalised acc) in f32,
// takes a ticket of its (b, g, head group), and the last of its splits
// merges the partials in split order (`finish_split`, decode_split.cuh:
// deterministic, one launch a call; a split past the row's n is empty,
// l = 0, and skipped). The ticket counters are zero before a launch and
// the last block resets its own (`ops.tickets`, one buffer a stream).
//
// Two routes (`route`, chosen by the wrapper, `ops.decode_route`):
//
// Tensor cores (`tc`, bf16 cache, dh a multiple of 16 up to 256): the
// block's heads, zero-padded to 16, are the M rows of
// `mma.sync.m16n8k16` bf16 -> f32 (mma.cuh). Four warps; per tile each
// warp computes S = Q K^T for 16 positions (Q's fragments by `ldmatrix`,
// held in registers up to dh 128; K's rows by `ldmatrix` as the col-major
// B operand) and writes the scaled, masked scores to shared memory; one
// warp per head updates the running max and sum in f32 and stores the
// probabilities rounded to bf16 (the reference's `p.astype(v.dtype)`,
// and the MMA's A operand); then the warps split O's columns in 16-column
// pairs (at dh 256 four pairs a warp, 32 f32 accumulators a thread) and
// add P V with V by `ldmatrix.trans`. A tile is 256 MMAs at dh 256
// where the CUDA-core route spent 16 x 64 scalar dot products of 256.
//
// CUDA cores (`cuda`: f32, the 1e-5 check; the int8 cache; dh outside the
// tensor-core list): each thread computes whole (head, position) scores
// from q in shared memory as f32, one warp per head updates the running
// max and sum and rounds the probabilities to T, each thread updates its
// (head, dim pair) accumulators in f32 registers over four chains, three
// barriers a tile. Wide groups (recurrentgemma: one kv head under 16
// query heads at dh 256, Hg*dh 4096): each thread holds kWidePair (8)
// output pairs instead of kMaxPair (4). In f32 at dh 256 two stages of K
// and V rows (266,240 bytes) pass the 227 KB a block may take, so that
// shape runs one stage: the next tile loads after the current one's PV
// product, behind one more barrier (ops.decode_stages picks the stages
// from the shared memory they need).
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
// probability. A tile's scales arrive by 4-byte cp.async copies beside
// its rows, into [2][kTile] f32 rings (0 past the split's end). Bound: bytes, now
// dh + 8 a position and kv head for K and V together with their scales.
#include "decode_split.cuh"
#include "mma.cuh"

namespace {

constexpr int kTile = 64;                      // positions per tile

// ---------------------------------------------------------- CUDA cores

constexpr int kThreads = 256;
constexpr int kMaxPair = 4;                    // output pairs a thread: Hb*dh <= 2048
constexpr int kWidePair = 8;                   // Hb*dh <= 4096 (recurrentgemma)

// Shared memory (its size comes from ops.decode_smem_bytes at the
// block's Hb = ceil(Hg / head_groups) heads): the K and V rings
// [kStages][kTile][dh + kVW] in C, then in f32 the block's queries
// [Hb, dh], the tile's scores [Hb, kTile], the running max, sum and
// correction [Hb] each, and with an int8 cache the K and V scale rings
// [2][kTile] each; the merge reuses it from the start (ops sizes it for
// both). T: the type of q and out; C: the cache's (T or int8). kPairs:
// output pairs a thread (kMaxPair, or kWidePair past Hb*dh 2048).
// kStages: 2 (tile j + 1 loads while tile j computes), or 1 where two
// stages do not fit 227 KB (f32 at dh 256: the tile loads after the
// previous one is consumed, one more barrier a tile).
template <typename T, typename C, int kPairs, int kStages>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ kv_len, int S, int H, int G,
                    int dh, float scale, int splits, int hgroups,
                    T* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ tickets) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  constexpr int kVW = 16 / sizeof(C);          // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = blockIdx.x, b = blockIdx.z;
  const int g = blockIdx.y / hgroups, hgi = blockIdx.y % hgroups;
  const int Hg = H / G, Hb = (Hg + hgroups - 1) / hgroups;
  const int h0 = hgi * Hb, nh = min(Hb, Hg - h0);   // this block's heads
  const int kr = dh + kVW;                     // padded cache row
  C* ks = reinterpret_cast<C*>(smem);          // [kStages][kTile][kr]
  C* vs = ks + kStages * kTile * kr;           // [kStages][kTile][kr]
  float* qs = reinterpret_cast<float*>(vs + kStages * kTile * kr);  // [nh, dh]
  float* ps = qs + nh * dh;                    // [nh, kTile]
  float* m_s = ps + nh * kTile;                // [nh] running max
  float* l_s = m_s + nh;                       // [nh] running sum
  float* c_s = l_s + nh;                       // [nh] this tile's correction
  float* ksc = c_s + nh;                       // [2][kTile] K scales (int8)
  float* vsc = ksc + 2 * kTile;                // [2][kTile] V scales (int8)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const size_t qbase = ((size_t)b * H + (size_t)g * Hg + h0) * dh;
  for (int e = tid; e < nh * dh; e += blockDim.x) qs[e] = to_f<T>(q[qbase + e]);
  if (tid < nh) { m_s[tid] = kMask; l_s[tid] = 0.f; }
  float2 acc[kPairs];                          // (head, dim pair) outputs
#pragma unroll
  for (int o = 0; o < kPairs; ++o) acc[o] = make_float2(0.f, 0.f);
  const int npair = nh * dh / 2;
  // this split's positions [p0, p1): tiles [sp*T/splits, (sp+1)*T/splits)
  // of the T tiles of S (ref.decode_split_ranges), cut at the row's n
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
        cp_async4(smem_u32(ksc + stage * kTile + t), k_scale + o, in);
        cp_async4(smem_u32(vsc + stage * kTile + t), v_scale + o, in);
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
    for (int e = tid; e < nh * kTile; e += blockDim.x) {
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
    for (int h = warp; h < nh; h += nw) {
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
  // partial of (b, g, sp): acc [Hg, dh], then m [Hg], then l [Hg]; this
  // block's rows h0 .. h0 + nh - 1
  const size_t bg = (size_t)b * G + g;
  float* pb = part + (bg * splits + sp) * Hg * (dh + 2);
#pragma unroll
  for (int o = 0; o < kPairs; ++o) {
    const int u = tid + o * blockDim.x;
    if (u < npair)
      *reinterpret_cast<float2*>(pb + (size_t)h0 * dh + 2 * u) = acc[o];
  }
  if (tid < nh) {
    pb[Hg * dh + h0 + tid] = m_s[tid];
    pb[Hg * dh + Hg + h0 + tid] = l_s[tid];
  }
  finish_split<T>(part + bg * splits * Hg * (dh + 2), Hg, dh, splits, h0, nh,
                  tickets + bg * hgroups + hgi,
                  reinterpret_cast<float*>(smem), out + qbase);
}

template <typename T, typename C, int kPairs, int kStages>
cudaError_t launch_split(const void* q, const void* k, const void* k_scale,
                         const void* v, const void* v_scale,
                         const void* kv_len, int B, int S, int H, int G,
                         int dh, float scale, int splits, int hgroups,
                         int smem, void* part, void* tickets, void* out,
                         cudaStream_t st) {
  auto kernel = decode_split_kernel<T, C, kPairs, kStages>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t e = allow_smem(kernel, smem_set);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(splits, G * hgroups, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(kv_len), S,
      H, G, dh, scale, splits, hgroups, static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets));
  return cudaGetLastError();
}

// -------------------------------------------------------- tensor cores

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;                  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kM = 16;                         // heads a block, zero-padded
constexpr int kPR = kTile + 8;                 // padded row of P (bf16)
constexpr int kSR = kTile + 8;                 // padded row of S (f32)

// Shared memory of a block (ops.decode_tc_smem_bytes): the K and V rings
// [2][kTile][dh + 8] and Q [kM][dh + 8] in bf16, P [kM][kPR] in bf16, then
// in f32 S [kM][kSR] and the running max, sum and correction [kM] each;
// the merge reuses it from the start.
template <int DH> constexpr int smem_bytes() {
  return (4 * kTile + kM) * (DH + 8) * 2 + kM * kPR * 2 +
         (kM * kSR + 3 * kM) * 4;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_len,
                 int S, int H, int G, float scale, int splits, int hgroups,
                 bf16* __restrict__ out, float* __restrict__ part,
                 int* __restrict__ tickets) {
  constexpr int R = DH + 8;                    // padded shared row
  constexpr int CPR = DH / 8;                  // 16-byte chunks a row
  constexpr int KS = DH / 16;                  // k-steps of Q K^T
  constexpr int NP = DH / 16;                  // 16-column pairs of O
  constexpr int PW = (NP + kWarps - 1) / kWarps;   // pairs a warp
  constexpr bool QREG = DH <= 128;             // Q's fragments in registers
  static_assert(DH % 16 == 0 && DH <= 256, "dh: a multiple of 16, <= 256");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);    // [2][kTile][R]
  bf16* vs = ks + 2 * kTile * R;               // [2][kTile][R]
  bf16* qs = vs + 2 * kTile * R;               // [kM][R]
  bf16* pbf = qs + kM * R;                     // [kM][kPR]
  float* ss = reinterpret_cast<float*>(pbf + kM * kPR);  // [kM][kSR]
  float* m_s = ss + kM * kSR;                  // [kM] running max
  float* l_s = m_s + kM;                       // [kM] running sum
  float* c_s = l_s + kM;                       // [kM] this tile's correction
  const int sp = blockIdx.x, b = blockIdx.z;
  const int g = blockIdx.y / hgroups, hgi = blockIdx.y % hgroups;
  const int Hg = H / G, Hb = (Hg + hgroups - 1) / hgroups;
  const int h0 = hgi * Hb, nh = min(Hb, Hg - h0);   // this block's heads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const size_t qbase = ((size_t)b * H + (size_t)g * Hg + h0) * DH;
  const int len = kv_len[b];
  const int n = len > 0 ? min(len, S) : S;
  const int tiles = (S + kTile - 1) / kTile;
  const int p0 = (int)((long long)sp * tiles / splits) * kTile;
  const int p1 = min(n, (int)((long long)(sp + 1) * tiles / splits) * kTile);
  const int ntl = p1 > p0 ? (p1 - p0 + kTile - 1) / kTile : 0;
  const size_t pos_stride = (size_t)G * DH;
  const bf16* kb = k + (size_t)b * S * pos_stride + (size_t)g * DH;
  const bf16* vb = v + (size_t)b * S * pos_stride + (size_t)g * DH;
  // Q's rows past nh are zero-filled; P starts zero (its rows past nh
  // stay so)
  for (int c = tid; c < kM * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool in = r < nh;
    cp_async16(smem_u32(qs + r * R + col),
               q + qbase + (in ? (size_t)r * DH : 0) + col, in);
  }
  for (int e = tid; e < kM * kPR / 2; e += kThreads)
    reinterpret_cast<uint32_t*>(pbf)[e] = 0u;
  if (tid < kM) {
    m_s[tid] = kMask;
    l_s[tid] = 0.f;
    c_s[tid] = 0.f;
  }
  auto load = [&](int stage, int t0) {        // rows past p1 zero-filled
    bf16* kd = ks + stage * kTile * R;
    bf16* vd = vs + stage * kTile * R;
    for (int c = tid; c < kTile * CPR; c += kThreads) {
      const int t = c / CPR, col = (c % CPR) * 8;
      const bool in = t0 + t < p1;
      const size_t off = (in ? (size_t)(t0 + t) * pos_stride : 0) + col;
      cp_async16(smem_u32(kd + t * R + col), kb + off, in);
      cp_async16(smem_u32(vd + t * R + col), vb + off, in);
    }
  };
  if (ntl > 0) load(0, p0);
  cp_async_commit();                           // Q and tile 0
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[QREG ? KS : 1][4];               // Q's A-fragments
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[kk], smem_u32(qs + (lane & 15) * R + kk * 16 +
                                   (lane >> 4) * 8));
  }
  float o[PW][2][4];
#pragma unroll
  for (int pi = 0; pi < PW; ++pi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      o[pi][j][0] = o[pi][j][1] = o[pi][j][2] = o[pi][j][3] = 0.f;
  for (int i = 0; i < ntl; ++i) {
    if (i > 0) {
      cp_async_wait<0>();                      // tile i has landed
      __syncthreads();                         // and tile i - 1 is consumed
    }
    if (i + 1 < ntl) {
      load((i + 1) & 1, p0 + (i + 1) * kTile);
      cp_async_commit();
    }
    const int t0 = p0 + i * kTile, nt = min(kTile, p1 - t0);
    const bf16* kt = ks + (i & 1) * kTile * R;
    const bf16* vt = vs + (i & 1) * kTile * R;
    // S = Q K^T: warp w takes positions 16w .. 16w + 15, two 8-position
    // accumulator tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, smem_u32(qs + (lane & 15) * R + kk * 16 +
                                 (lane >> 4) * 8));
      }
      uint32_t r[4];                           // positions 16w.., dims 16kk..
      ldmatrix_x4(r, smem_u32(kt + (warp * 16 + (lane & 7) +
                                    ((lane >> 4) << 3)) * R +
                              kk * 16 + ((lane >> 3) & 1) * 8));
      mma_bf16(s[0], qa, r[0], r[1]);
      mma_bf16(s[1], qa, r[2], r[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {         // rows gr, gr + 8
        const int t = warp * 16 + j * 8 + 2 * tg;
        const float2 sc = make_float2(
            t0 + t < len ? s[j][2 * hr] * scale : kMask,
            t0 + t + 1 < len ? s[j][2 * hr + 1] * scale : kMask);
        *reinterpret_cast<float2*>(ss + (gr + hr * 8) * kSR + t) = sc;
      }
    }
    __syncthreads();
    // per head: the tile's max, p = exp(s - max) summed unrounded and
    // stored rounded to bf16 (0 past nt), the running max and sum
    for (int h = warp; h < nh; h += kWarps) {
      const float* row = ss + h * kSR;
      float mc = kMask;
      for (int t = lane; t < nt; t += 32) mc = fmaxf(mc, row[t]);
      mc = warp_max(mc);
      const float mp = m_s[h];
      const float mn = fmaxf(mp, mc);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = t < nt ? expf(row[t] - mn) : 0.f;
        pbf[h * kPR + t] = __float2bfloat16(p);
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
    // O = O * corr + P V: warp w takes the column pairs w, w + 4, ...
    uint32_t pa[kTile / 16][4];                // P's A-fragments
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      ldmatrix_x4(pa[kk], smem_u32(pbf + (lane & 15) * kPR + kk * 16 +
                                   (lane >> 4) * 8));
    const float c0 = c_s[gr], c1 = c_s[gr + 8];
#pragma unroll
    for (int pi = 0; pi < PW; ++pi) {
      const int dp = warp + pi * kWarps;
      if (dp < NP) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          o[pi][j][0] *= c0;
          o[pi][j][1] *= c0;
          o[pi][j][2] *= c1;
          o[pi][j][3] *= c1;
        }
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          uint32_t r[4];                       // positions 16kk.., dims 16dp..
          ldmatrix_x4_trans(r, smem_u32(vt + (kk * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) * R +
                                        dp * 16 + (lane >> 4) * 8));
          mma_bf16(o[pi][0], pa[kk], r[0], r[1]);
          mma_bf16(o[pi][1], pa[kk], r[2], r[3]);
        }
      }
    }
  }
  __syncthreads();                             // m_s, l_s final
  if (splits == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = gr + hr * 8;
      if (row < nh) {
        const float den = fmaxf(l_s[row], 1e-30f);
        bf16* orow = out + qbase + (size_t)row * DH + tg * 2;
#pragma unroll
        for (int pi = 0; pi < PW; ++pi) {
          const int dp = warp + pi * kWarps;
          if (dp < NP) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
              *reinterpret_cast<uint32_t*>(orow + dp * 16 + j * 8) =
                  pack_bf16(o[pi][j][2 * hr] / den,
                            o[pi][j][2 * hr + 1] / den);
          }
        }
      }
    }
    return;
  }
  // partial of (b, g, sp), this block's rows h0 .. h0 + nh - 1
  const size_t bg = (size_t)b * G + g;
  float* pb = part + (bg * splits + sp) * Hg * (DH + 2);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = gr + hr * 8;
    if (row < nh) {
      float* prow = pb + (size_t)(h0 + row) * DH + tg * 2;
#pragma unroll
      for (int pi = 0; pi < PW; ++pi) {
        const int dp = warp + pi * kWarps;
        if (dp < NP) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<float2*>(prow + dp * 16 + j * 8) =
                make_float2(o[pi][j][2 * hr], o[pi][j][2 * hr + 1]);
        }
      }
    }
  }
  if (tid < nh) {
    pb[Hg * DH + h0 + tid] = m_s[tid];
    pb[Hg * DH + Hg + h0 + tid] = l_s[tid];
  }
  finish_split<bf16>(part + bg * splits * Hg * (DH + 2), Hg, DH, splits, h0,
                     nh, tickets + bg * hgroups + hgi,
                     reinterpret_cast<float*>(smem), out + qbase);
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, int B, int S, int H, int G, float scale,
                   int splits, int hgroups, int smem, void* part,
                   void* tickets, void* out, cudaStream_t st) {
  auto kernel = decode_tc_kernel<DH>;
  static std::atomic<unsigned> smem_set{0};
  if (smem < smem_bytes<DH>()) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(kernel, smem_set);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(splits, G * hgroups, B), kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(kv_len), S, H, G,
      scale, splits, hgroups, static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets));
  return cudaGetLastError();
}

}  // namespace tc

// k_scale and v_scale: null for a float cache (C = T). `route` 1 takes the
// tensor cores (a bf16 cache, dh 32, 64, 80, 128 or 256), 0 the CUDA
// cores; `stages` (1 or 2) comes with `smem` from ops.decode_smem_bytes
// for the CUDA cores, whose wide groups (Hb*dh past 2 * kMaxPair *
// kThreads) take kWidePair pairs a thread. `part` and `tickets` may be
// null when splits is 1.
template <typename T, typename C>
int launch(const void* q, const void* k, const void* k_scale, const void* v,
           const void* v_scale, const void* kv_len, int B, int S, int H, int G,
           int dh, float scale, int splits, int hgroups, int route, int stages,
           int smem, void* part, void* tickets, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Hg = H / G, Hb = hgroups > 0 ? (Hg + hgroups - 1) / hgroups : 0;
  if (splits < 1 || hgroups < 1 || hgroups > Hg || (hgroups - 1) * Hb >= Hg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value &&
                  std::is_same<C, __nv_bfloat16>::value) {
      if (Hb > tc::kM) return static_cast<int>(cudaErrorInvalidValue);
      switch (dh) {
#define DECODE_TC(D)                                                         \
  case D:                                                                    \
    return static_cast<int>(tc::launch<D>(q, k, v, kv_len, B, S, H, G,       \
                                          scale, splits, hgroups, smem,      \
                                          part, tickets, out, st));
        DECODE_TC(32) DECODE_TC(64) DECODE_TC(80) DECODE_TC(128)
        DECODE_TC(256)
#undef DECODE_TC
        default: break;
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int npair = Hb * dh / 2;
  if (route != 0 || npair > kWidePair * kThreads || stages < 1 || stages > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = npair > kMaxPair * kThreads;
#define DECODE_SPLIT(P, ST)                                                  \
  launch_split<T, C, P, ST>(q, k, k_scale, v, v_scale, kv_len, B, S, H, G,   \
                            dh, scale, splits, hgroups, smem, part, tickets, \
                            out, st)
  const cudaError_t e =
      stages == 2 ? (wide ? DECODE_SPLIT(kWidePair, 2) : DECODE_SPLIT(kMaxPair, 2))
                  : (wide ? DECODE_SPLIT(kWidePair, 1) : DECODE_SPLIT(kMaxPair, 1));
#undef DECODE_SPLIT
  return static_cast<int>(e);
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* kv_len, int B, int S, int H,
                                    int G, int dh, float scale, int splits,
                                    int hgroups, int route, int stages,
                                    int smem, void* part, void* tickets,
                                    void* out, void* stream) {
  return launch<float, float>(q, k, nullptr, v, nullptr, kv_len, B, S, H, G,
                              dh, scale, splits, hgroups, route, stages, smem,
                              part, tickets, out, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* kv_len, int B, int S, int H,
                                     int G, int dh, float scale, int splits,
                                     int hgroups, int route, int stages,
                                     int smem, void* part, void* tickets,
                                     void* out, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      q, k, nullptr, v, nullptr, kv_len, B, S, H, G, dh, scale, splits,
      hgroups, route, stages, smem, part, tickets, out, stream);
}

// int8 cache: k, v [B, S, G, dh] int8; k_scale, v_scale [B, S, G] f32; the
// CUDA cores
extern "C" int decode_attention_q8_f32(const void* q, const void* k,
                                       const void* k_scale, const void* v,
                                       const void* v_scale, const void* kv_len,
                                       int B, int S, int H, int G, int dh,
                                       float scale, int splits, int hgroups,
                                       int stages, int smem, void* part,
                                       void* tickets, void* out,
                                       void* stream) {
  return launch<float, int8_t>(q, k, k_scale, v, v_scale, kv_len, B, S, H, G,
                               dh, scale, splits, hgroups, 0, stages, smem,
                               part, tickets, out, stream);
}

extern "C" int decode_attention_q8_bf16(const void* q, const void* k,
                                        const void* k_scale, const void* v,
                                        const void* v_scale, const void* kv_len,
                                        int B, int S, int H, int G, int dh,
                                        float scale, int splits, int hgroups,
                                        int stages, int smem, void* part,
                                        void* tickets, void* out,
                                        void* stream) {
  return launch<__nv_bfloat16, int8_t>(q, k, k_scale, v, v_scale, kv_len, B,
                                       S, H, G, dh, scale, splits, hgroups, 0,
                                       stages, smem, part, tickets, out,
                                       stream);
}
