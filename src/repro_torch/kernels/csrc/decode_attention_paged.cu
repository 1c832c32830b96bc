// Block-table flash-decode GQA attention on Hopper.
//
// Replaces the Pallas kernel
// src/repro/kernels/decode_attention.py::decode_attention_paged
// (pallas_call at :135): one query position per row b against K/V that
// live in a page pool [P, ps, G, dh] and are read through the row's page
// table [W] (entry w backs positions [w*ps, (w+1)*ps)). Positions >=
// kv_len[b] are masked with -1e30; online softmax with scale 1/sqrt(dh)
// and scores in f32; probabilities are rounded to the value type before
// the PV product (as `p.astype(v.dtype)` does in the TPU kernel); the
// output is acc / max(l, 1e-30). A row counts its first
// npg = ceil(kv_len / ps) table entries (all W when kv_len <= 0, every
// position then masked: the uniform average, as the plain version gives).
//
// Bound on the H100: each row reads its kv_len K and V positions once
// (2*kv_len*G*dh elements) for ~4*H*dh flops per position, so it is bound
// by memory bytes. Design (flash-decoding over pages, the split scheme of
// decode_attention.cu): the table is split across blocks, grid (splits, G,
// B), so that a small batch still fills the 132 SMs; the wrapper's plan
// (`ops.decode_paged_split_plan`) picks the splits from host-known shapes
// (B, G, W, ps), and split s covers the table entries
// [s*W/splits, (s+1)*W/splits) (`ref.decode_paged_split_ranges`), cut at
// the row's npg, which the block computes from kv_len on the device (no
// host sync). A block keeps the Hg = H/G query heads of its kv group in
// shared memory and walks its entries' positions in tiles of kTile rows.
// Each row of a tile finds its own page through the table, so a tile may
// span pages, and nothing assumes two entries are neighbours in the pool
// (tables repeat, reverse and point tail entries at page 0). The rows
// arrive by 16-byte cp.async copies of the kv head's dh values (strided by
// G*dh in the pool) into a ring of two stages, padded to an odd number of
// 16 bytes so that the row-per-thread score reads are free of bank
// conflicts: tile j + 1 loads while tile j computes; rows past the split's
// entries are zero-filled. The first tile's copies are issued before the
// block reads kv_len or loads the queries (rows of it past npg get no
// weight). Each thread computes whole (head, position) scores, one
// warp per head takes the running max and sum and rounds the
// probabilities to T, and each thread updates its (head, dim pair)
// accumulators in f32 registers from V in shared memory. With one split
// the block writes the output; with more it writes a partial and a second
// small launch (`decode_merge_kernel`, decode_split.cuh) merges the
// partials of each (b, g) in split order: deterministic, no atomics; a
// split past the row's npg is empty (l = 0) and skipped.
#include "decode_split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                      // positions per ring stage
constexpr int kMaxPair = 4;                    // output pairs a thread: Hg*dh <= 2048

// Shared memory (launch() sizes it; ops.decode_smem_bytes mirrors it): the
// K and V rings [2][kTile][dh + kVW] in T, then in f32 the group's queries
// [Hg, dh], a tile's scores [Hg, kTile] and the running max, sum and
// correction [Hg] each.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    const int* __restrict__ table, int H, int G, int dh,
                    int ps, int W, float scale, int splits,
                    T* __restrict__ out, float* __restrict__ part) {
  constexpr int kVW = 16 / sizeof(T);          // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hg = H / G;
  const int kr = dh + kVW;                     // padded cache row
  T* ks = reinterpret_cast<T*>(smem);          // [2][kTile][kr]
  T* vs = ks + 2 * kTile * kr;                 // [2][kTile][kr]
  float* qs = reinterpret_cast<float*>(vs + 2 * kTile * kr);  // [Hg, dh]
  float* ss = qs + Hg * dh;                    // [Hg, kTile]
  float* m_s = ss + Hg * kTile;                // [Hg] running max
  float* l_s = m_s + Hg;                       // [Hg] running sum
  float* c_s = l_s + Hg;                       // [Hg] this tile's correction
  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  // this split's table entries [e0, e1n), from position p0
  const int e0 = (int)((long long)sp * W / splits);
  const int e1n = (int)((long long)(sp + 1) * W / splits);
  const int p0 = e0 * ps;
  const int* tb = table + (size_t)b * W;
  const size_t pos_stride = (size_t)G * dh;
  const size_t page_stride = (size_t)ps * pos_stride;
  const T* kg = k + (size_t)g * dh;
  const T* vg = v + (size_t)g * dh;
  const int rv = dh / kVW;                     // 16-byte copies per row
  auto load = [&](int stage, int t0, int hi) { // rows past hi zero-filled
    T* kd = ks + stage * kTile * kr;
    T* vd = vs + stage * kTile * kr;
    for (int e = tid; e < kTile * rv; e += blockDim.x) {
      const int t = e / rv, c = (e % rv) * kVW;
      const int pos = t0 + t;
      const bool in = pos < hi;
      const size_t off = in ? (size_t)__ldg(tb + pos / ps) * page_stride
                                  + (size_t)(pos % ps) * pos_stride + c
                            : c;
      cp_async16(smem_u32(kd + t * kr + c), kg + off, in);
      cp_async16(smem_u32(vd + t * kr + c), vg + off, in);
    }
  };
  // the first tile's copies go out before kv_len is read: its rows lie
  // in the split's own entries, which are valid page ids
  load(0, p0, e1n * ps);
  cp_async_commit();
  // the split's positions [p0, p1): its entries cut at the row's npg
  const int len = kv_len[b];
  const int npg = len > 0 ? min(W, (len + ps - 1) / ps) : W;
  const int p1 = min(npg, e1n) * ps;
  const int ntl = p1 > p0 ? (p1 - p0 + kTile - 1) / kTile : 0;
  const size_t qbase = ((size_t)b * H + (size_t)g * Hg) * dh;
  for (int e = tid; e < Hg * dh; e += blockDim.x) qs[e] = to_f<T>(q[qbase + e]);
  if (tid < Hg) { m_s[tid] = kMask; l_s[tid] = 0.f; }
  float2 acc[kMaxPair];                        // (head, dim pair) outputs
#pragma unroll
  for (int o = 0; o < kMaxPair; ++o) acc[o] = make_float2(0.f, 0.f);
  const int npair = Hg * dh / 2;
  for (int i = 0; i < ntl; ++i) {
    cp_async_wait<0>();                        // tile i has landed
    __syncthreads();                           // and tile i - 1 is consumed
    if (i + 1 < ntl) {
      load((i + 1) & 1, p0 + (i + 1) * kTile, p1);
      cp_async_commit();
    }
    const int t0 = p0 + i * kTile, nt = min(kTile, p1 - t0);
    const T* kt = ks + (i & 1) * kTile * kr;
    const T* vt = vs + (i & 1) * kTile * kr;
    for (int e = tid; e < Hg * kTile; e += blockDim.x) {
      const int h = e / kTile, t = e % kTile;
      float s = kMask;
      if (t < nt && t0 + t < len) {            // masked rows skip the dot
        const float* qh = qs + h * dh;
        const T* krow = kt + t * kr;
        float s0 = 0.f, s1 = 0.f;              // even and odd dims
        for (int c = 0; c < dh; c += kVW) {
          float kf[kVW];
          unpack<T>(*reinterpret_cast<const uint4*>(krow + c), kf);
#pragma unroll
          for (int j = 0; j < kVW; j += 4) {   // a warp's q reads broadcast
            const float4 qv = *reinterpret_cast<const float4*>(qh + c + j);
            s0 = fmaf(qv.x, kf[j], s0);
            s1 = fmaf(qv.y, kf[j + 1], s1);
            s0 = fmaf(qv.z, kf[j + 2], s0);
            s1 = fmaf(qv.w, kf[j + 3], s1);
          }
        }
        s = (s0 + s1) * scale;
      }
      ss[e] = s;
    }
    __syncthreads();
    // per head: the tile's max, p = exp(s - max) summed unrounded and
    // stored rounded to T (0 past nt), the running max and sum
    for (int h = warp; h < Hg; h += nw) {
      float* row = ss + h * kTile;
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
    // rows [nt, ntp) are zero-filled with p = 0
    const int ntp = (nt + 3) & ~3;
#pragma unroll
    for (int o = 0; o < kMaxPair; ++o) {
      const int u = tid + o * blockDim.x;
      if (u < npair) {
        const int h = 2 * u / dh, dd = 2 * u % dh;
        const float* prow = ss + h * kTile;
        const T* vcol = vt + dd;
        float2 a[4];                           // four chains over positions
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = make_float2(0.f, 0.f);
#pragma unroll 4
        for (int t = 0; t < ntp; t += 4) {
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
  cp_async_wait<0>();                          // an empty split's tile
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
           const void* table, int B, int H, int G, int dh, int ps, int W,
           int splits, void* part, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Hg = H / G;
  const int smem = static_cast<int>(
      4 * kTile * (dh + 16 / sizeof(T)) * sizeof(T) +
      (Hg * dh + Hg * kTile + 3 * Hg) * sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_paged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  decode_paged_kernel<T><<<dim3(splits, G, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<const int*>(table), H, G, dh, ps, W, scale, splits,
      static_cast<T*>(out), static_cast<float*>(part));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return static_cast<int>(launch_merge<T>(part, B, H, G, dh, splits, out, st));
}

}  // namespace

extern "C" int decode_attention_paged_f32(const void* q, const void* k,
                                          const void* v, const void* kv_len,
                                          const void* table, int B, int H, int G,
                                          int dh, int ps, int W, int splits,
                                          void* part, void* out, void* stream) {
  return launch<float>(q, k, v, kv_len, table, B, H, G, dh, ps, W, splits,
                       part, out, stream);
}

extern "C" int decode_attention_paged_bf16(const void* q, const void* k,
                                           const void* v, const void* kv_len,
                                           const void* table, int B, int H, int G,
                                           int dh, int ps, int W, int splits,
                                           void* part, void* out, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, table, B, H, G, dh, ps, W,
                               splits, part, out, stream);
}
