// The bodies of the two split flash-decode kernels, shared by
// decode_attention.cu (a contiguous cache k/v [B, S, G, dh]) and
// decode_attention_paged.cu (a page pool [P, ps, G, dh] read through each
// row's page table). Each source instantiates them with its own `Rows`,
// which says where a row's positions lie:
//
//   span(sp, splits) -> int2: the positions [p0, pe) of split sp of a row
//     before the row's length cuts them (host-known shapes only);
//   end(len) -> int: how far a row of length len walks (its positions at
//     or past len are masked: with len <= 0 every position of the row is,
//     and the output is the uniform average);
//   slot(b, pos) -> size_t: where row b's position pos lies: the K row of
//     kv head g at k + (slot * G + g) * dh, its int8 scale at
//     k_scale[slot * G + g];
//   kTable: whether slot() reads memory (a page table entry), so that the
//     tensor-core kernel reads a tile's slots ahead into a shared ring.
//
// What both compute: one query position per row b; positions >= kv_len[b]
// masked with -1e30; online softmax with scale 1/sqrt(dh) (a float from
// the caller) and scores in f32; probabilities rounded to the value type
// before the PV product (`p.astype(v.dtype)` in the TPU kernels); the
// output acc / max(l, 1e-30). Bound on the H100: each row reads its K and
// V positions once for ~4*H*dh flops a position, far below the card's 295
// flops a byte in bf16, so memory bytes.
//
// Grid (splits, G * head_groups, B) from the wrapper's plan (host-known
// shapes only: kv_len stays on the device): the splits cut each row's
// positions so that a small batch still fills the 132 SMs, and head
// groups split a kv group's Hg query heads into blocks of ceil(Hg /
// head_groups) heads where the blocks still leave SMs idle (those blocks
// read the same K/V tile, the later ones from L2, and need no merge). A
// block reads its row's kv_len and cuts its split there; a split that
// holds none of the row's positions loads nothing (`skip_split`). A block
// walks its split in tiles of kTile rows, which arrive by 16-byte cp.async
// copies into a ring of two stages (rows past the split's end
// zero-filled), neighbouring threads on neighbouring 16 bytes of a row.
// Each row finds its own slot (through the table, for a pool: a tile may
// span pages, and nothing assumes two table entries are neighbours in
// the pool). With one split the block writes
// the output; with more it writes a partial (m, l, unnormalised acc) in
// f32, takes a ticket of its (b, g, head group), and the last of its
// splits merges the partials in split order (`finish_split`,
// decode_split.cuh: deterministic, no atomics on the values, one launch a
// call). The ticket counters are zero before a launch and the last block
// resets its own (`ops.tickets`, one buffer a stream).
//
// Two routes (`route`, chosen by the wrapper):
//
// Tensor cores (`tc`, bf16 q, dh 32, 64, 80, 128 or 256; a bf16 cache, and
// an int8 pool where the source builds it): the block's heads, zero-padded
// to 16, are the M rows of `mma.sync.m16n8k16` bf16 -> f32 (mma.cuh; a
// block has at most 16 heads, and wgmma wants 64 rows). Four warps; per
// tile each warp computes S = Q K^T for 16 positions (Q's fragments by
// `ldmatrix`, held in registers up to dh 128; K's rows by `ldmatrix` as
// the col-major B operand) and writes the scaled, masked scores to shared
// memory; one warp per head updates the running max and sum in f32 and
// stores the probabilities rounded to bf16 (the reference's
// `p.astype(v.dtype)`, and the MMA's A operand); then the warps split O's
// columns in 16-column pairs and add P V with V by `ldmatrix.trans`. The
// threads copy a tile's 16-byte chunks in row order, so that a warp's
// copies cover whole rows, from the tile's row slots in a shared ring:
// through a page table (`Rows::kTable`) an entry is a dependent load
// before a row's copies can go out, so a tile's slots are read (one
// thread a row) two tiles ahead, while the tiles before it compute, and
// the first tile's beside kv_len.
// (Two threads a row, each with its row's slot in a register, was 10-15%
// slower over contiguous rows, and a table read a chunk 10% slower over
// pages: PERF.md.)
//
// The int8 pool on the tensor cores: a thread loads its chunks of a
// tile's int8 K/V rows into registers one tile ahead (16-byte loads, no
// shared stage, so a block takes the bf16 route's shared memory and
// occupancy), and widens them into the bf16 ring before the tile's
// barrier (every int8 value is exact in bf16), so that the tile goes
// through the same `ldmatrix` / `mma.sync` path; no dequantized copy is
// ever written to global memory. The scales commute through the
// products: a score is (q . kq) * scale * k_scale on the f32 accumulator,
// P's A operand is bf16(exp(s - max) * v_scale) (the reference's `p * vs`
// cast to q's type), the running sum takes the unscaled probability, and
// the scales arrive by 4-byte cp.async beside their rows.
//
// CUDA cores (`cuda`: f32, the 1e-5 check; an int8 cache under an f32 q,
// or where the source does not build the tensor cores for it; dh outside
// the tensor-core list): each thread computes whole (head, position)
// scores from q in shared memory as f32, one warp per head updates the
// running max and sum and rounds the probabilities to T, each thread
// updates its (head, dim pair) accumulators in f32 registers over four
// chains, three barriers a tile. Wide groups (Hb*dh past 2,048, as
// recurrentgemma's one kv head under 16 query heads at dh 256) hold
// kWidePair (8) output pairs a thread instead of kMaxPair (4). In f32 at
// dh 256 two stages of K and V rows pass the 227 KB a block may take, so
// that shape runs one stage: the next tile loads after the current one's
// PV product, behind one more barrier (ops.decode_stages). An int8 cache
// reads int8 rows (16 a 16-byte copy) and applies the scales as above,
// with the probability rounded to q's type.
#pragma once
#include "decode_split.cuh"
#include "mma.cuh"

namespace {

constexpr int kTile = 64;                      // positions per tile

// ---------------------------------------------------------- CUDA cores

constexpr int kThreads = 256;
constexpr int kMaxPair = 4;                    // output pairs a thread: Hb*dh <= 2048
constexpr int kWidePair = 8;                   // Hb*dh <= 4096

// Shared memory (its size comes from ops.decode_smem_bytes at the
// block's Hb = ceil(Hg / head_groups) heads): the K and V rings
// [kStages][kTile][dh + kVW] in C, then in f32 the block's queries
// [Hb, dh], the tile's scores [Hb, kTile], the running max, sum and
// correction [Hb] each, and with an int8 cache the K and V scale rings
// [2][kTile] each; the merge reuses it from the start (ops sizes it for
// both). T: the type of q and out; C: the cache's (T or int8). kPairs:
// output pairs a thread. kStages: 2 (tile j + 1 loads while tile j
// computes), or 1 where two stages do not fit 227 KB.
template <typename T, typename C, int kPairs, int kStages, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ kv_len, Rows rows, int H, int G,
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
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const size_t qbase = ((size_t)b * H + (size_t)g * Hg + h0) * dh;
  const size_t bg = (size_t)b * G + g;
  // the partials of (b, g)'s first split, and this split's m and l
  float* accb = part_acc(part, bg, 0, splits, Hg, dh);
  float* mlb = part_ml(part, (size_t)gridDim.z * G, bg, 0, splits, Hg, dh);
  float* ml = mlb + (size_t)sp * 2 * Hg;
  // this split's positions [p0, p1): its span cut at the row's walk
  const int2 span = rows.span(sp, splits);
  const int p0 = span.x;
  const int len = kv_len[b];
  const int p1 = min(span.y, rows.end(len));
  const int ntl = p1 > p0 ? (p1 - p0 + kTile - 1) / kTile : 0;
  if (ntl == 0) {
    skip_split<T>(accb, mlb, ml, Hg, dh, splits, h0, nh,
                  tickets + bg * hgroups + hgi,
                  reinterpret_cast<float*>(smem), out + qbase);
    return;
  }
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
  for (int e = tid; e < nh * dh; e += blockDim.x) qs[e] = to_f<T>(q[qbase + e]);
  if (tid < nh) { m_s[tid] = kMask; l_s[tid] = 0.f; }
  float2 acc[kPairs];                          // (head, dim pair) outputs
#pragma unroll
  for (int o = 0; o < kPairs; ++o) acc[o] = make_float2(0.f, 0.f);
  const int npair = nh * dh / 2;
  const size_t pos_stride = (size_t)G * dh;
  const C* kg = k + (size_t)g * dh;
  const C* vg = v + (size_t)g * dh;
  const int rv = dh / kVW;                     // 16-byte copies per row
  auto load = [&](int stage, int t0) {        // rows past p1 zero-filled
    stage %= kStages;
    C* kd = ks + stage * kTile * kr;
    C* vd = vs + stage * kTile * kr;
    for (int e = tid; e < kTile * rv; e += blockDim.x) {
      const int t = e / rv, c = (e % rv) * kVW;
      const bool in = t0 + t < p1;
      const size_t off = (in ? rows.slot(b, t0 + t) * pos_stride : 0) + c;
      cp_async16(smem_u32(kd + t * kr + c), kg + off, in);
      cp_async16(smem_u32(vd + t * kr + c), vg + off, in);
    }
    if constexpr (kQ8) {                      // the tile's scales, 0 past p1
      for (int t = tid; t < kTile; t += blockDim.x) {
        const bool in = t0 + t < p1;
        const size_t o = (in ? rows.slot(b, t0 + t) : 0) * G + g;
        cp_async4(smem_u32(ksc + stage * kTile + t), k_scale + o, in);
        cp_async4(smem_u32(vsc + stage * kTile + t), v_scale + o, in);
      }
    }
  };
  load(0, p0);
  cp_async_commit();
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
      float sc = kMask;
      if (t < nt && t0 + t < len) {            // masked rows skip the dot
        const float* qh = qs + h * dh;
        const C* krow = kt + t * kr;
        float s0 = 0.f, s1 = 0.f;              // even and odd dims
        for (int c = 0; c < dh; c += kVW) {
          float kf[kVW];
          unpack<C>(*reinterpret_cast<const uint4*>(krow + c), kf);
#pragma unroll
          for (int j = 0; j < kVW; j += 4) {   // a warp's q reads broadcast
            const float4 qv = *reinterpret_cast<const float4*>(qh + c + j);
            s0 = fmaf(qv.x, kf[j], s0);
            s1 = fmaf(qv.y, kf[j + 1], s1);
            s0 = fmaf(qv.z, kf[j + 2], s0);
            s1 = fmaf(qv.w, kf[j + 3], s1);
          }
        }
        sc = (s0 + s1) * scale;
        if constexpr (kQ8) sc *= kst[t];
      }
      ps[e] = sc;
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
    // rows [nt, ntp) are zero-filled with p = 0
    const int ntp = (nt + 3) & ~3;
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
        for (int t = 0; t < ntp; t += 4) {
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
  // partial of (b, g, sp), this block's rows h0 .. h0 + nh - 1
  float* pa = accb + ((size_t)sp * Hg + h0) * dh;
#pragma unroll
  for (int o = 0; o < kPairs; ++o) {
    const int u = tid + o * blockDim.x;
    if (u < npair) *reinterpret_cast<float2*>(pa + 2 * u) = acc[o];
  }
  if (tid < nh) {
    ml[h0 + tid] = m_s[tid];
    ml[Hg + h0 + tid] = l_s[tid];
  }
  finish_split<T>(accb, mlb, Hg, dh, splits, h0, nh,
                  tickets + bg * hgroups + hgi,
                  reinterpret_cast<float*>(smem), out + qbase);
}

template <typename T, typename C, int kPairs, int kStages, typename Rows>
cudaError_t launch_split(const void* q, const void* k, const void* k_scale,
                         const void* v, const void* v_scale,
                         const void* kv_len, const Rows& rows, int B, int H,
                         int G, int dh, float scale, int splits, int hgroups,
                         int smem, void* part, void* tickets, void* out,
                         cudaStream_t st) {
  auto kernel = decode_split_kernel<T, C, kPairs, kStages, Rows>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t e = allow_smem(kernel, smem_set);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(splits, G * hgroups, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(kv_len),
      rows, H, G, dh, scale, splits, hgroups, static_cast<T*>(out),
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
static_assert(kThreads == 2 * kTile, "a thread a tile row's K or V scale");

// Shared memory of a block (ops.decode_tc_smem_bytes): the K and V rings
// [2][kTile][dh + 8] and Q [kM][dh + 8] in bf16, P [kM][kPR] in bf16, then
// in f32 S [kM][kSR] and the running max, sum and correction [kM] each,
// the slots of two tiles' rows [2][kTile] (8 bytes each), and over an int8
// pool (Q8) the f32 K and V scale rings [2][kTile] each. The merge reuses
// it from the start.
template <int DH, bool Q8> constexpr int smem_bytes() {
  return (4 * kTile + kM) * (DH + 8) * 2 + kM * kPR * 2 +
         (kM * kSR + 3 * kM) * 4 + 2 * kTile * 8 + (Q8 ? 4 * kTile * 4 : 0);
}

// the 16 int8 values of a 16-byte load, as bf16 (exact) at d
__device__ __forceinline__ void widen16(const uint4& u, bf16* d) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      o[2 * j + i] = pack_bf16(
          static_cast<float>(static_cast<signed char>(w[j] >> (16 * i))),
          static_cast<float>(static_cast<signed char>(w[j] >> (16 * i + 8))));
  }
  reinterpret_cast<uint4*>(d)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(d)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

template <int DH, typename C, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const bf16* __restrict__ q, const C* __restrict__ k,
                 const C* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ kv_len, Rows rows, int H, int G,
                 float scale, int splits, int hgroups, bf16* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ tickets) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  constexpr int R = DH + 8;                    // padded shared row
  constexpr int CPR = DH * (int)sizeof(C) / 16;   // 16-byte chunks a cache row
  constexpr int CH = (kTile * CPR + kThreads - 1) / kThreads;  // a thread's
  constexpr int KS = DH / 16;                  // k-steps of Q K^T
  constexpr int NP = DH / 16;                  // 16-column pairs of O
  constexpr int PW = (NP + kWarps - 1) / kWarps;   // pairs a warp
  constexpr bool QREG = DH <= 128;             // Q's fragments in registers
  static_assert(DH % 16 == 0 && DH <= 256, "dh: a multiple of 16, <= 256");
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = blockIdx.x, b = blockIdx.z;
  const int g = blockIdx.y / hgroups, hgi = blockIdx.y % hgroups;
  const int Hg = H / G, Hb = (Hg + hgroups - 1) / hgroups;
  const int h0 = hgi * Hb, nh = min(Hb, Hg - h0);   // this block's heads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const size_t qbase = ((size_t)b * H + (size_t)g * Hg + h0) * DH;
  const size_t bg = (size_t)b * G + g;
  // the partials of (b, g)'s first split, and this split's m and l
  float* accb = part_acc(part, bg, 0, splits, Hg, DH);
  float* mlb = part_ml(part, (size_t)gridDim.z * G, bg, 0, splits, Hg, DH);
  float* ml = mlb + (size_t)sp * 2 * Hg;
  // this split's positions [p0, p1); thread t < kTile reads the slot of
  // row t of the first tile beside kv_len (the span's slots are all valid)
  const int2 span = rows.span(sp, splits);
  const int p0 = span.x;
  long long slot = Rows::kTable && tid < kTile && p0 + tid < span.y
                       ? (long long)rows.slot(b, p0 + tid) : -1;
  const int len = kv_len[b];
  const int p1 = min(span.y, rows.end(len));
  const int ntl = p1 > p0 ? (p1 - p0 + kTile - 1) / kTile : 0;
  if (ntl == 0) {
    skip_split<bf16>(accb, mlb, ml, Hg, DH, splits, h0, nh,
                     tickets + bg * hgroups + hgi,
                     reinterpret_cast<float*>(smem), out + qbase);
    return;
  }
  bf16* ks = reinterpret_cast<bf16*>(smem);    // [2][kTile][R]
  bf16* vs = ks + 2 * kTile * R;               // [2][kTile][R]
  bf16* qs = vs + 2 * kTile * R;               // [kM][R]
  bf16* pbf = qs + kM * R;                     // [kM][kPR]
  float* ss = reinterpret_cast<float*>(pbf + kM * kPR);  // [kM][kSR]
  float* m_s = ss + kM * kSR;                  // [kM] running max
  float* l_s = m_s + kM;                       // [kM] running sum
  float* c_s = l_s + kM;                       // [kM] this tile's correction
  long long* sl = reinterpret_cast<long long*>(c_s + kM);  // [2][kTile]
  float* ksc = reinterpret_cast<float*>(sl + 2 * kTile);  // [2][kTile] (int8)
  float* vsc = ksc + 2 * kTile;                // [2][kTile] (int8)
  // Q's rows past nh are zero-filled; P starts zero (its rows past nh
  // stay so)
  for (int c = tid; c < kM * (DH / 8); c += kThreads) {
    const int r = c / (DH / 8), col = (c % (DH / 8)) * 8;
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
  const size_t pos_stride = (size_t)G * DH;
  const C* kg = k + (size_t)g * DH;
  const C* vg = v + (size_t)g * DH;
  uint4 k8[kQ8 ? CH : 1], v8[kQ8 ? CH : 1];    // int8 chunks in flight
  // the slot of row t of the tile at t0 (-1 past p1): from the ring sl
  // where rows go through a table (`Rows::kTable`), else computed
  auto row_slot = [&](int stage, int t0, int t) -> long long {
    if constexpr (Rows::kTable) return sl[stage * kTile + t];
    return t0 + t < p1 ? (long long)rows.slot(b, t0 + t) : -1;
  };
  // The tile at t0 into ring stage `stage`: thread tid copies the 16-byte
  // chunks tid, tid + kThreads, ... of the tile's rows in order, so that a
  // warp's copies cover whole rows (a row with slot < 0 is zero-filled).
  // An int8 row's chunks go to registers, and its scale (thread t <
  // kTile: K's of row t, the next kTile: V's) to the scale rings.
  auto load = [&](int stage, int t0) {
    if constexpr (kQ8) {                      // unrolled: k8[j] in registers
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c = tid + j * kThreads;
        if (c < kTile * CPR) {
          const long long s = row_slot(stage, t0, c / CPR);
          const bool in = s >= 0;
          const size_t off = in ? (size_t)s * pos_stride : 0;
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          k8[j] = in ? __ldg(reinterpret_cast<const uint4*>(kg + off) +
                             c % CPR) : zero;
          v8[j] = in ? __ldg(reinterpret_cast<const uint4*>(vg + off) +
                             c % CPR) : zero;
        }
      }
    } else {                                  // rolled: fewer registers
      for (int c = tid; c < kTile * CPR; c += kThreads) {
        const int t = c / CPR, col = (c % CPR) * 8;
        const long long s = row_slot(stage, t0, t);
        const bool in = s >= 0;
        const size_t off = (in ? (size_t)s * pos_stride : 0) + col;
        cp_async16(smem_u32(ks + (stage * kTile + t) * R + col), kg + off,
                   in);
        cp_async16(smem_u32(vs + (stage * kTile + t) * R + col), vg + off,
                   in);
      }
    }
    if constexpr (kQ8) {
      const int t = tid % kTile;
      const long long s = row_slot(stage, t0, t);
      const bool in = s >= 0;
      cp_async4(smem_u32((tid < kTile ? ksc : vsc) + stage * kTile + t),
                (tid < kTile ? k_scale : v_scale) +
                    (in ? (size_t)s * G + g : 0),
                in);
    }
  };
  // the int8 chunks this thread loaded, widened into ring stage `stage`
  auto widen = [&](int stage) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = tid + j * kThreads;
      if (c < kTile * CPR) {
        const int t = c / CPR, col = c % CPR;
        widen16(k8[j], ks + (stage * kTile + t) * R + col * 16);
        widen16(v8[j], vs + (stage * kTile + t) * R + col * 16);
      }
    }
  };
  // thread t < kTile: the slot of row t of the tile at t0 (-1 past p1)
  auto slot_at = [&](int t0) -> long long {
    return tid < kTile && t0 + tid < p1 ? (long long)rows.slot(b, t0 + tid)
                                        : -1;
  };
  // Through a table, the slots of a tile go to the ring sl one tile ahead
  // of its copies: tile 0's and tile 1's here, tile i + 2's after tile
  // i's P V (its table reads in flight meanwhile)
  if constexpr (Rows::kTable) {
    if (tid < kTile) sl[tid] = p0 + tid < p1 ? slot : -1;
    slot = slot_at(p0 + kTile);
    __syncthreads();                           // tile 0's slots
  }
  load(0, p0);
  cp_async_commit();                           // Q and tile 0
  if constexpr (Rows::kTable) {
    if (tid < kTile) sl[kTile + tid] = slot;
    slot = slot_at(p0 + 2 * kTile);
  }
  cp_async_wait<0>();
  if constexpr (kQ8) widen(0);
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
    const int st = i & 1;
    if (i > 0) {
      cp_async_wait<0>();                      // tile i has landed
      if constexpr (kQ8) widen(st);            // (ring stage st: tile i - 2's)
      __syncthreads();                         // and tile i - 1 is consumed
    }
    if (i + 1 < ntl) {
      load(st ^ 1, p0 + (i + 1) * kTile);
      cp_async_commit();
    }
    const int t0 = p0 + i * kTile, nt = min(kTile, p1 - t0);
    const bf16* kt = ks + st * kTile * R;
    const bf16* vt = vs + st * kTile * R;
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
      const int t = warp * 16 + j * 8 + 2 * tg;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {         // rows gr, gr + 8
        float s0 = s[j][2 * hr] * scale, s1 = s[j][2 * hr + 1] * scale;
        if constexpr (kQ8) {                   // (q . kq) * scale * k_scale
          s0 *= ksc[st * kTile + t];
          s1 *= ksc[st * kTile + t + 1];
        }
        const float2 sc = make_float2(t0 + t < len ? s0 : kMask,
                                      t0 + t + 1 < len ? s1 : kMask);
        *reinterpret_cast<float2*>(ss + (gr + hr * 8) * kSR + t) = sc;
      }
    }
    __syncthreads();
    // per head: the tile's max, p = exp(s - max) summed unrounded and
    // stored rounded to bf16 (int8: times v_scale first; 0 past nt), the
    // running max and sum
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
        if constexpr (kQ8)
          pbf[h * kPR + t] = __float2bfloat16(p * vsc[st * kTile + t]);
        else
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
    if constexpr (Rows::kTable) {
      if (tid < kTile) sl[st * kTile + tid] = slot;    // tile i + 2's
      slot = slot_at(p0 + (i + 3) * kTile);
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
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = gr + hr * 8;
    if (row < nh) {
      float* prow = accb + ((size_t)sp * Hg + h0 + row) * DH + tg * 2;
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
    ml[h0 + tid] = m_s[tid];
    ml[Hg + h0 + tid] = l_s[tid];
  }
  finish_split<bf16>(accb, mlb, Hg, DH, splits, h0, nh,
                     tickets + bg * hgroups + hgi,
                     reinterpret_cast<float*>(smem), out + qbase);
}

template <int DH, typename C, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* k_scale,
                   const void* v, const void* v_scale, const void* kv_len,
                   const Rows& rows, int B, int H, int G, float scale,
                   int splits, int hgroups, int smem, void* part,
                   void* tickets, void* out, cudaStream_t st) {
  auto kernel = decode_tc_kernel<DH, C, Rows>;
  static std::atomic<unsigned> smem_set{0};
  if (smem < smem_bytes<DH, std::is_same<C, int8_t>::value>())
    return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(kernel, smem_set);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(splits, G * hgroups, B), kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(kv_len),
      rows, H, G, scale, splits, hgroups, static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets));
  return cudaGetLastError();
}

}  // namespace tc

// One call of a decode kernel over `rows`. k_scale and v_scale: null for a
// float cache (C = T). `route` 1 takes the tensor cores (kTc: the source
// builds them for this T and C; dh 32, 64, 80, 128 or 256, at most 16
// heads a block), 0 the CUDA cores, whose `stages` (1 or 2) come with
// `smem` from ops.decode_smem_bytes, and whose wide groups (Hb*dh past
// 2 * kMaxPair * kThreads) take kWidePair pairs a thread. `part` and
// `tickets` may be null when splits is 1.
template <typename T, typename C, bool kTc, typename Rows>
int launch_decode(const void* q, const void* k, const void* k_scale,
                  const void* v, const void* v_scale, const void* kv_len,
                  const Rows& rows, int B, int H, int G, int dh, float scale,
                  int splits, int hgroups, int route, int stages, int smem,
                  void* part, void* tickets, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Hg = H / G, Hb = hgroups > 0 ? (Hg + hgroups - 1) / hgroups : 0;
  if (splits < 1 || hgroups < 1 || hgroups > Hg || (hgroups - 1) * Hb >= Hg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if constexpr (kTc && std::is_same<T, __nv_bfloat16>::value) {
      if (Hb > tc::kM) return static_cast<int>(cudaErrorInvalidValue);
      switch (dh) {
#define DECODE_TC(D)                                                         \
  case D:                                                                    \
    return static_cast<int>(tc::launch<D, C>(q, k, k_scale, v, v_scale,      \
                                             kv_len, rows, B, H, G, scale,   \
                                             splits, hgroups, smem, part,    \
                                             tickets, out, st));
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
  launch_split<T, C, P, ST>(q, k, k_scale, v, v_scale, kv_len, rows, B, H, G, \
                            dh, scale, splits, hgroups, smem, part, tickets, \
                            out, st)
  const cudaError_t e =
      stages == 2 ? (wide ? DECODE_SPLIT(kWidePair, 2) : DECODE_SPLIT(kMaxPair, 2))
                  : (wide ? DECODE_SPLIT(kWidePair, 1) : DECODE_SPLIT(kMaxPair, 1));
#undef DECODE_SPLIT
  return static_cast<int>(e);
}

}  // namespace
