// A prompt chunk's attention over its slot's page pool on Hopper.
//
// Replaces no pallas_call: the reference computes this in jnp
// (src/repro/models/dense.py::paged_attn_chunk, `_pool_gather` of the
// slot's pages, then `layers.attention` at :335 and :379), the function of
// src/repro/kernels/flash_prefill.py::flash_prefill (pallas_call at :95)
// over K/V that live in a page pool. A chunk of C queries at absolute
// positions [offset, offset + C) attends, causally and within `window`,
// the keys at positions [lo, offset + C): the history [lo, offset) from
// the pool through the slot's page-table row (position p at ring cursor
// p % ring, on page row[cursor / ps] at offset cursor % ps; a row that
// never wraps is a ring of W * ps), then the chunk's own k, v [C, G, dh].
// In key-buffer positions j = p - lo the queries sit at hist = offset -
// lo and on, and the call computes exactly `flash_prefill` on the
// gathered buffer (causal, window, q_offset hist, kv_len hist + C). An
// int8 pool (values [P, ps, G, dh] and f32 scales [P, ps, G]) is
// attended as `layers.dequantize_kv` gives it: bf16(q * s) in bf16,
// q * s in f32.
//
// Bound on the H100: bytes. Each of the history's rows is read once for
// about 4 * Hg * C * dh operations a kv head, far below the card's 295
// operations a byte in bf16 at a chunk of 32 (h2o's last ring chunk: 4,128
// rows of 8 kv heads at dh 80, 10.6 MB, 3.3 us at 3.35 TB/s).
//
// What it does about the two costs of gathering the history in torch
// first (an index copy of K and V a layer, a dequantized f32 copy for an
// int8 pool, a `cat` with the chunk, then flash_prefill's 64-query tiles
// per head, which at a 32-token chunk is H blocks walking every key tile
// alone, each kv head's tiles read by all Hg of its query heads):
//
// - The kernel reads the rows where they lie. A tile's rows find their
//   slots through the table (a thread a row, two tiles ahead, into a
//   shared ring: the dependent table load is off the copies' path, as in
//   decode_body.cuh), so a tile may span pages, wrap the ring, repeat or
//   reverse pages, and straddle the history / chunk boundary. bf16 rows
//   arrive by 16-byte cp.async into a ring of two stages; an int8 row's
//   bytes by cp.async into a staging tile, widened to dequantize_kv's
//   bf16 values (each thread widens the chunks it copied, with its row's
//   scale loaded beside them) before the tile's barrier. Nothing is
//   written to global memory but the output (and the partials below).
//
// - bf16 q on the tensor cores (`tc`: at dh 32 and 256, and at any dh when
//   forced, the yardstick of the wgmma route that takes dh 64, 80 and 128
//   in csrc/flash_prefill_paged_sm90.cu; `ops.prefill_paged_route`): a
//   block's 64 query rows are (query position, head) pairs of ONE kv
//   group, position-major (row r of the group's Hg * C rows is query
//   r / Hg, head r % Hg), so each K/V
//   tile is read once per group and its row block, not once per head:
//   M = Hg * C rows (128 at h2o, 224 on the main path) in blocks of 64.
//   FlashAttention-2 per warp (16 rows, `mma.sync.m16n8k16` bf16 -> f32,
//   Q's fragments in registers up to dh 128, S's accumulators turned into
//   P's bf16 A-fragments in registers, V by `ldmatrix.trans`, softmax in
//   base 2 by `ex2.approx`, masks only on tiles that hold a masked pair),
//   key tiles of 64 (32 at dh 256, whose O takes 128 registers a thread).
//   The grid is (splits, row blocks, G): the host plans the splits from
//   shapes it knows exactly (`ops.prefill_paged_plan`: C, hist, G, Hg, dh,
//   window), so that a long history fills the 132 SMs (h2o's last ring
//   chunk: 8 splits x 2 row blocks x 8 kv heads) and a short one takes
//   one split. Split s walks the key tiles [s*T/splits, (s+1)*T/splits)
//   of the call's T tiles and writes a partial (unnormalised acc [64, dh],
//   max and sum in base 2, f32); the last split block of each (kv head,
//   row block) takes its ticket and merges in split order (ops.tickets,
//   ops._split_scratch: decode_split.cuh's scheme, one launch a call).
//   Every split holds keys of every row's range or none that its rows
//   attend; a row whose keys are all masked within a split gets weight 0
//   in the merge (its own key, in the chunk, is in the last split). The
//   rows' source, the int8 widening and the merge are those of
//   csrc/prefill_paged.cuh, shared with the wgmma route.
//
// - f32 q on the CUDA cores (`cuda`, the 1e-5 check): flash_prefill's f32
//   body (csrc/prefill_f32.cuh), one split, its key tiles of 32 over the
//   same buffer positions, each row read through the table (int8: q * s
//   in f32): the same sums in the same order as flash_prefill on the
//   gathered buffer, bit for bit.
#include <type_traits>

#include "decode_split.cuh"
#include "prefill_f32.cuh"
#include "prefill_paged.cuh"

namespace {

// ------------------------------------------------- f32 on the CUDA cores

// the chunk's keys for the f32 body: the history through the table from a
// float pool (C = float) or an int8 one with its scales (C = int8_t),
// then the chunk's rows
template <typename C> struct PagedKV {
  const float* k;                              // the chunk's [C, G, dh]
  const float* v;
  const C* kp;                                 // the pool [P, ps, G, dh]
  const C* vp;
  const float* ksc;                            // [P, ps, G] (int8)
  const float* vsc;
  Hist hs;
  int G, dh;
  __device__ void load(int, int g, int j, int c, float4& kv,
                       float4& vv) const {
    if (j >= hs.hist) {
      const size_t off = ((size_t)(j - hs.hist) * G + g) * dh + c;
      kv = *reinterpret_cast<const float4*>(k + off);
      vv = *reinterpret_cast<const float4*>(v + off);
      return;
    }
    const size_t o = hs.slot(j) * G + g, off = o * dh + c;
    if constexpr (std::is_same<C, int8_t>::value) {
      const char4 a = *reinterpret_cast<const char4*>(kp + off);
      const char4 b = *reinterpret_cast<const char4*>(vp + off);
      const float s = ksc[o], t = vsc[o];      // dequantize_kv: q * s in f32
      kv = make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s),
                       __fmul_rn(a.z, s), __fmul_rn(a.w, s));
      vv = make_float4(__fmul_rn(b.x, t), __fmul_rn(b.y, t),
                       __fmul_rn(b.z, t), __fmul_rn(b.w, t));
    } else {
      kv = *reinterpret_cast<const float4*>(kp + off);
      vv = *reinterpret_cast<const float4*>(vp + off);
    }
  }
};

// ------------------------------------------- bf16 on the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;                  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;             // query rows a block
constexpr int kBK = 64;                        // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

// the tile at a head dim: at dh 256 the O accumulator alone takes 128
// registers a thread, so key tiles of 32 and Q's fragments re-read from
// shared memory at each k-step
template <int DH> struct Tile {
  static constexpr int BK = DH > 128 ? kBK / 2 : kBK;
  static constexpr int NT = BK / 8;            // 8-key tiles of S
  static constexpr bool QREG = DH <= 128;
};

// Shared memory of a block (the merge reuses it from the start, and the
// launch takes the larger of the two): Q [kRows][dh + 8] and the K and V
// rings [2][BK][dh + 8] in bf16, the slots of two tiles' rows [2][BK]
// (8 bytes each), and over an int8 pool its staging tiles [BK][dh] int8
// for K and V.
template <int DH, bool Q8> constexpr int smem_bytes() {
  return (kRows + 4 * Tile<DH>::BK) * (DH + 8) * 2 + 2 * Tile<DH>::BK * 8 +
         (Q8 ? 2 * Tile<DH>::BK * DH : 0);
}

// Grid (splits, row blocks, G). P: the pool's type (bf16, or int8 with
// f32 scales ksc, vsc). Split sp walks the key tiles [t0, t1) of the
// call's `ntiles` tiles of BK keys from kbeg (every split holds at least
// one: splits <= ntiles).
template <int DH, typename P>
__global__ void __launch_bounds__(kThreads)
paged_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                const bf16* __restrict__ vc, const P* __restrict__ kp,
                const float* __restrict__ ksc, const P* __restrict__ vp,
                const float* __restrict__ vsc, Hist hs, int C, int H, int G,
                int window, float scale2, int kbeg, int ntiles, int splits,
                bf16* __restrict__ out, float* __restrict__ part,
                int* __restrict__ tickets) {
  constexpr bool kQ8 = std::is_same<P, int8_t>::value;
  constexpr int BK = Tile<DH>::BK, kNT = Tile<DH>::NT;
  constexpr bool QREG = Tile<DH>::QREG;
  constexpr int R = DH + 8;                    // padded shared row
  constexpr int CPR = DH / 8;                  // 16-byte chunks of a bf16 row
  constexpr int CPR8 = DH / 16;                // 16-byte chunks of an int8 row
  constexpr int CH8 = (BK * CPR8 + kThreads - 1) / kThreads;  // a thread's
  constexpr int KS = DH / 16;                  // k-steps of Q K^T
  constexpr int NT = DH / 8;                   // 8-column tiles of O
  constexpr int TILE = BK * R;
  static_assert(DH % 16 == 0 && DH <= 256, "dh: a multiple of 16, <= 256");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);    // [kRows][R]
  bf16* ks = qs + kRows * R;                   // [2][BK][R]
  bf16* vs = ks + 2 * TILE;                    // [2][BK][R]
  long long* sl = reinterpret_cast<long long*>(vs + 2 * TILE);  // [2][BK]
  int8_t* k8 = reinterpret_cast<int8_t*>(sl + 2 * BK);  // [BK][DH] (int8)
  int8_t* v8 = k8 + BK * DH;                   // [BK][DH] (int8)
  const int sp = blockIdx.x, rb = blockIdx.y, g = blockIdx.z;
  const int Hg = H / G, M = Hg * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int r0 = rb * kRows;                   // the block's first row
  const int kend = hs.hist + C;
  // this split's key positions [p0, p1)
  const int t0 = (int)((long long)sp * ntiles / splits);
  const int t1 = (int)((long long)(sp + 1) * ntiles / splits);
  const int p0 = kbeg + t0 * BK, p1 = min(kend, kbeg + t1 * BK);
  const int ntl = t1 - t0;
  // buffer positions of the block's first and last queries, and of this
  // thread's rows (row0 and row0 + 8 of the group's)
  const int qlo = hs.hist + r0 / Hg;
  const int qhi = hs.hist + (min(M, r0 + kRows) - 1) / Hg;
  const int row0 = r0 + warp * 16 + gr;
  const int qp[2] = {hs.hist + row0 / Hg, hs.hist + (row0 + 8) / Hg};
  // Where the key at position j of this split lies, as a row code: a pool
  // slot (>= 0), the chunk's row r (-2 - r), or none (-1: past p1)
  auto code_at = [&](int j) -> long long {
    if (j >= p1) return -1;
    if (j < hs.hist) return (long long)hs.slot(j);
    return -2 - (long long)(j - hs.hist);
  };
  // The tile whose row codes are in ring stage `stage` (sl) into that
  // stage: thread tid copies the 16-byte chunks tid, tid + kThreads, ...
  // of the tile's rows in order; over an int8 pool a pool row's chunks go
  // to the staging tiles and the thread keeps their rows' scales (the
  // chunks it copies are the ones it widens: no barrier between).
  float ksr[CH8], vsr[CH8];
  auto load = [&](int stage) {
    const long long* code = sl + stage * BK;
    bf16* kd = ks + stage * TILE;
    bf16* vd = vs + stage * TILE;
    for (int c = tid; c < BK * CPR; c += kThreads) {
      const int t = c / CPR, col = (c % CPR) * 8;
      const long long s = code[t];
      if (kQ8 && s >= 0) continue;             // widened from staging
      const bf16 *ksrc, *vsrc;
      if (s >= 0) {
        const size_t off = ((size_t)s * G + g) * DH + col;
        ksrc = reinterpret_cast<const bf16*>(kp) + off;
        vsrc = reinterpret_cast<const bf16*>(vp) + off;
      } else {
        const size_t off =
            ((s < -1 ? (size_t)(-2 - s) : 0) * G + g) * DH + col;
        ksrc = kc + off;
        vsrc = vc + off;
      }
      cp_async16(smem_u32(kd + t * R + col), ksrc, s != -1);
      cp_async16(smem_u32(vd + t * R + col), vsrc, s != -1);
    }
    if constexpr (kQ8) {
#pragma unroll
      for (int j = 0; j < CH8; ++j) {
        const int c = tid + j * kThreads;
        if (c < BK * CPR8) {
          const int t = c / CPR8, col = (c % CPR8) * 16;
          const long long s = code[t];
          if (s >= 0) {
            const size_t o = (size_t)s * G + g;
            cp_async16(smem_u32(k8 + t * DH + col), kp + o * DH + col);
            cp_async16(smem_u32(v8 + t * DH + col), vp + o * DH + col);
            ksr[j] = __ldg(ksc + o);
            vsr[j] = __ldg(vsc + o);
          }
        }
      }
    }
  };
  // this thread's int8 chunks of the staged tile, widened into ring stage
  // `stage` (after its own copies have landed)
  auto widen = [&](int stage) {
#pragma unroll
    for (int j = 0; j < CH8; ++j) {
      const int c = tid + j * kThreads;
      if (c < BK * CPR8) {
        const int t = c / CPR8, col = (c % CPR8) * 16;
        if (sl[stage * BK + t] >= 0) {
          const size_t d = (size_t)(stage * BK + t) * R + col;
          uint4* kd = reinterpret_cast<uint4*>(ks + d);
          uint4* vd = reinterpret_cast<uint4*>(vs + d);
          widen16(*reinterpret_cast<const uint4*>(k8 + t * DH + col), ksr[j],
                  kd[0], kd[1]);
          widen16(*reinterpret_cast<const uint4*>(v8 + t * DH + col), vsr[j],
                  vd[0], vd[1]);
        }
      }
    }
  };
  // the row codes of a tile go to the ring sl one tile ahead of its
  // copies: tile 0's and tile 1's here, tile i + 2's after tile i's P V
  long long code = tid < BK ? code_at(p0 + tid) : -1;
  if (tid < BK) sl[tid] = code;
  code = tid < BK ? code_at(p0 + BK + tid) : -1;
  // Q's rows past the group's M are zero-filled
  for (int c = tid; c < kRows * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int Rg = r0 + r;
    const bool in = Rg < M;
    cp_async16(smem_u32(qs + r * R + col),
               q + (in ? ((size_t)(Rg / Hg) * H + (size_t)g * Hg + Rg % Hg) *
                             DH
                       : 0) + col,
               in);
  }
  __syncthreads();                             // tile 0's codes
  load(0);
  cp_async_commit();                           // Q and tile 0
  if (tid < BK) sl[BK + tid] = code;
  code = tid < BK ? code_at(p0 + 2 * BK + tid) : -1;
  cp_async_wait<0>();
  if constexpr (kQ8) widen(0);
  __syncthreads();
  // this warp's A-fragment of Q at k-step kk
  auto q_frag = [&](uint32_t (&r)[4], int kk) {
    ldmatrix_x4(r, smem_u32(qs + (warp * 16 + (lane & 15)) * R + kk * 16 +
                            (lane >> 4) * 8));
  };
  uint32_t qf[QREG ? KS : 1][4];               // this warp's rows of Q
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) q_frag(qf[kk], kk);
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};   // rows gr, gr + 8

  for (int i = 0; i < ntl; ++i) {
    const int st = i & 1;
    if (i > 0) {
      cp_async_wait<0>();                      // tile i has landed
      if constexpr (kQ8) widen(st);
      __syncthreads();                         // and tile i - 1 is consumed
    }
    if (i + 1 < ntl) {
      load(st ^ 1);
      cp_async_commit();
    }
    const int k0 = p0 + i * BK;
    const bf16* kt = ks + st * TILE;
    const bf16* vt = vs + st * TILE;
    float s[kNT][4];                           // S: tiles of 8 keys
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        q_frag(qa, kk);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t r[4];                         // keys 16np.., dims 16kk..
        ldmatrix_x4(r, smem_u32(kt + (np * 16 + (lane & 7) +
                                      ((lane >> 4) << 3)) * R +
                                kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qa, r[0], r[1]);
        mma_bf16(s[2 * np + 1], qa, r[2], r[3]);
      }
    }
    // does this tile hold a masked (query, key) pair of the block?
    const bool masked = k0 + BK > kend || k0 + BK - 1 > qlo ||
                        (window > 0 && k0 <= qhi - window);
    uint32_t pa[kNT / 2][4];                   // P as A-fragments, bf16
    float mx[2] = {kMask, kMask};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (masked) {
          const int kp_ = k0 + j * 8 + tg * 2 + (e & 1);
          const int qq = qp[e >> 1];
          const bool ok = kp_ < kend && kp_ <= qq &&
                          (window <= 0 || qq - kp_ < window);
          x = ok ? x : kMask;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {              // the 4 lanes of a row agree
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      corr[r] = ex2(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(s[j][e] - m[e >> 1]);
        if (masked && k0 + j * 8 + tg * 2 + (e & 1) >= kend) p[e] = 0.f;
        l[e >> 1] += p[e];                     // unrounded
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t r[4];                         // keys 16kk.., dims 16dp..
        ldmatrix_x4_trans(r, smem_u32(vt + (kk * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) * R +
                                      dp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dp], pa[kk], r[0], r[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], r[2], r[3]);
      }
    }
    if (tid < BK) sl[st * BK + tid] = code;    // tile i + 2's
    code = tid < BK ? code_at(p0 + (i + 3) * BK + tid) : -1;
  }
  float lr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lr[r] = l[r];
    lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 1);
    lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 2);
  }
  if (splits == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int Rg = row0 + r * 8;
      if (Rg < M) {
        const float den = fmaxf(lr[r], 1e-30f);
        bf16* orow = out_row(out, Rg, Hg, H, g, DH) + tg * 2;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(o[n][2 * r] / den, o[n][2 * r + 1] / den);
      }
    }
    return;
  }
  // the partial of (g, rb, sp): acc [kRows, DH], then m and l [kRows] each
  const size_t pair = (size_t)g * gridDim.y + rb;
  const size_t pairs = (size_t)gridDim.z * gridDim.y;
  float* accb = part + pair * splits * kRows * DH;
  float* mlb = part + pairs * splits * kRows * DH + pair * splits * 2 * kRows;
  float* pa_ = accb + (size_t)sp * kRows * DH;
  float* ml = mlb + (size_t)sp * 2 * kRows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = warp * 16 + gr + r * 8;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(pa_ + (size_t)rr * DH + n * 8 + tg * 2) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
    if (tg == 0) {
      ml[rr] = m[r];
      ml[kRows + rr] = lr[r];
    }
  }
  // publish the partial, take the ticket; the last split block merges
  if (!last_split(tickets + pair, splits)) return;
  merge_rows<DH, kRows, kThreads>(accb, mlb, splits, r0, min(kRows, M - r0),
                                  Hg, H, g, reinterpret_cast<float*>(smem),
                                  out);
}

// kbeg, ntiles, rblocks, splits: ops.prefill_paged_plan's (checked here,
// not recomputed: the plan is the one place they are worked out)
template <int DH, typename P>
int launch(const void* q, const void* k, const void* v, const void* kp,
           const void* ksc, const void* vp, const void* vsc, const Hist& hs,
           int C, int H, int G, int window, float scale, int kbeg,
           int ntiles, int rblocks, int splits, void* part, void* tickets,
           void* out, cudaStream_t st) {
  constexpr int BK = Tile<DH>::BK;
  constexpr bool kQ8 = std::is_same<P, int8_t>::value;
  const int kend = hs.hist + C, M = H / G * C;
  const int smem = max(smem_bytes<DH, kQ8>(), merge_floats(splits, kRows) * 4);
  if (kbeg < 0 || kbeg % BK || kbeg >= kend || kbeg + ntiles * BK < kend ||
      kbeg + (ntiles - 1) * BK >= kend || rblocks * kRows < M ||
      (rblocks - 1) * kRows >= M || splits < 1 || splits > ntiles ||
      smem > 227 * 1024 ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_tc_kernel<DH, P>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t e = allow_smem(kernel, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(splits, rblocks, G), kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const P*>(kp),
      static_cast<const float*>(ksc), static_cast<const P*>(vp),
      static_cast<const float*>(vsc), hs, C, H, G, window, scale * kLog2e,
      kbeg, ntiles, splits, static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Both entries: q [1, C, H, dh]; k, v [C, G, dh] the chunk's keys in q's
// type; kp, vp one layer's pool [P, ps, G, dh] in q's type, or int8 with
// ksc, vsc [P, ps, G] f32 (null for a float pool); row [W] the slot's
// page-table row; ring the slot's ring (W * ps without a window); lo the
// history's first position, hist = offset - lo its length; window 0 for
// none. out [1, C, H, dh].
//
// bf16 q on the tensor cores at ops.prefill_paged_plan's plan: `ntiles`
// key tiles from key-buffer position kbeg in `splits` splits, `rblocks`
// row blocks (part, tickets: ops._split_scratch, null with one split)
extern "C" int flash_prefill_paged_bf16(
    const void* q, const void* k, const void* v, const void* kp,
    const void* ksc, const void* vp, const void* vsc, const void* row, int C,
    int H, int G, int dh, int ps, int ring, int lo, int hist, int window,
    float scale, int kbeg, int ntiles, int rblocks, int splits, void* part,
    void* tickets, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hist hs{static_cast<const int*>(row), ps, ring, lo, hist};
  const bool q8 = ksc != nullptr;
  switch (dh) {
#define PAGED_TC(D)                                                          \
  case D:                                                                    \
    return q8 ? tc::launch<D, int8_t>(q, k, v, kp, ksc, vp, vsc, hs, C, H,   \
                                      G, window, scale, kbeg, ntiles,        \
                                      rblocks, splits, part, tickets, out,   \
                                      st)                                    \
              : tc::launch<D, __nv_bfloat16>(q, k, v, kp, ksc, vp, vsc, hs,  \
                                             C, H, G, window, scale, kbeg,   \
                                             ntiles, rblocks, splits, part,  \
                                             tickets, out, st);
    PAGED_TC(32) PAGED_TC(64) PAGED_TC(80) PAGED_TC(128) PAGED_TC(256)
#undef PAGED_TC
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f32 q on the CUDA cores: one split, flash_prefill's
// f32 body through the table
extern "C" int flash_prefill_paged_f32(
    const void* q, const void* k, const void* v, const void* kp,
    const void* ksc, const void* vp, const void* vsc, const void* row, int C,
    int H, int G, int dh, int ps, int ring, int lo, int hist, int window,
    float scale, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hist hs{static_cast<const int*>(row), ps, ring, lo, hist};
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* kscf = static_cast<const float*>(ksc);
  const float* vscf = static_cast<const float*>(vsc);
  const int Sk = hist + C;
  if (ksc != nullptr)
    return launch_f32(static_cast<const float*>(q),
                      PagedKV<int8_t>{kf, vf, static_cast<const int8_t*>(kp),
                                      static_cast<const int8_t*>(vp), kscf,
                                      vscf, hs, G, dh},
                      1, C, Sk, H, G, dh, 1, window, hist, Sk, scale,
                      static_cast<float*>(out), st);
  return launch_f32(static_cast<const float*>(q),
                    PagedKV<float>{kf, vf, static_cast<const float*>(kp),
                                   static_cast<const float*>(vp), kscf, vscf,
                                   hs, G, dh},
                    1, C, Sk, H, G, dh, 1, window, hist, Sk, scale,
                    static_cast<float*>(out), st);
}
