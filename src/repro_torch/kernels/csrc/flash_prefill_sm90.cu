// bf16 flash attention for prefill on Hopper's own units: `wgmma` fed by
// TMA from a producer warp, consumer warpgroups whose exponentials overlap
// each other's products.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_prefill.py::flash_prefill (pallas_call at :95)
// on flash_prefill's "wgmma" route: bf16 at dh 64, 80, 128 and 256
// (`ops.prefill_route`). What it computes is the contract of
// csrc/flash_prefill.cu's header, unchanged: q [B, Sq, H, dh], k/v
// [B, Sk, G, dh], query head h on kv head h / (H/G), query i at
// position q_offset + i, keys at positions >= kv_len masked, the causal
// and window masks with -1e30 (finite) as the masked score, scores summed
// in f32 and the softmax taken in base 2 on scale * log2(e), P rounded to
// bf16 only as the PV operand while l sums the unrounded probabilities,
// the output acc / max(l, 1e-30), and a row whose every key is masked
// gets the uniform average over all Sk keys (its block walks every key).
//
// What bounds it: one unmasked (query, key) pair costs 4 * dh flops on
// the tensor cores and one exponential on the MUFU. An H100 SM does
// about 4,096 dense bf16 flops a clock (16 pairs at dh 64, 12.8 at dh
// 80, 8 at dh 128, 4 at dh 256) and 16 `ex2` a clock. So at dh 64 the
// exponentials alone take as long as the two products, at dh 80 0.8 of
// it, at dh 128 half as long and at dh 256 a quarter: a warp that runs
// Q K^T, the softmax and P V one after the other, as the `tc` route's
// warps do (mma.sync, csrc/flash_prefill.cu), cannot pass about half of
// the bound at dh 64 even with perfect products.
//
// The design: one block per (64 x NC query rows, head, batch), the late
// (heavy, causal) query tiles issued first.
// - Warpgroup 0 is the producer: after `setmaxnreg` gives its registers
//   away, one thread loads Q once and then each key tile's K and V by TMA
//   (4-d tensor maps over [B, S, heads, dh] encoded on the host per call,
//   0.3-0.4 us for the three, passed as __grid_constant__ parameters and
//   prefetched) into a ring of ST stages with the 128-byte swizzle (a
//   dh-64 row is one 128-byte atom, a dh-128 row two, a dh-256 row four,
//   stored as column chunks [dh / 64][rows][64]). A dh-80 row (160
//   bytes) fits no atom: it is padded to two, 128 columns, in shared
//   memory only; the maps keep dh 80 as their extent, so TMA's
//   out-of-bounds fill writes the zeros and no byte more is read (as in
//   csrc/flash_prefill_paged_sm90.cu). K and V of a stage have their own
//   full and empty mbarriers, so that a tile's K can land while the
//   previous tile's V is still read. Rows past Sq or Sk come in as zeros.
// - Warpgroups 1..NC are consumers of 64 query rows each, with the
//   registers the producer gave up. Each runs S = Q K^T as
//   `wgmma.mma_async` m64nBKk16 with Q and K from shared memory (both
//   K-major; dh / 16 k-steps, 5 at dh 80), the online softmax on S's f32
//   accumulator in registers, and O += P V as `wgmma` m64n(dh)k16 (n80
//   at dh 80: V's first 64-column chunk and 16 columns of the second, not
//   the padded n128) with P from registers (S's
//   accumulator fragments rounded to bf16 are the A-fragments) and V from
//   shared memory as an MN-major B operand (the descriptor's transpose
//   bit). Within a warpgroup, tile j's Q K^T is issued together with tile
//   j-1's P V, so tile j's softmax runs while P V still does.
// - The MUFU and the tensor cores overlap across warpgroups: with NC 2
//   the consumers take turns issuing their products on named barriers
//   (`bar.sync` / `bar.arrive`, ids 1..NC: ping-pong), so one's
//   exponentials run while the other's products do; with NC 1 and two
//   blocks an SM, the two blocks' consumers overlap with no turns to
//   take. At dh 64 the second is faster (8.1-8.5 ms against 8.9-9.0 at
//   the prefill_32k share), at dh 128 the first (0.70 ms against 0.94-0.98
//   at 2 x 8,192 rows): there O's 64 registers a thread leave room for one
//   block an SM only (attention_probe --prefill, PERF.md). A share of the
//   exponentials on the FMA pipe (a cubic) moved neither, so it is not
//   kept: the MUFU no longer sets the pace once they overlap. dh 80 takes
//   dh 128's way, its rows padded to dh 128's shared bytes: 0.282 ms at
//   h2o's wave row against 0.359 for dh 64's way at 64-key tiles, whose
//   83,200 bytes fit twice an SM. dh 256 has one consumer and one block
//   an SM (Q 32 KB and two stages of 32 KB K and V tiles, 165,120 bytes;
//   O 128 registers a thread): at 1,024 flops a pair the products set
//   the pace.
// - Masks as on the `tc` route: only the key tiles that causal, window and
//   kv_len leave partly unmasked for the block (`key_range`), the mask
//   applied only on tiles that hold a masked pair of the warpgroup's rows;
//   keys past Sk weigh 0. A row's sums depend only on the key tiles, not
//   on the block or warpgroup that holds it.
// The plan (DH, BK keys a tile, ST stages, NC consumers, NB blocks an SM)
// is the wrapper's pick (`ops.prefill_plan`, which also gives the shared
// bytes) among those compiled below (FLASH_WGMMA_PLAN).
#include "mma.cuh"
#include "prefill_keys.cuh"
#include "sm90.cuh"

namespace {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kProducerRegs = 24;              // setmaxnreg of the producer
constexpr float kLog2e = 1.4426950408889634f;

// a plan: DH, BK keys a tile, a ring of ST stages, NC consumer warpgroups
// of 64 query rows after the producer warpgroup, NB blocks an SM. Its
// registers: ptxas gives each thread L at launch (65,536 over the NB
// blocks' threads); `setmaxnreg` takes the producer down to 24 and
// gives what that frees to the consumers (240 at most): 168 -> 240 for
// 2 consumers and 1 block, 128 -> 232 for 1 and 2 blocks, 80 -> 136 for
// 1 and 3, 240 for 1 and 1. Shared memory: 1 KB to align the tiles to
// the swizzle's 1,024-byte period, Q [DHP / 64][rows][64], the K and V
// rings [ST][DHP / 64][BK][64] each (DHP: dh padded to the 64-column
// atoms, 128 at dh 80), then 256 bytes of mbarriers.
template <int DH, int BK, int ST, int NC, int NB> struct Plan {
  static constexpr int DHP = (DH + 63) / 64 * 64;
  static constexpr int ROWS = 64 * NC;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int L = 65536 / (THREADS * NB) / 8 * 8;
  static constexpr int CONSUMER_REGS =
      (L + (L - kProducerRegs) / NC) / 8 * 8 < 240
          ? (L + (L - kProducerRegs) / NC) / 8 * 8
          : 240;
  static constexpr int Q_CHUNK = ROWS * kAtom;
  static constexpr int Q_BYTES = ROWS * DHP * 2;
  static constexpr int KV_BYTES = BK * DHP * 2;  // one K (or V) tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * ST * KV_BYTES + 256;
  static_assert(DH % 16 == 0 && BK % 16 == 0, "dh 16k, keys 16k");
  static_assert(NB * (SMEM + 1024) <= 233472, "the plan's blocks pass 228 KB");
};

struct Args {
  int Sq, Sk, H, G, causal, window, q_offset, kv_len;
  float scale;
};

template <int DH, int BK, int ST, int NC, int NB>
__global__ void __launch_bounds__(Plan<DH, BK, ST, NC, NB>::THREADS, NB)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const Args a, bf16* __restrict__ out) {
  using P = Plan<DH, BK, ST, NC, NB>;
  constexpr int ROWS = P::ROWS;
  constexpr int CH = P::DHP / 64;              // 128-byte chunks of a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + P::Q_BYTES;       // [ST][CH][BK][64]
  const uint32_t v_s = k_s + ST * P::KV_BYTES;
  const uint32_t bars = v_s + ST * P::KV_BYTES;
  const uint32_t qfull = bars;
  auto kfull = [&](int s) { return bars + 8 * (1 + s); };
  auto vfull = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto kempty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  auto vempty = [&](int s) { return bars + 8 * (1 + 3 * ST + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, g = h / (a.H / a.G);
  int kbeg, kend;
  key_range(a.q_offset + q0, a.q_offset + min(q0 + ROWS, a.Sq) - 1, a.Sk,
            a.causal, a.window, a.kv_len, BK, kbeg, kend);
  const int n = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    mbar_init(qfull, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(vfull(s), 1);
      mbar_init(kempty(s), 4 * NC);            // every consumer warp
      mbar_init(vempty(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qfull, P::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        tma_load(q_s + c * P::Q_CHUNK, &qmap, qfull, c * 64, h, q0, b);
      // tile t's K and V into stage t % ST once the consumers released
      // the stage's last tile; K runs a tile ahead of V, as the consumers
      // take them (tile t's scores before tile t - 1's values)
      auto load = [&](int t, bool is_k) {
        const int s = t % ST;
        const uint32_t full = is_k ? kfull(s) : vfull(s);
        const uint32_t dst = (is_k ? k_s : v_s) + s * P::KV_BYTES;
        mbar_wait(is_k ? kempty(s) : vempty(s), ((t / ST) & 1) ^ 1);
        mbar_expect_tx(full, P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load(dst + c * BK * kAtom, is_k ? &kmap : &vmap, full, c * 64,
                   g, kbeg + t * BK, b);
      };
      if (n > 0) load(0, true);
      for (int t = 0; t < n; ++t) {
        if (t + 1 < n) load(t + 1, true);
        load(t, false);
      }
    }
  } else {
    // ------------------------------------------------ consumers
    setmaxnreg_inc<P::CONSUMER_REGS>();
    const int wg = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, gr = lane / 4, tg = lane % 4;
    const int r0 = q0 + 64 * wg;               // this warpgroup's first row
    const int wlo = a.q_offset + r0;
    const int whi = a.q_offset + min(r0 + 64, a.Sq) - 1;
    const int qp = wlo + 16 * warp + gr;       // rows qp and qp + 8
    const float scale2 = a.scale * kLog2e;     // softmax in base 2
    const uint32_t qa = q_s + wg * 64 * kAtom; // its 64 rows of Q
    // s[4j + e] and o[4j + e]: row qp + 8 (e >> 1), column 8j + 2tg + (e & 1)
    float o[DH / 2], s[BK / 2], m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    auto qk = [&](float (&d)[BK / 2], int st) {  // d = Q K^T of stage st
      const uint32_t kst = k_s + st * P::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BK>(d, smem_desc(qa + c * P::Q_CHUNK + off, 16),
                     smem_desc(kst + c * BK * kAtom + off, 16), kk > 0);
      }
    };
    auto pv = [&](int st) {                    // O += P V of stage st
      const uint32_t vst = v_s + st * P::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DH>(o, p[kk], smem_desc(vst + kk * 16 * kAtom, BK * kAtom));
    };
    auto to_p = [&](const float (&pr)[BK / 2]) {  // probabilities as bf16
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[kk][e] = pack_bf16(pr[8 * kk + 2 * e], pr[8 * kk + 2 * e + 1]);
    };
    // the online softmax of the tile at k0 in place: s becomes its
    // probabilities under the new running max; corr rescales the old O.
    // A masked tile computes what an unmasked one does for its unmasked
    // pairs (max of the raw scores times scale2, ex2 of s * scale2 - m as
    // one fma), so a row's sums do not depend on which block holds it;
    // a masked pair scores -1e30. Maxima and sums run in 4 chains a row
    // (i's bits 0 and 2): the warp, alone on its scheduler while the
    // others' products run, would wait out one long chain of adds.
    auto softmax = [&](float (&s)[BK / 2], int k0, float (&corr)[2]) {
      const bool masked = k0 + BK > a.kv_len ||
                          (a.causal && k0 + BK - 1 > wlo) ||
                          (a.window > 0 && k0 <= whi - a.window);
      float mx[2][4], sum[2][4], nm[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          mx[r][c] = -inf_f();
          sum[r][c] = 0.f;
        }
      if (masked) {                            // masked pairs to -inf here
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kp = k0 + 8 * (i / 4) + 2 * tg + (i & 1);
          const int qr = qp + 8 * ((i >> 1) & 1);
          const bool ok = kp < a.kv_len && (!a.causal || kp <= qr) &&
                          (a.window <= 0 || qr - kp < a.window);
          s[i] = ok ? s[i] : -inf_f();
        }
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1, c = (i & 1) | ((i >> 1) & 2);
        mx[r][c] = fmaxf(mx[r][c], s[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {            // the 4 lanes of a row agree
        float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        x = fmaxf(x * scale2, kMask);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float mn = fmaxf(m[r], x);
        corr[r] = ex2(m[r] - mn);
        m[r] = mn;
        nm[r] = -mn;
      }
      if (masked) {
        // a masked pair weighs ex2(-1e30 - m): 0, or 1 in a row whose
        // keys so far are all masked (the uniform average); keys past Sk 0
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = (i >> 1) & 1, c = (i & 1) | ((i >> 1) & 2);
          const int kp = k0 + 8 * (i / 4) + 2 * tg + (i & 1);
          const float x = s[i] == -inf_f() ? kMask + nm[r]
                                           : fmaf(s[i], scale2, nm[r]);
          s[i] = kp < a.Sk ? ex2(x) : 0.f;
          sum[r][c] += s[i];                   // unrounded
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = (i >> 1) & 1, c = (i & 1) | ((i >> 1) & 2);
          s[i] = ex2(fmaf(s[i], scale2, nm[r]));
          sum[r][c] += s[i];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * corr[r] +
               ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
    };

    mbar_wait(qfull, 0);
    if (n > 0) {
      // the consumers take turns issuing their products, warpgroup 0
      // first: each issue waits on its own barrier and ends with an arrive
      // on the next one's, but the last warpgroup's last, which would have
      // no taker (its first arrive, before any issue, starts warpgroup 0)
      // (one consumer alone takes no turns)
      const int mine = 1 + wg, next = 1 + (wg + 1) % NC;
      const bool last_wg = wg == NC - 1;
      constexpr bool turns = NC > 1;
      auto turn = [&] {
        if (turns) bar_sync(mine);
      };
      auto pass = [&](bool last) {
        if (turns && !(last && last_wg)) bar_arrive(next);
      };
      float corr[2];
      // O to the new maxima, skipped by a warp where no row of its 16 got
      // a new maximum (every factor exactly 1)
      auto rescale = [&] {
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        }
      };
      if (turns && last_wg) bar_arrive(1);
      // tile j's Q K^T goes out with tile j - 1's P V
      mbar_wait(kfull(0), 0);
      turn();
      wgmma_fence();
      qk(s, 0);
      wgmma_commit();
      pass(false);
      wgmma_wait<0>();
      fence_regs(s);
      release(kempty(0));
      softmax(s, kbeg, corr);
      for (int j = 1; j < n; ++j) {
        const int st = j % ST, pst = (j - 1) % ST;
        mbar_wait(kfull(st), (j / ST) & 1);
        mbar_wait(vfull(pst), ((j - 1) / ST) & 1);
        to_p(s);
        turn();
        wgmma_fence();
        qk(s, st);                             // tile j's scores
        wgmma_commit();
        pv(pst);                               // tile j - 1's values
        wgmma_commit();
        pass(false);
        wgmma_wait<1>();
        fence_regs(s);
        release(kempty(st));
        softmax(s, kbeg + j * BK, corr);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        release(vempty(pst));
        rescale();
      }
      to_p(s);
      const int pst = (n - 1) % ST;
      mbar_wait(vfull(pst), ((n - 1) / ST) & 1);
      turn();
      wgmma_fence();
      pv(pst);
      wgmma_commit();
      pass(true);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(vempty(pst));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = r0 + 16 * warp + gr + 8 * r;
      if (row < a.Sq) {
        const float den = fmaxf(lr, 1e-30f);
        bf16* orow = out + (((size_t)b * a.Sq + row) * a.H + h) * DH + 2 * tg;
#pragma unroll
        for (int c = 0; c < DH / 8; ++c)
          *reinterpret_cast<uint32_t*>(orow + 8 * c) =
              pack_bf16(o[4 * c + 2 * r] / den, o[4 * c + 2 * r + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------- host

// the bf16 tensor [B, S, heads, dh] as a 4-d map (dh innermost) of tiles
// [1][rows][1][64] with the 128-byte swizzle; out of bounds reads zeros
int encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int dh,
           int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)S * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

struct Maps {
  CUtensorMap q, k, v;
};

// the three maps of a call; with no key (Sk 0) k and v are mapped on q,
// a map the kernel then never reads
int encode_maps(Maps& m, const void* q, const void* k, const void* v, int B,
                int Sq, int Sk, int H, int G, int dh, int rows, int keys) {
  if (Sk == 0) {
    k = v = q;
    Sk = Sq;
    G = H;
  }
  int err = encode(&m.q, q, B, Sq, H, dh, rows);
  if (!err) err = encode(&m.k, k, B, Sk, G, dh, keys);
  if (!err) err = encode(&m.v, v, B, Sk, G, dh, keys);
  return err;
}

template <int DH, int BK, int ST, int NC, int NB>
int launch(const void* q, const void* k, const void* v, int B, const Args& a,
           int smem, void* out, cudaStream_t stream) {
  using P = Plan<DH, BK, ST, NC, NB>;
  if (smem != P::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  Maps m;
  const int err =
      encode_maps(m, q, k, v, B, a.Sq, a.Sk, a.H, a.G, DH, P::ROWS, BK);
  if (err) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_wgmma_kernel<DH, BK, ST, NC, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Sq + P::ROWS - 1) / P::ROWS, a.H, B);
  flash_prefill_wgmma_kernel<DH, BK, ST, NC, NB>
      <<<grid, P::THREADS, P::SMEM, stream>>>(m.q, m.k, m.v, a,
                                               static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace

// bf16 flash_prefill on the wgmma route at the plan (dh, keys, stages,
// consumers, blocks an SM), whose shared memory the caller states
// (`ops.prefill_plan`): a plan not compiled here, or bytes that are not
// its own, give cudaErrorInvalidValue
extern "C" int flash_prefill_wgmma(const void* q, const void* k,
                                   const void* v, int B, int Sq, int Sk,
                                   int H, int G, int dh, int causal,
                                   int window, int q_offset, int kv_len,
                                   float scale, int keys, int stages,
                                   int consumers, int blocks, int smem,
                                   void* out, void* stream) {
  const sm90::Args a{Sq, Sk, H, G, causal, window, q_offset, kv_len, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_WGMMA_PLAN(D, K, S, C, N)                                    \
  if (dh == D && keys == K && stages == S && consumers == C && blocks == N) \
    return sm90::launch<D, K, S, C, N>(q, k, v, B, a, smem, out, st);
  FLASH_WGMMA_PLAN(64, 128, 2, 1, 2)
  FLASH_WGMMA_PLAN(64, 64, 2, 1, 3)
  FLASH_WGMMA_PLAN(80, 128, 2, 2, 1)
  FLASH_WGMMA_PLAN(80, 128, 2, 1, 1)
  FLASH_WGMMA_PLAN(80, 64, 2, 1, 2)
  FLASH_WGMMA_PLAN(128, 128, 2, 2, 1)
  FLASH_WGMMA_PLAN(128, 128, 2, 1, 1)
  FLASH_WGMMA_PLAN(128, 64, 2, 1, 2)
  FLASH_WGMMA_PLAN(256, 64, 2, 1, 1)
#undef FLASH_WGMMA_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}

// the host cost of a call's maps: encodes the maps of a block of `rows`
// query rows and `keys`-key tiles `iters` times (0 or the encoding's
// error)
extern "C" int flash_prefill_wgmma_maps(const void* q, const void* k,
                                        const void* v, int B, int Sq, int Sk,
                                        int H, int G, int dh, int rows,
                                        int keys, int iters) {
  sm90::Maps maps;
  for (int i = 0; i < iters; ++i) {
    const int err =
        sm90::encode_maps(maps, q, k, v, B, Sq, Sk, H, G, dh, rows, keys);
    if (err) return err;
  }
  return 0;
}
