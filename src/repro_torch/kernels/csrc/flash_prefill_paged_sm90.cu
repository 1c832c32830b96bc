// A prompt chunk's attention over its slot's page pool on Hopper's own
// units: `wgmma` fed by TMA boxes of the slot's pages, which producer
// warps find through the page-table row.
//
// Replaces no pallas_call: flash_prefill_paged's "wgmma" route (bf16 q at
// dh 64, 80 and 128, `ops.prefill_paged_route`), the function of
// csrc/flash_prefill_paged.cu's header (the jnp chunk attention of
// src/repro/models/dense.py::paged_attn_chunk over `_pool_gather`ed pages,
// `flash_prefill` on the gathered buffer): the history [lo, offset)
// through the row, then the chunk's own k, v, causal within `window`,
// over a bf16 pool or an int8 one with f32 scales (attended as
// `dequantize_kv`'s bf16(q * s)). The rows of a block, the plan
// (`ops.prefill_paged_plan`: key tiles of 64 split across blocks, row
// blocks of 64) and the merge in the last split block are the tc route's
// (csrc/prefill_paged.cuh), so the two routes sum the same tiles.
//
// Bound on the H100: bytes (a chunk does ~4 Hg C operations a byte of the
// history, far under the 295 a byte of bf16 on the tensor cores). What
// kept the tc route at 13% of it at h2o's last ring chunk is latency: its
// 128 threads resolve a tile's slots, copy it by 16-byte cp.async into a
// ring of two stages and wait for it, a memory round trip each tile. Here:
//
// - Warpgroup 0 holds the producers: warps 0 and 2 load K, 1 and 3 V,
//   each every other tile. A warp fetches the row entries of its next
//   tile by 4-byte cp.async (a lane for rows lane and lane + 32) while
//   its tile goes out, so the dependent table load is off the copies'
//   path (int8: a row's scale is loaded a tile ahead, once its entry is
//   in). One warp a tensor, reading the entries in its loop, fed the
//   consumer too slowly (PERF.md, PR 33). A tile's 64 keys are 8 atoms
//   of 8 rows (the 128-byte swizzle's 1 KB period). From an atom's
//   first row, rows that lie in one page at consecutive offsets go as one
//   TMA box of a 4-d map over the pool (dh, G, ps, P) of hp rows (a
//   page's run: 32 at the paths' 32-position pages, so two boxes a tile);
//   the chunk's own rows as one box of a 3-d map (dh, G, C) of hc rows,
//   whose rows past C come in as zeros (the tile's tail); boxes as tall
//   as the pages allow (up to kBoxRows) ran 2-4% faster than 8-row ones
//   at the short chunks and even at h2o's. Any atom that no box covers
//   (a history that ends off a multiple of 8, pages that do not hold 8
//   rows, a ring that wraps inside it) is copied row by row by the
//   warp's lanes in the swizzle's XOR pattern. Both count
//   on the stage's full mbarrier (the TMA bytes by expect_tx, the rows by
//   the warp's second arrival after a proxy fence). A ring of kStages
//   stages, each with its full and empty barriers for K and for V.
// - dh 80 (h2o): 160-byte rows fit no swizzle atom, so K and V tiles are
//   padded to 128 columns in shared memory: the map's dh extent stays 80
//   and TMA's out-of-bounds fill writes the zeros (no extra byte read);
//   Q K^T takes 5 k-steps, P V runs at n128 and 80 columns are written.
// - int8 pools: the pool's atoms come by TMA of a byte map (no swizzle)
//   into a staging ring; the consumers widen the pool rows to bf16(q * s)
//   into the swizzled tile (the scales resolved by the producer beside
//   the slots), fence the proxy and take a warpgroup barrier before the
//   product. The chunk's own rows are bf16 and come by TMA as above.
// - Warpgroup 1 is the consumer of the block's 64 rows: Q loaded once by
//   hand (a block's rows are (position, head) pairs of one kv group, which
//   no TMA box matches at Hg 7), swizzled; then each tile: S = Q K^T by
//   `wgmma.mma_async` m64n64k16 (both operands from shared memory), the
//   online softmax in base 2 with masks only on tiles that hold a masked
//   pair of the block (each row its own query position: causal, window,
//   the chunk's end), O += P V with P from registers and V through the
//   transposed-B descriptor; tile i's Q K^T goes out with tile i - 1's
//   P V, so the softmax runs while P V does.
// - One block an SM (the plan's splits fill one wave of the SMs), so no
//   register split between the warpgroups is needed.
#include <type_traits>

#include "decode_split.cuh"
#include "prefill_paged.cuh"
#include "sm90.cuh"

namespace {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                      // query rows a block
constexpr int kBK = 64;                        // keys a tile
constexpr int kStages = 3;                     // the K and V rings
constexpr int kAhead = 2;                      // tiles of row entries ahead
constexpr int kBoxRows = 64;                   // rows of the tallest TMA box
constexpr int kThreads = 256;                  // producer + consumer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from a 1 KB-aligned base: the mbarriers, the producer
// warps' rings of row codes [4][kAhead][kBK] (int2: page and offset, or
// -1 and the chunk row), the rows' int8 scales [K, V][kStages][kBK] (-1:
// not a pool row), then Q [CH][kRows][64], the K and V rings
// [kStages][CH][kBK][64] in bf16 with the 128-byte swizzle (DHP: dh
// padded to the 64-column atoms), and over an int8 pool the staging rings
// [kStages][kBK][dh] for K and V. The merge reuses it from Q on.
template <int DH, bool Q8> struct Layout {
  static constexpr int DHP = DH <= 64 ? 64 : 128;
  static constexpr int CH = DHP / 64;
  static constexpr int TILE = kBK * DHP * 2;
  static constexpr int STAGE8 = Q8 ? kBK * DH : 0;
  static constexpr int CODES = 256;
  static constexpr int SCALES = CODES + 4 * kAhead * kBK * 8;
  static constexpr int Q = 10240;
  static constexpr int K = Q + kRows * DHP * 2;
  static constexpr int V = K + kStages * TILE;
  static constexpr int K8 = V + kStages * TILE;
  static constexpr int V8 = K8 + kStages * STAGE8;
  static constexpr int END = V8 + kStages * STAGE8;
  static_assert(SCALES + 2 * kStages * kBK * 4 <= Q, "the header's 10 KB");
  static_assert(DH % 16 == 0 && DH <= DHP, "dh 64, 80 or 128");
};

// the byte offset of 16-byte chunk c of row r in a swizzled tile of
// `rows` rows: [c / 8][rows][128 bytes], chunk c % 8 at (c % 8) ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (c >> 3) * rows * kAtom + r * kAtom + (((c & 7) ^ (r & 7)) << 4);
}

struct PagedArgs {
  const bf16* q;                               // [1, C, H, dh]
  const bf16* k;                               // the chunk's [C, G, dh]
  const bf16* v;
  const void* kp;                              // the pool [P, ps, G, dh]
  const void* vp;
  const float* ksc;                            // [P, ps, G] (int8)
  const float* vsc;
  Hist hs;
  int C, H, G, window;
  float scale2;                                // scale * log2(e)
  int kbeg, ntiles, splits;
  int hp, hc;                                  // the maps' box rows (0: none)
  bf16* out;
  float* part;
  int* tickets;
};

// Grid (splits, row blocks, G), kThreads threads. Split sp walks the key
// tiles [t0, t1) of the call's `ntiles` tiles of kBK keys from kbeg.
template <int DH, bool Q8>
__global__ void __launch_bounds__(kThreads, 1)
paged_wgmma_kernel(const __grid_constant__ CUtensorMap kpm,
                   const __grid_constant__ CUtensorMap vpm,
                   const __grid_constant__ CUtensorMap kcm,
                   const __grid_constant__ CUtensorMap vcm,
                   const PagedArgs a) {
  using L = Layout<DH, Q8>;
  constexpr int DHP = L::DHP, CH = L::CH, ST = kStages, BK = kBK;
  constexpr int NCH = DHP / 8;                 // 16-byte chunks of a tile row
  constexpr int RCH = DH / 8;                  // of them holding data
  constexpr int CH8 = DH / 16;                 // 16-byte chunks of an int8 row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  auto kfull = [&](int s) { return base + 8 * s; };
  auto vfull = [&](int s) { return base + 8 * (ST + s); };
  auto kempty = [&](int s) { return base + 8 * (2 * ST + s); };
  auto vempty = [&](int s) { return base + 8 * (3 * ST + s); };
  int2* codes = reinterpret_cast<int2*>(sm + L::CODES);
  float* scales = reinterpret_cast<float*>(sm + L::SCALES);

  const int sp = blockIdx.x, rb = blockIdx.y, g = blockIdx.z;
  const Hist& hs = a.hs;
  const int Hg = a.H / a.G, M = Hg * a.C, r0 = rb * kRows;
  const int kend = hs.hist + a.C;
  const int t0 = (int)((long long)sp * a.ntiles / a.splits);
  const int t1 = (int)((long long)(sp + 1) * a.ntiles / a.splits);
  const int p0 = a.kbeg + t0 * BK, ntl = t1 - t0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    if (a.hp) {
      prefetch_map(&kpm);
      prefetch_map(&vpm);
    }
    if (a.hc) {
      prefetch_map(&kcm);
      prefetch_map(&vcm);
    }
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(kfull(s), 2);                  // expect_tx, then the rows
      mbar_init(vfull(s), 2);
      mbar_init(kempty(s), 4);                 // every consumer warp
      mbar_init(vempty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ------------------------------------------------ producers
    // warps 0 and 2 load K, 1 and 3 V; warps 0 and 1 the even tiles,
    // 2 and 3 the odd ones (its u-th tile is i = par + 2u)
    const bool is_k = (warp & 1) == 0;
    const int par = warp >> 1;
    const CUtensorMap* pmap = is_k ? &kpm : &vpm;
    const CUtensorMap* cmap = is_k ? &kcm : &vcm;
    const void* pool = is_k ? a.kp : a.vp;
    const float* psc = is_k ? a.ksc : a.vsc;
    const bf16* chunk = is_k ? a.k : a.v;
    const int tiles = is_k ? L::K : L::V;      // offsets from base
    const int stage8 = is_k ? L::K8 : L::V8;
    int2* ring = codes + warp * kAhead * BK;
    float* scl = scales + (is_k ? 0 : ST * BK);
    const int fb = is_k ? 0 : ST, eb = is_k ? 2 * ST : 3 * ST;
    // The codes of this warp's u-th tile's rows go to ring slot u %
    // kAhead, kAhead - 1 of its tiles ahead: a pool row as (page, offset),
    // its page by 4-byte cp.async from the table (one group a tile, empty
    // past the split); a chunk row (or one past the chunk: zeros) as (-1,
    // its row). This lane's rows lane and lane + 32 advance by two tiles
    // at a time along the ring (cur: their cursors in the tile fetched
    // next).
    int cur[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      cur[h] = (hs.lo + p0 + par * BK + lane + 32 * h) % hs.ring;
    const float inv_ps = 1.f / hs.ps;
    auto fetch = [&](int u) {
      const int i = par + 2 * u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = p0 + i * BK + lane + 32 * h;
        int2* c = ring + (u % kAhead) * BK + lane + 32 * h;
        if (i < ntl && j < hs.hist) {
          // cur / ps and cur % ps (cur < 2^24: one correction)
          int pg = __float2int_rz(__int2float_rn(cur[h]) * inv_ps);
          int off = cur[h] - pg * hs.ps;
          if (off < 0) {
            --pg;
            off += hs.ps;
          } else if (off >= hs.ps) {
            ++pg;
            off -= hs.ps;
          }
          c->y = off;
          cp_async4(smem_u32(&c->x), hs.row + pg, true);
        } else {
          *c = make_int2(-1, j - hs.hist);
        }
        for (cur[h] += 2 * BK; cur[h] >= hs.ring;) cur[h] -= hs.ring;
      }
      cp_async_commit();
    };
    // int8: the scales of its u-th tile's pool rows (their codes have
    // landed)
    float sc[2] = {-1.f, -1.f};
    auto scales_of = [&](int u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int2 c = ring[(u % kAhead) * BK + lane + 32 * h];
        sc[h] = c.x >= 0
                    ? __ldg(psc + ((size_t)c.x * hs.ps + c.y) * a.G + g)
                    : -1.f;
      }
    };
    for (int u = 0; u < kAhead - 1; ++u) fetch(u);
    if (Q8) {
      cp_async_wait<kAhead - 2>();
      scales_of(0);
    }
    for (int u = 0, i = par; i < ntl; ++u, i += 2) {
      const int s = i % ST;
      fetch(u + kAhead - 1);
      cp_async_wait<kAhead - 1>();             // tile i's codes
      __syncwarp();
      const int2* code = ring + (u % kAhead) * BK;
      mbar_wait(base + 8 * (eb + s), ((i / ST) & 1) ^ 1);
      const uint32_t full = base + 8 * (fb + s);
      if (Q8) {
        scl[s * BK + lane] = sc[0];
        scl[s * BK + lane + 32] = sc[1];
      }
      // Row r continues row r - 1 where both are the chunk's, or both lie
      // in one page at consecutive offsets. Lane a < 8 looks at atom a
      // (rows 8a ..): the box of its first row's map (a.hp rows of a page,
      // a.hc of the chunk) aligned to its height that holds the atom
      // carries it if all the box's rows continue its first; lane a issues
      // the box that starts at its atom, lane 0 first expects the bytes of
      // them all. An atom no box carries is copied row by row.
      auto continues = [&](int r) {
        const int2 c = code[r], b = code[r - 1];
        return c.x < 0 ? b.x < 0 : c.x == b.x && c.y == b.y + 1;
      };
      const unsigned c_lo = __ballot_sync(0xffffffffu, lane > 0 &&
                                                           continues(lane));
      const unsigned c_hi = __ballot_sync(0xffffffffu, continues(lane + 32));
      const unsigned long long cont =
          c_lo | static_cast<unsigned long long>(c_hi) << 32;
      bool start = false, carried = false, in_pool = false;
      int2 c0 = make_int2(0, 0);
      if (lane < BK / 8) {
        in_pool = code[8 * lane].x >= 0;
        const int hb = in_pool ? a.hp : a.hc;
        if (hb) {
          const int r0 = 8 * lane / hb * hb;
          c0 = code[r0];
          const unsigned long long run =
              (hb == 64 ? ~0ull : ((1ull << hb) - 1) << r0) & ~(1ull << r0);
          carried = (c0.x >= 0) == in_pool && (cont & run) == run;
          start = carried && r0 == 8 * lane;
        }
      }
      const unsigned pools = __ballot_sync(0xffffffffu, start && in_pool);
      const unsigned chunks = __ballot_sync(0xffffffffu, start && !in_pool);
      const unsigned atoms = __ballot_sync(0xffffffffu, carried);
      if (lane == 0)
        mbar_expect_tx(full, __popc(pools) * (Q8 ? a.hp * DH
                                                 : CH * a.hp * kAtom) +
                                 __popc(chunks) * CH * a.hc * kAtom);
      __syncwarp();
      if (start) {
        const int r = 8 * lane;
        if (in_pool && Q8) {
          tma_load(base + stage8 + s * L::STAGE8 + r * DH, pmap, full, 0, g,
                   c0.y, c0.x);
        } else {
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) {
            const uint32_t d =
                base + tiles + s * L::TILE + ch * BK * kAtom + r * kAtom;
            if (in_pool)
              tma_load(d, pmap, full, ch * 64, g, c0.y, c0.x);
            else
              tma_load3(d, cmap, full, ch * 64, g, c0.y);
          }
        }
      }
      // the atoms no box carries, row by row: int8 pool rows to the
      // staging tile, the rest to the swizzled bf16 tile (zeros past dh
      // and past C)
      const unsigned rows = ~atoms & 0xffu;
      for (unsigned m = rows; m; m &= m - 1) {
        const int at = __ffs(m) - 1;
        for (int e = lane; e < 8 * NCH; e += 32) {
          const int r = 8 * at + e / NCH, c = e % NCH;
          const int2 cd = code[r];
          if (Q8 && cd.x >= 0) {
            if (c < CH8)
              *reinterpret_cast<uint4*>(sm + stage8 + s * L::STAGE8 + r * DH +
                                        c * 16) =
                  *reinterpret_cast<const uint4*>(
                      static_cast<const int8_t*>(pool) +
                      (((size_t)cd.x * hs.ps + cd.y) * a.G + g) * DH + c * 16);
            continue;
          }
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (c < RCH) {
            if (cd.x >= 0)
              val = *reinterpret_cast<const uint4*>(
                  static_cast<const bf16*>(pool) +
                  (((size_t)cd.x * hs.ps + cd.y) * a.G + g) * DH + c * 8);
            else if (cd.y < a.C)
              val = *reinterpret_cast<const uint4*>(
                  chunk + ((size_t)cd.y * a.G + g) * DH + c * 8);
          }
          *reinterpret_cast<uint4*>(sm + tiles + s * L::TILE +
                                    swz(r, c, BK)) = val;
        }
      }
      if (rows) fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(full);
      if (Q8 && i + 2 < ntl) {                 // its next tile's scales,
        cp_async_wait<kAhead - 2>();           // in flight until its turn
        __syncwarp();
        scales_of(u + 1);
      }
    }
  } else if (warp >= 4) {
    // ------------------------------------------------ consumers
    const int t = threadIdx.x - 128, w = t / 32, gr = lane / 4, tg = lane % 4;
    const int row0 = r0 + 16 * w + gr;         // rows row0 and row0 + 8
    const int qp[2] = {hs.hist + row0 / Hg, hs.hist + (row0 + 8) / Hg};
    const int qlo = hs.hist + r0 / Hg;
    const int qhi = hs.hist + (min(M, r0 + kRows) - 1) / Hg;
    const uint32_t q_s = base + L::Q;
    // Q: the block's rows (zeros past M and past dh), swizzled by hand
    {
      constexpr int QN = kRows * NCH / 128;
      uint4 x[QN];
#pragma unroll
      for (int u = 0; u < QN; ++u) {
        const int e = t + 128 * u, r = e / NCH, c = e % NCH, R = r0 + r;
        x[u] = R < M && c < RCH
                   ? *reinterpret_cast<const uint4*>(
                         a.q + ((size_t)(R / Hg) * a.H + (size_t)g * Hg +
                                R % Hg) * DH + c * 8)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < QN; ++u) {
        const int e = t + 128 * u;
        *reinterpret_cast<uint4*>(sm + L::Q + swz(e / NCH, e % NCH, kRows)) =
            x[u];
      }
      fence_proxy_async();
      bar_sync<128>(1);
    }
    // an int8 stage's pool rows widened into the bf16 tile (scales -1:
    // the chunk's rows, already there); the caller fences the proxy and
    // takes the warpgroup's barrier before the product reads them
    auto widen = [&](int st, int st8, const float* scl) {
      for (int e = t; e < BK * CH8; e += 128) {
        const int r = e / CH8, c = e % CH8;
        const float sc = scl[st * BK + r];
        if (sc >= 0.f) {
          uint4 lo, hi;
          widen16(*reinterpret_cast<const uint4*>(sm + st8 + st * L::STAGE8 +
                                                  r * DH + c * 16),
                  sc, lo, hi);
          unsigned char* d = sm + (st8 == L::K8 ? L::K : L::V) + st * L::TILE;
          *reinterpret_cast<uint4*>(d + swz(r, 2 * c, BK)) = lo;
          *reinterpret_cast<uint4*>(d + swz(r, 2 * c + 1, BK)) = hi;
        }
      }
    };
    auto widened = [&] {
      fence_proxy_async();
      bar_sync<128>(1);
    };
    // s[4n + e] and o[4n + e]: row row0 + 8 (e >> 1), column 8n + 2tg + (e & 1)
    float o[DHP / 2], s[BK / 2], m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    auto qk = [&](int st) {                    // s = Q K^T of stage st
      const uint32_t kst = base + L::K + st * L::TILE;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BK>(s, smem_desc(q_s + c * kRows * kAtom + off, 16),
                     smem_desc(kst + c * BK * kAtom + off, 16), kk > 0);
      }
    };
    auto pv = [&](int st) {                    // O += P V of stage st
      const uint32_t vst = base + L::V + st * L::TILE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DHP>(o, p[kk], smem_desc(vst + kk * 16 * kAtom, BK * kAtom));
    };
    // The online softmax of the tile at k0 in place: s becomes its
    // probabilities (unrounded in l, bf16 in p) under the new running max;
    // corr rescales the old O (after the previous tile's P V). Only a tile
    // that holds a masked pair of the block masks: a row keeps the keys
    // in [qp - window + 1, min(qp, kend - 1)], as offsets of its lane's
    // columns against compile-time column numbers; a masked score is
    // -inf (probability 0: a row's own key, in the chunk, is never
    // masked, so no row of the call is masked whole). Maxima and sums run
    // in 4 chains a row.
    float corr[2];
    auto softmax = [&](int k0) {
      const bool masked = k0 + BK > kend || k0 + BK - 1 > qlo ||
                          (a.window > 0 && k0 <= qhi - a.window);
      if (masked) {
        int hi[2], lo[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          hi[r] = min(qp[r], kend - 1) - k0 - 2 * tg;
          lo[r] = a.window > 0 ? qp[r] - a.window + 1 - k0 - 2 * tg
                               : -(1 << 30);
        }
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int r = (j >> 1) & 1, kj = 8 * (j / 4) + (j & 1);
          if (kj > hi[r] || kj < lo[r]) s[j] = -inf_f();
        }
      }
      float mx[2][4], sum[2][4], nm[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          mx[r][c] = -inf_f();
          sum[r][c] = 0.f;
        }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1, c = (j & 1) | ((j >> 1) & 2);
        mx[r][c] = fmaxf(mx[r][c], s[j]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {            // the 4 lanes of a row agree
        float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        x = fmaxf(x * a.scale2, kMask);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float mn = fmaxf(m[r], x);
        corr[r] = ex2(m[r] - mn);
        m[r] = mn;
        nm[r] = -mn;
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1, c = (j & 1) | ((j >> 1) & 2);
        s[j] = ex2(fmaf(s[j], a.scale2, nm[r]));
        sum[r][c] += s[j];                     // unrounded
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * corr[r] +
               ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
    };
    auto to_p = [&] {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    };
    // tile i's Q K^T goes out with tile i - 1's P V, so tile i's softmax
    // runs while P V does
    mbar_wait(kfull(0), 0);
    if (Q8) {
      widen(0, L::K8, scales);
      widened();
    }
    wgmma_fence();
    qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(kempty(0));
    softmax(p0);
    for (int i = 1; i < ntl; ++i) {
      const int st = i % ST, pst = (i - 1) % ST;
      mbar_wait(kfull(st), (i / ST) & 1);
      mbar_wait(vfull(pst), ((i - 1) / ST) & 1);
      if (Q8) {
        widen(st, L::K8, scales);
        widen(pst, L::V8, scales + ST * BK);
        widened();
      }
      to_p();
      wgmma_fence();
      qk(st);
      wgmma_commit();
      pv(pst);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(kempty(st));
      softmax(p0 + i * BK);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(vempty(pst));
      // O to the new maxima, skipped by a warp where no row of its 16 got
      // a new maximum (every factor exactly 1)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < DHP / 2; ++j) o[j] *= corr[(j >> 1) & 1];
      }
    }
    const int pst = (ntl - 1) % ST;
    mbar_wait(vfull(pst), ((ntl - 1) / ST) & 1);
    if (Q8) {
      widen(pst, L::V8, scales + ST * BK);
      widened();
    }
    to_p();
    wgmma_fence();
    pv(pst);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(vempty(pst));
    float lr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lr[r] = l[r];
      lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 1);
      lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 2);
    }
    if (a.splits == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int R = row0 + 8 * r;
        if (R < M) {
          const float den = fmaxf(lr[r], 1e-30f);
          bf16* orow = out_row(a.out, R, Hg, a.H, g, DH) + 2 * tg;
#pragma unroll
          for (int n = 0; n < DH / 8; ++n)
            *reinterpret_cast<uint32_t*>(orow + 8 * n) =
                pack_bf16(o[4 * n + 2 * r] / den, o[4 * n + 2 * r + 1] / den);
        }
      }
    } else {
      // the partial of (g, rb, sp): acc [kRows, DH], then m and l [kRows]
      const size_t pair = (size_t)g * gridDim.y + rb;
      const size_t pairs = (size_t)gridDim.z * gridDim.y;
      float* pa = a.part + (pair * a.splits + sp) * kRows * DH;
      float* ml = a.part + pairs * a.splits * kRows * DH +
                  (pair * a.splits + sp) * 2 * kRows;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = 16 * w + gr + 8 * r;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
          *reinterpret_cast<float2*>(pa + (size_t)rr * DH + 8 * n + 2 * tg) =
              make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
        if (tg == 0) {
          ml[rr] = m[r];
          ml[kRows + rr] = lr[r];
        }
      }
    }
  }
  if (a.splits == 1) return;
  // every thread of the block: publish the partial, take the ticket; the
  // last split block merges (the shared memory from Q on is free: every
  // stage's copies have landed and been read)
  const size_t pair = (size_t)g * gridDim.y + rb;
  const size_t pairs = (size_t)gridDim.z * gridDim.y;
  if (!last_split(a.tickets + pair, a.splits)) return;
  merge_rows<DH, kRows, kThreads>(
      a.part + pair * a.splits * kRows * DH,
      a.part + pairs * a.splits * kRows * DH + pair * a.splits * 2 * kRows,
      a.splits, r0, min(kRows, M - r0), Hg, a.H, g,
      reinterpret_cast<float*>(sm + L::Q), a.out);
}

// ---------------------------------------------------------------- host

// a row-major tensor of `rank` dims (dims[0] innermost) of esz-byte
// elements as a tensor map of `box` tiles; out of bounds reads zeros
int encode(CUtensorMap* map, CUtensorMapDataType type, int esz,
           const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  cuuint64_t strides[4];
  cuuint64_t stride = esz;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

struct Maps {
  CUtensorMap kp, vp, kc, vc;
  int hp, hc;                                  // their box rows (0: none)
};

// the rows of a map's boxes over n rows a run: the largest power of two
// from kBoxRows down to 8 that divides n (a page: every box inside one),
// or is at most n (the chunk: boxes past its end read zeros); 0 for none
int box_rows(int n, bool divides) {
  for (int h = kBoxRows; h >= 8; h /= 2)
    if (divides ? n % h == 0 : n >= h) return h;
  return 0;
}

// The four maps of a call: the pool [P, ps, G, dh] as (dh, G, ps, P),
// bf16 boxes of 64 columns with the 128-byte swizzle or int8 boxes of dh
// bytes, unswizzled, hp rows a box; the chunk's k, v [C, G, dh] as (dh,
// G, C), hc rows a box (at most 32: a chunk's keys in a tile after its
// history). Pages of fewer than 8 positions, or a chunk of fewer than 8
// keys, get no map: their rows are copied row by row.
int encode_maps(Maps& m, const void* k, const void* v, const void* kp,
                const void* vp, bool q8, int P, int ps, int G, int dh, int C) {
  m.hp = box_rows(ps, true);
  m.hc = min(32, box_rows(C, false));
  int err = 0;
  if (m.hp) {
    const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)G,
                                (cuuint64_t)ps, (cuuint64_t)P};
    const cuuint32_t box[4] = {q8 ? (cuuint32_t)dh : 64u, 1,
                               (cuuint32_t)m.hp, 1};
    const CUtensorMapDataType type = q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapSwizzle swz =
        q8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
    err = encode(&m.kp, type, q8 ? 1 : 2, kp, 4, dims, box, swz);
    if (!err) err = encode(&m.vp, type, q8 ? 1 : 2, vp, 4, dims, box, swz);
  }
  if (!err && m.hc) {
    const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)G, (cuuint64_t)C};
    const cuuint32_t box[3] = {64, 1, (cuuint32_t)m.hc};
    err = encode(&m.kc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, 3, dims, box,
                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err)
      err = encode(&m.vc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, 3, dims, box,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  }
  return err;
}

// the shared bytes of a launch: the layout, or the merge's scratch from Q
// on where that is larger, and 1 KB to align the base
template <int DH, bool Q8> int smem_bytes(int splits) {
  using L = Layout<DH, Q8>;
  return 1024 + max(L::END, L::Q + merge_floats(splits, kRows) * 4);
}

// kbeg, ntiles, rblocks, splits: ops.prefill_paged_plan's (checked here,
// not recomputed)
template <int DH, bool Q8>
int launch(PagedArgs a, int P, int rblocks, cudaStream_t st) {
  const int kend = a.hs.hist + a.C, M = a.H / a.G * a.C;
  const int smem = smem_bytes<DH, Q8>(a.splits);
  if (a.kbeg < 0 || a.kbeg % kBK || a.kbeg >= kend ||
      a.kbeg + a.ntiles * kBK < kend || a.kbeg + (a.ntiles - 1) * kBK >= kend ||
      rblocks * kRows < M || (rblocks - 1) * kRows >= M || a.splits < 1 ||
      a.splits > a.ntiles || smem > 227 * 1024 ||
      (a.splits > 1 && (a.part == nullptr || a.tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps m{};
  const int err = encode_maps(m, a.k, a.v, a.kp, a.vp, Q8, P, a.hs.ps, a.G,
                              DH, a.C);
  if (err) return err;
  a.hp = m.hp;
  a.hc = m.hc;
  auto kernel = paged_wgmma_kernel<DH, Q8>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t e = allow_smem(kernel, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(a.splits, rblocks, a.G), kThreads, smem, st>>>(
      m.kp, m.vp, m.kc, m.vc, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace

// bf16 q [1, C, H, dh] at dh 64, 80 or 128 on the wgmma route, over a bf16
// pool or an int8 one with its scales (ksc, vsc; null for a bf16 pool):
// the arguments of csrc/flash_prefill_paged.cu's flash_prefill_paged_bf16
// and the pool's page count P (its maps' extent)
extern "C" int flash_prefill_paged_wgmma(
    const void* q, const void* k, const void* v, const void* kp,
    const void* ksc, const void* vp, const void* vsc, const void* row, int C,
    int H, int G, int dh, int ps, int ring, int lo, int hist, int window,
    float scale, int P, int kbeg, int ntiles, int rblocks, int splits,
    void* part, void* tickets, void* out, void* stream) {
  using bf16 = __nv_bfloat16;
  const sm90::PagedArgs a{
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kp, vp, static_cast<const float*>(ksc),
      static_cast<const float*>(vsc),
      Hist{static_cast<const int*>(row), ps, ring, lo, hist}, C, H, G,
      window, scale * sm90::kLog2e, kbeg, ntiles, splits, 0, 0,
      static_cast<bf16*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool q8 = ksc != nullptr;
  switch (dh) {
#define PAGED_WGMMA(D)                                                \
  case D:                                                             \
    return q8 ? sm90::launch<D, true>(a, P, rblocks, st)              \
              : sm90::launch<D, false>(a, P, rblocks, st);
    PAGED_WGMMA(64) PAGED_WGMMA(80) PAGED_WGMMA(128)
#undef PAGED_WGMMA
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the host cost of a call's maps: encodes the four maps of a chunk `iters`
// times (0 or the encoding's error)
extern "C" int flash_prefill_paged_wgmma_maps(const void* k, const void* v,
                                              const void* kp, const void* vp,
                                              int q8, int P, int ps, int G,
                                              int dh, int C, int iters) {
  sm90::Maps m{};
  for (int i = 0; i < iters; ++i) {
    const int err = sm90::encode_maps(m, k, v, kp, vp, q8, P, ps, G, dh, C);
    if (err) return err;
  }
  return 0;
}
