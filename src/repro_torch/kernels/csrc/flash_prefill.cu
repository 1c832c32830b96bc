// Causal / sliding-window flash attention for prefill on Hopper.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_prefill.py::flash_prefill (pallas_call at :95),
// in the model's layout and with the two arguments the chunked prefill
// needs: q [B, Sq, H, dh], k/v [B, Sk, G, dh] with H % G == 0 (query head
// h reads kv head h / (H/G) directly; the TPU wrapper expanded KV to H
// heads first), query i at absolute position q_offset + i, keys at
// positions >= kv_len masked. A key is masked with -1e30 (finite, never
// -inf) when it is past the query (causal) or `window` or more positions
// behind it. Online softmax with scale 1/sqrt(dh) (a float from the
// caller): scores q.k summed in f32, then scaled in f32 (the bf16 route
// scales by scale * log2(e) and takes the softmax in base 2, the same
// probabilities); probabilities rounded to v's type only as the PV
// operand (the TPU kernel's `p.astype(v.dtype)`), the row sum l taken
// from the unrounded f32 probabilities, output acc / max(l, 1e-30). A row
// whose every key is masked gets the uniform average over all Sk keys,
// as the plain version's softmax over -1e30 gives: a block holding such
// a row walks every key tile.
//
// Bound on the H100: per (query, unmasked key) pair 4*dh flops against
// q, k, v and out each moved once, so at prefill lengths (hundreds to
// thousands of keys per query) it is bound by operations: the bf16
// tensor-core rate (989 TFLOP/s) for bf16 inputs, the f32 rate for f32.
//
// bf16 route (`flash_prefill_bf16`), FlashAttention-2 on the tensor
// cores: one block of 4 warps per (query tile of 64 rows, head, batch),
// each warp owning 16 query rows, heavy late query tiles issued first.
// The block walks key tiles of 64 in absolute positions (only those that
// the causal band, the window and kv_len leave partly unmasked), held in
// bf16 in shared memory with rows padded to dh + 8 elements so that
// `ldmatrix` is free of bank conflicts at every dh. The tiles arrive by
// 16-byte `cp.async.cg` copies into a ring of two stages: tile j + 1
// loads while tile j computes, one barrier a tile; rows past kv_len (or
// Sk) are zero-filled by the copy's source size 0. S = Q K^T and O += P V
// run on `mma.sync.m16n8k16` bf16 -> f32 with operands fetched by
// `ldmatrix` (V by `ldmatrix.trans`); Q's fragments stay in registers for
// the whole walk, and S's f32 accumulator fragments become P's bf16
// A-fragments in registers, so P never touches shared memory. Masks are
// applied only on tiles that hold a masked pair; the exponentials are
// `ex2.approx`. dh is a template parameter (32, 64, 80 or 128); kMT (16-row
// m-tiles per warp), kBK and kStages are the tile shape's knobs. At h2o's
// shape (dh 80) it lands near a fifth of its bound, and 128-row query
// tiles, 128-key tiles, a third stage or two m-tiles per warp each moved
// it by less than a tenth (PERF.md): neither the K/V traffic nor the
// shared-memory reads bound it, but each warp's serial chain of Q K^T,
// softmax (one MUFU exponential per pair, which at dh 80 costs most of
// the matmul's time) and P V. Next step: `wgmma` with two warpgroups
// taking turns at softmax and matmul, fed by TMA from a producer warp
// (dh 80 rows are 160 bytes, which fit no 128-byte swizzle without
// padding the head dim).
//
// f32 route (`flash_prefill_f32`), kept on the CUDA cores as the 1e-5
// check (tensor cores would take f32 as TF32): one block per (query tile
// of 32 rows, head, batch) with a loop over key tiles of 32; each query
// row is held by 4 threads, each owning dh/4 of its columns of q and of
// the f32 accumulator in registers, a score being their partial dot
// products summed with two shuffles; key and value tiles are staged in
// shared memory as f32.
#include "common.cuh"

namespace {

// [kbeg, kend): the key positions that a block of query rows at absolute
// positions [qlo, qhi] visits, kbeg rounded down to a tile. The last row
// is the most masked one; when it has no unmasked key, the block visits
// every key of Sk so that such rows get the uniform average.
__device__ __forceinline__ void key_range(int qlo, int qhi, int Sk, int causal,
                                          int window, int kv_len, int tile,
                                          int& kbeg, int& kend) {
  kend = causal ? min(kv_len, qhi + 1) : kv_len;
  kbeg = window > 0 ? max(0, qlo - window + 1) / tile * tile : 0;
  if (kend <= (window > 0 ? max(0, qhi - window + 1) : 0)) {
    kbeg = 0;
    kend = Sk;
  }
}

// ------------------------------------------------- f32 on the CUDA cores

constexpr int kBQ = 32;                        // query rows per block
constexpr int kTPR = 4;                        // threads per query row
constexpr int kTK = 32;                        // keys per tile
constexpr int kThreads = kBQ * kTPR;

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_prefill_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, int Sq, int Sk, int H,
                         int G, int causal, int window, int q_offset,
                         int kv_len, float scale, float* __restrict__ out) {
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
    qr[i] = *reinterpret_cast<const float4*>(q + qoff + (i * kTPR + t) * 4);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kMask, l = 0.f;
  int kbeg, kend;
  key_range(q_offset + q0, q_offset + min(q0 + kBQ, Sq) - 1, Sk, causal,
            window, kv_len, kTK, kbeg, kend);
  const size_t krow = (size_t)G * DH;
  const float* kbase = k + (size_t)b * Sk * krow + (size_t)g * DH;
  const float* vbase = v + (size_t)b * Sk * krow + (size_t)g * DH;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = kbeg; k0 < kend; k0 += kTK) {
    __syncthreads();                           // the previous tile is consumed
    for (int e = tid; e < kTK * RW; e += kThreads) {
      const int j = e / RW, c = (e % RW) * 4;
      const bool in = k0 + j < kend;
      const size_t off = (size_t)(k0 + j) * krow + c;
      ks[e] = in ? *reinterpret_cast<const float4*>(kbase + off) : zero;
      vs[e] = in ? *reinterpret_cast<const float4*>(vbase + off) : zero;
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
      const float p = k0 + j < Sk ? expf(s[j] - mn) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = vs[j * RW + i * kTPR + t];
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
      *reinterpret_cast<float4*>(out + qoff + (i * kTPR + t) * 4) =
          make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                      acc[i].w / den);
  }
}

// ------------------------------------------- bf16 on the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kMT = 1;                         // 16-row m-tiles per warp
constexpr int kThreads = 128;                  // 4 warps
constexpr int kBQ = 4 * 16 * kMT;              // query rows per block
constexpr int kBK = 64;                        // keys per tile
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kNT = kBK / 8;                   // 8-key tiles of S
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of a block: Q and the K/V ring, rows padded to dh + 8
template <int DH> constexpr int smem_bytes() {
  return (kBQ + 2 * kStages * kBK) * (DH + 8) * static_cast<int>(sizeof(bf16));
}

// 2^x on the MUFU (2 ulp; x = -1e30 or so gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16x8] += a[16x16] b[16x8], bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragments of mma.m16n8k16 (lane = 4 * gr + tg): an accumulator tile
// [16 rows x 8 cols] gives a lane (row gr, cols 2tg, 2tg + 1) in d[0..1]
// and (row gr + 8, same cols) in d[2..3]; an A tile [16 x 16] holds those
// of its left 8 columns in a[0..1] and of its right 8 in a[2..3]. So the
// S accumulators of keys 16kk..16kk+15, rounded, are P's A-fragment of
// k-step kk.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, int Sq, int Sk, int H,
                        int G, int causal, int window, int q_offset,
                        int kv_len, float scale, bf16* __restrict__ out) {
  constexpr int R = DH + 8;                    // padded shared row
  constexpr int CPR = DH / 8;                  // 16-byte chunks per row
  constexpr int KS = DH / 16;                  // k-steps of Q K^T
  constexpr int NT = DH / 8;                   // 8-column tiles of O
  constexpr int TILE = kBK * R;
  static_assert(DH % 16 == 0, "dh must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);    // [kBQ][R]
  bf16* ks = qs + kBQ * R;                     // [kStages][kBK][R]
  bf16* vs = ks + kStages * TILE;              // [kStages][kBK][R]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const size_t qstride = (size_t)H * DH, kstride = (size_t)G * DH;
  const bf16* qb = q + (size_t)b * Sq * qstride + (size_t)h * DH;
  const bf16* kb = k + (size_t)b * Sk * kstride + (size_t)g * DH;
  const bf16* vb = v + (size_t)b * Sk * kstride + (size_t)g * DH;
  const int qlo = q_offset + q0, qhi = q_offset + min(q0 + kBQ, Sq) - 1;
  int kbeg, kend;
  key_range(qlo, qhi, Sk, causal, window, kv_len, kBK, kbeg, kend);
  const int ntiles = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;

  for (int c = tid; c < kBQ * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool in = q0 + r < Sq;
    cp_async16(smem_u32(qs + r * R + col),
               qb + (in ? (size_t)(q0 + r) * qstride : 0) + col, in);
  }
  auto load_kv = [&](int stage, int k0) {
    bf16* kd = ks + stage * TILE;
    bf16* vd = vs + stage * TILE;
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * 8;
      const bool in = k0 + r < kend;
      const size_t off = (in ? (size_t)(k0 + r) * kstride : 0) + col;
      cp_async16(smem_u32(kd + r * R + col), kb + off, in);
      cp_async16(smem_u32(vd + r * R + col), vb + off, in);
    }
  };
  // the ring: one commit group per tile (empty past the last), so tile t
  // has landed when at most kStages - 2 groups are in flight
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_kv(t, kbeg + t * kBK);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  uint32_t qf[kMT][KS][4];                     // this warp's rows of Q
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[mt][kk],
                  smem_u32(qs + ((warp * kMT + mt) * 16 + (lane & 15)) * R +
                           kk * 16 + (lane >> 4) * 8));
  float o[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  float m[kMT][2], l[kMT][2];                  // rows gr, gr + 8 of each
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m[mt][0] = m[mt][1] = kMask;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const int qpos = qlo + warp * kMT * 16 + gr;
  const float scale2 = scale * kLog2e;         // softmax in base 2

  for (int t = 0; t < ntiles; ++t) {
    if (t > 0) {
      cp_async_wait<kStages - 2>();            // tile t has landed
      __syncthreads();                         // and tile t - 1 is consumed
    }
    const int tn = t + kStages - 1;            // into tile t - 1's stage
    if (tn < ntiles) load_kv(tn % kStages, kbeg + tn * kBK);
    cp_async_commit();
    const int k0 = kbeg + t * kBK;
    const bf16* kt = ks + (t % kStages) * TILE;
    const bf16* vt = vs + (t % kStages) * TILE;

    float s[kMT][kNT][4];                      // S: tiles of 8 keys
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t r[4];                         // keys 16np.., dims 16kk..
        ldmatrix_x4(r, smem_u32(kt + (np * 16 + (lane & 7) +
                                      ((lane >> 4) << 3)) * R +
                                kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][kk], r[0], r[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][kk], r[2], r[3]);
        }
      }
    }
    // does this tile hold a masked (query, key) pair of the block?
    const bool masked = k0 + kBK > kv_len ||
                        (causal && k0 + kBK - 1 > qlo) ||
                        (window > 0 && k0 <= qhi - window);
    uint32_t pa[kMT][kNT / 2][4];              // P as A-fragments, bf16
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx[2] = {kMask, kMask};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e] * scale2;
          if (masked) {
            const int kp = k0 + j * 8 + tg * 2 + (e & 1);
            const int qp = qpos + mt * 16 + (e >> 1) * 8;
            const bool ok = kp < kv_len && (!causal || kp <= qp) &&
                            (window <= 0 || qp - kp < window);
            x = ok ? x : kMask;
          }
          s[mt][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {            // the 4 lanes of a row agree
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[mt][r], mx[r]);
        corr[r] = ex2(m[mt][r] - mn);
        m[mt][r] = mn;
        l[mt][r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[mt][n][0] *= corr[0];
        o[mt][n][1] *= corr[0];
        o[mt][n][2] *= corr[1];
        o[mt][n][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(s[mt][j][e] - m[mt][e >> 1]);
          if (masked && k0 + j * 8 + tg * 2 + (e & 1) >= Sk) p[e] = 0.f;
          l[mt][e >> 1] += p[e];               // unrounded
        }
        pa[mt][j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[mt][j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t r[4];                         // keys 16kk.., dims 16dp..
        ldmatrix_x4_trans(r, smem_u32(vt + (kk * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) * R +
                                      dp * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(o[mt][2 * dp], pa[mt][kk], r[0], r[1]);
          mma_bf16(o[mt][2 * dp + 1], pa[mt][kk], r[2], r[3]);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = q0 + (warp * kMT + mt) * 16 + gr + r * 8;
      if (row < Sq) {
        const float den = fmaxf(lr, 1e-30f);
        bf16* orow = out + ((size_t)b * Sq + row) * qstride +
                     (size_t)h * DH + tg * 2;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(o[mt][n][2 * r] / den, o[mt][n][2 * r + 1] / den);
      }
    }
  }
}

}  // namespace tc

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, int B, int Sq,
               int Sk, int H, int G, int causal, int window, int q_offset,
               int kv_len, float scale, void* out, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_prefill_f32_kernel<DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), Sq, Sk, H, G, causal, window, q_offset,
      kv_len, scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, int B, int Sq,
                int Sk, int H, int G, int causal, int window, int q_offset,
                int kv_len, float scale, void* out, cudaStream_t stream) {
  using tc::bf16;
  constexpr int smem = tc::smem_bytes<DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      tc::flash_prefill_tc_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + tc::kBQ - 1) / tc::kBQ, H, B);
  tc::flash_prefill_tc_kernel<DH><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), Sq, Sk, H, G, causal, window, q_offset,
      kv_len, scale, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the launch of `Launch<dh>` for a runtime dh
#define FLASH_PREFILL_DISPATCH(Launch)                                       \
  switch (dh) {                                                              \
    case 32: return Launch<32>(q, k, v, B, Sq, Sk, H, G, causal, window,     \
                               q_offset, kv_len, scale, out, st);            \
    case 64: return Launch<64>(q, k, v, B, Sq, Sk, H, G, causal, window,     \
                               q_offset, kv_len, scale, out, st);            \
    case 80: return Launch<80>(q, k, v, B, Sq, Sk, H, G, causal, window,     \
                               q_offset, kv_len, scale, out, st);            \
    case 128: return Launch<128>(q, k, v, B, Sq, Sk, H, G, causal, window,   \
                                 q_offset, kv_len, scale, out, st);          \
    default: return static_cast<int>(cudaErrorInvalidValue);                 \
  }

extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 int B, int Sq, int Sk, int H, int G, int dh,
                                 int causal, int window, int q_offset,
                                 int kv_len, float scale, void* out,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_PREFILL_DISPATCH(launch_f32)
}

extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  int B, int Sq, int Sk, int H, int G, int dh,
                                  int causal, int window, int q_offset,
                                  int kv_len, float scale, void* out,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_PREFILL_DISPATCH(launch_bf16)
}
