// Shared by flash_prefill_paged's two bf16 routes
// (csrc/flash_prefill_paged.cu `tc`, csrc/flash_prefill_paged_sm90.cu
// `wgmma`): where a key-buffer position lies (the history through the
// slot's page-table row, then the chunk), the widening of int8 rows to
// `dequantize_kv`'s bf16 values, a group row's output row, and the split
// merge in the last split block.
// A block's rows are ROWS (position, head) pairs of one kv group,
// position-major; a split's partial is its unnormalised acc [ROWS, dh]
// and its max and sum in base 2 [ROWS] each, f32 (ops._split_scratch).
#pragma once
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

// Where key-buffer position j lies: j < hist is absolute position lo + j
// of the slot's history, at ring cursor (lo + j) % ring of the row's
// pages [W] (page row[cursor / ps], offset cursor % ps); hist <= j is row
// j - hist of the chunk's own keys.
struct Hist {
  const int* row;
  int ps, ring, lo, hist;
  __device__ size_t slot(int j) const {
    const int cur = (lo + j) % ring;
    return (size_t)__ldg(row + cur / ps) * ps + cur % ps;
  }
};

// 2^x on the MUFU (2 ulp; x = -1e30 or so gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the 16 int8 values of u times s, rounded to bf16 (dequantize_kv's
// bf16(q * s)): the first 8 in lo, the last 8 in hi
__device__ __forceinline__ void widen16(const uint4& u, float s, uint4& lo,
                                        uint4& hi) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      o[2 * j + i] = pack_bf16(
          static_cast<float>(static_cast<signed char>(w[j] >> (16 * i))) * s,
          static_cast<float>(static_cast<signed char>(w[j] >> (16 * i + 8))) *
              s);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// The output row of the group's row R (query R / Hg, head g * Hg + R % Hg)
__device__ __forceinline__ __nv_bfloat16* out_row(__nv_bfloat16* out, int R,
                                                  int Hg, int H, int g,
                                                  int dh) {
  return out + ((size_t)(R / Hg) * H + (size_t)g * Hg + R % Hg) * dh;
}

// The merge of a (kv head, row block)'s partials by its last split block:
// out_r = sum_s acc_s,r w_s,r / max(sum_s l_s,r w_s,r, 1e-30) with
// w_s,r = 2^(m_s,r - max_s m_s,r) over the splits where l > 0, each output
// summed in split order (the same bits whichever block merges). acc: the
// first split's acc [ROWS, dh] (a split's is ROWS * dh on), ml: its m
// [ROWS] then l [ROWS] (2 * ROWS a split); rows [r0, r0 + n) of the
// group's. sm: the shared m, l and weights [splits][ROWS] each and the
// denominators [ROWS]. NT threads; contains barriers: call from every
// thread of the block.
template <int DH, int ROWS, int NT>
__device__ void merge_rows(const float* acc, const float* ml, int splits,
                           int r0, int n, int Hg, int H, int g, float* sm,
                           __nv_bfloat16* out) {
  const int ns = splits * ROWS;
  float* m_s = sm;
  float* l_s = m_s + ns;
  float* w_s = l_s + ns;
  float* den = w_s + ns;
  for (int e = threadIdx.x; e < ns; e += NT) {
    const float* p = ml + (size_t)(e / ROWS) * 2 * ROWS + e % ROWS;
    m_s[e] = __ldcg(p);
    l_s[e] = __ldcg(p + ROWS);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    float mt = kMask;
    for (int s = 0; s < splits; ++s)
      if (l_s[s * ROWS + r] > 0.f) mt = fmaxf(mt, m_s[s * ROWS + r]);
    float lt = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ls = l_s[s * ROWS + r];
      const float w = ls > 0.f ? ex2(m_s[s * ROWS + r] - mt) : 0.f;
      w_s[s * ROWS + r] = w;
      lt += ls * w;
    }
    den[r] = fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  // four neighbouring outputs a float4; a thread takes kU of them at
  // once, so that their splits' loads are in flight together (dh is a
  // multiple of 16)
  constexpr int kU = 4;
  const int n4 = n * DH / 4;
  for (int f0 = threadIdx.x; f0 < n4; f0 += kU * NT) {
    float4 a[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float4* src =
          reinterpret_cast<const float4*>(acc + (size_t)s * ROWS * DH);
      float4 x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int f = f0 + u * NT;
        x[u] = f < n4 ? __ldcg(src + f) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int f = f0 + u * NT;
        const float w = f < n4 ? w_s[s * ROWS + 4 * f / DH] : 0.f;
        if (w != 0.f) {
          a[u].x += x[u].x * w;
          a[u].y += x[u].y * w;
          a[u].z += x[u].z * w;
          a[u].w += x[u].w * w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int f = f0 + u * NT;
      if (f < n4) {
        const int r = 4 * f / DH, c = 4 * f % DH;
        const float d = den[r];
        __nv_bfloat16* o = out_row(out, r0 + r, Hg, H, g, DH) + c;
        *reinterpret_cast<uint2*>(o) =
            make_uint2(pack_bf16(a[u].x / d, a[u].y / d),
                       pack_bf16(a[u].z / d, a[u].w / d));
      }
    }
  }
}

// Called by every thread of a split block once its rows of the partial
// are written: after a barrier, thread 0 publishes the block's partial and
// takes the ticket of its (kv head, row block) (`__threadfence()` then
// `atomicAdd`, decode_split.cuh's `finish_split`); the last of the
// `splits` blocks resets the ticket for the next launch. True in every
// thread of that last block, which then merges.
__device__ __forceinline__ bool last_split(int* ticket, int splits) {
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1) == splits - 1;
    if (last) {
      *ticket = 0;
      __threadfence();
    }
  }
  return __syncthreads_or(last);
}

}  // namespace
