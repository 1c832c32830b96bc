// Fused SCR select on Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/scr_select.py::scr_select
// (pallas_call at :115): per (query b, retrieved doc slot j), gather the
// doc's [CAPW, d] window block, take the dot product of each valid window
// with q, and return the best window's score and its window id. The first
// maximum wins ties (jnp.argmax); padding ids (< 0) and windowless docs
// give (-NEG, -1).
//
// Bound on the H100: each retrieved doc's valid windows are read once
// (lens[doc]*d*4 bytes) for 2 flops per element, so it is bound by memory
// bytes; at the path's shapes (a few pairs of 10 windows) by its chain of
// dependent loads. Design: one warp per window of a (b, j) pair, wp =
// min(CAPW, 16) warps a pair (a warp takes windows w, w + wp, ...), and
// 16 / wp pairs packed into a block where CAPW is small. Each lane loads
// its q vectors into registers before it reads the doc id, and starts its
// windows' 16-byte loads (4-byte when d % 4 or the alignment forbids
// them) as soon as the id arrives: the rows lie in the doc's own CAPW
// block, so they are in bounds for any valid id, and lens[doc], read at
// the same time, only masks them. Two dependent loads, then the warp sums
// and one shuffle reduction across the pair's warps by (score descending,
// window ascending).
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 16;      // warps of a block
constexpr int kChunks = 3;         // vectors a lane loads per window and pass
                                   // (3 x 32 float4: d 384 in one pass)
constexpr int kWin = 2;            // windows a warp has in flight

template <typename V>
__global__ void __launch_bounds__(kMaxWarps * 32)
scr_select_kernel(const float* __restrict__ q, const float* __restrict__ data,
                  const int* __restrict__ lens, const int* __restrict__ ids,
                  int npairs, int CAPW, int d, int K, int wp,
                  float* __restrict__ scores, int* __restrict__ wins) {
  constexpr int kW = sizeof(V) / sizeof(float);
  __shared__ float s_v[kMaxWarps];
  __shared__ int s_w[kMaxWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pb = blockDim.x / (32 * wp);            // pairs a block
  const int wi = warp % wp;
  const int pair = blockIdx.x * pb + warp / wp;     // b * K + j
  const bool live = pair < npairs;
  const int nv = d / kW;
  const V* qv = reinterpret_cast<const V*>(q + (size_t)(live ? pair / K : 0) * d);
  V qc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int v = c * 32 + lane;
    qc[c] = v < nv ? qv[v] : vzero<V>();
  }
  const int did = live ? ids[pair] : -1;
  float best = -inf_f();
  int best_w = INT_MAX;
  if (did >= 0) {
    const int len = lens[did];                      // masks, read alongside
    const V* blk = reinterpret_cast<const V*>(data + (size_t)did * CAPW * d);
    int qc0 = 0;                                    // the pass qc holds
    for (int w0 = wi; w0 < CAPW; w0 += wp * kWin) {
      float s[kWin];
#pragma unroll
      for (int r = 0; r < kWin; ++r) s[r] = 0.f;
      for (int c0 = 0; c0 < nv; c0 += 32 * kChunks) {
        V x[kWin][kChunks];
        if (c0 != qc0) {                            // d > 32 * kChunks vectors
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int v = c0 + c * 32 + lane;
            qc[c] = v < nv ? qv[v] : vzero<V>();
          }
          qc0 = c0;
        }
#pragma unroll
        for (int r = 0; r < kWin; ++r) {
          const int w = w0 + r * wp;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int v = c0 + c * 32 + lane;
            x[r][c] = (w < CAPW && v < nv) ? blk[(size_t)w * nv + v]
                                           : vzero<V>();
          }
        }
#pragma unroll
        for (int r = 0; r < kWin; ++r)
#pragma unroll
          for (int c = 0; c < kChunks; ++c) s[r] = dot4(x[r][c], qc[c], s[r]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < kWin; ++r)
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
      const int n = min(len, CAPW);
#pragma unroll
      for (int r = 0; r < kWin; ++r) {      // w ascends: the first max kept
        const int w = w0 + r * wp;
        if (w < n && s[r] > best) { best = s[r]; best_w = w; }
      }
    }
  }
  if (lane == 0) { s_v[warp] = best; s_w[warp] = best_w; }
  __syncthreads();
  if (wi == 0 && live) {                            // the pair's first warp
    float v = lane < wp ? s_v[warp + lane] : -inf_f();
    int w = lane < wp ? s_w[warp + lane] : INT_MAX;
    warp_argmax(v, w);
    if (lane == 0) {
      const bool none = w == INT_MAX;               // padding or no window
      scores[pair] = none ? -kNeg : v;
      wins[pair] = none ? -1 : w;
    }
  }
}

}  // namespace

extern "C" int scr_select(const void* q, const void* data, const void* lens,
                          const void* ids, int B, int CAPW, int d, int K,
                          void* scores, void* wins, void* stream) {
  const int npairs = B * K;
  const int wp = CAPW < kMaxWarps ? CAPW : kMaxWarps;
  const int pb = kMaxWarps / wp;
  const int blocks = (npairs + pb - 1) / pb;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0;
  auto kern = vec ? scr_select_kernel<float4> : scr_select_kernel<float>;
  kern<<<blocks, pb * wp * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(data),
      static_cast<const int*>(lens), static_cast<const int*>(ids), npairs,
      CAPW, d, K, wp, static_cast<float*>(scores), static_cast<int*>(wins));
  return static_cast<int>(cudaGetLastError());
}
