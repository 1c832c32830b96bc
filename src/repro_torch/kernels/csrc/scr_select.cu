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
// bytes. Design: one block per (doc slot, query), so the main path's
// B*K = 4*3 pairs become 12 independent blocks; each warp takes windows
// w = warp, warp + 8, ... (a coalesced row read, f32 dot, warp sum),
// keeps its first maximum, and the 8 warp results are reduced with the
// lower window id winning ties.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scr_select_kernel(const float* __restrict__ q, const float* __restrict__ data,
                  const int* __restrict__ lens, const int* __restrict__ ids,
                  int CAPW, int d, int K, float* __restrict__ scores,
                  int* __restrict__ wins) {
  extern __shared__ float qs[];     // [d]
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int j = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int did = ids[b * K + j];
  const int n = did >= 0 ? min(lens[did], CAPW) : 0;
  if (n <= 0) {                     // block-uniform exit, before any barrier
    if (tid == 0) {
      scores[b * K + j] = -kNeg;
      wins[b * K + j] = -1;
    }
    return;
  }
  for (int i = tid; i < d; i += blockDim.x) qs[i] = q[(size_t)b * d + i];
  __syncthreads();
  float best = -inf_f();
  int best_w = INT_MAX;
  for (int w = warp; w < n; w += nw) {
    const float* row = data + ((size_t)did * CAPW + w) * d;
    float s = 0.f;
    for (int i = lane; i < d; i += 32) s = fmaf(row[i], qs[i], s);
    s = warp_sum(s);
    if (s > best) { best = s; best_w = w; }   // w ascends: first max kept
  }
  if (lane == 0) { red_v[warp] = best; red_i[warp] = best_w; }
  __syncthreads();
  if (tid == 0) {
    float v = red_v[0];
    int wi = red_i[0];
    for (int w = 1; w < nw; ++w)
      if (max_before(red_v[w], red_i[w], v, wi)) { v = red_v[w]; wi = red_i[w]; }
    scores[b * K + j] = v;
    wins[b * K + j] = wi;
  }
}

}  // namespace

extern "C" int scr_select(const void* q, const void* data, const void* lens,
                          const void* ids, int B, int CAPW, int d, int K,
                          void* scores, void* wins, void* stream) {
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scr_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scr_select_kernel<<<dim3(K, B), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(data),
      static_cast<const int*>(lens), static_cast<const int*>(ids), CAPW, d, K,
      static_cast<float*>(scores), static_cast<int*>(wins));
  return static_cast<int>(cudaGetLastError());
}
