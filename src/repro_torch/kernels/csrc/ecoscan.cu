// EcoVector inverted-list scan on Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/ecoscan.py::ecoscan
// (pallas_call at :163, called by route_and_scan at :195): per query b,
// the L2 distances ||x||^2 - 2 x.q + ||q||^2 to every valid row of the
// probed cluster blocks data[block_map[probe]], and the k smallest of
// them. Slots >= lens, probe ids < 0 and block_map entries < 0 are
// masked; fewer than k candidates pad with (NEG, -1). Ties keep flat
// candidate order (probe-major, then slot), as lax.top_k does in the
// reference, so a duplicate probe surfaces its rows twice.
//
// Bound on the H100: the probed rows are read once (B*P*CAP*d*4 bytes at
// most) for 4 flops per element, so the scan is bound by memory bytes.
// The TPU kernel walks probes sequentially per query and merges into a
// revisited output block; here blocks run in parallel and carry nothing
// between them, so the work is split in two launches:
//   1. one block per (probe, query): distances of the block's valid rows
//      (one warp per row, coalesced loads of the row), then a block-local
//      top-k ordered by (distance, flat candidate index) into scratch;
//   2. one block per query: merge the P*k scratch candidates under the
//      same order.
// With B = 4 queries and P = 4 probes on the main path, step 1 puts 16
// blocks on the card instead of the 4 a block-per-query scan would.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ecoscan_probe_kernel(const float* __restrict__ q, const float* __restrict__ data,
                     const int* __restrict__ lens, const int* __restrict__ probes,
                     const int* __restrict__ bmap, int CAP, int d, int P, int k,
                     float* __restrict__ sc_d, int* __restrict__ sc_i,
                     int* __restrict__ sc_f) {
  extern __shared__ float sm[];
  float* qs = sm;            // [d]
  float* dist = sm + d;      // [CAP]
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int p = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int cid = probes[b * P + p];
  const int blk = cid >= 0 ? bmap[cid] : -1;
  const int n = blk >= 0 ? min(lens[blk], CAP) : 0;

  float part = 0.f;
  for (int i = tid; i < d; i += blockDim.x) {
    const float v = q[(size_t)b * d + i];
    qs[i] = v;
    part = fmaf(v, v, part);
  }
  part = warp_sum(part);
  if (lane == 0) red_v[warp] = part;
  __syncthreads();
  float qq = 0.f;
  for (int w = 0; w < nw; ++w) qq += red_v[w];

  for (int j = warp; j < n; j += nw) {
    const float* xr = data + ((size_t)blk * CAP + j) * d;
    float xx = 0.f, xq = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float xv = xr[i];
      xx = fmaf(xv, xv, xx);
      xq = fmaf(xv, qs[i], xq);
    }
    xx = warp_sum(xx);
    xq = warp_sum(xq);
    if (lane == 0) dist[j] = (xx - 2.0f * xq) + qq;
  }
  __syncthreads();

  const size_t base = ((size_t)b * P + p) * k;
  for (int r = 0; r < k; ++r) {
    float bv = inf_f();
    int bj = INT_MAX;
    for (int j = tid; j < n; j += blockDim.x) {
      const float v = dist[j];
      if (v != inf_f() && min_before(v, j, bv, bj)) { bv = v; bj = j; }
    }
    block_argmin(bv, bj, red_v, red_i);
    if (tid == 0) {
      if (bj == INT_MAX) {                        // block exhausted
        sc_d[base + r] = kNeg;
        sc_i[base + r] = -1;
        sc_f[base + r] = INT_MAX;
      } else {
        sc_d[base + r] = bv;
        sc_i[base + r] = blk * CAP + bj;
        sc_f[base + r] = p * CAP + bj;
        dist[bj] = inf_f();                       // taken
      }
    }
    __syncthreads();
  }
}

// Candidate order of the merge: (distance, flat index), both ascending.
__device__ __forceinline__ bool cand_before(float v, int f, float bv, int bf) {
  return v < bv || (v == bv && f < bf);
}

__global__ void __launch_bounds__(kThreads)
ecoscan_merge_kernel(const float* __restrict__ sc_d, const int* __restrict__ sc_i,
                     const int* __restrict__ sc_f, int P, int k,
                     float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float sm[];
  const int M = P * k;
  float* cd = sm;                                   // [M]
  int* cf = reinterpret_cast<int*>(sm + M);         // [M]
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  for (int e = tid; e < M; e += blockDim.x) {
    cd[e] = sc_d[(size_t)b * M + e];
    cf[e] = sc_f[(size_t)b * M + e];
  }
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    // best candidate of this thread, then of the block, as (value, slot e)
    float bv = inf_f();
    int bf = INT_MAX, be = -1;
    for (int e = tid; e < M; e += blockDim.x) {
      if (cd[e] != inf_f() && cand_before(cd[e], cf[e], bv, bf)) {
        bv = cd[e]; bf = cf[e]; be = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int of = __shfl_xor_sync(0xffffffffu, bf, off);
      const int oe = __shfl_xor_sync(0xffffffffu, be, off);
      if (cand_before(ov, of, bv, bf)) { bv = ov; bf = of; be = oe; }
    }
    __syncthreads();
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = be; }
    __syncthreads();
    if (tid == 0) {
      float v = inf_f();
      int f = INT_MAX, e = -1;
      for (int w = 0; w < nw; ++w) {
        const int we = red_i[w];
        if (we < 0) continue;
        if (cand_before(red_v[w], cf[we], v, f)) { v = red_v[w]; f = cf[we]; e = we; }
      }
      if (e < 0 || f == INT_MAX) {                // sentinel or nothing left
        out_d[(size_t)b * k + r] = kNeg;
        out_i[(size_t)b * k + r] = -1;
        if (e >= 0) cd[e] = inf_f();
      } else {
        out_d[(size_t)b * k + r] = v;
        out_i[(size_t)b * k + r] = sc_i[(size_t)b * M + e];
        cd[e] = inf_f();
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ecoscan(const void* q, const void* data, const void* lens,
                       const void* probes, const void* bmap, int B, int CAP, int d,
                       int P, int k, void* sc_d, void* sc_i, void* sc_f,
                       void* out_d, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = (size_t)(d + CAP) * sizeof(float);
  if (smem1 > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ecoscan_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem1));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ecoscan_probe_kernel<<<dim3(P, B), kThreads, smem1, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(data),
      static_cast<const int*>(lens), static_cast<const int*>(probes),
      static_cast<const int*>(bmap), CAP, d, P, k, static_cast<float*>(sc_d),
      static_cast<int*>(sc_i), static_cast<int*>(sc_f));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem2 = (size_t)P * k * (sizeof(float) + sizeof(int));
  if (smem2 > 48 * 1024) {
    e = cudaFuncSetAttribute(ecoscan_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ecoscan_merge_kernel<<<B, kThreads, smem2, s>>>(
      static_cast<const float*>(sc_d), static_cast<const int*>(sc_i),
      static_cast<const int*>(sc_f), P, k, static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
