// k-means assignment on Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/kmeans_assign.py::kmeans_assign
// (pallas_call at :37): per row x[n], the argmin over centroids of
// ||x||^2 - 2 x.c + ||c||^2, and that squared distance.
//
// Bound on the H100: at the EcoVector build's shapes (N = 16384 rows,
// NC = 256 centroids, d = 384) the function does 2*N*NC*d ~ 3.2 GFLOP on
// 26 MB of f32 input, so it is bound by f32 operations (no tensor cores:
// a TF32 product would round x.c and change assignments against the
// float32 reference). Design: a block owns 16 rows and sweeps the
// centroids in 16-wide tiles; both tiles are staged in shared memory in
// 32-feature chunks (a 16x16 register-blocked product, one output per
// thread), and each thread keeps a running (min, argmin) for its centroid
// lane, reduced across the 16 lanes with the lower index winning ties,
// as jnp.argmin does.
#include "common.cuh"

namespace {

constexpr int TR = 16;   // rows per block
constexpr int TC = 16;   // centroids per tile
constexpr int TK = 32;   // feature chunk staged in shared memory

__global__ void __launch_bounds__(TR * TC)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int N, int NC, int d, int* __restrict__ assign,
                     float* __restrict__ sqdist) {
  __shared__ float xs[TR][TK + 1];
  __shared__ float cs[TC][TK + 1];
  const int tid = threadIdx.x;
  const int r = tid / TC, j = tid % TC;
  const int row0 = blockIdx.x * TR;
  float best = inf_f();
  int best_i = INT_MAX;
  for (int c0 = 0; c0 < NC; c0 += TC) {
    float xc = 0.f, xx = 0.f, cc = 0.f;
    for (int k0 = 0; k0 < d; k0 += TK) {
      for (int e = tid; e < TR * TK; e += TR * TC) {
        const int rr = e / TK, kk = e % TK;
        const int gr = row0 + rr, gk = k0 + kk;
        xs[rr][kk] = (gr < N && gk < d) ? x[(size_t)gr * d + gk] : 0.f;
      }
      for (int e = tid; e < TC * TK; e += TR * TC) {
        const int rr = e / TK, kk = e % TK;
        const int gc = c0 + rr, gk = k0 + kk;
        cs[rr][kk] = (gc < NC && gk < d) ? c[(size_t)gc * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const float xv = xs[r][kk], cv = cs[j][kk];
        xc = fmaf(xv, cv, xc);
        xx = fmaf(xv, xv, xx);
        cc = fmaf(cv, cv, cc);
      }
      __syncthreads();
    }
    const int ci = c0 + j;
    if (ci < NC) {
      const float d2 = (xx - 2.0f * xc) + cc;
      if (min_before(d2, ci, best, best_i)) { best = d2; best_i = ci; }
    }
  }
  // the 16 lanes of one row are 16 consecutive threads of one warp
#pragma unroll
  for (int off = TC / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off, TC);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off, TC);
    if (min_before(ob, oi, best, best_i)) { best = ob; best_i = oi; }
  }
  const int row = row0 + r;
  if (j == 0 && row < N) {
    assign[row] = best_i;
    sqdist[row] = best;
  }
}

}  // namespace

extern "C" int kmeans_assign(const void* x, const void* c, int N, int NC, int d,
                             void* assign, void* sqdist, void* stream) {
  const dim3 grid((N + TR - 1) / TR);
  kmeans_assign_kernel<<<grid, TR * TC, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(c), N, NC, d,
      static_cast<int*>(assign), static_cast<float*>(sqdist));
  return static_cast<int>(cudaGetLastError());
}
