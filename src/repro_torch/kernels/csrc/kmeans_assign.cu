// k-means assignment on Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/kmeans_assign.py::kmeans_assign
// (pallas_call at :37): per row x[n], the argmin over centroids of
// d2 = (||x||^2 - 2 x.c) + ||c||^2 (the lower centroid id on ties, as
// jnp.argmin) and that d2, unclamped.
//
// Bound on the H100: 2*N*NC*d flops of f32 FMAs on (N + NC)*d*4 bytes,
// so the three shapes the port runs are bound by operations at the
// 67 TFLOP/s f32 rate (no tensor cores: a TF32 product rounds x.c to
// about three digits and changes assignments against the f32 reference):
//   EcoVector build, N 16384, NC 256, d 384: 3.2 GFLOP, 0.048 ms;
//   IVF partition,   N 100000, NC 390, d 128: 10.0 GFLOP, 0.149 ms;
//   PQ sub-quantizer, N 4096, NC 256, d 16:   0.03 GFLOP, 0.0005 ms (a
//   launch takes longer).
//
// Design: the SGEMM x c^T with the argmin in its epilogue. A block of
// 256 threads (a 16 x 16 grid) owns kBM = 128 rows and walks all NC
// centroids in kBN = 128-wide tiles; thread (ty, tx) holds a TM x TN =
// 8 x 8 register tile of x.c sums, for rows ty + 16i and centroids
// tx + 16j. One tile serves every shape: tools/kmeans_probe.py, which
// rebuilds this file with other kBM, kBN, kBK and kMinBlocks, measured
// 128 x 128 fastest at the EcoVector and IVF shapes and within 1 us of
// the fastest at the launch-bound PQ shape (PERF.md). Features are
// staged kBK = 32 at a time into shared memory, two stages deep, with
// cp.async (16-byte copies when d % 4 == 0 and both bases are 16-byte
// aligned, 4-byte copies otherwise), one barrier a chunk: the copy of
// chunk it + 1 is issued once every thread is done with chunk it - 1 and
// lands while chunk it is multiplied. A 16-byte copy carries four
// consecutive features of one row, so the tiles keep x's row-major
// layout ([rows][kBK + 4], a 144-byte pitch: the float4 reads of 8
// consecutive rows fall in 8 different bank groups), and each thread
// reads its rows and centroids as float4 along the features: TM + TN
// float4 loads feed 4*TM*TN FMAs (16 FMAs a load). The chunks of all
// centroid tiles form one pipeline. A ragged chunk (the last tile's
// 16-centroid slices past NC, the last chunk's features past d) is
// skipped there, not multiplied.
// Norms: while the first tile's chunks pass through shared memory,
// threads 0..kBM-1 sum ||x||^2 of their row; in every tile threads
// kBM..kBM+kBN-1 sum ||c||^2 of their centroid, so each norm is taken
// once per block, never per (row, centroid) pair. At a tile's last chunk
// each thread forms d2 for its TM x TN pairs (centroids >= NC never win)
// and updates a running (min, id) per row with min_before; the 16
// threads of a row reduce theirs with xor shuffles, the lower id winning
// ties, so a tie across a tile boundary goes to the lower id too. Rows
// >= N, centroids >= NC and features >= d are zero-filled by the copy,
// never padded in device memory (PERF.md: about half the f32 peak at the
// EcoVector and IVF shapes).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr int kBM = 128;          // rows per block
constexpr int kBN = 128;          // centroids per tile
constexpr int kBK = 32;           // features per staged chunk
constexpr int kMinBlocks = 1;     // blocks per SM the registers must allow
constexpr int kPitch = kBK + 4;   // floats per staged row

// two stages of x [kBM][kPitch] and c [kBN][kPitch], then the norms
constexpr int kSmemBytes = (2 * (kBM + kBN) * kPitch + kBM + kBN) * 4;

// cp.async of 4 bytes (any alignment); with in == false it zero-fills
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}

// Stage rows [r0, r0 + ROWS) x features [k0, k0 + kBK) of src [R, d]
// into dst [ROWS][kPitch], zero past R and d.
template <int ROWS, bool kVec>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int r0, int R, int k0, int d) {
  constexpr int W = kVec ? 4 : 1;           // floats per copy
  constexpr int PER_ROW = kBK / W;
  static_assert(ROWS * PER_ROW % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int e0 = 0; e0 < ROWS * PER_ROW; e0 += kThreads) {
    const int e = e0 + threadIdx.x;
    const int r = e / PER_ROW, k = (e % PER_ROW) * W;
    const bool in = r0 + r < R && k0 + k < d;
    const float* g = in ? src + (size_t)(r0 + r) * d + k0 + k : src;
    if (kVec)
      cp_async16(smem_u32(dst + r * kPitch + k), g, in);
    else
      cp_async4(smem_u32(dst + r * kPitch + k), g, in);
  }
}

// acc[i][j] += x[row ty + 16i] . c[centroid tx + 16j] over one staged
// chunk; kRagged: only the first jn slices of 16 centroids hold any
// centroid < NC (the last tile) and only the first kn features any
// feature < d (the last chunk), the rest are skipped
template <int TM, int TN, bool kRagged>
__device__ __forceinline__ void chunk_product(float (&acc)[TM][TN],
                                              const float* xb, const float* cb,
                                              int tx, int ty, int jn, int kn) {
#pragma unroll
  for (int k = 0; k < kBK; k += 4) {
    if (kRagged && k >= kn) break;
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(xb + (ty + 16 * i) * kPitch + k);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (kRagged && j >= jn) break;
      const float4 b =
          *reinterpret_cast<const float4*>(cb + (tx + 16 * j) * kPitch + k);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int N, int NC, int d, int* __restrict__ assign,
                     float* __restrict__ sqdist) {
  constexpr int BM = kBM, BN = kBN, TM = BM / 16, TN = BN / 16;
  static_assert(BM + BN <= kThreads, "one norm per thread");
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem;
  float* const cs = smem + 2 * BM * kPitch;
  float* const xx_s = smem + 2 * (BM + BN) * kPitch;      // [BM]
  float* const cc_s = xx_s + BM;                          // [BN]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * BM;
  const int nk = (d + kBK - 1) / kBK;
  const int total = nk * ((NC + BN - 1) / BN);

  float acc[TM][TN];
  float best[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = inf_f();
    best_i[i] = INT_MAX;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  float norm = 0.f;    // ||x||^2 of row tid, or ||c||^2 of centroid tid - BM

  stage<BM, kVec>(xs, x, row0, N, 0, d);
  stage<BN, kVec>(cs, c, 0, NC, 0, d);
  cp_async_commit();
  int tile = 0, kc = 0;        // chunk `it` is feature chunk kc of tile
  int ntile = 0, nkc = 1;      // and chunk it + 1 is nkc of ntile
  if (nkc == nk) { nkc = 0; ntile = 1; }
  for (int it = 0; it < total; ++it) {
    // chunk it has landed, and every thread is done with chunk it - 1,
    // whose stage chunk it + 1 now fills while chunk it is multiplied
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < total) {
      const int st = (it + 1) & 1;
      stage<BM, kVec>(xs + st * BM * kPitch, x, row0, N, nkc * kBK, d);
      stage<BN, kVec>(cs + st * BN * kPitch, c, ntile * BN, NC, nkc * kBK, d);
      cp_async_commit();
    }
    const float* xb = xs + (it & 1) * BM * kPitch;
    const float* cb = cs + (it & 1) * BN * kPitch;
    const int jn = (NC - tile * BN + 15) / 16;    // slices holding a centroid
    const int kn = d - kc * kBK;                  // features below d
    if (jn >= TN && kn >= kBK)
      chunk_product<TM, TN, false>(acc, xb, cb, tx, ty, TN, kBK);
    else
      chunk_product<TM, TN, true>(acc, xb, cb, tx, ty, jn, kn);
    const bool x_norm = tid < BM && tile == 0;
    const bool c_norm = tid >= BM && tid < BM + BN;
    if (x_norm || c_norm) {
      const float* r = x_norm ? xb + tid * kPitch : cb + (tid - BM) * kPitch;
#pragma unroll
      for (int k = 0; k < kBK; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(r + k);
        norm = fmaf(v.x, v.x, norm);
        norm = fmaf(v.y, v.y, norm);
        norm = fmaf(v.z, v.z, norm);
        norm = fmaf(v.w, v.w, norm);
      }
    }
    if (kc == nk - 1) {          // the tile's last chunk: its epilogue
      if (x_norm) xx_s[tid] = norm;
      if (c_norm) { cc_s[tid - BM] = norm; norm = 0.f; }
      __syncthreads();
      const int c0 = tile * BN;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xx = xx_s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = c0 + tx + 16 * j;
          const float d2 = (xx - 2.0f * acc[i][j]) + cc_s[tx + 16 * j];
          if (n < NC && min_before(d2, n, best[i], best_i[i])) {
            best[i] = d2;
            best_i[i] = n;
          }
          acc[i][j] = 0.f;
        }
      }
    }
    tile = ntile;
    kc = nkc;
    if (++nkc == nk) { nkc = 0; ++ntile; }
  }
  // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off, 16);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[i], off, 16);
      if (min_before(ob, oi, best[i], best_i[i])) { best[i] = ob; best_i[i] = oi; }
    }
    const int row = row0 + ty + 16 * i;
    if (tx == 0 && row < N) {
      assign[row] = best_i[i];
      sqdist[row] = best[i];
    }
  }
}

template <bool kVec>
int launch(const float* x, const float* c, int N, int NC, int d, int* assign,
           float* sqdist, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      kmeans_assign_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((N + kBM - 1) / kBM);
  kmeans_assign_kernel<kVec><<<grid, kThreads, kSmemBytes, s>>>(
      x, c, N, NC, d, assign, sqdist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int kmeans_assign(const void* x, const void* c, int N, int NC, int d,
                             void* assign, void* sqdist, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(c);
  int* a = static_cast<int*>(assign);
  float* s = static_cast<float*>(sqdist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  return vec ? launch<true>(xf, cf, N, NC, d, a, s, st)
             : launch<false>(xf, cf, N, NC, d, a, s, st);
}
