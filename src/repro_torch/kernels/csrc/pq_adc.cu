// PQ asymmetric-distance (ADC) scoring on Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/pq_adc.py::pq_adc
// (pallas_call at :44): scores[b, n] = sum_m lut[b, m, codes[n, m]]. The
// TPU kernel turns each lookup into a one-hot [TN, 256] x [256] matmul
// because gathers are slow on its vector unit; on Hopper the lookup is a
// plain gather from shared memory.
//
// Bound on the H100: N*M code bytes and B*N*4 output bytes (plus the
// B*M*K*4-byte tables) for M adds per output, so it is bound by memory
// bytes. Design: a block of 256 threads serves 256 code rows of one
// query b: it stages lut[b] ([M, K] f32, 8 KB at M = 8, K = 256) in
// shared memory, then each thread reads its row's M code bytes with the
// widest aligned vector load M allows (16, 8 or 4 bytes, else bytes) and
// sums its M lookups in f32, in m order. K <= 256 is an argument, so
// tables of any nbits <= 8 work; a code >= K adds NaN instead of reading
// outside the table. Rows past N are masked.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int V>   // bytes per vector load of a code row
struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };

// 32-bit word i of a vector load (bytes are then taken by shifts, so the
// load stays in registers)
__device__ __forceinline__ unsigned word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned word_of(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ unsigned word_of(uint32_t v, int) { return v; }

__device__ __forceinline__ float lookup(const float* t, int m, int K,
                                        unsigned c) {
  return c < static_cast<unsigned>(K) ? t[m * K + c]
                                      : __int_as_float(0x7fc00000);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
              int N, int M, int K, float* __restrict__ out) {
  extern __shared__ float tab[];           // [M, K] of query b
  const int b = blockIdx.y;
  const float* lb = lut + (size_t)b * M * K;
  for (int i = threadIdx.x; i < M * K; i += blockDim.x) tab[i] = lb[i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint8_t* row = codes + (size_t)n * M;
  float s = 0.f;
  if constexpr (V == 1) {
    for (int m = 0; m < M; ++m) s += lookup(tab, m, K, row[m]);
  } else {
    using T = typename Vec<V>::T;
    const T* rv = reinterpret_cast<const T*>(row);
    for (int j = 0; j < M / V; ++j) {
      const T v = rv[j];
#pragma unroll
      for (int w = 0; w < V / 4; ++w) {
        const unsigned x = word_of(v, w);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s += lookup(tab, j * V + w * 4 + e, K, (x >> (8 * e)) & 0xffu);
      }
    }
  }
  out[(size_t)b * N + n] = s;
}

template <int V>
cudaError_t launch(const void* lut, const void* codes, int B, int N, int M,
                   int K, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)M * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pq_adc_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  pq_adc_kernel<V><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes), N, M,
      K, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int pq_adc(const void* lut, const void* codes, int B, int N, int M,
                      int K, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  cudaError_t e;
  if (M % 16 == 0 && base % 16 == 0)
    e = launch<16>(lut, codes, B, N, M, K, out, s);
  else if (M % 8 == 0 && base % 8 == 0)
    e = launch<8>(lut, codes, B, N, M, K, out, s);
  else if (M % 4 == 0 && base % 4 == 0)
    e = launch<4>(lut, codes, B, N, M, K, out, s);
  else
    e = launch<1>(lut, codes, B, N, M, K, out, s);
  return static_cast<int>(e);
}
