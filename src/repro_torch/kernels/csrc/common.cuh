// Shared helpers of the port's hand-written Hopper kernels: warp/block
// reductions with explicit tie-breaks (the Pallas kernels' lax.top_k /
// jnp.argmin / jnp.argmax order: on equal values the lower index wins),
// the f32 <-> storage-type conversions of the attention kernels, and the
// cp.async copies of their tile rings.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

constexpr float kNeg = 3.4e38f;        // distance sentinel, repro.kernels.ref.NEG
constexpr float kMask = -1e30f;        // masked attention score

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// a probability as the PV product sees it: rounded to the value type
// (the Pallas kernels' `p.astype(v.dtype)`)
template <typename T> __device__ __forceinline__ float as_v(float p) {
  return to_f<T>(from_f<T>(p));
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// cp.async: 16 bytes global -> shared without a register stop; with
// in == false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool in = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups of copies are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a . b + acc over the 4 floats of a 16-byte load (or 1 of a 4-byte
// one): the row walks of ecoscan and scr_select take V = float4 where
// d % 4 == 0 and the base is 16-byte aligned, V = float otherwise
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}
__device__ __forceinline__ float dot4(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ float vzero<float>() { return 0.f; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// (v, i) is "better" than (bv, bi) under min-order: smaller value, then
// smaller index.
__device__ __forceinline__ bool min_before(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ bool max_before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (min_before(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (max_before(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Block-wide argmin with lower-index tie-break; every thread gets the
// result. `sv`/`si` are >= 32-entry shared scratch. Contains barriers:
// call from all threads of the block.
__device__ __forceinline__ void block_argmin(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  warp_argmin(v, i);
  __syncthreads();                       // scratch may hold a previous round
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? sv[lane] : inf_f();
    i = lane < nw ? si[lane] : INT_MAX;
    warp_argmin(v, i);
    if (lane == 0) { sv[0] = v; si[0] = i; }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
}
