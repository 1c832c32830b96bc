// SCR window scoring on Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/scr_score.py::scr_score
// (pallas_call at :33): scores[b, n] = windows[b, n, :] . q[b, :], the
// per-query similarity step of the legacy (re-embed every window) SCR.
//
// Bound on the H100: a batched GEMV, 2 flops per 4-byte window element
// read once, so it is bound by memory bytes (B*NW*d*4). At the legacy
// path's shape (B = 1, NW ~ 30, d = 384) the 46 KB read is far below a
// launch, so the call is launch-bound. Design: one warp per (b, window)
// row over a flat B*NW row index (no grid-y limit, small NW still fills
// whole blocks); each lane reads 16-byte float4 chunks of the row and of
// q when d % 4 == 0 and both bases are 16-byte aligned (scalar loads
// otherwise), keeps an f32 fma sum, and the warp reduces it with xor
// shuffles. Rows past B*NW are masked, never padded.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
scr_score_kernel(const float* __restrict__ w, const float* __restrict__ q,
                 long long rows, int NW, int d, int vec,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                 // masked ragged tail
  const long long b = row / NW;
  const float* wr = w + row * d;
  const float* qr = q + b * d;
  float s = 0.f;
  if (vec) {
    const float4* w4 = reinterpret_cast<const float4*>(wr);
    const float4* q4 = reinterpret_cast<const float4*>(qr);
    for (int i = lane; i < d / 4; i += 32) {
      const float4 a = w4[i], c = __ldg(q4 + i);
      s = fmaf(a.x, c.x, s);
      s = fmaf(a.y, c.y, s);
      s = fmaf(a.z, c.z, s);
      s = fmaf(a.w, c.w, s);
    }
  } else {
    for (int i = lane; i < d; i += 32) s = fmaf(wr[i], __ldg(qr + i), s);
  }
  s = warp_sum(s);
  if (lane == 0) out[row] = s;
}

}  // namespace

extern "C" int scr_score(const void* windows, const void* q, int B, int NW,
                         int d, void* out, void* stream) {
  const long long rows = (long long)B * NW;
  const int vec = (d % 4 == 0) &&
                  reinterpret_cast<uintptr_t>(windows) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  scr_score_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(windows), static_cast<const float*>(q), rows,
      NW, d, vec, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
