// PQ asymmetric-distance (ADC) scoring on Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/pq_adc.py::pq_adc
// (pallas_call at :44): scores[b, t] = sum_m lut[b, m, codes[row_t, m]].
// The TPU kernel turns each lookup into a one-hot [TN, 256] x [256]
// matmul because gathers are slow on its vector unit; on Hopper the
// lookup is a gather from shared memory. The rows are either all N code
// rows (row_t = t, a null `starts`) or segments of them: segment s is the
// rows starts[s] .. starts[s] + offs[s+1] - offs[s] - 1, scored into
// output columns offs[s] .. offs[s+1] - 1, so an IVFPQ search hands its
// probed lists, kept in one device pack, to a single launch. A row
// outside [0, N) scores NaN instead of being read.
//
// The sum: each row's M lookups are added in f32 in numpy's order, the
// reference's `tabs[arange(M)[None], codes].sum(axis=1)` (ref.pq_adc):
// M < 8 in order; else 8 partial sums r[m % 8] over the first M - M % 8
// lookups, the tree ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), the rest in
// order, and 0 + that (the reduction's identity). M <= 128, numpy's
// pairwise block. A code >= K adds NaN: the staged table holds NaN past
// K, so a lookup never reads outside it.
//
// Bound on the H100: N*M code bytes read and B*T*4 output bytes written
// (plus the B*M*K*4-byte tables) for M adds an output, so it is bound by
// memory bytes; at an IVFPQ search's shape (one query, ~5,000 rows) by
// the latency of one launch and its chain of dependent loads. Design:
//   - each block stages the tables of QB queries once, as [M][256][QB]
//     f32 in shared memory (32 KB at M 8, QB 4), and walks the output
//     columns with a grid-stride loop; the grid is about kBlocksPerSM
//     blocks an SM over all query groups, so a table is staged once per
//     block, not once per 256 rows as in the kernel this replaces;
//   - the tables are staged with 16-byte loads, transposed in registers
//     into the interleaved layout; the segments come first (cp.async),
//     and a thread sends its first rows' code loads out before it stores
//     its table chunk, so a launch waits on two dependent loads
//     (segments, codes) and the tables arrive meanwhile;
//   - a thread loads a row's M code bytes with one vector load (M 4, 8 or
//     16; rows are then aligned whatever row a segment starts at), kRows
//     rows a batch with the next batch in flight, and scores each row
//     against its block's QB queries: one 16-byte lookup at QB 4 fetches
//     four queries' entries, so the random, bank-conflicted lookups (the
//     limit at the flat shape) serve 4 adds each;
//   - a row's segment is a binary search of the staged offsets;
//   - no atomics: two calls give the same bits.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxM = 128;          // numpy's pairwise block
constexpr int kThreads = 512;       // threads a block (pq_adc_forced may
                                    // take 32..1024)
constexpr int kMaxThreads = 1024;
constexpr int kBlocksPerSM = 1;     // the grid's blocks an SM, over all
                                    // query groups
constexpr int kSMs = 132;           // streaming multiprocessors of an H100
constexpr int kRows = 2;            // rows a thread has in flight
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

template <int QB> struct Lanes { float v[QB]; };

// one table entry (m, code) of the QB queries: a 4, 8 or 16-byte load
template <int QB>
__device__ __forceinline__ Lanes<QB> fetch(const float* tab, unsigned i);
template <> __device__ __forceinline__ Lanes<1> fetch<1>(const float* tab,
                                                        unsigned i) {
  return {{tab[i]}};
}
template <> __device__ __forceinline__ Lanes<2> fetch<2>(const float* tab,
                                                        unsigned i) {
  const float2 x = reinterpret_cast<const float2*>(tab)[i];
  return {{x.x, x.y}};
}
template <> __device__ __forceinline__ Lanes<4> fetch<4>(const float* tab,
                                                        unsigned i) {
  const float4 x = reinterpret_cast<const float4*>(tab)[i];
  return {{x.x, x.y, x.z, x.w}};
}

template <int QB>
__device__ __forceinline__ void add(Lanes<QB>& a, const Lanes<QB>& b) {
#pragma unroll
  for (int j = 0; j < QB; ++j) a.v[j] += b.v[j];
}

// 0 + numpy's pairwise sum of get(0) .. get(n - 1), n <= kMaxM; with kN
// > 0 the count is a constant and the loops unroll
template <int QB, int kN, typename Get>
__device__ __forceinline__ Lanes<QB> np_sum(int n_rt, Get get) {
  const int n = kN > 0 ? kN : n_rt;
  Lanes<QB> s = get(0);
  if (n < 8) {
#pragma unroll
    for (int m = 1; m < (kN > 0 ? kN : 8); ++m)
      if (m < n) add(s, get(m));
  } else {
    Lanes<QB> r[8];
    r[0] = s;
#pragma unroll
    for (int i = 1; i < 8; ++i) r[i] = get(i);
    int m = 8;
    const int body = n - n % 8;
#pragma unroll
    for (; m < body; m += 8) {
#pragma unroll
      for (int i = 0; i < 8; ++i) add(r[i], get(m + i));
    }
#pragma unroll
    for (int j = 0; j < QB; ++j)
      s.v[j] = ((r[0].v[j] + r[1].v[j]) + (r[2].v[j] + r[3].v[j])) +
               ((r[4].v[j] + r[5].v[j]) + (r[6].v[j] + r[7].v[j]));
#pragma unroll
    for (; m < n; ++m) add(s, get(m));
  }
#pragma unroll
  for (int j = 0; j < QB; ++j) s.v[j] = 0.f + s.v[j];
  return s;
}

// a row's kM code bytes from one vector load (kM 4, 8, 16)
template <int kM> struct RowVec;
template <> struct RowVec<4> { using T = uint32_t; };
template <> struct RowVec<8> { using T = uint2; };
template <> struct RowVec<16> { using T = uint4; };

__device__ __forceinline__ unsigned word_of(uint32_t v, int) { return v; }
__device__ __forceinline__ unsigned word_of(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ unsigned word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// cp.async of 4 bytes global -> shared
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"(smem_u32(dst)), "l"(src));
}

// entries k4 .. k4+3 of sub-table m of query b (K % 4 == 0 and lut
// 16-byte aligned: one 16-byte load); NaN past K, zeros for b >= B
__device__ __forceinline__ float4 lut4(const float* __restrict__ lut, int b,
                                       int B, int m, int k4, int K,
                                       size_t MK, bool vec) {
  if (b >= B) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = lut + b * MK + static_cast<size_t>(m) * K + k4;
  if (vec) {
    return k4 < K ? __ldg(reinterpret_cast<const float4*>(p))
                  : make_float4(nan_f(), nan_f(), nan_f(), nan_f());
  }
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = k4 + i < K ? __ldg(p + i) : nan_f();
  return make_float4(e[0], e[1], e[2], e[3]);
}

// chunk c (entries 4c .. 4c+3 of the [M][256] index) of the QB queries'
// tables, v[j] of query j, stored interleaved: entry i holds the QB
// queries' values side by side at float offset i * QB
template <int QB>
__device__ __forceinline__ void put4(float4* tab4, int c,
                                     const float4 (&v)[QB]) {
  if constexpr (QB == 1) {
    tab4[c] = v[0];
  } else if constexpr (QB == 2) {
    tab4[2 * c] = make_float4(v[0].x, v[1].x, v[0].y, v[1].y);
    tab4[2 * c + 1] = make_float4(v[0].z, v[1].z, v[0].w, v[1].w);
  } else {
    tab4[4 * c] = make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
    tab4[4 * c + 1] = make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
    tab4[4 * c + 2] = make_float4(v[0].z, v[1].z, v[2].z, v[3].z);
    tab4[4 * c + 3] = make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
  }
}

// the code row of output column t: t itself, or its segment's row (a
// binary search of the segments staged in shared memory)
__device__ __forceinline__ int row_of(int t, const int* st, const int* off,
                                      int S) {
  if (st == nullptr) return t;
  int lo = 0, hi = S - 1;               // the last s with off[s] <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= t) lo = mid; else hi = mid - 1;
  }
  return st[lo] + (t - off[lo]);
}

// kM > 0: M == kM and every row is kM-byte aligned (vector loads, kRows
// rows a batch, the next batch's loads in flight while one is scored);
// kM == 0: any M <= kMaxM, byte loads
template <int QB, int kM>
__global__ void __launch_bounds__(kMaxThreads)
pq_adc_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
              const int* __restrict__ starts, const int* __restrict__ offs,
              int B, int S, int N, int T, int M, int K,
              float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float* tab = reinterpret_cast<float*>(smem);     // [M][256][QB]
  int* st = nullptr;                               // [S] segment starts
  int* off = nullptr;                              // [S + 1] their offsets
  const int b0 = blockIdx.y * QB;
  // the segments by asynchronous copies; the thread's first chunk of the
  // tables into registers (16-byte loads), stored only after the first
  // rows' code loads have gone out
  if (starts != nullptr) {
    st = reinterpret_cast<int*>(tab + M * 256 * QB);
    off = st + S;
    for (int i = threadIdx.x; i < 2 * S + 1; i += blockDim.x)
      cp_async4(st + i, i < S ? starts + i : offs + (i - S));
  }
  cp_async_commit();
  const size_t MK = static_cast<size_t>(M) * K;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(lut) % 16 == 0;
  const int chunks = M * 64, tid = threadIdx.x;
  float4 v[QB];
  auto fetch_chunk = [&](int c) {
#pragma unroll
    for (int j = 0; j < QB; ++j)
      v[j] = lut4(lut, b0 + j, B, c >> 6, (c & 63) * 4, K, MK, vec);
  };
  auto stage_rest = [&]() {               // the tables in place after it
    if (tid < chunks) put4<QB>(smem, tid, v);
    for (int c = tid + blockDim.x; c < chunks; c += blockDim.x) {
      fetch_chunk(c);
      put4<QB>(smem, c, v);
    }
    __syncthreads();
  };
  if (tid < chunks) fetch_chunk(tid);
  cp_async_wait<0>();
  __syncthreads();                                 // segments in place
  const int nq = min(QB, B - b0);
  const int step = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  auto store = [&](int t, const Lanes<QB>& sum) {
#pragma unroll
    for (int j = 0; j < QB; ++j)
      if (j < nq) out[static_cast<size_t>(b0 + j) * T + t] = sum.v[j];
  };
  if constexpr (kM > 0) {
    using V = typename RowVec<kM>::T;
    V c[kRows];
    bool in[kRows];
    auto load = [&](int t0) {            // the codes of a batch's rows
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int t = t0 + r * step;
        const int row = t < T ? row_of(t, st, off, S) : -1;
        in[r] = static_cast<unsigned>(row) < static_cast<unsigned>(N);
        c[r] = in[r] ? __ldg(reinterpret_cast<const V*>(codes) + row) : V{};
      }
    };
    load(first);
    stage_rest();
    for (int t0 = first; t0 < T; t0 += kRows * step) {
      V cur[kRows];
      bool cur_in[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) { cur[r] = c[r]; cur_in[r] = in[r]; }
      if (t0 + kRows * step < T) load(t0 + kRows * step);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int t = t0 + r * step;
        if (t >= T) break;
        Lanes<QB> sum;
        if (cur_in[r]) {
          sum = np_sum<QB, kM>(kM, [&](int m) {
            const unsigned w = word_of(cur[r], m >> 2);
            const unsigned code = (w >> (8 * (m & 3))) & 0xffu;
            return fetch<QB>(tab, (static_cast<unsigned>(m) << 8) | code);
          });
        } else {
#pragma unroll
          for (int j = 0; j < QB; ++j) sum.v[j] = nan_f();
        }
        store(t, sum);
      }
    }
  } else {
    stage_rest();
    for (int t = first; t < T; t += step) {
      const int row = row_of(t, st, off, S);
      Lanes<QB> sum;
      if (static_cast<unsigned>(row) < static_cast<unsigned>(N)) {
        const uint8_t* rp = codes + static_cast<size_t>(row) * M;
        sum = np_sum<QB, 0>(M, [&](int m) {
          const unsigned code = __ldg(rp + m);
          return fetch<QB>(tab, (static_cast<unsigned>(m) << 8) | code);
        });
      } else {
#pragma unroll
        for (int j = 0; j < QB; ++j) sum.v[j] = nan_f();
      }
      store(t, sum);
    }
  }
}

// shared memory of a block: the [M][256][qb] tables, then the S starts
// and S + 1 offsets of the segments
size_t smem_bytes(int M, int qb, int S) {
  return (static_cast<size_t>(M) * 256 * qb + (S ? 2 * S + 1 : 0)) * 4;
}

template <int QB, int kM>
cudaError_t launch_k(const void* lut, const void* codes, const void* starts,
                     const void* offs, int B, int S, int N, int T, int M,
                     int K, int threads, int gx, void* out, cudaStream_t s) {
  const size_t smem = smem_bytes(M, QB, starts ? S : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_adc_kernel<QB, kM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int groups = (B + QB - 1) / QB;
  if (gx <= 0) {          // a row a thread while that leaves SMs idle
    gx = (kSMs * kBlocksPerSM + groups - 1) / groups;
    gx = max(1, min(gx, (T + threads - 1) / threads));
  }
  pq_adc_kernel<QB, kM><<<dim3(gx, groups), threads, smem, s>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const int*>(starts), static_cast<const int*>(offs), B, S, N,
      T, M, K, static_cast<float*>(out));
  return cudaGetLastError();
}

template <int QB>
cudaError_t launch_q(const void* lut, const void* codes, const void* starts,
                     const void* offs, int B, int S, int N, int T, int M,
                     int K, int threads, int gx, void* out, cudaStream_t s) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
#define PQ_ADC_ARGS \
  lut, codes, starts, offs, B, S, N, T, M, K, threads, gx, out, s
  if (M == 16 && base % 16 == 0) return launch_k<QB, 16>(PQ_ADC_ARGS);
  if (M == 8 && base % 8 == 0) return launch_k<QB, 8>(PQ_ADC_ARGS);
  if (M == 4 && base % 4 == 0) return launch_k<QB, 4>(PQ_ADC_ARGS);
  return launch_k<QB, 0>(PQ_ADC_ARGS);
#undef PQ_ADC_ARGS
}

int launch(const void* lut, const void* codes, const void* starts,
           const void* offs, int B, int S, int N, int T, int M, int K,
           int qb, int threads, int gx, void* out, void* stream) {
  if (M < 1 || M > kMaxM || K < 1 || K > 256 || threads < 32 ||
      threads > kMaxThreads || threads % 32 ||
      smem_bytes(M, qb, starts ? S : 0) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qb) {
    case 1: return launch_q<1>(lut, codes, starts, offs, B, S, N, T, M, K,
                               threads, gx, out, s);
    case 2: return launch_q<2>(lut, codes, starts, offs, B, S, N, T, M, K,
                               threads, gx, out, s);
    case 4: return launch_q<4>(lut, codes, starts, offs, B, S, N, T, M, K,
                               threads, gx, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// scores [B, T] (out); starts == nullptr: the rows 0 .. T-1 (T == N).
// Queries a lookup: 4 from B 4 up, 2 at B 2-3, 1 at B 1, fewer where the
// [M][256][QB] table would pass the shared memory.
extern "C" int pq_adc(const void* lut, const void* codes, const void* starts,
                      const void* offs, int B, int S, int N, int T, int M,
                      int K, void* out, void* stream) {
  int qb = B >= 4 ? 4 : B >= 2 ? 2 : 1;
  while (qb > 1 &&
         smem_bytes(M, qb, starts ? S : 0) > static_cast<size_t>(kMaxSmem))
    qb >>= 1;
  return launch(lut, codes, starts, offs, B, S, N, T, M, K, qb, kThreads, 0,
                out, stream);
}

// The same at forced queries a lookup (1, 2, 4), threads a block (32..1024)
// and grid width (gx > 0; 0 sizes it as pq_adc does), for probes and
// checks; the wrapper always takes pq_adc.
extern "C" int pq_adc_forced(const void* lut, const void* codes,
                             const void* starts, const void* offs, int B,
                             int S, int N, int T, int M, int K, int qb,
                             int threads, int gx, void* out, void* stream) {
  return launch(lut, codes, starts, offs, B, S, N, T, M, K, qb, threads, gx,
                out, stream);
}
