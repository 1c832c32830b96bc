// EcoVector inverted-list scan on Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/ecoscan.py::ecoscan
// (pallas_call at :163, called by route_and_scan at :195): per query b,
// the L2 distances ||x||^2 - 2 x.q + ||q||^2 to every valid row of the
// probed cluster blocks data[block_map[probe]], and the k smallest of
// them. Slots >= lens, probe ids < 0 and block_map entries < 0 are
// masked (a null block_map is the identity); fewer than k candidates pad
// with (NEG, -1). Ties keep flat candidate order f = p*CAP + j
// (probe-major, then slot), as lax.top_k does in the reference, so a
// duplicate probe surfaces its rows twice.
//
// Bound on the H100: the probed rows are read once (sum of lens * d * 4
// bytes) for 4 flops per element, so the scan is bound by memory bytes;
// at a path's small shapes, by the latency of its chain of dependent
// loads. The TPU kernel walks probes sequentially per query and merges
// into a revisited output block; here one launch does it all:
//   1. each probed list is cut into tiles of kTile rows, one block per
//      (tile, probe, query): B*P*ceil(CAP/kTile) blocks (64 on the main
//      path, 2,048 at a 16 x 8-probe shape over 512-row lists). Each warp
//      holds kBatch rows' 16-byte loads in flight (4-byte loads when d % 4
//      or the alignment forbids them), reduces them together, and one warp
//      bitonic-sorts the tile's (distance, flat index) pairs in registers
//      and writes the first min(k, kTile) to scratch: a sorted list;
//   2. each block then takes a ticket of its query (atomicAdd behind
//      __threadfence()); the last block of a query resets the ticket and
//      merges that query's lists: it reads them position-major (every
//      list's first entries first), 256 candidates a pass with the next
//      pass's loads in flight, keeps those before the running k-th, sorts
//      each warp's into a run of <= k, and ranks every run and top entry
//      in the union by binary searches in the sorted runs (interleaved)
//      and top: ranks < k are the next top. Passes past the first mostly
//      keep nothing and skip the sort and ranks. The order (distance, flat
//      index) is total, so the result is the same bits whichever block
//      finishes last.
#include "common.cuh"

namespace {

constexpr int kTile = 32;          // rows of a probed list per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 2;          // rows a warp has in flight (fewer
                                   // registers, more blocks an SM)
constexpr int kChunks = 3;         // vectors a lane loads per row and pass
                                   // (3 x 32 float4: d 384 in one pass)

// Sort 32*kPer (value, flat, slot) triples held by one warp, element
// e = i*32 + lane in register i, ascending by min_before (value, then
// flat index); the slot travels with its key.
template <int kPer>
__device__ __forceinline__ void warp_bitonic_sort(float (&v)[kPer],
                                                  int (&f)[kPer],
                                                  int (&sl)[kPer]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 2; s <= 32 * kPer; s <<= 1) {
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const bool up = ((i * 32 + lane) & s) == 0;
        if (j >= 32) {                      // partner in this lane
          const int ii = i ^ (j >> 5);
          if (ii > i) {
            const bool swap = up ? min_before(v[ii], f[ii], v[i], f[i])
                                 : min_before(v[i], f[i], v[ii], f[ii]);
            if (swap) {
              const float tv = v[i]; v[i] = v[ii]; v[ii] = tv;
              const int tf = f[i]; f[i] = f[ii]; f[ii] = tf;
              const int ts = sl[i]; sl[i] = sl[ii]; sl[ii] = ts;
            }
          }
        } else {                            // partner lane ^ j
          const float ov = __shfl_xor_sync(0xffffffffu, v[i], j);
          const int of = __shfl_xor_sync(0xffffffffu, f[i], j);
          const int os = __shfl_xor_sync(0xffffffffu, sl[i], j);
          const bool lower = (lane & j) == 0;
          if (lower == up ? min_before(ov, of, v[i], f[i])
                          : min_before(v[i], f[i], ov, of)) {
            v[i] = ov;
            f[i] = of;
            sl[i] = os;
          }
        }
      }
    }
  }
}

// Entries before (v, f) in the kWarps sorted runs of <= 32 (rd, rf)
// [32 * w, 32 * w + n[w]): binary lifting, a fixed six steps, the runs'
// loads of a step in flight together.
template <int kRuns>
__device__ __forceinline__ int runs_before(const float* rd, const int* rf,
                                           const int (&n)[kRuns], float v,
                                           int f) {
  int lo[kRuns];
#pragma unroll
  for (int w = 0; w < kRuns; ++w) lo[w] = 0;
#pragma unroll
  for (int step = 32; step > 0; step >>= 1)
#pragma unroll
    for (int w = 0; w < kRuns; ++w) {
      const int at = 32 * w + min(lo[w] + step, 32) - 1;
      if (lo[w] + step <= n[w] && min_before(rd[at], rf[at], v, f)) lo[w] += step;
    }
  int r = 0;
#pragma unroll
  for (int w = 0; w < kRuns; ++w) r += lo[w];
  return r;
}

// Shared memory of the merge (dynamic, 4-byte words): two top-k buffers
// [3][k] (distance, flat, slot), then the warps' runs [3][kThreads].
template <int T, typename V>
__global__ void __launch_bounds__(kThreads)
ecoscan_kernel(const float* __restrict__ q, const float* __restrict__ data,
               const int* __restrict__ lens, const int* __restrict__ probes,
               const int* __restrict__ bmap, int CAP, int d, int P, int nt,
               int k, float* __restrict__ sc_d, int* __restrict__ sc_f,
               int* __restrict__ sc_s, int* __restrict__ tickets,
               float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int kW = sizeof(V) / sizeof(float);     // floats a vector
  constexpr int kRows = T / kWarps;                 // rows a warp
  constexpr int kB = kRows < kBatch ? kRows : kBatch;
  constexpr int kPer = T > 32 ? T / 32 : 1;         // sort slots a lane
  static_assert(T % kWarps == 0 && kRows % kB == 0, "tile shape");
  __shared__ float s_dist[T];
  __shared__ int s_cnt[kWarps];
  __shared__ int s_last;
  extern __shared__ float sm[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = blockIdx.x, b = blockIdx.y;         // list L = p*nt + t
  const int nl = gridDim.x;
  const int p = L / nt, j0 = (L - p * nt) * T;
  const int kt = min(k, T);
  const int cid = probes[b * P + p];
  const int blk = cid < 0 ? -1 : (bmap ? bmap[cid] : cid);
  const int n = blk >= 0 ? min(lens[blk], CAP) : 0;

  // 1. distances of the tile's rows: warp w takes rows w, w + kWarps, ...
  if (j0 < n) {
    const int nv = d / kW;
    const V* qv = reinterpret_cast<const V*>(q + (size_t)b * d);
    float qq = 0.f;
    for (int v = lane; v < nv; v += 32) {
      const V a = qv[v];
      qq = dot4(a, a, qq);
    }
    qq = warp_sum(qq);
#pragma unroll
    for (int i0 = 0; i0 < kRows; i0 += kB) {
      const V* row[kB];
      bool ok[kB];
      float xx[kB], xq[kB];
#pragma unroll
      for (int r = 0; r < kB; ++r) {
        const int j = j0 + warp + kWarps * (i0 + r);
        ok[r] = j < n;
        row[r] = reinterpret_cast<const V*>(
            data + ((size_t)blk * CAP + (ok[r] ? j : 0)) * d);
        xx[r] = 0.f;
        xq[r] = 0.f;
      }
      for (int c0 = 0; c0 < nv; c0 += 32 * kChunks) {
        V x[kB][kChunks], qc[kChunks];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int v = c0 + c * 32 + lane;
          qc[c] = v < nv ? qv[v] : vzero<V>();
#pragma unroll
          for (int r = 0; r < kB; ++r)
            x[r][c] = (ok[r] && v < nv) ? row[r][v] : vzero<V>();
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int r = 0; r < kB; ++r) {
            xx[r] = dot4(x[r][c], x[r][c], xx[r]);
            xq[r] = dot4(x[r][c], qc[c], xq[r]);
          }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < kB; ++r) {
          xx[r] += __shfl_xor_sync(0xffffffffu, xx[r], off);
          xq[r] += __shfl_xor_sync(0xffffffffu, xq[r], off);
        }
      if (lane == 0)
#pragma unroll
        for (int r = 0; r < kB; ++r)
          s_dist[warp + kWarps * (i0 + r)] =
              ok[r] ? (xx[r] - 2.0f * xq[r]) + qq : inf_f();
    }
  }
  __syncthreads();

  // 2. the tile's sorted list: its first kt pairs, (inf, INT_MAX) past n
  const size_t lbase = ((size_t)b * nl + L) * kt;
  if (warp == 0) {
    float v[kPer];
    int f[kPer], sl[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * 32 + lane;
      const bool ok = e < T && j0 + e < n;
      v[i] = ok ? s_dist[e] : inf_f();
      f[i] = ok ? p * CAP + j0 + e : INT_MAX;
      sl[i] = ok ? blk * CAP + j0 + e : -1;
    }
    warp_bitonic_sort<kPer>(v, f, sl);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * 32 + lane;
      if (e < kt) {
        sc_d[lbase + e] = v[i];
        sc_f[lbase + e] = f[i];
        sc_s[lbase + e] = sl[i];
      }
    }
    __threadfence();                  // the list is visible before the ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(&tickets[b], 1);
    s_last = prev == nl - 1;
    if (s_last) tickets[b] = 0;       // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // 3. the last block of query b merges its nl lists into the top k
  float* td = sm;                                   // the top k
  int* tf = reinterpret_cast<int*>(sm + k);
  int* ts = reinterpret_cast<int*>(sm + 2 * k);
  float* nd = sm + 3 * k;                           // the next top k
  int* nf = reinterpret_cast<int*>(sm + 4 * k);
  int* ns = reinterpret_cast<int*>(sm + 5 * k);
  float* rd = sm + 6 * k;                           // the warps' runs [kWarps][32]
  int* rf = reinterpret_cast<int*>(rd + kThreads);
  int* rs = rf + kThreads;
  const size_t qbase = (size_t)b * nl * kt;
  const int M = nl * kt;
  // candidate e is entry e / nl of list e % nl (position-major: every
  // list's first entries come first, so the running k-th is tight after
  // the first pass); the next pass's loads are in flight during a pass
  auto at = [&](int e) { return qbase + (size_t)(e % nl) * kt + e / nl; };
  int e = threadIdx.x;
  float cd = e < M ? __ldcg(sc_d + at(e)) : inf_f();
  int cf = e < M ? __ldcg(sc_f + at(e)) : INT_MAX;
  int cs = e < M ? __ldcg(sc_s + at(e)) : -1;
  int cnt = 0;
  for (int base = 0; base < M; base += kThreads) {
    e += kThreads;
    const float pd = e < M ? __ldcg(sc_d + at(e)) : inf_f();
    const int pf = e < M ? __ldcg(sc_f + at(e)) : INT_MAX;
    const int ps = e < M ? __ldcg(sc_s + at(e)) : -1;
    // a candidate counts if it is valid and before the running k-th (or
    // the top is short); each warp sorts its own into a run of <= k
    const bool keep = cf != INT_MAX &&
        (cnt < k || min_before(cd, cf, td[k - 1], tf[k - 1]));
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    const int run = min(__popc(m), k);
    if (m) {                                        // warp-uniform
      float v[1] = {keep ? cd : inf_f()};
      int f[1] = {keep ? cf : INT_MAX}, sl[1] = {cs};
      warp_bitonic_sort<1>(v, f, sl);
      if (lane < run) {
        rd[threadIdx.x] = v[0];
        rf[threadIdx.x] = f[0];
        rs[threadIdx.x] = sl[0];
      }
    }
    if (lane == 0) s_cnt[warp] = run;
    __syncthreads();
    int rn[kWarps], S = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      rn[w] = s_cnt[w];
      S += rn[w];
    }
    if (S > 0) {                                    // block-uniform
      // each entry's rank in the union of the top and the runs (keys are
      // distinct): the entries before it in the top and in every run
      if (lane < run) {
        const float v = rd[threadIdx.x];
        const int f = rf[threadIdx.x];
        int lo = 0, hi = cnt;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (min_before(td[mid], tf[mid], v, f)) lo = mid + 1;
          else hi = mid;
        }
        const int r = lo + runs_before<kWarps>(rd, rf, rn, v, f);
        if (r < k) {
          nd[r] = v;
          nf[r] = f;
          ns[r] = rs[threadIdx.x];
        }
      }
      for (int i = threadIdx.x; i < cnt; i += kThreads) {
        const float v = td[i];
        const int f = tf[i];
        const int r = i + runs_before<kWarps>(rd, rf, rn, v, f);
        if (r < k) {
          nd[r] = v;
          nf[r] = f;
          ns[r] = ts[i];
        }
      }
      cnt = min(k, cnt + S);
      float* t0 = td; td = nd; nd = t0;
      int* t1 = tf; tf = nf; nf = t1;
      int* t2 = ts; ts = ns; ns = t2;
    }
    __syncthreads();                                // runs and s_cnt reused
    cd = pd;
    cf = pf;
    cs = ps;
  }
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const bool ok = i < cnt;
    out_d[(size_t)b * k + i] = ok ? td[i] : kNeg;
    out_i[(size_t)b * k + i] = ok ? ts[i] : -1;
  }
}

template <int T, typename V>
int launch_tile(const float* q, const float* data, const int* lens,
                const int* probes, const int* bmap, int B, int CAP, int d,
                int P, int k, int* scratch, int* tickets, float* out_d,
                int* out_i, cudaStream_t s) {
  const int nt = (CAP + T - 1) / T;
  const size_t n = (size_t)B * P * nt * (k < T ? k : T);
  const size_t smem = (size_t)(6 * k + 3 * kThreads) * sizeof(float);
  auto kern = ecoscan_kernel<T, V>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(P * nt, B), kThreads, smem, s>>>(
      q, data, lens, probes, bmap, CAP, d, P, nt, k,
      reinterpret_cast<float*>(scratch), scratch + n, scratch + 2 * n,
      tickets, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int launch(const void* q, const void* data, const void* lens,
           const void* probes, const void* bmap, int B, int CAP, int d,
           int P, int k, void* scratch, void* tickets, void* out_d,
           void* out_i, void* stream) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0;
  auto go = vec ? launch_tile<T, float4> : launch_tile<T, float>;
  return go(static_cast<const float*>(q), static_cast<const float*>(data),
            static_cast<const int*>(lens), static_cast<const int*>(probes),
            static_cast<const int*>(bmap), B, CAP, d, P, k,
            static_cast<int*>(scratch), static_cast<int*>(tickets),
            static_cast<float*>(out_d), static_cast<int*>(out_i),
            static_cast<cudaStream_t>(stream));
}

}  // namespace

// scratch: 3 * B * P * ceil(CAP / tile) * min(k, tile) words; tickets: B
// ints, zero before the launch and zero again after it.
extern "C" int ecoscan(const void* q, const void* data, const void* lens,
                       const void* probes, const void* bmap, int B, int CAP,
                       int d, int P, int k, void* scratch, void* tickets,
                       void* out_d, void* out_i, void* stream) {
  return launch<kTile>(q, data, lens, probes, bmap, B, CAP, d, P, k, scratch,
                       tickets, out_d, out_i, stream);
}

// The same scan at a forced tile of 16, 32 or 64 rows (for probes and
// checks; the wrapper always takes kTile).
extern "C" int ecoscan_tile(const void* q, const void* data, const void* lens,
                            const void* probes, const void* bmap, int B,
                            int CAP, int d, int P, int k, int tile,
                            void* scratch, void* tickets, void* out_d,
                            void* out_i, void* stream) {
  switch (tile) {
    case 16: return launch<16>(q, data, lens, probes, bmap, B, CAP, d, P, k,
                               scratch, tickets, out_d, out_i, stream);
    case 32: return launch<32>(q, data, lens, probes, bmap, B, CAP, d, P, k,
                               scratch, tickets, out_d, out_i, stream);
    case 64: return launch<64>(q, data, lens, probes, bmap, B, CAP, d, P, k,
                               scratch, tickets, out_d, out_i, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
