// Flash-decode GQA attention over a contiguous KV cache on Hopper.
//
// Replaces the Pallas kernel
// src/repro/kernels/decode_attention.py::decode_attention
// (pallas_call at :188): one query position per row b against that row's
// cache k/v [B, S, G, dh]. Positions >= kv_len[b] are masked with -1e30;
// online softmax with scale 1/sqrt(dh) and scores in f32; probabilities
// are rounded to the value type before the PV product; the output is
// acc / max(l, 1e-30). A ring cache (`ring=True`, sliding window) masks
// min(kv_len, S) positions; over S positions that is the same mask as
// pos < kv_len, so the kernel needs no ring flag: a row walks its first
// n = min(kv_len, S) positions (all S when kv_len <= 0, every position
// then masked: the uniform average, as the plain version gives).
//
// The kernels' bodies, their bound and their design are decode_body.cuh's,
// shared with decode_attention_paged.cu; this source gives them the rows
// of a contiguous cache (`CacheRows`). Split s covers the tiles
// [s*T/splits, (s+1)*T/splits) of the T tiles of kTile positions of S
// (`ref.decode_split_ranges`; `ops.decode_split_plan` takes splits of at
// least two tiles, and none where that gives two or fewer: the merge in
// the last split block costs about three tiles of time). Routes
// (`ops.decode_route`): the tensor cores for a bf16 cache, the CUDA cores
// for f32, for a dh outside the tensor-core list and for the int8 cache.
//
// The int8 cache (`decode_attention_q8`, the plain jnp function
// src/repro/models/layers.py::decode_attention_q8 at :227, which the
// port runs on the card): int8 K/V rows (16 a 16-byte copy) and f32
// scales k_scale, v_scale [B, S, G], one a position and kv head, on the
// CUDA cores. Bound: bytes, dh + 8 a position and kv head for K and V
// together with their scales.
#include "decode_body.cuh"

namespace {

// row b's positions of a cache [B, S, G, dh], in order
struct CacheRows {
  static constexpr bool kTable = false;
  int S;
  __device__ int2 span(int sp, int splits) const {
    const int tiles = (S + kTile - 1) / kTile;
    return make_int2(
        (int)((long long)sp * tiles / splits) * kTile,
        min(S, (int)((long long)(sp + 1) * tiles / splits) * kTile));
  }
  __device__ int end(int len) const { return len > 0 ? min(len, S) : S; }
  __device__ size_t slot(int b, int pos) const { return (size_t)b * S + pos; }
};

}  // namespace

// `route` 1 takes the tensor cores (a bf16 cache), 0 the CUDA cores;
// `stages` and `smem` from ops (decode_body.cuh's `launch_decode`)
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* kv_len, int B, int S, int H,
                                    int G, int dh, float scale, int splits,
                                    int hgroups, int route, int stages,
                                    int smem, void* part, void* tickets,
                                    void* out, void* stream) {
  return launch_decode<float, float, false>(
      q, k, nullptr, v, nullptr, kv_len, CacheRows{S}, B, H, G, dh, scale,
      splits, hgroups, route, stages, smem, part, tickets, out, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* kv_len, int B, int S, int H,
                                     int G, int dh, float scale, int splits,
                                     int hgroups, int route, int stages,
                                     int smem, void* part, void* tickets,
                                     void* out, void* stream) {
  return launch_decode<__nv_bfloat16, __nv_bfloat16, true>(
      q, k, nullptr, v, nullptr, kv_len, CacheRows{S}, B, H, G, dh, scale,
      splits, hgroups, route, stages, smem, part, tickets, out, stream);
}

// int8 cache: k, v [B, S, G, dh] int8; k_scale, v_scale [B, S, G] f32; the
// CUDA cores
extern "C" int decode_attention_q8_f32(const void* q, const void* k,
                                       const void* k_scale, const void* v,
                                       const void* v_scale, const void* kv_len,
                                       int B, int S, int H, int G, int dh,
                                       float scale, int splits, int hgroups,
                                       int stages, int smem, void* part,
                                       void* tickets, void* out,
                                       void* stream) {
  return launch_decode<float, int8_t, false>(
      q, k, k_scale, v, v_scale, kv_len, CacheRows{S}, B, H, G, dh, scale,
      splits, hgroups, 0, stages, smem, part, tickets, out, stream);
}

extern "C" int decode_attention_q8_bf16(const void* q, const void* k,
                                        const void* k_scale, const void* v,
                                        const void* v_scale, const void* kv_len,
                                        int B, int S, int H, int G, int dh,
                                        float scale, int splits, int hgroups,
                                        int stages, int smem, void* part,
                                        void* tickets, void* out,
                                        void* stream) {
  return launch_decode<__nv_bfloat16, int8_t, false>(
      q, k, k_scale, v, v_scale, kv_len, CacheRows{S}, B, H, G, dh, scale,
      splits, hgroups, 0, stages, smem, part, tickets, out, stream);
}
