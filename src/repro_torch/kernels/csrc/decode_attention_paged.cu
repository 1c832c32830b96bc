// Block-table flash-decode GQA attention on Hopper.
//
// Replaces the Pallas kernel
// src/repro/kernels/decode_attention.py::decode_attention_paged
// (pallas_call at :135): one query position per row b against K/V that
// live in a page pool [P, ps, G, dh] and are read through the row's page
// table [W] (entry w backs positions [w*ps, (w+1)*ps)). Positions >=
// kv_len[b] are masked with -1e30; online softmax with scale 1/sqrt(dh)
// and scores in f32; probabilities are rounded to the value type before
// the PV product (as `p.astype(v.dtype)` does in the TPU kernel); the
// output is acc / max(l, 1e-30). A row counts its first
// npg = ceil(kv_len / ps) table entries (all W when kv_len <= 0, every
// position then masked: the uniform average, as the plain version gives).
//
// The kernels' bodies, their bound and their design are decode_body.cuh's,
// shared with decode_attention.cu; this source gives them the rows of a
// page table (`PageRows`). Split s covers the table entries
// [s*W/splits, (s+1)*W/splits) (`ref.decode_paged_split_ranges`), cut at
// the row's npg, which the block computes from kv_len on the device (no
// host sync); `ops.decode_paged_split_plan` picks the splits and head
// groups from host-known shapes (B, G, W, ps, Hg) by decode_attention's
// rule over the table's W*ps positions. Each row of a tile finds its own
// page through the table, so a tile may span pages (ps 16, 24), and
// nothing assumes two entries are neighbours in the pool (tables repeat,
// reverse and point tail entries at page 0). Routes
// (`ops.decode_paged_route`): the tensor cores for a bf16 q over a bf16
// pool or an int8 one, at dh 32, 64, 80, 128 and 256 and any Hg <= 16;
// the CUDA cores for f32 q (the 1e-5 check) and other dh. Either way a
// call is one launch: the merge runs in the last split block.
//
// The int8 pool (`decode_attention_paged_q8`; the reference gathers the
// pages with jnp and calls src/repro/models/layers.py::decode_attention_q8
// at :227): int8 pages with f32 scale planes k_scale, v_scale [P, ps, G]
// read through the same table, so decode reads int8 bytes and no
// dequantized copy of a slot's pages is ever written. Rows are masked by
// kv_len, so a ring (sliding window) whose ring_len is not a multiple of
// ps reads its last page only up to kv_len. Bound: bytes, dh + 8 a
// position and kv head for K and V with their scales.
#include "decode_body.cuh"

namespace {

// row b's positions through its page table [B, W] of ps-position pages
struct PageRows {
  static constexpr bool kTable = true;
  const int* table;
  int ps, W;
  __device__ int2 span(int sp, int splits) const {
    return make_int2((int)((long long)sp * W / splits) * ps,
                     (int)((long long)(sp + 1) * W / splits) * ps);
  }
  __device__ int end(int len) const {
    return (len > 0 ? min(W, (len + ps - 1) / ps) : W) * ps;
  }
  __device__ size_t slot(int b, int pos) const {
    return (size_t)__ldg(table + (size_t)b * W + pos / ps) * ps + pos % ps;
  }
};

}  // namespace

// float pool: k, v [P, ps, G, dh] in q's type. `route` 1 takes the
// tensor cores (bf16), 0 the CUDA cores; `stages` and `smem` from ops
// (decode_body.cuh's `launch_decode`)
extern "C" int decode_attention_paged_f32(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* table, int B, int H, int G, int dh, int ps, int W,
    float scale, int splits, int hgroups, int route, int stages, int smem,
    void* part, void* tickets, void* out, void* stream) {
  return launch_decode<float, float, false>(
      q, k, nullptr, v, nullptr, kv_len,
      PageRows{static_cast<const int*>(table), ps, W}, B, H, G, dh, scale,
      splits, hgroups, route, stages, smem, part, tickets, out, stream);
}

extern "C" int decode_attention_paged_bf16(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* table, int B, int H, int G, int dh, int ps, int W,
    float scale, int splits, int hgroups, int route, int stages, int smem,
    void* part, void* tickets, void* out, void* stream) {
  return launch_decode<__nv_bfloat16, __nv_bfloat16, true>(
      q, k, nullptr, v, nullptr, kv_len,
      PageRows{static_cast<const int*>(table), ps, W}, B, H, G, dh, scale,
      splits, hgroups, route, stages, smem, part, tickets, out, stream);
}

// int8 pool: k, v [P, ps, G, dh] int8; k_scale, v_scale [P, ps, G] f32
extern "C" int decode_attention_paged_q8_f32(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* kv_len, const void* table, int B, int H,
    int G, int dh, int ps, int W, float scale, int splits, int hgroups,
    int route, int stages, int smem, void* part, void* tickets, void* out,
    void* stream) {
  return launch_decode<float, int8_t, false>(
      q, k, k_scale, v, v_scale, kv_len,
      PageRows{static_cast<const int*>(table), ps, W}, B, H, G, dh, scale,
      splits, hgroups, route, stages, smem, part, tickets, out, stream);
}

extern "C" int decode_attention_paged_q8_bf16(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* kv_len, const void* table, int B, int H,
    int G, int dh, int ps, int W, float scale, int splits, int hgroups,
    int route, int stages, int smem, void* part, void* tickets, void* out,
    void* stream) {
  return launch_decode<__nv_bfloat16, int8_t, true>(
      q, k, k_scale, v, v_scale, kv_len,
      PageRows{static_cast<const int*>(table), ps, W}, B, H, G, dh, scale,
      splits, hgroups, route, stages, smem, part, tickets, out, stream);
}
