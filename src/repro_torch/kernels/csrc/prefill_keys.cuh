// The key walk of flash_prefill's three routes (csrc/flash_prefill.cu's
// f32 and `tc` kernels, csrc/flash_prefill_sm90.cu's `wgmma` kernel).
#pragma once

// [kbeg, kend): the key positions that a block of query rows at absolute
// positions [qlo, qhi] visits, kbeg rounded down to a tile. The last row
// is the most masked one; when it has no unmasked key, the block visits
// every key of Sk so that such rows get the uniform average.
__device__ __forceinline__ void key_range(int qlo, int qhi, int Sk, int causal,
                                          int window, int kv_len, int tile,
                                          int& kbeg, int& kend) {
  kend = causal ? min(kv_len, qhi + 1) : kv_len;
  kbeg = window > 0 ? max(0, qlo - window + 1) / tile * tile : 0;
  if (kend <= (window > 0 ? max(0, qhi - window + 1) : 0)) {
    kbeg = 0;
    kend = Sk;
  }
}
