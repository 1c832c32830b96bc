"""Whisper-style encoder-decoder backbone (the port of
`repro.models.encdec`; whisper-small). [arXiv:2212.04356]

The conv / mel frontend is a stub, as in the reference: inputs are frame
embeddings [B, frames, d], projected by `frame_proj`. Positions are
sinusoidal (`layers.sinusoidal_positions`) on both sides, so no rotary
embedding (`rope_type` "none").

Attention is on the two kernels:
- the encoder's self-attention: `flash_prefill(causal=False)`;
- the decoder's self-attention: `flash_prefill(causal=True)` over the
  prompt, `decode_attention` over pos + 1 positions in a decode step;
- the decoder's cross-attention over the encoder's frames:
  `flash_prefill(causal=False)` with Sq (decoder positions) != Sk
  (frames), `decode_attention` over every frame in a decode step.

Training (`forward_logits(frames, dec_tokens)`, the reference's `encode`
then `decode_train`) runs the same layers with every attention through
`layers.attention` (the kernels have no backward): the encoder's
self-attention not causal, the decoder's causal, its cross-attention
over the encoder's output.

Weights are the reference's "enc_layers" and "dec_layers" trees
flattened with "enc_" and "dec_" prefixes (convert.py). `prefill`
returns the reference's cache {"k", "v" [Ld, B, Sd, G, dh], "cross_k",
"cross_v" [Ld, B, frames, G, dh]}; the serving engines grow only "k" and
"v" (`serving.engine.grow_cache`), and a decode step writes them in
place.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.dense import LM, attn_shapes, embed_shapes, mlp_shapes

# decoder positions per encoder frame in a training batch (the
# reference's `encdec.DEC_RATIO`: S frames go with S // 8 tokens)
DEC_RATIO = 8


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init), the reference's `encdec.defs` flattened: the
    encoder's attention and FFN "enc_*" [Le, ...], the decoder's
    attention, cross-attention ("dec_cross_*") and FFN "dec_*" [Ld, ...],
    and the embedding with `frame_proj`."""
    e = cfg.encdec
    defs = {**attn_shapes(cfg, e.encoder_layers, "enc_"),
            **mlp_shapes(cfg, e.encoder_layers, cfg.d_ff, "enc_"),
            **attn_shapes(cfg, e.decoder_layers, "dec_"),
            **attn_shapes(cfg, e.decoder_layers, "dec_cross_"),
            **mlp_shapes(cfg, e.decoder_layers, cfg.d_ff, "dec_")}
    defs.update(embed_shapes(cfg))
    return defs


class EncDecLM(LM):
    """Encoder-decoder: `encode(frames)`, then the decoder's `prefill`
    and `decode_step` (callers serve it directly; the `Engine` takes
    token-only families)."""

    FAMILY = "encdec"
    shapes = staticmethod(param_shapes)

    def _positions(self, n: int, offset: int, device):
        return L.sinusoidal_positions(n, self.cfg.d_model, offset,
                                      device).to(self.cfg.torch_dtype)

    def _attn(self, i: int, x, prefix: str, causal: bool, attn=None):
        """x + self-attention of rmsnorm(x) by `attn` (`ops.flash_prefill`
        when None); returns (the sum, k, v)."""
        b, S, _ = x.shape
        y = L.rmsnorm(x, getattr(self, prefix + "attn_norm")[i],
                      self.cfg.norm_eps)
        q, k, v = self._qkv(i, y, None, prefix)
        ctx = (attn or ops.flash_prefill)(q, k, v, causal=causal)
        return x + ctx.reshape(b, S, -1) @ getattr(self, prefix + "wo")[i], \
            k, v

    def cross_kv(self, i: int, enc_out):
        """Decoder layer i's cross-attention keys and values [B, frames,
        G, dh] of the encoder's output."""
        cfg = self.cfg
        b, s, _ = enc_out.shape
        hd = cfg.resolved_head_dim
        return ((enc_out @ self.dec_cross_wk[i]).reshape(
                    b, s, cfg.num_kv_heads, hd),
                (enc_out @ self.dec_cross_wv[i]).reshape(
                    b, s, cfg.num_kv_heads, hd))

    def _cross(self, i: int, x, ck, cv, attn=None):
        """x + cross-attention of rmsnorm(x) over (ck, cv): by `attn` (not
        causal) when given; else `flash_prefill` for a sequence,
        `decode_attention` over every frame for one position."""
        cfg = self.cfg
        b, s, _ = x.shape
        y = L.rmsnorm(x, self.dec_cross_attn_norm[i], cfg.norm_eps)
        q = (y @ self.dec_cross_wq[i]).reshape(b, s, cfg.num_heads,
                                               cfg.resolved_head_dim)
        if attn is not None:
            ctx = attn(q, ck, cv, causal=False)
        elif s == 1:
            ctx = ops.decode_attention(q[:, 0], ck, cv, ck.shape[1])
        else:
            ctx = ops.flash_prefill(q, ck, cv, causal=False)
        return x + ctx.reshape(b, s, -1) @ self.dec_cross_wo[i]

    def _enc_layer(self, i: int, x, attn=None):
        """Encoder layer i: self-attention (not causal) by `attn`, then
        the FFN."""
        return self._ffn(i, self._attn(i, x, "enc_", False, attn)[0], "enc_")

    def _encode(self, frames, attn=None):
        x = frames.to(self.cfg.torch_dtype) @ self.frame_proj
        x = x + self._positions(x.shape[1], 0, x.device)[None]
        for i in range(self.cfg.encdec.encoder_layers):
            x = self._remat(self._enc_layer, i, x, attn)
        return x

    @torch.no_grad()
    def encode(self, frames):
        """frames [B, frames, d] stub embeddings -> the encoder's output
        [B, frames, d] in the model's dtype."""
        return self._encode(frames)

    def _dec_layer(self, i: int, x, enc_out):
        """Decoder layer i of the training forward: causal self-attention,
        cross-attention over enc_out, the FFN, all through
        `L.attention`."""
        x = self._attn(i, x, "dec_", True, L.attention)[0]
        x = self._cross(i, x, *self.cross_kv(i, enc_out), L.attention)
        return self._ffn(i, x, "dec_")

    def forward_logits(self, frames, dec_tokens):
        """The training entry (the reference's `forward_logits`: `encode`,
        then `decode_train`): logits [B, Sd, V] of dec_tokens [B, Sd] int
        after the frames [B, F, d], every attention by `L.attention`, each
        layer under `_remat`."""
        enc_out = self._encode(frames, L.attention)
        x = self.tok_embed[dec_tokens].to(enc_out.dtype)
        x = x + self._positions(x.shape[1], 0, x.device)[None]
        for i in range(self.cfg.encdec.decoder_layers):
            x = self._remat(self._dec_layer, i, x, enc_out)
        return self.logits_from_hidden(
            L.rmsnorm(x, self.final_norm, self.cfg.norm_eps))

    def forward(self, batch):
        return self.forward_logits(batch["frames"], batch["dec_tokens"]), None

    @torch.no_grad()
    def prefill(self, frames, dec_tokens):
        """Encode frames [B, F, d], run the decoder over dec_tokens [B, Sd]
        int. Returns (last-position logits [B, V], {"k", "v" [Ld, B, Sd,
        G, dh], "cross_k", "cross_v" [Ld, B, F, G, dh]})."""
        enc_out = self.encode(frames)
        x = self.tok_embed[dec_tokens].to(enc_out.dtype)
        x = x + self._positions(x.shape[1], 0, x.device)[None]
        parts: Dict[str, list] = {"k": [], "v": [], "cross_k": [],
                                  "cross_v": []}
        for i in range(self.cfg.encdec.decoder_layers):
            x, k, v = self._attn(i, x, "dec_", causal=True)
            ck, cv = self.cross_kv(i, enc_out)
            x = self._ffn(i, self._cross(i, x, ck, cv), "dec_")
            for n, t in (("k", k), ("v", v), ("cross_k", ck),
                         ("cross_v", cv)):
                parts[n].append(t)
        return self.final_logits(x), {n: torch.stack(ts)
                                      for n, ts in parts.items()}

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One decoder position `pos` for every row, token [B, 1] int:
        its k, v go to slot pos of the self-attention cache (in place;
        it must hold pos + 1 slots), which it attends up to pos; it
        attends every frame of the cross cache. Returns logits [B, V]."""
        cfg = self.cfg
        b = token.shape[0]
        x = self.tok_embed[token].to(cfg.torch_dtype)
        x = x + self._positions(1, pos, x.device)[None]
        lens = torch.full((b,), pos + 1, dtype=torch.int32,
                          device=token.device)
        for i in range(cfg.encdec.decoder_layers):
            y = L.rmsnorm(x, self.dec_attn_norm[i], cfg.norm_eps)
            q, k, v = self._qkv(i, y, None, "dec_")
            ck, cv = cache["k"][i], cache["v"][i]
            ck[:, pos], cv[:, pos] = k[:, 0], v[:, 0]
            ctx = ops.decode_attention(q[:, 0], ck, cv, lens)
            x = x + ctx.reshape(b, 1, -1) @ self.dec_wo[i]
            x = self._cross(i, x, cache["cross_k"][i], cache["cross_v"][i])
            x = self._ffn(i, x, "dec_")
        return self.final_logits(x)
