"""Dense LM (the port of `repro.models.dense`: RoPE, M-RoPE or no rotary
embedding; a SwiGLU, squared-ReLU or GELU FFN; optionally a sliding
window, an int8 KV cache and tensor-parallel serving), the
bidirectional encoder of gte-small (`encode`: mean-pooled, unit-norm
sentence embeddings) and the vision branch of qwen2-vl-2b: the first
N_IMG positions of a sequence are stub patch embeddings projected by
`patch_proj`, and M-RoPE ids place them on an IMG_GRID x IMG_GRID grid
(`mrope_positions`).

`DenseLM` keeps the reference's parameter layout: per-layer weights are
stacked on a leading layer axis ([L, d, out]) and applied as `x @ w`.
Two serving paths, each attention on a kernel:

- the wave path: `prefill` runs the full prompt through `flash_prefill`
  and returns a contiguous cache [L, B, Sc, G, dh]; `decode_step` writes
  one position into it and runs `decode_attention`. A sliding-window
  cache is a ring of Sc = window slots: position p lives in slot p % Sc.
- the paged path: `decode_step_paged` runs one `decode_attention_paged`
  kernel per layer directly on that layer's page pool (the reference
  gathers pages with jnp and calls `layers.decode_attention`, the same
  function); `prefill_chunk_paged` runs one `flash_prefill_paged`
  kernel per layer, which reads the slot's history through its page
  table (positions in order, from the pool; the reference gathers them
  with jnp and calls `layers.attention`), then the chunk, at the
  chunk's query offset. A sliding-window slot is a ring of `ring_len`
  positions over its pages: position p at ring cursor p % ring_len (a
  slot without a window is a ring that never wraps).

With `kv_quant` the caches and pools hold int8 values and f32 scales per
position and kv head ({"k", "k_s", "v", "v_s"}): prefill and chunks
attend `dequantize_kv(quantize_kv(k))`, the values decode reads back, and
decode runs the int8 kernels `decode_attention_q8` and
`decode_attention_paged_q8` on the int8 bytes and the scales.

Tensor-parallel serving: a `DenseLM` built while a mesh with a "model"
axis is installed (`dist.sharding.use_mesh`), or given `shard=(tp,
rank)`, holds rank r's part of the weights (`models.model.tp_layout`:
the query heads, their kv heads, the FFN's columns and rows, the
vocabulary range; whole `params` are narrowed, random ones drawn for the
part alone) and serves Megatron-style, with no-grad collectives over
"model" (`dist.collectives.AxisGroup`): q, k, v at its heads (the wave
cache and the attention kernels at (H / tp, its kv heads)), `wo` and
`w2` row-parallel, each followed by one all-reduce; the embedding
vocabulary-parallel (the rank's rows, zeros elsewhere, one all-reduce);
the logits of the rank's vocabulary slice all-gathered to [B, V]. A part
that does not divide stays whole on every rank, with no collective.
Training and the paged path serve one device: a TP model refuses them.

`MoELM` (models/moe.py) shares all of this and replaces the FFN.
Caches and page pools are updated in place. `LM` is the part every
family shares: the parameters (the reference's init kinds and its f32
recurrence parameters), the embedding and the output head.

Training (`forward_logits`, `forward`; `models/model.py` `loss_fn`)
runs the same blocks with the attention passed in: `_full_block` takes
`attn`, which serving leaves at `ops.flash_prefill` (a kernel without a
backward) and training sets to `layers.attention`, the reference's plain
function. The training forward is not under `torch.no_grad()`, runs
each layer under `torch.utils.checkpoint` when `cfg.remat`, and computes
with whatever weights `bound` gives the model (the trainer's f32 masters
cast to the compute dtype).
"""
from __future__ import annotations

import contextlib
import math
import zlib
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.dist import sharding as sh
from repro_torch.dist.collectives import AxisGroup
from repro_torch.kernels import ops
from repro_torch.models import layers as L


N_IMG = 256          # stub visual tokens at the head of a vision sequence
IMG_GRID = 16        # their 16 x 16 patch grid (M-RoPE spatial ids)


def embed_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The reference's `embed_defs`: the token embedding, the final norm,
    the untied output head, and the stub frontends' projections
    (`patch_proj` for vision, `frame_proj` for audio)."""
    d = cfg.d_model
    defs = {"tok_embed": ((cfg.vocab_padded, d), "normal"),
            "final_norm": ((d,), "zeros")}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((d, cfg.vocab_padded), "normal")
    if cfg.modality == "vision":
        defs["patch_proj"] = ((d, d), "normal")
    if cfg.modality == "audio":
        defs["frame_proj"] = ((d, d), "normal")
    return defs


def attn_shapes(cfg: ModelConfig, n: int, prefix: str = ""
                ) -> Dict[str, tuple]:
    """The reference's `attn_defs`: n stacked attention layers."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, max(cfg.num_kv_heads, 1)
    defs = {
        f"{prefix}attn_norm": ((n, d), "zeros"),
        f"{prefix}wq": ((n, d, h * hd), "normal"),
        f"{prefix}wk": ((n, d, kv * hd), "normal"),
        f"{prefix}wv": ((n, d, kv * hd), "normal"),
        f"{prefix}wo": ((n, h * hd, d), "normal"),
    }
    if cfg.qkv_bias:
        defs[f"{prefix}bq"] = ((n, h * hd), "zeros")
        defs[f"{prefix}bk"] = ((n, kv * hd), "zeros")
        defs[f"{prefix}bv"] = ((n, kv * hd), "zeros")
    return defs


def mlp_shapes(cfg: ModelConfig, n: int, d_ff: int, prefix: str = ""
               ) -> Dict[str, tuple]:
    """The reference's `mlp_defs`: n stacked FFNs (w3 only for SwiGLU)."""
    d = cfg.d_model
    defs = {
        f"{prefix}mlp_norm": ((n, d), "zeros"),
        f"{prefix}w1": ((n, d, d_ff), "normal"),
        f"{prefix}w2": ((n, d_ff, d), "normal"),
    }
    if cfg.act == "swiglu":
        defs[f"{prefix}w3"] = ((n, d, d_ff), "normal")
    return defs


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init) with init "normal" (N(0, 0.02)) or "zeros",
    the reference's `dense.defs` flattened (layer weights stacked)."""
    defs = {**attn_shapes(cfg, cfg.num_layers),
            **mlp_shapes(cfg, cfg.num_layers, cfg.d_ff)}
    defs.update(embed_shapes(cfg))
    return defs


def mrope_positions(S: int, device=None) -> torch.Tensor:
    """Qwen2-VL M-RoPE ids [S, 3]: the first N_IMG positions (patches)
    get (0, row, col) on the IMG_GRID grid; text position j after them
    gets IMG_GRID + j - N_IMG on all three streams."""
    idx = torch.arange(S, device=device)
    img = idx < N_IMG
    txt = IMG_GRID + idx - N_IMG
    t = torch.where(img, torch.zeros_like(idx), txt)
    h = torch.where(img, idx // IMG_GRID, txt)
    w = torch.where(img, idx % IMG_GRID, txt)
    return torch.stack([t, h, w], dim=-1)


def mrope_positions_decode(pos: int, b: int, device=None) -> torch.Tensor:
    """The M-RoPE ids [b, 1, 3] of the text position `pos`."""
    return torch.full((b, 1, 3), IMG_GRID + pos - N_IMG, device=device)


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Slots of a wave cache for `seq_len` positions: capped at the
    sliding window, whose cache is a ring."""
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def _kv_planes(cfg: ModelConfig, shape, device) -> Dict[str, torch.Tensor]:
    """Zeroed K/V planes of `shape` [..., G, dh]: in the model's dtype,
    or with `kv_quant` int8 values plus f32 scales [..., G] ("k_s",
    "v_s")."""
    dev = resolve_device(device)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(shape[:-1], device=dev),
                "v_s": torch.zeros(shape[:-1], device=dev)}
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}


def init_cache(cfg: ModelConfig, b: int, seq_len: int, device="cuda",
               kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Contiguous wave KV cache: {"k", "v"} of [L, b, cache_len(cfg,
    seq_len), G, dh] (+ "k_s", "v_s" [L, b, Sc, G] with `kv_quant`); G is
    `kv_heads` (a tensor-parallel rank's) or the config's."""
    return _kv_planes(cfg, (cfg.num_layers, b, cache_len(cfg, seq_len),
                            kv_heads or cfg.num_kv_heads,
                            cfg.resolved_head_dim), device)


def init_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Block-table KV pool: {"k", "v"} of [L, num_pages, page_size, G, dh]
    (+ "k_s", "v_s" [L, num_pages, page_size, G] with `kv_quant`)."""
    return _kv_planes(cfg, (cfg.num_layers, num_pages, page_size,
                            cfg.num_kv_heads, cfg.resolved_head_dim), device)


def chunk_rows(row, offset: int, c: int, limit: int, page_size: int,
               ring_len: int = 0, *, tile: int):
    """Where a [C]-token prompt chunk at positions [offset, offset + C)
    reads and writes the slot whose page-table row is `row` ([W] int32).
    Position p lives at cursor p % ring_len of a sliding-window ring, at
    cursor p without one (a ring of W * page_size that never wraps).
    Returns (lo, (page, offset)): the history is positions [lo, offset)
    (their flat pool rows: `ref.history_rows`); the chunk's real tokens
    (p < limit, and p < W * page_size without a ring) are written at
    (page, offset). lo is max(0, offset - ring) rounded down to `tile`,
    the key tile of the route that flash_prefill_paged takes at the
    attention's dtype and head dim (`ops.prefill_paged_key_tile`): the
    history holds every query's window (the positions the rounding adds
    lie outside it, masked), attention depends on positions only through
    their differences, and the keys fall into the kernel's tiles at
    absolute positions, as in the wave path's full prefill. The chunk
    attends [lo, offset + C) at query offset offset - lo."""
    ps = page_size
    ring = ring_len or row.shape[0] * ps
    end = limit if ring_len else min(limit, ring)
    rowl = row.long()
    lo = max(0, offset - ring) // tile * tile
    lw = torch.arange(offset, max(offset, min(offset + c, end)),
                      device=row.device) % ring
    return lo, (rowl[lw // ps], lw % ps)


def _fake_quant(t):
    """The values an int8 cache hands back for t."""
    return L.dequantize_kv(*L.quantize_kv(t), t.dtype)


# parameters the reference keeps in f32 whatever the compute dtype
# (`repro.models.common.F32_KEEP`: the recurrences' decay and skip terms)
F32_KEEP = ("lam", "A_log", "dt_bias", "D")
# a random tensor of more elements than DRAW_WHOLE is drawn in runs of
# DRAW_SLICE elements (its flat order), so that its f32 draw never holds
# more than a run beside the tensor itself
DRAW_WHOLE = 2 ** 31
DRAW_SLICE = 2 ** 27


def keeps_f32(name: str) -> bool:
    """Whether parameter `name` (a flat name, any prefix) stays f32."""
    return any(name == k or name.endswith("_" + k) for k in F32_KEEP)


def _draw(init: str, shape, gen, dev) -> torch.Tensor:
    """One f32 tensor of the reference's init kind: "normal" N(0, 0.02);
    "dt_bias" softplus^-1 of U(1e-3, 1e-1); "a_log" log U(1, 16); "lam"
    softplus^-1 of -log(u) / 8 for u ~ U(0.38, 0.8) (RG-LRU decays in
    about (0.9, 0.999); 8 is `rglru.RG_C`)."""
    if init == "normal":
        return torch.randn(shape, generator=gen, device=dev) * 0.02
    u = torch.rand(shape, generator=gen, device=dev)
    if init == "dt_bias":
        return torch.log(torch.expm1(u * (1e-1 - 1e-3) + 1e-3))
    if init == "a_log":
        return torch.log(u * 15.0 + 1.0)
    if init == "lam":
        return torch.log(torch.exp(-torch.log(u * 0.42 + 0.38) / 8.0) - 1.0)
    raise ValueError(f"unknown init {init!r}")


def part_generator(seed: int, name: str, part: int, dev) -> torch.Generator:
    """The generator of a tensor-parallel part's random draw: from (seed,
    the parameter's name, the part's index), so the ranks that hold the
    same part draw the same values, whatever their rank."""
    key = (seed * 1_000_003 + zlib.crc32(f"{name}/{part}".encode())) % 2**63
    return torch.Generator(device=dev).manual_seed(key)


def random_tensor(init: str, shape, dtype, gen, dev) -> torch.Tensor:
    """A random tensor of `init` kind in `dtype`, drawn in f32 from `gen`:
    whole, or in runs of DRAW_SLICE elements of its flat order when it
    has more than DRAW_WHOLE (arctic's experts: 17.8 GB in bf16 for two
    layers)."""
    n = math.prod(shape)
    if n <= DRAW_WHOLE:
        return _draw(init, shape, gen, dev).to(dtype)
    t = torch.empty(shape, dtype=dtype, device=dev)
    flat = t.view(-1)
    for lo in range(0, n, DRAW_SLICE):
        m = min(DRAW_SLICE, n - lo)
        flat[lo:lo + m] = _draw(init, (m,), gen, dev).to(dtype)
    return t


@contextlib.contextmanager
def bound(model: nn.Module, params: Mapping[str, torch.Tensor]):
    """Inside the block, `model` computes with `params` (name -> tensor,
    names of its parameters) in place of its own weights. Each tensor is
    set in the instance's `__dict__`, which attribute lookup reads before
    `nn.Module`'s parameter table, and the entries there before come back
    on exit, so bindings nest. Unlike `torch.func.functional_call`, a
    binding can be opened again around a remat recompute in the backward
    pass (`LM._remat`), after the forward's own binding has closed."""
    unknown = [n for n in params if n not in model._parameters]
    if unknown:
        raise KeyError(f"not parameters of the model: {unknown}")
    prev = {n: model.__dict__[n] for n in params if n in model.__dict__}
    model.__dict__.update(params)
    try:
        yield model
    finally:
        for n in params:
            if n in prev:
                model.__dict__[n] = prev[n]
            else:
                model.__dict__.pop(n, None)


class LM(nn.Module):
    """What every family shares: one parameter a flat name of `shapes(cfg)`
    (layer weights stacked on a leading axis), the token embedding
    (scaled by sqrt(d) when tied) and the output head. `params` (name ->
    tensor) loads given weights; without it the weights are random from
    `seed`, drawn on the device. F32_KEEP parameters stay f32, the rest
    take the config's dtype.

    A family with `TENSOR_PARALLEL` (the dense one) built under a mesh
    with a "model" axis, or given `shard=(tp, rank)`, holds rank's part
    (`tp`: its `models.model.TPLayout`, None otherwise): whole `params`
    are narrowed to it (`convert.shard_params`; a part given as it is is
    taken), random ones drawn for the part alone from (seed, name, the
    part's index). Its collectives run over `group` (an `AxisGroup` of
    the mesh's "model" axis by default; any object with `all_reduce(t)`
    and `all_gather(t, dim)`). A part of tp on a group of one rank is one
    rank's share of the work: the collectives are the identity there."""

    FAMILY = ""
    TENSOR_PARALLEL = False
    shapes = staticmethod(embed_shapes)

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 shard: Optional[Tuple[int, int]] = None, group=None):
        super().__init__()
        if cfg.family != self.FAMILY:
            raise ValueError(f"{cfg.name}: family {cfg.family!r}, not "
                             f"{self.FAMILY!r} (models.model.build_model)")
        self.cfg = cfg
        self.tp, self.tp_group = self._tp_part(shard, group)
        self.heads = self.tp.heads if self.tp else cfg.num_heads
        self.kv_heads = self.tp.kv_heads if self.tp else cfg.num_kv_heads
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, (whole, init) in self.shapes(cfg).items():
            dtype = torch.float32 if keeps_f32(name) else cfg.torch_dtype
            shape = self.tp.local_shape(name, whole) if self.tp else whole
            if params is not None:
                t = params[name]
                if self.tp and tuple(t.shape) != shape and \
                        tuple(t.shape) == whole:
                    t = t.narrow(*self.tp.cuts[name])
                if tuple(t.shape) != shape:
                    raise ValueError(f"{name}: {tuple(t.shape)} != {shape}")
                t = t.to(device=dev, dtype=dtype).clone()
            elif init == "zeros":
                t = torch.zeros(shape, dtype=dtype, device=dev)
            else:
                g = (part_generator(seed, name, self.tp.part(name), dev)
                     if self.tp else gen)
                t = random_tensor(init, shape, dtype, g, dev)
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def _tp_part(self, shard, group):
        """(the rank's TPLayout, its group), or (None, None) for a whole
        model: off-mesh without `shard`, or a family without
        TENSOR_PARALLEL."""
        mesh = sh.get_mesh()
        if not self.TENSOR_PARALLEL:
            if shard is not None:
                raise ValueError(f"{self.cfg.name}: the {self.FAMILY} "
                                 "family serves one device")
            return None, None
        has_model = "model" in sh.mesh_shape(mesh)
        if shard is None:
            if not has_model:
                return None, None
            shard = (sh.mesh_shape(mesh)["model"],
                     sh.local_index(mesh, ("model",))[0])
        if group is None:
            if not has_model:
                raise ValueError("a tensor-parallel part needs a group: "
                                 "a mesh with a \"model\" axis, or group=")
            group = AxisGroup(mesh, ("model",))
        if group.size not in (1, shard[0]):
            raise ValueError(f"a part of tp {shard[0]} on a group of "
                             f"{group.size} ranks")
        from repro_torch.models.model import tp_layout
        return tp_layout(self.cfg, *shard), group

    def _one_device(self, what: str) -> None:
        """Raise for a tensor-parallel part: `what` runs whole models."""
        if self.tp:
            raise NotImplementedError(f"{self.cfg.name}: {what} serves one "
                                      "device, not a tensor-parallel part")

    def _tp_sum(self, y, split: bool):
        """y summed over "model" where the part it came from is `split`
        (an attention or FFN output of the rank's heads or columns)."""
        return self.tp_group.all_reduce(y) if split else y

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def local_weights(self, mesh) -> Dict[str, int]:
        """The masters this model takes on `mesh` as this rank's shards
        and gathers in its layers (name -> the gathered dimension of the
        stacked tensor); the train step gathers every other master whole
        (`train.trainer.mesh_step`). None here."""
        return {}

    def forward(self, batch):
        """The training forward of a batch (name -> tensor: "tokens", and
        by family "patches", or "frames" and "dec_tokens"): (logits [B,
        S, V], the MoE aux loss summed over the layers, or None)."""
        return self.forward_logits(batch["tokens"]), None

    def _remat(self, fn, *args):
        """fn(*args), under `torch.utils.checkpoint` (non-reentrant) when
        `cfg.remat` and grad mode is on: the layer keeps its inputs and
        recomputes the rest in the backward pass, as the reference's
        `jax.checkpoint` does. The recompute runs after the forward has
        returned, so it binds again the weights that the forward ran on."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return fn(*args)
        weights = {n: self.__dict__[n] for n in self._parameters
                   if n in self.__dict__}

        def run(*a):
            with bound(self, weights):
                return fn(*a)
        return checkpoint(run, *args, use_reentrant=False)

    def _token_rows(self, tokens):
        """tok_embed's rows of tokens; under a vocabulary split the rank's
        rows (zeros for a token outside its range) summed over "model"."""
        if not (self.tp and self.tp.vocab):
            return self.tok_embed[tokens]
        _, lo, n = self.tp.cuts["tok_embed"]
        local = tokens - lo
        inside = ((local >= 0) & (local < n))[..., None]
        rows = self.tok_embed[local.clamp(0, n - 1)]
        return self.tp_group.all_reduce(
            torch.where(inside, rows, torch.zeros_like(rows)))

    def _embed(self, tokens):
        scale = self.cfg.d_model ** 0.5 if self.cfg.tie_embeddings else 1.0
        return (self._token_rows(tokens) * scale).to(self.cfg.torch_dtype)

    def _rope(self, x, positions):
        """RoPE over positions [B, S], M-RoPE over ids [B, S, 3], or x as
        it is (`rope_type` "none")."""
        cfg = self.cfg
        if cfg.rope_type == "mrope":
            return L.apply_mrope(x, positions, cfg.mrope_sections,
                                 cfg.rope_theta)
        if cfg.rope_type == "rope":
            return L.apply_rope(x, positions, cfg.rope_theta)
        return x

    def _qkv(self, i: int, x, positions, prefix: str = ""):
        """q [B, S, H, dh], k, v [B, S, G, dh] of the attention layer
        `prefix` + "wq"... at index i of its stack, rotated."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        b, s, _ = x.shape

        def p(n):
            return getattr(self, prefix + n)[i]
        q, k, v = x @ p("wq"), x @ p("wk"), x @ p("wv")
        if cfg.qkv_bias:
            q, k, v = q + p("bq"), k + p("bk"), v + p("bv")
        q = self._rope(q.reshape(b, s, self.heads, hd), positions)
        k = self._rope(k.reshape(b, s, self.kv_heads, hd), positions)
        return q, k, v.reshape(b, s, self.kv_heads, hd)

    def _attn_out(self, i: int, ctx):
        """Layer i's output projection of ctx [B, S, heads * dh] (the
        rank's heads' rows of `wo`, summed over "model")."""
        return self._tp_sum(ctx @ self.wo[i], bool(self.tp and self.tp.attn))

    def _ffn(self, i: int, x, prefix: str = ""):
        """x + the FFN `prefix` + "w1"... at index i (SwiGLU, or
        squared-ReLU or GELU without w3) of rmsnorm(x)."""
        cfg = self.cfg

        def p(n):
            return getattr(self, prefix + n)[i]
        y = L.rmsnorm(x, p("mlp_norm"), cfg.norm_eps)
        w3 = p("w3") if cfg.act == "swiglu" else None
        return x + self._tp_sum(L.mlp(y, p("w1"), p("w2"), w3, cfg.act),
                                bool(self.tp and self.tp.ffn))

    def logits_from_hidden(self, x):
        """Logits [..., V] of hidden states x [..., d]; under a vocabulary
        split the rank's slice, all-gathered over "model"."""
        head = self.tok_embed.T if self.cfg.tie_embeddings else self.lm_head
        y = x @ head.to(x.dtype)
        if self.tp and self.tp.vocab:
            y = self.tp_group.all_gather(y, -1)
        return y

    def final_logits(self, x):
        """Logits [B, V] of the last position of x [B, S, d]."""
        x = L.rmsnorm(x[:, -1:], self.final_norm, self.cfg.norm_eps)
        return self.logits_from_hidden(x)[:, 0]


class DenseLM(LM):
    """Dense decoder over a paged KV pool (`LM`'s parameters, the
    `param_shapes` layout)."""

    FAMILY = "dense"
    TENSOR_PARALLEL = True
    shapes = staticmethod(param_shapes)

    # ------------------------------------------------------------ blocks

    def _embed_inputs(self, tokens, patches=None):
        """(x [B, S, d], positions) of a sequence: tokens [B, S] at
        positions [B, S]; for a vision config the first N_IMG positions
        are patches [B, N_IMG, d] @ patch_proj (scaled like the tokens
        after them) at the M-RoPE ids [B, S, 3] of `mrope_positions`."""
        cfg = self.cfg
        b, S = tokens.shape
        dev = tokens.device
        if cfg.modality == "vision":
            if patches is None or patches.shape[1] != N_IMG:
                raise ValueError(f"{cfg.name}: a vision sequence starts "
                                 f"with {N_IMG} patches")
            scale = cfg.d_model ** 0.5 if cfg.tie_embeddings else 1.0
            txt = self._token_rows(tokens[:, N_IMG:])
            img = patches.to(txt.dtype) @ self.patch_proj
            x = (torch.cat([img, txt], dim=1) * scale).to(cfg.torch_dtype)
            return x, mrope_positions(S, dev)[None].expand(b, S, 3)
        return (self._embed(tokens),
                torch.arange(S, device=dev)[None].expand(b, S))

    def _decode_positions(self, b: int, pos: int, device):
        """The positions [b, 1] (M-RoPE ids [b, 1, 3]) of decode
        position `pos`."""
        if self.cfg.rope_type == "mrope":
            return mrope_positions_decode(pos, b, device)
        return torch.full((b, 1), pos, device=device)

    def _mlp_residual(self, i: int, x):
        """x + the layer's FFN of rmsnorm(x)."""
        return self._ffn(i, x)

    # ------------------------------------------------------------- wave

    @torch.no_grad()
    def prefill(self, tokens, patches=None):
        """Full-sequence forward of equal-length prompts, tokens [B, S]
        int (a vision config's first N_IMG positions are `patches` [B,
        N_IMG, d]; their token ids are ignored). Returns (last-position
        logits [B, V], the K/V cache `init_cache(cfg, B, S)` filled):
        position p in slot p, or, when S exceeds the sliding window, the
        last Sc positions rolled by S % Sc so that position p lives in
        ring slot p % Sc. With `kv_quant` attention reads the
        fake-quantized k/v and the cache holds their int8 values and
        scales."""
        cfg = self.cfg
        b, S = tokens.shape
        x, positions = self._embed_inputs(tokens, patches)
        cache = init_cache(cfg, b, S, device=tokens.device,
                           kv_heads=self.kv_heads)
        sc = cache["k"].shape[2]

        def write(i, k, v):
            self._write_kv(cache, i, (), *(
                t if sc == S else torch.roll(t[:, S - sc:], S % sc, dims=1)
                for t in (k, v)))
            if cfg.kv_quant:
                return _fake_quant(k), _fake_quant(v)
            return k, v
        for i in range(cfg.num_layers):
            x = self._full_block(i, x, positions, write)
        return self.final_logits(x), cache

    def _attn_residual(self, i: int, x, positions, attn=None, kv=None):
        """x + layer i's attention of rmsnorm(x) over whole sequences x [B,
        S, d] (`causal=cfg.causal`, the window), computed by `attn`:
        `ops.flash_prefill` when None (serving), `L.attention` in
        training. `kv(i, k, v)`, when given, sees k and v first and
        returns the pair attended (the wave prefill writes its cache
        there)."""
        cfg = self.cfg
        b, S, _ = x.shape
        y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
        q, k, v = self._qkv(i, y, positions)
        if kv is not None:
            k, v = kv(i, k, v)
        ctx = (attn or ops.flash_prefill)(q, k, v, causal=cfg.causal,
                                          window=cfg.sliding_window)
        return x + self._attn_out(i, ctx.reshape(b, S, -1))

    def _full_block(self, i: int, x, positions, kv=None, attn=None):
        """Layer i over whole sequences x [B, S, d]: the attention
        (`_attn_residual`, through `attn`), then the FFN."""
        return self._mlp_residual(i, self._attn_residual(i, x, positions,
                                                         attn, kv))

    # --------------------------------------------------------- training

    def _train_layer(self, i: int, x, positions):
        """Layer i of the training forward: (its output, None: a dense
        FFN has no aux loss)."""
        return self._full_block(i, x, positions, attn=L.attention), None

    def train_hidden(self, tokens, patches=None):
        """The training forward to the final norm: (hidden states [B, S,
        d], the layers' MoE aux losses summed in layer order, or None).
        Attention is `L.attention`, each layer under `_remat`."""
        self._one_device("training")
        x, positions = self._embed_inputs(tokens, patches)
        aux = None
        for i in range(self.cfg.num_layers):
            x, a = self._remat(self._train_layer, i, x, positions)
            if a is not None:
                aux = a if aux is None else aux + a
        return L.rmsnorm(x, self.final_norm, self.cfg.norm_eps), aux

    def forward_logits(self, tokens, patches=None):
        """The training entry (the reference's `forward_logits`): logits
        [B, S, V] of tokens [B, S] int (a vision config's first N_IMG
        positions are `patches`, as in `prefill`), differentiable in the
        bound weights."""
        return self.logits_from_hidden(self.train_hidden(tokens, patches)[0])

    def forward(self, batch):
        return self.forward_logits(batch["tokens"], batch.get("patches")), \
            None

    @torch.no_grad()
    def hidden_states(self, tokens, patches=None):
        """Full-sequence forward without a cache, tokens [B, S] int (and
        a vision config's `patches`, as in `prefill`): the final-normed
        hidden states [B, S, d] (the reference's `hidden_states`).
        Attention is `flash_prefill` with `causal=cfg.causal` over every
        position, padding included."""
        x, positions = self._embed_inputs(tokens, patches)
        for i in range(self.cfg.num_layers):
            x = self._full_block(i, x, positions)
        return L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)

    @torch.no_grad()
    def encode(self, tokens, mask=None):
        """Sentence embeddings [B, d] f32 (the reference's `encode`, the
        gte-small path): hidden states mean-pooled over `mask` ([B, S], 1
        for a real token; all ones when None) in the model's dtype, cast
        to f32 and L2-normalised with a 1e-9 floor. The mask weights only
        the pooling: padding keys are attended, as in the reference."""
        x = self.hidden_states(tokens)
        if mask is None:
            mask = torch.ones(tokens.shape, device=x.device)
        m = mask.to(x.dtype)[..., None]
        pooled = ((x * m).sum(1) / m.sum(1).clamp(min=1)).float()
        return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One decode position for every row of a wave. token [B, 1] int;
        pos: the position written (shared by the rows). K/V go into slot
        pos, or pos % Sc of a sliding-window ring, of the [L, B, Sc, G,
        dh] `cache` (in place; int8 values and scales with `kv_quant`,
        attended by `decode_attention_q8`); attention covers pos + 1
        positions (min(pos + 1, Sc) on a ring). Returns logits [B, V]."""
        cfg = self.cfg
        b = token.shape[0]
        ring = cfg.sliding_window is not None
        slot = pos % cache["k"].shape[2] if ring else pos
        positions = self._decode_positions(b, pos, token.device)
        kv_len = torch.full((b,), pos + 1, dtype=torch.int32,
                            device=token.device)
        x = self._embed(token)
        for i in range(cfg.num_layers):
            y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
            q, k, v = self._qkv(i, y, positions)
            self._write_kv(cache, i, (slice(None), slot), k[:, 0], v[:, 0])
            ck, cv = cache["k"][i], cache["v"][i]
            if cfg.kv_quant:
                ctx = ops.decode_attention_q8(
                    q[:, 0], ck, cache["k_s"][i], cv, cache["v_s"][i],
                    kv_len, ring=ring)
            else:
                ctx = ops.decode_attention(q[:, 0], ck, cv, kv_len,
                                           ring=ring)
            x = x + self._attn_out(i, ctx.reshape(b, 1, -1))
            x = self._mlp_residual(i, x)
        return self.final_logits(x)

    # ------------------------------------------------------------ paged

    @torch.no_grad()
    def decode_step_paged(self, cache, token, pos, active, table, *,
                          page_size: int, ring_len: int = 0):
        """One decode step for every slot. token [B, 1] int; pos [B] int
        (each slot's write position == its kv length); active [B] bool
        (only active slots write K/V); table [B, W] int32 page ids (tail
        entries past kv_len are masked). `ring_len` > 0 marks
        sliding-window rings: position p is written at ring cursor
        p % ring_len and a row attends min(pos + 1, ring_len) positions,
        every filled cursor (RoPE is in the stored keys, so the order in
        the ring does not matter). Returns logits [B, V]; `cache` is
        updated in place."""
        self._one_device("the paged decode step")
        cfg = self.cfg
        ps = page_size
        b = token.shape[0]
        pos = pos.long()
        rows = torch.nonzero(active)[:, 0]
        wpos = pos[rows]
        if ring_len:
            wpos = wpos % ring_len
        pg = table[rows, wpos // ps].long()
        off = wpos % ps
        lens = (pos + 1).clamp(max=ring_len) if ring_len else pos + 1
        lens = lens.to(torch.int32)
        table = table.to(torch.int32).contiguous()
        x = self._embed(token)
        for i in range(cfg.num_layers):
            y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
            q, k, v = self._qkv(i, y, pos[:, None])
            self._write_kv(cache, i, (pg, off), k[rows, 0], v[rows, 0])
            ck, cv = cache["k"][i], cache["v"][i]
            qd = q[:, 0].contiguous()
            if cfg.kv_quant:
                ctx = ops.decode_attention_paged_q8(
                    qd, ck, cache["k_s"][i], cv, cache["v_s"][i], lens, table)
            else:
                ctx = ops.decode_attention_paged(qd, ck, cv, lens, table)
            x = x + ctx.to(x.dtype).reshape(b, 1, -1) @ self.wo[i]
            x = self._mlp_residual(i, x)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)[:, 0]

    def _write_kv(self, cache, i: int, idx, k, v) -> None:
        """Write k, v [..., G, dh] into layer i of a cache or pool at index
        `idx` (a tuple over its leading axes; () for all of it): their
        int8 values and scales with `kv_quant`."""
        for name, t in (("k", k), ("v", v)):
            c = cache[name][i]
            if self.cfg.kv_quant:
                c[idx], cache[name + "_s"][i][idx] = L.quantize_kv(t)
            else:
                c[idx] = t.to(c.dtype)

    @torch.no_grad()
    def prefill_chunk_paged(self, cache, tokens, row, offset: int,
                            limit: Optional[int] = None, *, page_size: int,
                            ring_len: int = 0):
        """One [1, C] prompt chunk at logical positions [offset, offset+C)
        of the slot whose page-table row is `row` ([W] int32); `limit`:
        offset + the chunk's real token count (offset + C when None).
        Each layer is one `flash_prefill_paged` call: the slot's history
        (positions [lo, offset), `chunk_rows`) read through `row` in the
        kernel, then the chunk, with the window; its queries attend
        causally up to offset + C. The chunk's K/V are written after the
        call, so a ring chunk evicts nothing its own queries attend; only
        the real tokens (p < limit) are written, at ring cursors
        p % ring_len, so a ragged last chunk's padding evicts nothing
        another query's window still needs. With `kv_quant` the history
        is attended dequantized and the chunk's own K/V fake-quantized.
        Returns chunk logits [1, C, V]; `cache` is updated in place."""
        self._one_device("the paged chunk prefill")
        cfg = self.cfg
        c = tokens.shape[1]
        limit = offset + c if limit is None else limit
        tile = ops.prefill_paged_key_tile(cfg.torch_dtype,
                                          cfg.resolved_head_dim)
        lo, dst = chunk_rows(row, offset, c, limit, page_size, ring_len,
                             tile=tile)
        n_keep = dst[0].numel()
        row = row.to(torch.int32).contiguous()
        positions = offset + torch.arange(c, device=tokens.device)[None, :]
        x = self._embed(tokens)
        for i in range(cfg.num_layers):
            y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
            q, k, v = self._qkv(i, y, positions)
            kc, vc = ((_fake_quant(k[0]), _fake_quant(v[0])) if cfg.kv_quant
                      else (k[0], v[0]))
            scales = ({"k_scale": cache["k_s"][i], "v_scale": cache["v_s"][i]}
                      if cfg.kv_quant else {})
            ctx = ops.flash_prefill_paged(
                q, kc.contiguous(), vc.contiguous(), cache["k"][i],
                cache["v"][i], row, offset=offset, lo=lo,
                page_size=page_size, ring_len=ring_len,
                window=cfg.sliding_window, **scales)
            self._write_kv(cache, i, dst, k[0, :n_keep], v[0, :n_keep])
            x = x + ctx.reshape(1, c, -1) @ self.wo[i]
            x = self._mlp_residual(i, x)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)
