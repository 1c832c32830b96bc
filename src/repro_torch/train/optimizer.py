"""AdamW with optional int8 moments (the port of `repro.train.optimizer`):
the update, and the moments' logical axes (`opt_state_specs`) on a mesh.

Parameters, gradients and moments are name -> tensor dicts.
Moments are f32 ("float32"), or with `moments_dtype="int8"` the first
is stored as {"q": int8
parameter-shaped, "s": f32 per-row scales} (~1.03 bytes a parameter)
and the second in bf16 (2 bytes): v keeps its dynamic range, where a
linear int8 code would flush small second moments to zero and blow up
1/sqrt(v). 3.06 bytes a parameter against f32's 8.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import torch

from repro_torch.config import TrainConfig


# ------------------------------------------------------- int8 moment codec


def quantize_rows(x: torch.Tensor, row_max: Optional[Callable] = None
                  ) -> Dict[str, torch.Tensor]:
    """Symmetric int8 code with per-row (last-axis) f32 scales: s =
    max|x| / 127 over the row (kept as a trailing axis of 1), q = x /
    max(s, 1e-20) rounded half to even. `row_max`, when given, completes
    the rows' max|x| of a shard whose row is split across ranks (a max
    over them)."""
    mx = x.abs().amax(-1, keepdim=True)
    if row_max is not None:
        mx = row_max(mx)
    s = mx / 127.0
    q = torch.round(x / s.clamp(min=1e-20)).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_rows(qt: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return qt["q"].float() * qt["s"]


def _is_q(x) -> bool:
    return isinstance(x, Mapping) and set(x) == {"q", "s"}


# ------------------------------------------------------------- adamw


def lr_schedule(cfg: TrainConfig, max_steps: int = 10000) -> Callable:
    """step -> learning rate (f32 tensor): linear warmup from 0 to
    `learning_rate` over `warmup_steps`, then a cosine from it to 0.1 of
    it at `max_steps`, flat after."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(max_steps - cfg.warmup_steps, 1), 0, 1)
        cos = cfg.learning_rate * (0.1 + 0.9 * 0.5 * (
            1 + torch.cos(math.pi * frac)))
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return lr


def init_opt_state(params: Mapping[str, torch.Tensor],
                   moments_dtype: str = "float32") -> dict:
    """{"m", "v": name -> zero moments, "step": 0 (int32)} on the
    parameters' device: both moments f32, or with "int8" m as
    `quantize_rows` of zeros and v in bf16."""
    q8 = moments_dtype == "int8"

    def mk_m(p):
        z = torch.zeros(p.shape, device=p.device)
        return quantize_rows(z) if q8 else z
    dev = next(iter(params.values())).device
    return {"m": {n: mk_m(p) for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, device=p.device,
                                 dtype=torch.bfloat16 if q8 else None)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_specs: Mapping[str, tuple],
                    moments_dtype: str = "float32") -> dict:
    """Logical axes of the AdamW state from the parameters' (name ->
    axes): m and v as their parameter, an int8 m's scales without the
    last axis; "step" a scalar."""
    def mk_m(spec):
        if moments_dtype == "int8":
            return {"q": spec, "s": tuple(spec[:-1]) + (None,)}
        return spec
    return {"m": {n: mk_m(s) for n, s in param_specs.items()},
            "v": dict(param_specs), "step": ()}


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors.values()))


def adamw_update(cfg: TrainConfig, params, grads, opt_state, lr_fn,
                 moments_dtype: str = "float32", *,
                 gnorm: Optional[torch.Tensor] = None,
                 row_max: Optional[Mapping[str, Callable]] = None):
    """One AdamW step, as the reference's: gradients in f32 scaled by
    min(1, grad_clip / max(global norm, 1e-12)) (no clip when grad_clip
    is 0), bias-corrected moments, decoupled weight decay, the update in
    f32 and the parameters back in their dtype. Returns (new params, new
    state, {"grad_norm", "lr"}).

    On a mesh each rank updates its own shards (every term but the norm
    and an int8 m's row scales is elementwise): `gnorm` is then the
    whole gradient's norm, and `row_max[name]` the max over the ranks
    that split that parameter's rows (`quantize_rows`)."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / gnorm.clamp(min=1e-12), max=1.0) \
        if cfg.grad_clip else 1.0
    lr = lr_fn(step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    new_p, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        m, v = opt_state["m"][n], opt_state["v"][n]
        g = grads[n].float() * clip
        mf = dequantize_rows(m) if _is_q(m) else m.float()
        vf = dequantize_rows(v) if _is_q(v) else v.float()
        mf = b1 * mf + (1 - b1) * g
        vf = b2 * vf + (1 - b2) * torch.square(g)
        u = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        pf = p.float()
        new_p[n] = (pf - lr * (u + cfg.weight_decay * pf)).to(p.dtype)
        if moments_dtype == "int8":
            new_m[n] = quantize_rows(mf, (row_max or {}).get(n))
            new_v[n] = vf.to(torch.bfloat16)
        else:
            new_m[n], new_v[n] = mf, vf
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
