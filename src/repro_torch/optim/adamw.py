"""AdamW over ZeRO shards with fp32 master weights, as the JAX package's
``optim/adamw.py`` computes it.

Optimizer state leaves have the layout of the optimizer spec, the
parameter's shard or, for a widened leaf (hier, an 'inter_only' leaf),
its block of that shard (``StepBundle.opt_shards``), so the update is
local: each rank updates only its block. The port updates the master
copy and the moments in place and writes the new parameter block into
the tensor it is given (the JAX step donates and returns new arrays);
the arithmetic and its order are the same.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import DTYPES, OptimizerConfig, SystemConfig


def lr_at_step(cfg: OptimizerConfig, step: int) -> float:
    """Linear warmup, then cosine decay."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    t = min(max((step - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    decay = 0.5 * (1 + math.cos(math.pi * t))
    return cfg.lr * warm * decay


def init_opt_state(train_params: List[torch.Tensor], sys: SystemConfig):
    """m, v (opt dtype) and master copies (master dtype), each with the
    shape and device of its entry of ``train_params`` (the optimizer
    layout's blocks); step 0."""
    od, md = DTYPES[sys.opt_state_dtype], DTYPES[sys.master_dtype]
    return {
        "m": [torch.zeros(p.shape, dtype=od, device=p.device)
              for p in train_params],
        "v": [torch.zeros(p.shape, dtype=od, device=p.device)
              for p in train_params],
        "master": [p.detach().to(md).clone() for p in train_params],
        "step": 0,
    }


def clip_by_global_norm(grads: List[torch.Tensor],
                        rep_factors: Sequence[float], max_norm: float,
                        coll, axes):
    """Global-norm clip aware of sharding: each leaf's local sum of
    squares is divided by its replication factor, then summed over every
    mesh axis (``axes``), so each element counts exactly once. Returns
    (clipped grads, norm as a 0-dim fp32 tensor)."""
    device = grads[0].device
    local = torch.zeros((), dtype=torch.float32, device=device)
    for g, rep in zip(grads, rep_factors):
        local = local + g.float().square().sum() / rep
    gnorm = torch.sqrt(coll.all_reduce(local, axes))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return [g * scale.to(g.dtype) for g in grads], gnorm


@torch.no_grad()
def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 opt_state: Dict, opt_cfg: OptimizerConfig,
                 sys: SystemConfig,
                 wd_mask: Optional[Sequence[bool]] = None) -> None:
    """One AdamW step on every block, in place: moments and master in
    fp32 arithmetic; ``params[i]`` receives the master cast to its
    dtype."""
    step = opt_state["step"] + 1
    lr = lr_at_step(opt_cfg, step)
    b1, b2, eps = opt_cfg.b1, opt_cfg.b2, opt_cfg.eps
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for i, (p, g) in enumerate(zip(params, grads)):
        m, v, master = (opt_state["m"][i], opt_state["v"][i],
                        opt_state["master"][i])
        gf = g.float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + gf.square() * (1 - b2)
        upd = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
        wd = opt_cfg.weight_decay if (wd_mask is None or wd_mask[i]) else 0.0
        mastf = master.float()
        mastf = mastf - lr * (upd + wd * mastf)
        m.copy_(mf)
        v.copy_(vf)
        master.copy_(mastf)
        p.copy_(mastf)
    opt_state["step"] = step
