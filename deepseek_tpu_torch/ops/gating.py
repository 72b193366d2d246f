"""MoE router: scoring + top-k expert selection (reference moe_gate,
infer.cpp:493-599, with the JAX package's corrections):

- the V3 e-score-correction bias steers *selection only*; routing weights
  come from the unbiased scores;
- GROUP_LIMITED_GREEDY keeps the top ``topk_group`` groups by group max,
  then the top-k experts within them;
- NOAUX_TC scores a group by the sum of its top-2 biased scores.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepseek_tpu_torch.config import ModelConfig, ScoringFunc, TopKMethod

_NEG_INF = -1e30


def moe_gate(logits: torch.Tensor, bias: Optional[torch.Tensor],
             cfg: ModelConfig):
    """logits (..., E) -> (weights (..., k) f32, indices (..., k) int64)."""
    x = logits.float()
    if cfg.scoring_func == ScoringFunc.SOFTMAX:
        scores = torch.softmax(x, dim=-1)
    else:
        scores = torch.sigmoid(x)
    sel = scores + bias.float() if bias is not None else scores

    k = cfg.n_active_routed
    e = scores.shape[-1]
    if cfg.topk_method == TopKMethod.GREEDY:
        idx = torch.topk(sel, k, dim=-1).indices
    else:
        n_group = cfg.n_group
        group_size = e // n_group
        grouped = sel.reshape(*sel.shape[:-1], n_group, group_size)
        if cfg.topk_method == TopKMethod.NOAUX_TC:
            group_scores = torch.topk(grouped, 2, dim=-1).values.sum(dim=-1)
        else:  # GROUP_LIMITED_GREEDY: group score = group max
            group_scores = grouped.amax(dim=-1)
        gidx = torch.topk(group_scores, cfg.topk_group, dim=-1).indices
        group_mask = torch.zeros_like(group_scores).scatter_(-1, gidx, 1.0)
        keep = group_mask.repeat_interleave(group_size, dim=-1) > 0
        masked = torch.where(keep, sel, torch.full_like(sel, _NEG_INF))
        idx = torch.topk(masked, k, dim=-1).indices

    weights = torch.gather(scores, -1, idx)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * cfg.routed_scaling_factor
    return weights, idx
