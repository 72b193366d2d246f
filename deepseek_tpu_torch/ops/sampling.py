"""On-device token sampling: temperature, nucleus (top-p), top-k, min-p.

The port of ``deepseek_tpu/ops/sampling.py``. The nucleus is the smallest
set of highest-probability tokens whose mass reaches top_p, found without
sorting: 24 float32 halvings of a threshold tau, keeping {p >= tau}, so
value-ties at the boundary are all kept (as the host ``Sampler`` keeps
them). top-k is the same search on the count of {p >= tau}; min-p one
threshold against ``min_p * max(p)``. top-k and min-p cut the raw
distribution, which renormalizes, and the nucleus is taken over the rest.
A sample is ``argmax(masked_logits + gumbel)`` with the JAX package's
threefry noise (``ops/prng.py``), so a seed gives the JAX package's tokens.

Where the JAX code branches with ``lax.cond`` (all rows greedy; no row
asks for top-k or min-p), the host decides: a host float, or a host numpy
array of per-row values (the serving scheduler's per-slot temperature,
top-p, top-k and min-p), takes a Python branch and crosses to the device
in one non-blocking copy, so the decode block stays free of host syncs. A
device tensor is taken too, as the JAX code takes it, but deciding the
branch reads it back. ``SamplingRows`` makes the columns and the branch
once for a decode block's steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from deepseek_tpu_torch.ops import prng

_NEG_INF = -1e30


def _col(v, shape, device) -> torch.Tensor:
    """A host scalar, a host numpy array or a tensor, broadcastable to
    ``shape``, as a float32 column of ``shape + (1,)``. A host scalar
    becomes a device fill and a host array one non-blocking copy, not a
    blocking one (the decode block does not synchronize)."""
    if isinstance(v, torch.Tensor):
        t = v.to(device=device, dtype=torch.float32)
    elif np.ndim(v) == 0:
        return torch.full((*shape, 1), float(v), dtype=torch.float32, device=device)
    else:
        t = torch.from_numpy(np.array(v, dtype=np.float32)).to(device, non_blocking=True)
    return t.expand(shape).reshape(*shape, 1)


def _any(v, pred) -> bool:
    """``pred`` holds for a host scalar, or for some element of a host
    array or of a tensor (which reads the tensor back: host values keep the
    decode block free of synchronization)."""
    if isinstance(v, torch.Tensor):
        return bool(pred(v).any())
    return bool(np.any(pred(np.asarray(v))))


def _nucleus_mask(probs: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """(B, V) probs -> keep mask of the smallest mass >= top_p (B, 1)."""
    pmax = probs.amax(-1, keepdim=True)
    lo, hi = torch.zeros_like(pmax), pmax
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid, probs, zero).sum(-1, keepdim=True)
        ok = mass >= top_p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return (probs >= lo) | (probs >= pmax)


def _topk_mask(probs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, V) probs -> keep mask of the k (B, 1) highest, boundary ties
    kept; rows with k < 1 keep everything."""
    pmax = probs.amax(-1, keepdim=True)
    lo, hi = torch.zeros_like(pmax), pmax
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        cnt = (probs >= mid).to(torch.float32).sum(-1, keepdim=True)
        ok = cnt >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return (k < 1.0) | (probs >= lo) | (probs >= pmax)


def _keep_mask(probs, top_p, top_k, min_p, filters: bool) -> torch.Tensor:
    """The composed keep set over (B, V) probs; top_p, top_k, min_p (B, 1).
    ``filters`` is the JAX ``lax.cond`` predicate: some row asks for top-k
    or min-p."""
    if not filters:
        return _nucleus_mask(probs, top_p)
    keep = _topk_mask(probs, top_k)
    pmax = probs.amax(-1, keepdim=True)
    keep = keep & ((min_p <= 0.0) | (probs >= min_p * pmax))
    q = torch.where(keep, probs, torch.zeros_like(probs))
    q = q / q.sum(-1, keepdim=True).clamp_min(1e-30)
    return keep & _nucleus_mask(q, top_p)


def _filters_on(top_k, min_p) -> bool:
    return _any(top_k, lambda k: k >= 1.0) or _any(min_p, lambda m: m > 0.0)


def nucleus_dist(logits: torch.Tensor, temperature, top_p, top_k=0,
                 min_p=0.0) -> torch.Tensor:
    """(..., V) logits -> (..., V) float32 probabilities that
    ``sample_token`` draws from: the one-hot argmax where temperature is 0,
    else the softmax renormalized over the keep set."""
    logits = logits.float()
    lead, V = logits.shape[:-1], logits.shape[-1]
    flat = logits.reshape(-1, V)
    B, dev = flat.shape[0], flat.device
    col = lambda v: _col(v, lead, dev).reshape(B, 1)
    temp = col(temperature)
    onehot = torch.nn.functional.one_hot(flat.argmax(-1), V).to(torch.float32)
    probs = torch.softmax(flat / temp.clamp_min(1e-6), dim=-1)
    keep = _keep_mask(probs, col(top_p), col(top_k), col(min_p),
                      _filters_on(top_k, min_p))
    p = torch.where(keep, probs, torch.zeros_like(probs))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    p = torch.where(temp == 0.0, onehot, p)
    return p.reshape(*lead, V)


@dataclasses.dataclass
class SamplingRows:
    """The sampling parameters of B rows as device columns (B, 1), with the
    JAX ``lax.cond`` predicates decided on the host: some row samples
    (temperature != 0), some row asks for top-k or min-p."""
    temp: torch.Tensor
    top_p: torch.Tensor
    top_k: torch.Tensor
    min_p: torch.Tensor
    sampled: bool
    filters: bool

    @classmethod
    def make(cls, B: int, device, temperature, top_p, top_k=0, min_p=0.0):
        col = lambda v: _col(v, (B,), device)
        return cls(col(temperature), col(top_p), col(top_k), col(min_p),
                   _any(temperature, lambda t: t != 0.0), _filters_on(top_k, min_p))


def sample_rows(logits: torch.Tensor, noise: Callable[[], torch.Tensor],
                rows: SamplingRows) -> torch.Tensor:
    """``sample_token`` over (B, V) logits with the rows' parameters and the
    gumbel noise (B, V) given by ``noise()``, called only when some row
    samples (the decode loop draws a block's noise at once)."""
    logits = logits.float()
    greedy = logits.argmax(-1)
    if not rows.sampled:
        return greedy
    scaled = logits / rows.temp.clamp_min(1e-6)
    probs = torch.softmax(scaled, dim=-1)
    keep = _keep_mask(probs, rows.top_p, rows.top_k, rows.min_p, rows.filters)
    masked = torch.where(keep, scaled, torch.full_like(scaled, _NEG_INF))
    sampled = (noise() + masked).argmax(-1)
    return torch.where(rows.temp[:, 0] == 0.0, greedy, sampled)


def sample_token(logits: torch.Tensor, key, temperature, top_p, top_k=0,
                 min_p=0.0) -> torch.Tensor:
    """logits (B, V) -> (B,) int64 tokens. ``key`` is a (2,) uint32 threefry
    key (``prng.PRNGKey``/``split``); temperature, top_p, top_k and min_p
    are scalars or per-row (B,). top_k < 1 and min_p <= 0 turn those
    filters off; temperature 0 is argmax. Per-row values may be host numpy
    arrays (one non-blocking copy each) or tensors."""
    rows = SamplingRows.make(logits.shape[0], logits.device, temperature, top_p,
                             top_k, min_p)
    return sample_rows(
        logits, lambda: prng.gumbel(key, tuple(logits.shape), logits.device), rows)

