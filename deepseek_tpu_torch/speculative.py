"""Speculative decoding rounds: the port of ``deepseek_tpu/speculative.py``
(``_accept``, ``_ngram_lookup``, ``_accept_pointmass``, ``make_spec_rounds``,
``make_ngram_spec_rounds``, ``make_mtp_spec_rounds``, and the continuous-
batching scheduler's ``make_batched_ngram_spec_rounds`` and
``make_batched_mtp_spec_rounds``).

A maker returns a function that runs ``rounds`` complete speculation
rounds a call: draft ``spec_k`` tokens (a draft model's decode steps, an
n-gram match against the sequence's own history, or the checkpoint's MTP
layer), verify them with one (k+1)-row target chunk through
``forward_prefill``, and apply the arXiv 2211.17192 acceptance rule. Its
result is the JAX function's tuple. The drafts, the verify chunk, the
acceptance and the cache updates stay on the device; a round reads its
accepted count ``n_acc`` back to the host once, because the next round's
chunk starts at ``pos + n_acc + 1`` and the port's prefill takes a host
position.

Losslessness: acceptance uses the nucleus distributions that the sampler
draws from (``ops/sampling.py::nucleus_dist``), so outputs follow the
target model's distribution, and greedy outputs equal plain decode token
for token. The keys are the JAX package's threefry keys (``ops/prng.py``),
split where the JAX rounds split theirs, so a seed gives the JAX Engine's
sampled tokens. Rejected draft rows need no rollback: a ring slot is
rewritten whenever its position is fed, and ``kv_len`` masking never
exposes a slot before that. The rounds run strictly inside the prefill
window; the Engine guards ``pos + rounds*(k+1) <= window``.

The batched makers run every serving slot's round at once: each row drafts
from its own history (or its own MTP hidden state), one verify chunk of
per-row starts (``forward_prefill``'s verify mode, K10/K9 reading the
starts on the device) scores all rows, and each row advances by its own
accepted count; per-row sampling parameters are host arrays, as the
decode block takes them. A round reads its (B,) accepted counts back
once: the next chunk starts at host positions, and the scheduler needs
the counts anyway.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.models.deepseek import forward_decode, forward_prefill
from deepseek_tpu_torch.ops import prng
from deepseek_tpu_torch.ops.sampling import nucleus_dist, sample_token
from deepseek_tpu_torch.parallel.spmd import NULL_CTX, make_ctx


def _categorical(key, logp: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logp, axis=-1)`` over (..., V) rows;
    ``key`` one key, or a stack (B, 2) of one key per row of (B, V)."""
    shape = logp.shape[1:] if np.ndim(key) == 2 else logp.shape
    return (prng.gumbel(key, tuple(shape), logp.device) + logp).argmax(-1)


def _row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-d device index, without reading it to the host."""
    return t.index_select(0, i.reshape(1))[0]


def _accept_rows(ps: torch.Tensor, qs: torch.Tensor, drafts: torch.Tensor,
                 spec_k: int, keys):
    """``_accept`` of B rows at once, row b under its own key (the JAX
    ``vmap(_accept)`` over ``split(key, B)``). ps (B, k+1, V), qs (B, k,
    V), drafts (B, k) -> (n_acc (B,), next (B,))."""
    B, _, V = ps.shape
    ku, kr, kb = (np.stack(c) for c in zip(*(prng.split(k, 3) for k in keys)))
    pd = ps[:, :spec_k].gather(2, drafts[..., None])[..., 0]
    qd = qs.gather(2, drafts[..., None])[..., 0]
    u = prng.uniform(ku, (spec_k,), ps.device, minval=0.0)             # (B, k)
    acc = u < torch.clamp(pd / qd.clamp_min(1e-12), max=1.0)
    n_acc = torch.cumprod(acc.to(torch.int64), 1).sum(1)
    # the residual distribution at the first rejected position
    i = n_acc.clamp(max=spec_k - 1)[:, None, None].expand(B, 1, V)
    p_i, q_i = ps.gather(1, i)[:, 0], qs.gather(1, i)[:, 0]
    res = (p_i - q_i).clamp_min(0.0)
    rs = res.sum(-1, keepdim=True)
    res = torch.where(rs > 0, res / rs.clamp_min(1e-30), p_i)
    repl = _categorical(kr, torch.log(res.clamp_min(1e-30)))
    bonus = _categorical(kb, torch.log(ps[:, spec_k].clamp_min(1e-30)))
    return n_acc, torch.where(n_acc == spec_k, bonus, repl)


def _accept(ps: torch.Tensor, qs: torch.Tensor, drafts: torch.Tensor,
            spec_k: int, key):
    """Speculative acceptance on the device. ps (k+1, V) target nucleus
    distributions, qs (k, V) draft distributions, drafts (k,). Returns
    (n_acc, next_token), both 0-d."""
    n_acc, nxt = _accept_rows(ps[None], qs[None], drafts[None], spec_k, [key])
    return n_acc[0], nxt[0]


def _accept_pointmass(ps: torch.Tensor, drafts: torch.Tensor, spec_k: int, key):
    """Batched acceptance for point-mass drafts (prompt lookup): the rule
    with q = one-hot(draft) accepts with probability p(draft), and the
    residual is p with the draft zeroed. ps (B, k+1, V) target nucleus
    distributions, drafts (B, k) -> (n_acc (B,), next (B,)). A temperature-0
    row's p is one-hot, so acceptance is argmax equality and both draws are
    the argmax: greedy rows are plain decode's tokens."""
    B, _, V = ps.shape
    pd = ps[:, :spec_k].gather(2, drafts[..., None])[..., 0]          # (B, k)
    ku, kr, kb = prng.split(key, 3)
    u = prng.uniform(ku, (B, spec_k), ps.device, minval=0.0)
    acc = u < pd.clamp(max=1.0)
    n_acc = torch.cumprod(acc.to(torch.int64), 1).sum(1)              # (B,)
    i = n_acc.clamp(max=spec_k - 1)
    p_i = ps.gather(1, i[:, None, None].expand(B, 1, V))[:, 0]        # (B, V)
    d_i = drafts.gather(1, i[:, None])                                 # (B, 1)
    res = torch.where(torch.arange(V, device=ps.device)[None, :] == d_i,
                      torch.zeros_like(p_i), p_i)
    rs = res.sum(-1, keepdim=True)
    res = torch.where(rs > 0, res / rs.clamp_min(1e-30), p_i)
    repl = _categorical(kr, torch.log(res.clamp_min(1e-30)))
    bonus = _categorical(kb, torch.log(ps[:, spec_k].clamp_min(1e-30)))
    return n_acc, torch.where(n_acc == spec_k, bonus, repl)


def _greedy_accept(lg_all: torch.Tensor, drafts: torch.Tensor, spec_k: int):
    """Greedy acceptance: argmax equality; next = the target's argmax at
    row n_acc (the replacement, or the bonus when all k are accepted)."""
    tgt = lg_all.argmax(-1)
    n_acc = torch.cumprod((tgt[:spec_k] == drafts).to(torch.int64), 0).sum()
    return n_acc, _row(tgt, n_acc)


def _verify(lg_all: torch.Tensor, drafts: torch.Tensor, qs, spec_k: int, key,
            temperature, top_p, greedy: bool):
    """(n_acc, next) from the verify chunk's logits (k+1, V)."""
    if greedy:
        return _greedy_accept(lg_all, drafts, spec_k)
    ps = nucleus_dist(lg_all, temperature, top_p)
    return _accept(ps, qs, drafts, spec_k, key)


def _draw(lg: torch.Tensor, key, temperature, top_p, greedy: bool):
    """One draft token from (1, V) logits -> (token (1,), q (V,) | None,
    key): the argmax, or a sample with a subkey split off ``key``."""
    if greedy:
        return lg.argmax(-1), None, key
    q = nucleus_dist(lg, temperature, top_p)
    key, sub = prng.split(key)
    return sample_token(lg, sub, temperature, top_p), q[0], key


def _stack_rounds(out: List[tuple]):
    return tuple(torch.stack(list(col)) for col in zip(*out))


def make_spec_rounds(cfg_t: ModelConfig, cfg_d: ModelConfig, spec_k: int,
                     rounds: int, greedy: bool = False):
    """Draft-model speculation (``Engine.generate_speculative``'s hot loop).

    Returns ``fn(pt, pd, ct, cd, tok (1,1), pos0, key, temperature, top_p)
    -> (drafts (R, k), n_acc (R,), next (R,), ct, cd)``, both caches
    written in place. Per round r the host emits drafts[r, :n_acc[r]] then
    next[r] and advances pos by n_acc[r] + 1. ``greedy`` (temperature 0,
    known when the function is made) skips the nucleus distributions."""
    @torch.inference_mode()
    def fn(pt, pd, ct, cd, tok, pos0, key, temperature, top_p):
        pos, out = int(pos0), []
        for _ in range(rounds):
            drafts, qs, t = [], [], tok
            for i in range(spec_k):
                lg = forward_decode(pd, cd, t, pos + i, cfg_d)         # (1, V)
                d, q, key = _draw(lg, key, temperature, top_p, greedy)
                drafts.append(d[0])
                qs.append(q)
                t = d[:, None]
            drafts = torch.stack(drafts)
            chunk = torch.cat([tok[0], drafts])[None]                    # (1, k+1)
            lg_all = forward_prefill(pt, ct, chunk, pos, cfg_t, "all")[0]
            key, ka = prng.split(key)
            n_acc, nxt = _verify(lg_all, drafts, None if greedy else torch.stack(qs),
                                 spec_k, ka, temperature, top_p, greedy)
            # keep the draft cache aligned for the full-accept case (the
            # bonus is fed at pos+k+1 next); on a partial accept this writes
            # a row that is rewritten before it is exposed
            forward_decode(pd, cd, drafts[-1].reshape(1, 1), pos + spec_k, cfg_d)
            pos += int(n_acc) + 1          # the round's one read to the host
            out.append((drafts, n_acc, nxt))
            tok = nxt.reshape(1, 1)
        return (*_stack_rounds(out), ct, cd)

    return fn


def _ngram_lookup_rows(hist: torch.Tensor, hlen, H: int, ngram_max: int,
                       ngram_min: int):
    """Longest-n most-recent match of each row's last n history tokens, n
    = ngram_max down to ngram_min (the JAX ``vmap(_ngram_lookup)``). hist
    (B, H); hlen (B,) host ints. Returns (start (B,), matched (B,)) on the
    device: start indexes the token that followed the match."""
    dev, B = hist.device, hist.shape[0]
    hl = torch.from_numpy(np.array(hlen, dtype=np.int64).reshape(B)).to(
        dev, non_blocking=True)[:, None]                                # (B, 1)
    start = torch.zeros(B, dtype=torch.int64, device=dev)
    matched = torch.zeros(B, dtype=torch.bool, device=dev)
    for n in range(ngram_max, ngram_min - 1, -1):
        s = (hl - n).clamp(0, H - n)               # dynamic_slice clamps its start
        pat = hist.gather(1, s + torch.arange(n, device=dev))          # (B, n)
        eq = torch.ones((B, H - n + 1), dtype=torch.bool, device=dev)
        for j in range(n):
            eq &= hist[:, j:j + H - n + 1] == pat[:, j:j + 1]
        idx = torch.arange(H - n + 1, device=dev)[None, :]
        # a match needs a following token, and i == hlen-n is the suffix
        # itself: both excluded by i <= hlen-n-1
        ok = eq & (idx <= hl - n - 1) & (hl >= n + 1)
        best = torch.where(ok, idx, torch.full_like(idx, -1)).amax(1)
        hit = best >= 0
        start = torch.where(hit & ~matched, best + n, start)
        matched = matched | hit
    return start, matched


def _ngram_lookup(hist_row: torch.Tensor, hlen: int, H: int, ngram_max: int,
                  ngram_min: int):
    """``_ngram_lookup_rows`` of one history row (H,), hlen a host int ->
    (start, matched), 0-d device tensors."""
    start, matched = _ngram_lookup_rows(hist_row[None], [hlen], H, ngram_max, ngram_min)
    return start[0], matched[0]


def make_ngram_spec_rounds(cfg: ModelConfig, spec_k: int, rounds: int,
                           hist_len: int, ngram_max: int = 3, ngram_min: int = 1,
                           greedy: bool = False):
    """Prompt-lookup (n-gram) speculation: drafts copied from the
    sequence's own history (``Engine.generate_ngram``'s hot loop).

    Returns ``fn(params, ct, hist (1, hist_len), hlen, tok (1,1), pos0,
    key, temperature, top_p) -> (drafts (R, k), n_acc (R,), next (R,),
    matched (R,), ct, hist, hlen)``. ``hist`` holds the sequence so far
    (prompt + emitted) including ``tok`` at index hlen-1, and the emitted
    tokens are appended in place; ``hlen`` is a host int. The draft is a
    point mass at the looked-up token, so acceptance is the same rule with
    one-hot q."""
    H = hist_len

    @torch.inference_mode()
    def fn(params, ct, hist, hlen, tok, pos0, key, temperature, top_p):
        pos, hlen, out = int(pos0), int(hlen), []
        off = torch.arange(spec_k, device=hist.device)
        for _ in range(rounds):
            row = hist[0]
            start, matched = _ngram_lookup(row, hlen, H, ngram_max, ngram_min)
            # no match: propose copies of the current token (verified like
            # any draft: usually rejected, still lossless)
            start = torch.where(matched, start, torch.full_like(start, hlen - 1))
            drafts = row[start.clamp(0, H - spec_k) + off]
            drafts = torch.where(start + off < hlen, drafts, row[hlen - 1])
            chunk = torch.cat([tok[0], drafts])[None]                    # (1, k+1)
            lg_all = forward_prefill(params, ct, chunk, pos, cfg, "all")[0]
            key, ka = prng.split(key)
            qs = None if greedy else torch.nn.functional.one_hot(
                drafts, cfg.vocab_size).to(torch.float32)
            n_acc, nxt = _verify(lg_all, drafts, qs, spec_k, ka, temperature, top_p,
                                 greedy)
            # append drafts[:n_acc] then nxt; the slots past n_acc hold
            # drafts that the next round overwrites before hlen covers them
            emitted = torch.cat([drafts, drafts[-1:]])
            emitted = torch.where(torch.arange(spec_k + 1, device=hist.device) == n_acc,
                                  nxt, emitted)
            at = min(hlen, H - spec_k - 1)
            hist[0, at:at + spec_k + 1] = emitted
            na = int(n_acc)                # the round's one read to the host
            hlen += na + 1
            pos += na + 1
            out.append((drafts, n_acc, nxt, matched))
            tok = nxt.reshape(1, 1)
        return (*_stack_rounds(out), ct, hist, hlen)

    return fn


def make_mtp_spec_rounds(cfg: ModelConfig, spec_k: int, rounds: int,
                         greedy: bool = False):
    """Self-speculation with the checkpoint's MTP layer
    (``Engine.generate_mtp``'s hot loop).

    Returns ``fn(params, ct, mtp_cache, tok (1,1), h_cur (1,1,dim) f32,
    pos0, key, temperature, top_p) -> (drafts (R,k), n_acc (R,), next (R,),
    h_next (1,1,dim), ct, mtp_cache)``. MTP cache slot j holds the pair
    (token_{j+1}, hidden_j); after each verify the slots are re-written
    from the main model's hidden states, so drafting does not drift."""
    from deepseek_tpu_torch.models.mtp import mtp_forward

    @torch.inference_mode()
    def fn(params, ct, cm, tok, h_cur, pos0, key, temperature, top_p):
        pos, out = int(pos0), []
        for _ in range(rounds):
            drafts, qs, t, hh = [], [], tok, h_cur
            for j in range(spec_k):
                lg, hh, cm = mtp_forward(params, cm, t, hh, pos - 1 + j, cfg,
                                         prefill=False)
                d, q, key = _draw(lg[:, 0], key, temperature, top_p, greedy)
                hh = hh.float()
                drafts.append(d[0])
                qs.append(q)
                t = d[:, None]
            drafts = torch.stack(drafts)
            chunk = torch.cat([tok[0], drafts])[None]                    # (1, k+1)
            lg_all, h_all = forward_prefill(params, ct, chunk, pos, cfg, "all",
                                            with_hidden=True)
            key, ka = prng.split(key)
            n_acc, nxt = _verify(lg_all[0], drafts, None if greedy else torch.stack(qs),
                                 spec_k, ka, temperature, top_p, greedy)
            # re-write the MTP pairs (chunk[j+1], h_all[j]) at pos..pos+k
            # from the true hidden states; pairs past n_acc are rewritten
            # next round before they are attended
            h_all = h_all.float()
            pair_toks = torch.cat([drafts, nxt.reshape(1)])[None]        # (1, k+1)
            mtp_forward(params, cm, pair_toks, h_all, pos, cfg, prefill=True)
            h_cur = h_all.index_select(1, n_acc.reshape(1))
            pos += int(n_acc) + 1          # the round's one read to the host
            out.append((drafts, n_acc, nxt))
            tok = nxt.reshape(1, 1)
        return (*_stack_rounds(out), h_cur, ct, cm)

    return fn


def _row_params(temperature, top_p, top_k, min_p, B: int):
    """The per-row sampling parameters as host (B,) float32 arrays."""
    return tuple(np.broadcast_to(np.asarray(v, dtype=np.float32).reshape(-1), (B,))
                 for v in (temperature, top_p, top_k, min_p))


def _emitted(drafts, n_acc, nxt, spec_k: int) -> torch.Tensor:
    """(B, k+1): drafts[:n_acc], then next, then the drafts past it (junk
    that a later write covers before it is read)."""
    emitted = torch.cat([drafts, drafts[:, -1:]], 1)
    at = torch.arange(spec_k + 1, device=drafts.device)[None, :] == n_acc[:, None]
    return torch.where(at, nxt[:, None], emitted)


def _emitted_logprobs(lg_all: torch.Tensor, emitted: torch.Tensor) -> torch.Tensor:
    """The raw log-softmax (no temperature) of each emitted token from the
    verify chunk's own logits rows: (B, k+1)."""
    return torch.log_softmax(lg_all.float(), -1).gather(2, emitted[..., None])[..., 0]


def make_batched_ngram_spec_rounds(cfg: ModelConfig, spec_k: int, rounds: int,
                                   hist_len: int, ngram_max: int = 3,
                                   ngram_min: int = 1, with_logprobs: bool = False,
                                   mesh=None):
    """Prompt-lookup speculation for the continuous-batching scheduler: every
    slot drafts from its own history and all slots verify in one chunk of
    per-row starts a round (``forward_prefill``'s verify mode); acceptance is
    the point-mass rule per row (``_accept_pointmass``), so greedy and
    sampled slots share a round.

    ``hist[b, :pos0[b]+1]`` is slot b's sequence (prompt + emitted)
    including ``tok[b]`` at index pos0[b]. ``active`` freezes a row: its
    position, token and history stay put and its outputs are junk (its
    cache writes land in a dead slot). The caller keeps max(pos0) +
    rounds*(spec_k+1) <= kv_window and hist_len >= that bound.

    Returns ``fn(params, ct, hist (B,H) int64, tok (B,1), pos0 (B,) host
    ints, key, temperature, top_p, active, top_k, min_p) -> (drafts
    (R,B,k), n_acc (R,B), next (R,B), matched (R,B)[, lps (R,B,k+1)], ct,
    hist)``, the cache and hist written in place, the per-row parameters
    host (B,) arrays (or scalars), ``active`` a host (B,) bool mask. Per
    round r the host emits drafts[r,b,:n_acc[r,b]] then next[r,b] and
    advances pos[b] by n_acc[r,b]+1 (live rows). ``with_logprobs`` adds the
    raw log-softmax of each emitted token from the verify chunk's logits:
    lps[r,b,i] scores the i-th token round r emits.

    ``mesh`` (data, tensor and expert axes; a seq axis raises, as verify
    mode excludes it): every rank passes the whole batch's hist, tok,
    positions and sampling rows beside its slices of the weights and cache
    (``shard_params``, ``shard_cache``) and runs its data shard's rows
    with the key folded with its data index (``speculative.py:249-251``);
    the per-round results are gathered over the data line, so every rank
    returns the whole batch's, and hist's rows of this rank's data shard
    are written in place."""
    ctx = NULL_CTX if mesh is None else make_ctx(cfg, mesh)
    if ctx.sp > 1:
        raise ValueError("spec serving mesh must not shard 'seq'")
    H = hist_len

    @torch.inference_mode()
    def fn(params, ct, hist, tok, pos0, key, temperature, top_p, active, top_k,
           min_p):
        B = tok.shape[0]
        rp = _row_params(temperature, top_p, top_k, min_p, B)
        pos = np.array(pos0, dtype=np.int64).reshape(B)
        act = np.broadcast_to(np.asarray(active, dtype=bool).reshape(-1), (B,))
        whole = hist
        if ctx.dp > 1:
            if B != ct.batch * ctx.dp:
                raise ValueError(f"a data axis of {ctx.dp} takes the whole batch's "
                                 f"{ct.batch * ctx.dp} rows beside this rank's "
                                 f"{ct.batch} cache rows, not {B}")
            rows = ctx.data_rows(B)
            hist, tok, pos, act = hist[rows], tok[rows], pos[rows], act[rows]
            rp = tuple(v[rows] for v in rp)
            key = prng.fold_in(key, ctx.didx)
            B = tok.shape[0]
        dev = tok.device
        act_d = torch.from_numpy(act.copy()).to(dev, non_blocking=True)
        cols = [v[:, None] for v in rp]
        off = torch.arange(spec_k, device=dev)[None, :]
        out = []
        for _ in range(rounds):
            hlen = pos + 1
            start, matched = _ngram_lookup_rows(hist, hlen, H, ngram_max, ngram_min)
            hl = torch.from_numpy(hlen).to(dev, non_blocking=True)[:, None]
            start = torch.where(matched[:, None], start[:, None], hl - 1)
            drafts = hist.gather(1, start.clamp(0, H - spec_k) + off)
            drafts = torch.where(start + off < hl, drafts, hist.gather(1, hl - 1))
            chunk = torch.cat([tok, drafts], 1)                          # (B, k+1)
            lg_all = forward_prefill(params, ct, chunk, pos, cfg, "all", ctx)  # verify mode
            key, ka = prng.split(key)
            ps = nucleus_dist(lg_all, *cols)                             # (B, k+1, V)
            n_acc, nxt = _accept_pointmass(ps, drafts, spec_k, ka)
            emitted = _emitted(drafts, n_acc, nxt, spec_k)
            lp = _emitted_logprobs(lg_all, emitted) if with_logprobs else None
            at = torch.from_numpy(np.minimum(hlen, H - spec_k - 1)).to(dev, non_blocking=True)
            hist.scatter_(1, at[:, None] + torch.arange(spec_k + 1, device=dev), emitted)
            pos = pos + np.where(act, n_acc.cpu().numpy() + 1, 0)   # the round's host read
            tok = torch.where(act_d[:, None], nxt[:, None], tok)
            out.append((drafts, n_acc, nxt, matched.long())
                       + ((lp,) if with_logprobs else ()))
        res = [ctx.gather_d(x, 1) for x in _stack_rounds(out)]
        res[3] = res[3].bool()
        return (*res, ct, whole)

    return fn


def make_batched_mtp_spec_rounds(cfg: ModelConfig, spec_k: int, rounds: int,
                                 with_logprobs: bool = False, mesh=None):
    """MTP self-speculation for the continuous-batching scheduler: every slot
    drafts with the MTP layer from its own hidden state, all slots verify in
    one chunk of per-row starts a round, and each row accepts by the exact
    rule under its own key (the JAX ``vmap(_accept)``). After each verify the
    MTP cache takes the pairs (chunk[j+1], h_all[j]) at each row's own
    positions from the true hidden states (the MTP verify mode). ``active``
    freezes a row as in the n-gram maker.

    Returns ``fn(params, ct, cm, tok (B,1), h_cur (B,1,dim) f32, pos0 (B,)
    host ints, key, temperature, top_p, active, top_k, min_p) -> (drafts
    (R,B,k), n_acc (R,B), next (R,B)[, lps (R,B,k+1)], h_cur (B,1,dim),
    ct, cm)``, both caches written in place; ``lps`` as the n-gram
    maker's. Single-device, as in the JAX package: a mesh raises."""
    from deepseek_tpu_torch.models.mtp import mtp_forward

    if mesh is not None:
        raise ValueError("spec='mtp' serving is single-chip (the MTP drafter runs "
                         "with NULL_CTX)")

    @torch.inference_mode()
    def fn(params, ct, cm, tok, h_cur, pos0, key, temperature, top_p, active,
           top_k, min_p):
        B, dev = tok.shape[0], tok.device
        pos = np.array(pos0, dtype=np.int64).reshape(B)
        act = np.broadcast_to(np.asarray(active, dtype=bool).reshape(-1), (B,))
        act_d = torch.from_numpy(act.copy()).to(dev, non_blocking=True)
        params_b = _row_params(temperature, top_p, top_k, min_p, B)
        cols = [v[:, None] for v in params_b]
        out = []
        for _ in range(rounds):
            drafts, qs, t, hh = [], [], tok, h_cur
            for j in range(spec_k):
                lg, hh, cm = mtp_forward(params, cm, t, hh, pos - 1 + j, cfg,
                                         prefill=False)
                q = nucleus_dist(lg[:, 0], *params_b)
                key, sub = prng.split(key)
                d = sample_token(lg[:, 0], sub, *params_b)
                hh = hh.float()
                drafts.append(d)
                qs.append(q)
                t = d[:, None]
            drafts, qs = torch.stack(drafts, 1), torch.stack(qs, 1)     # (B,k), (B,k,V)
            chunk = torch.cat([tok, drafts], 1)                          # (B, k+1)
            lg_all, h_all = forward_prefill(params, ct, chunk, pos, cfg, "all",
                                            with_hidden=True)          # verify mode
            key, ka = prng.split(key)
            ps = nucleus_dist(lg_all, *cols)                             # (B, k+1, V)
            n_acc, nxt = _accept_rows(ps, qs, drafts, spec_k, prng.split(ka, B))
            h_all = h_all.float()
            # the MTP pairs (chunk[j+1], h_all[j]) at each row's positions;
            # the pairs past n_acc are rewritten before they are attended
            mtp_forward(params, cm, torch.cat([drafts, nxt[:, None]], 1), h_all, pos,
                        cfg, prefill=True)
            lp = (_emitted_logprobs(lg_all, _emitted(drafts, n_acc, nxt, spec_k))
                  if with_logprobs else None)
            h_next = h_all.gather(1, n_acc[:, None, None].expand(B, 1, h_all.shape[-1]))
            pos = pos + np.where(act, n_acc.cpu().numpy() + 1, 0)   # the round's host read
            tok = torch.where(act_d[:, None], nxt[:, None], tok)
            h_cur = torch.where(act_d[:, None, None], h_next, h_cur)
            out.append((drafts, n_acc, nxt) + ((lp,) if with_logprobs else ()))
        return (*_stack_rounds(out), h_cur, ct, cm)

    return fn
