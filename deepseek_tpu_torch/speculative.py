"""Single-sequence speculative decoding rounds: the port of
``deepseek_tpu/speculative.py`` (``_accept``, ``_ngram_lookup``,
``make_spec_rounds``, ``make_ngram_spec_rounds``, ``make_mtp_spec_rounds``).

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
"""

from __future__ import annotations

from typing import List

import torch

from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.models.deepseek import forward_decode, forward_prefill
from deepseek_tpu_torch.ops import prng
from deepseek_tpu_torch.ops.sampling import nucleus_dist, sample_token


def _categorical(key, logp: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logp)`` over a (V,) row."""
    return (prng.gumbel(key, tuple(logp.shape), logp.device) + logp).argmax(-1)


def _row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-d device index, without reading it to the host."""
    return t.index_select(0, i.reshape(1))[0]


def _accept(ps: torch.Tensor, qs: torch.Tensor, drafts: torch.Tensor,
            spec_k: int, key):
    """Speculative acceptance on the device. ps (k+1, V) target nucleus
    distributions, qs (k, V) draft distributions, drafts (k,). Returns
    (n_acc, next_token), both 0-d."""
    pd = ps[:spec_k].gather(1, drafts[:, None])[:, 0]
    qd = qs.gather(1, drafts[:, None])[:, 0]
    ku, kr, kb = prng.split(key, 3)
    u = prng.uniform(ku, (spec_k,), ps.device, minval=0.0)
    acc = u < torch.clamp(pd / qd.clamp_min(1e-12), max=1.0)
    n_acc = torch.cumprod(acc.to(torch.int64), 0).sum()
    # the residual distribution at the first rejected position
    i = n_acc.clamp_max(spec_k - 1)
    p_i, q_i = _row(ps, i), _row(qs, i)
    res = (p_i - q_i).clamp_min(0.0)
    rs = res.sum()
    res = torch.where(rs > 0, res / rs.clamp_min(1e-30), p_i)
    repl = _categorical(kr, torch.log(res.clamp_min(1e-30)))
    bonus = _categorical(kb, torch.log(ps[spec_k].clamp_min(1e-30)))
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


def _ngram_lookup(hist_row: torch.Tensor, hlen: int, H: int, ngram_max: int,
                  ngram_min: int):
    """Longest-n most-recent match of the history's last n tokens, n =
    ngram_max down to ngram_min. hist_row (H,); returns (start, matched),
    0-d device tensors: start indexes the token that followed the match."""
    dev = hist_row.device
    start = torch.zeros((), dtype=torch.int64, device=dev)
    matched = torch.zeros((), dtype=torch.bool, device=dev)
    for n in range(ngram_max, ngram_min - 1, -1):
        s = min(max(hlen - n, 0), H - n)          # dynamic_slice clamps its start
        pat = hist_row[s:s + n]
        eq = torch.ones(H - n + 1, dtype=torch.bool, device=dev)
        for j in range(n):
            eq &= hist_row[j:j + H - n + 1] == pat[j]
        idx = torch.arange(H - n + 1, device=dev)
        # a match needs a following token, and i == hlen-n is the suffix
        # itself: both excluded by i <= hlen-n-1
        ok = eq & (idx <= hlen - n - 1) & (hlen >= n + 1)
        best = torch.where(ok, idx, torch.full_like(idx, -1)).max()
        hit = best >= 0
        start = torch.where(hit & ~matched, best + n, start)
        matched = matched | hit
    return start, matched


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
