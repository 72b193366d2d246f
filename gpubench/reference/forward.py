"""The plain reference: DeepSeek-V2/V3 in float32 (TF32 off), written from
the published architecture and run the way the configuration states.

Plain torch; imports nothing of the program and takes nothing the program
made: every weight is drawn again from the seed (``gpubench/draw.py``) a
layer (and a group of experts) at a time, and decoded here
(``reference/decode.py``). Each sequence is one causal pass over its tokens
at positions 0..n-1 (inside the 4096-slot window, so no ring, no sinks).

What it follows, per layer (HF modeling_deepseek, with the configuration's
choices):

- RMSNorm (eps from the config; the statistics in f32).
- Attention: absorbed MLA where the configuration runs it (``run.use_mla``:
  q_a = norm(x Wq_a), latent queries q_a Wc per head, rope queries
  q_a Wq_rope_b, latent rows norm(x Wkv_a[:R]), one rope key x Wkv_a[R:];
  score = q_c.ckv + q_rope.k_rope; the attended latent through Wv_b per head),
  or decompressed MHA (q = x Wq; keys [k_nope, k_rope] and values from
  norm(ckv) Wkv_b). Softmax scale 1/sqrt(qk_nope + qk_rope). Plain-theta rope
  (YaRN is not applied: ``run.use_yarn`` false), angles in f32 as pos * theta^(-2i/d).
  The configuration caches in float16: the cached rows (latent rows and rope
  keys, or MHA keys and values) are rounded to float16 before they are attended.
- FFN: SiLU GLU; MoE routing by the config's scoring (sigmoid / softmax) and
  top-k method (noaux_tc: groups ranked by the sum of their top-2 biased
  scores, topk_group kept; greedy: plain top-k), weights from the unbiased
  scores, normalized where norm_topk_prob, times routed_scaling_factor; the
  shared experts always on.
- Final norm and the lm_head.

``tf32=True`` is the control: the same computation with every product's
operands rounded to TF32 (10 mantissa bits, round to nearest) and summed
in float32, as TF32 tensor cores take them; rounding them here, rather than
switching the card's TF32 mode on, gives the control the same bits on the
CPU, where its test runs, as on the card.
"""

from __future__ import annotations

import itertools

import contextlib
import math
from typing import List, Sequence

import numpy as np
import torch

from gpubench import draw
from gpubench.reference.decode import rows_to_f32, to_f32

EXPERT_GROUP = 16          # experts decoded to f32 at a time
HEAD_ROWS = 16384          # lm_head rows decoded at a time


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for the duration: float32 products stay float32."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate pairs (x[2i], x[2i+1]) of the last axis by pos * theta^(-2i/d);
    the rotated pairs come out as [real parts, imaginary parts] (HF's
    de-interleave then rotate_half). The layout is the same for queries and
    keys, so scores do not depend on it."""
    d = x.shape[-1]
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                     -(torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = pos.float()[:, None] * freq                          # (N, d/2)
    shape = (-1,) + (1,) * (x.dim() - 2) + (d // 2,)
    cos, sin = torch.cos(ang).reshape(shape), torch.sin(ang).reshape(shape)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)


# A routing choice within this much (in router score) of the reference's own
# top-k is a rounding tie: the program may take either side of it. ~100x the
# score noise of the program's float32 arithmetic, ~1-10x that of TF32
# products, and under the typical gap between the k-th and the (k+1)-th
# score (~5e-3 at DeepSeek-V3's 256 experts).
TIE = 1e-3


def _group_scores(sel: torch.Tensor, hf: dict) -> torch.Tensor:
    """(N, groups) scores of the expert groups (one group for greedy)."""
    N, E = sel.shape
    if hf["topk_method"] == "greedy":
        return sel.new_zeros(N, 1)
    grouped = sel.reshape(N, hf["n_group"], E // hf["n_group"])
    if hf["topk_method"] == "noaux_tc":
        return grouped.topk(2, dim=-1).values.sum(-1)
    return grouped.amax(-1)


def _top_k(sel: torch.Tensor, gs: torch.Tensor, hf: dict, groups=None) -> torch.Tensor:
    """The top-k experts of sel (N, E) inside the topk_group best groups, or
    inside ``groups`` (N, G) bool where given."""
    N, E = sel.shape
    k, G = hf["num_experts_per_tok"], gs.shape[1]
    if G > 1:
        if groups is None:
            groups = torch.zeros(N, G, dtype=torch.bool, device=sel.device)
            groups.scatter_(1, gs.topk(hf["topk_group"], dim=-1).indices, True)
        sel = sel.masked_fill(~groups.repeat_interleave(E // G, dim=1), float("-inf"))
    return sel.topk(k, dim=-1).indices


def _is_tie(sel_r, gs_r, given_r, hf) -> bool:
    """Whether one row's given experts are a top-k of the reference's scores
    up to ``TIE``: for some set S of topk_group groups that holds their
    groups and is a top-topk_group of the group scores within TIE (a group
    of S may have given no expert, so each such fill is tried), the given
    experts' lowest score lies within TIE of the best expert of S left out."""
    G = gs_r.shape[0]
    E = sel_r.shape[0]
    ng = hf["topk_group"] if G > 1 else 1
    own = sorted(set((given_r // (E // G)).tolist()))
    if len(own) > ng:
        return False
    others = [g for g in range(G) if g not in own]
    low = sel_r[given_r].min()
    for fill in itertools.combinations(others, ng - len(own)):
        S = own + list(fill)
        out = [g for g in range(G) if g not in S]
        if out and gs_r[S].min() < gs_r[out].max() - TIE:
            continue
        keep = torch.zeros(G, dtype=torch.bool, device=sel_r.device)
        keep[S] = True
        rest = sel_r.masked_fill(~keep.repeat_interleave(E // G), float("-inf"))
        rest[given_r] = float("-inf")
        if low >= rest.max() - TIE:
            return True
    return False


def route(scores: torch.Tensor, hf: dict, bias, given=None):
    """(weights (N, k), experts (N, k), rows whose ``given`` choice was
    taken, rows whose ``given`` choice was refused) from router scores
    (N, E). ``given`` (N, k), -1 rows unknown: the program's choice, taken
    where it differs from the reference's own only by ties (``_is_tie``)."""
    sel = scores if bias is None else scores + bias
    N = sel.shape[0]
    gs = _group_scores(sel, hf)
    idx = _top_k(sel, gs, hf)
    taken = torch.zeros(N, dtype=torch.bool, device=sel.device)
    refused = torch.zeros(N, dtype=torch.bool, device=sel.device)
    if given is not None:
        given = torch.as_tensor(given, device=sel.device)
        known = (given >= 0).all(-1)
        differ = known & (given.sort(-1).values != idx.sort(-1).values).any(-1)
        for row in differ.nonzero().flatten().tolist():
            ok = _is_tie(sel[row], gs[row], given[row], hf)
            (taken if ok else refused)[row] = True
            if ok:
                idx[row] = given[row]
    w = scores.gather(1, idx)
    if hf["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * hf["routed_scaling_factor"], idx, taken, refused


class Reference:
    """The reference over configuration ``spec`` drawn from ``seed``."""

    def __init__(self, spec: dict, seed: int, device, tf32: bool = False):
        self.hf, self.run, self.seed = spec, spec["run"], seed
        self.device, self.tf32 = torch.device(device), tf32
        self.eps = float(spec["rms_norm_eps"])
        self.ties_taken = self.ties_refused = 0     # routing choices given and taken, refused
        self.chosen = []                            # the experts chosen, (N, k) a MoE layer

    def _w(self, ws: draw.WeightSpec) -> torch.Tensor:
        return to_f32(draw.draw(self.seed, ws, self.run, self.device), self.run["quant"],
                      self.run.get("block_size"))

    def _named(self, specs: List[draw.WeightSpec], name: str) -> draw.WeightSpec:
        return next(w for w in specs if w.name.endswith("." + name))

    # -- attention --------------------------------------------------------
    def _attention(self, layer: int, h: torch.Tensor, pos: torch.Tensor,
                   spans: Sequence[slice]) -> torch.Tensor:
        hf = self.hf
        H, R, P = hf["num_attention_heads"], hf["kv_lora_rank"], hf["qk_rope_head_dim"]
        nope, Dv = hf["qk_nope_head_dim"], hf["v_head_dim"]
        scale = 1.0 / math.sqrt(nope + P)
        theta = float(hf["rope_theta"])
        specs = draw.attention_weights(hf, self.run, layer)
        W = lambda n: self._w(self._named(specs, n))   # noqa: E731
        N = h.shape[0]
        mm, ein = self.mm, self.ein
        kv_a = mm(h, W("wkv_a"))
        ckv = rms_norm(kv_a[:, :R], self.eps)
        k_pe = rope(kv_a[:, R:], pos, theta)
        f16 = lambda t: t.half().float()               # noqa: E731  (the f16 cache)
        out = torch.empty(N, H, Dv, device=h.device)
        if self.run["use_mla"]:
            q_a = rms_norm(mm(h, W("wq_a")), self.eps)
            q_c = mm(q_a, W("wc")).reshape(N, H, R)
            q_r = rope(mm(q_a, W("wq_rope_b")).reshape(N, H, P), pos, theta)
            wv = W("wv_b").reshape(H, Dv, R)
            c16, r16 = f16(ckv), f16(k_pe)
            for sp in spans:
                T = sp.stop - sp.start
                s = (ein("thr,sr->hts", q_c[sp], c16[sp])
                     + ein("thp,sp->hts", q_r[sp], r16[sp])) * scale
                s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=h.device)
                                  .triu(1), float("-inf"))
                lat = ein("hts,sr->thr", s.softmax(-1), c16[sp])
                out[sp] = ein("thr,hvr->thv", lat, wv)
        else:
            q = mm(h, W("wq")).reshape(N, H, nope + P)
            q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], dim=-1)
            kv = mm(ckv, W("wkv_b")).reshape(N, H, nope + Dv)
            k = f16(torch.cat([kv[..., :nope], k_pe[:, None, :].expand(N, H, P)], dim=-1))
            v = f16(kv[..., nope:])
            for sp in spans:
                T = sp.stop - sp.start
                s = ein("thd,shd->hts", q[sp], k[sp]) * scale
                s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=h.device)
                                  .triu(1), float("-inf"))
                out[sp] = ein("hts,shv->thv", s.softmax(-1), v[sp])
        return mm(out.reshape(N, H * Dv), W("wo"))

    # -- feed-forward -----------------------------------------------------
    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a @ w.T in float32, or with TF32 operands (the control)."""
        if self.tf32:
            a, w = tf32_round(a), tf32_round(w)
        return a @ w.t()

    def ein(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            ops = tuple(tf32_round(o) for o in ops)
        return torch.einsum(eq, *ops)

    def _glu(self, x, w1, w3, w2):
        return self.mm(torch.nn.functional.silu(self.mm(x, w1)) * self.mm(x, w3), w2)

    def _ffn(self, layer: int, h: torch.Tensor, given=None) -> torch.Tensor:
        hf, run = self.hf, self.run
        specs = draw.ffn_weights(hf, layer)
        W = lambda n: self._w(self._named(specs, n))   # noqa: E731
        if not draw.is_moe(hf, layer):
            return self._glu(h, W("w1"), W("w3"), W("w2"))
        E = hf["n_routed_experts"]
        logits = self.mm(h, draw.router(self.seed, f"l{layer}.moegate", E, hf["hidden_size"],
                                        self.device))
        scores = logits.sigmoid() if hf["scoring_func"] == "sigmoid" else logits.softmax(-1)
        weights, idx, taken, refused = route(scores, hf, draw.gate_bias(hf, self.device),
                                             given)
        self.ties_taken += int(taken.sum())
        self.ties_refused += int(refused.sum())
        self.chosen.append(idx.cpu().numpy())
        out = self._glu(h, W("shared_w1"), W("shared_w3"), W("shared_w2"))
        tables = {n: draw.draw(self.seed, self._named(specs, n), run, self.device)
                  for n in ("w1", "w3", "w2")}
        for lo in range(0, E, EXPERT_GROUP):
            hi = min(E, lo + EXPERT_GROUP)
            dec = {n: to_f32(draw.slice_experts(t, lo, hi), run["quant"],
                             run.get("block_size")) for n, t in tables.items()}
            for e in range(lo, hi):
                tok, slot = (idx == e).nonzero(as_tuple=True)
                if tok.numel() == 0:
                    continue
                y = self._glu(h[tok], dec["w1"][e - lo], dec["w3"][e - lo], dec["w2"][e - lo])
                out.index_add_(0, tok, y * weights[tok, slot][:, None])
            del dec
        return out

    # -- the model --------------------------------------------------------
    @torch.no_grad()
    def hidden(self, seqs: Sequence[Sequence[int]], routes=None) -> torch.Tensor:
        """Final-normed hidden states (sum of lengths, dim) of every position
        of every sequence, the sequences concatenated. ``routes``: per
        sequence None or (length, MoE layers, k) experts the program chose
        (-1 unknown), taken where they differ from the reference's own by a
        tie (``route``); ``self.chosen`` keeps the experts used."""
        hf, dev = self.hf, self.device
        spans, start = [], 0
        for s in seqs:
            spans.append(slice(start, start + len(s)))
            start += len(s)
        toks = torch.tensor([t for s in seqs for t in s], dtype=torch.int64, device=dev)
        pos = torch.cat([torch.arange(len(s), device=dev) for s in seqs])
        with float32_matmuls():
            emb = draw.draw(self.seed, draw.embed_weight(hf), self.run, dev)
            x = rows_to_f32(emb, toks, self.run["quant"], self.run.get("block_size"))
            del emb
            given = None
            if routes is not None:
                k = hf["num_experts_per_tok"]
                n_moe = sum(draw.is_moe(hf, l) for l in range(hf["num_hidden_layers"]))
                given = np.concatenate([np.full((len(s), n_moe, k), -1) if r is None
                                        else np.asarray(r) for s, r in zip(seqs, routes)])
            li = 0
            for layer in range(hf["num_hidden_layers"]):
                x = x + self._attention(layer, rms_norm(x, self.eps), pos, spans)
                g = None
                if given is not None and draw.is_moe(hf, layer):
                    g, li = given[:, li], li + 1
                x = x + self._ffn(layer, rms_norm(x, self.eps), g)
            return rms_norm(x, self.eps)

    def routes_per_sequence(self, seqs) -> list:
        """``self.chosen`` as ``hidden``'s ``routes`` argument."""
        if not self.chosen:
            return [None] * len(seqs)
        allr = np.stack(self.chosen, axis=1)                  # (N, MoE layers, k)
        bounds = np.cumsum([0] + [len(s) for s in seqs])
        return [allr[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    @torch.no_grad()
    def head_stats(self, h: torch.Tensor, targets: torch.Tensor):
        """For hidden rows h (N, dim) and target ids (N,): (log-softmax of the
        target, the target's logit, the best logit, the best id), the
        lm_head taken HEAD_ROWS vocabulary rows at a time."""
        hw = draw.head_weight(self.hf)
        fields = draw.draw(self.seed, hw, self.run, self.device)
        N = h.shape[0]
        lse = torch.full((N,), float("-inf"), device=h.device)
        best = torch.full((N,), float("-inf"), device=h.device)
        arg = torch.zeros(N, dtype=torch.int64, device=h.device)
        tgt = torch.zeros(N, device=h.device)
        with float32_matmuls():
            for lo in range(0, hw.rows, HEAD_ROWS):
                hi = min(hw.rows, lo + HEAD_ROWS)
                if self.run["quant"] == "q3_k":
                    part = draw.slice_experts(fields, lo, hi)
                else:                               # fp8 scales have row blocks
                    b0 = self.run["block_size"][0]
                    part = (fields[0][lo:hi], fields[1][lo // b0:-(-hi // b0)])
                lg = self.mm(h, to_f32(part, self.run["quant"], self.run.get("block_size")))
                lse = torch.logaddexp(lse, torch.logsumexp(lg, dim=-1))
                m, a = lg.max(dim=-1)
                upd = m > best
                best, arg = torch.where(upd, m, best), torch.where(upd, a + lo, arg)
                inside = (targets >= lo) & (targets < hi)
                tgt = torch.where(inside, lg.gather(1, (targets - lo).clamp(0, hi - lo - 1)
                                                    [:, None])[:, 0], tgt)
        return tgt - lse, tgt, best, arg

    def logit_of(self, h: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The logits of ids (N,) at hidden rows h (N, dim), in float32."""
        hw = draw.head_weight(self.hf)
        rows = rows_to_f32(draw.draw(self.seed, hw, self.run, self.device), ids,
                           self.run["quant"], self.run.get("block_size"))
        return (h * rows).sum(-1)
