"""What decides ``correct``: the program's outputs from the window against
the plain reference (``reference/forward.py``), run after the window on a
sample drawn from the seed, once the program's state is freed.

Served requests (``served``: prompt, served tokens, their log-probs, greedy):
each sequence prompt + tokens goes once through the reference (which
takes the program's routing where it differs from its own by a tie, the
logged experts of every position: ``reference/forward.py::route``); at every
served position the program's log-prob of the token it served is compared
with the reference's (the raw log-softmax, as the scheduler reports it),
and at greedy positions the gap by which the served token's logit lies
below the reference's best is read. Scored documents (``scored``: tokens,
the log-probs ``Engine.perplexity`` returned, the logged experts): every
target's log-prob, the reference taking the program's routing at ties.

Numbers, over all compared positions: ``lp_err_p50`` (median absolute
log-prob error), ``lp_err_p90`` and ``lp_err_max`` (the largest), ``gap_max`` (the widest
greedy gap). The cell's limits file says which of them are held, and to
what; the others are printed for the record.

The reference depends on the program's routing log (``trace.RouteLog``)
for its ties, and that dependence is held too (``ROUTING``), each at 0:
``routes_missing``, the share of compared token-layers whose experts the log
does not hold (the program stopped calling the router through the name the
log wraps, or the log was full), and ``ties_refused``, the token-layers where
the program chose other experts than the reference by more than a tie. ``control=True`` also reads
the control: the reference in TF32, the nearest precision below the
float32 that the configuration states, at the same positions (its
log-probs, and at greedy positions the f32 gap of the token TF32 puts first).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gpubench import draw
from gpubench.reference.forward import Reference

ROUTING = {"routes_missing": 0, "ties_refused": 0}


def _numbers(err: np.ndarray, gaps: np.ndarray) -> Dict[str, float]:
    out = {"lp_err_p50": float(np.median(err)), "lp_err_p90": float(np.percentile(err, 90)),
           "lp_err_max": float(err.max())}
    out["gap_max"] = float(gaps.max()) if gaps.size else 0.0
    return out


def _positions(items):
    """(sequences, row of each compared position, target ids, the
    program's log-probs, greedy mask, the program's routes of each sequence)
    from served or scored items."""
    seqs, rows, tgts, lps, greedy, routes = [], [], [], [], [], []
    start = 0
    for it in items:
        if len(it) == 5:                                   # served request
            prompt, toks, lp, g, r = it
            routes.append(r)
            seq = list(prompt) + list(toks[:-1])
            first = len(prompt) - 1
            tg = list(toks)
        else:                                              # scored document
            doc, lp, r = it
            seq, first, tg, g = list(doc), 0, list(doc[1:]), False
            routes.append(r)
        seqs.append(seq)
        rows += range(start + first, start + first + len(tg))
        tgts += tg
        lps += list(lp)
        greedy += [g] * len(tg)
        start += len(seq)
    return (seqs, np.array(rows), np.array(tgts), np.array(lps, np.float64), np.array(greedy),
            routes)


def _missing(routes, seqs, spec) -> float:
    """Share of the sequences' token-layers whose experts were not logged."""
    n_moe = sum(draw.is_moe(spec, l) for l in range(spec["num_hidden_layers"]))
    total = sum(len(s) for s in seqs) * n_moe
    logged = sum(int((np.asarray(r) >= 0).all(-1).sum()) for r in routes if r is not None)
    return 1.0 - logged / total if total else 0.0


def compare(spec: dict, seed: int, device, items, control: bool = False) -> dict:
    """{'program': numbers, 'routing': ROUTING's numbers, 'positions': n[,
    'control': numbers]}."""
    seqs, rows, tgts, lp_prog, greedy, routes = _positions(items)
    r = torch.as_tensor(rows, device=device)
    t = torch.as_tensor(tgts, device=device)

    def reference(given, tf32=False):
        ref = Reference(spec, seed, device, tf32=tf32)
        h = ref.hidden(seqs, given)[r]
        return ref, h, [x.cpu().numpy().astype(np.float64) if x.dtype != torch.int64
                        else x.cpu().numpy() for x in ref.head_stats(h, t)]

    ref, h, (lp_ref, tgt, best, _) = reference(routes)
    out = {"positions": int(len(rows)), "ties_taken": ref.ties_taken,
           "routing": {"routes_missing": _missing(routes, seqs, spec),
                       "ties_refused": ref.ties_refused},
           "program": _numbers(np.abs(lp_prog - lp_ref), (best - tgt)[greedy])}
    if control:
        # the control in the program's place: TF32 with its own routing, and
        # the reference following that routing at ties as it follows the program's
        ctl, _, (lp_c, _, _, arg_c) = reference(None, tf32=True)
        ref2, h2, (lp_r2, _, best2, _) = reference(ctl.routes_per_sequence(seqs))
        at_c = ref2.logit_of(h2, torch.as_tensor(arg_c, device=device)).cpu().numpy()
        out["control"] = _numbers(np.abs(lp_c - lp_r2), (best2 - at_c)[greedy])
        out["control_ties_taken"] = ref2.ties_taken
    return out


def verdict(got: dict, limits: Dict[str, float]) -> List[list]:
    """[name, value, limit] for every held number: the cell's limits on the
    program's numbers, then the routing log's (``ROUTING``)."""
    return ([[k, got["program"][k], limits[k]] for k in sorted(limits)]
            + [[k, got["routing"][k], v] for k, v in ROUTING.items()])
