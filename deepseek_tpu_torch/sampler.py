"""Token sampling: argmax, temperature, and proper nucleus (top-p) sampling.

Capability parity with the reference Sampler (``src/sampler.cpp``):
``temperature == 0`` short-circuits to argmax; ``sample_prob`` returns the
softmax probability of one index (used by perplexity mode). Per SURVEY.md §2
item 16, the reference's top-p loop walks the logits in raw vocab order (a
quirk); we implement the *intended* nucleus sampling — sort descending, cut
the nucleus at cumulative mass ``top_p``, renormalize, sample.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def nucleus_probs(logits: np.ndarray, temperature: float, top_p: float,
                  top_k: int = 0, min_p: float = 0.0) -> np.ndarray:
    """The ONE host-side sampling distribution, tie-handling identical to
    the JAX package's on-device sampler: each keep set is
    {p >= threshold} with boundary value-ties all kept, exactly like the
    device's binary-searched thresholds. temperature <= 0 -> one-hot
    argmax. Filters compose in the device's order: top-k (p >= k-th
    largest) ∧ min-p (p >= min_p * max(p)) cut the raw distribution,
    which renormalizes, then the nucleus (top-p) is taken over the
    remainder. top_k < 1 / min_p <= 0 disable those filters.

    Used by Sampler.sample, so the port samples from the same distribution
    as the JAX package.
    """
    logits = np.asarray(logits, dtype=np.float32).reshape(-1)
    if temperature <= 0:
        p = np.zeros(logits.shape[-1], np.float64)
        p[int(np.argmax(logits))] = 1.0
        return p
    z = logits.astype(np.float64) / max(temperature, 1e-6)
    z -= z.max()
    p = np.exp(z)
    p /= p.sum()
    if top_k >= 1 and top_k < p.size:
        kth = np.partition(p, -int(top_k))[-int(top_k)]
        p = np.where(p >= kth, p, 0.0)
    if min_p > 0.0:
        p = np.where(p >= min_p * p.max(), p, 0.0)
    p /= p.sum()
    if top_p < 1.0:
        nz = p[p > 0]
        sorted_probs = np.sort(nz)[::-1]
        cum = np.cumsum(sorted_probs)
        cutoff = int(np.searchsorted(cum, top_p) + 1)
        p_cut = sorted_probs[min(cutoff, len(sorted_probs)) - 1]
        p = np.where(p >= p_cut, p, 0.0)
        p /= p.sum()
    return p


class Sampler:
    def __init__(self, vocab_size: int, seed: Optional[int] = None):
        self.vocab_size = vocab_size
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _softmax(logits: np.ndarray) -> np.ndarray:
        x = logits.astype(np.float64)
        x = x - x.max()
        e = np.exp(x)
        return e / e.sum()

    def sample_prob(self, index: int, logits: np.ndarray) -> float:
        """softmax(logits)[index] — perplexity scoring (sampler.cpp:12-26)."""
        return float(self._softmax(np.asarray(logits))[index])

    def sample_argmax(self, logits: np.ndarray) -> int:
        return int(np.asarray(logits).argmax())

    def sample(self, logits: np.ndarray, temperature: float = 1.0,
               top_p: float = 0.95, top_k: int = 0,
               min_p: float = 0.0) -> int:
        logits = np.asarray(logits, dtype=np.float32).reshape(-1)
        if temperature == 0.0:
            return self.sample_argmax(logits)
        probs = nucleus_probs(logits, temperature, top_p, top_k, min_p)
        return int(self.rng.choice(len(probs), p=probs))
