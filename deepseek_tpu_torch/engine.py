"""Inference engine: the reference ``Session`` (main.cpp:71-83) as a class
owning the checkpoint, config, params, tokenizer and sampler.

The port of ``deepseek_tpu/engine.py::Engine`` (``__init__``, ``hydrate``,
``generate``, ``decode_loop``) for a single sequence. ``hydrate`` feeds a
prompt as the JAX engine does: causal prefill chunks of ``prefill_chunk``
tokens while the position is inside the KV window, then one decode step
per token. That schedule is ``hydrate_cache``, which also takes params and
a config built in memory (a random model has no checkpoint directory).
``generate`` samples the first token on the host and the rest on the
device, ``decode_block`` (default 32) a call, keyed from
``PRNGKey(seed)`` as the JAX Engine keys them; ``decode_block=1`` samples
every token on the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.models.deepseek import (
    forward_decode, forward_prefill, make_decode_loop,
)
from deepseek_tpu_torch.models.kvcache import init_cache
from deepseek_tpu_torch.models.loader import (
    fuse_projections, load_params, params_active_bytes,
)
from deepseek_tpu_torch.ops import prng
from deepseek_tpu_torch.sampler import Sampler
from deepseek_tpu_torch.tokenizer import Tokenizer
from deepseek_tpu_torch.utils.codec import load_checkpoint


@dataclass
class GenerationStats:
    prompt_tokens: int = 0
    generated_tokens: int = 0
    hydrate_s: float = 0.0
    generate_s: float = 0.0
    active_bytes_per_token: float = 0.0

    @property
    def tok_per_s(self) -> float:
        return self.generated_tokens / self.generate_s if self.generate_s > 0 else 0.0

    @property
    def gb_per_s(self) -> float:
        if self.generate_s <= 0:
            return 0.0
        return self.active_bytes_per_token * self.generated_tokens / self.generate_s / 1e9


def resolve_device(device) -> torch.device:
    """The engine's device; "cuda" without a visible GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA GPU is visible; pass "
                           "device='cpu' to run the plain versions")
    return dev


@torch.inference_mode()
def hydrate_cache(params, cfg: ModelConfig, cache, tokens: List[int],
                  pos0: int = 0, *, prefill_chunk: int = 256,
                  want_last_logits: bool = True,
                  collect_all_logits: bool = False,
                  progress: Optional[Callable[[int, int], None]] = None,
                  target_tokens: Optional[List[int]] = None):
    """Feed ``tokens`` at positions pos0.. into the cache of a single
    sequence (``deepseek_tpu/engine.py::Engine.hydrate``): prefill chunks of
    ``prefill_chunk`` while inside the window (each clamped at the window
    edge and zero-padded to its length), decode steps past it. Returns
    (cache, last_logits | None, collected | None, end_pos):
    ``collect_all_logits`` collects per-position log-softmax rows (N, V);
    ``target_tokens`` (entry i scored against the logits after tokens[i];
    the final entry may be a dummy) collects only those log-probabilities
    (N,), gathered on the device. ``progress(i, N)`` runs after each chunk
    or step."""
    window = cfg.kv_window
    C = max(1, int(prefill_chunk))
    device = cache.device
    N = len(tokens)
    last_logits = None
    collect = collect_all_logits or target_tokens is not None
    chunks: List[np.ndarray] = []      # per-chunk (r, V) lsm or (r,) lp

    def collect_rows(rows: torch.Tensor, i: int, r: int):
        """rows: (T, V) logits for positions i..i+r-1 (T >= r)."""
        lsm = torch.log_softmax(rows[:r].float(), dim=-1)
        if target_tokens is not None:
            tg = torch.as_tensor(list(target_tokens[i:i + r]), device=lsm.device)
            chunks.append(lsm.gather(1, tg[:, None])[:, 0].cpu().numpy())
        else:
            chunks.append(lsm.cpu().numpy())

    i = 0
    while i < N:
        pos = pos0 + i
        if pos < window:
            cp = min(C, window - pos)
            r = min(cp, N - i)
            chunk = list(tokens[i:i + r]) + [0] * (cp - r)
            need_last = i + r == N and want_last_logits
            mode = "all" if (collect or (need_last and r < cp)) else (
                "last" if need_last else "none")
            tok = torch.tensor([chunk], dtype=torch.int64, device=device)
            out = forward_prefill(params, cache, tok, pos, cfg, mode)
            if mode == "all":
                if collect:
                    collect_rows(out[0], i, r)
                if need_last:
                    last_logits = out[0, r - 1].float().cpu().numpy()
            elif mode == "last":
                last_logits = out[0].float().cpu().numpy()
            i += r
        else:
            tok = torch.tensor([[int(tokens[i])]], dtype=torch.int64, device=device)
            logits = forward_decode(params, cache, tok, pos, cfg)
            if collect:
                collect_rows(logits, i, 1)
            if i + 1 == N and want_last_logits:
                last_logits = logits[0].float().cpu().numpy()
            i += 1
        if progress is not None:
            progress(i, N)
    collected = np.concatenate(chunks, axis=0) if chunks else None
    return cache, last_logits, collected, pos0 + N


class Engine:
    def __init__(
        self,
        checkpoint_dir: str,
        *,
        context: int = 0,
        lock_weights: bool = False,
        compute_dtype: Optional[str] = None,
        runtime_dtype: Optional[str] = None,
        kv_cache_dtype: Optional[str] = None,
        seed: Optional[int] = None,
        prefill_chunk: int = 256,
        decode_block: int = 32,
        use_yarn: bool = False,
        load_mtp: bool = True,
        kquant_runtime: Optional[str] = None,
        fuse: bool = True,
        scan_layers="auto",
        device="cuda",
    ):
        """Same keywords as the JAX Engine. ``prefill_chunk`` is the
        prompt chunk ``hydrate`` prefills at a time, ``decode_block`` the
        tokens ``generate`` samples on the device a call (1: each on the
        host); ``lock_weights`` and ``load_mtp`` have no effect in this
        slice (weights are always resident, no MTP head); the options whose
        other values are not ported raise. A K-quant checkpoint keeps its
        packed planes (``kquant_runtime=None``, the JAX default) or takes
        the nibble (``"nibble"``) or int8 turbo (``"turbo"``) layout. With
        ``DSEEK_FUSED_FFN`` set in the environment when the Engine is made,
        ``fuse_projections`` gives nibble expert [w1;w3] tables the
        row-permuted layout, whose decode runs the fused expert FFN (K7);
        the variable is read there once and never in the forward."""
        if scan_layers not in ("auto", False):
            raise NotImplementedError(
                "scan-stacked layers have no counterpart in the port "
                "(ROADMAP.md queue 1, item 15)")
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.decode_block = max(1, int(decode_block))
        self.device = resolve_device(device)
        self.data = load_checkpoint(checkpoint_dir)
        overrides = {}
        if compute_dtype:
            overrides["compute_dtype"] = compute_dtype
        if kv_cache_dtype:
            overrides["kv_cache_dtype"] = kv_cache_dtype
        if use_yarn:
            overrides["use_yarn"] = True
        self.cfg = ModelConfig.from_metadata(self.data.metadata, context=context,
                                             **overrides)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self.params = load_params(self.data, self.cfg, device=self.device,
                                  runtime_dtype=runtime_dtype,
                                  kquant_runtime=kquant_runtime)
        if fuse:
            self.params = fuse_projections(self.params, self.cfg)
        self.tokenizer = Tokenizer.from_checkpoint(self.data)
        self.sampler = Sampler(self.cfg.vocab_size, seed)
        self._key = prng.PRNGKey(seed if seed is not None else 0)
        self._loops = {}

    def decode_loop(self, n_steps: int):
        """``make_decode_loop(cfg, n_steps)``, made once per ``n_steps``."""
        if n_steps not in self._loops:
            self._loops[n_steps] = make_decode_loop(self.cfg, n_steps)
        return self._loops[n_steps]

    def new_cache(self, batch: int = 1):
        return init_cache(self.cfg, batch=batch, device=self.device)

    def active_bytes(self, pos: int = 0) -> float:
        return params_active_bytes(self.params, self.cfg, pos)

    @torch.inference_mode()
    def step(self, cache, token: int, pos: int) -> torch.Tensor:
        """One decode step for a single sequence -> logits (1, V) on device."""
        tok = torch.tensor([[token]], dtype=torch.int64, device=self.device)
        return forward_decode(self.params, cache, tok, pos, self.cfg)

    def hydrate(self, cache, tokens: List[int], pos0: int = 0,
                want_last_logits: bool = True,
                collect_all_logits: bool = False,
                progress: Optional[Callable[[int, int], None]] = None,
                target_tokens: Optional[List[int]] = None):
        """``hydrate_cache`` with this engine's params, config and
        ``prefill_chunk``."""
        return hydrate_cache(self.params, self.cfg, cache, tokens, pos0,
                             prefill_chunk=self.prefill_chunk,
                             want_last_logits=want_last_logits,
                             collect_all_logits=collect_all_logits,
                             progress=progress, target_tokens=target_tokens)

    def generate(
        self,
        prompt_tokens: List[int],
        num_steps: int = 256,
        temperature: float = 1.0,
        top_p: float = 0.95,
        on_token: Optional[Callable[[int, bytes], None]] = None,
        top_k: int = 0,
        min_p: float = 0.0,
    ) -> Tuple[List[int], GenerationStats]:
        """Completion loop (run_completion, main.cpp:277-361).
        num_steps: 0 = up to max_seq_len, -1 = until eos."""
        cfg = self.cfg
        stats = GenerationStats(prompt_tokens=len(prompt_tokens))
        if not prompt_tokens:
            raise ValueError("generate needs at least one prompt token")
        cache = self.new_cache()

        t0 = time.perf_counter()
        cache, logits, _, pos = self.hydrate(cache, prompt_tokens, 0)
        stats.hydrate_s = time.perf_counter() - t0

        if num_steps == 0:
            max_new = cfg.max_seq_len - len(prompt_tokens)
        elif num_steps < 0:
            max_new = 1 << 62
        else:
            max_new = num_steps

        out_tokens: List[int] = []
        prev = prompt_tokens[-1]

        def emit(token: int) -> bool:
            nonlocal prev
            out_tokens.append(token)
            if on_token is not None:
                on_token(token, self.tokenizer.decode_one(prev, token))
            prev = token
            return self.tokenizer.is_eos_or_eot(token)

        t0 = time.perf_counter()
        # the first token from the hydrate logits (host sampler)
        token = self.sampler.sample(logits, temperature, top_p, top_k, min_p)
        stopped = emit(token)
        if self.decode_block > 1:
            # decode_block tokens sampled on the device a call; the cache
            # runs the whole block, as the JAX Engine's does
            loop = self.decode_loop(self.decode_block)
            while not stopped and len(out_tokens) < max_new:
                self._key, sub = prng.split(self._key)
                tok = torch.full((1, 1), token, dtype=torch.int64, device=self.device)
                toks, _, cache = loop(self.params, cache, tok, pos, sub, temperature,
                                      top_p, top_k=top_k, min_p=min_p)
                block = toks[0].tolist()
                pos += len(block)
                token = block[-1]
                for t in block:
                    stopped = emit(t)
                    if stopped or len(out_tokens) >= max_new:
                        stopped = True
                        break
        else:
            while not stopped and len(out_tokens) < max_new:
                logits = self.step(cache, token, pos)[0].float().cpu().numpy()
                pos += 1
                token = self.sampler.sample(logits, temperature, top_p, top_k, min_p)
                stopped = emit(token)
        stats.generate_s = time.perf_counter() - t0
        stats.generated_tokens = len(out_tokens)
        stats.active_bytes_per_token = self.active_bytes(pos)
        return out_tokens, stats
