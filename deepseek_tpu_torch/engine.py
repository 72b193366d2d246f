"""Inference engine: the reference ``Session`` (main.cpp:71-83) as a class
owning the checkpoint, config, params, tokenizer and sampler.

The port of ``deepseek_tpu/engine.py::Engine`` for a single sequence.
``hydrate`` feeds a prompt as the JAX engine does: causal prefill chunks
of ``prefill_chunk`` tokens while the position is inside the KV window,
then one decode step per token. That schedule is ``hydrate_cache``, which
also takes params and a config built in memory (a random model has no
checkpoint directory). ``generate`` samples the first token on the host
and the rest on the device, ``decode_block`` (default 32) a call, keyed
from ``PRNGKey(seed)`` as the JAX Engine keys them; ``decode_block=1``
samples every token on the host. ``generate_speculative`` (a draft
model), ``generate_ngram`` (prompt lookup) and ``generate_mtp`` (the
checkpoint's MTP layer) run 4 fused speculation rounds a call
(``speculative.py``) inside the window and a stepwise loop past it;
``perplexity`` scores a token list with the reference's estimator.
``save_session``/``load_session`` persist a hydrated cache and its next
position in the JAX Engine's session format, so a session written by
either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.models.deepseek import (
    forward_decode, forward_prefill, make_decode_loop,
)
from deepseek_tpu_torch.models.kvcache import KVCache, init_cache
from deepseek_tpu_torch.models.loader import (
    fuse_projections, load_params, params_active_bytes, params_bits_per_weight,
)
from deepseek_tpu_torch.ops import prng
from deepseek_tpu_torch.parallel.spmd import NULL_CTX
from deepseek_tpu_torch.sampler import Sampler, nucleus_probs
from deepseek_tpu_torch.tokenizer import Tokenizer
from deepseek_tpu_torch.utils.codec import _DTYPE_TO_NP, load_checkpoint, load_shard, save_shard
from deepseek_tpu_torch.utils.profiling import profile_scope

# fused speculation rounds a call (the JAX Engine's R)
SPEC_ROUNDS = 4


@dataclass
class GenerationStats:
    prompt_tokens: int = 0
    generated_tokens: int = 0
    hydrate_s: float = 0.0
    generate_s: float = 0.0
    active_bytes_per_token: float = 0.0
    # speculative decoding telemetry
    spec_rounds: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0

    @property
    def tok_per_s(self) -> float:
        return self.generated_tokens / self.generate_s if self.generate_s > 0 else 0.0

    @property
    def gb_per_s(self) -> float:
        if self.generate_s <= 0:
            return 0.0
        return self.active_bytes_per_token * self.generated_tokens / self.generate_s / 1e9


def check_card_widths(cfg: ModelConfig, factors: bool) -> None:
    """Raise ValueError where the config's attention widths are ones that
    the card's attention kernels refuse (ROADMAP.md, "Deliberate
    differences"): K3 and K10 (absorbed MLA) take kv_lora_rank R in {128,
    512} with (R + rope) % 4 == 0; K9 (MHA prefill, and the hybrid prefill
    of an MLA checkpoint that kept its ``factors`` wq_b/wkv_b) takes
    v_head_dim in {128, 512} and a head width % 4 == 0; K8 (MHA decode)
    head widths <= 256 in whole 16-byte vectors of the cache dtype. The
    plain versions on the CPU take any width: the Engine calls this on the
    card only, before any weight moves there."""
    from deepseek_tpu_torch.ops.kernels.attention import _DECODE_R, _MHA_MAX_D
    from deepseek_tpu_torch.ops.kernels.prefill_attn import _DV

    see = "(ROADMAP.md, Deliberate differences: attention widths on the card)"
    R, P, Dh, Dv = (cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.head_dim,
                    cfg.v_head_dim)
    if cfg.use_mla and (R not in _DECODE_R or (R + P) % 4):
        raise ValueError(
            f"kv_lora_rank {R} (rope {P}): K3 and K10 take kv_lora_rank in "
            f"{_DECODE_R} with (kv_lora_rank + rope) % 4 == 0 {see}")
    if (not cfg.use_mla or factors) and (Dv not in _DV or Dh % 4):
        raise ValueError(f"v_head_dim {Dv} (head width {Dh}): K9 takes v_head_dim "
                         f"in {_DV} and a head width % 4 == 0 {see}")
    if not cfg.use_mla:
        kv = str(cfg.kv_cache_dtype)
        per_vec = 16 // (1 if kv == "int8" else 4 if kv == "float32" else 2)
        if max(Dh, Dv) > _MHA_MAX_D or Dh % per_vec or Dv % per_vec:
            raise ValueError(
                f"head widths {Dh}/{Dv}: K8 takes head widths <= {_MHA_MAX_D} in "
                f"whole 16-byte vectors of the {kv} cache {see}")


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
                  target_tokens: Optional[List[int]] = None, ctx=NULL_CTX):
    """Feed ``tokens`` at positions pos0.. into the cache of a single
    sequence (``deepseek_tpu/engine.py::Engine.hydrate``): prefill chunks of
    ``prefill_chunk`` while inside the window (each clamped at the window
    edge and zero-padded to its length), decode steps past it. Returns
    (cache, last_logits | None, collected | None, end_pos):
    ``collect_all_logits`` collects per-position log-softmax rows (N, V);
    ``target_tokens`` (entry i scored against the logits after tokens[i];
    the final entry may be a dummy) collects only those log-probabilities
    (N,), gathered on the device. ``progress(i, N)`` runs after each chunk
    or step. ``ctx`` (``parallel.spmd.make_ctx``) runs the forward over this
    rank's slices of a mesh (the serving scheduler's admissions)."""
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
            with profile_scope("hydrate.prefill"):
                out = forward_prefill(params, cache, tok, pos, cfg, mode, ctx)
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
            logits = forward_decode(params, cache, tok, pos, cfg, ctx)
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
        host); ``lock_weights`` has no effect (weights are always
        resident); ``load_mtp`` reads the checkpoint's MTP layer where it
        has one (``params.mtp``, for ``generate_mtp``); the options whose
        other values are not ported raise. On the card a config whose
        attention widths the kernels refuse raises ValueError before any
        weight moves (``check_card_widths``). A K-quant checkpoint keeps its
        packed planes (``kquant_runtime=None``, the JAX default) or takes
        the nibble (``"nibble"``) or int8 turbo (``"turbo"``) layout. With
        ``DSEEK_FUSED_FFN`` set in the environment when the Engine is made,
        ``fuse_projections`` gives nibble expert [w1;w3] tables the
        row-permuted layout, whose decode runs the fused expert FFN (K7);
        the variable is read there once and never in the forward.
        ``scan_layers`` (True, False or "auto", as in the JAX Engine) is
        accepted and changes nothing: the port runs the layers one after
        another whatever it says. The JAX Engine stacks runs of like layers
        into one ``lax.scan`` to keep a deep model's compiled TPU program
        under its size cliff; eager torch compiles no program, so it has no
        such cliff, and the function computed is the same."""
        if scan_layers not in ("auto", True, False):
            raise ValueError(f"scan_layers must be True, False or 'auto', not "
                             f"{scan_layers!r}")
        device = resolve_device(device)
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
        if device.type == "cuda":
            factors = any(n.endswith(".attn.wkv_b.weight") for n in self.data.tensors) \
                and any(n.endswith(".attn.wq_b.weight") for n in self.data.tensors)
            check_card_widths(self.cfg, factors)
        params = load_params(self.data, self.cfg, device=device,
                             runtime_dtype=runtime_dtype,
                             kquant_runtime=kquant_runtime, load_mtp=load_mtp)
        if fuse:
            params = fuse_projections(params, self.cfg)
        self._attach(params, self.cfg, Tokenizer.from_checkpoint(self.data), device,
                     seed, prefill_chunk, decode_block)

    @classmethod
    def from_params(cls, params, cfg: ModelConfig, tokenizer: Tokenizer, *,
                    seed: Optional[int] = None, prefill_chunk: int = 256,
                    decode_block: int = 32) -> "Engine":
        """An Engine over weights already in memory (a random draw, which
        has no .dseek), on their device; it has no checkpoint metadata (no
        chat template). On the card the attention widths are checked as
        ``__init__`` checks them."""
        device = params.final_norm.device
        if device.type == "cuda":
            check_card_widths(cfg, any(lp.wq_b is not None and lp.wkv_b is not None
                                       for lp in params.layers))
        eng = cls.__new__(cls)
        eng.data = None
        eng.cfg = cfg
        eng._attach(params, cfg, tokenizer, device, seed, prefill_chunk, decode_block)
        return eng

    def _attach(self, params, cfg: ModelConfig, tokenizer: Tokenizer, device,
                seed: Optional[int], prefill_chunk: int, decode_block: int) -> None:
        """The state every Engine holds beside its weights' source."""
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self.params, self.cfg, self.tokenizer, self.device = params, cfg, tokenizer, device
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.decode_block = max(1, int(decode_block))
        self.sampler = Sampler(cfg.vocab_size, seed)
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

    def bits_per_weight(self) -> float:
        """Storage bits per weight of the loaded weight tensors (the
        reference's stat line, codec.cpp:40-66), runtime layout included."""
        return params_bits_per_weight(self.params)

    @property
    def chat_template(self) -> Optional[str]:
        """The checkpoint's HF chat template (the converter embeds it in the
        .dseek metadata), or None."""
        return None if self.data is None else self.data.metadata.get("chat_template")

    def render_chat(self, messages, add_generation_prompt: bool = True,
                    template: Optional[str] = None) -> str:
        """messages [{"role", "content"}, ...] -> the prompt string, through
        the checkpoint's chat template (``chat.render_chat``)."""
        from deepseek_tpu_torch.chat import ChatTemplateError, render_chat
        tpl = template or self.chat_template
        if not tpl:
            raise ChatTemplateError(
                "checkpoint has no chat_template metadata (re-convert from "
                "an HF dir whose tokenizer_config.json carries one, or pass "
                "a template explicitly)")
        md = {} if self.data is None else self.data.metadata
        return render_chat(tpl, messages, bos_token=md.get("chat_bos_token", ""),
                           eos_token=md.get("chat_eos_token", ""),
                           add_generation_prompt=add_generation_prompt)

    # ------------------------------------------------------------------
    # session persistence (``deepseek_tpu/engine.py:252-317``): the KV cache
    # and the next decode position in one safetensors-format file, tensors
    # ``session.cache.<field>`` (and ``session.tokens``), metadata
    # ``session.pos`` and the ``session.cfg.*`` fingerprint, the JAX
    # Engine's names and strings.
    _SESSION_FPR_KEYS = ("n_layers", "kv_window", "use_mla", "n_heads",
                         "kv_lora_rank", "qk_rope_head_dim",
                         "qk_nope_head_dim", "v_head_dim", "kv_cache_dtype")

    def _session_fingerprint(self) -> dict:
        c = self.cfg
        vals = dict(n_layers=c.n_layers, kv_window=c.kv_window,
                    use_mla=int(c.use_mla), n_heads=c.n_heads,
                    kv_lora_rank=c.kv_lora_rank,
                    qk_rope_head_dim=c.qk_rope_head_dim,
                    qk_nope_head_dim=c.qk_nope_head_dim,
                    v_head_dim=c.v_head_dim,
                    kv_cache_dtype=str(c.kv_cache_dtype))
        return {k: str(v) for k, v in vals.items()}

    def save_session(self, path: str, cache: KVCache, pos: int,
                     tokens: Optional[List[int]] = None) -> None:
        """Persist a hydrated session: the KV cache (every field, the int8
        cache's f32 scales and sink masters included; bf16 as its raw
        16-bit words) and the next decode position, optionally the token
        history. Resume with ``load_session`` on an Engine over the same
        checkpoint, of either package."""
        tensors = {}
        for f in dataclasses.fields(cache):
            v = getattr(cache, f.name)
            if v is not None:
                v = v.detach().cpu().contiguous()
                if v.dtype == torch.bfloat16:
                    arr = v.view(torch.int16).numpy().view(np.uint16).view(
                        _DTYPE_TO_NP["BF16"])
                else:
                    arr = v.numpy()
                tensors[f"session.cache.{f.name}"] = arr
        if tokens is not None:
            tensors["session.tokens"] = np.asarray(tokens, np.int32)
        md = {"session.pos": str(int(pos)), **{
            f"session.cfg.{k}": v for k, v in self._session_fingerprint().items()}}
        save_shard(path, tensors, metadata=md)

    def load_session(self, path: str) -> Tuple[KVCache, int, Optional[List[int]]]:
        """(cache on this Engine's device, pos, tokens or None) saved by
        ``save_session``. Raises ValueError when the session was hydrated
        under another depth, window, attention geometry or cache dtype."""
        md, tensors = load_shard(path, read_metadata=True)
        want = self._session_fingerprint()
        got = {k.split(".", 2)[2]: v for k, v in md.items()
               if k.startswith("session.cfg.")}
        if got != want:
            diff = {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
            raise ValueError(f"session {path} was saved under an incompatible config: "
                             f"{diff} (saved, engine)")
        kw = {}
        for name, tv in tensors.items():
            if name.startswith("session.cache."):
                if tv.dtype_str == "BF16":
                    t = torch.from_numpy(np.array(tv.array.view(np.uint16)).view(np.int16)
                                         ).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(np.array(tv.array))
                kw[name.split(".", 2)[2]] = t.to(self.device)
        cache = KVCache(**{f.name: kw.get(f.name) for f in dataclasses.fields(KVCache)})
        toks = (np.asarray(tensors["session.tokens"].array).tolist()
                if "session.tokens" in tensors else None)
        return cache, int(md["session.pos"]), toks

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

    def _max_new(self, n_prompt: int, num_steps: int) -> int:
        if num_steps == 0:
            return self.cfg.max_seq_len - n_prompt
        return (1 << 62) if num_steps < 0 else num_steps

    def _emitter(self, prompt_tokens: List[int], out_tokens: List[int],
                 on_token: Optional[Callable[[int, bytes], None]]):
        """emit(token) -> stop: appends, reports the piece, tests for eos."""
        prev = [prompt_tokens[-1] if prompt_tokens else self.tokenizer.bos_id]

        def emit(token: int) -> bool:
            out_tokens.append(token)
            if on_token is not None:
                on_token(token, self.tokenizer.decode_one(prev[0], token))
            prev[0] = token
            return self.tokenizer.is_eos_or_eot(token)

        return emit

    def _tok(self, token: int) -> torch.Tensor:
        return torch.full((1, 1), int(token), dtype=torch.int64, device=self.device)

    def _spec_rng(self) -> np.random.Generator:
        """The stepwise speculation's host generator, seeded from the key's
        data as the JAX Engine seeds it (engine.py:530-534)."""
        return np.random.default_rng(int(np.asarray(self._key).ravel()[-1]))

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
        stats = GenerationStats(prompt_tokens=len(prompt_tokens))
        if not prompt_tokens:
            raise ValueError("generate needs at least one prompt token")
        cache = self.new_cache()

        t0 = time.perf_counter()
        cache, logits, _, pos = self.hydrate(cache, prompt_tokens, 0)
        stats.hydrate_s = time.perf_counter() - t0
        max_new = self._max_new(len(prompt_tokens), num_steps)
        out_tokens: List[int] = []
        emit = self._emitter(prompt_tokens, out_tokens, on_token)

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
                with profile_scope("generate.decode_block"):
                    toks, _, cache = loop(self.params, cache, self._tok(token), pos,
                                          sub, temperature, top_p, top_k=top_k,
                                          min_p=min_p)
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
                with profile_scope("generate.step"):
                    logits = self.step(cache, token, pos)[0].float().cpu().numpy()
                pos += 1
                with profile_scope("generate.sample"):
                    token = self.sampler.sample(logits, temperature, top_p, top_k, min_p)
                stopped = emit(token)
        stats.generate_s = time.perf_counter() - t0
        stats.generated_tokens = len(out_tokens)
        stats.active_bytes_per_token = self.active_bytes(pos)
        return out_tokens, stats

    def _emit_rounds(self, stats: GenerationStats, emit, max_new: int, out_tokens,
                     spec_k: int, drafts_r, nacc_r, next_r):
        """Emit a fused call's rounds as the JAX Engine does: per round the
        accepted drafts, then the next token. Returns (stopped, the token
        to feed next, the positions advanced, the drafts accepted)."""
        drafts_r, nacc_r, next_r = (t.cpu().numpy() for t in (drafts_r, nacc_r, next_r))
        stopped, token, adv, accepted = False, None, 0, 0
        for r in range(len(nacc_r)):
            na = int(nacc_r[r])
            stats.spec_rounds += 1
            stats.spec_drafted += spec_k
            stats.spec_accepted += na
            accepted += na
            for d in drafts_r[r, :na]:
                stopped = emit(int(d))
                if stopped or len(out_tokens) >= max_new:
                    break
            if stopped or len(out_tokens) >= max_new:
                break
            token = int(next_r[r])
            adv += na + 1
            stopped = emit(token)
            if stopped or len(out_tokens) >= max_new:
                break
        return stopped or len(out_tokens) >= max_new, token, adv, accepted

    @torch.inference_mode()
    def generate_speculative(
        self,
        prompt_tokens: List[int],
        draft: "Engine",
        num_steps: int = 256,
        temperature: float = 0.0,
        top_p: float = 0.95,
        spec_k: int = 4,
        on_token: Optional[Callable[[int, bytes], None]] = None,
    ) -> Tuple[List[int], GenerationStats]:
        """Speculative decoding with a smaller draft model
        (``deepseek_tpu/engine.py::generate_speculative``): the draft
        proposes ``spec_k`` tokens a round, one target chunk verifies them,
        and the acceptance rule keeps the output the target's (greedy:
        ``generate``'s tokens). Fused rounds (``speculative.
        make_spec_rounds``, 4 a call) while they fit in the window, then a
        stepwise loop; past the window plain decode steps. The draft must
        share the vocabulary."""
        from deepseek_tpu_torch.speculative import make_spec_rounds

        if draft.cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError("draft and target must share the vocabulary")
        stats = GenerationStats(prompt_tokens=len(prompt_tokens))
        rng = self._spec_rng()

        t0 = time.perf_counter()
        cache, logits, _, pos = self.hydrate(self.new_cache(), prompt_tokens, 0)
        dcache, _, _, _ = draft.hydrate(draft.new_cache(), prompt_tokens, 0)
        stats.hydrate_s = time.perf_counter() - t0
        max_new = self._max_new(len(prompt_tokens), num_steps)
        out_tokens: List[int] = []
        emit = self._emitter(prompt_tokens, out_tokens, on_token)
        probs_of = lambda lg: nucleus_probs(lg, temperature, top_p)

        t0 = time.perf_counter()
        token = self.sampler.sample(logits, temperature, top_p)
        stopped = emit(token)
        window = min(self.cfg.kv_window, draft.cfg.kv_window)

        R, fused = SPEC_ROUNDS, None
        while (not stopped and len(out_tokens) < max_new and spec_k >= 1
               and pos + R * (spec_k + 1) <= window):
            if fused is None:
                fused = make_spec_rounds(self.cfg, draft.cfg, spec_k, R,
                                         greedy=temperature <= 0)
            self._key, sub = prng.split(self._key)
            drafts_r, nacc_r, next_r, cache, dcache = fused(
                self.params, draft.params, cache, dcache, self._tok(token), pos,
                sub, temperature, top_p)
            stopped, nxt, adv, _ = self._emit_rounds(
                stats, emit, max_new, out_tokens, spec_k, drafts_r, nacc_r, next_r)
            token = nxt if nxt is not None else token
            pos += adv

        while not stopped and len(out_tokens) < max_new:
            k = min(spec_k, max_new - len(out_tokens))
            if pos + k + 1 > window or k < 1:
                # past the prefill window: plain decode steps, both caches
                # in lockstep
                lg = self.step(cache, token, pos)
                draft.step(dcache, token, pos)
                pos += 1
                token = self.sampler.sample(lg[0].float().cpu().numpy(), temperature,
                                            top_p)
                stopped = emit(token)
                continue
            # 1. the draft proposes k tokens; drafts[i] is the candidate for
            #    position pos+1+i
            drafts, qdists, dtok = [], [], token
            for i in range(k):
                q = probs_of(draft.step(dcache, dtok, pos + i)[0].float().cpu().numpy())
                dtok = int(rng.choice(len(q), p=q)) if temperature > 0 \
                    else int(np.argmax(q))
                drafts.append(dtok)
                qdists.append(q)
            # 2. one target chunk scores the k drafts and gives the bonus row
            chunk = torch.tensor([[token] + drafts], dtype=torch.int64, device=self.device)
            lg_all = forward_prefill(self.params, cache, chunk, pos, self.cfg,
                                     "all")[0].float().cpu().numpy()
            # 3. acceptance (the output follows the target's distribution)
            n_acc, replacement = accept_drafts(lg_all, drafts, qdists, temperature,
                                               top_p, rng)
            stats.spec_rounds += 1
            stats.spec_drafted += k
            stats.spec_accepted += n_acc
            for d in drafts[:n_acc]:
                stopped = emit(d)
                if stopped:
                    break
            if stopped:
                break
            if replacement is not None:
                token = replacement
            else:
                # all k accepted: the draft cache lacks position pos+k (it
                # drafted drafts[-1] but never fed it)
                draft.step(dcache, drafts[-1], pos + k)
                token = int(rng.choice(len(qdists[0]), p=probs_of(lg_all[k]))) \
                    if temperature > 0 else int(np.argmax(lg_all[k]))
            pos += n_acc + 1
            if len(out_tokens) >= max_new:
                break
            stopped = emit(token)

        stats.generate_s = time.perf_counter() - t0
        stats.generated_tokens = len(out_tokens)
        stats.active_bytes_per_token = self.active_bytes(pos)
        return out_tokens, stats

    @torch.inference_mode()
    def generate_ngram(
        self,
        prompt_tokens: List[int],
        num_steps: int = 256,
        temperature: float = 0.0,
        top_p: float = 0.95,
        spec_k: int = 8,
        ngram_max: int = 3,
        on_token: Optional[Callable[[int, bytes], None]] = None,
    ) -> Tuple[List[int], GenerationStats]:
        """Prompt-lookup speculative decoding
        (``deepseek_tpu/engine.py::generate_ngram``): the drafter is the
        longest suffix n-gram match against the sequence's own history
        (``speculative.make_ngram_spec_rounds``, 4 rounds a call). After
        two dry calls (no draft accepted, or the acceptance average under
        0.15) it decodes plain blocks, probing again after an
        exponentially growing number of them; past the window edge plain
        blocks."""
        from deepseek_tpu_torch.speculative import make_ngram_spec_rounds

        stats = GenerationStats(prompt_tokens=len(prompt_tokens))
        t0 = time.perf_counter()
        cache, logits, _, pos = self.hydrate(self.new_cache(), prompt_tokens, 0)
        stats.hydrate_s = time.perf_counter() - t0
        max_new = self._max_new(len(prompt_tokens), num_steps)
        out_tokens: List[int] = []
        emit = self._emitter(prompt_tokens, out_tokens, on_token)

        t0 = time.perf_counter()
        token = self.sampler.sample(logits, temperature, top_p)
        stopped = emit(token)
        window = H = self.cfg.kv_window
        R = SPEC_ROUNDS
        fused = hist = None
        hlen = 0
        dry_dispatches, backoff_blocks = 0, 4
        ALPHA_FLOOR = 0.15
        alpha_ema = None
        plain_block = self.decode_block if self.decode_block > 1 else 8

        def run_plain_block() -> None:
            """One plain decode block (``generate``'s block)."""
            nonlocal cache, token, pos, stopped
            self._key, sub = prng.split(self._key)
            toks, _, cache = self.decode_loop(plain_block)(
                self.params, cache, self._tok(token), pos, sub, temperature, top_p)
            block = toks[0].tolist()
            pos += len(block)
            token = block[-1]
            for t in block:
                stopped = emit(t)
                if stopped or len(out_tokens) >= max_new:
                    stopped = True
                    break

        while (not stopped and len(out_tokens) < max_new and spec_k >= 1
               and len(prompt_tokens) + 1 < H
               and pos + R * (spec_k + 1) < window):
            if dry_dispatches >= 2:
                # dry phase: plain blocks, then probe speculation again
                for _ in range(backoff_blocks):
                    if (stopped or len(out_tokens) >= max_new
                            or pos + R * (spec_k + 1) >= window):
                        break
                    run_plain_block()
                backoff_blocks = min(backoff_blocks * 2, 64)
                hist = None            # stale after plain decode; rebuilt
                dry_dispatches = 1     # one more all-miss -> dry again
                alpha_ema = None
                continue
            if fused is None:
                fused = make_ngram_spec_rounds(self.cfg, spec_k, R, hist_len=H,
                                               ngram_max=ngram_max,
                                               greedy=temperature <= 0)
            if hist is None:
                seq = prompt_tokens + out_tokens       # len == pos + 1 <= H
                buf = np.zeros((1, H), np.int64)
                buf[0, :len(seq)] = seq
                hist, hlen = torch.from_numpy(buf).to(self.device), len(seq)
            self._key, sub = prng.split(self._key)
            drafts_r, nacc_r, next_r, _, cache, hist, hlen = fused(
                self.params, cache, hist, hlen, self._tok(token), pos, sub,
                temperature, top_p)
            stopped, nxt, adv, accepted = self._emit_rounds(
                stats, emit, max_new, out_tokens, spec_k, drafts_r, nacc_r, next_r)
            token = nxt if nxt is not None else token
            pos += adv
            disp_alpha = accepted / (R * spec_k)
            alpha_ema = disp_alpha if alpha_ema is None \
                else 0.6 * alpha_ema + 0.4 * disp_alpha
            if accepted == 0 or alpha_ema < ALPHA_FLOOR:
                dry_dispatches += 1
            else:
                dry_dispatches, backoff_blocks = 0, 4

        # the tail (the window edge onward): plain blocks
        while not stopped and len(out_tokens) < max_new:
            run_plain_block()

        stats.generate_s = time.perf_counter() - t0
        stats.generated_tokens = len(out_tokens)
        stats.active_bytes_per_token = self.active_bytes(pos)
        return out_tokens, stats

    @torch.inference_mode()
    def generate_mtp(
        self,
        prompt_tokens: List[int],
        num_steps: int = 256,
        temperature: float = 0.0,
        top_p: float = 0.95,
        spec_k: int = 2,
        on_token: Optional[Callable[[int, bytes], None]] = None,
    ) -> Tuple[List[int], GenerationStats]:
        """Self-speculative decoding with the checkpoint's MTP layer
        (``deepseek_tpu/engine.py::generate_mtp``): the same acceptance
        rule, drafts chained through the MTP layer's own hidden state, its
        cache re-written from the main model's hidden states after every
        verify. MTP cache slot j holds the pair (token_{j+1}, hidden_j).
        Plain ``generate`` where the prompt and the drafts do not fit in the
        window."""
        from deepseek_tpu_torch.models.mtp import init_mtp_cache, mtp_forward
        from deepseek_tpu_torch.speculative import make_mtp_spec_rounds

        if self.params.mtp is None:
            raise ValueError("checkpoint has no MTP module")
        cfg = self.cfg
        window = cfg.kv_window
        N = len(prompt_tokens)
        max_new = self._max_new(N, num_steps)
        if N + spec_k + 2 > window:
            return self.generate(prompt_tokens, num_steps, temperature, top_p, on_token)
        stats = GenerationStats(prompt_tokens=N)
        rng = self._spec_rng()

        # hydrate the main cache, keeping each position's hidden state
        t0 = time.perf_counter()
        cache = self.new_cache()
        mtp_cache = init_mtp_cache(cfg, device=self.device)
        C = self.prefill_chunk
        h_rows, logits, i = [], None, 0
        while i < N:
            cp = min(C, window - i)
            r = min(cp, N - i)
            chunk = torch.tensor([list(prompt_tokens[i:i + r]) + [0] * (cp - r)],
                                 dtype=torch.int64, device=self.device)
            last = i + r == N
            lg, hid = forward_prefill(self.params, cache, chunk, i, cfg,
                                      "all" if last else "none", with_hidden=True)
            h_rows.append(hid[0, :r])
            if last:
                logits = lg[0, r - 1].float().cpu().numpy()
            i += r
        h_prompt = torch.cat(h_rows).float()                          # (N, dim)
        stats.hydrate_s = time.perf_counter() - t0
        out_tokens: List[int] = []
        emit = self._emitter(prompt_tokens, out_tokens, on_token)
        probs_of = lambda lg: nucleus_probs(lg, temperature, top_p)

        t0 = time.perf_counter()
        token = self.sampler.sample(logits, temperature, top_p)
        stopped = emit(token)
        # the prompt's MTP pairs: slot j = (prompt[j+1], h_j), j < N-1, and
        # slot N-1 = (the first generated token, h_{N-1})
        pair_toks = torch.tensor([list(prompt_tokens[1:]) + [token]], dtype=torch.int64,
                                 device=self.device)
        mtp_forward(self.params, mtp_cache, pair_toks, h_prompt[None], 0, cfg,
                    prefill=True)
        pos = N
        h_cur = h_prompt[None, -1:]                                   # (1,1,dim)

        R, fused = SPEC_ROUNDS, None
        while (not stopped and len(out_tokens) < max_new and spec_k >= 1
               and pos + R * (spec_k + 1) <= window):
            if fused is None:
                fused = make_mtp_spec_rounds(cfg, spec_k, R, greedy=temperature <= 0)
            self._key, sub = prng.split(self._key)
            drafts_r, nacc_r, next_r, h_cur, cache, mtp_cache = fused(
                self.params, cache, mtp_cache, self._tok(token), h_cur, pos, sub,
                temperature, top_p)
            stopped, nxt, adv, _ = self._emit_rounds(
                stats, emit, max_new, out_tokens, spec_k, drafts_r, nacc_r, next_r)
            token = nxt if nxt is not None else token
            pos += adv

        mtp_live = True   # once the window fallback starts, h_cur and the
        # MTP cache go stale: drafting never resumes
        while not stopped and len(out_tokens) < max_new:
            k = min(spec_k, max_new - len(out_tokens))
            if pos + k + 1 > window or k < 1 or not mtp_live:
                mtp_live = False
                lg = self.step(cache, token, pos)
                pos += 1
                token = self.sampler.sample(lg[0].float().cpu().numpy(), temperature,
                                            top_p)
                stopped = emit(token)
                continue
            # 1. the MTP layer drafts k tokens, chaining its own hidden state
            drafts, qdists, dtok, hh = [], [], token, h_cur
            for j in range(k):
                lg_d, hh, mtp_cache = mtp_forward(self.params, mtp_cache, self._tok(dtok),
                                                  hh, pos - 1 + j, cfg, prefill=False)
                q = probs_of(lg_d[0, 0].float().cpu().numpy())
                dtok = int(rng.choice(len(q), p=q)) if temperature > 0 \
                    else int(np.argmax(q))
                drafts.append(dtok)
                qdists.append(q)
            # 2. one target chunk scores the drafts and the bonus, with hiddens
            chunk = torch.tensor([[token] + drafts], dtype=torch.int64, device=self.device)
            lg_all, h_all = forward_prefill(self.params, cache, chunk, pos, cfg, "all",
                                            with_hidden=True)
            lg_np = lg_all[0].float().cpu().numpy()                   # (k+1, V)
            # 3. lossless acceptance
            n_acc, replacement = accept_drafts(lg_np, drafts, qdists, temperature,
                                               top_p, rng)
            stats.spec_rounds += 1
            stats.spec_drafted += k
            stats.spec_accepted += n_acc
            for d in drafts[:n_acc]:
                stopped = emit(d)
                if stopped:
                    break
            if stopped:
                break
            if replacement is not None:
                token = replacement
            else:
                token = int(rng.choice(len(qdists[0]), p=probs_of(lg_np[k]))) \
                    if temperature > 0 else int(np.argmax(lg_np[k]))
            # 4. re-write the MTP pairs (chunk[j+1], h_all[j]) at pos..pos+k
            #    from the true hidden states
            pairs = torch.tensor([drafts + [token]], dtype=torch.int64, device=self.device)
            mtp_forward(self.params, mtp_cache, pairs, h_all.float(), pos, cfg,
                        prefill=True)
            h_cur = h_all[:, n_acc:n_acc + 1].float()
            pos += n_acc + 1
            if len(out_tokens) >= max_new:
                break
            stopped = emit(token)

        stats.generate_s = time.perf_counter() - t0
        stats.generated_tokens = len(out_tokens)
        stats.active_bytes_per_token = self.active_bytes(pos)
        return out_tokens, stats

    def perplexity(self, tokens: List[int],
                   progress: Optional[Callable[[int, int], None]] = None):
        """Perplexity over tokens[1:] given their prefixes (run_perplexity,
        main.cpp:371-431) -> (ppl, stderr, n_scored), the reference's
        estimator: ppl = exp(s/n), err = ppl * sqrt((ss - s^2/n) / n^2),
        s the negated sum of the log-probabilities and ss their squares'
        sum. The log-probabilities are gathered on the device
        (``hydrate_cache``'s ``target_tokens``)."""
        N = len(tokens)
        if N < 2:
            raise ValueError("perplexity needs at least 2 tokens")
        # the target after tokens[i] is tokens[i+1]; the final row has none
        _, _, logprobs, _ = self.hydrate(
            self.new_cache(), tokens, 0, want_last_logits=False, progress=progress,
            target_tokens=list(tokens[1:]) + [0])
        logprobs = logprobs[:N - 1]
        n = N - 1
        s = float(-logprobs.sum())
        ss = float((logprobs ** 2).sum())
        ppl = float(np.exp(s / n))
        err = ppl * float(np.sqrt(max(ss - s * s / n, 0.0) / n / n))
        return ppl, err, n


def accept_drafts(lg_all: np.ndarray, drafts: list, qdists: list,
                  temperature: float, top_p: float, rng) -> tuple:
    """Speculative acceptance on the host (arXiv 2211.17192 Alg. 1;
    ``deepseek_tpu/engine.py::_accept_drafts``): returns (n_accepted,
    replacement | None). Row i of lg_all verifies drafts[i]; on full
    acceptance the caller samples the bonus from lg_all[len(drafts)]."""
    for i, d in enumerate(drafts):
        p = nucleus_probs(lg_all[i], temperature, top_p)
        q = qdists[i]
        if temperature <= 0:
            if int(np.argmax(p)) == d:
                continue
            return i, int(np.argmax(p))
        if rng.random() < min(1.0, p[d] / max(q[d], 1e-12)):
            continue
        res = np.maximum(p - q, 0.0)
        res = res / res.sum() if res.sum() > 0 else p
        return i, int(rng.choice(len(res), p=res))
    return len(drafts), None
