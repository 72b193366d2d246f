"""Continuous batching: the port of ``deepseek_tpu/serving.py``.

Several requests share one batched KV cache. A finished sequence frees its
slot, and a queued request is admitted by prefilling a detached one-row
cache one bounded chunk per scheduler step, between decode blocks, so
running sequences never stall behind a whole prompt; the hydrated rows are
then copied into the slot's batch row of the shared cache in place. Decode
runs as one batched block (``models/deepseek.py::make_decode_loop``) with
per-slot positions, per-slot sampling parameters (host arrays, one
non-blocking copy each a block) and a mask of live slots whose dead rows
do no expert work.

``PrefixCache`` keeps the hydrated rows of block-aligned prompt prefixes
and restores them into a new admission that shares a prefix: slices of the
ring taken as tensor copies and written back in place. ``spec="ngram"`` /
``"mtp"`` replace decode blocks by batched speculation rounds
(``speculative.make_batched_ngram_spec_rounds`` /
``make_batched_mtp_spec_rounds``) while every slot is inside the window.

Eager torch compiles nothing: there is no jit and no donation, one decode
block serves every occupancy (the JAX scheduler compiles one per occupancy
bucket; here the pair list keeps exactly the live rows' pairs), and
``warmup`` builds the kernels and runs each path once on throwaway rows.
Three faults of the JAX scheduler are not copied: its prefix-cache warmup
stops at 8-block chains (``serving.py:225``; here nothing is compiled, so
nothing is capped); its speculation acceptance average counts slots that
finished inside the dispatch (``serving.py:763``; here the slots are
counted before the emission and a finished slot adds no more accepted
drafts); and after plain-decode backoff its MTP drafter cache is stale
(``serving.py:697``; here every plain block re-feeds its (token, hidden)
pairs into the drafter cache, so a probe drafts over fresh context).

Over a device mesh (``mesh=``, ``parallel/``) the scheduler runs on every
rank, SPMD, where the JAX scheduler is one controller: each rank holds its
slices of the weights and of the batch's cache (its data shard's rows),
gets the same requests, and takes the same host decisions, because the
decode block and the speculation rounds hand every rank the whole batch's
tokens (gathered over the data line) and nothing decides on a clock. An
admission hydrates its one-row cache on every data shard alike (a row
cannot split over data; the tensor, expert and seq axes cut it as the
batch's) and the rank that owns the slot merges it.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from deepseek_tpu_torch.engine import Engine, hydrate_cache
from deepseek_tpu_torch.models.kvcache import KVCache
from deepseek_tpu_torch.ops import prng
from deepseek_tpu_torch.parallel.spmd import NULL_CTX, make_ctx
from deepseek_tpu_torch.utils.profiling import span

# KVCache fields that are no ring: the int8 sink keys' float masters
_MASTERS = ("sink_krope", "sink_k")


def _fields(cache: KVCache):
    """(name, tensor) of every tensor field of the cache."""
    return [(f.name, getattr(cache, f.name)) for f in dataclasses.fields(cache)
            if getattr(cache, f.name) is not None]


def merge_row(cache: KVCache, sub: KVCache, row: int) -> None:
    """Copy a 1-row cache into batch row ``row`` of ``cache``, in place."""
    for (_, full), (_, part) in zip(_fields(cache), _fields(sub)):
        full[:, row].copy_(part[:, 0])


@dataclasses.dataclass
class _Pending:
    """An admission in flight: hydrating into a detached 1-row cache."""
    req: "Request"
    slot: int
    cache: KVCache
    fed: int = 0                     # prompt tokens hydrated so far


class PrefixCache:
    """Block-level prompt-prefix KV reuse across requests.

    The hydrated rows of block-aligned prompt prefixes are kept in an LRU
    store keyed by the cumulative token prefix; a new admission that shares
    a prefix with an earlier prompt restores those rows (tensor copies)
    instead of prefilling them again.

    Exactness: ring rows [0, P) are written once at their position during
    hydration and never change while pos < window (the sink re-rotation and
    the ring's wrap start at pos >= window), so a stored block equals a
    fresh hydration of the same prefix. Prompts longer than the window are
    never stored. Block j is keyed by tokens[0:(j+1)*block], so chains
    extend as far as two prompts agree; a block holds the ring slice of
    every ring field (rows and int8 scales) and, restored with block 0
    only, the sink masters.
    """

    def __init__(self, block_tokens: int = 64, budget_mb: float = 64.0,
                 base: int = 0, window: int = 0):
        """``base`` and ``window``: under a seq axis the position of this
        rank's first ring slot and the whole window (0: the cache's own),
        so that a block keeps this rank's part of its slots; its bytes are
        counted as the whole block's on every rank, so every rank evicts
        alike."""
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        self.block = block_tokens
        self.budget = int(budget_mb * 1e6)
        self.base, self.window = base, window
        self._store: Dict[bytes, list] = {}  # key -> [frag, nbytes]; insertion order = LRU
        self._bytes = 0
        self.hits = 0                # admissions that reused >= 1 block
        self.misses = 0              # admissions with no reusable prefix
        self.tokens_reused = 0       # prompt tokens not prefilled again

    def _span(self, cache: KVCache, off: int) -> slice:
        """This rank's slots of the block at global slot ``off``."""
        lo, hi = off - self.base, off + self.block - self.base
        return slice(min(max(lo, 0), cache.window), min(max(hi, 0), cache.window))

    def _slice(self, cache: KVCache, off: int) -> Dict[str, torch.Tensor]:
        span = self._span(cache, off)
        return {n: (t.clone() if n in _MASTERS else t[:, :, span].clone())
                for n, t in _fields(cache)}

    def _write(self, cache: KVCache, frag: Dict[str, torch.Tensor], off: int) -> None:
        span = self._span(cache, off)
        for n, t in _fields(cache):
            if n not in _MASTERS:
                t[:, :, span].copy_(frag[n])
            elif off == 0:           # the same in every block of a chain
                t.copy_(frag[n])

    def _block_bytes(self, cache: KVCache) -> int:
        """A block's bytes on one device, whatever part this rank holds."""
        total = 0
        for n, t in _fields(cache):
            nb = t.numel() * t.element_size()
            total += nb if n in _MASTERS else nb // cache.window * self.block
        return total

    def match(self, tokens: List[int]):
        """Longest stored block chain that is a proper prefix of ``tokens``
        (one token at least must remain to give the first step's logits).
        Returns (n_reusable_tokens, [block fragments])."""
        arr = np.asarray(tokens, np.int32)
        keys, frags = [], []
        while (len(keys) + 1) * self.block <= len(tokens) - 1:
            key = arr[:(len(keys) + 1) * self.block].tobytes()
            e = self._store.get(key)
            if e is None:
                break
            keys.append(key)
            frags.append(e[0])
        # LRU-touch deep to shallow: a chain's root must be its newest
        # entry, or evicting the root orphans every deeper block
        for key in reversed(keys):
            self._store[key] = self._store.pop(key)
        if frags:
            self.hits += 1
            self.tokens_reused += len(keys) * self.block
        else:
            self.misses += 1
        return len(keys) * self.block, frags

    def restore(self, cache: KVCache, frags) -> KVCache:
        """Write matched blocks into a fresh 1-row cache, in place."""
        for j, frag in enumerate(frags):
            self._write(cache, frag, j * self.block)
        return cache

    def insert(self, tokens: List[int], cache: KVCache) -> None:
        """Store every complete block of a fully hydrated prompt; skipped for
        prompts past the window (their hydration wrapped the ring and
        re-rotated the sinks)."""
        if len(tokens) > (self.window or cache.window):
            return
        arr = np.asarray(tokens, np.int32)
        n_blocks = (len(tokens) - 1) // self.block
        # store/touch deep to shallow (see match): the LRU order ages a
        # chain deepest first, so eviction trims chains from the tail
        for j in reversed(range(n_blocks)):
            key = arr[:(j + 1) * self.block].tobytes()
            e = self._store.pop(key, None)
            if e is None:
                e = [self._slice(cache, j * self.block), self._block_bytes(cache)]
                self._bytes += e[1]
            self._store[key] = e
        while self._bytes > self.budget and self._store:
            oldest = next(iter(self._store))   # insertion order = LRU order
            self._bytes -= self._store.pop(oldest)[1]

    def warmup(self, sample_cache: KVCache) -> None:
        """Run a slice and a restore once against a throwaway copy of
        ``sample_cache`` (left untouched); nothing is compiled."""
        if self.block > (self.window or sample_cache.window):
            return
        frag = self._slice(sample_cache, 0)
        blank = KVCache(**{n: torch.zeros_like(t) for n, t in _fields(sample_cache)})
        self._write(blank, frag, 0)

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "tokens_reused": self.tokens_reused,
                "blocks": len(self._store), "bytes": self._bytes}


@dataclasses.dataclass
class Request:
    prompt_tokens: List[int]
    max_new_tokens: int = 128
    temperature: float = 1.0
    top_p: float = 0.95
    top_k: int = 0                   # 0 = off
    min_p: float = 0.0
    # stop sequences: generation ends when the decoded text contains one;
    # out_bytes is cut before the match, and streamed pieces are held back
    # while a stop prefix is pending
    stop: Optional[List[str]] = None
    # per-token log-softmax of the sampled tokens (the raw distribution, no
    # temperature); needs a scheduler built with logprobs=True
    logprobs: bool = False
    request_id: int = 0
    # filled by the scheduler
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    out_logprobs: List[float] = dataclasses.field(default_factory=list)
    out_bytes: bytes = b""           # stop-truncated text of out_tokens
    stop_hit: bool = False
    done: bool = False
    on_token: Optional[Callable[[int, bytes], None]] = None
    _held: bytes = b""               # streaming hold-back (stop prefix)


class BatchScheduler:
    def __init__(self, engine: Engine, batch_size: int = 4,
                 decode_block: int = 8, mesh=None,
                 prefix_cache_mb: float = 0.0, prefix_block: int = 64,
                 logprobs: bool = False, spec: Optional[str] = None,
                 spec_k: int = 4, spec_rounds: int = 3,
                 ngram_max: int = 3, idle_block: int = 0,
                 record_routes: bool = False):
        """The JAX scheduler's keywords. ``prefix_cache_mb > 0`` turns on
        block-level prompt-prefix reuse (``PrefixCache``). ``logprobs=True``
        makes the decode blocks return each sampled token's log-softmax, so
        requests with ``logprobs=True`` get ``out_logprobs``. ``spec="ngram"``
        / ``"mtp"``: speculative continuous batching. While every slot sits
        inside the window, decode blocks are replaced by fused rounds in
        which each slot drafts ``spec_k`` tokens (from its own history, or
        with the checkpoint's MTP layer from its own hidden state) and all
        slots verify together in chunks of per-row starts; lossless per
        slot (greedy slots give plain decode's tokens). After two dry
        dispatches the scheduler backs off to plain blocks with exponential
        re-probing. ``idle_block``: with nothing queued, decode blocks of
        that many steps where every live slot has that many tokens left and
        room in the window (0: off). ``record_routes=True`` keeps each
        request's routing record (``routes``); single-device plain serving
        (no mesh, no speculation). The scheduler holds a request's record
        (device slices, each a view of its decode block's record) until
        ``routes`` reads it, so the caller reads every submitted request's
        record once it has finished.

        A served row computes the bits of its sequence decoded alone up to
        ``ops/kernels/attention.py::DECODE_INVARIANT_ROWS`` (8) rows a
        decode step (a data shard's rows: those of the unsharded batch);
        rows of a larger batch (or data shard) are not bit-equal to the
        sequence alone: K3's spans and the projections' route follow the
        batch there. Verify chunks keep the bits at any batch.

        ``mesh`` (``parallel.mesh.make_mesh``, the scheduler made on every
        rank alike): the weights cut by ``shard_params``, the batch's cache
        by ``shard_cache`` (the batch over ``data``, which it must divide),
        the decode blocks and n-gram rounds over the mesh; a seq axis takes
        no speculation, and MTP serving is single-chip, as in the JAX
        package. Admissions hydrate exactly (no EP prefill capacity), as the
        JAX scheduler's single-device hydrate does.

        Spans (``utils/profiling.py::span``): ``serve.step`` (a ``step``),
        ``serve.admit`` (an admission chunk), ``serve.decode_block`` (the
        block's call up to its return), ``serve.emit`` (the tokens' read-back
        and emission) and ``serve.spec_round`` (a speculation dispatch)."""
        self.engine = engine
        self.batch = batch_size
        cfg = engine.cfg
        if record_routes and (mesh is not None or spec is not None):
            raise ValueError("the routing record is kept by single-device plain serving "
                             "(no mesh, no speculation)")
        self.record_routes = record_routes
        # request id -> (request, [(first position, (n, n_moe_layers, k) int16)])
        self._routes: Dict[int, tuple] = {}
        # a block larger than the window could never be stored
        prefix_block = min(prefix_block, max(1, cfg.kv_window // 2))
        self.ctx = NULL_CTX if mesh is None else make_ctx(cfg, mesh)
        self.prefix_cache = (PrefixCache(prefix_block, prefix_cache_mb,
                                         base=self.ctx.sidx * cfg.kv_window // self.ctx.sp,
                                         window=cfg.kv_window)
                             if prefix_cache_mb > 0 else None)
        # tokens decoded a block for the whole batch (up to block-1 positions
        # are wasted after a sequence stops)
        self.block = max(1, decode_block)
        self.idle_block = idle_block if idle_block > self.block else 0
        self.logprobs = bool(logprobs)
        if spec is not None and spec not in ("ngram", "mtp"):
            raise ValueError(f"unknown spec mode {spec!r}")
        if spec == "ngram" and mesh is not None and mesh.seq > 1:
            raise ValueError("spec serving composes with data/tensor/expert meshes; "
                             "verify mode excludes 'seq'")
        if spec == "mtp":
            if engine.params.mtp is None:
                raise ValueError("spec='mtp' needs a checkpoint with an MTP module "
                                 "(convert --mtp)")
            if mesh is not None:
                raise ValueError("spec='mtp' serving is single-chip (the MTP drafter "
                                 "runs with NULL_CTX)")
        self.spec = spec
        self.spec_k = spec_k
        self.spec_rounds = spec_rounds
        self.ngram_max = ngram_max
        self._spec_fn = None
        self._hist = None               # device (B, window) token history
        self._hist_stale = True
        self._spec_dry = 0              # consecutive dry dispatches
        self._spec_backoff = 4          # plain dispatches a dry phase
        self._spec_plain_left = 0
        self._spec_alpha_ema = None     # acceptance average (Engine.generate_ngram's
        self._spec_alpha_floor = 0.15   # floor)
        self.spec_stats = {"rounds": 0, "drafted": 0, "accepted": 0,
                           "dispatches": 0, "plain_fallbacks": 0}
        self.mesh = mesh
        self._cm = None                 # batched MTP drafter cache
        self._h = None                  # (B,1,dim) f32 last hidden a slot
        if spec == "mtp":
            from deepseek_tpu_torch.models.mtp import init_mtp_cache
            self._cm = init_mtp_cache(cfg, batch=batch_size, device=engine.device)
            self._h = torch.zeros((batch_size, 1, cfg.dim), dtype=torch.float32,
                                  device=engine.device)
        self.params = engine.params
        self._rows = slice(0, batch_size)   # the slots whose cache rows this rank holds
        if mesh is not None:
            from deepseek_tpu_torch.parallel.sharding import shard_params
            if batch_size % mesh.data:
                raise ValueError(f"batch {batch_size} does not split over the data axis "
                                 f"({mesh.data})")
            self._rows = self.ctx.data_rows(batch_size)
            self.params = shard_params(engine.params, cfg, mesh)
        # admissions hydrate exactly: the JAX scheduler's hydrate runs unsharded
        self._hctx = dataclasses.replace(self.ctx, ep_capacity_factor=0.0)
        self.cache = self._new_cache(batch_size)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.pos = np.zeros(batch_size, np.int64)      # next decode position
        self.cur = np.zeros(batch_size, np.int64)      # token to feed next
        self.queue: Deque[Request] = deque()
        self.pending: Optional[_Pending] = None
        self._ids = itertools.count()
        self._key = prng.PRNGKey(0)
        # decode blocks per block length (the live mask cuts the pair list,
        # so no occupancy bucket needs a block of its own)
        self._loops: Dict[int, object] = {}

    def _new_cache(self, batch: int) -> KVCache:
        """A fresh cache of ``batch`` rows, this rank's slice of it on a
        mesh (a one-row cache stays whole over data)."""
        cache = self.engine.new_cache(batch=batch)
        if self.mesh is None:
            return cache
        from deepseek_tpu_torch.parallel.sharding import shard_cache
        return shard_cache(cache, self.engine.cfg, self.mesh, self.params)

    def _hydrate(self, cache: KVCache, tokens, pos0: int, want_last_logits: bool = True,
                 routes: Optional[list] = None):
        """``Engine.hydrate`` over this rank's weights."""
        eng = self.engine
        return hydrate_cache(self.params, eng.cfg, cache, tokens, pos0,
                             prefill_chunk=eng.prefill_chunk,
                             want_last_logits=want_last_logits, ctx=self._hctx,
                             routes=routes)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> int:
        req.request_id = next(self._ids)
        self.queue.append(req)
        if self.record_routes:
            self._routes[req.request_id] = (req, [])
        return req.request_id

    def routes(self, request_id: int) -> np.ndarray:
        """The routing record of a finished request: (positions, n_moe_layers,
        k) int16 host array, row p the experts every MoE layer's gate chose
        for the token fed at position p (the prompt's and the fed outputs',
        so len(prompt) + len(out_tokens) - 1 rows); -1 at positions the
        prefix cache restored. One read from the device, after the fact:
        the record leaves the scheduler with it."""
        req, pieces = self._routes[request_id]
        if not req.done:
            raise ValueError(f"request {request_id} is still running")
        del self._routes[request_id]
        host = torch.cat([t for _, t in pieces]).cpu().numpy()
        out = np.full((max(p + len(t) for p, t in pieces), *host.shape[1:]), -1, np.int16)
        off = 0
        for p, t in pieces:
            out[p:p + len(t)] = host[off:off + len(t)]
            off += len(t)
        return out

    @property
    def has_work(self) -> bool:
        return (bool(self.queue) or self.pending is not None
                or any(s is not None for s in self.slots))

    # ------------------------------------------------------------------
    def _loop_for(self, block: Optional[int] = None):
        """The decode block of ``block`` steps (default ``self.block``)."""
        block = block or self.block
        if block not in self._loops:
            from deepseek_tpu_torch.models.deepseek import make_decode_loop
            self._loops[block] = make_decode_loop(
                self.engine.cfg, block, mesh=self.mesh, with_logprobs=self.logprobs,
                all_hidden=self.spec == "mtp", with_routes=self.record_routes)
        return self._loops[block]

    def _pick_block(self) -> int:
        """Idle-queue escalation: the long block only when nothing waits,
        every live slot has that many tokens left, and the whole span stays
        inside the window for every slot."""
        ib = self.idle_block
        if not ib or self.pending is not None or self.queue:
            return self.block
        window = self.engine.cfg.kv_window
        live = False
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            live = True
            if req.max_new_tokens - len(req.out_tokens) < ib:
                return self.block
            if self.pos[i] + ib > window:
                return self.block
        return ib if live else self.block

    @torch.inference_mode()
    def warmup(self) -> None:
        """Build the kernels and run every serving path once before traffic:
        the decode block of each block length, a speculation dispatch, the admission chunk modes, the slot
        merge and the prefix cache's slice and restore. Nothing is compiled
        (eager torch); the first use of each path builds its kernels
        (``ops/kernels/build.py``) and its first launches' state instead of
        a request paying for them. Safe on idle state: the decode rows go to
        dead slots, and an admission overwrites its whole batch row."""
        B, eng = self.batch, self.engine
        dev = eng.device
        key = prng.PRNGKey(0)
        tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        pos = np.zeros(B, np.int64)
        temps, topps = np.zeros(B, np.float32), np.ones(B, np.float32)
        topks, minps = np.zeros(B, np.float32), np.zeros(B, np.float32)
        act = np.zeros(B, np.bool_)
        for blk in {self.block, self.idle_block or self.block}:
            out = self._loop_for(blk)(self.params, self.cache, tok, pos, key,
                                      temps, topps, act, topks, minps)
            self.cache = out[-1]
        if (self.spec is not None
                and self.spec_rounds * (self.spec_k + 1) + 1 <= eng.cfg.kv_window):
            if self.spec == "mtp":
                out = self._get_spec_fn()(
                    self.params, self.cache, self._cm, tok,
                    torch.zeros((B, 1, eng.cfg.dim), dtype=torch.float32, device=dev),
                    pos, key, temps, topps, act, topks, minps)
                self._cm, self.cache = out[-1], out[-2]
            else:
                *_, self.cache, self._hist = self._get_spec_fn()(
                    self.params, self.cache,
                    torch.zeros((B, eng.cfg.kv_window), dtype=torch.int64, device=dev),
                    tok, pos, key, temps, topps, act, topks, minps)
                self._hist_stale = True
        # admission modes on a throwaway 1-row cache: a mid-prompt chunk
        # ("none"), a final chunk ("last"), a short tail ("all")
        C, window = eng.prefill_chunk, eng.cfg.kv_window
        sub = self._new_cache(1)
        if 2 * C <= window:
            sub, _, _, _ = self._hydrate(sub, [0] * (2 * C), 0)
        if C + 1 <= window:
            sub, _, _, _ = self._hydrate(sub, [0] * (C + 1), 0)
        self.cache = self._merge_slot(self.cache, sub, 0)
        if self.prefix_cache is not None:
            self.prefix_cache.warmup(sub)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _merge_slot(self, cache: KVCache, sub: KVCache, slot: int) -> KVCache:
        """Copy the hydrated 1-row cache into batch row ``slot`` of the
        shared cache, in place, where this rank holds that row."""
        if self._rows.start <= slot < self._rows.stop:
            merge_row(cache, sub, slot - self._rows.start)
        return cache

    def _advance_pending(self) -> None:
        """Hydrate one bounded chunk of the pending request's prompt; on
        completion, merge the rows into its slot and start decoding."""
        from deepseek_tpu_torch.models.deepseek import forward_decode

        p = self.pending
        eng = self.engine
        toks = p.req.prompt_tokens
        window = eng.cfg.kv_window
        if p.fed < window:
            r = min(eng.prefill_chunk, window - p.fed, len(toks) - p.fed)
        else:
            # past the window the hydrate takes decode steps: bound them a
            # step like a decode block
            r = min(max(1, self.block), len(toks) - p.fed)
        final = p.fed + r == len(toks)
        rec = [] if self.record_routes else None
        p.cache, logits, _, _ = self._hydrate(p.cache, toks[p.fed:p.fed + r], p.fed,
                                              want_last_logits=final, routes=rec)
        pos = p.fed
        for t in rec or ():
            self._routes[p.req.request_id][1].append((pos, t))
            pos += len(t)
        p.fed += r
        if not final:
            return
        if self.prefix_cache is not None:
            self.prefix_cache.insert(toks, p.cache)
        self._hist_stale = True          # a new slot history (spec serving)
        if self.spec == "mtp":
            # seed the MTP drafter: the hidden state of the last prompt
            # position (the final token fed again in decode mode, which
            # rewrites the same cache row) and a zeroed drafter slot
            from deepseek_tpu_torch.models.mtp import init_mtp_cache
            tok = torch.full((1, 1), int(toks[-1]), dtype=torch.int64, device=eng.device)
            _, hid = forward_decode(self.params, p.cache, tok, len(toks) - 1, eng.cfg,
                                    with_hidden=True)
            self._h[p.slot] = hid[0].float()
            self._merge_slot(self._cm, init_mtp_cache(eng.cfg, batch=1,
                                                      device=eng.device), p.slot)
        self.cache = self._merge_slot(self.cache, p.cache, p.slot)
        token = eng.sampler.sample(logits, p.req.temperature, p.req.top_p,
                                   p.req.top_k, p.req.min_p)
        if self.logprobs and p.req.logprobs:
            # the raw log-softmax of the sampled token, as the decode
            # block's logprobs
            import math
            prob = eng.sampler.sample_prob(token, logits)
            p.req.out_logprobs.append(math.log(max(prob, 1e-45)))
        self._emit(p.req, token, prev=toks[-1])
        self.slots[p.slot] = p.req
        self.pos[p.slot] = len(toks)
        self.cur[p.slot] = token
        self.pending = None

    def _emit(self, req: Request, token: int, prev: int) -> None:
        req.out_tokens.append(token)
        piece = self.engine.tokenizer.decode_one(prev, token)
        if not req.stop:
            req.out_bytes += piece
            if req.on_token is not None:
                req.on_token(token, piece)
        else:
            buf = req._held + piece
            stops = [x.encode() for x in req.stop]
            hits = [buf.find(b) for b in stops if buf.find(b) >= 0]
            if hits:
                flush = buf[:min(hits)]
                req.out_bytes += flush
                req._held = b""
                if req.on_token is not None and flush:
                    req.on_token(token, flush)
                req.stop_hit = True
                req.done = True
                return
            # hold back the longest suffix of buf that is a proper prefix
            # of a stop string: it may complete on a later token
            hold = 0
            for b in stops:
                for L in range(min(len(b) - 1, len(buf)), hold, -1):
                    if buf.endswith(b[:L]):
                        hold = L
                        break
            flush, req._held = buf[:len(buf) - hold], buf[len(buf) - hold:]
            req.out_bytes += flush
            if req.on_token is not None and flush:
                req.on_token(token, flush)
        if (self.engine.tokenizer.is_eos_or_eot(token)
                or len(req.out_tokens) >= req.max_new_tokens):
            req.done = True
            if req._held:                    # no stop hit: flush the tail
                req.out_bytes += req._held
                if req.on_token is not None:
                    req.on_token(token, req._held)
                req._held = b""

    def _free_finished(self) -> None:
        for i, req in enumerate(self.slots):
            if req is not None and req.done:
                self.slots[i] = None
                self.pos[i] = 0
                self.cur[i] = 0

    # ------------------------------------------------------------------
    def _get_spec_fn(self):
        """The fused batched speculation rounds (made once)."""
        if self._spec_fn is None:
            eng = self.engine
            if self.spec == "mtp":
                from deepseek_tpu_torch.speculative import make_batched_mtp_spec_rounds
                self._spec_fn = make_batched_mtp_spec_rounds(
                    eng.cfg, self.spec_k, self.spec_rounds, with_logprobs=self.logprobs)
            else:
                from deepseek_tpu_torch.speculative import make_batched_ngram_spec_rounds
                self._spec_fn = make_batched_ngram_spec_rounds(
                    eng.cfg, self.spec_k, self.spec_rounds, hist_len=eng.cfg.kv_window,
                    ngram_max=self.ngram_max, with_logprobs=self.logprobs, mesh=self.mesh)
        return self._spec_fn

    def _spec_ready(self) -> bool:
        """Speculate this step? Spec serving is on, every slot stays strictly
        inside the window for the whole fused span (verify mode's
        precondition), and no dry-spell backoff is running."""
        if self.spec is None:
            return False
        span = self.spec_rounds * (self.spec_k + 1)
        window = self.engine.cfg.kv_window
        for i, req in enumerate(self.slots):
            if req is not None and self.pos[i] + span + 1 > window:
                return False
        if self._spec_plain_left > 0:
            self._spec_plain_left -= 1
            self.spec_stats["plain_fallbacks"] += 1
            if self._spec_plain_left == 0:
                self._spec_alpha_ema = None   # a fresh probe measures again
            return False
        return True

    def _spec_step(self, temps, topps, topks, minps, act) -> None:
        """One fused speculation dispatch in place of a decode block: every
        live slot drafts, all verify together, and each advances by its own
        accepted count (pos/cur follow the rounds the dispatch ran, also
        after a slot finished inside it)."""
        eng = self.engine
        dev = eng.device
        H = eng.cfg.kv_window
        R, K = self.spec_rounds, self.spec_k
        if self.spec == "ngram" and (self._hist_stale or self._hist is None):
            # rebuilt from the host's record: live slots hold pos+1 <= window
            hist = np.zeros((self.batch, H), np.int64)
            for i, req in enumerate(self.slots):
                if req is not None:
                    seq = req.prompt_tokens + req.out_tokens
                    hist[i, :len(seq)] = seq
            self._hist = torch.from_numpy(hist).to(dev)
            self._hist_stale = False
        self._key, sub = prng.split(self._key)
        cur = torch.from_numpy(self.cur.reshape(-1, 1).copy()).to(dev)
        if self.spec == "mtp":
            out = self._get_spec_fn()(self.params, self.cache, self._cm, cur, self._h,
                                      self.pos, sub, temps, topps, act, topks, minps)
            drafts_r, nacc_r, next_r = out[:3]
            lps_r = out[3] if self.logprobs else None
            self._h, self.cache, self._cm = out[-3:]
        else:
            out = self._get_spec_fn()(self.params, self.cache, self._hist, cur,
                                      self.pos, sub, temps, topps, act, topks, minps)
            drafts_r, nacc_r, next_r = out[:3]
            lps_r = out[4] if self.logprobs else None
            self.cache, self._hist = out[-2:]
        drafts = drafts_r.cpu().numpy()                   # (R, B, k)
        nacc = nacc_r.cpu().numpy()                       # (R, B)
        nxt = next_r.cpu().numpy()                        # (R, B)
        lps = lps_r.cpu().numpy() if lps_r is not None else None   # (R, B, k+1)
        self.spec_stats["dispatches"] += 1
        # the slots this dispatch served, counted before any finishes in it
        n_live = int(np.sum(act))
        accepted_this = 0
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            prev = int(self.cur[i])
            adv = 0
            for r in range(R):
                na = int(nacc[r, i])
                adv += na + 1
                if req.done:
                    continue             # the device went on; follow pos only
                self.spec_stats["rounds"] += 1
                self.spec_stats["drafted"] += K
                self.spec_stats["accepted"] += na
                accepted_this += na
                want_lp = lps is not None and req.logprobs
                for j, d in enumerate(drafts[r, i, :na]):
                    if want_lp:
                        req.out_logprobs.append(float(lps[r, i, j]))
                    self._emit(req, int(d), prev=prev)
                    prev = int(d)
                    if req.done:
                        break
                if not req.done:
                    t = int(nxt[r, i])
                    if want_lp:
                        req.out_logprobs.append(float(lps[r, i, na]))
                    self._emit(req, t, prev=prev)
                    prev = t
            self.pos[i] += adv
            self.cur[i] = int(nxt[R - 1, i])
        disp_alpha = accepted_this / max(1, R * K * n_live)
        self._spec_alpha_ema = disp_alpha if self._spec_alpha_ema is None \
            else 0.6 * self._spec_alpha_ema + 0.4 * disp_alpha
        if accepted_this == 0 or self._spec_alpha_ema < self._spec_alpha_floor:
            self._spec_dry += 1
            if self._spec_dry >= 2:
                # dry spell: plain blocks with exponential re-probing (one
                # more all-miss dispatch enters the dry phase again)
                self._spec_plain_left = self._spec_backoff
                self._spec_backoff = min(self._spec_backoff * 2, 64)
                self._spec_dry = 1
        else:
            self._spec_dry = 0
            self._spec_backoff = 4

    def _refeed_drafter(self, toks: torch.Tensor, hid: torch.Tensor,
                        pos0: np.ndarray) -> None:
        """After a plain block in MTP serving: the MTP pairs (token fed at
        p+1, hidden at p) of the block's positions into the drafter cache,
        at each slot's positions (the MTP verify mode). A slot whose block
        ends past the window writes at 0 instead: it never drafts again
        (speculation needs every slot inside the window), and an admission
        zeroes its drafter rows."""
        from deepseek_tpu_torch.models.mtp import mtp_forward

        T = toks.shape[1]
        window = self.engine.cfg.kv_window
        if T > window:
            return
        start = np.where(pos0 + T <= window, pos0, 0)
        mtp_forward(self.params, self._cm, toks, hid, start, self.engine.cfg, prefill=True)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> None:
        """One bounded admission chunk (if an admission is in flight or can
        start), then one decode block of ``block`` tokens for the whole
        batch; sampling stays on the device with per-slot parameters, and
        only the (B, block) token ids come back."""
        with span("serve.step"):
            self._step()

    def _step(self) -> None:
        self._free_finished()
        if self.pending is None and self.queue:
            free = next((i for i in range(self.batch) if self.slots[i] is None), None)
            if free is not None:
                p = _Pending(self.queue.popleft(), free, self._new_cache(1))
                if self.prefix_cache is not None:
                    reused, frags = self.prefix_cache.match(p.req.prompt_tokens)
                    if reused:
                        p.cache = self.prefix_cache.restore(p.cache, frags)
                        p.fed = reused
                self.pending = p
        if self.pending is not None:
            with span("serve.admit"):
                self._advance_pending()
        if not any(s is not None for s in self.slots):
            return

        temps = np.zeros(self.batch, np.float32)
        topps = np.ones(self.batch, np.float32)
        topks = np.zeros(self.batch, np.float32)
        minps = np.zeros(self.batch, np.float32)
        act = np.zeros(self.batch, np.bool_)
        for i, req in enumerate(self.slots):
            if req is not None:
                temps[i] = req.temperature
                topps[i] = req.top_p
                topks[i] = req.top_k
                minps[i] = req.min_p
                act[i] = not req.done
        if self._spec_ready():
            with span("serve.spec_round"):
                return self._spec_step(temps, topps, topks, minps, act)
        if self.spec is not None:
            # plain blocks append tokens outside the rounds
            self._hist_stale = True

        blk = self._pick_block()
        self._key, sub = prng.split(self._key)
        pos0 = self.pos.copy()
        cur = torch.from_numpy(self.cur.reshape(-1, 1).copy()).to(self.engine.device)
        with span("serve.decode_block"):
            out = self._loop_for(blk)(self.params, self.cache, cur, pos0, sub,
                                      temps, topps, act, topks, minps)
        self.cache = out[-1]
        toks_dev = out[0]
        if self.spec == "mtp":
            hid = out[-2]                                       # (B, block, dim)
            self._h = hid[:, -1:].contiguous()
            self._refeed_drafter(toks_dev, hid, pos0)
        with span("serve.emit"):
            lps = out[2].cpu().numpy() if self.logprobs else None   # (B, block)
            toks = toks_dev.cpu().numpy()                           # (B, block)
            self._emit_block(toks, lps, blk, pos0, out[-2] if self.record_routes else None)

    def _emit_block(self, toks, lps, blk: int, pos0, routes) -> None:
        """Emit a decode block's tokens; with the block's routing record,
        keep each live request's rows up to its last token."""
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                # idle slots keep pos 0: their rows route to no expert and
                # attend over one slot
                continue
            prev = int(self.cur[i])
            for j in range(blk):
                token = int(toks[i, j])
                if req.logprobs and lps is not None:
                    req.out_logprobs.append(float(lps[i, j]))
                self._emit(req, token, prev=prev)
                prev = token
                if req.done:
                    break
            if routes is not None:
                self._routes[req.request_id][1].append((int(pos0[i]), routes[i, :j + 1]))
            self.pos[i] += blk
            self.cur[i] = prev

    def run(self) -> List[Request]:
        finished: Dict[int, Request] = {}
        while self.has_work:
            self.step()
            for req in self.slots:
                if req is not None and req.done:
                    finished[req.request_id] = req
        return [finished[k] for k in sorted(finished)]
