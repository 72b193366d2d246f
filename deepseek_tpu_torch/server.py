"""HTTP serving daemon on top of the continuous-batching scheduler: the
port of ``deepseek_tpu/server.py``.

Stdlib only: a ThreadingHTTPServer accepts requests, one scheduler thread
owns every torch call (the device is driven from one thread) and runs
continuous-batching steps, and the handler threads exchange work with it
through thread-safe queues.

Endpoints:
  GET  /health          -> {"status": "ok", model info}
  POST /v1/chat/completions -> {"messages": [{"role", "content"}...], ...}
                           (renders the checkpoint's chat template)
  POST /v1/completions  -> {"prompt", "max_tokens", "temperature", "top_p",
                           "top_k", "min_p", "stop" (string | [string]),
                            "logprobs" (bool: per-token log-softmax of the
                            sampled tokens, aligned with "tokens"),
                            "stream"} ; non-stream returns the full JSON,
                            stream=true returns server-sent events, one
                            ``data: {"text": ...}`` line per token, ending
                            with ``data: [DONE]``.

Run: ``python -m deepseek_tpu_torch <ckpt_dir> -m serve [--port 8080]`` or
``Server(engine).serve_forever()``.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.serving import BatchScheduler, Request


_STREAM_END = object()


class _Pending:
    """Bridges one HTTP request to the scheduler thread."""

    def __init__(self, req: Request, stream: bool):
        self.req = req
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.tokens: "queue.Queue" = queue.Queue()
        if stream:
            req.on_token = lambda tok, piece: self.tokens.put(piece)


class Server:
    def __init__(self, engine: Engine, batch_size: int = 4,
                 warmup: bool = True, prefix_cache_mb: float = 64.0,
                 spec: Optional[str] = None, spec_k: int = 4,
                 spec_rounds: int = 3, idle_block: int = 0):
        """``warmup`` builds the kernels and runs every serving path once
        (``BatchScheduler.warmup``) before the first request, so that no
        request pays for a build; ``-m serve --no-warmup`` skips it.

        ``prefix_cache_mb``: device memory budget for block-level prompt-
        prefix KV reuse across requests (shared system prompts skip their
        prefill again); 0 disables (``-m serve --prefix-cache 0``).

        ``spec="ngram"`` (``-m serve --serve-spec``): speculative
        continuous batching — fused prompt-lookup rounds across the whole
        batch while every slot is in-window, plain decode otherwise
        (BatchScheduler docstring). ``spec="mtp"`` (``--serve-spec mtp``)
        drafts with the checkpoint's MTP module instead (requires
        ``convert --mtp`` weights). Both lossless; both compose with the
        per-request "logprobs" field (accepted tokens' log-softmax values
        ride the verify chunks).

        ``idle_block`` keeps the JAX scheduler's idle-queue escalation
        (``BatchScheduler.idle_block``), off by default here: eager torch
        dispatches every step from the host anyway, so a longer block saves
        no dispatch, while a request that arrives just after a long block
        starts waits for all of it before its admission (time to first
        token)."""
        self.engine = engine
        self._warmup = warmup
        self._prefix_mb = prefix_cache_mb
        self._spec_kw = dict(spec=spec, spec_k=spec_k,
                             spec_rounds=spec_rounds)
        # logprobs=True so that per-request "logprobs" needs no second
        # scheduler: one gather a step on the device (and from the verify
        # chunks' log-softmax in spec rounds)
        self._idle_block = idle_block
        self.scheduler = BatchScheduler(engine, batch_size=batch_size,
                                        prefix_cache_mb=prefix_cache_mb,
                                        logprobs=True,
                                        idle_block=idle_block,
                                        **self._spec_kw)
        if warmup:
            import time
            t0 = time.perf_counter()
            self.scheduler.warmup()
            print(f"serving warmup: kernels built, decode blocks and admission "
                  f"modes run in {time.perf_counter()-t0:.1f}s", flush=True)
        self.inbox: "queue.Queue[_Pending]" = queue.Queue()
        self._pending: list[_Pending] = []
        self._shutdown = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---------------------------------------------------------------- loop
    def _run(self) -> None:
        """Scheduler thread: the only thread that calls torch."""
        while not self._shutdown.is_set():
            try:
                idle = not self.scheduler.has_work
                try:
                    p = self.inbox.get(timeout=0.05 if idle else 0.0)
                    while True:
                        self.scheduler.submit(p.req)
                        self._pending.append(p)
                        p = self.inbox.get_nowait()
                except queue.Empty:
                    pass
                if self.scheduler.has_work:
                    self.scheduler.step()
            except Exception:
                # a step failure (OOM, device error) must not zombify the
                # daemon: fail every in-flight request and rebuild the
                # scheduler so later requests get a clean batch state
                import traceback
                traceback.print_exc()
                for p in self._pending:
                    p.req.done = True
                    p.error = "internal error during generation"
                self.scheduler = BatchScheduler(
                    self.engine, batch_size=self.scheduler.batch,
                    prefix_cache_mb=self._prefix_mb,
                    logprobs=True,
                    idle_block=self._idle_block,
                    **self._spec_kw)
                if self._warmup:
                    try:
                        self.scheduler.warmup()
                    except Exception:
                        traceback.print_exc()
            still = []
            for p in self._pending:
                if p.req.done:
                    p.tokens.put(_STREAM_END)
                    p.done.set()
                else:
                    still.append(p)
            self._pending = still

    def shutdown(self) -> None:
        self._shutdown.set()
        self._thread.join(timeout=5)

    # ----------------------------------------------------------------- api
    def submit(self, prompt: str, max_tokens: int = 128,
               temperature: float = 1.0, top_p: float = 0.95,
               stream: bool = False, top_k: int = 0, min_p: float = 0.0,
               stop=None, bos: bool = True,
               logprobs: bool = False) -> _Pending:
        """``bos=False`` for chat-template prompts — rendered templates
        embed the BOS token literally (HF add_special_tokens=False
        convention), so the tokenizer must not prepend another."""
        toks = self.engine.tokenizer.encode(prompt, bos=bos)
        req = Request(prompt_tokens=toks, max_new_tokens=max_tokens,
                      temperature=temperature, top_p=top_p,
                      top_k=top_k, min_p=min_p, stop=stop,
                      logprobs=logprobs)
        p = _Pending(req, stream)
        self.inbox.put(p)
        return p

    def make_http_server(self, host: str = "127.0.0.1", port: int = 8080
                         ) -> ThreadingHTTPServer:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/health":
                    return self._json(404, {"error": "not found"})
                cfg = server.engine.cfg
                info = {
                    "status": "ok", "arch": cfg.arch,
                    "n_layers": cfg.n_layers, "dim": cfg.dim,
                    "quant": cfg.weight_quant.value,
                    "max_seq_len": cfg.max_seq_len,
                }
                pc = server.scheduler.prefix_cache
                if pc is not None:
                    info["prefix_cache"] = pc.stats
                if server.scheduler.spec is not None:
                    info["spec"] = dict(server.scheduler.spec_stats)
                self._json(200, info)

            def do_POST(self):
                if self.path not in ("/v1/completions",
                                     "/v1/chat/completions"):
                    return self._json(404, {"error": "not found"})
                chat = self.path == "/v1/chat/completions"
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if chat:
                        from deepseek_tpu_torch.chat import ChatTemplateError
                        try:
                            prompt = server.engine.render_chat(
                                body["messages"])
                        except ChatTemplateError as e:
                            return self._json(400, {"error": str(e)})
                    else:
                        prompt = body["prompt"]
                except (KeyError, ValueError) as e:
                    return self._json(400, {"error": f"bad request: {e}"})
                stream = bool(body.get("stream", False))
                stop = body.get("stop")
                if isinstance(stop, str):
                    stop = [stop]
                if stop is not None and not (
                        isinstance(stop, list)
                        and all(isinstance(x, str) and x for x in stop)):
                    return self._json(
                        400, {"error": "stop must be a non-empty string "
                                       "or a list of them"})
                want_lp = bool(body.get("logprobs", False))
                p = server.submit(
                    prompt,
                    max_tokens=int(body.get("max_tokens", 128)),
                    temperature=float(body.get("temperature", 1.0)),
                    top_p=float(body.get("top_p", 0.95)),
                    top_k=int(body.get("top_k", 0)),
                    min_p=float(body.get("min_p", 0.0)),
                    stop=stop,
                    stream=stream,
                    bos=not chat,
                    logprobs=want_lp)
                if not stream:
                    p.done.wait()
                    if p.error:
                        return self._json(500, {"error": p.error})
                    # out_bytes is the canonical (stop-truncated) text;
                    # identical to decode(out_tokens) when no stop is set
                    text = p.req.out_bytes.decode("utf-8", errors="replace")
                    fin = "stop" if p.req.stop_hit else "length"
                    resp = {
                        "tokens": p.req.out_tokens,
                        "prompt_tokens": len(p.req.prompt_tokens),
                        "completion_tokens": len(p.req.out_tokens),
                        "finish_reason": fin,
                    }
                    if want_lp:
                        resp["logprobs"] = p.req.out_logprobs
                    if chat:
                        resp["message"] = {"role": "assistant",
                                           "content": text}
                    else:
                        resp["text"] = text
                    return self._json(200, resp)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                # token pieces are raw bytes; multi-byte UTF-8 characters can
                # span byte-fallback tokens, so decode incrementally
                import codecs
                dec = codecs.getincrementaldecoder("utf-8")("replace")
                while True:
                    piece = p.tokens.get()
                    final = piece is _STREAM_END
                    text = dec.decode(b"" if final else piece, final)
                    if text:
                        data = json.dumps({"text": text})
                        self.wfile.write(f"data: {data}\n\n".encode())
                        self.wfile.flush()
                    if final:
                        break
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()

        return ThreadingHTTPServer((host, port), Handler)

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8080) -> None:
        httpd = self.make_http_server(host, port)
        print(f"serving on http://{host}:{port}  "
              f"(POST /v1/completions, GET /health)", flush=True)
        try:
            httpd.serve_forever()
        finally:
            self.shutdown()
