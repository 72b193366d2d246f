"""CLI workloads: completion | perplexity | passkey | chat | interactive | serve.

The port of ``deepseek_tpu/cli.py``, with the same flags and defaults (the
reference's surface, main.cpp:18-43, and the JAX CLI's long options):

    python -m deepseek_tpu_torch <checkpoint_dir> [options]
      -h            help
      -L            lock/eagerly materialize weights
      -m <mode>     completion|perplexity|passkey|interactive|chat|serve
                    (default completion)
      -T <int>      sliding window context length (0 = max)
    completion: -i <str> | -f <path>, -t <float>, -p <float>, -n <int>,
                --draft <ckpt> | --mtp-spec | --ngram-spec, --spec-k <int>
    perplexity: -i <str> | -f <path> | -w (embedded wikitext fixture)
    passkey:    -n <int> junk lines, -l <int> passkey position (-1 random)
    serve:      --port, --host, --batch, --no-warmup, --prefix-cache <MB>,
                --serve-spec [ngram|mtp], --spec-k (``server.py``: HTTP over
                the continuous-batching scheduler)

The model runs on the card (``--device cuda``, the default) or, with
``--device cpu``, through the kernels' plain versions. The defaults are
the JAX CLI's: the packed K-quant runtime, ``--block 32``, ``--chunk
256`` and a time-based seed when ``--seed`` is absent.
"""

from __future__ import annotations

import os
import random
import shlex
import sys
import time
from typing import List, Optional

import numpy as np

from deepseek_tpu_torch.engine import Engine

USAGE = """Usage:   python -m deepseek_tpu_torch <checkpoint_dir> [options]
Example: python -m deepseek_tpu_torch model_weights_dir/ -i "Q: What is the meaning of life?"
Options:
  -h Display this help message
  -L Locks model weights to RAM (eagerly materializes mmaps)
  -m [completion,passkey,perplexity,interactive,chat,serve] which mode to run in (default - completion)
  -T <int> sliding window context length (0 - max)

Perplexity mode options:
  Choose one:
    -i <string> input prompt
    -f <filepath> input file with prompt
    -w use embedded wikitext fixture as input
Completion mode options:
  -n <int>    number of steps to run for in completion mode, default 256. 0 = max_seq_len, -1 = infinite
  -t <float> temperature (default - 1.0)
  -p <float> p for top-p sampling (default - 0.95)
  --top-k <int> keep only the k most probable tokens (default 0 = off)
  --min-p <float> drop tokens below min_p * max probability (default 0 = off)
  Choose one:
    -i <string> input prompt
    -f <filepath> input file with prompt
Passkey mode options:
  -n <int>    number of junk lines to insert (default - 250)
  -l <int>    passkey position (-1 - random)
Options of the port:
  --device <cuda|cpu>         where the model runs (default cuda: the H100's
                              kernels; cpu runs their plain versions)
  --dtype <float32|bfloat16>  activation compute dtype
  --kv-dtype <float16|bfloat16|int8>  KV cache dtype (int8 = half the cache
                              bytes, per-row amax scales)
  --draft <ckpt_dir>          speculative decoding draft model (completion
                              mode; output is exactly the target model's)
  --mtp-spec                  self-speculative decoding with the checkpoint's
                              own MTP module (DeepSeek-V3 extra layer)
  --ngram-spec                prompt-lookup speculation: draft-free n-gram
                              match against the sequence's own history
  --spec-k <int>              draft tokens per speculation round (default 4)
  --no-scan-layers            keep the layer stack unrolled (default: deep
                              models run homogeneous layers as one lax.scan
                              — constant program size, faster compiles)
  --kquant-turbo              expand K-quant weights to pre-scaled int8
                              planes at load: ~2x faster decode for ~3x
                              the packed weight memory (still < bf16)
  --kquant-nibble             expand K-quant weights to 4-bit nibble
                              planes at load: fastest K-quant decode
                              (~2x packed) at 5-6 bits/weight — deep
                              models that don't fit the turbo layout
  --chunk <int>               prefill chunk size (default 256)
  --block N                   decode tokens per fused dispatch (default 32;
                              128 measured +4% single-stream at V3 scale)
  --seed <int>                sampler seed
  --yarn                      apply YaRN rope scaling (reference parses but
                              never applies it; opt-in quality improvement)
Serve mode (-m serve) options:
  --port <int>                HTTP port (default 8080)
  --host <str>                bind address (default 127.0.0.1)
  --batch <int>               continuous-batching slots (default 4)
  --no-warmup                 skip startup precompile of serving shapes
  --prefix-cache <MB>         HBM budget for prompt-prefix KV reuse across
                              requests (default 64; 0 disables)
  --serve-spec [ngram|mtp]    speculative continuous batching: fused prompt-
                              lookup rounds across the whole batch (lossless;
                              backs off to plain decode on novel text)
"""



def _die(msg: str = ""):
    if msg:
        print(f"Error: {msg}", file=sys.stderr)
    print(USAGE, file=sys.stderr)
    raise SystemExit(1)


class Args:
    def __init__(self):
        self.mode = "completion"
        self.checkpoint = None
        self.lock = False
        self.context = 0
        self.prompt: Optional[str] = None
        self.prompt_path: Optional[str] = None
        self.use_wikitext = False
        self.num_steps: Optional[int] = None
        self.temperature = 1.0
        self.top_p = 0.95
        self.top_k = 0
        self.min_p = 0.0
        self.n_junk = 250
        self.passkey_pos = -1
        self.dtype: Optional[str] = None
        self.kv_dtype: Optional[str] = None
        self.kquant_turbo = False
        self.kquant_nibble = False
        self.scan_layers = "auto"
        self.chunk = 256
        self.seed: Optional[int] = None
        self.yarn = False
        self.draft: Optional[str] = None
        self.mtp_spec = False
        self.ngram_spec = False
        self.spec_k = 4
        self.port = 8080
        self.host = "127.0.0.1"
        self.batch = 4
        self.warmup = True
        self.prefix_cache_mb = 64.0
        self.serve_spec = None
        self.block = 32          # decode tokens per fused dispatch
        self.device = "cuda"


def parse_mode_flags(args: Args, argv: List[str]) -> Args:
    """Per-mode flags (reference arg structs, main.cpp:85-255)."""
    i = 0

    def val():
        nonlocal i
        if i + 1 >= len(argv):
            _die(f"flag {argv[i]} needs a value")
        i += 1
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a == "-h":
            _die()
        elif a == "-i":
            args.prompt = val()
        elif a == "-f":
            args.prompt_path = val()
        elif a == "-t":
            args.temperature = float(val())
        elif a == "-p":
            args.top_p = float(val())
        elif a == "--top-k":
            args.top_k = int(val())
        elif a == "--min-p":
            args.min_p = float(val())
        elif a == "-n":
            v = int(val())
            if args.mode == "passkey":
                args.n_junk = v
            else:
                args.num_steps = v
        elif a == "-l":
            args.passkey_pos = int(val())
        elif a == "-w":
            args.use_wikitext = True
        elif a == "--dtype":
            args.dtype = val()
        elif a == "--kv-dtype":
            args.kv_dtype = val()
        elif a == "--kquant-turbo":
            args.kquant_turbo = True
        elif a == "--kquant-nibble":
            args.kquant_nibble = True
        elif a == "--no-scan-layers":
            args.scan_layers = False
        elif a == "--chunk":
            args.chunk = int(val())
        elif a == "--block":
            args.block = int(val())
        elif a == "--seed":
            args.seed = int(val())
        elif a == "--yarn":
            args.yarn = True
        elif a == "--draft":
            args.draft = val()
        elif a == "--mtp-spec":
            args.mtp_spec = True
        elif a == "--ngram-spec":
            args.ngram_spec = True
        elif a == "--spec-k":
            args.spec_k = int(val())
        elif a == "--port":
            args.port = int(val())
        elif a == "--host":
            args.host = val()
        elif a == "--batch":
            args.batch = int(val())
        elif a == "--no-warmup":
            args.warmup = False
        elif a == "--prefix-cache":
            args.prefix_cache_mb = float(val())
        elif a == "--serve-spec":
            # optional mode operand: ngram (default) | mtp
            if i + 1 < len(argv) and argv[i + 1] in ("ngram", "mtp"):
                i += 1
                args.serve_spec = argv[i]
            else:
                args.serve_spec = "ngram"
        else:
            _die(f"unknown flag {a}")
        i += 1
    return args


def resolve_prompt(args: Args, need: bool = True) -> Optional[str]:
    sources = sum([args.prompt is not None, args.prompt_path is not None,
                   args.use_wikitext])
    if args.mode == "perplexity":
        if sources != 1:
            _die("must provide exactly one of -i, -f, -w")
    elif need and sources != 1:
        _die("must provide exactly one of -i, -f")
    if args.prompt_path:
        with open(args.prompt_path) as f:
            return f.read()
    return args.prompt


def wikitext_tokens(engine: Engine) -> List[int]:
    """Embedded pre-tokenized wikitext fixture, selected by arch
    (main.cpp:363-369,672-678). Data provenance: the reference repo's
    wikitest.cat.1chunk.{v2,v3}-encoded fixtures."""
    name = "v3" if engine.cfg.arch == "DeepseekV3ForCausalLM" else "v2"
    path = os.path.join(os.path.dirname(__file__), "fixtures", f"wikitext_{name}.npy")
    return np.load(path).tolist()


def run_completion(engine: Engine, args: Args):
    prompt = resolve_prompt(args)
    t0 = time.perf_counter()
    encoding = engine.tokenizer.encode(prompt, bos=True)
    enc_s = max(time.perf_counter() - t0, 1e-9)
    print(engine.tokenizer.encoding_to_debug_string(encoding))
    print(f"Encoding stats: ({len(encoding)} tokens, throughput: "
          f"{len(encoding)/enc_s:.5g}tok/s, latency: {enc_s/len(encoding):.5g}s/tok, "
          f"total: {enc_s:.5g}s)\n")
    print(f"Model active bytes per token: {engine.active_bytes(0):.0f}")
    print(f"Model bits per weight: {engine.bits_per_weight():.4g}")

    def emit(token, piece: bytes):
        sys.stdout.write(piece.decode("utf-8", errors="replace"))
        sys.stdout.flush()

    steps = 256 if args.num_steps is None else args.num_steps
    if args.mtp_spec:
        out, st = engine.generate_mtp(
            encoding, steps, temperature=args.temperature,
            top_p=args.top_p, spec_k=args.spec_k, on_token=emit)
    elif args.ngram_spec:
        out, st = engine.generate_ngram(
            encoding, steps, temperature=args.temperature,
            top_p=args.top_p, spec_k=args.spec_k, on_token=emit)
    elif args.draft:
        # forward the session flags so the draft runs under the same compute
        # dtype / KV dtype / context / YaRN regime as the target (a
        # default-built draft would silently run full-window f32)
        draft_engine = Engine(args.draft,
                              context=args.context,
                              compute_dtype=args.dtype,
                              kv_cache_dtype=args.kv_dtype,
                              use_yarn=args.yarn,
                              seed=args.seed if args.seed is not None else 0,
                              prefill_chunk=args.chunk,
                              device=engine.device)
        out, st = engine.generate_speculative(
            encoding, draft_engine, steps, temperature=args.temperature,
            top_p=args.top_p, spec_k=args.spec_k, on_token=emit)
    else:
        out, st = engine.generate(
            encoding, steps, temperature=args.temperature, top_p=args.top_p,
            top_k=args.top_k, min_p=args.min_p, on_token=emit)
    print()
    spec = (f"  speculative: {st.spec_accepted}/{st.spec_drafted} drafts "
            f"accepted over {st.spec_rounds} rounds "
            f"({100*st.acceptance_rate:.0f}%)\n") if st.spec_rounds else ""
    print(f"Generation stats:\n"
          f"{spec}"
          f"  {st.generated_tokens} tokens\n"
          f"  throughput: {st.tok_per_s:.5g} tok/s\n"
          f"  latency: {st.generate_s/max(st.generated_tokens,1):.5g} s/tok\n"
          f"  hydrate: {st.hydrate_s:.5g} s\n"
          f"  bandwidth: {st.gb_per_s:.5g} GB/s\n"
          f"  total: {st.hydrate_s + st.generate_s:.5g} s")
    from deepseek_tpu_torch.utils.profiling import dump_profile, profiling_enabled
    if profiling_enabled():
        # end-of-completion profile dump (DSEEK_PROFILE=1; main.cpp:355-360)
        print(dump_profile())


def run_perplexity(engine: Engine, args: Args):
    prompt = resolve_prompt(args)  # validates exactly one of -i/-f/-w
    if args.use_wikitext:
        tokens = wikitext_tokens(engine)
        tokens = tokens[:engine.cfg.max_seq_len]
    else:
        tokens = engine.tokenizer.encode(prompt, bos=True)
    if len(tokens) < 2:
        _die("need at least 2 tokens for perplexity")

    def prog(i, n):
        print(f"\rComputing perplexity...{i}/{n}", end="", flush=True)

    t0 = time.perf_counter()
    ppl, err, n = engine.perplexity(tokens, progress=prog)
    dt = time.perf_counter() - t0
    print()
    print(f"Stats:\n  {n + 1} tokens\n  perplexity: {ppl:.5g} ± {err:.5g}\n"
          f"  throughput: {(n + 1)/dt:.5g} tok/s\n  total: {dt:.5g} s")


def run_passkey(engine: Engine, args: Args):
    """Long-context retrieval eval over the ring+sink cache
    (run_passkey, main.cpp:433-512)."""
    prefix = ("There is an important info hidden inside a lot of irrelevant "
              "text. Find it and memorize them. I will quiz you about the "
              "important information there.")
    suffix = " What is the pass key? The pass key is"
    junk = (" The grass is green. The sky is blue. The sun is yellow. "
            "Here we go. There and back again.")

    passkey = random.randint(1, 50000)
    pos = args.passkey_pos if args.passkey_pos != -1 else random.randrange(args.n_junk)
    if not (0 <= pos < args.n_junk):
        _die(f"passkey position must be between 0 and {args.n_junk - 1}")

    parts = [prefix]
    for i in range(args.n_junk):
        if i == pos:
            parts.append(f" The pass key is {passkey}. Remember it. "
                         f"{passkey} is the pass key.")
        parts.append(junk)
    parts.append(suffix)
    prompt = "".join(parts)

    encoding = engine.tokenizer.encode(prompt, bos=True)
    print(f"Passkey test:\n  prompt: {len(encoding)} tokens\n  passkey: {passkey}\n"
          f"  passkey token index: ~{int(pos / args.n_junk * len(encoding))}\n")

    cache = engine.new_cache()

    def prog(i, n):
        print(f"\r Running passkey test...{i}/{n}", end="", flush=True)

    cache, logits, _, p = engine.hydrate(cache, encoding, 0, progress=prog)
    print()
    print(suffix, end="", flush=True)
    prev = encoding[-1]
    for _ in range(16):
        token = engine.sampler.sample(logits, 1.0, 0.95)
        sys.stdout.write(
            engine.tokenizer.decode_one(prev, token).decode("utf-8", errors="replace"))
        sys.stdout.flush()
        prev = token
        if engine.tokenizer.is_eos_or_eot(token):
            break
        logits = engine.step(cache, token, p)[0].float().cpu().numpy()
        p += 1
    print()


INTERACTIVE_USAGE = """Usage:   <mode> [options]
Example: c -i "Q: What is the meaning of life?"
Modes:
  h Display this help message
  c Completion - complete a single prompt
  p Perplexity - compute perplexity of a single prompt
  k Passkey - test passkey extraction
  q Quit
(flags as in the main CLI)
"""


def run_chat(engine: Engine, args: Args):
    """Multi-turn chat REPL over the checkpoint's embedded chat template
    (deepseek_tpu_torch.chat; the converter stores tokenizer_config.json's
    chat_template in the .dseek metadata). Each turn re-renders the whole
    conversation and hydrates it — chunked prefill makes the re-hydrate
    cheap, and the template, not the CLI, decides the turn format. The
    reference has no chat surface (its interactive mode feeds raw
    completion prompts, main.cpp:514-592)."""
    from deepseek_tpu_torch.chat import ChatTemplateError
    if engine.chat_template is None:
        _die("this checkpoint has no chat_template metadata — re-convert "
             "from an HF dir whose tokenizer_config.json carries one")
    messages = []
    print("chat mode: empty line or 'q' quits", file=sys.stderr)
    while True:
        try:
            line = input("user> ").strip()
        except EOFError:
            break
        if not line or line == "q":
            break
        messages.append({"role": "user", "content": line})
        try:
            prompt = engine.render_chat(messages)
        except ChatTemplateError as e:
            print(f"error: {e}", file=sys.stderr)
            return
        toks = engine.tokenizer.encode(prompt, bos=False)
        pieces = []

        def emit(token, piece: bytes):
            if engine.tokenizer.is_eos_or_eot(token):
                return
            pieces.append(piece)
            sys.stdout.write(piece.decode("utf-8", errors="replace"))
            sys.stdout.flush()

        steps = args.num_steps if args.num_steps else -1
        engine.generate(toks, steps, temperature=args.temperature,
                        top_p=args.top_p, top_k=args.top_k,
                        min_p=args.min_p, on_token=emit)
        print()
        messages.append({
            "role": "assistant",
            "content": b"".join(pieces).decode("utf-8", errors="replace")})


def run_interactive(engine: Engine, args: Args):
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line:
            continue
        mode, *rest = shlex.split(line)
        sub = Args()
        sub.checkpoint = args.checkpoint
        sub.chunk = args.chunk
        sub.device = args.device
        if mode == "q":
            break
        if mode == "h":
            print(INTERACTIVE_USAGE, file=sys.stderr)
            continue
        try:
            if mode == "c":
                sub.mode = "completion"
                parse_mode_flags(sub, rest)
                run_completion(engine, sub)
            elif mode == "p":
                sub.mode = "perplexity"
                parse_mode_flags(sub, rest)
                run_perplexity(engine, sub)
            elif mode == "k":
                sub.mode = "passkey"
                parse_mode_flags(sub, rest)
                run_passkey(engine, sub)
            else:
                print(INTERACTIVE_USAGE, file=sys.stderr)
        except SystemExit:
            pass


def main(argv: Optional[List[str]] = None):
    # The JAX CLI starts with enable_compile_cache(); the port has no
    # counterpart: its kernels are built once into build/torch_kernels/
    # (ops/kernels/build.py) and loaded from there by every later run.
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        _die()
    args = Args()
    args.checkpoint = argv[0]
    rest = []
    i = 1
    while i < len(argv):
        a = argv[i]
        if a == "-m":
            i += 1
            args.mode = argv[i]
            if args.mode not in ("completion", "perplexity", "passkey",
                                 "interactive", "chat", "serve"):
                _die(f"unknown mode {args.mode}")
        elif a == "-T":
            i += 1
            args.context = int(argv[i])
        elif a == "-L":
            args.lock = True
        elif a == "--device":
            i += 1
            if i >= len(argv) or argv[i] not in ("cuda", "cpu"):
                _die("--device takes cuda or cpu")
            args.device = argv[i]
        else:
            rest.append(a)
        i += 1
    parse_mode_flags(args, rest)

    engine = Engine(
        args.checkpoint,
        context=args.context,
        lock_weights=args.lock,
        compute_dtype=args.dtype,
        kv_cache_dtype=args.kv_dtype,
        seed=args.seed if args.seed is not None else int(time.time() * 1000) % (1 << 31),
        prefill_chunk=args.chunk,
        decode_block=args.block,
        use_yarn=args.yarn,
        kquant_runtime=("turbo" if args.kquant_turbo
                        else "nibble" if args.kquant_nibble else None),
        scan_layers=args.scan_layers,
        device=args.device,
    )
    md = engine.data.metadata
    print(f"Loaded model: arch={md.get('arch')} quant={md.get('quant')} "
          f"n_layers={engine.cfg.n_layers} dim={engine.cfg.dim} "
          f"use_mla={int(engine.cfg.use_mla)} "
          f"max_seq_len={engine.cfg.max_seq_len} kv_window={engine.cfg.kv_window}")

    if args.mode == "completion":
        run_completion(engine, args)
    elif args.mode == "chat":
        run_chat(engine, args)
    elif args.mode == "perplexity":
        run_perplexity(engine, args)
    elif args.mode == "passkey":
        run_passkey(engine, args)
    elif args.mode == "serve":
        from deepseek_tpu_torch.server import Server
        Server(engine, batch_size=args.batch, warmup=args.warmup,
               prefix_cache_mb=args.prefix_cache_mb,
               spec=args.serve_spec,
               spec_k=args.spec_k,
               ).serve_forever(args.host, args.port)
    else:
        run_interactive(engine, args)


if __name__ == "__main__":
    main()
