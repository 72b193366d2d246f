"""The port's HTTP serving daemon (``deepseek_tpu_torch/server.py``) on
loopback over the CPU Engine, against the JAX package's ``Server`` on the
same tiny checkpoint: health, greedy completions (the port's tokens are the
JAX server's and the port Engine's ``generate``'s), streaming as SSE,
concurrent requests, ``stop``, ``top_k``, ``min_p``, ``logprobs``, the
prefix cache's hits, chat completions through the checkpoint's template,
and a ``--serve-spec`` server. No network: every request goes to
127.0.0.1.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.server import Server as JaxServer
from deepseek_tpu.utils import codec
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.server import Server
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_tinymodel import (
    tiny_checkpoint_tensors, tiny_config, tiny_metadata, tiny_weights,
)

TEMPLATE = ("{{ bos_token }}{% for m in messages %}<|{{ m.role }}|>{{ m.content }}"
            "{{ eos_token if m.role == 'assistant' }}\n{% endfor %}"
            "{% if add_generation_prompt %}<|assistant|>{% endif %}")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("srvhttp")
    cfg = tiny_config(use_mla=True, vocab_size=300, max_seq_len=128,
                      rs_original_max_position_embeddings=64)
    md = tiny_metadata(cfg)
    md.update(chat_template=TEMPLATE, chat_bos_token="<s>", chat_eos_token="</s>")
    codec.save_checkpoint(str(d), [tiny_checkpoint_tensors(cfg, tiny_weights(cfg, 5))], md)
    return str(d)


@pytest.fixture(scope="module")
def engine(ckpt):
    return Engine(ckpt, seed=0, prefill_chunk=8, decode_block=1, device="cpu")


def _start(srv):
    httpd = srv.make_http_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def served(engine):
    srv = Server(engine, batch_size=2)
    httpd, url = _start(srv)
    yield url, srv
    httpd.shutdown()
    srv.shutdown()


@pytest.fixture(scope="module")
def jax_served(ckpt):
    srv = JaxServer(JaxEngine(ckpt, seed=0, prefill_chunk=8, decode_block=1),
                    batch_size=2, warmup=False, idle_block=0)
    httpd, url = _start(srv)
    yield url
    httpd.shutdown()
    srv.shutdown()


def _post(url, payload, path="/v1/completions", timeout=300):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _json(url, payload, path="/v1/completions"):
    with _post(url, payload, path) as r:
        return json.loads(r.read())


def _greedy(engine, text, n):
    return engine.generate(engine.tokenizer.encode(text, bos=True), num_steps=n,
                           temperature=0.0)[0]


def test_health(served):
    url, _ = served
    with urllib.request.urlopen(url + "/health", timeout=60) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["n_layers"] == 3
    assert body["prefix_cache"]["misses"] >= 0


def test_server_idle_block_defaults_off(engine):
    """Not copied from server.py:57: the port's Server leaves idle-block
    escalation off by default (a long block costs time to first token and
    saves no dispatch in eager torch)."""
    srv = Server(engine, batch_size=1, warmup=False)
    try:
        assert srv.scheduler.idle_block == 0
    finally:
        srv.shutdown()


@pytest.mark.parametrize("payload", [
    {"prompt": "ab", "max_tokens": 5, "temperature": 0.0},
    {"prompt": "hello world", "max_tokens": 6, "temperature": 0.0, "logprobs": True},
    {"prompt": "xyz", "max_tokens": 4, "temperature": 0.7, "top_k": 1},
    {"prompt": "abc", "max_tokens": 4, "temperature": 0.0, "min_p": 0.5},
])
def test_completion_matches_jax_server(served, jax_served, engine, payload):
    """The port's response against the JAX server's for the same request:
    tokens, text, counts and finish reason equal, log-probabilities within
    1e-3; the tokens are also the port Engine's greedy run."""
    url, _ = served
    got, want = _json(url, payload), _json(jax_served, payload)
    lp, wlp = got.pop("logprobs", None), want.pop("logprobs", None)
    assert got == want
    assert got["tokens"] == _greedy(engine, payload["prompt"], payload["max_tokens"])
    if payload.get("logprobs"):
        assert len(lp) == len(got["tokens"])
        assert max(abs(a - b) for a, b in zip(lp, wlp)) <= 1e-3
    else:
        assert lp is None


def test_streaming(served, engine):
    url, _ = served
    with _post(url, {"prompt": "ab", "max_tokens": 4, "temperature": 0.0,
                     "stream": True}) as r:
        lines = [ln for ln in r.read().decode().splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "data: [DONE]"
    text = "".join(json.loads(ln[6:])["text"] for ln in lines[:-1])
    full = _json(url, {"prompt": "ab", "max_tokens": 4, "temperature": 0.0})["text"]
    assert text == full


def test_concurrent_requests(served, engine):
    url, _ = served
    results = {}

    def go(name, prompt):
        results[name] = _json(url, {"prompt": prompt, "max_tokens": 3, "temperature": 0.0})

    prompts = ["ab", "ba", "aa", "abc"]
    threads = [threading.Thread(target=go, args=(i, p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert [results[i]["tokens"] for i in range(4)] == [_greedy(engine, p, 3)
                                                         for p in prompts]


def test_stop_sequence_over_http(served, jax_served):
    url, _ = served
    req = {"prompt": "the", "max_tokens": 10, "temperature": 0.0}
    base = _json(url, req)
    assert base["finish_reason"] == "length"
    full = base["text"]
    stop = next(full[i:i + 2] for i in range(len(full) // 3, len(full) - 1)
                if full[i:i + 2].isascii() and full[i:i + 2].isprintable())
    body = _json(url, dict(req, stop=stop))
    assert body["finish_reason"] == "stop"
    assert stop not in body["text"] and full.startswith(body["text"])
    assert body == _json(jax_served, dict(req, stop=[stop]))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, {"prompt": "ab", "stop": 5}).read()
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, {"no": "prompt"}).read()
    assert e.value.code == 400


def test_prefix_cache_hits_over_http(served):
    url, srv = served
    prompt = "hello world abc xyz hello world abc xyz hello world"
    bodies = [_json(url, {"prompt": prompt + tail, "max_tokens": 3, "temperature": 0.0})
              for tail in (" one", " two", " one")]
    assert bodies[0]["tokens"] == bodies[2]["tokens"]
    with urllib.request.urlopen(url + "/health", timeout=60) as r:
        pc = json.loads(r.read())["prefix_cache"]
    assert pc["hits"] >= 1 and pc["tokens_reused"] >= 1


def test_chat_completions_match_jax(served, jax_served):
    url, _ = served
    payload = {"messages": [{"role": "user", "content": "hi there"}],
               "max_tokens": 5, "temperature": 0.0}
    got = _json(url, payload, "/v1/chat/completions")
    assert got["message"]["role"] == "assistant"
    assert got == _json(jax_served, payload, "/v1/chat/completions")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, {"max_tokens": 2}, "/v1/chat/completions").read()
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, {}, "/v1/nothing").read()
    assert e.value.code == 404


@pytest.mark.parametrize("spec", ["ngram", "mtp"])
def test_spec_serving_over_http(engine, spec):
    """A --serve-spec server: greedy completions are the plain Engine's, the
    logprobs field rides the verify chunks, and /health reports the
    speculation counts. The tiny checkpoint has no MTP module: spec="mtp"
    refuses to start, as the JAX server does."""
    if spec == "mtp":
        with pytest.raises(ValueError, match="MTP module"):
            Server(engine, batch_size=2, warmup=False, spec="mtp")
        return
    srv = Server(engine, batch_size=2, spec=spec, spec_k=3, spec_rounds=2)
    httpd, url = _start(srv)
    try:
        body = _json(url, {"prompt": "ab ab ab ab", "max_tokens": 12, "temperature": 0.0,
                           "logprobs": True})
        assert body["tokens"] == _greedy(engine, "ab ab ab ab", 12)
        assert len(body["logprobs"]) == 12 and all(x <= 0.0 for x in body["logprobs"])
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        assert health["spec"]["dispatches"] >= 1
    finally:
        httpd.shutdown()
        srv.shutdown()
