"""The port's CLI (``python -m deepseek_tpu_torch``) against the JAX CLI on
the CPU, and the Engine surface it prints: ``bits_per_weight``,
``perplexity``, ``render_chat``, the profiler's scopes.

Both CLIs run in process through ``main([...])`` on tiny checkpoints that
``deepseek_tpu.convert`` makes from a fake HF directory: an fp32
absorbed-MLA one with a chat template, and a Q3_K one for the K-quant
runtimes and the int8 cache. The port runs with ``--device cpu`` (the
kernels' plain versions); the sampler is seeded with ``--seed`` and
Python's ``random`` before passkey.
"""

import dataclasses
import filecmp
import io
import os
import random
import re
import sys

import pytest

from deepseek_tpu import cli as jax_cli
from deepseek_tpu import convert as cv
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.utils import profiling as jax_profiling
from deepseek_tpu_torch import cli
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.utils import profiling
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

TPL = ("{{ bos_token }}{% for m in messages %}"
       "{% if m.role == 'user' %}<U>{{ m.content }}</U>"
       "{% else %}<A>{{ m.content }}{{ eos_token }}{% endif %}{% endfor %}"
       "{% if add_generation_prompt %}<A>{% endif %}")

_Q3K = dict(dim=256, hidden=256, q_lora=256, kv_lora=256, nope=128, rope=64,
            v_dim=128, moe_inter=256, layers=2, vocab=300, n_experts=4,
            n_active=2, arch="DeepseekV3ForCausalLM", topk_method="noaux_tc",
            scoring="sigmoid")


def _convert(root, quant, cfg_kw=None, tokenizer_config=None, seed=5, **conv):
    cfg = hf_config(**(cfg_kw or {}))
    hf_dir = os.path.join(root, "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=seed, scale=0.15),
                 tokenizer_config=tokenizer_config)
    out = os.path.join(root, "ck")
    cv.convert(hf_dir, out, quant=quant, **conv)
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _convert(str(tmp_path_factory.mktemp("fp32")), "fp32",
                    tokenizer_config={"chat_template": TPL, "bos_token": "<s>",
                                      "eos_token": "</s>"}, use_mla=True)


@pytest.fixture(scope="module")
def q3k(tmp_path_factory):
    return _convert(str(tmp_path_factory.mktemp("q3k")), "q3_k", _Q3K, seed=23,
                    use_mla=True)


def _run(main, argv, capsys, stdin=None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    main(argv)
    return capsys.readouterr().out


def _both(path, args, capsys, stdin=None, monkeypatch=None, passkey_seed=None):
    """(port output, JAX output) of the same command line."""
    outs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        if passkey_seed is not None:
            random.seed(passkey_seed)
        outs.append(_run(main, [path, *args, *extra], capsys, stdin, monkeypatch))
    return outs


def _completions(out):
    """The generated texts of a run's completions (between the bits line
    and the stats) and its bits-per-weight lines."""
    texts = re.findall(r"Model bits per weight: [^\n]*\n(.*?)\nGeneration stats:",
                       out, re.S)
    return texts, re.findall(r"Model bits per weight: [^\n]*", out)


def _ppl(out):
    return [(float(a), float(b)) for a, b in
            re.findall(r"perplexity: ([0-9.e+-]+) ± ([0-9.e+-]+)", out)]


@pytest.mark.parametrize("temp", ["0", "0.8"])
def test_completion_matches_jax_cli(ckpt, capsys, temp):
    ours, theirs = _both(ckpt, ["-i", "hello world", "-n", "12", "-t", temp,
                                "--chunk", "8", "--seed", "3"], capsys)
    assert _completions(ours) == _completions(theirs)
    assert _completions(ours)[0][0]
    assert "throughput:" in ours and "bandwidth:" in ours


def test_perplexity_matches_jax_cli(ckpt, capsys, tmp_path):
    text = "hello world, hello again world: the quick brown fox"
    path = tmp_path / "prompt.txt"
    path.write_text(text)
    for src in (["-i", text], ["-f", str(path)]):
        ours, theirs = _both(ckpt, ["-m", "perplexity", *src, "--chunk", "8"], capsys)
        (p, e), = _ppl(ours)
        (jp, je), = _ppl(theirs)
        assert p == pytest.approx(jp, rel=1e-4)
        assert e == pytest.approx(je, rel=1e-4)
        assert re.search(r"Stats:\n  (\d+) tokens", ours).group(1) == \
            re.search(r"Stats:\n  (\d+) tokens", theirs).group(1)


def test_passkey_matches_jax_cli(ckpt, capsys):
    ours, theirs = _both(ckpt, ["-m", "passkey", "-n", "8", "-l", "3", "--chunk", "8",
                                "--seed", "4"], capsys, passkey_seed=17)
    head = lambda o: re.search(r"Passkey test:\n.*?passkey token index: ~\d+", o, re.S)
    assert head(ours).group(0) == head(theirs).group(0)
    # the 16 sampled tokens follow the suffix
    tail = lambda o: o.rsplit(" What is the pass key? The pass key is", 1)[1]
    assert tail(ours) == tail(theirs)


def test_interactive_matches_jax_cli(ckpt, capsys, monkeypatch):
    script = ('c -i "hello world" -n 6 -t 0 --chunk 8\n'
              'p -i "hello world hello" --chunk 8\n'
              'k -n 4 -l 1 --chunk 8\n'
              'h\n'
              'q\n')
    ours, theirs = _both(ckpt, ["-m", "interactive", "--seed", "2"], capsys,
                         stdin=script, monkeypatch=monkeypatch, passkey_seed=9)
    assert _completions(ours) == _completions(theirs)
    (p, _), = _ppl(ours)
    (jp, _), = _ppl(theirs)
    assert p == pytest.approx(jp, rel=1e-4)
    assert "Passkey test:" in ours


def test_chat_matches_jax_cli(ckpt, capsys, monkeypatch):
    ours, theirs = _both(ckpt, ["-m", "chat", "-n", "6", "-t", "0", "--chunk", "8",
                                "--seed", "1"], capsys,
                         stdin="hello\nworld\n\n", monkeypatch=monkeypatch)
    assert ours.strip() and ours == theirs
    eng = Engine(ckpt, device="cpu")
    assert eng.render_chat([{"role": "user", "content": "hi"}]) == "<s><U>hi</U><A>"


@pytest.mark.parametrize("flags", [["--kv-dtype", "int8"], ["--kquant-nibble"],
                                   ["--kquant-turbo"]])
def test_q3k_runtimes_match_jax_cli(q3k, capsys, flags):
    ours, theirs = _both(q3k, ["-i", "hello world", "-n", "6", "-t", "0",
                               "--chunk", "8", "--seed", "1", *flags], capsys)
    assert _completions(ours) == _completions(theirs)


def test_bad_flags_exit(ckpt):
    """As the JAX CLI's (``test_engine.py::test_cli_rejects_bad_flags``)."""
    for argv in ([ckpt, "-m", "completion"], [ckpt, "-m", "nope"],
                 [ckpt, "-m", "perplexity", "-i", "a", "-w"], [ckpt, "-x"],
                 [ckpt, "--device", "tpu"], []):
        with pytest.raises(SystemExit):
            cli.main(argv + (["--device", "cpu"] if len(argv) > 1 else []))


def test_serve_exits_citing_item_12(ckpt, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([ckpt, "-m", "serve", "--device", "cpu"])
    assert e.value.code != 0
    assert "item 12" in capsys.readouterr().err


def test_default_device_is_the_card(ckpt):
    """Without ``--device cpu`` the CLI asks for the card, and without one
    it raises: no silent fallback to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main([ckpt, "-i", "hi", "-n", "2"])


@pytest.mark.parametrize("quant,runtime", [
    ("fp32", None), ("fp16", None), ("f8e5m2", None), ("q2_k", None), ("q3_k", None),
    ("q3_k", "nibble"), ("q2_k", "turbo")])
def test_bits_per_weight_matches_jax(tmp_path, quant, runtime):
    ck = _convert(str(tmp_path), quant, _Q3K, seed=3, use_mla=True)
    got = Engine(ck, device="cpu", kquant_runtime=runtime).bits_per_weight()
    want = JaxEngine(ck, kquant_runtime=runtime).bits_per_weight()
    assert got == pytest.approx(want, rel=1e-9)
    assert got > 0


def test_fixtures_are_the_jax_packages():
    import deepseek_tpu
    import deepseek_tpu_torch
    for name in ("wikitext_v2.npy", "wikitext_v3.npy"):
        ours = os.path.join(os.path.dirname(deepseek_tpu_torch.__file__), "fixtures", name)
        theirs = os.path.join(os.path.dirname(deepseek_tpu.__file__), "fixtures", name)
        assert filecmp.cmp(ours, theirs, shallow=False)


def test_wikitext_tokens_match_jax():
    """``-w`` reads the port's own fixture, chosen by architecture as the
    JAX CLI chooses it."""
    from types import SimpleNamespace
    for arch in ("DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM"):
        eng = SimpleNamespace(cfg=SimpleNamespace(arch=arch))
        toks = cli.wikitext_tokens(eng)
        assert toks == jax_cli.wikitext_tokens(eng) and len(toks) > 100


def test_profile_scopes_match_jax(ckpt, capsys):
    """DSEEK_PROFILE parity (``test_engine.py::
    test_profile_scopes_capture_hot_paths``): the port's dump names the
    JAX CLI's scopes."""
    keys = []
    for mod, main, extra in ((profiling, cli.main, ["--device", "cpu"]),
                             (jax_profiling, jax_cli.main, [])):
        mod.reset_profile()
        mod.enable_profiling(True)
        try:
            main([ckpt, "-i", "hi there", "-n", "3", "-t", "0", "--chunk", "8",
                  "--seed", "1", *extra])
        finally:
            mod.enable_profiling(False)
        keys.append(sorted(mod.profile_report()))
        assert "Profile total times" in capsys.readouterr().out
    assert keys[0] == keys[1]
    assert any(k.startswith("hydrate.") for k in keys[0])
    assert any(k.startswith("generate.") for k in keys[0])


def _published_widths():
    """DeepSeek-V2-Lite's, V2's and V3's attention widths (their
    config.json), V2-Lite as converted by default (MHA) and in absorbed
    MLA."""
    from deepseek_tpu_torch.models.testing import (
        deepseek_v2_lite_proportions, deepseek_v3_proportions)
    lite = deepseek_v2_lite_proportions(n_layers=2)
    v2 = deepseek_v2_lite_proportions(n_layers=2, dim=5120, n_heads=128,
                                      q_lora_rank=1536, use_mla=True)
    return [lite, dataclasses.replace(lite, use_mla=True),
            dataclasses.replace(lite, kv_cache_dtype="int8"), v2,
            deepseek_v3_proportions(n_layers=2),
            deepseek_v3_proportions(n_layers=2, kv_cache_dtype="int8")]


@pytest.mark.parametrize("factors", [False, True])
def test_card_widths_accept_published_models(factors):
    from deepseek_tpu_torch.engine import check_card_widths
    for cfg in _published_widths():
        check_card_widths(cfg, factors)


@pytest.mark.parametrize("change,kernels", [
    (dict(kv_lora_rank=256), "K3 and K10"), (dict(kv_lora_rank=32), "K3 and K10"),
    (dict(v_head_dim=192), "K9"), (dict(use_mla=False, qk_nope_head_dim=320), "K8"),
])
def test_card_widths_refuse_what_the_kernels_refuse(change, kernels):
    from deepseek_tpu_torch.engine import check_card_widths
    from deepseek_tpu_torch.models.testing import deepseek_v3_proportions
    cfg = dataclasses.replace(deepseek_v3_proportions(n_layers=2), **change)
    with pytest.raises(ValueError, match=f"{kernels} take.*ROADMAP.md"):
        check_card_widths(cfg, factors=True)


def test_card_widths_checked_on_the_card_only(ckpt, monkeypatch):
    """The tiny checkpoint's kv_lora_rank 16 runs on the CPU; an Engine on
    the card refuses it before any weight moves there."""
    import torch
    from deepseek_tpu_torch import engine as engine_mod
    eng = Engine(ckpt, device="cpu")
    assert eng.cfg.kv_lora_rank == 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    moved = []
    monkeypatch.setattr(engine_mod, "load_params", lambda *a, **k: moved.append(1))
    with pytest.raises(ValueError, match="kv_lora_rank 16"):
        Engine(ckpt, device="cuda")
    assert not moved
