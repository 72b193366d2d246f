"""The port's native host libraries (``deepseek_tpu_torch/native/``)
against the JAX package's (``deepseek_tpu/native/``). g++ is present on
this host, so both libraries must build: nothing here skips.

- The native K-quant encoder equals the JAX native encoder byte for byte
  (the same source and flags), and both native decoders; it agrees with
  the numpy encoder on most bytes (the JAX package's own bound).
- The native trie tokenizer encodes as both Python tokenizers do.
- ``DSEEK_NO_NATIVE=1`` turns both libraries off (a fresh interpreter).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

from deepseek_tpu.native import kquant_native as jnat
from deepseek_tpu.quant import kquant as jk
from deepseek_tpu.tokenizer import Tokenizer as JaxTokenizer
from deepseek_tpu_torch.native import build, kquant_native, tokenizer_native
from deepseek_tpu_torch.quant import kquant as tk
from deepseek_tpu_torch.tokenizer import Tokenizer
from tests.test_tokenizer import make_vocab
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_libraries_build_under_build_dir():
    assert kquant_native.available(), kquant_native.build_error()
    assert tokenizer_native.available(), tokenizer_native.build_error()
    assert kquant_native.build_error() is None
    assert build.BUILD_DIR == __import__("pathlib").Path(ROOT) / "build" / "native"
    libs = sorted(p.name for p in build.BUILD_DIR.glob("lib*.so"))
    assert any(n.startswith("libkquant-") for n in libs), libs
    assert any(n.startswith("libtokenizer-") for n in libs), libs


@pytest.mark.parametrize("seed,rows,cols", [(1, 8, 1024), (2, 3, 256), (3, 17, 512)])
@pytest.mark.parametrize("method", ["q2_k", "q3_k", "q8_k"])
def test_native_encoder_equals_jax_native(seed, rows, cols, method):
    assert jnat.available()
    x = np.random.default_rng(seed).standard_normal((rows, cols)).astype(np.float32)
    x[0] = 0.0                                     # an all-zero row too
    got = kquant_native.quantize(x, method)
    np.testing.assert_array_equal(got, jnat.quantize(x, method))
    if method == "q8_k":
        return
    np.testing.assert_array_equal(kquant_native.dequantize(got, method, rows, cols),
                                  jnat.dequantize(got, method, rows, cols))
    dq = {"q2_k": tk.dequantize_q2_k, "q3_k": tk.dequantize_q3_k}[method]
    np.testing.assert_array_equal(kquant_native.dequantize(got, method, rows, cols),
                                  dq(got, rows, cols))
    numpy_enc = {"q2_k": tk.quantize_q2_k, "q3_k": tk.quantize_q3_k}[method](x)
    assert (got == numpy_enc).mean() > 0.99


def test_native_encoder_rejects_ragged_columns():
    with pytest.raises(ValueError, match="multiple of 256"):
        kquant_native.quantize(np.zeros((2, 300), np.float32), "q3_k")


def _samples():
    rng = np.random.default_rng(0)
    out = ["hello world", "", "  hello", "héllo wörld 中文", "wor",
           "hellohellohello world", "\x00\x01 byte fallback \xff"]
    return out + ["".join(chr(rng.integers(32, 500)) for _ in range(50)) for _ in range(5)]


def test_native_tokenizer_matches_both_python_tokenizers():
    tok = Tokenizer(make_vocab(), bos_id=1, eos_id=2)
    assert tok._native is not None
    py = copy.copy(tok)
    py._native = None
    jtok = JaxTokenizer(make_vocab(), bos_id=1, eos_id=2)
    jpy = copy.copy(jtok)
    jpy._native = None
    for s in _samples():
        want = jpy.encode(s, bos=True)
        assert tok.encode(s, bos=True) == want, s
        assert py.encode(s, bos=True) == want, s
        assert tok.decode(tok.encode(s)) == s.encode("utf-8")


_NO_NATIVE = r"""
import numpy as np
from deepseek_tpu_torch import convert
from deepseek_tpu_torch.native import kquant_native, tokenizer_native
from deepseek_tpu_torch.tokenizer import Tokenizer
assert not kquant_native.available() and not tokenizer_native.available()
assert kquant_native.build_error() == "DSEEK_NO_NATIVE=1"
assert convert.encoder() == "numpy (DSEEK_NO_NATIVE=1)"
tok = Tokenizer([b"<unk>", b"<s>", b"</s>", b"ab", b"b"], bos_id=1, eos_id=2)
assert tok._native is None and tok.encode("abb") == [3, 4]
x = np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32)
from deepseek_tpu_torch.quant import kquant
assert (convert._k_quantize(x, "q3_k") == kquant.quantize_q3_k(x)).all()
print("ok")
"""


def test_no_native_environment_variable_is_honoured():
    env = dict(os.environ, DSEEK_NO_NATIVE="1")
    res = subprocess.run([sys.executable, "-c", _NO_NATIVE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
