"""HuggingFace -> ``.dseek`` checkpoint converter: the port of
``deepseek_tpu/convert.py``.

Normalizes the HF config into string-valued metadata, merges the
safetensors shards (memory-mapped, one tensor fetched at a time, its
mapped pages released once it is copied), embeds the tokenizer vocab
as a tensor and the chat template in the metadata, dequantizes HF-native
FP8 checkpoints (``F8_E4M3`` weights with ``weight_scale_inv`` block
grids), re-quantizes to the target format (fp32 / fp16 / blockwise or
per-tensor f8e5m2 / Q2_K / Q3_K), stacks per-expert weights into one 3-D
tensor, performs the offline MLA absorption (attn.wc / wq_rope_b / wv_b,
keeping wkv_b / wq_b beside them), converts DeepSeek-V3's MTP layer, and
writes ``shard_NNN.dseek`` every 8 layers: the JAX converter's tensor
names, metadata keys and shards, so either package loads the result.

The float work runs in torch on ``device`` (the card by default;
``device="cpu"`` / ``--device cpu`` on the host): the FP8 dequantization,
the absorption product and the fp16 and f8e5m2 quantization
(``quant/fp8.py``). Every step but the absorption is exact IEEE arithmetic
(casts, single products, the fp8 scale division), so the output is the JAX
converter's byte for byte except ``attn.wc``: its product sums in another
order than ``np.einsum``; it is accumulated in f64 and rounded once. The
K-quant encoding runs on the host through the native C++/OpenMP encoder
(``native/kquant_native.py``) where it builds, else the numpy encoder
(``quant/kquant.py``), as in the JAX package; ``encoder()`` says which.
HF tensors are read as raw bytes (``BF16``, ``F8_E4M3``) reinterpreted as
torch dtypes, so no ``ml_dtypes`` is needed.

    python -m deepseek_tpu_torch.convert OUT_DIR HF_DIR [--mla] [--quant q3_k]
        [--bsize 128] [--n-layers N] [--ref-compat-topk] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from deepseek_tpu_torch.native import kquant_native
from deepseek_tpu_torch.quant import fp8 as fp8q
from deepseek_tpu_torch.quant import kquant
from deepseek_tpu_torch.utils import codec

SUPPORTED_ARCHITECTURES = ["DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM"]
SUPPORTED_QUANTS = ["fp32", "fp16", "f8e5m2", "q2_k", "q3_k"]

# raw HF dtypes read as bytes and reinterpreted (no ml_dtypes needed)
_RAW_TORCH = {"BF16": (np.int16, torch.bfloat16), "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
              "F8_E5M2": (np.uint8, torch.float8_e5m2)}


def encoder() -> str:
    """The K-quant encoder the converter uses: "native" or "numpy (why)"."""
    if kquant_native.available():
        return "native"
    return f"numpy ({kquant_native.build_error()})"


def _k_quantize(t: np.ndarray, method: str) -> np.ndarray:
    if t.shape[-1] % kquant.QK_K:
        raise ValueError(f"{method}: {t.shape[-1]} columns are no multiple of "
                         f"{kquant.QK_K}, so the weight has no K-quant form")
    if kquant_native.available():
        return kquant_native.quantize(t, method)
    fn = kquant.quantize_q2_k if method == "q2_k" else kquant.quantize_q3_k
    return fn(t)


# ---------------------------------------------------------------------------
# config normalization
# ---------------------------------------------------------------------------

def normalize_metadata(config: dict, tokenizer_config: dict, quant: str,
                       n_layers: Optional[int], use_mla: bool,
                       bsize: Optional[int], ref_compat_topk: bool = False) -> dict:
    """The ``.dseek`` metadata (string values) of an HF config."""
    arch = config["architectures"][0]
    if arch not in SUPPORTED_ARCHITECTURES:
        raise ValueError(f"unsupported architecture {arch}")
    if quant not in SUPPORTED_QUANTS:
        raise ValueError(f"unsupported quant {quant}")

    nl = config["num_hidden_layers"]
    if n_layers is not None:
        nl = min(nl, n_layers)

    q_lora = config["q_lora_rank"] or 0
    if use_mla and not (q_lora > 0 and config["kv_lora_rank"] > 0):
        raise ValueError("--mla requires q_lora_rank > 0 and kv_lora_rank > 0")

    if config.get("attention_bias", False) or config.get("mlp_bias", False):
        raise ValueError("attention and MLP biases are not supported")
    if config["hidden_act"] not in ("gelu", "silu"):
        raise ValueError(f"unsupported activation {config['hidden_act']}")

    topk_method = config["topk_method"]
    if topk_method == "noaux_tc" and ref_compat_topk:
        topk_method = "group_limited_greedy"

    rs = config["rope_scaling"]
    if rs["type"] != "yarn":
        raise ValueError(f"unsupported rope scaling {rs['type']}")

    md = {
        "arch": arch,
        "use_mla": str(int(use_mla)),
        "quant": quant,
        "dim": str(config["hidden_size"]),
        "hidden_dim": str(config["intermediate_size"]),
        "n_layers": str(nl),
        "n_heads": str(config["num_attention_heads"]),
        "vocab_size": str(config["vocab_size"]),
        "max_seq_len": str(tokenizer_config["model_max_length"]),
        "bos_token_id": str(config["bos_token_id"]),
        "eos_token_id": str(config["eos_token_id"]),
        "rope_theta": str(config.get("rope_theta", 10000.0)),
        "norm_eps": str(config["rms_norm_eps"]),
        "norm_type": "rmsnorm",
        "act_type": config["hidden_act"],
        "first_k_dense_replace": str(config["first_k_dense_replace"]),
        "kv_lora_rank": str(config["kv_lora_rank"]),
        "q_lora_rank": str(q_lora),
        "qk_nope_head_dim": str(config["qk_nope_head_dim"]),
        "qk_rope_head_dim": str(config["qk_rope_head_dim"]),
        "v_head_dim": str(config["v_head_dim"]),
        "n_shared_experts": str(config["n_shared_experts"]),
        "n_routed_experts": str(config["n_routed_experts"]),
        "n_active_routed": str(config["num_experts_per_tok"]),
        "moe_intermediate_size": str(config["moe_intermediate_size"]),
        "routed_scaling_factor": str(config["routed_scaling_factor"]),
        "n_group": str(config["n_group"]),
        "norm_topk_prob": str(config["norm_topk_prob"]),
        "scoring_func": config["scoring_func"],
        "topk_group": str(config["topk_group"]),
        "topk_method": topk_method,
        "rope_scaling_beta_fast": str(rs["beta_fast"]),
        "rope_scaling_beta_slow": str(rs["beta_slow"]),
        "rope_scaling_factor": str(rs["factor"]),
        "rope_scaling_mscale": str(rs["mscale"]),
        "rope_scaling_mscale_all_dim": str(rs["mscale_all_dim"]),
        "rope_scaling_original_max_position_embeddings":
            str(rs["original_max_position_embeddings"]),
    }
    if quant == "f8e5m2" and bsize != 0:
        # --bsize 0: per-tensor scalar scales, no block-size keys (the loader
        # then takes scalar / (E,1,1) scales); the default is 128x128 blocks
        b = bsize if bsize else 128
        md["quantization_block_size_0"] = str(b)
        md["quantization_block_size_1"] = str(b)

    # the HF chat template, embedded verbatim for the CLI's chat mode and
    # the server's chat completions
    tpl = tokenizer_config.get("chat_template")
    if isinstance(tpl, list):        # HF multi-template form
        named = {t.get("name"): t.get("template") for t in tpl
                 if isinstance(t, dict)}
        tpl = named.get("default") or next(iter(named.values()), None)
    if isinstance(tpl, str) and tpl:
        md["chat_template"] = tpl

        def tok_str(key):
            v = tokenizer_config.get(key)
            if isinstance(v, dict):      # AddedToken form
                v = v.get("content")
            return v if isinstance(v, str) else None

        bos, eos = tok_str("bos_token"), tok_str("eos_token")
        if bos:
            md["chat_bos_token"] = bos
        if eos:
            md["chat_eos_token"] = eos
    return md


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def gpt2_bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte<->unicode mapping used by HF ByteLevel tokenizers."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def load_tokens(tokenizer_path: str, vocab_size: int) -> List[bytes]:
    """The vocab of an HF tokenizer.json as byte strings (GPT-2 byte-level
    pieces decoded, SentencePiece "▁" turned into spaces, NUL as BEL)."""
    with open(tokenizer_path) as f:
        tok = json.load(f)
    use_gpt2_bytes = not tok["model"].get("byte_fallback", False)
    tokens: List[str] = [""] * vocab_size
    for t, i in tok["model"]["vocab"].items():
        tokens[i] = t
    for added in tok.get("added_tokens", []):
        tokens[added["id"]] = added["content"]

    gpt2_decode = {v: k for k, v in gpt2_bytes_to_unicode().items()}
    out: List[bytes] = []
    for t in tokens:
        if use_gpt2_bytes:
            b = bytes(gpt2_decode.get(ch, 0) for ch in t)
        else:
            b = t.replace("▁", " ").encode("utf-8")
        out.append(b.replace(b"\x00", b"\x07"))
    return out


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _read_safetensors(paths: List[str]
                      ) -> Tuple[Dict[str, np.ndarray], List[np.memmap]]:
    """Memory-map every input shard: the tensors are lazy views, fetched
    (copied) one at a time by ``Converter.fetch``, so the checkpoint is
    never held in RAM. Also returns the maps, whose consumed pages
    ``_release_mapped_pages`` drops."""
    weights: Dict[str, np.ndarray] = {}
    mms: List[np.memmap] = []
    for path in paths:
        _, tensors = codec.load_shard(path, read_metadata=False)
        first = True
        for name, tv in tensors.items():
            if name in weights:
                raise ValueError(f"duplicate tensor {name}")
            weights[name] = tv.array
            if first:
                b = tv.array
                while b is not None and not isinstance(b, np.memmap):
                    b = b.base
                if isinstance(b, np.memmap):
                    mms.append(b)
                first = False
    return weights, mms


def _release_mapped_pages(mms: List[np.memmap]) -> None:
    """Drop the input maps' resident pages (MADV_DONTNEED). Each HF tensor
    is read once, but the touched pages of a private read-only map stay in
    the RSS until memory pressure; dropping them after each fetch keeps
    the peak at about one output shard plus the largest tensor, whatever
    the checkpoint's size. An untouched page is unaffected; a re-read
    faults in from the file."""
    import mmap as _m
    if not hasattr(_m, "MADV_DONTNEED"):  # pragma: no cover - non-Linux
        return
    for mm in mms:
        try:
            mm._mmap.madvise(_m.MADV_DONTNEED)
        except (AttributeError, ValueError, OSError):  # pragma: no cover
            pass


# bytes of a mapped HF tensor copied through host memory at a time
FETCH_BYTES = 256 << 20


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    """A (memory-mapped) HF array copied to ``device`` as float32: BF16
    and F8 arrays through their raw bytes (with or without ml_dtypes),
    FETCH_BYTES of leading rows at a time, so the host holds one such
    slice beside the mapped pages, not a copy of the whole tensor."""
    raw = _RAW_TORCH.get(codec.np_to_dtype_str(a.dtype))

    def moved(x):
        t = torch.from_numpy(np.array(x) if raw is None else np.array(x).view(raw[0]))
        return (t if raw is None else t.view(raw[1])).to(device)
    if a.ndim == 0 or a.nbytes <= FETCH_BYTES:
        return moved(a).float()
    step = max(1, FETCH_BYTES // (a.nbytes // a.shape[0]))
    return torch.cat([moved(a[i:i + step]) for i in range(0, a.shape[0], step)]).float()


def _host(t: torch.Tensor, np_dtype) -> np.ndarray:
    """A torch tensor as a contiguous host array of the codec's dtype."""
    if t.dtype == torch.float8_e5m2:
        return t.view(torch.uint8).cpu().numpy().view(np_dtype)
    return np.ascontiguousarray(t.cpu().numpy())


# rows of a weight copied to the host at a time for the K-quant encoder
# (its rows are independent): the host holds one such slice, not the
# whole f32 weight (a V3 head is 3.7 GB in f32)
K_QUANT_ROWS = 4096


class Converter:
    def __init__(self, weights: Dict[str, np.ndarray], md: dict, quant: str,
                 bsize: Optional[int], dequant_block: Optional[Tuple[int, int]],
                 device="cpu", mms: Optional[List[np.memmap]] = None):
        self.w = weights
        self.mms = mms or []
        self.md = md
        self.quant = quant
        self.device = torch.device(device)
        if quant == "f8e5m2":
            # (0, 0) = per-tensor scalar scale (--bsize 0)
            self.block = (0, 0) if bsize == 0 else (bsize or 128,) * 2
        else:
            self.block = None
        self.dequant_block = dequant_block

    def fetch(self, name: str) -> torch.Tensor:
        """An HF tensor as float32 on the device (an FP8 one dequantized by
        its ``weight_scale_inv`` grid: one exact product a weight)."""
        t = _to_torch(self.w[name], self.device)
        scale_name = name.replace(".weight", ".weight_scale_inv")
        if scale_name in self.w and scale_name != name:
            s = _to_torch(self.w[scale_name], self.device)
            (b0, b1), (d, n) = self.dequant_block, t.shape
            t = t * s.repeat_interleave(b0, 0)[:d].repeat_interleave(b1, 1)[:, :n]
        _release_mapped_pages(self.mms)     # the tensor is copied: drop its pages
        return t

    def norm(self, name: str) -> np.ndarray:
        """A norm or router tensor, stored as f32 whatever the target."""
        return _host(_to_torch(self.w[name], "cpu"), np.float32)

    def quantize(self, t: torch.Tensor) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if self.quant == "fp32":
            return _host(t.float(), np.float32), None
        if self.quant == "fp16":
            return _host(t.half(), np.float16), None
        if self.quant == "f8e5m2":
            f8 = codec._DTYPE_TO_NP["F8_E5M2"]
            if self.block == (0, 0):
                # one scalar scale a stored tensor, expert stacks included
                q, s = fp8q.per_tensor_quantize(t)
            elif t.dim() == 3:       # stacked experts: per-expert block grids
                qs, ss = zip(*(fp8q.blockwise_quantize(e, self.block) for e in t))
                q, s = torch.stack(qs), torch.stack(ss)
            else:
                q, s = fp8q.blockwise_quantize(t, self.block)
            return _host(q, f8), _host(s, np.float32)
        # K-quants, on the host, K_QUANT_ROWS rows at a time
        if t.dim() == 3:
            return np.stack([self._k_rows(e) for e in t]), None
        return self._k_rows(t), None

    def _k_rows(self, t: torch.Tensor) -> np.ndarray:
        return np.concatenate([_k_quantize(_host(t[i:i + K_QUANT_ROWS], np.float32),
                                           self.quant)
                               for i in range(0, t.shape[0], K_QUANT_ROWS)])

    def conv(self, out: dict, out_name: str, hf_name: str):
        self.conv_raw(out, out_name, self.fetch(hf_name))

    def conv_raw(self, out: dict, out_name: str, t: torch.Tensor):
        q, s = self.quantize(t)
        out[out_name + ".weight"] = q
        if s is not None:
            out[out_name + ".scale"] = s

    def conv_experts(self, out: dict, out_name: str, hf_names: List[str]):
        self.conv_raw(out, out_name, torch.stack([self.fetch(n) for n in hf_names]))


def absorb(k_nope_b: torch.Tensor, q_nope_b: torch.Tensor) -> torch.Tensor:
    """The absorbed score projection c[h] = k_nope_b[h].T @ q_nope_b[h]
    ((H, nope, R), (H, nope, Q) -> (H, R, Q)), accumulated in f64 and
    rounded to f32 once."""
    return torch.einsum("hnr,hnq->hrq", k_nope_b.double(), q_nope_b.double()).float()


def convert_weights(weights: Dict[str, np.ndarray], md: dict,
                    quant: str, use_mla: bool, tie_word_embeddings: bool,
                    bsize: Optional[int],
                    dequant_block: Optional[Tuple[int, int]],
                    progress: bool = False,
                    mtp_layer: Optional[int] = None, device="cpu",
                    mms: Optional[List[np.memmap]] = None) -> Iterator[dict]:
    """Yields tensor dicts, one per 8-layer output shard; the input maps
    ``mms`` drop their pages after each tensor is fetched."""
    cv = Converter(weights, md, quant, bsize, dequant_block, device, mms)
    n_layers = int(md["n_layers"])
    n_heads = int(md["n_heads"])
    kv_lora = int(md["kv_lora_rank"])
    q_lora = int(md["q_lora_rank"])
    rope_dim = int(md["qk_rope_head_dim"])
    nope_dim = int(md["qk_nope_head_dim"])
    v_dim = int(md["v_head_dim"])
    first_dense = int(md["first_k_dense_replace"])
    n_experts = int(md["n_routed_experts"])
    is_v3 = md["arch"] == "DeepseekV3ForCausalLM"

    tensors: dict = {}
    cv.conv(tensors, "model.embed", "model.embed_tokens.weight")

    def convert_block(tensors, hf, out, moe):
        """One transformer block (the main layers' and the MTP block's)."""
        tensors[f"{out}.attn.norm.weight"] = cv.norm(f"{hf}.input_layernorm.weight")
        tensors[f"{out}.attn.kv_a_norm.weight"] = \
            cv.norm(f"{hf}.self_attn.kv_a_layernorm.weight")

        cv.conv(tensors, f"{out}.attn.wkv_a", f"{hf}.self_attn.kv_a_proj_with_mqa.weight")
        cv.conv(tensors, f"{out}.attn.wo", f"{hf}.self_attn.o_proj.weight")

        if use_mla:
            cv.conv(tensors, f"{out}.attn.wq_a", f"{hf}.self_attn.q_a_proj.weight")
            tensors[f"{out}.attn.q_a_norm.weight"] = \
                cv.norm(f"{hf}.self_attn.q_a_layernorm.weight")
            # offline MLA absorption: scores live in the kv_lora space
            kv_b = cv.fetch(f"{hf}.self_attn.kv_b_proj.weight").reshape(
                n_heads, nope_dim + v_dim, kv_lora)
            q_b = cv.fetch(f"{hf}.self_attn.q_b_proj.weight").reshape(
                n_heads, nope_dim + rope_dim, q_lora)
            k_nope_b = kv_b[:, :nope_dim]                   # (H, nope, R)
            v_b = kv_b[:, nope_dim:].reshape(n_heads * v_dim, kv_lora)
            q_nope_b = q_b[:, :nope_dim]                    # (H, nope, Q)
            q_rope_b = q_b[:, nope_dim:]                    # (H, rope, Q)
            cv.conv_raw(tensors, f"{out}.attn.wq_rope_b", q_rope_b.reshape(-1, q_lora))
            cv.conv_raw(tensors, f"{out}.attn.wc",
                        absorb(k_nope_b, q_nope_b).reshape(-1, q_lora))
            cv.conv_raw(tensors, f"{out}.attn.wv_b", v_b)
            del kv_b, q_b, k_nope_b, v_b, q_nope_b, q_rope_b
            # the decompressed projections too: prefill attends in head
            # space, decode stays absorbed
            cv.conv(tensors, f"{out}.attn.wkv_b", f"{hf}.self_attn.kv_b_proj.weight")
            cv.conv(tensors, f"{out}.attn.wq_b", f"{hf}.self_attn.q_b_proj.weight")
        else:
            cv.conv(tensors, f"{out}.attn.wkv_b", f"{hf}.self_attn.kv_b_proj.weight")
            if q_lora > 0:
                cv.conv(tensors, f"{out}.attn.wq_a", f"{hf}.self_attn.q_a_proj.weight")
                cv.conv(tensors, f"{out}.attn.wq_b", f"{hf}.self_attn.q_b_proj.weight")
                tensors[f"{out}.attn.q_a_norm.weight"] = \
                    cv.norm(f"{hf}.self_attn.q_a_layernorm.weight")
            else:
                cv.conv(tensors, f"{out}.attn.wq", f"{hf}.self_attn.q_proj.weight")

        tensors[f"{out}.mlp.norm.weight"] = cv.norm(f"{hf}.post_attention_layernorm.weight")

        if not moe:
            cv.conv(tensors, f"{out}.mlp.w1", f"{hf}.mlp.gate_proj.weight")
            cv.conv(tensors, f"{out}.mlp.w2", f"{hf}.mlp.down_proj.weight")
            cv.conv(tensors, f"{out}.mlp.w3", f"{hf}.mlp.up_proj.weight")
        else:
            tensors[f"{out}.moegate.weight"] = cv.norm(f"{hf}.mlp.gate.weight")
            if is_v3:
                tensors[f"{out}.moegate.bias"] = \
                    cv.norm(f"{hf}.mlp.gate.e_score_correction_bias")
            for proj, hf_proj in (("w1", "gate_proj"), ("w2", "down_proj"),
                                  ("w3", "up_proj")):
                cv.conv_experts(
                    tensors, f"{out}.mlp.{proj}",
                    [f"{hf}.mlp.experts.{e}.{hf_proj}.weight" for e in range(n_experts)])
            cv.conv(tensors, f"{out}.shared_mlp.w1", f"{hf}.mlp.shared_experts.gate_proj.weight")
            cv.conv(tensors, f"{out}.shared_mlp.w2", f"{hf}.mlp.shared_experts.down_proj.weight")
            cv.conv(tensors, f"{out}.shared_mlp.w3", f"{hf}.mlp.shared_experts.up_proj.weight")

    for layer in range(n_layers):
        if layer % 8 == 0 and layer > 0:
            yield tensors
            tensors = {}
        if progress:
            print(f"\rConverting layer {layer + 1}/{n_layers}", end="", flush=True)
        convert_block(tensors, f"model.layers.{layer}", f"model.layers.{layer}",
                      moe=layer >= first_dense)

    # DeepSeek-V3's MTP module (HF stores it as one extra layer index), for
    # self-speculative decoding; its prediction head is the shared lm_head
    if mtp_layer is not None and \
            f"model.layers.{mtp_layer}.eh_proj.weight" in weights:
        hf = f"model.layers.{mtp_layer}"
        tensors["model.mtp.enorm.weight"] = cv.norm(f"{hf}.enorm.weight")
        tensors["model.mtp.hnorm.weight"] = cv.norm(f"{hf}.hnorm.weight")
        cv.conv(tensors, "model.mtp.eh_proj", f"{hf}.eh_proj.weight")
        tensors["model.mtp.norm.weight"] = cv.norm(f"{hf}.shared_head.norm.weight")
        convert_block(tensors, hf, "model.mtp.block", moe=mtp_layer >= first_dense)

    tensors["model.norm.weight"] = cv.norm("model.norm.weight")
    if not tie_word_embeddings:
        cv.conv(tensors, "model.output", "lm_head.weight")
    if progress:
        print()
    yield tensors


# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA GPU is visible; pass "
                           "device='cpu' (--device cpu) to convert on the host")
    return dev


def convert(input_dir: str, output_dir: str, *, quant: str = "fp16",
            use_mla: bool = False, n_layers: Optional[int] = None,
            bsize: Optional[int] = None, ref_compat_topk: bool = False,
            progress: bool = False, device="cuda") -> None:
    """Convert the HF checkpoint in ``input_dir`` into ``output_dir``."""
    device = _device(device)
    with open(os.path.join(input_dir, "config.json")) as f:
        config = json.load(f)
    with open(os.path.join(input_dir, "tokenizer_config.json")) as f:
        tokenizer_config = json.load(f)

    md = normalize_metadata(config, tokenizer_config, quant, n_layers,
                            use_mla, bsize, ref_compat_topk)

    dequant_block = None
    qc = config.get("quantization_config")
    if qc is not None:
        if qc["quant_method"] != "fp8":
            raise ValueError(f"unsupported HF quantization {qc['quant_method']}")
        dequant_block = tuple(qc["weight_block_size"])

    model_files = sorted(
        os.path.join(input_dir, f) for f in os.listdir(input_dir)
        if f.endswith(".safetensors"))
    if not model_files:
        raise FileNotFoundError(f"no .safetensors in {input_dir}")
    weights, mms = _read_safetensors(model_files)

    tokens = load_tokens(os.path.join(input_dir, "tokenizer.json"),
                         int(md["vocab_size"]))

    os.makedirs(output_dir, exist_ok=True)
    if progress:
        print(f"Converting on {device}; K-quant encoder: {encoder()}", flush=True)
    # the MTP module lives at HF layer index num_hidden_layers (V3)
    mtp_layer = int(config["num_hidden_layers"])
    if f"model.layers.{mtp_layer}.eh_proj.weight" not in weights:
        mtp_layer = None
    shards = convert_weights(
        weights, md, quant, use_mla,
        bool(config.get("tie_word_embeddings", False)), bsize, dequant_block,
        progress=progress, mtp_layer=mtp_layer, device=device, mms=mms)
    for i, shard in enumerate(shards):
        if i == 0:
            shard["tokenizer.tokens"] = codec.pack_tokenizer_tokens(tokens)
        codec.save_shard(
            os.path.join(output_dir, f"shard_{i:03d}.dseek"),
            shard, metadata=md if i == 0 else None)
        if progress:
            print(f"Saved shard {i}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="HF checkpoint -> .dseek")
    ap.add_argument("output_dir")
    ap.add_argument("input", help="HF model dir (config.json, tokenizer.json, *.safetensors)")
    ap.add_argument("--mla", action="store_true", help="absorbed-MLA attention")
    ap.add_argument("--quant", default="fp16", choices=SUPPORTED_QUANTS)
    ap.add_argument("--bsize", type=int, default=None,
                    help="f8e5m2 scale block size (default 128; 0 = "
                         "per-tensor scalar scales)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--ref-compat-topk", action="store_true",
                    help="downgrade noaux_tc to group_limited_greedy")
    ap.add_argument("--device", default="cuda",
                    help="where the float work runs (default cuda; cpu on the host)")
    args = ap.parse_args(argv)
    convert(args.input, args.output_dir, quant=args.quant, use_mla=args.mla,
            n_layers=args.n_layers, bsize=args.bsize,
            ref_compat_topk=args.ref_compat_topk, progress=True, device=args.device)


if __name__ == "__main__":
    main()
