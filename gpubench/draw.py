"""The benchmark's weights, drawn from ``--seed`` on the device in the
checkpoint's stored formats.

Plain torch only: the reference imports this module, and it imports nothing
of the program. Every tensor has a generator of its own, seeded from the run's
seed and the tensor's name, so that the reference can draw any one tensor
again, alone and in the same bits, after the program's copy is freed.

Formats (the numbers are the benchmark's, not the program's):

- Q3_K, in the packed plane layout that the port's loader makes of Q3_K
  blocks (a bijection of the blocks' fields): ``qs`` (.., rows, cols/4) uint8,
  2-bit low quants plane-packed over stride-16 permuted columns; ``hm`` (..,
  rows, cols/8) uint8, the high bits likewise; ``sc`` (.., rows, cols/16)
  int8 in [-32, 32), the 6-bit group scales minus 32, in natural group order;
  ``d`` (.., rows, cols/256) f32 super scales, each an f16 value as a block
  stores it. Random bytes give quants uniform over [-4, 3].
- F8E5M2: bytes (.., rows, cols) uint8 of normal(0, 1) values rounded to
  e5m2 through bf16 (random bytes would hit the inf/NaN codes), with f32
  inverse scales on a ceil-sized (b0, b1) block grid.
- Norms are ones, the router (``moegate``) f32 normal, the V3 e-score
  correction bias zeros.

The scales are chosen so that a projection keeps unit-RMS inputs at about
unit RMS (weight std ~ gain / sqrt(cols)), so that logits, attention scores
and router scores have the spread of a trained model rather than saturating.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Tuple

import torch

# std of a Q3_K weight over d: quants uniform over [-4, 3] (E[q^2] = 5.5)
# times group scales uniform over [-32, 32) (E[s^2] = 341.5)
_Q3K_STD_PER_D = math.sqrt(5.5 * 341.5)


def tensor_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for tensor ``name`` of run ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(tensor_seed(seed, name))
    return gen


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    """One stored weight: ``lead`` (experts) x (rows, cols), its format
    ('q3_k' or 'f8e5m2') and the gain of its scale."""
    name: str
    lead: Tuple[int, ...]
    rows: int
    cols: int
    gain: float = 1.0


def q3k_planes(seed: int, w: WeightSpec, device) -> Dict[str, torch.Tensor]:
    """The Q3_K planes of ``w`` (see the module docstring), in four calls."""
    if w.cols % 256:
        raise ValueError(f"{w.name}: Q3_K needs cols % 256 == 0, got {w.cols}")
    gen = generator(seed, w.name, device)
    lead, r, c = w.lead, w.rows, w.cols

    def u8(n):
        return torch.randint(0, 256, (*lead, r, n), generator=gen, device=device,
                             dtype=torch.uint8)

    qs, hm = u8(c // 4), u8(c // 8)
    sc = torch.randint(-32, 32, (*lead, r, c // 16), generator=gen, device=device,
                       dtype=torch.int8)
    mean_d = w.gain / (_Q3K_STD_PER_D * math.sqrt(c))
    d = torch.rand((*lead, r, c // 256), generator=gen, device=device) + 0.5
    d = (d * mean_d).to(torch.float16).float()
    return {"qs": qs, "hm": hm, "sc": sc, "d": d}


def fp8_blocks(seed: int, w: WeightSpec, block: Tuple[int, int], device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bytes uint8 (.., rows, cols), scale f32 (.., ceil(rows/b0),
    ceil(cols/b1))) of ``w``, the bytes in one call a table."""
    gen = generator(seed, w.name, device)
    lead, r, c = w.lead, w.rows, w.cols
    data = torch.randn((*lead, r, c), generator=gen, device=device) \
        .to(torch.bfloat16).to(torch.float8_e5m2).view(torch.uint8)
    b0, b1 = block
    sc = torch.rand((*lead, -(-r // b0), -(-c // b1)), generator=gen, device=device) + 0.5
    return data, sc * (w.gain / math.sqrt(c))


def router(seed: int, name: str, E: int, dim: int, device) -> torch.Tensor:
    """The router weight (E, dim) f32: scores spread over the experts."""
    gen = generator(seed, name, device)
    return torch.randn((E, dim), generator=gen, device=device) * (1.5 / math.sqrt(dim))


# ---------------------------------------------------------------------------
# the tensors a configuration stores
# ---------------------------------------------------------------------------

def is_moe(hf: dict, layer: int) -> bool:
    return layer >= hf["first_k_dense_replace"] and hf.get("n_routed_experts", 0) > 0


def attention_weights(hf: dict, run: dict, layer: int) -> List[WeightSpec]:
    """Absorbed MLA without the factor weights (``convert.py --mla``), or
    decompressed MHA (the converter's default), as the configuration runs."""
    p = f"l{layer}."
    dim, H = hf["hidden_size"], hf["num_attention_heads"]
    R, P = hf["kv_lora_rank"], hf["qk_rope_head_dim"]
    nope, Dv = hf["qk_nope_head_dim"], hf["v_head_dim"]
    ql = hf.get("q_lora_rank") or 0
    out = [WeightSpec(p + "wkv_a", (), R + P, dim), WeightSpec(p + "wo", (), dim, H * Dv)]
    if run["use_mla"]:
        out += [WeightSpec(p + "wq_a", (), ql, dim), WeightSpec(p + "wc", (), H * R, ql),
                WeightSpec(p + "wq_rope_b", (), H * P, ql),
                WeightSpec(p + "wv_b", (), H * Dv, R)]
    else:
        if ql:
            raise ValueError("decompressed MHA with a query LoRA is not drawn")
        out += [WeightSpec(p + "wq", (), H * (nope + P), dim),
                WeightSpec(p + "wkv_b", (), H * (nope + Dv), R)]
    return out


def ffn_weights(hf: dict, layer: int) -> List[WeightSpec]:
    p = f"l{layer}."
    dim = hf["hidden_size"]
    if not is_moe(hf, layer):
        h = hf["intermediate_size"]
        return [WeightSpec(p + "w1", (), h, dim), WeightSpec(p + "w3", (), h, dim),
                WeightSpec(p + "w2", (), dim, h)]
    E, m, ns = hf["n_routed_experts"], hf["moe_intermediate_size"], hf["n_shared_experts"]
    return [WeightSpec(p + "w1", (E,), m, dim), WeightSpec(p + "w3", (E,), m, dim),
            WeightSpec(p + "w2", (E,), dim, m),
            WeightSpec(p + "shared_w1", (), ns * m, dim),
            WeightSpec(p + "shared_w3", (), ns * m, dim),
            WeightSpec(p + "shared_w2", (), dim, ns * m)]


def embed_weight(hf: dict) -> WeightSpec:
    """Embedding rows of unit RMS."""
    return WeightSpec("embed", (), hf["vocab_size"], hf["hidden_size"],
                      gain=math.sqrt(hf["hidden_size"]))


def head_weight(hf: dict) -> WeightSpec:
    """The lm_head: logits of std ~2 over unit-RMS hidden states."""
    return WeightSpec("lm_head", (), hf["vocab_size"], hf["hidden_size"], gain=2.0)


def draw(seed: int, w: WeightSpec, run: dict, device):
    """The stored fields of ``w`` in the configuration's format: a dict of
    Q3_K planes, or (fp8 bytes, scale)."""
    if run["quant"] == "q3_k":
        return q3k_planes(seed, w, device)
    if run["quant"] == "f8e5m2":
        return fp8_blocks(seed, w, tuple(run["block_size"]), device)
    raise ValueError(f"unsupported weight format {run['quant']!r}")


def slice_experts(fields, lo: int, hi: int):
    """Experts lo..hi of an expert table's stored fields."""
    if isinstance(fields, dict):
        return {k: v[lo:hi] for k, v in fields.items()}
    return tuple(t[lo:hi] for t in fields)


def gate_bias(hf: dict, device) -> Optional[torch.Tensor]:
    """DeepSeek-V3's e-score correction bias (zeros), None for V2."""
    if hf.get("topk_method") != "noaux_tc":
        return None
    return torch.zeros(hf["n_routed_experts"], device=device)
