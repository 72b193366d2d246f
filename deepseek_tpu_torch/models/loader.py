"""Checkpoint -> ModelParams, the fusion pass, and params carried across
from the JAX package.

``load_params`` ports ``deepseek_tpu/models/loader.py::load_params`` for
F32/F16/BF16 tensors, F8_E5M2 tensors with blockwise or per-tensor scales,
and U8 K-quant tensors in the packed plane layout (the default, as in the
JAX package) or the nibble or turbo runtime layouts; ``fuse_projections``
ports the function of the same name, with the row-permuted expert layout
of ``DSEEK_FUSED_FFN=1`` (``rowperm_expert_w13``). ``params_from_reference``
builds the port's params from a ``deepseek_tpu`` ModelParams object
without importing JAX.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from deepseek_tpu_torch.config import ModelConfig, QuantKind
from deepseek_tpu_torch.models.params import LayerParams, MTPParams, ModelParams
from deepseek_tpu_torch.quant.kquant import Q2K_BLOCK_BYTES, Q3K_BLOCK_BYTES, QK_K
from deepseek_tpu_torch.quant.qtensor import (
    PACKED, TURBO, Fp8Tensor, KNibbleTensor, PlainTensor, Q2KTensor,
    Q3KTensor, cols_to_experts, q2k_to_nibble, q2k_to_turbo, q3k_to_nibble,
    q3k_to_turbo, rows_to_experts,
)
from deepseek_tpu_torch.quant.repack import repack_q2k, repack_q3k
from deepseek_tpu_torch.utils.codec import _DTYPE_TO_NP, CheckpointData

_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16}


def _to_torch(arr) -> torch.Tensor:
    """numpy (or array-like) -> CPU tensor; bfloat16 and float8_e5m2
    arrays (ml_dtypes, or the codec's raw words and bytes) keep their bits
    (torch.from_numpy knows neither dtype)."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16), copy=True, order="C")
                                ).view(torch.bfloat16)
    if a.dtype == _DTYPE_TO_NP["F8_E5M2"]:
        return torch.from_numpy(np.array(a.view(np.uint8), copy=True, order="C")
                                ).view(torch.float8_e5m2)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def check_kquant_runtime(cfg: ModelConfig, kquant_runtime: Optional[str]) -> None:
    """For a K-quant checkpoint: None (packed planes), "nibble" or
    "turbo"; any other value raises."""
    if cfg.weight_quant not in (QuantKind.Q2_K, QuantKind.Q3_K):
        return
    if kquant_runtime not in (None, "nibble", "turbo"):
        raise ValueError(f"kquant_runtime must be None, 'nibble' or 'turbo', "
                         f"not {kquant_runtime!r}")


def _logical_shape(dtype_str: str, shape, cfg: ModelConfig):
    """Logical (..., out, in) shape of a stored tensor (K-quant raw blocks
    encode 256 weights per block)."""
    if dtype_str == "U8":
        bb = (Q2K_BLOCK_BYTES if cfg.weight_quant == QuantKind.Q2_K
              else Q3K_BLOCK_BYTES)
        return tuple(shape[:-1]) + (shape[-1] // bb * QK_K,)
    return tuple(shape)


def load_params(data: CheckpointData, cfg: ModelConfig, *, device="cpu",
                runtime_dtype: Optional[str] = None,
                kquant_runtime: Optional[str] = None,
                load_mtp: bool = True) -> ModelParams:
    """Read a ``.dseek`` checkpoint onto ``device``. K-quant tensors keep
    the packed planes (``kquant_runtime=None``, the JAX package's default)
    or expand to the nibble (``"nibble"``) or int8 turbo (``"turbo"``)
    layout, the turbo one converted from the packed planes on ``device``;
    shapes are checked against the config and a mismatch fails loudly.
    With ``load_mtp`` the multi-token-prediction layer (``model.mtp.*``)
    is read where the checkpoint has one (``ModelParams.mtp``)."""
    check_kquant_runtime(cfg, kquant_runtime)

    def norm(name: str, expect=None) -> Optional[torch.Tensor]:
        arr = data.get(name + ".weight")
        if arr is None:
            return None
        arr = np.asarray(arr, dtype=np.float32)
        if expect is not None and tuple(arr.shape) != tuple(expect):
            raise ValueError(
                f"checkpoint tensor {name}.weight has shape "
                f"{tuple(arr.shape)}, config expects {tuple(expect)}")
        return torch.from_numpy(arr.copy()).to(device)

    def qt(name: str, expect=None):
        w = data.get(name + ".weight")
        if w is None:
            return None
        dt = data.tensors[name + ".weight"].dtype_str
        if expect is not None:
            got = _logical_shape(dt, w.shape, cfg)
            if tuple(got) != tuple(expect):
                raise ValueError(
                    f"checkpoint tensor {name}.weight has logical shape "
                    f"{tuple(got)}, config expects {tuple(expect)}")
        if dt in ("F32", "F16", "BF16"):
            t = _to_torch(w)
            if dt == "BF16" and t.dtype != torch.bfloat16:
                t = t.view(torch.bfloat16)       # raw 16-bit words
            if runtime_dtype is not None:
                t = t.to(_TORCH_DTYPES[runtime_dtype])
            return PlainTensor(data=t.to(device))
        if dt == "F8_E5M2":
            scale = data.get(name + ".scale")
            blockwise = scale is not None and scale.ndim >= 2
            s = (torch.from_numpy(np.array(scale, np.float32)) if scale is not None
                 else torch.ones((), dtype=torch.float32))
            t = _to_torch(w)
            if not blockwise and t.dim() == 3 and s.numel() == 1:
                # one per-tensor scalar over an expert stack (the reference
                # wire format): (E, 1, 1), so the scale gathers with the
                # experts and broadcasts in dequant
                s = s.reshape(1, 1, 1).expand(t.shape[0], 1, 1).contiguous()
            return Fp8Tensor(
                data=t.view(torch.uint8).to(device).view(torch.float8_e5m2),
                scale=s.to(device),
                block_size=tuple(cfg.block_size) if blockwise else (0, 0))
        if dt == "U8":
            raw = np.asarray(w)
            rows = raw.shape[-2]
            nibble = kquant_runtime == "nibble"
            turbo = kquant_runtime == "turbo"
            if cfg.weight_quant == QuantKind.Q2_K:
                cols = raw.shape[-1] // Q2K_BLOCK_BYTES * QK_K
                planes = repack_q2k(raw, rows, cols)
                if nibble:
                    return q2k_to_nibble(*planes, device=device)
                packed = Q2KTensor(*(_to_torch(a).to(device) for a in planes))
                return q2k_to_turbo(packed) if turbo else packed
            if cfg.weight_quant == QuantKind.Q3_K:
                cols = raw.shape[-1] // Q3K_BLOCK_BYTES * QK_K
                planes = repack_q3k(raw, rows, cols)
                if nibble:
                    return q3k_to_nibble(*planes, device=device)
                packed = Q3KTensor(*(_to_torch(a).to(device) for a in planes))
                return q3k_to_turbo(packed) if turbo else packed
            raise ValueError(f"U8 tensor {name} but weight_quant={cfg.weight_quant}")
        raise NotImplementedError(f"stored dtype {dt} of {name} is not ported")

    def block_params(p: str, moe: bool) -> LayerParams:
        c = cfg
        H = c.n_heads
        R, P = c.kv_lora_rank, c.qk_rope_head_dim
        nope, Dv = c.qk_nope_head_dim, c.v_head_dim
        E, m, ql = c.n_routed_experts, c.moe_intermediate_size, c.q_lora_rank
        moegate = norm(f"{p}.moegate", expect=(E, c.dim) if E else None)
        bias = data.get(f"{p}.moegate.bias") if moegate is not None else None
        ffn1 = (E, m, c.dim) if moe else (c.hidden_dim, c.dim)
        ffn2 = (E, c.dim, m) if moe else (c.dim, c.hidden_dim)
        return LayerParams(
            attn_norm=norm(f"{p}.attn.norm", expect=(c.dim,)),
            ffn_norm=norm(f"{p}.mlp.norm", expect=(c.dim,)),
            kv_a_norm=norm(f"{p}.attn.kv_a_norm", expect=(R,)),
            q_a_norm=norm(f"{p}.attn.q_a_norm", expect=(ql,) if ql > 0 else None),
            wkv_a=qt(f"{p}.attn.wkv_a", expect=(R + P, c.dim)),
            wo=qt(f"{p}.attn.wo", expect=(c.dim, H * Dv)),
            wq=qt(f"{p}.attn.wq", expect=(H * c.head_dim, c.dim)),
            wq_a=qt(f"{p}.attn.wq_a", expect=(ql, c.dim)),
            wq_b=qt(f"{p}.attn.wq_b", expect=(H * c.head_dim, ql)),
            wkv_b=qt(f"{p}.attn.wkv_b", expect=(H * (nope + Dv), R)),
            wc=qt(f"{p}.attn.wc", expect=(H * R, ql)),
            wq_rope_b=qt(f"{p}.attn.wq_rope_b", expect=(H * P, ql)),
            wv_b=qt(f"{p}.attn.wv_b", expect=(H * Dv, R)),
            w1=qt(f"{p}.mlp.w1", expect=ffn1),
            w2=qt(f"{p}.mlp.w2", expect=ffn2),
            w3=qt(f"{p}.mlp.w3", expect=ffn1),
            shared_w1=qt(f"{p}.shared_mlp.w1", expect=(c.n_shared_experts * m, c.dim)),
            shared_w2=qt(f"{p}.shared_mlp.w2", expect=(c.dim, c.n_shared_experts * m)),
            shared_w3=qt(f"{p}.shared_mlp.w3", expect=(c.n_shared_experts * m, c.dim)),
            moegate=moegate,
            moegate_bias=None if bias is None else torch.from_numpy(
                np.asarray(bias, np.float32).copy()).to(device),
        )

    layers = [block_params(f"model.layers.{l}", cfg.is_moe_layer(l))
              for l in range(cfg.n_layers)]
    mtp = None
    if load_mtp and data.get("model.mtp.eh_proj.weight") is not None:
        mtp = MTPParams(
            enorm=norm("model.mtp.enorm", expect=(cfg.dim,)),
            hnorm=norm("model.mtp.hnorm", expect=(cfg.dim,)),
            eh_proj=qt("model.mtp.eh_proj", expect=(cfg.dim, 2 * cfg.dim)),
            block=block_params("model.mtp.block", cfg.n_routed_experts > 0),
            final_norm=norm("model.mtp.norm", expect=(cfg.dim,)))
    embed = qt("model.embed", expect=(cfg.vocab_size, cfg.dim))
    lm_head = qt("model.output", expect=(cfg.vocab_size, cfg.dim))
    return ModelParams(embed=embed, layers=layers,
                       final_norm=norm("model.norm"),
                       lm_head=lm_head if lm_head is not None else embed, mtp=mtp)


# ---------------------------------------------------------------------------
# projection fusion
# ---------------------------------------------------------------------------

def _concat(a, b, dim: int):
    """Concatenate two same-layout weights along ``dim`` (-2: output rows,
    0: experts); None when the pair cannot be fused losslessly (fp8: scales
    per tensor, or a row block that would straddle the seam)."""
    if a is None or b is None or type(a) is not type(b):
        return None
    if isinstance(a, PlainTensor):
        return PlainTensor(data=torch.cat([a.data, b.data], dim=dim))
    if isinstance(a, Fp8Tensor):
        if tuple(a.block_size) != tuple(b.block_size) or a.per_tensor:
            return None
        b0 = a.block_size[0]
        if dim == -2 and (a.shape[-2] % b0 or b.shape[-2] % b0):
            return None
        return Fp8Tensor(
            data=torch.cat([a.data.view(torch.uint8), b.data.view(torch.uint8)],
                           dim=dim).view(torch.float8_e5m2),
            scale=torch.cat([a.scale, b.scale], dim=dim), block_size=a.block_size)
    if isinstance(a, (*PACKED, *TURBO)):
        # every plane scales with the rows (and the experts), as the JAX
        # _qt_concat_rows / _qt_concat0 concatenate each field
        return type(a)(*(torch.cat([getattr(a, f.name), getattr(b, f.name)], dim=dim)
                         for f in dataclasses.fields(a)))
    if a.off != b.off or (a.c is None) != (b.c is None):
        return None
    return KNibbleTensor(
        p=torch.cat([a.p, b.p], dim=dim), a=torch.cat([a.a, b.a], dim=dim),
        c=None if a.c is None else torch.cat([a.c, b.c], dim=dim), off=a.off)


def fuse_layer(lp: LayerParams, cfg: ModelConfig) -> LayerParams:
    """``fuse_projections`` for one layer."""
    w13 = _concat(lp.w1, lp.w3, -2)
    wcr = _concat(lp.wq_rope_b, lp.wc, -2)
    wkvq = _concat(lp.wkv_a, lp.wq_a, -2)
    attn = dict(
        wcr=wcr, wq_rope_b=None if wcr is not None else lp.wq_rope_b,
        wc=None if wcr is not None else lp.wc,
        wkvq=wkvq, wkv_a=None if wkvq is not None else lp.wkv_a,
        wq_a=None if wkvq is not None else lp.wq_a)
    ns, m = cfg.n_shared_experts, cfg.moe_intermediate_size
    if (lp.moegate is not None and w13 is not None and ns > 0
            and lp.shared_w1 is not None and lp.shared_w1.shape[-2] == ns * m):
        w2sh = cols_to_experts(lp.shared_w2, ns, m)
        sh1, sh3 = (rows_to_experts(t, ns) for t in (lp.shared_w1, lp.shared_w3))
        sh13 = None if sh1 is None or sh3 is None else _concat(sh1, sh3, -2)
        if w2sh is not None and sh13 is not None:
            return dataclasses.replace(
                lp, w13s=_concat(w13, sh13, 0), w2s=_concat(lp.w2, w2sh, 0),
                w1=None, w2=None, w3=None, shared_w1=None, shared_w2=None,
                shared_w3=None, **attn)
    s13 = _concat(lp.shared_w1, lp.shared_w3, -2)
    return dataclasses.replace(
        lp, w13=w13, w1=None if w13 is not None else lp.w1,
        w3=None if w13 is not None else lp.w3, shared_w13=s13,
        shared_w1=None if s13 is not None else lp.shared_w1,
        shared_w3=None if s13 is not None else lp.shared_w3, **attn)


def fuse_projections(params: ModelParams, cfg: ModelConfig) -> ModelParams:
    """Concatenate projection pairs that read the same activation
    ([w1;w3], [shared_w1;shared_w3], [wq_rope_b;wc], [wkv_a;wq_a]) so one
    kernel launch and one weight sweep replace two, and fold the shared
    experts into the routed tables where the layout allows (plain weights,
    blockwise fp8 whose blocks divide the expert width, Q2_K turbo when 256
    divides it). The component fields become None.

    With ``DSEEK_FUSED_FFN`` set (the JAX package's opt-in, read here once
    a call, i.e. once at ``Engine.__init__``) the nibble expert [w1;w3]
    tables also take the row-permuted layout (``rowperm_expert_w13``); the
    tables' ``rowperm`` then chooses the fused expert FFN (K7) and the
    prepermuted w2 products, and the variable is never read again."""
    mtp = params.mtp
    if mtp is not None:
        mtp = dataclasses.replace(mtp, block=fuse_layer(mtp.block, cfg))
    fused = dataclasses.replace(params, layers=[fuse_layer(lp, cfg)
                                                for lp in params.layers], mtp=mtp)
    if os.environ.get("DSEEK_FUSED_FFN"):
        fused = rowperm_expert_w13(fused, cfg)
    return fused


def _rowperm_qt(qt: KNibbleTensor, halves: int, undo: bool) -> KNibbleTensor:
    """Permute a nibble table's OUT rows stride-16 per contiguous part
    (``deepseek_tpu/models/loader.py::_rowperm_qt``; a reshape and
    transpose of p, a and c, which share the row axis -2): stored position
    o*(mh/16) + g of a part holds natural row g*16 + o. ``undo`` restores
    the natural rows."""
    rows = qt.p.shape[-2]
    mh = rows // halves
    if rows % halves or mh % 16:
        raise ValueError(f"rowperm: {rows} rows do not split into {halves} "
                         "parts of a multiple of 16")

    def perm(t):
        *lead, _, cols = t.shape
        split = (halves, 16, mh // 16) if undo else (halves, mh // 16, 16)
        return t.reshape(*lead, *split, cols).transpose(-3, -2) \
            .reshape(*lead, rows, cols)

    return KNibbleTensor(p=perm(qt.p), a=perm(qt.a),
                         c=None if qt.c is None else perm(qt.c), off=qt.off,
                         rowperm=0 if undo else halves)


def rowperm_expert_w13(params: ModelParams, cfg: ModelConfig,
                       undo: bool = False) -> ModelParams:
    """Apply (or ``undo``) the stride-16 row permutation of the fused expert
    [w1;w3] nibble tables (w13s and w13: 3-D, rows % 32 == 0), as
    ``deepseek_tpu/models/loader.py::rowperm_expert_w13`` does: the w13
    products then leave h in the permuted activation order that the w2
    kernels and K7 take. Reads no environment variable."""
    def layer(lp: LayerParams) -> LayerParams:
        rep = {}
        for f in ("w13s", "w13"):
            qt = getattr(lp, f)
            if (isinstance(qt, KNibbleTensor) and qt.p.dim() == 3
                    and bool(qt.rowperm) == undo and qt.p.shape[-2] % 32 == 0):
                rep[f] = _rowperm_qt(qt, 2, undo)
        return dataclasses.replace(lp, **rep) if rep else lp

    mtp = params.mtp
    if mtp is not None:
        mtp = dataclasses.replace(mtp, block=layer(mtp.block))
    return dataclasses.replace(params, layers=[layer(lp) for lp in params.layers],
                               mtp=mtp)


# ---------------------------------------------------------------------------
# params carried across from the JAX package
# ---------------------------------------------------------------------------

def _weight_from_reference(obj, device):
    kind = type(obj).__name__
    if kind == "PlainTensor":
        return PlainTensor(data=_to_torch(obj.data).to(device))
    if kind == "KNibbleTensor":
        return KNibbleTensor(
            p=_to_torch(obj.p).to(device), a=_to_torch(obj.a).to(device),
            c=None if obj.c is None else _to_torch(obj.c).to(device),
            off=int(obj.off), rowperm=int(getattr(obj, "rowperm", 0)))
    classes = {c.__name__: c for c in (*PACKED, *TURBO)}
    if kind in classes:
        cls = classes[kind]
        return cls(*(_to_torch(getattr(obj, f.name)).to(device)
                     for f in dataclasses.fields(cls)))
    if kind == "Fp8Tensor":
        return Fp8Tensor(data=_to_torch(obj.data).view(torch.uint8).to(device)
                         .view(torch.float8_e5m2),
                         scale=_to_torch(obj.scale).float().to(device),
                         block_size=tuple(int(b) for b in obj.block_size))
    raise NotImplementedError(f"weight layout {kind} is not ported yet")


def _layer_from_reference(lp, device) -> LayerParams:
    kw = {}
    for f in dataclasses.fields(LayerParams):
        v = getattr(lp, f.name, None)
        if v is None:
            kw[f.name] = None
        elif dataclasses.is_dataclass(v):
            kw[f.name] = _weight_from_reference(v, device)
        else:
            kw[f.name] = _to_torch(v).float().to(device)
    return LayerParams(**kw)


def params_from_reference(obj, device="cpu") -> ModelParams:
    """The JAX package's ``ModelParams`` (fused or not, unstacked layers)
    -> the port's, walking dataclass fields and type names and reading each
    leaf through ``np.asarray`` — no import of JAX or of deepseek_tpu."""
    layers = []
    for lp in obj.layers:
        if type(lp).__name__ != "LayerParams":
            raise NotImplementedError(
                f"{type(lp).__name__} layer groups (scan stacking) have no "
                "counterpart in the port (ROADMAP.md queue 1, item 15)")
        layers.append(_layer_from_reference(lp, device))
    mtp = getattr(obj, "mtp", None)
    if mtp is not None:
        norm = lambda v: _to_torch(v).float().to(device)
        mtp = MTPParams(enorm=norm(mtp.enorm), hnorm=norm(mtp.hnorm),
                        eh_proj=_weight_from_reference(mtp.eh_proj, device),
                        block=_layer_from_reference(mtp.block, device),
                        final_norm=norm(mtp.final_norm))
    return ModelParams(
        embed=_weight_from_reference(obj.embed, device),
        layers=layers,
        final_norm=_to_torch(obj.final_norm).float().to(device),
        lm_head=_weight_from_reference(obj.lm_head, device), mtp=mtp)


def params_active_bytes(params: ModelParams, cfg: ModelConfig, pos: int = 0) -> float:
    """Bytes one decode token reads (reference active_bytes,
    model.cpp:324-352; ``deepseek_tpu/models/loader.py::
    params_active_bytes``): all dense weights, k routed (+ shared) experts
    per MoE layer, the cache up to kv_len (latent rows for MLA, every
    head's key and value for MHA), one embedding row. Unlike the JAX
    function, an absorbed-MLA model does not count ``wq_b``/``wkv_b``: its
    decode never reads them (ROADMAP.md queue 3)."""
    def nb(t):
        if t is None:
            return 0
        if isinstance(t, torch.Tensor):
            return t.numel() * t.element_size()
        return t.nbytes_active

    kv_len = min(pos + 1, cfg.kv_window)
    itemsize = _TORCH_DTYPES[str(cfg.kv_cache_dtype)].itemsize \
        if str(cfg.kv_cache_dtype) in _TORCH_DTYPES else 1
    if cfg.use_mla:
        kv = kv_len * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * itemsize
        attn = ("wq_a", "wc", "wq_rope_b", "wv_b", "wcr", "wkvq")
    else:
        kv = kv_len * cfg.n_heads * (cfg.head_dim + cfg.v_head_dim) * itemsize
        attn = ("wq", "wq_a", "wq_b", "wkv_b", "wkvq")
    total = nb(params.embed) / params.embed.shape[0] + nb(params.final_norm) \
        + nb(params.lm_head)
    for l, lp in enumerate(params.layers):
        total += kv
        for f in ("attn_norm", "ffn_norm", "kv_a_norm", "q_a_norm", "wkv_a",
                  "wo", *attn, "moegate", "moegate_bias", "shared_w1",
                  "shared_w2", "shared_w3", "shared_w13"):
            total += nb(getattr(lp, f))
        moe = cfg.is_moe_layer(l)
        frac = cfg.n_active_routed / cfg.n_routed_experts if moe else 1.0
        for f in ("w1", "w2", "w3", "w13"):
            total += nb(getattr(lp, f)) * frac
        if lp.w13s is not None:
            ns = cfg.n_shared_experts
            frac_s = (cfg.n_active_routed + ns) / (cfg.n_routed_experts + ns)
            total += (nb(lp.w13s) + nb(lp.w2s)) * frac_s
    return float(total)


def params_bits_per_weight(params: ModelParams) -> float:
    """Storage bits per weight over the weight tensors as loaded
    (``deepseek_tpu/models/loader.py::params_bits_per_weight``; the
    reference's stat line, codec.cpp:40-66): every plane's bytes over the
    logical elements, at the runtime layout (packed, nibble, turbo, fp8
    with its scales, plain). The embedding, the lm_head (counted again
    where tied to it, as the JAX tree walk counts it), every layer and the
    MTP layer count; norms and router weights are no weight tensors."""
    def weights(lp: LayerParams):
        return [v for v in (getattr(lp, f.name) for f in dataclasses.fields(lp))
                if dataclasses.is_dataclass(v)]

    tensors = [params.embed, params.lm_head]
    for lp in params.layers:
        tensors += weights(lp)
    if params.mtp is not None:
        tensors += [params.mtp.eh_proj, *weights(params.mtp.block)]
    bits = weights_n = 0.0
    for qt in tensors:
        bits += 8.0 * sum(t.numel() * t.element_size()
                          for t in (getattr(qt, f.name) for f in dataclasses.fields(qt))
                          if isinstance(t, torch.Tensor))
        weights_n += float(np.prod(qt.shape, dtype=np.float64))
    return bits / weights_n if weights_n else 0.0
