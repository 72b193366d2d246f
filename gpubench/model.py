"""The system under test, built from a configuration file and a seed: the
port's ``ModelConfig``, its weights (the benchmark's draw handed through the
loader's fusion, ``models/loader.py::fuse_layer``, the per-layer body of
``fuse_projections``), a tokenizer and ``Engine.from_params``."""

from __future__ import annotations

import time

import torch

from gpubench import draw


def port_config(spec: dict):
    """The port's ModelConfig for a configuration file."""
    from deepseek_tpu_torch.config import (
        ActivationType, ModelConfig, QuantKind, ScoringFunc, TopKMethod,
    )
    run, rs = spec["run"], spec["rope_scaling"]
    v3 = spec["model_type"] == "deepseek_v3"
    return ModelConfig(
        dim=spec["hidden_size"], hidden_dim=spec["intermediate_size"],
        n_layers=spec["num_hidden_layers"], n_heads=spec["num_attention_heads"],
        vocab_size=spec["vocab_size"], max_seq_len=run["max_seq_len"],
        rope_theta=float(spec["rope_theta"]), norm_eps=float(spec["rms_norm_eps"]),
        act=ActivationType(spec["hidden_act"]),
        first_k_dense_replace=spec["first_k_dense_replace"],
        n_shared_experts=spec["n_shared_experts"], n_routed_experts=spec["n_routed_experts"],
        n_active_routed=spec["num_experts_per_tok"],
        moe_intermediate_size=spec["moe_intermediate_size"],
        routed_scaling_factor=float(spec["routed_scaling_factor"]),
        n_group=spec["n_group"], norm_topk_prob=bool(spec["norm_topk_prob"]),
        scoring_func=ScoringFunc(spec["scoring_func"]), topk_group=spec["topk_group"],
        topk_method=TopKMethod(spec["topk_method"]), has_moegate_bias=v3,
        use_mla=bool(run["use_mla"]), kv_lora_rank=spec["kv_lora_rank"],
        q_lora_rank=spec.get("q_lora_rank") or 0,
        qk_nope_head_dim=spec["qk_nope_head_dim"], qk_rope_head_dim=spec["qk_rope_head_dim"],
        v_head_dim=spec["v_head_dim"], weight_quant=QuantKind(run["quant"]),
        block_size=tuple(run.get("block_size", (0, 0))),
        rs_beta_fast=rs["beta_fast"], rs_beta_slow=rs["beta_slow"],
        rs_factor=float(rs["factor"]), rs_mscale=float(rs["mscale"]),
        rs_mscale_all_dim=float(rs["mscale_all_dim"]),
        rs_original_max_position_embeddings=rs["original_max_position_embeddings"],
        arch="DeepseekV3ForCausalLM" if v3 else "DeepseekV2ForCausalLM",
        compute_dtype=run["compute_dtype"], kv_cache_dtype=run["kv_cache_dtype"],
        use_yarn=bool(run["use_yarn"]))


def _weight(fields, run: dict):
    """The port's weight tensor over a draw's stored fields."""
    from deepseek_tpu_torch.quant.qtensor import Fp8Tensor, Q3KTensor
    if run["quant"] == "q3_k":
        return Q3KTensor(**fields)
    data, scale = fields
    return Fp8Tensor(data=data.view(torch.float8_e5m2), scale=scale,
                     block_size=tuple(run["block_size"]))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def port_params(spec: dict, cfg, seed: int, device, times=None):
    """The draw of ``seed`` as the port's fused ModelParams, a layer at a
    time (the unfused layer is dropped once fused). ``times`` (a dict) gets
    the seconds spent drawing (``weights_drawn``) and fusing
    (``loader_fused``)."""
    from deepseek_tpu_torch.models.loader import fuse_layer
    from deepseek_tpu_torch.models.params import LayerParams, ModelParams

    run, hf = spec["run"], spec
    ones = lambda n: torch.ones(n, device=device)   # noqa: E731
    layers = []
    t_draw = t_fuse = 0.0
    t = _sync(device)
    for l in range(hf["num_hidden_layers"]):
        kw = {w.name.split(".", 1)[1]: _weight(draw.draw(seed, w, run, device), run)
              for w in draw.attention_weights(hf, run, l) + draw.ffn_weights(hf, l)}
        if draw.is_moe(hf, l):
            kw["moegate"] = draw.router(seed, f"l{l}.moegate", hf["n_routed_experts"],
                                        hf["hidden_size"], device)
            kw["moegate_bias"] = draw.gate_bias(hf, device)
        ql = hf.get("q_lora_rank") or 0
        lp = LayerParams(attn_norm=ones(hf["hidden_size"]), ffn_norm=ones(hf["hidden_size"]),
                         kv_a_norm=ones(hf["kv_lora_rank"]),
                         q_a_norm=ones(ql) if ql and run["use_mla"] else None, **kw)
        t1 = _sync(device)
        layers.append(fuse_layer(lp, cfg))
        del kw, lp
        t2 = _sync(device)
        t_draw, t_fuse, t = t_draw + t1 - t, t_fuse + t2 - t1, t2
    embed = _weight(draw.draw(seed, draw.embed_weight(hf), run, device), run)
    head = _weight(draw.draw(seed, draw.head_weight(hf), run, device), run)
    t_draw += _sync(device) - t
    if times is not None:
        times["weights_drawn"], times["loader_fused"] = t_draw, t_fuse
    return ModelParams(embed=embed, layers=layers, final_norm=ones(hf["hidden_size"]),
                       lm_head=head)


def port_tokenizer(vocab_size: int):
    """A byte-fallback vocabulary of the configuration's size. No id is the
    end of sequence: every request generates the tokens it asks for, as
    serving benchmarks ignore EOS, so the work is the traffic's."""
    from deepseek_tpu_torch.tokenizer import Tokenizer
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{i:02X}>".encode() for i in range(256)]
    vocab += [f"t{i}".encode() for i in range(len(vocab), vocab_size)]
    return Tokenizer(vocab, bos_id=1, eos_id=-1)


def port_engine(spec: dict, seed: int, device, prefill_chunk: int, times=None):
    """(Engine.from_params over the draw, ModelConfig); ``times`` as
    ``port_params`` fills it, and ``engine`` (the tokenizer and the Engine)."""
    from deepseek_tpu_torch.engine import Engine
    cfg = port_config(spec)
    params = port_params(spec, cfg, seed, device, times)
    t = time.perf_counter()
    eng = Engine.from_params(params, cfg, port_tokenizer(cfg.vocab_size),
                             seed=draw.tensor_seed(seed, "sampler") % (1 << 31),
                             prefill_chunk=prefill_chunk)
    if times is not None:
        times["engine"] = time.perf_counter() - t
    return eng, cfg
