"""How far the JAX package's own shard_map forward at tensor=2 (and
expert=2) lies from its unsharded forward, on the tiny checkpoints of
``tests/test_torch_tensor_expert.py``: packed, nibble and turbo Q3_K (MLA)
and F8E5M2 with 32x32 blocks and an 80-wide dense hidden (MHA). Runs on
the CPU over 8 virtual devices:

    python scripts/jax_tensor_split_check.py [q3k] [fp8]

The JAX ``parallel/sharding.py::_fit`` cuts each field of a weight on its
own: a stride-16 permuted K-quant plane is cut in its stored order (not
the natural columns its scales and activations follow), and an fp8 scale
grid that does not divide by the axis stays whole beside a cut data
block. Where that happens the sharded forward computes another function
(a difference of the order of the logits themselves); the port's
``quant/qtensor.py::slice_qt`` cuts every field at one natural boundary
instead, or keeps the projection group whole. Prints one line per
(checkpoint, runtime layout, mesh): max|sharded - unsharded| /
max|unsharded| over the logits of an 8-token prefill chunk in f32
compute, or the exception the sharded forward raised.
"""

import dataclasses
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main(kinds):
    jax.config.update("jax_num_cpu_devices", 8)
    from deepseek_tpu.engine import Engine
    from deepseek_tpu.models import init_cache, make_forward
    from deepseek_tpu.parallel.mesh import make_mesh
    from deepseek_tpu.parallel.sharding import shard_cache, shard_params
    from tests.test_torch_tensor_expert import _convert

    root = tempfile.mkdtemp(prefix="jax_tensor_split_")
    toks = jnp.asarray([[5, 17, 40, 99, 3, 8, 250, 11]], jnp.int32)
    for kind in kinds:
        ck = _convert(root, kind)
        runtimes = (None, "nibble", "turbo") if kind == "q3k" else (None,)
        for runtime in runtimes:
            eng = Engine(ck, seed=0, **({"kquant_runtime": runtime} if runtime else {}))
            cfg = dataclasses.replace(eng.cfg, compute_dtype="float32")
            want, _ = make_forward(cfg, prefill=True, logits_mode="all")(
                eng.params, init_cache(cfg), toks, 0)
            for shape in (dict(tensor=2), dict(expert=2)):
                mesh = make_mesh(**shape)
                label = f"{kind} {runtime or 'default'} {shape}"
                try:
                    sc = shard_cache(init_cache(cfg), cfg, mesh)
                    fwd = make_forward(cfg, prefill=True, logits_mode="all", mesh=mesh,
                                       params=eng.params, cache=sc)
                    got, _ = fwd(shard_params(eng.params, cfg, mesh), sc, toks, 0)
                    err = float(jnp.abs(got - want).max() / jnp.abs(want).max())
                    print(f"{label}: max|sharded - unsharded| / max|unsharded| {err:.3e}",
                          flush=True)
                except Exception as exc:     # reported: the check is what it raises
                    print(f"{label}: raises {type(exc).__name__}: {str(exc)[:200]}",
                          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["q3k", "fp8"])
