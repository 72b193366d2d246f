"""The numerics of K11 on the tensor cores (``csrc/gmm.cu``) against the
JAX package, on the CPU.

The kernel computes ``gmm_plain``'s function (each group's rows against
its table, cast first to the rows' dtype, the compute dtype) with bf16
operands and f32 accumulators: the table rounded to bf16 (nearest-even)
where it is f16 or f32 and the compute dtype bf16; in f32 compute the
rows split into bf16 hi + lo, and an f16 or f32 table too, with the
passes W.x_hi + W.x_lo (bf16 table) or W_hi.x_hi + W_hi.x_lo + W_lo.x_hi
(f16/f32), summed a 16-column k-step at a time. ``_emulate`` repeats that
arithmetic in float32 torch (a product of two bf16 values is exact in
f32, as on the tensor cores), walking the tiles as the kernel does
(``gmm_tiles``), and must agree with megablox.gmm in interpret mode, the
TPU kernel as grouped_expert_ffn calls it, at 1e-4 of max|ref|: the
tolerance of every check of the kernel on the card. A negative control
pins why the rows are split in f32 compute: one bf16 pass misses 1e-4 on
the same inputs. The emulation is test-local; ``gmm_plain`` stays f32.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import megablox

import deepseek_tpu_torch.ops.kernels.qmm as wrapper
from deepseek_tpu_torch.ops.kernels.qmm import _GMM_ROWS, gmm, gmm_tiles
from tests.test_torch_threads import one_torch_thread  # noqa: F401

PAIRS = [("bfloat16", "bfloat16"), ("bfloat16", "float16"), ("bfloat16", "float32"),
         ("float32", "bfloat16"), ("float32", "float16"), ("float32", "float32")]
# 384 rows over 6 groups, the last carrying 63 slack rows (grouped_expert_ffn
# pads the pairs to a multiple of 128 and adds the rest to the last group):
# two empty groups, a one-row group that starts inside a 64-row tile, a
# group of 150 rows over three tiles, a group of 70 over two
SIZES = np.asarray([0, 70, 1, 0, 150, 163], np.int32)
M, N, K = 384, 256, 1408            # K: DeepSeek-V2-Lite's w2 (k % 64 == 0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split(x: torch.Tensor):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _terms(lhs: torch.Tensor, w: torch.Tensor, split_x: bool = True):
    """The (table term, x term) pairs of the kernel's passes."""
    if lhs.dtype == torch.bfloat16:              # bf16 compute: one pass
        return [(_bf16(w.float()), lhs.float())]
    xs = _split(lhs.float()) if split_x else (_bf16(lhs.float()),)
    if w.dtype == torch.bfloat16:
        return [(w.float(), x) for x in xs]
    wh, wl = _split(w.float())
    pairs = [(wh, x) for x in xs]
    return pairs + [(wl, xs[0])] if split_x else pairs


def _tile_of(group_off, tile_off, g, rows):
    """The kernel's tile_of: (group, first row, live rows), or None."""
    E = len(group_off) - 1
    if g >= tile_off[E]:
        return None
    e = max(i for i in range(E) if tile_off[i] <= g)
    r0 = group_off[e] + (g - tile_off[e]) * _GMM_ROWS
    nr = min(_GMM_ROWS, group_off[e + 1] - r0, rows - r0)
    return (e, r0, nr) if nr > 0 else None


def _emulate(lhs: torch.Tensor, rhs: torch.Tensor, sizes, split_x: bool = True):
    """K11's arithmetic over its tiles; rows no tile writes stay NaN."""
    group_off, tile_off = (t.tolist() for t in gmm_tiles(torch.from_numpy(sizes)))
    E, n, k = rhs.shape
    y = torch.full((lhs.shape[0], n), float("nan"))
    for g in range(E + -(-lhs.shape[0] // _GMM_ROWS)):     # the launched tiles
        t = _tile_of(group_off, tile_off, g, lhs.shape[0])
        if t is None:
            continue
        e, r0, nr = t
        assert torch.isnan(y[r0:r0 + nr]).all()           # each row once
        acc = torch.zeros((nr, n))
        for k0 in range(0, k, 16):
            for wt, xt in _terms(lhs[r0:r0 + nr, k0:k0 + 16], rhs[e][:, k0:k0 + 16],
                                 split_x):
                acc += xt @ wt.t()
        y[r0:r0 + nr] = acc
    return y


def _inputs(x_dtype, w_dtype, sizes=SIZES, m=M, seed=0):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((m, K)).astype(np.float32)
    rhs = (rng.standard_normal((len(sizes), N, K)) * 0.1).astype(np.float32)
    lj = jnp.asarray(lhs, x_dtype)
    rj = jnp.asarray(rhs, w_dtype)
    lt = torch.from_numpy(np.array(lj.astype(jnp.float32))).to(getattr(torch, x_dtype))
    rt = torch.from_numpy(np.array(rj.astype(jnp.float32))).to(getattr(torch, w_dtype))
    return lj, rj, lt, rt


def _megablox(lj, rj, sizes):
    """megablox.gmm as grouped_expert_ffn calls it: the table cast to the
    compute dtype, f32 output."""
    return np.asarray(megablox.gmm(lj, rj.astype(lj.dtype), jnp.asarray(sizes),
                                   preferred_element_type=jnp.float32,
                                   transpose_rhs=True, tiling=(128, K, N),
                                   interpret=True))


_REFS = {}


def _case(x_dtype, w_dtype):
    if (x_dtype, w_dtype) not in _REFS:
        lj, rj, lt, rt = _inputs(x_dtype, w_dtype)
        _REFS[x_dtype, w_dtype] = (_megablox(lj, rj, SIZES), lt, rt)
    return _REFS[x_dtype, w_dtype]


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("x_dtype,w_dtype", PAIRS)
def test_kernel_arithmetic_matches_megablox(x_dtype, w_dtype):
    """Every (rows, table) dtype pair, with empty groups, a one-row group
    inside a tile, groups over several tiles, slack rows and k = 1408:
    the emulated kernel within 1e-4 of max|ref| of megablox.gmm, and
    every row written once."""
    want, lt, rt = _case(x_dtype, w_dtype)
    got = _emulate(lt, rt, SIZES).numpy()
    assert not np.isnan(got).any()
    assert _rel_err(got, want) <= 1e-4
    # the plain version (the card's oracle) agrees with both
    plain = gmm(lt, rt, torch.from_numpy(SIZES)).numpy()
    assert _rel_err(plain, want) <= 1e-4


@pytest.mark.parametrize("w_dtype", ["bfloat16", "float16", "float32"])
def test_single_pass_bf16_rows_miss_the_tolerance(w_dtype):
    """Negative control: f32 rows rounded to bf16 once (one pass, as the
    TPU's DEFAULT precision would) miss 1e-4 of max|ref| on the same
    inputs, so the kernel keeps their lo terms in f32 compute."""
    want, lt, rt = _case("float32", w_dtype)
    single = _emulate(lt, rt, SIZES, split_x=False).numpy()
    assert _rel_err(single, want) > 1e-4


def test_rows_past_the_groups_are_left_unwritten():
    """Groups that end before the last row: the tiles cover the groups'
    rows only, and those agree with megablox.gmm's."""
    sizes = np.asarray([5, 0, 64, 65, 1], np.int32)          # 135 of 256 rows
    lj, rj, lt, rt = _inputs("bfloat16", "float16", sizes, m=256, seed=1)
    got = _emulate(lt, rt, sizes).numpy()
    live = int(sizes.sum())
    assert np.isnan(got[live:]).all() and not np.isnan(got[:live]).any()
    want = _megablox(lj, rj, sizes)
    assert _rel_err(got[:live], want[:live]) <= 1e-4


def test_gmm_tiles():
    """The tile offsets: a group of s rows takes ceil(s / 64) tiles, an
    empty group none."""
    group_off, tile_off = gmm_tiles(torch.tensor([0, 70, 1, 0, 150, 163]))
    assert group_off.tolist() == [0, 0, 70, 71, 71, 221, 384]
    assert tile_off.tolist() == [0, 0, 2, 3, 3, 6, 9]
    assert group_off.dtype == tile_off.dtype == torch.int32


def test_wrapper_constants_match_the_kernel():
    """The wrapper's tile rows and dtype codes are csrc/gmm.cu's (kBN; the
    table's switch), its k alignment is the kernel's k-step, and the tile
    GEMM's _TILE is csrc/qmm_tiles.cu's kBM."""
    csrc = Path(wrapper.__file__).resolve().parents[2] / "csrc"
    src = (csrc / "gmm.cu").read_text()

    def const(pattern, text=src):
        return int(re.search(pattern, text).group(1))

    assert wrapper._GMM_ROWS == const(r"constexpr int kBN = (\d+);")
    assert const(r"constexpr int kBK = (\d+);") == 64
    cases = dict(re.findall(r"case (\d): return launch<XT, ([\w:]+)>", src))
    assert cases == {"0": "float", "1": "__half", "2": "__nv_bfloat16"}
    assert wrapper._GMM_DTYPE == {torch.float32: 0, torch.float16: 1,
                                  torch.bfloat16: 2}
    assert wrapper._TILE == const(r"constexpr int kBM = (\d+);",
                                  (csrc / "qmm_tiles.cu").read_text())
