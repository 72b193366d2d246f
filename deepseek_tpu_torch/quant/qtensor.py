"""Weight tensors of the port: plain, F8E5M2, K-quant packed and nibble.

The counterparts of ``deepseek_tpu/quant/qtensor.py``'s ``PlainTensor``,
``Fp8Tensor``, ``Q2KTensor``, ``Q3KTensor``, ``Q2KTurboTensor``,
``Q3KTurboTensor`` and ``KNibbleTensor`` with the same fields, dtypes and
layouts, so a test can hand the same planes to both packages. A projection is stored as ``W (out, in)`` and applied as
``y = x @ W.T``.

Packed layout (quant.repack, the default K-quant runtime): 2-bit planes
``qs`` (byte j, bits 2s..2s+1 = permuted column s*(n/4) + j), Q3_K's 1-bit
plane ``hm`` (byte j, bit b = permuted column b*(n/8) + j), per-16-group
scale bytes in natural group order and f32 super scales per 256 columns.

Nibble layout: unsigned ``u = q + off`` stored two per byte in the stride-16
PERMUTED column order (quant.repack): the low nibble of byte j is permuted
column j, the high nibble permuted column j + n/2, and permuted position
``o*(n/16) + g`` holds natural column ``g*16 + o``. Each 16-column group g
has one bf16 scale ``a[g]``; the signed or min offset is applied on the
output side against the activations' per-16 group sums ``s16``:

    y = sum_c x_c * a_g(c) * u_c  -  sum_g s16_g * (off*a_g + c_g)

(Q2_K: off=0, c = dmin*mn; Q3_K: off=4, c=None.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from deepseek_tpu_torch.quant.repack import stride16_inv_perm, stride16_perm


@dataclasses.dataclass
class PlainTensor:
    """Unquantized weight (f32 / f16 / bf16)."""

    data: torch.Tensor  # (..., out, in)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def nbytes_active(self) -> int:
        return self.data.numel() * self.data.element_size()

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return self.data.to(dtype)


@dataclasses.dataclass
class Fp8Tensor:
    """F8E5M2 weight with a blockwise (or per-tensor) inverse-scale grid.
    The grid is ceil-sized: an edge block may be partial (a 576-row
    weight has 5 row blocks of 128)."""

    data: torch.Tensor   # (..., out, in) float8_e5m2
    scale: torch.Tensor  # (..., ceil(out/b0), ceil(in/b1)) f32; per-tensor:
                         # a scalar, (1,), or (E, 1, 1) over an expert stack
    block_size: Tuple[int, int] = (0, 0)   # (0, 0) = per-tensor

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def per_tensor(self) -> bool:
        return tuple(self.block_size) == (0, 0)

    @property
    def nbytes_active(self) -> int:
        return self.data.numel() + self.scale.numel() * 4

    def map(self, fn) -> "Fp8Tensor":
        """Apply ``fn`` to the data (as its raw bytes: not every torch op
        has a float8 kernel) and the scale grid: expert gathers, reshapes,
        device moves."""
        data = fn(self.data.view(torch.uint8)).view(torch.float8_e5m2)
        return Fp8Tensor(data=data, scale=fn(self.scale),
                         block_size=tuple(self.block_size))

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        w = self.data.to(dtype)
        if self.per_tensor:
            return w * self.scale.to(dtype)
        b0, b1 = self.block_size
        d, n = self.shape[-2:]
        s = self.scale.repeat_interleave(b0, dim=-2)[..., :d, :]
        s = s.repeat_interleave(b1, dim=-1)[..., :n]
        return w * s.to(dtype)

    def gather_rows(self, rows: torch.Tensor) -> "Fp8Tensor":
        """The weight rows ``rows`` (...,) of a 2-D weight, each with its own
        scale row: (..., n) data under a (1, b1) grid (an embedding
        lookup)."""
        data = self.data.view(torch.uint8)[rows].view(torch.float8_e5m2)
        if self.per_tensor:
            return Fp8Tensor(data=data, scale=self.scale, block_size=(0, 0))
        b0, b1 = self.block_size
        return Fp8Tensor(data=data, scale=self.scale[rows // b0],
                         block_size=(1, b1))


def _unpack_planes(planes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., d, n*bits/8) 2-bit (bits=2) or 1-bit planes -> (..., d, n)
    values in the NATURAL column order."""
    mask = (1 << bits) - 1
    return unperm_x(torch.cat([(planes >> s) & mask for s in range(0, 8, bits)], dim=-1))


def _rep16(t: torch.Tensor) -> torch.Tensor:
    return t.repeat_interleave(16, dim=-1)


@dataclasses.dataclass
class Q2KTensor:
    """Q2_K weight in the packed plane layout: w = d*sc*q - dmin*mn."""

    qs: torch.Tensor     # (..., out, in//4) uint8: 4 plane-packed 2-bit quants
    sm: torch.Tensor     # (..., out, in//16) uint8: sc | mn << 4
    d: torch.Tensor      # (..., out, in//256) f32 super scale
    dmin: torch.Tensor   # (..., out, in//256) f32 super min scale

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.qs.shape[:-1]) + (self.qs.shape[-1] * 4,)

    @property
    def nbytes_active(self) -> int:
        return self.qs.numel() + self.sm.numel() + 4 * (self.d.numel() + self.dmin.numel())

    def map(self, fn) -> "Q2KTensor":
        """Apply ``fn`` to every plane (row slices, expert gathers, moves)."""
        return Q2KTensor(qs=fn(self.qs), sm=fn(self.sm), d=fn(self.d),
                         dmin=fn(self.dmin))

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        q = _unpack_planes(self.qs, 2).to(dtype)
        scale = _rep16(self.d.to(dtype)) * (self.sm & 0xF).to(dtype)
        minv = _rep16(self.dmin.to(dtype)) * (self.sm >> 4).to(dtype)
        return _rep16(scale) * q - _rep16(minv)


@dataclasses.dataclass
class Q3KTensor:
    """Q3_K weight in the packed plane layout: w = d*sc*(qlow + 4*hbit - 4)."""

    qs: torch.Tensor   # (..., out, in//4) uint8: low 2 bits, plane-packed
    hm: torch.Tensor   # (..., out, in//8) uint8: high bit, plane-packed
    sc: torch.Tensor   # (..., out, in//16) int8: signed 6-bit scale (already -32)
    d: torch.Tensor    # (..., out, in//256) f32 super scale

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.qs.shape[:-1]) + (self.qs.shape[-1] * 4,)

    @property
    def nbytes_active(self) -> int:
        return self.qs.numel() + self.hm.numel() + self.sc.numel() + 4 * self.d.numel()

    def map(self, fn) -> "Q3KTensor":
        """Apply ``fn`` to every plane (row slices, expert gathers, moves)."""
        return Q3KTensor(qs=fn(self.qs), hm=fn(self.hm), sc=fn(self.sc), d=fn(self.d))

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        qlow = _unpack_planes(self.qs, 2).to(torch.int8)
        hbit = _unpack_planes(self.hm, 1).to(torch.int8)
        q = (qlow + (hbit << 2) - 4).to(dtype)
        scale = _rep16(self.d.to(dtype)) * self.sc.to(dtype)
        return _rep16(scale) * q


PACKED = (Q2KTensor, Q3KTensor)


@dataclasses.dataclass
class Q2KTurboTensor:
    """Q2_K expanded at load to a pre-scaled int8 plane ("turbo"), in the
    NATURAL column order: p = sc*q (0..45, exact in int8), so a superblock
    is 256 contiguous columns and

        y = sum_sb d[:, sb] * (x_sb . p_sb) - sum_g s16_g * bm_g

    with s16 the activations' per-16 group sums. 9.125 bits a weight."""

    p: torch.Tensor    # (..., out, in) int8 = sc*q, natural column order
    d: torch.Tensor    # (..., out, in//256) f32 super scale
    bm: torch.Tensor   # (..., out, in//16) bf16 = dmin*mn, the min term

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.p.shape)

    @property
    def nbytes_active(self) -> int:
        return self.p.numel() + 4 * self.d.numel() + 2 * self.bm.numel()

    def map(self, fn) -> "Q2KTurboTensor":
        """Apply ``fn`` to every plane (row slices, expert gathers, moves)."""
        return Q2KTurboTensor(p=fn(self.p), d=fn(self.d), bm=fn(self.bm))

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        w = self.d.to(dtype).repeat_interleave(256, dim=-1) * self.p.to(dtype)
        return w - _rep16(self.bm.to(dtype))


@dataclasses.dataclass
class Q3KTurboTensor:
    """Q3_K expanded at load to an int8 quant plane with fused per-16
    scales ("turbo"): p = qlow + 4*hbit - 4 in [-4, 3], a = d*sc, in the
    stride-16 PERMUTED column order, where position c' belongs to scale
    group c' mod (in/16): w = a[c' mod in/16] * p[c']. 9 bits a weight."""

    p: torch.Tensor    # (..., out, in) int8, permuted column order
    a: torch.Tensor    # (..., out, in//16) bf16 = d*sc

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.p.shape)

    @property
    def nbytes_active(self) -> int:
        return self.p.numel() + 2 * self.a.numel()

    def map(self, fn) -> "Q3KTurboTensor":
        """Apply ``fn`` to every plane (row slices, expert gathers, moves)."""
        return Q3KTurboTensor(p=fn(self.p), a=fn(self.a))

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        reps = (1,) * (self.a.dim() - 1) + (16,)
        return unperm_x(self.a.to(dtype).repeat(reps) * self.p.to(dtype))


TURBO = (Q2KTurboTensor, Q3KTurboTensor)


def q2k_to_turbo(qt: Q2KTensor) -> Q2KTurboTensor:
    """Packed Q2_K planes -> the turbo layout, on the planes' device
    (``deepseek_tpu/quant/qtensor.py::q2k_to_turbo``): the quants unpacked
    to natural order and multiplied by their 4-bit scales in uint8 (at most
    45), the min term dmin*mn made in f32 and stored bf16."""
    q = _unpack_planes(qt.qs, 2)                         # natural, uint8 0..3
    p = (_rep16(qt.sm & 0xF) * q).to(torch.int8)
    bm = _rep16(qt.dmin.float()) * (qt.sm >> 4).float()
    return Q2KTurboTensor(p=p, d=qt.d.float().contiguous(), bm=bm.to(torch.bfloat16))


def q3k_to_turbo(qt: Q3KTensor) -> Q3KTurboTensor:
    """Packed Q3_K planes -> the turbo layout, on the planes' device
    (``deepseek_tpu/quant/qtensor.py::q3k_to_turbo``): the plane keeps the
    permuted column order, a = d*sc is made in f32 and stored bf16."""
    qlow = torch.cat([(qt.qs >> s) & 3 for s in (0, 2, 4, 6)], dim=-1).to(torch.int8)
    hbit = torch.cat([(qt.hm >> b) & 1 for b in range(8)], dim=-1).to(torch.int8)
    p = qlow + hbit * 4 - 4
    a = _rep16(qt.d.float()) * qt.sc.float()
    return Q3KTurboTensor(p=p, a=a.to(torch.bfloat16))


@dataclasses.dataclass
class KNibbleTensor:
    """K-quant expanded to a 4-bit nibble plane (see the module docstring)."""

    p: torch.Tensor                    # (..., out, in//2) uint8
    a: torch.Tensor                    # (..., out, in//16) bf16 = d*sc
    c: Optional[torch.Tensor] = None   # (..., out, in//16) bf16 min term
    off: int = 0                       # u = q + off
    # rowperm > 0: the OUT rows are stored stride-16 permuted per
    # contiguous part (rowperm = the number of parts; 2 for an expert
    # [w1;w3] table, models/loader.py::rowperm_expert_w13): stored position
    # o*(mh/16) + g of a part holds its natural row g*16 + o. A product
    # against the stored rows lands in the permuted activation order (per
    # part), which the w2 kernels and K7 take as they are. dequant()
    # restores the natural rows.
    rowperm: int = 0

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.p.shape[:-1]) + (self.p.shape[-1] * 2,)

    @property
    def nbytes_active(self) -> int:
        return (self.p.numel() + self.a.numel() * 2
                + (self.c.numel() * 2 if self.c is not None else 0))

    def map(self, fn) -> "KNibbleTensor":
        """Apply ``fn`` to every plane (row slices, device moves)."""
        return KNibbleTensor(p=fn(self.p), a=fn(self.a),
                             c=None if self.c is None else fn(self.c),
                             off=self.off, rowperm=self.rowperm)

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        u = torch.cat([self.p & 0xF, self.p >> 4], dim=-1).to(dtype)
        reps = (1,) * (self.a.dim() - 1) + (16,)
        w = self.a.to(dtype).repeat(reps) * (u - float(self.off))
        if self.c is not None:
            w = w - self.c.to(dtype).repeat(reps)
        w = unperm_x(w)
        if self.rowperm:
            # stored position o*(mh/16) + g of each part holds natural row
            # g*16 + o: the inverse is a (16, mh/16) -> (mh/16, 16) transpose
            *lead, rows, cols = w.shape
            mh = rows // self.rowperm
            w = w.reshape(*lead, self.rowperm, 16, mh // 16, cols) \
                .transpose(-3, -2).reshape(*lead, rows, cols)
        return w

    def stored_rows(self) -> "KNibbleTensor":
        """The same planes read as rows in their stored order (what the
        kernels compute against): rowperm dropped."""
        return dataclasses.replace(self, rowperm=0)


def perm_x(x: torch.Tensor) -> torch.Tensor:
    """Activations (..., n) into the stride-16 permuted order: position
    o*(n/16) + g holds natural column g*16 + o (a (n/16, 16) transpose)."""
    *lead, n = x.shape
    return x.reshape(*lead, n // 16, 16).transpose(-1, -2).reshape(*lead, n)


def unperm_x(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``perm_x``."""
    *lead, n = x.shape
    return x.reshape(*lead, 16, n // 16).transpose(-1, -2).reshape(*lead, n)


def rows_to_experts(qt, ns: int):
    """(ns*m, cols...) -> (ns, m, cols...) for every plane (the shared
    experts' rows, wv_b's per-head blocks; ``deepseek_tpu/ops/matmul.py::
    reshape_rows``); None for an fp8 weight with a per-tensor scale or with
    row blocks that would straddle two parts."""
    if isinstance(qt, Fp8Tensor) and (
            qt.per_tensor or (qt.shape[-2] // ns) % qt.block_size[0]):
        return None
    fn = lambda t: t.reshape(ns, t.shape[0] // ns, *t.shape[1:])
    return PlainTensor(data=fn(qt.data)) if isinstance(qt, PlainTensor) \
        else qt.map(fn)


def cols_to_experts(qt, ns: int, m: int):
    """(dim, ns*m) -> (ns, dim, m) where the columns split cleanly: plain
    weights, blockwise fp8 whose column blocks divide m and Q2_K turbo
    (natural order) when m % 256 == 0 (packed, Q3_K turbo and nibble planes
    interleave columns stride-16, as the JAX ``_qt_split_cols_to_experts``
    says); None otherwise."""
    split = lambda t, c: t.reshape(t.shape[0], ns, c).movedim(1, 0).contiguous()
    if isinstance(qt, PlainTensor):
        return PlainTensor(data=split(qt.data, m))
    if isinstance(qt, Q2KTurboTensor):
        if m % 256:
            return None
        return Q2KTurboTensor(p=split(qt.p, m), d=split(qt.d, m // 256),
                              bm=split(qt.bm, m // 16))
    if isinstance(qt, Fp8Tensor) and not qt.per_tensor and m % qt.block_size[1] == 0:
        return Fp8Tensor(
            data=split(qt.data.view(torch.uint8), m).view(torch.float8_e5m2),
            scale=split(qt.scale, m // qt.block_size[1]), block_size=qt.block_size)
    return None


def _plane_unpack(planes: np.ndarray, bits: int) -> np.ndarray:
    """Shift+concat unpack of 2-bit (bits=2) or 1-bit planes; stays in the
    permuted column order the planes are packed in."""
    mask = (1 << bits) - 1
    return np.concatenate([(planes >> s) & mask for s in range(0, 8, bits)],
                          axis=-1)


def _nibble_pack(u: np.ndarray) -> np.ndarray:
    """Two nibbles per byte, C-contiguous (numpy may hand back another
    memory order from elementwise ops on fancy-indexed planes, and the
    kernels take row-major planes only)."""
    n = u.shape[-1]
    return np.ascontiguousarray(
        (u[..., :n // 2] | (u[..., n // 2:] << 4)).astype(np.uint8))


def _bf16(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        device=device, dtype=torch.bfloat16)


def q2k_to_nibble(qs, sm, d, dmin, device="cpu") -> KNibbleTensor:
    """Q2_K planes (quant.repack.repack_q2k) -> nibble layout (6 bit/w)."""
    u = _plane_unpack(qs, 2)
    a = np.repeat(d.astype(np.float32), 16, axis=-1) * (sm & 0xF).astype(np.float32)
    c = np.repeat(dmin.astype(np.float32), 16, axis=-1) * (sm >> 4).astype(np.float32)
    return KNibbleTensor(p=torch.from_numpy(_nibble_pack(u)).to(device),
                         a=_bf16(a, device), c=_bf16(c, device), off=0)


def q3k_to_nibble(qs, hm, sc, d, device="cpu") -> KNibbleTensor:
    """Q3_K planes (quant.repack.repack_q3k) -> nibble layout (5 bit/w):
    u = qlow + 4*hbit in [0,7]; the -4 offset is output-side (off=4)."""
    u = _plane_unpack(qs, 2) + (_plane_unpack(hm, 1) << 2)
    a = np.repeat(d.astype(np.float32), 16, axis=-1) * sc.astype(np.float32)
    return KNibbleTensor(p=torch.from_numpy(_nibble_pack(u)).to(device),
                         a=_bf16(a, device), c=None, off=4)


# ---------------------------------------------------------------------------
# slicing a weight by its logical dims (parallel/sharding.py)
# ---------------------------------------------------------------------------

_AXIS = {"rows": -2, "cols": -1, "experts": 0}


def _permuted_cols(vals: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Values stored in the stride-16 permuted order of their n columns ->
    those of natural columns lo..hi-1, in the permuted order of hi - lo
    columns (new position c' holds old position inv[lo + perm'(c')])."""
    idx = stride16_inv_perm(vals.shape[-1])[lo:hi][stride16_perm(hi - lo)]
    return vals.index_select(-1, torch.as_tensor(idx, device=vals.device))


def _unpack_bits(planes: torch.Tensor, bits: int) -> torch.Tensor:
    """Plane bytes -> values in plane order (byte j, field s holds position
    s * n/(8/bits) + j)."""
    mask = (1 << bits) - 1
    return torch.cat([(planes >> s) & mask for s in range(0, 8, bits)], dim=-1)


def _pack_bits(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """The inverse of ``_unpack_bits``."""
    per = 8 // bits
    w = vals.shape[-1] // per
    out = torch.zeros(vals.shape[:-1] + (w,), dtype=torch.uint8, device=vals.device)
    for s in range(per):
        out |= vals[..., s * w:(s + 1) * w].to(torch.uint8) << (s * bits)
    return out


def _cols_of_planes(planes: torch.Tensor, bits: int, lo: int, hi: int) -> torch.Tensor:
    return _pack_bits(_permuted_cols(_unpack_bits(planes, bits), lo, hi), bits)


def _cut(t: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """A contiguous copy of t's lo:hi along ``axis`` (the whole tensor's
    storage is not kept alive by the slice)."""
    return t.narrow(axis, lo, hi - lo).clone(memory_format=torch.contiguous_format)


def slice_qt(qt, dim: str, lo: int, hi: int):
    """The part lo:hi of a weight along one logical dim: ``"rows"`` (out
    features), ``"cols"`` (in features) or ``"experts"`` (the stacked
    expert axis), every field cut at the one boundary, as contiguous
    copies; or None where a field's block would straddle it, in which
    case the caller keeps the tensor whole (``deepseek_tpu/parallel/
    sharding.py::_fit`` decides field by field instead, which can cut the
    data and its scale grid at different columns).

    Blocks: a blockwise fp8 weight cuts rows and columns at multiples of
    its block (or the tensor's end), a per-tensor one anywhere (its scale
    stays whole; an (E, 1, 1) expert scale follows the experts). K-quant
    weights (packed, turbo, nibble) cut columns at multiples of the
    256-column superblock; their stride-16 permuted planes (packed, Q3_K
    turbo, nibble) are unpacked to the natural columns, cut and packed
    again at the new width, so the part is the layout a (rows, hi - lo)
    tensor has. A row-permuted nibble table (``rowperm``) cuts no rows."""
    axis = _AXIS[dim]
    size = qt.shape[axis]
    if not 0 <= lo < hi <= size:
        raise ValueError(f"slice {lo}:{hi} of {dim} ({size})")
    if (lo, hi) == (0, size):
        return qt
    cut = lambda t: _cut(t, axis, lo, hi)
    if isinstance(qt, PlainTensor):
        return PlainTensor(data=cut(qt.data))
    if isinstance(qt, Fp8Tensor):
        data = _cut(qt.data.view(torch.uint8), axis, lo, hi).view(torch.float8_e5m2)
        if qt.per_tensor:
            whole = dim != "experts" or qt.scale.dim() == 0 or qt.scale.shape[0] != size
            scale = qt.scale.clone() if whole else _cut(qt.scale, 0, lo, hi)
            return Fp8Tensor(data=data, scale=scale, block_size=(0, 0))
        if dim == "experts":
            return Fp8Tensor(data=data, scale=cut(qt.scale), block_size=qt.block_size)
        b = qt.block_size[0 if dim == "rows" else 1]
        if lo % b or (hi % b and hi != size):
            return None
        return Fp8Tensor(data=data, scale=_cut(qt.scale, axis, lo // b, -(-hi // b)),
                         block_size=qt.block_size)
    if dim == "experts" or dim == "rows":
        if dim == "rows" and isinstance(qt, KNibbleTensor) and qt.rowperm:
            return None
        return qt.map(cut)
    if lo % 256 or hi % 256:
        return None
    g = lambda t, per: _cut(t, -1, lo // per, hi // per)    # per-group fields
    if isinstance(qt, Q2KTensor):
        return Q2KTensor(qs=_cols_of_planes(qt.qs, 2, lo, hi), sm=g(qt.sm, 16),
                         d=g(qt.d, 256), dmin=g(qt.dmin, 256))
    if isinstance(qt, Q3KTensor):
        return Q3KTensor(qs=_cols_of_planes(qt.qs, 2, lo, hi),
                         hm=_cols_of_planes(qt.hm, 1, lo, hi), sc=g(qt.sc, 16),
                         d=g(qt.d, 256))
    if isinstance(qt, Q2KTurboTensor):
        return Q2KTurboTensor(p=cut(qt.p), d=g(qt.d, 256), bm=g(qt.bm, 16))
    if isinstance(qt, Q3KTurboTensor):
        return Q3KTurboTensor(p=_permuted_cols(qt.p, lo, hi), a=g(qt.a, 16))
    if isinstance(qt, KNibbleTensor):
        return KNibbleTensor(p=_cols_of_planes(qt.p, 4, lo, hi), a=g(qt.a, 16),
                             c=None if qt.c is None else g(qt.c, 16), off=qt.off,
                             rowperm=qt.rowperm)
    raise TypeError(f"unsupported weight {type(qt).__name__}")
