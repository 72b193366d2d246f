"""Kernels K1 and K2: nibble-plane dequant + matrix-vector product.

``qmm`` replaces ``deepseek_tpu/ops/pallas/qmm.py::qmm`` with ``_knib_body``
(K1) and ``qmm_experts`` replaces ``::qmm_experts`` with ``_knib_body`` (K2,
one expert id per activation row). Both launch ``csrc/qmm.cu`` (see its
header for the design and why the weight bytes bound it). Each wrapper
keeps its own launch count in ``.launches``.

A wrapper given CPU tensors computes the plain version (``*_plain``: the
f32 dequant of quant/qtensor.py and a product); given CUDA tensors it
launches the kernel or raises. It never falls back.
"""

from __future__ import annotations

import torch

from deepseek_tpu_torch.ops.kernels.build import check, library
from deepseek_tpu_torch.quant.qtensor import KNibbleTensor


def qmm_plain(qt: KNibbleTensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., n) @ dequant(W (d, n)).T -> (..., d) float32."""
    return torch.matmul(x.float(), qt.dequant(torch.float32).t())


def qmm_experts_plain(qt: KNibbleTensor, idx: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Row i of x (..., n) times expert idx[i] of W (E, d, n) -> (..., d)
    float32. Only the selected experts are dequantized."""
    lead, n = x.shape[:-1], x.shape[-1]
    sel = qt.map(lambda t: t[idx.reshape(-1).long()])
    w = sel.dequant(torch.float32)                         # (N, d, n)
    out = torch.bmm(w, x.reshape(-1, n, 1).float())[..., 0]
    return out.reshape(*lead, -1)


def _check_planes(qt: KNibbleTensor, x: torch.Tensor, experts: bool) -> None:
    dims = 3 if experts else 2
    if qt.p.dim() != dims:
        raise ValueError(f"expected {dims}-D nibble planes, got {tuple(qt.p.shape)}")
    planes = [("p", qt.p, torch.uint8), ("a", qt.a, torch.bfloat16)]
    if qt.c is not None:
        planes.append(("c", qt.c, torch.bfloat16))
    for name, t, dt in planes:
        if t.device != x.device or t.dtype != dt or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"plane {name}: need a contiguous, 16-byte aligned {dt} "
                f"tensor on {x.device}, got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}, address % 16 = {t.data_ptr() % 16}")
    n = qt.shape[-1]
    if n % 256:
        raise ValueError(f"nibble kernels need in-features % 256 == 0, got {n}")


def _launch(qt: KNibbleTensor, x2: torch.Tensor, idx, d: int) -> torch.Tensor:
    n = x2.shape[-1]
    x2 = x2.float().contiguous()
    y = torch.empty((x2.shape[0], d), dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = library("qmm").knib_matvec(
        x2.data_ptr(), qt.p.data_ptr(), qt.a.data_ptr(),
        qt.c.data_ptr() if qt.c is not None else None,
        idx.data_ptr() if idx is not None else None, y.data_ptr(),
        x2.shape[0], d, n, int(qt.off), stream)
    check(err, "knib_matvec")
    return y


def qmm(qt: KNibbleTensor, x: torch.Tensor) -> torch.Tensor:
    """K1: x (..., n) @ W (d, n).T -> (..., d) float32."""
    if x.device.type == "cpu":
        return qmm_plain(qt, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm runs on cuda or cpu tensors, not {x.device}")
    _check_planes(qt, x, experts=False)
    lead, n = x.shape[:-1], x.shape[-1]
    d = qt.shape[-2]
    x2 = x.reshape(-1, n)
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    y = _launch(qt, x2, None, d)
    qmm.launches += 1
    return y.reshape(*lead, d)


def qmm_experts(qt: KNibbleTensor, idx: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """K2: row i of x (..., n) against expert idx[i] of W (E, d, n) ->
    (..., d) float32. ``idx`` (...) must hold ids in [0, E): the kernel
    reads the expert's planes at that offset unchecked."""
    if x.device.type == "cpu":
        return qmm_experts_plain(qt, idx, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_experts runs on cuda or cpu tensors, not {x.device}")
    _check_planes(qt, x, experts=True)
    lead, n = x.shape[:-1], x.shape[-1]
    d = qt.shape[-2]
    if idx.shape != lead:
        raise ValueError(f"idx shape {tuple(idx.shape)} != rows {tuple(lead)}")
    x2 = x.reshape(-1, n)
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    idx32 = idx.reshape(-1).to(device=x.device, dtype=torch.int32).contiguous()
    y = _launch(qt, x2, idx32, d)
    qmm_experts.launches += 1
    return y.reshape(*lead, d)


qmm.launches = 0
qmm_experts.launches = 0
