"""quant_pack: blockwise int8 quantization of checkpoint leaves.

The persist format of APPROXIMABLE leaves (Adam moments) under
``PARTLY_Q8``: one int8 per element plus one f32 scale per 256-element
group of a row, about 3.9x fewer bytes than f32.  ``CheckpointManager``
quantizes on the card before the copy to the host and dequantizes on the
card after loading (through ``kernels/ops.py``).  ``csrc/quant_pack.cu``
holds the Hopper kernels and their design note.

Both functions give the reference's CPU bits exactly: the scale is
``max(absmax, 1e-12) * f32(1/127)`` (a multiply: XLA rewrites the
reference's division by the constant 127 into one), the payload
``clip(rint(x / scale), -127, 127)`` with true division.  On a group
holding NaN or +-inf they give the reference's bits too: a NaN absmax
makes the scale NaN, an infinite one inf, and every NaN quotient
quantizes to 0.

``dequantize_blockwise(..., dtype=torch.bfloat16)`` rounds the f32
product to bf16 (nearest even) as it stores it, in the same pass: the
reference's ``(q * s in f32).astype(dtype)`` bit for bit.

The wrappers dispatch by where their tensors live: CPU tensors take the
``*_plain`` version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["GROUP", "quantize_blockwise", "quantize_blockwise_plain",
           "dequantize_blockwise", "dequantize_blockwise_plain"]

GROUP = 256
_INV127 = float(np.float32(1.0 / 127.0))     # exact in f32
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check_rows(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dim() != 2 or t.shape[1] % GROUP:
        raise ValueError(f"{name}: expected (N, {GROUP}k), got shape "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _check_scales(q: torch.Tensor, s: torch.Tensor) -> None:
    _check_rows("dequantize_blockwise", q, torch.int8)
    want = (q.shape[0], q.shape[1] // GROUP)
    if tuple(s.shape) != want or s.dtype != torch.float32:
        raise ValueError(f"dequantize_blockwise: scales must be f32 {want}, "
                         f"got {s.dtype} {tuple(s.shape)}")
    if not s.is_contiguous():
        raise ValueError("dequantize_blockwise: scales must be contiguous")
    if q.device != s.device:
        raise ValueError(f"dequantize_blockwise: q on {q.device}, scales on "
                         f"{s.device}")


def quantize_blockwise_plain(x: torch.Tensor):
    """Plain version of ``quantize_blockwise``."""
    _check_rows("quantize_blockwise", x, torch.float32)
    n, d = x.shape
    g = x.reshape(n, d // GROUP, GROUP)
    # amax and clamp carry a NaN through to the scale, as the reference's
    # max and maximum do; a NaN quotient (a NaN element, or inf / inf)
    # becomes 0, as XLA converts it to int8
    scale = torch.clamp_min(g.abs().amax(dim=2), 1e-12) * _INV127
    q = torch.clamp(torch.round(g / scale[..., None]), -127, 127)
    q = torch.nan_to_num(q, nan=0.0)
    return q.to(torch.int8).reshape(n, d), scale


def _check_out(dtype: torch.dtype) -> None:
    if dtype not in _OUT_DTYPES:
        raise TypeError(f"dequantize_blockwise: dtype must be one of "
                        f"{_OUT_DTYPES}, got {dtype}")


def dequantize_blockwise_plain(q: torch.Tensor, s: torch.Tensor,
                               dtype: torch.dtype = torch.float32):
    """Plain version of ``dequantize_blockwise``."""
    _check_scales(q, s)
    _check_out(dtype)
    n, d = q.shape
    x = q.reshape(n, d // GROUP, GROUP).to(torch.float32) * s[..., None]
    return x.reshape(n, d).to(dtype)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")


def _aligned(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor at {t.data_ptr():#x} is not "
                             f"16-byte aligned")


def quantize_blockwise(x: torch.Tensor):
    """x (N, 256k) f32 -> (q (N, 256k) int8, scales (N, k) f32)."""
    _check_rows("quantize_blockwise", x, torch.float32)
    if x.device.type == "cpu":
        return quantize_blockwise_plain(x)
    _require_cuda("quantize_blockwise", x)
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    s = torch.empty((n, d // GROUP), dtype=torch.float32, device=x.device)
    _aligned("quantize_blockwise", x, q)
    if x.numel() == 0:
        return q, s
    lib = _build.load("quant_pack")
    with torch.cuda.device(x.device):
        rc = lib.quantize_blockwise_launch(x.data_ptr(), q.data_ptr(),
                                           s.data_ptr(), x.numel(),
                                           _stream(x))
    if rc:
        raise RuntimeError(f"quantize_blockwise: kernel launch failed (CUDA "
                           f"error {rc})")
    _build.note_launch(quantize_blockwise, n)
    return q, s


def dequantize_blockwise(q: torch.Tensor, s: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (N, 256k) int8, scales (N, k) f32 -> (N, 256k) in ``dtype`` (f32
    or bf16)."""
    _check_scales(q, s)
    _check_out(dtype)
    if q.device.type == "cpu":
        return dequantize_blockwise_plain(q, s, dtype)
    _require_cuda("dequantize_blockwise", q)
    x = torch.empty(q.shape, dtype=dtype, device=q.device)
    _aligned("dequantize_blockwise", q, x)
    if q.numel() == 0:
        return x
    lib = _build.load("quant_pack")
    with torch.cuda.device(q.device):
        rc = lib.dequantize_blockwise_launch(q.data_ptr(), s.data_ptr(),
                                             x.data_ptr(), q.numel(),
                                             int(dtype == torch.bfloat16),
                                             _stream(q))
    if rc:
        raise RuntimeError(f"dequantize_blockwise: kernel launch failed "
                           f"(CUDA error {rc})")
    _build.note_launch(dequantize_blockwise, q.shape[0])
    return x


quantize_blockwise.launches = 0
quantize_blockwise.sizes = {}
dequantize_blockwise.launches = 0
dequantize_blockwise.sizes = {}
