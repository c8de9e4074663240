"""Hand-written CUDA flash-attention forward, and its wrappers.

Counterpart of ``repro.kernels.flash``'s forward kernels: the source
``csrc/flash_fwd.cu`` replaces ``_flash_fwd_lse_kernel`` (behind
:func:`flash_fwd_lse`) and ``_flash_kernel`` (behind
:func:`flash_attention_bhsd`, the same kernel without the logsumexp
output).  Its header says what bounds it on the card and what its design
does about that.  The backward kernels (``flash_bwd``) are not ported yet.

The library is built with ``nvcc`` into ``build/kernels/`` on first use,
from the sources in the checkout only, and loaded with ``ctypes``; nothing
is built when this module is imported.  On CPU tensors both wrappers run
the plain version (:func:`repro_torch.kernels.ref.flash_fwd_lse_ref`); on
CUDA tensors they launch the kernel or raise.

Unlike the reference, every sequence length S >= 1 is exact: the reference
tiles S by ``min(512, S)`` and leaves the rows past ``(S // 512) * 512``
unwritten when 512 does not divide S.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from . import ref
from ._build import build_library

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: ctypes.CDLL | None = None
_launches = {"flash_fwd_lse": 0, "flash_attention_bhsd": 0}
build_log = ""  # nvcc/ptxas output of the build this process ran, if any


def launch_count(entry: str = "flash_fwd_lse") -> int:
    """Kernel launches through ``entry`` (``"flash_fwd_lse"`` or
    ``"flash_attention_bhsd"``) since the last :func:`reset_launch_count`."""
    return _launches[entry]


def reset_launch_count() -> None:
    for entry in _launches:
        _launches[entry] = 0


def build() -> pathlib.Path:
    """Compile ``csrc/flash_fwd.cu`` (once per source and flag set)."""
    global build_log
    out, log = build_library(SOURCE, NVCC_FLAGS, "flash_fwd")
    if log:
        build_log = log
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ci, vp = ctypes.c_int, ctypes.c_void_p
        lib.flash_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                  ctypes.c_float, ci, vp]
        lib.flash_fwd.restype = ci
        lib.flash_error_string.argtypes = [ci]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention takes float32 or bfloat16 operands "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 \
            or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"expected q, k [BH, S, d] and v [BH, S, dv], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, d = q.shape
    dv = v.shape[2]
    if min(bh, s) < 1 or not (1 <= d <= MAX_HEAD_DIM
                              and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"need BH, S >= 1 and 1 <= d, dv <= {MAX_HEAD_DIM}, "
                         f"got q {tuple(q.shape)}, v {tuple(v.shape)}")
    if max(bh, s * max(d, dv)) > 2**31 - 1:
        raise ValueError(f"operands too large for the kernel: "
                         f"{tuple(q.shape)}, {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention takes contiguous operands")


def _launch(q, k, v, scale: float, causal: bool, entry: str):
    lib = _load()
    with_lse = entry == "flash_fwd_lse"
    bh, s, d = q.shape
    dv = v.shape[2]
    o = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((bh, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(),
                             None if lse is None else lse.data_ptr(),
                             _DTYPE_CODES[q.dtype], bh, s, d, dv,
                             float(scale), int(causal), stream)
    if code != 0:
        raise RuntimeError(f"flash attention kernel launch failed ({code}): "
                           f"{lib.flash_error_string(code).decode()}")
    _launches[entry] += 1
    return o, lse


def flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(O [BH, S, dv] in q's dtype, logsumexp [BH, S] float32) of
    ``softmax(scale * q k^T) v`` for contiguous q, k [BH, S, d] and
    v [BH, S, dv] (float32 or bfloat16, d, dv <= 256).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation) and count one launch.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_fwd_lse_ref(q, k, v, scale=scale, causal=causal)
    return _launch(q, k, v, scale, causal, "flash_fwd_lse")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, causal: bool = True
                         ) -> torch.Tensor:
    """O of :func:`flash_fwd_lse` without the logsumexp output (the same
    kernel, launched with a null logsumexp pointer)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal)
    return _launch(q, k, v, scale, causal, "flash_attention_bhsd")[0]
