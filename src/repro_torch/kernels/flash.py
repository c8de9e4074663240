"""Hand-written CUDA flash attention, forward and backward, and their wrappers.

Counterpart of ``repro.kernels.flash``.  The source ``csrc/flash_fwd.cu``
replaces ``_flash_fwd_lse_kernel`` (behind :func:`flash_fwd_lse`) and
``_flash_kernel`` (behind :func:`flash_attention_bhsd`, the same kernel
without the logsumexp output); ``csrc/flash_bwd.cu`` replaces
``_flash_dq_kernel`` (behind :func:`flash_bwd_dq`) and
``_flash_dkv_kernel`` (behind :func:`flash_bwd_dkv`), which
:func:`flash_bwd` runs one after the other.  Each source's header says
what bounds it on the card and what its design does about that.

Each source is built with ``nvcc`` into its own library under
``build/kernels/`` on first use, from the sources in the checkout only,
and loaded with ``ctypes``; nothing is built when this module is
imported.  On CPU tensors every wrapper runs the plain version
(:mod:`repro_torch.kernels.ref`); on CUDA tensors it launches the kernel
or raises.

Unlike the reference, every sequence length S >= 1 is exact: the reference
tiles S by ``min(512, S)`` and leaves the rows past ``(S // 512) * 512``
unwritten when 512 does not divide S, in the forward and the backward.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from . import ref
from ._build import build_library

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = {stem: CSRC / f"{stem}.cu" for stem in ("flash_fwd", "flash_bwd")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: dict[str, ctypes.CDLL] = {}
_launches = {"flash_fwd_lse": 0, "flash_attention_bhsd": 0,
             "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
build_log: dict[str, str] = {}  # nvcc/ptxas output of this process's builds


def launch_count(entry: str = "flash_fwd_lse") -> int:
    """Kernel launches of ``entry`` (``"flash_fwd_lse"``,
    ``"flash_attention_bhsd"``, ``"flash_bwd_dq"`` or ``"flash_bwd_dkv"``)
    since the last :func:`reset_launch_count`."""
    return _launches[entry]


def reset_launch_count() -> None:
    for entry in _launches:
        _launches[entry] = 0


def build(stem: str = "flash_fwd") -> pathlib.Path:
    """Compile ``csrc/<stem>.cu`` (``"flash_fwd"`` or ``"flash_bwd"``;
    once per source and flag set)."""
    out, log = build_library(SOURCES[stem], NVCC_FLAGS, stem)
    if log:
        build_log[stem] = log
    return out


def _load(stem: str) -> ctypes.CDLL:
    if stem not in _libs:
        lib = ctypes.CDLL(str(build(stem)))
        ci, vp, cf = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        if stem == "flash_fwd":
            lib.flash_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      cf, ci, vp]
            lib.flash_fwd.restype = ci
            lib.flash_error_string.argtypes = [ci]
            lib.flash_error_string.restype = ctypes.c_char_p
        else:
            lib.flash_bwd_dq.argtypes = [vp] * 7 + [ci] * 5 + [cf, ci, vp]
            lib.flash_bwd_dq.restype = ci
            lib.flash_bwd_dkv.argtypes = [vp] * 8 + [ci] * 5 + [cf, ci, vp]
            lib.flash_bwd_dkv.restype = ci
            lib.flash_bwd_error_string.argtypes = [ci]
            lib.flash_bwd_error_string.restype = ctypes.c_char_p
        _libs[stem] = lib
    return _libs[stem]


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
    lib = _load("flash_fwd")
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


def _check_bwd(q, k, v, do, lse, *, o=None, delta=None) -> None:
    _check(q, k, v)
    rows = q.shape[:2]
    operands = {"do": (do, v.shape, q.dtype),
                "lse": (lse, rows, torch.float32), "o": (o, v.shape, q.dtype),
                "delta": (delta, rows, torch.float32)}
    for name, (x, shape, dtype) in operands.items():
        if x is None:
            continue
        if x.shape != shape or x.dtype != dtype:
            raise ValueError(f"expected {name} of shape {tuple(shape)} and "
                             f"dtype {dtype}, got {tuple(x.shape)} {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError("flash attention takes contiguous operands")


def _launch_bwd(entry: str, q, k, v, do, lse, delta, outs, scale: float,
                causal: bool) -> None:
    lib = _load("flash_bwd")
    bh, s, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
            _DTYPE_CODES[q.dtype], bh, s, d, v.shape[2], float(scale),
            int(causal), stream)
    if code != 0:
        raise RuntimeError(f"{entry} kernel launch failed ({code}): "
                           f"{lib.flash_bwd_error_string(code).decode()}")
    _launches[entry] += 1


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                 scale: float, causal: bool = True) -> torch.Tensor:
    """dq [BH, S, d] in q's dtype, from the forward's lse and
    ``delta = rowsum(do * o)`` (both [BH, S] float32).  CPU tensors take
    the plain version; CUDA tensors launch the dq kernel (one launch)."""
    _check_bwd(q, k, v, do, lse, delta=delta)
    if q.device.type == "cpu":
        return ref.flash_bwd_dq_ref(q, k, v, do, lse, delta, scale=scale,
                                    causal=causal)
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, (dq,), scale,
                causal)
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  *, scale: float, causal: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk [BH, S, d], dv [BH, S, dv]) in q's dtype; operands as for
    :func:`flash_bwd_dq`.  CUDA tensors launch the dk/dv kernel (one
    launch)."""
    _check_bwd(q, k, v, do, lse, delta=delta)
    if q.device.type == "cpu":
        return ref.flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale=scale,
                                     causal=causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), scale,
                causal)
    return dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              scale: float, causal: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_fwd_lse`'s O for the cotangent ``do``,
    from the forward's ``o`` and ``lse``: contiguous q, k [BH, S, d];
    v, o, do [BH, S, dv] in q's dtype (float32 or bfloat16, d, dv <= 256);
    lse [BH, S] float32.  The gradients come out in q's dtype.

    ``delta = rowsum(do * o)`` is a float32 torch reduction, as in the
    reference.  CPU tensors take the plain version; CUDA tensors launch
    the dq kernel and the dk/dv kernel on the current stream (no
    synchronisation), one launch each.
    """
    _check_bwd(q, k, v, do, lse, o=o)
    if q.device.type == "cpu":
        return ref.flash_bwd_ref(q, k, v, o, lse, do, scale=scale,
                                 causal=causal)
    delta = ref.flash_bwd_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale=scale, causal=causal)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale,
                               causal=causal))
