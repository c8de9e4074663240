"""Hand-written CUDA flash attention, forward and backward, and their wrappers.

Counterpart of ``repro.kernels.flash``.  Four sources replace the reference's
Pallas kernels:

* ``csrc/flash_fwd_sm90.cu`` (tensor cores: ``wgmma`` fed by TMA) and
  ``csrc/flash_fwd.cu`` (CUDA cores, float32) replace
  ``_flash_fwd_lse_kernel`` (behind :func:`flash_fwd_lse`) and
  ``_flash_kernel`` (behind :func:`flash_attention_bhsd`, the same kernel
  without the logsumexp output);
* ``csrc/flash_bwd_dq_sm90.cu`` (tensor cores) and ``csrc/flash_bwd.cu``
  replace ``_flash_dq_kernel`` (behind :func:`flash_bwd_dq`), and
  ``csrc/flash_bwd_dkv_sm90.cu`` (tensor cores) and ``csrc/flash_bwd.cu``
  replace ``_flash_dkv_kernel`` (behind :func:`flash_bwd_dkv`);
  :func:`flash_bwd` runs dq, then dk/dv.

Which kernel a call takes is :func:`kernel_variant`'s rule on dtype and
shape alone: ``"sm90"`` (the tensor-core kernel) for bfloat16 with
d = dv in {64, 128}, ``"simt"`` (the CUDA-core kernel) for everything else.
A build or launch failure raises; nothing falls back.  Each source's header
says what bounds it on the card and what its design does about that.

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
STEMS = ("flash_fwd", "flash_bwd", "flash_fwd_sm90", "flash_bwd_dq_sm90",
         "flash_bwd_dkv_sm90")
SOURCES = {stem: CSRC / f"{stem}.cu" for stem in STEMS}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
MAX_HEAD_DIM = 256
SM90_HEAD_DIMS = (64, 128)
ENTRIES = ("flash_fwd_lse", "flash_attention_bhsd", "flash_bwd_dq",
           "flash_bwd_dkv")
VARIANTS = ("sm90", "simt")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: dict[str, ctypes.CDLL] = {}
_launches = {(e, v): 0 for e in ENTRIES for v in VARIANTS}
build_log: dict[str, str] = {}  # nvcc/ptxas output of this process's builds


def kernel_variant(entry: str, dtype: torch.dtype, d: int, dv: int) -> str:
    """The kernel ``entry`` launches for a CUDA call: ``"sm90"`` (the
    tensor-core kernel, ``csrc/flash_fwd_sm90.cu``,
    ``csrc/flash_bwd_dq_sm90.cu`` or ``csrc/flash_bwd_dkv_sm90.cu``) at
    bfloat16 with d = dv in {64, 128}; ``"simt"`` (the float32 CUDA-core
    kernel of ``csrc/flash_fwd.cu`` or ``csrc/flash_bwd.cu``) otherwise.
    The same rule for every entry, on dtype and shape only."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown flash entry {entry!r}")
    if dtype == torch.bfloat16 and d == dv and d in SM90_HEAD_DIMS:
        return "sm90"
    return "simt"


def launch_count(entry: str = "flash_fwd_lse",
                 variant: str | None = None) -> int:
    """Kernel launches of ``entry`` (``"flash_fwd_lse"``,
    ``"flash_attention_bhsd"``, ``"flash_bwd_dq"`` or ``"flash_bwd_dkv"``)
    through ``variant`` (``"sm90"`` or ``"simt"``; both when None) since
    the last :func:`reset_launch_count`."""
    if variant is None:
        return sum(_launches[(entry, v)] for v in VARIANTS)
    return _launches[(entry, variant)]


def reset_launch_count() -> None:
    for key in _launches:
        _launches[key] = 0


def build(stem: str = "flash_fwd") -> pathlib.Path:
    """Compile ``csrc/<stem>.cu`` (one of :data:`STEMS`; once per source,
    included headers and flag set)."""
    out, log = build_library(SOURCES[stem], NVCC_FLAGS, stem)
    if log:
        build_log[stem] = log
    return out


def _load(stem: str) -> ctypes.CDLL:
    if stem not in _libs:
        lib = ctypes.CDLL(str(build(stem)))
        ci, vp, cf = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        signatures = {
            "flash_fwd": {
                "flash_fwd": [vp] * 5 + [ci] * 5 + [cf, ci, vp]},
            "flash_bwd": {
                "flash_bwd_dq": [vp] * 7 + [ci] * 5 + [cf, ci, vp],
                "flash_bwd_dkv": [vp] * 8 + [ci] * 5 + [cf, ci, vp]},
            "flash_fwd_sm90": {
                "flash_fwd_sm90": [vp] * 5 + [ci] * 3 + [cf, ci, vp],
                "flash_sm90_probe": [vp] * 5 + [ci, vp]},
            "flash_bwd_dq_sm90": {
                "flash_bwd_dq_sm90": [vp] * 7 + [ci] * 3 + [cf, ci, vp]},
            "flash_bwd_dkv_sm90": {
                "flash_bwd_dkv_sm90": [vp] * 8 + [ci] * 3 + [cf, ci, vp]},
        }[stem]
        for name, argtypes in signatures.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ci
        errors = {"flash_fwd": "flash_error_string",
                  "flash_bwd": "flash_bwd_error_string",
                  "flash_fwd_sm90": "flash_sm90_error_string",
                  "flash_bwd_dq_sm90": "flash_bwd_dq_sm90_error_string",
                  "flash_bwd_dkv_sm90": "flash_bwd_dkv_sm90_error_string"}
        lib.error_string = getattr(lib, errors[stem])
        lib.error_string.argtypes = [ci]
        lib.error_string.restype = ctypes.c_char_p
        _libs[stem] = lib
    return _libs[stem]


def _variant(entry, dtype, d, dv, forced: str | None) -> str:
    """:func:`kernel_variant`'s kernel, or ``forced`` where a kernel of that
    name takes these inputs (the CUDA-core kernels take every input)."""
    rule = kernel_variant(entry, dtype, d, dv)
    if forced is None or forced == rule or forced == "simt":
        return forced or rule
    raise ValueError(f"{entry}: no {forced!r} kernel for {dtype} d={d} "
                     f"dv={dv}")


def _raise_if_failed(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed ({code}): "
                           f"{lib.error_string(code).decode()}")


def _check_tma(**tensors: torch.Tensor) -> None:
    """TMA's own conditions on the tensor-core kernels' operands: base
    pointers 16-byte aligned, and rows of the [BH, S, d] tiles a multiple
    of 16 bytes ([BH, S] lse and delta are read as one flat vector)."""
    for name, x in tensors.items():
        row = x.shape[-1] * x.element_size() if x.dim() == 3 else 16
        if x.data_ptr() % 16 or row % 16:
            raise ValueError(f"{name}: TMA needs a 16-byte-aligned base "
                             f"pointer and rows a multiple of 16 bytes, got "
                             f"address {x.data_ptr():#x}, rows of {row} "
                             f"bytes")


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


def _launch(q, k, v, scale: float, causal: bool, entry: str,
            variant: str | None = None):
    """Launch ``entry``'s kernel: :func:`kernel_variant`'s, or ``variant``
    when given (a measurement of the other kernel at the same inputs;
    ``"sm90"`` only where the rule allows it)."""
    bh, s, d = q.shape
    dv = v.shape[2]
    variant = _variant(entry, q.dtype, d, dv, variant)
    o = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((bh, s), dtype=torch.float32, device=q.device)
           if entry == "flash_fwd_lse" else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant == "sm90":
            _check_tma(q=q, k=k, v=v)
            lib = _load("flash_fwd_sm90")
            code = lib.flash_fwd_sm90(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), o.data_ptr(), lse_ptr,
                                      bh, s, d, float(scale), int(causal),
                                      stream)
        else:
            lib = _load("flash_fwd")
            code = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse_ptr,
                                 _DTYPE_CODES[q.dtype], bh, s, d, dv,
                                 float(scale), int(causal), stream)
    _raise_if_failed(lib, code, f"{entry} ({variant})")
    _launches[(entry, variant)] += 1
    return o, lse


def sm90_tile_probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kernels' two tile products alone, for the card's
    tests: ``(a b^T, bf16(a b^T) c)`` in float32 for contiguous bf16 CUDA
    tensors a, b, c [64, d], d in {64, 128}.  The first is an SS ``wgmma``
    (both operands K-major in shared memory), the second an RS ``wgmma``
    (A from registers, c read MN-major); all three tiles arrive by TMA."""
    d = a.shape[1]
    for x in (a, b, c):
        if x.shape != (64, d) or d not in SM90_HEAD_DIMS \
                or x.dtype != torch.bfloat16 or x.device.type != "cuda" \
                or not x.is_contiguous():
            raise ValueError("sm90_tile_probe takes contiguous bf16 CUDA "
                             "tensors [64, d], d in {64, 128}")
    _check_tma(a=a, b=b, c=c)
    s_out = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    o_out = torch.empty((64, d), dtype=torch.float32, device=a.device)
    lib = _load("flash_fwd_sm90")
    with torch.cuda.device(a.device):
        code = lib.flash_sm90_probe(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), s_out.data_ptr(),
            o_out.data_ptr(), d,
            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_if_failed(lib, code, "sm90 tile probe")
    return s_out, o_out


def flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(O [BH, S, dv] in q's dtype, logsumexp [BH, S] float32) of
    ``softmax(scale * q k^T) v`` for contiguous q, k [BH, S, d] and
    v [BH, S, dv] (float32 or bfloat16, d, dv <= 256).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    :func:`kernel_variant` names on the current stream (no
    synchronisation) and count one launch of that variant.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_fwd_lse_ref(q, k, v, scale=scale, causal=causal)
    return _launch(q, k, v, scale, causal, "flash_fwd_lse")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, causal: bool = True
                         ) -> torch.Tensor:
    """O of :func:`flash_fwd_lse` without the logsumexp output (the same
    kernels, launched with a null logsumexp pointer)."""
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
                causal: bool, variant: str | None = None) -> None:
    """Launch ``entry``'s kernel (or ``variant``'s, as in :func:`_launch`)
    writing ``outs``."""
    bh, s, d = q.shape
    dv = v.shape[2]
    variant = _variant(entry, q.dtype, d, dv, variant)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant == "sm90":
            tma = dict(q=q, k=k, v=v, do=do)
            if entry == "flash_bwd_dkv":    # lse and delta arrive by TMA too
                tma.update(lse=lse, delta=delta)
            _check_tma(**tma)
            stem = f"{entry}_sm90"
            lib = _load(stem)
            code = getattr(lib, stem)(*ptrs, bh, s, d, float(scale),
                                      int(causal), stream)
        else:
            lib = _load("flash_bwd")
            code = getattr(lib, entry)(*ptrs, _DTYPE_CODES[q.dtype], bh, s,
                                       d, dv, float(scale), int(causal),
                                       stream)
    _raise_if_failed(lib, code, f"{entry} ({variant})")
    _launches[(entry, variant)] += 1


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                 scale: float, causal: bool = True) -> torch.Tensor:
    """dq [BH, S, d] in q's dtype, from the forward's lse and
    ``delta = rowsum(do * o)`` (both [BH, S] float32).  CPU tensors take
    the plain version; CUDA tensors launch the dq kernel
    :func:`kernel_variant` names (one launch)."""
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
    :func:`flash_bwd_dq`.  CUDA tensors launch the dk/dv kernel
    :func:`kernel_variant` names (one launch)."""
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
