"""Hand-written CUDA kernels for the tropical (min, +) product and closure,
and their wrappers.

Counterpart of ``repro.kernels.minplus``: the source
``csrc/minplus.cu`` replaces both Pallas TPU kernels there
(``_minplus_kernel_batched`` and ``_minplus_kernel``; the 2-D product is
the batch-of-one view), and adds a closure kernel that runs every
squaring of a ``[D, V, V]`` stack (V <= 32) in one launch.  Its header
says what bounds them on the card and what the design does about that.

The library is built with ``nvcc`` into ``build/kernels/`` under the
repository root on first use, from the sources in the checkout only, and
loaded with ``ctypes``.  Nothing is built or imported when this module is
imported: the CPU tests import it on machines without ``nvcc``.

:func:`minplus_matmul_batched` (entry ``"product"``) and
:func:`minplus_closure_batched` (entry ``"closure"``) are the ways in.  On
CPU tensors they run the plain version
(:func:`repro_torch.kernels.ref.minplus_matmul_ref`,
:func:`repro_torch.kernels.ref.minplus_closure_ref`); on CUDA tensors
they launch the kernel or raise.  A failed build or launch raises; there
is no fallback to the plain version.  :func:`closure_variant` is the rule
by which ``ops.minplus_closure`` picks the closure kernel or the loop of
products.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from . import ref
from ._build import build_library

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "minplus.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

ENTRIES = ("product", "closure")
CLOSURE_MAX_V = 32  # the closure kernel holds a whole [V, V] matrix a block

_lib: ctypes.CDLL | None = None
_launches = dict.fromkeys(ENTRIES, 0)
build_log = ""  # nvcc/ptxas output of the build this process ran, if any


def launch_count(entry: str | None = None) -> int:
    """Kernel launches of ``entry`` (``"product"`` or ``"closure"``; both
    when None) since the last :func:`reset_launch_count`."""
    if entry is None:
        return sum(_launches.values())
    return _launches[entry]


def reset_launch_count() -> None:
    for key in _launches:
        _launches[key] = 0


def closure_steps(n: int) -> int:
    """Squarings that close any ``[n, n]`` weight matrix: after s squarings
    every path of <= 2^s hops is covered, and simple paths have <= n-1."""
    return max(1, (n - 1).bit_length())


def closure_variant(v: int, device: torch.device | str) -> str:
    """How ``ops.minplus_closure`` closes a stack of ``[v, v]`` matrices on
    ``device``: ``"closure"`` (one launch of the closure kernel) on CUDA
    with v <= :data:`CLOSURE_MAX_V`, else ``"product"`` (a loop of
    :func:`closure_steps` products: kernel launches on CUDA, the plain
    product on the CPU).  A rule on shape and device only."""
    if torch.device(device).type == "cuda" and v <= CLOSURE_MAX_V:
        return "closure"
    return "product"


def build() -> pathlib.Path:
    """Compile ``csrc/minplus.cu`` (once per source and flag set; see
    :func:`repro_torch.kernels._build.build_library`)."""
    global build_log
    out, log = build_library(SOURCE, NVCC_FLAGS, "minplus")
    if log:
        build_log = log
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ll, ci, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        lib.minplus_batched_f32.argtypes = [vp, vp, vp, ci, ci, ci, ci,
                                            ll, ll, ll, ll, ll, ll, vp]
        lib.minplus_batched_f32.restype = ci
        lib.minplus_closure_f32.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.minplus_closure_f32.restype = ci
        lib.minplus_error_string.argtypes = [ci]
        lib.minplus_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} vs "
                         f"{b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"min-plus kernel takes float32, got {a.dtype} x "
                        f"{b.dtype}")
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"operands must both be [M, K] x [K, N] or "
                         f"[B, M, K] x [B, K, N], got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"mismatched shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if min(a.shape) == 0 or min(b.shape) == 0:
        raise ValueError(f"empty operand {tuple(a.shape)} x {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("min-plus kernel takes contiguous operands")


def minplus_matmul_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[b] = A[b] (min,+) B[b] for f32 [B, M, K] x [B, K, N] (or 2-D
    [M, K] x [K, N]) contiguous operands on one device.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation) and count one launch.
    """
    _check(a, b)
    if a.device.type == "cpu":
        return ref.minplus_matmul_ref(a, b)
    two_d = a.dim() == 2
    a3 = a.unsqueeze(0) if two_d else a
    b3 = b.unsqueeze(0) if two_d else b
    bsz, m, k = a3.shape
    n = b3.shape[2]
    if max(bsz, m, k, n) > 2**31 - 1:
        raise ValueError(f"dimension too large for the kernel: "
                         f"{tuple(a3.shape)} x {tuple(b3.shape)}")
    lib = _load()
    c = torch.empty((bsz, m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.minplus_batched_f32(
            a3.data_ptr(), b3.data_ptr(), c.data_ptr(), bsz, m, k, n,
            a3.stride(0), a3.stride(1), b3.stride(0), b3.stride(1),
            c.stride(0), c.stride(1), stream)
    _raise_if_failed(lib, code, "min-plus")
    _launches["product"] += 1
    return c[0] if two_d else c


def minplus_closure_batched(w: torch.Tensor) -> torch.Tensor:
    """D[b] = the min-plus closure of W[b] for a contiguous float32
    ``[B, V, V]`` (or ``[V, V]``) stack: the diagonal forced to
    ``min(w_uu, 0)``, then :func:`closure_steps` (V) squarings -- the
    function of ``ops.minplus_closure``.

    CPU tensors take the plain version; CUDA tensors (V <= 32) launch the
    closure kernel on the current stream (no synchronisation) and count
    one launch.
    """
    if w.dim() < 2 or w.shape[-1] != w.shape[-2]:
        raise ValueError(f"closure takes square matrices, got "
                         f"{tuple(w.shape)}")
    _check(w, w)
    v = w.shape[-1]
    steps = closure_steps(v)
    if w.device.type == "cpu":
        return ref.minplus_closure_ref(w, steps=steps)
    if v > CLOSURE_MAX_V:
        raise ValueError(f"the closure kernel takes V <= {CLOSURE_MAX_V}, "
                         f"got V = {v}")
    w3 = w.unsqueeze(0) if w.dim() == 2 else w
    if w3.shape[0] > 2**31 - 1:
        raise ValueError(f"stack too large for the kernel: {tuple(w.shape)}")
    lib = _load()
    d = torch.empty_like(w3)
    with torch.cuda.device(w.device):
        code = lib.minplus_closure_f32(
            w3.data_ptr(), d.data_ptr(), w3.shape[0], v, steps,
            torch.cuda.current_stream(w.device).cuda_stream)
    _raise_if_failed(lib, code, "min-plus closure")
    _launches["closure"] += 1
    return d.view_as(w)


def _raise_if_failed(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed ({code}): "
                           f"{lib.minplus_error_string(code).decode()}")
