"""A hand-written fused AdamW for the card, and its wrappers.

The port's own kernel: the JAX package's ``repro.optim.adamw`` runs plain
``jnp`` ops and has no Pallas kernel to replace.  The source
``csrc/adamw.cu`` runs :class:`repro_torch.optim.adamw.AdamW`'s arithmetic
in three launches a step shape: ``"sumsq"`` (a leaf's sum of squared
gradient, one float32 partial a block), ``"finalize"`` (one block: every
partial in a fixed order, the global norm and the clip scale) and
``"update"`` (one pass over a leaf: reads p, g, m, v once and writes the
new p, m, v once).  Its header says what bounds it on the card and what
the design does about that.  No float atomics, no value brought to the
host: :func:`global_norm` and :func:`update` never wait for the card.

The plain version is ``AdamW``'s per-leaf PyTorch code, which the
optimizer runs on every tree that is not on a card; a CUDA tree always
comes here.  :func:`refusal` is the rule, on what each leaf shows, and
:func:`tree_refusal` the whole tree's: a plain tensor (``torch.Tensor`` or
``nn.Parameter``, not a ``DTensor`` or another subclass), p bfloat16 or
float32, g of p's dtype and shape, m and v float32 of p's shape, all on
one CUDA device.  The wrappers raise on a tree it refuses, so a train
step on the card either runs this kernel or fails; none falls back.  A
leaf that is not contiguous is copied to a contiguous one first.  Given
the same scale, lr and bias corrections the kernel's p, m and v equal the
per-leaf code's bit for bit; only the norm's summation order differs.

The library is built with ``nvcc`` into ``build/kernels/`` on first use and
loaded with ``ctypes``; nothing is built when this module is imported.
:func:`launch_count` counts launches by entry, :func:`apply_count` the
optimizer's applies by path (``"fused"`` or ``"per_leaf"``).
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from ._build import build_library

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "adamw.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

ENTRIES = ("sumsq", "finalize", "update")
PATHS = ("fused", "per_leaf")
THREADS, VEC, BLOCKS_PER_SM = 256, 8, 4  # as csrc/adamw.cu's kThreads, kVec
NORM_FLOOR = 1e-9  # AdamW's clamp of the norm before the clip's division
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN = (torch.Tensor, torch.nn.Parameter)

_lib: ctypes.CDLL | None = None
_launches = dict.fromkeys(ENTRIES, 0)
_applies = dict.fromkeys(PATHS, 0)
build_log = ""  # nvcc/ptxas output of the build this process ran, if any


def launch_count(entry: str | None = None) -> int:
    """Kernel launches of ``entry`` (one of :data:`ENTRIES`; all when None)
    since the last :func:`reset_launch_count`."""
    if entry is None:
        return sum(_launches.values())
    return _launches[entry]


def apply_count(path: str | None = None) -> int:
    """``AdamW`` applies that took ``path`` (``"fused"`` or ``"per_leaf"``;
    both when None) since the last :func:`reset_launch_count`."""
    if path is None:
        return sum(_applies.values())
    return _applies[path]


def count_apply(path: str) -> None:
    _applies[path] += 1


def reset_launch_count() -> None:
    """Zero both the launch and the apply counts."""
    for counts in (_launches, _applies):
        for key in counts:
            counts[key] = 0


def refusal(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor) -> str | None:
    """Why the kernel does not take the leaf ``(p, g, m, v)``, or None when
    it does.  The device is checked last, so the other reasons read the
    same on the CPU as on the card."""
    if any(type(x) not in _PLAIN for x in (p, g, m, v)):
        return "not a plain tensor"
    if p.dtype not in _DTYPES or g.dtype != p.dtype:
        return "p not bfloat16 or float32, or g not of p's dtype"
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        return "m or v not float32"
    if not p.shape == g.shape == m.shape == v.shape:
        return "shapes differ"
    if not (p.is_cuda and g.device == m.device == v.device == p.device):
        return "not on one CUDA device"
    return None


def _plain_on(x: torch.Tensor, device: torch.device) -> bool:
    return type(x) in _PLAIN and x.device == device and device.type == "cuda"


def tree_refusal(ps: list, gs: list, ms: list, vs: list) -> str | None:
    """Why the kernel does not take the whole apply, or None when every
    leaf passes :func:`refusal` and all lie on one device."""
    if not ps or not len(ps) == len(gs) == len(ms) == len(vs):
        return "no leaves, or trees of different sizes"
    for leaf in zip(ps, gs, ms, vs):
        why = refusal(*leaf) or (leaf[0].device != ps[0].device
                                 and "not on one CUDA device")
        if why:
            return why
    return None


def build() -> pathlib.Path:
    """Compile ``csrc/adamw.cu`` (once per source and flag set; see
    :func:`repro_torch.kernels._build.build_library`)."""
    global build_log
    out, log = build_library(SOURCE, NVCC_FLAGS, "adamw")
    if log:
        build_log = log
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ll, ci, vp, cf = (ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_float)
        lib.adamw_sumsq.argtypes = [vp, ci, ll, vp, ci, vp]
        lib.adamw_finalize.argtypes = [vp, ll, cf, cf, vp, vp, vp]
        lib.adamw_update.argtypes = [vp] * 7 + [ci, ll] + [vp] * 4 + \
            [cf] * 6 + [ci, vp]
        for fn in (lib.adamw_sumsq, lib.adamw_finalize, lib.adamw_update):
            fn.restype = ci
        lib.adamw_error_string.argtypes = [ci]
        lib.adamw_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.cache
def _max_blocks(index: int) -> int:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * BLOCKS_PER_SM


def _blocks(n: int, device: torch.device) -> int:
    return min(-(-n // (THREADS * VEC)), _max_blocks(device.index))


def _run(lib: ctypes.CDLL, entry: str, *args) -> None:
    code = getattr(lib, f"adamw_{entry}")(*args)
    if code != 0:
        raise RuntimeError(f"AdamW {entry} kernel launch failed ({code}): "
                           f"{lib.adamw_error_string(code).decode()}")
    _launches[entry] += 1


def global_norm(grads: list, clip_norm: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(gnorm, scale)``, two 0-d float32 tensors on the gradients' CUDA
    device: the norm of all of ``grads`` together (float32 or bfloat16)
    and ``min(1, clip_norm / max(gnorm, 1e-9))``.  One ``"sumsq"`` launch
    a non-empty leaf, then one ``"finalize"``."""
    dev = grads[0].device
    for g in grads:
        if not (_plain_on(g, dev) and g.dtype in _DTYPES):
            raise ValueError(f"the AdamW norm kernel takes plain float32 or "
                             f"bfloat16 tensors on one CUDA device, got "
                             f"{type(g).__name__} {g.dtype} "
                             f"{tuple(g.shape)} on {g.device}")
    grads = [g.contiguous() for g in grads]
    lib = _load()
    sizes = [(g, g.numel(), _blocks(g.numel(), dev)) for g in grads]
    partials = torch.empty(sum(b for _, n, b in sizes if n),
                           dtype=torch.float32, device=dev)
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    scale = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        at = partials.data_ptr()
        for g, n, blocks in sizes:
            if n:
                _run(lib, "sumsq", g.data_ptr(), _DTYPES[g.dtype], n, at,
                     blocks, stream)
                at += 4 * blocks
        _run(lib, "finalize", partials.data_ptr(), partials.numel(),
             clip_norm, NORM_FLOOR, gnorm.data_ptr(), scale.data_ptr(),
             stream)
    return gnorm, scale


def update(ps: list, gs: list, ms: list, vs: list, scale: torch.Tensor,
           lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor, *,
           b1: float, b2: float, eps: float, weight_decay: float
           ) -> tuple[list, list, list]:
    """New ``(ps, ms, vs)``, one ``"update"`` launch a non-empty leaf:
    AdamW's step with the 0-d float32 device tensors ``scale``, ``lr`` and
    the bias corrections ``bc1 = 1 - b1**t``, ``bc2 = 1 - b2**t``.  The
    inputs are left as they were."""
    why = tree_refusal(ps, gs, ms, vs)
    if why:
        raise ValueError(f"the AdamW kernel refuses the tree: {why}")
    dev = ps[0].device
    for x in (scale, lr, bc1, bc2):
        if not (_plain_on(x, dev) and x.dtype == torch.float32
                and x.numel() == 1):
            raise ValueError(f"AdamW's scalars are one-element float32 "
                             f"tensors on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    ps, gs, ms, vs = ([x.contiguous() for x in xs] for xs in (ps, gs, ms, vs))
    lib = _load()
    new_p = [torch.empty_like(p) for p in ps]
    new_m = [torch.empty_like(m) for m in ms]
    new_v = [torch.empty_like(v) for v in vs]
    hyper = (b1, 1 - b1, b2, 1 - b2, eps, weight_decay)
    scalars = [x.data_ptr() for x in (scale, lr, bc1, bc2)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for leaf in zip(ps, gs, ms, vs, new_p, new_m, new_v):
            n = leaf[0].numel()
            if n:
                _run(lib, "update", *(x.data_ptr() for x in leaf),
                     _DTYPES[leaf[0].dtype], n, *scalars, *hyper,
                     _blocks(n, dev), stream)
    return new_p, new_m, new_v
