"""Checkpointing: atomic, with the reference's on-disk layout.

Counterpart of ``repro.checkpoint.ckpt``.  Layout: ``<dir>/step_<n>/``
holding ``arrays.npz`` (one array per leaf, keyed by its path, e.g.
``params/blocks/attn/wq``) and ``manifest.json`` (step, sorted keys,
``dtypes`` tags, ``complete``).  Writes go to a tmp dir + atomic rename,
so a crash mid-save never corrupts the latest checkpoint.  bfloat16
leaves are stored as a uint16 view with the "bfloat16" tag, as the
reference stores them, so either package restores the other's
checkpoints.

``restore`` returns a tree of CPU tensors; ``place`` moves it to a device.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.pytree import items, tree_map, unflatten


def _to_numpy(x: torch.Tensor) -> tuple[np.ndarray, str | None]:
    """(array, dtype tag): numpy has no bfloat16, so a bf16 leaf is stored
    as its uint16 view, tagged."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return x.numpy(), None


def _from_numpy(arr: np.ndarray, tag: str | None) -> torch.Tensor:
    if tag is None:
        return torch.from_numpy(np.array(arr))
    if tag != "bfloat16":
        raise ValueError(f"checkpoint dtype tag {tag!r} is not supported "
                         "by the port (only 'bfloat16')")
    return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)


def save(ckpt_dir: str | os.PathLike, step: int, tree) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat, dtypes = {}, {}
    for key, leaf in items(tree):
        flat[key], tag = _to_numpy(leaf)
        if tag is not None:
            dtypes[key] = tag
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "manifest.json").write_text(json.dumps({
            "step": step, "keys": sorted(flat.keys()), "dtypes": dtypes,
            "complete": True}))
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best = None
    for d in sorted(ckpt_dir.glob("step_*")):
        man = d / "manifest.json"
        if man.exists() and json.loads(man.read_text()).get("complete"):
            best = int(d.name.split("_")[1])
    return best


def restore(ckpt_dir: str | os.PathLike, step: int, like_tree):
    """Load the leaves for ``step`` shaped like ``like_tree``: a tree of
    CPU tensors in the stored dtypes (see :func:`place`)."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    dtypes = json.loads((d / "manifest.json").read_text()).get("dtypes", {})
    out = []
    with np.load(d / "arrays.npz") as data:
        for key, like in items(like_tree):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            x = _from_numpy(data[key], dtypes.get(key))
            if tuple(x.shape) != tuple(like.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(x.shape)} "
                                 f"!= expected {tuple(like.shape)}")
            out.append(x)
    return unflatten(like_tree, out)


def place(host_tree, device: str | torch.device = "cuda"):
    """Move a restored tree onto ``device`` (the card by default; raises
    without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev), host_tree)


def prune(ckpt_dir: str | os.PathLike, keep: int = 3) -> None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    steps = sorted(d for d in ckpt_dir.glob("step_*") if d.is_dir())
    for d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
