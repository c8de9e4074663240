"""Shared neural-net building blocks on PyTorch tensors.

Counterpart of ``repro.models.common`` for one card.  Conventions kept
from the reference:

  * params are nested dicts of tensors; block params are stacked along a
    leading layer axis (``transformer`` loops over it);
  * activations default to bfloat16, norm and softmax math in float32;
  * layouts at every function are the reference's: activations
    ``[B, S, H, hd]``, weights ``[in, out]`` applied as ``x @ w``.

``remat_wrap`` is ``torch.utils.checkpoint``, with selective
checkpointing for the ``"dots"`` policy.  :func:`maybe_shard` is the
identity on a plain tensor and a ``redistribute`` on a ``DTensor`` (the
production-mesh audit of :mod:`repro_torch.launch.dryrun`).  The
``shard_map`` branch of ``_flash_bshd`` has no counterpart: on one card
the kernel always runs on the whole ``[B*H, S, hd]`` block.  Left out on
purpose: ``DP`` and ``TP`` (the axes are ``cfg.dp_axes`` and
:data:`repro_torch.distributed.sharding.TP`) and ``get_abstract_mesh``
(a ``DTensor`` carries its own mesh).  Nothing on the training
path writes in place into a tensor that autograd saved; ``write_kv``'s
in-place cache write serves decode only.

Stacked ``[L, ...]`` param trees are drawn with :func:`stack_layers` and
read a layer at a time through :func:`layer` (a view, no copy).
"""
from __future__ import annotations

import functools
import math
import sys

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.pytree import tree_map

NEG_INF = -1e30  # the reference's masked-score value
# leaves the reference keeps float32 whatever cfg.dtype is: the MoE router
# and Mamba2's per-head A, dt bias and skip
FLOAT32_LEAVES = frozenset({"router", "a_log", "dt_bias", "d_skip"})
# jax.nn.gelu's default is the tanh approximation
gelu_tanh = functools.partial(F.gelu, approximate="tanh")


def setting(cfg, name: str):
    """``cfg``'s value of a port-only setting
    (:class:`repro_torch.models.model.PortConfig`); a plain
    ``ModelConfig`` has none and reads the default, which gives its
    behaviour."""
    from .model import PortConfig       # model imports this module
    return getattr(cfg, name, getattr(PortConfig, name))


def experts_held(cfg) -> int:
    """How many experts a layer of ``cfg`` holds (all, unless told)."""
    return setting(cfg, "moe_experts_held") or cfg.moe_num_experts


# the products without batch dimensions that the "dots" policy keeps
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """The ``"dots"`` remat policy, the reference's
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
    outputs of products without batch dimensions (``aten.mm``,
    ``aten.addmm``: every ``x @ w``) are kept from the forward, and
    everything else is recomputed in the backward -- ``bmm`` (the
    experts' batched products, the einsums) and the flash forward, whose
    ``autograd.Function`` launches its kernel again as under ``"full"``."""
    if op in DOTS_SAVED:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def is_dtensor(x) -> bool:
    """Is ``x`` a ``torch.distributed.tensor.DTensor``?  False, without
    the import, while nothing has imported that module (then no tensor
    can be one, and the plain path does not pay for the import)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def maybe_shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """Activation-sharding anchor: lay ``x`` out as ``PartitionSpec(*axes)``.

    The identity on a plain tensor.  On a ``DTensor`` it is a
    ``redistribute`` over the tensor's own mesh, as the reference's
    ``with_sharding_constraint``: a dim whose named axes (those the mesh
    has) divide it is sharded over them, every other mesh axis is
    replicated.
    """
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    placements = [Replicate()] * mesh.ndim
    for i, a in enumerate(axes):
        parts = [names.index(p) for p in
                 (a if isinstance(a, tuple) else (a,)) if p in names]
        if parts and x.shape[i] % math.prod(
                mesh.size(m) for m in parts) == 0:
            for m in parts:
                placements[m] = Shard(i)
    return x.redistribute(mesh, placements)


def remat_wrap(fn, cfg):
    """``fn`` recomputed in the backward instead of keeping its
    activations (``jax.checkpoint`` in the reference):
    ``torch.utils.checkpoint`` without reentrance, so the recompute runs
    the same flash forward again.  ``cfg.remat_policy == "dots"`` keeps
    the products without batch dimensions (:func:`dots_policy`, through
    selective checkpointing); any other policy recomputes everything, as
    the reference's ``"full"``."""
    extra = {}
    if cfg.remat_policy == "dots":
        extra["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            dots_policy)

    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False,
                                                 **extra)

    return wrapped


def to_device(tree, device: torch.device):
    return tree_map(lambda x: x.to(device), tree)


def stack_layers(n: int, draw) -> dict:
    """``n`` draws of a block's param tree stacked along a leading layer
    axis: the stacked tensors are allocated on the first draw's device and
    each draw is copied in as it comes, so the device holds the stack and
    one block, and the host one weight, at a time."""
    first = draw()
    out = tree_map(lambda x: torch.empty((n,) + tuple(x.shape),
                                         dtype=x.dtype, device=x.device),
                   first)
    for i in range(n):
        tree = first if i == 0 else draw()
        tree_map(lambda dst, src: dst[i].copy_(src), out, tree)
        first = tree = None
    return out


def layer(tree, i: int):
    """Layer ``i``'s view of a stacked ``[L, ...]`` tree (no copy)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def truncated_normal(gen: torch.Generator, shape, dtype: torch.dtype,
                     scale: float) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``, drawn in
    float32 on the CPU from ``gen`` and cast to ``dtype``."""
    x = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, *, scale: float | None = None
               ) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return truncated_normal(gen, (in_dim, out_dim), dtype, scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(d: int, kind: str, dtype: torch.dtype) -> dict:
    if kind == "rmsnorm":
        return {"w": torch.ones((d,), dtype=dtype)}
    if kind == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype),
                "b": torch.zeros((d,), dtype=dtype)}
    if kind == "nonparam_ln":  # OLMo: LayerNorm without affine params
        return {}
    raise ValueError(kind)


def apply_norm(params: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (y * params["w"].float()).to(x.dtype)
    mean = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, -1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["w"].float() + params["b"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split halves, as the reference)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 mscale ln(factor) + 1`` (1 for a
    factor of at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(dim: int, theta: float,
               original_max: int) -> tuple[int, int]:
    """The frequency indices between which YaRN ramps from the original
    frequencies (below ``low``) to the interpolated ones (above
    ``high``): where a dimension turns 32 and 1 times over
    ``original_max`` positions (the published beta_fast and beta_slow,
    which the port fixes)."""
    def dim_of(rotations):
        return (dim * math.log(original_max / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(dim_of(32)), 0),
            min(math.ceil(dim_of(1)), dim - 1))


def rope_inv_freq(cfg, dim: int, device=None) -> torch.Tensor:
    """The [dim/2] float32 inverse frequencies of ``cfg``'s rotary
    embedding over ``dim`` dimensions: plain, or YaRN's where the config
    sets ``rope_yarn_factor`` (:class:`repro_torch.models.model.PortConfig`;
    the published ``DeepseekV2YarnRotaryEmbedding``'s arithmetic)."""
    extra = rope_freqs(dim, cfg.rope_theta, device)
    factor = setting(cfg, "rope_yarn_factor")
    if not factor:
        return extra
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device) / dim
    inter = 1.0 / (factor * cfg.rope_theta ** exponent)
    low, high = yarn_range(dim, cfg.rope_theta,
                           setting(cfg, "rope_yarn_original_max"))
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4, *,
               inv_freq: torch.Tensor | None = None) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].
    ``inv_freq`` [hd/2] replaces the plain frequencies of ``theta``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device) if inv_freq is None \
        else inv_freq                                         # [hd/2]
    ang = positions[..., :, None, None].float() * freqs       # [..., S,1,hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / sliding-window / cross)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, dtype: torch.dtype) -> dict:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, n_kv * head_dim, dtype),
        "wv": dense_init(gen, d_model, n_kv * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype,
                         scale=1.0 / math.sqrt(n_heads * head_dim)),
    }


def _sdpa(q, k, v, mask, *, grouped: bool = False) -> torch.Tensor:
    """q: [B,S,H,hd]; k/v: [B,T,Hkv,hd]; mask: [B?,1,S,T] bool, or None
    for no mask.

    ``grouped=True`` contracts GQA with a grouped einsum instead of
    repeating K/V per head; the function is the same.  On DTensors it runs
    :func:`_sdpa_local`.
    """
    if is_dtensor(q):
        return _sdpa_local(q, k, v, mask, grouped=grouped)
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    if rep > 1 and grouped:
        qg = q.reshape(b, s, hkv, rep, hd)
        scores = torch.einsum("bsgrd,btgd->bgrst", qg, k).float()
        scores = scores.reshape(b, h, s, -1) / math.sqrt(hd)
        if mask is not None:
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        pg = probs.reshape(b, hkv, rep, s, -1)
        out = torch.einsum("bgrst,btgd->bsgrd", pg, v)
        return out.reshape(b, s, h, hd)
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _sdpa_local(q, k, v, mask, *, grouped: bool) -> torch.Tensor:
    """:func:`_sdpa` of DTensors, run on each rank's own batch rows and
    heads, as the reference's partitioner runs it (and its ``shard_map``
    the flash kernel): q, k and v are laid out with the largest one's
    shards of dims 0 (batch) and 2 (heads) (q's on a tie; a decode
    step's cache otherwise) and every other mesh axis replicated (K/V
    heads repeated first where they do not divide as the heads are
    split), the mask (a plain tensor) applies whole, and the result has
    that layout.  The scores' einsum would otherwise merge two sharded
    dims into one, which ``DTensor`` does not do in every version."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    lead = max((q, k, v), key=lambda t: t.numel())
    place = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                  else Replicate() for p in lead.placements)
    head_shards = math.prod(mesh.size(m) for m, p in enumerate(place)
                            if p == Shard(2))
    b, t, hkv, _ = k.shape
    rep = q.shape[2] // hkv
    if rep > 1 and hkv % head_shards:
        k, v = (x[:, :, :, None].expand(b, t, hkv, rep, x.shape[-1])
                .reshape(b, t, hkv * rep, x.shape[-1]) for x in (k, v))
    for x in (q, k, v):
        for m, p in enumerate(place):
            if isinstance(p, Shard) and x.shape[p.dim] % mesh.size(m):
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does "
                                 f"not divide over mesh axis {m}")
    q, k, v = (_ContiguousGrad.apply(x.redistribute(mesh, place).to_local())
               for x in (q, k, v))
    out = _sdpa(q, k, v, mask, grouped=grouped)
    return DTensor.from_local(out, mesh, place, run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: the
    einsums' backward leaves a local shard's gradient transposed, and
    ``DTensor`` then views it, which a transposed shard refuses."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _sdpa_chunked(q, k, v, *, window: int, chunk: int) -> torch.Tensor:
    """Query-chunked causal attention: the function of :func:`_sdpa` with a
    causal (optionally sliding-window) mask, with the live score tensor
    bounded to [B, H, chunk, T].  (The reference's ``unroll`` switch only
    chooses how XLA sees the loop; here it is always a Python loop.)"""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if h // hkv > 1:
        k = torch.repeat_interleave(k, h // hkv, dim=2)
        v = torch.repeat_interleave(v, h // hkv, dim=2)
    kpos = torch.arange(s, device=q.device)[None, :]
    outs = []
    for i in range(s // chunk):
        qc = q[:, i * chunk:(i + 1) * chunk]
        qpos = i * chunk + torch.arange(chunk, device=q.device)[:, None]
        m = kpos <= qpos
        if window > 0:
            m &= kpos > qpos - window
        sc = torch.einsum("bshd,bthd->bhst", qc, k).float() / math.sqrt(hd)
        sc = torch.where(m[None, None], sc, NEG_INF)
        pr = torch.softmax(sc, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhst,bthd->bshd", pr, v))
    return torch.cat(outs, dim=1)


def causal_mask(s: int, t: int, window: int = 0, device=None) -> torch.Tensor:
    """[1,1,S,T] causal (optionally sliding-window) mask; t >= s offsets."""
    qpos = torch.arange(s, device=device)[:, None] + (t - s)
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, None]


def _flash_bshd(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """[B,S,H,hd] -> the flash kernel on [B*H, S, hd] (GQA repeated here,
    outside the kernel, as the reference does); ``scale`` defaults to
    1/sqrt(hd)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)

    def to_bhsd(x):
        return x.movedim(2, 1).reshape(b * h, s, x.shape[-1]).contiguous()

    out = kops.flash_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                               scale=(1.0 / math.sqrt(hd) if scale is None
                                      else scale))
    return out.reshape(b, h, s, -1).movedim(1, 2)


def write_kv(kv_cache: dict, k: torch.Tensor, v: torch.Tensor,
             cache_pos: int) -> dict:
    """Write K/V [B, s, Hkv, hd] at ``cache_pos`` of a layer's cache
    {'k','v'} [B, T, Hkv, hd], **in place** (the reference returns an
    updated copy).  Raises unless ``cache_pos + s <= T``: the reference's
    ``dynamic_update_slice`` would silently clamp the start instead."""
    s, t = k.shape[1], kv_cache["k"].shape[1]
    if not 0 <= cache_pos <= t - s:
        raise ValueError(f"cache position {cache_pos} + {s} new tokens "
                         f"exceeds the cache length {t}")
    kv_cache["k"][:, cache_pos:cache_pos + s] = k.to(kv_cache["k"].dtype)
    kv_cache["v"][:, cache_pos:cache_pos + s] = v.to(kv_cache["v"].dtype)
    return kv_cache


def attention(params, x, positions, *, n_heads, n_kv, head_dim,
              rope_theta=1e4, window=0, kv_cache=None, cache_pos=None,
              use_rope=True, chunk_q=0, attn_impl="xla", grouped=False):
    """Self-attention.  With ``kv_cache`` = {'k','v'} [B, T, n_kv, hd] it
    runs a decode step: writes K/V at ``cache_pos`` (in place, see
    :func:`write_kv`) and attends over positions <= cache_pos + s - 1."""
    b, s, d = x.shape
    q = (x @ params["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, s, n_kv, head_dim)
    v = (x @ params["wv"]).reshape(b, s, n_kv, head_dim)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if kv_cache is None:
        if attn_impl == "flash" and window == 0 and s >= 128:
            out = _flash_bshd(q, k, v)
        elif chunk_q > 0 and s % chunk_q == 0 and s > chunk_q:
            out = _sdpa_chunked(q, k, v, window=window, chunk=chunk_q)
        else:
            out = _sdpa(q, k, v, causal_mask(s, s, window, x.device),
                        grouped=grouped)
        new_cache = None
    else:
        new_cache = write_kv(kv_cache, k, v, cache_pos)
        t = kv_cache["k"].shape[1]
        kpos = torch.arange(t, device=x.device)[None, :]
        valid = kpos <= (cache_pos + s - 1)     # decode chunks use s == 1
        if window > 0:
            valid &= kpos > (cache_pos + s - 1 - window)
        out = _sdpa(q, new_cache["k"].to(q.dtype), new_cache["v"].to(q.dtype),
                    valid[None, None], grouped=grouped)
    out = out.reshape(b, s, n_heads * head_dim) @ params["wo"]
    return out, new_cache


def init_cross_attention(gen: torch.Generator, d_model: int, n_heads: int,
                         head_dim: int, dtype: torch.dtype) -> dict:
    return init_attention(gen, d_model, n_heads, n_heads, head_dim, dtype)


def cross_attention(params, x, enc, *, n_heads, head_dim) -> torch.Tensor:
    """x: [B, S, D] attends, unmasked and without RoPE, to enc: [B, T, D]."""
    b, s, _ = x.shape
    t = enc.shape[1]
    q = (x @ params["wq"]).reshape(b, s, n_heads, head_dim)
    k = (enc @ params["wk"]).reshape(b, t, n_heads, head_dim)
    v = (enc @ params["wv"]).reshape(b, t, n_heads, head_dim)
    out = _sdpa(q, k, v, None)
    return out.reshape(b, s, n_heads * head_dim) @ params["wo"]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, *, gated: bool = True) -> dict:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype),
         "w_down": dense_init(gen, d_ff, d_model, dtype,
                              scale=1.0 / math.sqrt(d_ff))}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp(params, x, *, gated: bool = True, act=F.silu) -> torch.Tensor:
    up = x @ params["w_up"]
    up = act(x @ params["w_gate"]) * up if gated else act(up)
    return up @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d_model: int,
               dtype: torch.dtype, *, tie: bool = True) -> dict:
    p = {"tok": truncated_normal(gen, (vocab, d_model), dtype, 0.02)}
    if not tie:
        p["head"] = dense_init(gen, d_model, vocab, dtype)
    return p


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(tokens):
        # the same gather, through the op DTensor has a layout rule for
        # (its rule for the indexing's backward is not in every version);
        # a vocab-parallel table's partial rows are summed here, as the
        # reference's partitioner sums them
        from torch.distributed.tensor import Replicate
        out = F.embedding(tokens, params["tok"])
        return out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return params["tok"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        return x @ params["head"]
    return x @ params["tok"].T


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple
