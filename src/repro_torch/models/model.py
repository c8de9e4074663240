"""Unified model API: one config dataclass + family dispatch.

Counterpart of ``repro.models.model`` for all six families: dense and
moe (dense, MoE and MLA blocks), vlm (the dense backbone behind a patch
prefix), ssm (xLSTM), hybrid (Zamba2) and encdec (Whisper):

    init_params(cfg, generator, device=)          -> params dict
    param_shapes(cfg)                             -> the same tree on "meta"
    prefill_logits(cfg, params, batch)            -> [B, S, vocab] float32
    loss_fn(cfg, params, batch)                   -> scalar float32 loss
    init_cache(cfg, batch, max_len, device=)      -> cache / state dict
    serve_step(cfg, params, cache, batch)         -> (logits [B, vocab], cache)

``batch`` is a dict of tensors on the params' device: 'tokens' [B, S],
plus 'labels' [B, S] for the loss, 'frames' [B, T, D] for the audio stub
(encdec), 'patches' [B, P, D] for the vision stub (vlm), and during
decode the int 'pos' and, for encdec, 'enc_out' [B, T, D].  An unknown
family raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import common as cm
from . import encdec, hybrid, ssm, transformer

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Every field of the reference's ``ModelConfig``.

    ``dtype`` is a ``torch.dtype``.  On one card these fields are
    accepted and have no effect: ``dp_axes``, ``moe_ep_shard`` and
    ``moe_local_dispatch`` (sharding); the first two name the layouts
    that :func:`repro_torch.models.common.maybe_shard` asks of a
    ``DTensor``.  ``remat`` recomputes each block in
    the backward (``torch.utils.checkpoint``); ``remat_policy`` is
    ``"full"`` or ``"dots"``.  ``scan_layers=False`` computes the same
    function as ``True``: both are a loop over the stacked layers here.
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
    rope_theta: float = 1e4
    # attention pattern
    sliding_window: int = 0
    local_global_pattern: int = 0    # gemma3: 6 => 5 local + 1 global
    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # MLA
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # SSM / hybrid
    ssm_state: int = 0
    mamba_headdim: int = 64
    mamba_dconv: int = 4
    attn_every: int = 0
    # enc-dec / stubs
    dec_layers: int = 0
    num_frames: int = 0
    num_patches: int = 0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    scan_layers: bool = True
    # query-chunked attention: live score tensor [B, H, chunk, T]
    attn_chunk_q: int = 0
    remat_policy: str = "full"
    dp_axes: tuple = ("pod", "data")
    moe_ep_shard: bool = False
    # attention for causal prefill: 'xla' (einsum softmax) or 'flash' (the
    # hand-written kernel, kernels/flash.py; full causal attention only)
    attn_impl: str = "xla"
    # GQA contraction via grouped einsum (no materialized K/V repeat)
    gqa_grouped: bool = False
    moe_local_dispatch: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return cm.pad_vocab(self.vocab_size)

    @property
    def sub_quadratic(self) -> bool:
        """Can this config decode at 500k context? (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: str | torch.device = "cuda") -> dict:
    """Random params drawn from ``generator`` (a CPU generator; the same
    seed gives the same weights on every device), placed on ``device``."""
    return _init(cfg, generator, resolve_device(device))


def param_shapes(cfg: ModelConfig) -> dict:
    """The tree :func:`init_params` builds, as meta tensors: every leaf's
    shape and dtype, no storage and no draw (the counterpart of
    ``jax.eval_shape`` of the reference's ``init_params``; a full
    deepseek-v2-236b tree costs a few seconds of host time)."""
    meta = torch.device("meta")
    with meta:
        return _init(cfg, torch.Generator(), meta)


def _init(cfg: ModelConfig, generator: torch.Generator,
          dev: torch.device) -> dict:
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.init(generator, cfg, dev)
    if cfg.family == "ssm":
        return ssm.xlstm_init(generator, cfg, dev)
    if cfg.family == "hybrid":
        return hybrid.init(generator, cfg, dev)
    if cfg.family == "encdec":
        return encdec.init(generator, cfg, dev)
    raise ValueError(cfg.family)


def prefill_logits(cfg: ModelConfig, params: dict, batch: dict
                   ) -> torch.Tensor:
    tokens = batch["tokens"]
    if cfg.family in ("dense", "moe"):
        return transformer.forward(cfg, params, tokens, remat=cfg.remat)
    if cfg.family == "vlm":
        return transformer.forward(cfg, params, tokens,
                                   extra_embeds=batch.get("patches"),
                                   remat=cfg.remat)
    if cfg.family == "ssm":
        return ssm.xlstm_forward(cfg, params, tokens, remat=cfg.remat)
    if cfg.family == "hybrid":
        return hybrid.forward(cfg, params, tokens, remat=cfg.remat)
    if cfg.family == "encdec":
        return encdec.forward(cfg, params, batch["frames"], tokens,
                              remat=cfg.remat)
    raise ValueError(cfg.family)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Causal-LM cross entropy (labels = next tokens, -1 = masked): float32
    log-softmax over the padded vocab, the mean over unmasked positions."""
    logits = prefill_logits(cfg, params, batch)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.init_cache(cfg, batch, max_len, dev)
    if cfg.family == "ssm":
        return ssm.xlstm_state(cfg, batch, dev)
    if cfg.family == "hybrid":
        return hybrid.init_cache(cfg, batch, max_len, dev)
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, dev)
    raise ValueError(cfg.family)


def serve_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One decode step: batch = {'tokens': [B, 1], 'pos': int, ...}.  The
    cache (the recurrent state for ssm) is updated in place and
    returned."""
    tokens, pos = batch["tokens"], int(batch["pos"])
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.decode_step(cfg, params, cache, tokens, pos)
    if cfg.family == "ssm":
        return ssm.xlstm_decode_step(cfg, params, cache, tokens, pos)
    if cfg.family == "hybrid":
        return hybrid.decode_step(cfg, params, cache, tokens, pos)
    if cfg.family == "encdec":
        return encdec.decode_step(cfg, params, cache, tokens, pos,
                                  batch["enc_out"])
    raise ValueError(cfg.family)


def param_count(params: dict) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def active_param_count(cfg: ModelConfig, params: dict) -> int:
    """Params touched per token (MoE counts top-k + shared experts only)."""
    total = param_count(params)
    if cfg.moe_num_experts <= 0:
        return total
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    routed_total = cfg.num_layers * cfg.moe_num_experts * per_expert
    routed_active = cfg.num_layers * cfg.moe_top_k * per_expert
    return total - routed_total + routed_active
