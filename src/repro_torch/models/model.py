"""Unified model API: one config dataclass + family dispatch.

Counterpart of ``repro.models.model`` for the dense family (the serving
and training paths):

    init_params(cfg, generator, device=)          -> params dict
    prefill_logits(cfg, params, batch)            -> [B, S, vocab] float32
    loss_fn(cfg, params, batch)                   -> scalar float32 loss
    init_cache(cfg, batch, max_len, device=)      -> KV cache dict
    serve_step(cfg, params, cache, batch)         -> (logits [B, vocab], cache)

``batch`` is a dict: 'tokens' [B, S] (a tensor on the params' device),
plus 'labels' [B, S] for the loss and the int 'pos' during decode.  The
other families (moe, ssm, hybrid, encdec, vlm) raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import common as cm
from . import transformer

PORTED_FAMILIES = ("dense",)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Every field of the reference's ``ModelConfig``.

    ``dtype`` is a ``torch.dtype``.  On one card these fields are
    accepted and have no effect: ``dp_axes``, ``moe_ep_shard`` and
    ``moe_local_dispatch`` (sharding).  ``remat`` recomputes each block in
    the backward (``torch.utils.checkpoint``); ``remat_policy`` takes
    ``"full"`` only.  ``scan_layers=False`` computes the same function as
    ``True``: both are a loop over the stacked layers here.
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


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 item 12); ported: {PORTED_FAMILIES}")
    if cfg.use_mla or cfg.moe_num_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA blocks are not ported yet "
            "(ROADMAP Queue 1 item 12)")


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: str | torch.device = "cuda") -> dict:
    """Random params drawn from ``generator`` (a CPU generator; the same
    seed gives the same weights on every device), placed on ``device``."""
    dev = resolve_device(device)
    _check_family(cfg)
    return transformer.init(generator, cfg, dev)


def prefill_logits(cfg: ModelConfig, params: dict, batch: dict
                   ) -> torch.Tensor:
    _check_family(cfg)
    return transformer.forward(cfg, params, batch["tokens"], remat=cfg.remat)


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
    _check_family(cfg)
    return transformer.init_cache(cfg, batch, max_len, dev)


def serve_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict):
    """One decode step: batch = {'tokens': [B, 1], 'pos': int}.  The cache
    is updated in place and returned."""
    _check_family(cfg)
    return transformer.decode_step(cfg, params, cache, batch["tokens"],
                                   int(batch["pos"]))


def param_count(params: dict) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
