"""Plain float32 PyTorch reference of DeepSeek-V2 (arXiv:2405.04434;
``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2) over the share of it
that one chip holds.

It imports nothing of the program.  It reads the weights the benchmark
drew (bfloat16, as served), by the keys of the benchmark's tree, one
layer at a time in float32, and computes with TF32 off.  The model is the
configuration as run (:func:`bench.reference.lm.as_run`):

* pre-norm blocks, RMSNorm with the file's eps; the first
  ``first_k_dense_replace`` blocks (``dense_blocks``) with a dense MLP of
  width ``intermediate_size``, the rest with the expert layer;
* MLA: q = RMSNorm(x W_qa) W_qb split per head into a no-rope part
  (``qk_nope_head_dim``) and a rope part (``qk_rope_head_dim``); the
  latent c = RMSNorm((x W_kva)[:kv_lora_rank]) and one rope key shared
  by the heads, the rest of x W_kva; per head k = [c W_uk, rope key],
  v = c W_uv; causal softmax(scale q k^T) v, computed in query blocks so
  that 16K positions fit; out W_o;
* the rotary embedding on the rope parts: split halves (the published
  checkpoint's interleaved pairs are a fixed permutation of the rope
  columns of W_qb and W_kva), at YaRN's frequencies (:func:`yarn_inv_freq`),
  cos and sin times mscale(factor, mscale) / mscale(factor,
  mscale_all_dim); scale = (qk_nope + qk_rope)^-1/2 times
  mscale(factor, mscale_all_dim)^2;
* the expert layer: the router's softmax over all published experts;
  for ``group_limited_greedy`` the experts in ``n_group`` groups, each
  scored by its best probability, the ``topk_group`` best kept and the
  top k taken among their experts; weights renormalised where
  ``norm_topk_prob``, else times ``routed_scaling_factor``; only the
  choices of the experts held here (``n_routed_experts`` from
  ``deployment.expert_group`` times as many) are computed, each expert
  keeping at most C = int(f N k / E) + 1 of the N tokens' choices (E the
  published count, f the file's ``capacity_factor``; N <= 64: all), first
  come by token; plus the ``n_shared_experts`` experts, one MLP of their
  summed width, on every token;
* the head: final RMSNorm, then x W_h over the padded vocabulary.

``forward(tokens, experts=...)`` follows given expert choices (one
[N, k] id tensor an expert layer) in place of its own top-k, weighting
them by its own probabilities; its own choices at its own inputs are kept
in ``choices`` either way.  That separates what the routing decides from
the rest of the arithmetic: in bf16 a near-tie among the router's scores
breaks otherwise than in float32 for some tokens, and random weights let
each such change grow through the later layers.

``matmul="fp8"`` rounds both operands of every weight product and of
attention's two products to float8 e4m3 at a per-tensor scale, as
:mod:`bench.reference.lm` does: the control a comparison has to fail.
"""
from __future__ import annotations

import math

import torch

from bench.reference import lm

# query rows a block of the causal attention computes at a time
ATTN_BLOCK = 256


def yarn_mscale(scale: float = 1, mscale: float = 1) -> float:
    """``yarn_get_mscale`` as published."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(low_rot, high_rot, dim, base, max_pos):
    """``yarn_find_correction_range`` as published."""
    def find_dim(rot):
        return (dim * math.log(max_pos / (rot * 2 * math.pi))) / \
            (2 * math.log(base))
    low = math.floor(find_dim(low_rot))
    high = math.ceil(find_dim(high_rot))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(dim: int, base: float, rope: dict | None,
                  device=None) -> torch.Tensor:
    """The inverse frequencies of ``DeepseekV2YarnRotaryEmbedding``
    (plain ones without ``rope``), float32."""
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** ar)
    if not rope:
        return freq_extra
    factor = rope["factor"]
    freq_inter = 1.0 / (factor * base ** ar)
    low, high = yarn_correction_range(
        rope["beta_fast"], rope["beta_slow"], dim, base,
        rope["original_max_position_embeddings"])
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


class Model(lm.Model):
    """The reference over one weight tree (the chip's share of the
    model)."""

    def __init__(self, cfg: dict, params: dict, *, matmul: str = "float32",
                 remat: bool = False):
        lm.no_tf32()
        if matmul not in ("float32", "fp8"):
            raise ValueError(matmul)
        self.cfg, self.p, self.remat = cfg, params, remat
        self.fp8 = matmul == "fp8"
        self.eps = lm.as_run(cfg, "rms_norm_eps")
        self.h = cfg["num_attention_heads"]
        self.nope, self.rope_dim = (cfg["qk_nope_head_dim"],
                                    cfg["qk_rope_head_dim"])
        self.rope_cfg = lm.as_run(cfg, "rope_scaling")
        self.scale = (self.nope + self.rope_dim) ** -0.5
        self.cos_sin_scale = 1.0
        if self.rope_cfg:
            f = self.rope_cfg["factor"]
            all_dim = self.rope_cfg.get("mscale_all_dim", 0)
            if all_dim:
                self.scale *= yarn_mscale(f, all_dim) ** 2
            self.cos_sin_scale = (yarn_mscale(f, self.rope_cfg["mscale"])
                                  / yarn_mscale(f, all_dim))
        self.n_dense = cfg["first_k_dense_replace"]
        self.choices: list = []
        self.follow = None

    def forward(self, tokens: torch.Tensor, patches=None,
                experts: list | None = None) -> torch.Tensor:
        """Logits [B, S, padded vocab]; with ``experts``, each expert
        layer follows its entry's choices."""
        self.choices = []
        self.follow = None if experts is None else iter(experts)
        return super().forward(tokens, patches)

    def layer(self, i: int) -> dict:
        def pick(t, j):
            return {k: pick(v, j) for k, v in t.items()} \
                if isinstance(t, dict) else t[j]
        if i < self.n_dense:
            return pick(self.p["dense_blocks"], i)
        return pick(self.p["blocks"], i - self.n_dense)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x: [B, S, H, d]; pos: [S]."""
        inv = yarn_inv_freq(x.shape[-1], float(self.cfg["rope_theta"]),
                            self.rope_cfg, x.device)
        ang = pos.float()[:, None, None] * inv
        cos = torch.cos(ang) * self.cos_sin_scale
        sin = torch.sin(ang) * self.cos_sin_scale
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def product(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b (batched) in float32, or of float8 operands."""
        return lm._Fp8Matmul.apply(a, b) if self.fp8 else a @ b

    def attention(self, p: dict, x: torch.Tensor, pos: torch.Tensor
                  ) -> torch.Tensor:
        b, s, _ = x.shape
        h, r = self.h, self.cfg["kv_lora_rank"]
        if "w_q_a" in p:
            q = self.mm(self.norm(self.mm(x, p["w_q_a"]), p["q_a_norm"]["w"]),
                        p["w_q_b"])
        else:
            q = self.mm(x, p["w_q"])
        q = q.view(b, s, h, self.nope + self.rope_dim)
        q_pe = self.rope(q[..., self.nope:], pos)
        kv = self.mm(x, p["w_kv_a"])
        c = self.norm(kv[..., :r], p["kv_a_norm"]["w"])
        k_pe = self.rope(kv[..., r:][:, :, None], pos)       # [B, S, 1, dr]
        # per head: [B, 1, S, r] @ [H, r, d] -> [B, H, S, d]
        k_nope = self.product(c[:, None], p["w_uk"].float())
        v = self.product(c[:, None], p["w_uv"].float())
        q = torch.cat([q[..., :self.nope], q_pe], -1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe.transpose(1, 2).expand(
            b, h, s, self.rope_dim)], -1)
        out = torch.empty((b, h, s, v.shape[-1]), device=x.device)
        for i0 in range(0, s, ATTN_BLOCK):
            i1 = min(s, i0 + ATTN_BLOCK)
            scores = self.product(q[:, :, i0:i1],
                                  k[:, :, :i1].transpose(-1, -2)) * self.scale
            causal = pos[None, :i1] <= pos[i0:i1, None]
            scores = scores.masked_fill(~causal, float("-inf"))
            out[:, :, i0:i1] = self.product(scores.softmax(-1), v[:, :, :i1])
        return self.mm(out.transpose(1, 2).reshape(b, s, -1), p["wo"])

    def moe(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        n, k = b * s, cfg["num_experts_per_tok"]
        e = cfg["published"]["n_routed_experts"]
        held = cfg["n_routed_experts"]
        first = cfg["deployment"]["expert_group"] * held
        xf = x.reshape(n, d)
        probs = torch.softmax(xf @ p["router"].float(), -1)       # [N, E]
        scores = probs
        if lm.as_run(cfg, "topk_method") == "group_limited_greedy":
            groups = cfg["n_group"]
            best = probs.view(n, groups, -1).max(-1).values
            idx = torch.topk(best, k=cfg["topk_group"], dim=-1)[1]
            mask = torch.zeros_like(best).scatter_(1, idx, 1)
            mask = mask[:, :, None].expand(n, groups, e // groups)
            scores = probs.masked_fill(~mask.reshape(n, e).bool(), 0.0)
        top_w, top_e = torch.topk(scores, k=k, dim=-1)
        self.choices.append(top_e)
        if self.follow is not None:
            top_e = next(self.follow).to(top_e.device).reshape(n, k)
            top_w = probs.gather(1, top_e)
        if lm.as_run(cfg, "norm_topk_prob"):
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
        else:
            top_w = top_w * lm.as_run(cfg, "routed_scaling_factor")
        f = lm.as_run(cfg, "capacity_factor")
        cap = n if n <= 64 else int(f * n * k / e) + 1
        y = torch.zeros_like(xf)
        flat = top_e.reshape(-1)
        for ex in range(first, first + held):
            pairs = torch.nonzero(flat == ex).flatten()[:cap]
            if pairs.numel() == 0:
                continue
            tok = pairs // k
            w = {name: p[name][ex - first]
                 for name in ("w_gate", "w_up", "w_down")}
            out = self.ffn(w, xf[tok]) * top_w.reshape(-1)[pairs][:, None]
            y = y.index_add(0, tok, out)
        if "shared" in p:
            y = y + self.ffn(p["shared"], xf)
        return y.reshape(b, s, d)
