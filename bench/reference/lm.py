"""Plain float32 PyTorch reference of the attention LMs the benchmark runs:
phi-3-vision's phi-3-mini backbone behind its patch embeddings, and
OLMoE's blocks of 64 experts, top 8.

It imports nothing of the program.  It reads the weights the benchmark
drew (bfloat16, as served), by the keys of the benchmark's tree, one
layer at a time in float32, and computes with TF32 off.  The model it
computes is the configuration as run: the file's published values, except
where its ``departures`` give what the program runs instead (:func:`as_run`):

* pre-norm blocks: x + attn(rmsnorm(x)), then x + ffn(rmsnorm(x)), RMSNorm
  with the file's eps and a float32 weight;
* attention: q, k, v = x Wq, x Wk, x Wv; rotary embedding on split halves
  (theta from the file) at positions counted over patches and tokens;
  causal softmax(q k^T / sqrt(hd)) v; out Wo;
* ffn: (silu(x Wg) * x Wu) Wd; or the router's softmax over the experts,
  the top k by descending weight (ties to the lower index), weights
  renormalised to sum 1 where ``norm_topk_prob``, each expert's ffn
  weighted and summed over the kept choices; an expert keeps at most
  C = int(f N k / E) + 1 of the N tokens' choices (f the file's
  ``capacity_factor``; N <= 64: all), first come by (token, choice);
* the head: final RMSNorm, then x Wh, or x E^T where tied, over the
  vocabulary padded to a multiple of 256 as the head is drawn.

``matmul="fp8"`` rounds both operands of every weight product and of
attention's two products (q k^T, then the probabilities times v) to
float8 e4m3 with a per-tensor scale, and in the backward the incoming
gradient to e5m2: the control a comparison has to fail.
``remat`` recomputes each block in the backward, so a training step's
reference fits beside its float32 optimizer state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


def as_run(cfg: dict, key: str, default=None):
    """The configuration's value of ``key`` as run: its ``departures``
    entry where it has one, else the published value."""
    return cfg.get("departures", {}).get(key, cfg.get(key, default))


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to a float8 format at a per-tensor scale."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """x @ w of float8 operands, as fp8 training computes it: e4m3 inputs
    and weights forward, the incoming gradient in e5m2 backward.  ``w`` is
    a weight (2-D) or, batched like ``x``, attention's other operand."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        if wq.dim() == 2:
            gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        else:
            gw = xq.transpose(-1, -2) @ gq
        return gq @ wq.transpose(-1, -2), gw


class Model:
    """The reference over one weight tree."""

    def __init__(self, cfg: dict, params: dict, *, matmul: str = "float32",
                 remat: bool = False):
        no_tf32()
        self.cfg, self.p, self.remat = cfg, params, remat
        self.h = cfg["num_attention_heads"]
        self.kv = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or cfg["hidden_size"] // self.h
        self.theta = cfg["rope_theta"]
        self.eps = as_run(cfg, "rms_norm_eps")
        if as_run(cfg, "rope_scaling") is not None:
            raise ValueError("the reference computes plain rotary embeddings")
        if matmul not in ("float32", "fp8"):
            raise ValueError(matmul)
        self.fp8 = matmul == "fp8"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w in float32, or of float8 operands (weights 2-D)."""
        return _Fp8Matmul.apply(x, w.float()) if self.fp8 else x @ w.float()

    def layer(self, i: int) -> dict:
        def pick(t):
            return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
                else t[i]
        return pick(self.p["blocks"])

    # -- pieces ----------------------------------------------------------------
    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * w.float()

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x: [B, S, H, hd]; pos: [S]."""
        hd = x.shape[-1]
        freqs = 1.0 / self.theta ** (torch.arange(0, hd, 2, device=x.device,
                                                  dtype=torch.float32) / hd)
        ang = pos.float()[:, None, None] * freqs
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, p: dict, x: torch.Tensor, pos: torch.Tensor
                  ) -> torch.Tensor:
        """Causal self-attention of x [B, S, D] at positions ``pos``."""
        b, s, _ = x.shape
        q = self.rope(self.mm(x, p["wq"]).view(b, s, self.h, self.hd), pos)
        k = self.rope(self.mm(x, p["wk"]).view(b, s, self.kv, self.hd), pos)
        v = self.mm(x, p["wv"]).view(b, s, self.kv, self.hd)
        rep = self.h // self.kv
        k = k.repeat_interleave(rep, 2)
        v = v.repeat_interleave(rep, 2)
        mask = pos[None, :] <= pos[:, None]
        if self.fp8:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            scores = _Fp8Matmul.apply(q, k.transpose(-1, -2))
            scores = scores.masked_fill(~mask, float("-inf")) / \
                math.sqrt(self.hd)
            out = _Fp8Matmul.apply(scores.softmax(-1), v).transpose(1, 2)
        else:
            scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(self.hd)
            scores = scores.masked_fill(~mask, float("-inf"))
            out = torch.einsum("bhst,bthd->bshd", scores.softmax(-1), v)
        return self.mm(out.reshape(b, s, self.h * self.hd), p["wo"])

    def ffn(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return self.mm(F.silu(self.mm(x, p["w_gate"])) * self.mm(x, p["w_up"]),
                       p["w_down"])

    def moe(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        n, e, k = b * s, self.cfg["num_experts"], self.cfg["num_experts_per_tok"]
        xf = x.reshape(n, d)
        probs = torch.softmax(xf @ p["router"].float(), -1)
        top_w, top_e = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
        top_w, top_e = top_w[:, :k], top_e[:, :k]
        if as_run(self.cfg, "norm_topk_prob"):
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
        f = as_run(self.cfg, "capacity_factor")
        cap = n if n <= 64 else int(f * n * k / e) + 1
        y = torch.zeros_like(xf)
        flat = top_e.reshape(-1)
        for ex in range(e):
            pairs = torch.nonzero(flat == ex).flatten()[:cap]
            if pairs.numel() == 0:
                continue
            tok = pairs // k
            w = {name: p[name][ex] for name in ("w_gate", "w_up", "w_down")}
            out = self.ffn(w, xf[tok]) * top_w.reshape(-1)[pairs][:, None]
            y = y.index_add(0, tok, out)
        return y.reshape(b, s, d)

    # -- the model ---------------------------------------------------------------
    def embed(self, tokens: torch.Tensor, patches=None) -> torch.Tensor:
        h = self.p["embed"]["tok"][tokens].float()
        if patches is not None:
            h = torch.cat([patches.float(), h], 1)
        return h

    def block(self, i: int, h: torch.Tensor, pos: torch.Tensor
              ) -> torch.Tensor:
        p = self.layer(i)
        h = h + self.attention(p["attn"], self.norm(h, p["ln1"]["w"]), pos)
        x = self.norm(h, p["ln2"]["w"])
        return h + (self.moe(p["moe"], x) if "moe" in p else
                    self.ffn(p["mlp"], x))

    def head(self, h: torch.Tensor) -> torch.Tensor:
        h = self.norm(h, self.p["ln_f"]["w"])
        e = self.p["embed"]
        return self.mm(h, e["head"]) if "head" in e else \
            self.mm(h, e["tok"].T)

    def forward(self, tokens: torch.Tensor, patches=None) -> torch.Tensor:
        """Logits [B, S, padded vocab] of the token positions."""
        h = self.embed(tokens, patches)
        pos = torch.arange(h.shape[1], device=h.device)
        for i in range(self.cfg["num_hidden_layers"]):
            if self.remat:
                h = torch.utils.checkpoint.checkpoint(
                    self.block, i, h, pos, use_reentrant=False)
            else:
                h = self.block(i, h, pos)
        n_extra = 0 if patches is None else patches.shape[1]
        return self.head(h[:, n_extra:])
