"""Batched decode engine.

Counterpart of ``repro.serving.engine``: drives ``serve_step`` over a
padded request batch with greedy sampling.  Prompts are right-aligned to a
common length so the whole batch shares one scalar ``pos``.

Prefill runs ``serve_step`` once per prompt position in both modes.  The
reference's default mode (``"fused"``) folds that loop into one jitted
``lax.scan`` to save host dispatches; PyTorch runs eagerly, so here both
modes are the same Python loop and emit identical tokens (a CUDA graph of
the step is a later change).  The KV cache is updated in place.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M

PREFILL_MODES = ("fused", "per_token")


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray        # [B, gen_len]
    prefill_s: float
    decode_s: float
    tokens_per_s: float


class DecodeEngine:
    def __init__(self, cfg, params, *, max_len: int = 512,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, cache, tokens: torch.Tensor, pos: int, extra: dict):
        return M.serve_step(self.cfg, self.params, cache,
                            {"tokens": tokens, "pos": pos, **extra})

    def generate(self, prompts: np.ndarray, gen_len: int, *,
                 extra_batch: dict | None = None,
                 prefill_mode: str = "fused") -> GenerationResult:
        """prompts: [B, P] int (a common prompt length P).

        ``extra_batch`` joins every step's batch (the encoder output
        ``enc_out`` for encdec).  ``prefill_mode``: ``"fused"`` (default)
        or ``"per_token"``; both are a loop over ``serve_step`` here.
        """
        if prefill_mode not in PREFILL_MODES:
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}; "
                             f"expected one of {PREFILL_MODES}")
        b, p = prompts.shape
        if p + gen_len > self.max_len:
            raise ValueError(f"prompt {p} + {gen_len} generated tokens "
                             f"exceed max_len {self.max_len}")
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=self.device)
        extra = {k: torch.as_tensor(v, device=self.device)
                 for k, v in (extra_batch or {}).items()}
        with torch.no_grad():
            cache = M.init_cache(self.cfg, b, self.max_len,
                                 device=self.device)
            t0 = time.perf_counter()
            logits = None
            for i in range(p):
                logits, cache = self._step(cache, toks[:, i:i + 1], i, extra)
            self._sync()
            t1 = time.perf_counter()

            out = torch.empty((b, gen_len), dtype=torch.long,
                              device=self.device)
            tok = torch.argmax(logits, -1)[:, None]
            for j in range(gen_len):
                out[:, j] = tok[:, 0]
                logits, cache = self._step(cache, tok, p + j, extra)
                tok = torch.argmax(logits, -1)[:, None]
            self._sync()
            t2 = time.perf_counter()
        return GenerationResult(
            tokens=out.cpu().numpy().astype(np.int32), prefill_s=t1 - t0,
            decode_s=t2 - t1, tokens_per_s=b * gen_len / max(t2 - t1, 1e-9))
