from .model import (ModelConfig, init_params, prefill_logits, loss_fn,
                    init_cache, serve_step, param_count)

__all__ = ["ModelConfig", "init_params", "prefill_logits", "loss_fn",
           "init_cache", "serve_step", "param_count"]
