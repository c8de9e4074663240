"""olmo-1b [dense]: 16L d2048 16H (kv=16) d_ff=8192 vocab=50304; non-parametric LN [arXiv:2402.00838; hf]"""
from repro_torch.configs import _lm_common
from repro_torch.costs import lm as lm_costs
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name='olmo-1b', family='dense', num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, d_ff=8192, vocab_size=50304, norm='nonparam_ln')


def smoke_config() -> ModelConfig:
    return ModelConfig(name='olmo-1b-smoke', family='dense', num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512, norm='nonparam_ln', remat=False)


def input_specs(spec, cfg=None):
    return _lm_common.input_specs(cfg or config(), spec)


def cost_profile(cfg=None, *, seq_len=2048, batch=1):
    return lm_costs.cost_profile(cfg or config(), seq_len=seq_len, batch=batch)
