"""minicpm-2b [dense]: 40L d2304 36H (kv=36) d_ff=5760 vocab=122753; WSD schedule (llama-like arch) [arXiv:2404.06395; hf]"""
from repro_torch.configs import _lm_common
from repro_torch.costs import lm as lm_costs
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name='minicpm-2b', family='dense', num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36, d_ff=5760, vocab_size=122753)


def smoke_config() -> ModelConfig:
    return ModelConfig(name='minicpm-2b-smoke', family='dense', num_layers=2, d_model=72, num_heads=6, num_kv_heads=6, d_ff=144, vocab_size=512, remat=False)


def input_specs(spec, cfg=None):
    return _lm_common.input_specs(cfg or config(), spec)


def cost_profile(cfg=None, *, seq_len=2048, batch=1):
    return lm_costs.cost_profile(cfg or config(), seq_len=seq_len, batch=batch)
