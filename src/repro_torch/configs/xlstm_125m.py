"""xlstm-125m [ssm]: 12L d768 4H vocab=50304; alternating sLSTM + mLSTM blocks [arXiv:2405.04517]"""
from repro_torch.configs import _lm_common
from repro_torch.costs import lm as lm_costs
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name='xlstm-125m', family='ssm', num_layers=12, d_model=768, num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304)


def smoke_config() -> ModelConfig:
    return ModelConfig(name='xlstm-125m-smoke', family='ssm', num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=512, remat=False)


def input_specs(spec, cfg=None):
    return _lm_common.input_specs(cfg or config(), spec)


def cost_profile(cfg=None, *, seq_len=2048, batch=1):
    return lm_costs.cost_profile(cfg or config(), seq_len=seq_len, batch=batch)
