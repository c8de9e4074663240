"""olmoe-1b-7b [moe]: 16L d2048 16H (kv=16), 64 experts top-8, expert d_ff=1024, vocab=50304 [arXiv:2409.02060; hf]"""
from repro_torch.configs import _lm_common
from repro_torch.costs import lm as lm_costs
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name='olmoe-1b-7b', family='moe', num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, d_ff=1024, vocab_size=50304, moe_num_experts=64, moe_top_k=8, moe_d_ff=1024)


def smoke_config() -> ModelConfig:
    return ModelConfig(name='olmoe-1b-7b-smoke', family='moe', num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=512, moe_num_experts=8, moe_top_k=2, moe_d_ff=64, remat=False)


def input_specs(spec, cfg=None):
    return _lm_common.input_specs(cfg or config(), spec)


def cost_profile(cfg=None, *, seq_len=2048, batch=1):
    return lm_costs.cost_profile(cfg or config(), seq_len=seq_len, batch=batch)
