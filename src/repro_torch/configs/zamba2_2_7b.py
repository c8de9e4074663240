"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d2560 + shared attention block every 6 (32H kv=32, d_ff=10240), ssm_state=64, vocab=32000 [arXiv:2411.15242; hf]"""
from repro_torch.costs import lm as lm_costs
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name='zamba2-2.7b', family='hybrid', num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000, ssm_state=64, mamba_headdim=160, attn_every=6)


def smoke_config() -> ModelConfig:
    return ModelConfig(name='zamba2-smoke', family='hybrid', num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512, ssm_state=8, mamba_headdim=32, attn_every=2, remat=False)


def cost_profile(cfg=None, *, seq_len=2048, batch=1):
    return lm_costs.cost_profile(cfg or config(), seq_len=seq_len, batch=batch)
