"""gemma3-1b [dense]: 26L d1152 4H (GQA kv=1, head_dim=256) d_ff=6912 vocab=262144; 5:1 local:global sliding window [hf:google/gemma-3-1b-pt]"""
from repro_torch.costs import lm as lm_costs
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name='gemma3-1b', family='dense', num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256, d_ff=6912, vocab_size=262144, local_global_pattern=6, sliding_window=512)


def smoke_config() -> ModelConfig:
    return ModelConfig(name='gemma3-1b-smoke', family='dense', num_layers=6, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=512, local_global_pattern=3, sliding_window=8, remat=False)


def cost_profile(cfg=None, *, seq_len=2048, batch=1):
    return lm_costs.cost_profile(cfg or config(), seq_len=seq_len, batch=batch)
