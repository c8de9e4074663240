"""phi-3-vision-4.2b [vlm]: 32L d3072 32H (kv=32) d_ff=8192 vocab=32064; phi3-mini backbone + CLIP patch-embedding stub [hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.costs import lm as lm_costs
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name='phi-3-vision-4.2b', family='vlm', num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064, num_patches=576, tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(name='phi3v-smoke', family='vlm', num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512, num_patches=8, tie_embeddings=False, remat=False)


def cost_profile(cfg=None, *, seq_len=2048, batch=1):
    return lm_costs.cost_profile(cfg or config(), seq_len=seq_len, batch=batch)
