"""whisper-base [audio]: 6L enc + 6L dec, d512 8H d_ff=2048 vocab=51865; conv frontend is a stub (precomputed frame embeddings) [arXiv:2212.04356]"""
from repro_torch.costs import lm as lm_costs
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name='whisper-base', family='encdec', num_layers=6, d_model=512, num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=51865, dec_layers=6, num_frames=1500, norm='layernorm')


def smoke_config() -> ModelConfig:
    return ModelConfig(name='whisper-base-smoke', family='encdec', num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512, dec_layers=2, num_frames=16, norm='layernorm', remat=False)


def cost_profile(cfg=None, *, seq_len=2048, batch=1):
    return lm_costs.cost_profile(cfg or config(), seq_len=seq_len, batch=batch)
