"""smollm-135m [dense]: 30L d576 9H (GQA kv=3) d_ff=1536 vocab=49152; llama-arch small [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs import _lm_common
from repro_torch.costs import lm as lm_costs
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name='smollm-135m', family='dense', num_layers=30, d_model=576, num_heads=9, num_kv_heads=3, d_ff=1536, vocab_size=49152)


def smoke_config() -> ModelConfig:
    return ModelConfig(name='smollm-135m-smoke', family='dense', num_layers=2, d_model=48, num_heads=3, num_kv_heads=1, d_ff=96, vocab_size=512, remat=False)


def input_specs(spec, cfg=None):
    return _lm_common.input_specs(cfg or config(), spec)


def cost_profile(cfg=None, *, seq_len=2048, batch=1):
    return lm_costs.cost_profile(cfg or config(), seq_len=seq_len, batch=batch)
