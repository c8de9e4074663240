"""deepseek-v2-236b [moe]: 60L d5120 128H, MLA kv_lora=512 q_lora=1536, 2 shared + 160 routed experts top-6 (expert d_ff=1536), vocab=102400 [arXiv:2405.04434; hf]"""
from repro_torch.costs import lm as lm_costs
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(name='deepseek-v2-236b', family='moe', num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128, d_ff=1536, vocab_size=102400, use_mla=True, kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, moe_num_experts=160, moe_top_k=6, moe_num_shared=2, moe_d_ff=1536, tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(name='deepseek-v2-smoke', family='moe', num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=512, use_mla=True, kv_lora_rank=16, q_lora_rank=24, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, moe_num_experts=8, moe_top_k=2, moe_num_shared=1, moe_d_ff=32, tie_embeddings=False, remat=False)


def cost_profile(cfg=None, *, seq_len=2048, batch=1):
    return lm_costs.cost_profile(cfg or config(), seq_len=seq_len, batch=batch)
