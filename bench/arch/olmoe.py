"""OLMoE (``model_type`` "olmoe"): the shared attention-LM mapping, and
the reference with its expert blocks."""
from bench.arch._attention_lm import is_norm_leaf, program_config  # noqa: F401
from bench.reference.lm import Model  # noqa: F401
