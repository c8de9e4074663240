"""Phi-3-vision (``model_type`` "phi3_v"): the shared attention-LM mapping,
and the reference with its dense blocks behind the patch embeddings."""
from bench.arch._attention_lm import is_norm_leaf, program_config  # noqa: F401
from bench.reference.lm import Model  # noqa: F401
