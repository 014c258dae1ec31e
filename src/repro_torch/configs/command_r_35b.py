"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01] — dense GQA, no bias.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.models.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22528, vocab_size=256000,
        source="[hf:CohereForAI/c4ai-command-r-v01]")


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
        vocab_size=128, attn_impl="naive", remat="none", dtype="float32")
