"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base] — dense GQA.

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
"""
from repro_torch.models.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab_size=49155,
        source="[hf:ibm-granite/granite-3.0-2b-base]")


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, attn_impl="naive", remat="none", dtype="float32")
