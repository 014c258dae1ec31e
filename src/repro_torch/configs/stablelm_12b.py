"""stablelm-12b [hf:stabilityai/stablelm-2-12b] — dense GQA.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352 (head_dim 160).
"""
from repro_torch.models.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=13824, vocab_size=100352,
        source="[hf:stabilityai/stablelm-2-1_6b (12b family)]")


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, attn_impl="naive", remat="none", dtype="float32")
