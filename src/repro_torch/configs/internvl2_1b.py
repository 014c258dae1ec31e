"""internvl2-1b [arXiv:2404.16821] — InternViT + Qwen2-0.5B-style decoder.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The vision encoder
is a stub, as in the JAX package: a batch carries 256 precomputed patch
embeddings (d_vis=1024) consumed through a learned projector.
"""
from repro_torch.models.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab_size=151655,
        n_vis_tokens=256, d_vis=1024,
        source="[arXiv:2404.16821]")


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=56, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, n_vis_tokens=8, d_vis=32,
        attn_impl="naive", remat="none", dtype="float32")
