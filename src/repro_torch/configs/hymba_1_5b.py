"""hymba-1.5b [arXiv:2411.13676] — parallel attention + mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each layer fuses its attention and SSM head outputs in parallel, and 128
learnable meta tokens are prepended to every sequence. As in the JAX
package, every layer uses sliding-window attention (window 1024); the
published model keeps 3 full-attention layers.
"""
from repro_torch.models.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001,
        ssm_state=16, ssm_heads=25, conv_kernel=4,
        sliding_window=1024, n_meta_tokens=128,
        source="[arXiv:2411.13676]")


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, ssm_state=4, ssm_heads=4, sliding_window=16,
        n_meta_tokens=4, attn_impl="naive", remat="none", dtype="float32")
