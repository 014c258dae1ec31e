"""musicgen-medium [arXiv:2306.05284] — decoder over EnCodec tokens.

48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048, 4 codebooks.
The EnCodec audio frontend is a stub, as in the JAX package: a batch
carries 4 parallel token streams; their embeddings are summed and each
codebook has its own output head. The model sees plain parallel streams
(``serve.engine.apply_delay_pattern`` is offered beside it). Deviation
kept from the JAX package: RoPE instead of sinusoidal positions.
"""
from repro_torch.models.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        d_ff=6144, vocab_size=2048, n_codebooks=4,
        source="[arXiv:2306.05284]")


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=64, n_codebooks=2,
        attn_impl="naive", remat="none", dtype="float32")
