"""gemma2-27b [arXiv:2408.00118] — local/global alternating + softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; head_dim=128
(model card), sliding window 4096 on local layers, attention logit softcap
50.0, final-logit softcap 30.0, GeGLU.
"""
from repro_torch.models.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
        d_ff=36864, vocab_size=256000, head_dim=128,
        sliding_window=4096, global_every=2,
        logit_softcap=50.0, final_softcap=30.0, act="gelu",
        source="[arXiv:2408.00118]")


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=128, head_dim=16, sliding_window=16,
        attn_impl="naive", remat="none", dtype="float32")
