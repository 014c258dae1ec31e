"""xlstm-125m [arXiv:2405.04517] — alternating mLSTM + sLSTM blocks.

12L d_model=768 4H vocab=50304; d_ff=0 (the xLSTM blocks carry their own
projection factor). Constant-size recurrent state, no attention.
"""
from repro_torch.models.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304, conv_kernel=4,
        source="[arXiv:2405.04517]")


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, vocab_size=128,
        remat="none", dtype="float32")
