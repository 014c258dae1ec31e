"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
The reference also runs its expert-parallel all-to-all variant
(``expert_parallel=True``) in its rules-carrying builders; its
mesh-native path ignores the flag. So does the port's command line; a
train step built with ``expert_parallel`` (``launch.sync.bundles
.replica_layout``, ``launch.train.run_mesh_native(expert_parallel=True)``)
splits the experts over the model ranks and runs ``moe.moe_forward_ep``.
"""
from repro_torch.models.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, expert_d_ff=512, vocab_size=49155,
        n_experts=32, top_k=8,
        source="[hf:ibm-granite/granite-3.0-1b-a400m-base]")


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, expert_d_ff=64, vocab_size=128, n_experts=4, top_k=2,
        attn_impl="naive", remat="none", dtype="float32")
