"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4,
4 shared + 60 routed top-4. The 1408 is the routed-expert hidden size; the
shared-expert block is 4×1408 wide with a sigmoid gate (model card).
"""
from repro_torch.models.types import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, expert_d_ff=1408, vocab_size=151936,
        n_experts=60, top_k=4, n_shared_experts=4,
        source="[hf:Qwen/Qwen1.5-MoE-A2.7B]")


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, expert_d_ff=96, vocab_size=128,
        n_experts=4, top_k=2, n_shared_experts=1,
        attn_impl="naive", remat="none", dtype="float32")
