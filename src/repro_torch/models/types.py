"""Model / input-shape configuration dataclasses (a copy of the JAX
package's, with the same fields and defaults, so a config means the
same thing in both packages)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | vlm | audio | convnet
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0                 # routed-expert hidden size
    router_aux_coef: float = 0.01
    expert_parallel: bool = False        # EP all-to-all path (needs E % model == 0)
    moe_capacity_factor: float = 1.25    # capacity-dispatch overprovision

    # --- attention ---
    sliding_window: int | None = None    # None = full causal
    global_every: int = 0                # gemma2: every 2nd layer is global
    logit_softcap: float = 0.0           # attention logit softcap
    final_softcap: float = 0.0           # final-logits softcap
    rope_theta: float = 10_000.0
    attn_impl: str = "flash_jnp"         # naive | flash_jnp | flash_pallas

    # --- ssm / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    conv_kernel: int = 4

    # --- misc ---
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    act: str = "silu"                    # silu | gelu | geglu
    n_meta_tokens: int = 0               # hymba learnable prefix tokens

    # --- modality frontends (stubs per assignment) ---
    n_codebooks: int = 0                 # musicgen EnCodec streams
    n_vis_tokens: int = 0                # internvl patch embeddings
    d_vis: int = 0

    # --- convnet (paper-faithful ResNet-CIFAR) ---
    widths: tuple = ()
    blocks_per_stage: int = 3
    image_size: int = 32
    n_classes: int = 0

    dtype: str = "bfloat16"
    remat: str = "full"                  # none | full | dots
    scan_unroll: bool = False            # unroll the layer scan (no XLA
    # while loop — required inside partial-auto shard_map on jax 0.4.x,
    # whose SPMD partitioner fatals on while+manual-subgroup shardings)
    source: str = ""                     # citation bracket from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
