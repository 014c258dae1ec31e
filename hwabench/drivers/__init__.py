"""The drivers of the benchmark's cells, one per kind of traffic (a
traffic file's ``kind``): ``train`` so far. A driver builds the
system under test from a configuration and a traffic file, runs its
set-up, the measured window and the comparison with the reference."""
from __future__ import annotations

import importlib


def driver_for(kind: str):
    return importlib.import_module(f"hwabench.drivers.{kind}")


def program_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file: its sizes
    under the program's names, with the run settings of ``program``."""
    from repro_torch.models.types import ModelConfig
    experts = cfg.get("num_local_experts", 0)
    return ModelConfig(
        name=cfg["name"], family="moe" if experts else "dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        n_experts=experts, top_k=cfg.get("num_experts_per_tok", 0),
        expert_d_ff=cfg["intermediate_size"] if experts else 0,
        router_aux_coef=cfg.get("router_aux_loss_coef", 0.01),
        rope_theta=float(cfg["rope_theta"]), dtype=cfg["torch_dtype"],
        **cfg["program"])
