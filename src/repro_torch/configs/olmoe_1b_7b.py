"""olmoe-1b-7b — 64 experts top-8, no shared. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50304,
        moe=MoEConfig(n_experts=64, top_k=8, expert_d_ff=1024),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=512,
        moe=MoEConfig(n_experts=8, top_k=4, expert_d_ff=64),
        param_dtype="float32",
    )
