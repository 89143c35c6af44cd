"""qwen2-moe-a2.7b — 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=151936,
        moe=MoEConfig(n_experts=60, n_shared=4, top_k=4, expert_d_ff=1408),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=512,
        moe=MoEConfig(n_experts=8, n_shared=2, top_k=4, expert_d_ff=64),
        param_dtype="float32",
    )
