"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE 16e top-2.
[arXiv:2403.19887; hf]  72 layers = 9 super-blocks of 8 (1 attention + 7
mamba); MoE replaces the MLP on every 2nd sublayer.  Spec-tree total is
~398B params (verified in tests).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab=65536,
        attn_every=8,
        moe=MoEConfig(n_experts=16, top_k=2, expert_d_ff=24576, every=2),
        ssm=SSMConfig(d_state=128, expand=2, head_dim=128, n_groups=8, chunk=256),
        sub_quadratic=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        n_layers=8,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        attn_every=4,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=128, every=2),
        ssm=SSMConfig(d_state=16, expand=2, head_dim=32, n_groups=2, chunk=16),
        sub_quadratic=True,
        param_dtype="float32",
    )
