"""mamba2-1.3b — attention-free SSD. [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1, chunk=256),
        sub_quadratic=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=512,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=32, n_groups=1, chunk=16),
        sub_quadratic=True,
        param_dtype="float32",
    )
