"""starcoder2-15b — dense GQA(kv=4), RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        d_ff=24576,
        vocab=49152,
        mlp_type="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        mlp_type="gelu",
        param_dtype="float32",
    )
