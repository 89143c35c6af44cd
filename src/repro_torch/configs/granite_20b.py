"""granite-20b — dense llama-arch code model, MQA (kv=1). [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        mlp_type="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=1,
        d_ff=256,
        vocab=512,
        mlp_type="gelu",
        param_dtype="float32",
    )
