"""llama3.2-3b — small llama3, GQA(kv=8). [hf:meta-llama/Llama-3.2; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab=128256,
        rope_theta=500_000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        param_dtype="float32",
    )
