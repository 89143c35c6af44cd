"""internvl2-26b — InternLM2 backbone of the VLM; InternViT frontend is a
STUB (input_specs supplies precomputed patch embeddings). [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=92553,
        vision_tokens=256,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        vision_tokens=8,
        param_dtype="float32",
    )
