"""minicpm3-4b — dense with Multi-head Latent Attention.
[hf:openbmb/MiniCPM3-4B; hf]  MLA ranks follow the HF config family
(q_lora 768, kv_lora 256, qk 64+32 rope, v 64); the assignment's "GQA kv=40"
denotes 40 full KV heads pre-compression — MLA stores the 288-wide latent.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab=73448,
        mla=MLAConfig(
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_dim=64,
            qk_rope_dim=32,
            v_head_dim=64,
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=8,
        d_ff=256,
        vocab=512,
        mla=MLAConfig(
            q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=16,
        ),
        param_dtype="float32",
    )
