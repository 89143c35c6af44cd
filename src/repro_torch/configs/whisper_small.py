"""whisper-small — enc-dec; conv audio frontend is a STUB (input_specs
supplies precomputed frame embeddings).  12 encoder + 12 decoder layers.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        n_layers=12,
        n_enc_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=51865,
        mlp_type="gelu",
        tie_embeddings=True,
        enc_context=1500,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        mlp_type="gelu",
        tie_embeddings=True,
        enc_context=16,
        param_dtype="float32",
    )
