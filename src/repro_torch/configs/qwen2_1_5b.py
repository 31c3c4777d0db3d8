"""qwen2-1.5b [arXiv:2407.10671]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias, rope theta 1e6."""
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, head_dim=128, d_ff=8960, vocab=151936,
        qkv_bias=True, rope_theta=1e6,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-reduced", n_layers=2, d_model=48, n_heads=6,
        n_kv_heads=2, head_dim=8, d_ff=128, vocab=256,
        qkv_bias=True, dtype="float32", ce_chunk=16,
    )
