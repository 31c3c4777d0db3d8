"""olmoe-1b-7b [arXiv:2409.02060]: 16L d_model=2048 16H (kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8."""
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=1024, vocab=50304,
        n_experts=64, top_k=8,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=64, vocab=256,
        n_experts=8, top_k=2, moe_group=64, dtype="float32", ce_chunk=16,
    )
