"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]:
32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2."""
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=6400, vocab=32064,
        n_experts=16, top_k=2,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="phi3.5-moe-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, vocab=256,
        n_experts=4, top_k=2, moe_group=64, dtype="float32", ce_chunk=16,
    )
