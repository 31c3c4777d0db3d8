"""gemma2-9b [arXiv:2408.00118]: 42L d_model=3584 16H (GQA kv=8) head_dim=256
d_ff=14336 vocab=256000; alternating 4096-local/global attention, attn
softcap 50, final softcap 30, post-norms."""
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-9b", n_layers=42, d_model=3584, n_heads=16,
        n_kv_heads=8, head_dim=256, d_ff=14336, vocab=256000,
        local_window=4096, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        local_window=8, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, dtype="float32", ce_chunk=16,
    )
