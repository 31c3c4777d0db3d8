"""yi-34b [arXiv:2403.04652]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 (llama-arch GQA). ``context_parallel`` is the reference's mesh
option; it has no meaning on one card and is kept so configs compare field
by field."""
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="yi-34b", n_layers=60, d_model=7168, n_heads=56,
        n_kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
        context_parallel=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="yi-reduced", n_layers=2, d_model=56, n_heads=7,
        n_kv_heads=1, head_dim=8, d_ff=128, vocab=256,
        dtype="float32", ce_chunk=16,
    )
