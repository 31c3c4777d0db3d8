"""dlrm-mlperf [arXiv:1906.00091]: MLPerf DLRM over Criteo-1TB; 13 dense,
26 sparse fields, embed_dim=128, bot 13-512-256-128, top 1024-1024-512-256-1,
dot interaction."""
from repro_torch.models.dlrm import DLRMConfig


def config() -> DLRMConfig:
    return DLRMConfig()


def reduced() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-reduced", embed_dim=16, bot_mlp=(32, 16), top_mlp=(32, 16, 1),
        compute_dtype="float32",
        row_counts=tuple([50, 20, 30, 10, 5, 3, 40, 8, 6, 25, 12, 9, 10, 7,
                          11, 13, 4, 14, 14, 21, 22, 23, 24, 12, 10, 35]),
    )
