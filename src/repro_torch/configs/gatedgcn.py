"""gatedgcn [arXiv:2003.00982]: 16 layers, d_hidden=70, gated aggregation."""
from repro_torch.models.gnn import GatedGCNConfig


def config() -> GatedGCNConfig:
    return GatedGCNConfig(n_layers=16, d_hidden=70, name="gatedgcn")


def reduced() -> GatedGCNConfig:
    return GatedGCNConfig(n_layers=3, d_hidden=16, name="gatedgcn-reduced")
