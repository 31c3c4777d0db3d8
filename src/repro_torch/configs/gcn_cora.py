"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden=16, mean/sym aggregation."""
from repro_torch.models.gnn import GCNConfig


def config() -> GCNConfig:
    return GCNConfig(n_layers=2, d_hidden=16, norm="sym", name="gcn-cora")


def reduced() -> GCNConfig:
    return GCNConfig(n_layers=2, d_hidden=8, norm="sym", name="gcn-reduced")
