"""meshgraphnet [arXiv:2010.03409]: 15 layers, d_hidden=128, sum aggregation,
2-layer MLPs."""
from repro_torch.models.gnn import MeshGraphNetConfig


def config() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(n_layers=15, d_hidden=128, mlp_layers=2, name="meshgraphnet")


def reduced() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(n_layers=3, d_hidden=32, mlp_layers=2, name="mgn-reduced")
