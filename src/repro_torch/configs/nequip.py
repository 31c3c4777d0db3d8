"""nequip [arXiv:2101.03164]: 5 layers, d_hidden=32, l_max=2, 8 radial basis
functions, cutoff 5 Å, E(3)-equivariant tensor products."""
from repro_torch.models.gnn import NequIPConfig


def config() -> NequIPConfig:
    return NequIPConfig(n_layers=5, d_hidden=32, l_max=2, n_rbf=8, cutoff=5.0, name="nequip")


def reduced() -> NequIPConfig:
    return NequIPConfig(n_layers=2, d_hidden=8, l_max=2, n_rbf=4, cutoff=5.0, name="nequip-reduced")
