"""Models of the JAX package's zoo that the port runs: DLRM, the transformer
zoo and the four GNN architectures."""
