"""Models of the JAX package's zoo that the port runs: DLRM and the dense
GQA transformer."""
