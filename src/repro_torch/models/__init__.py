"""Models of the JAX package's zoo that the port runs: DLRM, the dense GQA
transformer and GCN."""
