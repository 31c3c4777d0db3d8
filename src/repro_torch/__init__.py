"""ITR (grammar-based graph compression with fast triple queries) on
PyTorch and CUDA.

The twin of the ``repro`` package, module for module: triples go in, RePair
compresses them into a grammar, the grammar is encoded succinctly, and a
batched engine answers all eight (S, P, O) triple patterns, with tensors on
an NVIDIA GPU. From the package's model zoo it serves DLRM
(:mod:`repro_torch.models.dlrm`) and the dense GQA transformer
(:mod:`repro_torch.models.transformer`, :mod:`repro_torch.serve`), and it
trains GCN (:mod:`repro_torch.models.gnn`, :mod:`repro_torch.train`). The hot
operations of these paths run in hand-written CUDA kernels (``csrc/``);
each has a plain PyTorch twin that serves the CPU.

Entry points take ``device=None``, meaning ``"cuda"``; without a GPU they
raise unless ``device="cpu"`` is given.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
