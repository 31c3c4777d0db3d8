"""LM serving on the GPU: the twin of ``repro.serve.engine``."""
from repro_torch.serve.engine import GenerationResult, ServeEngine

__all__ = ["ServeEngine", "GenerationResult"]
