"""The paper's comparison baselines (Table 1a) on the card: the twin of
``repro.baselines``.

* :class:`K2Triples`: one k²-tree per predicate over subject × object.
* :class:`HDTBitmapTriples`: HDT's Bitmap-Triples, subject-sorted runs of
  predicates and objects delimited by rank/select bitmaps.
* :func:`ntriples_size_bytes`: the uncompressed N-Triples size model.
"""
from repro_torch.baselines.hdt_bt import HDTBitmapTriples
from repro_torch.baselines.k2_triples import K2Triples
from repro_torch.baselines.ntriples import ntriples_size_bytes

__all__ = ["K2Triples", "HDTBitmapTriples", "ntriples_size_bytes"]
