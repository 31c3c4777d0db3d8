"""Compressed term dictionary: RDF term strings <-> dense integer ids.

The engines speak dense int64 ids; RDF speaks IRIs, blank nodes and
literals. This module is the bridge, the twin of the reference's
``core/term_dict.py``, with the same layout and the same persisted arrays:

* **Front-coded base**: the immutable side of a :class:`StringSpace` holds
  its terms sorted, in blocks of ``block`` strings. Each block head is
  stored whole, every other term only ``(lcp, suffix)`` against its
  predecessor. The suffix bytes live in one ``uint8`` blob; the byte
  offset of each block head is indexed with the port's
  :class:`~repro_torch.core.succinct.EliasFano` (on the CPU), so
  ``term_to_id`` is a binary search over block heads plus one in-block walk
  and ``id_to_term`` decodes one block prefix.
* **Append tail**: terms minted after the base was built (ingestion) go to a
  plain list and dict. Ids are dense and stable; ``compacted()``
  front-codes everything again without changing any id.
* **Two spaces**: a :class:`TermDict` holds separate node and predicate
  spaces, mirroring the engines' separate id universes.

The dictionary lives on the host: strings have no use on the card. Its
arrays are numpy arrays of the reference's dtypes; lookups walk host
copies made once when a base is built or opened (the blob as ``bytes``,
the head offsets decoded from the Elias–Fano index, the lengths as lists),
so a probe costs no torch call. Ids leave it as int64 CPU tensors, which
the engine copies to its device once a batch. Sorting is by Unicode code
point; UTF-8 byte order preserves it, so comparisons run on encoded bytes.
"""
from __future__ import annotations

import bisect

import numpy as np
import torch

from repro_torch.core.succinct import EliasFano

DEFAULT_BLOCK = 16


def resolve_dict_block(value=None) -> int:
    """Front-coding block size: the argument, else 16. Values below 2 clamp
    to 2 (a block of 1 would store every term whole)."""
    if value is None:
        return DEFAULT_BLOCK
    return max(2, int(value))


def _lcp(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class StringSpace:
    """One term space: front-coded immutable base + mutable append tail."""

    def __init__(self, block: int | None = None):
        self.block = resolve_dict_block(block)
        self.n_base = 0
        self._blob = np.zeros(0, dtype=np.uint8)
        self._suffix_lens = np.zeros(0, dtype=np.int32)
        self._lcps = np.zeros(0, dtype=np.int32)
        # permutations between sorted position and public id (None: the
        # build-time terms were sorted already, so position == id)
        self._ids = None
        self._pos_of_id = None
        self._extra: list[str] = []
        self._extra_index: dict[str, int] = {}
        self._index_base()

    # -- construction ---------------------------------------------------
    @classmethod
    def from_terms(cls, terms, block: int | None = None) -> "StringSpace":
        """Build with ``terms[i]`` assigned id ``i``. Terms must be unique."""
        self = cls(block)
        terms = list(terms)
        if not terms:
            return self
        order = sorted(range(len(terms)), key=lambda i: terms[i])
        for a, b in zip(order, order[1:]):
            if terms[a] == terms[b]:
                raise ValueError(f"duplicate term: {terms[a]!r}")
        self.n_base = len(terms)
        if order != list(range(len(terms))):
            self._ids = np.array(order, dtype=np.int64)
            self._pos_of_id = np.empty(len(terms), dtype=np.int64)
            self._pos_of_id[self._ids] = np.arange(len(terms), dtype=np.int64)
        chunks = []
        suffix_lens = np.empty(len(terms), dtype=np.int32)
        lcps = np.empty(len(terms), dtype=np.int32)
        prev = b""
        for pos, idx in enumerate(order):
            enc = terms[idx].encode("utf-8")
            cut = 0 if pos % self.block == 0 else _lcp(prev, enc)
            chunks.append(enc[cut:])
            lcps[pos] = cut
            suffix_lens[pos] = len(enc) - cut
            prev = enc
        self._blob = np.frombuffer(b"".join(chunks), dtype=np.uint8).copy()
        self._suffix_lens = suffix_lens
        self._lcps = lcps
        self._index_base()
        return self

    def _index_base(self) -> None:
        """The block-offset Elias–Fano index and the host copies lookups
        walk: the blob as bytes, each term's suffix length, LCP and offset
        in the blob, and each block head's offset decoded from the index."""
        offsets = np.zeros(self.n_base, dtype=np.int64)
        if self.n_base:
            np.cumsum(self._suffix_lens[:-1], out=offsets[1:])
        heads = torch.from_numpy(offsets[::self.block].copy())
        self._block_ef = EliasFano(heads, universe=int(self._blob.nbytes) + 1, device="cpu") \
            if self.n_base else EliasFano(heads, device="cpu")
        self._bytes = self._blob.tobytes()
        self._lens = self._suffix_lens.tolist()
        self._lcp_list = self._lcps.tolist()
        self._heads = self._block_ef.to_tensor().tolist()
        self._head_terms = [self._bytes[h:h + self._lens[b * self.block]]
                            for b, h in enumerate(self._heads)]

    # -- lookups --------------------------------------------------------
    def __len__(self) -> int:
        return self.n_base + len(self._extra)

    def _walk_block(self, b: int, stop_pos: int | None = None):
        """Yield ``(pos, decoded_bytes)`` for block ``b`` up to `stop_pos`."""
        start = b * self.block
        end = min(start + self.block, self.n_base)
        off = self._heads[b]
        cur = b""
        for pos in range(start, end):
            ln = self._lens[pos]
            cur = cur[:self._lcp_list[pos]] + self._bytes[off:off + ln]
            off += ln
            yield pos, cur
            if stop_pos is not None and pos >= stop_pos:
                return

    def _base_pos(self, enc: bytes) -> int | None:
        """Sorted position of an encoded term in the base, or None."""
        b = bisect.bisect_right(self._head_terms, enc) - 1  # last head <= enc
        if b < 0:
            return None
        for pos, cur in self._walk_block(b):
            if cur == enc:
                return pos
            if cur > enc:
                return None
        return None

    def term_to_id(self, term: str) -> int | None:
        pos = self._base_pos(term.encode("utf-8"))
        if pos is not None:
            return int(self._ids[pos]) if self._ids is not None else pos
        return self._extra_index.get(term)

    def id_to_term(self, i: int) -> str:
        i = int(i)
        if i < 0 or i >= len(self):
            raise IndexError(f"term id {i} out of range (have {len(self)})")
        if i >= self.n_base:
            return self._extra[i - self.n_base]
        pos = int(self._pos_of_id[i]) if self._pos_of_id is not None else i
        for p, cur in self._walk_block(pos // self.block, stop_pos=pos):
            if p == pos:
                return cur.decode("utf-8")
        raise AssertionError("unreachable: position not found in its block")

    # -- appends --------------------------------------------------------
    def add_terms(self, terms) -> torch.Tensor:
        """Mint ids for `terms` (existing terms keep theirs); returns the
        int64 id tensor (CPU), in input order."""
        out = []
        for term in terms:
            known = self.term_to_id(term)
            if known is None:
                known = len(self)
                self._extra.append(term)
                self._extra_index[term] = known
            out.append(known)
        return torch.tensor(out, dtype=torch.int64)

    @property
    def n_extra(self) -> int:
        return len(self._extra)

    def terms_in_id_order(self) -> list[str]:
        return [self.id_to_term(i) for i in range(len(self))]

    def compacted(self, block: int | None = None) -> "StringSpace":
        """Everything front-coded, every id preserved."""
        return StringSpace.from_terms(self.terms_in_id_order(),
                                      block if block is not None else self.block)

    def size_in_bytes(self) -> int:
        base = (self._blob.nbytes + self._suffix_lens.nbytes + self._lcps.nbytes
                + self._block_ef.size_in_bytes())
        if self._ids is not None:
            base += self._ids.nbytes + self._pos_of_id.nbytes
        # tail: utf-8 payload plus a conservative per-entry pointer estimate
        tail = sum(len(t.encode("utf-8")) for t in self._extra) + 16 * len(self._extra)
        return base + tail

    # -- persistence ----------------------------------------------------
    def to_arrays(self):
        """``(meta, arrays)`` capturing the full state (base + tail), the
        reference's arrays and dtypes. The block-offset index is derived
        from ``suffix_lens`` on load, so it is not persisted."""
        extra_enc = [t.encode("utf-8") for t in self._extra]
        extra_offsets = np.zeros(len(extra_enc) + 1, dtype=np.int64)
        if extra_enc:
            np.cumsum([len(e) for e in extra_enc], out=extra_offsets[1:])
        meta = {
            "block": int(self.block),
            "n_base": int(self.n_base),
            "identity_ids": self._ids is None,
            "n_extra": len(self._extra),
        }
        arrays = {
            "blob": self._blob,
            "suffix_lens": self._suffix_lens,
            "lcps": self._lcps,
            "ids": self._ids if self._ids is not None else np.zeros(0, dtype=np.int64),
            "extra_blob": np.frombuffer(b"".join(extra_enc), dtype=np.uint8).copy(),
            "extra_offsets": extra_offsets,
        }
        return meta, arrays

    @classmethod
    def from_arrays(cls, meta, arrays) -> "StringSpace":
        self = cls(int(meta["block"]))
        self.n_base = int(meta["n_base"])
        self._blob = np.asarray(arrays["blob"], dtype=np.uint8)
        self._suffix_lens = np.asarray(arrays["suffix_lens"], dtype=np.int32)
        self._lcps = np.asarray(arrays["lcps"], dtype=np.int32)
        if not meta["identity_ids"]:
            self._ids = np.asarray(arrays["ids"], dtype=np.int64)
            self._pos_of_id = np.empty(self.n_base, dtype=np.int64)
            self._pos_of_id[self._ids] = np.arange(self.n_base, dtype=np.int64)
        self._index_base()
        blob = np.asarray(arrays["extra_blob"], dtype=np.uint8).tobytes()
        offs = np.asarray(arrays["extra_offsets"], dtype=np.int64).tolist()
        self._extra = [blob[offs[j]:offs[j + 1]].decode("utf-8")
                       for j in range(int(meta["n_extra"]))]
        self._extra_index = {t: self.n_base + j for j, t in enumerate(self._extra)}
        return self


class TermDict:
    """Node + predicate term spaces with bidirectional dense-id lookup."""

    def __init__(self, nodes: StringSpace, preds: StringSpace):
        self.nodes = nodes
        self.preds = preds

    @classmethod
    def empty(cls, block: int | None = None) -> "TermDict":
        return cls(StringSpace(block), StringSpace(block))

    @classmethod
    def from_terms(cls, node_terms, pred_terms, block: int | None = None) -> "TermDict":
        return cls(StringSpace.from_terms(node_terms, block),
                   StringSpace.from_terms(pred_terms, block))

    # -- lookups --------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def n_preds(self) -> int:
        return len(self.preds)

    def node_id(self, term: str):
        return self.nodes.term_to_id(term)

    def pred_id(self, term: str):
        return self.preds.term_to_id(term)

    def node_term(self, i: int) -> str:
        return self.nodes.id_to_term(i)

    def pred_term(self, i: int) -> str:
        return self.preds.id_to_term(i)

    def add_node_terms(self, terms) -> torch.Tensor:
        return self.nodes.add_terms(terms)

    def add_pred_terms(self, terms) -> torch.Tensor:
        return self.preds.add_terms(terms)

    def compacted(self) -> "TermDict":
        return TermDict(self.nodes.compacted(), self.preds.compacted())

    def size_in_bytes(self) -> int:
        return self.nodes.size_in_bytes() + self.preds.size_in_bytes()

    def bytes_per_term(self) -> float:
        n = self.n_nodes + self.n_preds
        return self.size_in_bytes() / n if n else 0.0

    def to_arrays(self):
        """``(meta, arrays)`` over both spaces, keys prefixed ``nodes_`` /
        ``preds_``: what ``persist.snapshot.save_term_dict`` writes."""
        meta, arrays = {}, {}
        for prefix, space in (("nodes", self.nodes), ("preds", self.preds)):
            m, a = space.to_arrays()
            meta[prefix] = m
            for k, v in a.items():
                arrays[f"{prefix}_{k}"] = v
        return meta, arrays

    @classmethod
    def from_arrays(cls, meta, arrays) -> "TermDict":
        spaces = {}
        for prefix in ("nodes", "preds"):
            sub = {k[len(prefix) + 1:]: v for k, v in arrays.items()
                   if k.startswith(prefix + "_")}
            spaces[prefix] = StringSpace.from_arrays(meta[prefix], sub)
        return cls(spaces["nodes"], spaces["preds"])


# -- string-pattern resolution (engine surfaces) -------------------------------

def _is_var(term) -> bool:
    return isinstance(term, str) and term.startswith("?")


def resolve_string_triple(td: TermDict, s, p, o):
    """Map one string (S, P, O) pattern to ids. ``None`` stays unbound; a
    bound term unknown to the dictionary gives ``known=False`` so the caller
    answers empty without executing. Returns ``(s_id, p_id, o_id, known)``."""
    ids = []
    for term, space in ((s, td.nodes), (p, td.preds), (o, td.nodes)):
        if term is None:
            ids.append(None)
            continue
        if not isinstance(term, str):
            raise TypeError(f"string pattern terms must be str or None, got {term!r}")
        i = space.term_to_id(term)
        if i is None:
            return None, None, None, False
        ids.append(i)
    return ids[0], ids[1], ids[2], True


def resolve_string_bgp(td: TermDict, patterns):
    """Map string-term BGP patterns to id-term patterns.

    `patterns` is one ``(s, p, o)`` tuple or a list of them; each term is a
    ``?var`` name or a constant term string (int ids pass through). Returns
    ``(id_patterns, pred_vars, known)``: `pred_vars` is the set of variables
    in predicate position (their ids decode through the predicate space),
    and ``known=False`` means some constant is absent from the dictionary,
    so the BGP has no answers.
    """
    if patterns and isinstance(patterns[0], (str, int, np.integer)):
        patterns = [patterns]
    id_patterns = []
    pred_vars, node_vars = set(), set()
    known = True
    for pat in patterns:
        if len(pat) != 3:
            raise ValueError(f"BGP patterns are (s, p, o) triples, got {pat!r}")
        out = []
        for slot, term in enumerate(pat):
            is_pred = slot == 1
            if _is_var(term):
                (pred_vars if is_pred else node_vars).add(term)
                out.append(term)
            elif isinstance(term, (int, np.integer)):
                out.append(int(term))
            elif isinstance(term, str):
                i = td.pred_id(term) if is_pred else td.node_id(term)
                if i is None:
                    known = False
                    i = 0  # placeholder: the caller answers empty on known=False
                out.append(i)
            else:
                raise TypeError(f"unsupported string BGP term: {term!r}")
        id_patterns.append(tuple(out))
    both = pred_vars & node_vars
    if both:
        raise ValueError(
            f"variable(s) {sorted(both)} appear in both predicate and "
            "subject/object positions; predicate and node id spaces are "
            "disjoint, so their bindings cannot decode to one term")
    return id_patterns, pred_vars, known


def bgp_result_to_terms(td: TermDict, result, pred_vars) -> list[dict]:
    """A :class:`~repro_torch.core.bgp.BGPResult` as ``[{var: term}, ...]``,
    its rows read back once; predicate-position variables decode through
    the predicate space."""
    decode = [td.pred_term if v in pred_vars else td.node_term for v in result.vars]
    return [{v: decode[j](row[j]) for j, v in enumerate(result.vars)}
            for row in result.rows.tolist()]
