"""Signature-bearing leaves for the SBT index.

Provides the glue between the generic bloom-filter tree in `sbt.py` and
sourmash signatures: a `Leaf` subclass whose payload is a serialized
signature, plus the three convenience entry points the CLI and API use
(the port's copy of `sourmash_tpu/sbtmh.py`; parity surface: reference
`src/sourmash/sbtmh.py`).
"""

from __future__ import annotations

import sys
from io import BytesIO

from . import signature
from .sbt import SBT, GraphFactory, Leaf

__all__ = ["SigLeaf", "create_sbt_index", "load_sbt_index", "search_sbt_index"]

# GraphFactory(ksize, starting_size, n_tables) defaults for fresh trees.
_DEFAULT_NT = 4
_DEFAULT_KSIZE = 1


def create_sbt_index(bloom_filter_size=1e5, n_children=2):
    "Create an empty SBT index."
    factory = GraphFactory(_DEFAULT_KSIZE, bloom_filter_size, _DEFAULT_NT)
    return SBT(factory, d=n_children)


def load_sbt_index(filename, *, print_version_warning=True, cache_size=None):
    "Load and return an SBT index."
    kwargs = dict(
        leaf_loader=SigLeaf.load,
        print_version_warning=print_version_warning,
        cache_size=cache_size,
    )
    return SBT.load(filename, **kwargs)


def search_sbt_index(tree, query, threshold):
    "Search an SBT index with a query signature; yields (match, score) pairs."
    hits = tree.search(query, threshold=threshold, unload_data=True)
    return ((result.signature, result.score) for result in _as_triples(hits))


class _as_triples:
    """Adapt the tree's (score, match, location) tuples to named access."""

    __slots__ = ("_hits",)

    def __init__(self, hits):
        self._hits = iter(hits)

    def __iter__(self):
        return self

    def __next__(self):
        score, match, _location = next(self._hits)
        return _Hit(score, match)


class _Hit:
    __slots__ = ("score", "signature")

    def __init__(self, score, sig):
        self.score = score
        self.signature = sig


class SigLeaf(Leaf):
    """A tree leaf whose payload is one signature, stored as gzipped JSON.

    The signature is lazily deserialized from the tree's storage on first
    access and cached on the node thereafter.
    """

    def __str__(self):
        return f"**Leaf:{self.name} -> {self.metadata}"

    # -- payload access ------------------------------------------------

    def _materialize(self):
        raw = self.storage.load(self._path)
        return signature.load_one_signature_from_json(BytesIO(raw))

    @property
    def data(self):
        if self._data is None:
            self._data = self._materialize()
        return self._data

    @data.setter
    def data(self, new_data):
        self._data = new_data

    # -- persistence ---------------------------------------------------

    def save(self, path):
        # Force the lazy load first: `path` may alias the backing file we
        # are about to truncate.
        sig = self.data
        serialized = signature.save_signatures_to_json([sig], compression=1)
        return self.storage.save(path, serialized)

    def make_manifest_row(self, loc):
        from .manifest import CollectionManifest

        return CollectionManifest.make_manifest_row(
            self.data, loc, include_signature=0
        )

    # -- internal-node maintenance ------------------------------------

    def update(self, parent):
        """Fold this leaf's hashes into `parent`'s bloom filter.

        Also ratchets the parent's `min_n_below` bookkeeping, which the
        downsampling search bound depends on (never below 1).
        """
        mh = self.data.minhash
        parent.data.update(mh)
        prior = parent.metadata.get("min_n_below", sys.maxsize)
        parent.metadata["min_n_below"] = min(prior, len(mh)) or 1
