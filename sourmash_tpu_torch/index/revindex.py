"""RevIndex: inverted hash -> dataset index, in memory and on disk.

The port of `sourmash_tpu/index/revindex.py`; its directories are the JAX
package's byte for byte (`FORMAT_NAME`, version 3), so either package
loads the other's. Behavior parity: reference `src/sourmash/index/revindex.py` (Python
wrapper API) and `src/core/src/index/revindex/` (mem_revindex.rs:1-461,
disk_revindex.rs:45-466 — the RocksDB-backed "branchwater" index with
incremental, resumable builds keyed on processed dataset md5s).

Design: instead of RocksDB posting lists the collection lives on the
device as bucketed row banks (`ops/index_ops.py`): overlap counting is one
`counts_rows` launch per bank chunk, and gather's rounds ride the same
planes (`index/flat.py`). The on-disk format replaces RocksDB with a
versioned directory:

    <path>/revindex.json   header: version, sketch params, processed md5s
    <path>/hashes.npy      per-dataset sorted uint64 mins, concatenated (v2)
    <path>/offsets.npy     int64 [n+1] dataset boundaries in hashes.npy (v2)
    <path>/planes/         packed bucketed u32 hi/lo/cnt planes + spills (v3)
    <path>/sigs.zip        signature collection (manifest-bearing zip)

(v1 directories — hashes sorted globally with a parallel datasets.npy id
array — and v2 directories without planes/ are still read.) numpy
mmap-loads the tensors and the signatures of sigs.zip come through the
flat-view cache, so opening a directory a second time is cheap. At first
query the raw mins are packed on the device when they fit its budget;
beyond it the v3 planes stream from their mmaps to the device per query
pass, with no host re-pack.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import LinearIndex, _check_select_parameters, select_signature
from .flat import FlatIndex

FORMAT_NAME = "sourmash-tpu-revindex"
FORMAT_VERSION = 3  # v3 adds planes/ with the packed bucketed banks


class RevIndex(FlatIndex):
    """In-memory reverse index (reference `index/revindex.py:14-239` API).

    Accepts signatures or signature paths; `template` (a MinHash) acts as
    the selection template, `threshold` filters low-overlap candidates in
    `counter_gather`.
    """

    is_database = True

    def __init__(
        self,
        *,
        signatures=None,
        signature_paths=None,
        template=None,
        threshold=0,
        queries=None,
        keep_sigs=False,
        location=None,
    ):
        sigs = list(signatures) if signatures else []
        if signature_paths:
            from .. import sourmash_args

            for path in signature_paths:
                sigs.extend(sourmash_args.load_file_as_signatures(path))
        if template is not None:
            sigs = [
                ss
                for ss in sigs
                if select_signature(
                    ss, ksize=template.ksize, moltype=template.moltype
                )
            ]
        super().__init__(sigs, location)
        self.template = template
        self.threshold = threshold
        self.queries = queries
        self.keep_sigs = keep_sigs

    def select(self, **kwargs):
        _check_select_parameters(**kwargs)
        # manifest semantics: containment filters to scaled sketches rather
        # than requiring an explicit scaled= (reference manifest.py:324)
        containment = kwargs.pop("containment", False)
        keep = [i for i, ss in enumerate(self._signatures) if select_signature(ss, **kwargs)]
        if containment or kwargs.get("scaled"):
            keep = [i for i in keep if self._signatures[i].minhash.scaled]
        out = RevIndex(signatures=[self._signatures[i] for i in keep], location=self._location)
        out.template = self.template
        out.threshold = self.threshold
        if len(keep) == len(self._signatures) and self._ds_mins is not None:
            # a selection that keeps every dataset (gather's ksize / moltype
            # / containment select) keeps the loaded mins and disk planes
            out._ds_mins, out._scaled = self._ds_mins, self._scaled
            out._banks_dir = self._banks_dir
        return out

    @property
    def scaled(self):
        self._build()
        return self._scaled

    def save(self, path):
        "Write the versioned on-disk format (see module docstring)."
        save_revindex(self, path)

    @classmethod
    def load(cls, location):
        return load_revindex(location)


def save_revindex(index, path, *, processed=None):
    "Serialize any collection of scaled signatures as a disk revindex."
    from ..save_load import SaveSignaturesToLocation

    sigs = list(index.signatures())
    os.makedirs(path, exist_ok=True)

    # sigs.zip holds the actual sketches for returning matches
    zip_path = os.path.join(path, "sigs.zip")
    if os.path.exists(zip_path):
        os.unlink(zip_path)
    with SaveSignaturesToLocation(zip_path) as save_sigs:
        for ss in sigs:
            save_sigs.add(ss)

    # per-dataset sorted mins at the common scaled, concatenated + offsets.
    # Packed on the host: the planes are being persisted to disk, and a
    # device pack would send every byte to the card just to read it back.
    fi = FlatIndex(sigs)
    fi._build(resident=False)
    mins_list = fi._ds_mins
    offsets = np.zeros(len(mins_list) + 1, dtype=np.int64)
    np.cumsum([len(m) for m in mins_list], out=offsets[1:])
    H = (
        np.concatenate(mins_list)
        if mins_list
        else np.zeros(0, dtype=np.uint64)
    )
    np.save(os.path.join(path, "hashes.npy"), H)
    np.save(os.path.join(path, "offsets.npy"), offsets)

    # v3: persist the packed bucketed planes so loading skips the host pack
    from ..ops.index_ops import save_banks

    save_banks(fi._banks, os.path.join(path, "planes"))

    if processed is None:
        processed = [ss.md5sum() for ss in sigs]
    header = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "n_datasets": len(sigs),
        "dataset_order": [ss.md5sum() for ss in sigs],
        "scaled": int(fi._scaled),
        "ksize": sigs[0].minhash.ksize if sigs else None,
        "moltype": sigs[0].minhash.moltype if sigs else None,
        "seed": sigs[0].minhash.seed if sigs else None,
        "processed": processed,
    }
    with open(os.path.join(path, "revindex.json"), "w") as fp:
        json.dump(header, fp)
    return path


def is_revindex_dir(path):
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "revindex.json")
    )


def load_revindex(path):
    "Load a disk revindex; tensors are mmapped until first device use."
    from .. import save_load
    from ..save_load import IndexNotLoaded

    header_path = os.path.join(path, "revindex.json")
    if not os.path.exists(header_path):
        raise IndexNotLoaded(f"{path} is not a revindex directory")
    with open(header_path) as fp:
        header = json.load(fp)
    if header.get("format") != FORMAT_NAME:
        raise IndexNotLoaded(f"{path}: unknown revindex format")
    if header.get("version", 0) > FORMAT_VERSION:
        raise IndexNotLoaded(
            f"{path}: revindex version {header['version']} too new"
        )

    sigs = _zip_signatures(save_load._load_database(os.path.join(path, "sigs.zip"), False))

    # restore the save-time dataset order (D ids index into it)
    order = header.get("dataset_order")
    if order:
        by_md5 = {}
        for ss in sigs:
            by_md5.setdefault(ss.md5sum(), []).append(ss)
        sigs = [by_md5[md5].pop(0) for md5 in order]

    idx = RevIndex(signatures=sigs, location=path)

    H = np.load(os.path.join(path, "hashes.npy"), mmap_mode="r")
    offsets_path = os.path.join(path, "offsets.npy")
    if os.path.exists(offsets_path):  # v2: per-dataset concatenation
        offsets = np.load(offsets_path)
        idx._ds_mins = [
            np.asarray(H[offsets[i] : offsets[i + 1]])
            for i in range(len(sigs))
        ]
    else:  # v1: globally hash-sorted pairs with a parallel dataset-id array
        D = np.asarray(np.load(os.path.join(path, "datasets.npy"), mmap_mode="r"))
        order = np.argsort(D, kind="stable")
        bounds = np.searchsorted(D[order], np.arange(len(sigs) + 1))
        Hs = np.asarray(H)[order]
        idx._ds_mins = [
            Hs[bounds[i] : bounds[i + 1]] for i in range(len(sigs))
        ]
    idx._scaled = int(header["scaled"])
    planes_dir = os.path.join(path, "planes")
    if os.path.exists(os.path.join(planes_dir, "banks.json")):
        idx._banks_dir = planes_dir  # FlatIndex._build loads these lazily
    return idx


def _zip_signatures(sigs_idx):
    """The signatures of a directory's sigs.zip, in its manifest's order,
    through the flat-view cache (`view_cache.py`): a warm load skips the
    zip's decompression, JSON and md5s. A zip without a manifest is read."""
    from . import view_cache

    manifest = getattr(sigs_idx, "manifest", None)
    key = None
    if manifest is not None:
        key = view_cache.collection_cache_key(sigs_idx.location, manifest.rows)
    hit = view_cache.load(key)
    if hit is not None:
        return hit[0]
    sigs = list(sigs_idx.signatures())
    view_cache.store(key, sigs)
    return sigs


def update_revindex(path, new_sigs):
    """Incrementally add signatures (reference `disk_revindex.rs:96-112`
    resumable-build semantics: datasets whose md5 is already recorded in
    the 'processed' header list are skipped)."""
    idx = load_revindex(path)
    processed = set()
    with open(os.path.join(path, "revindex.json")) as fp:
        header = json.load(fp)
    processed.update(header.get("processed", []))

    added = 0
    sigs = list(idx.signatures())
    for ss in new_sigs:
        md5 = ss.md5sum()
        if md5 in processed:
            continue
        sigs.append(ss)
        processed.add(md5)
        added += 1
    if not added:
        return idx, 0

    merged = LinearIndex(sigs)
    save_revindex(merged, path, processed=sorted(processed))
    return load_revindex(path), added
