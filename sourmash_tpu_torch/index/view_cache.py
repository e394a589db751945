"""Sidecar cache for device flat views over signature collections.

The port of `sourmash_tpu/index/view_cache.py`. The reference pays its
collection-load cost in Rust each run; here the equivalent cost is JSON
decode + signature materialization before the device pack. This module
memoizes the *extracted signature payloads* of a
collection's flat view on disk (a plain ``.npz`` of concatenated hash
arrays + metadata), so a warm ``sourmash gather meta.sig db.zip`` skips
zip decompression, JSON parsing and md5 verification entirely and goes
straight to the on-device pack.

Keying: the cache key hashes the collection's identity (absolute path,
size, mtime_ns) together with the exact ordered selection outcome
(md5 / name / internal_location of every manifest row) — so re-writing
the zip, or selecting a different subset, misses cleanly. Entries are
written atomically and evicted oldest-first over a byte budget. A corrupt
or stale entry is a miss: the caller reads the collection itself. The
entries' layout is the JAX package's, in a directory of the port's own.

Env knobs:
  SOURMASH_TORCH_VIEW_CACHE=0        disable entirely
  SOURMASH_TORCH_VIEW_CACHE_DIR      cache directory
                                     (default ~/.cache/sourmash_tpu_torch/flatview)
  SOURMASH_TORCH_VIEW_CACHE_BYTES    eviction budget (default 20e9)

`STATS` counts this process's hits, misses and the bytes read and written.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

_VERSION = 1
_MOLTYPES = ("DNA", "protein", "dayhoff", "hp")
ENABLE_ENV = "SOURMASH_TORCH_VIEW_CACHE"
DIR_ENV = "SOURMASH_TORCH_VIEW_CACHE_DIR"
BYTES_ENV = "SOURMASH_TORCH_VIEW_CACHE_BYTES"

STATS = dict(hits=0, misses=0, bytes_read=0, bytes_written=0)


def reset_stats():
    for key in STATS:
        STATS[key] = 0


def _enabled():
    return os.environ.get(ENABLE_ENV, "1") != "0"


def _cache_dir():
    d = os.environ.get(DIR_ENV)
    if not d:
        d = os.path.join(
            os.path.expanduser("~"), ".cache", "sourmash_tpu_torch", "flatview"
        )
    return d


def collection_cache_key(path, manifest_rows, extra_stat_paths=()):
    """Cache key for a collection file + its ordered selected rows, or
    None when the collection can't be keyed (no stat-able path).
    `extra_stat_paths` pins referenced member files (size + mtime) for
    collections whose manifest points at separate signature files."""
    if not _enabled() or not path:
        return None
    h = hashlib.sha256()
    try:
        st = os.stat(path)
        h.update(
            f"v{_VERSION}|{os.path.abspath(path)}|{st.st_size}|{st.st_mtime_ns}|".encode()
        )
        for p in extra_stat_paths:
            st = os.stat(p)
            h.update(f"{p}|{st.st_size}|{st.st_mtime_ns}|".encode())
    except OSError:
        return None
    for row in manifest_rows:
        h.update(
            json.dumps(
                [
                    row.get("md5"),
                    row.get("name"),
                    row.get("internal_location"),
                ]
            ).encode()
        )
        h.update(b"\n")
    return h.hexdigest()


def _entry_path(key):
    return os.path.join(_cache_dir(), key + ".npz")


def store(key, sigs, max_bytes=None, locations=None):
    """Serialize the flat view's signatures (and optional per-signature
    locations) under `key` (best-effort: any failure — read-only cache
    dir, exotic sketch state — just skips)."""
    if key is None:
        return False
    try:
        n = len(sigs)
        mins_off = np.zeros(n + 1, dtype=np.int64)
        ab_off = np.zeros(n + 1, dtype=np.int64)
        num = np.zeros(n, dtype=np.int64)
        ksize = np.zeros(n, dtype=np.int64)
        seed = np.zeros(n, dtype=np.int64)
        max_hash = np.zeros(n, dtype=np.uint64)
        mol = np.zeros(n, dtype=np.uint8)
        track = np.zeros(n, dtype=np.uint8)
        md5s = []
        meta = []  # (name, filename) with None-ness preserved
        mins_parts, ab_parts = [], []
        for i, ss in enumerate(sigs):
            mh = ss.minhash
            mins = mh.mins_array()
            mins_parts.append(mins)
            mins_off[i + 1] = mins_off[i] + len(mins)
            ab = mh.abunds_array()
            if mh.track_abundance:
                track[i] = 1
                ab_parts.append(ab)
                ab_off[i + 1] = ab_off[i] + len(ab)
            else:
                ab_off[i + 1] = ab_off[i]
            num[i] = mh.num
            ksize[i] = mh.ksize
            seed[i] = mh.seed
            max_hash[i] = mh._max_hash
            mol[i] = _MOLTYPES.index(mh._moltype)
            md5s.append(ss.md5sum())
            meta.append((ss._name, ss._filename))
        payload = json.dumps(
            {"sigs": meta, "locations": list(locations) if locations else None}
        ).encode("utf-8")
        mins_cat = (
            np.concatenate(mins_parts) if mins_parts
            else np.zeros(0, dtype=np.uint64)
        )
        ab_cat = (
            np.concatenate(ab_parts) if ab_parts
            else np.zeros(0, dtype=np.uint64)
        )
        d = _cache_dir()
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fp:
                np.savez(
                    fp,
                    version=np.int64(_VERSION),
                    mins_cat=mins_cat,
                    mins_off=mins_off,
                    ab_cat=ab_cat,
                    ab_off=ab_off,
                    num=num,
                    ksize=ksize,
                    seed=seed,
                    max_hash=max_hash,
                    mol=mol,
                    track=track,
                    md5=np.array(md5s, dtype="S32"),
                    meta=np.frombuffer(payload, dtype=np.uint8),
                )
            os.replace(tmp, _entry_path(key))
            STATS["bytes_written"] += os.path.getsize(_entry_path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _evict(max_bytes)
        return True
    except Exception:
        return False


def load(key):
    """Rebuild the flat view's (signatures, per-sig locations or None)
    from the cache, or None on miss / any inconsistency (callers fall
    back to the real load)."""
    if key is None:
        return None
    path = _entry_path(key)
    hit = _load_entry(path)
    if hit is None:
        STATS["misses"] += 1
    else:
        STATS["hits"] += 1
        STATS["bytes_read"] += os.path.getsize(path)
    return hit


def _load_entry(path):
    "The entry at `path` as (signatures, locations or None), or None."
    try:
        with np.load(path, allow_pickle=False) as z:
            if int(z["version"]) != _VERSION:
                return None
            mins_cat = z["mins_cat"]
            mins_off = z["mins_off"]
            ab_cat = z["ab_cat"]
            ab_off = z["ab_off"]
            num, ksize, seed = z["num"], z["ksize"], z["seed"]
            max_hash, mol, track = z["max_hash"], z["mol"], z["track"]
            md5 = z["md5"]
            payload = json.loads(bytes(z["meta"].tobytes()).decode("utf-8"))
        meta = payload["sigs"]
        locations = payload["locations"]
        n = len(num)
        if not (
            len(meta) == n
            and (locations is None or len(locations) == n)
            and len(md5) == n
            and len(mins_off) == n + 1
            and mins_off[-1] == len(mins_cat)
            and ab_off[-1] == len(ab_cat)
        ):
            return None
        from ..minhash import MinHash
        from ..signature import SourmashSignature

        os.utime(path)  # LRU touch for eviction
        sigs = []
        for i in range(n):
            mt = _MOLTYPES[mol[i]]
            mh = MinHash(
                int(num[i]),
                int(ksize[i]),
                seed=int(seed[i]),
                max_hash=int(max_hash[i]),
                is_protein=mt == "protein",
                dayhoff=mt == "dayhoff",
                hp=mt == "hp",
                track_abundance=bool(track[i]),
            )
            mins = mins_cat[mins_off[i] : mins_off[i + 1]]
            if track[i]:
                mh._set_mins_internal(mins, ab_cat[ab_off[i] : ab_off[i + 1]])
            else:
                mh._set_mins_internal(mins)
            mh._md5cache = md5[i].decode("ascii")
            name, filename = meta[i]
            sig = SourmashSignature(
                mh, name=name or "", filename=filename or ""
            )
            sig._name = name
            sig._filename = filename
            sigs.append(sig.to_frozen())
        return sigs, locations
    except Exception:
        return None


def _evict(max_bytes=None):
    "Drop oldest entries past the byte budget (best-effort)."
    if max_bytes is None:
        max_bytes = int(
            float(os.environ.get(BYTES_ENV, "20e9"))
        )
    try:
        d = _cache_dir()
        entries = []
        for fn in os.listdir(d):
            if fn.endswith(".npz"):
                p = os.path.join(d, fn)
                st = os.stat(p)
                entries.append((st.st_mtime_ns, st.st_size, p))
        entries.sort(reverse=True)
        total = 0
        for mt, size, p in entries:
            total += size
            if total > max_bytes:
                try:
                    os.unlink(p)
                except OSError:
                    pass
    except OSError:
        pass
