"""Plain numpy reference of `sourmash gather` against a scaled collection.

Independent of the program: the collection is the benchmark's own flat
array of hashes with per-member offsets, and each query a sorted array of
distinct hashes with abundances (or none, read as 1). The greedy
min-set-cover follows sourmash's gather: candidates are members sharing at
least the threshold with the query; each round takes the member with the
most hashes in common with what remains of the query (the lowest index on
ties), reports its overlap with the whole query (`intersect_bp`) and with
what remains (`unique_intersect_bp`), the abundance-weighted share of the
query it removes (`f_unique_weighted`) and the bases left (`remaining_bp`),
and removes those hashes; it stops when no member holds the threshold of
what remains. The greedy core is `chip_smoke.oracle_gather`'s, copied.
Imports numpy alone.
"""

from __future__ import annotations

import numpy as np

_TABLE_BITS = 27  # the prefilter's direct-address table: 128 MiB of flags
_CHUNK = 1 << 24


class Holders:
    """For every hash of `qunion` (sorted, distinct), the members of the
    collection that hold it, as a CSR: starts[j] .. starts[j + 1] index
    `owners`. One pass over the collection: a direct-address table of the
    queries' low bits drops most hashes, a binary search confirms the
    rest."""

    def __init__(self, flat: np.ndarray, offsets: np.ndarray, qunion: np.ndarray):
        self.qunion = qunion
        bits = min(_TABLE_BITS, max(10, int(len(qunion)).bit_length() + 4))
        mask = np.uint64((1 << bits) - 1)
        table = np.zeros(1 << bits, dtype=bool)
        table[(qunion & mask).astype(np.int64)] = True
        hs, own = [], []
        for lo in range(0, len(flat), _CHUNK):
            chunk = flat[lo : lo + _CHUNK]
            at = np.flatnonzero(table[(chunk & mask).astype(np.int64)])
            if not len(at) or not len(qunion):
                continue
            vals = chunk[at]
            p = np.searchsorted(qunion, vals)
            p[p == len(qunion)] = 0
            hit = qunion[p] == vals
            hs.append(p[hit])
            own.append(np.searchsorted(offsets, lo + at[hit], side="right") - 1)
        h = np.concatenate(hs) if hs else np.zeros(0, dtype=np.int64)
        o = np.concatenate(own) if own else np.zeros(0, dtype=np.int64)
        order = np.lexsort((o, h))
        self.owners = o[order]
        self.starts = np.searchsorted(h[order], np.arange(len(qunion) + 1))

    def of(self, q: np.ndarray) -> tuple:
        """(position in q, member) of every pair of a hash of q and a member
        holding it, by position then member. q is sorted and in qunion."""
        j = np.searchsorted(self.qunion, q)
        lo = self.starts[j]
        n = self.starts[j + 1] - lo
        first = np.cumsum(n) - n
        at = np.repeat(lo - first, n) + np.arange(int(n.sum()))
        return np.repeat(np.arange(len(q)), n), self.owners[at]


def _members_hashes(flat, offsets, i: int) -> np.ndarray:
    return flat[offsets[i] : offsets[i + 1]]


def gather(q: np.ndarray, abunds, flat, offsets, holders: Holders, threshold_bp: int,
           scaled: int, greedy: bool = True) -> list:
    """Rows (member, intersect_bp, unique_intersect_bp, f_unique_weighted,
    remaining_bp) of the greedy gather of q (sorted, distinct).

    greedy=False is the benchmark's control: the members are taken in the
    order of their overlap with the whole query, never recounted against
    what remains, while that overlap holds the threshold."""
    n_members = len(offsets) - 1
    thresh = max(int(threshold_bp // scaled), 1)
    if len(q) * scaled < threshold_bp:
        return []
    ab = np.ones(len(q), dtype=np.int64) if abunds is None else np.asarray(abunds, np.int64)
    pos, cands = holders.of(q)
    counts0 = np.bincount(cands, minlength=n_members)
    keep = counts0[cands] >= thresh
    pos, cands = pos[keep], cands[keep]
    starts = np.searchsorted(pos, np.arange(len(q) + 1))
    counts = np.where(counts0 >= thresh, counts0, 0).astype(np.int64)
    fixed = counts.copy()
    alive = np.ones(len(q), dtype=bool)
    total = int(ab.sum())
    left = len(q)
    rows = []
    while True:
        best = int(np.argmax(counts if greedy else fixed))
        if (counts if greedy else fixed)[best] < thresh:
            break
        m = _members_hashes(flat, offsets, best)
        p = np.searchsorted(q, m)
        inside = p < len(q)
        p = p[inside][q[p[inside]] == m[inside]]
        p = np.sort(p[alive[p]])
        left -= len(p)
        rows.append((best, int(counts0[best]) * scaled, len(p) * scaled,
                     int(ab[p].sum()) / total, left * scaled))
        alive[p] = False
        fixed[best] = 0
        n = starts[p + 1] - starts[p]
        first = np.cumsum(n) - n
        held = cands[np.repeat(starts[p] - first, n) + np.arange(int(n.sum()))]
        counts -= np.bincount(held, minlength=n_members)
    return rows
