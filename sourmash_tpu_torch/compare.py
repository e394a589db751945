"""All-pairs signature comparison matrices (`sourmash compare`): the port
of `sourmash_tpu/compare.py` (itself reference `src/sourmash/compare.py`:
compare_serial:14, compare_serial_containment:67, compare_all_pairs:328).

The whole intersection-count matrix is computed in one batched pass
(`ops/intersect.pairwise_intersection_counts`: the `pairwise_counts` join
on CUDA, the sorted engine on the CPU), and the abundance-product matrix of
angular similarity by the `pairwise_products` join
(`ops/bucketed.pairwise_weighted_products`);
the scalar similarity and ANI formulas run on the host per pair, with
numerics identical to the reference, so both packages write the same
floats. `compare_parallel` delegates to the batched path.
"""

from __future__ import annotations

import itertools

import numpy as np

from .logging import notify
from .ops.intersect import pairwise_intersection_counts
from .sketchcomparison import FracMinHashComparison


def _warn_potential_false_negatives(flagged):
    "One-shot chance-false-negative warning shared by the all-pairs loops."
    if flagged:
        notify(
            "WARNING: Some of these sketches may have no hashes in common based on chance alone (false negatives). Consider decreasing your scaled value to prevent this."
        )


def _can_batch(mhs, need_flat=True):
    """Device-batchable: all scaled, same scaled/ksize/moltype/seed.
    The batched path computes raw intersection counts; abundance-weighted
    (angular) similarity still needs per-pair abundances."""
    if not mhs:
        return False
    first = mhs[0]
    if not first.scaled:
        return False
    for mh in mhs:
        if (
            mh._max_hash != first._max_hash
            or mh.ksize != first.ksize
            or mh.moltype != first.moltype
            or mh.seed != first.seed
        ):
            return False
    return True


def _count_matrix(mhs):
    "Batched [n, n] intersection-count matrix over flattened sketches."
    return pairwise_intersection_counts([mh.mins_array() for mh in mhs])


def _containment_from_counts(common, len_self, scaled):
    "contained_by() numerics (minhash.py:819-841), from a raw common count."
    if not len_self:
        return 0.0
    total_denom = float(len_self * scaled)
    bias_factor = 1.0 - (1.0 - 1.0 / scaled) ** total_denom
    return max(0.0, min(1.0, common / (len_self * bias_factor)))


def _abund_products_fit_exactly(mhs):
    """True when every pairwise abundance-product sum is exactly
    representable in both i64 (device accumulation) and f64 (the host
    merge-join) — guaranteeing the batched angular path is bit-identical
    to per-pair `angular_similarity`."""
    max_a = 0
    max_len = 0
    for mh in mhs:
        ab = mh._abunds
        if ab is None or not len(ab):
            continue
        max_a = max(max_a, int(ab.max()))
        max_len = max(max_len, len(ab))
    # worst-case sum: max_len * max_a^2 must stay under 2**53
    return max_a < 2**20 and max_len * max_a * max_a < 2**53


def _angular_matrix_batched(mhs, similarities):
    """Abundance-weighted (angular) all-pairs matrix with the product sums
    computed in one batched pass (`pairwise_weighted_products`);
    the scalar cosine->angular conversion matches `angular_similarity`
    (minhash.py:791) exactly."""
    from .ops.bucketed import pairwise_weighted_products

    prods = pairwise_weighted_products(
        [mh.mins_array() for mh in mhs],
        [mh._abunds for mh in mhs],
    )
    norms = np.array(
        [
            np.sqrt(float(np.sum(mh._abunds.astype(np.float64) ** 2)))
            for mh in mhs
        ]
    )
    n = len(mhs)
    for i, j in itertools.combinations(range(n), 2):
        if norms[i] == 0.0 or norms[j] == 0.0:
            v = 0.0
        else:
            cos = min(float(prods[i, j]) / (norms[i] * norms[j]), 1.0)
            v = 1.0 - 2.0 * np.arccos(cos) / np.pi
        similarities[i][j] = similarities[j][i] = v
    return similarities


class _AniTracker:
    """Accumulate ANI warnings across an all-pairs loop.

    `take(result)` records the flags on one ANIResult and returns its ani
    as a float (None -> 0.0); `warn()` emits each triggered warning once.
    """

    _FN_WARNING = (
        "WARNING: Some of these sketches may have no hashes in common based"
        " on chance alone (false negatives). Consider decreasing your scaled"
        " value to prevent this."
    )
    _JE_WARNING = (
        "WARNING: Jaccard estimation for at least one of these comparisons"
        " is likely inaccurate. Could not estimate ANI for these comparisons."
    )

    def __init__(self):
        self.false_negatives = False
        self.untrustworthy = False

    def take(self, result):
        self.false_negatives |= bool(result.p_exceeds_threshold)
        self.untrustworthy |= bool(getattr(result, "je_exceeds_threshold", False))
        return 0.0 if result.ani is None else result.ani

    def warn(self):
        if self.untrustworthy:
            notify(self._JE_WARNING)
        if self.false_negatives:
            notify(self._FN_WARNING)


def compare_serial(siglist, ignore_abundance, *, downsample=False, return_ani=False):
    """All-pairs similarity matrix (Jaccard, or angular if both sketches
    track abundance and ignore_abundance is False)."""
    n = len(siglist)
    similarities = np.ones((n, n))
    tracker = _AniTracker()

    mhs = [s.minhash for s in siglist]
    use_batch = _can_batch(mhs) and (
        return_ani
        or ignore_abundance
        or all(not mh.track_abundance for mh in mhs)
    )

    if (
        not use_batch
        and not return_ani
        and not ignore_abundance
        and _can_batch(mhs)
        and all(mh.track_abundance for mh in mhs)
        and _abund_products_fit_exactly(mhs)
    ):
        return _angular_matrix_batched(mhs, similarities)

    if use_batch:
        counts = _count_matrix(mhs)
        lens = np.array([len(mh) for mh in mhs], dtype=np.int64)
        for i, j in itertools.combinations(range(n), 2):
            common = int(counts[i, j])
            union = int(lens[i] + lens[j] - common)
            jaccard = common / max(1, union)
            if return_ani:
                # the expensive set op is batched above; the closed-form
                # ANI conversion runs per pair with the precomputed jaccard
                ani = tracker.take(siglist[i].jaccard_ani(siglist[j], jaccard=jaccard))
                similarities[i][j] = similarities[j][i] = ani
            else:
                similarities[i][j] = similarities[j][i] = jaccard
        tracker.warn()
        return similarities

    for i, j in itertools.combinations(range(n), 2):
        if return_ani:
            result = siglist[i].jaccard_ani(siglist[j], downsample=downsample)
            similarities[i][j] = similarities[j][i] = tracker.take(result)
        else:
            similarities[i][j] = similarities[j][i] = siglist[i].similarity(
                siglist[j], ignore_abundance=ignore_abundance, downsample=downsample
            )

    tracker.warn()
    return similarities


def compare_serial_containment(siglist, *, downsample=False, return_ani=False):
    "All-pairs containment matrix: C[i][j] = containment of j in i."
    n = len(siglist)
    containments = np.ones((n, n))
    tracker = _AniTracker()

    mhs = [s.minhash for s in siglist]
    if _can_batch(mhs):
        counts = _count_matrix(mhs)
        scaled = mhs[0].scaled
        lens = np.array([len(mh) for mh in mhs], dtype=np.int64)
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                c = _containment_from_counts(int(counts[i, j]), int(lens[j]), scaled)
                if return_ani:
                    result = siglist[j].containment_ani(siglist[i], containment=c)
                    containments[i][j] = tracker.take(result)
                else:
                    containments[i][j] = c
        tracker.warn()
        return containments

    for i in range(n):
        for j in range(n):
            if i == j:
                containments[i][j] = 1
            elif return_ani:
                result = siglist[j].containment_ani(siglist[i], downsample=downsample)
                containments[i][j] = tracker.take(result)
            else:
                containments[i][j] = siglist[j].contained_by(
                    siglist[i], downsample=downsample
                )
    tracker.warn()
    return containments


def compare_serial_max_containment(siglist, *, downsample=False, return_ani=False):
    "All-pairs max-containment matrix."
    n = len(siglist)
    containments = np.ones((n, n))
    tracker = _AniTracker()

    mhs = [s.minhash for s in siglist]
    if _can_batch(mhs):
        counts = _count_matrix(mhs)
        scaled = mhs[0].scaled
        lens = np.array([len(mh) for mh in mhs], dtype=np.int64)
        for i, j in itertools.combinations(range(n), 2):
            md = int(min(lens[i], lens[j]))
            v = _containment_from_counts(int(counts[i, j]), md, scaled)
            if return_ani:
                result = siglist[j].max_containment_ani(siglist[i], max_containment=v)
                v = tracker.take(result)
            containments[i][j] = containments[j][i] = v
        tracker.warn()
        return containments

    for i, j in itertools.combinations(range(n), 2):
        if return_ani:
            result = siglist[j].max_containment_ani(siglist[i], downsample=downsample)
            containments[i][j] = containments[j][i] = tracker.take(result)
        else:
            containments[i][j] = containments[j][i] = siglist[j].max_containment(
                siglist[i], downsample=downsample
            )
    tracker.warn()
    return containments


def compare_serial_avg_containment(siglist, *, downsample=False, return_ani=False):
    "All-pairs average-containment matrix."
    n = len(siglist)
    containments = np.ones((n, n))
    potential_false_negatives = False

    mhs = [s.minhash for s in siglist]
    if _can_batch(mhs):
        counts = _count_matrix(mhs)
        scaled = mhs[0].scaled
        lens = np.array([len(mh) for mh in mhs], dtype=np.int64)
        for i, j in itertools.combinations(range(n), 2):
            c1 = _containment_from_counts(int(counts[i, j]), int(lens[j]), scaled)
            c2 = _containment_from_counts(int(counts[i, j]), int(lens[i]), scaled)
            if return_ani:
                # FracMinHashComparison(mh_j, mh_i) semantics with the
                # containments precomputed from the batched counts
                cmp = FracMinHashComparison(siglist[j].minhash, siglist[i].minhash)
                cmp.estimate_ani_from_mh1_containment_in_mh2(containment=c1)
                cmp.estimate_ani_from_mh2_containment_in_mh1(containment=c2)
                a1 = cmp.ani_from_mh1_containment_in_mh2
                a2 = cmp.ani_from_mh2_containment_in_mh1
                if not potential_false_negatives and cmp.potential_false_negative:
                    potential_false_negatives = True
                v = 0.0 if (a1 is None or a2 is None) else (a1 + a2) / 2
            else:
                v = (c1 + c2) / 2
            containments[i][j] = containments[j][i] = v
        _warn_potential_false_negatives(potential_false_negatives)
        return containments

    for i, j in itertools.combinations(range(n), 2):
        if return_ani:
            cmp = FracMinHashComparison(siglist[j].minhash, siglist[i].minhash)
            ani = cmp.avg_containment_ani
            if not potential_false_negatives and cmp.potential_false_negative:
                potential_false_negatives = True
            if ani is None:
                ani = 0.0
            containments[i][j] = containments[j][i] = ani
        else:
            containments[i][j] = containments[j][i] = siglist[j].avg_containment(
                siglist[i], downsample=downsample
            )
    _warn_potential_false_negatives(potential_false_negatives)
    return containments


def compare_parallel(
    siglist, ignore_abundance, downsample, n_jobs, return_ani=False
):
    """The reference uses a fork+memmap process pool (`compare.py:241-325`);
    here the batched path already parallelizes the hot loop, so this simply
    delegates (with the reference package's message)."""
    notify(f"(-p {n_jobs} noted; using batched device comparison)")
    return compare_serial(
        siglist,
        ignore_abundance=ignore_abundance,
        downsample=downsample,
        return_ani=return_ani,
    )


def compare_all_pairs(
    siglist, ignore_abundance, downsample=False, n_jobs=None, return_ani=False
):
    "Dispatch to serial or 'parallel' (batched device) comparison."
    if n_jobs is None or n_jobs == 1:
        return compare_serial(
            siglist,
            ignore_abundance=ignore_abundance,
            downsample=downsample,
            return_ani=return_ani,
        )
    return compare_parallel(
        siglist, ignore_abundance, downsample, n_jobs, return_ani=return_ani
    )
