"""Pairwise sketch-comparison bundles.

A *comparison* object captures two MinHashes brought to a common resolution
(shared num, or shared scaled) and lazily exposes every derived statistic the
result rows in ``search.py`` need: jaccard, containments both directions,
ANI point estimates with optional confidence intervals, and the
abundance-weighted intersection used by gather.

API parity target: reference ``src/sourmash/sketchcomparison.py``
(BaseMinHashComparison:12, NumMinHashComparison:82, FracMinHashComparison:99).
Every set operation delegates to MinHash, whose bulk paths run through the
batched device ops — nothing here touches hashes directly.

The port's copy of `sourmash_tpu/sketchcomparison.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .minhash import MinHash

def _pairwise(method, reverse=False):
    "Build a property delegating to a MinHash pairwise method on the cmp views."

    def get(self):
        a, b = self.mh1_cmp, self.mh2_cmp
        if reverse:
            a, b = b, a
        return getattr(a, method)(b)

    get.__name__ = method
    return property(get)


@dataclass
class BaseMinHashComparison:
    "Two MinHashes plus the downsampled 'cmp' views they are scored on."

    mh1: MinHash
    mh2: MinHash
    ignore_abundance: bool = False
    jaccard_ani_untrustworthy: bool = False

    def downsample_and_handle_ignore_abundance(self, cmp_num=None, cmp_scaled=None):
        "Populate mh1_cmp/mh2_cmp: flattened if requested, then downsampled."
        pair = (self.mh1, self.mh2)
        if self.ignore_abundance:
            pair = tuple(mh.flatten() for mh in pair)

        if cmp_scaled is not None:
            pair = tuple(mh.downsample(scaled=cmp_scaled) for mh in pair)
        elif cmp_num is not None:
            pair = tuple(mh.downsample(num=cmp_num) for mh in pair)
        else:
            raise ValueError("Error: must pass in a comparison scaled or num value.")

        self.mh1_cmp, self.mh2_cmp = pair

    def check_compatibility_and_downsample(self, cmp_num=None, cmp_scaled=None):
        both_num = self.mh1.num and self.mh2.num
        both_scaled = self.mh1.scaled and self.mh2.scaled
        if not (both_num or both_scaled):
            raise TypeError("Error: Both sketches must be 'num' or 'scaled'.")

        self.downsample_and_handle_ignore_abundance(cmp_num=cmp_num,
                                                    cmp_scaled=cmp_scaled)
        if not self.mh1_cmp.is_compatible(self.mh2_cmp):
            raise TypeError("Error: Cannot compare incompatible sketches.")
        self.ksize, self.moltype = self.mh1.ksize, self.mh1.moltype

    # -- lazily-derived statistics -----------------------------------------

    @property
    def intersect_mh(self):
        """Flat MinHash holding the hashes common to both cmp sketches.

        Computed once per comparison: gather's result rows read this
        several times per round (containments, weighted stats), and the
        cmp views never change after construction."""
        cached = getattr(self, "_intersect_mh_cache", None)
        if cached is None:
            flat1, flat2 = self.mh1_cmp.flatten(), self.mh2_cmp.flatten()
            cached = flat1.intersection(flat2)
            self._intersect_mh_cache = cached
        return cached

    jaccard = _pairwise("jaccard")
    angular_similarity = _pairwise("angular_similarity")
    cosine_similarity = _pairwise("angular_similarity")

    def estimate_jaccard_ani(self, jaccard=None):
        info = self.mh1_cmp.jaccard_ani(self.mh2_cmp, jaccard=jaccard)
        self.jaccard_ani = info.ani
        if info.p_exceeds_threshold:
            self.potential_false_negative = True
        self.jaccard_ani_untrustworthy = info.je_exceeds_threshold


@dataclass
class FracMinHashComparison(BaseMinHashComparison):
    "Pair of scaled sketches compared at max(scaled1, scaled2) by default."

    cmp_scaled: int = None
    threshold_bp: int = 0
    estimate_ani_ci: bool = False
    ani_confidence: float = 0.95

    def __post_init__(self):
        if self.cmp_scaled is None:
            # compare at the coarser of the two resolutions
            self.cmp_scaled = max(self.mh1.scaled, self.mh2.scaled)
        self.check_compatibility_and_downsample(cmp_scaled=self.cmp_scaled)
        self.potential_false_negative = False

    @property
    def pass_threshold(self):
        return self.total_unique_intersect_hashes >= self.threshold_bp

    @property
    def size_may_be_inaccurate(self):
        "True when either sketch fails the Chernoff size-accuracy bound."
        accurate = (self.mh1_cmp.size_is_accurate()
                    and self.mh2_cmp.size_is_accurate())
        return not accurate

    @property
    def total_unique_intersect_hashes(self):
        "Intersection size scaled back up to ~bp (no (k-1) end correction)."
        return len(self.intersect_mh) * self.cmp_scaled

    # -- containment + ANI, both directions ---------------------------------
    #
    # The three ANI estimators share one recording pattern: stash the point
    # estimate under `<attr>`, flag potential false negatives, and (when CI
    # was requested) stash `<attr>_low` / `<attr>_high` too.

    def _record_ani(self, attr, info):
        setattr(self, attr, info.ani)
        if info.p_exceeds_threshold:
            self.potential_false_negative = True
        if self.estimate_ani_ci:
            setattr(self, attr + "_low", info.ani_low)
            setattr(self, attr + "_high", info.ani_high)

    def _ani_opts(self):
        return dict(confidence=self.ani_confidence, estimate_ci=self.estimate_ani_ci)

    mh1_containment_in_mh2 = _pairwise("contained_by")
    mh2_containment_in_mh1 = _pairwise("contained_by", reverse=True)
    max_containment = _pairwise("max_containment")
    avg_containment = _pairwise("avg_containment")

    def estimate_ani_from_mh1_containment_in_mh2(self, containment=None):
        info = self.mh1_cmp.containment_ani(
            self.mh2_cmp, containment=containment, **self._ani_opts()
        )
        self._record_ani("ani_from_mh1_containment_in_mh2", info)

    def estimate_ani_from_mh2_containment_in_mh1(self, containment=None):
        info = self.mh2_cmp.containment_ani(
            self.mh1_cmp, containment=containment, **self._ani_opts()
        )
        self._record_ani("ani_from_mh2_containment_in_mh1", info)

    def estimate_max_containment_ani(self, max_containment=None):
        info = self.mh1_cmp.max_containment_ani(
            self.mh2_cmp, max_containment=max_containment, **self._ani_opts()
        )
        self._record_ani("max_containment_ani", info)

    def _both_directional_anis(self):
        self.estimate_ani_from_mh1_containment_in_mh2()
        self.estimate_ani_from_mh2_containment_in_mh1()
        return (
            self.ani_from_mh1_containment_in_mh2,
            self.ani_from_mh2_containment_in_mh1,
        )

    @property
    def avg_containment_ani(self):
        "Mean of the two directional ANIs (None if either is undefined)."
        a1, a2 = self._both_directional_anis()
        if a1 is None or a2 is None:
            return None
        return (a1 + a2) / 2

    def estimate_all_containment_ani(self):
        "Directional ANIs plus max-containment ANI (max of the two)."
        a1, a2 = self._both_directional_anis()
        self.max_containment_ani = (
            None if (a1 is None or a2 is None) else max([a1, a2])
        )

    # -- gather support -----------------------------------------------------

    def weighted_intersection(self, from_mh=None, from_abundD={}):
        """Intersection with abundances re-attached from a source sketch/dict.

        Hashes missing from the abundance source count as abundance 1; with
        no usable source, the flat intersection is returned unchanged.
        """
        from .minhash import _HashesDict

        if from_mh is not None and from_mh.track_abundance:
            from_abundD = from_mh.hashes
        if not from_abundD:
            return self.intersect_mh

        weighted = self.intersect_mh.copy_and_clear()
        weighted.track_abundance = True
        mins = self.intersect_mh.mins_array()
        if isinstance(from_abundD, _HashesDict):
            # vectorized attach from the parallel (mins, abunds) arrays —
            # a per-hash dict .get over a _HashesDict costs one Python
            # searchsorted per hash
            src_m = from_abundD._mins
            src_a = from_abundD._abunds
            ab = np.ones(len(mins), dtype=np.uint64)
            if len(src_m) and len(mins) and src_a is not None:
                idx = np.searchsorted(src_m, mins)
                np.minimum(idx, len(src_m) - 1, out=idx)
                hit = src_m[idx] == mins
                ab[hit] = src_a[idx[hit]]
            weighted._set_mins_internal(mins.copy(), ab)
        else:
            weighted.set_abundances(
                {h: from_abundD.get(h, 1) for h in self.intersect_mh.hashes}
            )
        return weighted


@dataclass
class NumMinHashComparison(BaseMinHashComparison):
    "Pair of num-MinHashes compared at min(num1, num2) unless told otherwise."

    cmp_num: int = None

    def __post_init__(self):
        if self.cmp_num is None:
            self.cmp_num = min(self.mh1.num, self.mh2.num)
        self.check_compatibility_and_downsample(cmp_num=self.cmp_num)

    @property
    def size_may_be_inaccurate(self):
        return False
