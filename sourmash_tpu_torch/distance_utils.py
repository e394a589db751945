"""k-mer statistics → evolutionary distance (ANI) estimation.

Point estimates invert the expected containment/jaccard of two sequences at
per-base mutation rate r: E[containment] = (1-r)^k.  Confidence intervals
come from the variance model of Blanca et al. (the KoslickiLab
mutation-rate-ci-calculator, doi:10.1101/2022.01.11.475870), solved with
Brent's method.  Also here: the probability-of-sharing-nothing check used to
flag potential false negatives, and sketch-size accuracy bounds.

API parity target: reference ``src/sourmash/distance_utils.py``
(ANIResult:44, containment_to_distance:258, jaccard_to_distance:349) and the
Rust twin ``src/core/src/ani_utils.rs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import exp, log, sqrt

from scipy.optimize import brentq
from scipy.stats import binom
from scipy.stats import norm as _norm

from .logging import notify

# ---------------------------------------------------------------------------
# mutation-model primitives
# ---------------------------------------------------------------------------


def r1_to_q(k, r1):
    "Probability q that a k-mer contains >=1 mutation at per-base rate r1."
    return float(1 - (1 - float(r1)) ** k)


def exp_n_mutated(L, k, r1):
    "Expected count of mutated k-mers among L."
    return L * r1_to_q(k, r1)


def var_n_mutated(L, k, r1, *, q=None):
    "Variance of the mutated-k-mer count (Blanca et al.)."
    if r1 == 0:
        return 0.0
    r1 = float(r1)
    if q is None:
        q = r1_to_q(k, r1)

    term_linear = L * (1 - q) * (q * (2 * k + (2 / r1) - 1) - 2 * k)
    term_pairs = k * (k - 1) * (1 - q) ** 2
    term_tail = (2 * (1 - q) / (r1**2)) * ((1 + (k - 1) * (1 - q)) * r1 - q)

    variance = term_linear + term_pairs + term_tail
    if variance < 0.0:
        raise ValueError("Error: varN <0.0!")
    return float(variance)


def exp_n_mutated_squared(L, k, p):
    "E[N_mut^2] = Var + E^2."
    return var_n_mutated(L, k, p) + exp_n_mutated(L, k, p) ** 2


def probit(p):
    return _norm.ppf(p)


def handle_seqlen_nkmers(ksize, *, sequence_len_bp=None, n_unique_kmers=None):
    "Resolve the k-mer count: given directly, or derived from sequence length."
    if n_unique_kmers is not None:
        return n_unique_kmers
    if sequence_len_bp is None:
        raise ValueError(
            "Error: distance estimation requires input of either 'sequence_len_bp' or 'n_unique_kmers'"
        )
    return sequence_len_bp - (ksize - 1)


# ---------------------------------------------------------------------------
# sketch-size accuracy + false-negative probability
# ---------------------------------------------------------------------------


def set_size_chernoff(set_size, scaled, *, relative_error=0.05):
    "Chernoff lower bound on P(|estimate - truth| <= rel_err) (deprecated)."
    return 1 - 2 * exp(-(relative_error**2) * set_size / (scaled * 3))


_SET_SIZE_PROB_CACHE: dict = {}


def set_size_exact_prob(set_size, scaled, *, relative_error=0.05):
    """Exact binomial probability that len(sketch)*scaled lands within
    relative_error of the true set size.

    Memoized: a pure function of (set_size, scaled, relative_error), and
    gather re-checks the same query's size accuracy every round — the
    binom.cdf pair costs ~1 ms each."""
    key = (set_size, scaled, relative_error)
    hit = _SET_SIZE_PROB_CACHE.get(key)
    if hit is not None:
        return hit
    p = 1 / scaled
    upper = set_size / scaled * (relative_error + 1)
    lower = -set_size / scaled * (relative_error - 1)
    prob = binom.cdf(upper, set_size, p) - binom.cdf(lower, set_size, p)
    # cdf subtraction excludes the lower endpoint; add it back when integral
    if lower == int(lower):
        prob += binom.pmf(lower, set_size, p)
    if len(_SET_SIZE_PROB_CACHE) >= 4096:
        _SET_SIZE_PROB_CACHE.clear()
    _SET_SIZE_PROB_CACHE[key] = prob
    return prob


def get_expected_log_probability(n_unique_kmers, ksize, mutation_rate, scaled_fraction):
    "(L - E[N_mut]) * ln(1 - 1/scaled); -inf when the sketch keeps everything."
    surviving = n_unique_kmers - exp_n_mutated(n_unique_kmers, ksize, mutation_rate)
    try:
        return surviving * log(1.0 - scaled_fraction)
    except ValueError:
        return float("-inf")


def get_exp_probability_nothing_common(
    mutation_rate, ksize, scaled, *, n_unique_kmers=None, sequence_len_bp=None
):
    "Probability that two related sketches share zero hashes by chance."
    n_unique_kmers = handle_seqlen_nkmers(
        ksize, sequence_len_bp=sequence_len_bp, n_unique_kmers=n_unique_kmers
    )
    if mutation_rate == 1.0:
        return 1.0
    if mutation_rate == 0.0:
        return 0.0
    log_prob = get_expected_log_probability(
        n_unique_kmers, ksize, mutation_rate, 1.0 / float(scaled)
    )
    return exp(log_prob)


# ---------------------------------------------------------------------------
# result containers
# ---------------------------------------------------------------------------


def check_distance(dist):
    if not 0 <= dist <= 1:
        raise ValueError(f"Error: distance value {dist :.4f} is not between 0 and 1!")
    return dist


def check_prob_threshold(val, threshold=1e-3):
    "Pass through val; second return flags val > threshold."
    return val, bool(threshold is not None and val > threshold)


def check_jaccard_error(val, threshold=1e-4):
    return val, bool(threshold is not None and val > threshold)


@dataclass
class ANIResult:
    "Distance/ANI point estimate plus the nothing-in-common sanity flag."

    dist: float
    p_nothing_in_common: float
    p_threshold: float = 1e-3
    size_is_inaccurate: bool = False
    p_exceeds_threshold: bool = field(init=False)

    def check_dist_and_p_threshold(self):
        self.dist = check_distance(self.dist)
        p, exceeded = check_prob_threshold(self.p_nothing_in_common,
                                           self.p_threshold)
        self.p_nothing_in_common, self.p_exceeds_threshold = p, exceeded

    def __post_init__(self):
        self.check_dist_and_p_threshold()

    @property
    def ani(self):
        return None if self.size_is_inaccurate else 1 - self.dist


@dataclass
class jaccardANIResult(ANIResult):
    "ANI from jaccard; untrusted when the jaccard approximation error is big."

    jaccard_error: float = None
    je_threshold: float = 1e-4

    def __post_init__(self):
        self.check_dist_and_p_threshold()
        if self.jaccard_error is None:
            raise ValueError("Error: jaccard_error cannot be None.")
        je, exceeded = check_jaccard_error(self.jaccard_error, self.je_threshold)
        self.jaccard_error, self.je_exceeds_threshold = je, exceeded

    @property
    def ani(self):
        untrusted = self.je_exceeds_threshold or self.size_is_inaccurate
        return None if untrusted else 1 - self.dist


@dataclass
class ciANIResult(ANIResult):
    "ANI from containment with a confidence interval (note: low/high swap)."

    dist_low: float = None
    dist_high: float = None

    def __post_init__(self):
        self.check_dist_and_p_threshold()
        if self.dist_low is not None and self.dist_high is not None:
            self.dist_low = check_distance(self.dist_low)
            self.dist_high = check_distance(self.dist_high)

    def _inverted_bound(self, bound):
        "ANI bound from the opposite distance bound (dist high => ani low)."
        if bound is None or self.size_is_inaccurate:
            return None
        return 1 - bound

    @property
    def ani_low(self):
        return self._inverted_bound(self.dist_high)

    @property
    def ani_high(self):
        return self._inverted_bound(self.dist_low)


# ---------------------------------------------------------------------------
# the two public converters
# ---------------------------------------------------------------------------


def _containment_ci(containment, ksize, scaled, n_kmers, confidence):
    """Solve for the distance CI around an observed containment.

    Finds mutation rates where the expected containment, shifted by
    z * sqrt(Var[containment estimate]), equals the observation.  Returns
    (dist_high_solution, dist_low_solution) or (None, None) on failure.
    """
    z = probit(1 - (1 - confidence) / 2)
    f_scaled = 1.0 / scaled
    bias_factor = 1 - (1 - f_scaled) ** n_kmers
    lead = (1.0 - f_scaled) / (f_scaled * n_kmers**3 * bias_factor**2)

    def est_var(rate):
        cross = n_kmers * exp_n_mutated(n_kmers, ksize, rate) - exp_n_mutated_squared(
            n_kmers, ksize, rate
        )
        direct = var_n_mutated(n_kmers, ksize, rate) / n_kmers**2
        return lead * cross + direct

    def above(rate):
        return (1 - rate) ** ksize + z * sqrt(est_var(rate)) - containment

    def below(rate):
        return (1 - rate) ** ksize - z * sqrt(est_var(rate)) - containment

    try:
        hi_sol = brentq(above, 0.0000001, 0.9999999)
        lo_sol = brentq(below, 0.0000001, 0.9999999)
    except ValueError as exc:
        notify(
            "WARNING: Cannot estimate ANI confidence intervals from containment. Do your sketches contain enough hashes?"
        )
        notify(str(exc))
        return None, None
    return hi_sol, lo_sol


def containment_to_distance(containment, ksize, scaled, *, n_unique_kmers=None,
                            sequence_len_bp=None, confidence=0.95,
                            estimate_ci=False, prob_threshold=1e-3):
    "Observed containment → ciANIResult (point estimate, optional CI)."
    n_unique_kmers = handle_seqlen_nkmers(
        ksize, sequence_len_bp=sequence_len_bp, n_unique_kmers=n_unique_kmers
    )

    hi_sol = lo_sol = None
    if containment == 0:
        dist = hi_sol = lo_sol = 1.0
    elif containment == 1:
        dist = hi_sol = lo_sol = 0.0
    else:
        dist = 1.0 - containment ** (1.0 / ksize)
        if estimate_ci:
            hi_sol, lo_sol = _containment_ci(
                containment, ksize, scaled, n_unique_kmers, confidence
            )

    p_none = get_exp_probability_nothing_common(
        dist, ksize, scaled, n_unique_kmers=n_unique_kmers
    )
    return ciANIResult(
        dist, p_none, dist_low=lo_sol, dist_high=hi_sol, p_threshold=prob_threshold
    )


def jaccard_to_distance(jaccard, ksize, scaled, *, n_unique_kmers=None,
                        sequence_len_bp=None, prob_threshold=1e-3,
                        err_threshold=1e-4):
    "Observed jaccard → jaccardANIResult, with approximation-error bound."
    n_unique_kmers = handle_seqlen_nkmers(
        ksize, sequence_len_bp=sequence_len_bp, n_unique_kmers=n_unique_kmers
    )

    if jaccard == 0:
        dist, err_bound = 1.0, 0.0
    elif jaccard == 1:
        dist, err_bound = 0.0, 0.0
    else:
        # invert E[jaccard] = (2j/(1+j))^(1/k), then bound the bias of the
        # jaccard plug-in estimator by N*Var / (N + E[N_mut])^3
        dist = 1.0 - (2.0 * jaccard / float(1 + jaccard)) ** (1.0 / float(ksize))
        e_mut = exp_n_mutated(n_unique_kmers, ksize, dist)
        v_mut = var_n_mutated(n_unique_kmers, ksize, dist)
        err_bound = 1.0 * n_unique_kmers * v_mut / (n_unique_kmers + e_mut) ** 3

    p_none = get_exp_probability_nothing_common(
        dist, ksize, scaled, n_unique_kmers=n_unique_kmers
    )
    return jaccardANIResult(
        dist,
        p_none,
        jaccard_error=err_bound,
        p_threshold=prob_threshold,
        je_threshold=err_threshold,
    )
