"""Key mappings: value <-> geometric bucket index (paper §2.1, §2.2).

A mapping is alpha-accurate iff every bucket (lo, hi] satisfies hi/lo <= gamma
with gamma = (1+alpha)/(1-alpha); the estimate returned for a bucket is the
relative-error midpoint 2*lo*hi/(lo+hi), whose worst-case relative error is
(hi-lo)/(hi+lo) <= alpha  (Lemma 2 generalized to arbitrary bucket bounds).

Three mappings are provided, mirroring the paper's implementations (§2.2):

* ``LogarithmicMapping`` — the memory-optimal mapping of Algorithm 1:
  ``key = ceil(log_gamma(x))``.
* ``LinearInterpolatedMapping`` — the "DDSketch (fast)" mapping: log2 is read
  off the float's exponent bits and the mantissa is interpolated linearly.
  Costs ``1/ln(2) ~ 1.44x`` more buckets for the same guarantee.
* ``CubicInterpolatedMapping`` — cubic mantissa interpolation; ~1% more
  buckets than optimal while still avoiding a true logarithm.

These are the *host* (math/numpy scalar) implementations;
``repro_torch.kernels.ref`` holds the vectorized torch twins, and the
``tests/test_torch_*.py`` files cross-check them against the JAX package.
"""

from __future__ import annotations

import math

__all__ = [
    "KeyMapping",
    "LogarithmicMapping",
    "LinearInterpolatedMapping",
    "CubicInterpolatedMapping",
    "make_mapping",
]


def _float_exponent_mantissa(x: float) -> tuple[int, float]:
    """(e, f) such that x = (1 + f) * 2**e with f in [0, 1).

    Uses frexp (exact bit extraction) — the host-side analogue of the
    bit-twiddling the TPU kernel performs with a bitcast.
    """
    m, e = math.frexp(x)  # x = m * 2**e, m in [0.5, 1)
    return e - 1, 2.0 * m - 1.0


class KeyMapping:
    """Base class; subclasses define ``_log(x)`` and its inverse ``_exp(u)``.

    ``_log`` must be a monotone approximation of ``log_2`` such that the
    induced buckets satisfy the gamma-ratio requirement given the subclass's
    ``_multiplier`` choice.
    """

    def __init__(self, relative_accuracy: float):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError(f"relative_accuracy must be in (0,1), got {relative_accuracy}")
        self.relative_accuracy = float(relative_accuracy)
        self.gamma = (1.0 + relative_accuracy) / (1.0 - relative_accuracy)
        # Subclasses scale this so that every bucket's hi/lo ratio <= gamma.
        self._multiplier = 1.0 / math.log2(self.gamma)
        # Values below min_indexable underflow double precision keys.
        self.min_indexable = 1e-270
        self.max_indexable = 1e270

    # -- to be overridden -------------------------------------------------
    def _log(self, x: float) -> float:  # approximate log2
        raise NotImplementedError

    def _exp(self, u: float) -> float:  # exact inverse of _log
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    def key(self, x: float) -> int:
        """Bucket index for value x > 0 (Algorithm 1: ceil(log_gamma x))."""
        return math.ceil(self._log(x) * self._multiplier)

    def lower_bound(self, key: int) -> float:
        """Infimum of bucket ``key`` (== upper bound of bucket key-1)."""
        return self._exp((key - 1) / self._multiplier)

    def upper_bound(self, key: int) -> float:
        return self._exp(key / self._multiplier)

    def value(self, key: int) -> float:
        """Relative-error midpoint 2*lo*hi/(lo+hi) (Lemma 2's estimate).

        Computed in harmonic form 2/(1/lo + 1/hi): the naive product lo*hi
        overflows float64 for values above ~1e154 while the reciprocals stay
        in range across the whole indexable span.
        """
        lo = self.lower_bound(key)
        hi = self.upper_bound(key)
        return 2.0 / (1.0 / lo + 1.0 / hi)

    def min_key(self) -> int:
        return self.key(self.min_indexable)

    def max_key(self) -> int:
        return self.key(self.max_indexable)

    # -- uniform-collapse (level-L) bucket values --------------------------
    def upper_bound_safe(self, key: int) -> float:
        """``upper_bound`` with float overflow mapped to +inf (level keys
        scale as 2**L * key, which escapes float64 at high levels)."""
        try:
            return self.upper_bound(key)
        except OverflowError:
            return math.inf

    def value_at_level(self, key: int, level: int) -> float:
        """Relative-error midpoint estimate of level-``level`` bucket ``key``.

        The level-L bucket k is the union of base buckets with keys in
        (2**L*(k-1), 2**L*k]; its bounds are base upper bounds and the
        estimate their harmonic midpoint 2/(1/lo + 1/hi) (Lemma 2
        generalized to arbitrary bucket bounds; worst-case relative error
        alpha_L = (g-1)/(g+1) with g = gamma**(2**L)).  This is the single
        source of truth for both tiers — the host quantile path and the
        device bucket-value tables must stay bit-identical for lossless
        host<->device round-trips.
        """
        if level == 0:
            return self.value(key)
        s = 1 << level
        lo = self.upper_bound_safe(s * (key - 1))
        hi = self.upper_bound_safe(s * key)
        inv = (1.0 / lo if lo > 0.0 else math.inf) + (
            1.0 / hi if hi > 0.0 else math.inf
        )
        return 2.0 / inv if inv > 0.0 else math.inf

    def __eq__(self, other) -> bool:
        return (
            type(self) is type(other)
            and self.relative_accuracy == other.relative_accuracy
        )

    def __repr__(self) -> str:
        return f"{type(self).__name__}(alpha={self.relative_accuracy})"

    def to_dict(self) -> dict:
        return {"kind": _KIND_OF[type(self)], "relative_accuracy": self.relative_accuracy}


class LogarithmicMapping(KeyMapping):
    """Memory-optimal mapping: key = ceil(log_gamma(x))  (paper Algorithm 1)."""

    def _log(self, x: float) -> float:
        return math.log2(x)

    def _exp(self, u: float) -> float:
        return 2.0 ** u


class LinearInterpolatedMapping(KeyMapping):
    """'DDSketch (fast)': exponent bits + linear mantissa interpolation.

    approx_log2(x) = e + f for x = (1+f)*2^e.  Since
    d(log2)/d(approx) = log2(e)/(1+f) <= log2(e), using
    multiplier = log2(e)/log2(gamma) = 1/ln(gamma) keeps every bucket's
    ratio <= gamma at the cost of 1/ln(2) ~ 1.44x more buckets.
    """

    def __init__(self, relative_accuracy: float):
        super().__init__(relative_accuracy)
        self._multiplier = 1.0 / math.log(self.gamma)

    def _log(self, x: float) -> float:
        e, f = _float_exponent_mantissa(x)
        return e + f

    def _exp(self, u: float) -> float:
        e = math.floor(u)
        f = u - e
        return (1.0 + f) * 2.0 ** e


# Cubic coefficients from the reference implementations (sketches-java):
# log2(1+f) ~ A f^3 + B f^2 + C f on [0,1); continuous at octave borders
# since A + B + C = 1.
_CUBIC_A = 6.0 / 35.0
_CUBIC_B = -3.0 / 5.0
_CUBIC_C = 10.0 / 7.0


def _cubic_correction() -> float:
    """max_f log2(e) / ((1+f) * d(approx)/df): bucket-count overhead factor."""
    best = 0.0
    for i in range(20001):
        f = i / 20000.0
        slope = 3 * _CUBIC_A * f * f + 2 * _CUBIC_B * f + _CUBIC_C
        best = max(best, math.log2(math.e) / ((1.0 + f) * slope))
    return best


_CUBIC_CORR = _cubic_correction()  # ~1.01


class CubicInterpolatedMapping(KeyMapping):
    """Cubic mantissa interpolation: ~1% bucket overhead, no true log."""

    def __init__(self, relative_accuracy: float):
        super().__init__(relative_accuracy)
        self._multiplier = _CUBIC_CORR / math.log2(self.gamma)

    def _log(self, x: float) -> float:
        e, f = _float_exponent_mantissa(x)
        return e + ((_CUBIC_A * f + _CUBIC_B) * f + _CUBIC_C) * f

    def _exp(self, u: float) -> float:
        e = math.floor(u)
        g = u - e  # solve Af^3 + Bf^2 + Cf = g for f in [0,1)
        # Newton from a linear initial guess; the cubic is monotone on [0,1).
        f = g / _CUBIC_C
        for _ in range(40):
            val = ((_CUBIC_A * f + _CUBIC_B) * f + _CUBIC_C) * f - g
            slope = (3 * _CUBIC_A * f + 2 * _CUBIC_B) * f + _CUBIC_C
            step = val / slope
            f -= step
            if abs(step) < 1e-15:
                break
        f = min(max(f, 0.0), 1.0)
        return (1.0 + f) * 2.0 ** e


_KIND_OF = {
    LogarithmicMapping: "log",
    LinearInterpolatedMapping: "linear",
    CubicInterpolatedMapping: "cubic",
}
_KIND_TO_CLS = {v: k for k, v in _KIND_OF.items()}


def make_mapping(kind: str, relative_accuracy: float) -> KeyMapping:
    try:
        return _KIND_TO_CLS[kind](relative_accuracy)
    except KeyError:
        raise ValueError(f"unknown mapping kind {kind!r}; options: {sorted(_KIND_TO_CLS)}")
