"""Log-space statistical helpers for spectrum modelling.

A copy of zotpu/stats.py; tests hold the two equal.

Reference analog: zotmer/library/stats.py (SURVEY.md section 2a "stats"):
log-gamma/factorial/choose, log-space addition, Poisson and Gamma pdfs/cdfs,
and a Kolmogorov-Smirnov distance -- the machinery zotmer's histogram/model
commands use to fit k-mer frequency spectra (error peak vs genomic coverage
peaks).

Implemented with numpy in float64 on host (these run over histogram-sized
arrays, ~1e3 entries, so device offload would be pure overhead; the heavy
count aggregation they consume IS device-side, kernels/hist.py).
"""

from __future__ import annotations

import numpy as np

_LANCZOS_G = 7
_LANCZOS_COEF = np.array([
    0.99999999999980993, 676.5203681218851, -1259.1392167224028,
    771.32342877765313, -176.61502916214059, 12.507343278686905,
    -0.13857109526572012, 9.9843695780195716e-6, 1.5056327351493116e-7,
])


def log_gamma(x):
    """log Gamma(x) for x > 0 (Lanczos approximation, vectorized)."""
    x = np.asarray(x, dtype=np.float64)
    small = x < 0.5
    # reflection for x < 0.5: Gamma(x) Gamma(1-x) = pi / sin(pi x)
    xr = np.where(small, 1.0 - x, x) - 1.0
    a = np.full_like(xr, _LANCZOS_COEF[0])
    for i in range(1, _LANCZOS_G + 2):
        a = a + _LANCZOS_COEF[i] / (xr + i)
    t = xr + _LANCZOS_G + 0.5
    y = 0.5 * np.log(2 * np.pi) + (xr + 0.5) * np.log(t) - t + np.log(a)
    with np.errstate(divide="ignore", invalid="ignore"):
        refl = np.log(np.pi / np.abs(np.sin(np.pi * x))) - y
    return np.where(small, refl, y)


def log_fac(n):
    """log n!"""
    return log_gamma(np.asarray(n, np.float64) + 1.0)


def log_choose(n, k):
    """log C(n, k)."""
    return log_fac(n) - log_fac(k) - log_fac(np.asarray(n, np.float64) - k)


def log_add(a, b):
    """log(exp(a) + exp(b)), overflow-safe, -inf neutral."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    hi = np.maximum(a, b)
    lo = np.minimum(a, b)
    with np.errstate(invalid="ignore"):
        out = hi + np.log1p(np.exp(lo - hi))
    return np.where(np.isneginf(hi), hi, out)


def log_sum(xs):
    """log-space sum over the last axis."""
    xs = np.asarray(xs, np.float64)
    hi = np.max(xs, axis=-1, keepdims=True)
    out = hi[..., 0] + np.log(np.sum(np.exp(xs - hi), axis=-1))
    return np.where(np.isneginf(hi[..., 0]), hi[..., 0], out)


def log_poisson_pdf(lam, k):
    """log P[X = k], X ~ Poisson(lam)."""
    k = np.asarray(k, np.float64)
    return k * np.log(lam) - lam - log_fac(k)


def poisson_pdf(lam, k):
    return np.exp(log_poisson_pdf(lam, k))


def poisson_cdf(lam, k):
    """P[X <= k] by direct log-space summation (k small in spectra)."""
    k = int(k)
    terms = log_poisson_pdf(lam, np.arange(k + 1, dtype=np.float64))
    return float(np.exp(log_sum(terms)))


def log_gamma_pdf(shape_a, rate_b, x):
    """log pdf of Gamma(a, rate b) at x."""
    a = np.asarray(shape_a, np.float64)
    b = np.asarray(rate_b, np.float64)
    x = np.asarray(x, np.float64)
    return a * np.log(b) - log_gamma(a) + (a - 1.0) * np.log(x) - b * x


def ks_distance(cdf_a, cdf_b):
    """Kolmogorov-Smirnov distance between two discrete CDF arrays."""
    return float(np.max(np.abs(np.asarray(cdf_a, np.float64)
                               - np.asarray(cdf_b, np.float64))))


def spectrum_mixture_fit_detail(hist, max_cov=100, iters=200, tol=1e-8):
    """EM fit of a k-mer frequency spectrum as a three-component mixture.

    Reference analog: zotmer's stats-model consumers fit spectra to separate
    the sequencing-error peak from genomic coverage peaks (SURVEY.md
    section 3.4). Model, over observed frequencies f >= 1:

      error   ~ zero-truncated Poisson(lam_e)      (lam_e small)
      genomic ~ zero-truncated Poisson(lam_g)      (single-copy coverage)
      repeat  ~ zero-truncated Poisson(2 * lam_g)  (two-copy, rate TIED)

    Zero truncation matters because a spectrum never observes f = 0; for the
    error component (lam_e ~ 1) the correction is large. The tied-rate M
    step for {Poisson(lam), Poisson(2 lam)} is lam = (S_g + S_r) /
    (N_g + 2 N_r) with S/N the responsibility-weighted sums, then a
    fixed-point truncation correction lam <- mean * (1 - exp(-lam)).

    Returns a dict: lam_e, lam_g, weights (w_e, w_g, w_r), cutoff (the
    OPERATIVE error cutoff -- the reference error-peak-valley heuristic,
    kept as the byte-affecting policy), em_cutoff (diagnostic: smallest f
    whose genomic+repeat posterior dominates the error posterior),
    genome_size_estimate (genomic k-mer mass / lam_g), ks (Kolmogorov-
    Smirnov distance between the fitted and empirical spectra over the
    fitted range -- the goodness-of-fit diagnostic).
    """
    h = np.asarray(hist, np.float64)
    from zotpu_torch.reference_impl.golden import error_peak_cutoff
    cut0 = error_peak_cutoff(h.astype(np.int64))
    F = min(len(h), max(int(max_cov), cut0 + 2))
    f = np.arange(1, F, dtype=np.float64)
    w_f = h[1:F]
    total = w_f.sum()
    if total <= 0 or len(h) <= cut0 + 1:
        return {"lam_e": 0.0, "lam_g": 0.0, "weights": (0.0, 0.0, 0.0),
                "cutoff": cut0, "em_cutoff": cut0,
                "genome_size_estimate": 0, "ks": 0.0}

    lam_e = 1.0
    lam_g = float(np.argmax(h[cut0:F]) + cut0)
    lam_g = max(lam_g, cut0 + 1.0)
    w = np.array([w_f[: max(cut0 - 1, 1)].sum(), 0.0, 0.0])
    w[1] = max(total - w[0], 1.0) * 0.9
    w[2] = max(total - w[0], 1.0) * 0.1
    w = np.maximum(w / w.sum(), 1e-9)

    def _trunc_log_pdf(lam, f):
        # log P[X = f | X >= 1], X ~ Poisson(lam)
        return log_poisson_pdf(lam, f) - np.log1p(-np.exp(-lam))

    prev = -np.inf
    for _ in range(iters):
        lp = np.stack([
            np.log(w[0]) + _trunc_log_pdf(lam_e, f),
            np.log(w[1]) + _trunc_log_pdf(lam_g, f),
            np.log(w[2]) + _trunc_log_pdf(2.0 * lam_g, f),
        ])
        norm = log_sum(lp.T)
        ll = float(np.sum(w_f * norm))
        r = np.exp(lp - norm)                      # responsibilities (3, F-1)
        N = (r * w_f).sum(axis=1)
        S = (r * w_f * f).sum(axis=1)
        w = np.maximum(N / total, 1e-12)
        # truncated-Poisson rate updates (fixed point on the truncation)
        mean_e = S[0] / max(N[0], 1e-12)
        for _ in range(5):
            lam_e = max(mean_e * -np.expm1(-lam_e), 1e-6)
        lam_raw = (S[1] + S[2]) / max(N[1] + 2.0 * N[2], 1e-12)
        for _ in range(5):
            lam_g = max(lam_raw * -np.expm1(-lam_g), cut0 * 0.5 + 0.5)
        if abs(ll - prev) < tol * (abs(prev) + 1.0):
            break
        prev = ll

    # The OPERATIVE cutoff stays the reference heuristic (error-peak valley,
    # reference_impl/golden.py): it is a byte-affecting policy (filter
    # --auto thresholds on it). The EM posterior crossover is reported as a
    # diagnostic alongside.
    post_err = r[0]
    post_gen = r[1] + r[2]
    genomic_f = np.nonzero(post_gen >= post_err)[0]
    em_cutoff = int(genomic_f[0] + 1) if len(genomic_f) else cut0
    mass = h[cut0:] * np.arange(cut0, len(h))
    genome_size = int(mass.sum() / max(lam_g, 1.0))
    fitted = np.exp(log_sum(np.stack([
        np.log(w[0]) + _trunc_log_pdf(lam_e, f),
        np.log(w[1]) + _trunc_log_pdf(lam_g, f),
        np.log(w[2]) + _trunc_log_pdf(2.0 * lam_g, f)]).T))
    ks = ks_distance(np.cumsum(fitted) / fitted.sum(),
                     np.cumsum(w_f) / total)
    return {"lam_e": float(lam_e), "lam_g": float(lam_g),
            "weights": tuple(float(x) for x in w), "cutoff": cut0,
            "em_cutoff": em_cutoff,
            "genome_size_estimate": genome_size, "ks": float(ks)}


def spectrum_mixture_fit(hist, max_cov=100):
    """(cutoff, lam_g, genome_size_estimate) from the EM mixture fit --
    the BASELINE config-4 statistic (see spectrum_mixture_fit_detail)."""
    d = spectrum_mixture_fit_detail(hist, max_cov=max_cov)
    return d["cutoff"], d["lam_g"], d["genome_size_estimate"]
