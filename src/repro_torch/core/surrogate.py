"""Gaussian-process surrogate for MOBO (paper §V-B: "we use a Gaussian
Process as the surrogate model").

Pure-numpy GP regression with an RBF kernel.  Lengthscale/noise are selected
by maximizing the log marginal likelihood over a small deterministic grid —
cheap, robust, and good enough for the ≤ a-few-hundred observations a DSE run
produces.  One independent GP per objective (standard MOBO practice).
"""
from __future__ import annotations

import numpy as np


def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / (ls * ls))


class GP:
    """GP regression on inputs normalized to [0,1]^d, standardized targets."""

    def __init__(self, lengthscales=(0.1, 0.2, 0.5, 1.0),
                 noises=(1e-6, 1e-4, 1e-2)):
        self._ls_grid = lengthscales
        self._noise_grid = noises
        self._fitted = False

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GP":
        fitted = fit_gps(X, np.asarray(y, dtype=float).ravel()[:, None],
                         self._ls_grid, self._noise_grid)[0]
        self.X = fitted.X
        self.y_mean = fitted.y_mean
        self.y_std = fitted.y_std
        self.ls = fitted.ls
        self.L = fitted.L
        self.alpha = fitted.alpha
        self._fitted = True
        return self

    def predict(self, Xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and variance at ``Xs`` (de-standardized)."""
        assert self._fitted
        Xs = np.asarray(Xs, dtype=float)
        Ks = _rbf(self.X, Xs, self.ls)             # (n, m)
        mean = Ks.T @ self.alpha
        v = np.linalg.solve(self.L, Ks)            # (n, m)
        var = np.clip(1.0 - (v * v).sum(axis=0), 1e-12, None)
        return (mean * self.y_std + self.y_mean, var * self.y_std ** 2)

    def sample(self, Xs: np.ndarray, n_draws: int,
               rng: np.random.Generator) -> np.ndarray:
        """Independent-marginal posterior draws, shape (n_draws, m)."""
        mean, var = self.predict(Xs)
        return mean[None, :] + np.sqrt(var)[None, :] * rng.standard_normal(
            (n_draws, len(mean)))


def fit_gps(X: np.ndarray, Y: np.ndarray,
            lengthscales=(0.1, 0.2, 0.5, 1.0),
            noises=(1e-6, 1e-4, 1e-2)) -> list[GP]:
    """Fit one GP per objective column of ``Y`` (n, n_obj) sharing the
    kernel work across objectives.

    All objectives observe the same inputs, so the RBF Gram matrix and its
    Cholesky factor per (lengthscale, noise) grid point are computed once and
    reused for every objective's marginal-likelihood evaluation — fitting a
    3-objective surrogate costs one grid sweep instead of three.  Each
    objective still selects its own hyperparameters.  This is the single
    grid-search implementation: ``GP.fit`` delegates here with one column.
    """
    X = np.asarray(X, dtype=float)
    Y = np.asarray(Y, dtype=float)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, n_obj = len(X), Y.shape[1]

    yn = np.empty_like(Y)
    gps = [GP(lengthscales, noises) for _ in range(n_obj)]
    for j, gp in enumerate(gps):
        gp.X = X
        gp.y_mean = float(Y[:, j].mean())
        gp.y_std = float(Y[:, j].std()) or 1.0
        yn[:, j] = (Y[:, j] - gp.y_mean) / gp.y_std

    best = [(-np.inf, None, None, None)] * n_obj
    for ls in lengthscales:
        K0 = _rbf(X, X, ls)
        for noise in noises:
            K = K0 + noise * np.eye(n)
            try:
                L = np.linalg.cholesky(K)
            except np.linalg.LinAlgError:
                continue
            alphas = np.linalg.solve(L.T, np.linalg.solve(L, yn))  # (n, n_obj)
            logdet = np.log(np.diag(L)).sum()
            for j in range(n_obj):
                lml = (-0.5 * yn[:, j] @ alphas[:, j] - logdet
                       - 0.5 * n * np.log(2 * np.pi))
                if lml > best[j][0]:
                    best[j] = (lml, ls, L, alphas[:, j])
    fallback = None
    for j, gp in enumerate(gps):
        if best[j][1] is None:  # pathological; fall back to heavy noise
            if fallback is None:
                K = _rbf(X, X, 1.0) + 1e-1 * np.eye(n)
                fallback = np.linalg.cholesky(K)
            L = fallback
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn[:, j]))
            best[j] = (0.0, 1.0, L, alpha)
        _, gp.ls, gp.L, gp.alpha = best[j]
        gp._fitted = True
    return gps
