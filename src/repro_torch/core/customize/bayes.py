"""Bayesian Ridge Regression (evidence maximization), self-contained (a
copy of ``repro.core.customize.bayes``).

The paper pre-trains Bayesian ridge predictors on sampled synthesized
configurations to estimate per-stage DSPs, LUTs and WNS orders of
magnitude faster than vendor tools (§VI).  No sklearn offline, so this
is the standard Tipping/Bishop iterative evidence approximation.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BayesianRidge:
    max_iter: int = 300
    tol: float = 1e-4
    alpha: float = 1.0  # weight precision
    beta: float = 1.0  # noise precision
    mean_: np.ndarray | None = None
    cov_: np.ndarray | None = None
    x_mu_: np.ndarray | None = None
    x_sd_: np.ndarray | None = None
    y_mu_: float = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "BayesianRidge":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        self.x_mu_ = X.mean(0)
        self.x_sd_ = X.std(0) + 1e-9
        self.y_mu_ = float(y.mean())
        Xs = (X - self.x_mu_) / self.x_sd_
        ys = y - self.y_mu_
        n, d = Xs.shape
        xtx = Xs.T @ Xs
        xty = Xs.T @ ys
        alpha, beta = self.alpha, max(1.0 / (ys.var() + 1e-9), 1e-6)
        for _ in range(self.max_iter):
            S = np.linalg.inv(alpha * np.eye(d) + beta * xtx)
            m = beta * S @ xty
            gamma = np.clip(d - alpha * np.trace(S), 1e-9, d)
            new_alpha = float(np.clip(gamma / max(m @ m, 1e-12), 1e-9, 1e9))
            resid = ys - Xs @ m
            new_beta = float(np.clip(max(n - gamma, 1e-9) / max(resid @ resid, 1e-12), 1e-12, 1e12))
            if abs(new_alpha - alpha) < self.tol * alpha and abs(new_beta - beta) < self.tol * beta:
                alpha, beta = new_alpha, new_beta
                break
            alpha, beta = new_alpha, new_beta
        self.alpha, self.beta = float(alpha), float(beta)
        self.cov_ = np.linalg.inv(alpha * np.eye(d) + beta * xtx)
        self.mean_ = beta * self.cov_ @ xty
        return self

    def predict(self, X: np.ndarray, return_std: bool = False):
        Xs = (np.asarray(X, np.float64) - self.x_mu_) / self.x_sd_
        mean = Xs @ self.mean_ + self.y_mu_
        if not return_std:
            return mean
        var = 1.0 / self.beta + np.einsum("nd,de,ne->n", Xs, self.cov_, Xs)
        return mean, np.sqrt(var)

    def r2(self, X: np.ndarray, y: np.ndarray) -> float:
        pred = self.predict(X)
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - np.mean(y)) ** 2)) + 1e-12
        return 1.0 - ss_res / ss_tot
