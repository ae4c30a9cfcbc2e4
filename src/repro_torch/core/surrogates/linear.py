"""Linear-family surrogates: OLS, Ridge, Lasso, ElasticNet, Bayesian Ridge
(evidence maximization), Huber, SGD, and degree-2 polynomial ridge.

Bayesian Ridge is one of the paper's two production models (best power
estimator, Fig. 6)."""

from __future__ import annotations

import numpy as np

from .base import Model

__all__ = [
    "OLS",
    "Ridge",
    "Lasso",
    "ElasticNet",
    "BayesianRidge",
    "Huber",
    "SGDRegressor",
    "Poly2Ridge",
]


def _add_bias(X: np.ndarray) -> np.ndarray:
    return np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)


class OLS(Model):
    def _fit(self, X, y):
        Xb = _add_bias(X)
        self.w, *_ = np.linalg.lstsq(Xb, y, rcond=None)

    def _predict(self, X):
        return _add_bias(X) @ self.w


class Ridge(Model):
    def __init__(self, alpha: float = 1.0, seed: int = 0):
        super().__init__(seed)
        self.alpha = alpha

    def _fit(self, X, y):
        Xb = _add_bias(X)
        d = Xb.shape[1]
        reg = self.alpha * np.eye(d)
        reg[-1, -1] = 0.0  # don't penalize the bias
        self.w = np.linalg.solve(Xb.T @ Xb + reg, Xb.T @ y)

    def _predict(self, X):
        return _add_bias(X) @ self.w


class Lasso(Model):
    """Coordinate descent on standardized features."""

    def __init__(self, alpha: float = 0.01, n_iter: int = 200, seed: int = 0):
        super().__init__(seed)
        self.alpha = alpha
        self.n_iter = n_iter

    def _fit(self, X, y):
        n, d = X.shape
        w = np.zeros(d)
        b = y.mean()
        col_sq = (X**2).sum(axis=0) + 1e-12
        r = y - b - X @ w
        lam = self.alpha * n
        for _ in range(self.n_iter):
            for j in range(d):
                r = r + X[:, j] * w[j]
                rho = X[:, j] @ r
                w[j] = np.sign(rho) * max(abs(rho) - lam, 0.0) / col_sq[j]
                r = r - X[:, j] * w[j]
            b_new = b + r.mean()
            r = r - (b_new - b)
            b = b_new
        self.w, self.b = w, b

    def _predict(self, X):
        return X @ self.w + self.b


class ElasticNet(Lasso):
    def __init__(self, alpha: float = 0.01, l1_ratio: float = 0.5, n_iter: int = 200, seed: int = 0):
        super().__init__(alpha, n_iter, seed)
        self.l1_ratio = l1_ratio

    def _fit(self, X, y):
        n, d = X.shape
        w = np.zeros(d)
        b = y.mean()
        lam1 = self.alpha * self.l1_ratio * n
        lam2 = self.alpha * (1 - self.l1_ratio) * n
        col_sq = (X**2).sum(axis=0) + lam2 + 1e-12
        r = y - b - X @ w
        for _ in range(self.n_iter):
            for j in range(d):
                r = r + X[:, j] * w[j]
                rho = X[:, j] @ r
                w[j] = np.sign(rho) * max(abs(rho) - lam1, 0.0) / col_sq[j]
                r = r - X[:, j] * w[j]
            b_new = b + r.mean()
            r = r - (b_new - b)
            b = b_new
        self.w, self.b = w, b


class BayesianRidge(Model):
    """Type-II maximum likelihood (evidence maximization) over the weight
    prior precision `alpha` and the noise precision `beta` — the classic
    MacKay iteration, matching sklearn's BayesianRidge behaviour."""

    def __init__(self, n_iter: int = 300, tol: float = 1e-4, seed: int = 0):
        super().__init__(seed)
        self.n_iter = n_iter
        self.tol = tol

    def _fit(self, X, y):
        n, d = X.shape
        alpha, beta = 1.0, 1.0 / (y.var() + 1e-9)
        XtX = X.T @ X
        Xty = X.T @ y
        eigs = np.linalg.eigvalsh(XtX)
        m = np.zeros(d)
        for _ in range(self.n_iter):
            A = alpha * np.eye(d) + beta * XtX
            m_new = beta * np.linalg.solve(A, Xty)
            lam = beta * eigs
            gamma = float((lam / (lam + alpha)).sum())
            alpha = gamma / float(m_new @ m_new + 1e-12)
            resid = y - X @ m_new
            beta = max(n - gamma, 1e-9) / float(resid @ resid + 1e-12)
            if np.max(np.abs(m_new - m)) < self.tol:
                m = m_new
                break
            m = m_new
        self.w = m
        self.alpha_, self.beta_ = alpha, beta
        self.Sigma = np.linalg.inv(alpha * np.eye(d) + beta * XtX)

    def _predict(self, X):
        return X @ self.w

    def predict_std(self, X) -> np.ndarray:
        """Posterior predictive std — available for acquisition heuristics."""
        X = self._xs.transform(np.asarray(X, dtype=np.float64))
        var = 1.0 / self.beta_ + np.einsum("nd,de,ne->n", X, self.Sigma, X)
        return np.sqrt(np.maximum(var, 0)) * self._ysd


class Huber(Model):
    """IRLS Huber regression (robust linear)."""

    def __init__(self, delta: float = 1.0, n_iter: int = 50, seed: int = 0):
        super().__init__(seed)
        self.delta = delta
        self.n_iter = n_iter

    def _fit(self, X, y):
        Xb = _add_bias(X)
        w = np.linalg.lstsq(Xb, y, rcond=None)[0]
        for _ in range(self.n_iter):
            r = y - Xb @ w
            a = np.abs(r)
            wt = np.where(a <= self.delta, 1.0, self.delta / np.maximum(a, 1e-12))
            W = Xb * wt[:, None]
            w = np.linalg.solve(W.T @ Xb + 1e-8 * np.eye(Xb.shape[1]), W.T @ y)
        self.w = w

    def _predict(self, X):
        return _add_bias(X) @ self.w


class SGDRegressor(Model):
    """Plain minibatch SGD on squared loss (the paper cites SGD as one of
    the weaker alternatives evaluated by [15])."""

    def __init__(self, lr: float = 0.01, epochs: int = 100, batch: int = 32, seed: int = 0):
        super().__init__(seed)
        self.lr, self.epochs, self.batch = lr, epochs, batch

    def _fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        n, d = X.shape
        w = np.zeros(d)
        b = 0.0
        for _ in range(self.epochs):
            order = rng.permutation(n)
            for s in range(0, n, self.batch):
                idx = order[s : s + self.batch]
                err = X[idx] @ w + b - y[idx]
                w -= self.lr * (X[idx].T @ err) / len(idx)
                b -= self.lr * err.mean()
        self.w, self.b = w, b

    def _predict(self, X):
        return X @ self.w + self.b


class Poly2Ridge(Ridge):
    """Ridge on degree-2 polynomial features (pairwise products)."""

    def _expand(self, X):
        n, d = X.shape
        cols = [X]
        for i in range(d):
            cols.append(X[:, i : i + 1] * X[:, i:])
        return np.concatenate(cols, axis=1)

    def _fit(self, X, y):
        super()._fit(self._expand(X), y)

    def _predict(self, X):
        return super()._predict(self._expand(X))
