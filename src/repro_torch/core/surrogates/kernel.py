"""Kernel / instance-based / neural surrogates: RBF kernel ridge, epsilon-SVR
(the paper's third Fig. 6 contender), kNN, and a small MLP (cited by [15]
as inferior to statistical regression — included for the ablation)."""

from __future__ import annotations

import numpy as np

from .base import Model

__all__ = ["KernelRidgeRBF", "SVR", "KNN", "MLP"]


def _rbf(A: np.ndarray, B: np.ndarray, gamma: float) -> np.ndarray:
    d2 = (
        (A**2).sum(axis=1)[:, None]
        + (B**2).sum(axis=1)[None, :]
        - 2.0 * A @ B.T
    )
    return np.exp(-gamma * np.maximum(d2, 0.0))


class KernelRidgeRBF(Model):
    def __init__(self, alpha: float = 0.1, gamma: float = 0.5, seed: int = 0):
        super().__init__(seed)
        self.alpha, self.gamma = alpha, gamma

    def _fit(self, X, y):
        self.Xtr = X
        K = _rbf(X, X, self.gamma)
        self.dual = np.linalg.solve(K + self.alpha * np.eye(len(X)), y)

    def _predict(self, X):
        return _rbf(X, self.Xtr, self.gamma) @ self.dual


class SVR(Model):
    """Epsilon-insensitive support vector regression, solved in the primal
    by subgradient descent over random Fourier features (RBF kernel
    approximation).  From-scratch stand-in for sklearn's SVR."""

    def __init__(
        self,
        C: float = 10.0,
        epsilon: float = 0.05,
        gamma: float = 0.05,
        n_features: int = 512,
        epochs: int = 1000,
        lr: float = 0.05,
        seed: int = 0,
    ):
        super().__init__(seed)
        self.C, self.epsilon, self.gamma = C, epsilon, gamma
        self.n_features, self.epochs, self.lr = n_features, epochs, lr

    def _phi(self, X):
        z = X @ self.W + self.b0
        return np.sqrt(2.0 / self.n_features) * np.cos(z)

    def _fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        d = X.shape[1]
        self.W = rng.normal(0.0, np.sqrt(2 * self.gamma), size=(d, self.n_features))
        self.b0 = rng.uniform(0, 2 * np.pi, size=self.n_features)
        P = self._phi(X)
        n = len(y)
        w = np.zeros(self.n_features)
        b = 0.0
        for ep in range(self.epochs):
            lr = self.lr / (1.0 + 0.01 * ep)
            pred = P @ w + b
            r = pred - y
            g = np.where(r > self.epsilon, 1.0, np.where(r < -self.epsilon, -1.0, 0.0))
            grad_w = w / (self.C * n) + P.T @ g / n
            w -= lr * grad_w
            b -= lr * g.mean()
        self.w, self.b = w, b

    def _predict(self, X):
        return self._phi(X) @ self.w + self.b


class KNN(Model):
    standardize_y = False

    def __init__(self, k: int = 5, weighted: bool = True, seed: int = 0):
        super().__init__(seed)
        self.k, self.weighted = k, weighted

    def _fit(self, X, y):
        self.Xtr, self.ytr = X, y

    def _predict(self, X):
        d2 = (
            (X**2).sum(axis=1)[:, None]
            + (self.Xtr**2).sum(axis=1)[None, :]
            - 2.0 * X @ self.Xtr.T
        )
        k = min(self.k, len(self.ytr))
        idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
        dd = np.take_along_axis(d2, idx, axis=1)
        yy = self.ytr[idx]
        if not self.weighted:
            return yy.mean(axis=1)
        w = 1.0 / (np.sqrt(np.maximum(dd, 0)) + 1e-9)
        return (yy * w).sum(axis=1) / w.sum(axis=1)


class MLP(Model):
    """Two-hidden-layer tanh MLP trained with Adam (full-batch)."""

    def __init__(self, hidden: int = 64, epochs: int = 500, lr: float = 1e-2, seed: int = 0):
        super().__init__(seed)
        self.hidden, self.epochs, self.lr = hidden, epochs, lr

    def _fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        d, h = X.shape[1], self.hidden
        p = {
            "W1": rng.normal(0, 1 / np.sqrt(d), (d, h)),
            "b1": np.zeros(h),
            "W2": rng.normal(0, 1 / np.sqrt(h), (h, h)),
            "b2": np.zeros(h),
            "W3": rng.normal(0, 1 / np.sqrt(h), (h, 1)),
            "b3": np.zeros(1),
        }
        m = {k: np.zeros_like(v) for k, v in p.items()}
        v = {k: np.zeros_like(val) for k, val in p.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        y = y[:, None]
        for t in range(1, self.epochs + 1):
            h1 = np.tanh(X @ p["W1"] + p["b1"])
            h2 = np.tanh(h1 @ p["W2"] + p["b2"])
            out = h2 @ p["W3"] + p["b3"]
            dout = 2.0 * (out - y) / len(y)
            g = {}
            g["W3"] = h2.T @ dout
            g["b3"] = dout.sum(axis=0)
            dh2 = (dout @ p["W3"].T) * (1 - h2**2)
            g["W2"] = h1.T @ dh2
            g["b2"] = dh2.sum(axis=0)
            dh1 = (dh2 @ p["W2"].T) * (1 - h1**2)
            g["W1"] = X.T @ dh1
            g["b1"] = dh1.sum(axis=0)
            for k in p:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v[k] = b2 * v[k] + (1 - b2) * g[k] ** 2
                mh = m[k] / (1 - b1**t)
                vh = v[k] / (1 - b2**t)
                p[k] -= self.lr * mh / (np.sqrt(vh) + eps)
        self.p = p

    def _predict(self, X):
        h1 = np.tanh(X @ self.p["W1"] + self.p["b1"])
        h2 = np.tanh(h1 @ self.p["W2"] + self.p["b2"])
        return (h2 @ self.p["W3"] + self.p["b3"]).ravel()
