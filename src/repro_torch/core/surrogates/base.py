"""Surrogate-model base classes and metrics.

All models implement fit(X, y) -> self and predict(X) -> y_hat on float64
numpy arrays, are deterministic under their ``seed``, and standardize
inputs internally (the library's feature scales span ~6 decades).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["Standardizer", "Model", "pcc", "r2", "mae", "rmse"]


@dataclass
class Standardizer:
    mu: Optional[np.ndarray] = None
    sd: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray) -> "Standardizer":
        self.mu = X.mean(axis=0)
        self.sd = X.std(axis=0)
        self.sd = np.where(self.sd > 0, self.sd, 1.0)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mu) / self.sd


class Model:
    """Base: handles x/y standardization around a core _fit/_predict."""

    standardize_x = True
    standardize_y = True

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._xs = Standardizer()
        self._ymu = 0.0
        self._ysd = 1.0

    def fit(self, X, y) -> "Model":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64).ravel()
        if self.standardize_x:
            X = self._xs.fit(X).transform(X)
        if self.standardize_y:
            self._ymu = float(y.mean())
            self._ysd = float(y.std()) or 1.0
            y = (y - self._ymu) / self._ysd
        self._fit(X, y)
        return self

    def predict(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if self.standardize_x:
            X = self._xs.transform(X)
        y = self._predict(X)
        if self.standardize_y:
            y = y * self._ysd + self._ymu
        return y

    # subclasses implement:
    def _fit(self, X: np.ndarray, y: np.ndarray) -> None:
        raise NotImplementedError

    def _predict(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError


def pcc(y_true, y_pred) -> float:
    """Pearson correlation coefficient — the paper's model-quality metric."""
    a = np.asarray(y_true, dtype=np.float64).ravel()
    b = np.asarray(y_pred, dtype=np.float64).ravel()
    sa, sb = a.std(), b.std()
    if sa == 0 or sb == 0:
        return 0.0
    return float(((a - a.mean()) * (b - b.mean())).mean() / (sa * sb))


def r2(y_true, y_pred) -> float:
    a = np.asarray(y_true, dtype=np.float64).ravel()
    b = np.asarray(y_pred, dtype=np.float64).ravel()
    ss = ((a - a.mean()) ** 2).sum()
    if ss == 0:
        return 0.0
    return float(1.0 - ((a - b) ** 2).sum() / ss)


def mae(y_true, y_pred) -> float:
    return float(np.mean(np.abs(np.asarray(y_true) - np.asarray(y_pred))))


def rmse(y_true, y_pred) -> float:
    return float(np.sqrt(np.mean((np.asarray(y_true) - np.asarray(y_pred)) ** 2)))
