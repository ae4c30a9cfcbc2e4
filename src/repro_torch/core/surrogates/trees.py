"""Tree-family surrogates: CART, Random Forest, Extra-Trees, Gradient
Boosting.  Random Forest is the paper's production QoR estimator (Fig. 6).

The CART core is a vectorized variance-reduction regression tree; at the
paper's scale (n~1000, d~10-60) exhaustive split search is cheap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .base import Model

__all__ = ["CART", "RandomForest", "ExtraTrees", "GradientBoosting"]


@dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    value: float = 0.0

    @property
    def is_leaf(self) -> bool:
        return self.feature < 0


def _best_split(X, y, feat_idx, min_leaf, base):
    """Exhaustive best (feature, threshold) by SSE reduction; ``base`` is
    the node's SSE, ``((y - y.mean()) ** 2).sum()``.

    All candidate features are scored at once, one column each; every
    column's sums run in the order a one-feature loop would add them, so
    the scores, and the split (the first feature of the largest gain),
    are that loop's to the bit."""
    n = len(y)
    feat_idx = np.asarray(feat_idx)
    cols = X[:, feat_idx]
    order = np.argsort(cols, axis=0, kind="stable")
    xs, ys = cols[order, np.arange(len(feat_idx))], y[order]
    csum = np.cumsum(ys, axis=0)
    csq = np.cumsum(ys**2, axis=0)
    tot, tot2 = csum[-1], csq[-1]
    k = np.arange(1, n)[:, None]
    # valid split positions: leaves >= min_leaf and distinct x
    valid = (k >= min_leaf) & (k <= n - min_leaf) & (xs[1:] != xs[:-1])
    lsum, lsq = csum[:-1], csq[:-1]
    rsum, rsq = tot - lsum, tot2 - lsq
    sse = (lsq - lsum**2 / k) + (rsq - rsum**2 / (n - k))
    sse = np.where(valid, sse, np.inf)
    kbest = np.argmin(sse, axis=0)
    smin = sse[kbest, np.arange(len(feat_idx))]
    gain = base - smin
    cand = np.isfinite(smin) & (gain > 0.0)
    if not cand.any():
        return (None, None, 0.0)  # feature, threshold, gain
    c = int(np.argmax(np.where(cand, gain, -np.inf)))
    kb = kbest[c]
    thr = 0.5 * (xs[kb, c] + xs[kb + 1, c])
    if thr >= xs[kb + 1, c]:
        # the midpoint of two adjacent floats can round up to the upper
        # one, and ``X <= thr`` would then leave the right child empty (a
        # NaN leaf in the JAX package's copy): keep the k-left split that
        # was scored
        thr = xs[kb, c]
    return (feat_idx[c], thr, gain[c])


def _random_split(X, y, feat_idx, min_leaf, rng):
    """Extra-Trees style: one uniform-random threshold per candidate
    feature, pick the best of those."""
    best = (None, None, 0.0)
    base = ((y - y.mean()) ** 2).sum()
    for j in feat_idx:
        lo, hi = X[:, j].min(), X[:, j].max()
        if lo == hi:
            continue
        thr = rng.uniform(lo, hi)
        mask = X[:, j] <= thr
        nl = int(mask.sum())
        if nl < min_leaf or len(y) - nl < min_leaf:
            continue
        yl, yr = y[mask], y[~mask]
        sse = ((yl - yl.mean()) ** 2).sum() + ((yr - yr.mean()) ** 2).sum()
        gain = base - sse
        if gain > best[2]:
            best = (j, thr, gain)
    return best


class CART(Model):
    standardize_x = False
    standardize_y = False

    def __init__(
        self,
        max_depth: int = 12,
        min_leaf: int = 2,
        max_features: Optional[float] = None,  # fraction of features per split
        random_splits: bool = False,
        seed: int = 0,
    ):
        super().__init__(seed)
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.max_features = max_features
        self.random_splits = random_splits

    def _grow(self, X, y, depth, rng):
        mean = y.mean()
        node = _Node(value=float(mean))
        # the node's SSE; zero over len(y) exactly where y.std() is zero
        # (numpy's variance sums the same squares in the same order)
        base = ((y - mean) ** 2).sum()
        if (depth >= self.max_depth or len(y) < 2 * self.min_leaf
                or base / len(y) == 0):
            return node
        d = X.shape[1]
        if self.max_features is not None:
            k = max(1, int(round(self.max_features * d)))
            feat_idx = rng.choice(d, size=k, replace=False)
        else:
            feat_idx = np.arange(d)
        if self.random_splits:
            j, thr, gain = _random_split(X, y, feat_idx, self.min_leaf, rng)
        else:
            j, thr, gain = _best_split(X, y, feat_idx, self.min_leaf, base)
        # relative gain threshold: an absolute epsilon silently refuses to
        # split small-magnitude targets (e.g. energies ~1e-7 J), leaving a
        # constant predictor
        if j is None or gain <= 1e-9 * max(base, 1e-300):
            return node
        mask = X[:, j] <= thr
        node.feature, node.threshold = int(j), float(thr)
        node.left = self._grow(X[mask], y[mask], depth + 1, rng)
        node.right = self._grow(X[~mask], y[~mask], depth + 1, rng)
        return node

    def _fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        self.root = self._grow(X, y, 0, rng)

    def _predict(self, X):
        out = np.empty(X.shape[0])
        # iterative batched traversal
        stack = [(self.root, np.arange(X.shape[0]))]
        while stack:
            node, idx = stack.pop()
            if node.is_leaf or not idx.size:
                out[idx] = node.value
                continue
            mask = X[idx, node.feature] <= node.threshold
            stack.append((node.left, idx[mask]))
            stack.append((node.right, idx[~mask]))
        return out


class RandomForest(Model):
    standardize_x = False
    standardize_y = False

    def __init__(
        self,
        n_trees: int = 50,
        max_depth: int = 12,
        min_leaf: int = 2,
        max_features: float = 0.7,
        seed: int = 0,
    ):
        super().__init__(seed)
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.max_features = max_features

    _tree_cls = CART
    _random_splits = False

    def _fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        n = X.shape[0]
        self.trees = []
        for t in range(self.n_trees):
            idx = rng.integers(0, n, size=n)  # bootstrap
            tree = self._tree_cls(
                max_depth=self.max_depth,
                min_leaf=self.min_leaf,
                max_features=self.max_features,
                random_splits=self._random_splits,
                seed=int(rng.integers(0, 2**31)),
            )
            tree._fit(X[idx], y[idx])
            self.trees.append(tree)

    def _predict(self, X):
        return np.mean([t._predict(X) for t in self.trees], axis=0)


class ExtraTrees(RandomForest):
    _random_splits = True

    def _fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for t in range(self.n_trees):  # no bootstrap (classic ET)
            tree = CART(
                max_depth=self.max_depth,
                min_leaf=self.min_leaf,
                max_features=self.max_features,
                random_splits=True,
                seed=int(rng.integers(0, 2**31)),
            )
            tree._fit(X, y)
            self.trees.append(tree)


class GradientBoosting(Model):
    standardize_x = False
    standardize_y = True

    def __init__(
        self,
        n_stages: int = 100,
        lr: float = 0.1,
        max_depth: int = 3,
        min_leaf: int = 3,
        subsample: float = 1.0,
        seed: int = 0,
    ):
        super().__init__(seed)
        self.n_stages = n_stages
        self.lr = lr
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.subsample = subsample

    def _fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        n = X.shape[0]
        self.base = float(y.mean())
        pred = np.full(n, self.base)
        self.stages = []
        for _ in range(self.n_stages):
            resid = y - pred
            if self.subsample < 1.0:
                idx = rng.choice(n, size=max(1, int(self.subsample * n)), replace=False)
            else:
                idx = np.arange(n)
            tree = CART(max_depth=self.max_depth, min_leaf=self.min_leaf,
                        seed=int(rng.integers(0, 2**31)))
            tree._fit(X[idx], resid[idx])
            pred = pred + self.lr * tree._predict(X)
            self.stages.append(tree)

    def _predict(self, X):
        out = np.full(X.shape[0], self.base)
        for tree in self.stages:
            out = out + self.lr * tree._predict(X)
        return out
