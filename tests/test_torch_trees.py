"""The port's regression-tree split search scores every candidate feature
in one pass over a 2-D array.  It must pick the split that a loop over
one feature at a time picks, to the bit: the JAX package's loop (its
``_best_split``) wherever the chosen midpoint is exact, and the tree
ensembles built on it must predict the JAX package's values bit for bit
on such data."""

import numpy as np
import pytest

from repro.core.surrogates import make as ref_make
from repro.core.surrogates.trees import _best_split as ref_best_split
from repro_torch.core.surrogates import make
from repro_torch.core.surrogates.trees import _best_split

from _torch_threads import bounded_torch_threads  # noqa: F401

# (rows, features, kind of X, min_leaf, fraction of features tried)
SPLIT_CASES = [
    (4, 1, "ternary", 1, None),
    (37, 5, "ternary", 2, None),
    (200, 30, "ternary", 2, 0.7),
    (300, 12, "normal", 1, None),
    (150, 20, "rounded", 3, 0.7),
    (64, 8, "constant", 2, None),
    (999, 60, "octal", 2, 0.7),
]


def _data(n, d, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ternary":
        X = rng.integers(0, 3, (n, d)).astype(float)
    elif kind == "octal":
        X = rng.integers(0, 8, (n, d)) / 7.0
    elif kind == "normal":
        X = rng.standard_normal((n, d))
    elif kind == "rounded":
        X = np.round(rng.standard_normal((n, d)), 1)
        X[:, 0] = 1.0                     # a column with no split
    else:
        X = np.ones((n, d))               # no column has a split
    y = X.sum(axis=1) * rng.random() + rng.standard_normal(n)
    return X, y, rng


@pytest.mark.parametrize("n,d,kind,min_leaf,frac", SPLIT_CASES)
def test_best_split_equals_the_one_feature_loop(n, d, kind, min_leaf, frac):
    X, y, rng = _data(n, d, kind, seed=n + d)
    for scale in (1.0, 1e-7):             # energies are ~1e-7 J
        ys = y * scale
        feat_idx = (np.arange(d) if frac is None else
                    rng.choice(d, size=max(1, round(frac * d)),
                               replace=False))
        got = _best_split(X, ys, feat_idx, min_leaf,
                          ((ys - ys.mean()) ** 2).sum())
        want = ref_best_split(X, ys, feat_idx, min_leaf)
        assert (got[0] is None) == (want[0] is None)
        assert got[2] == want[2]
        if want[0] is not None:
            assert int(got[0]) == int(want[0])
            assert got[1] == want[1]


@pytest.mark.parametrize("target", ["linear", "constant"])
@pytest.mark.parametrize("name", ["random_forest", "extra_trees",
                                  "gradient_boosting", "cart"])
def test_tree_models_predict_the_reference_bits(name, target):
    X, y, _ = _data(400, 16, "octal", seed=3)
    if target == "constant":
        # a mean of n copies of 0.1 is not 0.1: the nodes' SSE is tiny
        # but not zero, and they search for a split as the reference's do
        y = np.full(len(y), 0.1)
    probe, _, _ = _data(100, 16, "octal", seed=4)
    got = make(name, seed=1).fit(X, y).predict(probe)
    want = ref_make(name, seed=1).fit(X, y).predict(probe)
    assert got.tobytes() == want.tobytes()
