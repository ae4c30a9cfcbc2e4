"""Registry of the ~20 pre-available surrogate models (paper §IV: 'of the
nearly 20 models pre-available in the autoXFPGAs framework')."""

from __future__ import annotations

from typing import Callable, Dict

from .base import Model
from .kernel import KNN, MLP, SVR, KernelRidgeRBF
from .linear import (
    OLS,
    BayesianRidge,
    ElasticNet,
    Huber,
    Lasso,
    Poly2Ridge,
    Ridge,
    SGDRegressor,
)
from .trees import CART, ExtraTrees, GradientBoosting, RandomForest

__all__ = ["REGISTRY", "make", "available"]

REGISTRY: Dict[str, Callable[..., Model]] = {
    # linear family
    "ols": OLS,
    "ridge": Ridge,
    "ridge_strong": lambda seed=0: Ridge(alpha=10.0, seed=seed),
    "lasso": Lasso,
    "elastic_net": ElasticNet,
    "bayesian_ridge": BayesianRidge,     # paper's power estimator
    "huber": Huber,
    "sgd": SGDRegressor,
    "poly2_ridge": Poly2Ridge,
    # kernel / instance family
    "kernel_ridge_rbf": KernelRidgeRBF,
    "svr": SVR,                          # paper Fig. 6 contender
    "knn3": lambda seed=0: KNN(k=3, seed=seed),
    "knn5": lambda seed=0: KNN(k=5, seed=seed),
    "knn_uniform": lambda seed=0: KNN(k=5, weighted=False, seed=seed),
    # tree family
    "cart": CART,
    "cart_shallow": lambda seed=0: CART(max_depth=4, seed=seed),
    "random_forest": RandomForest,       # paper's QoR estimator
    "random_forest_big": lambda seed=0: RandomForest(n_trees=200, seed=seed),
    "extra_trees": ExtraTrees,
    "gradient_boosting": GradientBoosting,
    # neural
    "mlp": MLP,
}


def make(name: str, seed: int = 0) -> Model:
    return REGISTRY[name](seed=seed)


def available() -> list[str]:
    return sorted(REGISTRY)
