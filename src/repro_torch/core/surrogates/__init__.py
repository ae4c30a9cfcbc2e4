from .base import Model, Standardizer, mae, pcc, r2, rmse
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
from .registry import REGISTRY, available, make
from .trees import CART, ExtraTrees, GradientBoosting, RandomForest

__all__ = [
    "Model", "Standardizer", "pcc", "r2", "mae", "rmse",
    "OLS", "Ridge", "Lasso", "ElasticNet", "BayesianRidge", "Huber",
    "SGDRegressor", "Poly2Ridge",
    "KernelRidgeRBF", "SVR", "KNN", "MLP",
    "CART", "RandomForest", "ExtraTrees", "GradientBoosting",
    "REGISTRY", "make", "available",
]
