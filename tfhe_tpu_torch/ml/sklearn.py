"""Sklearn-style FHE estimators (a copy of tfhe_tpu/ml/sklearn.py; host
code over ml/linear, keys on `device` at compile()).

Analog of the reference's linear model zoo (reference:
ml/concrete-ml/src/concrete/ml/sklearn/linear_model.py LinearRegression /
LogisticRegression / SGDClassifier over BaseEstimator, sklearn/base.py:124):
fit in the clear, predict under FHE with the linear part encrypted and the
inverse link applied post-decryption (the reference's linear models do the
same). `fhe=` accepts disable/simulate/execute (common/utils.py FheMode).
"""

from __future__ import annotations

import numpy as np

from tfhe_tpu_torch.ml.base import SklearnEstimatorMixin
from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor
from tfhe_tpu_torch.ml.serialization import serializable


class _LinearBase(SklearnEstimatorMixin):
    _kwargs_attr = None

    def __init__(self, n_bits: int = 8, params=None):
        self.n_bits = n_bits
        self.params = params
        self._executor: GlweLinearLayerExecutor | None = None

    def _build(self, coef: np.ndarray, intercept: np.ndarray):
        # sklearn-convention fitted attrs (also the serialized state)
        self.coef_ = np.asarray(coef, np.float64)
        self.intercept_ = np.asarray(intercept, np.float64)
        self._executor = GlweLinearLayerExecutor(
            weights=self.coef_,
            bias=self.intercept_,
            n_bits_in=self.n_bits,
            n_bits_w=self.n_bits,
            params=self.params,
        )

    def _post_load(self):
        if hasattr(self, "coef_"):
            self._build(self.coef_, self.intercept_)

    def compile(self, seed: int = 0, device=None):
        """Generate FHE keys on `device`, default "cuda" (the reference's
        .compile() step)."""
        if self._executor is None:
            raise RuntimeError("fit first")
        self._executor.keygen(seed, device)
        return self

    def _linear(self, X, fhe):
        if self._executor is None:
            raise RuntimeError("fit first")
        return self._executor.forward(np.asarray(X, np.float64), fhe=fhe)


@serializable
class LinearRegression(_LinearBase):
    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        xb = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        sol, *_ = np.linalg.lstsq(xb, y, rcond=None)
        self._build(sol[:-1], sol[-1])
        return self

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        out = self._linear(X, fhe)
        return out[:, 0] if out.shape[1] == 1 else out


class _SkLinearRegressor(_LinearBase):
    """Penalized regressors fit by scikit-learn, predicted under FHE
    (reference sklearn/linear_model.py Ridge/Lasso/ElasticNet: thin
    wrappers whose inference is the same encrypted linear map)."""

    sk_path: str = ""
    _kwargs_attr = "sk_kwargs"

    def __init__(self, n_bits: int = 8, params=None, **sk_kwargs):
        super().__init__(n_bits, params)
        self.sk_kwargs = sk_kwargs

    def fit(self, X, y):
        import importlib

        mod, cls = self.sk_path.rsplit(".", 1)
        SK = getattr(importlib.import_module(mod), cls)
        m = SK(**self.sk_kwargs).fit(np.asarray(X, np.float64), np.asarray(y))
        coef = np.asarray(m.coef_, np.float64)
        coef = coef.reshape(-1, 1) if coef.ndim == 1 else coef.T
        self._build(coef, np.atleast_1d(m.intercept_))
        return self

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        out = self._linear(X, fhe)
        return out[:, 0] if out.shape[1] == 1 else out


@serializable
class Ridge(_SkLinearRegressor):
    """reference sklearn/linear_model.py Ridge"""

    sk_path = "sklearn.linear_model.Ridge"


@serializable
class Lasso(_SkLinearRegressor):
    """reference sklearn/linear_model.py Lasso"""

    sk_path = "sklearn.linear_model.Lasso"


@serializable
class ElasticNet(_SkLinearRegressor):
    """reference sklearn/linear_model.py ElasticNet"""

    sk_path = "sklearn.linear_model.ElasticNet"


@serializable
class SGDRegressor(_SkLinearRegressor):
    """reference sklearn/linear_model.py SGDRegressor (clear fit; the
    FHE-training variant is SGDClassifier in ml/zoo.py)"""

    sk_path = "sklearn.linear_model.SGDRegressor"


@serializable
class LogisticRegression(_LinearBase):
    """Binary or one-vs-rest multiclass, gradient-descent fit."""

    def __init__(self, n_bits: int = 8, params=None, lr: float = 0.5, epochs: int = 200):
        super().__init__(n_bits, params)
        self.lr = lr
        self.epochs = epochs

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        n_out = 1 if len(self.classes_) == 2 else len(self.classes_)
        w = np.zeros((X.shape[1], n_out))
        b = np.zeros(n_out)
        if n_out == 1:
            t = (y == self.classes_[1]).astype(np.float64)[:, None]
        else:
            t = (y[:, None] == self.classes_[None, :]).astype(np.float64)
        for _ in range(self.epochs):
            p = 1.0 / (1.0 + np.exp(-(X @ w + b)))
            g = X.T @ (p - t) / len(X)
            w -= self.lr * g
            b -= self.lr * (p - t).mean(axis=0)
        self._build(w, b)
        return self

    def decision_function(self, X, fhe: FheMode | str = FheMode.DISABLE):
        return self._linear(X, fhe)

    def predict_proba(self, X, fhe: FheMode | str = FheMode.DISABLE):
        z = self.decision_function(X, fhe)
        p = 1.0 / (1.0 + np.exp(-z))
        if p.shape[1] == 1:
            return np.concatenate([1 - p, p], axis=1)
        return p / p.sum(axis=1, keepdims=True)

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        return self.classes_[np.argmax(self.predict_proba(X, fhe), axis=1)]
