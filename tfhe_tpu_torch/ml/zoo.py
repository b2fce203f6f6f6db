"""The remaining sklearn-style FHE model families (a copy of
tfhe_tpu/ml/zoo.py; host code over ml/linear and ml/quantized_module;
scikit-learn is imported only where a model is fit).

Mirrors the reference's sklearn package surface (reference:
ml/concrete-ml/src/concrete/ml/sklearn/: svm.py LinearSVC/LinearSVR,
glm.py PoissonRegressor/GammaRegressor/TweedieRegressor, neighbors.py
KNeighborsClassifier, linear_model.py SGDClassifier with encrypted
training via _fhe_training_utils.py, qnn.py NeuralNetClassifier/
Regressor). Training runs in the clear via scikit-learn (the reference
does the same), except SGDClassifier which also offers FHE-executed
training steps; inference puts every linear contraction on the encrypted
GLWE matmul engine.
"""

from __future__ import annotations

import numpy as np

from tfhe_tpu_torch.ml.base import SklearnEstimatorMixin
from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor
from tfhe_tpu_torch.ml.serialization import serializable
from tfhe_tpu_torch.ml.sklearn import _LinearBase


# -- SVM -----------------------------------------------------------------------


@serializable
class LinearSVC(_LinearBase):
    """Reference sklearn/svm.py LinearSVC: sklearn-fit, FHE linear predict."""

    _kwargs_attr = "sk_kwargs"

    def __init__(self, n_bits: int = 8, params=None, **sk_kwargs):
        super().__init__(n_bits, params)
        self.sk_kwargs = sk_kwargs

    def fit(self, X, y):
        from sklearn.svm import LinearSVC as SK

        self.sk_model = SK(**self.sk_kwargs).fit(X, y)
        self.classes_ = self.sk_model.classes_
        self._build(self.sk_model.coef_.T, self.sk_model.intercept_)
        return self

    def decision_function(self, X, fhe: FheMode | str = FheMode.DISABLE):
        z = self._linear(X, fhe)
        return z[:, 0] if z.shape[1] == 1 else z

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        z = self.decision_function(X, fhe)
        if z.ndim == 1:
            return self.classes_[(z > 0).astype(int)]
        return self.classes_[np.argmax(z, axis=1)]


@serializable
class LinearSVR(_LinearBase):
    _kwargs_attr = "sk_kwargs"

    def __init__(self, n_bits: int = 8, params=None, **sk_kwargs):
        super().__init__(n_bits, params)
        self.sk_kwargs = sk_kwargs

    def fit(self, X, y):
        from sklearn.svm import LinearSVR as SK

        self.sk_model = SK(**self.sk_kwargs).fit(X, y)
        self._build(
            self.sk_model.coef_.reshape(-1, 1), np.atleast_1d(self.sk_model.intercept_)
        )
        return self

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        return self._linear(X, fhe)[:, 0]


# -- GLMs (linear under FHE, inverse link after decryption) ---------------------


class _GlmBase(_LinearBase):
    sk_cls_path: tuple[str, str] = ("", "")
    link_inv = staticmethod(np.exp)
    _kwargs_attr = "sk_kwargs"

    def __init__(self, n_bits: int = 8, params=None, **sk_kwargs):
        super().__init__(n_bits, params)
        self.sk_kwargs = sk_kwargs

    def fit(self, X, y):
        import importlib

        mod, name = self.sk_cls_path
        SK = getattr(importlib.import_module(mod), name)
        self.sk_model = SK(**self.sk_kwargs).fit(X, y)
        self._build(
            self.sk_model.coef_.reshape(-1, 1), np.atleast_1d(self.sk_model.intercept_)
        )
        return self

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        """Linear part under FHE; the inverse link runs client-side after
        decryption (reference glm.py post_processing)."""
        return self.link_inv(self._linear(X, fhe)[:, 0])


@serializable
class PoissonRegressor(_GlmBase):
    sk_cls_path = ("sklearn.linear_model", "PoissonRegressor")


@serializable
class GammaRegressor(_GlmBase):
    sk_cls_path = ("sklearn.linear_model", "GammaRegressor")


@serializable
class TweedieRegressor(_GlmBase):
    sk_cls_path = ("sklearn.linear_model", "TweedieRegressor")

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        z = self._linear(X, fhe)[:, 0]
        power = self.sk_kwargs.get("power", 0.0)
        link = self.sk_kwargs.get("link", "auto")
        if link == "identity" or (link == "auto" and power <= 0):
            return z
        return np.exp(z)


# -- KNN -------------------------------------------------------------------------


@serializable
class KNeighborsClassifier(SklearnEstimatorMixin):
    """Reference sklearn/neighbors.py KNeighborsClassifier: encrypted
    distance computation. ||x - c||^2 = ||x||^2 - 2 c.x + ||c||^2: the
    cross term (the only part needing the encrypted input) is a linear
    map and runs on the GLWE engine; ranking happens after decryption of
    the distance vector (the decryption boundary the deployment client
    owns)."""

    def __init__(self, n_neighbors: int = 3, n_bits: int = 8, params=None):
        self.k = n_neighbors
        self.n_bits = n_bits
        self.params = params

    @property
    def n_neighbors(self):  # sklearn-name alias for get_params
        return self.k

    @n_neighbors.setter
    def n_neighbors(self, v):
        self.k = v

    _serial_attrs = ("_train", "_labels")

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        self._train = X
        self._labels = np.asarray(y)
        self.classes_ = np.unique(y)
        self._build_exec()
        return self

    def _build_exec(self):
        X = self._train
        self._exec = GlweLinearLayerExecutor(
            weights=-2.0 * X.T,  # (features, n_train)
            bias=(X**2).sum(axis=1),
            n_bits_in=self.n_bits,
            n_bits_w=self.n_bits,
            params=self.params,
        )

    def _post_load(self):
        if hasattr(self, "_train"):
            self._build_exec()

    def compile(self, seed: int = 0, device=None):
        self._exec.keygen(seed, device)
        return self

    def _distances(self, X, fhe):
        X = np.asarray(X, np.float64)
        cross = self._exec.forward(X, fhe=fhe)  # -2 x.c + ||c||^2
        return cross + (X**2).sum(axis=1, keepdims=True)

    def kneighbors(self, X, fhe: FheMode | str = FheMode.DISABLE):
        d2 = self._distances(X, fhe)
        idx = np.argsort(d2, axis=1)[:, : self.k]
        return np.sqrt(np.maximum(np.take_along_axis(d2, idx, 1), 0.0)), idx

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        _, idx = self.kneighbors(X, fhe)
        votes = self._labels[idx]
        out = []
        for row in votes:
            vals, counts = np.unique(row, return_counts=True)
            out.append(vals[np.argmax(counts)])
        return np.asarray(out)


# -- SGDClassifier with FHE-executed training -----------------------------------


@serializable
class SGDClassifier(_LinearBase):
    """Binary logistic SGD where the per-step gradient matmuls can run
    under FHE (reference linear_model.py SGDClassifier +
    _fhe_training_utils.py LogisticRegressionTraining: X @ w and
    X^T @ err are the encrypted ops; the sigmoid runs as a low-bit
    polynomial/TLU between them)."""

    def __init__(
        self,
        n_bits: int = 8,
        params=None,
        lr: float = 0.5,
        epochs: int = 30,
        fit_encrypted: bool = False,
    ):
        super().__init__(n_bits, params)
        self.lr = lr
        self.epochs = epochs
        self.fit_encrypted = fit_encrypted

    @staticmethod
    def _sigmoid_tlu(z):
        # degree-3 polynomial sigmoid on a clipped range: what the
        # reference evaluates as a TLU during encrypted training
        z = np.clip(z, -4.0, 4.0)
        return np.clip(0.5 + 0.197 * z - 0.004 * z**3, 0.0, 1.0)

    def fit(self, X, y, fhe: FheMode | str = FheMode.DISABLE, device=None):
        """`device` holds the EXECUTE-mode training keys (default "cuda")."""
        fhe = FheMode.from_any(fhe)
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) != 2:
            raise ValueError("binary training only (reference parity)")
        t = (y == self.classes_[1]).astype(np.float64)
        w = np.zeros(X.shape[1])
        b = 0.0
        use_fhe = self.fit_encrypted and fhe != FheMode.DISABLE
        for _ in range(self.epochs):
            if use_fhe:
                fwd = GlweLinearLayerExecutor(
                    weights=w.reshape(-1, 1), bias=np.array([b]),
                    n_bits_in=self.n_bits, n_bits_w=self.n_bits,
                )
                if fhe == FheMode.EXECUTE:
                    fwd.keygen(0, device)
                z = fwd.forward(X, fhe=fhe)[:, 0]
            else:
                z = X @ w + b
            p = self._sigmoid_tlu(z)
            err = p - t
            if use_fhe:
                bwd = GlweLinearLayerExecutor(
                    weights=X, bias=None,
                    n_bits_in=self.n_bits, n_bits_w=self.n_bits,
                )
                if fhe == FheMode.EXECUTE:
                    bwd.keygen(1, device)
                g = bwd.forward(err.reshape(1, -1), fhe=fhe)[0] / len(X)
            else:
                g = X.T @ err / len(X)
            w = w - self.lr * g
            b = b - self.lr * float(err.mean())
        self._build(w.reshape(-1, 1), np.array([b]))
        return self

    def decision_function(self, X, fhe: FheMode | str = FheMode.DISABLE):
        return self._linear(X, fhe)[:, 0]

    def predict_proba(self, X, fhe: FheMode | str = FheMode.DISABLE):
        p = 1.0 / (1.0 + np.exp(-self.decision_function(X, fhe)))
        return np.stack([1 - p, p], axis=1)

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        return self.classes_[(self.decision_function(X, fhe) > 0).astype(int)]


# -- QNN (torch-trained MLP compiled to the quantized pipeline) -------------------


@serializable
class NeuralNetClassifier(SklearnEstimatorMixin):
    """Reference sklearn/qnn.py NeuralNetClassifier: a small torch MLP
    trained in the clear, compiled with compile_torch_model for FHE
    inference."""

    def __init__(
        self,
        hidden: tuple = (32,),
        n_bits: int = 6,
        epochs: int = 80,
        lr: float = 0.05,
        activation: str = "ReLU",
    ):
        self.hidden = hidden
        self.n_bits = n_bits
        self.epochs = epochs
        self.lr = lr
        self.activation = activation
        self._qm = None

    _serial_attrs = ("_qm",)

    def _build_torch(self, n_in, n_out):
        import torch.nn as nn

        act = getattr(nn, self.activation)
        layers = []
        d = n_in
        for h in self.hidden:
            layers += [nn.Linear(d, h), act()]
            d = h
        layers.append(nn.Linear(d, n_out))
        return nn.Sequential(*layers)

    def fit(self, X, y):
        import torch

        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        yi = np.searchsorted(self.classes_, y)
        net = self._build_torch(X.shape[1], len(self.classes_))
        opt = torch.optim.Adam(net.parameters(), lr=self.lr)
        xt = torch.tensor(X)
        yt = torch.tensor(yi, dtype=torch.long)
        loss_fn = torch.nn.CrossEntropyLoss()
        for _ in range(self.epochs):
            opt.zero_grad()
            loss = loss_fn(net(xt), yt)
            loss.backward()
            opt.step()
        from tfhe_tpu_torch.ml.quantized_module import compile_torch_model

        self._qm = compile_torch_model(net, X, n_bits=self.n_bits)
        return self

    def compile(self, seed: int = 0, device=None):
        self._qm.compile(seed, device)
        return self

    def predict_proba(self, X, fhe: FheMode | str = FheMode.DISABLE):
        z = self._qm.forward(np.asarray(X, np.float64), fhe=fhe)
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        return self.classes_[np.argmax(self.predict_proba(X, fhe), axis=1)]


@serializable
class NeuralNetRegressor(NeuralNetClassifier):
    def fit(self, X, y):
        import torch

        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32).reshape(len(X), -1)
        net = self._build_torch(X.shape[1], y.shape[1])
        opt = torch.optim.Adam(net.parameters(), lr=self.lr)
        xt, yt = torch.tensor(X), torch.tensor(y)
        for _ in range(self.epochs):
            opt.zero_grad()
            loss = ((net(xt) - yt) ** 2).mean()
            loss.backward()
            opt.step()
        from tfhe_tpu_torch.ml.quantized_module import compile_torch_model

        self._qm = compile_torch_model(net, X, n_bits=self.n_bits)
        return self

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        out = self._qm.forward(np.asarray(X, np.float64), fhe=fhe)
        return out[:, 0] if out.shape[1] == 1 else out
