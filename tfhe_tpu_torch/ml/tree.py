"""Tree-based FHE models: decision trees, random forests, gradient boosting
(a copy of tfhe_tpu/ml/tree.py; host code over two ml/linear executors
at TREES_MATMUL; scikit-learn is imported only where a model is fit).

Analog of the reference's tree zoo (reference:
ml/concrete-ml/src/concrete/ml/sklearn/tree.py DecisionTreeClassifier/
Regressor, rf.py RandomForest*, xgb.py XGB*, with the tree->tensor
lowering of sklearn/tree_to_numpy.py): training delegates to scikit-learn
in the clear; inference lowers every tree ensemble to the 3-GEMM
"Hummingbird" form

    S = step(X @ A - T)        (one comparison per internal node)
    L = onehot(S @ B == C)     (path indicator per leaf)
    y = L @ V                  (leaf values)

where the matmuls run on the encrypted GLWE engine and the step/equality
nonlinearities are quantized TLUs -- the whole ensemble is three
batched matmuls instead of per-node branching.
"""

from __future__ import annotations

import numpy as np

from tfhe_tpu_torch.ml.base import SklearnEstimatorMixin
from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor
from tfhe_tpu_torch.ml.serialization import serializable
from tfhe_tpu_torch.ml.quantization import UniformQuantizer


class _LoweredTree:
    """GEMM form of one fitted sklearn tree."""

    def __init__(self, sk_tree, n_features: int, n_outputs: int,
                 normalize_leaves: bool = False, out_col: int | None = None):
        t = sk_tree.tree_
        internal = [i for i in range(t.node_count) if t.children_left[i] != -1]
        leaves = [i for i in range(t.node_count) if t.children_left[i] == -1]
        self.n_internal = max(len(internal), 1)
        self.n_leaves = len(leaves)
        # A: feature selector per internal node; T: thresholds
        self.a = np.zeros((n_features, self.n_internal))
        self.thr = np.zeros(self.n_internal)
        node_pos = {n: j for j, n in enumerate(internal)}
        for n, j in node_pos.items():
            self.a[t.feature[n], j] = 1.0
            self.thr[j] = t.threshold[n]
        # B/C: leaf path conditions; V: leaf values
        self.b = np.zeros((self.n_internal, self.n_leaves))
        self.c = np.zeros(self.n_leaves)
        self.v = np.zeros((self.n_leaves, n_outputs))
        for k, leaf in enumerate(leaves):
            # walk root->leaf recording (node, went_left)
            path = []
            node = 0
            while node != leaf:
                left, right = t.children_left[node], t.children_right[node]
                # does `leaf` live in the left subtree of `node`?
                span = set()
                stack = [left]
                while stack:
                    m = stack.pop()
                    span.add(m)
                    if t.children_left[m] != -1:
                        stack.extend([t.children_left[m], t.children_right[m]])
                if leaf in span:
                    path.append((node, True))
                    node = left
                else:
                    path.append((node, False))
                    node = right
            for n, went_left in path:
                j = node_pos[n]
                # step(x - thr) = 0 when x <= thr (left), 1 when right
                self.b[j, k] = -1.0 if went_left else 1.0
                if not went_left:
                    self.c[k] += 1.0
            vals = t.value[leaf].reshape(-1).astype(np.float64)
            if normalize_leaves and vals.sum() > 0:
                vals = vals / vals.sum()
            if out_col is not None:
                self.v[k, out_col] = vals[0]
            else:
                self.v[k, : len(vals)] = vals


class _TreeEnsembleBase(SklearnEstimatorMixin):
    """Shared FHE inference over lowered trees. The two GEMM stages run
    on GlweLinearLayerExecutors; step/equality are exact small TLUs."""

    sklearn_cls: str = ""  # "<sklearn submodule>.<class>", imported at fit
    is_classifier = True
    normalize_leaves = True  # counts -> per-tree probabilities (DT/RF)
    _kwargs_attr = "sk_kwargs"
    _serial_attrs = ("_a", "_thr", "_b", "_c", "_v", "_n_trees")

    def __init__(self, n_bits: int = 6, params=None, **sk_kwargs):
        self.n_bits = n_bits
        self.params = params  # GLWE matmul parameter set (None = default)
        self.sk_kwargs = sk_kwargs
        self.sk_model = None
        self._trees: list[_LoweredTree] = []

    # -- fit ------------------------------------------------------------------

    def _fit_sklearn(self, X, y):
        # sklearn_cls names a class of sklearn.tree / sklearn.ensemble,
        # imported here: importing this module never imports scikit-learn
        import importlib

        mod, name = self.sklearn_cls.split(".")
        self.sk_model = getattr(importlib.import_module(f"sklearn.{mod}"), name)(**self.sk_kwargs)
        self.sk_model.fit(X, y)
        return self.sk_model

    def _estimators(self):
        """[(tree, out_col)]: boosted multiclass stages are per-class
        single-output trees routed to their class column."""
        m = self.sk_model
        if hasattr(m, "estimators_"):
            ests = np.asarray(m.estimators_)
            if ests.ndim == 2 and ests.shape[1] > 1:  # GBT multiclass
                return [
                    (ests[i, j], j)
                    for i in range(ests.shape[0])
                    for j in range(ests.shape[1])
                ]
            return [(e, None) for e in ests.reshape(-1)]
        return [(m, None)]

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        self._fit_sklearn(X, y)
        if self.is_classifier:
            self.classes_ = np.unique(y)
            n_out = len(self.classes_)
        else:
            n_out = 1 if y.ndim == 1 else y.shape[1]
        if not self.normalize_leaves and self.is_classifier:
            # boosted ensembles: per-stage trees each carry ONE output;
            # multiclass stages interleave per class
            n_out = 1 if len(self.classes_) == 2 else len(self.classes_)
        self.n_outputs_ = n_out
        norm = self.is_classifier and self.normalize_leaves
        self._trees = [
            _LoweredTree(e, X.shape[1], n_out, normalize_leaves=norm,
                         out_col=col)
            for e, col in self._estimators()
        ]
        # stack ensembles into block matrices: one GEMM for all trees
        self._a = np.concatenate([t.a for t in self._trees], axis=1)
        self._thr = np.concatenate([t.thr for t in self._trees])
        n_int = [t.n_internal for t in self._trees]
        n_lea = [t.n_leaves for t in self._trees]
        self._b = np.zeros((sum(n_int), sum(n_lea)))
        self._c = np.concatenate([t.c for t in self._trees])
        self._v = np.concatenate([t.v for t in self._trees], axis=0)
        io = lo = 0
        for t in self._trees:
            self._b[io : io + t.n_internal, lo : lo + t.n_leaves] = t.b
            io += t.n_internal
            lo += t.n_leaves
        self._n_trees = len(self._trees)
        self._build_execs()
        return self

    def _build_execs(self):
        # default to the tree-grade parameter set: the default 8-bit
        # matmul params' 26-bit output storage leaves ~13.5 LSB of
        # decrypt noise, which breaks the EXACT step/equality integer
        # comparisons this lowering depends on (params.TREES_MATMUL)
        from tfhe_tpu_torch import params as tparams

        p = getattr(self, "params", None) or tparams.TREES_MATMUL
        self._exec_a = GlweLinearLayerExecutor(
            weights=self._a, bias=None, n_bits_in=self.n_bits, n_bits_w=2,
            exact_int_weights=True, params=p,
        )
        self._exec_l = GlweLinearLayerExecutor(
            weights=self._b, bias=None, n_bits_in=2, n_bits_w=2,
            exact_int_weights=True, params=p,
        )

    def _post_load(self):
        if hasattr(self, "_a"):
            self._build_execs()

    def compile(self, seed: int = 0, device=None):
        self._exec_a.keygen(seed, device)
        self._exec_l.keygen(seed + 1, device)
        return self

    # -- predict ----------------------------------------------------------------

    def _raw_predict(self, X, fhe):
        fhe = FheMode.from_any(fhe)
        X = np.asarray(X, np.float64)
        # stage 1: node feature selection (encrypted GEMM; the executor
        # quantizes activations dynamically like the reference), then the
        # threshold-step TLU
        sel = self._exec_a.forward(X, fhe=fhe)  # (B, n_internal_total)
        # Threshold snapping: sel lives on the batch quantization grid
        # (k - zp) * scale plus sub-LSB decrypt noise. A raw `sel > thr`
        # is knife-edged when thr collides with a grid point (sklearn
        # thresholds are data midpoints; collisions at 6 bits are
        # routine) -- DISABLE resolves the tie exactly, EXECUTE's noise
        # resolves it randomly. Snapping thr to the neighboring grid
        # MIDPOINT makes the comparison an integer comparison, immune to
        # any noise < 0.5 LSB.
        xq = self._exec_a.last_input_quantizer
        s_step = float(xq.scale) or 1.0
        zp = float(xq.zero_point)
        thr_snap = (np.floor(self._thr / s_step + zp) + 0.5 - zp) * s_step
        s = (sel > thr_snap[None, :]).astype(np.float64)  # TLU: step
        # stage 2: leaf path match (encrypted GEMM), then equality TLU
        acc = self._exec_l.forward(s, fhe=fhe)  # (B, n_leaves_total)
        # leaf selected iff acc == c (count of satisfied right-branches
        # minus violated left-branches hits its exact per-leaf target)
        sel_leaf = (np.round(acc) == self._c[None, :]).astype(np.float64)
        out = sel_leaf @ self._v  # leaf values (clear weights, could also
        # ride the GLWE engine; kept clear like the reference's final gather)
        return out

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        out = self._raw_predict(X, fhe)
        if self.is_classifier:
            return self.classes_[np.argmax(out, axis=1)]
        return out[:, 0] / max(self._n_trees, 1)

    def predict_proba(self, X, fhe: FheMode | str = FheMode.DISABLE):
        if not self.is_classifier:
            raise ValueError("predict_proba needs a classifier")
        out = self._raw_predict(X, fhe) / max(self._n_trees, 1)
        tot = out.sum(axis=1, keepdims=True)
        tot = np.where(tot == 0, 1.0, tot)
        return out / tot


@serializable
class DecisionTreeClassifier(_TreeEnsembleBase):
    """Reference sklearn/tree.py DecisionTreeClassifier."""

    sklearn_cls = "tree.DecisionTreeClassifier"
    is_classifier = True


@serializable
class DecisionTreeRegressor(_TreeEnsembleBase):
    sklearn_cls = "tree.DecisionTreeRegressor"
    is_classifier = False

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        return self._raw_predict(X, fhe)[:, 0]


@serializable
class RandomForestClassifier(_TreeEnsembleBase):
    """Reference sklearn/rf.py RandomForestClassifier."""

    sklearn_cls = "ensemble.RandomForestClassifier"
    is_classifier = True

    def _raw_predict(self, X, fhe):
        out = super()._raw_predict(X, fhe)
        return out  # class-count votes across trees accumulate naturally


@serializable
class RandomForestRegressor(_TreeEnsembleBase):
    sklearn_cls = "ensemble.RandomForestRegressor"
    is_classifier = False


@serializable
class XGBClassifier(_TreeEnsembleBase):
    """Gradient-boosted classifier (reference sklearn/xgb.py wraps
    xgboost; gradient-boosting semantics via sklearn's implementation;
    staged-logit link offsets are derived empirically from the fitted
    model so version-internal init conventions cannot drift)."""

    sklearn_cls = "ensemble.GradientBoostingClassifier"
    is_classifier = True
    normalize_leaves = False  # boosting leaves are regression values

    def fit(self, X, y):
        super().fit(X, y)
        X = np.asarray(X, np.float64)
        # GBT trees are per-stage-per-class: n_outputs follows stages
        lr = self.learning_rate_ = self.sk_model.learning_rate
        df = self.sk_model.decision_function(X[:16])
        if df.ndim == 1:
            df = df[:, None]
        mine = self._leaf_sum(X[:16]) * lr
        self.link_offset_ = (df - mine).mean(axis=0)
        return self

    def _leaf_sum(self, X):
        """Leaf-value sum in the clear -- calibrates the link offset."""
        out = _TreeEnsembleBase._raw_predict(self, X, FheMode.DISABLE)
        k = 1 if len(self.classes_) == 2 else len(self.classes_)
        return out[:, :k]

    def decision_function(self, X, fhe: FheMode | str = FheMode.DISABLE):
        raw = _TreeEnsembleBase._raw_predict(self, X, fhe)
        k = 1 if len(self.classes_) == 2 else len(self.classes_)
        return raw[:, :k] * self.learning_rate_ + self.link_offset_

    def predict_proba(self, X, fhe: FheMode | str = FheMode.DISABLE):
        z = self.decision_function(X, fhe)
        if z.shape[1] == 1:
            p1 = 1.0 / (1.0 + np.exp(-z[:, 0]))
            return np.stack([1 - p1, p1], axis=1)
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        return self.classes_[np.argmax(self.predict_proba(X, fhe), axis=1)]


@serializable
class XGBRegressor(_TreeEnsembleBase):
    sklearn_cls = "ensemble.GradientBoostingRegressor"
    is_classifier = False
    normalize_leaves = False

    def fit(self, X, y):
        super().fit(X, y)
        X = np.asarray(X, np.float64)
        lr = self.learning_rate_ = self.sk_model.learning_rate
        mine = _TreeEnsembleBase._raw_predict(self, X[:16], FheMode.DISABLE)[:, 0]
        self.link_offset_ = float(
            (self.sk_model.predict(X[:16]) - mine * lr).mean()
        )
        return self

    def predict(self, X, fhe: FheMode | str = FheMode.DISABLE):
        raw = self._raw_predict(X, fhe)[:, 0]
        return raw * self.learning_rate_ + self.link_offset_
