"""The ML stack of tfhe_tpu_torch against the JAX package, on the CPU.

One JAX matmul keygen at TOY_MATMUL (N = 256) for the file, carried into
every encrypted executor of both packages:
* QuantizedModule from compile_torch_model (torch_models.FC and a conv
  Sequential: Conv, AvgPool, Flatten, Gemm) and the ONNX route
  (compile_torch_model_via_onnx of torch_models.CNN, compile_onnx_model of
  a hand-written ONNX blob): the same op list, DISABLE and SIMULATE equal,
  EXECUTE equal on the carried key (tolerance 0: the decrypted integer
  accumulators are the same; torch_models.CNN's 36 im2col rows an image
  are left to DISABLE/SIMULATE, the conv Sequential takes the encrypted
  conv). compile_torch_model cannot lower torch_models.CNN in either
  package (its flatten is functional), so CNN goes through ONNX;
* every EXECUTE case runs 2 rows a matmul and output widths from
  {1, 3, 4} (hence 4-wide hidden layers): the JAX matmul compiles once per
  (rows, width), ~7 s each;
* ml/serialization: a model dumped by either package loads in the other
  and dumps to the same JSON;
* a linear model, a GLM, NeuralNetClassifier, a decision tree and a
  gradient-boosted ensemble: the same predictions in DISABLE and in
  EXECUTE on the carried key;
* the get_sklearn_*_models registries name the same classes.
"""

import json

import numpy as np
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu import ml as jml
from tfhe_tpu.ml import torch_models as jzoo
from tfhe_tpu.ml.onnx_frontend import compile_onnx_model as jax_compile_onnx
from tfhe_tpu.ml.serialization import dumps as jax_dumps, loads as jax_loads
from tfhe_tpu.ml.torch_export import compile_torch_model_via_onnx as jax_via_onnx
from tfhe_tpu.models import glwe_matmul as jgm
from tfhe_tpu_torch import convert
from tfhe_tpu_torch import ml as tml
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.ml import torch_models as tzoo
from tfhe_tpu_torch.ml.onnx_frontend import compile_onnx_model as port_compile_onnx
from tfhe_tpu_torch.ml.serialization import dumps as port_dumps, loads as port_loads
from tfhe_tpu_torch.ml.torch_export import compile_torch_model_via_onnx as port_via_onnx
from tests.test_onnx_frontend import _mlp_model

N_BITS = 4  # the TOY_MATMUL accumulators decrypt exactly at 4-bit inputs and weights


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    """JAX TOY_MATMUL key (seed 71) and the port's copy."""
    pk = jgm.create_private_key(jp.TOY_MATMUL, seed=71)
    return pk, convert.matmul_private_key_from_reference(pk, device="cpu")


def _executors(model):
    """Every GlweLinearLayerExecutor of a model of either package."""
    found = []
    for name in ("_executor", "_exec", "_exec_a", "_exec_l"):
        ex = getattr(model, name, None)
        if ex is not None and hasattr(ex, "w_q"):
            found.append(ex)
    qm = getattr(model, "_qm", None) or model
    ops = [n.op for n in getattr(qm, "nodes", [])] or getattr(qm, "ops", [])
    found += [op._exec for op in ops if getattr(op, "_exec", None) is not None]
    return found


def _carry(jax_model, port_model, keys):
    """Put the one TOY_MATMUL key pair on every executor of both models."""
    pk, tkey = keys
    jex, tex = _executors(jax_model), _executors(port_model)
    assert len(jex) == len(tex) > 0
    for a, b in zip(jex, tex):
        np.testing.assert_array_equal(a.w_q, b.w_q)
        a.params, a._pkey = jp.TOY_MATMUL, pk
        b.params, b._pkey = tp.TOY_MATMUL, tkey
    for m in (jax_model, port_model):
        m = getattr(m, "_qm", None) or m
        if hasattr(m, "_compiled"):
            m._compiled = True


def _conv_seq():
    """A strided conv to one position a 4x4 image: im2col gives one row
    an image."""
    nn = torch.nn
    return nn.Sequential(nn.Conv2d(1, 4, 3, stride=2), nn.ReLU(), nn.AvgPool2d(1), nn.Flatten(), nn.Linear(4, 4))


# name -> (build the pair of modules from one seeded model, calibration input)
def _modules(name):
    rs = np.random.default_rng(5)
    if name == "fc":
        torch.manual_seed(0)
        x = rs.normal(size=(6, 8)).astype(np.float32)
        jm, tm = jzoo.FC(hidden=4), tzoo.FC(hidden=4)
        tm.load_state_dict(jm.state_dict())
        return jml.compile_torch_model(jm, x, n_bits=N_BITS), tml.compile_torch_model(tm, x, n_bits=N_BITS), x
    if name == "conv":
        torch.manual_seed(1)
        x = rs.normal(size=(3, 1, 4, 4)).astype(np.float32)
        net = _conv_seq()
        return jml.compile_torch_model(net, x, n_bits=N_BITS), tml.compile_torch_model(net, x, n_bits=N_BITS), x
    if name == "cnn_onnx":
        torch.manual_seed(2)
        x = rs.normal(size=(3, 1, 8, 8)).astype(np.float32)
        jm, tm = jzoo.CNN(), tzoo.CNN()
        tm.load_state_dict(jm.state_dict())
        kw = dict(n_bits=N_BITS, keygen=False)
        return jax_via_onnx(jm, x, **kw), port_via_onnx(tm, x, **kw), x
    if name == "mlp_onnx":
        w1 = rs.normal(0, 0.6, (4, 4)).astype(np.float32)
        b1 = rs.normal(0, 0.3, (4,)).astype(np.float32)
        w2 = rs.normal(0, 0.6, (4, 4)).astype(np.float32)
        blob = _mlp_model(w1, b1, w2)
        x = rs.normal(0, 1, (5, 4))
        kw = dict(n_bits=N_BITS, keygen=False)
        return jax_compile_onnx(blob, x, **kw), port_compile_onnx(blob, x, **kw), x
    raise KeyError(name)


def _op_names(qm):
    ops = [n.op for n in qm.nodes] if hasattr(qm, "nodes") else qm.ops
    return [type(op).__name__ for op in ops]


@pytest.fixture(scope="module")
def module_pairs():
    return {name: _modules(name) for name in ("fc", "conv", "cnn_onnx", "mlp_onnx")}


CASES = [(name, mode) for name in ("fc", "conv", "cnn_onnx", "mlp_onnx") for mode in ("disable", "simulate", "execute")
         if (name, mode) != ("cnn_onnx", "execute")]


@pytest.mark.parametrize("name,mode", CASES)
def test_quantized_module_matches_reference(module_pairs, keys, name, mode):
    jqm, tqm, x = module_pairs[name]
    assert _op_names(tqm) == _op_names(jqm)
    if mode == "execute":
        _carry(jqm, tqm, keys)
        x = x[:2]
    np.testing.assert_array_equal(tqm.forward(x, fhe=mode), jqm.forward(x, fhe=mode))


def test_compile_threads_device_to_every_executor():
    """A torch calibration tensor and module weights leave torch through
    .detach().cpu(), and compile(seed, device) puts every executor's key
    on that device."""
    torch.manual_seed(3)
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU())
    x = np.random.default_rng(3).normal(size=(4, 4)).astype(np.float32)
    qm = tml.compile_torch_model(net, torch.from_numpy(x), n_bits=N_BITS)
    np.testing.assert_array_equal(qm.ops[0].weights, net[0].weight.detach().numpy().T)
    for op in qm.ops:
        if hasattr(op, "_exec"):
            op._exec.params = tp.TOY_MATMUL
    qm.compile(seed=4, device="cpu")
    assert all(op._exec._pkey.glwe_key.key.device.type == "cpu" for op in qm.ops if hasattr(op, "_exec"))


def test_execute_forward_transform_calls(keys, monkeypatch):
    """A QuantizedModule EXECUTE forward calls the engine's forward
    transforms (K1 on the card) 7 times and its inverse (K2) 4 times per
    encrypted Gemm: encrypt, prepare the weights, matmul with its packing
    keyswitch, decrypt. chip_smoke.py's ml_qm launch counts read the same."""
    from tfhe_tpu_torch.ops.folded_ntt import FoldedCrtEngine

    torch.manual_seed(4)
    nn = torch.nn
    net = nn.Sequential(nn.Linear(6, 4), nn.ReLU(), nn.Linear(4, 4))
    x = np.random.default_rng(4).normal(size=(4, 6))
    qm = tml.compile_torch_model(net, x, n_bits=N_BITS)
    for op in qm.ops:
        if hasattr(op, "_exec"):
            op._exec.params, op._exec._pkey = tp.TOY_MATMUL, keys[1]
    qm._compiled = True
    calls = {"forward": 0, "inverse": 0}
    for name, kind in (("forward_small", "forward"), ("forward_u64", "forward"), ("backward", "inverse")):
        def counted(self, *a, _orig=getattr(FoldedCrtEngine, name), _kind=kind, **kw):
            calls[_kind] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(FoldedCrtEngine, name, counted)
    qm.forward(x[:2], fhe="execute")
    assert calls == {"forward": 2 * 7, "inverse": 2 * 4}


# -- sklearn-style models ---------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(96, 5))
    y2 = (X[:, 0] * X[:, 1] > 0).astype(int)  # xor-like: one full depth-2 boosting stage
    y4 = np.digitize(X[:, 0] - X[:, 2], [-0.7, 0.0, 0.7])  # four classes: 4-wide outputs
    yr = 3 * X[:, 0] + X[:, 1]
    return X, y2, y4, yr


def _fit_pair(name, data):
    X, y2, y4, yr = data
    if name == "linear_regression":
        return [m(n_bits=N_BITS, params=p).fit(X, yr) for m, p in
                ((jml.LinearRegression, jp.TOY_MATMUL), (tml.LinearRegression, tp.TOY_MATMUL))]
    if name == "poisson":
        ypos = np.exp(0.3 * X[:, 0])
        return [m(n_bits=N_BITS, params=p).fit(X, ypos) for m, p in
                ((jml.PoissonRegressor, jp.TOY_MATMUL), (tml.PoissonRegressor, tp.TOY_MATMUL))]
    if name == "neural_net":
        out = []
        for cls in (jml.NeuralNetClassifier, tml.NeuralNetClassifier):
            torch.manual_seed(0)
            out.append(cls(hidden=(4,), n_bits=N_BITS, epochs=20).fit(X, y4))
        return out
    if name == "decision_tree":
        return [m(n_bits=N_BITS, params=p, max_depth=2, random_state=0).fit(X, y4) for m, p in
                ((jml.DecisionTreeClassifier, jp.TOY_MATMUL), (tml.DecisionTreeClassifier, tp.TOY_MATMUL))]
    if name == "gradient_boosting":  # one boosting stage of depth 2: the tree's (5, 3) and (3, 4) shapes
        return [m(n_bits=N_BITS, params=p, n_estimators=1, max_depth=2, random_state=0).fit(X, y2) for m, p in
                ((jml.XGBClassifier, jp.TOY_MATMUL), (tml.XGBClassifier, tp.TOY_MATMUL))]
    raise KeyError(name)


MODELS = ["linear_regression", "poisson", "neural_net", "decision_tree", "gradient_boosting"]


@pytest.fixture(scope="module")
def model_pairs(data):
    return {name: _fit_pair(name, data) for name in MODELS}


@pytest.mark.parametrize("mode", ["disable", "execute"])
@pytest.mark.parametrize("name", MODELS)
def test_sklearn_models_match_reference(model_pairs, data, keys, name, mode):
    jm, tm = model_pairs[name]
    X = data[0][:24] if mode == "disable" else data[0][:2]
    if mode == "execute":
        _carry(jm, tm, keys)
    np.testing.assert_array_equal(tm.predict(X, fhe=mode), jm.predict(X, fhe=mode))


# -- serialization across packages ----------------------------------------------------


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", ["fc", "linear_regression", "neural_net", "decision_tree"])
def test_serialization_crosses_packages(module_pairs, model_pairs, data, name, direction):
    jm, tm = module_pairs[name][:2] if name in module_pairs else model_pairs[name]
    src_dumps, dst_loads, dst_dumps = (
        (jax_dumps, port_loads, port_dumps) if direction == "jax_to_port" else (port_dumps, jax_loads, jax_dumps)
    )
    blob = src_dumps(jm if direction == "jax_to_port" else tm)
    assert blob == (port_dumps(tm) if direction == "jax_to_port" else jax_dumps(jm))
    back = dst_loads(blob)
    assert type(back).__module__.startswith("tfhe_tpu_torch." if direction == "jax_to_port" else "tfhe_tpu.")
    # equal up to key order: loading rebuilds the n_bits dict through
    # get_n_bits_dict, which orders its keys anew in both packages
    assert json.loads(dst_dumps(back)) == json.loads(blob)
    if name in module_pairs:
        x = module_pairs[name][2]
        np.testing.assert_array_equal(back.forward(x, fhe="disable"), jm.forward(x, fhe="disable"))
    else:
        X = data[0][:16]
        np.testing.assert_array_equal(back.predict(X), jm.predict(X))


@pytest.mark.parametrize(
    "registry",
    ["get_sklearn_linear_models", "get_sklearn_tree_models", "get_sklearn_neural_net_models",
     "get_sklearn_neighbors_models", "get_sklearn_all_models"],
)
def test_model_registry_matches_reference(registry):
    names = [c.__name__ for c in getattr(tml, registry)()]
    assert names == [c.__name__ for c in getattr(jml, registry)()]
    assert all(c.__module__.startswith("tfhe_tpu_torch.ml.") for c in getattr(tml, registry)())
