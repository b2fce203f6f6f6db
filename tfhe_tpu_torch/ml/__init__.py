"""ML layers over the port's encrypted primitives (counterpart of
tfhe_tpu/ml/): quantization, the GLWE linear executor, the quantized
module and op graph (torch, ONNX and QAT import), the full-FHE
FheSequential, serialization, the sklearn-style model zoo, and the
deployment side: the deploy triplet, hybrid models served over HTTP,
LoRA on FHE base layers, encrypted dataframes and the p_error search.
scikit-learn is imported only where a model is fit on it, pandas only
where a frame is decrypted to one."""

from tfhe_tpu_torch.ml.quantization import QuantizedArray, UniformQuantizer, get_n_bits_dict
from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor
from tfhe_tpu_torch.ml.serialization import dump, dumps, load, loads
from tfhe_tpu_torch.ml.quantized_module import (
    QuantizedModule,
    QuantizedGemm,
    QuantizedConv,
    QuantizedTLU,
    compile_torch_model,
    compile_onnx_model,
    compile_brevitas_qat_model,
)
from tfhe_tpu_torch.ml.fhe_pipeline import (
    AccumulatorOverflow,
    FheConv2d,
    FheLinear,
    FheSequential,
    FheTensor,
    FheTlu,
    conv2d_as_linear,
)
from tfhe_tpu_torch.ml.qat_fhe import onnx_qat_to_fhe, run_qat_fhe
from tfhe_tpu_torch.ml.sklearn import (
    ElasticNet,
    Lasso,
    LinearRegression,
    LogisticRegression,
    Ridge,
    SGDRegressor,
)
from tfhe_tpu_torch.ml.tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
    XGBClassifier,
    XGBRegressor,
)
from tfhe_tpu_torch.ml.zoo import (
    GammaRegressor,
    KNeighborsClassifier,
    LinearSVC,
    LinearSVR,
    NeuralNetClassifier,
    NeuralNetRegressor,
    PoissonRegressor,
    SGDClassifier,
    TweedieRegressor,
)
from tfhe_tpu_torch.ml.hybrid import (
    HybridFHEModel,
    RemoteHybridModel,
    serve_hybrid_model,
)
from tfhe_tpu_torch.ml.hybrid_server import (
    HTTPTransport,
    HybridFHEModelServer,
    HybridHTTPServer,
)
from tfhe_tpu_torch.ml.torch_export import (
    compile_torch_model_via_onnx,
    export_onnx_bytes,
)


# -- model registry (reference sklearn/__init__.py get_sklearn_models etc.) ----

_LINEAR_MODELS = [
    ElasticNet, Lasso, LinearRegression, LogisticRegression, Ridge,
    SGDClassifier, SGDRegressor, LinearSVC, LinearSVR,
    GammaRegressor, PoissonRegressor, TweedieRegressor,
]
_TREE_MODELS = [
    DecisionTreeClassifier, DecisionTreeRegressor,
    RandomForestClassifier, RandomForestRegressor,
    XGBClassifier, XGBRegressor,
]
_NEURALNET_MODELS = [NeuralNetClassifier, NeuralNetRegressor]
_NEIGHBOR_MODELS = [KNeighborsClassifier]


def get_sklearn_linear_models() -> list:
    """reference sklearn/__init__.py:124"""
    return sorted(_LINEAR_MODELS, key=lambda c: c.__name__)


def get_sklearn_tree_models() -> list:
    """reference sklearn/__init__.py:156"""
    return sorted(_TREE_MODELS, key=lambda c: c.__name__)


def get_sklearn_neural_net_models() -> list:
    """reference sklearn/__init__.py:181"""
    return sorted(_NEURALNET_MODELS, key=lambda c: c.__name__)


def get_sklearn_neighbors_models() -> list:
    """reference sklearn/__init__.py:213"""
    return sorted(_NEIGHBOR_MODELS, key=lambda c: c.__name__)


def get_sklearn_all_models() -> list:
    """reference sklearn/__init__.py:245"""
    return sorted(
        _LINEAR_MODELS + _TREE_MODELS + _NEURALNET_MODELS + _NEIGHBOR_MODELS,
        key=lambda c: c.__name__,
    )
