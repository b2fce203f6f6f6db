"""Deployment triplet: model packaging, client-side crypto, server-side run
(counterpart of tfhe_tpu/ml/deploy.py).

Analog of the reference's FHEModelDev / FHEModelClient / FHEModelServer
(reference: ml/concrete-ml/src/concrete/ml/deployment/fhe_client_server.py
:110,239,368 -- dev saves a zip of circuit + quantizers; client does keygen,
quantize_encrypt_serialize:491 and deserialize_decrypt_dequantize:578;
server loads the artifact and run():157 executes on serialized inputs plus
serialized evaluation keys).

Artifact layout (zip): model.json (quantizers + params + meta),
weights.npy (quantized weights), bias.npy -- the JAX package's, so either
package reads the other's artifacts. Blobs are utils/serialization bytes,
the JAX package's wire format.

As in the JAX package, the client encrypts every input under the matmul's
default seed (encrypt_matrix's seed=1), and the server deserializes the
evaluation key on every run.
"""

from __future__ import annotations

import io
import json
import pathlib
import types
import zipfile

import numpy as np

from tfhe_tpu_torch import _device
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.core.packing import PackingKeyswitchKey
from tfhe_tpu_torch.ml.quantization import UniformQuantizer
from tfhe_tpu_torch.models import glwe_matmul as gm
from tfhe_tpu_torch.utils import serialization

ARTIFACT = "model.zip"


class FHEModelDev:
    """Package a fitted linear executor for deployment."""

    def __init__(self, path: str, model):
        self.path = pathlib.Path(path)
        self.model = model  # a linear model holding `_executor`, or a GlweLinearLayerExecutor

    def save(self):
        ex = getattr(self.model, "_executor", None) or self.model
        self.path.mkdir(parents=True, exist_ok=True)
        meta = {
            "params": ex.params.to_json(),
            "params_name": ex.params.name,
            "n_bits_in": ex.n_bits_in,
            "w_quant": ex.w_quant.to_dict(),
            "has_bias": ex.bias is not None,
        }
        with zipfile.ZipFile(self.path / ARTIFACT, "w") as z:
            z.writestr("model.json", json.dumps(meta))
            buf = io.BytesIO()
            np.save(buf, ex.w_q)
            z.writestr("weights.npy", buf.getvalue())
            if ex.bias is not None:
                buf = io.BytesIO()
                np.save(buf, np.asarray(ex.bias, np.float64))
                z.writestr("bias.npy", buf.getvalue())


def _load(path) -> tuple:
    with zipfile.ZipFile(pathlib.Path(path) / ARTIFACT) as z:
        meta = json.loads(z.read("model.json"))
        w_q = np.load(io.BytesIO(z.read("weights.npy")))
        bias = np.load(io.BytesIO(z.read("bias.npy"))) if meta["has_bias"] else None
    return meta, w_q, bias, tp.by_name(meta["params_name"])


class FHEModelClient:
    """Key generation, input encryption, output decryption. The matmul
    private key lives on `device` (default "cuda")."""

    def __init__(self, path: str, key_seed: int = 0, device=None):
        self.meta, self.w_q, self.bias, self.params = _load(path)
        self._pkey = gm.create_private_key(self.params, seed=key_seed, device=device)
        self.w_quant = UniformQuantizer.from_dict(self.meta["w_quant"])

    def get_serialized_evaluation_keys(self) -> bytes:
        """The packing keyswitch key: all the server needs."""
        return serialization.serialize(self._pkey.pksk)

    def quantize_encrypt_serialize(self, x: np.ndarray) -> tuple[bytes, dict]:
        xq = UniformQuantizer(self.meta["n_bits_in"], is_signed=False).fit(x)
        x_q = xq.quant(np.asarray(x, np.float64))
        enc = gm.encrypt_matrix(self._pkey, x_q.astype(np.uint64))
        ctx = {"scale": float(xq.scale), "zero_point": float(xq.zero_point)}
        return serialization.serialize(enc), ctx

    def deserialize_decrypt_dequantize(self, blob: bytes, ctx: dict) -> np.ndarray:
        res = serialization.deserialize(blob, device=self._pkey.device)
        acc = gm.decrypt_matrix(res, self._pkey).cpu().numpy().astype(np.float64)
        w_col = self.w_q.sum(axis=0).astype(np.float64)
        acc = acc - ctx["zero_point"] * w_col
        y = acc * ctx["scale"] * np.asarray(self.w_quant.scale, np.float64)
        if self.bias is not None:
            y = y + self.bias
        return y


class FHEModelServer:
    """Stateless encrypted inference on serialized inputs, on `device`
    (default "cuda")."""

    def __init__(self, path: str, device=None):
        self.meta, self.w_q, self.bias, self.params = _load(path)
        self.device = _device.resolve(device)

    def run(self, serialized_input: bytes, serialized_evaluation_keys: bytes) -> bytes:
        enc = serialization.deserialize(serialized_input, device=self.device)
        pksk = serialization.deserialize(serialized_evaluation_keys, device=self.device)
        if not isinstance(enc, gm.EncryptedMatrix) or not isinstance(pksk, PackingKeyswitchKey):
            raise serialization.SerializationError("run: expected an EncryptedMatrix and a PackingKeyswitchKey")
        # server-side key view: only the public packing key, no secrets
        view = types.SimpleNamespace(pksk=pksk)
        return serialization.serialize(gm.matrix_multiplication(enc, self.w_q, view))
