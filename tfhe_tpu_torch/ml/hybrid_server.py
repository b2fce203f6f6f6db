"""Hybrid-model FHE serving: remote encrypted linear layers over HTTP
(counterpart of tfhe_tpu/ml/hybrid_server.py).

Analog of the reference's HybridFHEModelServer + RemoteModule transport
(reference: ml/concrete-ml/src/concrete/ml/torch/hybrid_model.py:821
FHEModelServer-backed per-(model, module) registry; :974 add_key ->
{"uid"}; :998 compute(model_input, uid, model_name, module_name);
:180-216 the client fetches the per-module client artifact with
/get_client, uploads its evaluation keys once, then POSTs encrypted
activations per forward). The FHE circuit per module is the deployment
triplet (ml/deploy.py): the server only ever sees the packing keyswitch
key and encrypted activations -- weights stay server-side, activations
stay encrypted.

Routes, JSON bodies, base64 blobs and the 400/404 rules are the JAX
package's, so either package's HTTPTransport talks to either server.
"""

from __future__ import annotations

import base64
import json
import pathlib
import shutil
import tempfile
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlencode, urlparse
from urllib.request import Request, urlopen

import numpy as np
import torch

from tfhe_tpu_torch import _device
from tfhe_tpu_torch.ml.deploy import ARTIFACT, FHEModelClient, FHEModelDev, FHEModelServer
from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor


def linear_executor(linear: torch.nn.Linear, params=None, n_bits: int = 8) -> GlweLinearLayerExecutor:
    """The encrypted executor of an nn.Linear's weights and bias."""
    return GlweLinearLayerExecutor(
        weights=linear.weight.detach().cpu().numpy().T,  # (in, out)
        bias=linear.bias.detach().cpu().numpy() if linear.bias is not None else None,
        n_bits_in=n_bits,
        n_bits_w=n_bits,
        params=params,
    )


class HybridFHEModelServer:
    """Per-(model_name, module_name) registry of deployed linear modules
    (reference hybrid_model.py:900: modules dict + key store). Each
    module's FHEModelServer runs on `device` (default "cuda")."""

    # uploaded evaluation keys are large: cap the store and evict the
    # oldest (clients re-upload transparently via add_key on a miss)
    MAX_KEYS = 256

    def __init__(self, device=None):
        self.device = _device.resolve(device)
        self.modules: dict[str, dict[str, dict[str, Any]]] = {}
        self.keys: dict[str, bytes] = {}
        self._lock = threading.Lock()  # the HTTP server calls add_key/compute from many threads

    def register(self, model_name: str, module_name: str, model, params=None) -> None:
        """Deploy one linear module (torch nn.Linear, a linear model holding
        `_executor`, or GlweLinearLayerExecutor) under (model_name,
        module_name). `params` picks the GLWE matmul parameter set for
        torch layers."""
        if isinstance(model, torch.nn.Linear):
            model = linear_executor(model, params)
        tmp = tempfile.mkdtemp(prefix="tfhe_hybrid_")
        FHEModelDev(tmp, model).save()
        old = self.modules.setdefault(model_name, {}).get(module_name)
        self.modules[model_name][module_name] = {"path": tmp, "server": FHEModelServer(tmp, device=self.device)}
        if old is not None:  # re-registration: reclaim the old artifacts
            shutil.rmtree(old["path"], ignore_errors=True)

    def _entry(self, model_name: str, module_name: str) -> dict:
        try:
            return self.modules[model_name][module_name]
        except KeyError:
            raise KeyError(
                f"unknown module {model_name}/{module_name}; registered: "
                f"{ {m: list(v) for m, v in self.modules.items()} }"
            ) from None

    def list_modules(self, model_name: str) -> list[str]:
        return sorted(self.modules.get(model_name, {}))

    def get_client(self, model_name: str, module_name: str) -> bytes:
        """The client artifact zip for one module (reference :953)."""
        return (pathlib.Path(self._entry(model_name, module_name)["path"]) / ARTIFACT).read_bytes()

    def add_key(self, key: bytes, model_name: str, module_name: str) -> dict:
        """Store evaluation keys, return their uid (reference :974-996)."""
        self._entry(model_name, module_name)
        uid = str(uuid.uuid4())
        with self._lock:
            while len(self.keys) >= self.MAX_KEYS:
                self.keys.pop(next(iter(self.keys)))  # FIFO eviction
            self.keys[uid] = key
        return {"uid": uid}

    def compute(self, model_input: bytes, uid: str, model_name: str, module_name: str) -> bytes:
        """Encrypted forward of one module (reference :998-1040)."""
        with self._lock:
            key = self.keys[uid]
        return self._entry(model_name, module_name)["server"].run(model_input, key)


class RemoteModule:
    """Client half of one remote FHE layer (reference hybrid_model.py:122
    RemoteModule): fetch the module's client artifact, generate keys
    locally on `device` (default "cuda"), upload evaluation keys once,
    then encrypt-compute-decrypt per forward."""

    def __init__(self, transport, model_name: str, module_name: str, key_seed: int = 0, device=None):
        self.transport = transport
        self.model_name = model_name
        self.module_name = module_name
        blob = transport.get_client(model_name, module_name)
        self._dir = tempfile.mkdtemp(prefix="tfhe_hybrid_client_")
        (pathlib.Path(self._dir) / ARTIFACT).write_bytes(blob)
        self.client = FHEModelClient(self._dir, key_seed=key_seed, device=device)
        self.uid = transport.add_key(self.client.get_serialized_evaluation_keys(), model_name, module_name)["uid"]

    def forward(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        shape = x.shape
        blob, ctx = self.client.quantize_encrypt_serialize(x.reshape(-1, shape[-1]))
        out_blob = self.transport.compute(blob, self.uid, self.model_name, self.module_name)
        y = self.client.deserialize_decrypt_dequantize(out_blob, ctx)
        return y.reshape(*shape[:-1], y.shape[-1])

    __call__ = forward


# -- HTTP wrapper --------------------------------------------------------------

_POST_FIELDS = {
    "/add_key": ("key", "model_name", "module_name"),
    "/compute": ("model_input", "uid", "model_name", "module_name"),
}


class _Handler(BaseHTTPRequestHandler):
    """The routes of HybridHTTPServer; the registry is `self.server.core`."""

    def log_message(self, *a):
        pass

    def _reply(self, code, payload: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _json(self, code, obj):
        self._reply(code, json.dumps(obj).encode())

    def do_GET(self):
        core = self.server.core
        u = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        try:
            if u.path == "/get_client":
                self._reply(200, core.get_client(q["model_name"], q["module_name"]), "application/octet-stream")
            elif u.path == "/list_modules":
                self._json(200, {"modules": core.list_modules(q["model_name"])})
            else:
                self._json(404, {"error": "not found"})
        except KeyError as e:
            self._json(404, {"error": str(e)})

    def do_POST(self):
        core = self.server.core
        # parse inside the handler: a malformed body must produce a 400
        # response, not an unanswered connection; a missing JSON field is a
        # 400, an unknown module/uid the 404
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n))
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:  # json.JSONDecodeError is a ValueError
            self._json(400, {"error": f"bad request: {e}"})
            return
        needed = _POST_FIELDS.get(self.path)
        if needed is None:
            self._json(404, {"error": "not found"})
            return
        missing = [k for k in needed if k not in body]
        if missing:
            self._json(400, {"error": f"missing fields: {missing}"})
            return
        try:
            if self.path == "/add_key":
                r = core.add_key(base64.b64decode(body["key"]), body["model_name"], body["module_name"])
                self._json(200, r)
            else:
                out = core.compute(
                    base64.b64decode(body["model_input"]), body["uid"], body["model_name"], body["module_name"]
                )
                self._json(200, {"result": base64.b64encode(out).decode()})
        except KeyError as e:
            self._json(404, {"error": str(e)})


class HybridHTTPServer:
    """The reference's FastAPI surface as a stdlib HTTP server (routes
    match hybrid_model.py's client calls: GET /get_client?model_name=..&
    module_name=.., GET /list_modules, POST /add_key, POST /compute)."""

    def __init__(self, server: HybridFHEModelServer, host="127.0.0.1", port=0):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.core = server
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


class HTTPTransport:
    """Client-side transport speaking HybridHTTPServer's routes (the
    reference RemoteModule uses requests against the FastAPI app)."""

    def __init__(self, base_url: str):
        self.base = base_url.rstrip("/")

    def _get(self, path: str) -> bytes:
        with urlopen(self.base + path) as r:
            return r.read()

    def _post(self, path: str, obj: dict) -> dict:
        req = Request(self.base + path, data=json.dumps(obj).encode(), headers={"Content-Type": "application/json"})
        with urlopen(req) as r:
            return json.loads(r.read())

    def get_client(self, model_name, module_name) -> bytes:
        return self._get("/get_client?" + urlencode({"model_name": model_name, "module_name": module_name}))

    def list_modules(self, model_name) -> list[str]:
        return json.loads(self._get("/list_modules?" + urlencode({"model_name": model_name})))["modules"]

    def add_key(self, key: bytes, model_name, module_name) -> dict:
        return self._post(
            "/add_key",
            {"key": base64.b64encode(key).decode(), "model_name": model_name, "module_name": module_name},
        )

    def compute(self, model_input: bytes, uid, model_name, module_name) -> bytes:
        r = self._post(
            "/compute",
            {
                "model_input": base64.b64encode(model_input).decode(),
                "uid": uid,
                "model_name": model_name,
                "module_name": module_name,
            },
        )
        return base64.b64decode(r["result"])
