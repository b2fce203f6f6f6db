"""The deployment side of tfhe_tpu_torch.ml against the JAX package, on the CPU.

One JAX matmul keygen at TOY_MATMUL (N = 256), carried to the port; both
packages' FHEModelClient take it by patching their glwe_matmul
create_private_key:
* deploy: the artifacts of either package read in the other; the
  evaluation-key blob is byte-equal; exactly one JAX FHEModelServer.run,
  on the port client's blob, gives the port server's result bytes; each
  client decrypts them to equal arrays; a JAX client blob runs on the
  port's server;
* hybrid_server: the port's HybridHTTPServer answers the JAX package's
  HTTPTransport (list, artifact, a remote forward, 404 and 400 cases, key
  isolation); add_key's FIFO eviction holds under concurrent uploads;
* hybrid: HybridFHEModel's DISABLE equals JAX's, its EXECUTE its DISABLE;
* lora: the same torch seed gives the same adapters; two DISABLE steps
  give JAX's losses and adapters; an EXECUTE step equals a DISABLE step;
* profiling: pbs_speed_of_light's counts and Timings' report keys equal
  JAX's; device_trace writes a Chrome trace.
"""

import copy
import json
import sys
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.ml import deploy as jdeploy
from tfhe_tpu.ml import lora as jlora
from tfhe_tpu.ml.hybrid import HybridFHEModel as JaxHybrid
from tfhe_tpu.ml.hybrid_server import HTTPTransport as JaxTransport
from tfhe_tpu.ml.linear import GlweLinearLayerExecutor as JaxExecutor
from tfhe_tpu.models import glwe_matmul as jgm
from tfhe_tpu.utils import profiling as jprof
from tfhe_tpu_torch import convert
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.ml import deploy as tdeploy
from tfhe_tpu_torch.ml import lora as tlora
from tfhe_tpu_torch.ml.hybrid import HybridFHEModel, RemoteHybridModel, serve_hybrid_model
from tfhe_tpu_torch.ml.hybrid_server import HybridFHEModelServer, HybridHTTPServer
from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor
from tfhe_tpu_torch.models import glwe_matmul as tgm
from tfhe_tpu_torch.utils import profiling as tprof


PORT_CREATE_PRIVATE_KEY = tgm.create_private_key  # before any fixture patches it


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


@pytest.fixture(scope="module")
def carried_keygen(keys):
    """Both packages' create_private_key hand out the carried key pair
    while the fixture stands."""
    pk, tkey = keys
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgm, "create_private_key", lambda *a, **k: pk)
        mp.setattr(tgm, "create_private_key", lambda *a, **k: tkey)
        yield


# -- deploy ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def triplet(tmp_path_factory, carried_keygen):
    """One linear layer (16 -> 2, with bias) deployed by both packages, the
    clients on the carried key, and the one JAX server run on the port
    client's blob."""
    rs = np.random.RandomState(5)
    w = rs.uniform(-1, 1, size=(16, 2))
    b = np.array([0.5, -0.5])
    x = rs.uniform(0, 1, size=(2, 16))
    jdir, tdir = tmp_path_factory.mktemp("jax_artifact"), tmp_path_factory.mktemp("port_artifact")
    jdeploy.FHEModelDev(jdir, JaxExecutor(weights=w, bias=b, params=jp.TOY_MATMUL)).save()
    ex = GlweLinearLayerExecutor(weights=w, bias=b, params=tp.TOY_MATMUL)
    tdeploy.FHEModelDev(tdir, ex).save()
    jclient = jdeploy.FHEModelClient(jdir, key_seed=7)
    tclient = tdeploy.FHEModelClient(tdir, key_seed=7, device="cpu")
    blob, ctx = tclient.quantize_encrypt_serialize(x)
    evk = tclient.get_serialized_evaluation_keys()
    jax_result = jdeploy.FHEModelServer(jdir).run(blob, evk)
    return dict(jdir=jdir, tdir=tdir, x=x, ex=ex, jclient=jclient, tclient=tclient, blob=blob, ctx=ctx, evk=evk,
                jax_result=jax_result)


def test_artifacts_read_each_other(triplet):
    with zipfile.ZipFile(triplet["jdir"] / tdeploy.ARTIFACT) as a, zipfile.ZipFile(
        triplet["tdir"] / tdeploy.ARTIFACT
    ) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    for path in (triplet["jdir"], triplet["tdir"]):
        jmeta, jw, jb, jparams = jdeploy._load(path)
        tmeta, tw, tb, tparams = tdeploy._load(path)
        assert tmeta == jmeta and tparams.name == jparams.name == "TOY_MATMUL"
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tb, jb)


def test_evaluation_key_bytes_equal(triplet):
    assert triplet["evk"] == triplet["jclient"].get_serialized_evaluation_keys()


def test_server_run_bytes_equal(triplet):
    t = triplet
    port_result = tdeploy.FHEModelServer(t["tdir"], device="cpu").run(t["blob"], t["evk"])
    assert port_result == t["jax_result"]
    y_port = t["tclient"].deserialize_decrypt_dequantize(port_result, t["ctx"])
    y_jax = t["jclient"].deserialize_decrypt_dequantize(t["jax_result"], t["ctx"])
    np.testing.assert_array_equal(y_port, y_jax)
    np.testing.assert_allclose(y_port, t["ex"].forward(t["x"], fhe="disable"), atol=1e-9)


def test_jax_client_blob_runs_on_port_server(triplet):
    """A JAX client's blob and key on the port's server, loaded from the
    JAX package's artifact."""
    t = triplet
    blob, ctx = t["jclient"].quantize_encrypt_serialize(t["x"])
    assert ctx == t["ctx"]
    res = tdeploy.FHEModelServer(t["jdir"], device="cpu").run(blob, t["jclient"].get_serialized_evaluation_keys())
    y_jax = t["jclient"].deserialize_decrypt_dequantize(res, ctx)
    np.testing.assert_array_equal(t["tclient"].deserialize_decrypt_dequantize(res, ctx), y_jax)
    np.testing.assert_allclose(y_jax, t["ex"].forward(t["x"], fhe="disable"), atol=1e-9)


def test_server_rejects_a_blob_of_another_class(triplet):
    t = triplet
    with pytest.raises(ValueError, match="EncryptedMatrix"):
        tdeploy.FHEModelServer(t["tdir"], device="cpu").run(t["evk"], t["evk"])


def test_entry_points_need_a_device_when_no_cuda(triplet, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    monkeypatch.setattr(tgm, "create_private_key", PORT_CREATE_PRIVATE_KEY)
    for make in (
        lambda: tdeploy.FHEModelClient(triplet["tdir"]),
        lambda: tdeploy.FHEModelServer(triplet["tdir"]),
        lambda: HybridFHEModelServer(),
        lambda: HybridFHEModel(_hybrid_net(), ["0"], params=tp.TOY_MATMUL).compile(),
        lambda: tlora.LoraTraining(_hybrid_net(), target_modules=["2"], params=tp.TOY_MATMUL).compile(),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# -- hybrid_server over HTTP -----------------------------------------------------


def _tiny_net():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4)).eval()


@pytest.fixture(scope="module")
def http_stack():
    """The port's server on the CPU, served over HTTP, and the JAX
    package's transport to it."""
    core = HybridFHEModelServer(device="cpu")
    serve_hybrid_model(_tiny_net(), ["0", "2"], "tiny", core, params=tp.TOY_MATMUL)
    httpd = HybridHTTPServer(core).start()
    yield core, JaxTransport(f"http://127.0.0.1:{httpd.port}"), httpd.port
    httpd.stop()


def test_http_list_and_artifact(http_stack):
    _, transport, _ = http_stack
    assert transport.list_modules("tiny") == ["0", "2"]
    blob = transport.get_client("tiny", "0")
    assert blob[:2] == b"PK"  # the deployment artifact zip


@pytest.fixture(scope="module")
def remote(http_stack):
    """A port client over the JAX transport; its local layers 0 and 2 are
    discarded."""
    _, transport, _ = http_stack
    client_net = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    return RemoteHybridModel(client_net, ["0", "2"], "tiny", transport, device="cpu")


def _x_remote():
    return torch.tensor(np.random.default_rng(3).normal(0, 1, (5, 6)), dtype=torch.float32)


def test_http_remote_forward_matches_local(remote):
    """A remote forward over the JAX transport: within the quantization
    error of the float net, and equal to the in-process DISABLE forward."""
    x = _x_remote()
    net = _tiny_net()
    want = net(x).detach().numpy()
    got = remote(x)
    assert got.dtype == x.dtype and got.shape == (5, 4)
    scale = np.abs(want).max() or 1.0
    assert np.abs(got.numpy() - want).max() / scale < 0.25
    local = HybridFHEModel(net, ["0", "2"], params=tp.TOY_MATMUL)(x, fhe="disable")
    np.testing.assert_allclose(got.numpy(), local.numpy(), atol=1e-5)


def test_remote_forward_transform_calls(remote, monkeypatch):
    """A remote forward calls the engine's forward transforms (K1 on the
    card) 7 times and its inverse (K2) 4 times per remote layer: encrypt,
    prepare the weights, matmul with its packing keyswitch, decrypt.
    chip_smoke.py's hybrid launch counts read the same."""
    from tfhe_tpu_torch.ops.folded_ntt import FoldedCrtEngine

    calls = {"forward": 0, "inverse": 0}
    for name, kind in (("forward_small", "forward"), ("forward_u64", "forward"), ("backward", "inverse")):
        def counted(self, *a, _orig=getattr(FoldedCrtEngine, name), _kind=kind, **kw):
            calls[_kind] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(FoldedCrtEngine, name, counted)
    remote(_x_remote())
    assert calls == {"forward": 2 * 7, "inverse": 2 * 4}


def test_http_unknown_module_404(http_stack):
    _, transport, _ = http_stack
    with pytest.raises(urllib.error.HTTPError) as e:
        transport.get_client("tiny", "nope")
    assert e.value.code == 404


def _post(port, path, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_bad_requests(http_stack):
    """A malformed body or a missing field is a 400; an unknown route, an
    unknown uid or an unknown module is a 404."""
    _, _, port = http_stack
    assert _post(port, "/compute", b"{not json")[0] == 400
    assert _post(port, "/compute", b"[1, 2]")[0] == 400
    code, body = _post(port, "/compute", json.dumps({"uid": "u"}).encode())
    assert code == 400 and "missing fields" in body["error"]
    assert _post(port, "/nowhere", b"{}")[0] == 404
    fields = {"model_input": "", "uid": "no-such-uid", "model_name": "tiny", "module_name": "0"}
    assert _post(port, "/compute", json.dumps(fields).encode())[0] == 404
    fields = {"key": "", "model_name": "tiny", "module_name": "nope"}
    assert _post(port, "/add_key", json.dumps(fields).encode())[0] == 404


def test_key_isolation(http_stack):
    """compute with a never-registered uid fails (no key on the server)."""
    core, _, _ = http_stack
    with pytest.raises(KeyError):
        core.compute(b"x", "no-such-uid", "tiny", "0")


def test_add_key_fifo_eviction_under_concurrent_uploads():
    """Many threads upload at once: the store ends at MAX_KEYS keys, each
    one uploaded."""
    core = HybridFHEModelServer(device="cpu")
    core.register("tiny", "0", _tiny_net()[0], params=tp.TOY_MATMUL)
    core.MAX_KEYS = 8
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    uids = []
    try:
        def upload(i):
            for j in range(25):
                uids.append(core.add_key(b"%d" % (100 * i + j), "tiny", "0")["uid"])

        threads = [threading.Thread(target=upload, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(uids) == 400
    assert len(core.keys) == 8 and set(core.keys) <= set(uids)


# -- HybridFHEModel --------------------------------------------------------------


def _hybrid_net():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(), torch.nn.Linear(32, 4))


def test_hybrid_disable_matches_reference():
    x = torch.rand(5, 16, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    want = JaxHybrid(_hybrid_net(), ["0", "2"], params=jp.TOY_MATMUL)(x, fhe="disable")
    got = HybridFHEModel(_hybrid_net(), ["0", "2"], params=tp.TOY_MATMUL)(x, fhe="disable")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9)


def test_hybrid_execute_matches_disable():
    hybrid = HybridFHEModel(_hybrid_net(), ["0", "2"], params=tp.TOY_MATMUL).compile(seed=3, device="cpu")
    x = torch.rand(2, 16, generator=torch.Generator().manual_seed(2))
    y0 = hybrid(x, fhe="disable")
    y1 = hybrid(x, fhe="execute")
    assert y1.dtype == x.dtype and y1.device == x.device
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), atol=1e-5)


# -- LoRA ------------------------------------------------------------------------


def _lora_pair():
    """The JAX and the port LoraTraining on copies of one net, each built
    right after torch.manual_seed(11)."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 6), torch.nn.ReLU(), torch.nn.Linear(6, 3))
    torch.manual_seed(11)
    jlt = jlora.LoraTraining(copy.deepcopy(net), rank=2, target_modules=["0", "2"], params=jp.TOY_MATMUL)
    torch.manual_seed(11)
    tlt = tlora.LoraTraining(copy.deepcopy(net), rank=2, target_modules=["0", "2"], params=tp.TOY_MATMUL)
    return jlt, tlt


def _lora_data():
    g = torch.Generator().manual_seed(4)
    return [(torch.rand(4, 8, generator=g), torch.rand(4, 3, generator=g)) for _ in range(2)]


def _adapters(lt):
    return [p.detach().numpy().copy() for p in lt.trainable_parameters()]


def test_lora_adapters_equal_from_seed():
    jlt, tlt = _lora_pair()
    for a, b in zip(_adapters(jlt), _adapters(tlt), strict=True):
        np.testing.assert_array_equal(b, a)


def test_lora_disable_steps_match_reference():
    jlt, tlt = _lora_pair()
    data = _lora_data()
    jloss = jlora.LoraTrainer(jlt, lr=1e-2).train(data, epochs=1)
    tloss = tlora.LoraTrainer(tlt, lr=1e-2).train(data, epochs=1)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    for a, b in zip(_adapters(jlt), _adapters(tlt), strict=True):
        np.testing.assert_allclose(b, a, rtol=1e-6)
    assert any(np.abs(b).max() > 0 for b in _adapters(tlt)[1::2])  # lora_b moved off zero


def test_lora_execute_step_matches_disable():
    _, disable = _lora_pair()
    _, execute = _lora_pair()
    execute.compile(seed=5, device="cpu")
    data = _lora_data()[:1]
    loss_d = tlora.LoraTrainer(disable).train(data, fhe="disable")
    loss_e = tlora.LoraTrainer(execute).train(data, fhe="execute")
    np.testing.assert_allclose(loss_e, loss_d, rtol=1e-5)
    for a, b in zip(_adapters(disable), _adapters(execute), strict=True):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


# -- profiling -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["TOY_SHORTINT", "PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
                                  "PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128"])
def test_pbs_speed_of_light_matches_reference(name):
    want = jprof.pbs_speed_of_light(jp.by_name(name))
    got = tprof.pbs_speed_of_light(tp.by_name(name))
    for k in ("ntts", "butterfly_mults", "pointwise_macs", "bsk_bytes_per_pbs"):
        assert got[k] == want[k], k
    assert got["hbm_bound_pbs_per_s_at_3350GBps"] == round(3.35e12 / want["bsk_bytes_per_pbs"], 1)


def test_timings_report_keys_match_reference():
    called = []
    reports = []
    for t, sync in ((jprof.Timings(), None), (tprof.Timings(), lambda: called.append(1) or torch.zeros(2))):
        for _ in range(2):
            with t.section("encrypt", sync=sync):
                pass
        with t.section("decrypt"):
            pass
        reports.append(t.report())
        assert json.loads(t.dump()) == reports[-1]
    assert called == [1, 1]
    assert reports[1].keys() == reports[0].keys() == {"encrypt", "decrypt"}
    for name in ("encrypt", "decrypt"):
        assert reports[1][name].keys() == reports[0][name].keys()
        assert reports[1][name]["count"] == reports[0][name]["count"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """Every thread is recorded: a span entered on a second thread, after
    its request began, is in the trace with that request's id, beside the
    calling thread's ops."""

    def serve():
        tprof.new_request()
        with tprof.span("api.device_trace_test"):
            torch.ones(8, 8) @ torch.ones(8, 8)

    with tprof.device_trace(str(tmp_path / "trace")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
        t = threading.Thread(target=serve)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (ev,) = [e for e in events if e.get("name") == "api.device_trace_test"]
    (mark,) = [e for e in events if e.get("name", "").startswith(tprof.REQUEST_MARK) and e["tid"] == ev["tid"]]
    assert ev["args"]["request"] == mark["name"][len(tprof.REQUEST_MARK):]
    assert ev["tid"] != threading.get_native_id()
    assert any(e.get("name") == "aten::mm" and e.get("tid") == threading.get_native_id() for e in events)
