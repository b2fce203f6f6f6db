"""parallel/multihost of tfhe_tpu_torch on the CPU (the port's counterpart
of tests/test_multihost.py).

One world of 4 ranks (gloo, spawned by tfhe_tpu_torch.parallel.launch,
one torch thread a rank) laid out as 2 hosts of 2 ranks runs the
multihost PBS step on a ("host", "data", "model") = (2, 1, 2) mesh and
the same step on the cross-host model mesh, each rank with the port's
own seed-51 TOY_SHORTINT keys (equal to the JAX package's seed-51 keys:
tests/test_torch_port_parallel.py). Every rank's rows decrypt to the LUT
and equal the single-process apply_lut; the recorder shows the model
all-reduces and no collective crossing a host on the host mesh, and every
all-reduce crossing on the cross-host one. The file takes no JAX keygen.
"""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch import _u64
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.parallel import launch, multihost as mh
from tfhe_tpu_torch.parallel.mesh import Mesh
from tfhe_tpu_torch.rng import FheRng

P = tp.TOY_SHORTINT
WORLD, PER_HOST = 4, 2
BATCH = 64  # 2 hosts x 32 rows, as the JAX dry run's 2 x (16 * n_data)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The port's seed-51 keys, 64 ciphertexts and the single-process
    apply_lut."""
    ck, sk = tsi.keygen(P, seed=51, device="cpu")
    vals = torch.arange(BATCH) % 4
    c = tsi.encrypt(ck, vals, FheRng(100, "cpu"))
    table = np.asarray([(v + 1) % 4 for v in range(16)], dtype=np.uint64)
    applied = tsi.apply_lut(sk, c, tsi.generate_lut(P, table, "cpu"), 3)
    return dict(ck=ck, sk=sk, vals=vals, cts=_u64.u64_to_numpy(c.ct), table=table,
                applied=_u64.u64_to_numpy(applied.ct))


@pytest.fixture(scope="module")
def world(ref):
    common = dict(params=P, seed=51, cts=ref["cts"], lut_table=ref["table"])
    jobs = [("pbs", dict(common, layout="host", n_model=2)), ("pbs", dict(common, layout="cross"))]
    return launch.launch(launch.run_jobs, WORLD, (jobs,), device="cpu", ranks_per_host=PER_HOST, timeout=300)


def test_every_rank_rows_decrypt(ref, world):
    """Every rank's output rows decrypt to the LUT and equal the single
    process's apply_lut; the rows of the 2 hosts cover the batch once."""
    verified = set()
    for r in world:
        a, b = r[0]["rows"]
        out = tsi.Ciphertext(ct=_u64.u64_from_numpy(r[0]["out"]), params=P, degree=3, noise_level=1)
        np.testing.assert_array_equal(tsi.decrypt(ref["ck"], out).numpy(), ref["table"][ref["vals"][a:b]])
        np.testing.assert_array_equal(r[0]["out"], ref["applied"][a:b])
        verified.update(range(a, b))
    assert verified == set(range(BATCH))


def test_host_mesh_layout(world):
    for rank, r in enumerate(world):
        res = r[0]
        assert res["shape"] == {"host": 2, "data": 1, "model": 2}
        assert res["coords"] == {"host": rank // PER_HOST, "data": 0, "model": rank % PER_HOST}
        assert res["host_of"] == (0, 0, 1, 1)
        assert res["lines"]["model"] == [rank - rank % PER_HOST + i for i in range(PER_HOST)]
        assert res["rows"] == ((rank // PER_HOST) * BATCH // 2, (rank // PER_HOST + 1) * BATCH // 2)


def test_no_per_step_collective_crosses_a_host(world):
    for r in world:
        stats = r[0]["stats"]
        assert [s for s in stats if s["crosses_host"]] == []
        assert sum(s["bytes"] * s["count"] for s in stats if s["crosses_host"]) == 0
        # the model-axis all-reduces are there (the intra-host reductions)
        assert {s["op"] for s in stats} == {"all-reduce"}
        assert sorted(s["count"] for s in stats) == [1, P.lwe_dimension]


def test_cross_host_model_mesh_crosses(ref, world):
    for rank, r in enumerate(world):
        res = r[1]
        assert res["shape"] == {"data": 2, "model": 2}
        assert res["lines"]["model"] == [rank % PER_HOST, rank % PER_HOST + PER_HOST]
        assert res["stats"] and all(s["crosses_host"] for s in res["stats"])
        a, b = res["rows"]
        np.testing.assert_array_equal(res["out"], ref["applied"][a:b])


def _hand_mesh(host_of, rank=1):
    grid = np.arange(4).reshape(2, 1, 2)
    at = {0: (0, 0, 0), 1: (0, 0, 1), 2: (1, 0, 0), 3: (1, 0, 1)}[rank]
    return Mesh(grid=grid, axis_names=("host", "data", "model"), rank=rank, device=torch.device("cpu"),
                coords=dict(zip(("host", "data", "model"), at)), groups={}, host_of=host_of)


def test_collective_stats_reads_bytes_and_hosts():
    """Unit: the recorder counts payload bytes and calls; collective_stats
    says whether a group spans hosts."""
    mesh = _hand_mesh((0, 0, 1, 1))
    x = torch.zeros((2, 3, 128), dtype=torch.int32)
    for _ in range(3):
        with mesh.recorder.record("all-reduce", x, [0, 1], False):
            pass
    with mesh.recorder.record("collective-permute", x.to(torch.int64), [1, 3], True):
        pass
    stats = mh.collective_stats(mesh)
    assert stats[0] == dict(op="all-reduce", bytes=2 * 3 * 128 * 4, replica_groups=[[0, 1]], crosses_host=False,
                            count=3, staged=False, seconds=0.0)
    assert stats[1]["bytes"] == 2 * 3 * 128 * 8 and stats[1]["crosses_host"] and stats[1]["staged"]
    mesh.recorder.reset()
    assert mh.collective_stats(mesh) == []


def test_global_placement_is_a_local_slice():
    mesh = _hand_mesh((0, 0, 1, 1), rank=3)
    x = np.arange(8 * 3, dtype=np.int64).reshape(8, 3)
    np.testing.assert_array_equal(mh.global_put(mesh, (("host", "data"), None), x).numpy(), x[4:])
    np.testing.assert_array_equal(mh.global_put(mesh, (None, None), x).numpy(), x)
    np.testing.assert_array_equal(mh.replicate_batch_global(mesh, x).numpy(), x)  # data axis of 1
    np.testing.assert_array_equal(mh.shard_batch_global(mesh, x[4:]).numpy(), x[4:])
    keys = mh.replicate_global(mesh, {"a": x, "b": (x[:2], x[2:4])})
    assert torch.equal(keys["b"][1], torch.as_tensor(x[2:4])) and keys["a"].shape == (8, 3)


def test_a_failing_rank_raises_in_the_parent(ref):
    """No fallback: a job that fails on its rank (a 2 x 1 mesh asked of a
    world of 1) raises in the parent with the rank's traceback, and the
    launcher leaves no rank running."""
    jobs = [("pbs", dict(params=P, seed=51, cts=ref["cts"], lut_table=ref["table"], n_data=2, n_model=1))]
    with pytest.raises(RuntimeError, match="needs more than 1 ranks"):
        launch.launch(launch.run_jobs, 1, (jobs,), device="cpu", timeout=120)
