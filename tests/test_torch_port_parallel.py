"""parallel/mesh and parallel/sharded of tfhe_tpu_torch against the JAX
package, on the CPU.

One world of 4 ranks (gloo, spawned by tfhe_tpu_torch.parallel.launch,
one torch thread a rank) runs the sharded PBS step at (data, model) =
(4, 1), (2, 2) and (1, 4) on its shards of 32 ciphertexts, each rank with
the port's own seed-51 TOY_SHORTINT keys, which equal the JAX package's
seed-51 keys carried across. The gathered outputs equal, bit for bit, JAX's
make_sharded_pbs_step on the 8-device virtual mesh of tests/conftest.py at
the same layout and JAX's apply_lut, and decrypt to the LUT. The ranks
report their mesh's grid, groups and collectives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu import parallel as jpar
from tfhe_tpu.models import shortint as jsi
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu_torch import _u64, convert, parallel
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.parallel import launch, mesh as tmesh

LAYOUTS = [(4, 1), (2, 2), (1, 4)]
WORLD = 4
BATCH = 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """JAX seed-51 keys, 32 ciphertexts, a LUT and JAX's apply_lut."""
    params = jp.TOY_SHORTINT
    ck, sk = jsi.keygen(params, seed=51)
    vals = np.arange(16).repeat(2)
    c = jsi.encrypt(ck, jnp.asarray(vals, dtype=jnp.uint64), JaxRng(61))
    table = np.asarray([(5 * v + 3) % 16 for v in range(16)], dtype=np.uint64)
    lut = jsi.generate_lut(params, table)
    applied = np.asarray(jsi.apply_lut(sk, c, lut, out_degree=15).ct)
    return dict(ck=ck, sk=sk, vals=vals, cts=np.asarray(c.ct), table=table, lut=lut, applied=applied)


@pytest.fixture(scope="module")
def world(ref):
    jobs = [("pbs", dict(params=tp.TOY_SHORTINT, seed=51, cts=ref["cts"], lut_table=ref["table"],
                         n_data=d, n_model=m)) for d, m in LAYOUTS]
    return launch.launch(launch.run_jobs, WORLD, (jobs,), device="cpu", timeout=300)


def _gathered(world, j):
    out = np.zeros((BATCH, world[0][j]["out"].shape[-1]), dtype=np.uint64)
    for r in world:
        a, b = r[j]["rows"]
        out[a:b] = r[j]["out"]
    return out


def test_port_keygen_equals_the_reference(ref):
    tck, tsk = convert.keys_from_reference(ref["ck"], ref["sk"], device="cpu")
    ck, sk = tsi.keygen(tp.TOY_SHORTINT, seed=51, device="cpu")
    assert torch.equal(ck.glwe_key.key, tck.glwe_key.key) and torch.equal(ck.lwe_key.key, tck.lwe_key.key)
    assert torch.equal(sk.bsk.bsk_ntt, tsk.bsk.bsk_ntt) and sk.bsk.shift == tsk.bsk.shift
    assert torch.equal(sk.ksk.ksk, tsk.ksk.ksk)


@pytest.mark.parametrize("j", range(len(LAYOUTS)), ids=[f"{d}x{m}" for d, m in LAYOUTS])
def test_sharded_pbs_bit_exact(ref, world, j):
    n_data, n_model = LAYOUTS[j]
    got = _gathered(world, j)
    np.testing.assert_array_equal(got, ref["applied"])
    mesh = jpar.make_mesh(n_data=n_data, n_model=n_model)
    step = jpar.make_sharded_pbs_step(mesh, jsi.engine_for(jp.TOY_SHORTINT), jp.TOY_SHORTINT.ks,
                                      jp.TOY_SHORTINT.pbs, bsk_shift=ref["sk"].bsk.shift)
    want = np.asarray(step(jnp.asarray(ref["cts"]), ref["lut"], ref["sk"].bsk.bsk_ntt, ref["sk"].ksk.ksk))
    np.testing.assert_array_equal(got, want)
    tck, _ = convert.keys_from_reference(ref["ck"], ref["sk"], device="cpu")
    dec = tsi.decrypt(tck, tsi.Ciphertext(ct=_u64.u64_from_numpy(got), params=tp.TOY_SHORTINT, degree=15,
                                          noise_level=1))
    np.testing.assert_array_equal(dec.numpy(), ref["table"][ref["vals"]].astype(np.int64))


@pytest.mark.parametrize("j", range(len(LAYOUTS)), ids=[f"{d}x{m}" for d, m in LAYOUTS])
def test_sharded_pbs_collectives(world, j):
    """One all-reduce for the keyswitch and one per rotation step, over
    this rank's model group, of the sizes the shards give; nothing staged
    (gloo on the CPU takes every op)."""
    p = tp.TOY_SHORTINT
    n_data, n_model = LAYOUTS[j]
    b_loc = BATCH // n_data
    for r in world:
        res = r[j]
        stats = {s["count"]: s for s in res["stats"]}
        assert sorted(stats) == [1, p.lwe_dimension]
        ks, step = stats[1], stats[p.lwe_dimension]
        assert ks["op"] == step["op"] == "all-reduce"
        assert ks["bytes"] == b_loc * (p.lwe_dimension + 1) * 8
        assert step["bytes"] == b_loc * (p.glwe_dimension + 1) * 3 * p.polynomial_size * 4
        assert ks["replica_groups"] == step["replica_groups"] == [res["lines"]["model"]]
        assert not ks["staged"] and not ks["crosses_host"]


def test_make_mesh_grid_and_groups(world):
    for rank, results in enumerate(world):
        for (n_data, n_model), res in zip(LAYOUTS, results):
            d, m = res["coords"]["data"], res["coords"]["model"]
            assert res["shape"] == {"data": n_data, "model": n_model}
            assert rank == d * n_model + m
            assert res["lines"]["model"] == [d * n_model + i for i in range(n_model)]
            assert res["lines"]["data"] == [i * n_model + m for i in range(n_data)]
            assert res["rows"] == (d * BATCH // n_data, (d + 1) * BATCH // n_data)


def test_mesh_blocks_without_a_world():
    """A Mesh's shard arithmetic alone: lines, row-major blocks over
    several axes, and a ragged split refused."""
    grid = np.arange(8).reshape(2, 2, 2)
    m = tmesh.Mesh(grid=grid, axis_names=("host", "data", "model"), rank=6, device=torch.device("cpu"),
                   coords={"host": 1, "data": 1, "model": 0}, groups={}, host_of=(0,) * 4 + (1,) * 4)
    assert m.line("model") == [6, 7] and m.line("data") == [4, 6] and m.line("host") == [2, 6]
    assert m.block_index(("host", "data")) == (3, 4)
    x = torch.arange(16).reshape(8, 2)
    assert torch.equal(m.local_block(x, 0, ("host", "data")), x[6:8])
    assert torch.equal(m.local_block(x, 1, "model"), x[:, :1])
    with pytest.raises(ValueError, match="does not split"):
        m.local_block(torch.arange(6), 0, ("host", "data"))


def test_rank_device_needs_a_card_unless_cpu():
    assert tmesh.rank_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.rank_device()


def test_parallel_exports():
    names = ("make_mesh", "make_sharded_pbs_step", "PbsDispatcher")
    for name in names:
        assert hasattr(jpar, name) and hasattr(parallel, name)
    assert parallel.make_mesh is tmesh.make_mesh
    assert set(parallel.__all__) == set(names)
