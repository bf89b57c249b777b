"""The rank topology (``deepspeed_tpu_torch/parallel/topology.py``) against
JAX's ``parallel/topology.py``: the free-axis solver with its errors, the
row-major layout (rank r where JAX's device r sits, so each axis group is
JAX's), the group-size queries and the batch slice. These run without a
process group: ``build_mesh(devices=range(8))`` lays out the shape."""

import jax
import numpy as np
import pytest

from deepspeed_tpu.parallel import topology as jtopo

from deepspeed_tpu_torch.parallel import topology as ttopo

CASES = [
    None,
    {"dp": 1, "fsdp": 2, "tp": 4},
    {"dp": 1, "fsdp": -1, "tp": 2},
    {"dp": 2, "fsdp": 2, "tp": 2},
    {"dp": 1, "fsdp": 8},
    {"pp": 2, "dp": 1, "fsdp": 2, "ep": 2},
    {"dp": 1, "sp": 2, "tp": 4},
]
BAD = [
    ({"dp": 3, "fsdp": 1, "tp": 1}, ValueError),
    ({"dp": -1, "fsdp": -1}, ValueError),
    ({"tp": 0}, ValueError),
    ({"dp": 3, "fsdp": -1}, ValueError),
]


def _jax_mesh(case):
    topo = None if case is None else jtopo.TopologyConfig(**case)
    return jtopo.build_mesh(topo, devices=jax.devices()[:8])


def _port_mesh(case):
    topo = None if case is None else ttopo.TopologyConfig(**case)
    return ttopo.build_mesh(topo, devices=range(8))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_sizes_and_layout_follow_jax(case):
    jm, tm = _jax_mesh(case), _port_mesh(case)
    assert dict(jm.shape) == tm.shape
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert np.array_equal(ids, tm.devices)


@pytest.mark.parametrize("case", CASES[1:], ids=str)
def test_axis_groups_are_jax_axis_groups(case):
    """The ranks of each axis's group are the device ids JAX's mesh lines
    up along that axis (and along the data axes together)."""
    jm, tm = _jax_mesh(case), _port_mesh(case)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    names = list(jtopo.MESH_AXES)
    for axes in [(a,) for a in names] + [jtopo.BATCH_AXES]:
        for rank in range(8):
            where = dict(zip(names, np.argwhere(ids == rank)[0]))
            index = tuple(slice(None) if a in axes else where[a]
                          for a in names)
            want = [int(i) for i in ids[index].reshape(-1)]
            assert tm.axis_ranks(axes, rank) == want, (axes, rank)
            assert tm.axis_index(axes, rank) == want.index(rank)


@pytest.mark.parametrize("case,exc", BAD, ids=str)
def test_solver_errors_are_jax_errors(case, exc):
    with pytest.raises(exc) as want:
        _jax_mesh(case)
    with pytest.raises(exc) as got:
        _port_mesh(case)
    assert str(got.value) == str(want.value)


def test_dict_topology_unknown_key_raises():
    with pytest.raises(ValueError) as want:
        jtopo.build_mesh({"tensor_parallel": 8}, devices=jax.devices())
    with pytest.raises(ValueError) as got:
        ttopo.build_mesh({"tensor_parallel": 8}, devices=range(8))
    assert str(got.value) == str(want.value)


def test_group_size_queries_follow_jax():
    case = {"dp": 2, "fsdp": 2, "tp": 2}
    jtopo.set_global_mesh(_jax_mesh(case))
    ttopo.set_global_mesh(_port_mesh(case))
    try:
        for name in ("get_data_parallel_world_size",
                     "get_model_parallel_world_size",
                     "get_tensor_parallel_world_size",
                     "get_pipeline_parallel_world_size",
                     "get_expert_parallel_world_size",
                     "get_sequence_parallel_world_size",
                     "get_fsdp_world_size"):
            assert getattr(ttopo, name)() == getattr(jtopo, name)(), name
    finally:
        jtopo.set_global_mesh(None)
        ttopo.set_global_mesh(None)
    with pytest.raises(RuntimeError, match="no global mesh"):
        ttopo.get_global_mesh()


def test_use_mesh_scopes_the_global_mesh():
    outer, inner = _port_mesh({"dp": 1, "fsdp": 8}), _port_mesh(None)
    ttopo.set_global_mesh(outer)
    try:
        with ttopo.use_mesh(inner):
            assert ttopo.get_global_mesh() is inner
        assert ttopo.get_global_mesh() is outer
    finally:
        ttopo.set_global_mesh(None)


@pytest.mark.parametrize("rank", range(8))
def test_batch_slice_is_the_devices_rows(rank):
    """Rank r's rows of a global batch are the rows JAX's batch_sharding
    places on device r (the data axes, row-major)."""
    case = {"dp": 2, "fsdp": 2, "tp": 2}
    jm = _jax_mesh(case)
    tm = ttopo.build_mesh(ttopo.TopologyConfig(**case), devices=range(8))
    tm.rank = rank
    batch = np.arange(16 * 3).reshape(16, 3)
    sh = jtopo.batch_sharding(jm)
    want = batch[sh.devices_indices_map(batch.shape)[jax.devices()[rank]]]
    got = ttopo.batch_sharding(tm).take({"x": batch})["x"]
    assert np.array_equal(got, want)
    assert ttopo.replicated(tm).take(batch).shape == batch.shape
