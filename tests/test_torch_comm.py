"""The port's ``comm`` (named-axis collectives on ``torch.distributed``)
against JAX's ``comm`` in ``shard_map`` on an fsdp = 4 mesh of the CPU
devices, on the same numpy inputs: 4 gloo ranks
(``tests/torch_dist_worker.py``) run every collective once. Also the
capability probes, the cross-process assert and ``any_process``, and
``init_distributed``'s rules without a process group."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.parallel.topology import build_mesh as jax_build_mesh
from deepspeed_tpu.utils.jaxcompat import shard_map

from deepspeed_tpu_torch import comm as tcomm

from torch_dist_worker import Ranks

WORLD = 4
SHAPE = (4, 8)


def _x():
    rng = np.random.default_rng(7)
    return rng.standard_normal((WORLD, *SHAPE)).astype(np.float32)


def _jax_per_device(fn):
    """``fn`` on each device's [4, 8] slice of x, stacked per device."""
    mesh = jax_build_mesh({"dp": 1, "fsdp": WORLD},
                          devices=jax.devices()[:WORLD])
    body = shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                     in_specs=P("fsdp"), out_specs=P("fsdp"))
    return np.asarray(body(jnp.asarray(_x())))


JAX_OPS = {
    "all_reduce_sum": lambda v: jcomm.all_reduce(v, "fsdp"),
    "all_reduce_mean": lambda v: jcomm.all_reduce(v, "fsdp", op="avg"),
    "all_reduce_max": lambda v: jcomm.all_reduce(v, "fsdp", op="max"),
    "all_gather": lambda v: jcomm.all_gather(v, "fsdp"),
    "all_gather_dim1": lambda v: jcomm.all_gather(v, "fsdp", gather_dim=1),
    "all_gather_stacked": lambda v: jcomm.all_gather(v, "fsdp",
                                                     tiled=False),
    "reduce_scatter": lambda v: jcomm.reduce_scatter(v, "fsdp"),
    "reduce_scatter_dim1": lambda v: jcomm.reduce_scatter(
        v, "fsdp", scatter_dim=1),
    "all_to_all": lambda v: jcomm.all_to_all(v, "fsdp", split_dim=1,
                                             concat_dim=0),
    "ppermute": lambda v: jcomm.ppermute(
        v, "fsdp", [(i, (i + 1) % WORLD) for i in range(WORLD)]),
    "broadcast": lambda v: jcomm.broadcast(v, "fsdp", root=1),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    job = Ranks("comm", str(tmp_path_factory.mktemp("comm")), WORLD,
                {"x": _x()})
    return [out["comm"] for out in job.join()]


@pytest.mark.parametrize("op", sorted(JAX_OPS))
def test_collective_follows_jax(ranks, op):
    want = _jax_per_device(JAX_OPS[op])
    for rank, out in enumerate(ranks):
        assert out[op].shape == want[rank].shape, op
        np.testing.assert_allclose(out[op], want[rank], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{op} rank {rank}")


def test_axis_index_and_size(ranks):
    for rank, out in enumerate(ranks):
        assert out["axis_index"] == rank and out["axis_size"] == WORLD


def test_comms_logger_records_each_executed_collective(ranks):
    counts, totals = ranks[0]["logged"]
    nbytes = int(np.prod(SHAPE)) * 4
    assert counts == {"all_reduce": 3, "all_gather": 3,
                      "reduce_scatter": 2, "all_to_all": 1, "ppermute": 1,
                      "broadcast": 1}
    assert totals == {k: v * nbytes for k, v in counts.items()}


def test_probes_and_any_process_and_the_cross_process_assert(ranks):
    for rank, out in enumerate(ranks):
        assert out["probes"] == (True, True, True)
        assert out["any_process"] == (True, False)
        assert "consistency check failed for 'diverging'" in \
            out["diverging"]


def test_probes_read_the_installed_torch(monkeypatch):
    import torch.distributed as dist

    assert tcomm.has_reduce_scatter_tensor() == (
        hasattr(dist, "reduce_scatter_tensor")
        or hasattr(dist, "reduce_scatter_single"))
    monkeypatch.delattr(dist, "reduce_scatter_tensor", raising=False)
    monkeypatch.delattr(dist, "reduce_scatter_single", raising=False)
    assert not tcomm.has_reduce_scatter_tensor()
    monkeypatch.delattr(dist, "all_gather_into_tensor", raising=False)
    monkeypatch.delattr(dist, "all_gather_single", raising=False)
    assert not tcomm.has_all_gather_into_tensor()


def test_one_process_is_its_own_world(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "COORDINATOR_ADDRESS",
                "NUM_PROCESSES", "PROCESS_ID", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    tcomm.init_distributed(device="cpu")  # nothing to join, as in JAX
    assert not torch.distributed.is_initialized()
    assert tcomm.is_initialized()
    assert tcomm.get_world_size() == 1 and tcomm.get_rank() == 0
    assert tcomm.get_process_count() == 1
    tcomm.assert_same_across_processes("x", [1, 2, 3])  # one rank: no-op
    assert tcomm.any_process(True) and not tcomm.any_process(False)
    tcomm.barrier()
    x = torch.arange(4.0)
    assert torch.equal(tcomm.all_reduce(x, "fsdp"), x)  # no group: identity


def test_nccl_needs_a_card_and_never_falls_back(monkeypatch):
    with pytest.raises(ValueError, match="nccl backend needs a card"):
        tcomm.init_distributed(dist_backend="nccl", device="cpu",
                               dist_init_required=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcomm.init_distributed(dist_init_required=True)
    assert not torch.distributed.is_initialized()


def test_chaos_fails_the_kth_control_plane_op(monkeypatch):
    """``DSTPU_CHAOS`` reaches ``comm``'s control plane (JAX
    ``_chaos_collective``): the 2nd op fails, once."""
    from deepspeed_tpu_torch.resilience import chaos

    monkeypatch.setenv("DSTPU_CHAOS", "collective_k=2,collective_mode=fail")
    chaos.reset_chaos_injector()
    try:
        tcomm.barrier()  # 1st: fine
        with pytest.raises(chaos.ChaosCollectiveError, match="#2"):
            tcomm.assert_same_across_processes("cfg", [1])  # 2nd: boom
        tcomm.barrier()  # one-shot
    finally:
        monkeypatch.delenv("DSTPU_CHAOS")
        chaos.reset_chaos_injector()


def test_configure_installs_the_retry_policy_and_the_logger():
    from deepspeed_tpu_torch.config.config import load_config
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger

    cfg = load_config({"resilience": {"collective_timeout_s": 7.0,
                                      "init_timeout_s": 9.0,
                                      "max_retries": 1},
                       "comms_logger": {"enabled": True,
                                        "prof_ops": ["all_gather"]}})
    try:
        tcomm.configure(cfg)
        policy = tcomm.get_retry_policy()
        assert (policy.collective_timeout_s, policy.init_timeout_s,
                policy.max_retries) == (7.0, 9.0, 1)
        logger = get_comms_logger()
        assert logger.enabled and logger.prof_ops == ["all_gather"]
        logger.reset()
        logger.record("all_reduce", 4, "fsdp")  # not profiled
        logger.record("all_gather", 8, "fsdp")
        assert logger.counts() == {"all_gather": 1}
        assert "all_gather" in tcomm.log_summary()
    finally:
        tcomm.configure(load_config({}))
        get_comms_logger().reset()
