"""Sparse embedding gradients (``deepspeed_tpu_torch/runtime/
sparse_tensor.py``) against JAX's ``runtime/sparse_tensor.py``: the
compaction and the dense rebuild on the same arrays, and
``sparse_allreduce`` over dp at 2 gloo ranks against JAX's in
``shard_map`` on a dp = 2 mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.parallel.topology import build_mesh as jax_build_mesh
from deepspeed_tpu.runtime import sparse_tensor as jst
from deepspeed_tpu.utils.jaxcompat import shard_map

from deepspeed_tpu_torch.runtime import sparse_tensor as tst

from torch_dist_worker import Ranks

WORLD, VOCAB, H, TOKENS = 2, 16, 4, (2, 5)


def _inputs(seed=3):
    """Per-rank token ids (with repeats) and embedding gradients that are
    zero off the rank's rows, as an embedding's gradient is."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (WORLD, *TOKENS)).astype(np.int32)
    tokens[:, 0, 1] = tokens[:, 0, 0]  # a repeated id on every rank
    grads = np.zeros((WORLD, VOCAB, H), np.float32)
    for r in range(WORLD):
        rows = np.unique(tokens[r])
        grads[r, rows] = rng.standard_normal((rows.size, H))
    return tokens, grads


@pytest.mark.parametrize("rank", range(WORLD))
def test_compaction_and_rebuild_follow_jax(rank):
    tokens, grads = _inputs()
    want = jst.SparseTensor.from_dense_rows(jnp.asarray(grads[rank]),
                                            jnp.asarray(tokens[rank]))
    got = tst.SparseTensor.from_dense_rows(torch.as_tensor(grads[rank]),
                                           torch.as_tensor(tokens[rank]))
    assert got.dense_shape == want.dense_shape
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))
    # the rebuild is the gradient itself (repeats counted once)
    np.testing.assert_array_equal(got.to_dense().numpy(), grads[rank])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tokens, grads = _inputs()
    job = Ranks("sparse", str(tmp_path_factory.mktemp("sparse")), WORLD,
                {"tokens": tokens, "grads": grads})
    return [out["sparse"] for out in job.join()]


def test_sparse_allreduce_follows_jax(ranks):
    tokens, grads = _inputs()
    mesh = jax_build_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])
    body = shard_map(
        lambda g, t: jst.sparse_allreduce(g[0], t[0], axis="dp")[None],
        mesh=mesh, in_specs=(P("dp"), P("dp")), out_specs=P("dp"))
    want = np.asarray(body(jnp.asarray(grads), jnp.asarray(tokens)))
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got, want[rank], rtol=1e-6, atol=1e-6)
        # the dense all-reduce's sum, at a fraction of its rows
        np.testing.assert_allclose(got, grads.sum(0), rtol=1e-6,
                                   atol=1e-6)
