"""The fragment accessors of partitioned state
(``deepspeed_tpu_torch/utils/tensor_fragment.py``) at 2 gloo ranks against
JAX's ``utils/tensor_fragment.py`` on an fsdp = 2 mesh: JAX's
``tests/test_fragments.py`` cases, on the same weights and batch (fp32,
ZeRO stage 3)."""

import jax
import numpy as np
import pytest

import deepspeed_tpu as dstpu
from deepspeed_tpu.models.transformer import TransformerConfig, TransformerLM
from deepspeed_tpu.parallel.topology import build_mesh as jax_build_mesh
from deepspeed_tpu.utils import tensor_fragment as jfr

from torch_dist_worker import Ranks

WORLD = 2
MODEL_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                max_seq_len=32, remat=False)
CONFIG = {"train_micro_batch_size_per_chip": 2,
          "gradient_accumulation_steps": 1, "bf16": {"enabled": False},
          "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
          "zero_optimization": {"stage": 3}, "steps_per_print": 100}
RTOL, ATOL = 1e-5, 1e-6


def _batch():
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(0, 64, (2 * WORLD, 17)).astype(
        np.int32)}


@pytest.fixture(scope="module")
def frag(tmp_path_factory):
    mesh = jax_build_mesh({"dp": 1, "fsdp": WORLD},
                          devices=jax.devices()[:WORLD])
    engine, *_ = dstpu.initialize(
        model=TransformerLM(TransformerConfig(dtype=jax.numpy.float32,
                                              **MODEL_KW)),
        mesh=mesh, config=CONFIG)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          engine.opt_state.master)
    job = Ranks("fragments", str(tmp_path_factory.mktemp("frag")), WORLD,
                {"preset": None, "model_kw": MODEL_KW, "params": params,
                 "config": CONFIG, "batches": [_batch()]})
    ref = {"wq_full": jfr.safe_get_full_fp32_param(engine, "layers/attn/wq"),
           "wi_full": jfr.safe_get_full_fp32_param(engine, "layers/mlp/wi"),
           "wi_local": jfr.safe_get_local_fp32_param(engine,
                                                     "layers/mlp/wi"),
           "wq_shape": engine.params["layers"]["attn"]["wq"].shape}
    jfr.safe_set_full_fp32_param(engine, "final_norm/scale",
                                 np.full(32, 2.0, np.float32))
    # at fp32 JAX's set leaves the param and its master one buffer, which
    # the donating step then refuses ("donate the same buffer twice"; its
    # own test runs at bf16): give the params their own buffers
    engine.params = jax.tree.map(lambda a: a.copy(), engine.params)
    engine.train_batch(iter([_batch()]))
    ref["mu"] = jfr.safe_get_full_optimizer_state(engine, "layers/attn/wq",
                                                  "exp_avg")
    ref["nu"] = jfr.safe_get_full_optimizer_state(engine, "layers/attn/wq",
                                                  "exp_avg_sq")
    engine.backward(engine(_batch()))
    ref["grad"] = jfr.safe_get_full_grad(engine, "layers/attn/wq")
    engine.step()
    return ref, [out["fragments"] for out in job.join()]


def test_get_full_param_shape_and_dtype(frag):
    ref, ranks = frag
    for out in ranks:
        assert out["wq_full"].dtype == np.float32
        assert out["wq_full"].shape == ref["wq_shape"]
        np.testing.assert_array_equal(out["wq_full"], ref["wq_full"])


def test_local_is_shard_of_full(frag):
    ref, ranks = frag
    for rank, out in enumerate(ranks):
        full, local = out["wi_full"], out["wi_local"]
        width = full.shape[1] // WORLD  # embed dim fsdp-sharded
        assert local.shape[1] == width
        np.testing.assert_array_equal(
            local, full[:, rank * width:(rank + 1) * width])
    # rank 0's block is JAX's first addressable shard
    np.testing.assert_array_equal(ranks[0]["wi_local"], ref["wi_local"])


def test_set_full_param_roundtrip(frag):
    _, ranks = frag
    for out in ranks:
        np.testing.assert_allclose(out["scale_full"], 2.0)
        # the compute copy is refreshed too (this rank's block at stage 3)
        np.testing.assert_allclose(out["scale_param"], 2.0)
        assert out["scale_param"].size * WORLD == out["scale_full"].size


def test_optimizer_state_access(frag):
    ref, ranks = frag
    for out in ranks:
        assert out["mu"] is not None and out["nu"] is not None
        assert out["mu"].shape == ref["wq_shape"]
        assert np.abs(out["mu"]).sum() > 0
        np.testing.assert_allclose(out["mu"], ref["mu"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(out["nu"], ref["nu"], rtol=RTOL,
                                   atol=ATOL)


def test_grad_access_on_micro_step_path(frag):
    ref, ranks = frag
    for out in ranks:
        assert out["grad_before"] is None
        assert out["grad"] is not None and np.abs(out["grad"]).sum() > 0
        np.testing.assert_allclose(out["grad"], ref["grad"], rtol=RTOL,
                                   atol=ATOL)
        assert out["grad_after"] is None


def test_bad_path_raises(frag):
    _, ranks = frag
    for out in ranks:
        assert out["bad_path"] is not None and "nope" in out["bad_path"]
