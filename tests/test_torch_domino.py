"""Domino (``parallel/domino.py``): the chunked tensor-parallel layer on
two gloo ranks against JAX's ``domino_transformer_layer`` on a tp-2 mesh
of the CPU devices (fp32, ``tests/test_domino.py``'s 2e-4), one chunk
against two (the chunks are independent: the same numbers) and the
two-layer stack; the single-device layer needs no ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.parallel.domino import (DominoTransformer as JaxStack,
                                           domino_layer_params as jparams,
                                           domino_transformer_layer as jlayer)

from deepspeed_tpu_torch.parallel.domino import (DominoTransformer,
                                                 domino_layer_params,
                                                 domino_transformer_layer)

from torch_dist_worker import Ranks

HEADS, HIDDEN, FFN = 4, 32, 64
TOL = dict(rtol=2e-4, atol=2e-4)


def _case():
    params = jparams(jax.random.PRNGKey(0), hidden=HIDDEN, ffn=FFN,
                     num_heads=HEADS, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, HIDDEN),
                          jnp.float32)
    return params, x


@pytest.fixture(scope="module")
def druns(tmp_path_factory):
    params, x = _case()
    job = Ranks("domino", str(tmp_path_factory.mktemp("domino")), 2, {
        "domino": {"params": {k: np.asarray(v) for k, v in params.items()},
                   "x": np.asarray(x), "heads": HEADS}})
    jtopo._GLOBAL_MESH = None
    mesh = jtopo.build_mesh(jtopo.TopologyConfig(tp=2, dp=-1),
                            devices=jax.devices()[:2])
    jtopo.set_global_mesh(mesh)
    xs = jax.device_put(x, NamedSharding(mesh, P(("dp", "fsdp", "ep"))))
    ref = {}
    with mesh:
        for chunks in (1, 2):
            ref[chunks] = np.asarray(jax.jit(
                lambda p, x, c=chunks: jlayer(p, x, num_heads=HEADS,
                                              num_chunks=c,
                                              mesh=mesh))(params, xs))
        stack = JaxStack(num_layers=2, hidden=HIDDEN, ffn=FFN,
                         num_heads=HEADS, dtype=jnp.float32)
        ref["stack"] = np.asarray(jax.jit(
            lambda p, x: stack.apply(p, x, mesh=mesh))([params, params], xs))
    jtopo._GLOBAL_MESH = None
    return {"ref": ref, "port": [o["domino"] for o in job.join()]}


@pytest.mark.parametrize("chunks", [1, 2, "stack"])
def test_domino_at_tp2_follows_jax(druns, chunks):
    for out in druns["port"]:
        np.testing.assert_allclose(out[chunks], druns["ref"][chunks], **TOL)


def test_domino_chunks_are_one_function(druns):
    for out in druns["port"]:
        np.testing.assert_allclose(out[1], out[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(druns["port"][0][2], druns["port"][1][2])


def test_domino_single_device_follows_jax():
    params, x = _case()
    jtopo._GLOBAL_MESH = None
    want = jlayer(params, x, num_heads=HEADS, mesh=None)
    got = domino_transformer_layer({k: torch.tensor(np.asarray(v))
                                    for k, v in params.items()},
                                   torch.tensor(np.asarray(x)),
                                   num_heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_domino_params_at_jax_scales():
    gen = torch.Generator().manual_seed(0)
    p = domino_layer_params(gen, HIDDEN, FFN, HEADS, dtype=torch.float32)
    j = jparams(jax.random.PRNGKey(0), hidden=HIDDEN, ffn=FFN,
                num_heads=HEADS, dtype=jnp.float32)
    for k, v in j.items():
        assert tuple(p[k].shape) == v.shape and p[k].dtype == torch.float32
        np.testing.assert_allclose(float(p[k].std()), float(jnp.std(v)),
                                   rtol=0.2)
    stack = DominoTransformer(2, HIDDEN, FFN, HEADS, dtype=torch.float32)
    layers = stack.init(gen)
    assert len(layers) == 2 and not torch.equal(layers[0]["wo"],
                                                layers[1]["wo"])
