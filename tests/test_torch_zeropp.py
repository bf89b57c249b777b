"""ZeRO++ and the 1-bit optimizers across ranks (the port's
``ops/quantization`` collectives, ``runtime/{zeropp, qgz, onebit}.py`` and
the stage-3 qwZ gather) on gloo against the JAX package on meshes of the
CPU devices.

The quantized collectives are held bit for bit against JAX's shard_map
bodies at 2 and 4 ranks, int8 and int4. The engines train JAX's
``tests/test_zeropp.py`` model (fp32, micro 2, AdamW lr 1e-2, clip 1.0)
from JAX's own init, rank r on rows r of the global batch, and follow
JAX's quantized engine of the same config at rtol 1e-4 on the losses
(params at atol 1e-4), and JAX's exact path within its rtol 0.05. One
launch a world size serves the file.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu as dstpu
from deepspeed_tpu.models.transformer import TransformerConfig, \
    TransformerLM
from deepspeed_tpu.ops.pallas import quantization as jq
from deepspeed_tpu.parallel import topology as jtopo

import deepspeed_tpu_torch
from deepspeed_tpu_torch.config.config import load_config
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops import quantization as qz
from deepspeed_tpu_torch.runtime import qgz, zeropp
from deepspeed_tpu_torch.runtime.optimizer import get_base_optimizer
from deepspeed_tpu_torch.utils import telemetry

from torch_dist_worker import Ranks

MODEL_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                max_seq_len=32, pos_emb="learned", norm="layernorm",
                activation="gelu", tie_embeddings=True, remat=False)
CONFIG = {"train_micro_batch_size_per_chip": 2,
          "gradient_accumulation_steps": 1, "bf16": {"enabled": False},
          "gradient_clipping": 1.0, "steps_per_print": 1000,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}}
STEPS, SEQ = 3, 16
RTOL, ATOL = 1e-4, 1e-4
EXACT_RTOL = 0.05  # JAX's own bound against the exact path


def _z(stage, **kw):
    return {"zero_optimization": dict(stage=stage, **kw)}


def _onebit(freeze, **kw):
    return {"optimizer": {"type": "onebitadam", "params": dict(
        lr=1e-2, freeze_step=freeze, **kw)}, **_z(0)}


FSDP = {"fsdp": -1, "dp": 1}
# name -> (config over CONFIG, topology, worlds, extra worker keys)
RUNS = {
    "exact1": (_z(1), {"dp": -1, "fsdp": 1}, (2,), {}),
    "qgz_qwz": (_z(1, zero_quantized_gradients=True,
                   zero_quantized_weights=True), None, (2,), {}),
    "qar": (_z(1, zero_quantized_allreduce=True), None, (2,), {}),
    "qwz1": (_z(1, zero_quantized_weights=True), None, (2,), {}),
    "exact3": (_z(3), FSDP, (2,), {}),
    "qwz3": (_z(3, zero_quantized_weights=True), FSDP, (2,), {}),
    "qgz3": (_z(3, zero_quantized_gradients=True), FSDP, (2,), {}),
    "qgz2": (_z(2, zero_quantized_gradients=True), FSDP, (2,), {}),
    "plain3_dp": (_z(3), {"dp": -1, "fsdp": 1}, (2,), {}),
    "qgz3_dp": (_z(3, zero_quantized_gradients=True), {"dp": -1, "fsdp": 1},
                (2,), {}),
    "onebit": (_onebit(2), None, (2,), {"steps": 4}),
    "onebit_warm": (_onebit(100, weight_decay=0.0), None, (2,), {}),
    "adam0": ({"optimizer": {"type": "adam", "params": {
        "lr": 1e-2, "weight_decay": 0.0}}, **_z(0)}, None, (2,), {}),
    "zpp_ckpt": (_z(2, zero_quantized_gradients=True), None, (2,),
                 {"ckpt": True, "steps": 2}),
    "onebit_ckpt": (_onebit(1), None, (2,), {"ckpt": True, "steps": 2}),
    "zpp_lr1": (_z(1, zero_quantized_gradients=True), None, (2,),
                {"steps": 1}),
    "zpp_lr0": (_z(1, zero_quantized_gradients=True), None, (2,),
                {"steps": 2, "set_lr_at": (1, 0.0)}),
    "qgz3_h": (_z(3, zero_quantized_gradients=True), {"dp": 2, "fsdp": 2},
               (4,), {}),
    "hpz": (_z(3, zero_hpz_partition_size=2), None, (4,), {}),
    "mics": (_z(2, mics_shard_size=2), None, (4,), {}),
}
# the runs held to JAX's engine of the same config and mesh (the exact
# stages follow JAX's at rtol 1e-5 in tests/test_torch_zero.py, so the
# port's own exact runs are the tracking references here)
JAX_OF = ("qgz_qwz", "qar", "qwz1", "qwz3", "qgz3", "qgz2", "onebit",
          "qgz3_h", "hpz", "mics")


def _batches(world, n=STEPS + 1, seed=0):
    rng = np.random.default_rng(seed)
    rows = CONFIG["train_micro_batch_size_per_chip"] * world
    return [{"input_ids": rng.integers(0, MODEL_KW["vocab_size"],
                                       (rows, SEQ + 1)).astype(np.int32)}
            for _ in range(n)]


def _jax_mesh(world, name):
    topo = RUNS[name][1]
    z = RUNS[name][0].get("zero_optimization", {})
    if topo is None:  # the engine's default mesh, over `world` devices
        if "zero_hpz_partition_size" in z or "mics_shard_size" in z:
            topo = {"fsdp": 2, "dp": -1}
        else:
            topo = {"dp": -1, "fsdp": 1}
    return jtopo.build_mesh(topo, devices=jax.devices()[:world])


def _jax_engine(world, name):
    jtopo._GLOBAL_MESH = None
    model = TransformerLM(TransformerConfig(dtype=jnp.float32, **MODEL_KW))
    engine, *_ = dstpu.initialize(model=model, mesh=_jax_mesh(world, name),
                                  config=dict(CONFIG, **RUNS[name][0]))
    return engine


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_run(world, name):
    engine = _jax_engine(world, name)
    steps = RUNS[name][3].get("steps", STEPS)
    batches = _batches(world)
    losses = [float(engine.train_batch(iter([batches[s % len(batches)]])))
              for s in range(steps)]
    return {"losses": losses, "params": engine.module_state_dict()}


def _jax_params():
    jtopo._GLOBAL_MESH = None
    model = TransformerLM(TransformerConfig(dtype=jnp.float32, **MODEL_KW))
    engine, *_ = dstpu.initialize(
        model=model, mesh=jtopo.build_mesh({"dp": 1},
                                           devices=jax.devices()[:1]),
        config=dict(CONFIG, **_z(0)))
    return _np(engine.params)


def _coll_inputs(world, seed=3):
    rng = np.random.default_rng(seed)
    # rows divisible by every world size, a block that tiles the last dim
    return [rng.standard_normal((8, 256)).astype(np.float32) * (r + 1)
            for r in range(world)]


def _jax_collectives(world, xs, block):
    """JAX's shard_map bodies over a dp mesh of ``world`` CPU devices on
    the same per-device inputs (each device's block of dim 0)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    stacked = jnp.asarray(np.concatenate(xs, axis=0))
    out = {}
    for bits in (8, 4):
        fns = {"gather": lambda x: jq.quantized_all_gather(
                   x, "dp", bits=bits, block=block),
               "scatter": lambda x: jq.quantized_psum_scatter(
                   x, "dp", bits=bits, block=block),
               "all_reduce": lambda x: jq.quantized_all_reduce(
                   x, "dp", bits=bits, block=block)}
        res = {}
        for name, fn in fns.items():
            # run eagerly: under jit XLA's CPU fusions move the
            # dequantized values by an ulp, the bodies' own numerics not
            y = jax.shard_map(fn, mesh=mesh, in_specs=P("dp"),
                              out_specs=P("dp"), check_vma=False)(stacked)
            y = np.asarray(y)
            res[name] = np.split(y, world, axis=0)
        out[bits] = res
    return out


@pytest.fixture(scope="module")
def zruns(tmp_path_factory):
    root = tmp_path_factory.mktemp("zeropp")
    params = _jax_params()
    runs = [{"name": name, "config": cfg, "topology": topo,
             "worlds": worlds, "steps": STEPS, **extra}
            for name, (cfg, topo, worlds, extra) in RUNS.items()]
    jobs = {}
    for world in (2, 4):
        work = str(root / f"w{world}")
        jobs[world] = Ranks("quant_coll,engines", work, world, dict(
            preset=None, model_kw=MODEL_KW, params=params, config=CONFIG,
            batches=_batches(world), runs=runs, workdir=work, block=128,
            coll_x=_coll_inputs(world)))
    jax_ref = {(world, name): _jax_run(world, name)
               for name in JAX_OF for world in RUNS[name][2]}
    coll = {w: _jax_collectives(w, _coll_inputs(w), 128) for w in (2, 4)}
    port = {w: job.join() for w, job in jobs.items()}
    jtopo._GLOBAL_MESH = None
    return {"jax": jax_ref, "port": port, "coll": coll, "params": params}


def _engine_runs(zruns, world, name):
    return [out["engines"][name] for out in zruns["port"][world]]


# -- the quantized collectives ------------------------------------------------


@pytest.mark.parametrize("op", ["gather", "scatter", "all_reduce"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("world", [2, 4])
def test_quantized_collectives_bit_equal_jax(zruns, world, bits, op):
    want = zruns["coll"][world][bits][op]
    for rank, out in enumerate(zruns["port"][world]):
        got = out["quant_coll"][bits][op].numpy()
        assert got.dtype == want[rank].dtype
        assert np.array_equal(got, want[rank]), (rank, op, bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_wire_bytes_are_codes_plus_scales(zruns, bits):
    """The comms logger records what each quantized call sends: codes
    (int4 packed two to a byte) plus fp32 scales, per rank."""
    rows, cols, block = 8, 256, 128
    code = rows * cols * bits // 8
    scales = rows * (cols // block) * 4
    got = zruns["port"][2][0]["quant_coll"][bits]["bytes"]
    assert got["quantized_all_gather"] == code
    assert got["quantized_all_gather_scales"] == scales
    assert got["quantized_psum_scatter"] == code
    assert got["quantized_psum_scatter_scales"] == scales


def test_quantized_collectives_one_process_quantize():
    """Without a group the bodies still quantize (JAX's bodies run at
    every axis size): the gather equals quantize-dequantize."""
    x = torch.randn(4, 256)
    q, s = qz.quantize_blockwise(x, 8, 128)
    want = qz.dequantize_blockwise(q, s, 8, 128, torch.float32)
    assert torch.equal(qz.quantized_all_gather(x, "dp", 8, 128), want)
    assert torch.equal(qz.quantized_psum_scatter(x, "dp", 8, 128), want)


# -- the ZeRO++ engines -------------------------------------------------------


# a quantized engine's code can flip at a rounding tie, where an fp32
# difference of 1e-7 upstream lands on the other side of x.5: at most this
# share of a leaf's elements may part by more than ATOL, and then by no
# more than two AdamW steps at lr 1e-2
TIE_SHARE, TIE_BOUND = 1e-3, 2e-2


def _follows(got, ref, rtol=RTOL):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=rtol,
                               atol=ATOL)
    for key, want in ref["params"].items():
        diff = np.abs(got["params"][key] - want)
        off = diff > ATOL + rtol * np.abs(want)
        assert off.mean() <= TIE_SHARE, (key, int(off.sum()), want.size)
        assert diff.max() <= TIE_BOUND, (key, float(diff.max()))


@pytest.mark.parametrize("name,world", [
    ("qgz_qwz", 2), ("qar", 2), ("qwz1", 2), ("qwz3", 2), ("qgz3", 2),
    ("qgz2", 2), ("qgz3_h", 4), ("hpz", 4), ("mics", 4)])
def test_engine_follows_jax_quantized_engine(zruns, name, world):
    ref = zruns["jax"][world, name]
    for got in _engine_runs(zruns, world, name):
        _follows(got, ref)


@pytest.mark.parametrize("name", ["qgz_qwz", "qar", "qwz1"])
def test_zeropp_step_tracks_the_exact_path(zruns, name):
    exact = _engine_runs(zruns, 2, "exact1")[0]["losses"]
    for got in _engine_runs(zruns, 2, name):
        assert got["flags"]["_zeropp"]
        assert got["mesh"]["dp"] == 2 and got["mesh"]["fsdp"] == 1
        np.testing.assert_allclose(got["losses"], exact, rtol=EXACT_RTOL)


@pytest.mark.parametrize("name", ["qwz3", "qgz3", "qgz2", "qgz3_h"])
def test_stage3_quantized_tracks_the_exact_path(zruns, name):
    world = RUNS[name][2][0]
    exact = _engine_runs(zruns, 2, "exact3")[0]["losses"] \
        if world == 2 else None
    for got in _engine_runs(zruns, world, name):
        flag = "_qwz_stage3" if name.startswith("qwz") else "_qgz_stage3"
        assert got["flags"][flag]
        assert not got["flags"]["_zeropp"]
        if exact is not None:
            np.testing.assert_allclose(got["losses"], exact,
                                       rtol=EXACT_RTOL)


def test_qgz_hierarchical_levels_on_the_wire(zruns):
    """dp 2 x fsdp 2: int8 codes over fsdp, packed int4 over dp."""
    for got in _engine_runs(zruns, 4, "qgz3_h"):
        assert got["mesh"]["dp"] == 2 and got["mesh"]["fsdp"] == 2
        assert got["counts"].get("qgz_fsdp_int8", 0) > 0
        assert got["counts"].get("qgz_dp_int4", 0) > 0


def test_qgz_disarms_at_fsdp_one(zruns):
    """Stage 3 with qgZ on a dp-only mesh: JAX's rule disarms it, counts
    ``zeropp.qgz_disabled`` once and trains the plain stage 3 step."""
    plain = _engine_runs(zruns, 2, "plain3_dp")
    for got, want in zip(_engine_runs(zruns, 2, "qgz3_dp"), plain):
        assert not got["flags"]["_qgz_stage3"]
        assert got["telemetry"].get("zeropp.qgz_disabled") == 1
        assert got["losses"] == want["losses"]


def test_qgz_wire_bytes_reduction(zruns):
    """The stage-3 gradient reduction's bytes: qgZ's int8 codes and
    scales against the exact reduce-scatter's fp32 (JAX's
    ``test_qgz_wire_bytes_reduction`` reads compiled HLO; the port counts
    what its calls send)."""
    exact = _engine_runs(zruns, 2, "exact3")[0]["bytes"]
    quant = _engine_runs(zruns, 2, "qgz3")[0]["bytes"]
    full_red = exact["reduce_scatter"]
    narrow = sum(v for k, v in quant.items()
                 if k.startswith("qgz_") and k.endswith("_int8"))
    scales = sum(v for k, v in quant.items()
                 if k.startswith("qgz_") and k.endswith("_scales"))
    quant_red = narrow + scales + quant.get("reduce_scatter", 0)
    assert narrow / quant_red > 0.5, quant
    assert quant_red < 0.35 * full_red, (quant_red, full_red)


def test_zeropp_checkpoint_roundtrip_and_reseed(zruns):
    for got in _engine_runs(zruns, 2, "zpp_ckpt"):
        ck = got["ckpt"]
        np.testing.assert_allclose(ck["again"], ck["more"], rtol=1e-4)
        for key, want in ck["saved_params"].items():
            np.testing.assert_array_equal(ck["reseed_params"][key], want)


def test_onebit_checkpoint_roundtrip(zruns):
    for got in _engine_runs(zruns, 2, "onebit_ckpt"):
        ck = got["ckpt"]
        np.testing.assert_allclose(ck["again"], ck["more"], rtol=1e-4)


def test_zeropp_set_lr_without_rebuild(zruns):
    """set_lr(0.0) after step 1: step 2 leaves the params where step 1
    put them (the override rides into the step, no rebuild)."""
    for one, two in zip(_engine_runs(zruns, 2, "zpp_lr1"),
                        _engine_runs(zruns, 2, "zpp_lr0")):
        for key, want in one["params"].items():
            np.testing.assert_allclose(two["params"][key], want, atol=1e-6)


def test_hpz_and_mics_mesh(zruns):
    for name in ("hpz", "mics"):
        for got in _engine_runs(zruns, 4, name):
            assert got["mesh"]["fsdp"] == 2 and got["mesh"]["dp"] == 2


# -- the 1-bit optimizers -----------------------------------------------------


def test_onebit_follows_jax_through_compression(zruns):
    ref = zruns["jax"][2, "onebit"]
    for got in _engine_runs(zruns, 2, "onebit"):
        assert got["flags"]["_onebit"]
        _follows(got, ref)


def test_onebit_warmup_matches_adam(zruns):
    adam = _engine_runs(zruns, 2, "adam0")
    for got, want in zip(_engine_runs(zruns, 2, "onebit_warm"), adam):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=3e-3)


def _one_engine(extra, model=None):
    cfg = tf.TransformerConfig(dtype=torch.float32, **MODEL_KW)
    model = model or tf.TransformerLM(cfg, device="cpu", seed=0)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=dict(CONFIG, **extra), device="cpu")
    return engine


def test_onebit_rejections():
    with pytest.raises(ValueError, match="stage"):
        _one_engine(dict(_onebit(2), **_z(2)))
    with pytest.raises(ValueError, match="offload"):
        _one_engine(dict(_onebit(2), **_z(
            1, offload_optimizer={"device": "cpu"})))
    engine = _one_engine(_onebit(2))
    with pytest.raises(RuntimeError, match="train_batch"):
        engine.forward({"input_ids": np.zeros((2, 17), np.int32)})
    with pytest.raises(ValueError, match="engine"):
        get_base_optimizer(load_config(_onebit(2)).optimizer)


def test_onebit_set_lr_without_rebuild():
    engine = _one_engine(_onebit(1))
    batch = _batches(1)[0]
    engine.train_batch(iter([batch]))
    step = engine._quant_step
    before = {k: v.clone() for k, v in step.state.master.items()}
    engine.set_lr(0.0)
    engine.train_batch(iter([batch]))
    assert engine._quant_step is step and engine.get_lr() == [0.0]
    for k, v in step.state.master.items():
        assert torch.equal(v, before[k]), k
    engine.set_lr(1e-2)
    engine.train_batch(iter([batch]))
    assert any(not torch.equal(v, before[k])
               for k, v in step.state.master.items())


# -- the rules ----------------------------------------------------------------


def test_qar_and_qgz_are_mutually_exclusive():
    with pytest.raises(ValueError, match="gradient wire"):
        load_config(_z(1, zero_quantized_allreduce=True,
                       zero_quantized_gradients=True))


def test_zeropp_step_applicability_and_warnings(caplog):
    """JAX's rules at one process: the stage 1-2 step arms for AdamW,
    the flags warn when nothing can carry them, qwZ at stage 3 disarms
    under MoE with its count."""
    engine = _one_engine(_z(1, zero_quantized_gradients=True))
    assert engine._zeropp and engine.mesh.shape["dp"] == 1
    log = logging.getLogger("deepspeed_tpu_torch.runtime.engine")
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            lamb = _one_engine(dict(_z(1, zero_quantized_gradients=True),
                                    optimizer={"type": "sgd", "params": {
                                        "lr": 1e-2}}))
    finally:
        log.removeHandler(caplog.handler)
    assert not lamb._zeropp
    assert any("ZeRO++ flags" in r.getMessage() for r in caplog.records)
    telemetry.reset()
    from deepspeed_tpu_torch.models import zoo

    moe = zoo.get_model("tiny-moe", device="cpu", dtype=torch.float32,
                        vocab_size=64, hidden_size=32, num_layers=1,
                        num_heads=4, max_seq_len=32)
    e = _one_engine(dict(_z(3, zero_quantized_weights=True),
                         moe={"enabled": True}), model=moe)
    assert not e._qwz_stage3
    assert telemetry.get("zeropp.qwz_disabled") == 1


def test_qgz_reduce_leaf_exact_path_without_ranks():
    """Without a group a leaf reduces to itself over one group; a 1-D
    leaf takes the exact path."""
    from deepspeed_tpu_torch.parallel.topology import build_mesh

    mesh = build_mesh({"dp": 1})
    g = torch.randn(8, 32)
    out = qgz.reduce_leaf(g, ("fsdp",), mesh, part_dim=0)
    assert torch.equal(out, g)
    assert qgz.leaf_block((64,), (None,), mesh) == 64
    assert qgz.leaf_block((3,), (None,), mesh) == 1


def test_zeropp_master_layout_is_jax_flat_blocks():
    params = {"w": torch.arange(300, dtype=torch.float32).reshape(3, 100)}
    blk = zeropp.flat_block(params["w"], dp=2, rank=1)
    # padded to dp x 256 = 512, rank 1 holds elements 256..511
    want = torch.zeros(256)
    want[:44] = torch.arange(256, 300, dtype=torch.float32)
    assert torch.equal(blk, want)


@pytest.mark.parametrize("step", [1, 2, 3, 50])
def test_zeropp_adamw_is_jax_step_update_bit_for_bit(step):
    """The stage 1-2 update on the same fp32 (master, m, v, g) equals the
    update of JAX's ZeRO++ step (``_local_step_inner``'s expression,
    jitted as XLA's CPU compile runs it), bit for bit: its fused
    multiply-adds, ``m / (bc1 * (sqrt(v / bc2) + eps))``, the float
    exponent of the bias corrections, the correctly rounded sqrt."""
    b1, b2, eps, wd, lr = 0.9, 0.999, 1e-8, 0.01, 1e-2
    rng = np.random.default_rng(step)
    n = 1 << 14
    mm = (rng.standard_normal(n) * 0.05).astype(np.float32)
    m = (rng.standard_normal(n) * 1e-4).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 1e-8).astype(np.float32)
    g = (rng.standard_normal(n) * 1e-3).astype(np.float32)

    @jax.jit
    def jax_update(mm, m, v, g, step, lr):
        # deepspeed_tpu/runtime/zeropp.py, the per-leaf update
        mi = b1 * m + (1 - b1) * g
        vi = b2 * v + (1 - b2) * g * g
        mhat = mi / (1 - b1 ** step.astype(jnp.float32))
        vhat = vi / (1 - b2 ** step.astype(jnp.float32))
        upd = lr * (mhat / (jnp.sqrt(vhat) + eps) + wd * mm)
        return mm - upd, mi, vi

    want = [np.asarray(x) for x in jax_update(
        mm, m, v, g, jnp.asarray(step, jnp.int32),
        jnp.asarray(lr, jnp.float32))]
    master, st = torch.from_numpy(mm.copy()), {
        "mu": torch.from_numpy(m.copy()), "nu": torch.from_numpy(v.copy())}
    zeropp.adamw({}, None, lr).update_leaf("w", master, torch.from_numpy(g),
                                           st, step, lr)
    for got, ref in zip((master, st["mu"], st["nu"]), want):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      ref.view(np.uint32))
