"""ZeRO's host optimizer tiers and the whole-leaf optimizers across ranks
(the port's ``runtime/{offload, zenflow, optimizer, muon}.py`` over
``runtime/zero.ZeroPartition``'s blocks) on gloo against the JAX engine
on the same mesh of CPU devices.

The model is ``tests/test_torch_zero.py``'s (config A's dense Llama at
hidden 64, remat on), fp32, clip 1.0, from JAX's own init; rank r trains
on its rows of the global batch (``topology.batch_sharding``). World 2 is
fsdp 2, world 4 is dp 2 x fsdp 2. Each run follows JAX's engine of the
same config and mesh: losses at rtol 1e-5, the gathered fp32 masters and
the params within atol 1e-4. One launch a world size serves the file.
"""

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu_torch.runtime.zenflow import (LeafBlock, ZenFlowConfig,
                                                 ZenFlowOptimizer,
                                                 merge_topk, topk_indices)
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.utils import tensor_fragment as jtfr

from torch_dist_worker import Ranks

PRESET = "llama3-8b"
MODEL_KW = dict(num_layers=2, hidden_size=64, ffn_size=128, num_heads=8,
                num_kv_heads=4, vocab_size=256, max_seq_len=64, remat=True)
CONFIG = {"train_micro_batch_size_per_chip": 2,
          "gradient_accumulation_steps": 1, "bf16": {"enabled": False},
          "gradient_clipping": 1.0, "steps_per_print": 1000,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
STEPS, SEQ = 2, 16
RTOL, ATOL = 1e-5, 1e-4
MESH = {2: {"fsdp": 2, "dp": 1}, 4: {"fsdp": 2, "dp": 2}}


def _z(stage, **kw):
    return {"zero_optimization": dict(stage=stage, **kw)}


def _off(stage, device="cpu", **kw):
    off = {"device": device}
    if device == "nvme":
        off["nvme_path"] = "@nvme"  # the worker's own directory
    return _z(stage, offload_optimizer=off, **kw)


# name -> (config over CONFIG, worlds, extra keys of the run)
RUNS = {}
# every stage and GAS at fsdp 2; at dp 2 x fsdp 2 the cpu tier at stage 3
# and the nvme tier at stage 1, both at GAS 2
AT_FOUR = {"off_cpu_s3_g2", "off_nvme_s1_g2"}
for _stage in (1, 2, 3):
    for _gas in (1, 2):
        for _dev in ("cpu", "nvme"):
            _name = f"off_{_dev}_s{_stage}_g{_gas}"
            RUNS[_name] = (dict(_off(_stage, _dev),
                                gradient_accumulation_steps=_gas),
                           (2, 4) if _name in AT_FOUR else (2,), {})
# dry-run config C (``__graft_entry__.py:139-172``): its model, its
# ZenFlow block at stage 2 over the whole fsdp mesh
C_MODEL = ("tiny", dict(vocab_size=256, hidden_size=64, num_layers=2,
                        num_heads=4, max_seq_len=64, remat=False))
C_ZENFLOW = {"topk_ratio": 0.05, "update_interval": 2, "select_interval": 4,
             "workers": 2}
C_CONFIG = {"train_micro_batch_size_per_chip": 1,
            "gradient_accumulation_steps": 2,
            **_off(2, zenflow=C_ZENFLOW)}
# tests/zenflow_worker.py's block (JAX's two-process ZenFlow test), at
# the file's lr 1e-3: at the worker's 1e-2 Adam turns the reduction-order
# noise of a near-zero gradient into a 2.3e-4 step of one master
MP_ZENFLOW = {"topk_ratio": 0.05, "update_interval": 2, "select_interval": 4,
              "overlap_step": False}
RUNS.update({
    "zen_c_s2": (dict(_off(2, zenflow=C_ZENFLOW),
                      gradient_accumulation_steps=2), (2, 4), {"steps": 4}),
    "zen_c_s3": (dict(_off(3, zenflow=C_ZENFLOW),
                      gradient_accumulation_steps=2), (2,), {"steps": 4}),
    "zen_mp_s2": (_off(2, zenflow=MP_ZENFLOW), (2,), {"steps": 5}),
    "config_c": (C_CONFIG, (2, 4), {"steps": 3, "model": "c",
                                    "topology": {"dp": 1, "fsdp": -1}}),
})
# the whole-leaf optimizers over the fsdp blocks (Adafactor on hidden 128,
# where its moments factor: optax's min_dim_size_to_factor)
A_MODEL = (PRESET, dict(MODEL_KW, hidden_size=128))
OPTIMIZERS = {"lamb": {}, "adafactor": {"model": "a"}, "muon": {}}
for _opt, _extra in OPTIMIZERS.items():
    for _stage in (1, 2, 3):
        RUNS[f"{_opt}_s{_stage}"] = (
            {"optimizer": {"type": _opt, "params": {"lr": 1e-3}},
             **_z(_stage)}, (2,), _extra)
# a client torch.optim.AdamW over the fsdp blocks, held to world size 1
CLIENT_RUNS = {f"client_s{st}": (_z(st), (2,), {"client": 1e-3})
               for st in (1, 2, 3)}
# checkpoints of the host tiers: resumed at 2 ranks, ZenFlow's at 1 too
CKPT_RUNS = {
    "ckpt_off": (_off(2, "nvme"), (2,), {"ckpt": True}),
    "ckpt_zen": (dict(_off(2, zenflow=C_ZENFLOW),
                      gradient_accumulation_steps=2), (2,),
                 {"ckpt": True, "steps": 3}),
}
RUNS.update(CLIENT_RUNS)
RUNS.update(CKPT_RUNS)
# the stage-3 resident overlap (performance.overlap_depth) against the
# remat'd layer loop, and offload_param's streamed stack beside the
# per-rank host optimizer
RUNS.update({
    "overlap_d0": (_z(3), (2,), {}),
    "overlap_d1": ({**_z(3), "performance": {"overlap_depth": 1}}, (2,),
                   {}),
    "overlap_d2": ({**_z(3), "performance": {"overlap_depth": 2}}, (2,),
                   {}),
    "oparam_s2": (_off(2, offload_param={"device": "cpu"}), (2,), {}),
    "oparam_s3": (_off(3, offload_param={"device": "cpu"}), (2,), {}),
})
OVERLAP_RUNS = ("overlap_d0", "overlap_d1", "overlap_d2")
# qgZ's quantized wire before the host copy (JAX
# tests/test_qgz_stage3.py:148-183, at dp 2 x fsdp 2)
QUANT_RUNS = {
    "qgz_off_s3": (_off(3, zero_quantized_gradients=True), (4,),
                   {"steps": 3}),
    "qgz_zen_s3": (_off(3, zero_quantized_gradients=True, zenflow={
        "topk_ratio": 0.5, "select_interval": 2, "overlap_step": False}),
        (4,), {"steps": 4}),
}
RUNS.update(QUANT_RUNS)


def _jax_of(name):
    """The JAX run a port run follows: JAX's stages 1-3 give one host
    tier's and one optimizer's numbers on a mesh (its step is per shard,
    or global under GSPMD), so one JAX stage serves the three; the nvme
    tier is the cpu tier's bits."""
    name = name.replace("nvme", "cpu")
    if name.startswith("overlap_"):
        return "overlap_d1"
    for stem in ("off_cpu", "zen_c", "oparam") + tuple(OPTIMIZERS):
        if name.startswith(stem + "_s"):
            return name.replace(f"_s{name[len(stem) + 2]}", "_s2", 1)
    return name


# the runs whose config JAX runs too
JAX_OF = {name: _jax_of(name) for name in RUNS
          if name not in CLIENT_RUNS and name not in CKPT_RUNS}
# the quantized runs' bounds (tests/test_torch_zeropp.py): a code may flip
# at a rounding tie
Q_RTOL, TIE_SHARE, TIE_BOUND = 1e-4, 1e-3, 2e-2


def _batches(world, n=2 * STEPS, seed=0):
    rng = np.random.default_rng(seed)
    rows = CONFIG["train_micro_batch_size_per_chip"] * world
    return [{"input_ids": rng.integers(0, MODEL_KW["vocab_size"],
                                       (rows, SEQ + 1)).astype(np.int32)}
            for _ in range(n)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _jax_engine(world, cfg, topology=None, model=None):
    jtopo._GLOBAL_MESH = None
    mesh = jtopo.build_mesh(topology or MESH[world],
                            devices=jax.devices()[:world])
    preset, kw = model or (PRESET, MODEL_KW)
    engine, *_ = dstpu.initialize(
        model=jax_get_model(preset, dtype=jnp.float32, **kw), mesh=mesh,
        config=dict(CONFIG, **cfg))
    return engine


def _paths(engine):
    flat, _ = jax.tree_util.tree_flatten_with_path(engine.params)
    return ["/".join(k.key for k in kp) for kp, _ in flat]


def _jax_masters(engine):
    """The gathered fp32 masters: the offload tier's through the fragment
    API, ZenFlow's per-shard masters reassembled."""
    zen = engine._zenflow
    if zen is None:
        return {p: np.asarray(jtfr.safe_get_full_fp32_param(engine, p),
                              np.float32) for p in _paths(engine)}
    zen.finalize()
    out = {}
    for path, shape, metas, bufs in zip(_paths(engine), zen._shapes,
                                        zen._shard_meta, zen._masters):
        full = np.zeros(shape, np.float32)
        for (index, _), buf in zip(metas, bufs):
            full[index] = buf.reshape(full[index].shape)
        out[path] = full
    return out


def _jax_run(world, name):
    cfg, _, extra = RUNS[name]
    model = MODELS.get(extra.get("model"))
    engine = _jax_engine(world, cfg, extra.get("topology"), model)
    gas = engine.gradient_accumulation_steps
    batches = _run_batches(world, extra.get("model"))
    steps = extra.get("steps", STEPS)
    losses = [float(engine.train_batch(iter(
        batches[(s * gas) % len(batches):][:gas]))) for s in range(steps)]
    return {"losses": losses, "params": engine.module_state_dict(),
            "masters": _jax_masters(engine)}


MODELS = {"c": C_MODEL, "a": A_MODEL}


def _run_batches(world, model=None):
    """The global batches of a run: config C's own (micro 1, its vocab)."""
    if model == "c":
        rng = np.random.default_rng(1)
        return [{"input_ids": rng.integers(0, 256, (world, 33)).astype(
            np.int32)} for _ in range(2)]
    return _batches(world)


def _jax_params(model=None):
    jtopo._GLOBAL_MESH = None
    engine = _jax_engine(2, _z(0), model=model)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), engine.params)


@pytest.fixture(scope="module")
def hruns(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_tiers")
    params = _jax_params()
    params_by = {key: _jax_params(m) for key, m in MODELS.items()}
    runs = []
    for name, (cfg, worlds, extra) in RUNS.items():
        run = {"name": name, "config": cfg, "topology": None,
               "worlds": worlds, "steps": STEPS, "masters": True, **extra}
        if extra.get("model"):
            run["model"] = (*MODELS[extra["model"]], extra["model"])
        if extra.get("model") == "c":
            run["batches"] = "batches_c"
        runs.append(run)
    jobs = {}
    for world in (2, 4):
        work = str(root / f"w{world}")
        jobs[world] = Ranks("engines", work, world, dict(
            preset=PRESET, model_kw=MODEL_KW, params=params, config=CONFIG,
            batches=_batches(world), runs=runs, workdir=work,
            topology=MESH[world], params_by=params_by,
            batches_c=_run_batches(world, "c")))
    keys = sorted({(world, ref) for name, ref in JAX_OF.items()
                   for world in RUNS[name][1]})
    # the JAX engines run in three spawned processes beside the ranks
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futures = {key: pool.submit(_jax_run, *key) for key in keys}
        one = {name: _world_one(params, name) for name in CLIENT_RUNS}
        jax_ref = {key: f.result() for key, f in futures.items()}
    port = {w: job.join() for w, job in jobs.items()}
    jtopo._GLOBAL_MESH = None
    return {"jax": jax_ref, "port": port, "params": params, "one": one,
            "root": root}


def _port_engine(params, cfg, optimizer=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.models.convert import params_from_jax

    model = params_from_jax(params, zoo.get_config(
        PRESET, dtype=torch.float32, **MODEL_KW), device="cpu")
    kw = {} if optimizer is None else {"optimizer": optimizer}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=dict(CONFIG, **cfg), device="cpu", **kw)
    return engine


def _world_one(params, name):
    """A client run at world size 1 (no process group) on the global
    batch: what the ranks must equal."""
    cfg, _, extra = RUNS[name]
    engine = _port_engine(params, cfg, lambda ps: torch.optim.AdamW(
        ps, lr=extra["client"]))
    losses = [float(engine.train_batch(iter([b])))
              for b in _batches(2)[:STEPS]]
    return {"losses": losses, "params": engine.module_state_dict()}


def _cases(names):
    return [(w, n) for n in names for w in RUNS[n][1]]


EXACT = [n for n in JAX_OF if n not in QUANT_RUNS]


@pytest.mark.parametrize("world,name", _cases(EXACT))
def test_run_follows_jax(hruns, world, name):
    """Losses, gathered masters and params of every rank follow JAX's
    engine of the same config on the same mesh."""
    ref = hruns["jax"][world, JAX_OF[name]]
    for out in hruns["port"][world]:
        got = out["engines"][name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL)
        for path, want in ref["masters"].items():
            np.testing.assert_allclose(got["masters"][path], want,
                                       rtol=0, atol=ATOL, err_msg=path)
        for key, want in ref["params"].items():
            np.testing.assert_allclose(got["params"][key], want, rtol=0,
                                       atol=ATOL, err_msg=key)


@pytest.mark.parametrize("world,name", _cases(QUANT_RUNS))
def test_quantized_wire_before_the_host_copy_follows_jax(hruns, world,
                                                         name):
    """qgZ with the offload tier and with ZenFlow: the int8 wire reduces
    each gradient to the rank's block before it crosses to the host;
    losses and params follow JAX's quantized engine within the ZeRO++
    tests' bounds."""
    ref = hruns["jax"][world, name]
    for out in hruns["port"][world]:
        got = out["engines"][name]
        assert got["flags"]["_qgz_stage3"]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=Q_RTOL, atol=ATOL)
        for key, want in ref["params"].items():
            diff = np.abs(got["params"][key] - want)
            off = diff > ATOL + Q_RTOL * np.abs(want)
            assert off.mean() <= TIE_SHARE, (key, int(off.sum()))
            assert diff.max() <= TIE_BOUND, (key, float(diff.max()))


@pytest.mark.parametrize("name", sorted(CLIENT_RUNS))
def test_client_optimizer_over_blocks_equals_world_one(hruns, name):
    """A client torch.optim.AdamW at stages 1-3 over 2 fsdp ranks steps
    whole leaves (gathered from the blocks, cut back): losses and params
    equal the same optimizer at world size 1."""
    ref = hruns["one"][name]
    for out in hruns["port"][2]:
        got = out["engines"][name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL)
        for key, want in ref["params"].items():
            np.testing.assert_allclose(got["params"][key], want, rtol=0,
                                       atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name", sorted(CKPT_RUNS))
def test_host_tier_checkpoint_resumes_bit_identical(hruns, name):
    """Each rank saves its own host blocks (``offload_optim_rank<r>``,
    ``zenflow_rank<r>``); a fresh engine at the same world size resumes
    the uninterrupted run bit for bit, and one loaded without its
    optimizer state re-seeds its masters from the params."""
    for out in hruns["port"][2]:
        got = out["engines"][name]["ckpt"]
        assert got["again"] == got["more"]
        for key, want in got["saved_params"].items():
            np.testing.assert_array_equal(got["reseed_params"][key], want)
    files = os.listdir(os.path.join(str(hruns["root"]), "w2", name,
                                    f"global_step{RUNS[name][2].get('steps', STEPS)}",
                                    "state"))
    stem = "zenflow_rank" if "zen" in name else "offload_optim_rank"
    assert {f"{stem}0", f"{stem}1"} <= set(files)


def test_zenflow_restore_at_one_rank_reslices_the_two_rank_save(hruns):
    """ZenFlow saved at 2 ranks loads at world size 1 (JAX's reslice):
    the masters are the two blocks joined, bit for bit, and the resumed
    steps follow the 2-rank continuation."""
    cfg, _, extra = CKPT_RUNS["ckpt_zen"]
    engine = _port_engine(hruns["params"], cfg)
    steps = extra["steps"]
    engine.load_checkpoint(os.path.join(str(hruns["root"]), "w2",
                                        "ckpt_zen"))
    got = hruns["port"][2][0]["engines"]["ckpt_zen"]
    from deepspeed_tpu_torch.utils import tensor_fragment as tfr

    for path, want in got["masters"].items():
        np.testing.assert_array_equal(
            tfr.safe_get_full_fp32_param(engine, path), want, err_msg=path)
    gas = engine.gradient_accumulation_steps
    batches = _batches(2)
    more = [float(engine.train_batch(iter(batches[:gas])))
            for _ in range(2)]
    np.testing.assert_allclose(more, got["ckpt"]["more"], rtol=RTOL)
    assert engine.global_steps == steps + 2


@pytest.mark.parametrize("world", [2])
def test_overlap_depth_is_pure_schedule(hruns, world):
    """JAX's stage-3 resident overlap at depths 1 and 2 gives the remat'd
    layer loop's bits (the same gathers, layer and reductions issued in
    another order; JAX ``tests/test_param_prefetch_ring.py:149``)."""
    L, gas = MODEL_KW["num_layers"], CONFIG["gradient_accumulation_steps"]
    for out in hruns["port"][world]:
        runs = out["engines"]
        want = runs["overlap_d0"]
        assert want["resident_gathers"] == 0
        for name in ("overlap_d1", "overlap_d2"):
            # each layer gathered in the forward and again in the backward
            assert runs[name]["resident_gathers"] == 2 * L * gas * STEPS
            assert runs[name]["losses"] == want["losses"], name
            for key, value in want["params"].items():
                np.testing.assert_array_equal(runs[name]["params"][key],
                                              value, err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_nvme_tier_keeps_one_swap_directory_a_rank(hruns, world):
    """The NVMe tier's swap files live under ``rank<r>`` of the run's
    path, one directory a rank (JAX's ``rank<process_index>``), each
    holding the rank's blocks only."""
    name = "off_nvme_s1_g2"
    folders = []
    for rank, out in enumerate(hruns["port"][world]):
        host = out["engines"][name]["host"]
        assert os.path.basename(host["swap_folder"]) == f"rank{rank}"
        assert host["swap_files"] > 0
        full = dict(out["engines"][name]["masters"])
        for path, shape in host["shapes"].items():
            assert int(np.prod(shape)) * 2 == full[path.strip("/")].size
        folders.append(host["swap_folder"])
    assert len(set(folders)) == world


@pytest.mark.parametrize("world,name", _cases(["oparam_s2", "oparam_s3"]))
def test_offload_param_streams_beside_the_host_optimizer(hruns, world, name):
    """offload_param across ranks streams the layer stack from the host
    (two fetches a layer a microbatch) beside the per-rank host
    optimizer."""
    L = MODEL_KW["num_layers"]
    for out in hruns["port"][world]:
        host = out["engines"][name]["host"]
        assert host["fetched_layers"] == 2 * L * STEPS


@pytest.mark.parametrize("world,name", [(2, "zen_c_s2"), (4, "zen_c_s2"),
                                        (2, "zen_mp_s2")])
def test_zenflow_schedule_across_ranks(hruns, world, name):
    """Every rank ships, passes and folds on JAX's step schedule: with
    overlap a pass folds at the next interval boundary, without it at
    the step after the ship."""
    cfg, _, extra = RUNS[name]
    zf = cfg["zero_optimization"]["zenflow"]
    ui, steps = zf["update_interval"], extra["steps"]
    ships = steps // ui
    folds = ships - 1 if zf.get("overlap_step", True) else \
        len([s for s in range(2, steps + 1) if (s - 1) % ui == 0])
    for out in hruns["port"][world]:
        counts = out["engines"][name]["host"]["counts"]
        assert counts["ships"] == ships and counts["folds"] == folds
        assert counts["host_passes"] == ships


def test_zenflow_selection_is_global_topk(hruns):
    """The fsdp ranks' selections of every leaf are disjoint where the
    leaf is cut, and together the whole leaf's k = ceil(ratio * size)
    coordinates (the dp replicas select alike)."""
    for world in (2, 4):
        outs = hruns["port"][world]
        for path in outs[0]["engines"]["zen_c_s2"]["host"]["idx"]:
            size = outs[0]["engines"]["zen_c_s2"]["masters"][
                path.strip("/")].size
            k = int(np.ceil(C_ZENFLOW["topk_ratio"] * size))
            host = [o["engines"]["zen_c_s2"]["host"] for o in outs]
            picked = [set(h["idx"][path].tolist()) for h in host]
            cut = int(np.prod(host[0]["shapes"][path])) < size
            if cut:
                assert not picked[0] & picked[1], path
            assert len(picked[0] | picked[1]) == k, path
            if world == 4:  # rank r + 2 is rank r's dp replica
                assert picked[2:] == picked[:2], path


@pytest.mark.parametrize("dim", [0, 1])
def test_distributed_topk_picks_jax_indices_with_ties_across_ranks(dim):
    """Each rank's block candidates, all-gathered and merged by value then
    global index, give ``jax.lax.top_k`` of the whole accumulator: with
    ties planted on both sides of the rank boundary the lower global
    indices win, as in JAX. Also through ``ZenFlowOptimizer``'s own
    selection with a gather that stands in for the ranks."""
    rng = np.random.default_rng(3)
    shape, n, k = (8, 12), 2, 13
    acc = rng.standard_normal(shape).astype(np.float32)
    # ties of the k-th value across the boundary of dim ``dim``
    flat = acc.reshape(-1)
    order = np.argsort(-np.abs(flat), kind="stable")
    tie = abs(float(flat[order[k - 1]]))
    half = shape[dim] // 2
    for pos in ((half - 1, 2), (half, 3), (half + 1, 5), (0, 7)):
        idx = pos if dim == 0 else (pos[1], pos[0] % shape[1])
        acc[idx] = tie * (1 if sum(idx) % 2 else -1)
    jax_idx = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(acc)).reshape(
        -1), k)[1])
    a = torch.from_numpy(acc).abs()
    blocks = [LeafBlock(shape, dim, r, n) for r in range(n)]
    local = [a.narrow(dim, r * shape[dim] // n, shape[dim] // n).reshape(-1)
             for r in range(n)]
    cands = [topk_indices(loc, min(k, loc.numel())) for loc in local]
    values = torch.cat([loc[c] for loc, c in zip(local, cands)])
    glob = torch.cat([b.to_global(c) for b, c in zip(blocks, cands)])
    merged = merge_topk(values, glob, k)
    assert merged.tolist() == jax_idx.tolist()
    # through the optimizer: each rank's selection, from its block
    got = []
    for r, blk in enumerate(blocks):
        calls = iter([values, glob])
        zen = ZenFlowOptimizer(
            {"w": torch.zeros(local[r].numel())},
            ZenFlowConfig(topk_ratio=(k - 0.5) / acc.size),
            blocks={"/w": blk},
            gather=lambda t: next(calls))
        zen._acc[0] = local[r].clone()
        got.append(blk.to_global(zen._topk(0)))
    assert sorted(torch.cat(got).tolist()) == sorted(jax_idx.tolist())
    for blk, sel in zip(blocks, got):
        assert blk.split(sel)[0].all()
