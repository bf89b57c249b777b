"""What ``tests/test_torch_zeropp_3d*.py`` share: the model (dry-run config
D's Llama-3-8B at hidden 64), the runs' configs and global batches, JAX's
engine on the same config and mesh in a fresh process, and the port's
ranks.

Every run trains from JAX's own init (fp32 compute, as the port's other
parity tests: ROADMAP C3) on the same global batches, each rank fed its
rows and its sequence block (``topology.batch_sharding``). A JAX engine
with stage-3 qwZ races concurrent collective rendezvous on the CPU
simulator (``tests/test_zeropp.py:192-214``), so every JAX engine runs in
a process of its own.
"""

import logging
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from torch_dist_worker import Ranks, WarningRecorder

PRESET = "llama3-8b"
# dry-run config D's model (``__graft_entry__.py:181-183``)
MODEL_KW = dict(num_layers=2, hidden_size=64, ffn_size=128, num_heads=8,
                num_kv_heads=4, vocab_size=256, max_seq_len=64, remat=False)
CONFIG = {"train_micro_batch_size_per_chip": 2,
          "gradient_accumulation_steps": 1, "bf16": {"enabled": False},
          "gradient_clipping": 1.0, "steps_per_print": 1000,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
# the global rows a microbatch, and its tokens (config D's 33-token rows)
ROWS, SEQ, STEPS = 8, 32, 2
SP = {"sequence_parallel": True}

# tests/test_torch_zeropp.py's bounds: the exact stages follow JAX at
# rtol 1e-5 / atol 1e-4; a quantized engine's code may flip at a rounding
# tie, so at most TIE_SHARE of a leaf's elements may part by more than
# ATOL, and then by no more than TIE_BOUND
EXACT_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-4
TIE_SHARE, TIE_BOUND = 1e-3, 2e-2
TRACK_RTOL = 0.05  # JAX's own bound for one mesh against another


def z(stage, **kw):
    return {"zero_optimization": dict(stage=stage, **kw)}


def onebit(freeze, kind="onebitadam", lr=1e-3, **kw):
    return {"optimizer": {"type": kind, "params": dict(
        lr=lr, freeze_step=freeze, **kw)}, **z(0)}


def data_ranks(mesh):
    return int(np.prod([mesh.get(a, 1) for a in ("dp", "fsdp", "ep")]))


def world_of(mesh):
    return int(np.prod([v for v in mesh.values()]))


def run(name, cfg, mesh, over=None, steps=STEPS, micro=None, gas=1,
        client=None, raises=False, masters=False, default_mesh=False):
    """One run: its config over CONFIG (micro so that a microbatch is ROWS
    global rows unless given), its mesh (the topology; with
    ``default_mesh`` the engines build their own from the config, and
    ``mesh`` says what it comes to), the model's switches, steps, a
    client AdamW's lr."""
    micro = micro or max(1, ROWS // data_ranks(mesh))
    config = dict(cfg, train_micro_batch_size_per_chip=micro,
                  gradient_accumulation_steps=gas)
    return {"name": name, "config": config,
            "topology": None if default_mesh else mesh, "mesh": mesh,
            "worlds": (world_of(mesh),), "steps": steps,
            "model_over": over or {}, "client": client, "raises": raises,
            "masters": masters,
            "batches": f"batches_{micro * data_ranks(mesh)}"}


def batches(rows, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, MODEL_KW["vocab_size"],
                                       (rows, SEQ + 1)).astype(np.int32)}
            for _ in range(n)]


def batch_sets(runs, n=8):
    """The global batches by rows a microbatch (every run of one size
    reads the same ones)."""
    sizes = {int(r["batches"].split("_")[1]) for r in runs}
    return {f"batches_{rows}": batches(rows, n) for rows in sizes}


# -- JAX ----------------------------------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as dstpu
    from deepspeed_tpu.models.zoo import get_model
    from deepspeed_tpu.parallel import topology as jtopo

    return jax, jnp, dstpu, get_model, jtopo


def jax_params():
    """JAX's init of the model (every run starts from it)."""
    jax, jnp, dstpu, get_model, jtopo = _jax()
    jtopo._GLOBAL_MESH = None
    engine, *_ = dstpu.initialize(
        model=get_model(PRESET, dtype=jnp.float32, **MODEL_KW),
        mesh=jtopo.build_mesh({"dp": 1}, devices=jax.devices()[:1]),
        config=dict(CONFIG, **z(0)))
    out = jax.tree.map(lambda a: np.asarray(a, np.float32), engine.params)
    jtopo._GLOBAL_MESH = None
    return out


def jax_run(spec, sets):
    """JAX's engine on ``spec``'s config and mesh (a process of its own):
    losses, params, the fp32 masters (``masters``), its ZeRO++ flags,
    telemetry and warnings; or the exception a ``raises`` run gives."""
    jax, jnp, dstpu, get_model, jtopo = _jax()
    from deepspeed_tpu.utils import telemetry
    from deepspeed_tpu.utils import tensor_fragment as jtfr

    jtopo._GLOBAL_MESH = None
    telemetry.reset()
    warned = WarningRecorder()
    log = logging.getLogger("deepspeed_tpu")
    log.addHandler(warned)
    mesh = spec["mesh"]
    kw = {}
    if spec.get("client"):
        import optax

        kw["optimizer"] = optax.adamw(spec["client"], weight_decay=0.01)
    model = get_model(PRESET, dtype=jnp.float32,
                      **{**MODEL_KW, **spec["model_over"]})
    try:
        if spec["topology"] is not None:
            kw["mesh"] = jtopo.build_mesh(
                mesh, devices=jax.devices()[:world_of(mesh)])
        engine, *_ = dstpu.initialize(
            model=model, config=dict(CONFIG, **spec["config"]), **kw)
        gas = engine.gradient_accumulation_steps
        data = sets[spec["batches"]]
        losses = [float(engine.train_batch(iter(
            data[(s * gas) % len(data):][:gas])))
            for s in range(spec["steps"])]
    except (ValueError, NotImplementedError) as e:
        if not spec.get("raises"):
            raise
        return {"raised": (type(e).__name__, str(e))}
    out = {"losses": losses, "params": engine.module_state_dict(),
           "flags": {k: bool(getattr(engine, k, False)) for k in
                     ("_zeropp", "_onebit", "_qwz_stage3", "_qgz_stage3")},
           "telemetry": {k: telemetry.get(k) for k in
                         ("zeropp.qwz_disabled", "zeropp.qgz_disabled")},
           "warnings": warned.messages, "mesh": dict(engine.mesh.shape)}
    if engine._onebit:  # the 1-bit momentum, by "/" paths
        flat, _ = jax.tree_util.tree_flatten_with_path(
            engine._onebit_state.m)
        out["onebit_m"] = {"/".join(k.key for k in kp): np.asarray(
            v, np.float32) for kp, v in flat}
    if spec.get("masters"):
        out["masters"] = {   # by the port's record's "/" paths
            k.replace(".", "/"): np.asarray(jtfr.safe_get_full_fp32_param(
                engine, k.replace(".", "/")), np.float32)
            for k in out["params"]}
    log.removeHandler(warned)
    jtopo._GLOBAL_MESH = None
    return out


def run_all(root, runs, jax_specs, worlds, procs=3):
    """The port's ranks at each world size (one launch a world) beside
    JAX's engines (each in a fresh spawned process): ({name: JAX's
    result}, {world: [each rank's outputs]})."""
    params = jax_params()
    sets = batch_sets(runs + list(jax_specs.values()))
    jobs = {}
    for world in worlds:
        work = str(root / f"w{world}")
        jobs[world] = Ranks("engines", work, world, dict(
            preset=PRESET, model_kw=MODEL_KW, params=params, config=CONFIG,
            runs=[r for r in runs if world in r["worlds"]], workdir=work,
            **sets), timeout=600)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(procs, mp_context=ctx,
                             max_tasks_per_child=1) as pool:
        futures = {name: pool.submit(jax_run, spec, sets)
                   for name, spec in jax_specs.items()}
        ref = {name: f.result() for name, f in futures.items()}
    port = {w: job.join() for w, job in jobs.items()}
    return ref, port


# -- the bounds ---------------------------------------------------------------


def follows(got, ref, rtol=RTOL, key="params"):
    """Losses at ``rtol`` / ATOL, every leaf within the tie rule."""
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=rtol,
                               atol=ATOL)
    leaves_follow(got[key], ref[key], rtol, ATOL)


def leaves_follow(got, ref, rtol, atol, bound=TIE_BOUND):
    """At most TIE_SHARE of each leaf's elements past ``atol + rtol *
    |ref|``, and none past ``bound``."""
    for leaf, want in ref.items():
        diff = np.abs(got[leaf] - want)
        off = diff > atol + rtol * np.abs(want)
        assert off.mean() <= TIE_SHARE, (leaf, int(off.sum()), want.size)
        assert diff.max() <= bound, (leaf, float(diff.max()))


def follows_exactly(got, ref, key="params"):
    """An exact step: losses at rtol 1e-5, every leaf at atol 1e-4."""
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=EXACT_RTOL, atol=ATOL)
    for leaf, want in ref[key].items():
        np.testing.assert_allclose(got[key][leaf], want, rtol=EXACT_RTOL,
                                   atol=ATOL, err_msg=leaf)


def same_on_every_rank(outs, name):
    first = outs[0]["engines"][name]
    for out in outs[1:]:
        got = out["engines"][name]
        assert got["losses"] == first["losses"], name
