"""Sequence parallelism across ranks (the port's ``parallel/ulysses``,
``parallel/ring_attention``, ``parallel/auto_sp``, the models' sp branch
and the engine at sp) on gloo against the JAX package on meshes of the
CPU devices.

One process is one rank; the ranks of a launch run
``tests/torch_dist_worker.py`` (one launch a world size serves the
file). Ulysses and ring attention hold each rank's output block and
gradients against JAX's functions on the same mesh (fp32, 2e-5 /
``tests/test_ring_attention.py``'s tolerance). The engines train JAX's
tiny dense model from JAX's init (fp32) and follow JAX's engine on a
mesh of the same shape over 3 steps at ``tests/test_torch_zero.py``'s
rtol 1e-5 / atol 1e-4, each rank fed its rows and its sequence block
(``topology.batch_sharding``, the cut after the next-token shift);
config A is JAX's dry run's dense fsdp x tp x sp.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.parallel import auto_sp as jsp
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.parallel.ring_attention import ring_attention as jring
from deepspeed_tpu.parallel.ulysses import ulysses_attention as julysses

from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.parallel import auto_sp as tsp
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.parallel.ring_attention import ring_attention
from deepspeed_tpu_torch.parallel.ulysses import UlyssesSPDataLoaderAdapter

from torch_dist_worker import Ranks

MODEL_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=32, pos_emb="rope",
                norm="rmsnorm", activation="swiglu", tie_embeddings=False,
                remat=True)
CONFIG = {"train_micro_batch_size_per_chip": 2,
          "gradient_accumulation_steps": 1, "bf16": {"enabled": False},
          "gradient_clipping": 1.0, "steps_per_print": 1000,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
# SGD is not scale-invariant: a gradient off by a factor shows (AdamW's
# first steps move each weight by about lr whatever its gradient's size)
SGD = {"optimizer": {"type": "sgd", "params": {"lr": 0.5}}}
MOE_KW = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=64, num_experts=4, top_k=2, remat=False)
MOE_RTOL, MOE_ATOL = 1e-4, 1e-4
STEPS, SEQ, ROWS = 3, 16, 4
RTOL, ATOL = 1e-5, 1e-4
FN_TOL = dict(rtol=2e-5, atol=2e-5)

SP = {"sequence_parallel": True}
RING = {"sequence_parallel": True, "sp_mode": "ring"}
DP2SP2 = {"dp": 2, "sp": 2}
FSDP2SP2 = {"dp": 1, "fsdp": 2, "sp": 2}
# name -> (stage, mesh, the model's sp switches, JAX's reference run)
ENGINES = {
    "ulysses_dp2sp2_sgd": (0, DP2SP2, SP, "ulysses_dp2sp2_sgd"),
    "ulysses_dp2sp2_z0": (0, DP2SP2, SP, "ulysses_dp2sp2"),
    "ulysses_dp2sp2_z1": (1, DP2SP2, SP, "ulysses_dp2sp2"),
    "ulysses_fsdp2sp2_z2": (2, FSDP2SP2, SP, "ulysses_fsdp2sp2"),
    "ulysses_fsdp2sp2_z3": (3, FSDP2SP2, SP, "ulysses_fsdp2sp2"),
    "ring_dp2sp2_z0": (0, DP2SP2, RING, "ring_dp2sp2"),
    "ring_dp2sp2_z1": (1, DP2SP2, RING, "ring_dp2sp2"),
    "ring_fsdp2sp2_z2": (2, FSDP2SP2, RING, "ring_fsdp2sp2"),
    "ring_fsdp2sp2_z3": (3, FSDP2SP2, RING, "ring_fsdp2sp2"),
    # JAX's dry run, config A: dense at fsdp x tp x sp, ZeRO-3
    "config_a_tp2sp2": (3, {"dp": 1, "fsdp": 1, "tp": 2, "sp": 2}, SP,
                        "config_a_tp2sp2"),
    "config_a_fsdp2sp2": (3, FSDP2SP2, SP, "ulysses_fsdp2sp2"),
}
# JAX's runs: (stage, mesh, the model's sp switches)
JAX_RUNS = {
    "ulysses_dp2sp2_sgd": (0, DP2SP2, SP),
    "ulysses_dp2sp2": (0, DP2SP2, SP),
    "ulysses_fsdp2sp2": (3, FSDP2SP2, SP),
    "ring_dp2sp2": (0, DP2SP2, RING),
    "ring_fsdp2sp2": (3, FSDP2SP2, RING),
    "config_a_tp2sp2": (3, {"dp": 1, "fsdp": 1, "tp": 2, "sp": 2}, SP),
}


def _data_ranks(mesh):
    return mesh.get("dp", 1) * mesh.get("fsdp", 1) * mesh.get("ep", 1)


def _config(stage, mesh, name=""):
    """The run's config: the same 4 rows a step on every mesh."""
    return dict(CONFIG, zero_optimization={"stage": stage},
                train_micro_batch_size_per_chip=ROWS // _data_ranks(mesh),
                **(SGD if name.endswith("_sgd") else {}))


def _batches(n, rows=ROWS, vocab=MODEL_KW["vocab_size"], seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (rows, SEQ + 1)).astype(
        np.int32)} for _ in range(n)]


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_params(model):
    jtopo._GLOBAL_MESH = None
    engine, *_ = dstpu.initialize(
        model=model,
        mesh=jtopo.build_mesh({"dp": 1}, devices=jax.devices()[:1]),
        config=dict(CONFIG, zero_optimization={"stage": 0}))
    params = _np(engine.params)
    jtopo._GLOBAL_MESH = None
    return params


# the MoE model at sp (ep 2 x sp 2, each rank routing its own tokens),
# and at ep 2 x tp 2 without sp, both at ZeRO-1: before this file an
# expert gradient at stages 0-1 was cut to this rank's experts twice
MOE_SP_MESH = {"dp": 1, "ep": 2, "sp": 2}
MOE_SP_CONFIG = dict(CONFIG, train_micro_batch_size_per_chip=1,
                     zero_optimization={"stage": 1},
                     moe={"enabled": True}, **SGD)
# name -> (mesh, the model's sp switches)
MOE_RUNS = {"moe_ep2sp2": (MOE_SP_MESH, SP),
            "moe_ep2tp2": ({"dp": 1, "ep": 2, "tp": 2}, {})}


def _jax_engine_run(name):
    jtopo._GLOBAL_MESH = None
    if name in MOE_RUNS:
        mesh, over = MOE_RUNS[name]
        model = jax_get_model("tiny-moe", dtype=jnp.float32, **MOE_KW,
                              **over)
        config = MOE_SP_CONFIG
        batches = _batches(STEPS, rows=2, vocab=MOE_KW["vocab_size"])
    else:
        stage, mesh, over = JAX_RUNS[name]
        model = JaxLM(JaxConfig(dtype=jnp.float32, **MODEL_KW, **over))
        config, batches = _config(stage, mesh, name), _batches(STEPS)
    engine, *_ = dstpu.initialize(
        model=model, config=config,
        mesh=jtopo.build_mesh(mesh, devices=jax.devices()[:4]))
    losses = [float(engine.train_batch(iter([b]))) for b in batches]
    out = {"losses": losses, "params": engine.module_state_dict(),
           "model": {k: getattr(engine.module.config, k) for k in
                     ("sequence_parallel", "sp_mode", "attn_chunks")}}
    jtopo._GLOBAL_MESH = None
    return out


# -- the attention functions -------------------------------------------------


def _attn_case(name, kind, mesh, world, *, causal=True, S=16, N=4,
               seg=False, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, proj = (rng.standard_normal((2, S, N, 8)).astype(np.float32)
                     for _ in range(4))
    case = {"name": name, "kind": kind, "mesh": mesh, "worlds": (world,),
            "causal": causal, "q": q, "k": k, "v": v, "proj": proj}
    if seg:
        case["seg"] = np.stack([np.repeat(np.arange(4), S // 4),
                                np.repeat(np.arange(2), S // 2)]).astype(
            np.int32)
    return case


SP2, SP4 = {"sp": 2, "dp": 1}, {"sp": 4, "dp": 1}
SP_CASES = [
    _attn_case("ulysses_sp2", "ulysses", SP2, 2),
    _attn_case("ulysses_sp4", "ulysses", SP4, 4, seed=1),
    _attn_case("ulysses_tp2sp2", "ulysses", {"tp": 2, "sp": 2, "dp": 1}, 4,
               N=8, seed=2),
    _attn_case("ulysses_sp2_segments", "ulysses", SP2, 2, seg=True,
               seed=3),
    _attn_case("ring_sp2_causal", "ring", SP2, 2, seed=4),
    _attn_case("ring_sp2_full", "ring", SP2, 2, causal=False, seed=5),
    _attn_case("ring_sp4_causal", "ring", SP4, 4, seed=6),
    # sp (4) over the head count (2): the ring's reason to be
    _attn_case("ring_sp4_over_heads", "ring", SP4, 4, S=32, N=2, seed=7),
    _attn_case("ring_sp2_segments", "ring", SP2, 2, seg=True, seed=8),
    _attn_case("ring_sp4_segments_full", "ring", SP4, 4, causal=False,
               seg=True, seed=9),
    # a sequence the ring pads to its size (30 -> 32)
    _attn_case("ring_sp4_padded", "ring", SP4, 4, S=30, seed=10),
]


def _jax_attn(case):
    world = case["worlds"][0]
    mesh = jtopo.build_mesh(case["mesh"], devices=jax.devices()[:world])
    jtopo.set_global_mesh(mesh)
    seg = None if case.get("seg") is None else jnp.asarray(case["seg"])
    proj = jnp.asarray(case["proj"])

    def loss(q, k, v):
        if case["kind"] == "ulysses":
            out = julysses(q, k, v, causal=case["causal"], impl="xla",
                           segment_ids=seg)
        else:
            out = jring(q, k, v, causal=case["causal"], segment_ids=seg)
        return jnp.sum(out * proj), out

    args = tuple(jnp.asarray(case[n]) for n in ("q", "k", "v"))
    with mesh:
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(*args)
    jtopo._GLOBAL_MESH = None
    return {"out": np.asarray(out), "dq": np.asarray(grads[0]),
            "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}


@pytest.fixture(scope="module")
def sruns(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    params = _jax_params(JaxLM(JaxConfig(dtype=jnp.float32, **MODEL_KW)))
    moe_params = _jax_params(jax_get_model("tiny-moe", dtype=jnp.float32,
                                           **MOE_KW))
    runs = [{"name": name, "worlds": (4,),
             "config": _config(stage, mesh, name),
             "topology": mesh, "steps": STEPS, "model_over": over}
            for name, (stage, mesh, over, _) in ENGINES.items()]
    runs += [{"name": name, "worlds": (4,), "moe": True,
              "config": MOE_SP_CONFIG, "topology": mesh, "steps": STEPS,
              "model_over": over} for name, (mesh, over) in MOE_RUNS.items()]
    jobs = {}
    for world in (2, 4):
        work = str(root / f"w{world}")
        modes = "sp_fn,sp_raises" if world == 2 else "sp_fn,engines"
        jobs[world] = Ranks(modes, work, world, dict(
            preset=None, model_kw=MODEL_KW, params=params, config=CONFIG,
            moe_kw=MOE_KW, moe_params=moe_params,
            moe_batches=_batches(STEPS, rows=2,
                                 vocab=MOE_KW["vocab_size"]),
            batches=_batches(STEPS), runs=runs, sp_cases=SP_CASES,
            workdir=work))
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futures = {name: pool.submit(_jax_engine_run, name)
                   for name in list(JAX_RUNS) + list(MOE_RUNS)}
        ref = {"attn": {c["name"]: _jax_attn(c) for c in SP_CASES},
               "engines": {name: f.result() for name, f in futures.items()}}
    port = {w: job.join() for w, job in jobs.items()}
    jtopo._GLOBAL_MESH = None
    return {"ref": ref, "port": port}


@pytest.mark.parametrize("name", [c["name"] for c in SP_CASES])
def test_sp_attention_follows_jax(sruns, name):
    case = next(c for c in SP_CASES if c["name"] == name)
    ref = sruns["ref"]["attn"][name]
    S = case["q"].shape[1]
    outs = sruns["port"][case["worlds"][0]]
    for out in outs:
        got = out["sp_fn"][name]
        si, ti, s_loc = got["sp_index"], got["tp_index"], got["s_loc"]
        nh = got["out"].shape[2]
        lo = si * s_loc
        valid = max(0, min(s_loc, S - lo))
        for key in ("out", "dq", "dk", "dv"):
            want = ref[key][:, lo:lo + valid, ti * nh:(ti + 1) * nh]
            np.testing.assert_allclose(got[key][:, :valid], want,
                                       err_msg=f"{name} {key}", **FN_TOL)
        counts = got["counts"]
        if case["kind"] == "ulysses":
            # q, k and v in, the output back, and the inverse exchanges
            assert counts["ulysses_qkv"] == 3, counts
            assert counts["ulysses_out"] == 1, counts
            assert counts["ulysses_qkv_grad"] == 3, counts
        else:
            hops = case["mesh"]["sp"] - 1  # no hop after the last step
            assert counts["ring_attention_kv"] == 2 * hops, counts
            assert counts["ring_attention_kv_grad"] == 2 * hops, counts
            assert got["fallback"] == 0


def test_ring_dense_fallback_is_counted():
    """Without sp ranks the ring is dense attention, counted as JAX counts
    it (``tests/test_ring_attention.py``)."""
    from deepspeed_tpu.ops.attention import xla_attention
    from deepspeed_tpu.utils import telemetry as jtel
    from deepspeed_tpu_torch.utils import telemetry

    case = SP_CASES[4]
    jtopo._GLOBAL_MESH = None
    ttopo.set_global_mesh(None)
    telemetry.reset()
    jtel.reset()
    args = [case[n] for n in ("q", "k", "v")]
    got = ring_attention(*(torch.tensor(a) for a in args), causal=True)
    want = jring(*(jnp.asarray(a) for a in args), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    np.testing.assert_allclose(
        np.asarray(want), np.asarray(xla_attention(
            *(jnp.asarray(a) for a in args), causal=True)), **FN_TOL)
    assert telemetry.get("ring_attention.dense_fallback") == 1 == \
        jtel.get("ring_attention.dense_fallback")


# -- the engines --------------------------------------------------------------


@pytest.mark.parametrize("name", list(ENGINES))
def test_sp_engine_follows_jax(sruns, name):
    stage, mesh, over, ref_name = ENGINES[name]
    ref = sruns["ref"]["engines"][ref_name]
    assert ref["model"]["sequence_parallel"]
    for out in sruns["port"][4]:
        got = out["engines"][name]
        assert got["mesh"]["sp"] == 2
        assert got["model"] == ref["model"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        assert set(got["params"]) == set(ref["params"])
        for key, want in ref["params"].items():
            np.testing.assert_allclose(got["params"][key], want, rtol=RTOL,
                                       atol=ATOL, err_msg=key)
        if name.startswith("ulysses"):
            counts = got["counts"]
            # 2 layers x 3 steps: q, k, v and the output a layer, and the
            # recompute of each remat'd layer in the backward
            assert counts["ulysses_qkv"] == 2 * 3 * 3 * 2, counts
            assert counts["ulysses_out"] == 2 * 3 * 2, counts


@pytest.mark.parametrize("name", list(MOE_RUNS))
def test_moe_sp_engine_follows_jax(sruns, name):
    """The MoE model at sp (ep 2 x sp 2): the KV heads repeated before
    Ulysses, each rank routing its sequence block's tokens, the routing
    statistics averaged over the ep and sp ranks; and at ep 2 x tp 2.
    SGD at ZeRO-1: a gradient off by a factor, or an expert gradient cut
    to the wrong experts, shows."""
    mesh, over = MOE_RUNS[name]
    ref = sruns["ref"]["engines"][name]
    for out in sruns["port"][4]:
        got = out["engines"][name]
        assert got["mesh"]["ep"] == 2 and got["local_experts"] == 2
        assert got["model"]["sequence_parallel"] == bool(over)
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=MOE_RTOL, atol=MOE_ATOL)
        for key, want in ref["params"].items():
            np.testing.assert_allclose(got["params"][key], want,
                                       rtol=MOE_RTOL, atol=MOE_ATOL,
                                       err_msg=key)


def test_sp_ranks_agree(sruns):
    """Every rank of a run holds the same losses and params (the sp ranks
    hold the same state)."""
    outs = sruns["port"][4]
    for name in ENGINES:
        first = outs[0]["engines"][name]
        for out in outs[1:]:
            got = out["engines"][name]
            assert got["losses"] == first["losses"], name
            for key, want in first["params"].items():
                np.testing.assert_array_equal(got["params"][key], want,
                                              err_msg=f"{name} {key}")


# what JAX's engine does with ZeRO++, the 1-bit optimizers and a client
# optimizer at sp 2 / pp 2 (tests/test_torch_zeropp_3d_small.py holds the
# numbers): qwZ arms at sp, qgZ at stage 2 on pp has nothing to carry it
# and warns, 1-bit Adam and a client optimizer train; the flag each arms
ARMED = {"qwz_sp": "_qwz_stage3", "onebit_sp": "_onebit"}


@pytest.mark.parametrize("case,kind,words", [
    ("qwz_sp", "trained", ""),
    ("qgz_pp", "trained", "ZeRO++ flags (qwZ/qgZ) are wired for"),
    ("onebit_sp", "trained", ""),
    ("client_pp", "trained", ""),
    ("offload_param_pp", ValueError, "offload_param does not compose with "
     "the pipeline-parallel layer path yet"),
    ("fpdt_host_kv_sp", NotImplementedError, "item 11's sp part"),
    ("dense_model_sp", ValueError, "needs sequence_parallel=True"),
    ("unshifted_sp", ValueError, "after the next-token shift"),
])
def test_sp_and_pp_leftovers_raise(sruns, case, kind, words):
    for out in sruns["port"][2]:
        got = out["sp_raises"][case]
        assert got is not None, case
        if kind == "trained":  # follows JAX's engine, which trains it
            assert got[0] == "trained" and words in got[1], (case, got)
            flags = got[2]
            assert flags == {k: k == ARMED.get(case) for k in flags}, flags
            continue
        assert got[0] == kind.__name__ and words in got[1], got


def test_fpdt_host_residual_with_sp_raises_jax_words():
    with pytest.raises(ValueError) as want:
        JaxConfig(fpdt_host_kv=True, fpdt_host_residual=True,
                  sequence_parallel=True)
    with pytest.raises(ValueError) as got:
        TransformerConfig(fpdt_host_kv=True, fpdt_host_residual=True,
                          sequence_parallel=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JaxConfig(sp_mode="bogus")
    with pytest.raises(ValueError) as got:
        TransformerConfig(sp_mode="bogus")
    assert str(got.value) == str(want.value)


# -- AutoSP: JAX's own grid, no ranks -----------------------------------------


@pytest.mark.parametrize("heads,kv,sp", [
    (8, 8, 1), (8, 8, 0), (8, 8, 4), (8, 2, 2), (8, 2, 4), (8, None, 4),
    (6, 6, 4), (2, 2, 4), (32, 8, 8), (32, 8, 16)])
def test_detect_sp_strategy_equals_jax(heads, kv, sp):
    assert tsp.detect_sp_strategy(heads, kv, sp) == \
        jsp.detect_sp_strategy(heads, kv, sp)


@pytest.mark.parametrize("args,kw", [
    ((4096, 8, 8, None), {}),
    ((65536, 8, 8, 4), {}), ((65536, 8, 2, 4), {}),
    ((262144, 32, 8, 8), {}), ((1048576, 32, 8, 16), {}),
    ((262144, 8, 8, 4), {}), ((1048576, 8, 8, 8), {}),
    ((98304, 8, 8, 4), {}),
    ((1048576, 32, 8, 8, None), {}),
    ((1048576, 32, 8, 8, 8 * 2 ** 30), {"head_dim": 128}),
    ((8192, 8, 8, 4, 64 * 2 ** 30), {"head_dim": 64}),
    ((262144, 32, 8, 8, 4 * 2 ** 30), {}),
    ((32768, 32, 8, 2, 2 ** 30), {"hidden_size": 4096, "batch_size": 2}),
    ((30, 4, 4, 4, 2 ** 20), {}),
])
def test_plan_sequence_parallel_equals_jax(args, kw):
    """The same plan; the reasons say the same but for the note on the
    backend's memories, which each package states of its own (JAX's CPU
    devices have a host memory kind, a torch CPU build no second
    memory)."""
    from deepspeed_tpu.utils import memspace as jmem
    from deepspeed_tpu_torch.utils import memspace as tmem

    got = dict(tsp.plan_sequence_parallel(*args, **kw).__dict__)
    want = dict(jsp.plan_sequence_parallel(*args, **kw).__dict__)
    note = "single-memory backend"
    for plan, supported in ((got, tmem.memories_supported()),
                            (want, jmem.memories_supported())):
        kept = tuple(r for r in plan["reasons"] if note not in r)
        noted = len(kept) != len(plan["reasons"])
        assert noted == (plan["fpdt_host_kv"] and not supported)
        plan["reasons"] = kept
    assert got == want


@pytest.mark.parametrize("plan,cfg_kw", [
    (dict(strategy="ring", sp_degree=4, attn_chunks=4, fpdt_host_kv=True,
          overlap_depth_hint=2), {}),
    (dict(strategy="ring", sp_degree=4, attn_chunks=4, fpdt_host_kv=True,
          overlap_depth_hint=3),
     dict(sequence_parallel=True, sp_mode="ulysses", attn_chunks=8,
          fpdt_host_kv=True)),
    (dict(strategy=None, sp_degree=1, attn_chunks=0, fpdt_host_kv=False),
     {}),
])
def test_sp_plan_apply_equals_jax(plan, cfg_kw):
    base = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                num_kv_heads=2, max_seq_len=128, **cfg_kw)
    # the explicit config names an overlap_depth too (both configs have
    # the field: the stage-3 overlap stream), which the plan's hint leaves
    over = {"overlap_depth": 1} if cfg_kw else {}
    tcfg = TransformerConfig(**base, **over)
    jcfg = JaxConfig(**base, **over)
    tout = tsp.SPPlan(**plan).apply(tcfg)
    jout = jsp.SPPlan(**plan).apply(jcfg)
    assert (tout is tcfg) == (jout is jcfg)
    for field in ("sequence_parallel", "sp_mode", "attn_chunks",
                  "fpdt_host_kv", "overlap_depth"):
        assert getattr(tout, field) == getattr(jout, field), field


@pytest.mark.parametrize("topology,kw,want", [
    ({"dp": 2, "sp": 4}, dict(num_kv_heads=2,
                              sequence_parallel_block=(4, True)),
     ("ring", True)),
    ({"dp": 2, "sp": 4}, dict(sequence_parallel_block=None), (None, False)),
    ({"dp": 2, "sp": 4}, dict(sequence_parallel_block=(4, False)),
     (None, False)),
    ({"dp": 4, "sp": 2}, dict(sequence_parallel_block=(2, True)),
     ("ulysses", True)),
])
def test_engine_applies_the_planner_as_jax(topology, kw, want):
    """JAX's opt-in rule (``tests/test_auto_sp.py``): the planner composes
    onto the model's config at init with an sp axis and the
    ``sequence_parallel`` block (or the model's switch); an sp axis alone
    or ``auto_plan`` False leaves it. The mesh names 8 ranks without a
    process group (its shape only)."""
    from deepspeed_tpu_torch.config.config import load_config
    from deepspeed_tpu_torch.runtime.engine import Engine

    kw = dict(kw)
    block = kw.pop("sequence_parallel_block")
    model_kw = dict(vocab_size=64, hidden_size=32, num_layers=1,
                    num_heads=4, max_seq_len=64, remat=False,
                    dtype=torch.float32, **kw)
    config = {"train_micro_batch_size_per_chip": 1,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "zero_optimization": {"stage": 0}}
    if block is not None:
        config["sequence_parallel"] = {"size": block[0],
                                       "auto_plan": block[1]}
    mesh = ttopo.build_mesh(topology, devices=range(8))
    engine = Engine(zoo.get_model("tiny", device="cpu", **model_kw),
                    load_config(config),
                    device="cpu", mesh=mesh)
    strategy, on = want
    assert (engine.sp_plan.strategy if engine.sp_plan else None) == strategy
    assert engine.model_config.sequence_parallel is on
    if on:
        assert engine.model_config.sp_mode == strategy
    ttopo.set_global_mesh(None)


def test_auto_wrap_keeps_the_weights():
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                          vocab_size=64, hidden_size=32, num_layers=1,
                          num_heads=4, num_kv_heads=2, max_seq_len=64)
    mesh = ttopo.build_mesh({"dp": 1, "sp": 4}, devices=range(4))
    wrapped = tsp.auto_wrap_model_for_sp(model, mesh=mesh)
    assert wrapped is not model
    assert wrapped.config.sequence_parallel and \
        wrapped.config.sp_mode == "ring"  # kv 2 < sp 4
    assert wrapped.params()["embed"]["tokens"] is \
        model.params()["embed"]["tokens"]
    assert tsp.auto_wrap_model_for_sp(model, mesh=None) is model


# -- the data cut -------------------------------------------------------------


@pytest.mark.parametrize("rank", range(8))
def test_sp_dataloader_adapter_cuts_after_the_shift(rank):
    """Rank r's block of the shifted inputs and labels is what JAX's
    ``batch_sharding`` (batch over the data axes, sequence over sp) places
    on device r of the same mesh."""
    case = {"dp": 2, "fsdp": 2, "sp": 2}
    jm = jtopo.build_mesh(jtopo.TopologyConfig(**case),
                          devices=jax.devices()[:8])
    tm = ttopo.build_mesh(case, devices=range(8))
    tm.rank = rank
    tokens = np.arange(8 * 17).reshape(8, 17)
    got = next(iter(UlyssesSPDataLoaderAdapter([{"input_ids": tokens}],
                                               tm)))
    sh = jtopo.batch_sharding(jm)
    idx = sh.devices_indices_map((8, 16))[jax.devices()[rank]]
    np.testing.assert_array_equal(got["input_ids"], tokens[:, :-1][idx])
    np.testing.assert_array_equal(got["labels"], tokens[:, 1:][idx])
    assert got["loss_mask"].shape == got["labels"].shape
    assert got["loss_mask"].all()
    # a sequence that does not split is padded at its end, masked out
    odd = ttopo.BatchSlice(0, 1, 3, 4).take({"input_ids": tokens[:, :16]})
    assert odd["input_ids"].shape == (8, 4)
    np.testing.assert_array_equal(odd["loss_mask"][:, -1], 0)
