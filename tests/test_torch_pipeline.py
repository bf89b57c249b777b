"""Pipeline parallelism across ranks (the port's ``parallel/pipeline``,
the models' pipeline branch, the engine and the checkpoint at pp) on
gloo against the JAX package on meshes of the CPU devices.

One process is one rank; the ranks of a launch run
``tests/torch_dist_worker.py`` (one launch a world size serves the
file). ``pipelined_layers`` holds each stage's output and gradients
against JAX's scan over the same layers (JAX's
``tests/test_pipeline.py`` layer, 1e-5). The engines train JAX's tiny
dense model (and config B's tiny MoE) from JAX's init (fp32) and follow
JAX's engine on a mesh of the same shape over 3 steps at
``tests/test_torch_zero.py``'s rtol 1e-5 / atol 1e-4 (the MoE run at
``tests/test_torch_moe_ep.py``'s); config B is JAX's dry run's MoE at
pp x ep, whose tokens must not replicate.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu as dstpu
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.parallel import topology as jtopo

from deepspeed_tpu_torch.parallel.pipeline import microbatch_plan

from torch_dist_worker import Ranks

MODEL_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=32, pos_emb="rope",
                norm="rmsnorm", activation="swiglu", tie_embeddings=False,
                remat=True)
MOE_KW = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=64, num_experts=4, top_k=2, remat=False)
CONFIG = {"train_micro_batch_size_per_chip": 2,
          "gradient_accumulation_steps": 1, "bf16": {"enabled": False},
          "gradient_clipping": 1.0, "steps_per_print": 1000,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
# SGD is not scale-invariant: a gradient off by a factor shows
SGD = {"optimizer": {"type": "sgd", "params": {"lr": 0.5}}}
STEPS, SEQ, ROWS = 3, 16, 4
RTOL, ATOL = 1e-5, 1e-4
MOE_RTOL, MOE_ATOL = 1e-4, 1e-4

PP2 = {"pp": 2, "dp": 1}
PP2DP2 = {"pp": 2, "dp": 2}
PP2FSDP2 = {"pp": 2, "dp": 1, "fsdp": 2}
PP2TP2 = {"pp": 2, "dp": 1, "tp": 2}
# name -> (stage, mesh, world, extra config, model switches, JAX's run)
ENGINES = {
    "pp2_z0": (0, PP2, 2, {}, {}, "pp2"),
    "pp2_sgd": (0, PP2, 2, SGD, {}, "pp2_sgd"),
    "pp2_z3_save_boundaries": (3, PP2, 2, {"pipeline": {
        "schedule": "save_boundaries"}}, {}, "pp2"),
    "pp2_waves_m4_w2": (1, PP2, 2, {"pipeline": {
        "microbatches": 4, "window": 2}}, {}, "pp2"),
    "pp2_tied": (0, PP2, 2, {}, {"tie_embeddings": True}, "pp2_tied"),
    "pp2dp2_z0": (0, PP2DP2, 4, {}, {}, "pp2dp2"),
    "pp2dp2_z1": (1, PP2DP2, 4, {}, {}, "pp2dp2"),
    "pp2fsdp2_z2": (2, PP2FSDP2, 4, {}, {}, "pp2fsdp2"),
    "pp2fsdp2_z3": (3, PP2FSDP2, 4, {}, {}, "pp2fsdp2"),
    "pp2tp2_z2": (2, PP2TP2, 4, {}, {}, "pp2tp2"),
}
# JAX's runs: (stage, mesh, world, extra config, model switches)
JAX_RUNS = {
    "pp2": (0, PP2, 2, {}, {}),
    "pp2_sgd": (0, PP2, 2, SGD, {}),
    "pp2_tied": (0, PP2, 2, {}, {"tie_embeddings": True}),
    "pp2dp2": (0, PP2DP2, 4, {}, {}),
    "pp2fsdp2": (3, PP2FSDP2, 4, {}, {}),
    "pp2tp2": (2, PP2TP2, 4, {}, {}),
}
# JAX's dry run, config B: tiny-moe at pp 2 x ep 2, ZeRO-2, one row a
# data rank (a microbatch of one row, its tokens over ep by the sequence)
CONFIG_B = dict(CONFIG, train_micro_batch_size_per_chip=1,
                zero_optimization={"stage": 2}, moe={"enabled": True},
                **SGD)
CONFIG_B_MESH = {"pp": 2, "ep": 2, "dp": 1}


def _data_ranks(mesh):
    return mesh.get("dp", 1) * mesh.get("fsdp", 1) * mesh.get("ep", 1)


def _config(stage, mesh, extra):
    """The run's config: the same 4 rows a step on every mesh."""
    return dict(CONFIG, zero_optimization={"stage": stage},
                train_micro_batch_size_per_chip=ROWS // _data_ranks(mesh),
                **extra)


def _batches(n, rows=ROWS, vocab=MODEL_KW["vocab_size"], seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (rows, SEQ + 1)).astype(
        np.int32)} for _ in range(n)]


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_params(model):
    jtopo._GLOBAL_MESH = None
    engine, *_ = dstpu.initialize(
        model=model, mesh=jtopo.build_mesh({"dp": 1},
                                           devices=jax.devices()[:1]),
        config=dict(CONFIG, zero_optimization={"stage": 0}))
    params = _np(engine.params)
    jtopo._GLOBAL_MESH = None
    return params


def _jax_dense(over):
    return JaxLM(JaxConfig(dtype=jnp.float32, **{**MODEL_KW, **over}))


def _jax_moe():
    return jax_get_model("tiny-moe", dtype=jnp.float32, **MOE_KW)


def _jax_engine_run(name):
    from deepspeed_tpu.utils import telemetry

    jtopo._GLOBAL_MESH = None
    telemetry.reset()
    if name == "config_b":
        model, config, mesh, world = _jax_moe(), CONFIG_B, CONFIG_B_MESH, 4
        batches = _batches(STEPS, rows=2, vocab=MOE_KW["vocab_size"])
    else:
        stage, mesh, world, extra, over = JAX_RUNS[name]
        model, config = _jax_dense(over), _config(stage, mesh, extra)
        batches = _batches(STEPS)
    engine, *_ = dstpu.initialize(
        model=model, config=config,
        mesh=jtopo.build_mesh(mesh, devices=jax.devices()[:world]))
    losses = [float(engine.train_batch(iter([b]))) for b in batches]
    out = {"losses": losses, "params": engine.module_state_dict(),
           "replicated": telemetry.get("moe.grouped_replicated_tokens")}
    jtopo._GLOBAL_MESH = None
    return out


# -- pipelined_layers against JAX's scan -------------------------------------


def _pp_case(name, mesh, world, kw, L=4, B=8, S=4, H=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"name": name, "mesh": mesh, "worlds": (world,), "kw": kw,
            "w": (rng.standard_normal((L, H, H)) * 0.3).astype(np.float32),
            "x": rng.standard_normal((B, S, H)).astype(np.float32),
            "proj": rng.standard_normal((B, S, H)).astype(np.float32)}


PP_CASES = [
    _pp_case("pp2_m4", PP2, 2, {"num_microbatches": 4}),
    _pp_case("pp2_default", PP2, 2, {}, seed=1),
    # waves of 2 microbatches against one pass over all 8
    _pp_case("pp2_waves_m8_w2", PP2, 2, {"num_microbatches": 8,
                                         "window": 2}, seed=2),
    _pp_case("pp2_single_pass_m8", PP2, 2, {"num_microbatches": 8,
                                            "window": 8}, seed=2),
    _pp_case("pp2_save_boundaries", PP2, 2, {"num_microbatches": 8,
                                             "schedule": "save_boundaries"},
             seed=2),
    _pp_case("pp4_m4", {"pp": 4, "dp": 1}, 4, {"num_microbatches": 4},
             seed=3),
    _pp_case("pp4_one_layer_a_stage", {"pp": 4, "dp": 1}, 4, {}, L=4,
             seed=4),
    # the microbatches' rows split over dp (8 rows, M 4: 2 a microbatch)
    _pp_case("pp2dp2_m4", PP2DP2, 4, {"num_microbatches": 4}, seed=5),
    # a microbatch of one row held by both dp ranks
    _pp_case("pp2dp2_m8", PP2DP2, 4, {"num_microbatches": 8}, seed=6),
]


def _jax_scan(case):
    w, x, proj = (jnp.asarray(case[k]) for k in ("w", "x", "proj"))

    def loss(w, x):
        y, _ = jax.lax.scan(lambda c, wl: (jnp.tanh(c @ wl) + c, None), x, w)
        return jnp.sum(y * proj), y

    (_, y), (dw, dx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(w, x)
    return {"out": np.asarray(y), "dw": np.asarray(dw),
            "dx": np.asarray(dx)}


@pytest.fixture(scope="module")
def pruns(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp")
    dense = _jax_params(_jax_dense({}))
    tied = _jax_params(_jax_dense({"tie_embeddings": True}))
    moe_params = _jax_params(_jax_moe())
    runs = [{"name": name, "worlds": (world,),
             "config": _config(stage, mesh, extra), "topology": mesh,
             "steps": STEPS, "model_over": over,
             **({"params": "tied"} if over else {}),
             "ckpt": name == "pp2_z0",
             "load_at": {"dp": 2} if name == "pp2_z0" else None}
            for name, (stage, mesh, world, extra, over, _) in
            ENGINES.items()]
    runs.append({"name": "config_b", "worlds": (4,), "moe": True,
                 "config": CONFIG_B, "topology": CONFIG_B_MESH,
                 "steps": STEPS})
    jobs = {}
    for world in (2, 4):
        work = str(root / f"w{world}")
        jobs[world] = Ranks("pp_fn,engines", work, world, dict(
            preset=None, model_kw=MODEL_KW, params=dense,
            params_by={"tied": tied}, config=CONFIG, moe_kw=MOE_KW,
            moe_params=moe_params, batches=_batches(STEPS),
            moe_batches=_batches(STEPS, rows=2, vocab=MOE_KW["vocab_size"]),
            runs=runs, pp_cases=PP_CASES, workdir=work))
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futures = {name: pool.submit(_jax_engine_run, name)
                   for name in list(JAX_RUNS) + ["config_b"]}
        ref = {"scan": {c["name"]: _jax_scan(c) for c in PP_CASES},
               "engines": {name: f.result() for name, f in futures.items()}}
    port = {w: job.join() for w, job in jobs.items()}
    jtopo._GLOBAL_MESH = None
    return {"ref": ref, "port": port}


@pytest.mark.parametrize("name", [c["name"] for c in PP_CASES])
def test_pipelined_layers_follow_jax_scan(pruns, name):
    """Each rank's output rows, its stage's layer gradients (summed over
    the data ranks that hold parts of them) and the input's gradient
    (stage 0's; the engine sums a replicated leaf's over pp) are JAX's
    scan's."""
    case = next(c for c in PP_CASES if c["name"] == name)
    ref = pruns["ref"]["scan"][name]
    outs = [o["pp_fn"][name] for o in pruns["port"][case["worlds"][0]]]
    pp, L = case["mesh"]["pp"], case["w"].shape[0]
    rows = case["x"].shape[0] // case["mesh"].get("dp", 1)
    for got in outs:
        rs = slice(got["data_index"] * rows, (got["data_index"] + 1) * rows)
        np.testing.assert_allclose(got["out"], ref["out"][rs], rtol=1e-5,
                                   atol=1e-5)
        dx = sum(o["dx"] for o in outs
                 if o["data_index"] == got["data_index"])
        np.testing.assert_allclose(dx, ref["dx"][rs], rtol=1e-5, atol=1e-5)
        if got["stage"] != 0:
            assert not got["dx"].any()  # stage 0 reads the input
        ls = slice(got["stage"] * L // pp, (got["stage"] + 1) * L // pp)
        dw = sum(o["dw"] for o in outs if o["stage"] == got["stage"])
        np.testing.assert_allclose(dw, ref["dw"][ls], rtol=1e-5, atol=1e-5)


def test_waves_equal_a_single_pass(pruns):
    """Waves of 2 and one pass of 8 (and save_boundaries) are one
    function: the same numbers on every rank."""
    for out in pruns["port"][2]:
        runs = [out["pp_fn"][n] for n in (
            "pp2_waves_m8_w2", "pp2_single_pass_m8", "pp2_save_boundaries")]
        for other in runs[1:]:
            for key in ("out", "dw", "dx"):
                np.testing.assert_allclose(other[key], runs[0][key],
                                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,pp,kw,want", [
    (4, 2, {}, (4, 4, "waves")), (8, 2, {}, (4, 4, "waves")),
    (6, 2, {}, (3, 3, "waves")), (16, 4, {"num_microbatches": 12},
                                  (8, 8, "waves")),
    (16, 2, {"num_microbatches": 8, "window": 3}, (8, 2, "waves")),
    (16, 2, {"num_microbatches": 8, "schedule": "save_boundaries"},
     (8, 8, "save_boundaries")),
    (1, 2, {}, (1, 1, "waves")),
])
def test_microbatch_plan_is_jaxs(B, pp, kw, want):
    """JAX's defaults and divisibility loops (``pipelined_layers``)."""
    assert microbatch_plan(B, pp, **kw) == want
    with pytest.raises(ValueError, match="'waves' or 'save_boundaries'"):
        microbatch_plan(B, pp, schedule="1f1b")


# -- the engines --------------------------------------------------------------


@pytest.mark.parametrize("name", list(ENGINES))
def test_pp_engine_follows_jax(pruns, name):
    stage, mesh, world, _, over, ref_name = ENGINES[name]
    ref = pruns["ref"]["engines"][ref_name]
    for out in pruns["port"][world]:
        got = out["engines"][name]
        assert got["mesh"]["pp"] == 2
        # each stage holds its one layer of the two
        assert got["local_shapes"]["/layers/attn/wq"][0] == 1
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        assert set(got["params"]) == set(ref["params"])
        for key, want in ref["params"].items():
            np.testing.assert_allclose(got["params"][key], want, rtol=RTOL,
                                       atol=ATOL, err_msg=key)


@pytest.mark.parametrize("tied", [True, False])
def test_pp_embedding_parity(pruns, tied):
    """Tied and untied embeddings across pp (JAX ``tests/test_pipeline.py``
    ``test_pp_embedding_parity``): the replicated embedding and head are
    counted once, on every stage, and pp follows JAX's pp engine."""
    name = "pp2_tied" if tied else "pp2_z0"
    ref = pruns["ref"]["engines"][name if tied else "pp2"]
    outs = [o["engines"][name] for o in pruns["port"][2]]
    for got in outs:
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["params"]["embed.tokens"],
                                   ref["params"]["embed.tokens"], rtol=RTOL,
                                   atol=ATOL)
        assert ("unembed.kernel" in got["params"]) is not tied
    np.testing.assert_array_equal(outs[0]["params"]["embed.tokens"],
                                  outs[1]["params"]["embed.tokens"])


def test_config_b_follows_jax(pruns):
    """JAX's dry run's config B: tiny-moe at pp 2 x ep 2 (ZeRO-2, SGD so
    that a gradient off by a factor shows), the aux loss threaded through
    the stages, and no token replicated over ep."""
    ref = pruns["ref"]["engines"]["config_b"]
    assert ref["replicated"] == 0
    for out in pruns["port"][4]:
        got = out["engines"]["config_b"]
        assert got["mesh"]["pp"] == 2 and got["mesh"]["ep"] == 2
        assert got["local_experts"] == MOE_KW["num_experts"] // 2
        assert got["telemetry"].get("moe.grouped_replicated_tokens",
                                    0) == 0
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=MOE_RTOL, atol=MOE_ATOL)
        for key, want in ref["params"].items():
            np.testing.assert_allclose(got["params"][key], want,
                                       rtol=MOE_RTOL, atol=MOE_ATOL,
                                       err_msg=key)
        assert got["counts"]["pp_aux"] > 0  # the aux rides the stages


def test_pp_checkpoint_resumes_and_loads_at_pp1(pruns):
    """A pp-2 checkpoint resumes bit for bit at pp 2 and loads at pp 1
    (each stage's layers are files of their own)."""
    for out in pruns["port"][2]:
        ck = out["engines"]["pp2_z0"]["ckpt"]
        assert ck["more"] == ck["again"]
        assert ck["load_at_mesh"]["pp"] == 1
        for key, want in ck["saved_params"].items():
            np.testing.assert_array_equal(ck["load_at_params"][key], want,
                                          err_msg=key)
        assert "wq.pp0of2.pt" in ck["files"] and "wq.pp1of2.pt" in \
            ck["files"]


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_model_built_as_one_stage(preset):
    """``get_model(..., pp=(stage, stages))`` draws every leaf from the
    seed and keeps one stage's layers: the whole model's, cut."""
    import torch

    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.runtime.optimizer import leaves

    kw = dict(device="cpu", dtype=torch.float32, num_layers=4, seed=3)
    whole = dict(leaves(zoo.get_model(preset, **kw).params()))
    for stage in range(2):
        part = dict(leaves(zoo.get_model(preset, pp=(stage, 2),
                                         **kw).params()))
        assert set(part) == set(whole)
        for path, t in part.items():
            want = whole[path][2 * stage:2 * stage + 2] \
                if path.startswith("/layers/") else whole[path]
            assert torch.equal(t, want), path
