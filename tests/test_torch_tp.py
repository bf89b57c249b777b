"""Tensor parallelism across ranks (the port's ``runtime/sharding`` tp
collectives, ``module_inject/auto_tp.tp_model_init``, the models'
column / row layers, the vocab-parallel embedding and loss, the engine
at tp, the tp-split experts and the serving engines at tp) on gloo
against the JAX package on meshes of the CPU devices.

One process is one rank; the ranks of a launch run
``tests/torch_dist_worker.py`` (one launch a world size serves the
file). The engines train JAX's own tiny models from JAX's init (fp32)
and follow JAX's engine on a mesh with the same tp (and fsdp) at
``tests/test_torch_zero.py``'s rtol 1e-5 / atol 1e-4, the MoE engines
and dispatch at ``tests/test_torch_moe_ep.py``'s tolerances; the greedy
streams are token-identical to JAX's tp-2 ``InferenceEngineV2``.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.inference import InferenceEngineV2 as JaxV2
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.models.transformer import TransformerConfig, \
    TransformerLM
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.module_inject import AutoTP as JaxAutoTP
from deepspeed_tpu.module_inject import tp_model_init as jax_tp_model_init
from deepspeed_tpu.parallel import moe as jmoe
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.runtime.sharding import vocab_parallel_lookup as jvpl

from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.module_inject.auto_tp import AutoTP
from deepspeed_tpu_torch.ops import attention as attn

from test_auto_tp import llama_like_params
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
          "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}}
MOE_CONFIG = dict(CONFIG, optimizer={"type": "adamw", "params": {
    "lr": 1e-3}})
STEPS, SEQ = 3, 16
RTOL, ATOL = 1e-5, 1e-4


def _z(stage, **kw):
    return {"zero_optimization": dict(stage=stage, **kw)}


TP2 = {"tp": 2, "dp": 1}
TP2_FSDP2 = {"tp": 2, "fsdp": 2, "dp": 1}
# name -> (config over CONFIG, mesh, world, extra)
ENGINES = {
    "tp2_z0": (_z(0), TP2, 2, {}),
    "tp2_z3": (_z(3), TP2, 2, {}),
    "tp2_gas_clip": (dict(_z(1), gradient_accumulation_steps=2,
                          gradient_clipping=0.05), TP2, 2, {}),
    # SGD is not scale-invariant: a gradient off by a factor shows
    "tp2_sgd": (dict(_z(0), optimizer={"type": "sgd", "params": {
        "lr": 0.5}}), TP2, 2, {}),
    "tp2_fsdp2_z0": (_z(0), TP2_FSDP2, 4, {}),
    "tp2_fsdp2_z2": (_z(2), TP2_FSDP2, 4, {}),
    "tp2_fsdp2_z3": (_z(3), TP2_FSDP2, 4, {}),
    "moe_tp2": (_z(0), TP2, 2, {"moe": True}),
    "moe_tp2_einsum": (dict(_z(1), moe={"enabled": True, "impl": "einsum"}),
                       TP2, 2, {"moe": True}),
}


def _rows(world, mesh):
    data = world // mesh["tp"]
    return CONFIG["train_micro_batch_size_per_chip"] * data


def _batches(rows, vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (rows, SEQ + 1)).astype(
        np.int32)} for _ in range(n)]


def _run_batches(name):
    cfg, mesh, world, extra = ENGINES[name]
    gas = cfg.get("gradient_accumulation_steps", 1)
    vocab = (MOE_KW if extra.get("moe") else MODEL_KW)["vocab_size"]
    return _batches(_rows(world, mesh), vocab, STEPS * gas), gas


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_dense():
    return TransformerLM(TransformerConfig(dtype=jnp.float32, **MODEL_KW))


def _jax_moe():
    return jax_get_model("tiny-moe", dtype=jnp.float32, **MOE_KW)


def _jax_params(model):
    jtopo._GLOBAL_MESH = None
    engine, *_ = dstpu.initialize(
        model=model, mesh=jtopo.build_mesh({"dp": 1},
                                           devices=jax.devices()[:1]),
        config=dict(CONFIG, **_z(0)))
    params = _np(engine.params)
    jtopo._GLOBAL_MESH = None
    return params


def _config(name):
    """The run's whole config (the MoE runs: lr 1e-3, the moe block)."""
    cfg, _, _, extra = ENGINES[name]
    if extra.get("moe"):
        return {**MOE_CONFIG, "moe": {"enabled": True}, **cfg}
    return dict(CONFIG, **cfg)


def _jax_engine_run(name):
    _, mesh, world, extra = ENGINES[name]
    jtopo._GLOBAL_MESH = None
    model = _jax_moe() if extra.get("moe") else _jax_dense()
    engine, *_ = dstpu.initialize(
        model=model, mesh=jtopo.build_mesh(mesh,
                                           devices=jax.devices()[:world]),
        config=_config(name))
    batches, gas = _run_batches(name)
    losses = [float(engine.train_batch(iter(batches[s * gas:(s + 1) * gas])))
              for s in range(STEPS)]
    out = {"losses": losses, "params": engine.module_state_dict()}
    jtopo._GLOBAL_MESH = None
    return out


# -- the MoE dispatch on tp meshes (tests/test_torch_moe_ep.py's cases) -----


def _moe_case(name, mesh, world):
    rng = jax.random.PRNGKey(0)
    B, S, H, F, E = 4, 16, 32, 64, 8
    x = jax.random.normal(rng, (B, S, H), jnp.float32)
    router = jax.random.normal(jax.random.fold_in(rng, 1), (H, E)) * 0.1
    experts = {k: jax.random.normal(jax.random.fold_in(rng, i), shape) * 0.1
               for i, (k, shape) in enumerate((("wi", (E, H, F)),
                                               ("wo", (E, F, H)),
                                               ("wg", (E, H, F))), 2)}
    proj = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)
    return {"name": name, "mesh": mesh, "worlds": (world,),
            "gate": dict(num_experts=E, top_k=2, drop_tokens=False),
            "activation": "swiglu", "x": np.asarray(x),
            "router": np.asarray(router),
            "experts": {k: np.asarray(v) for k, v in experts.items()},
            "proj": proj}


MOE_CASES = [_moe_case("tp2", TP2, 2),
             _moe_case("ep2_tp2", {"ep": 2, "tp": 2, "dp": 1}, 4)]


def _jax_moe_case(case):
    world = case["worlds"][0]
    cfg = jmoe.GateConfig(**case["gate"])
    mesh = jtopo.build_mesh(case["mesh"], devices=jax.devices()[:world])
    jtopo.set_global_mesh(mesh)
    proj = jnp.asarray(case["proj"])

    def loss(x, r, p):
        out, aux = jmoe.moe_ffn_dropless(x, r, p, cfg)
        return jnp.sum(out * proj), (out, aux)

    args = (jnp.asarray(case["x"]), jnp.asarray(case["router"]),
            {k: jnp.asarray(v) for k, v in case["experts"].items()})
    with mesh:
        (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(*args)
    jtopo._GLOBAL_MESH = None
    return {"out": np.asarray(out),
            "aux": {k: np.asarray(v) for k, v in aux.items()},
            "dx": np.asarray(grads[0]), "drouter": np.asarray(grads[1]),
            "dexperts": {k: np.asarray(v) for k, v in grads[2].items()}}


# -- the vocab-parallel lookup (tests/test_vocab_parallel.py's oracle) -------

VOCAB = {"table": np.random.default_rng(1).normal(size=(64, 16)).astype(
             np.float32),
         # 70 lies past the vocab: clamped to the last row, as XLA does
         "ids": np.concatenate([np.random.default_rng(2).integers(
             0, 64, (4, 9)), [[70]] * 4], axis=1).astype(np.int64),
         "proj": np.random.default_rng(3).normal(size=(4, 10, 16)).astype(
             np.float32)}


def _jax_vocab():
    mesh = jtopo.build_mesh({"tp": 2, "dp": 1}, devices=jax.devices()[:2])
    jtopo.set_global_mesh(mesh)
    ids = jnp.asarray(VOCAB["ids"], jnp.int32)
    proj = jnp.asarray(VOCAB["proj"])
    out = {}
    for name, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        def loss(t, dt=dt):
            rows = jvpl(t.astype(dt), ids)
            return jnp.sum(rows.astype(jnp.float32) ** 2 * proj)

        with mesh:
            rows = jax.jit(lambda t, dt=dt: jvpl(t.astype(dt), ids))(
                jnp.asarray(VOCAB["table"]))
            grad = jax.jit(jax.grad(loss))(jnp.asarray(VOCAB["table"]))
        out[name] = {"rows": np.asarray(rows, np.float32),
                     "dtype": str(rows.dtype), "grad": np.asarray(grad)}
    jtopo._GLOBAL_MESH = None
    return out


# -- serving (JAX's test_tp_serve_uses_kernel_and_matches and
# test_gqa_tp_serve_matches) ------------------------------------------------

SERVE_KW = dict(kv_blocks=64, kv_block_size=8, max_tokens_per_step=32,
                max_seqs_per_step=4, max_blocks_per_seq=8)
SERVE = [("mha", {}, 0, {1: [5, 9, 2, 14, 7], 2: [3, 1, 4], 3: [2] * 17}),
         ("gqa", {"num_kv_heads": 2}, 1, {1: [5, 9, 2, 14, 7],
                                          2: [3, 1, 4]})]
V1_PROMPT = [[3, 1, 4, 1, 5, 9]]
SERVE_VARIANTS = {"spec": {"spec_decode": True, "spec_k": 4},
                  "kv_int8": {"kv_quant_bits": 8}}


def _serve_cases():
    cases = []
    for name, kw, seed, prompts in SERVE:
        model = jax_get_model("tiny", dtype=jnp.float32,
                              param_dtype=jnp.float32, **kw)
        params = model.init(jax.random.PRNGKey(seed))
        cases.append((name, kw, model, params, prompts))
    return cases


def _jax_serve(model, params, prompts):
    jtopo._GLOBAL_MESH = None
    mesh = jtopo.build_mesh(jtopo.TopologyConfig(dp=1, tp=2),
                            devices=jax.devices()[:2])
    v2 = JaxV2(model, params=params, mesh=mesh, dtype=jnp.float32,
               **SERVE_KW)
    assert v2._use_paged_kernel
    v2.put(list(prompts), [np.asarray(p) for p in prompts.values()],
           max_new_tokens=5)
    streams = v2.generate_all()
    jtopo._GLOBAL_MESH = None
    v1 = jax_init_inference(model, params=params, mesh=mesh,
                            dtype=jnp.float32, max_seq_len=64)
    gen = np.asarray(v1.generate(np.asarray(V1_PROMPT, np.int32),
                                 max_new_tokens=3))
    jtopo._GLOBAL_MESH = None
    return streams, gen


def _port_tp1_streams(kw, params, prompts):
    """The port's one-rank streams, its kernel steps (decode, prefill,
    gather fallbacks) and its streams under SERVE_VARIANTS."""
    cfg = zoo.get_config("tiny", dtype=torch.float32, **kw)
    model = params_from_jax(_np(params), cfg, device="cpu")
    out = {}
    for name, extra in {"plain": {}, **SERVE_VARIANTS}.items():
        eng = InferenceEngineV2(model, device="cpu", **SERVE_KW, **extra)
        eng.put(list(prompts), [np.asarray(p) for p in prompts.values()],
                max_new_tokens=5)
        out[name] = {int(k): list(map(int, v))
                     for k, v in eng.generate_all().items()}
        if name == "plain":
            steps = (eng.stats["decode_kernel_steps"],
                     eng.stats["prefill_kernel_steps"],
                     eng.stats["prefill_gather_fallbacks"])
    return out.pop("plain"), steps, out


AUTOTP_TREES = {
    "llama": llama_like_params(),
    # 33 columns do not split over 2 ranks: the leaf stays whole
    "odd": {"model": {"q_proj": {"kernel": np.ones((32, 33), np.float32)},
                      "o_proj": {"kernel": np.ones((32, 32), np.float32)}}},
}


@pytest.fixture(scope="module")
def truns(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    dense = _jax_params(_jax_dense())
    moe_params = _jax_params(_jax_moe())
    serve = _serve_cases()
    runs = [{"name": name, "worlds": (world,), "config": cfg,
             "topology": mesh, "steps": STEPS, "moe": extra.get("moe", False),
             "ckpt": name == "tp2_z3"}
            for name, (cfg, mesh, world, extra) in ENGINES.items()]
    jobs = {}
    for world in (2, 4):
        work = str(root / f"w{world}")
        rows = CONFIG["train_micro_batch_size_per_chip"] * (world // 2)
        modes = "tp,moe_fn,engines" if world == 2 else "moe_fn,engines"
        jobs[world] = Ranks(modes, work, world, dict(
            preset=None, model_kw=MODEL_KW, params=dense, config=CONFIG,
            moe_kw=MOE_KW, moe_params=moe_params,
            batches=_batches(rows, MODEL_KW["vocab_size"], STEPS * 2),
            moe_batches=_batches(rows, MOE_KW["vocab_size"], STEPS),
            runs=[dict(r, config=_config(r["name"])) for r in runs],
            moe_cases=MOE_CASES, workdir=work, vocab=VOCAB,
            autotp=AUTOTP_TREES, serve_kw=SERVE_KW,
            serve_variants=SERVE_VARIANTS,
            serve=[{"name": name, "preset": "tiny", "model_kw": kw,
                    "params": _np(params), "prompts": prompts,
                    "max_new": 5, "v1_prompt": V1_PROMPT}
                   for name, kw, _, params, prompts in serve]))
    # JAX's engines compile a step each: three processes of their own
    # run them beside the ranks and the references below
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futures = {name: pool.submit(_jax_engine_run, name)
                   for name in ENGINES}
        ref = {"vocab": _jax_vocab(),
               "moe": {c["name"]: _jax_moe_case(c) for c in MOE_CASES},
               "serve": {name: _jax_serve(model, params, prompts)
                         for name, _, model, params, prompts in serve},
               "tp1": {name: _port_tp1_streams(kw, params, prompts)
                       for name, kw, _, params, prompts in serve}}
        ref["engines"] = {name: f.result() for name, f in futures.items()}
    port = {w: job.join() for w, job in jobs.items()}
    jtopo._GLOBAL_MESH = None
    return {"ref": ref, "port": port}


def _tp(truns):
    return [out["tp"] for out in truns["port"][2]]


# -- AutoTP -------------------------------------------------------------------


def test_autotp_classification_and_specs_equal_jax():
    for name, tree in AUTOTP_TREES.items():
        for policy in (None, "llama"):
            want = JaxAutoTP(policy=policy).infer_specs(tree)
            got = AutoTP(policy=policy).infer_specs(tree)
            flat_w = jax.tree.leaves(want, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))
            flat_g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(
                x, tuple))
            assert [tuple(s) for s in flat_w] == [tuple(s) for s in flat_g]
            assert AutoTP(policy=policy).summary(tree) == \
                JaxAutoTP(policy=policy).summary(tree)


def test_tp_model_init_keeps_each_ranks_slice(truns):
    jtopo._GLOBAL_MESH = None
    mesh = jtopo.build_mesh(jtopo.TopologyConfig(tp=2, dp=1),
                            devices=jax.devices()[:2])
    for name, tree in AUTOTP_TREES.items():
        sharded, jspecs = jax_tp_model_init(tree, mesh=mesh)
        want = {jax.tree_util.keystr(k, simple=True, separator="."):
                [np.asarray(s.data) for s in sorted(
                    v.addressable_shards, key=lambda s: s.device.id)]
                for k, v in jax.tree_util.tree_leaves_with_path(sharded)}
        for rank, out in enumerate(_tp(truns)):
            local, specs = out["autotp"][name]
            for path, shards in want.items():
                np.testing.assert_array_equal(local[path], shards[rank],
                                              err_msg=path)
    odd_local = _tp(truns)[0]["autotp"]["odd"][0]
    assert odd_local["model.q_proj.kernel"].shape == (32, 33)  # whole
    assert odd_local["model.o_proj.kernel"].shape == (16, 32)
    jtopo._GLOBAL_MESH = None


# -- the vocab-parallel lookup ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_vocab_parallel_lookup_follows_jax(truns, dtype):
    ref = truns["ref"]["vocab"][dtype]
    for out in _tp(truns):
        got = out["vocab"][dtype]
        assert got["dtype"] == "torch." + ("float32" if dtype == "fp32"
                                           else "bfloat16")
        np.testing.assert_array_equal(got["rows"], ref["rows"])
        lo = out["vocab"]["lo"]
        want = ref["grad"][lo:lo + got["grad"].shape[0]]
        tol = dict(rtol=1e-6, atol=1e-6) if dtype == "fp32" else \
            dict(rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(got["grad"], want, **tol)


# -- the engines ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ENGINES))
def test_tp_engine_follows_jax(truns, name):
    ref = truns["ref"]["engines"][name]
    world = ENGINES[name][2]
    for out in truns["port"][world]:
        got = out["engines"][name]
        assert got["mesh"]["tp"] == 2
        # each rank holds its tp slice: half the query heads, the vocab
        # rows of the embedding and half of every expert's width
        shapes = got["local_shapes"]
        full = ref["params"]
        for path, dim in (("/layers/attn/wq", 2), ("/embed/tokens", 0)):
            key = path.strip("/").replace("/", ".")
            if key in full:
                assert shapes[path][dim] * 2 == full[key].shape[dim], path
        if "layers.moe.experts.wi" in full:
            assert shapes["/layers/moe/experts/wi"][-1] * 2 == \
                full["layers.moe.experts.wi"].shape[-1]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        assert set(got["params"]) == set(ref["params"])
        for key, want in ref["params"].items():
            np.testing.assert_allclose(got["params"][key], want, rtol=RTOL,
                                       atol=ATOL, err_msg=key)


def test_partition_activations_changes_no_gradient(truns):
    for out in _tp(truns):
        loss0, g0 = out["grads"][False]
        loss1, g1 = out["grads"][True]
        assert loss0 == loss1
        assert set(g0) == set(g1) and g0
        for path in g0:
            np.testing.assert_allclose(g1[path], g0[path], rtol=1e-6,
                                       atol=1e-7, err_msg=path)


def test_tp_checkpoint_resumes_and_loads_at_tp1(truns):
    for out in truns["port"][2]:
        ck = out["tp"]["ckpt"]
        assert ck["more"] == ck["again"]  # bit for bit at tp 2
        for key, want in ck["saved"].items():
            np.testing.assert_array_equal(ck["tp1_params"][key], want,
                                          err_msg=key)
        # each tp rank wrote its slice of a tp-sharded leaf
        assert "wq.tp0of2.pt" in ck["files"] and "wq.tp1of2.pt" in \
            ck["files"]
        got = out["engines"]["tp2_z3"]["ckpt"]
        assert got["more"] == got["again"]


# -- tp-split experts -------------------------------------------------------------


@pytest.mark.parametrize("name", [c["name"] for c in MOE_CASES])
def test_tp_split_experts_follow_jax(truns, name):
    case = next(c for c in MOE_CASES if c["name"] == name)
    ref = truns["ref"]["moe"][name]
    outs = [out["moe_fn"][name] for out in truns["port"][case["worlds"][0]]]
    for got in outs:
        np.testing.assert_allclose(got["out"], ref["out"], atol=2e-5,
                                   rtol=2e-4)
        np.testing.assert_allclose(got["aux"]["l_aux"], ref["aux"]["l_aux"],
                                   rtol=1e-5)
        assert float(got["aux"]["dispatch_digest_mismatch"]) == 0.0
        assert float(ref["aux"]["dispatch_digest_mismatch"]) == 0.0
    ep = case["mesh"].get("ep", 1)
    # x and the router are replicated over tp: each tp group's ranks hold
    # the whole gradient of their tokens (summed over the ep ranks)
    dx = sum(g["dx"] for g in outs) / 2
    np.testing.assert_allclose(dx, ref["dx"], atol=1e-3, rtol=1e-3)
    drouter = sum(g["drouter"] for g in outs) / 2
    np.testing.assert_allclose(drouter, ref["drouter"], atol=1e-3,
                               rtol=1e-3)
    for k, want in ref["dexperts"].items():
        got = np.zeros_like(want)
        for g in outs:
            e, f = g["dexperts"][k].shape[0], g["dexperts"][k].shape[-1 if k
                                                                     != "wo"
                                                                     else 1]
            sl = (slice(g["lo"], g["lo"] + e),) + (
                (slice(g["flo"], g["flo"] + f),) if k == "wo" else
                (slice(None), slice(g["flo"], g["flo"] + f)))
            got[sl] += g["dexperts"][k]
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3,
                                   err_msg=k)
    assert ep * 2 == case["worlds"][0]


# -- serving ------------------------------------------------------------------------


@pytest.mark.parametrize("name", [s[0] for s in SERVE])
def test_tp_serve_streams_equal_jax_and_tp1(truns, name):
    jax_streams, jax_gen = truns["ref"]["serve"][name]
    tp1, tp1_steps, _ = truns["ref"]["tp1"][name]
    want = {int(k): list(map(int, v)) for k, v in jax_streams.items()}
    assert {int(k): list(map(int, v)) for k, v in tp1.items()} == want
    for out in _tp(truns):
        got = out["serve"][name]
        assert got["streams"] == want
        assert got["paged"]
        # the same scheduling on every rank as on one: the same decode
        # and prefill steps through the paged kernels
        assert got["kernel_steps"] == tp1_steps
        assert got["kernel_steps"][0] > 0
        np.testing.assert_array_equal(got["v1"], jax_gen)


@pytest.mark.parametrize("variant", list(SERVE_VARIANTS))
def test_tp_serve_runs_what_jax_runs_at_tp(truns, variant):
    """Speculation and a quantized KV pool at tp 2 give the one-rank
    engine's streams (speculation: the plain streams too)."""
    for name, _, _, _ in SERVE:
        plain, _, tp1 = truns["ref"]["tp1"][name]
        want = tp1[variant]
        if variant == "spec":
            assert want == {int(k): list(map(int, v))
                            for k, v in plain.items()}
        for out in _tp(truns):
            assert out["serve"][name]["variants"][variant] == want


def test_tp_serve_holds_each_ranks_kv_heads(truns):
    for name, kw, _, _ in SERVE:
        nkv = zoo.get_config("tiny", **kw).kv_heads
        for out in _tp(truns):
            assert out["serve"][name]["pool_kv_heads"] == nkv // 2


def test_auto_impl_routes_tp_local_heads_to_flash():
    """A tp rank's q / kv heads keep the head dim, so ``impl="auto"``
    still routes bf16 at head dim 128 to the flash kernels on the card
    (and the dense path on the CPU)."""
    assert attn.auto_impl("cuda", torch.bfloat16, 4096 // 32) == "flash"
    assert attn.auto_impl("cpu", torch.bfloat16, 128) == "xla"


def test_tp_serve_refusals_are_jax_words(truns):
    for out in _tp(truns):
        errors = out["serve"]["errors"]
        assert errors["kv1"] is not None and "does not divide" in \
            errors["kv1"]
        assert errors["int8"] is not None and \
            "does not compose with tp>1" in errors["int8"]
