"""MoE across ranks (the port's ``parallel/moe.py`` ep dispatch, top-k
gating with the einsum dispatch, and ``module_inject/auto_ep.py``)
against the JAX package.

One process: ``top_k_gating`` and ``moe_ffn(impl="einsum")`` against
JAX's at fp32, and the dropless path against einsum at capacity E. On
gloo: JAX's ``moe_ffn_dropless`` on ep meshes of the CPU devices
(``tests/test_grouped_moe.py``'s inputs and tolerances: outputs atol
2e-5 / rtol 2e-4, gradients 1e-3), the dropped fraction where the
budget overflows, the replicated-token count, and ``dryrun_multichip``
config B's tiny MoE model (at pp = tp = 1) training on ep meshes within
rtol 1e-5 / atol 1e-4 of JAX's engine. AutoEP's restacked trees and
specs equal JAX's on in-process HF Mixtral-shaped trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.module_inject import auto_ep as jep
from deepspeed_tpu.parallel import moe as jmoe
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.utils import telemetry as jtele

from deepspeed_tpu_torch.module_inject import auto_ep as pep
from deepspeed_tpu_torch.parallel import moe as pmoe

from torch_dist_worker import Ranks

MOE_KW = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=64, num_experts=4, top_k=2, remat=False)
CONFIG = {"train_micro_batch_size_per_chip": 2,
          "gradient_accumulation_steps": 1, "bf16": {"enabled": False},
          "gradient_clipping": 1.0, "steps_per_print": 1000,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
          "moe": {"enabled": True}}
STEPS, SEQ = 2, 16
RTOL, ATOL = 1e-5, 1e-4
# name -> (zero_optimization, mesh, world); under qgZ both engines
# dispatch by einsum and reduce the expert gradients with qgZ's ep level
ENGINES = {"ep2_z2": ({"stage": 2}, {"ep": 2, "dp": 1}, 2),
           "fsdp2_ep2_z3": ({"stage": 3}, {"fsdp": 2, "ep": 2, "dp": 1}, 4),
           "qgz_fsdp2_ep2_z2": ({"stage": 2, "zero_quantized_gradients": True},
                                {"fsdp": 2, "ep": 2, "dp": 1}, 4)}


def _mk_inputs(B=8, S=64, H=32, F=64, E=8, seed=0):
    rng = jax.random.PRNGKey(seed)
    x = jax.random.normal(rng, (B, S, H), jnp.float32)
    router = jax.random.normal(jax.random.fold_in(rng, 1), (H, E)) * 0.1
    params = {
        "wi": jax.random.normal(jax.random.fold_in(rng, 2), (E, H, F)) * 0.1,
        "wo": jax.random.normal(jax.random.fold_in(rng, 3), (E, F, H)) * 0.1,
        "wg": jax.random.normal(jax.random.fold_in(rng, 4), (E, H, F)) * 0.1,
    }
    return x, router, params


def _case(name, mesh, world, gate, B=8, S=64, hot=False):
    x, router, params = _mk_inputs(B=B, S=S)
    if hot:  # everyone to expert 0
        router = jnp.zeros_like(router).at[:, 0].set(1.0)
    proj = np.random.default_rng(7).standard_normal(
        x.shape).astype(np.float32)
    return {"name": name, "mesh": mesh, "worlds": (world,), "gate": gate,
            "activation": "swiglu", "x": np.asarray(x),
            "router": np.asarray(router),
            "experts": {k: np.asarray(v) for k, v in params.items()},
            "proj": proj}


FREE = dict(num_experts=8, top_k=2, drop_tokens=False)
TIGHT = dict(num_experts=8, top_k=2, drop_tokens=True, capacity_factor=1.0)
CASES = [
    _case("ep2", {"ep": 2, "dp": 1}, 2, FREE),
    _case("ep4", {"ep": 4, "dp": 1}, 4, FREE),
    _case("dp2_ep2", {"dp": 2, "ep": 2}, 4, FREE),
    _case("drop_ep2", {"ep": 2, "dp": 1}, 2, TIGHT, S=256, hot=True),
    _case("b1_ep2", {"ep": 2, "dp": 1}, 2, FREE, B=1, S=3),
]


def _jax_case(case):
    """JAX's dispatch on the case's mesh: output, aux, the gradients of
    sum(out * proj), and the replicated-token count."""
    world = case["worlds"][0]
    cfg = jmoe.GateConfig(**case["gate"])
    mesh = jtopo.build_mesh(case["mesh"], devices=jax.devices()[:world])
    jtopo.set_global_mesh(mesh)
    jtele.reset()
    proj = jnp.asarray(case["proj"])

    def loss(x, r, p):
        out, aux = jmoe.moe_ffn_dropless(x, r, p, cfg)
        return jnp.sum(out * proj), (out, aux)

    args = (jnp.asarray(case["x"]), jnp.asarray(case["router"]),
            {k: jnp.asarray(v) for k, v in case["experts"].items()})
    with mesh:
        (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(*args)
    rep = jtele.get("moe.grouped_replicated_tokens")
    jtopo._GLOBAL_MESH = None
    return {"out": np.asarray(out),
            "aux": {k: np.asarray(v) for k, v in aux.items()},
            "dx": np.asarray(grads[0]), "drouter": np.asarray(grads[1]),
            "dexperts": {k: np.asarray(v) for k, v in grads[2].items()},
            "replicated": rep}


def _moe_batches(world, seed=0):
    rng = np.random.default_rng(seed)
    rows = CONFIG["train_micro_batch_size_per_chip"] * world
    return [{"input_ids": rng.integers(0, MOE_KW["vocab_size"],
                                       (rows, SEQ + 1)).astype(np.int32)}
            for _ in range(STEPS)]


def _jax_moe_model():
    return jax_get_model("tiny-moe", dtype=jnp.float32, **MOE_KW)


def _jax_engine_run(name):
    zero, mesh, world = ENGINES[name]
    jtopo._GLOBAL_MESH = None
    engine, *_ = dstpu.initialize(
        model=_jax_moe_model(),
        mesh=jtopo.build_mesh(mesh, devices=jax.devices()[:world]),
        config=dict(CONFIG, zero_optimization=zero))
    losses = [float(engine.train_batch(iter([b])))
              for b in _moe_batches(world)]
    out = {"losses": losses, "params": engine.module_state_dict()}
    jtopo._GLOBAL_MESH = None
    return out


def _jax_moe_params():
    jtopo._GLOBAL_MESH = None
    engine, *_ = dstpu.initialize(
        model=_jax_moe_model(),
        mesh=jtopo.build_mesh({"dp": 1}, devices=jax.devices()[:1]),
        config=dict(CONFIG, zero_optimization={"stage": 0}))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), engine.params)
    jtopo._GLOBAL_MESH = None
    return params


@pytest.fixture(scope="module")
def mruns(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_ep")
    params = _jax_moe_params()
    runs = [{"name": name, "moe": True, "worlds": (world,),
             "config": {"zero_optimization": zero},
             "topology": mesh, "steps": STEPS, "ckpt": True}
            for name, (zero, mesh, world) in ENGINES.items()]
    jobs = {}
    for world in (2, 4):
        work = str(root / f"w{world}")
        jobs[world] = Ranks("moe_fn,engines", work, world, dict(
            moe_cases=CASES, runs=runs, config=CONFIG, moe_kw=MOE_KW,
            moe_params=params, moe_batches=_moe_batches(world),
            workdir=work))
    jax_cases = {c["name"]: _jax_case(c) for c in CASES}
    jax_engines = {name: _jax_engine_run(name) for name in ENGINES}
    port = {w: job.join() for w, job in jobs.items()}
    return {"cases": jax_cases, "engines": jax_engines, "port": port}


def _case_outs(mruns, name):
    world = next(c for c in CASES if c["name"] == name)["worlds"][0]
    return [out["moe_fn"][name] for out in mruns["port"][world]]


@pytest.mark.parametrize("name", ["ep2", "ep4", "dp2_ep2"])
def test_ep_dispatch_follows_jax(mruns, name):
    ref = mruns["cases"][name]
    outs = _case_outs(mruns, name)
    for got in outs:
        np.testing.assert_allclose(got["out"], ref["out"], atol=2e-5,
                                   rtol=2e-4)
        np.testing.assert_allclose(got["aux"]["l_aux"], ref["aux"]["l_aux"],
                                   rtol=1e-5)
        assert float(got["aux"]["ep_dropped_frac"]) == 0.0
    # the gradients: each rank's share (its tokens, its experts) summed
    dx = sum(g["dx"] for g in outs)
    np.testing.assert_allclose(dx, ref["dx"], atol=1e-3, rtol=1e-3)
    drouter = sum(g["drouter"] for g in outs)
    np.testing.assert_allclose(drouter, ref["drouter"], atol=1e-3,
                               rtol=1e-3)
    for k, want in ref["dexperts"].items():
        got = np.zeros_like(want)
        for g in outs:
            n = g["dexperts"][k].shape[0]
            got[g["lo"]:g["lo"] + n] += g["dexperts"][k]
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3,
                                   err_msg=k)


def test_each_rank_holds_its_experts(mruns):
    for name, e_loc in (("ep2", 4), ("ep4", 2)):
        for rank, got in enumerate(_case_outs(mruns, name)):
            assert got["dexperts"]["wi"].shape[0] == e_loc
            assert got["lo"] == rank * e_loc
    for name in ENGINES:
        world = ENGINES[name][2]
        for out in mruns["port"][world]:
            assert out["engines"][name]["local_experts"] == 2


def test_ep_dropped_fraction_equals_jax(mruns):
    want = float(mruns["cases"]["drop_ep2"]["aux"]["ep_dropped_frac"])
    assert want > 0.1
    for got in _case_outs(mruns, "drop_ep2"):
        assert float(got["aux"]["ep_dropped_frac"]) == pytest.approx(
            want, rel=1e-6)
        np.testing.assert_allclose(got["out"],
                                   mruns["cases"]["drop_ep2"]["out"],
                                   atol=2e-5, rtol=2e-4)


def test_replicated_tokens_counter_equals_jax(mruns):
    want = mruns["cases"]["b1_ep2"]["replicated"]
    assert want == 1
    for got in _case_outs(mruns, "b1_ep2"):
        assert got["replicated"] == want
        np.testing.assert_allclose(got["out"],
                                   mruns["cases"]["b1_ep2"]["out"],
                                   atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("name", list(ENGINES))
def test_moe_engine_follows_jax_on_ep_mesh(mruns, name):
    ref = mruns["engines"][name]
    for out in mruns["port"][ENGINES[name][2]]:
        got = out["engines"][name]
        assert got["mesh"]["ep"] == 2
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        for key, want in ref["params"].items():
            if not name.startswith("qgz"):
                np.testing.assert_allclose(got["params"][key], want,
                                           rtol=RTOL, atol=ATOL, err_msg=key)
                continue
            # a quantized code can flip at a rounding tie (an fp32
            # difference of 1e-7 upstream): at most 0.1% of a leaf parts
            # by more than the tolerance, by at most two steps at lr 1e-3
            diff = np.abs(got["params"][key] - want)
            off = diff > ATOL + RTOL * np.abs(want)
            assert off.mean() <= 1e-3 and diff.max() <= 2e-3, key
        assert got["telemetry"].get("moe.grouped_replicated_tokens", 0) == 0


# -- one process --------------------------------------------------------------


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("cap_factor,z", [(1.0, 0.0), (1.25, 0.01)])
def test_top_k_gating_equals_jax(cap_factor, z):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 16, 4)).astype(np.float32)
    jcfg = jmoe.GateConfig(num_experts=4, top_k=2,
                           capacity_factor=cap_factor, z_loss_weight=z)
    pcfg = pmoe.GateConfig(num_experts=4, top_k=2,
                           capacity_factor=cap_factor, z_loss_weight=z)
    cap = jmoe.compute_capacity(16, jcfg)
    assert cap == pmoe.compute_capacity(16, pcfg)
    jc, jd, ja = jmoe.top_k_gating(jnp.asarray(logits), jcfg, cap)
    pc, pd, pa = pmoe.top_k_gating(torch.tensor(logits), pcfg, cap)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-7)
    assert np.array_equal(pd.numpy(), np.asarray(jd))
    assert set(pa) == set(ja)
    for k in ja:
        np.testing.assert_allclose(pa[k].numpy(), np.asarray(ja[k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_einsum_dispatch_follows_jax(activation):
    x, router, params = _mk_inputs(B=2, S=32, E=4)
    cfg = dict(num_experts=4, top_k=2, capacity_factor=1.25)
    jout, jaux = jmoe.moe_ffn(x, router, params, jmoe.GateConfig(**cfg),
                              activation=activation, impl="einsum")
    pout, paux = pmoe.moe_ffn(_t(x), _t(router),
                              {k: _t(v) for k, v in params.items()},
                              pmoe.GateConfig(**cfg), activation=activation,
                              impl="einsum")
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(float(paux["l_aux"]), float(jaux["l_aux"]),
                               rtol=1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_dropless_matches_einsum_at_capacity_e(activation):
    x, router, params = _mk_inputs(B=2, S=64, E=4)
    cfg = pmoe.GateConfig(num_experts=4, top_k=2, capacity_factor=4.0)
    args = (_t(x), _t(router), {k: _t(v) for k, v in params.items()}, cfg)
    out_e, aux_e = pmoe.moe_ffn(*args, activation=activation, impl="einsum")
    out_g, aux_g = pmoe.moe_ffn_dropless(*args, activation=activation)
    np.testing.assert_allclose(out_g.numpy(), out_e.numpy(), atol=2e-5,
                               rtol=2e-4)
    np.testing.assert_allclose(float(aux_g["l_aux"]), float(aux_e["l_aux"]),
                               rtol=1e-5)


def test_grouped_unsupported_reason_and_fallback():
    from deepspeed_tpu_torch.parallel import topology
    from deepspeed_tpu_torch.utils import telemetry

    topology.set_global_mesh(topology.build_mesh({"ep": 3}, devices=[0, 1,
                                                                      2]))
    try:
        cfg = pmoe.GateConfig(num_experts=4)
        assert "not divisible" in pmoe._grouped_unsupported_reason(cfg)
        with pytest.raises(ValueError, match="grouped"):
            pmoe.moe_ffn(torch.zeros(1, 2, 8), torch.zeros(8, 4),
                         {"wi": torch.zeros(4, 8, 8),
                          "wo": torch.zeros(4, 8, 8),
                          "wg": torch.zeros(4, 8, 8)}, cfg, impl="grouped")
        telemetry.reset()
        pmoe.moe_ffn(torch.zeros(1, 2, 8), torch.zeros(8, 4),
                     {"wi": torch.zeros(4, 8, 8), "wo": torch.zeros(4, 8, 8),
                      "wg": torch.zeros(4, 8, 8)}, cfg, impl="auto")
        assert telemetry.get("moe.grouped_fallback") == 1
    finally:
        topology.set_global_mesh(None)


def test_token_placement_is_jax_rule():
    sizes = {"dp": 2, "fsdp": 1, "ep": 2}
    assert pmoe.token_placement(4, 8, sizes) == (("dp", "ep"), (), ())
    assert pmoe.token_placement(1, 32, sizes) == ((), ("dp", "ep"), ())
    assert pmoe.token_placement(2, 3, sizes) == (("dp",), (), ("ep",))


def test_tp_split_experts_still_raise():
    """tp-split experts are ported: the two tp ranks' F/2 partials
    (summed here; the mesh's all-reduce on ranks) equal JAX's dropless
    core over the whole experts, and the ranks route alike. The tp mesh
    itself runs in tests/test_torch_tp.py."""
    cfg = pmoe.GateConfig(num_experts=4)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 6, 8)).astype(np.float32)
    router = rng.normal(size=(8, 4)).astype(np.float32)
    experts = {k: (rng.normal(size=(4, 8, 8)) * 0.3).astype(np.float32)
               for k in ("wi", "wo", "wg")}
    want, _ = jmoe._dropless_shard_core(
        jnp.asarray(x), jnp.asarray(router),
        {k: jnp.asarray(v) for k, v in experts.items()}, jmoe.GateConfig(
            num_experts=4), "swiglu")
    got = 0
    for lo in (0, 4):
        part = {k: torch.from_numpy(np.ascontiguousarray(
            v[:, lo:lo + 4] if k == "wo" else v[..., lo:lo + 4]))
            for k, v in experts.items()}
        y, stats = pmoe._dropless_shard_core(
            torch.from_numpy(x), torch.from_numpy(router), part, cfg,
            "swiglu", tp=2)
        assert float(stats["dispatch_digest_mismatch"][0]) == 0.0
        got = got + y
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -- AutoEP -------------------------------------------------------------------


def _hf_mixtral_tree(E=4):
    """A tiny HF Mixtral's parameters (built in process, nothing
    downloaded) as a nested dict with the JAX tests' [in, out] kernels."""
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(0)
    model = MixtralForCausalLM(MixtralConfig(
        vocab_size=64, hidden_size=16, intermediate_size=32,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        num_local_experts=E, num_experts_per_tok=2))
    tree = {}
    for name, t in model.state_dict().items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        arr = t.detach().numpy()
        node["kernel" if parts[-1] == "weight" else parts[-1]] = \
            arr.T.copy() if arr.ndim == 2 else arr
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_auto_ep_restack_and_specs_equal_jax():
    tree = _hf_mixtral_tree()
    jstack = jep.stack_expert_modulelist(tree, jep.PRESETS["mixtral"])
    pstack = pep.stack_expert_modulelist(tree, pep.PRESETS["mixtral"])
    jflat, pflat = _flat(jstack), _flat(pstack)
    assert set(jflat) == set(pflat)
    assert any(".experts.w1.kernel" in k for k in pflat)
    for k, want in jflat.items():
        assert np.array_equal(np.asarray(pflat[k]), np.asarray(want)), k
    jspecs = _flat(jep.AutoEP(preset="mixtral").infer_specs(jstack))
    pspecs = _flat(pep.AutoEP(preset="mixtral").infer_specs(pstack))
    for k, want in jspecs.items():
        assert pspecs[k] == tuple(want), k


def test_ep_model_init_places_this_ranks_experts():
    from deepspeed_tpu_torch.parallel import topology

    tree = _hf_mixtral_tree()
    mesh = topology.build_mesh({"ep": 4, "dp": 1}, devices=[0, 1, 2, 3])
    local, specs = pep.ep_model_init(tree, mesh=mesh, preset="mixtral")
    w1 = local["model"]["layers"]["0"]["block_sparse_moe"]["experts"]["w1"][
        "kernel"]
    full = pep.stack_expert_modulelist(tree, pep.PRESETS["mixtral"])
    assert w1.shape[0] == 1  # rank 0's one of four experts
    assert torch.equal(w1, torch.as_tensor(
        full["model"]["layers"]["0"]["block_sparse_moe"]["experts"]["w1"][
            "kernel"][:1]))
    gate = local["model"]["layers"]["0"]["block_sparse_moe"]["gate"][
        "kernel"]
    assert tuple(gate.shape) == (16, 4)  # the router replicates
    # an expert count that does not divide ep replicates
    local3, _ = pep.ep_model_init(_hf_mixtral_tree(E=3), mesh=mesh,
                                  preset="mixtral")
    assert local3["model"]["layers"]["0"]["block_sparse_moe"]["experts"][
        "w1"]["kernel"].shape[0] == 3


@pytest.mark.parametrize("name", list(ENGINES))
def test_moe_checkpoint_round_trip_on_ep_mesh(mruns, name):
    """Each ep rank writes its experts (``<leaf>.ep<e>of<n>``, then its
    fsdp block): a fresh engine resumes the same losses, and a load of
    the params alone gives the saved params back."""
    for out in mruns["port"][ENGINES[name][2]]:
        ck = out["engines"][name]["ckpt"]
        np.testing.assert_allclose(ck["again"], ck["more"], rtol=1e-6)
        for key, want in ck["saved_params"].items():
            np.testing.assert_array_equal(ck["reseed_params"][key], want)


def test_qgz_expert_level_under_ep(mruns):
    """qgZ on an fsdp x ep mesh: the MoE layers dispatch by einsum (the
    per-group gradients), and the expert gradients reduce with int8 codes
    over fsdp and over ep onto the expert dim (JAX's level 2)."""
    for out in mruns["port"][4]:
        got = out["engines"]["qgz_fsdp2_ep2_z2"]
        assert got["flags"]["_qgz_stage3"]
        assert got["telemetry"].get("moe.grouped_fallback", 0) > 0
        assert got["counts"].get("qgz_ep_int8", 0) > 0
        assert got["counts"].get("qgz_fsdp_int8", 0) > 0
