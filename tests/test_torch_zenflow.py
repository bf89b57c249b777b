"""ZenFlow in the port against the JAX package's
(``tests/test_zenflow.py`` contracts).

The optimizer: the same seeded tree and grads through JAX's
``ZenFlowOptimizer`` and the port's, with and without overlap, aligned
and misaligned intervals, one and two workers: the selected indices are
equal in value and order at every step, and the params agree within
rtol 1e-5 / atol 1e-7 over 12 steps (both step the same native Adam on
the host and the same fp32 selective Adam; the device ops round in
another order). Top-k breaks ties as ``jax.lax.top_k``.

Resume: the port's state dict carries ``fold_due``, so a run resumed from
a state dict taken after any step equals the uninterrupted run bit for
bit, in both overlap modes; JAX's drops its pending upload, and its
resumed run parts from the uninterrupted one (recorded here as the
reference's gap, ROADMAP C).

The engine: from the JAX engine's initial fp32 weights (``params_from_
jax``), the port's ZenFlow engine follows JAX's (8 CPU devices, ZeRO
stage 2; the port at world size 1 with the JAX global batch) over 8
steps in fp32 (three folds at interval 2), at GAS 1 and 2, with and
without overlap: losses within rtol 1e-5, host masters within atol 1e-4
(``tests/test_torch_engine.py``'s; Adam's normalised step turns a
rounding-level gradient difference into up to ~3e-6 on an element). The
port's global norm is fp32 on the card where JAX's ``optax.global_norm``
of bf16 grads rounds to bf16: the clip coefficients part by up to a few
bf16 steps (stated below).
"""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.runtime import zenflow as jzf
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.ops.native import builder
from deepspeed_tpu_torch.ops.native import cpu_optimizer as co
from deepspeed_tpu_torch.runtime import zenflow as zf
from deepspeed_tpu_torch.runtime.optimizer import leaves, tree_map

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=32, pos_emb="learned", norm="layernorm",
            activation="gelu", tie_embeddings=True, remat=False,
            attn_impl="xla")
LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- the optimizer --------------------------------------------------------------


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((64, 8)).astype(np.float32),
            "b": rng.standard_normal(256).astype(np.float32),
            "c": rng.standard_normal((16, 16)).astype(np.float32)}


def _grads(tree, step):
    return {k: np.random.default_rng(100 + step).standard_normal(v.shape)
            .astype(np.float32) for k, v in tree.items()}


def _pair(tree, lr=LR, **cfg):
    """JAX's and the port's optimizer from the same tree and config."""
    jopt = jzf.ZenFlowOptimizer({k: jnp.asarray(v) for k, v in tree.items()},
                                jzf.ZenFlowConfig(**cfg), lr=lr)
    popt = zf.ZenFlowOptimizer(
        {k: torch.from_numpy(v.copy()) for k, v in tree.items()},
        zf.ZenFlowConfig(**cfg), lr=lr)
    return jopt, popt


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("ui,si", [(2, 4), (3, 5)])
@pytest.mark.parametrize("overlap", [True, False])
def test_optimizer_follows_jax(overlap, ui, si, workers):
    tree = _tree()
    jopt, popt = _pair(tree, topk_ratio=0.05, update_interval=ui,
                       select_interval=si, overlap_step=overlap,
                       workers=workers)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    for step in range(12):
        g = _grads(tree, step)
        jp = jopt.step({k: jnp.asarray(v) for k, v in g.items()}, jp)
        assert popt.step({k: torch.from_numpy(v) for k, v in g.items()},
                         pp) is pp
        for i in range(len(tree)):
            np.testing.assert_array_equal(popt._idx[i].numpy(),
                                          np.asarray(jopt._idx[i]))
        for k in tree:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    jopt.finalize()
    popt.finalize()
    jopt.close()
    popt.close()
    assert popt.steps == 12 and popt.counts["ships"] == 12 // ui


@pytest.mark.parametrize("pattern", ["zeros", "plateau", "all_equal",
                                     "negative_zero"])
def test_topk_breaks_ties_as_jax(pattern):
    rng = np.random.default_rng(3)
    a = rng.standard_normal(200).astype(np.float32)
    if pattern == "zeros":  # rows that saw no token: |acc| = 0
        a[rng.permutation(200)[:150]] = 0.0
    elif pattern == "plateau":  # the k-th value shared across the cut
        a[rng.permutation(200)[:40]] = 0.75
    elif pattern == "all_equal":
        a[:] = 1.5
    else:
        a[::3] = -0.0
        a[1::3] = 0.0
    for k in (1, 7, 20, 60, 199, 200):
        _, want = jax.lax.top_k(jnp.abs(jnp.asarray(a)), k)
        got = zf.topk_indices(torch.from_numpy(a).abs(), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"k={k}")


def test_planted_ties_pick_jax_indices():
    """A leaf whose grads are zero but for a few equal entries: the first
    selection reaches into the ties, and both pick the same indices."""
    tree = {"w": np.ones(64, np.float32), "e": np.zeros((16, 4), np.float32)}
    jopt, popt = _pair(tree, topk_ratio=0.25, update_interval=2,
                       select_interval=2, overlap_step=False)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    for step in range(6):
        g = {"w": np.zeros(64, np.float32), "e": np.zeros((16, 4), np.float32)}
        g["w"][[5, 9, 40, 41]] = 0.5
        g["w"][[2, 60]] = -0.5
        g["e"][step % 16] = 1.0
        jp = jopt.step({k: jnp.asarray(v) for k, v in g.items()}, jp)
        popt.step({k: torch.from_numpy(v) for k, v in g.items()}, pp)
        for i in range(2):
            np.testing.assert_array_equal(popt._idx[i].numpy(),
                                          np.asarray(jopt._idx[i]))
    for k in tree:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)


# the resume problem of the issue: tests/test_zenflow.py's quadratic
RESUME_CFG = dict(topk_ratio=0.1, update_interval=2, select_interval=4)
RESUME_STEPS, RESUME_LR = 10, 0.05


def _quad(seed=0, n=256):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n,)).astype(np.float32),
            "b": rng.normal(size=(32,)).astype(np.float32)}


def _port_run(overlap, cut=None):
    """Params after RESUME_STEPS steps of the quadratic (grad 2 p);
    with ``cut``, the state dict and params after step ``cut`` go into a
    fresh optimizer, which takes the remaining steps."""
    init = _quad()
    cfg = zf.ZenFlowConfig(overlap_step=overlap, **RESUME_CFG)
    opt = zf.ZenFlowOptimizer({k: torch.from_numpy(v.copy())
                               for k, v in init.items()}, cfg)
    p = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    for step in range(1, RESUME_STEPS + 1):
        opt.step(tree_map(lambda x: 2 * x, p), p, lr=RESUME_LR)
        if step == cut:
            sd = copy.deepcopy(opt.state_dict())  # a checkpoint's copy
            p = {k: v.clone() for k, v in p.items()}
            opt.close()
            opt = zf.ZenFlowOptimizer({k: torch.from_numpy(v.copy())
                                       for k, v in init.items()}, cfg)
            opt.load_state_dict(sd)
    opt.close()
    return p


@pytest.mark.parametrize("cut", range(1, 10))
@pytest.mark.parametrize("overlap", [True, False])
def test_resume_is_bit_identical_at_every_cut(overlap, cut):
    want = _port_run(overlap)
    got = _port_run(overlap, cut)
    for k in want:
        assert torch.equal(got[k], want[k]), (k, cut)


@pytest.mark.parametrize("overlap", [True, False])
def test_the_references_resume_gap(overlap):
    """JAX's state dict drops the pending fold: resumed at step 2 its
    run parts from the uninterrupted one (max-abs 0.086 in both modes
    on this problem), where the port's is equal."""
    grad = jax.grad(lambda p: sum(jnp.sum(x * x)
                                  for x in jax.tree.leaves(p)))
    init = {k: jnp.asarray(v) for k, v in _quad().items()}

    def run(cut=None):
        cfg = jzf.ZenFlowConfig(overlap_step=overlap, **RESUME_CFG)
        opt, p = jzf.ZenFlowOptimizer(init, cfg), init
        for step in range(1, RESUME_STEPS + 1):
            p = opt.step(grad(p), p, lr=RESUME_LR)
            if step == cut:
                sd = opt.state_dict()
                opt = jzf.ZenFlowOptimizer(init, cfg)
                opt.load_state_dict(sd)
        opt.finalize()
        return p

    full, resumed = run(), run(cut=2)
    gap = max(float(jnp.max(jnp.abs(full[k] - resumed[k]))) for k in full)
    assert gap > 1e-2, gap
    port_full, port_resumed = _port_run(overlap), _port_run(overlap, 2)
    for k in port_full:
        assert torch.equal(port_full[k], port_resumed[k])


# -- JAX's contracts (tests/test_zenflow.py) ------------------------------------


def _quad_loss(p):
    return sum(float((v.double() ** 2).sum()) for v in p.values())


def _run_quad(opt, p, steps, lr=0.05):
    for _ in range(steps):
        opt.step(tree_map(lambda x: 2 * x, p), p, lr=lr)
    opt.finalize()
    # one more step folds the final host pass in
    opt.step(tree_map(lambda x: 2 * x, p), p, lr=lr)
    opt.close()
    return p


def _quad_opt(seed, n=256, **cfg):
    p = {k: torch.from_numpy(v) for k, v in _quad(seed, n).items()}
    opt = zf.ZenFlowOptimizer(tree_map(torch.clone, p),
                              zf.ZenFlowConfig(**cfg))
    return opt, p


@pytest.mark.parametrize("overlap,seed,ui,si,steps", [
    (False, 0, 4, 8, 40), (True, 1, 4, 8, 40), (True, 3, 4, 6, 48)])
def test_converges(overlap, seed, ui, si, steps):
    """test_zenflow_converges, _async_converges and the misaligned
    select / update intervals."""
    opt, p = _quad_opt(seed, 256 if seed != 3 else 128, topk_ratio=0.1,
                       update_interval=ui, select_interval=si,
                       overlap_step=overlap)
    l0 = _quad_loss(p)
    p = _run_quad(opt, p, steps)
    assert _quad_loss(p) < l0 * 0.2
    assert all(torch.isfinite(v).all() for v in p.values())


def test_selected_coords_update_every_step():
    p = {"w": torch.ones(64)}
    opt = zf.ZenFlowOptimizer(tree_map(torch.clone, p), zf.ZenFlowConfig(
        topk_ratio=0.25, update_interval=100, select_interval=100,
        overlap_step=False))
    before = p["w"].clone()
    opt.step({"w": 2 * p["w"]}, p)
    assert int((p["w"] != before).sum()) == 16  # exactly k moved


def test_host_pass_updates_unselected():
    p = {"w": torch.ones(64)}
    opt = zf.ZenFlowOptimizer(tree_map(torch.clone, p), zf.ZenFlowConfig(
        topk_ratio=0.05, update_interval=2, select_interval=100,
        overlap_step=False))
    for _ in range(3):  # one interval boundary and its fold
        opt.step({"w": 2 * p["w"]}, p)
    assert int((p["w"] != 1.0).sum()) > 16  # far more than k = 4


def test_state_dict_roundtrip():
    init = {k: torch.from_numpy(v) for k, v in _quad(2, 64).items()}
    opt = zf.ZenFlowOptimizer(init, zf.ZenFlowConfig(overlap_step=False))
    p = tree_map(torch.clone, init)
    opt.step(tree_map(lambda x: 2 * x, p), p)
    sd = opt.state_dict()
    assert sorted(sd) == sorted(
        ["steps", "masters", "shard_index", "host_opt", "idx", "m", "v",
         "acc", "sel_step", "protected", "updated_since_foldin",
         "fold_due"])
    assert sd["shard_index"][0] == [((0, 32),)]
    opt2 = zf.ZenFlowOptimizer(init, zf.ZenFlowConfig(overlap_step=False))
    opt2.load_state_dict(sd)
    g = tree_map(lambda x: 2 * x, p)
    pa, pb = tree_map(torch.clone, p), tree_map(torch.clone, p)
    opt.step(g, pa)
    opt2.step(g, pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k])
    with pytest.raises(ValueError, match="zenflow state: leaf /w"):
        zf.ZenFlowOptimizer({"w": torch.zeros(8), "b": torch.zeros(32)},
                            zf.ZenFlowConfig()).load_state_dict(sd)


def test_workers_match_serial():
    tree = _tree()

    def run(workers):
        opt = zf.ZenFlowOptimizer(
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()},
            zf.ZenFlowConfig(topk_ratio=0.05, update_interval=2,
                             select_interval=4, overlap_step=False,
                             workers=workers), lr=LR)
        p = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
        for s in range(6):
            opt.step({k: torch.from_numpy(v)
                      for k, v in _grads(tree, s).items()}, p)
        opt.close()
        return p

    p1, p3 = run(1), run(3)
    for k in tree:
        assert torch.equal(p1[k], p3[k])


def test_zenflow_requires_the_native_library(monkeypatch):
    monkeypatch.setattr(builder, "_lib", None)
    monkeypatch.setattr(builder, "_build_error", "no C++ compiler (test)")
    with pytest.raises(RuntimeError, match="native host library"):
        zf.ZenFlowOptimizer({"w": torch.zeros(8)})
    with pytest.raises(RuntimeError, match="native host library"):
        _engine()


# -- the engine -------------------------------------------------------------------


def data_iter(batch, seq=17, seed=0, n_fixed=2):
    """The JAX ``tests/test_zenflow.py`` data: a small fixed set, cycled."""
    rng = np.random.default_rng(seed)
    fixed = [{"input_ids": rng.integers(0, 64, (batch, seq)).astype(np.int32)}
             for _ in range(n_fixed)]
    i = 0
    while True:
        yield fixed[i % n_fixed]
        i += 1


def _config(gas=1, dtype="fp32", clip=1.0, overlap=True, ui=4, si=8,
            topk=0.1, off="cpu", **extra):
    cfg = {"train_micro_batch_size_per_chip": 2,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "adamw", "params": {"lr": LR}},
           "gradient_clipping": clip, "steps_per_print": 100,
           "bf16": {"enabled": dtype == "bf16"},
           "zero_optimization": {
               "stage": 2, "offload_optimizer": {"device": off},
               "zenflow": {"topk_ratio": topk, "update_interval": ui,
                           "select_interval": si, "overlap_step": overlap}}}
    if dtype == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    cfg.update(extra)
    return cfg


def _engine(seed=0, model=None, **kw):
    if model is None:
        model = zoo.get_model("tiny", device="cpu", seed=seed,
                              dtype=torch.float32, **TINY)
    return deepspeed_tpu_torch.initialize(model=model, config=_config(**kw),
                                          device="cpu")[0]


def _losses(engine, n, seed=0, api="train_batch", it=None):
    it = it if it is not None else data_iter(engine.micro_batch_size,
                                             seed=seed)
    out = []
    for _ in range(n):
        if api == "train_batch":
            out.append(float(engine.train_batch(it)))
            continue
        for _ in range(engine.gradient_accumulation_steps):
            engine.backward(engine(next(it)))
            engine.step()
        out.append(float(engine.last_metrics["loss"]))
    return out


def _jax_masters(zen):
    """JAX ZenFlow's per-shard masters as whole leaves."""
    out = []
    for shape, metas, bufs in zip(zen._shapes, zen._shard_meta,
                                  zen._masters):
        full = np.zeros(shape, np.float32)
        for (index, _), buf in zip(metas, bufs):
            full[index] = buf.reshape(full[index].shape)
        out.append(full)
    return out


@pytest.fixture(scope="module")
def jax_parity():
    """8 steps of the JAX ZenFlow engine and of the port's at GAS 1 and
    2, with and without overlap, fp32, interval 2 and select 4 (three
    folds), from the JAX engine's initial weights."""
    out = {}
    for gas, overlap in ((1, True), (1, False), (2, True), (2, False)):
        cfg = _config(gas=gas, ui=2, si=4, overlap=overlap)
        jeng, *_ = dstpu.initialize(
            model=JaxLM(JaxConfig(dtype=jnp.float32, **TINY)),
            config=copy.deepcopy(cfg))
        init = jax.tree.map(np.asarray, jeng.params)
        pcfg = dict(cfg, train_batch_size=jeng.train_batch_size)
        del pcfg["train_micro_batch_size_per_chip"]
        model = params_from_jax(init, TransformerConfig(
            dtype=torch.float32, **TINY), device="cpu")
        eng = deepspeed_tpu_torch.initialize(model=model, config=pcfg,
                                             device="cpu")[0]
        got = _losses(eng, 8, seed=5)
        it = data_iter(jeng.micro_batch_size * jeng.dp_world_size, seed=5)
        want = [float(jeng.train_batch(it)) for _ in range(8)]
        jeng._zenflow.finalize()
        jm = {"/" + "/".join(k.key for k in kp): m for (kp, _), m in zip(
            jax.tree_util.tree_flatten_with_path(jeng.params)[0],
            _jax_masters(jeng._zenflow))}
        out[(gas, overlap)] = {"jax": want, "port": got, "engine": eng,
                               "jax_masters": jm}
    return out


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("gas", [1, 2])
def test_engine_follows_the_jax_engine(jax_parity, gas, overlap):
    r = jax_parity[(gas, overlap)]
    eng = r["engine"]
    np.testing.assert_allclose(r["port"], r["jax"], rtol=1e-5)
    assert r["port"][-1] < r["port"][0]
    assert eng.global_steps == 8 and eng.update_count == 8
    assert eng._zenflow.counts["folds"] == 3
    for path, want in r["jax_masters"].items():
        np.testing.assert_allclose(
            eng._zenflow.full_fp32_param(path).numpy().ravel(),
            want.ravel(), atol=1e-4, rtol=0, err_msg=path)


def test_only_one_host_optimizer_is_built(monkeypatch):
    made = []
    real = co.CPUAdam.__init__

    def spy(self, n, *a, **kw):
        made.append(n)
        real(self, n, *a, **kw)

    monkeypatch.setattr(co.CPUAdam, "__init__", spy)
    eng = _engine()
    assert eng._offload is None and eng.tx is None and eng.opt_state is None
    assert sorted(made) == sorted(
        p.numel() for _, p in leaves(eng.params))
    # the host state: master, two moments and the shipped grads
    zen = eng._zenflow
    host = sum(t.nbytes for t in (*zen._masters, *zen._host_grads))
    host += sum(m.nbytes for o in zen._host_opts for m in o.moments())
    assert host == 16 * sum(p.numel() for _, p in leaves(eng.params))


@pytest.mark.parametrize("dtype,rtol", [("fp32", 1e-3), ("bf16", 4e-3)])
def test_engine_applies_grad_clipping(dtype, rtol):
    """JAX's test_engine_zenflow_applies_grad_clipping: the grads the
    optimizer sees have the clip's norm. In bf16 the coefficient and each
    product round to bf16 (2**-9 relative each)."""
    seen = {}

    def run(clip):
        eng = _engine(dtype=dtype, clip=clip, topk=0.5, ui=1,
                      overlap=False)
        real = eng._zenflow.step

        def spy(grads, params, lr=None):
            seen[clip] = float(np.sqrt(sum(
                float((g.double() ** 2).sum()) for _, g in leaves(grads))))
            return real(grads, params, lr=lr)

        eng._zenflow.step = spy
        eng.train_batch(data_iter(eng.micro_batch_size, seed=9))

    run(0.0)
    run(0.5)
    assert seen[0.0] > 0.5
    np.testing.assert_allclose(seen[0.5], 0.5, rtol=rtol)


def test_norm_gap_against_optax_global_norm():
    """JAX takes ``optax.global_norm`` of the bf16 grads (each leaf's sum
    rounded to bf16); the port's fp32 norm on the card. On a bf16 tree
    the port's clip coefficient is within 1e-6 of a double-precision sum,
    JAX's within 2**-6."""
    import optax

    rng = np.random.default_rng(4)
    tree = {k: (rng.standard_normal(n) * s).astype(np.float32)
            for k, n, s in (("a", 5000, 0.1), ("b", 300, 2.0),
                            ("c", 70000, 0.01))}
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in tree.items()}
    from deepspeed_tpu_torch.runtime.optimizer import global_norm

    n32 = float(global_norm(bf))
    n64 = float(np.sqrt(sum(float((g.double() ** 2).sum())
                            for g in bf.values())))
    njax = float(optax.global_norm(
        {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
         for k, v in bf.items()}))
    clip = 0.5
    c32, c64, cjax = (clip / (x + 1e-6) for x in (n32, n64, njax))
    assert abs(c32 - c64) / c64 < 1e-6
    assert abs(cjax - c64) / c64 < 2 ** -6


@pytest.mark.parametrize("off,match", [
    ("none", "zenflow requires offload_optimizer.device='cpu'"),
    ("nvme", "zenflow requires offload_optimizer.device='cpu'")])
def test_zenflow_requires_the_cpu_tier(off, match):
    with pytest.raises(ValueError, match=match):
        _engine(off=off, **({"zero_optimization": {
            "stage": 2, "zenflow": {"topk_ratio": 0.1},
            **({"offload_optimizer": {"device": "nvme", "nvme_path": "/x"}}
               if off == "nvme" else {})}}))


def test_config_block_and_checks():
    from deepspeed_tpu_torch.config.config import load_config

    z = load_config({"zero_optimization": {"zenflow": {}}}).zero_optimization
    assert (z.zenflow.topk_ratio, z.zenflow.update_interval,
            z.zenflow.select_interval, z.zenflow.overlap_step,
            z.zenflow.workers) == (0.01, 4, 16, True, 1)
    for bad, match in (({"topk_ratio": 0.0}, "topk_ratio"),
                       ({"workers": 0}, "workers"),
                       ({"update_interval": 0}, "intervals")):
        with pytest.raises(ValueError, match=match):
            load_config({"zero_optimization": {"zenflow": bad}})
    # ZenFlow with offload_param parses; the engine falls back to the
    # blocking offload step, as JAX's (tests/test_torch_param_stream.py)
    z = load_config({"zero_optimization": {
        "offload_optimizer": {"device": "cpu"},
        "offload_param": {"device": "cpu"}, "zenflow": {}}}).zero_optimization
    assert z.zenflow is not None and z.offload_param_device == "cpu"


@pytest.mark.parametrize("api", ["train_batch", "micro"])
@pytest.mark.parametrize("overlap", [True, False])
def test_checkpoint_resume_is_bit_identical(tmp_path, overlap, api):
    """Saved at step 3, with the pass shipped at step 2 in flight; a
    fresh engine from another seed loads it, and its 3 resumed losses
    equal the uninterrupted run's (bf16, interval 2, select 4)."""
    kw = dict(dtype="bf16", ui=2, si=4, overlap=overlap)
    eng = _engine(**kw)
    it = data_iter(eng.micro_batch_size, seed=3)
    _losses(eng, 3, api=api, it=it)
    eng.save_checkpoint(str(tmp_path))
    want = _losses(eng, 3, api=api, it=it)
    eng2 = _engine(seed=1, **kw)
    eng2.load_checkpoint(str(tmp_path))
    it2 = data_iter(eng2.micro_batch_size, seed=3)
    for _ in range(3 * eng2.gradient_accumulation_steps):
        next(it2)  # the 3 steps' batches the checkpoint consumed
    assert _losses(eng2, 3, api=api, it=it2) == want
    assert eng2.update_count == 6 and eng2.global_steps == 6


def test_load_without_optimizer_states_rebuilds_zenflow(tmp_path, caplog):
    eng = _engine(dtype="bf16", ui=2, si=4)
    _losses(eng, 3)
    eng.save_checkpoint(str(tmp_path))
    eng2 = _engine(seed=1, dtype="bf16", ui=2, si=4)
    with caplog.at_level(logging.WARNING):
        eng2.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert "ZenFlow rebuilt" in caplog.text
    zen = eng2._zenflow
    assert zen.steps == 0 and not zen._fold_due and eng2.update_count == 0
    for path, p in leaves(eng2.params):
        assert torch.equal(zen.full_fp32_param(path), p.float()), path
        assert torch.equal(p, dict(leaves(eng.params))[path])
    assert all(not o.exp_avg.any() for o in zen._host_opts)
    assert np.isfinite(_losses(eng2, 2)).all()


def test_missing_zenflow_payload_raises(tmp_path):
    plain = deepspeed_tpu_torch.initialize(
        model=zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                            **TINY),
        config={"train_micro_batch_size_per_chip": 2,
                "bf16": {"enabled": False}}, device="cpu")[0]
    plain.save_checkpoint(str(tmp_path))
    eng = _engine()
    with pytest.raises(FileNotFoundError, match="zenflow optimizer state"):
        eng.load_checkpoint(str(tmp_path))
    eng.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    for (_, a), (_, b) in zip(leaves(plain.params), leaves(eng.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("overlap", [True, False])
def test_gas_2_is_the_same_on_both_apis(overlap):
    a = _losses(_engine(gas=2, dtype="bf16", ui=2, si=4, overlap=overlap),
                5)
    b = _losses(_engine(gas=2, dtype="bf16", ui=2, si=4, overlap=overlap),
                5, api="micro")
    assert a == b and a[-1] < a[0]


def test_fp16_overflow_skips_without_counting_an_update():
    eng = _engine(dtype="fp16", fp16={"enabled": True,
                                      "initial_scale_power": 60})
    before = {p: t.clone() for p, t in leaves(eng.params)}
    _losses(eng, 1)
    assert eng.skipped_steps == 1 and eng.global_steps == 1
    assert eng.update_count == 0 and eng._zenflow.steps == 0
    for p, t in leaves(eng.params):
        assert torch.equal(t, before[p])
    assert np.isfinite(_losses(eng, 2)).all()


def test_module_state_dict_sets_the_masters():
    eng, eng2 = _engine(), _engine(seed=1)
    _losses(eng, 2)
    eng2.load_module_state_dict(eng.module_state_dict())
    for path, p in leaves(eng.params):
        assert torch.equal(eng2._zenflow.full_fp32_param(path), p), path
        assert torch.equal(dict(leaves(eng2.params))[path], p)
