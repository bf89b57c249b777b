"""ZeRO-Offload in the port against the JAX package's
(``tests/test_offload.py`` contracts).

The native host optimizers are the same C++ in both packages, so the
port's ``CPUAdam`` / ``CPULion`` / ``CPUAdagrad`` steps are bit-equal to
JAX's on the same buffers (the port builds with ``-fno-math-errno``,
which vectorizes the Adam loop and keeps its bits), within rtol 1e-6 of
their plain PyTorch twins (the native build may contract a multiply-add
into one rounding), and ``CPUAdam`` follows the port's device AdamW
(optax numerics) at JAX's own rtol 1e-5 / atol 1e-6 over 5 steps.

The offload engine follows JAX's offload engine (the JAX engine on the
8-device CPU mesh at ZeRO stage 2, the port at world size 1 with the JAX
global micro batch; weights carried over from the JAX host masters by
``params_from_jax``) for 4 steps: fp32 losses at rtol 1e-5, masters at
atol 1e-4 (``tests/test_torch_engine.py``'s); bf16 losses at rtol 2e-3
(the two frameworks round different bf16 activations)
and masters at atol 8 lr (an Adam step moves an element by about lr at
most, so two runs part by at most 2 lr a step). Against the port's
device-optimizer engine: rtol 3e-3, JAX's ``test_offload_matches_
device_optimizer``. The cpu and NVMe tiers give ``==`` losses and
masters. The gradient norm is taken in fp32 on the grads' device where
JAX sums the host copies in double: the clip coefficients part by less
than 1e-6 relative (ROADMAP C).
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.ops.native import cpu_optimizer as jco
from deepspeed_tpu_torch.config.config import load_config
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.ops.native import builder
from deepspeed_tpu_torch.ops.native import cpu_optimizer as co
from deepspeed_tpu_torch.runtime import offload as offload_mod
from deepspeed_tpu_torch.runtime.offload import HostOffloadOptimizer
from deepspeed_tpu_torch.runtime.optimizer import (
    Adam, MixedPrecisionState, apply_mixed_precision_update, leaves,
    set_leaf)

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


def data_iter(batch, seq=17, seed=0, n_fixed=2):
    """The JAX ``tests/test_offload.py`` data: a small fixed set, cycled."""
    rng = np.random.default_rng(seed)
    fixed = [{"input_ids": rng.integers(0, 64, (batch, seq)).astype(np.int32)}
             for _ in range(n_fixed)]
    i = 0
    while True:
        yield fixed[i % n_fixed]
        i += 1


def _config(off="cpu", gas=1, dtype="bf16", nvme_path=None, **extra):
    cfg = {"train_micro_batch_size_per_chip": 2,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "adamw", "params": {"lr": LR}},
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "bf16": {"enabled": dtype == "bf16"},
           "zero_optimization": {"stage": 2, "offload_optimizer": {
               "device": off, "nvme_path": nvme_path}}}
    if dtype == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    cfg.update(extra)
    return cfg


def _engine(off="cpu", gas=1, dtype="bf16", seed=0, nvme_path=None,
            model=None, **extra):
    if model is None:
        model = zoo.get_model("tiny", device="cpu", seed=seed,
                              dtype=torch.float32, **TINY)
    return deepspeed_tpu_torch.initialize(
        model=model, config=_config(off, gas, dtype, nvme_path, **extra),
        device="cpu")[0]


def _losses(engine, n, seed=0, api="train_batch"):
    it = data_iter(engine.micro_batch_size, seed=seed)
    out = []
    for _ in range(n):
        if api == "train_batch":
            out.append(float(engine.train_batch(it)))
            continue
        for _ in range(engine.gradient_accumulation_steps):
            loss = engine(next(it))
            engine.backward(loss)
            engine.step()
        out.append(float(engine.last_metrics["loss"]))
    return out


def _masters(engine):
    off = engine._offload
    return {p: off.full_fp32_param(p).clone() for p in off.optimizers}


# -- the native optimizers -------------------------------------------------------


def _rand(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("adamw_mode", [True, False])
def test_cpu_adam_bit_equal_to_jax_and_near_its_twin(adamw_mode):
    n = 100_003
    p0 = _rand(n, 0)
    pt, pj, pp = torch.from_numpy(p0.copy()), p0.copy(), \
        torch.from_numpy(p0.copy())
    port = co.CPUAdam(n, lr=LR, weight_decay=0.01, adamw_mode=adamw_mode)
    jax_ = jco.CPUAdam(n, lr=LR, weight_decay=0.01, adamw_mode=adamw_mode)
    m, v = torch.zeros(n), torch.zeros(n)
    out, out_j = torch.empty(n, dtype=torch.bfloat16), np.empty(n, np.uint16)
    for step in range(1, 6):
        g = _rand(n, step)
        gt = torch.from_numpy(g)
        if step == 5:  # the bf16-gradient entry
            gt = gt.to(torch.bfloat16)
            g = gt.view(torch.int16).numpy().view(np.uint16)
        port.step(pt, gt, out)
        jax_.step(pj, g, out_j)
        co.adam_plain(pp, gt, m, v, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                      weight_decay=0.01, step=step, adamw_mode=adamw_mode)
        assert np.array_equal(pt.numpy(), pj), step
        assert np.array_equal(out.view(torch.int16).numpy().view(np.uint16),
                              out_j)
        np.testing.assert_allclose(pt.numpy(), pp.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert np.array_equal(port.exp_avg_sq.numpy(), jax_.exp_avg_sq)
    np.testing.assert_allclose(port.exp_avg.numpy(), m.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert port.state_dict()["step"] == jax_.state_dict()["step"] == 5


def test_cpu_lion_and_adagrad_bit_equal_to_jax_and_near_their_twins():
    n = 50_001
    p0 = _rand(n, 1)
    lt, lj, lp = torch.from_numpy(p0.copy()), p0.copy(), \
        torch.from_numpy(p0.copy())
    at, aj, ap = torch.from_numpy(p0.copy()), p0.copy(), \
        torch.from_numpy(p0.copy())
    lion, jlion = co.CPULion(n, lr=1e-3, weight_decay=0.1), \
        jco.CPULion(n, lr=1e-3, weight_decay=0.1)
    ada, jada = co.CPUAdagrad(n, lr=1e-2, weight_decay=0.01), \
        jco.CPUAdagrad(n, lr=1e-2, weight_decay=0.01)
    lm, av = torch.zeros(n), torch.zeros(n)
    for step in range(1, 4):
        g = _rand(n, 10 + step)
        gt = torch.from_numpy(g)
        lion.step(lt, gt)
        jlion.step(lj, g)
        co.lion_plain(lp, gt, lm, lr=1e-3, betas=(0.9, 0.99),
                      weight_decay=0.1)
        ada.step(at, gt)
        jada.step(aj, g)
        co.adagrad_plain(ap, gt, av, lr=1e-2, eps=1e-10, weight_decay=0.01)
        assert np.array_equal(lt.numpy(), lj)
        assert np.array_equal(at.numpy(), aj)
        np.testing.assert_allclose(lt.numpy(), lp.numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(at.numpy(), ap.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert set(lion.state_dict()) == set(jlion.state_dict()) == {"exp_avg"}
    assert set(ada.state_dict()) == set(jada.state_dict()) == {"exp_avg_sq"}


def test_cpu_adam_follows_the_device_adamw_over_five_steps():
    """JAX's test_cpu_adam_matches_optax: the port's device AdamW has
    optax's numerics."""
    n = 4096
    p0 = torch.from_numpy(_rand(n, 0))
    cpu = co.CPUAdam(n, lr=LR, weight_decay=0.01, adamw_mode=True)
    tx = Adam(lr=LR, weight_decay=0.01, decoupled=True)
    state = MixedPrecisionState(master={"w": p0.clone()},
                                mu={"w": torch.zeros(n)},
                                nu={"w": torch.zeros(n)})
    cp = p0.clone()
    for step in range(5):
        g = torch.from_numpy(_rand(n, 100 + step))
        apply_mixed_precision_update(state, {"w": g}, tx)
        cpu.step(cp, g)
        np.testing.assert_allclose(cp.numpy(), state.master["w"].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_bf16_conversions_bit_equal_to_torch_and_jax():
    x = torch.from_numpy(_rand(100_000, 7) * 100)
    x[:4] = torch.tensor([0.0, -0.0, 1e-40, 3.0e38])
    ours = co.f32_to_bf16(x)
    assert torch.equal(ours, x.to(torch.bfloat16))
    assert np.array_equal(ours.view(torch.int16).numpy().view(np.uint16),
                          jco.f32_to_bf16(x.numpy()))
    assert torch.equal(co.bf16_to_f32(ours), ours.float())
    with pytest.raises(ValueError, match="bf16"):
        co.bf16_to_f32(x)


def test_native_pointers_are_checked():
    opt = co.CPUAdam(8)
    with pytest.raises(ValueError, match="contiguous CPU"):
        opt.step(torch.zeros(16)[::2], torch.zeros(8))
    with pytest.raises(ValueError, match="float32"):
        opt.step(torch.zeros(8, dtype=torch.float64), torch.zeros(8))
    with pytest.raises(ValueError, match="8 elements"):
        opt.step(torch.zeros(8), torch.zeros(9))


# -- the offload optimizer ---------------------------------------------------------


def test_streaming_in_chunks_gives_the_whole_leaf_bits(tmp_path):
    """Chunks of 7 elements through 2 staging buffers, bf16 params, a
    clip and a loss scale: the same bits as one native step a leaf; the
    NVMe tier's too."""
    rng = np.random.default_rng(0)
    shapes = {"a": (13, 5), "b": {"c": (40,), "d": (3,)}}

    def tree(fn):
        return {k: tree_of(v, fn) for k, v in shapes.items()}

    def tree_of(v, fn):
        return {k: fn(s) for k, s in v.items()} if isinstance(v, dict) \
            else fn(v)

    p32 = tree(lambda s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)))
    grads = [tree(lambda s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 64).to(torch.bfloat16))
        for _ in range(3)]
    runs = {}
    for name, kw in (("whole", {}), ("chunks", {"chunk_elems": 7,
                                                "buffer_count": 2}),
                     ("nvme", {"chunk_elems": 7, "buffer_count": 2,
                               "nvme_path": str(tmp_path)})):
        src = {k: (v.clone() if not isinstance(v, dict) else
                   {kk: vv.clone() for kk, vv in v.items()})
               for k, v in p32.items()}
        off = HostOffloadOptimizer(src, optimizer_params={"lr": LR},
                                   grad_clip=0.5, **kw)
        params = {p: t.to(torch.bfloat16) for p, t in leaves(src)}
        nested = {}
        for p, t in params.items():
            set_leaf(nested, p, t)
        norms = [off.step(g, nested, grad_scale=64.0)[0] for g in grads]
        runs[name] = (norms, {p: off.full_fp32_param(p).clone()
                              for p in off.optimizers},
                      {p: t.clone() for p, t in leaves(nested)})
        assert off.count == 3
        off.close()
    for name in ("chunks", "nvme"):
        assert runs[name][0] == runs["whole"][0]
        for i in (1, 2):
            for p, t in runs["whole"][i].items():
                assert torch.equal(runs[name][i][p], t), (name, p)
    # the params are the masters in bf16
    for p, m in runs["whole"][1].items():
        assert torch.equal(runs["whole"][2][p], m.to(torch.bfloat16))


def test_norm_gap_against_a_double_precision_sum():
    """The fp32 norm on the grads' device (one host read) against the
    double sum JAX takes on the host: the clip coefficients part by less
    than 1e-6 relative."""
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.standard_normal((1000, 4096))
                               .astype(np.float32) * 1e-3),
         "b": torch.from_numpy(rng.standard_normal(3_000_001)
                               .astype(np.float32))}
    off = HostOffloadOptimizer({k: v.clone() for k, v in g.items()},
                               grad_clip=1.0, chunk_elems=1 << 20)
    for dtype in (torch.float32, torch.bfloat16):
        gd = {k: v.to(dtype) for k, v in g.items()}
        n32 = off.grad_norm(gd, grad_scale=4.0)
        sq = sum(float(np.dot(x.float().numpy().astype(np.float64).ravel(),
                              x.float().numpy().astype(np.float64).ravel()))
                 for x in gd.values()) / 16.0
        n64 = float(np.sqrt(sq))
        c32, c64 = 1.0 / (n32 + 1e-6), 1.0 / (n64 + 1e-6)
        assert abs(c32 - c64) / c64 < 1e-6, (dtype, n32, n64)


def test_offload_requires_the_native_library(monkeypatch):
    """No numpy fallback: a library that does not build stops the
    offload engine at construction."""
    monkeypatch.setattr(builder, "_lib", None)
    monkeypatch.setattr(builder, "_build_error", "no C++ compiler (test)")
    with pytest.raises(RuntimeError, match="native host library"):
        _engine()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        co.CPUAdam(4)


# -- the engine ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_parity():
    """4 steps of the JAX offload engine and of the port's, fp32 and
    bf16, GAS 1 and 2, from the JAX host masters; the port's device
    optimizer from the same weights."""
    out = {}
    for dtype in ("fp32", "bf16"):
        for gas in (1, 2):
            cfg = _config("cpu", gas, dtype)
            jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
            jeng, *_ = dstpu.initialize(
                model=JaxLM(JaxConfig(dtype=jdt, **TINY)), config=dict(cfg))
            flat, tdef = jax.tree_util.tree_flatten_with_path(jeng.params)
            masters = jax.tree_util.tree_unflatten(tdef, [
                np.asarray(jeng._offload.full_fp32_param(
                    jax.tree_util.keystr(kp))) for kp, _ in flat])
            pcfg = dict(cfg, train_batch_size=jeng.train_batch_size)
            del pcfg["train_micro_batch_size_per_chip"]
            dcfg = dict(pcfg, zero_optimization={"stage": 2})
            runs = {}
            for name, c in (("port", pcfg), ("device", dcfg)):
                model = params_from_jax(masters, TransformerConfig(
                    dtype=torch.float32, **TINY), device="cpu")
                eng = deepspeed_tpu_torch.initialize(model=model, config=c,
                                                     device="cpu")[0]
                runs[name] = (eng, _losses(eng, 4, seed=5))
            rows = jeng.micro_batch_size * jeng.dp_world_size
            it = data_iter(rows, seed=5)
            want = [float(jeng.train_batch(it)) for _ in range(4)]
            jm = {"/" + "/".join(k.key for k in kp): np.asarray(
                jeng._offload.full_fp32_param(jax.tree_util.keystr(kp)))
                for kp, _ in flat}
            out[(dtype, gas)] = {"jax": want, "jax_masters": jm,
                                 "port": runs["port"],
                                 "device": runs["device"][1]}
    return out


@pytest.mark.parametrize("gas", [1, 2])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_offload_engine_follows_the_jax_offload_engine(jax_parity, dtype,
                                                       gas):
    r = jax_parity[(dtype, gas)]
    eng, got = r["port"]
    rtol, atol = (1e-5, 1e-4) if dtype == "fp32" else (2e-3, 8 * LR)
    np.testing.assert_allclose(got, r["jax"], rtol=rtol)
    assert eng.global_steps == 4 and eng._offload.count == 4
    masters = _masters(eng)
    assert sorted(masters) == sorted(r["jax_masters"])
    for path, want in r["jax_masters"].items():
        np.testing.assert_allclose(masters[path].numpy(), want, atol=atol,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("gas", [1, 2])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_offload_engine_matches_the_device_optimizer(jax_parity, dtype, gas):
    r = jax_parity[(dtype, gas)]
    np.testing.assert_allclose(r["port"][1], r["device"], rtol=3e-3)


@pytest.mark.parametrize("gas", [1, 2])
def test_cpu_and_nvme_tiers_are_bit_identical(tmp_path, gas):
    cpu = _engine("cpu", gas)
    nvme = _engine("nvme", gas, nvme_path=str(tmp_path))
    assert _losses(cpu, 4) == _losses(nvme, 4)
    a, b = _masters(cpu), _masters(nvme)
    assert all(torch.equal(a[p], b[p]) for p in a)
    for (_, x), (_, y) in zip(leaves(cpu.params), leaves(nvme.params)):
        assert torch.equal(x, y)
    folder = nvme._offload.swap_folder
    assert folder.startswith(str(tmp_path)) and "dstpu_opt_swap" in folder
    names = os.listdir(folder)
    # master, exp_avg and exp_avg_sq of every leaf
    assert len(names) == 3 * len(nvme._offload.optimizers)
    assert nvme._offload.masters == dict.fromkeys(nvme._offload.masters)
    nvme._offload.close()
    assert os.listdir(folder) == []


def test_offload_losses_fall_at_every_stage():
    for stage in (0, 1, 2, 3):
        eng = _engine(zero_optimization={
            "stage": stage, "offload_optimizer": {"device": "cpu"}})
        losses = _losses(eng, 8)
        assert losses[-1] < losses[0] - 0.3, (stage, losses)
        assert eng.opt_state is None and eng.tx is None


def test_micro_step_path_at_gas_2_equals_train_batch():
    """engine(batch) / backward / step at GAS 2: the same grads in
    p.grad, the same bits as train_batch; no fp32 accumulators."""
    a, b = _engine(gas=2), _engine(gas=2)
    la = _losses(a, 3)
    lb = _losses(b, 3, api="micro_steps")
    assert la == lb
    assert b.global_steps == 3 and b.micro_steps == 6
    assert b._grad_acc == {}
    assert all(p.grad is None for _, p in leaves(b.params))
    assert lb[-1] < lb[0]


def test_fp16_overflow_skips_the_step():
    eng = _engine(dtype="fp16")
    before = _masters(eng)
    params = {p: t.clone() for p, t in leaves(eng.params)}
    it = data_iter(2)
    eng.loss_scale_state = type(eng.loss_scale_state)(2.0 ** 30, 0)
    eng.train_batch(it)  # scaled grads overflow fp16: skipped
    assert eng.last_metrics["overflow"] and eng.skipped_steps == 1
    assert eng._offload.count == 0
    assert eng.loss_scale < 2.0 ** 30
    after = _masters(eng)
    assert all(torch.equal(before[p], after[p]) for p in before)
    assert all(torch.equal(params[p], t) for p, t in leaves(eng.params))
    assert all(o.step_count == 0 for o in eng._offload.optimizers.values())
    # at the default scale it trains (JAX test_offload_fp16_loss_scaling)
    eng = _engine(dtype="fp16")
    losses = _losses(eng, 8)
    assert losses[-1] < losses[0] - 0.3 and eng.skipped_steps == 0


def test_bf16_grad_transfer_trains():
    """grad_transfer_dtype bf16: on a bf16 model the grads are bf16
    already (the same bits as fp32 transfer); on an fp32 model they are
    rounded to bf16 for the host and still train."""
    fp32, bf16 = ({"stage": 2, "offload_optimizer": {
        "device": "cpu", "grad_transfer_dtype": x}} for x in ("fp32", "bf16"))
    assert _losses(_engine(zero_optimization=fp32), 4) == \
        _losses(_engine(zero_optimization=bf16), 4)
    eng = _engine(dtype="fp32", zero_optimization=bf16)
    assert eng._offload.xfer_dtype == torch.bfloat16
    losses = _losses(eng, 8)
    assert losses[-1] < losses[0] - 0.3
    assert losses != _losses(_engine(dtype="fp32", zero_optimization=fp32), 8)


def test_lion_offload_trains():
    eng = _engine(optimizer={"type": "lion", "params": {"lr": LR}})
    assert type(next(iter(eng._offload.optimizers.values()))) is co.CPULion
    losses = _losses(eng, 6)
    assert losses[-1] < losses[0] - 0.2


def test_an_fp32_model_shares_the_host_masters():
    model = zoo.get_model("tiny", device="cpu", seed=0, dtype=torch.float32,
                          **TINY)
    eng = _engine(model=model)
    _losses(eng, 2)
    wq = model.params()["layers"]["attn"]["wq"]
    assert torch.equal(wq, eng._offload.full_fp32_param("layers/attn/wq"))
    assert wq.data_ptr() == eng._offload.masters["/layers/attn/wq"].data_ptr()


def test_fragment_apis_and_module_state_dict(tmp_path):
    eng = _engine()
    _losses(eng, 2)
    off = eng._offload
    full = off.full_fp32_param("/layers/attn/wq")
    assert full.shape == eng.params["layers"]["attn"]["wq"].shape
    assert torch.equal(full.to(torch.bfloat16),
                       eng.params["layers"]["attn"]["wq"])
    assert off.full_optimizer_state("layers/attn/wq", "exp_avg").abs().sum() > 0
    assert off.full_optimizer_state("layers/attn/wq", "nope") is None
    off.set_full_fp32_param("layers/attn/wq", torch.zeros_like(full))
    assert not off.full_fp32_param("layers/attn/wq").any()
    with pytest.raises(KeyError, match="no offloaded leaf"):
        off.full_fp32_param("layers/attn/nope")
    with pytest.raises(ValueError, match="shape"):
        off.set_full_fp32_param("layers/attn/wq", torch.zeros(3))
    sd = eng.module_state_dict()
    other = _engine(seed=1)
    other.load_module_state_dict(sd)
    key = "layers.attn.wo"
    assert torch.equal(other._offload.full_fp32_param("layers/attn/wo"),
                       torch.from_numpy(sd[key]))
    assert torch.equal(other.params["layers"]["attn"]["wo"],
                       torch.from_numpy(sd[key]).to(torch.bfloat16))
    nv = _engine("nvme", nvme_path=str(tmp_path))
    nv.load_module_state_dict(sd)
    assert torch.equal(nv._offload.full_fp32_param("layers/attn/wo"),
                       torch.from_numpy(sd[key]))


@pytest.mark.parametrize("off", ["cpu", "nvme"])
@pytest.mark.parametrize("fast", [False, True])
def test_checkpoint_resume_is_bit_identical(tmp_path, off, fast):
    def make(seed):
        return _engine(off, seed=seed, nvme_path=str(tmp_path / f"swap{seed}"),
                       checkpoint={"parallel_write_pipeline": fast},
                       scheduler={"type": "WarmupLR",
                                  "params": {"warmup_num_steps": 4}})

    eng = make(0)
    it = data_iter(2)
    for _ in range(3):
        eng.train_batch(it)
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    ref = [float(eng.train_batch(it)) for _ in range(2)]
    state = os.path.join(tmp_path, "ckpt", "global_step3", "state")
    assert sorted(os.listdir(state)) == ["loss_scale", "offload_optim_rank0",
                                         "opt_count.pt", "params"]
    assert sorted(os.listdir(os.path.join(state, "offload_optim_rank0"))) \
        == ["exp_avg", "exp_avg_sq", "master", "step"]
    eng2 = make(1)
    it2 = data_iter(2)
    for _ in range(3):
        next(it2)
    eng2.load_checkpoint(str(tmp_path / "ckpt"))
    assert eng2.global_steps == 3 and eng2._offload.count == 3
    assert eng2.get_lr() == [eng.lr_schedule(3)]
    assert [float(eng2.train_batch(it2)) for _ in range(2)] == ref


def test_missing_offload_payload_raises(tmp_path):
    dev = _engine(zero_optimization={"stage": 2})
    _losses(dev, 1)
    dev.save_checkpoint(str(tmp_path))
    eng = _engine()
    with pytest.raises(FileNotFoundError,
                       match="offload optimizer state missing"):
        eng.load_checkpoint(str(tmp_path))


def test_load_without_optimizer_states_reseeds_the_masters(tmp_path):
    """JAX test_offload_load_without_optimizer_states: the masters come
    from the restored params, the moments and counts start over."""
    eng = _engine()
    _losses(eng, 3)
    eng.save_checkpoint(str(tmp_path))
    ref = {p: t.clone() for p, t in leaves(eng.params)}
    eng2 = _engine(seed=1)
    _losses(eng2, 1)
    eng2.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    off = eng2._offload
    restored = dict(leaves(eng2.params))
    for p, t in ref.items():
        assert torch.equal(restored[p], t)
        assert torch.equal(off.full_fp32_param(p), t.float())
        assert not off.full_optimizer_state(p, "exp_avg").any()
    assert off.count == 0
    assert all(o.step_count == 0 for o in off.optimizers.values())
    eng2.train_batch(data_iter(2))  # does not roll the params back to init
    got = eng2.params["layers"]["attn"]["wq"].float()
    assert (got - ref["/layers/attn/wq"].float()).abs().max() < 0.05


def test_offload_states_roundtrip_and_unknown_include_raises():
    for eng in (_engine(), _engine(zero_optimization={"stage": 2})):
        _losses(eng, 1)
        before = {p: t.clone() for p, t in leaves(eng.params)}
        eng.offload_states()
        # a CPU engine's state is host memory already: nothing moves
        assert eng._offloaded_states == []
        eng.reload_states()
        assert eng._offloaded_states is None
        assert all(torch.equal(before[p], t) for p, t in leaves(eng.params))
        eng.offload_states(include={"lp_params"})
        eng.reload_states()
        eng.reload_states()  # a second reload is a no-op
        with pytest.raises(ValueError, match="unknown offload_states"):
            eng.offload_states(include={"lp_params", "kv_cache"})
        with pytest.raises(ValueError, match="device='cpu'"):
            eng.offload_states(device="nvme")
        _losses(eng, 1)


def test_config_checks():
    with pytest.raises(ValueError, match="requires nvme_path"):
        load_config({"zero_optimization": {"offload_optimizer": {
            "device": "nvme"}}})
    with pytest.raises(ValueError, match="none\\|cpu\\|nvme"):
        load_config({"zero_optimization": {"offload_optimizer": {
            "device": "gpu"}}})
    with pytest.raises(ValueError, match="fp32\\|bf16"):
        load_config({"zero_optimization": {"offload_optimizer": {
            "device": "cpu", "grad_transfer_dtype": "fp16"}}})
    with pytest.raises(ValueError, match="buffer_count"):
        load_config({"zero_optimization": {"offload_optimizer": {
            "device": "cpu", "buffer_count": 0}}})
    cfg = load_config({"zero_optimization": {"offload_optimizer": {
        "device": "cpu", "pipeline_read": True, "ratio": 0.5,
        "pin_memory": True, "buffer_count": 2}}})
    off = cfg.zero_optimization.offload_optimizer
    assert (off.buffer_count, off.pin_memory) == (2, True)
    assert cfg.zero_optimization.offload_device == "cpu"
    assert cfg.to_dict()["zero_optimization"]["offload_optimizer"][
        "device"] == "cpu"
    assert load_config({"zero_optimization": {"offload_optimizer": {
        "device": None}}}).zero_optimization.offload_device == "none"
    par = load_config({"zero_optimization": {"offload_param": {
        "device": "cpu"}}}).zero_optimization
    assert (par.offload_param.device, par.offload_param_device) == ("cpu",
                                                                    "cpu")
    with pytest.raises(ValueError, match="offload_param.device"):
        load_config({"zero_optimization": {"offload_param": {
            "device": "gpu"}}})
    zen = load_config({"zero_optimization": {"offload_optimizer": {
        "device": "cpu"}, "zenflow": {"topk_ratio": 0.1}}}).zero_optimization
    assert zen.zenflow.topk_ratio == 0.1 and zen.offload_device == "cpu"
    with pytest.raises(ValueError, match="host offload supports"):
        _engine(optimizer={"type": "sgd", "params": {"lr": 0.1}})


def test_engine_logs_the_offload_tier(caplog):
    with caplog.at_level(logging.INFO, logger=offload_mod.logger.name):
        _engine()
    assert "host offload optimizer" in caplog.text and "on cpu" in caplog.text
