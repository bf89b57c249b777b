"""The port engine's sparse wiring, dataloader and micro-step API against
the JAX engine.

Both engines start from the same fp32 masters (the JAX engine's
``opt_state.master`` through ``params_from_jax``). The JAX engine runs on
the 8-device CPU mesh; the port's world size is 1, so it gets the JAX
engine's global micro batch (``train_batch_size`` and the same GAS).
Model: a Llama-style TINY with ``attn_impl="blocksparse"`` and a
``sparse_attention`` block (fixed, block 8). fp32, AdamW lr 1e-3, clip
1.0, GAS 2. Tolerances: losses rtol 1e-4 over 4 steps, masters atol 1e-4
(fp32 sums in different orders carried through Adam steps); the port's
``forward`` / ``backward`` / ``step`` run the same operations as its
``train_batch`` and must match it bit for bit. ``eval_batch`` runs the
kernel path (its plain version on the CPU) under no_grad and matches
JAX's masked form within 1e-5.
"""

import collections
import functools
import gc
import logging
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.ops import attention as jax_attn
from deepspeed_tpu.runtime import dataloader as jax_dl
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                params_to_numpy)
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.ops import attention as attn
from deepspeed_tpu_torch.ops import blocksparse_attention as bs
from deepspeed_tpu_torch.runtime import dataloader as dl

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, pos_emb="rope", norm="rmsnorm",
            activation="swiglu", tie_embeddings=False, remat=False,
            attn_impl="blocksparse")
CFG = {"train_micro_batch_size_per_chip": 2,
       "gradient_accumulation_steps": 2,
       "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
       "gradient_clipping": 1.0, "bf16": {"enabled": False},
       "zero_optimization": {"stage": 0}, "steps_per_print": 100,
       "sparse_attention": {"mode": "fixed", "block": 8,
                            "num_local_blocks": 2}}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clear_layouts():
    """The layout is process-global in both packages: clear it after
    each test."""
    yield
    attn.set_sparse_config(None)
    jax_attn.set_sparse_config(None)


def _engines(cfg=CFG):
    jeng, *_ = dstpu.initialize(
        model=JaxLM(JaxConfig(dtype=jnp.float32, **TINY)), config=dict(cfg))
    masters = jax.tree.map(np.asarray, jeng.opt_state.master)
    pcfg = dict(cfg, train_batch_size=jeng.train_batch_size)
    del pcfg["train_micro_batch_size_per_chip"]

    def port():
        model = params_from_jax(masters, TransformerConfig(
            dtype=torch.float32, **TINY), device="cpu")
        return deepspeed_tpu_torch.initialize(model=model, config=pcfg,
                                              device="cpu")[0]

    return jeng, port


def _batches(n, rows, seq=34, seed=5):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 64, (rows, seq)).astype(np.int32)}
            for _ in range(n)]


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


def _assert_masters_close(jeng, eng):
    jm = dict(_flat(jax.tree.map(np.asarray, jeng.opt_state.master)))
    pm = dict(_flat(params_to_numpy(eng.opt_state.master)))
    assert sorted(jm) == sorted(pm)
    for path in jm:
        np.testing.assert_allclose(pm[path], jm[path], atol=1e-4, rtol=0,
                                   err_msg=path)


def test_sparse_engine_steps_and_eval_match_jax():
    jeng, port = _engines()
    eng = port()
    assert isinstance(attn._SPARSE_CONFIG, bs.FixedSparsityConfig)
    assert attn._SPARSE_CONFIG.block == 8
    fixed = _batches(2, eng.micro_batch_size)
    want = [float(jeng.train_batch(iter(fixed))) for _ in range(4)]
    got = [float(eng.train_batch(iter(fixed))) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    _assert_masters_close(jeng, eng)
    ev = _batches(1, eng.micro_batch_size, seq=50, seed=6)[0]
    np.testing.assert_allclose(float(eng.eval_batch(ev)),
                               float(jeng.eval_batch(ev)), rtol=1e-5)


def test_micro_steps_match_train_batch_and_the_jax_micro_steps():
    jeng, port = _engines()
    loop, fused = port(), port()
    batches = _batches(6, loop.micro_batch_size, seed=8)
    want, got = [], []
    for step in range(3):
        pair = batches[2 * step:2 * step + 2]
        for mb in pair:
            want.append(float(jeng.forward(mb)))
            jeng.backward()
            jeng.step()
            loss = loop(mb)
            got.append(float(loop.backward(loss).detach()))
            loop.step()
        fused.train_batch(iter(pair))
        assert loop.global_steps == fused.global_steps == step + 1
    assert loop.micro_steps == 6 and fused.micro_steps == 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for a, b in zip(_flat(params_to_numpy(loop.opt_state.master)),
                    _flat(params_to_numpy(fused.opt_state.master))):
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])
    _assert_masters_close(jeng, loop)


def test_micro_step_guards():
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                          **dict(TINY, attn_impl="xla"))
    eng = deepspeed_tpu_torch.initialize(model=model, config=dict(
        CFG, sparse_attention=None), device="cpu")[0]
    with pytest.raises(RuntimeError, match="without accumulated gradients"):
        eng.step()
    with pytest.raises(RuntimeError, match="without a prior forward"):
        eng.backward()
    mb = _batches(1, eng.micro_batch_size)[0]
    eng.backward(eng(mb))
    assert not eng.is_gradient_accumulation_boundary()
    eng.step()  # off the boundary: no update
    assert eng.global_steps == 0
    eng.backward(eng.forward(mb))
    assert eng.is_gradient_accumulation_boundary()
    eng.step()
    assert eng.global_steps == 1 and eng.micro_steps == 2
    assert all(p.grad is None for p in
               (v for _, v in _flat(eng.params)))


# -- the dataloader ------------------------------------------------------------


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 64, 9).astype(np.int32),
             "mask": rng.random(9).astype(np.float32)} for _ in range(n)]


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], np.asarray(w[key]))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_yields_jax_batches(shuffle, drop_last):
    data = _samples(11)
    ours = dl.DeepSpeedDataLoader(data, 3, shuffle=shuffle, seed=4,
                                  drop_last=drop_last)
    theirs = jax_dl.DeepSpeedDataLoader(data, 3, shuffle=shuffle, seed=4,
                                        drop_last=drop_last)
    assert len(ours) == len(theirs) == (3 if drop_last else 4)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        _same_batches(ours, theirs)
    sd = ours.state_dict()
    fresh = dl.DeepSpeedDataLoader(data, 3, shuffle=shuffle, seed=4,
                                   drop_last=drop_last)
    fresh.load_state_dict(sd)
    _same_batches(fresh, theirs)


@pytest.mark.parametrize("drop_last", [True, False])
def test_stream_dataset_and_repeating_loader(drop_last):
    data = _samples(7, seed=1)
    ours = dl.DeepSpeedDataLoader(_Stream(data), 2, drop_last=drop_last)
    theirs = jax_dl.DeepSpeedDataLoader(_Stream(data), 2,
                                        drop_last=drop_last)
    with pytest.raises(TypeError, match="no length"):
        len(ours)
    _same_batches(ours, theirs)
    rep = dl.RepeatingLoader(dl.DeepSpeedDataLoader(data, 2))
    jrep = jax_dl.RepeatingLoader(jax_dl.DeepSpeedDataLoader(data, 2))
    _same_batches([next(rep) for _ in range(8)],
                  [next(jrep) for _ in range(8)])
    assert rep.state_dict() == jrep.state_dict()
    with pytest.raises(ValueError, match="no batches"):
        next(dl.RepeatingLoader(dl.DeepSpeedDataLoader([], 2)))


class _Stream:
    """A dataset with no length: iterating it streams the samples."""

    def __init__(self, samples):
        self.samples = samples

    def __iter__(self):
        return iter(self.samples)


def test_initialize_builds_the_loader_and_train_batch_pulls_from_it():
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                          **dict(TINY, attn_impl="xla"))
    rows = _batches(4, 1, seed=9)
    data = [{"input_ids": r["input_ids"][0]} for r in rows]
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, config=dict(CFG, sparse_attention=None,
                                 bf16={"enabled": False}),
        training_data=data, device="cpu")
    assert isinstance(loader, dl.DeepSpeedDataLoader)
    assert eng.micro_batch_size == 2 and len(loader) == 2
    first = float(eng.train_batch())  # the loader's 2 microbatches
    twin = deepspeed_tpu_torch.initialize(
        model=zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                            **dict(TINY, attn_impl="xla")),
        config=dict(CFG, sparse_attention=None), device="cpu")[0]
    twin_loss = float(twin.train_batch(iter(
        [{"input_ids": np.stack([d["input_ids"] for d in data[i:i + 2]])}
         for i in (0, 2)])))
    assert first == twin_loss
    seen = []
    eng2, _, loader2, _ = deepspeed_tpu_torch.initialize(
        model=model, config=dict(CFG, sparse_attention=None),
        training_data=data, device="cpu",
        collate_fn=lambda s: seen.append(len(s)) or dl.default_collate(s))
    next(iter(loader2))
    assert seen == [2]
    with pytest.raises(ValueError, match="needs data_iter or training_data"):
        twin.train_batch()


# -- the config blocks -----------------------------------------------------------


def test_sparse_wiring_overrides_warns_and_clears(caplog):
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                          **dict(TINY, attn_impl="xla"))
    cfg = dict(CFG, kernels={"blocksparse_block": 16, "flash_block_q": 128,
                             "gmm_block_m": 256, "dispatch": "heuristic"})
    cfg["sparse_attention"] = dict(CFG["sparse_attention"],
                                   attention="bidirectional")
    with caplog.at_level(logging.WARNING), pytest.warns(UserWarning) as rec:
        deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    # the geometry knobs set away from the JAX defaults warn that they
    # have no effect; blocksparse_block and dispatch (installed for
    # impl="auto") do not
    inert = sorted(str(w.message).split("=")[0] for w in rec
                   if "has no effect" in str(w.message))
    assert inert == ["kernels.flash_block_q", "kernels.gmm_block_m"]
    assert attn._KERNEL_CONFIG.dispatch == "heuristic"
    text = caplog.text
    assert "attn_impl is not 'blocksparse'" in text
    assert "bidirectional" in text
    assert attn._SPARSE_CONFIG.block == 16  # the kernels block wins
    assert attn._SPARSE_CONFIG.num_local_blocks == 2
    deepspeed_tpu_torch.initialize(model=model, config=dict(
        CFG, sparse_attention=None), device="cpu")
    assert attn._SPARSE_CONFIG is None
    assert attn._KERNEL_CONFIG.dispatch == "auto"


@pytest.mark.parametrize("block,err,match", [
    ({"sparse_attention": {"mode": "zzz"}}, ValueError, "sparse_attention"),
    ({"sparse_attention": {"attention": "sideways"}}, ValueError,
     "unidirectional"),
    ({"kernels": {"blocksparse_block": 24}}, ValueError, "power of two"),
    ({"kernels": {"pages_per_compute_block": 0}}, ValueError, ">= 1"),
    ({"kernels": {"dispatch": "table"}}, ValueError, "auto|heuristic"),
    ({"kernels": {"flash_block_q": 100}}, ValueError, "power of two"),
    ({"resilience": {"preemption_save_deadline_s": 0}}, ValueError, "> 0"),
    ({"resilience": {"max_retries": -1}}, ValueError, ">= 0"),
    ({"resilience": {"jitter": -0.5}}, ValueError, "jitter must be >= 0"),
    ({"resilience": {"collective_timeout_s": 0}}, ValueError,
     "or null for unbounded"),
])
def test_config_blocks_validate_as_jax_does(block, err, match):
    from deepspeed_tpu_torch.config.config import load_config

    with pytest.raises(err, match=match):
        load_config(block)


# -- collate: JAX's pytree map ---------------------------------------------------

Pair = collections.namedtuple("Pair", ["tokens", "weight"])


def _same_tree(got, want):
    """Equal structure (types, keys, None where JAX keeps None) and equal
    arrays."""
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for key in want:
            _same_tree(got[key], want[key])
        return
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
        return
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, np.asarray(want))


def _tree_samples(kind, n=3, seed=2):
    rng = np.random.default_rng(seed)

    def ids():
        return rng.integers(0, 64, 9).astype(np.int32)

    if kind == "namedtuple":
        return [Pair(ids(), rng.random(9).astype(np.float32))
                for _ in range(n)]
    if kind == "none-leaf":
        return [{"input_ids": ids(), "loss_mask": None} for _ in range(n)]
    return [{"input_ids": ids(),  # nested dict of tuples
             "extra": {"pair": (ids(), rng.random(2).astype(np.float32)),
                       "list": [ids()]}} for _ in range(n)]


@pytest.mark.parametrize("kind", ["namedtuple", "none-leaf",
                                  "nested-dict-of-tuples"])
def test_default_collate_is_jax_pytree_map(kind):
    samples = _tree_samples(kind)
    _same_tree(dl.default_collate(samples), jax_dl.default_collate(samples))


@pytest.mark.parametrize("kind", ["none-leaf", "nested-dict-of-tuples"])
def test_engine_trains_on_collated_trees(kind):
    """Batches with a None leaf or nested tuples go through the loader
    into train_batch and give the losses of the plain input_ids
    batches."""
    data = _tree_samples(kind, n=4, seed=3)
    plain = [{"input_ids": s["input_ids"]} for s in data]
    losses = []
    for rows in (data, plain):
        model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                              seed=1, **dict(TINY, attn_impl="xla"))
        eng, _, loader, _ = deepspeed_tpu_torch.initialize(
            model=model, config=dict(CFG, sparse_attention=None),
            training_data=rows, device="cpu")
        losses.append([float(eng.train_batch()) for _ in range(2)])
    assert losses[0] == losses[1]


# -- gradient accumulation in fp32 (JAX's backward) ---------------------------------


def _grad_tree_rel_errs(got, want):
    """Each leaf's relative L2 error, by path (fp64)."""
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    return {p: float(np.linalg.norm(np.asarray(g[p], np.float64)
                                    - np.asarray(w[p], np.float64))
                     / np.linalg.norm(np.asarray(w[p], np.float64)))
            for p in w}


def _tree_mean64(trees):
    """The exact (fp64) mean of gradient trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_mean64([t[k] for t in trees]) for k in trees[0]}
    return sum(np.asarray(t, np.float64) for t in trees) / len(trees)


@pytest.mark.parametrize("gas", [2, 3, 16])
def test_bf16_accumulation_is_fp32_in_jax_order(gas):
    """TINY Llama, bf16 compute on the same fp32 masters, micro 2 x seq
    33 at GAS 2, 3 and 16.

    The port's micro-steps leave, before the update, each parameter's
    accumulated gradient equal bit for bit to JAX's backward formula run
    in numpy fp32 over the same microbatches' bf16 gradients: acc = g_0 *
    (1/gas), then acc + g_i * (1/gas). Against the exact (fp64) mean of
    those microbatch gradients, the worst leaf's relative error of the
    accumulation is no worse than the JAX micro-steps' against the mean
    of theirs, plus 10% (and the fp32 rounding of one add, 2**-24, as a
    floor: XLA may fuse the multiply-add into one rounding).

    The whole gradient against the fp32 one is held to JAX's below, by
    its ratio at GAS 1: each microbatch's bf16 gradient already differs
    from JAX's there, whose model here keeps fp32 activations where the
    port's engine runs bf16 ones (ROADMAP C3)."""
    from deepspeed_tpu_torch.runtime.optimizer import tree_map

    tiny = dict(TINY, attn_impl="xla")
    cfg = dict(CFG, sparse_attention=None, gradient_accumulation_steps=gas,
               bf16={"enabled": True})
    jeng, *_ = dstpu.initialize(
        model=JaxLM(JaxConfig(dtype=jnp.float32, **tiny)), config=dict(cfg))
    masters = jax.tree.map(np.asarray, jeng.opt_state.master)
    pcfg = dict(cfg, train_batch_size=jeng.train_batch_size)
    del pcfg["train_micro_batch_size_per_chip"]
    batches = _batches(gas, jeng.train_batch_size // gas, seq=34, seed=11)

    def port(steps):
        model = params_from_jax(masters, TransformerConfig(
            dtype=torch.float32, **tiny), device="cpu")
        return deepspeed_tpu_torch.initialize(
            model=model, config=dict(pcfg, gradient_accumulation_steps=steps,
                                     train_batch_size=pcfg[
                                         "train_batch_size"] // gas * steps),
            device="cpu")[0]

    single = port(1)  # each microbatch's own bf16 gradient
    micro = []
    for mb in batches:
        single.backward(single(mb))
        micro.append(params_to_numpy(tree_map(
            lambda p: p.grad.detach().float(), single.params)))
        for _, p in _flat(single.params):
            p.grad = None
    eng = port(gas)
    for mb in batches:
        eng.backward(eng(mb))
    got = params_to_numpy(tree_map(lambda p: eng._grad_acc[p], eng.params))
    coef = np.float32(1.0 / gas)
    for path, leaf in _flat(got):
        parts = [dict(_flat(m))[path] for m in micro]
        want = parts[0] * coef
        for part in parts[1:]:
            want = want + part * coef
        assert leaf.dtype == np.float32
        np.testing.assert_array_equal(leaf, want, err_msg=path)

    jax_micro = []
    for mb in batches:
        jeng.forward(mb)
        jax_micro.append(jax.tree.map(np.asarray, jeng._pending[1]))
        jeng.backward()
    jax_acc = jax.tree.map(np.asarray, jeng._grad_acc)
    ours = max(_grad_tree_rel_errs(got, _tree_mean64(micro)).values())
    theirs = max(_grad_tree_rel_errs(jax_acc,
                                     _tree_mean64(jax_micro)).values())
    assert ours <= 1.1 * theirs + 2.0 ** -24, (ours, theirs)


@functools.lru_cache(maxsize=None)
def _bf16_grad_errs(gas, jax_dtype="float32"):
    """TINY Llama on the JAX engine's fp32 masters, micro-steps over
    ``gas`` microbatches (seed 11; the first is the same at every GAS).
    Returns the worst leaf's relative error of the accumulated bf16
    gradient against the port's fp32 one (same masters, same GAS), for
    the port and for the JAX engine. ``jax_dtype`` is the JAX model's
    activation dtype (``TransformerConfig.dtype``; its parameters stay
    fp32): the JAX engine's bf16 block rounds the weights to bf16 and
    leaves the activations at that dtype, where the port's engine runs
    them in the compute dtype, bf16 (ROADMAP C3)."""
    from deepspeed_tpu_torch.runtime.optimizer import tree_map

    tiny = dict(TINY, attn_impl="xla")
    cfg = dict(CFG, sparse_attention=None, gradient_accumulation_steps=gas,
               bf16={"enabled": True})
    jeng, *_ = dstpu.initialize(
        model=JaxLM(JaxConfig(dtype=getattr(jnp, jax_dtype), **tiny)),
        config=dict(cfg))
    masters = jax.tree.map(np.asarray, jeng.opt_state.master)
    pcfg = dict(cfg, train_batch_size=jeng.train_batch_size)
    del pcfg["train_micro_batch_size_per_chip"]
    batches = _batches(gas, jeng.train_batch_size // gas, seq=34, seed=11)
    grads = {}
    for bf16 in (False, True):
        eng = deepspeed_tpu_torch.initialize(
            model=params_from_jax(masters, TransformerConfig(
                dtype=torch.float32, **tiny), device="cpu"),
            config=dict(pcfg, bf16={"enabled": bf16}), device="cpu")[0]
        for mb in batches:
            eng.backward(eng(mb))
        grads[bf16] = params_to_numpy(tree_map(
            (lambda p: eng._grad_acc[p]) if gas > 1
            else (lambda p: p.grad.detach().float()), eng.params))
    for mb in batches:
        jeng.forward(mb)
        jeng.backward()
    ours = max(_grad_tree_rel_errs(grads[True], grads[False]).values())
    theirs = max(_grad_tree_rel_errs(
        jax.tree.map(np.asarray, jeng._grad_acc), grads[False]).values())
    print(f"worst-leaf relative error vs fp32 at GAS {gas} (JAX "
          f"activations {jax_dtype}): port {ours:.3e}, JAX {theirs:.3e}, "
          f"ratio {ours / theirs:.4f}")
    return ours, theirs


def test_bf16_gradient_gap_to_jax_at_gas_1():
    """One microbatch, no accumulation, against a JAX model built with
    fp32 activations: the worst leaf's relative error of the port's bf16
    gradient against its fp32 one stays within 2x the JAX engine's. The
    gap (~1.55x on this input) is the activation dtype: the JAX engine
    rounds only the weights to bf16 and keeps this model's fp32
    activations, the port's engine runs the activations in bf16 too
    (ROADMAP C3, a deliberate difference; the test below compares like
    with like)."""
    ours, theirs = _bf16_grad_errs(1)
    assert ours <= 2.0 * theirs


def test_bf16_gradient_matches_jax_at_bf16_activations():
    """One microbatch, against a JAX model at its default activation
    dtype, bf16, the configuration that computes what the port's bf16
    engine computes: the port's worst-leaf relative error against fp32
    is no more than the JAX engine's (0.877x on this input: port 2.375e-2,
    JAX 2.709e-2; the bound leaves a 14% margin for the worst leaf's
    run-to-run choice). No rounding of eager PyTorch is missing from
    XLA's: fp32 elementwise chains in the port's model (ROADMAP C3's
    probes) do not bring it closer."""
    ours, theirs = _bf16_grad_errs(1, "bfloat16")
    assert ours <= 1.0 * theirs, (ours, theirs)


@pytest.mark.parametrize("gas", [2, 3, 16])
def test_bf16_accumulated_gradient_gap_to_jax_holds_with_gas(gas):
    """The accumulated bf16 gradient against the fp32 one at GAS 2, 3 and
    16, the port's worst leaf over the JAX micro-steps': no more than
    1.1x that ratio at GAS 1. The per-microbatch gap (C3: the JAX model's
    fp32 activations) is allowed for; an accumulation that loses
    precision with GAS is not (bf16 accumulation gave ~2.0x at GAS 2
    against ~1.55x at GAS 1)."""
    ours, theirs = _bf16_grad_errs(gas)
    ours_1, theirs_1 = _bf16_grad_errs(1)
    assert ours / theirs <= 1.1 * (ours_1 / theirs_1), (
        ours, theirs, ours_1, theirs_1)


def test_bf16_micro_steps_match_train_batch_bit_for_bit():
    cfg = dict(CFG, sparse_attention=None, bf16={"enabled": True})

    def engine():
        model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                              seed=2, **dict(TINY, attn_impl="xla"))
        return deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                              device="cpu")[0]

    loop, fused = engine(), engine()
    batches = _batches(4, loop.micro_batch_size, seed=12)
    for step in range(2):
        pair = batches[2 * step:2 * step + 2]
        for mb in pair:
            loop.backward(loop(mb))
            loop.step()
        fused.train_batch(iter(pair))
    for a, b in zip(_flat(params_to_numpy(loop.opt_state.master)),
                    _flat(params_to_numpy(fused.opt_state.master))):
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])
    assert not loop._grad_acc and not fused._grad_acc
    assert all(p.grad is None for _, p in _flat(loop.params))


def test_engine_with_accumulation_is_freed_without_the_collector():
    """The accumulation hooks hold the engine weakly: dropping the last
    reference frees the engine (and its tensors) at once, with the
    garbage collector off."""
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                          **dict(TINY, attn_impl="xla"))
    eng = deepspeed_tpu_torch.initialize(model=model, config=dict(
        CFG, sparse_attention=None), device="cpu")[0]
    eng.train_batch(iter(_batches(2, eng.micro_batch_size)))
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_fp16_overflow_steps_match_jax():
    """fp16 at initial_scale_power 30, GAS 2: every step overflows; 10
    train_batch steps give the JAX engine's losses, loss scales, skipped
    steps and global_steps."""
    tiny = dict(TINY, attn_impl="xla")
    cfg = dict(CFG, sparse_attention=None, bf16={"enabled": False},
               fp16={"enabled": True, "initial_scale_power": 30})
    jeng, *_ = dstpu.initialize(
        model=JaxLM(JaxConfig(dtype=jnp.float32, **tiny)), config=dict(cfg))
    masters = jax.tree.map(np.asarray, jeng.opt_state.master)
    pcfg = dict(cfg, train_batch_size=jeng.train_batch_size)
    del pcfg["train_micro_batch_size_per_chip"]
    eng = deepspeed_tpu_torch.initialize(
        model=params_from_jax(masters, TransformerConfig(
            dtype=torch.float32, **tiny), device="cpu"),
        config=pcfg, device="cpu")[0]
    batches = _batches(2, eng.micro_batch_size, seed=13)
    want, got = [], []
    for _ in range(10):
        loss = float(jeng.train_batch(iter(batches)))
        want.append((loss, jeng.loss_scale, jeng.skipped_steps,
                     jeng.global_steps))
        loss = float(eng.train_batch(iter(batches)))
        got.append((loss, eng.loss_scale, eng.skipped_steps,
                    eng.global_steps))
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=3e-5)
    assert [g[1:] for g in got] == [w[1:] for w in want]
    assert got[-1][2] == 10  # every step skipped
