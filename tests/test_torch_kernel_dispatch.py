"""The port's measured kernel dispatch against the JAX package's (after
``tests/test_kernel_dispatch.py``): the win/loss table
(``ops/kernel_table.py``), the registry's decision layer
(``ops/registry.py``) and ``multi_head_attention(impl="auto")``
consulting both, plus the ``kernels`` config keys that steer them.

Both packages read one table file (``DSTPU_KERNEL_TABLE`` is the same
variable), so each test plants rows once and asks both. The port's
decision sources are "kernel" / "xla" where JAX's are "pallas" / "xla".
A winning bucket runs the flash kernel's plain version on the CPU, held
within 2e-5 of JAX's Pallas kernel in interpret mode (fp32); a losing one
is ``torch.equal`` to ``xla_attention``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config.config import KernelsConfig as JaxKernelsConfig
from deepspeed_tpu.ops import attention as jax_attn
from deepspeed_tpu.ops import kernel_table as jax_table
from deepspeed_tpu.ops import registry as jax_registry
import deepspeed_tpu_torch
from deepspeed_tpu_torch.config.config import KernelsConfig
from deepspeed_tpu_torch.ops import attention as attn_ops
from deepspeed_tpu_torch.ops import kernel_table, registry

SOURCE = {"pallas": "kernel", "xla": "xla"}  # JAX's name -> the port's
CARD = "NVIDIA H100 80GB HBM3"


def _entry(ratio, backend, blocks=None, device=None):
    e = {"kernel_ms": 1.0, "xla_ms": ratio, "ratio": ratio,
         "backend": backend}
    if device:
        e["device"] = device
    if blocks:
        e["blocks"] = blocks
    return e


@pytest.fixture
def table_env(tmp_path, monkeypatch):
    """Point both dispatchers at one scratch table; restore and uncache
    on exit."""
    path = tmp_path / "kernel_table.json"

    def install(entries):
        doc = {"_meta": {"schema": kernel_table.SCHEMA}, "entries": entries}
        path.write_text(json.dumps(doc))
        monkeypatch.setenv("DSTPU_KERNEL_TABLE", str(path))
        kernel_table.invalidate_cache()
        jax_table.invalidate_cache()
        return path

    attn_ops.set_kernel_config(None)
    attn_ops._reset_dispatch_stats()
    jax_attn._reset_dispatch_stats()
    yield install
    monkeypatch.delenv("DSTPU_KERNEL_TABLE", raising=False)
    kernel_table.invalidate_cache()
    jax_table.invalidate_cache()
    attn_ops.set_kernel_config(None)
    jax_attn.set_kernel_config(None)


def _one(kernel, bucket, entry):
    return {kernel: {bucket: entry}}


@pytest.fixture
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((1, 256, 4, 32), (1, 256, 2, 32), (1, 256, 2, 32)))


def _torch(arrs, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrs)


# -- the table ---------------------------------------------------------------


def test_bucket_keys_equal_jax_over_a_grid():
    for seq in (1, 2, 100, 128, 129, 255, 256, 1000, 1024, 1025, 4096, 5000,
                131072):
        for hd in (16, 32, 64, 128):
            for causal in (True, False):
                assert kernel_table.attention_bucket(seq, hd, causal) == \
                    jax_table.attention_bucket(seq, hd, causal)
        assert kernel_table.bucket_pow2(seq) == jax_table.bucket_pow2(seq)
        assert kernel_table.bucket_pow2(seq, 16) == \
            jax_table.bucket_pow2(seq, 16)
        for k, n, g in ((128, 256, 4), (4096, 14336, 8), (14336, 4096, 8)):
            assert kernel_table.gmm_bucket(seq, k, n, g) == \
                jax_table.gmm_bucket(seq, k, n, g)
    assert kernel_table.attention_bucket(2048, 128, True) == \
        "s2048_d128_causal"
    assert kernel_table.SCHEMA == jax_table.SCHEMA


def test_decide_matches_jax_field_for_field(table_env):
    """One file with cpu, tpu and cuda rows (and a malformed one): on
    this CPU host both packages give the same decision for every
    bucket, measured or not."""
    table_env({"flash_attention": {
        "s256_d32_causal": _entry(2.0, "cpu",
                                  {"block_q": 128, "block_k": 128}),
        "s512_d32_causal": _entry(0.5, "cpu"),
        "s1024_d32_causal": _entry(1.0, "cpu"),
        "s2048_d128_causal": _entry(3.0, "tpu"),
        "s4096_d128_causal": _entry(4.1, "cuda", {"template": "wgmma"},
                                    CARD),
        "s128_d64_full": {"kernel_ms": 1.0, "backend": "cpu"},
    }, "grouped_matmul": {"m256_k128_n256_g4": _entry(1.3, "cpu")}})
    cases = [("flash_attention", b) for b in (
        "s256_d32_causal", "s512_d32_causal", "s1024_d32_causal",
        "s2048_d128_causal", "s4096_d128_causal", "s128_d64_full",
        "s8192_d128_causal")] + [("grouped_matmul", "m256_k128_n256_g4"),
                                 ("no_such_kernel", "x")]
    for kernel, bucket in cases:
        want = jax_table.decide(kernel, bucket)
        got = kernel_table.decide(kernel, bucket)
        assert (got.measured, got.win, got.ratio, got.blocks, got.reason) == \
            (want.measured, want.win, want.ratio, want.blocks, want.reason), \
            (kernel, bucket)
    assert kernel_table.decide("flash_attention", "s4096_d128_causal"
                               ).reason.endswith("running on cpu")


def test_missing_and_malformed_tables_never_raise(tmp_path, monkeypatch):
    for text in (None, "{not json", "[1, 2]", '{"_meta": {}}'):
        path = tmp_path / "t.json"
        if text is None:
            path.unlink(missing_ok=True)
        else:
            path.write_text(text)
        monkeypatch.setenv("DSTPU_KERNEL_TABLE", str(path))
        kernel_table.invalidate_cache()
        jax_table.invalidate_cache()
        got = kernel_table.decide("flash_attention", "s256_d32_causal")
        want = jax_table.decide("flash_attention", "s256_d32_causal")
        assert not got.measured and got.reason == want.reason
    kernel_table.invalidate_cache()


def test_cuda_rows_are_scoped_to_the_card(table_env, monkeypatch):
    table_env({"flash_attention": {
        "s2048_d128_causal": _entry(4.0, "cuda", device=CARD),
        "s4096_d128_causal": _entry(4.0, "cuda"),  # names no card
        "s1024_d128_causal": _entry(0.6, "cuda", device=CARD),
        "s512_d128_causal": _entry(2.0, "cpu")}})
    monkeypatch.setattr(kernel_table, "card_name", lambda index=None: CARD)
    d = kernel_table.decide("flash_attention", "s2048_d128_causal",
                            backend="cuda")
    assert d.measured and d.win and d.ratio == 4.0
    d = kernel_table.decide("flash_attention", "s1024_d128_causal",
                            backend="cuda")
    assert d.measured and not d.win
    for bucket in ("s4096_d128_causal", "s512_d128_causal"):
        assert not kernel_table.decide("flash_attention", bucket,
                                       backend="cuda").measured
    monkeypatch.setattr(kernel_table, "card_name",
                        lambda index=None: "NVIDIA A100-SXM4-80GB")
    d = kernel_table.decide("flash_attention", "s2048_d128_causal",
                            backend="cuda")
    assert not d.measured and "A100" in d.reason


def test_default_table_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("DSTPU_KERNEL_TABLE", raising=False)
    path = kernel_table.table_path()
    assert path == kernel_table.DEFAULT_TABLE
    assert path.endswith("deepspeed_tpu_torch/kernel_table.json")
    assert path != jax_table.DEFAULT_TABLE
    monkeypatch.setenv("DSTPU_KERNEL_TABLE", "/elsewhere.json")
    assert kernel_table.table_path() == "/elsewhere.json"


def test_tables_cross_between_the_packages(tmp_path, monkeypatch):
    """A table the port's ``record`` wrote loads in JAX's ``load_table``
    and decides the same; one JAX's ``record`` wrote loads in the
    port's."""
    ported = tmp_path / "port.json"
    kernel_table.record("flash_attention", "s256_d32_causal", 1.0, 2.5,
                        blocks={"template": "plain"}, path=str(ported))
    kernel_table.record("grouped_matmul", "m256_k128_n256_g4", 2.0, 1.0,
                        path=str(ported))
    kernel_table.record("flash_attention", "s2048_d128_causal", 1.0, 4.0,
                        backend="cuda", device=CARD, path=str(ported))
    doc = jax_table.load_table(str(ported))
    assert doc["_meta"]["schema"] == jax_table.SCHEMA
    assert doc["entries"]["flash_attention"]["s2048_d128_causal"][
        "device"] == CARD
    for kernel, bucket in (("flash_attention", "s256_d32_causal"),
                           ("grouped_matmul", "m256_k128_n256_g4"),
                           ("flash_attention", "s2048_d128_causal")):
        want = jax_table.decide(kernel, bucket, path=str(ported))
        got = kernel_table.decide(kernel, bucket, path=str(ported))
        assert (got.measured, got.win, got.ratio, got.reason) == \
            (want.measured, want.win, want.ratio, want.reason)
    written = tmp_path / "jax.json"
    jax_table.record("flash_attention", "s512_d64_causal", kernel_ms=2.0,
                     xla_ms=5.0, blocks={"block_q": 128, "block_k": 128},
                     path=str(written))
    assert kernel_table.load_table(str(written)) == \
        jax_table.load_table(str(written))
    d = kernel_table.decide("flash_attention", "s512_d64_causal",
                            path=str(written))
    assert d.measured and d.win and d.ratio == 2.5
    assert d.blocks == {"block_q": 128, "block_k": 128}
    kernel_table.invalidate_cache()
    jax_table.invalidate_cache()


def test_record_roundtrip(tmp_path, monkeypatch):
    path = tmp_path / "t.json"
    monkeypatch.setenv("DSTPU_KERNEL_TABLE", str(path))
    kernel_table.invalidate_cache()
    e = kernel_table.record("grouped_matmul", "m256_k128_n256_g4",
                            kernel_ms=2.0, xla_ms=5.0,
                            blocks={"template": "wgmma"})
    assert e["backend"] == "cpu" and "device" not in e
    d = kernel_table.decide("grouped_matmul", "m256_k128_n256_g4")
    assert d.measured and d.win and d.ratio == 2.5
    assert d.blocks == {"template": "wgmma"}
    kernel_table.invalidate_cache()


# -- the registry -----------------------------------------------------------


def test_registry_names_and_loaders():
    ops = registry.all_ops()
    assert sorted(ops) == sorted(jax_registry.all_ops())
    from deepspeed_tpu_torch.inference.model_runner import ragged_forward
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention
    from deepspeed_tpu_torch.ops.quantization import (dequantize_blockwise,
                                                      quantize_blockwise)

    assert registry.get_op("flash_attention") is flash_attention
    assert registry.get_op("quantize_blockwise") is quantize_blockwise
    assert registry.get_op("dequantize_blockwise") is dequantize_blockwise
    assert registry.get_op("xla_attention") is attn_ops.xla_attention
    assert registry.get_op("ragged_forward") is ragged_forward
    with pytest.raises(KeyError):
        registry.get_op("not_an_op")
    with pytest.raises(KeyError):
        registry.dispatch_op("not_an_op", "b", "xla_attention")
    # the plain versions always qualify on the CPU
    for name, op in ops.items():
        assert op.is_compatible("cpu")[0], name


@pytest.mark.parametrize("ratio", [0.4, 0.999, 1.0, 2.2])
@pytest.mark.parametrize("default_use", [True, False])
@pytest.mark.parametrize("backend", ["cpu", "tpu", "cuda"])
def test_dispatch_op_decisions_equal_jax(table_env, ratio, default_use,
                                         backend):
    """The guard order: a row measured here rules whatever the heuristic
    says; one from another backend leaves the heuristic to decide. The
    same table gives both packages the same decision."""
    bucket = "s256_d32_causal"
    table_env(_one("flash_attention", bucket,
                   _entry(ratio, backend, {"block_q": 128, "block_k": 128},
                          CARD if backend == "cuda" else None)))
    for b in (bucket, "s512_d32_causal"):
        want = jax_registry.dispatch_op("flash_attention", b,
                                        "xla_attention",
                                        default_use=default_use)
        got = registry.dispatch_op("flash_attention", b, "xla_attention",
                                   default_use=default_use)
        assert (got.op_name, got.source, got.reason, got.ratio,
                got.blocks) == (want.op_name, SOURCE[want.source],
                                want.reason, want.ratio, want.blocks)
    measured_here = backend == "cpu"
    d = registry.dispatch_op("flash_attention", bucket, "xla_attention",
                             default_use=default_use)
    use = (ratio >= 1.0) if measured_here else default_use
    assert d.source == ("kernel" if use else "xla")


def test_failing_probe_on_cuda_raises(table_env):
    """On a CUDA device a failing compat probe raises with its note
    instead of routing to the dense path (JAX routes to XLA); on the CPU
    the plain versions qualify."""
    table_env(_one("flash_attention", "s2048_d128_causal",
                   _entry(3.0, "cuda", device=CARD)))
    registry._card_status.cache_clear()
    try:
        ok, note = registry.all_ops()["flash_attention"].is_compatible(
            "cuda")
        assert not ok and "no CUDA device" in note
        with pytest.raises(RuntimeError, match="compat probe failed: no "
                                               "CUDA device"):
            registry.dispatch_op("flash_attention", "s2048_d128_causal",
                                 "xla_attention", device_type="cuda")
        with pytest.raises(RuntimeError, match="compat probe failed"):
            attn_ops.auto_decision("cuda", torch.bfloat16, 2048, 128, True)
        # the dense op has no probe; a dtype the kernels do not take goes
        # dense before the probe and the table are asked
        d = attn_ops.auto_decision("cuda", torch.float16, 2048, 128, True)
        assert d.source == "xla" and "float16" in d.reason
        d = attn_ops.auto_decision("cuda", torch.bfloat16, 2048, 16, True)
        assert d.source == "xla"
    finally:
        registry._card_status.cache_clear()


def test_probe_passes_on_a_card(table_env, monkeypatch):
    """With the probe passing, a CUDA row for this card rules, another
    card's row leaves the heuristic (flash on the card)."""
    table_env({"flash_attention": {
        "s256_d128_causal": _entry(0.5, "cuda", device=CARD),
        "s2048_d128_causal": _entry(0.5, "cuda", device="another card")}})
    monkeypatch.setattr(registry, "_card_status", lambda: (True, ""))
    monkeypatch.setattr(kernel_table, "card_name", lambda index=None: CARD)
    d = attn_ops.auto_decision("cuda", torch.bfloat16, 200, 128, True)
    assert d.source == "xla" and "measured loss" in d.reason
    d = attn_ops.auto_decision("cuda", torch.bfloat16, 2048, 128, True)
    assert d.source == "kernel" and "heuristic prefers kernel" in d.reason
    attn_ops.set_kernel_config(KernelsConfig(dispatch="heuristic"))
    d = attn_ops.auto_decision("cuda", torch.bfloat16, 200, 128, True)
    assert d.source == "kernel" and d.reason == "kernels.dispatch=heuristic"


# -- multi_head_attention(impl="auto") ------------------------------------------


def test_losing_entry_routes_to_xla_bit_identically(table_env, qkv):
    table_env(_one("flash_attention", "s256_d32_causal",
                   _entry(0.4, "cpu")))
    for dtype in (torch.float32, torch.bfloat16):
        attn_ops._reset_dispatch_stats()
        q, k, v = _torch(qkv, dtype)
        out = attn_ops.multi_head_attention(q, k, v, causal=True)
        assert torch.equal(out, attn_ops.xla_attention(q, k, v, causal=True))
        assert attn_ops.dispatch_stats() == {"kernel": 0, "xla": 1,
                                             "flash_fallbacks": 0,
                                             "card_losses": 0}


def test_winning_entry_matches_jax_flash(table_env, qkv):
    """A measured win runs flash in both packages: the port's plain
    version against JAX's Pallas kernel in interpret mode, fp32."""
    table_env(_one("flash_attention", "s256_d32_causal",
                   _entry(2.2, "cpu", {"block_q": 128, "block_k": 128})))
    want = np.asarray(jax_attn.multi_head_attention(
        *(jnp.asarray(a) for a in qkv), causal=True))
    assert jax_attn.dispatch_stats()["pallas"] == 1
    got = attn_ops.multi_head_attention(*_torch(qkv), causal=True)
    assert attn_ops.dispatch_stats()["kernel"] == 1
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # and the flash route is the flash function itself
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention
    assert torch.equal(got, flash_attention(*_torch(qkv), causal=True))


def test_flip_win_to_loss_flips_route(table_env, qkv):
    q, k, v = _torch(qkv)
    for ratio, source in ((1.5, "kernel"), (0.9, "xla"), (1.0, "kernel")):
        table_env(_one("flash_attention", "s256_d32_causal",
                       _entry(ratio, "cpu")))
        attn_ops._reset_dispatch_stats()
        attn_ops.multi_head_attention(q, k, v, causal=True)
        assert attn_ops.dispatch_stats()[source] == 1


def test_unmeasured_bucket_follows_the_heuristic(table_env, qkv):
    """On the CPU the heuristic (``auto_impl``) is the dense path, as
    JAX's off the TPU; a non-causal call is another bucket."""
    table_env(_one("flash_attention", "s256_d32_causal",
                   _entry(3.0, "cpu")))
    q, k, v = _torch(qkv)
    out = attn_ops.multi_head_attention(q, k, v, causal=False)
    assert torch.equal(out, attn_ops.xla_attention(q, k, v, causal=False))
    assert attn_ops.dispatch_stats() == {"kernel": 0, "xla": 1,
                                         "flash_fallbacks": 0,
                                         "card_losses": 0}
    assert attn_ops.flash_fallback_ratio() == 0.0


def test_heuristic_mode_ignores_table(table_env, qkv):
    table_env(_one("flash_attention", "s256_d32_causal",
                   _entry(9.0, "cpu")))
    q, k, v = _torch(qkv)
    attn_ops.set_kernel_config(KernelsConfig(dispatch="heuristic"))
    out = attn_ops.multi_head_attention(q, k, v, causal=True)
    assert attn_ops.dispatch_stats()["xla"] == 1
    assert torch.equal(out, attn_ops.xla_attention(q, k, v, causal=True))


def test_config_table_path_beats_the_env(table_env, qkv, tmp_path):
    """``kernels.table_path`` is the table read (JAX passes it to
    ``dispatch_op``), whatever ``DSTPU_KERNEL_TABLE`` says."""
    table_env(_one("flash_attention", "s256_d32_causal",
                   _entry(0.3, "cpu")))
    mine = tmp_path / "mine.json"
    kernel_table.record("flash_attention", "s256_d32_causal", 1.0, 3.0,
                        path=str(mine))
    q, k, v = _torch(qkv)
    attn_ops.set_kernel_config(KernelsConfig(table_path=str(mine)))
    attn_ops.multi_head_attention(q, k, v, causal=True)
    assert attn_ops.dispatch_stats()["kernel"] == 1
    attn_ops.set_kernel_config(None)
    attn_ops.multi_head_attention(q, k, v, causal=True)
    assert attn_ops.dispatch_stats()["xla"] == 1


def test_dispatch_stats_count_each_decision(table_env, qkv):
    table_env({"flash_attention": {
        "s256_d32_causal": _entry(2.0, "cpu"),
        "s128_d32_causal": _entry(0.5, "cpu")}})
    q, k, v = _torch(qkv)
    for _ in range(3):
        attn_ops.multi_head_attention(q, k, v)               # win
    for _ in range(2):
        attn_ops.multi_head_attention(q[:, :100], k[:, :100],
                                      v[:, :100])            # loss
    attn_ops.multi_head_attention(q, k, v, impl="xla")      # not auto
    assert attn_ops.dispatch_stats() == {"kernel": 3, "xla": 2,
                                         "flash_fallbacks": 0,
                                         "card_losses": 0}
    stats = attn_ops.dispatch_stats()
    stats["kernel"] = 99  # a copy
    assert attn_ops.dispatch_stats()["kernel"] == 3


def test_auto_decision_is_memoised_until_the_table_or_config_changes(
        table_env):
    """One decision object per (device, dtype, bucket, table); a new
    table (``invalidate_cache``) or config (``set_kernel_config``) is
    read afresh."""
    table_env(_one("flash_attention", "s256_d32_causal",
                   _entry(2.0, "cpu")))
    d = attn_ops.auto_decision("cpu", torch.float32, 200, 32, True)
    assert d.source == "kernel"
    assert attn_ops.auto_decision("cpu", torch.float32, 256, 32, True) is d
    assert attn_ops.auto_decision("cpu", torch.bfloat16, 256, 32,
                                  True) is not d
    table_env(_one("flash_attention", "s256_d32_causal",
                   _entry(0.5, "cpu")))
    assert attn_ops.auto_decision("cpu", torch.float32, 200, 32,
                                  True).source == "xla"
    attn_ops.set_kernel_config(KernelsConfig(dispatch="heuristic"))
    d = attn_ops.auto_decision("cpu", torch.float32, 200, 32, True)
    assert d.reason == "kernels.dispatch=heuristic"


# -- the kernels config block -------------------------------------------------------


@pytest.mark.parametrize("bad", [
    {"flash_block_q": 100}, {"gmm_block_m": 3},
    {"pages_per_compute_block": 0}, {"dispatch": "nope"},
    {"blocksparse_block": -128},
])
def test_kernels_config_rejects_as_jax_does(bad):
    with pytest.raises(ValueError) as want:
        JaxKernelsConfig(**bad).validate()
    with pytest.raises(ValueError) as got:
        KernelsConfig(**bad).validate()
    assert str(got.value) == str(want.value)


def test_initialize_installs_the_kernels_block(table_env, qkv, tmp_path):
    """``kernels.table_path`` and ``kernels.dispatch`` take effect through
    ``initialize`` (JAX ``engine.py:212``): the model's forward at
    attn_impl "auto" follows the configured table."""
    from deepspeed_tpu_torch.models import zoo

    mine = tmp_path / "mine.json"
    kernel_table.record("flash_attention", "s128_d16_causal", 1.0, 2.0,
                        path=str(mine))
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32)
    cfg = {"train_micro_batch_size_per_chip": 1,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "kernels": {"table_path": str(mine)}}
    deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    assert attn_ops._KERNEL_CONFIG.table_path == str(mine)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    model.apply(model.params(), toks)
    L = model.config.num_layers
    assert attn_ops.dispatch_stats() == {"kernel": L, "xla": 0,
                                         "flash_fallbacks": 0,
                                         "card_losses": 0}
    cfg["kernels"] = {"table_path": str(mine), "dispatch": "heuristic"}
    deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    attn_ops._reset_dispatch_stats()
    model.apply(model.params(), toks)
    assert attn_ops.dispatch_stats()["xla"] == L
