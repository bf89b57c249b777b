"""Quantized KV pools of the port against the JAX package: the int8 /
int4 / fp8 rungs of ``KVCacheConfig`` and ``BlockedKVCache``, the fused
append-and-dequantize, the four ragged forwards over a quantized pool,
and greedy engine streams.

Weights come from the JAX ``model.init(PRNGKey(0))`` through
``params_from_jax``; pools and metadata are made with numpy from a seed
and handed to both sides. fp32 on the CPU (the port's kernels through
their plain versions, JAX's Pallas kernels in interpret mode).

Tolerances: logits atol/rtol 1e-4 (the two frameworks sum matmuls in
different orders). The pool's codes are equal except at most one code
step on a handful of entries: K/V that differ in the last fp32 bit can
land on the other side of a rounding boundary. Scales rtol 2e-6: the
absmax comes from K/V that the two frameworks' matmuls round differently
in the last few bits by the second layer (measured: at most 1.07e-6), and
one more rounding divides it. Greedy streams must be token-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference import model_runner as jax_runner
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.ops.pallas import quantization as jq
from deepspeed_tpu_torch.config.config import ServingConfig, load_config
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference import model_runner as runner
from deepspeed_tpu_torch.inference.ragged import (BlockedKVCache,
                                                  KVCacheConfig)
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops import quantization as tq

LLAMA = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
             num_kv_heads=1, ffn_size=128, tie_embeddings=False)
TOL = dict(rtol=1e-4, atol=1e-4)
BS, NB, BM = 8, 24, 4
RUNGS = [8, 4, "fp8"]
POOL_DTYPE = {8: torch.int8, 4: torch.uint8, "fp8": torch.float8_e4m3fn}
JAX_DTYPE = {8: jnp.int8, 4: jnp.uint8, "fp8": jnp.float8_e4m3fn}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_get_model("tiny", dtype=jnp.float32,
                           param_dtype=jnp.float32, **LLAMA)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = zoo.get_config("tiny", dtype=torch.float32, **LLAMA)
    return jmodel, jparams, cfg


def _port_model(pair):
    jmodel, jparams, cfg = pair
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                           device="cpu")


# -- the pool layout ---------------------------------------------------------


def test_bytes_per_block_ratios_and_widths():
    base = dict(num_layers=2, kv_heads=2, head_dim=128, block_size=16,
                num_blocks=4)
    bf16 = KVCacheConfig(**base)
    int8 = KVCacheConfig(**base, quant_bits=8)
    int4 = KVCacheConfig(**base, quant_bits=4)
    fp8 = KVCacheConfig(**base, quant_bits="fp8")
    # int8 / fp8 payload + one fp32 scale per head vector vs 2-byte bf16
    assert bf16.bytes_per_block / int8.bytes_per_block == pytest.approx(
        2 * 128 / (128 + 4))
    assert fp8.bytes_per_block == int8.bytes_per_block
    assert int4.payload_width == 64 and int8.payload_width == 128
    assert int8.bytes_per_block / int4.bytes_per_block == pytest.approx(
        (128 + 4) / (64 + 4))
    assert bf16.bytes_per_block / int4.bytes_per_block > 3.7
    with pytest.raises(ValueError, match="head_dim"):
        KVCacheConfig(num_layers=1, kv_heads=1, head_dim=63, quant_bits=4)
    with pytest.raises(ValueError, match="quant_bits"):
        KVCacheConfig(num_layers=1, kv_heads=1, head_dim=8, quant_bits=3)


@pytest.mark.parametrize("bits", RUNGS)
def test_quantized_pool_dtypes_and_scales(bits):
    cfg = KVCacheConfig(num_layers=2, kv_heads=2, head_dim=16, block_size=4,
                        num_blocks=5, quant_bits=bits)
    kv = BlockedKVCache(cfg, device="cpu")
    W = 8 if bits == 4 else 16
    assert kv.data.dtype == POOL_DTYPE[bits]
    assert kv.data.shape == (2, 5, 4, 2, 2, W)
    assert kv.scales.dtype == torch.float32
    assert kv.scales.shape == (2, 5, 4, 2, 2)
    assert torch.all(kv.scales == 1.0)
    payload, scales = kv.kv_state
    assert payload is kv.data and scales is kv.scales
    assert kv.quant_bits == bits


def test_unquantized_pool_stays_a_bare_tensor():
    cfg = KVCacheConfig(num_layers=2, kv_heads=2, head_dim=16, block_size=4,
                        num_blocks=5, dtype=torch.float32)
    kv = BlockedKVCache(cfg, device="cpu")
    assert kv.scales is None and kv.kv_state is kv.data
    assert kv.data.dtype == torch.float32
    payload, scales = kv.read_blocks_host([1, 3])
    assert scales is None and payload.shape == (2, 2, 4, 2, 2, 16)


# -- the fused append and dequantize ------------------------------------------


def _fused_case(bits, dtype, seed=21):
    """One layer pool of random codes and scales, 7 tokens (5 real, two of
    them into page 2, which both table rows read; 2 padding tokens routed
    to the scratch page's last row) and a table over pages 0-5."""
    nb, bs, nkv, hd = 7, 4, 2, 32
    W = hd // 2 if bits == 4 else hd
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (nb, bs, 2, nkv, W), dtype=np.uint8)
    if bits == "fp8":
        codes[(codes & 0x7F) >= 0x78] = 0x30  # no NaN
    scales = rng.uniform(0.005, 0.02, codes.shape[:-1]).astype(np.float32)
    page = np.array([2, 2, 0, 5, 3, nb - 1, nb - 1])
    offset = np.array([0, 3, 1, 2, 3, bs - 1, bs - 1])
    k, v = ((rng.standard_normal((7, nkv, hd))
             * rng.uniform(0.1, 20, (7, nkv, 1))).astype(np.float32)
            for _ in range(2))
    k[1, 0] = 0.0  # an all-zero head vector (scale 1)
    if dtype == "bfloat16":  # values both frameworks hold exactly
        k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                for x in (k, v))
    table = np.array([[2, 0, 4], [5, 2, 1]])
    return codes, scales, page, offset, k, v, table


@pytest.mark.parametrize("mode", ["pool", "table"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", RUNGS)
def test_fused_append_dequantize_is_jax_sequence(bits, dtype, mode):
    """``kv_append_dequantize`` on the CPU against JAX's kv_quantize ->
    kv_pack -> scatter -> kv_dequantize(kv_unpack(pool)) (or of
    ``pool[block_table]``), bit for bit: codes and scales outside the
    scratch page, and every value written out."""
    codes, scales, page, offset, k, v, table = _fused_case(bits, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jpool = jnp.asarray(codes if bits == 4 else codes.view(JAX_DTYPE[bits]))
    jsc = jnp.asarray(scales)
    for plane, x in ((0, k), (1, v)):
        q, s = jq.kv_quantize(jnp.asarray(x).astype(jdt), bits=bits)
        jpool = jpool.at[page, offset, plane].set(jq.kv_pack(q, bits))
        jsc = jsc.at[page, offset, plane].set(s)
    read, rsc = (jpool, jsc) if mode == "pool" else (jpool[table],
                                                     jsc[table])
    want = jq.kv_dequantize(jq.kv_unpack(read, bits), rsc, dtype=jdt)

    pool = torch.from_numpy(codes.copy()).view(POOL_DTYPE[bits])
    sc = torch.from_numpy(scales.copy())
    bt = None if mode == "pool" else torch.from_numpy(table)
    out = torch.empty((*(table.shape if bt is not None else (7,)),
                       4, 2, 2, 32), dtype=tdt)
    got = tq.kv_append_dequantize(
        pool, sc, torch.from_numpy(page), torch.from_numpy(offset),
        torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt), bits, out,
        block_table=bt)
    assert got is out
    np.testing.assert_array_equal(
        pool.view(torch.uint8).numpy()[:-1],
        np.asarray(jpool).view(np.uint8)[:-1])
    np.testing.assert_array_equal(sc.numpy()[:-1].view(np.uint32),
                                  np.asarray(jsc)[:-1].view(np.uint32))
    got_bits = got.float().numpy().view(np.uint32)
    want_bits = np.asarray(want.astype(jnp.float32)).view(np.uint32)
    if mode == "pool":  # the scratch page's rows raced between padding
        got_bits, want_bits = got_bits[:-1], want_bits[:-1]
    np.testing.assert_array_equal(got_bits, want_bits)
    # the padding landed in the scratch page's last row only
    assert not np.array_equal(pool.view(torch.uint8).numpy()[-1, -1],
                              codes[-1, -1])
    np.testing.assert_array_equal(pool.view(torch.uint8).numpy()[-1, :-1],
                                  codes[-1, :-1])
    assert tq.LAUNCHES["kv_append_dequantize"] == 0  # plain: no launch


def test_fused_append_dequantize_rejects_a_wrong_out():
    codes, scales, page, offset, k, v, table = _fused_case(8, "float32")
    args = (torch.from_numpy(codes).view(torch.int8),
            torch.from_numpy(scales), torch.from_numpy(page),
            torch.from_numpy(offset), torch.from_numpy(k),
            torch.from_numpy(v), 8)
    with pytest.raises(ValueError, match="out must be"):
        tq.kv_append_dequantize(*args, torch.empty((7, 4, 2, 2, 16)))
    with pytest.raises(ValueError, match="out must be"):
        tq.kv_append_dequantize(*args, torch.empty((7, 4, 2, 2, 32)),
                                block_table=torch.from_numpy(table))


def _spy_fused(monkeypatch):
    """Count the runner's fused calls; the standalone append and
    dequantize wrappers raise if anything reaches them."""
    calls = []
    fused = runner.kv_append_dequantize

    def counting(*a, **kw):
        calls.append(kw.get("block_table") is not None)
        return fused(*a, **kw)

    def never(*a, **kw):
        raise AssertionError("a standalone KV append or dequantize ran")

    monkeypatch.setattr(runner, "kv_append_dequantize", counting)
    monkeypatch.setattr(tq, "kv_quantize_append", never)
    monkeypatch.setattr(tq, "dequantize", never)
    return calls


@pytest.mark.parametrize("forward", ["prefill", "decode", "gather"])
@pytest.mark.parametrize("bits", RUNGS)
def test_forwards_append_and_read_in_one_call_a_layer(pair, monkeypatch,
                                                      bits, forward):
    """Each ragged forward over a quantized pool appends and reads a
    layer through ``kv_append_dequantize`` once (the gather forward with
    its block table), never the standalone append or dequantize."""
    _, _, cfg = pair
    params = _port_model(pair).params()
    calls = _spy_fused(monkeypatch)
    _, tpool = _both(*_pool(cfg, bits, 13), bits)
    S = 3
    bt = _t(_table(14, S))
    rng = np.random.default_rng(15)
    if forward == "prefill":
        toks = rng.integers(0, cfg.vocab_size, (S, 4)).astype(np.int32)
        runner.ragged_prefill_forward(
            cfg, params, tpool, _t(toks), _t(np.array([3, 0, 9], np.int32)),
            _t(np.array([4, 2, 0], np.int32)), bt)
    elif forward == "decode":
        toks = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
        pos = np.array([4, 0, 12], np.int32)
        runner.ragged_decode_forward(cfg, params, tpool, _t(toks), _t(pos),
                                     bt, _t(pos + 1))
    else:
        toks = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
        runner.ragged_forward(
            cfg, params, tpool, _t(toks), _t(np.array([0, 0, 1, 2, 2, 0])),
            _t(np.array([5, 6, 0, 7, 8, 0])), bt, 5)
    assert calls == [forward == "gather"] * cfg.num_layers


# -- the four forwards over a quantized pool ---------------------------------


def _pool(cfg, bits, seed):
    """Random codes (no fp8 NaN) and positive scales, as numpy bytes."""
    rng = np.random.default_rng(seed)
    W = cfg.head_dim // 2 if bits == 4 else cfg.head_dim
    codes = rng.integers(0, 256, (cfg.num_layers, NB, BS, 2, cfg.kv_heads,
                                  W), dtype=np.uint8)
    if bits == "fp8":
        codes[(codes & 0x7F) >= 0x78] = 0x30  # values up to 240, no NaN
    scales = rng.uniform(0.005, 0.02, codes.shape[:-1]).astype(np.float32)
    return codes, scales


def _both(codes, scales, bits):
    jax_pool = (jnp.asarray(codes.view(JAX_DTYPE[bits])
                            if bits != 4 else codes), jnp.asarray(scales))
    port_pool = (torch.from_numpy(codes.copy()).view(POOL_DTYPE[bits]),
                 torch.from_numpy(scales.copy()))
    return jax_pool, port_pool


def _order(codes_u8, bits):
    """Codes as integers whose order is the value order, so neighbouring
    codes differ by 1 (fp8: sign-magnitude; int4: unpacked nibbles)."""
    c = codes_u8.astype(np.int32)
    if bits == "fp8":
        return np.where(c & 0x80, -(c & 0x7F), c)
    if bits == 4:
        lo, hi = c & 0x0F, c >> 4
        lo, hi = np.where(lo > 7, lo - 16, lo), np.where(hi > 7, hi - 16, hi)
        return np.stack([lo, hi], -1)
    return np.where(c > 127, c - 256, c)


def _check_pool(got, want, bits):
    codes = got[0].view(torch.uint8).numpy()[:, :-1]  # scratch excluded
    want_codes = np.asarray(want[0]).view(np.uint8)[:, :-1]
    a, b = _order(codes, bits), _order(want_codes, bits)
    diff = np.abs(a - b)
    assert diff.max() <= 1
    assert (diff > 0).sum() <= max(4, diff.size // 1000)
    np.testing.assert_allclose(got[1].numpy()[:, :-1],
                               np.asarray(want[1])[:, :-1], rtol=2e-6)


def _table(seed, S):
    rng = np.random.default_rng(seed)
    return rng.permutation(NB - 1)[:S * BM].reshape(S, BM).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("bits", RUNGS)
def test_prefill_forward_matches_jax(pair, bits):
    jmodel, jparams, cfg = pair
    params = _port_model(pair).params()
    S, Tq = 3, 8
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (S, Tq)).astype(np.int32)
    pos0 = np.array([11, 0, 0], np.int32)
    nreal = np.array([8, 0, 5], np.int32)
    jpool, tpool = _both(*_pool(cfg, bits, 2), bits)
    bt = _table(3, S)
    want_lg, want_kv = jax_runner.ragged_prefill_forward(
        jmodel.config, jparams, jpool, jnp.asarray(toks), jnp.asarray(pos0),
        jnp.asarray(nreal), jnp.asarray(bt))
    got_lg, got_kv = runner.ragged_prefill_forward(
        cfg, params, tpool, _t(toks), _t(pos0), _t(nreal), _t(bt))
    assert got_kv[0] is tpool[0] and got_kv[1] is tpool[1]  # in place
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), **TOL)
    _check_pool(got_kv, want_kv, bits)


@pytest.mark.parametrize("bits", RUNGS)
def test_decode_forward_matches_jax(pair, bits):
    jmodel, jparams, cfg = pair
    params = _port_model(pair).params()
    S = 4
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
    pos = np.array([0, 13, 0, 31], np.int32)
    ctx = np.array([1, 14, 0, 32], np.int32)  # slot 2 is dead
    jpool, tpool = _both(*_pool(cfg, bits, 5), bits)
    bt = _table(6, S)
    want_lg, want_kv = jax_runner.ragged_decode_forward(
        jmodel.config, jparams, jpool, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(bt), jnp.asarray(ctx))
    got_lg, got_kv = runner.ragged_decode_forward(
        cfg, params, tpool, _t(toks), _t(pos), _t(bt), _t(ctx))
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), **TOL)
    _check_pool(got_kv, want_kv, bits)


@pytest.mark.parametrize("bits", RUNGS)
def test_gather_forward_matches_jax(pair, bits):
    jmodel, jparams, cfg = pair
    params = _port_model(pair).params()
    S, T = 3, 16
    rng = np.random.default_rng(7)
    seq = np.array([0] * 6 + [1] + [2] * 4 + [0] * 5, np.int32)
    pos = np.array(list(range(9, 15)) + [20] + list(range(4)) + [0] * 5,
                   np.int32)
    toks = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    jpool, tpool = _both(*_pool(cfg, bits, 8), bits)
    bt = _table(9, S)
    want_lg, want_kv = jax_runner.ragged_forward(
        jmodel.config, jparams, jpool, jnp.asarray(toks), jnp.asarray(seq),
        jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(11, jnp.int32))
    got_lg, got_kv = runner.ragged_forward(
        cfg, params, tpool, _t(toks), _t(seq), _t(pos), _t(bt), 11)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), **TOL)
    _check_pool(got_kv, want_kv, bits)


@pytest.mark.parametrize("bits", RUNGS)
def test_multi_decode_matches_jax(pair, bits):
    jmodel, jparams, cfg = pair
    params = _port_model(pair).params()
    S, steps = 4, 3
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
    pos = np.array([5, 0, 17, 2], np.int32)
    ctx = np.array([6, 0, 18, 3], np.int32)  # slot 1 dead
    jpool, tpool = _both(*_pool(cfg, bits, 11), bits)
    bt = _table(12, S)
    want_toks, want_kv = jax_runner.ragged_multi_decode(
        jmodel.config, jparams, jpool, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(bt), jnp.asarray(ctx), steps=steps)
    got_toks, got_kv = runner.ragged_multi_decode(
        cfg, params, tpool, _t(toks), _t(pos), _t(bt), _t(ctx), steps=steps)
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
    _check_pool(got_kv, want_kv, bits)


# -- greedy engine streams ------------------------------------------------


def _kw(**kw):
    kw.setdefault("kv_blocks", 64)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("max_tokens_per_step", 32)
    kw.setdefault("max_seqs_per_step", 4)
    kw.setdefault("max_blocks_per_seq", 8)
    return kw


def _serve(eng, rounds):
    out = {}
    for uids, prompts, n in rounds:
        eng.put(uids, prompts, max_new_tokens=n)
        for uid, toks in eng.generate_all().items():
            out.setdefault(uid, []).extend(toks)
    return out


def _streams(pair, rounds, **kw):
    jmodel, jparams, _ = pair
    kw = _kw(**kw)
    jax_eng = JaxEngine(jmodel, params=jparams, dtype=jnp.float32, **kw)
    eng = InferenceEngineV2(_port_model(pair), device="cpu", **kw)
    return _serve(jax_eng, rounds), _serve(eng, rounds), jax_eng, eng


@pytest.mark.parametrize("bits", RUNGS)
def test_shared_prefix_streams_match_jax(pair, bits):
    base = np.arange(16, dtype=np.int32) * 5 % 256
    a = np.concatenate([base, [50, 51, 52, 53]]).astype(np.int32)
    b = np.concatenate([base, [60, 61, 62, 63, 64]]).astype(np.int32)
    want, got, jax_eng, eng = _streams(
        pair, [([1], [a], 6), ([2], [b], 6)], kv_quant_bits=bits,
        decode_steps=4)
    assert got == want
    assert eng.stats["prefix_hit_tokens"] == 16
    assert jax_eng.stats["prefix_hit_tokens"] == 16
    assert eng.kv_cache.data.dtype == POOL_DTYPE[bits]


@pytest.mark.parametrize("bits", RUNGS)
def test_overload_preemption_streams_match_jax(pair, bits):
    prompts = [((np.arange(20) * 7 + i) % 100).astype(np.int32)
               for i in range(6)]
    want, got, jax_eng, eng = _streams(
        pair, [(list(range(6)), prompts, 8)], kv_quant_bits=bits,
        kv_blocks=13, max_blocks_per_seq=4, prefix_cache=False)
    assert got == want
    assert all(len(got[u]) == 8 for u in range(6))
    assert eng.stats["preempted"] >= 1
    assert eng.stats["preempted"] == jax_eng.stats["preempted"]


def test_tiny_moe_int8_pool_stream_matches_jax():
    jmodel = jax_get_model("tiny-moe", dtype=jnp.float32,
                           param_dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(7))
    model = params_from_jax(jax.tree.map(np.asarray, jparams),
                            zoo.get_config("tiny-moe", dtype=torch.float32),
                            device="cpu")
    kw = _kw(decode_steps=4, kv_quant_bits=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 12, 19)]
    outs = []
    for eng in (JaxEngine(jmodel, params=jparams, dtype=jnp.float32, **kw),
                InferenceEngineV2(model, device="cpu", **kw)):
        eng.put([1, 2, 3], prompts, max_new_tokens=8)
        outs.append(eng.generate_all())
    assert outs[1] == outs[0]
    assert all(len(v) == 8 for v in outs[1].values())


# -- the serving config block ----------------------------------------------


def test_serving_config_drives_the_engine(pair):
    prompts = [((np.arange(18) * 3 + 11 * i) % 100).astype(np.int32)
               for i in range(3)]
    serving = load_config({"serving": {"kv_quant_bits": "fp8",
                                       "decode_steps": 4,
                                       "host_kv_tier": True,
                                       "host_tier_mb": 8}}).serving
    assert isinstance(serving, ServingConfig)
    outs = []
    for kw in (dict(serving=serving),
               dict(kv_quant_bits="fp8", decode_steps=4, host_kv_tier=True,
                    host_tier_mb=8)):
        eng = InferenceEngineV2(_port_model(pair), device="cpu",
                                **_kw(**kw))
        assert eng.kv_cache.quant_bits == "fp8"
        assert eng.kv_cache.host_tier.capacity_bytes == 8 << 20
        assert eng.decode_steps == 4
        eng.put([0, 1, 2], prompts, max_new_tokens=6)
        outs.append(eng.generate_all())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("block,err,match", [
    ({"spec_k": 0}, ValueError, "spec_k"),
    ({"handoff_wire": "raw"}, NotImplementedError, "item 13"),
    ({"handoff_wire": "int8"}, NotImplementedError, "item 13"),
    ({"router": {"replicas": 2}}, NotImplementedError, "item 13"),
    ({"kv_quant_bits": 3}, ValueError, "kv_quant_bits"),
    ({"decode_steps": 0}, ValueError, "decode_steps"),
    ({"spec_accept_alpha": 0.0}, ValueError, "spec_accept_alpha"),
])
def test_serving_config_validates_like_jax(block, err, match):
    with pytest.raises(err, match=match):
        load_config({"serving": block})
    spec = ServingConfig(spec_k=2, spec_ngram=5, spec_accept_alpha=0.5,
                         spec_decode=True, spec_adaptive_k=True)
    assert (spec.spec_k, spec.spec_ngram) == (2, 5)
    assert spec.spec_decode and spec.spec_adaptive_k
