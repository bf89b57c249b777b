"""Port quantization ops against the JAX package on the same inputs:
``quantize_blockwise`` / ``_quantize_ref``, ``kv_quantize`` (int8, int4,
fp8), ``fp_quantize``, the int4 nibble codec, the dequantize and the
quantize-on-append.

Inputs are made with numpy from a seed and handed to both sides. On the
CPU the port runs its plain versions; JAX runs its reference path (the
Pallas kernel's interpret fallback). The gate is bit equality: codes and
fp32 scales byte for byte (fp8 compared as its bytes), dequantized values
bit for bit in fp32 — every step is one IEEE-rounded operation in both
(round half to even, an IEEE quotient, one product).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import fp_quantizer as jfp
from deepspeed_tpu.ops.pallas import quantization as jq
from deepspeed_tpu_torch.ops import fp_quantizer as tfp
from deepspeed_tpu_torch.ops import quantization as tq


def _values(seed, rows, n, block, top):
    """rows x n fp32 values patterned per block: normal blocks at mixed
    magnitudes, exact .5 ties on a unit grid (absmax ``top`` makes the
    scale exactly 1), all-zero blocks, blocks past both ends of the
    grid."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n))
         * rng.uniform(0.01, 50, (rows, 1))).astype(np.float32)
    xb = x.reshape(-1, block)
    ties = rng.integers(-top, top, xb.shape).astype(np.float32) + 0.5
    xb[::7] = ties[::7]
    xb[::7, 0] = top
    xb[3::11] = 0.0
    xb[5::13, 0], xb[5::13, 1] = top - 0.5, -top - 0.5
    return x


def _bf16_exact(x):
    """Round x to bf16 values (both frameworks then hold the same bits)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        x = _bf16_exact(x)
        return jnp.asarray(x).astype(jnp.bfloat16), \
            torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _same_bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if got.dtype == torch.float8_e4m3fn:
        got, want = got.view(torch.uint8), want.view(np.uint8)
    elif got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(np.int32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block", [128, 256])
def test_quantize_blockwise_matches_jax_bit_for_bit(dtype, bits, block):
    top = (1 << (bits - 1)) - 1
    xj, xt = _pair(_values(bits + block, 64, 512, block, top), dtype)
    qj, sj = jq.quantize_blockwise(xj, bits=bits, block=block)
    qt, st = tq.quantize_blockwise(xt, bits=bits, block=block)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    _same_bits(qt, qj)
    _same_bits(st, sj)
    # and the reference formula itself, which the kernel is held to
    qr, sr = jq._quantize_ref(xj, bits, block)
    _same_bits(qt, qr)
    _same_bits(st, sr)
    assert tq.LAUNCHES["quantize_blockwise"] == 0  # plain version on CPU


@pytest.mark.parametrize("n,block", [(48, 256), (40, 64)])
def test_odd_block_falls_back_to_the_row(n, block):
    x = _values(3, 16, n, n, 127)
    qj, sj = jq.quantize_blockwise(jnp.asarray(x), bits=8, block=block)
    qt, st = tq.quantize_blockwise(torch.from_numpy(x), bits=8, block=block)
    assert st.shape == (16, 1)
    _same_bits(qt, qj)
    _same_bits(st, sj)
    deq_j = jq.dequantize_blockwise(qj, sj, bits=8, block=block,
                                    dtype=jnp.float32)
    deq_t = tq.dequantize_blockwise(qt, st, bits=8, block=block,
                                    dtype=torch.float32)
    _same_bits(deq_t, deq_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4, "fp8"])
def test_kv_quantize_matches_jax_bit_for_bit(dtype, bits):
    top = {8: 127, 4: 7, "fp8": 448}[bits]
    x = _values(11, 6 * 4, 2 * 64, 64, top).reshape(6, 4, 2, 64)
    xj, xt = _pair(x, dtype)
    qj, sj = jq.kv_quantize(xj, bits=bits)
    qt, st = tq.kv_quantize(xt, bits=bits)
    assert st.shape == (6, 4, 2)
    _same_bits(qt, qj)
    _same_bits(st, sj)
    # storage codec and dequantize, in fp32
    pj, pt = jq.kv_pack(qj, bits), tq.kv_pack(qt, bits)
    _same_bits(pt, pj)
    _same_bits(tq.kv_unpack(pt, bits), jq.kv_unpack(pj, bits))
    want = jq.kv_dequantize(jq.kv_unpack(pj, bits), sj, bits=bits,
                            dtype=jnp.float32)
    _same_bits(tq.dequantize(pt, st, torch.float32), want)
    _same_bits(tq.kv_dequantize(tq.kv_unpack(pt, bits), st, bits,
                                torch.float32), want)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("group", [32, 128, 96])
def test_fp_quantize_matches_jax(fmt, group):
    x = _values(5, 8, 384, 32, 448)
    if group == 96:  # not a divisor: one scale per row, with a warning
        x = x[:, :200]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the one-scale-per-row notice
        qj, sj = jfp.fp_quantize(jnp.asarray(x), fmt=fmt, group_size=group)
        qt, st = tfp.fp_quantize(torch.from_numpy(x), fmt=fmt,
                                 group_size=group)
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(),
                                  np.asarray(qj).view(np.uint8))
    _same_bits(st, sj)
    _same_bits(tfp.fp_dequantize(qt, st, group, torch.float32),
               jfp.fp_dequantize(qj, sj, group, jnp.float32))


def test_int4_codec_covers_every_nibble_pair():
    vals = np.arange(-8, 8, dtype=np.int8)
    pairs = np.stack(np.meshgrid(vals, vals, indexing="ij"), -1)
    q = pairs.reshape(1, -1)  # all 256 (even, odd) pairs
    pj = jq.pack_int4(jnp.asarray(q))
    pt = tq.pack_int4(torch.from_numpy(q))
    assert pt.dtype == torch.uint8 and pt.shape == (1, 256)
    _same_bits(pt, pj)
    assert sorted(pt.numpy().ravel().tolist()) == list(range(256))
    np.testing.assert_array_equal(tq.unpack_int4(pt).numpy(), q)
    _same_bits(tq.unpack_int4(pt), jq.unpack_int4(pj))


def test_dequantize_matches_jax_reference_in_fp32_and_bf16():
    rng = np.random.default_rng(2)
    q = rng.integers(-128, 128, (5, 3, 128)).astype(np.int8)
    s = rng.random((5, 3)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jq._dequantize_ref(jnp.asarray(q.reshape(5, 384)),
                                  jnp.asarray(s), 8, 128, jdt)
        got = tq.dequantize(torch.from_numpy(q), torch.from_numpy(s), tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(
            got.reshape(5, 384).float().numpy(),
            np.asarray(want).astype(np.float32))
    out = torch.empty((5, 3, 128))
    assert tq.dequantize(torch.from_numpy(q), torch.from_numpy(s),
                         torch.float32, out=out) is out
    assert tq.LAUNCHES["dequantize"] == 0


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
def test_quantize_append_is_quantize_pack_scatter(bits):
    """The append's plain version against JAX's kv_quantize -> kv_pack ->
    scatter on the same pool, padding rows routed to the scratch row."""
    nb, bs, nkv, hd = 6, 4, 2, 32
    W = hd // 2 if bits == 4 else hd
    top = {8: 127, 4: 7, "fp8": 448}[bits]
    rng = np.random.default_rng(9)
    pdt = {8: torch.int8, 4: torch.uint8, "fp8": torch.float8_e4m3fn}[bits]
    init = rng.integers(0, 256, (nb, bs, 2, nkv, W), dtype=np.uint8)
    pool = torch.from_numpy(init.copy()).view(pdt)
    scales = torch.ones((nb, bs, 2, nkv))
    page = np.array([[0, 3], [2, nb - 1]])
    offset = np.array([[1, 0], [3, bs - 1]])  # [1, 1] is padding
    k, v = (_values(s, 4 * nkv, hd, hd, top).reshape(2, 2, nkv, hd)
            for s in (1, 2))
    tq.kv_quantize_append(pool, scales, torch.from_numpy(page),
                          torch.from_numpy(offset), torch.from_numpy(k),
                          torch.from_numpy(v), bits)
    want = init.copy()
    want_s = np.ones((nb, bs, 2, nkv), np.float32)
    for plane, x in ((0, k), (1, v)):
        qj, sj = jq.kv_quantize(jnp.asarray(x), bits=bits)
        codes = np.asarray(jq.kv_pack(qj, bits))
        want[page, offset, plane] = codes.view(np.uint8)
        want_s[page, offset, plane] = np.asarray(sj)
    np.testing.assert_array_equal(pool.view(torch.uint8).numpy(), want)
    _same_bits(scales, want_s)
    assert tq.LAUNCHES["kv_quantize_append"] == 0


def test_append_rejects_a_mismatched_pool():
    pool = torch.zeros((4, 2, 2, 1, 8), dtype=torch.int8)
    scales = torch.ones((4, 2, 2, 1))
    idx = torch.zeros(3, dtype=torch.long)
    kv = torch.zeros((3, 1, 8))
    with pytest.raises(TypeError, match="does not match"):
        tq.kv_quantize_append(pool, scales, idx, idx, kv, kv, 4)
    with pytest.raises(ValueError, match="do not fit"):
        tq.kv_quantize_append(pool, scales, idx, idx, kv[:, :, :4],
                              kv[:, :, :4], 8)
    with pytest.raises(ValueError, match="leading shape"):
        tq.dequantize(pool, scales[..., :1, :], torch.float32)
