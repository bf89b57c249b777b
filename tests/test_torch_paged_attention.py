"""Port paged attention (plain PyTorch path on CPU) against the JAX
Pallas kernels, which run in interpret mode on the CPU as
tests/test_paged_attention.py runs them.

Tolerance atol = rtol = 2e-5, the JAX paged-attention tests' own: both
sides fold the same pages in the same order in fp32 and differ only in
the order of the sums inside a page.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import paged_attention as jax_pa
from deepspeed_tpu_torch.ops import paged_attention as pa

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _case(seed, S, nh, nkv, hd, bs, Bm, ctx, tq=None):
    """A pool with a decoy page 0, slots' pages drawn from a shuffled
    permutation, and q per slot (decode) or per segment row (prefill)."""
    rng = np.random.default_rng(seed)
    nb = S * Bm + 3
    kv = rng.standard_normal((nb, bs, 2, nkv, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = perm[:S * Bm].reshape(S, Bm).copy()
    for s in range(S):  # stale entries past the context point at the decoy
        table[s, (int(ctx[s]) + bs - 1) // bs:] = 0
    shape = (S, nh, hd) if tq is None else (S, tq, nh, hd)
    q = rng.standard_normal(shape).astype(np.float32)
    return q, kv, table


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("ppcb", [1, 2])
@pytest.mark.parametrize("nh,nkv", [(8, 8), (8, 2), (4, 1)])
def test_decode_matches_jax(nh, nkv, ppcb):
    S, hd, bs, Bm = 4, 32, 8, 5
    ctx = np.array([1, 17, 0, 40], np.int32)  # partial, cross-page, dead, full
    q, kv, table = _case(0, S, nh, nkv, hd, bs, Bm, ctx)
    want = np.asarray(jax_pa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(table),
        jnp.asarray(ctx), pages_per_compute_block=ppcb))
    pa.reset_launch_counts()
    got = pa.paged_decode_attention(_t(q), _t(kv), _t(table), _t(ctx))
    assert got.dtype == torch.float32 and got.shape == (S, nh, hd)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[2] == 0.0)  # dead slot
    assert pa.LAUNCHES == {"paged_decode": 0, "paged_prefill": 0}
    assert not any(pa.VARIANT_LAUNCHES.values())


@pytest.mark.parametrize("ppcb", [1, 2])
@pytest.mark.parametrize("nh,nkv", [(8, 8), (8, 2), (4, 1)])
def test_prefill_matches_jax(nh, nkv, ppcb):
    S, tq, hd, bs, Bm = 3, 8, 32, 8, 4
    # segment 0: 8 new tokens on 11 of history; segment 1: a dead
    # segment; segment 2: 5 real tokens from position 0 (3 padded rows)
    pos0 = np.array([11, 0, 0], np.int32)
    ctx = np.array([19, 0, 5], np.int32)
    q, kv, table = _case(1, S, nh, nkv, hd, bs, Bm, ctx, tq=tq)
    want = np.asarray(jax_pa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(table),
        jnp.asarray(pos0), jnp.asarray(ctx), pages_per_compute_block=ppcb))
    got = pa.paged_prefill_attention(_t(q), _t(kv), _t(table), _t(pos0),
                                     _t(ctx))
    assert got.shape == (S, tq, nh, hd)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[1] == 0.0)  # dead segment


@pytest.mark.parametrize("nh,nkv", [(8, 8), (8, 2)])
def test_decode_context_past_the_table(nh, nkv):
    """A context longer than the block table covers (Bm * bs): columns
    past the table are never visited, as in the JAX kernel at
    pages_per_compute_block=1. (At 2, with Bm odd, the JAX index map
    clamps the missing page id to the last one and attends that page a
    second time; that is outside the kernels' contract.)"""
    S, hd, bs, Bm = 2, 32, 8, 5
    ctx = np.array([45, 12], np.int32)
    q, kv, table = _case(4, S, nh, nkv, hd, bs, Bm, ctx)
    want = np.asarray(jax_pa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(table),
        jnp.asarray(ctx)))
    got = pa.paged_decode_attention(_t(q), _t(kv), _t(table), _t(ctx))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_is_prefill_with_one_query():
    """The kernel design treats decode as the Tq = 1 prefill at
    pos0 = ctx - 1; the plain versions must agree exactly."""
    S, nh, nkv, hd, bs, Bm = 3, 8, 2, 16, 4, 6
    ctx = np.array([3, 0, 21], np.int32)
    q, kv, table = _case(2, S, nh, nkv, hd, bs, Bm, ctx)
    dec = pa.paged_decode_attention(_t(q), _t(kv), _t(table), _t(ctx))
    pre = pa.paged_prefill_attention(_t(q[:, None]), _t(kv), _t(table),
                                     _t(ctx - 1), _t(ctx))
    torch.testing.assert_close(dec, pre[:, 0], rtol=0, atol=0)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("nh,nkv", [(32, 8), (24, 8), (256, 1)])
@pytest.mark.parametrize("bs", [4, 8, 16, 32, 48, 128, 256])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_variant_rule(dtype, hd, bs, nh, nkv, aligned):
    """The card's rule, asked of CPU tensors: the tensor-core prefill for
    bf16 at head dim 128, a block size of 8 to 128 that divides 128, a
    query group dividing 128 and 16-byte aligned q and pool; the scalar
    kernel otherwise; the plain version on the CPU itself."""
    kv = torch.zeros(3, bs, 2, nkv, hd, dtype=dtype)
    shape = (2, 4, nh, hd)
    if aligned:
        q = torch.zeros(shape, dtype=dtype)
    else:  # contiguous, 2 or 4 bytes off a 16-byte boundary
        q = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:].view(shape)
    g = nh // nkv
    want = ("wgmma" if dtype == torch.bfloat16 and hd == 128
            and bs in (8, 16, 32, 64, 128) and 128 % g == 0 and aligned
            else "simt")
    assert pa.paged_prefill_variant(q, kv, device_type="cuda") == want
    assert pa.paged_prefill_variant(q, kv) == "plain"


def test_prefill_variant_override_is_for_the_card():
    S, nh, nkv, hd, bs, Bm = 2, 8, 2, 16, 8, 3
    ctx = np.array([9, 24], np.int32)
    q, kv, table = _case(3, S, nh, nkv, hd, bs, Bm, ctx, tq=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_prefill_attention(_t(q), _t(kv), _t(table), _t(ctx - 4),
                                   _t(ctx), variant="simt")


def test_bf16_plain_path_keeps_dtype():
    S, nh, nkv, hd, bs, Bm = 2, 8, 2, 16, 8, 3
    ctx = np.array([9, 24], np.int32)
    q, kv, table = _case(3, S, nh, nkv, hd, bs, Bm, ctx)
    q16, kv16 = _t(q).bfloat16(), _t(kv).bfloat16()
    out = pa.paged_decode_attention(q16, kv16, _t(table), _t(ctx))
    ref = pa.paged_decode_attention(q16.float(), kv16.float(), _t(table),
                                    _t(ctx))
    assert out.dtype == torch.bfloat16
    # one bf16 rounding of outputs of magnitude <= ~4
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=2e-2)


@pytest.mark.parametrize("bad", ["heads", "pool", "meta", "table"])
def test_wrapper_rejects_bad_shapes(bad):
    q = torch.zeros(2, 8, 16)
    kv = torch.zeros(6, 4, 2, 2, 16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    ctx = torch.ones(2, dtype=torch.int32)
    if bad == "heads":
        q = torch.zeros(2, 7, 16)
    elif bad == "pool":
        kv = torch.zeros(6, 4, 3, 2, 16)
    elif bad == "meta":
        ctx = torch.ones(3, dtype=torch.int32)
    else:
        bt = torch.zeros(3, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, kv, bt, ctx)


def test_cuda_source_exports_the_bound_symbols():
    """The ctypes binding and the C interface of the CUDA source name the
    same functions (the source compiles only on the card)."""
    import os
    import re

    from deepspeed_tpu_torch.ops import build

    with open(os.path.join(build.CSRC, build.SOURCES["paged_attention"])) as f:
        src = f.read()
    exported = set(re.findall(r'extern "C" [^(]*?\b(dstpu_\w+)\(', src))
    assert exported == {"dstpu_paged_decode", "dstpu_paged_prefill",
                        "dstpu_paged_prefill_wgmma",
                        "dstpu_cuda_error_string"}
    assert "-gencode" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
