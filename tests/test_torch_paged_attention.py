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


# The split decode's plain twin against JAX's decode kernel. One pool of
# 20 pages of 4 tokens a row (80 columns), five slots: a dead one, one
# that ends mid-page, one that fills the table, one past it
# (ctx > Bm * bs) and one of two pages. Span sizes: 1 page (every span
# but the first few wholly past a short context), 3 (spans that end
# mid-context), 16, Bm and past Bm (one span). JAX runs in interpret mode
# once per head layout; the cache keeps its output.
SPLIT_S, SPLIT_HD, SPLIT_BS, SPLIT_BM = 5, 32, 4, 20
SPLIT_CTX = np.array([0, 37, 80, 93, 8], np.int32)
_JAX_DECODE = {}


def _split_case(nh, nkv):
    q, kv, table = _case(7, SPLIT_S, nh, nkv, SPLIT_HD, SPLIT_BS, SPLIT_BM,
                         SPLIT_CTX)
    if (nh, nkv) not in _JAX_DECODE:
        _JAX_DECODE[(nh, nkv)] = np.asarray(jax_pa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kv), jnp.asarray(table),
            jnp.asarray(SPLIT_CTX)))
    return q, kv, table, _JAX_DECODE[(nh, nkv)]


@pytest.mark.parametrize("span", [1, 3, 16, SPLIT_BM, SPLIT_BM + 5])
@pytest.mark.parametrize("nh,nkv", [(8, 8), (8, 2), (8, 1)])
def test_split_plain_matches_jax(nh, nkv, span):
    """GQA groups 1, 4 and 8; every span size folds the same columns and
    merges to JAX's result within its own tolerance; the dead slot gives
    exactly 0."""
    q, kv, table, want = _split_case(nh, nkv)
    got = pa.paged_decode_attention_split_plain(
        _t(q), _t(kv), _t(table), _t(SPLIT_CTX), SPLIT_HD ** -0.5, span)
    assert got.dtype == torch.float32 and got.shape == (SPLIT_S, nh,
                                                        SPLIT_HD)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[0] == 0.0)


@pytest.mark.parametrize("span", [SPLIT_BM, SPLIT_BM + 1, 4 * SPLIT_BM])
@pytest.mark.parametrize("nh,nkv", [(8, 8), (8, 2)])
def test_split_plain_one_span_is_the_plain_fold(nh, nkv, span):
    """One span covering the table is the single ascending fold bit for
    bit: its weight is exp(0) = 1 and the merge adds it to 0."""
    q, kv, table = _case(7, SPLIT_S, nh, nkv, SPLIT_HD, SPLIT_BS, SPLIT_BM,
                         SPLIT_CTX)
    args = (_t(q), _t(kv), _t(table), _t(SPLIT_CTX), SPLIT_HD ** -0.5)
    got = pa.paged_decode_attention_split_plain(*args, span)
    assert torch.equal(got, pa.paged_decode_attention_plain(*args))


def test_split_plain_rows_do_not_see_their_neighbours():
    """A slot's output under the split fold does not move when another
    slot's context changes (the spans come from shapes alone)."""
    q, kv, table = _case(8, SPLIT_S, 8, 2, SPLIT_HD, SPLIT_BS, SPLIT_BM,
                         SPLIT_CTX)
    args = (_t(q), _t(kv), _t(table))
    a = pa.paged_decode_attention_split_plain(*args, _t(SPLIT_CTX),
                                              SPLIT_HD ** -0.5, 3)
    ctx = SPLIT_CTX.copy()
    ctx[[0, 2, 4]] = [61, 5, 0]
    b = pa.paged_decode_attention_split_plain(*args, _t(ctx),
                                              SPLIT_HD ** -0.5, 3)
    assert torch.equal(a[[1, 3]], b[[1, 3]])


# The card gate on the split kernel (chip_smoke.py, tests of the card):
# the largest error in an output row (sequence, head) over that row's
# largest reference entry. At long contexts the largest outputs are
# 0.05-0.1, so a max-abs limit of 2e-2 cannot tell a sound merge from a
# broken one.
DECODE_ROW_REL = 2e-2


def _unweighted_merge(q, kv_layer, block_table, context_lens, scale, span):
    """The split twin with a planted merge fault: every span weighs
    w_i = 1 instead of exp(m_i - M)."""
    S, nh, hd = q.shape
    nkv, bs = kv_layer.shape[3], kv_layer.shape[1]
    g = nh // nkv
    ctx = context_lens.long()
    L = A = 0.0
    for p0 in range(0, block_table.shape[1], span):
        ctx_k = ctx - p0 * bs
        _, l, acc = pa._paged_fold(
            q.reshape(S, nkv, g, hd), kv_layer,
            block_table[:, p0:p0 + span], (ctx_k - 1)[:, None].expand(S, g),
            ctx_k, scale)
        L, A = L + l, A + acc
    return pa._finish(L, A).reshape(S, nh, hd).to(q.dtype)


def _row_rel_err(got, want):
    got, want = got.float(), want.float()
    top = want.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return ((got - want).abs().amax(-1) / top).max().item()


@pytest.mark.parametrize("S,pages,span", [(1, 1024, 31), (4, 256, 28)])
def test_split_row_gate_catches_an_unweighted_merge(S, pages, span):
    """The card's long-context decode cases (S 1 x 16384 and S 4 x 4096
    tokens of bf16, 16-token pages, the spans the host picks there on a
    132-SM card; 2 kv heads of g 4 here): the split twin stays within the
    row gate of the single fold, and a merge that leaves out the
    exp(m_i - M) weights fails it."""
    rng = np.random.default_rng(0)
    nkv, nb = 2, S * pages + 1
    kv = _t(rng.standard_normal((nb, 16, 2, nkv, 128), np.float32)).to(
        torch.bfloat16)
    table = _t(rng.permutation(nb)[:S * pages].reshape(S, pages).astype(
        np.int32))
    q = _t(rng.standard_normal((S, 4 * nkv, 128), np.float32)).to(
        torch.bfloat16)
    args = (q, kv, table, torch.full((S,), pages * 16, dtype=torch.int32),
            128 ** -0.5)
    sound = pa.paged_decode_attention_split_plain(*args, span)
    assert _row_rel_err(sound, pa.paged_decode_attention_plain(*args)) \
        <= DECODE_ROW_REL
    assert _row_rel_err(_unweighted_merge(*args, span), sound) \
        > DECODE_ROW_REL


def test_split_plain_rejects_an_empty_span():
    q, kv, table = _case(7, 2, 8, 2, 16, 4, 3, np.array([3, 9], np.int32))
    with pytest.raises(ValueError, match="span_pages"):
        pa.paged_decode_attention_split_plain(
            _t(q), _t(kv), _t(table), _t(np.array([3, 9], np.int32)), 0.25,
            0)


@pytest.mark.parametrize("S,nh,nkv,pages,bs,want", [
    (16, 32, 8, 48, 16, 16),     # the smoke's and the serve's shape
    (1, 32, 8, 1024, 16, 31),    # S 1 x 16384 tokens
    (4, 32, 8, 256, 16, 28),     # S 4 x 4096 tokens
    (16, 32, 8, 48, 128, 16),    # 128-token pages: 3 spans, as at 16
    (16, 32, 8, 48, 8, 16),      # 8-token pages: spans of >= 128 tokens
    (256, 32, 8, 48, 16, 48),    # enough blocks without a split
    (1, 128, 1, 64, 16, 8),      # MQA, g 128: 16 row groups, 128 tokens
    (2, 8, 8, 0, 16, 1),         # an empty table
])
def test_decode_span_is_shape_only(S, nh, nkv, pages, bs, want):
    """The host's span at 132 SMs: whole pages, at least 128 tokens (or
    the whole table), and at least 2 blocks an SM where the table allows
    it; it takes no context lengths at all."""
    span = pa.decode_span_pages(S, nh, nkv, pages, bs, 132)
    assert span == want
    groups = pa.decode_split_groups(nh, nkv)
    blocks = S * nkv * groups * -(-pages // span) if pages else 0
    assert span * bs >= 128 or span == max(pages, 1)
    if pages * bs >= 128 * 264 // (S * nkv * groups):
        assert blocks >= 2 * 132


@pytest.mark.parametrize("nh,nkv,want", [
    (8, 8, 1), (32, 8, 1), (64, 8, 1), (72, 8, 2), (96, 8, 2),
    (128, 1, 16)])
def test_decode_split_groups(nh, nkv, want):
    """A block takes up to 8 query heads of its kv head (the mma's n)."""
    assert pa.decode_split_groups(nh, nkv) == want


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_variant_rule(dtype, hd, aligned):
    """The card's rule, asked of CPU tensors: the split decode for bf16 at
    head dim 128 with q and pool contiguous and 16-byte aligned; the
    scalar kernel otherwise; the plain version on the CPU itself."""
    kv = torch.zeros(3, 16, 2, 8, hd, dtype=dtype)
    shape = (4, 32, hd)
    if aligned:
        q = torch.zeros(shape, dtype=dtype)
    else:  # contiguous, 2 or 4 bytes off a 16-byte boundary
        q = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:].view(shape)
    want = ("split" if dtype == torch.bfloat16 and hd == 128 and aligned
            else "simt")
    assert pa.paged_decode_variant(q, kv, device_type="cuda") == want
    assert pa.paged_decode_variant(q, kv) == "plain"


def test_decode_variant_rule_needs_contiguous_data():
    kv = torch.zeros(3, 16, 2, 8, 128, dtype=torch.bfloat16)
    q = torch.zeros(32, 4, 128, dtype=torch.bfloat16).transpose(0, 1)
    assert pa.paged_decode_variant(q, kv, device_type="cuda") == "simt"
    kv_t = torch.zeros(16, 3, 2, 8, 128, dtype=torch.bfloat16).transpose(0, 1)
    q = torch.zeros(4, 32, 128, dtype=torch.bfloat16)
    assert pa.paged_decode_variant(q, kv_t, device_type="cuda") == "simt"
    assert pa.paged_decode_variant(q, kv, device_type="cuda") == "split"


@pytest.mark.parametrize("variant", ["split", "simt"])
def test_decode_variant_override_is_for_the_card(variant):
    S, nh, nkv, hd, bs, Bm = 2, 8, 2, 16, 8, 3
    ctx = np.array([9, 24], np.int32)
    q, kv, table = _case(3, S, nh, nkv, hd, bs, Bm, ctx)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_decode_attention(_t(q), _t(kv), _t(table), _t(ctx),
                                  variant=variant)


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
    assert exported == {"dstpu_paged_decode", "dstpu_paged_decode_split",
                        "dstpu_paged_prefill", "dstpu_paged_prefill_wgmma",
                        "dstpu_cuda_error_string"}
    assert "-gencode" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
