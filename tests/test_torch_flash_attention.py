"""Port flash attention against the JAX flash kernel and the dense path.

The port runs its plain PyTorch versions on the CPU (through the
autograd Function, so the backward is ``_flash_bwd``'s); the JAX kernel
runs in Pallas interpret mode, as ``tests/test_flash_attention.py`` runs
it. Inputs come from numpy seeds and cross as arrays. Tolerances are the
JAX tests' own: forward max-abs 2e-5, gradients 5e-4 (fp32, sums in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import attention as jax_attn
from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu_torch.ops import attention as attn
from deepspeed_tpu_torch.ops import flash_attention as fa

FWD_TOL = 2e-5
GRAD_TOL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, B=2, S=128, Nq=8, Nkv=8, D=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Nq, D)).astype(np.float32),
            rng.standard_normal((B, S, Nkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Nkv, D)).astype(np.float32))


def _segments(B, S, lens):
    seg = np.concatenate([np.full(n, i, np.int32) for i, n in
                          enumerate(lens)])
    assert seg.shape == (S,)
    return np.broadcast_to(seg, (B, S)).copy()


def _port_fwd_bwd(q, k, v, causal, seg=None):
    """Output and the gradients of sum(o ** 2) through the port."""
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    seg_t = None if seg is None else torch.from_numpy(seg)
    o = fa.flash_attention(*t, causal=causal, segment_ids=seg_t)
    (o ** 2).sum().backward()
    return o.detach().numpy(), [x.grad.numpy() for x in t]


def _jax_fwd_bwd(fn, q, k, v, causal, seg=None, **kw):
    seg_j = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return fn(q, k, v, causal=causal, segment_ids=seg_j, **kw)

    args = [jnp.asarray(x) for x in (q, k, v)]
    out = f(*args)
    grads = jax.grad(lambda *a: (f(*a) ** 2).sum(), argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check(got, want):
    o, grads = got
    o_w, grads_w = want
    np.testing.assert_allclose(o, o_w, atol=FWD_TOL, rtol=0)
    for g, g_w in zip(grads, grads_w):
        assert g.shape == g_w.shape
        np.testing.assert_allclose(g, g_w, atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("ratio", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_flash_and_dense(ratio, causal):
    q, k, v = _qkv(ratio, Nkv=8 // ratio)
    got = _port_fwd_bwd(q, k, v, causal)
    _check(got, _jax_fwd_bwd(jax_flash.flash_attention, q, k, v, causal,
                             block_q=64, block_k=64))
    _check(got, _jax_fwd_bwd(jax_attn.xla_attention, q, k, v, causal))


@pytest.mark.parametrize("causal", [True, False])
def test_sequence_not_a_tile_multiple(causal):
    """S = 100: the JAX wrapper pads to 128 (and synthesizes segment ids
    when not causal); the port masks rows and columns past S itself."""
    q, k, v = _qkv(11, S=100, Nkv=2)
    got = _port_fwd_bwd(q, k, v, causal)
    _check(got, _jax_fwd_bwd(jax_flash.flash_attention, q, k, v, causal,
                             block_q=64, block_k=64))
    _check(got, _jax_fwd_bwd(jax_attn.xla_attention, q, k, v, causal))


@pytest.mark.parametrize("causal", [True, False])
def test_packed_segment_ids(causal):
    B, S = 2, 128
    q, k, v = _qkv(21, B=B, S=S, Nkv=2)
    seg = _segments(B, S, (48, 50, 30))
    got = _port_fwd_bwd(q, k, v, causal, seg)
    _check(got, _jax_fwd_bwd(jax_flash.flash_attention, q, k, v, causal,
                             seg, block_q=64, block_k=64))
    _check(got, _jax_fwd_bwd(jax_attn.xla_attention, q, k, v, causal, seg))


def test_segments_gqa_and_ragged_length():
    """Segments, GQA and S = 100 at once, three segments, non-causal."""
    B, S = 1, 100
    q, k, v = _qkv(31, B=B, S=S, Nq=4, Nkv=2)
    seg = _segments(B, S, (40, 35, 25))
    got = _port_fwd_bwd(q, k, v, False, seg)
    _check(got, _jax_fwd_bwd(jax_flash.flash_attention, q, k, v, False,
                             seg, block_q=64, block_k=64))


def test_lse_matches_dense_logsumexp():
    q, k, v = _qkv(41, S=100, Nq=8, Nkv=2)
    seg = _segments(2, 100, (60, 40))
    scale = 32 ** -0.5
    _, lse = fa._flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                           torch.from_numpy(seg), True, scale)
    assert lse.shape == (2, 8, 100) and lse.dtype == torch.float32
    kr = np.repeat(k, 4, axis=2)
    s = np.einsum("bqnd,bknd->bnqk", q.astype(np.float64),
                  kr.astype(np.float64)) * scale
    i = np.arange(100)
    vis = (i[None, :] <= i[:, None])[None, None] & (
        seg[:, None, :, None] == seg[:, None, None, :])
    s = np.where(vis, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("impl", ["flash", "xla", "auto"])
def test_multi_head_attention_dispatch(impl):
    q, k, v = _qkv(51, Nkv=2)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    before = dict(fa.LAUNCHES)
    got = attn.multi_head_attention(*t, causal=True, impl=impl)
    want = jax_attn.multi_head_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                         causal=True, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=0)
    assert fa.LAUNCHES == before  # plain versions never count launches
    k_rep, _ = attn.repeat_kv_heads(*t)
    np.testing.assert_array_equal(
        k_rep.numpy(), np.asarray(jax_attn.repeat_kv_heads(
            *(jnp.asarray(x) for x in (q, k, v)))[0]))


def test_unsupported_impls_and_shapes_raise():
    t = [torch.from_numpy(x) for x in _qkv(61, S=16, Nq=6, Nkv=4)]
    # block-sparse without a layout raises as JAX does; with a layout it
    # runs, and segment ids are refused (tests/test_torch_blocksparse.py)
    with pytest.raises(ValueError, match="sparse_attention config"):
        attn.multi_head_attention(*t, impl="blocksparse")
    from deepspeed_tpu_torch.ops import blocksparse_attention as bs
    attn.set_sparse_config(bs.FixedSparsityConfig(block=8))
    try:
        with pytest.raises(NotImplementedError, match="segment_ids"):
            attn.multi_head_attention(*t, impl="blocksparse",
                                      segment_ids=torch.zeros(2, 16))
    finally:
        attn.set_sparse_config(None)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attn.multi_head_attention(*t, impl="bogus")
    with pytest.raises(ValueError, match="not a multiple"):
        fa.flash_attention(*t)


@pytest.mark.parametrize("device,dtype,D,strides,ptrs,want", [
    # bf16, head dim 128, (batch, seq, head) strides of q, k, v positive
    # multiples of 8, 16-byte aligned data: the tensor cores
    ("cuda", torch.bfloat16, 128, (2048 * 4096, 4096, 128) * 3,
     (0x7f0000000000, 256, 512), "wgmma"),
    # a head slice of a fused [B, S, 48, 128] projection, a [B, H, S, D]
    # layout read as [B, S, H, D]
    ("cuda", torch.bfloat16, 128, (300 * 6144, 6144, 128,
                                   32 * 300 * 128, 128, 300 * 128,
                                   2400, 1024, 128), (0, 16, 32), "wgmma"),
    # what the tensor-core forward does not take: the scalar kernel
    ("cuda", torch.float32, 128, (8,) * 9, (0, 16, 32), "simt"),
    ("cuda", torch.bfloat16, 64, (8,) * 9, (0, 16, 32), "simt"),
    ("cuda", torch.bfloat16, 128, (8,) * 8 + (12,), (0, 16, 32), "simt"),
    ("cuda", torch.bfloat16, 128, (8,) * 8 + (0,), (0, 16, 32), "simt"),
    ("cuda", torch.bfloat16, 128, (8,) * 9, (0, 16, 34), "simt"),
    ("cuda", torch.bfloat16, 128, (8,) * 9, (2, 16, 32), "simt"),
    # CPU tensors: the plain version, whatever the type and shape
    ("cpu", torch.bfloat16, 128, (8,) * 9, (0, 16, 32), "plain"),
    ("cpu", torch.float32, 64, (3,) * 9, (2, 6, 10), "plain"),
    # the backward: the strides and pointers of q, k, v and dO by the
    # same rule; a dO that autograd hands over as a [B, H, S, D] view
    ("cuda", torch.bfloat16, 128, (2048 * 4096, 4096, 128) * 3
     + (32 * 2048 * 128, 128, 2048 * 128), (0, 256, 512, 1024), "wgmma"),
    ("cuda", torch.bfloat16, 128, (8,) * 12, (0, 16, 32, 48), "wgmma"),
    # a dO stride that is not a multiple of 8, zero (expanded), or a
    # misaligned dO: the scalar kernels
    ("cuda", torch.bfloat16, 128, (8,) * 9 + (8, 12, 8), (0, 16, 32, 48),
     "simt"),
    ("cuda", torch.bfloat16, 128, (8,) * 9 + (0, 8, 8), (0, 16, 32, 48),
     "simt"),
    ("cuda", torch.bfloat16, 128, (8,) * 12, (0, 16, 32, 50), "simt"),
    ("cuda", torch.float32, 128, (8,) * 12, (0, 16, 32, 48), "simt"),
    ("cuda", torch.bfloat16, 64, (8,) * 12, (0, 16, 32, 48), "simt"),
    ("cpu", torch.bfloat16, 128, (8,) * 12, (0, 16, 32, 48), "plain"),
])
def test_flash_variant_dispatch(device, dtype, D, strides, ptrs, want):
    assert fa.flash_variant(device, dtype, D, strides, ptrs) == want


def test_flash_forward_on_cpu_counts_no_variant():
    """CPU tensors take the plain forward, in any type and from any
    view: no launch and no variant is counted."""
    q, k, v = _qkv(71, S=40, Nq=4, Nkv=2, D=128)
    wide = torch.from_numpy(np.concatenate([q, q], axis=2))
    views = [(torch.from_numpy(q), torch.float32),
             (torch.from_numpy(q), torch.bfloat16),
             (wide[:, :, :4], torch.bfloat16)]  # a head slice
    before = (dict(fa.LAUNCHES), dict(fa.VARIANT_LAUNCHES))
    for qt, dt in views:
        kt, vt = (torch.from_numpy(x).to(dt) for x in (k, v))
        qt = qt.to(dt)
        o, lse = fa._flash_fwd(qt, kt, vt, None, True, 128 ** -0.5)
        o_ref, lse_ref = fa.flash_fwd_plain(qt, kt, vt, None, True,
                                            128 ** -0.5)
        assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert (fa.LAUNCHES, fa.VARIANT_LAUNCHES) == before
    assert sorted(fa.VARIANT_LAUNCHES) == [
        f"{name}/{var}" for name in ("flash_bwd_dkdv", "flash_bwd_dq",
                                     "flash_fwd")
        for var in ("simt", "wgmma")]


def test_flash_backward_on_cpu_counts_no_variant():
    """CPU tensors take the plain backward, in any type and with a dO
    that is a strided view (as autograd may hand it over): no launch and
    no variant is counted, and the result is the plain versions'."""
    q, k, v = _qkv(72, S=40, Nq=4, Nkv=2, D=128)
    rng = np.random.default_rng(73)
    do_np = rng.standard_normal((2, 4, 40, 128)).astype(np.float32)
    before = (dict(fa.LAUNCHES), dict(fa.VARIANT_LAUNCHES))
    for dt in (torch.float32, torch.bfloat16):
        qt, kt, vt = (torch.from_numpy(x).to(dt) for x in (q, k, v))
        do = torch.from_numpy(do_np).to(dt).transpose(1, 2)  # [B, S, H, D]
        o, lse = fa._flash_fwd(qt, kt, vt, None, True, 128 ** -0.5)
        got = fa._flash_bwd(qt, kt, vt, None, o, lse, do, True, 128 ** -0.5)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
        args = (qt, kt, vt, None, lse, delta, do, True, 128 ** -0.5)
        want = (fa.flash_bwd_dq_plain(*args),
                *fa.flash_bwd_dkdv_plain(*args))
        for a, b in zip(got, want):
            assert a.dtype == dt and torch.equal(a, b)
    assert (fa.LAUNCHES, fa.VARIANT_LAUNCHES) == before


@pytest.mark.parametrize("name", ["flash_bwd_dkdv", "flash_bwd_dq"])
def test_flash_backward_launch_refuses_what_its_kernel_does_not_take(name):
    """``_flash_bwd_launch`` asked for the tensor-core kernel on tensors
    the rule sends elsewhere (here CPU tensors), or for an unknown
    kernel, raises before it launches anything."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(74, S=16, Nq=4, Nkv=2, D=128))
    lse = torch.zeros(2, 4, 16)
    args = (q, k, v, None, lse, lse, q, True, 128 ** -0.5)
    before = (dict(fa.LAUNCHES), dict(fa.VARIANT_LAUNCHES))
    with pytest.raises(ValueError, match="tensor-core flash backward"):
        fa._flash_bwd_launch(name, *args, "wgmma")
    with pytest.raises(ValueError, match="unknown flash backward kernel"):
        fa._flash_bwd_launch("flash_bwd", *args, "simt")
    assert (fa.LAUNCHES, fa.VARIANT_LAUNCHES) == before
