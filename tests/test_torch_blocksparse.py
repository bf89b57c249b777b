"""Port block-sparse attention against the JAX package.

Layouts are numpy in both packages and must be the same arrays. The
masked form runs through autograd against JAX's ``blocksparse_attention``
and ``jax.grad``; the kernel's plain version (what the kernel wrapper
runs on CPU tensors) against JAX's ``blocksparse_attention_pallas`` in
interpret mode, as ``tests/test_blocksparse.py`` and
``tests/test_kernel_geometry.py`` run it, with S a block multiple; at a
ragged S and with GQA against the masked form after ``repeat_kv_heads``.
The model's ``attn_impl="blocksparse"`` is held to JAX's loss and every
gradient leaf on a Llama-style TINY and on tiny-moe. Inputs come from
numpy seeds. Tolerances (fp32, sums in different orders): forward
max-abs 2e-5, gradients 5e-4; loss rtol 1e-5, gradient leaves atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.ops import attention as jax_attn
from deepspeed_tpu.ops.pallas import blocksparse_attention as jbs
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops import attention as attn
from deepspeed_tpu_torch.ops import blocksparse_attention as bs

FWD_TOL, GRAD_TOL = 2e-5, 5e-4
LOSS_RTOL, LEAF_ATOL = 1e-5, 1e-4
MODES = ("dense", "fixed", "longformer", "bigbird", "variable")
# Llama-style: rope, rmsnorm, swiglu, untied, GQA 2
LLAMA_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, max_seq_len=64, pos_emb="rope",
                  norm="rmsnorm", activation="swiglu", tie_embeddings=False,
                  attn_impl="blocksparse")


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


def _qkv(seed, B=2, S=64, Nq=4, Nkv=4, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Nq, D)).astype(np.float32),
            rng.standard_normal((B, S, Nkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Nkv, D)).astype(np.float32))


def _pair(mode, **kw):
    return bs.make_sparsity_config(mode, **kw), jbs.make_sparsity_config(
        mode, **kw)


def _torch(*xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


# -- layouts ----------------------------------------------------------------

LAYOUT_KW = {
    "dense": {}, "fixed": {"num_local_blocks": 2, "num_global_blocks": 1},
    "longformer": {"num_sliding_window_blocks": 5, "num_global_blocks": 2},
    "bigbird": {"num_random_blocks": 2, "seed": 3},
    "variable": {"local_window_blocks": [1, 2, 3],
                 "global_block_indices": [1, 5]},
}


@pytest.mark.parametrize("mode", MODES)
def test_layouts_equal_jax(mode):
    for kw in ({}, LAYOUT_KW[mode]):
        for block, S in ((16, 64), (16, 256), (32, 512), (128, 1024),
                         (128, 8192), (256, 4096)):
            ours, theirs = _pair(mode, block=block, **kw)
            got, want = ours.make_layout(S), theirs.make_layout(S)
            assert got.dtype == want.dtype == bool
            np.testing.assert_array_equal(got, want, err_msg=f"{block} {S}")
            for causal in (True, False):
                assert bs.layout_density(got, causal) == \
                    jbs.layout_density(want, causal)
    with pytest.raises(ValueError, match="unknown sparse attention mode"):
        bs.make_sparsity_config("nope")
    with pytest.raises(ValueError, match="not a multiple"):
        bs.FixedSparsityConfig(block=16).make_layout(100)


@pytest.mark.parametrize("mode", ["dense", "fixed", "bslongformer",
                                  "bigbird", "variable"])
def test_from_config_maps_each_mode(mode):
    from deepspeed_tpu.config.config import Config as JaxConfig
    from deepspeed_tpu_torch.config.config import load_config

    block = {"mode": mode, "block": 16, "num_local_blocks": 3,
             "num_global_blocks": 2, "num_random_blocks": 2,
             "num_sliding_window_blocks": 5, "local_window_blocks": [2, 1],
             "global_block_indices": [3]}
    ours = bs.from_config(load_config({"sparse_attention": block})
                          .sparse_attention)
    theirs = jbs.from_config(JaxConfig.from_dict({"sparse_attention": block})
                             .sparse_attention)
    assert type(ours).__name__ == type(theirs).__name__
    np.testing.assert_array_equal(ours.make_layout(256),
                                  theirs.make_layout(256))


# -- the masked form -----------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_masked_form_and_gradients_match_jax(mode, causal):
    q, k, v = _qkv(11, S=80)  # ragged: 80 is not a multiple of 32
    ours, theirs = _pair(mode, block=32)
    t = _torch(q, k, v, grad=True)
    out = bs.blocksparse_attention(*t, ours, causal=causal)
    (out ** 2).sum().backward()

    def f(q, k, v):
        return jbs.blocksparse_attention(q, k, v, theirs, causal=causal)

    jq = [jnp.asarray(x) for x in (q, k, v)]
    want = f(*jq)
    grads = jax.grad(lambda *a: (f(*a) ** 2).sum(), argnums=(0, 1, 2))(*jq)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=0)
    for got, ref in zip(t, grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   atol=GRAD_TOL, rtol=0)


def test_one_call_form_and_density():
    q, k, v = _qkv(12, S=32)
    got = bs.sparse_self_attention(*_torch(q, k, v), mode="bigbird",
                                   block=16, num_random_blocks=1)
    want = jbs.sparse_self_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                     mode="bigbird", block=16,
                                     num_random_blocks=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=0)


# -- the kernel's plain version ------------------------------------------------


@pytest.mark.parametrize("tile", [bs.TILE, bs.TC_TILE])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block,S,mode", [
    (16, 64, "fixed"), (16, 64, "longformer"), (16, 128, "bigbird"),
    (16, 64, "variable"), (128, 256, "fixed"), (128, 256, "dense")])
def test_plain_kernel_version_matches_jax_pallas(block, S, mode, causal,
                                                 tile):
    """The plain version at the scalar kernel's fold (64, what the
    wrapper runs on CPU tensors) and at the tensor-core kernel's (128)
    against JAX's kernel in interpret mode."""
    q, k, v = _qkv(13, B=1, S=S, Nq=2, Nkv=2, D=32)
    kw = {"num_local_blocks": 2} if mode == "fixed" else {}
    ours, theirs = _pair(mode, block=block, **kw)
    if tile == bs.TILE:
        got = bs.blocksparse_attention_kernel(*_torch(q, k, v), ours,
                                              causal=causal)
    else:
        work = bs.work_list(ours, S, causal, torch.device("cpu"), tile)
        got = bs.blocksparse_fwd_plain(*_torch(q, k, v), work, 32 ** -0.5)
    want = jbs.blocksparse_attention_pallas(
        *(jnp.asarray(x) for x in (q, k, v)), theirs, causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=0)
    assert bs.LAUNCHES["blocksparse_fwd"] == 0  # plain versions never count


@pytest.mark.parametrize("block", [8, 16, 32, 64, 128, 256, 48])
@pytest.mark.parametrize("S,Nq,Nkv", [(100, 4, 2), (200, 4, 1),
                                      (64, 4, 4)])
def test_ragged_and_gqa_match_the_masked_form(block, S, Nq, Nkv):
    q, k, v = _qkv(14, S=S, Nq=Nq, Nkv=Nkv)
    ours, theirs = _pair("bigbird", block=block, num_random_blocks=2)
    for causal in (True, False):
        t = _torch(q, k, v)
        got = bs.blocksparse_attention_kernel(*t, ours, causal=causal)
        kr, vr = attn.repeat_kv_heads(*t)
        want = bs.blocksparse_attention(t[0], kr, vr, ours, causal=causal)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL,
                                   rtol=0)
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        jk, jv = jax_attn.repeat_kv_heads(jq, jk, jv)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jbs.blocksparse_attention(
                jq, jk, jv, theirs, causal=causal)), atol=FWD_TOL, rtol=0)


class _Custom(bs.SparsityConfig):
    """A layout with an empty query block (block row 1)."""

    def make_layout(self, seq_len):
        n = self.num_blocks(seq_len)
        lay = np.eye(n, dtype=bool)
        lay[:, 0] = True
        lay[1, :] = False
        return lay


class _JaxCustom(jbs.SparsityConfig):
    make_layout = _Custom.make_layout


def test_an_empty_row_gives_zero_as_jax_kernel_does():
    q, k, v = _qkv(15, B=1, S=64, Nq=2, Nkv=2, D=32)
    got = bs.blocksparse_attention_kernel(*_torch(q, k, v), _Custom(16),
                                          causal=False).numpy()
    want = np.asarray(jbs.blocksparse_attention_pallas(
        *(jnp.asarray(x) for x in (q, k, v)), _JaxCustom(16), causal=False))
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)
    assert np.all(got[:, 16:32] == 0) and np.all(want[:, 16:32] == 0)
    assert np.abs(got[:, :16]).max() > 0
    # the masked form softmaxes an all-hidden row evenly: the mean of V
    masked = bs.blocksparse_attention(*_torch(q, k, v), _Custom(16),
                                      causal=False).numpy()
    np.testing.assert_allclose(masked[:, 16:32],
                               np.broadcast_to(v.mean(axis=1, keepdims=True),
                                               (1, 16, 2, 32)), atol=FWD_TOL)
    np.testing.assert_allclose(masked[:, 32:], got[:, 32:], atol=FWD_TOL)


# -- the work list -----------------------------------------------------------


def _element_mask(layout, block, S, causal):
    m = np.repeat(np.repeat(layout, block, 0), block, 1)[:S, :S]
    return m & np.tril(np.ones((S, S), bool)) if causal else m


@pytest.mark.parametrize("tile", [bs.TILE, bs.TC_TILE])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", [4, 16, 48, 64, 96, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_work_list_holds_exactly_the_live_tiles(block, causal, mode, tile):
    """At either kernel's tile width, every layout mode, causal and not:
    a tile is listed exactly when it holds a visible (row, column)
    pair."""
    for S in (64, 200, 383, 512):
        kw = {"num_random_blocks": 1} if mode == "bigbird" else {}
        cfg = bs.make_sparsity_config(mode, block=block, **kw)
        work = bs.work_list(cfg, S, causal, torch.device("cpu"), tile)
        assert work.tile == tile
        mask = _element_mask(work.layout_host, block, S, causal)
        nt = -(-S // tile)
        pad = np.zeros((nt * tile, nt * tile), bool)
        pad[:S, :S] = mask
        want = pad.reshape(nt, tile, nt, tile).any(axis=(1, 3))
        np.testing.assert_array_equal(work.live, want, err_msg=str(S))
        offs, tiles = work.offsets.numpy(), work.tiles.numpy()
        for i in range(nt):
            np.testing.assert_array_equal(tiles[offs[i]:offs[i + 1]],
                                          np.nonzero(want[i])[0])
        counts = np.diff(offs)
        assert list(counts[work.order.numpy()]) == sorted(counts, reverse=True)
        assert bs.visible_pairs(work.layout_host, block, S, causal) == \
            mask.sum()


def test_work_list_is_cached_per_layout_object():
    cfg = bs.FixedSparsityConfig(block=16)
    a = bs.work_list(cfg, 128, True, torch.device("cpu"))
    assert bs.work_list(cfg, 128, True, torch.device("cpu")) is a
    assert bs.work_list(bs.FixedSparsityConfig(block=16), 128, True,
                        torch.device("cpu")) is not a
    # the tile width is part of the key: each kernel's list is its own
    wide = bs.work_list(cfg, 128, True, torch.device("cpu"), bs.TC_TILE)
    assert wide is not a and (a.tile, wide.tile) == (bs.TILE, bs.TC_TILE)
    assert wide.live.shape == (1, 1) and a.live.shape == (2, 2)
    assert bs.work_list(cfg, 128, True, torch.device("cpu"),
                        bs.TC_TILE) is wide
    assert bs.work_list(cfg, 128, True, torch.device("cpu"), bs.TILE) is a


def _variant_views(dtype, D, view):
    """q, k, v [1, 256, H, D] CPU tensors: contiguous, a head slice of a
    fused projection (strides multiples of 8), a [B, H, S, D] tensor read
    as [B, S, H, D], or each a contiguous view 2 bytes off a 16-byte
    boundary."""
    if view == "head-slice":
        fused = torch.zeros(1, 256, 6, D, dtype=dtype)
        return fused[:, :, :4], fused[:, :, 4:5], fused[:, :, 5:]
    if view == "bhsd":
        return tuple(torch.zeros(1, h, 256, D, dtype=dtype).transpose(1, 2)
                     for h in (4, 1, 1))
    shapes = [(1, 256, h, D) for h in (4, 1, 1)]
    if view == "misaligned":
        return tuple(torch.zeros(int(np.prod(sh)) + 1, dtype=dtype)[1:]
                     .view(sh) for sh in shapes)
    return tuple(torch.zeros(sh, dtype=dtype) for sh in shapes)


@pytest.mark.parametrize("view", ["contiguous", "head-slice", "bhsd",
                                  "misaligned"])
@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_blocksparse_variant_rule(dtype, D, block, view):
    """The card's rule, asked of CPU tensors: the tensor-core kernel for
    bf16 at head dim 128 with a layout block that is a multiple of 128,
    16-byte strides and aligned data; the scalar kernel otherwise; the
    plain version on the CPU itself."""
    q, k, v = _variant_views(dtype, D, view)
    cfg = bs.FixedSparsityConfig(block=block)
    want = ("wgmma" if dtype == torch.bfloat16 and D == 128
            and block % 128 == 0 and view != "misaligned" else "simt")
    assert bs.blocksparse_variant(q, k, v, cfg, device_type="cuda") == want
    assert bs.blocksparse_variant(q, k, v, cfg) == "plain"


def test_blocksparse_variant_override_is_for_the_card():
    q, k, v = _torch(*_qkv(19, S=64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bs.blocksparse_attention_kernel(q, k, v,
                                        bs.FixedSparsityConfig(block=16),
                                        variant="simt")


def test_wrapper_checks_shapes():
    q, k, v = _torch(*_qkv(16, S=32, Nq=6, Nkv=4))
    cfg = bs.FixedSparsityConfig(block=16)
    with pytest.raises(ValueError, match="not a multiple"):
        bs.blocksparse_attention_kernel(q, k, v, cfg)
    with pytest.raises(ValueError, match="do not match"):
        bs.blocksparse_attention_kernel(q, k[:, :16], v[:, :16], cfg)
    with pytest.raises(ValueError, match=r"\[B, S, Hq, D\]"):
        bs.blocksparse_attention_kernel(q[0], k, v, cfg)
    with pytest.raises(ValueError, match="unsupported device"):
        bs.blocksparse_attention_kernel(*(x.to("meta") for x in (q, q, q)),
                                        cfg)


# -- the dispatch --------------------------------------------------------------


def test_dispatch_raises_like_jax():
    q, k, v = _torch(*_qkv(17, S=32))
    with pytest.raises(ValueError, match="sparse_attention config"):
        attn.multi_head_attention(q, k, v, impl="blocksparse")
    with pytest.raises(ValueError, match="sparse_attention config"):
        jax_attn.multi_head_attention(*(jnp.asarray(x.numpy())
                                        for x in (q, k, v)),
                                      impl="blocksparse")
    attn.set_sparse_config(bs.FixedSparsityConfig(block=16))
    with pytest.raises(NotImplementedError, match="segment_ids"):
        attn.multi_head_attention(q, k, v, impl="blocksparse",
                                  segment_ids=torch.zeros(2, 32))


def test_dispatch_routes_by_gradient(monkeypatch):
    q, k, v = _qkv(18, S=96, Nq=4, Nkv=2)
    ours, theirs = _pair("longformer", block=16)
    attn.set_sparse_config(ours)
    jax_attn.set_sparse_config(theirs)
    want = np.asarray(jax_attn.multi_head_attention(
        *(jnp.asarray(x) for x in (q, k, v)), impl="blocksparse"))
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(bs, "blocksparse_attention",
                        spy("masked", bs.blocksparse_attention))
    monkeypatch.setattr(bs, "blocksparse_attention_kernel",
                        spy("kernel", bs.blocksparse_attention_kernel))
    t = _torch(q, k, v, grad=True)
    out = attn.multi_head_attention(*t, impl="blocksparse")
    out.sum().backward()
    assert calls == ["masked"] and t[1].grad.shape == k.shape
    with torch.no_grad():
        nog = attn.multi_head_attention(*t, impl="blocksparse")
    assert calls == ["masked", "kernel"]
    plain = attn.multi_head_attention(*_torch(q, k, v), impl="blocksparse")
    assert calls == ["masked", "kernel", "kernel"]
    for got in (out.detach(), nog, plain):
        np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)


# -- the model -----------------------------------------------------------------


def _flat(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], f"{prefix}/{key}")
        else:
            yield f"{prefix}/{key}", tree[key]


def _models(kind, remat):
    if kind == "llama":
        over = dict(LLAMA_TINY, remat=remat)
        jmodel = jax_tf.TransformerLM(jax_tf.TransformerConfig(
            dtype=jnp.float32, **over))
        cfg = tf.TransformerConfig(dtype=torch.float32, **over)
    else:
        over = dict(vocab_size=64, hidden_size=32, max_seq_len=64,
                    attn_impl="blocksparse", remat=remat)
        jmodel = jax_get_model("tiny-moe", dtype=jnp.float32,
                               param_dtype=jnp.float32, **over)
        cfg = zoo.get_config("tiny-moe", dtype=torch.float32, **over)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jmodel, jparams, model


@pytest.mark.parametrize("kind,remat", [("llama", False), ("llama", True),
                                        ("moe", False)])
def test_loss_and_every_gradient_match_jax(kind, remat):
    jmodel, jparams, model = _models(kind, remat)
    ours, theirs = _pair("fixed", block=8, num_local_blocks=2)
    attn.set_sparse_config(ours)
    jax_attn.set_sparse_config(theirs)
    toks = np.random.default_rng(19).integers(0, 64, (2, 46)).astype(
        np.int32)  # 45 inputs: a ragged last block
    (want, _), want_grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"input_ids": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    params = model.params()
    flat = dict(_flat(params))
    for p in flat.values():
        p.requires_grad_()
    loss, _ = model.loss(params, {"input_ids": torch.from_numpy(toks)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    want_flat = dict(_flat(jax.tree.map(np.asarray, want_grads)))
    assert sorted(want_flat) == sorted(flat)
    for path, ref in want_flat.items():
        np.testing.assert_allclose(flat[path].grad.numpy(), ref,
                                   atol=LEAF_ATOL, rtol=0, err_msg=path)
    # no grad: the kernel path (its plain version here) gives the loss too
    with torch.no_grad():
        nog, _ = model.loss(params, {"input_ids": torch.from_numpy(toks)})
    np.testing.assert_allclose(nog.item(), float(want), rtol=LOSS_RTOL)
