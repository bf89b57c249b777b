"""Port grouped matmul (``ops/grouped_matmul.py``) against the JAX Pallas
``gmm`` on the same inputs.

On the CPU the port's wrappers run their plain versions (one fp32
matmul per group); the JAX kernels run in Pallas interpret mode, as the
JAX package's own tests run them (``tests/test_grouped_moe.py``).
Inputs come from numpy seeds. Tolerances are the JAX tests': fp32
forward atol/rtol 1e-5 (1e-4 across several k-blocks, which reorder the
fp32 sums), gradients 1e-3. The hand-written kernels themselves are
checked against the plain versions on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import grouped_matmul as jgm
from deepspeed_tpu_torch.ops import grouped_matmul as gm

# name -> (group sizes, M (None = their sum), K, N, JAX blocks (m, n, k),
# tolerance)
CASES = {
    "aligned": ([128, 128], None, 64, 128, (128, 128, 64), 1e-5),
    "mid-tile-empty": ([100, 0, 128, 28], None, 64, 128, (128, 128, 64),
                       1e-5),
    "tiny-ends": ([1, 254, 1], None, 64, 128, (128, 128, 64), 1e-5),
    "one-hot-expert": ([0, 0, 256, 0], None, 64, 128, (128, 128, 64), 1e-5),
    "multi-tile": ([300, 212, 0, 512], None, 256, 384, (128, 128, 128),
                   1e-4),
    "odd-k-n": ([37, 0, 21, 9], None, 33, 45, (128, 128, 128), 1e-5),
    "over-sum": ([40, 40, 40], 100, 48, 40, (128, 128, 128), 1e-5),
    "under-sum": ([30, 20, 0], 64, 48, 40, (128, 128, 128), 1e-5),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(name, seed=0, transpose=False):
    sizes, M, K, N, blocks, tol = CASES[name]
    sizes = np.asarray(sizes, np.int32)
    M = int(sizes.sum()) if M is None else M
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((M, K)).astype(np.float32)
    rhs_shape = (len(sizes), N, K) if transpose else (len(sizes), K, N)
    rhs = rng.standard_normal(rhs_shape).astype(np.float32)
    dout = rng.standard_normal((M, N)).astype(np.float32)
    return sizes, lhs, rhs, dout, blocks, tol


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", sorted(CASES))
def test_gmm_forward_matches_jax(name):
    sizes, lhs, rhs, _, blocks, tol = _inputs(name)
    want = np.asarray(jgm.gmm(jnp.asarray(lhs), jnp.asarray(rhs),
                              jnp.asarray(sizes), *blocks))
    before = dict(gm.LAUNCHES)
    got = gm.gmm(_t(lhs), _t(rhs), _t(sizes))
    assert gm.LAUNCHES == before  # the plain version counts no launch
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    ends = np.minimum(np.cumsum(sizes), lhs.shape[0])
    assert np.all(got.numpy()[ends[-1]:] == 0)  # rows no group owns


@pytest.mark.parametrize("name", ["mid-tile-empty", "odd-k-n", "over-sum",
                                  "under-sum"])
def test_gmm_transposed_matches_jax(name):
    sizes, lhs, rhs, _, blocks, tol = _inputs(name, seed=1, transpose=True)
    bm, bn, bk = blocks
    want = np.asarray(jgm._gmm_call(jnp.asarray(lhs), jnp.asarray(rhs),
                                    jnp.asarray(sizes), bm, bn, bk,
                                    transpose_rhs=True))
    got = gm.gmm_raw(_t(lhs), _t(rhs), _t(sizes), transpose_rhs=True)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(
        gm.gmm_transposed_plain(_t(lhs), _t(rhs), _t(sizes)).numpy(), want,
        atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["mid-tile-empty", "one-hot-expert",
                                  "odd-k-n", "over-sum", "under-sum"])
def test_tgmm_matches_jax_and_zero_fills_empty_groups(name):
    sizes, lhs, _, dout, blocks, tol = _inputs(name, seed=2)
    bm, bn, bk = blocks
    want = np.asarray(jgm._tgmm_call(jnp.asarray(lhs), jnp.asarray(dout),
                                     jnp.asarray(sizes), bm, bn, bk))
    got = gm.tgmm(_t(lhs), _t(dout), _t(sizes))
    assert got.shape == (len(sizes), lhs.shape[1], dout.shape[1])
    np.testing.assert_allclose(got.numpy(), want, atol=10 * tol, rtol=tol)
    ends = np.minimum(np.cumsum(sizes), lhs.shape[0])
    starts = np.concatenate([[0], ends[:-1]])
    for e in np.flatnonzero(ends <= starts):
        assert torch.all(got[e] == 0)


@pytest.mark.parametrize("name", ["aligned", "mid-tile-empty", "odd-k-n",
                                  "under-sum"])
def test_gmm_gradients_match_jax(name):
    sizes, lhs, rhs, _, blocks, _ = _inputs(name, seed=3)
    gs = jnp.asarray(sizes)
    want = jax.grad(lambda l, r: jnp.sum(jgm.gmm(l, r, gs, *blocks) ** 2),
                    argnums=(0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    tl, tr = _t(lhs).requires_grad_(), _t(rhs).requires_grad_()
    (gm.gmm(tl, tr, _t(sizes)) ** 2).sum().backward()
    for got, ref in zip((tl.grad, tr.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3,
                                   rtol=1e-3)


def test_bf16_plain_rounds_the_fp32_product_once():
    sizes, lhs, rhs, _, _, _ = _inputs("mid-tile-empty", seed=4)
    lb, rb = _t(lhs).bfloat16(), _t(rhs).bfloat16()
    got = gm.gmm(lb, rb, _t(sizes))
    assert got.dtype == torch.bfloat16
    ref = gm.gmm(lb.float(), rb.float(), _t(sizes))
    assert torch.equal(got, ref.bfloat16())
    dl = gm.tgmm(lb, lb[:, :40].contiguous(), _t(sizes))
    assert dl.dtype == torch.bfloat16 and dl.shape == (4, 64, 40)


def test_group_sizes_get_no_gradient_and_shapes_are_checked():
    sizes, lhs, rhs, _, _, _ = _inputs("aligned")
    tl = _t(lhs).requires_grad_()
    out = gm.gmm(tl, _t(rhs), _t(sizes))
    out.sum().backward()
    assert tl.grad is not None and tl.grad.shape == tl.shape
    with pytest.raises(ValueError, match="does not match"):
        gm.gmm_raw(_t(lhs), _t(rhs[:, :10]), _t(sizes))
    with pytest.raises(ValueError, match="does not match"):
        gm.tgmm(_t(lhs), _t(lhs[:10]), _t(sizes))
    with pytest.raises(ValueError, match="unsupported device"):
        gm.gmm_raw(_t(lhs).to("meta"), _t(rhs).to("meta"),
                   _t(sizes).to("meta"))
