"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at Llama-3-8B attention shapes: the paged decode and prefill
kernels (nh 32, nkv 8, hd 128, block size 16; shuffled block tables,
ragged context lengths including 0, a dead prefill segment) and the
three flash attention kernels (B 2, S 2048, 32/8 heads, hd 128, causal;
a non-causal S 1000 case with three segments; an hd 64 case).

Needs an sm_90 card and nvcc: marked ``cuda`` and skipped elsewhere.
Run on the card with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``
(tests/conftest.py imports jax, which the card's machine need not have).

Tolerances: fp32 max-abs 1e-4 (the two sum in different orders); bf16
2e-2, one bf16 rounding of outputs of magnitude up to ~4 (both round an
fp32 result once, and may round to neighbouring values).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import kernels_available
from deepspeed_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

NH, NKV, HD, BS, BM, NB = 32, 8, 128, 16, 48, 2048
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def card():
    if not kernels_available():
        pytest.skip("needs a CUDA device of compute capability >= 9.0 "
                    "and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, S, seed, tq=None):
    rng = np.random.default_rng(seed)
    kv = torch.from_numpy(rng.standard_normal(
        (NB, BS, 2, NKV, HD), np.float32)).to(dev, dtype)
    bt = torch.from_numpy(rng.permutation(NB - 1)[:S * BM].reshape(
        S, BM).astype(np.int32)).to(dev)
    shape = (S, NH, HD) if tq is None else (S, tq, NH, HD)
    q = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev,
                                                                    dtype)
    return rng, q, kv, bt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(card, dtype):
    S = 16
    rng, q, kv, bt = _case(card, dtype, S, 0)
    ctx_np = rng.integers(1, BM * BS + 1, S).astype(np.int32)
    ctx_np[3] = 0
    ctx_np[5] = BM * BS
    ctx_np[7] = BM * BS + 9  # past the table: columns beyond it unseen
    ctx = torch.from_numpy(ctx_np).to(card)
    before = pa.LAUNCHES["paged_decode"]
    out = pa.paged_decode_attention(q, kv, bt, ctx)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == before + 1
    ref = pa.paged_decode_attention_plain(q, kv, bt, ctx, HD ** -0.5)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert torch.all(out[3] == 0)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq", [16, 128])
def test_prefill_kernel_matches_plain(card, dtype, tq):
    S = 4
    rng, q, kv, bt = _case(card, dtype, S, 1, tq=tq)
    pos0_np = rng.integers(0, BM * BS - tq, S).astype(np.int32)
    nreal = np.full(S, tq, np.int32)
    nreal[2] = tq - 5  # padded rows
    pos0_np[1], nreal[1] = 0, 0  # dead segment
    pos0 = torch.from_numpy(pos0_np).to(card)
    ctx = torch.from_numpy(pos0_np + nreal).to(card)
    before = pa.LAUNCHES["paged_prefill"]
    out = pa.paged_prefill_attention(q, kv, bt, pos0, ctx)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == before + 1
    ref = pa.paged_prefill_attention_plain(q, kv, bt, pos0, ctx, HD ** -0.5)
    assert torch.isfinite(out).all() and torch.all(out[1] == 0)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[dtype], err


# flash kernels: forward at the paged kernels' tolerances; gradients
# within a share of the largest reference gradient (fp32: sums over 2048
# rows in another order; bf16: p and ds round to bf16 in both, and a
# rounding that lands on the other side of a tie moves one term by 2**-8)
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_CASES = {  # B, S, Hq, Hkv, D, causal, segment lengths
    "smoke": (2, 2048, 32, 8, 128, True, None),
    "odd": (1, 1000, 4, 4, 128, False, (400, 350, 250)),
    "hd64": (2, 300, 8, 2, 64, True, None),
}


def _flash_inputs(dev, dtype, case, seed):
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, S, hq, hkv, D, causal, lens = FLASH_CASES[case]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)

    q, k, v, do = t(B, S, hq, D), t(B, S, hkv, D), t(B, S, hkv, D), \
        t(B, S, hq, D)
    seg = None
    if lens is not None:
        seg = torch.from_numpy(np.repeat(np.arange(len(lens)), lens)[None]
                               .repeat(B, 0).astype(np.int32)).to(dev)
    return fa, q, k, v, do, seg, causal, D ** -0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(card, dtype, case):
    fa, q, k, v, do, seg, causal, scale = _flash_inputs(card, dtype, case, 3)
    before = dict(fa.LAUNCHES)
    o, lse = fa._flash_fwd(q, k, v, seg, causal, scale)
    dq, dk, dv = fa._flash_bwd(q, k, v, seg, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, seg, causal, scale)
    ref_args = (q, k, v, seg, lse_ref,
                (do.float() * o_ref.float()).sum(-1).transpose(1, 2), do,
                causal, scale)
    grads_ref = (fa.flash_bwd_dq_plain(*ref_args),
                 *fa.flash_bwd_dkdv_plain(*ref_args))
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - o_ref.float()).abs().max().item() <= ATOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    for got, want in zip((dq, dk, dv), grads_ref):
        assert got.shape == want.shape and torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= GRAD_REL[dtype] * want.float().abs().max().item(), err


def test_flash_backward_is_bit_identical_across_launches(card):
    fa, q, k, v, do, seg, causal, scale = _flash_inputs(
        card, torch.bfloat16, "smoke", 4)
    o, lse = fa._flash_fwd(q, k, v, seg, causal, scale)
    first = fa._flash_bwd(q, k, v, seg, o, lse, do, causal, scale)
    second = fa._flash_bwd(q, k, v, seg, o, lse, do, causal, scale)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_on_card_matches_dense(card):
    """flash_attention's autograd Function against the dense path's
    autograd, fp32, GQA 4, S not a tile multiple."""
    from deepspeed_tpu_torch.ops.attention import xla_attention
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(5)
    base = [rng.standard_normal(s, np.float32) for s in
            ((2, 200, 8, 64), (2, 200, 2, 64), (2, 200, 2, 64))]
    outs = []
    for fn in (flash_attention, xla_attention):
        t = [torch.tensor(x, device=card, requires_grad=True) for x in base]
        o = fn(*t, causal=True)
        (o ** 2).sum().backward()
        outs.append([o.detach()] + [x.grad for x in t])
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max()
                                                        .item())


def test_engine_on_card_matches_cpu(card):
    """A tiny fp32 Llama-style engine gives the same greedy streams on
    the card (kernels) as on the CPU (plain versions)."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import zoo

    over = dict(dtype=torch.float32, pos_emb="rope", norm="rmsnorm",
                activation="swiglu", num_kv_heads=1, ffn_size=128,
                tie_embeddings=False)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 19, 40)]
    outs = []
    for dev in ("cpu", "cuda"):
        model = zoo.get_model("tiny", device="cpu", seed=0, **over)
        model.to(dev)
        eng = InferenceEngineV2(model, kv_blocks=64, kv_block_size=8,
                                max_tokens_per_step=32, max_seqs_per_step=4,
                                max_blocks_per_seq=8, device=dev)
        eng.put([0, 1, 2], prompts, max_new_tokens=12)
        outs.append(eng.generate_all())
    assert outs[0] == outs[1]
