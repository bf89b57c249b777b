"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at Llama-3-8B attention shapes: the paged decode and prefill
kernels (nh 32, nkv 8, hd 128, block size 16; shuffled block tables,
ragged context lengths including 0, a dead prefill segment) and the
three flash attention kernels (B 2, S 2048, 32/8 heads, hd 128, causal;
a non-causal S 1000 case with three segments; an hd 64 case); and the
grouped matmuls gmm, gmm^T and tgmm at Mixtral-8x7B expert shapes (E 8,
K 4096, N 14336 and back, 4096 rows in imbalanced groups; 32 decode rows),
at aligned sizes with group boundaries mid-tile, one tile straddling three
groups, an over-sum and an under-sum (bf16 there takes the tensor-core
kernel, fp32 the scalar one; the variant counters must say which ran and
two launches must give the same bits), at odd sizes (the scalar kernel)
and from a misaligned bf16 view (the scalar kernel); and the
quantize kernels (blockwise quantize, KV quantize-on-append, dequantize,
and the fused append and dequantize) at Llama-3-8B shapes, held to
their plain versions bit for bit (every operation is one IEEE-rounded
step in both), with exact .5 ties, all-zero blocks and values at the
edges of the grid among the inputs; and the
block-sparse forward over the five layout modes, layout blocks 16 to
256, a ragged S, GQA 32/8 and 32/32, and a custom layout with an empty
row.

Needs an sm_90 card and nvcc: marked ``cuda`` and skipped elsewhere.
Run on the card with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``
(tests/conftest.py imports jax, which the card's machine need not have).

The bf16 paged decode at head dim 128 takes the split kernel (spans of
pages merged in the same launch): it is held to its plain twin at the
span the host picked (block sizes 8 to 128, GQA groups 1, 4 and 8, dead
slots, contexts past the table, S 1 x 1024 pages), must give the same
bits on a second launch and whatever its neighbours' contexts, and must
say so in its variant counters; fp32 and a misaligned bf16 q take the
scalar kernel by the rule.

The bf16 flash kernels at head dim 128 (forward, dK/dV, dQ) and the
bf16 tgmm take the tensor-core kernels (wgmma fed by TMA); they are held
to the same tolerances, must say so in their variant counters, read q,
k, v (and dO) views in place, give the same bits on a second launch, and
tgmm must ignore rows of the neighbouring groups poisoned with 1e30. So
do the bf16 paged prefill (block sizes 8, 16 and 32, Tq 16 and 128, a
dead segment, padded rows, a context at the table's end; the scalar
kernel forced on the same inputs agrees too, and block size 4 or a
misaligned q take it by the rule) and the bf16 block-sparse forward at
layout blocks that are multiples of 128 (against the plain version at
its 128-wide fold; head-slice and [B, H, S, D] views; the main path's S
8192 shape; an empty row).

Tolerances: fp32 max-abs 1e-4 (the two sum in different orders); bf16
2e-2, one bf16 rounding of outputs of magnitude up to ~4 (both round an
fp32 result once, and may round to neighbouring values). The grouped
matmuls' sums run over thousands of terms, so their bounds are relative
to the largest reference entry: 1e-4 in fp32, 2e-2 in bf16. So are the
block-sparse forward's (fp32 1e-4; bf16 2e-2 against the plain version,
which rounds p to bf16 at the same point, and 3e-2 against the masked
form, which rounds the normalised probabilities instead).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import kernels_available
from deepspeed_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

NH, NKV, HD, BS, BM, NB = 32, 8, 128, 16, 48, 2048
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the split decode against its plain twin, as the largest error in an
# output row (sequence, head) over that row's largest reference entry
# (_row_rel_err): at long contexts the largest outputs are 0.05-0.1,
# where a max-abs limit of 2e-2 would pass a merge that leaves out a
# span's weight; one bf16 ulp of a row's largest entry is up to 7.8e-3
DECODE_ROW_REL = 2e-2


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


def _decode_case(dev, bs, g, S, pages, seed):
    """A bf16 pool of block size bs and ``pages`` table entries a slot
    (shuffled page ids), q of g query heads a kv head, and contexts:
    ragged, a dead slot, one token, the table's whole span and past it."""
    rng = np.random.default_rng(seed)
    nb = S * pages + 3
    kv = torch.from_numpy(rng.standard_normal(
        (nb, bs, 2, NKV, HD), np.float32)).to(dev, torch.bfloat16)
    bt = torch.from_numpy(rng.permutation(nb)[:S * pages].reshape(
        S, pages).astype(np.int32)).to(dev)
    q = torch.from_numpy(rng.standard_normal(
        (S, g * NKV, HD), np.float32)).to(dev, torch.bfloat16)
    ctx = rng.integers(1, pages * bs + 1, S).astype(np.int32)
    if S >= 5:
        ctx[1:5] = [0, 1, pages * bs, pages * bs + 9]
    return q, kv, bt, torch.from_numpy(ctx).to(dev)


def _split_checked(q, kv, bt, ctx):
    """Two launches of the split decode: same bits, counted by variant,
    against the plain twin at the host's span, in each output row."""
    variants = dict(pa.VARIANT_LAUNCHES)
    out = pa.paged_decode_attention(q, kv, bt, ctx)
    again = pa.paged_decode_attention(q, kv, bt, ctx)
    torch.cuda.synchronize()
    assert {k: pa.VARIANT_LAUNCHES[k] - variants[k] for k in variants} == {
        k: 2 * (k == "paged_decode/split") for k in variants}
    assert torch.equal(out, again)
    span = pa.decode_span_of(q, kv, bt)
    ref = pa.paged_decode_attention_split_plain(q, kv, bt, ctx, HD ** -0.5,
                                                span)
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[torch.bfloat16], err
    assert _row_rel_err(out, ref) <= DECODE_ROW_REL
    return out


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
def test_split_decode_matches_split_plain(card, bs, g):
    """The split decode over a 768-token table at every block size the
    pool takes and GQA groups 1, 4 and 8 (several spans a slot): a dead
    slot gives exactly 0, a context past the table stops at it."""
    q, kv, bt, ctx = _decode_case(card, bs, g, 8, 768 // bs, 30 + bs + g)
    assert pa.paged_decode_variant(q, kv) == "split"
    assert pa.decode_span_of(q, kv, bt) < bt.shape[1]
    out = _split_checked(q, kv, bt, ctx)
    assert torch.all(out[1] == 0)


def test_split_decode_long_context(card):
    """S 1 x 1024 pages of 16 tokens (16384 keys) in 64 spans, and a
    context ending mid-page."""
    q, kv, bt, ctx = _decode_case(card, 16, 4, 1, 1024, 40)
    for n in (1024 * 16, 9999):
        ctx.fill_(n)
        _split_checked(q, kv, bt, ctx)


def test_split_decode_is_batch_invariant(card):
    """A sequence's output keeps its bits when its neighbours' contexts
    change (the span comes from shapes alone)."""
    q, kv, bt, ctx = _decode_case(card, 16, 4, 8, 48, 41)
    out = pa.paged_decode_attention(q, kv, bt, ctx)
    ctx2 = ctx.clone()
    ctx2[0::2] = torch.tensor([3, 700, 0, 768], dtype=torch.int32,
                              device=card)
    out2 = pa.paged_decode_attention(q, kv, bt, ctx2)
    torch.cuda.synchronize()
    assert torch.equal(out[1::2], out2[1::2])
    assert not torch.equal(out[0::2], out2[0::2])


@pytest.mark.parametrize("case", ["fp32", "misaligned"])
def test_decode_rule_sends_to_simt(card, case):
    """fp32, and a bf16 q 2 bytes off a 16-byte boundary, run the scalar
    kernel by the rule; forcing "split" there raises, and "simt" forced
    on the split kernel's inputs agrees with the plain fold."""
    q, kv, bt, ctx = _decode_case(card, 16, 4, 8, 48, 42)
    if case == "fp32":
        q, kv = q.float(), kv.float()
    else:
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
        qm = buf[1:].view(q.shape)
        qm.copy_(q)
        q = qm
    assert pa.paged_decode_variant(q, kv) == "simt"
    variants = dict(pa.VARIANT_LAUNCHES)
    out = pa.paged_decode_attention(q, kv, bt, ctx)
    torch.cuda.synchronize()
    assert {k: pa.VARIANT_LAUNCHES[k] - variants[k] for k in variants} == {
        k: int(k == "paged_decode/simt") for k in variants}
    ref = pa.paged_decode_attention_plain(q, kv, bt, ctx, HD ** -0.5)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[q.dtype], err
    with pytest.raises(ValueError, match="split decode"):
        pa.paged_decode_attention(q, kv, bt, ctx, variant="split")
    if case == "misaligned":
        q2, kv2, bt2, ctx2 = _decode_case(card, 16, 4, 8, 48, 42)
        simt = pa.paged_decode_attention(q2, kv2, bt2, ctx2, variant="simt")
        err = (simt.float() - ref.float()).abs().max().item()
        assert err <= ATOL[torch.bfloat16], err


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
    variants = dict(pa.VARIANT_LAUNCHES)
    out = pa.paged_prefill_attention(q, kv, bt, pos0, ctx)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == before + 1
    # bf16 at hd 128 and block size 16 takes the tensor-core kernel
    want = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert {k: pa.VARIANT_LAUNCHES[k] - variants[k] for k in variants} == {
        k: int(k == f"paged_prefill/{want}") for k in variants}
    ref = pa.paged_prefill_attention_plain(q, kv, bt, pos0, ctx, HD ** -0.5)
    assert torch.isfinite(out).all() and torch.all(out[1] == 0)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[dtype], err


def _prefill_case(dev, tq, bs, seed):
    """bf16 pool of block size bs (the same 768-token table span at every
    bs), four segments: ragged, a dead one, padded rows, and one whose
    context is the table's whole span (ctx = Bm * bs)."""
    bm = BM * BS // bs
    rng = np.random.default_rng(seed)
    nb = 4 * bm + 8
    kv = torch.from_numpy(rng.standard_normal(
        (nb, bs, 2, NKV, HD), np.float32)).to(dev, torch.bfloat16)
    bt = torch.from_numpy(rng.permutation(nb)[:4 * bm].reshape(4, bm)
                          .astype(np.int32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((4, tq, NH, HD), np.float32)).to(
        dev, torch.bfloat16)
    pos0_np = np.array([rng.integers(0, bm * bs - tq), 0, 37,
                        bm * bs - tq], np.int32)
    nreal = np.array([tq, 0, tq - 5, tq], np.int32)
    pos0 = torch.from_numpy(pos0_np).to(dev)
    ctx = torch.from_numpy(pos0_np + nreal).to(dev)
    return q, kv, bt, pos0, ctx


@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("tq", [16, 128])
def test_tensor_core_prefill_matches_plain_and_simt(card, tq, bs):
    """The tensor-core prefill at block sizes 8, 16 and 32 against its
    plain version and against the scalar kernel forced on the same bf16
    inputs: a dead segment (exactly 0), padded rows, ctx at Bm * bs; two
    launches bit-identical; launches counted by variant."""
    q, kv, bt, pos0, ctx = _prefill_case(card, tq, bs, 5)
    assert pa.paged_prefill_variant(q, kv) == "wgmma"
    variants = dict(pa.VARIANT_LAUNCHES)
    out = pa.paged_prefill_attention(q, kv, bt, pos0, ctx)
    again = pa.paged_prefill_attention(q, kv, bt, pos0, ctx)
    simt = pa.paged_prefill_attention(q, kv, bt, pos0, ctx, variant="simt")
    torch.cuda.synchronize()
    assert {k: pa.VARIANT_LAUNCHES[k] - variants[k] for k in variants} == {
        **{k: 0 for k in variants},
        "paged_prefill/wgmma": 2, "paged_prefill/simt": 1}
    assert torch.equal(out, again)
    assert torch.all(out[1] == 0) and torch.isfinite(out).all()
    ref = pa.paged_prefill_attention_plain(q, kv, bt, pos0, ctx, HD ** -0.5)
    for got in (out, simt):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= ATOL[torch.bfloat16], err


@pytest.mark.parametrize("case", ["bs4", "misaligned"])
def test_prefill_rule_sends_bf16_to_simt(card, case):
    """bf16 inputs the tensor-core prefill does not take run the scalar
    kernel: block size 4, and q a contiguous view 2 bytes off a 16-byte
    boundary; forcing "wgmma" there raises."""
    q, kv, bt, pos0, ctx = _prefill_case(card, 16, 4 if case == "bs4" else 16,
                                         6)
    if case == "misaligned":
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
        qm = buf[1:].view(q.shape)
        qm.copy_(q)
        q = qm
    assert pa.paged_prefill_variant(q, kv) == "simt"
    variants = dict(pa.VARIANT_LAUNCHES)
    out = pa.paged_prefill_attention(q, kv, bt, pos0, ctx)
    torch.cuda.synchronize()
    assert pa.VARIANT_LAUNCHES["paged_prefill/simt"] == \
        variants["paged_prefill/simt"] + 1
    ref = pa.paged_prefill_attention_plain(q, kv, bt, pos0, ctx, HD ** -0.5)
    assert (out.float() - ref.float()).abs().max().item() <= ATOL[
        torch.bfloat16]
    with pytest.raises(ValueError, match="tensor-core prefill"):
        pa.paged_prefill_attention(q, kv, bt, pos0, ctx, variant="wgmma")


# flash kernels: forward at the paged kernels' tolerances; gradients
# within a share of each gradient row's largest reference entry (a key's
# dK or dV, a q row's dQ: causal gradients span ~10 at the first keys and
# rows to ~0.1 at the late ones), fp32: sums over 2048 rows in another
# order; bf16: p and ds round to bf16 in both, and a rounding that lands
# on the other side of a tie moves one term by 2**-8. A row whose exact
# gradient is 0 (dQ of a causal segment's first row: p = 1, so
# dS = dP - delta cancels) holds fp32 noise of the sums' order, and
# GRAD_ROW_FLOOR of the tensor's largest entry stands in for its scale
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GRAD_ROW_FLOOR = 1e-4
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
    variants = dict(fa.VARIANT_LAUNCHES)
    o, lse = fa._flash_fwd(q, k, v, seg, causal, scale)
    dq, dk, dv = fa._flash_bwd(q, k, v, seg, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}
    # bf16 at hd 128 takes the tensor-core kernels (forward, dK/dV and
    # dQ), the rest the scalar ones
    kind = fa.flash_variant("cuda", dtype, q.shape[-1], (8,) * 12, (0,) * 4)
    assert kind == ("wgmma" if dtype == torch.bfloat16 and case != "hd64"
                    else "simt")
    assert {n: fa.VARIANT_LAUNCHES[n] - variants[n] for n in variants} == {
        f"{name}/{v}": int(v == kind)
        for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
        for v in ("wgmma", "simt")}
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
        err = _row_rel_err(got, want, GRAD_ROW_FLOOR)
        assert err <= GRAD_REL[dtype], err


def test_flash_backward_is_bit_identical_across_launches(card):
    fa, q, k, v, do, seg, causal, scale = _flash_inputs(
        card, torch.bfloat16, "smoke", 4)
    o, lse = fa._flash_fwd(q, k, v, seg, causal, scale)
    variants = dict(fa.VARIANT_LAUNCHES)
    first = fa._flash_bwd(q, k, v, seg, o, lse, do, causal, scale)
    second = fa._flash_bwd(q, k, v, seg, o, lse, do, causal, scale)
    # the tensor-core kernels: one block owns each output tile, no atomics
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        assert fa.VARIANT_LAUNCHES[f"{name}/wgmma"] == \
            variants[f"{name}/wgmma"] + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _flash_bwd_checked(fa, q, k, v, seg, causal, do, want_variant):
    """The backward kernels through their wrappers, twice, against their
    plain versions on the same inputs (lse from the plain forward, delta
    from its output): the variant that ran, every gradient within
    GRAD_REL of its row's largest reference entry, the two launches
    bit-identical."""
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, seg, causal, scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, seg, lse, delta, do, causal, scale)
    variants = dict(fa.VARIANT_LAUNCHES)
    got = [(fa.flash_bwd_dq(*args), *fa.flash_bwd_dkdv(*args))
           for _ in range(2)]
    torch.cuda.synchronize()
    assert {n: fa.VARIANT_LAUNCHES[n] - variants[n] for n in variants} == {
        f"{name}/{v}": 2 * int(v == want_variant and name != "flash_fwd")
        for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
        for v in ("wgmma", "simt")}
    want = (fa.flash_bwd_dq_plain(*args), *fa.flash_bwd_dkdv_plain(*args))
    for a, b, ref in zip(*got, want):
        assert torch.equal(a, b)
        err = _row_rel_err(a, ref, GRAD_ROW_FLOOR)
        assert err <= GRAD_REL[q.dtype], err


@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_flash_backward_segments_at_s1000(card, causal):
    """S 1000 (not a tile multiple) with three packed segments and GQA
    4/2, bf16: the tensor-core dK/dV and dQ against their plain versions,
    causal and not."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(13)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 1000, h, 128), np.float32)).to(card, torch.bfloat16)
        for h in (4, 2, 2, 4))
    seg = torch.from_numpy(np.repeat(np.arange(3), (400, 350, 250))[None]
                           .astype(np.int32)).to(card)
    _flash_bwd_checked(fa, q, k, v, seg, causal, do, "wgmma")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("view", ["head-slice", "bhsd", "contiguous"])
def test_tensor_core_flash_backward_reads_views(card, causal, view):
    """The tensor-core backward reads q, k, v and dO in place at any
    strides TMA takes: head slices of a fused projection, [B, H, S, D]
    tensors read as [B, S, H, D] (dO as autograd may hand it over), and
    contiguous ones; causal and not, S 300 (a ragged tail)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(14)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            card, torch.bfloat16)

    B, S = 2, 300
    if view == "head-slice":
        fused = t(B, S, 48, 128)  # 32 q heads, 8 k, 8 v
        q, k, v = fused[:, :, :32], fused[:, :, 32:40], fused[:, :, 40:]
        do = t(B, S, 40, 128)[:, :, 4:36]
    elif view == "bhsd":
        q, k, v, do = (t(B, h, S, 128).transpose(1, 2)
                       for h in (32, 8, 8, 32))
    else:
        q, k, v, do = t(B, S, 32, 128), t(B, S, 8, 128), t(B, S, 8, 128), \
            t(B, S, 32, 128)
    assert view == "contiguous" or not do.is_contiguous()
    _flash_bwd_checked(fa, q, k, v, None, causal, do, "wgmma")


def test_tensor_core_flash_autograd_takes_an_expanded_grad(card):
    """``o.sum().backward()`` hands the backward an expanded dO (stride
    0): it is made contiguous once and the tensor-core kernels run, with
    the gradients of the plain versions."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(15)
    base = [torch.from_numpy(rng.standard_normal((2, 300, h, 128),
                                                 np.float32))
            .to(card, torch.bfloat16) for h in (8, 2, 2)]
    t = [x.clone().requires_grad_() for x in base]
    variants = dict(fa.VARIANT_LAUNCHES)
    fa.flash_attention(*t, causal=True).sum().backward()
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert fa.VARIANT_LAUNCHES[f"{name}/wgmma"] == \
            variants[f"{name}/wgmma"] + 1
    scale = 128 ** -0.5
    q, k, v = base
    o, lse = fa.flash_fwd_plain(q, k, v, None, True, scale)
    do = torch.ones_like(o)
    delta = o.float().sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, None, lse, delta, do, True, scale)
    want = (fa.flash_bwd_dq_plain(*args), *fa.flash_bwd_dkdv_plain(*args))
    for x, ref in zip(t, want):
        err = _row_rel_err(x.grad, ref, GRAD_ROW_FLOOR)
        assert err <= GRAD_REL[torch.bfloat16], err


def _flash_fwd_checked(fa, q, k, v, seg, causal, want_variant):
    """The forward through the wrapper, twice, against its plain version:
    the variant that ran, output within the forward tolerance, lse within
    1e-4, the two launches bit-identical."""
    scale = q.shape[-1] ** -0.5
    variants = dict(fa.VARIANT_LAUNCHES)
    o, lse = fa._flash_fwd(q, k, v, seg, causal, scale)
    o2, lse2 = fa._flash_fwd(q, k, v, seg, causal, scale)
    torch.cuda.synchronize()
    assert {n: fa.VARIANT_LAUNCHES[n] - variants[n] for n in variants} == {
        f"{name}/{v}": 2 * int(v == want_variant and name == "flash_fwd")
        for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
        for v in ("wgmma", "simt")}
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, seg, causal, scale)
    assert torch.isfinite(o).all()
    assert (o.float() - o_ref.float()).abs().max().item() <= ATOL[q.dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("view", ["head-slice", "bhsd", "contiguous"])
def test_tensor_core_flash_forward_reads_views(card, causal, view):
    """The tensor-core forward reads q (and k, v) in place at any strides
    TMA takes: a head slice of a fused projection and a [B, H, S, D]
    tensor read as [B, S, H, D]; causal and not, S 300 (a ragged tail)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(11)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            card, torch.bfloat16)

    B, S = 2, 300
    if view == "head-slice":
        fused = t(B, S, 48, 128)  # 32 q heads, 8 k, 8 v
        q, k, v = fused[:, :, :32], fused[:, :, 32:40], fused[:, :, 40:]
    elif view == "bhsd":
        q, k, v = (t(B, h, S, 128).transpose(1, 2) for h in (32, 8, 8))
    else:
        q, k, v = t(B, S, 32, 128), t(B, S, 8, 128), t(B, S, 8, 128)
    _flash_fwd_checked(fa, q, k, v, None, causal, "wgmma")


@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_flash_forward_segments_at_s1000(card, causal):
    """S 1000 (not a tile multiple) with three packed segments and GQA
    4/2, bf16: the tensor-core forward against its plain version."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 1000, h, 128), np.float32)).to(card, torch.bfloat16)
        for h in (4, 2, 2))
    seg = torch.from_numpy(np.repeat(np.arange(3), (400, 350, 250))[None]
                           .astype(np.int32)).to(card)
    _flash_fwd_checked(fa, q, k, v, seg, causal, "wgmma")


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


# grouped matmuls: name -> (group sizes, M (None = their sum), K, N). In
# bf16 every case but the odd ones takes the tensor-core kernel: 128 x 256
# tiles above 1024 rows, 64 x 128 at or below (decode, mid-tile-small)
GMM_CASES = {
    "mixtral": ([700, 0, 1000, 300, 64, 1500, 500, 32], None, 4096, 14336),
    "train_wi": ([704, 0, 1000, 296, 64, 1496, 504, 32], None, 4096, 14336),
    "train_wo": ([704, 0, 1000, 296, 64, 1496, 504, 32], None, 14336, 4096),
    "decode": ([5, 0, 9, 1, 3, 6, 0, 8], None, 4096, 14336),
    "mid-tile-small": ([200, 0, 517, 307], None, 512, 768),
    "tile-straddles-three-groups": ([100, 20, 1180], None, 256, 512),
    "aligned-over-sum": ([600, 600, 600], 1500, 256, 512),
    "aligned-under-sum": ([500, 0, 400], 1200, 256, 520),
    "small-over-sum": ([40, 40, 40], 100, 64, 128),
    "odd-over-sum": ([40, 40, 40], 100, 33, 45),
    "odd-under-sum": ([30, 0, 21], 70, 33, 45),
}
GMM_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel_err(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_grouped_matmul_kernels_match_plain(card, dtype, case):
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    sizes, M, K, N = GMM_CASES[case]
    M = sum(sizes) if M is None else M
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            card, dtype)

    gs = torch.tensor(sizes, dtype=torch.int32, device=card)
    lhs, rhs, dout = t(M, K), t(len(sizes), K, N), t(M, N)
    before = dict(gm.LAUNCHES)
    variants = dict(gm.VARIANT_LAUNCHES)
    out = gm.gmm_raw(lhs, rhs, gs)
    dlhs = gm.gmm_raw(dout, rhs, gs, transpose_rhs=True)
    drhs = gm.tgmm(lhs, dout, gs)
    torch.cuda.synchronize()
    assert {n: gm.LAUNCHES[n] - before[n] for n in before} == {
        "gmm": 1, "gmm_transposed": 1, "tgmm": 1}
    # the variant counters name the kernel that ran: gmm contracts K into
    # N, gmm^T N into K, tgmm M into [K, N]
    kind = {name: gm.gmm_variant("cuda", dtype, k, n, (0, 0))
            for name, k, n in (("gmm", K, N), ("gmm_transposed", N, K))}
    kind["tgmm"] = gm.tgmm_variant("cuda", dtype, K, N, (0, 0))
    assert kind["gmm"] == kind["tgmm"] == (
        "wgmma" if dtype == torch.bfloat16 and not case.startswith("odd")
        else "simt")
    assert {n: gm.VARIANT_LAUNCHES[n] - variants[n] for n in variants} == {
        f"{name}/{v}": int(kind[name] == v) for name in kind
        for v in ("wgmma", "simt")}
    assert out.dtype == dlhs.dtype == drhs.dtype == dtype
    for got, want in ((out, gm.gmm_plain(lhs, rhs, gs)),
                      (dlhs, gm.gmm_transposed_plain(dout, rhs, gs)),
                      (drhs, gm.tgmm_plain(lhs, dout, gs))):
        assert _rel_err(got, want) <= GMM_REL[dtype]
    end = min(sum(sizes), M)
    assert torch.all(out[end:] == 0) and torch.all(dlhs[end:] == 0)
    for e, size in enumerate(sizes):
        if size == 0:
            assert torch.all(drhs[e] == 0)
    # no atomics, no split-K: a second launch gives the same bits
    assert torch.equal(gm.gmm_raw(lhs, rhs, gs), out)
    assert torch.equal(gm.gmm_raw(dout, rhs, gs, transpose_rhs=True), dlhs)
    assert torch.equal(gm.tgmm(lhs, dout, gs), drhs)


@pytest.mark.parametrize("case", ["train_wi", "mid-tile-small",
                                  "aligned-over-sum", "aligned-under-sum"])
def test_tensor_core_tgmm_ignores_the_neighbouring_groups(card, case):
    """Poison: for each group, the rows of every other group (and the
    unowned tail) of lhs and dout filled with 1e30. The tensor-core tgmm
    must give that group the same bits as on the clean inputs: a missed
    zeroing of the last stage's foreign rows would bring 1e30 (or inf)
    into it."""
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    sizes, M, K, N = GMM_CASES[case]
    M = sum(sizes) if M is None else M
    rng = np.random.default_rng(13)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            card, torch.bfloat16)

    gs = torch.tensor(sizes, dtype=torch.int32, device=card)
    lhs, dout = t(M, K), t(M, N)
    variants = dict(gm.VARIANT_LAUNCHES)
    clean = gm.tgmm(lhs, dout, gs)
    assert gm.VARIANT_LAUNCHES["tgmm/wgmma"] == variants["tgmm/wgmma"] + 1
    assert _rel_err(clean, gm.tgmm_plain(lhs, dout, gs)) <= GMM_REL[
        torch.bfloat16]
    ends = np.minimum(np.cumsum(sizes), M)
    starts = np.concatenate([[0], ends[:-1]])
    for e, (s0, s1) in enumerate(zip(starts, ends)):
        lp, dp = lhs.clone(), dout.clone()
        for x in (lp, dp):
            x[:s0] = 1e30
            x[s1:] = 1e30
        got = gm.tgmm(lp, dp, gs)[e]
        torch.cuda.synchronize()
        assert torch.equal(got, clean[e]), (case, e)


def test_gmm_misaligned_bf16_takes_the_scalar_kernel(card):
    """A bf16 view 2 bytes off a 16-byte boundary cannot feed TMA: gmm_raw
    launches the scalar kernel, which agrees with the plain version."""
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    rng = np.random.default_rng(10)
    sizes, K, N = [300, 0, 900, 100], 256, 512
    M = sum(sizes)
    base = torch.from_numpy(rng.standard_normal(M * K + 1, np.float32)).to(
        card, torch.bfloat16)
    lhs = base[1:].view(M, K)
    rhs = torch.from_numpy(rng.standard_normal((4, K, N), np.float32)).to(
        card, torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device=card)
    variants = dict(gm.VARIANT_LAUNCHES)
    got = gm.gmm_raw(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert gm.VARIANT_LAUNCHES["gmm/simt"] == variants["gmm/simt"] + 1
    assert gm.VARIANT_LAUNCHES["gmm/wgmma"] == variants["gmm/wgmma"]
    assert _rel_err(got, gm.gmm_plain(lhs, rhs, gs)) <= GMM_REL[
        torch.bfloat16]
    aligned = gm.gmm_raw(lhs.clone(), rhs, gs)
    assert gm.VARIANT_LAUNCHES["gmm/wgmma"] == variants["gmm/wgmma"] + 1
    assert _rel_err(aligned, got) <= GMM_REL[torch.bfloat16]


def test_gmm_autograd_on_card_matches_cpu(card):
    from deepspeed_tpu_torch.ops.grouped_matmul import gmm

    rng = np.random.default_rng(4)
    sizes = torch.tensor([37, 0, 90, 1], dtype=torch.int32)
    base = [rng.standard_normal(s).astype(np.float32)
            for s in ((128, 64), (4, 64, 96))]
    grads = []
    for dev in ("cpu", card):
        lhs, rhs = (torch.tensor(x, device=dev, requires_grad=True)
                    for x in base)
        (gmm(lhs, rhs, sizes.to(dev)) ** 2).sum().backward()
        grads.append((lhs.grad.cpu(), rhs.grad.cpu()))
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


# -- quantization -----------------------------------------------------------


def _quant_values(rng, rows, n, top):
    """rows x n fp32 values: normal rows, rows of exact ties on a unit
    grid (absmax ``top`` makes the scale exactly 1), all-zero rows, and
    rows reaching past both ends of the grid."""
    x = rng.standard_normal((rows, n)).astype(np.float32) * 3
    ties = rng.integers(-top, top, (rows, n)).astype(np.float32) + 0.5
    x[::7] = ties[::7]
    x[::7, 0] = top
    x[3::11] = 0.0
    x[5::13, :2] = (top - 0.5, -top - 0.5)
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block", [128, 256, 40])
def test_quantize_blockwise_kernel_matches_plain(card, dtype, bits, block):
    from deepspeed_tpu_torch.ops import quantization as qz

    rng = np.random.default_rng(bits + block)
    n = block if block < 128 else 1024  # 40: the min(block, n) fallback
    top = (1 << (bits - 1)) - 1
    x = torch.from_numpy(_quant_values(rng, 512, n, top)).to(card, dtype)
    before = qz.LAUNCHES["quantize_blockwise"]
    q, s = qz.quantize_blockwise(x, bits=bits, block=256 if block == 40
                                 else block)
    torch.cuda.synchronize()
    assert qz.LAUNCHES["quantize_blockwise"] == before + 1
    q_ref, s_ref = qz._quantize_ref(x, bits, min(block, n))
    assert q.dtype == torch.int8 and torch.equal(q, q_ref)
    assert torch.equal(s, s_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("ntok", [16, 256])
def test_kv_quantize_append_kernel_matches_plain(card, dtype, bits, ntok):
    from deepspeed_tpu_torch.ops import quantization as qz

    rng = np.random.default_rng(ntok)
    W = HD // 2 if bits == 4 else HD
    pdt = {8: torch.int8, 4: torch.uint8, "fp8": torch.float8_e4m3fn}[bits]
    init = torch.from_numpy(rng.integers(0, 256, (NB, BS, 2, NKV, W),
                                         dtype=np.uint8)).to(card)
    pools = [init.clone().view(pdt) for _ in range(2)]
    scales = [torch.ones((NB, BS, 2, NKV), device=card) for _ in range(2)]
    # distinct destinations for real tokens; the last 3 are padding,
    # routed to the scratch block's last row
    slots = rng.permutation((NB - 1) * BS)[:ntok]
    page = torch.from_numpy(slots // BS).to(card)
    offset = torch.from_numpy(slots % BS).to(card)
    page[-3:], offset[-3:] = NB - 1, BS - 1
    top = {8: 127, 4: 7, "fp8": 448}[bits]
    k, v = (torch.from_numpy(_quant_values(rng, ntok * NKV, HD, top)
                             .reshape(ntok, NKV, HD)).to(card, dtype)
            for _ in range(2))
    before = qz.LAUNCHES["kv_quantize_append"]
    qz.kv_quantize_append(pools[0], scales[0], page, offset, k, v, bits)
    qz.kv_quantize_append_plain(pools[1], scales[1], page, offset, k, v,
                                bits)
    torch.cuda.synchronize()
    assert qz.LAUNCHES["kv_quantize_append"] == before + 1
    assert torch.equal(pools[0].view(torch.uint8)[:-1],
                       pools[1].view(torch.uint8)[:-1])
    assert torch.equal(scales[0][:-1], scales[1][:-1])


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_dequantize_kernel_matches_plain(card, bits, out_dtype):
    from deepspeed_tpu_torch.ops import quantization as qz

    rng = np.random.default_rng(7)
    W = HD // 2 if bits == 4 else HD
    pdt = {8: torch.int8, 4: torch.uint8, "fp8": torch.float8_e4m3fn}[bits]
    codes = rng.integers(0, 256, (NB, BS, 2, NKV, W), dtype=np.uint8)
    if bits == "fp8":
        codes[(codes & 0x7F) == 0x7F] = 0  # no NaN codes
    payload = torch.from_numpy(codes).to(card).view(pdt)
    sc = torch.from_numpy(rng.random((NB, BS, 2, NKV), np.float32)).to(card)
    before = qz.LAUNCHES["dequantize"]
    scratch = torch.empty((NB, BS, 2, NKV, HD), dtype=out_dtype,
                          device=card)
    out = qz.dequantize(payload, sc, out_dtype, out=scratch)
    # a row length that is not a multiple of 4 takes the one-value path
    part = payload[..., :3 if bits == 4 else 6].contiguous()
    odd = qz.dequantize(part, sc, out_dtype)
    torch.cuda.synchronize()
    assert out is scratch
    assert qz.LAUNCHES["dequantize"] == before + 2
    assert torch.equal(out, qz.dequantize_plain(payload, sc, out_dtype))
    assert odd.shape[-1] == 6
    assert torch.equal(odd, qz.dequantize_plain(part, sc, out_dtype))


@pytest.mark.parametrize("mode", ["pool", "table"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("ntok", [16, 256])
def test_kv_append_dequantize_kernel_matches_plain(card, ntok, bits, dtype,
                                                   mode):
    """The fused append and dequantize at the decode (16 tokens) and
    prefill (256) shapes, into the whole 2048-page pool or through a
    16 x 48 block table that reads pages the step appends to, bit for
    bit its plain version (outside the scratch page, where the padding
    tokens' writes race); a second launch on the same inputs gives the
    same bits."""
    from deepspeed_tpu_torch.ops import quantization as qz

    rng = np.random.default_rng(ntok + 1)
    W = HD // 2 if bits == 4 else HD
    pdt = {8: torch.int8, 4: torch.uint8, "fp8": torch.float8_e4m3fn}[bits]
    codes = rng.integers(0, 256, (NB, BS, 2, NKV, W), dtype=np.uint8)
    if bits == "fp8":
        codes[(codes & 0x7F) == 0x7F] = 0  # no NaN codes
    init = torch.from_numpy(codes).to(card)
    init_sc = torch.from_numpy(rng.random((NB, BS, 2, NKV),
                                          np.float32)).to(card)
    slots = rng.permutation((NB - 1) * BS)[:ntok]
    page = torch.from_numpy(slots // BS).to(card)
    offset = torch.from_numpy(slots % BS).to(card)
    page[-3:], offset[-3:] = NB - 1, BS - 1
    top = {8: 127, 4: 7, "fp8": 448}[bits]
    k, v = (torch.from_numpy(_quant_values(rng, ntok * NKV, HD, top)
                             .reshape(ntok, NKV, HD)).to(card, dtype)
            for _ in range(2))
    table = None
    lead = (NB,)
    if mode == "table":
        pages = rng.permutation(NB - 1)[:16 * BM].reshape(16, BM)
        pages[:, 0] = slots[:16] // BS  # pages the step appends to
        pages[1, 1] = pages[0, 0]       # and one read twice
        table = torch.from_numpy(pages).to(card)
        lead = tuple(table.shape)
    outs, pools, scs = [], [], []
    for run in ("kernel", "again", "plain"):
        pool, sc = init.clone().view(pdt), init_sc.clone()
        out = torch.empty((*lead, BS, 2, NKV, HD), dtype=dtype, device=card)
        before = qz.LAUNCHES["kv_append_dequantize"]
        if run == "plain":
            qz.kv_append_dequantize_plain(pool, sc, page, offset, k, v,
                                          bits, out, table)
        else:
            got = qz.kv_append_dequantize(pool, sc, page, offset, k, v,
                                          bits, out, table)
            assert got is out
            assert qz.LAUNCHES["kv_append_dequantize"] == before + 1
        outs.append(out)
        pools.append(pool.view(torch.uint8))
        scs.append(sc)
    torch.cuda.synchronize()
    for i in (0, 1):
        assert torch.equal(pools[i][:-1], pools[2][:-1])
        assert torch.equal(scs[i][:-1], scs[2][:-1])
        if mode == "pool":
            assert torch.equal(outs[i][:-1], outs[2][:-1])
        else:
            assert torch.equal(outs[i], outs[2])


def test_weight_quantization_on_card_matches_cpu(card):
    from deepspeed_tpu_torch.inference.weight_quant import quantize_weight

    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.standard_normal((2, 256, 448), np.float32))
    got = quantize_weight(w.to(card, torch.bfloat16))
    want = quantize_weight(w.to(torch.bfloat16))
    assert torch.equal(got.q.cpu(), want.q)
    assert torch.equal(got.scale.cpu(), want.scale)
    assert torch.equal(got[1].to(torch.bfloat16).cpu(),
                       want[1].to(torch.bfloat16))


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
def test_quantized_engine_on_card_matches_cpu(card, bits):
    """A tiny fp32 Llama-style engine with a quantized pool (and, for
    int8, int8 weights) gives the same greedy streams on the card
    (kernels) as on the CPU (plain versions)."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import zoo

    over = dict(dtype=torch.float32, pos_emb="rope", norm="rmsnorm",
                activation="swiglu", num_kv_heads=1, ffn_size=128,
                tie_embeddings=False)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 19, 40)]
    outs = []
    for dev in ("cpu", "cuda"):
        model = zoo.get_model("tiny", device="cpu", seed=0, **over)
        model.to(dev)
        eng = InferenceEngineV2(
            model, kv_blocks=64, kv_block_size=8, max_tokens_per_step=32,
            max_seqs_per_step=4, max_blocks_per_seq=8, kv_quant_bits=bits,
            quantize_weights="int8" if bits == 8 else None, device=dev)
        eng.put([0, 1, 2], prompts, max_new_tokens=12)
        outs.append(eng.generate_all())
    assert outs[0] == outs[1]


# block-sparse forward: name -> (mode, block, S, Hq, Hkv, D, causal)
BS_CASES = {
    "fixed": ("fixed", 128, 1024, 32, 8, 128, True),
    "fixed-noncausal": ("fixed", 128, 1024, 32, 8, 128, False),
    "longformer": ("longformer", 128, 1024, 32, 8, 128, True),
    "bigbird": ("bigbird", 128, 1024, 32, 8, 128, True),
    "variable": ("variable", 128, 1024, 32, 8, 128, False),
    "dense": ("dense", 128, 1024, 32, 32, 128, True),
    "block16": ("bigbird", 16, 1024, 32, 8, 128, True),
    "block64": ("fixed", 64, 1024, 32, 8, 128, False),
    "block256": ("longformer", 256, 1024, 32, 8, 128, True),
    "ragged": ("fixed", 128, 1000, 32, 8, 128, True),
    "hd64": ("bigbird", 32, 300, 8, 2, 64, False),
}
# the largest error in an output row over that row's largest reference
# entry (_row_rel_err): causal rows that see a few columns have outputs
# near 1, rows that see hundreds near 0.05, and each row is held at its
# own scale; against the masked form (normalised probabilities rounded
# instead of p) bf16 differs at rounding level in every term
BS_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BS_MASKED_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _row_rel_err(got, want, floor=0.0):
    """The largest, over rows (the last axis), of a row's largest error
    over its largest reference entry, or over ``floor`` times the
    tensor's largest entry where that is more."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    got, want = got.float(), want.float()
    top = want.abs().amax(-1)
    top = top.clamp_min(max(floor * top.max().item(),
                            torch.finfo(torch.float32).tiny))
    return ((got - want).abs().amax(-1) / top).max().item()


def _bs_inputs(dev, dtype, S, hq, hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, S, h, D), np.float32))
            .to(dev, dtype) for h in (hq, hkv, hkv)]


def _bs_checked(bs, attn, q, k, v, cfg, causal, want_variant):
    """The kernel through the wrapper, twice: the variant that ran, the
    two launches bit-identical, each output row within the row tolerance
    of the plain version at the variant's tile and of the masked form.
    Returns the output."""
    S, D = q.shape[1], q.shape[-1]
    variants = dict(bs.VARIANT_LAUNCHES)
    got = bs.blocksparse_attention_kernel(q, k, v, cfg, causal=causal)
    again = bs.blocksparse_attention_kernel(q, k, v, cfg, causal=causal)
    torch.cuda.synchronize()
    assert {n: bs.VARIANT_LAUNCHES[n] - variants[n] for n in variants} == {
        f"blocksparse_fwd/{v}": 2 * int(v == want_variant)
        for v in ("wgmma", "simt")}
    assert torch.equal(got, again)
    tile = bs.TC_TILE if want_variant == "wgmma" else bs.TILE
    work = bs.work_list(cfg, S, causal, q.device, tile)
    want = bs.blocksparse_fwd_plain(q, k, v, work, D ** -0.5)
    assert got.dtype == q.dtype
    assert _row_rel_err(got, want) <= BS_ROW_REL[q.dtype]
    kr, vr = attn.repeat_kv_heads(q, k, v)
    masked = bs.blocksparse_attention(q, kr, vr, cfg, causal=causal)
    assert _row_rel_err(got, masked) <= BS_MASKED_ROW_REL[q.dtype]
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BS_CASES))
def test_blocksparse_kernel_matches_plain(card, dtype, case):
    from deepspeed_tpu_torch.ops import attention as attn
    from deepspeed_tpu_torch.ops import blocksparse_attention as bs

    mode, block, S, hq, hkv, D, causal = BS_CASES[case]
    q, k, v = _bs_inputs(card, dtype, S, hq, hkv, D, 21)
    cfg = bs.make_sparsity_config(mode, block=block)
    # bf16 at head dim 128 with a block multiple of 128: the tensor-core
    # kernel; the rest the scalar one
    want = ("wgmma" if dtype == torch.bfloat16 and D == 128
            and block % 128 == 0 else "simt")
    before = bs.LAUNCHES["blocksparse_fwd"]
    _bs_checked(bs, attn, q, k, v, cfg, causal, want)
    assert bs.LAUNCHES["blocksparse_fwd"] == before + 2


@pytest.mark.parametrize("view", ["head-slice", "bhsd", "main"])
def test_tensor_core_blocksparse_reads_views_and_the_main_shape(card, view):
    """The tensor-core forward reads q, k, v in place at any strides TMA
    takes (a head slice of a fused projection, a [B, H, S, D] tensor read
    as [B, S, H, D]; S 1000, a ragged tail) and runs the main path's
    shape (fixed, causal, S 8192, GQA 32/8); against the plain version
    at tile 128 and the masked form, and the scalar kernel forced on the
    same inputs against the plain version at tile 64."""
    from deepspeed_tpu_torch.ops import attention as attn
    from deepspeed_tpu_torch.ops import blocksparse_attention as bs

    rng = np.random.default_rng(25)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            card, torch.bfloat16)

    S = 8192 if view == "main" else 1000
    if view == "head-slice":
        fused = t(1, S, 48, 128)
        q, k, v = fused[:, :, :32], fused[:, :, 32:40], fused[:, :, 40:]
    elif view == "bhsd":
        q, k, v = (t(1, h, S, 128).transpose(1, 2) for h in (32, 8, 8))
    else:
        q, k, v = t(1, S, 32, 128), t(1, S, 8, 128), t(1, S, 8, 128)
    cfg = bs.FixedSparsityConfig()
    assert bs.blocksparse_variant(q, k, v, cfg) == "wgmma"
    if view == "main":
        # the masked form's fp32 scores of 32 heads at S 8192 would take
        # 8.6 GB; the plain version at tile 128 stands alone here
        variants = dict(bs.VARIANT_LAUNCHES)
        got = bs.blocksparse_attention_kernel(q, k, v, cfg)
        again = bs.blocksparse_attention_kernel(q, k, v, cfg)
        torch.cuda.synchronize()
        assert bs.VARIANT_LAUNCHES["blocksparse_fwd/wgmma"] == \
            variants["blocksparse_fwd/wgmma"] + 2
        assert torch.equal(got, again)
        want = bs.blocksparse_fwd_plain(
            q, k, v, bs.work_list(cfg, S, True, q.device, bs.TC_TILE),
            128 ** -0.5)
        assert _row_rel_err(got, want) <= BS_ROW_REL[torch.bfloat16]
        return
    _bs_checked(bs, attn, q, k, v, cfg, True, "wgmma")
    simt = bs.blocksparse_attention_kernel(q, k, v, cfg, variant="simt")
    want = bs.blocksparse_fwd_plain(q, k, v, bs.work_list(cfg, S, True,
                                                          q.device),
                                    128 ** -0.5)
    assert _row_rel_err(simt, want) <= BS_ROW_REL[torch.bfloat16]


def test_blocksparse_rule_sends_misaligned_bf16_to_simt(card):
    """bf16 q, k, v 2 bytes off a 16-byte boundary at layout block 128
    run the scalar kernel by the rule (TMA needs 16-byte aligned data);
    forcing "wgmma" there raises."""
    from deepspeed_tpu_torch.ops import attention as attn
    from deepspeed_tpu_torch.ops import blocksparse_attention as bs

    rng = np.random.default_rng(26)

    def t(*shape):
        buf = torch.empty(int(np.prod(shape)) + 1, dtype=torch.bfloat16,
                          device=card)
        x = buf[1:].view(shape)
        x.copy_(torch.from_numpy(rng.standard_normal(shape, np.float32)))
        return x

    q, k, v = t(1, 512, 8, 128), t(1, 512, 2, 128), t(1, 512, 2, 128)
    cfg = bs.FixedSparsityConfig()
    assert bs.blocksparse_variant(q, k, v, cfg) == "simt"
    _bs_checked(bs, attn, q, k, v, cfg, True, "simt")
    with pytest.raises(ValueError, match="tensor-core blocksparse"):
        bs.blocksparse_attention_kernel(q, k, v, cfg, variant="wgmma")


@pytest.mark.parametrize("block", [32, 128])
def test_blocksparse_empty_row_and_rerun_bits(card, block):
    """A layout with an empty query block row gives exactly 0 there, on
    the scalar kernel (block 32) and the tensor-core one (block 128)."""
    from deepspeed_tpu_torch.ops import blocksparse_attention as bs

    class EmptyRow(bs.SparsityConfig):
        def make_layout(self, seq_len):
            n = self.num_blocks(seq_len)
            lay = np.eye(n, dtype=bool)
            lay[:, 0] = True
            lay[3, :] = False
            return lay

    S = 16 * block
    q, k, v = _bs_inputs(card, torch.bfloat16, S, 8, 8, 128, 22)
    cfg = EmptyRow(block)
    variants = dict(bs.VARIANT_LAUNCHES)
    a = bs.blocksparse_attention_kernel(q, k, v, cfg, causal=False)
    b = bs.blocksparse_attention_kernel(q, k, v, cfg, causal=False)
    want_variant = "wgmma" if block % 128 == 0 else "simt"
    assert bs.VARIANT_LAUNCHES[f"blocksparse_fwd/{want_variant}"] == \
        variants[f"blocksparse_fwd/{want_variant}"] + 2
    assert torch.equal(a, b)
    rows = slice(3 * block, 4 * block)
    assert torch.all(a[:, rows] == 0) and a[:, :3 * block].abs().max() > 0
    tile = bs.TC_TILE if want_variant == "wgmma" else bs.TILE
    want = bs.blocksparse_fwd_plain(q, k, v, bs.work_list(
        cfg, S, False, q.device, tile), 128 ** -0.5)
    assert _row_rel_err(a, want) <= BS_ROW_REL[torch.bfloat16]


@pytest.mark.parametrize("case", ["fp32-hd64", "bf16-hd128"])
def test_blocksparse_dispatch_launches_only_without_grad(card, case):
    """Under no_grad the dispatch launches the kernel (the scalar one in
    fp32 at hd 64 and block 64, the tensor-core one in bf16 at hd 128 and
    block 128); with a gradient to record it runs the masked form and
    launches nothing."""
    from deepspeed_tpu_torch.ops import attention as attn
    from deepspeed_tpu_torch.ops import blocksparse_attention as bs

    if case == "fp32-hd64":
        dtype, D, block, variant = torch.float32, 64, 64, "simt"
    else:
        dtype, D, block, variant = torch.bfloat16, 128, 128, "wgmma"
    q, k, v = _bs_inputs(card, dtype, 512, 8, 2, D, 23)
    attn.set_sparse_config(bs.FixedSparsityConfig(block=block))
    try:
        bs.reset_launch_counts()
        with torch.no_grad():
            nog = attn.multi_head_attention(q, k, v, impl="blocksparse")
        assert bs.LAUNCHES["blocksparse_fwd"] == 1
        assert bs.VARIANT_LAUNCHES[f"blocksparse_fwd/{variant}"] == 1
        qg = q.clone().requires_grad_()
        out = attn.multi_head_attention(qg, k, v, impl="blocksparse")
        out.sum().backward()
        assert bs.LAUNCHES["blocksparse_fwd"] == 1 and qg.grad is not None
        assert sum(bs.VARIANT_LAUNCHES.values()) == 1
        assert _row_rel_err(nog, out.detach()) <= BS_MASKED_ROW_REL[dtype]
    finally:
        attn.set_sparse_config(None)


def test_blocksparse_wrapper_raises_on_what_it_cannot_take(card):
    from deepspeed_tpu_torch.ops import blocksparse_attention as bs

    cfg = bs.FixedSparsityConfig(block=64)
    q, k, v = _bs_inputs(card, torch.float32, 128, 4, 2, 64, 24)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bs.blocksparse_attention_kernel(q.half(), k.half(), v.half(), cfg)
    with pytest.raises(ValueError, match="share a device"):
        bs.blocksparse_attention_kernel(q, k.cpu(), v, cfg)
    with pytest.raises(ValueError, match="not a multiple"):
        bs.blocksparse_attention_kernel(q[:, :, :3], k, v, cfg)
    with pytest.raises(ValueError, match="head_dim"):
        bs.blocksparse_attention_kernel(q[..., :32], k[..., :32],
                                        v[..., :32], cfg)


def test_checkpoint_resume_on_the_card_is_bit_identical(card, tmp_path):
    """A 2-layer model trained on the card (bf16 on fp32 masters, GAS 2,
    the flash kernels at head dim 128 with remat), saved, resumed in a
    fresh engine from other weights: the losses equal the uninterrupted
    run's bit for bit, every flash launch on the tensor-core kernels."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.runtime import dataloader as dl

    def engine(seed):
        model = zoo.get_model("tiny", device=card, seed=seed,
                              dtype=torch.float32, hidden_size=256,
                              num_heads=2, num_kv_heads=2, max_seq_len=256,
                              attn_impl="flash", remat=True)
        return deepspeed_tpu_torch.initialize(model=model, config={
            "train_micro_batch_size_per_chip": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 4}},
            "gradient_clipping": 1.0, "steps_per_print": 10_000})[0]

    def loader():
        rng = np.random.default_rng(7)
        rows = [{"input_ids": rng.integers(0, 256, (257,)).astype(np.int32)}
                for _ in range(12)]
        return dl.RepeatingLoader(dl.DeepSpeedDataLoader(
            rows, batch_size=2, shuffle=True, seed=7))

    eng = engine(0)
    it = loader()
    got = [float(eng.train_batch(it)) for _ in range(2)]
    eng.save_checkpoint(str(tmp_path))
    ref = got + [float(eng.train_batch(it)) for _ in range(3)]
    del eng, it
    eng = engine(1)
    eng.load_checkpoint(str(tmp_path))
    src = loader()
    it = eng.resume_data_iter(src, source=src)
    fa.reset_launch_counts()
    got += [float(eng.train_batch(it)) for _ in range(3)]
    assert got == ref
    # 2 layers x GAS 2 x 3 steps: forward and its remat replay, dK/dV, dQ
    assert fa.LAUNCHES == {"flash_fwd": 24, "flash_bwd_dkdv": 12,
                           "flash_bwd_dq": 12}
    assert {k: v for k, v in fa.VARIANT_LAUNCHES.items() if v} == {
        "flash_fwd/wgmma": 24, "flash_bwd_dkdv/wgmma": 12,
        "flash_bwd_dq/wgmma": 12}


def test_offload_tiers_on_the_card(card, tmp_path):
    """A 2-layer model (hd 128, flash with remat) trained on the card with
    the optimizer on the host: the cpu and nvme tiers give the same
    losses, masters and params bit for bit, within 3e-3 of the device
    optimizer (JAX's tolerance, tests/test_offload.py:236); the native
    library is required and in use; offload_states frees the card bytes
    and reload_states brings them back unchanged."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.ops.native import builder
    from deepspeed_tpu_torch.runtime.optimizer import leaves

    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (2, 257)).astype(np.int32)}
               for _ in range(2)]

    def run(off):
        model = zoo.get_model("tiny", device=card, seed=0,
                              dtype=torch.float32, hidden_size=256,
                              num_heads=2, num_kv_heads=2, max_seq_len=256,
                              attn_impl="flash", remat=True)
        eng = deepspeed_tpu_torch.initialize(model=model, config={
            "train_micro_batch_size_per_chip": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "gradient_clipping": 1.0, "steps_per_print": 10_000,
            "zero_optimization": {"stage": 3, "offload_optimizer": off}})[0]
        losses = [float(eng.train_batch(iter([batches[i % 2]])))
                  for i in range(4)]
        return eng, losses

    dev, want = run({"device": "none"})
    sums = {p: t.clone() for p, t in leaves(dev.params)}
    mu = dev.opt_state.mu["layers"]["attn"]["wq"].clone()
    before = torch.cuda.memory_allocated()
    dev.offload_states()
    assert before - torch.cuda.memory_allocated() > 0
    dev.reload_states()
    assert all(torch.equal(sums[p], t) for p, t in leaves(dev.params))
    assert torch.equal(mu, dev.opt_state.mu["layers"]["attn"]["wq"])
    del dev
    cpu, got = run({"device": "cpu", "pin_memory": True})
    assert builder.native_status() == "built"
    assert cpu._offload.last_step_s["d2h_copy"] > 0
    nvme, got_nvme = run({"device": "nvme", "nvme_path": str(tmp_path),
                          "pin_memory": True})
    assert got == got_nvme
    np.testing.assert_allclose(got, want, rtol=3e-3)
    for p in cpu._offload.optimizers:
        assert torch.equal(cpu._offload.full_fp32_param(p),
                           nvme._offload.full_fp32_param(p))
    for (_, a), (_, b) in zip(leaves(cpu.params), leaves(nvme.params)):
        assert a.is_cuda and torch.equal(a, b)
    nvme._offload.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("overlap", [True, False])
def test_zenflow_on_the_card_follows_the_cpu(card, dtype, overlap):
    """ZenFlow's ship and fold through the pinned staging buffers and the
    side stream, in chunks of 1000 elements (many chunks a leaf, every
    buffer reused): the same selections as on the CPU at every step (the
    accumulators add the same grads exactly), and params and masters
    within rtol 1e-6 (the card's pow may round the bias corrections one
    ulp apart; a bf16 param may then round one bf16 step apart)."""
    from deepspeed_tpu_torch.runtime import zenflow as zf

    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((64, 80)).astype(np.float32),
            "b": rng.standard_normal(2500).astype(np.float32),
            "c": rng.standard_normal((3, 16, 16)).astype(np.float32)}
    cfg = zf.ZenFlowConfig(topk_ratio=0.05, update_interval=2,
                           select_interval=3, overlap_step=overlap)
    runs = {}
    for device in (card, "cpu"):
        opt = zf.ZenFlowOptimizer(
            {k: torch.from_numpy(v).to(device) for k, v in tree.items()},
            cfg, lr=1e-2, chunk_elems=1000)
        p = {k: torch.from_numpy(v).to(device, dtype)
             for k, v in tree.items()}
        sel = []
        for s in range(9):
            g = {k: torch.from_numpy(np.random.default_rng(100 + s)
                                     .standard_normal(v.shape)
                                     .astype(np.float32)).to(device, dtype)
                 for k, v in tree.items()}
            opt.step(g, p)
            sel.append([i.cpu() for i in opt._idx])
        opt.finalize()
        runs[str(device)] = (p, sel, [m.clone() for m in opt._masters],
                             dict(opt.counts))
        opt.close()
    (pc, sc, mc, cc), (pp, sp, mp, cp) = runs[str(card)], runs["cpu"]
    assert cc == cp and cc["folds"] >= 3
    for a, b in zip(sc, sp):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    rtol = 1e-6 if dtype == torch.float32 else 2 ** -7
    for k in tree:
        torch.testing.assert_close(pc[k].cpu(), pp[k], rtol=rtol, atol=1e-7)
    for x, y in zip(mc, mp):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


def test_c5_flash_raises_and_auto_is_dense(card):
    """ROADMAP C5: on CUDA tensors of head dim 16 (the drafter's
    shape) ``impl="flash"`` raises before any launch and ``impl="auto"``
    computes the dense path, launching no flash kernel."""
    from deepspeed_tpu_torch.ops import attention as at
    from deepspeed_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 64, 2, 16)).astype(np.float32)).to(card, torch.bfloat16)
        for _ in range(3))
    with pytest.raises(ValueError, match="head_dim"):
        at.multi_head_attention(q, k, v, impl="flash")
    before = dict(fa.LAUNCHES)
    got = at.multi_head_attention(q, k, v, impl="auto")
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before
    assert torch.equal(got, at.xla_attention(q, k, v))


# -- the measured dispatch and the v1 engine on the card ------------------------


@pytest.fixture
def table(tmp_path, monkeypatch):
    """A scratch kernel table that both the bench and the dispatch read;
    the installed kernels config cleared."""
    from deepspeed_tpu_torch.ops import attention as at
    from deepspeed_tpu_torch.ops import kernel_table

    path = tmp_path / "kernel_table.json"
    monkeypatch.setenv("DSTPU_KERNEL_TABLE", str(path))
    monkeypatch.setenv("KERNEL_BENCH_RECORD_PATH", str(path))
    at.set_kernel_config(None)
    kernel_table.invalidate_cache()
    yield path
    kernel_table.invalidate_cache()


def test_kernel_bench_writes_cuda_rows_named_by_the_card(card, table,
                                                         monkeypatch):
    """The bench's small tier on the card: every arm's kernels launch,
    its gates pass, and each row is a "cuda" row naming this card."""
    from deepspeed_tpu_torch.tools import kernel_bench as kb

    monkeypatch.setenv("KERNEL_BENCH_FULL", "0")
    monkeypatch.setenv("KERNEL_BENCH_ITERS", "2")
    _, payload, ok = kb.run_kernel_bench()
    assert ok, payload["violations"]
    assert payload["backend"] == "cuda"
    name = torch.cuda.get_device_name()
    assert payload["device"] == name
    doc = __import__("json").loads(table.read_text())
    rows = [e for b in doc["entries"].values() for e in b.values()]
    assert len(rows) == 4
    assert all(e["backend"] == "cuda" and e["device"] == name for e in rows)
    for r in payload["entries"]:
        assert r["numerics_ok"] and r["row_rel_err"]["out"] <= 3e-2, r
        assert r["launches"] and min(r["launches"].values()) > 0, r
        assert r["blocks"]["template"] in ("wgmma", "simt", "split",
                                           "wgmma+simt")


@pytest.mark.parametrize("ratio", [0.5, 2.0])
def test_planted_row_routes_on_the_card(card, table, ratio):
    """A losing cuda row for this card routes impl="auto" to
    xla_attention bit for bit with no flash launch, and is counted as a
    loss on the card (the smoke's main paths allow none); a winning one
    launches the flash kernel."""
    from deepspeed_tpu_torch.ops import attention as at
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import kernel_table

    kernel_table.record("flash_attention", "s512_d128_causal", 1.0, ratio,
                        path=str(table))
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 500, 8, 128), np.float32)
                         ).to(card, torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((1, 500, 2, 128),
                                                 np.float32)
                             ).to(card, torch.bfloat16) for _ in range(2))
    before, stats = dict(fa.LAUNCHES), at.dispatch_stats()
    got = at.multi_head_attention(q, k, v, impl="auto")
    torch.cuda.synchronize()
    assert at.dispatch_stats()["card_losses"] - stats["card_losses"] == (
        1 if ratio < 1.0 else 0)
    if ratio < 1.0:
        assert fa.LAUNCHES == before
        assert torch.equal(got, at.xla_attention(q, k, v))
    else:
        assert fa.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
        assert torch.equal(got, fa.flash_attention(q, k, v))


def test_failing_probe_on_a_cuda_tensor_raises(card, table, monkeypatch):
    from deepspeed_tpu_torch.ops import attention as at
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import registry

    monkeypatch.setattr(registry, "_card_status",
                        lambda: (False, "nvcc not found (test)"))
    q = torch.zeros((1, 64, 4, 128), device=card, dtype=torch.bfloat16)
    before = dict(fa.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        at.multi_head_attention(q, q, q, impl="auto")
    assert fa.LAUNCHES == before


def test_v1_generate_on_the_card_follows_the_cpu(card):
    """A small fp32 Llama-style v1 engine (head dim 64) generates on the
    card what it generates on the CPU, or parts only at a near tie: the
    CPU row's gap between the two chosen tokens no larger than the
    max-abs difference between the two rows."""
    from deepspeed_tpu_torch.inference import engine as eng_mod
    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                    params_to_numpy)

    over = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
                hidden_size=256, num_heads=4, num_kv_heads=2, ffn_size=512,
                tie_embeddings=False, num_layers=2)
    cpu_model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                              seed=3, **over)
    card_model = params_from_jax(params_to_numpy(cpu_model.params()),
                                 cpu_model.config, device=card)
    prompt = np.random.default_rng(2).integers(1, 256, (2, 20)).astype(
        np.int32)
    runs = {}
    real = eng_mod._sample
    for name, model in (("cpu", cpu_model), ("card", card_model)):
        rows = []

        def spy(logits, temperature, top_k, generator=None, rows=rows):
            rows.append(logits.float().cpu())
            return real(logits, temperature, top_k, generator)

        eng_mod._sample = spy
        try:
            eng = init_inference(model, dtype=torch.float32, max_seq_len=64)
            runs[name] = (eng.generate(prompt, max_new_tokens=12), rows)
        finally:
            eng_mod._sample = real
    (cpu_out, cpu_rows), (card_out, card_rows) = runs["cpu"], runs["card"]
    for b in range(2):
        a, c = cpu_out[b, 20:].tolist(), card_out[b, 20:].tolist()
        if a == c:
            continue
        p = next(i for i, (x, y) in enumerate(zip(a, c)) if x != y)
        gap = float(cpu_rows[p][b, a[p]] - cpu_rows[p][b, c[p]])
        diff = float((cpu_rows[p][b] - card_rows[p][b]).abs().max())
        assert gap <= diff, (b, p, gap, diff)


@pytest.mark.parametrize("api", ["micro", "blocking", "pipelined"])
def test_logged_loss_is_the_step_loss_on_the_card(card, api):
    """The loss and grad norm a step logs and sends to the monitor are the
    step's own, in every loop, while the stream is still busy when the
    host reads them: a post-step hook queues a ~0.1 s device sleep ahead
    of the loss's pinned copy."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import zoo

    model = zoo.get_model("tiny", device=card, seed=0, dtype=torch.float32,
                          attn_impl="xla")
    eng = deepspeed_tpu_torch.initialize(model=model, config={
        "train_micro_batch_size_per_chip": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "bf16": {"enabled": False}, "steps_per_print": 1,
        "performance": {"pipeline_depth": 2 if api == "pipelined" else 0}
    })[0]
    seen = []
    eng._monitor_events = lambda events: seen.extend(
        v for name, v, _ in events if name == "Train/Samples/train_loss")
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 64, (2, 17)).astype(np.int32)}
               for _ in range(6)]
    losses = []
    if api == "micro":
        eng.register_post_step_hook(lambda e: torch.cuda._sleep(1 << 28))
        for i in range(3):
            for b in batches[2 * i:2 * i + 2]:
                eng.backward(eng(b))
                eng.step()
            losses.append(float(eng.last_metrics["loss"]))
    else:
        # a post-step hook forces the blocking loop; the sleep goes into
        # the model's loss instead
        real = eng._model_loss

        def slow_loss(mb):
            torch.cuda._sleep(1 << 27)
            return real(mb)

        eng._model_loss = slow_loss
        it = iter(batches)
        out = [eng.train_batch(it) for _ in range(3)]
        eng.synchronize()
        losses = [float(x) for x in out]
    assert seen == losses


# -- A11's one-card parts ----------------------------------------------------


@pytest.mark.parametrize("policy", ["dots_saveable", "save_qkv_attn_out",
                                    "save_attn_mlp", "offload_dots_host",
                                    "none"])
def test_checkpoint_policies_are_bit_equal_on_the_card(card, policy):
    """One bf16 layer at hd 128 through the flash kernels: every policy's
    loss and gradients equal nothing_saveable's bit for bit, and the flash
    forward launches again in the recompute only where the policy does
    not keep its output."""
    import dataclasses

    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.runtime.optimizer import leaves

    model = zoo.get_model("llama3-8b", device=card, seed=0,
                          dtype=torch.bfloat16, num_layers=1,
                          hidden_size=1024, num_heads=8, num_kv_heads=2,
                          ffn_size=2048, vocab_size=4096)
    batch = {"input_ids": torch.randint(
        0, 4096, (2, 513), device=card,
        generator=torch.Generator(card).manual_seed(0))}

    def run(name):
        cfg = dataclasses.replace(model.config, remat_policy=name)
        params = {k: v for k, v in model.params().items()}
        flat = [t for _, t in leaves(params)]
        for t in flat:
            t.requires_grad_()
            t.grad = None
        fa.reset_launch_counts()
        loss, _ = tf.loss_fn(cfg, params, batch)
        loss.backward()
        torch.cuda.synchronize()
        return (loss.item(), [t.grad.clone() for t in flat],
                fa.LAUNCHES["flash_fwd"])

    ref = run("nothing_saveable")
    got = run(policy)
    assert got[0] == ref[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    assert ref[2] == 2
    assert got[2] == (1 if policy in ("save_qkv_attn_out", "save_attn_mlp",
                                      "none") else 2)


@pytest.mark.parametrize("depth", [1, 2])
def test_streamed_layer_fetches_on_the_copy_stream(card, depth):
    """The prefetch streamer on the card at ``depth`` layers in flight:
    each layer fetched from pinned host memory on the copy stream (twice
    a step), its gradients landed in the stack's pinned fp32 host buffer,
    equal to the plain loop's."""
    from deepspeed_tpu_torch.runtime import param_stream as ps
    from deepspeed_tpu_torch.utils import memspace

    L, H = 4, 256
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(L, H, H, generator=g) / 16).to(torch.bfloat16)
    stack = {"w": w.pin_memory().requires_grad_()}
    x0 = torch.randn(8, H, generator=g).to(card, torch.bfloat16)

    def layer(x, p):
        return torch.tanh(x @ p["w"])

    assert memspace.is_on_host(stack["w"])
    ps.reset_fetch_stats()
    x = x0.clone().requires_grad_()
    y = ps.streamed_layers_prefetch(layer, stack, x, prefetch_depth=depth)
    (y.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert ps.FETCH_STATS["layers"] == 2 * L
    got = ps.host_grad(stack["w"])
    assert got.dtype == torch.float32 and got.is_pinned()
    ref_w = w.to(card).requires_grad_()
    xr0 = x0.clone().requires_grad_()
    xr = xr0
    for i in range(L):
        xr = layer(xr, {"w": ref_w[i]})
    (xr.float() ** 2).sum().backward()
    assert torch.equal(y, xr)
    assert torch.equal(got, ref_w.grad.float().cpu())
    assert torch.equal(x.grad, xr0.grad)


def test_host_kv_tile_ring_on_the_card(card):
    """The host-KV block at S 2048, 8 chunks, GQA 32/8, hd 128, bf16: its
    K/V tiles go to pinned host memory and stream back on the copy
    stream; its output matches the dense path on the same weights at
    bf16 row error 3e-2 (ROADMAP C's masked-form limit: both round the
    scores to bf16), its gradients by phase 4's cosine of 0.99 (the
    dense path also rounds the probabilities to bf16)."""
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops.attention import xla_attention
    from deepspeed_tpu_torch.parallel import fpdt
    from deepspeed_tpu_torch.utils import memspace

    S, Hd, N, Nkv, D = 2048, 1024, 32, 8, 128
    g = torch.Generator(card).manual_seed(0)

    def rnd(*shape, scale=0.05):
        return (torch.randn(shape, generator=g, device=card) * scale).to(
            torch.bfloat16).requires_grad_()

    y = rnd(1, S, Hd, scale=1.0)
    ap = {"wq": rnd(Hd, N, D), "wk": rnd(Hd, Nkv, D), "wv": rnd(Hd, Nkv, D),
          "wo": rnd(N, D, Hd)}
    rope = tf.rope_tables(torch.arange(S, device=card)[None], D, 500000.0)
    memspace.reset_transfer_stats()
    out = fpdt.fpdt_attention_block(y, ap, rope, num_heads=N, kv_heads=Nkv,
                                    head_dim=D, q_chunks=8)
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert memspace.TRANSFER_STATS["to_host_bytes"] > 0
    got = [out.detach()] + [t.grad.clone() for t in [y, *ap.values()]]
    for t in [y, *ap.values()]:
        t.grad = None
    q = tf.apply_rope(tf._proj(y, ap["wq"]), *rope)
    k = tf.apply_rope(tf._proj(y, ap["wk"]), *rope)
    v = tf._proj(y, ap["wv"])
    ref = xla_attention(q, k, v, causal=True).reshape(1, S, -1) @ \
        ap["wo"].reshape(-1, Hd)
    (ref.float() ** 2).sum().backward()
    want = [ref.detach()] + [t.grad for t in [y, *ap.values()]]
    assert _row_rel_err(got[0], want[0], 1e-4) <= 3e-2
    for a, b in zip(got[1:], want[1:]):
        a, b = a.float(), b.float()
        assert torch.sum(a * b) / (a.norm() * b.norm()) >= 0.99


# -- ZeRO++'s quantized collectives and the fp8 product ----------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_collectives_one_rank_nccl_equal_their_cpu_twins(card,
                                                                   bits,
                                                                   tmp_path):
    """On a one-rank NCCL group the quantized gather, scatter and
    all-reduce launch B6 and 6b and give their CPU twins' bits (the
    same bodies on CPU tensors without a group: quantize, dequantize)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import quantization as qz
    from deepspeed_tpu_torch.parallel import topology

    x = torch.randn(64, 512, generator=torch.Generator().manual_seed(1))
    cpu = {"gather": qz.quantized_all_gather(x, "dp", bits, 128),
           "scatter": qz.quantized_psum_scatter(x, "dp", bits, 128),
           "all_reduce": qz.quantized_all_reduce(x, "dp", bits, 128)}
    comm.init_distributed(dist_backend="nccl",
                          init_method=f"file://{tmp_path}/store",
                          num_processes=1, process_id=0, device=card)
    try:
        topology.set_global_mesh(topology.build_mesh({"dp": 1}))
        qz.reset_launch_counts()
        xc = x.to(card)
        got = {"gather": qz.quantized_all_gather(xc, "dp", bits, 128),
               "scatter": qz.quantized_psum_scatter(xc, "dp", bits, 128),
               "all_reduce": qz.quantized_all_reduce(xc, "dp", bits, 128)}
        torch.cuda.synchronize()
        # one quantize and one dequantize a hop; qar has two hops
        assert qz.LAUNCHES["quantize_blockwise"] == 4
        assert qz.LAUNCHES["dequantize"] == 4
    finally:
        comm.destroy()
    for name, want in cpu.items():
        assert torch.equal(got[name].cpu(), want), name


def test_fp8_matmul_on_the_card_within_its_bound(card):
    """``torch._scaled_mm`` on e4m3 operands against the fp32 product of
    the same fp8 values: each fp8 x fp8 term is exact in fp32, so the two
    part only by the accumulation over K = 4096 terms in another order,
    at most K x 2^-24 of the largest |a| |b| sum."""
    from deepspeed_tpu_torch.ops import fp_quantizer as fpq

    g = torch.Generator(card).manual_seed(0)
    a = torch.randn(256, 4096, generator=g, device=card).to(torch.bfloat16)
    b = (torch.randn(4096, 512, generator=g, device=card) * 0.02).to(
        torch.bfloat16)
    fpq.reset_launch_counts()
    got = fpq.fp8_matmul(a, b, out_dtype=torch.float32)
    assert fpq.FP8_LAUNCHES["fp8_matmul"] == 1
    sa, sb = fpq._tensor_scale(a, "e4m3"), fpq._tensor_scale(b, "e4m3")
    qa = (a.float() / sa).to(torch.float8_e4m3fn).float()
    qb = (b.float() / sb).to(torch.float8_e4m3fn).float()
    want = (qa @ qb) * (sa * sb)
    mag = (qa.abs() @ qb.abs()) * (sa * sb)
    assert float(((got - want).abs() / mag.amax()).max()) <= 4096 * 2 ** -24
