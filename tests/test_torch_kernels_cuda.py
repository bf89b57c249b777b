"""The hand-written CUDA paged attention kernels against their plain
PyTorch versions, on the card, at Llama-3-8B attention shapes (nh 32,
nkv 8, hd 128, block size 16), with shuffled block tables, ragged
context lengths including 0, and a dead prefill segment.

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
