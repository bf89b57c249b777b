#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``deepspeed_tpu_torch``).

Run from the repository root on a machine with one sm_90 card and nvcc:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   — compile every hand-written CUDA kernel from the sources in
               the checkout (``ops/build.py``), print the build seconds;
  2. kernels — run each kernel at Llama-3-8B attention shapes (nh 32,
               nkv 8, hd 128, block size 16; shuffled block tables,
               ragged contexts including 0, prefill Tq 16 and 128 with a
               dead segment), hold it against its plain PyTorch version
               in fp32 and bf16, and time kernel, plain version and a
               PyTorch library yardstick with CUDA events;
  2b. flash  — the three flash attention kernels against their plain
               versions at B 2, S 2048, 32/8 heads, hd 128, causal (fp32
               and bf16), a non-causal S 1000 case with three segments
               and an hd 64 case; the backward must be bit-identical
               across two launches; kernel, plain version and SDPA (a
               yardstick the port never calls) timed with CUDA events.
  3. serve   — ``InferenceEngineV2`` over ``get_model("llama3-8b")`` at
               full width and depth with seeded bf16 weights: 8 requests
               (64-512 prompt tokens, two sharing a 256-token prefix),
               64 new tokens each, through ``put`` and ``generate_all``.
               The kernels' launch counts are read around this run. A
               second engine from the same seed must give identical
               streams, and the paged prefill path must agree with the
               plain gather path on one prefill batch. A third run of
               the same workload under torch.profiler gives the device
               time by kernel family and the device's idle share.
  4. train   — ``deepspeed_tpu_torch.initialize`` + ``train_batch`` on
               Llama-3-8B at full width, 8 of its 32 layers (fp32
               masters from a seed, bf16 compute, AdamW, ZeRO-3 config,
               clip 1.0), micro 2 x GAS 2 x 2048 tokens over two fixed
               batches: one warm-up and four measured steps with the
               flash launch counts read around them; loss and wq
               gradient through the flash path against the dense path
               on one microbatch; one more step under torch.profiler.
Then it prints the kernels line, the serve, profile, train and train
profile lines, the card's name and power limit (nvidia-smi), and, last,
the device line.

Exits non-zero with no result when there is no CUDA device or when the
package is not beside it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain tolerances (max-abs). fp32: both sum in fp32 in
# different orders. bf16: both round an fp32 result to bf16 once;
# outputs are convex mixes of unit-normal V rows (|out| up to ~4), where
# one bf16 step is 2**-6 = 0.0156.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# kernel-path vs gather-path last-row logits (bf16, 32 layers): the
# gather path rounds scores and probabilities to bf16 where the kernel
# keeps fp32, a ~2**-8 relative difference per layer in the attention
# output that the residual stream carries to the logits
LOGIT_TOL_REL = 0.05

# flash gradients vs their plain versions, as a share of the largest
# reference gradient: fp32 sums over 2048 rows in another order; bf16 p
# and ds round to bf16 in both, and a rounding on the other side of a
# tie moves one term by 2**-8
GRAD_TOL_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# train: flash path (fp32 softmax) vs dense path (scores rounded to bf16,
# as in LOGIT_TOL_REL) on one microbatch through 8 bf16 layers
TRAIN_LOSS_TOL_REL, TRAIN_GRAD_COS_MIN = 2e-2, 0.99

NH, NKV, HD, BS = 32, 8, 128, 16
KV_BLOCKS, MAX_BLOCKS, MAX_SEQS, MAX_TOKENS = 2048, 48, 16, 256
NEW_TOKENS, DECODE_STEPS, SEED = 64, 8, 0
FLASH_CASES = {  # B, S, Hq, Hkv, D, causal, segment lengths
    "smoke": (2, 2048, 32, 8, 128, True, None),
    "odd": (1, 1000, 4, 4, 128, False, (400, 350, 250)),
    "hd64": (2, 300, 8, 2, 64, True, None),
}
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_MICRO, TRAIN_GAS, TRAIN_MEASURED = \
    8, 2048, 2, 2, 4
TRAIN_CONFIG = {
    "train_micro_batch_size_per_chip": TRAIN_MICRO,
    "gradient_accumulation_steps": TRAIN_GAS,
    "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
    "bf16": {"enabled": True}, "zero_optimization": {"stage": 3},
    "gradient_clipping": 1.0,
}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


def card_identity():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


# -- timing ------------------------------------------------------------------


class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch (the main path finds every layer's pool cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- phase 2: kernels ----------------------------------------------------------


def make_pool(torch, rng, dtype, S):
    kv = torch.from_numpy(rng.standard_normal(
        (KV_BLOCKS, BS, 2, NKV, HD), np.float32)).to("cuda", dtype)
    bt = torch.from_numpy(rng.permutation(KV_BLOCKS - 1)[:S * MAX_BLOCKS]
                          .reshape(S, MAX_BLOCKS).astype(np.int32)).cuda()
    return kv, bt


def dense_kv(torch, kv, bt, lmax):
    """Each slot's pages gathered dense, heads expanded to NH:
    K, V [S, NH, lmax, HD] (the library yardstick's input)."""
    S = bt.shape[0]
    g = kv[bt.long()].reshape(S, -1, 2, NKV, HD)[:, :lmax]
    k = g[:, :, 0].permute(0, 2, 1, 3).repeat_interleave(NH // NKV, dim=1)
    v = g[:, :, 1].permute(0, 2, 1, 3).repeat_interleave(NH // NKV, dim=1)
    return k.contiguous(), v.contiguous()


def check_decode(torch, pa, timer, dtype, S=MAX_SEQS):
    import torch.nn.functional as F

    rng = np.random.default_rng(10)
    kv, bt = make_pool(torch, rng, dtype, S)
    ctx_np = rng.integers(1, MAX_BLOCKS * BS + 1, S).astype(np.int32)
    ctx_np[3] = 0                      # dead slot
    ctx_np[5] = MAX_BLOCKS * BS        # every page of the row
    ctx = torch.from_numpy(ctx_np).cuda()
    q = torch.from_numpy(rng.standard_normal((S, NH, HD), np.float32)).to(
        "cuda", dtype)
    scale = HD ** -0.5
    out = pa.paged_decode_attention(q, kv, bt, ctx)
    ref = pa.paged_decode_attention_plain(q, kv, bt, ctx, scale)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all() or not torch.all(out[3] == 0):
        fail(f"paged_decode {dtype}: non-finite output or live dead slot")
    err = (out.float() - ref.float()).abs().max().item()
    name = str(dtype).split(".")[-1]
    if err > TOL[name]:
        fail(f"paged_decode {name}: max-abs {err} > {TOL[name]}")
    res = {"max_abs_err": err}
    if dtype == torch.bfloat16:
        itm = q.element_size()
        sum_ctx = int(ctx_np.sum())
        nbytes = (2 * q.numel() * itm + sum_ctx * 2 * NKV * HD * itm
                  + bt.numel() * 4 + S * 4)
        flops = 4 * NH * HD * sum_ctx
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, name)
        res["ms"] = timer.ms(lambda: pa.paged_decode_attention(
            q, kv, bt, ctx))
        res["plain_ms"] = timer.ms(lambda: pa.paged_decode_attention_plain(
            q, kv, bt, ctx, scale), iters=3, warmup=1)
        lmax = int(ctx_np.max())
        k, v = dense_kv(torch, kv, bt, lmax)
        mask = (torch.arange(lmax, device="cuda")[None, :]
                < ctx[:, None])[:, None, None, :]
        res["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask))
        res["shape"] = {"S": S, "sum_ctx": sum_ctx, "max_pages": MAX_BLOCKS}
    return res


def check_prefill(torch, pa, timer, dtype, tq, S):
    import torch.nn.functional as F

    rng = np.random.default_rng(20 + tq)
    kv, bt = make_pool(torch, rng, dtype, S)
    pos0_np = rng.integers(0, MAX_BLOCKS * BS - tq, S).astype(np.int32)
    nreal = np.full(S, tq, np.int32)
    nreal[-1] = max(1, tq - 5)         # padded rows
    pos0_np[1], nreal[1] = 0, 0        # dead segment
    ctx_np = pos0_np + nreal
    pos0 = torch.from_numpy(pos0_np).cuda()
    ctx = torch.from_numpy(ctx_np).cuda()
    q = torch.from_numpy(rng.standard_normal((S, tq, NH, HD),
                                             np.float32)).to("cuda", dtype)
    scale = HD ** -0.5
    out = pa.paged_prefill_attention(q, kv, bt, pos0, ctx)
    ref = pa.paged_prefill_attention_plain(q, kv, bt, pos0, ctx, scale)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all() or not torch.all(out[1] == 0):
        fail(f"paged_prefill {dtype} tq={tq}: non-finite or live dead seg")
    err = (out.float() - ref.float()).abs().max().item()
    name = str(dtype).split(".")[-1]
    if err > TOL[name]:
        fail(f"paged_prefill {name} tq={tq}: max-abs {err} > {TOL[name]}")
    res = {"max_abs_err": err}
    if dtype == torch.bfloat16:
        itm = q.element_size()
        qi = np.arange(tq)[None, :]
        vis = np.clip(np.minimum(pos0_np[:, None] + qi + 1,
                                 ctx_np[:, None]), 0, None)
        vis[ctx_np == 0] = 0
        nbytes = (2 * q.numel() * itm + int(ctx_np.sum()) * 2 * NKV * HD
                  * itm + bt.numel() * 4 + 2 * S * 4)
        flops = 4 * NH * HD * int(vis.sum())
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, name)
        res["ms"] = timer.ms(lambda: pa.paged_prefill_attention(
            q, kv, bt, pos0, ctx))
        res["plain_ms"] = timer.ms(lambda: pa.paged_prefill_attention_plain(
            q, kv, bt, pos0, ctx, scale), iters=3, warmup=1)
        lmax = int(ctx_np.max())
        k, v = dense_kv(torch, kv, bt, lmax)
        cols = torch.arange(lmax, device="cuda")
        qpos = pos0[:, None] + torch.arange(tq, device="cuda")[None, :]
        mask = ((cols[None, None, :] <= qpos[:, :, None])
                & (cols[None, None, :] < ctx[:, None, None]))[:, None]
        qt = q.transpose(1, 2).contiguous()
        res["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask))
        res["shape"] = {"S": S, "tq": tq, "sum_ctx": int(ctx_np.sum()),
                        "visible_cols": int(vis.sum())}
    return res


# -- phase 2b: flash kernels ---------------------------------------------------


def flash_inputs(torch, dtype, case, seed):
    B, S, hq, hkv, D, causal, lens = FLASH_CASES[case]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            "cuda", dtype)

    q, k, v, do = t(B, S, hq, D), t(B, S, hkv, D), t(B, S, hkv, D), \
        t(B, S, hq, D)
    seg = None
    if lens is not None:
        seg = torch.from_numpy(np.repeat(np.arange(len(lens)), lens)[None]
                               .repeat(B, 0).astype(np.int32)).cuda()
    return q, k, v, do, seg, causal, D ** -0.5


def visible_pairs(case):
    """(query row, key column) pairs the mask lets through, over every
    batch row and q head: the work the kernels' data needs."""
    B, S, hq, _, _, causal, lens = FLASH_CASES[case]
    if lens is None:
        per = S * (S + 1) // 2 if causal else S * S
    else:
        per = sum(n * (n + 1) // 2 if causal else n * n for n in lens)
    return B * hq * per


def check_flash(torch, fa, timer, dtype, case):
    """The three kernels against their plain versions on the same
    inputs; the backward twice, bit for bit; bf16 at the smoke shape
    also timed against its bound, its plain version and SDPA."""
    import torch.nn.functional as F

    q, k, v, do, seg, causal, scale = flash_inputs(torch, dtype, case, 30)
    name = str(dtype).split(".")[-1]
    o, lse = fa._flash_fwd(q, k, v, seg, causal, scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, seg, lse, delta, do, causal, scale)
    dk, dv = fa.flash_bwd_dkdv(*args)
    dq = fa.flash_bwd_dq(*args)
    dk2, dv2 = fa.flash_bwd_dkdv(*args)
    dq2 = fa.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
            and torch.equal(dv, dv2)):
        fail(f"flash backward {name} {case}: two launches differ")
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, seg, causal, scale)
    dk_ref, dv_ref = fa.flash_bwd_dkdv_plain(*args)
    dq_ref = fa.flash_bwd_dq_plain(*args)
    res = {}

    def err(got, want, rel):
        if not torch.isfinite(got).all():
            fail(f"flash {name} {case}: non-finite output")
        e = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        return {"max_abs_err": e, "max_rel_err": e / top if rel else None}

    res["flash_fwd"] = err(o, o_ref, False)
    res["flash_fwd"]["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
    if res["flash_fwd"]["max_abs_err"] > TOL[name] or \
            res["flash_fwd"]["lse_max_abs_err"] > 1e-4:
        fail(f"flash_fwd {name} {case}: {res['flash_fwd']} over "
             f"{TOL[name]} (lse 1e-4)")
    ek, ev = err(dk, dk_ref, True), err(dv, dv_ref, True)
    res["flash_bwd_dkdv"] = {
        "max_abs_err": max(ek["max_abs_err"], ev["max_abs_err"]),
        "max_rel_err": max(ek["max_rel_err"], ev["max_rel_err"])}
    res["flash_bwd_dq"] = err(dq, dq_ref, True)
    for kern in ("flash_bwd_dkdv", "flash_bwd_dq"):
        if res[kern]["max_rel_err"] > GRAD_TOL_REL[name]:
            fail(f"{kern} {name} {case}: {res[kern]} over "
                 f"{GRAD_TOL_REL[name]} of the largest gradient")
    if not (dtype == torch.bfloat16 and case == "smoke"):
        return res

    B, S, hq, hkv, D, _, _ = FLASH_CASES[case]
    itm, pairs = q.element_size(), visible_pairs(case)
    rows_q, rows_kv, stats = B * S * hq * D * itm, B * S * hkv * D * itm, \
        B * hq * S * 4
    work = {  # bytes each input read once and each output written once
        "flash_fwd": (2 * rows_q + 2 * rows_kv + stats, 4 * D * pairs),
        "flash_bwd_dkdv": (2 * rows_q + 4 * rows_kv + 2 * stats,
                           8 * D * pairs),
        "flash_bwd_dq": (3 * rows_q + 2 * rows_kv + 2 * stats,
                         6 * D * pairs),
    }
    for kern, (nbytes, flops) in work.items():
        res[kern]["bound_ms"], res[kern]["bound_by"] = bound(nbytes, flops,
                                                             name)
        res[kern]["flops"] = flops
    res["flash_fwd"]["ms"] = timer.ms(
        lambda: fa._flash_fwd(q, k, v, seg, causal, scale))
    res["flash_bwd_dkdv"]["ms"] = timer.ms(lambda: fa.flash_bwd_dkdv(*args))
    res["flash_bwd_dq"]["ms"] = timer.ms(lambda: fa.flash_bwd_dq(*args))
    res["flash_fwd"]["plain_ms"] = timer.ms(
        lambda: fa.flash_fwd_plain(q, k, v, seg, causal, scale), iters=3,
        warmup=1)
    res["flash_bwd_dkdv"]["plain_ms"] = timer.ms(
        lambda: fa.flash_bwd_dkdv_plain(*args), iters=3, warmup=1)
    res["flash_bwd_dq"]["plain_ms"] = timer.ms(
        lambda: fa.flash_bwd_dq_plain(*args), iters=3, warmup=1)
    # yardstick: SDPA forward, and its backward through autograd (all
    # three gradients in one call, so the same time stands beside dK/dV
    # and beside dQ)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    res["flash_fwd"]["library_ms"] = timer.ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    lib_bwd = timer.ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    res["flash_bwd_dkdv"]["library_ms"] = res["flash_bwd_dq"][
        "library_ms"] = lib_bwd
    res["shape"] = {"B": B, "S": S, "Hq": hq, "Hkv": hkv, "D": D,
                    "causal": causal, "visible_pairs": pairs}
    return res


# -- phase 3: serve ----------------------------------------------------------


def prompts_for(seed):
    """8 prompts of 64-512 tokens; uid 0 and uid 7 share their first 256
    tokens. uid 7 is submitted after uid 0's prefix is in the cache."""
    rng = np.random.default_rng(seed)
    lens = [448, 64, 96, 160, 224, 288, 512, 320]
    prompts = [rng.integers(0, 128256, n).astype(np.int32) for n in lens]
    prompts[7][:256] = prompts[0][:256]
    return prompts


def serve_once(torch, zoo, InferenceEngineV2, profile=False):
    model = zoo.get_model("llama3-8b", device="cuda", seed=SEED)
    eng = InferenceEngineV2(model, kv_blocks=KV_BLOCKS, kv_block_size=BS,
                            max_tokens_per_step=MAX_TOKENS,
                            max_seqs_per_step=MAX_SEQS,
                            max_blocks_per_seq=MAX_BLOCKS,
                            decode_steps=DECODE_STEPS)
    prompts = prompts_for(SEED + 1)
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
        prof.__enter__()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.put(list(range(7)), prompts[:7], max_new_tokens=NEW_TOKENS)
    out = {}
    # one round prefills uid 0's first 256 tokens (16 full blocks), which
    # the prefix cache then offers to uid 7
    for uid, toks in eng.serve_step().items():
        out.setdefault(uid, []).extend(toks)
    eng.put([7], prompts[7:], max_new_tokens=NEW_TOKENS)
    for uid, toks in eng.generate_all().items():
        out.setdefault(uid, []).extend(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        return out, wall, prof
    return model, eng, out, wall, prompts


def device_breakdown(torch, prof, wall_s, units, unit="generated_token"):
    """Device time of a profiled run by kernel family, the union of busy
    intervals, and the idle share of the host wall time; ``units`` of
    ``unit`` (generated tokens, train steps) divide the kernel count."""
    from torch.autograd import DeviceType

    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return {"device_time_measured": False}
    fams = {}
    spans = []
    for e in kern:
        n = e.name.lower()
        fam = ("paged_decode" if "paged_decode" in n else
               "paged_prefill" if "paged_prefill" in n else
               "flash_fwd" if "flash_fwd_kernel" in n else
               "flash_bwd_dkdv" if "flash_bwd_dkdv" in n else
               "flash_bwd_dq" if "flash_bwd_dq" in n else
               "matmul" if any(k in n for k in ("gemm", "xmma", "cutlass",
                                                "cublas", "matmul",
                                                "nvjet")) else
               "copy" if "memcpy" in n or "memset" in n else "other")
        us = e.time_range.end - e.time_range.start
        f = fams.setdefault(fam, {"ms": 0.0, "kernels": 0})
        f["ms"] += us / 1e3
        f["kernels"] += 1
        spans.append((e.time_range.start, e.time_range.end))
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return {"device_time_measured": True, "wall_s": wall_s,
            "device_busy_s": busy / 1e6,
            "device_idle_share": 1.0 - busy / 1e6 / wall_s,
            "kernels": len(kern),
            f"kernels_per_{unit}": len(kern) / units,
            "by_family": fams,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def check_paths_agree(torch, model_runner, model, prompts):
    """One 128-token prefill batch through the paged prefill kernel and
    through the plain gather path, each on its own fresh pool."""
    cfg, params = model.config, model.params()
    tq, nblk = 128, 8
    toks = torch.from_numpy(prompts[5][:tq]).cuda()
    bt = torch.arange(nblk, dtype=torch.int32, device="cuda")[None]
    pools = [torch.zeros((cfg.num_layers, nblk + 1, BS, 2, NKV, HD),
                         dtype=cfg.dtype, device="cuda") for _ in range(2)]
    i32 = dict(dtype=torch.int32, device="cuda")
    lg_k, _ = model_runner.ragged_prefill_forward(
        cfg, params, pools[0], toks[None], torch.zeros(1, **i32),
        torch.full((1,), tq, **i32), bt)
    lg_g, _ = model_runner.ragged_forward(
        cfg, params, pools[1], toks, torch.zeros(tq, **i32),
        torch.arange(tq, **i32), bt, tq)
    a, b = lg_k[0, -1], lg_g[-1]
    if a.shape != (cfg.vocab_size,) or not (torch.isfinite(a).all()
                                            and torch.isfinite(b).all()):
        fail("prefill/gather logits: wrong shape or non-finite")
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    if diff > LOGIT_TOL_REL * scale:
        fail(f"prefill kernel path vs gather path: max-abs {diff} > "
             f"{LOGIT_TOL_REL} x max|logit| {scale}")
    return {"max_abs_diff": diff, "max_abs_logit": scale,
            "argmax_equal": bool(a.argmax() == b.argmax())}


# -- phase 4: train ----------------------------------------------------------


def fixed_batches(vocab):
    """Two fixed microbatches of TRAIN_SEQ + 1 tokens, cycled so that
    the loss can fall."""
    rng = np.random.default_rng(SEED + 2)
    fixed = [{"input_ids": rng.integers(0, vocab, (TRAIN_MICRO,
                                                   TRAIN_SEQ + 1))
              .astype(np.int32)} for _ in range(2)]

    def it():
        i = 0
        while True:
            yield fixed[i % 2]
            i += 1

    return fixed, it()


def flash_vs_dense(torch, tf, engine, batch):
    """Loss and the layers.attn.wq gradient of one microbatch through the
    flash kernels and through the dense path, on the engine's params."""
    import dataclasses

    mb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    wq = engine.params["layers"]["attn"]["wq"]
    out = {}
    for impl in ("flash", "xla"):
        cfg = dataclasses.replace(engine.model_config, attn_impl=impl)
        loss, _ = tf.loss_fn(cfg, engine.params, mb)
        (grad,) = torch.autograd.grad(loss, [wq])
        out[impl] = (loss.item(), grad.float())
    (lf, gf), (lx, gx) = out["flash"], out["xla"]
    res = {"loss_flash": lf, "loss_dense": lx,
           "loss_rel_diff": abs(lf - lx) / abs(lx),
           "wq_grad_max_rel_diff": ((gf - gx).abs().max()
                                    / gx.abs().max()).item(),
           "wq_grad_cosine": (torch.sum(gf * gx) / (gf.norm() * gx.norm())
                              ).item()}
    if not (res["loss_rel_diff"] <= TRAIN_LOSS_TOL_REL
            and res["wq_grad_cosine"] >= TRAIN_GRAD_COS_MIN):
        fail(f"train: flash vs dense path disagree: {res}")
    return res


def train_phase(torch, zoo, initialize, fa, tf):
    """Returns (train line, train profile line, flash launches on the
    main path)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = zoo.get_model("llama3-8b", num_layers=TRAIN_LAYERS,
                          dtype=torch.float32, seed=SEED)
    cfg = model.config
    engine, *_ = initialize(model=model, config=dict(TRAIN_CONFIG))
    fixed, data = fixed_batches(cfg.vocab_size)
    losses = [float(engine.train_batch(data))]  # warm-up step
    fa.reset_launch_counts()
    step_s = []
    for _ in range(TRAIN_MEASURED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(data)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = dict(fa.LAUNCHES)
    L, steps = TRAIN_LAYERS, TRAIN_MEASURED
    want = {"flash_fwd": steps * 2 * L * TRAIN_GAS,  # forward + remat replay
            "flash_bwd_dkdv": steps * L * TRAIN_GAS,
            "flash_bwd_dq": steps * L * TRAIN_GAS}
    if launches != want:
        fail(f"train: flash launches {launches}, remat implies {want}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail(f"train: losses {losses} not finite and falling")
    if engine.global_steps != 1 + TRAIN_MEASURED:
        fail(f"train: global_steps {engine.global_steps}")
    gnorm = float(engine.get_global_grad_norm())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    agree = flash_vs_dense(torch, tf, engine, fixed[0])

    tokens = TRAIN_MICRO * TRAIN_GAS * TRAIN_SEQ
    p50 = float(np.median(step_s))
    # 6 N + the attention term at the trained length (flops_per_token
    # counts it at max_seq_len, 8192 for this preset)
    flops_tok = 6 * cfg.num_params() + 12 * L * cfg.hidden_size * TRAIN_SEQ
    train = {
        "model": "llama3-8b", "layers": f"{L} of 32",
        "params": cfg.num_params(), "dtype": "bfloat16 compute, fp32 masters",
        "micro": TRAIN_MICRO, "gas": TRAIN_GAS, "seq": TRAIN_SEQ,
        "tokens_per_step": tokens, "step_s": step_s, "step_ms_p50": p50 * 1e3,
        "tokens_per_s": tokens / p50,
        "mfu": tokens / p50 * flops_tok / PEAK_FLOPS["bfloat16"],
        "flops_per_token": flops_tok, "peak_mem_gb": peak_gb,
        "losses": losses, "grad_norm": gnorm, "global_steps": 1 + steps,
        "launches": launches,
        "launches_per_step": {k: v // steps for k, v in launches.items()},
        "flash_vs_dense": agree,
    }
    from torch.profiler import ProfilerActivity

    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    prof.__enter__()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_batch(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    profile = device_breakdown(torch, prof, wall, 1, unit="step")
    del prof, engine, model
    torch.cuda.empty_cache()
    return train, profile, launches


def main():
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device (torch.cuda.is_available() is False)")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.inference import InferenceEngineV2, model_runner
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_identity()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    secs = build.build()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s)")
    for src in build.SOURCES:
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: " + line.strip())

    # 2. kernels
    timer = Timer(torch)
    dec = {"float32": check_decode(torch, pa, timer, torch.float32),
           "bfloat16": check_decode(torch, pa, timer, torch.bfloat16)}
    pre = {}
    for tq, S in ((128, 4), (16, MAX_SEQS)):
        pre[tq] = {"float32": check_prefill(torch, pa, timer, torch.float32,
                                            tq, S),
                   "bfloat16": check_prefill(torch, pa, timer,
                                             torch.bfloat16, tq, S)}
    # 2b. flash kernels
    flash = {(name, case): check_flash(torch, fa, timer, dtype, case)
             for case in FLASH_CASES
             for name, dtype in (("float32", torch.float32),
                                 ("bfloat16", torch.bfloat16))}
    del timer
    log("kernels agree with their plain versions")

    # 3. serve: run 1 warms up and is the determinism reference; run 2
    # is the measured main path, with the launch counts read around it
    model, eng, ref_out, _, _ = serve_once(torch, zoo, InferenceEngineV2)
    del model, eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    model, eng, out, wall, prompts = serve_once(torch, zoo,
                                                InferenceEngineV2)
    launches = dict(pa.LAUNCHES)
    if sorted(out) != list(range(8)) or any(len(v) != NEW_TOKENS
                                            for v in out.values()):
        fail(f"serve: token counts {[len(out.get(u, [])) for u in range(8)]}")
    if out != ref_out:
        fail("serve: a second engine from the same seed gave other streams")
    st = eng.stats
    if st["prefill_kernel_steps"] <= 0 or st["decode_kernel_steps"] <= 0:
        fail(f"serve: kernel steps {st}")
    if min(launches.values()) <= 0:
        fail(f"serve: a kernel was never launched on the main path: "
             f"{launches}")
    agree = check_paths_agree(torch, model_runner, model, prompts)
    ttft = sorted(eng.latency["ttft_s"])
    gen = sum(len(v) for v in out.values())
    prompt_tokens = sum(len(p) for p in prompts)
    serve = {
        "model": "llama3-8b", "layers": model.config.num_layers,
        "dtype": "bfloat16", "requests": 8, "prompt_tokens": prompt_tokens,
        "generated_tokens": gen, "wall_s": wall,
        "generated_tokens_per_s": gen / wall,
        "total_tokens_per_s": (gen + prompt_tokens) / wall,
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "decode_token_p50_s": float(np.median(eng.latency["decode_token_s"])),
        "prefill_kernel_steps": st["prefill_kernel_steps"],
        "decode_kernel_steps": st["decode_kernel_steps"],
        "burst_steps": st["burst_steps"],
        "prefill_gather_fallbacks": st["prefill_gather_fallbacks"],
        "fallback_reasons": st["fallback_reasons"],
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "prefill_vs_gather": agree,
        "deterministic_rerun": True,
    }
    # a third run of the same workload under torch.profiler: where the
    # device time goes and how long the device sits idle
    del model, eng
    torch.cuda.empty_cache()
    prof_out, prof_wall, prof = serve_once(torch, zoo, InferenceEngineV2,
                                           profile=True)
    if prof_out != ref_out:
        fail("serve: the profiled run gave other streams")
    profile = device_breakdown(torch, prof, prof_wall, gen)
    del prof

    # 4. train: the serve model is gone; the launch counts are read
    # around the measured steps
    train, train_profile, train_launches = train_phase(torch, zoo,
                                                       initialize, fa, tf)

    def entry(name, replaces, res, other):
        b = res["bfloat16"]
        return {"name": name, "route": "cuda",
                "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": b["max_abs_err"],
                "max_abs_err_fp32": res["float32"]["max_abs_err"],
                "ms": b["ms"], "plain_ms": b["plain_ms"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": b["library_ms"],
                "library_call": "scaled_dot_product_attention on K/V "
                                "gathered dense beforehand (heads expanded, "
                                "boolean mask)",
                "dtype": "bfloat16", "shape": b["shape"], "other": other}

    other_pre = {k: v for k, v in pre[16]["bfloat16"].items()}
    other_pre["max_abs_err_fp32"] = pre[16]["float32"]["max_abs_err"]
    def flash_entry(name, line):
        b = flash[("bfloat16", "smoke")][name]
        lib = ("scaled_dot_product_attention(is_causal=True, enable_gqa="
               "True) on [B, H, S, D] copies" + (
                   "" if name == "flash_fwd" else
                   ", its backward through autograd (dQ, dK and dV in one "
                   "call)"))
        return {"name": name, "route": "cuda",
                "source": "deepspeed_tpu_torch/ops/csrc/flash_attention.cu",
                "replaces": f"deepspeed_tpu/ops/pallas/flash_attention.py:"
                            f"{line}",
                "launches": train_launches[name],
                "max_abs_err": b["max_abs_err"],
                "max_rel_err": b["max_rel_err"],
                "ms": b["ms"], "plain_ms": b["plain_ms"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": b["library_ms"], "library_call": lib,
                "dtype": "bfloat16",
                "shape": flash[("bfloat16", "smoke")]["shape"],
                "other": {f"{dt}/{case}": flash[(dt, case)][name]
                          for dt, case in flash
                          if (dt, case) != ("bfloat16", "smoke")}}

    kernels = {"kernels": [
        entry("paged_decode",
              "deepspeed_tpu/ops/pallas/paged_attention.py:77", dec, None),
        entry("paged_prefill",
              "deepspeed_tpu/ops/pallas/paged_attention.py:117", pre[128],
              other_pre),
        flash_entry("flash_fwd", 150),
        flash_entry("flash_bwd_dkdv", 268),
        flash_entry("flash_bwd_dq", 326),
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"serve_profile": profile}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"train_profile": train_profile}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
