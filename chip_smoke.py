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
               PyTorch library yardstick with CUDA events. Prefill must
               take the tensor-core kernel (wgmma) in bf16 and the
               scalar one (simt) in fp32 and on a bf16 q 2 bytes off a
               16-byte boundary; two launches bit-identical; the first
               version (simt on the same bf16 inputs) timed beside it.
               Decode must take the split kernel (split) in bf16, held
               to its plain twin at the span the host picked, and the
               scalar one in fp32, held to the single-fold plain
               version; two launches bit-identical; timed at the smoke's
               shape and at two long contexts (S 1 x 16384 and S 4 x
               4096 tokens from the same 2048-page pool) beside the
               bound, SDPA on gathered K/V and the first version (simt
               on the same bf16 inputs);
  2b. flash  — the three flash attention kernels against their plain
               versions at B 2, S 2048, 32/8 heads, hd 128, causal (fp32
               and bf16), a non-causal S 1000 case with three segments
               and an hd 64 case; the forward and backward must be
               bit-identical across two launches; the forward must take
               the tensor-core kernel (wgmma) in bf16 at hd 128 and the
               scalar one (simt) in fp32 and at hd 64; kernel, plain
               version, SDPA (a yardstick the port never calls) and, for
               the forward, the first version (the scalar kernel on the
               same bf16 inputs) timed with CUDA events.
  2c. gmm    — the grouped matmuls gmm, gmm^T and tgmm against their
               plain versions in fp32 and bf16 at Mixtral-8x7B expert
               shapes (E 8, 4096 rows in imbalanced groups with an empty
               one and boundaries mid-tile; K 4096 -> N 14336 and 14336 ->
               4096), at 32 decode rows, and at odd sizes with an
               over-sum and an under-sum of the group sizes; errors
               relative to the largest reference entry; two launches
               bit-identical; gmm, gmm^T and tgmm must take the
               tensor-core kernel (wgmma) in bf16 at the aligned shapes
               and the scalar kernel (simt) in fp32 and at the odd ones.
               At the train shapes (and gmm at decode) it prints the
               variant, kernel ms (and TFLOP/s) beside the bound,
               torch._grouped_mm (a yardstick the port never calls), the
               first version (the scalar kernel on the same bf16 inputs),
               all timed with CUDA events; phase 1 prints each kernel's
               ptxas registers, shared memory and spills.
  2d. quant  — the quantize kernels against their plain versions, bit for
               bit (same bytes of codes and scales, same output bits):
               the blockwise quantize on one layer's mlp.wi of
               Llama-3-8B ([4096, 14336], bf16 and fp32, block 128 and
               256, 8 and 4 bits), the KV quantize-on-append at decode
               (16 tokens) and prefill (256 tokens) for int8, int4 and
               fp8 into a 2048 x 16 layer pool, and the dequantize of
               that pool in each rung and of one quantized weight; inputs
               hold exact .5 ties, all-zero blocks and values at both ends
               of the grid. Kernel and plain version timed with CUDA
               events beside the bound (no single PyTorch call computes
               either function, so there is no library yardstick).
  2e. blocksparse — the block-sparse forward (B9) against its plain
               version and against the masked form (after
               repeat_kv_heads), fp32 and bf16, B 1, 32 q heads of 128:
               the five layout modes at the JAX defaults (block 128;
               fixed: 4 local blocks, 1 global) at S 4096, causal and
               not, with 8 kv heads and (fixed) 32; layout blocks 16, 64
               and 256 at S 1024; a ragged S 4000; a custom layout with
               an empty row (non-causal: 0 there); the main-path shape
               (fixed, causal, S 8192, 8 kv heads). Two launches must be
               bit-identical; errors relative to the largest reference
               entry; densities printed. bf16 at a layout block that is a
               multiple of 128 must take the tensor-core kernel (wgmma),
               the rest the scalar one (simt), each against the plain
               version at its own tile (128, 64). At S 4096 and 8192
               (fixed, causal, bf16) kernel, the first version (simt on
               the same inputs), plain version and SDPA with the layout
               as a boolean mask (a yardstick the port never calls)
               timed with CUDA events against the bound.
  3. serve   — ``InferenceEngineV2`` over ``get_model("llama3-8b")`` at
               full width and depth with seeded bf16 weights: 8 requests
               (64-512 prompt tokens, two sharing a 256-token prefix),
               64 new tokens each, through ``put`` and ``generate_all``.
               The kernels' launch counts are read around this run. A
               second engine from the same seed must give identical
               streams, and the paged prefill path must agree with the
               plain gather path on one prefill batch; every paged
               prefill launch must take the tensor-core kernel and every
               paged decode launch the split kernel. A third
               run of the same workload on the same model under
               torch.profiler gives the device time by kernel family and
               the device's idle share.
  7. quant serve — right after phase 3, on its model (built once): the
               same workload with int8, int4 and fp8 KV pools, a second
               int8 engine (identical streams; profiled), an int8 pool
               with the host KV tier that pages one request out after 16
               tokens and back (the restored blocks hold the bytes paged
               out; no prefill after the resume; 64 tokens), and last
               int8 weights over a bf16 pool, which quantizes the model
               in place. Launch counts per run: the append and the
               dequantize once per layer per forward on the KV runs; the
               blockwise quantize once per quantized leaf (8) and the
               dequantize 7 x 32 + 1 times per forward on the weight run;
               every paged prefill launch on the tensor-core kernel and
               every paged decode launch on the split kernel (a
               quantized pool reaches both as the bf16 scratch).
               Agreement with phase 3's bf16 streams is reported.
  8a. sparse forward — right after phase 3's profile, on its model:
               ``loss_fn`` with ``attn_impl="blocksparse"`` and the fixed
               layout under no_grad at B 1 x S 8192, all 32 layers:
               exactly 32 B9 launches a forward, all on the tensor-core
               kernel, a finite loss, layer 0's
               q/k/v through the kernel against the masked form; forward
               time p50 over 3 runs and a profile (B9's share).
  4. train   — ``deepspeed_tpu_torch.initialize`` + ``train_batch`` on
               Llama-3-8B at full width, 8 of its 32 layers (fp32
               masters from a seed, bf16 compute, AdamW, ZeRO-3 config,
               clip 1.0), micro 2 x GAS 2 x 2048 tokens over two fixed
               batches: one warm-up and four measured steps with the
               flash launch counts read around them (every forward on
               the tensor-core kernel); loss and wq gradient through the
               flash path against the dense path on one microbatch; one
               more step under torch.profiler.
  9. checkpoint — after phase 4, once its engine is freed: Llama-3-8B at
               full width, 1 of its 32 layers (1.27 B parameters: the
               vocabulary matrices hold 83% of the ~17.8 GB of state),
               bf16 on fp32 masters, AdamW with a warm-up schedule, clip
               1.0, micro 1 x GAS 2 x 2048 tokens from a shuffled,
               seeded ``RepeatingLoader(DeepSpeedDataLoader(...))``.
               Engine A (weights from seed 0) takes 2 steps, saves
               synchronously into a temporary directory (the free space
               is checked first: short space fails the phase), records a
               bitwise checksum of every saved leaf, takes 3 more steps
               (the reference losses) and is freed. Engine B (weights
               from seed 1, ``checkpoint.async_save`` on) loads the tag
               with the manifest's crc32 validation: every restored leaf
               must checksum as saved. Then ``resume_data_iter`` and 3
               steps with the flash launch counts read around them: the
               losses must equal A's bit for bit, and the launches must be
               what remat implies, all on the tensor-core kernels. A's tag
               goes; B saves again asynchronously: ``latest`` must appear
               only after the commit, and the tag must validate. Save,
               load (manifest validation and tensor read apart) and the
               async save's blocking and commit seconds are printed with
               their GB/s.
  5. moe serve — ``InferenceEngineV2`` over ``get_model("mixtral-8x7b",
               num_layers=16)`` (full width, seeded bf16 weights): the
               serve phase's 8 requests drawn in Mixtral's 32000-token
               vocabulary, 64 new tokens each. A second engine from the
               same seed must give identical streams; gmm launches are a
               multiple of 3 x 16; layer 0's MoE FFN through the kernel
               agrees with the same FFN on the plain gmm on one prefill
               batch, and makes the host wait nowhere (CUDA's sync debug
               mode); every gmm launch went through the tensor-core kernel
               (no scalar one), every paged prefill launch too, every
               paged decode launch on the split kernel; one more run
               under torch.profiler.
  6. moe train — ``initialize`` + ``train_batch`` on Mixtral-8x7B at full
               width, 2 of its 32 layers (fp32 masters, bf16 compute,
               AdamW, ZeRO-3 config, clip 1.0), micro 1 x GAS 2 x 2048
               tokens: one warm-up and four measured steps with the gmm
               and flash launch counts read around them (exactly what
               remat implies; every gmm, gmm^T, tgmm and flash forward
               launch through the tensor-core kernels), then one step
               under torch.profiler.
  8b. sparse train — after phase 4: ``initialize`` over 8-layer
               full-width Llama-3-8B with a ``sparse_attention`` block
               (fixed), ``kernels.blocksparse_block`` 0 and
               ``training_data`` (seeded token rows); the micro-step loop
               ``engine(batch)`` / ``engine.backward(loss)`` /
               ``engine.step()`` over the returned dataloader at micro 1
               x GAS 2 x S 4096, one warm-up and three measured steps:
               finite, falling losses and no B9 launch (the masked form
               carries the gradient; AdamW at lr 1e-4); then
               ``eval_batch`` at S 8192: exactly 8 B9 launches, all on
               the tensor-core kernel. Last,
               the same loop for 5 steps at phase 4's lr 3e-4 through the
               fixed layout, the flash path and the masked form on a
               dense layout: the last two must give the same losses
               within 2% at every step.
  10. offload — after phase 9, once its engines are freed: ZeRO-Offload
               (``zero_optimization.offload_optimizer``), the fp32
               masters and AdamW moments on the host, stepped by the
               native CPU Adam (``csrc/adam`` built with g++). 10a:
               Llama-3-8B at full width, as deep as the host holds (12
               bytes of host state a parameter against MemAvailable and
               the command's 96 GiB, less 6 GB: the cut and its
               reckoning are printed; 32 layers need 96.4 GB), cut to 8
               layers for the run's time limit, bf16 on
               fp32 host masters, AdamW lr 3e-4, ZeRO-3 config, clip 1.0,
               ``offload_optimizer`` cpu with pinned staging, micro 2 x
               GAS 1 x 2048 over phase 4's fixed batches: one warm-up and
               three measured steps (flash launches exactly what remat
               implies, all on the tensor-core kernels; finite, falling
               losses; the native library in use), the step split into
               device forward/backward, norm, device->host, host
               optimizer and host->device (the copies' stream time
               beside them), tokens/s, MFU on phase 4's formula, the
               card's peak memory at init and in training, the host's
               RSS, then one step under torch.profiler (the device's
               idle share with and without the copies). 10b: phase 9's
               1-layer model at a 16384-token vocabulary
               (``CKPT_SMALL_VOCAB``) from one seed under the device
               optimizer,
               the cpu tier and the NVMe tier (a temporary directory,
               free space checked first), 3 steps each: cpu and nvme
               losses equal, device and cpu within 3e-3 (JAX's
               tolerance), the swap directory holds files; on the device
               engine ``offload_states`` / ``reload_states`` frees the
               card's bytes and restores every leaf bit for bit. 10c:
               the cpu-tier engine saves through
               ``checkpoint.parallel_write_pipeline`` (the AIO writer); a
               fresh engine from another seed loads it and its 2 resumed
               losses equal the uninterrupted run's bit for bit (flash
               launches all tensor-core); save and load seconds and GB/s
               beside phase 9's sync save. The phase's wall is printed.
  11. zenflow — after phase 10, once its engines are freed: ZenFlow
               (``zero_optimization.zenflow`` at JAX's defaults: the top
               1% of each leaf's coordinates on the card every step, the
               rest in a native host Adam pass every 4 steps on a
               thread), bf16 on fp32 host masters, AdamW lr 3e-4, clip
               1.0, micro 2 x GAS 1 x 2048 over phase 4's fixed batches.
               11a: Llama-3-8B at full width as deep as host and card
               hold (16 bytes a parameter of host state, 10 / 8 on the
               card at init / in training; both reckonings and the cut
               printed), cut to 8 layers for the run's time limit; one interval of warm-up (the first selection and
               the first ship: a fold needs a pass shipped an interval
               earlier), then two measured intervals (gates: finite,
               falling losses; flash launches as remat implies, all
               tensor-core; the native library and no second host
               optimizer; 2 ships and 2 folds; after each fold one
               leaf's host masters at the kept coordinates equal the
               card's values and its other coordinates the bf16 cast of
               the masters), each step's wall by kind (steady, fold +
               ship), tokens/s, MFU, each host pass's seconds and
               Gparam/s, the collect's wait, the ship and fold walls and
               copy-stream seconds, peak memory and host RSS, then one
               interval under torch.profiler (idle share with and
               without the copy engines). 11b: PR 12's blocking offload
               step at 11a's depth, 1 warm-up and 2 steps, one profiled.
               11c: phase 9's 1 layer at 10b's vocabulary, update
               interval 2 and select interval 4, saved at step 3 (the pass shipped at step 2 in
               flight), loaded by an engine from another seed: its 3
               resumed losses equal the uninterrupted run's (``==``).
               11d: sgd, momentum, lion, adagrad, lamb, adafactor and
               muon at the lr of ``SWEEP_LR``, 3 steps of 2 layers
               (finite losses, the last below the first; step
               times; muon's Newton-Schulz share) and one update of a
               small seeded tree on the card against the CPU (fp32, rtol
               1e-4, atol 1e-6). The phase's wall is printed.
  12. spec and engine — 12a-c right after phase 8a, on phase 3's model
               (before phase 7, whose weight run quantizes it in place):
               12a phase 3's 8 requests with speculative decoding
               (prompt lookup, k 4) at fixed k, again (identical
               streams), and with adaptive k; then a repetitive set of
               the same lengths whose prompts repeat a seeded 32-token
               motif, spec off and on. Each run: tokens/s, wall, TTFT,
               decode gap, verify rounds, drafts proposed and accepted,
               accepted tokens a verify round, backoff rounds, peak
               memory, and the verify rounds' paged prefill launches by
               variant, chunk shape and template. Gates: 64 tokens a
               request; every verify round one paged prefill launch a
               layer on the tensor-core kernel, no gather fallback;
               accepted <= proposed; verify rounds on the repetitive
               set; every paged launch on the fast kernels; each spec
               stream equal to its plain run's (phase 3's, or the
               repetitive set's spec-off run), or parting only at a near
               tie: reruns of both runs (identical streams) record the
               logits rows of the first parting tokens, and the plain
               row's gap between the two chosen tokens must be no larger
               than the max-abs difference of the two rows (each parting
               printed). 12b ``TransformerDrafter
               .small`` (head dim 16: dense attention by C5, no flash
               launch) behind the same engine, served before and after
               ``distill_from`` against the served model (its steps and
               seconds printed), with the propose time a call and a
               round, and 12a's stream gate. 12c B5 at the verify shape
               (8 segments x Tq 8, 5 real rows, over 300-560-token
               histories): the one-warpgroup tensor-core kernel twice,
               bit for bit, against its plain version, then timed beside
               its first version, the plain version, SDPA on gathered
               K/V and the bound. 12d after phase 9: 2-layer
               full-width Llama-3-8B at micro 2 x GAS 2 x 2048 over phase
               4's fixed batches, AdamW at lr 3e-5: the blocking loop and pipeline_depth 2
               + prefetch_depth 2, 6 steps each (losses ``==``; step p50
               and, over 3 more steps under torch.profiler, the device's
               idle share), the same model as a ``(loss_fn, params)``
               pair over the functional forward (3 steps within rtol 1e-5
               of the module engine) and a client ``torch.optim.AdamW``
               against the config AdamW (3 steps, rtol 1e-4); flash
               launches as remat implies, all tensor-core. The phase's
               wall is printed.
  13. dispatch and v1 engine — after phase 12c, on phase 3's model
               (before phase 7, whose weight run quantizes it in place).
               13a: ``tools.kernel_bench.run_kernel_bench()`` at its card
               tier into a scratch table: flash (forward and backward,
               B 2 x 32/8 heads of 128, causal, S 256, 512, 1024, 2048 and
               4096) against ``xla_attention``, the paged decode (the
               2048 x 16 bf16 pool's shape, S 16 x 768 tokens) against
               the gathered dense reference, gmm forward and backward
               (phase 2c's train_wi shape) against the dense per-group
               product, and B9 (fixed, causal, S 8192) against the masked
               form outside autograd; each row's kernel, fallback and
               library ms, ratio and template printed. Gates: numerics,
               every kernel of the arms launched (B1-B4, B7, B7T, B8,
               B9), the dispatch probe (a losing flash bucket routes to
               ``xla_attention`` bit for bit, a winning one launches the
               kernel). 13b: ``init_inference`` over phase 3's model
               (bf16, a 1024-row dense cache) with DSTPU_KERNEL_TABLE at
               13a's table: ``forward`` at B 1 x S 2048 with the dispatch
               decision printed, and exactly 32 flash launches (all
               tensor-core) when the bucket won, none (32 dense
               dispatches) when it lost; ``generate`` on 4 of phase 3's
               prompts cut to 128 tokens, 32 new tokens each: wall,
               tokens/s, TTFT, decode gap, peak memory, dense-cache
               bytes; the streams against ``InferenceEngineV2``'s on the
               same prompts (equal, or parting only at a near tie by
               phase 12's rule, the v2 rows from a recorded rerun) and JAX's
               teacher-forcing check under the same rule. 13c: the same
               generate with int8 weights over a copy of the tree: 8
               blockwise quantize launches at build, the dequantize 7 x
               32 + 1 times a forward, agreement with 13b's streams. The
               phase's wall is printed.
  14. zero — after phase 12d, on its model size and phase 4's fixed
               batches. 14a: ``comm.init_distributed`` joins a one-rank
               NCCL group through a file store in a temporary directory
               (no TCP port; backend nccl, world size 1, rank 0 gated).
               14b: 2-layer full-width Llama-3-8B, bf16 on fp32 masters,
               AdamW at lr 3e-5, clip 1.0, micro 2 x GAS 2 x 2048, 3
               steps at each of ZeRO stages 0, 1, 2 and 3 (the comms
               logger on). Gates: every stage's losses and final fp32
               masters equal stage 0's bit for bit; the collectives the
               comms logger counted equal those the plan implies,
               derived from the model's leaves and the remat setting
               (stage 3: each layer's leaves all-gathered in the forward
               and again in the recompute, each reduce-scattered in the
               backward); flash launches as remat implies, all
               tensor-core; no measured loss routed to the dense path.
               Per stage: step p50, peak memory, collectives and bytes
               by op. The group is destroyed at the end, so the phases
               after it run without one. The phase's wall is printed.
  15. observability — 15c right after phase 13, on phase 3's model
               (before phase 7 quantizes it): phase 3's 8 requests with
               every request traced and the engine's series labelled;
               gates: streams ``==`` phase 3's, every trace's phases
               close, the labelled TTFT histogram counts 8 and the
               emitted tokens 512, ``snapshot()`` has JAX's keys (less
               ``handoff_wire``), the dispatch gauges on the hub. 15a
               after phase 14: 12d's 2-layer step at pipeline depth 2,
               8 steps with observability on (JSONL, Prometheus, the
               watchdog, the profiler over steps 5-6), then off; gates:
               losses and fp32 masters ``==``, a step row a step whose
               MFU the row recomputes, the window MFU of steps 3-8
               within 2% of the smoke's (the model's flops_per_token
               over 989e12 on both sides; the S 2048 figure printed
               beside), the same count of CUDA sync-debug warnings on
               and off over steps 3-8, one kernel_dispatch event per
               memoised decision, the trace naming the three flash
               wgmma kernels as remat implies and the region ranges;
               printed: step p50 on and off, device ms by range, the
               counted regions' FLOPs against their ranges' time, the
               roofline. 15b: two more steps with a small watchdog
               threshold, a post-step hook holding the second past it:
               one report (stacks, device memory), train.stalls 1, a
               flight dump with the step's entry and the previous
               step's drain.
Then it prints the kernels line, the serve, profile, train, train
profile, moe serve, moe serve profile, moe train, moe train profile,
quant serve, quant serve profile, sparse forward, sparse forward profile
sparse train, checkpoint, offload, offload profile, offload parity,
offload checkpoint, zenflow, zenflow profile, zenflow blocking, zenflow
checkpoint, optimizer sweep, spec serve, draft model, verify-shape
prefill, A4, kernel bench, v1 engine, zero, observability and
observability serve lines, the run's seconds,
the card's name
and power limit (nvidia-smi), and, last, the device line.

Exits non-zero with no result when there is no CUDA device or when the
package is not beside it.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
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

# flash gradients vs their plain versions, as the largest error in a
# gradient row (a key's dK or dV, a q row's dQ) over that row's largest
# reference entry, the largest over rows (row_rel_err): with causal
# attention the first keys and rows hold gradients near 10 and the late
# ones near 0.1, and each row is held at its own scale. fp32 sums over
# 2048 rows in another order; bf16 p and ds round to bf16 in both, and a
# rounding on the other side of a tie moves one term by 2**-8. A row
# whose exact gradient is 0 (dQ of a causal segment's first row, where
# p = 1 and dS = dP - delta cancels) holds fp32 noise of the sums'
# order; GRAD_ROW_FLOOR of the tensor's largest entry stands in for such
# a row's scale
GRAD_TOL_REL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_ROW_FLOOR = 1e-4
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
# MoE phases: Mixtral-8x7B at full width, cut in depth to fit one card
# (serve: 16 of 32 layers, 23.5 B parameters, 47 GB in bf16; train: 2
# layers, 3.17 B parameters x 16 bytes of state)
MOE_SERVE_LAYERS, MOE_VOCAB = 16, 32000
MOE_TRAIN_LAYERS, MOE_TRAIN_MICRO, MOE_TRAIN_GAS = 2, 1, 2
MOE_TRAIN_CONFIG = dict(TRAIN_CONFIG,
                        train_micro_batch_size_per_chip=MOE_TRAIN_MICRO,
                        gradient_accumulation_steps=MOE_TRAIN_GAS)
# grouped matmuls vs their plain versions, relative to the largest
# reference entry: fp32 sums over up to 14336 terms in another order;
# bf16 rounds an fp32 sum once in both, which may land one step apart
GMM_TOL_REL = {"float32": 1e-4, "bfloat16": 2e-2}
GMM_CASES = {  # group sizes, M (None = their sum), K, N
    # 2048 tokens x top-2; multiples of 8 rows (torch._grouped_mm's tgmm
    # alignment) but not of 128, so boundaries fall mid-tile
    "train_wi": ([704, 0, 1000, 296, 64, 1496, 504, 32], None, 4096, 14336),
    "train_wo": ([704, 0, 1000, 296, 64, 1496, 504, 32], None, 14336, 4096),
    "decode": ([5, 0, 9, 1, 3, 6, 0, 8], None, 4096, 14336),
    "odd_over_sum": ([40, 40, 40], 100, 33, 45),
    "odd_under_sum": ([30, 0, 21], 70, 33, 45),
}
# the kernel function behind each (wrapper, variant) of the kernels line
GMM_KERNELS = {
    ("gmm", "wgmma"): "gmm_wgmma_kernel<Tile<128, 256, 4>, false> (64 x 128 "
                      "tiles at <= 1024 rows)",
    ("gmm_transposed", "wgmma"): "gmm_wgmma_kernel<Tile<128, 256, 4>, true> "
                                 "(64 x 128 tiles at <= 1024 rows)",
    ("gmm", "simt"): "gmm_kernel<T, BM, false>",
    ("gmm_transposed", "simt"): "gmm_kernel<T, BM, true>",
    ("tgmm", "wgmma"): "tgmm_wgmma_kernel<Tile<128, 256, 4>> (TMA-store "
                       "epilogue)",
    ("tgmm", "simt"): "tgmm_kernel<T>",
}
PREFILL_KERNELS = {"wgmma": "paged_prefill_wgmma_kernel",
                   "simt": "paged_prefill_kernel"}
DECODE_KERNELS = {"split": "paged_decode_split_kernel",
                  "simt": "paged_decode_kernel"}
# the fast variant each kernel of a bf16 main path must take
FAST_VARIANT = {"paged_decode": "split"}
# long-context decode: name -> (S, context tokens), every slot full
DECODE_LONG = {"S1x16384": (1, 16384), "S4x4096": (4, 4096)}
# the split decode against its plain twin, besides TOL: the largest error
# in an output row (sequence, head) over that row's largest reference
# entry (row_rel_err). At the long contexts the largest outputs are
# 0.05-0.1, where TOL's 2e-2 would pass a cross-span merge that leaves
# out the exp(m_i - M) weights (max-abs 0.0175 at S 1 x 16384, row error
# 0.47: tests/test_torch_paged_attention.py, the unweighted merge); one
# bf16 ulp of a row's largest entry is up to 7.8e-3
DECODE_TOL_ROW = 2e-2
BS_KERNELS = {"wgmma": "blocksparse_fwd_wgmma_kernel",
              "simt": "blocksparse_fwd_kernel"}
FLASH_KERNELS = {
    ("flash_fwd", "wgmma"): "flash_fwd_wgmma_kernel",
    ("flash_fwd", "simt"): "flash_fwd_kernel",
    ("flash_bwd_dkdv", "wgmma"): "flash_bwd_dkdv_wgmma_kernel",
    ("flash_bwd_dkdv", "simt"): "flash_bwd_dkdv_kernel",
    ("flash_bwd_dq", "wgmma"): "flash_bwd_dq_wgmma_kernel",
    ("flash_bwd_dq", "simt"): "flash_bwd_dq_kernel",
}
# the MoE FFN through the kernels vs the plain gmm, bf16, as a share of
# the largest plain output: a bf16 rounding step of the first gmm's
# output passes through silu and the second gmm
MOE_FFN_TOL_REL = 2e-2
# quantize kernels: one layer's mlp.wi of Llama-3-8B; the request the
# quantized serve pages out and back
QUANT_SHAPE = (4096, 14336)
PAGE_OUT_UID = 1
# block-sparse forward (B9): name -> (mode, layout block, S, kv heads,
# causal); 32 q heads of 128, B 1. The JAX defaults: block 128, fixed
# with 4 local blocks and 1 global. "main" is the shape the main path
# gives the kernel (phase 8: S 8192, GQA 32/8, causal, fixed).
BS_BLOCK = 128
BS_CASES = {f"{mode}-{'causal' if causal else 'full'}":
            (mode, BS_BLOCK, 4096, NKV, causal)
            for mode in ("dense", "fixed", "longformer", "bigbird",
                         "variable") for causal in (True, False)}
BS_CASES.update({
    "fixed-mha": ("fixed", BS_BLOCK, 4096, NH, True),
    "block16": ("fixed", 16, 1024, NKV, True),
    "block64": ("bigbird", 64, 1024, NKV, False),
    "block256": ("longformer", 256, 1024, NKV, True),
    "ragged": ("fixed", BS_BLOCK, 4000, NKV, True),
    "empty-row": ("custom", BS_BLOCK, 1024, NKV, False),
    "main": ("fixed", BS_BLOCK, 8192, NKV, True),
})
BS_TIMED = ("fixed-causal", "main")
# kernel vs plain version, as the largest error in an output row (b, s,
# head) over that row's largest reference entry, the largest over rows
# (row_rel_err): a causal row that sees a few columns has outputs near 1,
# one that sees thousands near 0.05, and each row is held at its own
# scale. fp32 sums in another order; bf16 rounds p to bf16 at the same
# point in both and the output once, where a rounding on the other side
# of a tie moves a term by 2**-8. Against the masked form, which rounds
# the normalised probabilities instead of p and divides before the
# product with V, bf16 differs at rounding level in every term. Worst
# readings on an H100 80GB HBM3 (700 W): bf16 7.7e-3 against the plain
# version and 9.6e-3 against the masked form (one bf16 ulp of a row's
# largest entry is up to 7.8e-3); fp32 5.7e-6 and 8.0e-6.
BS_TOL_ROW = {"float32": 1e-4, "bfloat16": 2e-2}
BS_MASKED_TOL_ROW = {"float32": 1e-4, "bfloat16": 3e-2}
# phase 8: the preset's context for the forwards; training at S 4096,
# micro 1 x GAS 2, 1 warm-up and 3 measured steps, AdamW at lr 1e-4: at
# phase 4's 3e-4 this micro 1 x 4096 run overshoots around its fourth
# step, on the flash path too (phase 8b's flash run at lr 3e-4 shows it)
SPARSE_SEQ, SPARSE_TRAIN_SEQ, SPARSE_GAS, SPARSE_MEASURED = 8192, 4096, 2, 3
SPARSE_TRAIN_CONFIG = dict(TRAIN_CONFIG, train_micro_batch_size_per_chip=1,
                           gradient_accumulation_steps=SPARSE_GAS,
                           optimizer={"type": "adamw",
                                      "params": {"lr": 1e-4}},
                           sparse_attention={"mode": "fixed"},
                           kernels={"blocksparse_block": 0})


# phase 9: the checkpoint round trip (Llama-3-8B at 1 of 32 layers: the
# vocabulary matrices hold 83% of the state; 2 layers until phase 12
# joined and the run had to stay inside its time limit)
CKPT_LAYERS, CKPT_ROWS, CKPT_BEFORE, CKPT_AFTER = 1, 16, 2, 3
CKPT_CONFIG = dict(TRAIN_CONFIG, train_micro_batch_size_per_chip=1,
                   gradient_accumulation_steps=2,
                   scheduler={"type": "WarmupLR",
                              "params": {"warmup_num_steps": 10}})
# the engine B of phase 9: async saves
CKPT_ASYNC_CONFIG = dict(CKPT_CONFIG, checkpoint={"async_save": True})
# phases 10b, 10c and 11c: phase 9's 1 layer with the vocabulary cut to
# CKPT_SMALL_VOCAB rows. The full vocabulary's two matrices hold 83% of
# the state and made their round trips ~140 s of disk time; phase 9 keeps
# the full model, and every gate of 10b-10c and 11c stays
CKPT_SMALL_VOCAB = 16384
# phase 10: ZeRO-Offload (fp32 masters and AdamW moments on the host,
# the native CPU Adam). 10a: Llama-3-8B at full width and as deep as the
# host holds (12 bytes of host state a parameter), cut to
# OFFLOAD_MAX_LAYERS for the run's time limit (the host held 28), micro
# 2 x GAS 1 x 2048 over phase 4's fixed batches, 1 warm-up and 3
# measured steps; 10b / 10c: phase 9's 1 layer, 3 steps a tier, 2
# resumed steps
OFFLOAD_MAX_LAYERS = 8
OFFLOAD_MICRO, OFFLOAD_MEASURED, OFFLOAD_SMALL_STEPS, OFFLOAD_RESUMED = \
    2, 3, 3, 2
OFFLOAD_CONFIG = dict(TRAIN_CONFIG,
                      train_micro_batch_size_per_chip=OFFLOAD_MICRO,
                      gradient_accumulation_steps=1,
                      zero_optimization={"stage": 3, "offload_optimizer": {
                          "device": "cpu", "pin_memory": True}})
OFFLOAD_DEVICE_CONFIG = dict(OFFLOAD_CONFIG, zero_optimization={"stage": 3})
# host memory beyond the optimizer state that the full-depth run leaves
# free (allocator slack, the profiler's buffers, the kernel's reserve)
OFFLOAD_HOST_MARGIN = 6e9
# the host memory a one-card H100 command may use (96 GiB, less than the
# host's MemTotal); a cgroup limit, where one is set, is read as well
HOST_LIMIT_BYTES = 96 << 30
# device optimizer vs host offload: JAX's tolerance
# (tests/test_offload.py:236)
OFFLOAD_TOL_REL = 3e-3
# phase 11: ZenFlow (the top 1% of each leaf's coordinates on the card
# every step, the rest in a host pass every 4 steps, overlapped; JAX's
# defaults), bf16 on fp32 host masters, AdamW lr 3e-4, clip 1.0, micro 2
# x GAS 1 x 2048 over phase 4's fixed batches. 11a: Llama-3-8B at full
# width as deep as host and card hold (16 bytes a parameter on the host:
# master, two moments, the shipped grads; 8 on the card in training:
# bf16 params and grads, fp32 accumulators; 10 at init, with the fp32
# model), one interval of warm-up (the first selection and the first
# ship), two measured intervals, one profiled; 11b: the blocking offload
# step at 11a's depth, 1 warm-up and 2 steps; 11c: phase 9's 1 layer at
# interval 2 and select 4, saved at step 3, 3 resumed steps; 11d: each
# optimizer for 3 steps at 2 layers, micro 2 x GAS 1. 11a's depth is cut
# to ZENFLOW_MAX_LAYERS for the run's time limit (the host held 20)
ZENFLOW_MAX_LAYERS = 8
SWEEP_LAYERS = 2
ZENFLOW_BLOCK = {"topk_ratio": 0.01, "update_interval": 4,
                 "select_interval": 16, "overlap_step": True}
ZENFLOW_CONFIG = dict(OFFLOAD_CONFIG, zero_optimization={
    "stage": 3, "offload_optimizer": {"device": "cpu"},
    "zenflow": ZENFLOW_BLOCK})
ZENFLOW_CKPT_CONFIG = dict(ZENFLOW_CONFIG, zero_optimization={
    "stage": 3, "offload_optimizer": {"device": "cpu"},
    "zenflow": dict(ZENFLOW_BLOCK, update_interval=2, select_interval=4)})
ZENFLOW_INTERVALS, ZENFLOW_BLOCKING_STEPS = 2, 2
ZENFLOW_CKPT_BEFORE, ZENFLOW_CKPT_AFTER = 3, 3
# card memory besides the 8 bytes a parameter: activations, the logits,
# the top-k's temporaries on the largest leaf, allocator slack
ZENFLOW_CARD_RESERVE = 12e9
# 11d: an lr per optimizer for the 2-layer model's 3 steps
SWEEP_LR = {"sgd": 1.0, "momentum": 0.1, "lion": 3e-5, "adagrad": 1.0,
            "lamb": 1e-3, "adafactor": 1e-3, "muon": 3e-4}
SWEEP_STEPS = 3
# 11d: one update of a small tree on the card and on the CPU (fp32)
SWEEP_TREE = {"layers": {"attn": {"wq": (2, 64, 4, 16),
                                  "wo": (2, 4, 16, 64)},
                         "mlp": {"wi": (2, 160, 320)},
                         "ln1": {"scale": (2, 64)}},
              "embed": {"tokens": (300, 64)}, "final_norm": {"scale": (64,)}}
SWEEP_TOL_REL, SWEEP_TOL_ABS = 1e-4, 1e-6
# phase 12: speculative serving on phase 3's model (12a prompt lookup at
# k 4, fixed and adaptive, and a repetitive request set whose prompts
# repeat a 32-token motif; 12b a distilled draft model; 12c B5 at the
# verify shape: 8 segments x Tq 8, 5 real rows, over 300-560-token
# histories) and A4 on 2 layers (12d: the blocking and the
# pipelined loop, a (loss_fn, params) model, a client torch AdamW)
SPEC_K, SPEC_MOTIF = 4, 32
# 150 steps (~15 s) where about a minute was the aim: the run's time
# limit. The random-weight target's logits are nearly flat over 128256
# tokens, and the held-out top-1 agreement stays 0.0 (PERF.md, PR 14)
DRAFT_WINDOW, DRAFT_STEPS, DRAFT_BATCH = 64, 150, 16
DRAFT_RESAMPLE, DRAFT_PREFIX = 50, 48
VERIFY_S, VERIFY_TQ, VERIFY_REAL, VERIFY_CTX = 8, 8, 5, (300, 560)
A4_LAYERS, A4_STEPS, A4_SHORT, A4_PROFILED = 2, 6, 3, 3
# AdamW without a schedule at lr 3e-5: at phase 4's 3e-4 the 2-layer
# model memorises the two fixed batches within two updates, and the
# third loss then magnifies the rounding-level differences of two AdamW
# implementations past A4_CLIENT_TOL_REL
A4_LR = 3e-5
A4_CONFIG = dict(TRAIN_CONFIG, optimizer={"type": "adamw",
                                          "params": {"lr": A4_LR}})
A4_PIPELINED = dict(A4_CONFIG, performance={"pipeline_depth": 2,
                                            "prefetch_depth": 2})
# (loss_fn, params) against the module engine: the same ops on the same
# inputs; torch's AdamW against the engine's: the same update in another
# order of operations, for 3 steps
A4_FN_TOL_REL, A4_CLIENT_TOL_REL = 1e-5, 1e-4
# phase 14: ZeRO stages 0-3 on a one-rank NCCL group, at phase 12d's depth
# and lr over phase 4's fixed batches, ZERO_STEPS steps a stage
ZERO_STAGES, ZERO_STEPS = (0, 1, 2, 3), 3
# phase 13: the kernel bench at its card tier (13a), then the v1 engine
# (init_inference) over phase 3's model: the forward at B 1 x S 2048, and
# generate on 4 of phase 3's prompts cut to 128 tokens, 32 new tokens
# each, with a 1024-row dense cache (13b); the same with int8 weights
# (13c)
V1_BATCH, V1_PROMPT, V1_NEW, V1_MAX_SEQ, V1_FORWARD_SEQ = 4, 128, 32, 1024, 2048
# 13b/13c's near ties: the two rows' max-abs difference must itself stay
# within V1_ROW_DIFF_FACTOR times phase 3's paged-prefill-vs-gather
# logits difference, so that a v1 engine whose rows are wrong (K/V
# written at the wrong rows) cannot pass as a near tie
V1_ROW_DIFF_FACTOR = 2.0
# phase 15: observability on 12d's 2-layer step (15a) at pipeline depth 2,
# 8 steps: 1-2 warm up, 3-8 the measured window (MFU, sync warnings),
# OBS_TRACE profiled; the window MFU within OBS_MFU_TOL of the smoke's
# (JAX's test_mfu_agrees_with_bench_formula); 15b's watchdog threshold
OBS_CONFIG = dict(A4_CONFIG, performance={"pipeline_depth": 2})
OBS_STEPS, OBS_WINDOW, OBS_TRACE, OBS_MFU_TOL = 8, (3, 8), (5, 6), 0.02
OBS_WD_FACTOR, OBS_WD_MIN_S = 2.0, 0.05
OBS_RANGES = ("attention", "mlp", "norm", "rope", "vocab_head", "optimizer")
OBS_FLASH_KERNELS = {"flash_fwd": "flash_fwd_wgmma_kernel",
                     "flash_bwd_dkdv": "flash_bwd_dkdv_wgmma_kernel",
                     "flash_bwd_dq": "flash_bwd_dq_wgmma_kernel"}
BENCH_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                 "paged_decode", "gmm", "gmm_transposed", "tgmm",
                 "blocksparse_fwd")


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


def ptxas_report(build_log):
    """One line per kernel of nvcc's -Xptxas -v output: its (demangled,
    where c++filt is installed) name, registers, shared memory and
    spills."""
    import re
    import shutil

    entries, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            entries.append([name, []])
        elif name and ("Used" in line or "spill" in line):
            entries[-1][1].append(line.split(":", 1)[-1].strip())
    names = [n for n, _ in entries]
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [n.replace("(anonymous namespace)::", "")
                     for n in out.stdout.splitlines()]
    return [f"{n.split('(')[0]}: " + "; ".join(info)
            for n, (_, info) in zip(names, entries)]


def kernel_lines(report, kernel):
    """The lines of a ptxas report that name ``kernel`` (and not a kernel
    whose name merely ends in it: gmm_wgmma_kernel, not
    tgmm_wgmma_kernel)."""
    import re

    pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(kernel) + r"[<:]")
    return [line for line in report if pat.search(line)]


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- phase 2: kernels ----------------------------------------------------------


def block_table(torch, rng, S, pages=MAX_BLOCKS):
    """S rows of ``pages`` distinct shuffled page ids of the pool."""
    return torch.from_numpy(rng.permutation(KV_BLOCKS - 1)[:S * pages]
                            .reshape(S, pages).astype(np.int32)).cuda()


def make_pool(torch, rng, dtype, S):
    kv = torch.from_numpy(rng.standard_normal(
        (KV_BLOCKS, BS, 2, NKV, HD), np.float32)).to("cuda", dtype)
    return kv, block_table(torch, rng, S)


def dense_kv(torch, kv, bt, lmax):
    """Each slot's pages gathered dense, heads expanded to NH:
    K, V [S, NH, lmax, HD] (the library yardstick's input)."""
    S = bt.shape[0]
    g = kv[bt.long()].reshape(S, -1, 2, NKV, HD)[:, :lmax]
    k = g[:, :, 0].permute(0, 2, 1, 3).repeat_interleave(NH // NKV, dim=1)
    v = g[:, :, 1].permute(0, 2, 1, 3).repeat_interleave(NH // NKV, dim=1)
    return k.contiguous(), v.contiguous()


def decode_variants_ran(pa, before):
    """Decode launches by variant since the counts ``before``."""
    return {v: pa.VARIANT_LAUNCHES[f"paged_decode/{v}"]
            - before[f"paged_decode/{v}"] for v in ("split", "simt")}


def checked_decode(torch, pa, q, kv, bt, ctx, label):
    """The decode kernel the rule names, twice: the variant counters must
    say which ran and the two outputs must be the same bits. bf16 (the
    split kernel) is held to its plain twin at the host's span, fp32 (the
    scalar kernel) to the single-fold plain version."""
    name = str(q.dtype).split(".")[-1]
    expect = "split" if q.dtype == torch.bfloat16 else "simt"
    scale = HD ** -0.5
    before = dict(pa.VARIANT_LAUNCHES)
    out = pa.paged_decode_attention(q, kv, bt, ctx)
    again = pa.paged_decode_attention(q, kv, bt, ctx)
    torch.cuda.synchronize()
    ran = decode_variants_ran(pa, before)
    if ran != {v: 2 * int(v == expect) for v in ran}:
        fail(f"paged_decode {label} {name}: ran {ran}, expected {expect}")
    if not torch.equal(out, again):
        fail(f"paged_decode {label} {name}: two launches differ")
    if not torch.isfinite(out).all() or not torch.all(out[ctx == 0] == 0):
        fail(f"paged_decode {label} {name}: non-finite output or live "
             f"dead slot")
    res = {"variant": expect, "bit_identical_rerun": True}
    if expect == "split":
        span = pa.decode_span_of(q, kv, bt)
        ref = pa.paged_decode_attention_split_plain(q, kv, bt, ctx, scale,
                                                    span)
        res["span_pages"] = span
    else:
        ref = pa.paged_decode_attention_plain(q, kv, bt, ctx, scale)
    err = (out.float() - ref.float()).abs().max().item()
    if err > TOL[name]:
        fail(f"paged_decode {label} {name}: max-abs {err} > {TOL[name]}")
    res["max_abs_err"] = err
    if expect == "split":
        rel = row_rel_err(torch, out, ref)
        if rel > DECODE_TOL_ROW:
            fail(f"paged_decode {label} {name}: row error {rel} over "
                 f"{DECODE_TOL_ROW} of a row's largest entry")
        res["max_row_rel_err"] = rel
        single = pa.paged_decode_attention_plain(q, kv, bt, ctx, scale)
        res["max_abs_err_vs_single_fold"] = (
            out.float() - single.float()).abs().max().item()
    return res


def time_decode(torch, pa, timer, res, q, kv, bt, ctx, ctx_np):
    """The bf16 split kernel's time beside the bound, the first version
    (the scalar kernel on the same inputs), the plain twin and SDPA on
    K/V gathered dense beforehand."""
    import torch.nn.functional as F

    S = q.shape[0]
    scale = HD ** -0.5
    itm = q.element_size()
    sum_ctx = int(np.minimum(ctx_np, bt.shape[1] * BS).sum())
    nbytes = (2 * q.numel() * itm + sum_ctx * 2 * NKV * HD * itm
              + bt.numel() * 4 + S * 4)
    flops = 4 * NH * HD * sum_ctx
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, "bfloat16")
    res["ms"] = timer.ms(lambda: pa.paged_decode_attention(q, kv, bt, ctx))
    res["first_version_ms"] = timer.ms(lambda: pa.paged_decode_attention(
        q, kv, bt, ctx, variant="simt"))
    span = res["span_pages"]
    res["plain_ms"] = timer.ms(
        lambda: pa.paged_decode_attention_split_plain(q, kv, bt, ctx, scale,
                                                      span),
        iters=3, warmup=1)
    res["gb_per_s"] = nbytes / res["ms"] / 1e6
    lmax = int(ctx_np.max())
    k, v = dense_kv(torch, kv, bt, lmax)
    mask = (torch.arange(lmax, device="cuda")[None, :]
            < ctx[:, None])[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None], k, v, attn_mask=mask)
    res["library_ms"] = timer.ms(sdpa)
    del k, v
    res["shape"] = {"S": S, "sum_ctx": sum_ctx, "max_pages": bt.shape[1],
                    "span_pages": span,
                    "spans": -(-bt.shape[1] // span)}
    return res


def check_decode(torch, pa, timer, dtype, S=MAX_SEQS):
    rng = np.random.default_rng(10)
    kv, bt = make_pool(torch, rng, dtype, S)
    ctx_np = rng.integers(1, MAX_BLOCKS * BS + 1, S).astype(np.int32)
    ctx_np[3] = 0                      # dead slot
    ctx_np[5] = MAX_BLOCKS * BS        # every page of the row
    ctx = torch.from_numpy(ctx_np).cuda()
    q = torch.from_numpy(rng.standard_normal((S, NH, HD), np.float32)).to(
        "cuda", dtype)
    res = checked_decode(torch, pa, q, kv, bt, ctx, "smoke")
    if dtype != torch.bfloat16:
        return res
    time_decode(torch, pa, timer, res, q, kv, bt, ctx, ctx_np)
    # the long contexts, every slot full, from the same pool
    res["long_context"] = {}
    for case, (S_l, n) in DECODE_LONG.items():
        bt_l = block_table(torch, rng, S_l, n // BS)
        ctx_l_np = np.full(S_l, n, np.int32)
        ctx_l = torch.from_numpy(ctx_l_np).cuda()
        q_l = torch.from_numpy(rng.standard_normal(
            (S_l, NH, HD), np.float32)).to("cuda", dtype)
        r = checked_decode(torch, pa, q_l, kv, bt_l, ctx_l, case)
        res["long_context"][case] = time_decode(torch, pa, timer, r, q_l,
                                                kv, bt_l, ctx_l, ctx_l_np)
        torch.cuda.empty_cache()
    return res


def prefill_variants_ran(pa, before):
    """Prefill launches by variant since the counts ``before``."""
    return {v: pa.VARIANT_LAUNCHES[f"paged_prefill/{v}"]
            - before[f"paged_prefill/{v}"] for v in ("wgmma", "simt")}


def check_prefill(torch, pa, timer, dtype, tq, S):
    """The prefill kernel the rule names (bf16: the tensor-core kernel,
    fp32: the scalar one) twice, bit for bit, against its plain version;
    in bf16 also the rule's scalar case (q 2 bytes off a 16-byte
    boundary) and the timings: kernel, the first (scalar) version on the
    same inputs, plain version, SDPA, bound."""
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
    name = str(dtype).split(".")[-1]
    expect = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = dict(pa.VARIANT_LAUNCHES)
    out = pa.paged_prefill_attention(q, kv, bt, pos0, ctx)
    again = pa.paged_prefill_attention(q, kv, bt, pos0, ctx)
    ref = pa.paged_prefill_attention_plain(q, kv, bt, pos0, ctx, scale)
    torch.cuda.synchronize()
    ran = prefill_variants_ran(pa, before)
    if ran != {v: 2 * int(v == expect) for v in ran}:
        fail(f"paged_prefill {name} tq={tq}: ran {ran}, expected {expect}")
    if not torch.equal(out, again):
        fail(f"paged_prefill {name} tq={tq}: two launches differ")
    if not torch.isfinite(out).all() or not torch.all(out[1] == 0):
        fail(f"paged_prefill {dtype} tq={tq}: non-finite or live dead seg")
    err = (out.float() - ref.float()).abs().max().item()
    if err > TOL[name]:
        fail(f"paged_prefill {name} tq={tq}: max-abs {err} > {TOL[name]}")
    res = {"max_abs_err": err, "variant": expect,
           "bit_identical_rerun": True}
    if dtype != torch.bfloat16:
        return res
    # the rule's scalar case in bf16: a contiguous q 2 bytes off a 16-byte
    # boundary
    buf = torch.empty(q.numel() + 1, dtype=dtype, device="cuda")
    qm = buf[1:].view(q.shape)
    qm.copy_(q)
    before = dict(pa.VARIANT_LAUNCHES)
    out_m = pa.paged_prefill_attention(qm, kv, bt, pos0, ctx)
    torch.cuda.synchronize()
    ran = prefill_variants_ran(pa, before)
    err_m = (out_m.float() - ref.float()).abs().max().item()
    if pa.paged_prefill_variant(qm, kv) != "simt" or \
            ran != {"wgmma": 0, "simt": 1} or err_m > TOL[name]:
        fail(f"paged_prefill bf16 tq={tq} misaligned q: ran {ran}, "
             f"max-abs {err_m}")
    res["misaligned_q"] = {"variant": "simt", "max_abs_err": err_m}
    del buf, qm, out_m
    res.update(time_prefill(torch, pa, timer, q, kv, bt, pos0_np, ctx_np))
    return res


def time_prefill(torch, pa, timer, q, kv, bt, pos0_np, ctx_np):
    """The prefill kernel, its first (scalar) version, the plain version
    and SDPA on gathered K/V timed on the same inputs, and the bound."""
    import torch.nn.functional as F

    S, tq = q.shape[:2]
    name = str(q.dtype).split(".")[-1]
    scale = HD ** -0.5
    pos0 = torch.from_numpy(pos0_np).cuda()
    ctx = torch.from_numpy(ctx_np).cuda()
    res = {}
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
    res["first_version_ms"] = timer.ms(lambda: pa.paged_prefill_attention(
        q, kv, bt, pos0, ctx, variant="simt"))
    res["plain_ms"] = timer.ms(lambda: pa.paged_prefill_attention_plain(
        q, kv, bt, pos0, ctx, scale), iters=3, warmup=1)
    res["gb_per_s"] = nbytes / res["ms"] / 1e6
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
    inputs, each twice, bit for bit, through the variant the dispatch
    rule names; bf16 at the smoke shape also timed against its bound,
    its plain version, SDPA and the first (scalar) version."""
    import torch.nn.functional as F

    q, k, v, do, seg, causal, scale = flash_inputs(torch, dtype, case, 30)
    name = str(dtype).split(".")[-1]
    variants = dict(fa.VARIANT_LAUNCHES)
    o, lse = fa._flash_fwd(q, k, v, seg, causal, scale)
    o2, lse2 = fa._flash_fwd(q, k, v, seg, causal, scale)
    # bf16 at hd 128 takes the tensor-core forward, the rest the scalar one
    ran = [var for var in ("wgmma", "simt")
           if fa.VARIANT_LAUNCHES[f"flash_fwd/{var}"]
           != variants[f"flash_fwd/{var}"]]
    expect = "wgmma" if dtype == torch.bfloat16 and q.shape[-1] == 128 \
        else "simt"
    if ran != [expect]:
        fail(f"flash_fwd {name} {case}: ran {ran}, expected {expect}")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, seg, lse, delta, do, causal, scale)
    dk, dv = fa.flash_bwd_dkdv(*args)
    dq = fa.flash_bwd_dq(*args)
    dk2, dv2 = fa.flash_bwd_dkdv(*args)
    dq2 = fa.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    # the backward by the same rule: two launches each, all of one variant
    for kern in ("flash_bwd_dkdv", "flash_bwd_dq"):
        ran = {var: fa.VARIANT_LAUNCHES[f"{kern}/{var}"]
               - variants[f"{kern}/{var}"] for var in ("wgmma", "simt")}
        if ran != {var: 2 * int(var == expect) for var in ran}:
            fail(f"{kern} {name} {case}: ran {ran}, expected {expect}")
    if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
            and torch.equal(dv, dv2)):
        fail(f"flash backward {name} {case}: two launches differ")
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        fail(f"flash forward {name} {case}: two launches differ")
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, seg, causal, scale)
    dk_ref, dv_ref = fa.flash_bwd_dkdv_plain(*args)
    dq_ref = fa.flash_bwd_dq_plain(*args)
    res = {}

    def err(got, want, rel):
        if not torch.isfinite(got).all():
            fail(f"flash {name} {case}: non-finite output")
        e = (got.float() - want.float()).abs().max().item()
        if not rel:
            return {"max_abs_err": e}
        return {"max_abs_err": e, "max_row_rel_err": row_rel_err(
            torch, got, want, GRAD_ROW_FLOOR)}

    res["flash_fwd"] = err(o, o_ref, False)
    res["flash_fwd"]["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
    res["flash_fwd"]["variant"] = expect
    res["flash_fwd"]["bit_identical_rerun"] = True
    if res["flash_fwd"]["max_abs_err"] > TOL[name] or \
            res["flash_fwd"]["lse_max_abs_err"] > 1e-4:
        fail(f"flash_fwd {name} {case}: {res['flash_fwd']} over "
             f"{TOL[name]} (lse 1e-4)")
    ek, ev = err(dk, dk_ref, True), err(dv, dv_ref, True)
    res["flash_bwd_dkdv"] = {
        "max_abs_err": max(ek["max_abs_err"], ev["max_abs_err"]),
        "max_row_rel_err": max(ek["max_row_rel_err"],
                               ev["max_row_rel_err"]),
        "dk_max_row_rel_err": ek["max_row_rel_err"],
        "dv_max_row_rel_err": ev["max_row_rel_err"]}
    res["flash_bwd_dq"] = err(dq, dq_ref, True)
    for kern in ("flash_bwd_dkdv", "flash_bwd_dq"):
        res[kern]["variant"] = expect
        res[kern]["bit_identical_rerun"] = True
        if res[kern]["max_row_rel_err"] > GRAD_TOL_REL[name]:
            fail(f"{kern} {name} {case}: {res[kern]} over "
                 f"{GRAD_TOL_REL[name]} of a gradient row's largest entry")
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
    for kern in work:
        res[kern]["tflops"] = res[kern]["flops"] / res[kern]["ms"] / 1e9
    # the first version: the scalar kernels on the same bf16 inputs
    res["flash_fwd"]["first_version_ms"] = timer.ms(
        lambda: fa._flash_fwd_launch(q, k, v, seg, causal, scale, "simt"),
        iters=3, warmup=1)
    for kern in ("flash_bwd_dkdv", "flash_bwd_dq"):
        res[kern]["first_version_ms"] = timer.ms(
            lambda: fa._flash_bwd_launch(kern, *args, "simt"), iters=3,
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


# -- phase 2c: grouped matmuls -----------------------------------------------


def grouped_mm_call(torch, gm, name, lhs, other, gs, sizes):
    """A ``torch._grouped_mm`` call computing the same function on the
    same inputs (layouts prepared outside the timed call), or None with
    the reason when the installed torch has none for these operands. A
    yardstick only: the port never calls it."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm missing"
    # with the groups along the contraction dim (tgmm), every group but
    # the last must span a multiple of 16 bytes; the library checks this
    # with a device-side assert, which would end the process
    align = 16 // lhs.element_size()
    if name == "tgmm" and any(s % align for s in sizes[:-1]):
        return None, f"group sizes not multiples of {align} rows"
    offs = torch.cumsum(gs, 0).to(torch.int32)

    def col_major(b):
        return b.transpose(-2, -1).contiguous().transpose(-2, -1)

    if name == "gmm":
        layouts = [(lhs, other), (lhs, col_major(other))]
    elif name == "gmm_transposed":  # other is rhs [E, K, N]: B[g] = rhs[g]^T
        layouts = [(lhs, other.transpose(-2, -1))]
    else:  # tgmm: groups along the contraction dim M
        a = lhs.t().contiguous()
        layouts = [(a, other), (a, col_major(other))]
    want = {"gmm": gm.gmm_plain, "gmm_transposed": gm.gmm_transposed_plain,
            "tgmm": gm.tgmm_plain}[name](lhs, other, gs)
    why = None
    for args in layouts:
        try:
            got = fn(*args, offs=offs)
            torch.cuda.synchronize()
        except RuntimeError as e:  # capability probe, not a phase
            why = f"torch._grouped_mm refused: {str(e)[:160]}"
            continue
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        if got.shape == want.shape and err <= GMM_TOL_REL["bfloat16"]:
            return (lambda: fn(*args, offs=offs)), None
        why = f"torch._grouped_mm disagrees ({err})"
    return None, why


def check_gmm(torch, gm, timer, dtype, case):
    """gmm, gmm^T and tgmm against their plain versions on the same
    inputs; bf16 at the train and decode shapes also timed against the
    bound, the plain version and torch._grouped_mm."""
    sizes, M, K, N = GMM_CASES[case]
    M = sum(sizes) if M is None else M
    name = str(dtype).split(".")[-1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)  # drawn on the card: the weights are ~0.5 G values

    def t(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    lhs, rhs, dout = t(M, K), t(len(sizes), K, N), t(M, N)
    calls = {  # kernel call, plain call
        "gmm": (lambda: gm.gmm_raw(lhs, rhs, gs),
                lambda: gm.gmm_plain(lhs, rhs, gs)),
        "gmm_transposed": (
            lambda: gm.gmm_raw(dout, rhs, gs, transpose_rhs=True),
            lambda: gm.gmm_transposed_plain(dout, rhs, gs)),
        "tgmm": (lambda: gm.tgmm(lhs, dout, gs),
                 lambda: gm.tgmm_plain(lhs, dout, gs)),
    }
    end = min(sum(sizes), M)
    res = {}
    for kern, (kernel, plain) in calls.items():
        variants = dict(gm.VARIANT_LAUNCHES)
        got, want = kernel(), plain()
        again = kernel()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{kern} {name} {case}: shape {tuple(got.shape)} or "
                 "non-finite output")
        if not torch.equal(got, again):
            fail(f"{kern} {name} {case}: two launches gave other bits")
        # bf16 at the aligned shapes takes the tensor-core kernel, the
        # rest (fp32, odd K or N) the scalar one
        ran = [v for v in ("wgmma", "simt")
               if gm.VARIANT_LAUNCHES[f"{kern}/{v}"]
               != variants[f"{kern}/{v}"]]
        expect = "wgmma" if dtype == torch.bfloat16 and \
            not case.startswith("odd") else "simt"
        if ran != [expect]:
            fail(f"{kern} {name} {case}: ran {ran}, expected {expect}")
        if kern != "tgmm" and not torch.all(got[end:] == 0):
            fail(f"{kern} {name} {case}: rows no group owns are not zero")
        if kern == "tgmm" and any(not torch.all(got[e] == 0)
                                  for e, n in enumerate(sizes) if n == 0):
            fail(f"tgmm {name} {case}: an empty group is not zero")
        e = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        res[kern] = {"max_abs_err": e, "max_rel_err": e / top,
                     "bit_identical_rerun": True, "variant": ran[0]}
        if e > GMM_TOL_REL[name] * top:
            fail(f"{kern} {name} {case}: max-abs {e} over "
                 f"{GMM_TOL_REL[name]} x {top}")
    if not (dtype == torch.bfloat16
            and case in ("train_wi", "train_wo", "decode")):
        return res

    itm, E_used = lhs.element_size(), sum(1 for n in sizes if n > 0)
    rows = min(sum(sizes), M)
    work = {  # bytes each input read once (the weights of groups with
        # rows only) and each output written once; flops of owned rows
        "gmm": ((M * K + E_used * K * N + M * N) * itm + 4 * len(sizes),
                2 * rows * K * N),
        "gmm_transposed": ((M * N + E_used * K * N + M * K) * itm
                           + 4 * len(sizes), 2 * rows * K * N),
        "tgmm": ((M * K + M * N + len(sizes) * K * N) * itm
                 + 4 * len(sizes), 2 * rows * K * N),
    }
    other = {"gmm": rhs, "gmm_transposed": rhs, "tgmm": dout}
    for kern, (kernel, plain) in calls.items():
        if case == "decode" and kern != "gmm":
            continue  # serving runs the forward only
        nbytes, flops = work[kern]
        r = res[kern]
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, name)
        r["flops"], r["bytes"] = flops, nbytes
        r["ms"] = timer.ms(kernel, iters=5, warmup=1)
        r["tflops"] = flops / r["ms"] / 1e9
        r["plain_ms"] = timer.ms(plain, iters=3, warmup=1)
        # the first version: the scalar kernel on the same bf16 inputs
        if kern == "tgmm":
            r["first_version_ms"] = timer.ms(
                lambda: gm._tgmm_launch(lhs, dout, gs, "simt"), iters=3,
                warmup=1)
        else:
            a = dout if kern == "gmm_transposed" else lhs
            r["first_version_ms"] = timer.ms(
                lambda: gm._gmm_launch(a, rhs, gs, kern == "gmm_transposed",
                                       "simt"), iters=3, warmup=1)
        src = dout if kern == "gmm_transposed" else lhs
        lib, why = grouped_mm_call(torch, gm, kern, src, other[kern], gs,
                                   sizes)
        r["library_ms"] = None if lib is None else timer.ms(lib, iters=5,
                                                            warmup=1)
        if why:
            r["library_note"] = why
            log(f"{kern} {case}: no library yardstick: {why}")
    res["shape"] = {"E": len(sizes), "M": M, "K": K, "N": N,
                    "group_sizes": sizes}
    return res


# -- phase 2d: quantize kernels ----------------------------------------------


def quant_values(torch, gen, shape, block, top, dtype):
    """Seeded values on the card, patterned per block of ``block`` along
    the last dim: normal blocks, blocks of exact .5 ties on a unit grid
    (absmax ``top`` makes the scale exactly 1), all-zero blocks, and
    blocks reaching past both ends of the grid (top - 0.5, -top - 0.5)."""
    x = torch.randn(shape, generator=gen, device="cuda") * 3
    xb = x.view(-1, block)
    ties = torch.randint(-top, top, xb.shape, generator=gen,
                         device="cuda").float() + 0.5
    xb[::7] = ties[::7]
    xb[::7, 0] = top
    xb[3::11] = 0.0
    xb[5::13, 0] = top - 0.5
    xb[5::13, 1] = -top - 0.5
    return x.to(dtype)


def bit_equal(torch, a, b):
    """Same shape, dtype and bytes (fp8 compared as its bytes)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float8_e4m3fn:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return bool(torch.equal(a, b))


def check_quantize(torch, qz, timer, dtype, block, bits):
    """K1 on one layer's mlp.wi shape against its plain version, bit for
    bit; bf16 / block 128 / int8 (the weight path's case) also timed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(50 + block + bits)
    top = (1 << (bits - 1)) - 1
    x = quant_values(torch, gen, QUANT_SHAPE, block, top, dtype)
    q, s = qz.quantize_blockwise(x, bits=bits, block=block)
    q_ref, s_ref = qz._quantize_ref(x, bits, block)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    if not (bit_equal(torch, q, q_ref) and bit_equal(torch, s, s_ref)):
        fail(f"quantize_blockwise {name} block {block} bits {bits}: not "
             f"bit-equal to the plain version (codes differ at "
             f"{int((q != q_ref).sum())}, scales at "
             f"{int((s != s_ref).sum())})")
    res = {"bit_equal": True, "max_abs_err": 0.0}
    if (dtype, block, bits) != (torch.bfloat16, 128, 8):
        return res
    n = x.numel()
    # each value read once, its code and each block's scale written once;
    # about four fp32 operations a value (|x| and max, divide, round, clip)
    nbytes = n * x.element_size() + n + s.numel() * 4
    res["bound_ms"], res["bound_by"] = bound(nbytes, 4 * n, "float32")
    res["ms"] = timer.ms(lambda: qz.quantize_blockwise(x, bits=8,
                                                       block=128))
    res["plain_ms"] = timer.ms(lambda: qz._quantize_ref(x, 8, 128),
                               iters=3, warmup=1)
    res["shape"] = {"x": list(QUANT_SHAPE), "dtype": name, "block": block,
                    "bits": bits}
    return res


def check_kv_append(torch, qz, timer, bits, ntok, dtype):
    """K2 into a 2048 x 16 layer pool against its plain version (kv_quantize
    -> kv_pack -> scatter) on the same inputs, bit for bit outside the
    scratch block; the last 3 tokens are padding routed there."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(60 + ntok)
    W = HD // 2 if bits == 4 else HD
    pdt = {8: torch.int8, 4: torch.uint8, "fp8": torch.float8_e4m3fn}[bits]
    init = torch.randint(0, 256, (KV_BLOCKS, BS, 2, NKV, W), generator=gen,
                         device="cuda", dtype=torch.uint8)
    pools = [init.clone().view(pdt) for _ in range(2)]
    scales = [torch.ones((KV_BLOCKS, BS, 2, NKV), device="cuda")
              for _ in range(2)]
    slots = torch.randperm((KV_BLOCKS - 1) * BS, generator=gen,
                           device="cuda")[:ntok]
    page, offset = slots // BS, slots % BS
    page[-3:], offset[-3:] = KV_BLOCKS - 1, BS - 1
    top = {8: 127, 4: 7, "fp8": 448}[bits]
    k, v = (quant_values(torch, gen, (ntok, NKV, HD), HD, top, dtype)
            for _ in range(2))
    qz.kv_quantize_append(pools[0], scales[0], page, offset, k, v, bits)
    qz.kv_quantize_append_plain(pools[1], scales[1], page, offset, k, v,
                                bits)
    torch.cuda.synchronize()
    if not (bit_equal(torch, pools[0][:-1], pools[1][:-1])
            and bit_equal(torch, scales[0][:-1], scales[1][:-1])):
        fail(f"kv_quantize_append bits {bits} ntok {ntok}: not bit-equal "
             "to kv_quantize -> kv_pack -> scatter")
    res = {"bit_equal": True, "max_abs_err": 0.0}
    if bits != 8 or dtype != torch.bfloat16:
        return res
    vecs = 2 * ntok * NKV
    # K and V read once; codes, scales and the page / offset of each
    # token written / read once
    nbytes = vecs * HD * k.element_size() + vecs * (W + 4) + 2 * ntok * 8
    res["bound_ms"], res["bound_by"] = bound(nbytes, 4 * vecs * HD,
                                             "float32")
    res["ms"] = timer.ms(lambda: qz.kv_quantize_append(
        pools[0], scales[0], page, offset, k, v, bits))
    res["plain_ms"] = timer.ms(lambda: qz.kv_quantize_append_plain(
        pools[1], scales[1], page, offset, k, v, bits), iters=3, warmup=1)
    res["shape"] = {"tokens": ntok, "kv_heads": NKV, "head_dim": HD,
                    "pool": [KV_BLOCKS, BS, 2, NKV, W], "k_dtype":
                    str(dtype).split(".")[-1]}
    return res


def check_dequant(torch, qz, wq, timer, case):
    """K3 against its plain version on the same inputs, bit for bit: a
    2048 x 16 layer pool of each rung into bf16, or one layer's mlp.wi
    slice quantized at block 128 (QuantizedTensor.to); all timed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(70)
    if case == "weight":
        w = torch.randn(QUANT_SHAPE, generator=gen, device="cuda").to(
            torch.bfloat16)
        qt = wq.quantize_weight(w)
        del w
        payload, sc = qt.q, qt.scale[..., 0]
        kernel = lambda: qt.to(torch.bfloat16)  # noqa: E731
    else:
        W = HD // 2 if case == 4 else HD
        pdt = {8: torch.int8, 4: torch.uint8,
               "fp8": torch.float8_e4m3fn}[case]
        codes = torch.randint(0, 256, (KV_BLOCKS, BS, 2, NKV, W),
                              generator=gen, device="cuda",
                              dtype=torch.uint8)
        if case == "fp8":
            codes[(codes & 0x7F) == 0x7F] = 0  # no NaN codes
        payload = codes.view(pdt)
        sc = torch.rand((KV_BLOCKS, BS, 2, NKV), generator=gen,
                        device="cuda")
        scratch = torch.empty((KV_BLOCKS, BS, 2, NKV, HD),
                              dtype=torch.bfloat16, device="cuda")
        kernel = lambda: qz.dequantize(payload, sc,  # noqa: E731
                                       torch.bfloat16, out=scratch)
    got = kernel().reshape(*payload.shape[:-1], -1)
    want = qz.dequantize_plain(payload, sc, torch.bfloat16)
    torch.cuda.synchronize()
    if not bit_equal(torch, got, want):
        fail(f"dequantize {case}: not bit-equal to the plain version")
    n = got.numel()
    # codes and scales read once, the bf16 values written once; one
    # multiply a value
    nbytes = payload.numel() + sc.numel() * 4 + n * 2
    res = {"bit_equal": True, "max_abs_err": 0.0}
    res["bound_ms"], res["bound_by"] = bound(nbytes, n, "float32")
    res["ms"] = timer.ms(kernel)
    res["plain_ms"] = timer.ms(lambda: qz.dequantize_plain(
        payload, sc, torch.bfloat16), iters=3, warmup=1)
    res["shape"] = {"payload": list(payload.shape),
                    "payload_dtype": str(payload.dtype).split(".")[-1],
                    "out_dtype": "bfloat16"}
    return res


# -- phase 2e: block-sparse forward ---------------------------------------------


def bs_custom_layout(bs):
    """A layout with an empty query block (block row 3; non-causal) on
    the diagonal plus a global first column."""
    class EmptyRow(bs.SparsityConfig):
        def make_layout(self, seq_len):
            n = self.num_blocks(seq_len)
            lay = np.eye(n, dtype=bool)
            lay[:, 0] = True
            lay[3, :] = False
            return lay

    return EmptyRow(BS_BLOCK)


def bs_sparsity(bs, case):
    mode, block = BS_CASES[case][:2]
    if mode == "custom":
        return bs_custom_layout(bs)
    return bs.make_sparsity_config(mode, block=block)


def bs_inputs(torch, dtype, case, seed):
    _, _, S, hkv, _ = BS_CASES[case]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, S, h, HD), np.float32))
            .to("cuda", dtype) for h in (NH, hkv, hkv)]


def masked_by_heads(torch, attn, bs, q, k, v, sparsity, causal):
    """The masked form after repeat_kv_heads, 8 q heads at a time (the
    heads are independent; the fp32 score tensor of all 32 at S 8192
    would need 8.6 GB a copy)."""
    g = q.shape[2] // k.shape[2]  # 1 or 4: 8 heads hold whole groups
    outs = []
    for h0 in range(0, q.shape[2], 8):
        kv = slice(h0 // g, (h0 + 8) // g)
        kr, vr = attn.repeat_kv_heads(q[:, :, h0:h0 + 8], k[:, :, kv],
                                      v[:, :, kv])
        outs.append(bs.blocksparse_attention(q[:, :, h0:h0 + 8], kr, vr,
                                             sparsity, causal=causal))
    return torch.cat(outs, dim=2)


def row_rel_err(torch, got, want, floor=0.0):
    """The largest, over output rows (the last axis is D), of a row's
    largest |got - want| over its largest |want|, or over ``floor`` times
    the largest |want| of the tensor where that is more; with no floor a
    row of zeros must be matched exactly."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    top = want.abs().amax(-1)
    top = top.clamp_min(max(floor * top.max().item(),
                            torch.finfo(torch.float32).tiny))
    return (err / top).max().item()


def check_blocksparse(torch, bs, attn, timer, dtype, case):
    """The kernel the rule names (bf16 with a layout block that is a
    multiple of 128: the tensor-core kernel; the rest the scalar one)
    against its plain version at the kernel's tile and against the
    masked form on the same inputs; two launches bit for bit; at the
    timed cases also kernel, the first (scalar) version on the same
    inputs, plain version and SDPA with the layout as a boolean mask
    timed against the bound."""
    import torch.nn.functional as F

    name = str(dtype).split(".")[-1]
    mode, block, S, hkv, causal = BS_CASES[case]
    sparsity = bs_sparsity(bs, case)
    q, k, v = bs_inputs(torch, dtype, case, 40)
    scale = HD ** -0.5
    expect = ("wgmma" if dtype == torch.bfloat16 and block % bs.TC_TILE == 0
              else "simt")
    before = dict(bs.VARIANT_LAUNCHES)
    got = bs.blocksparse_attention_kernel(q, k, v, sparsity, causal=causal)
    again = bs.blocksparse_attention_kernel(q, k, v, sparsity, causal=causal)
    tile = bs.TC_TILE if expect == "wgmma" else bs.TILE
    work = bs.work_list(sparsity, S, causal, q.device, tile)
    plain = bs.blocksparse_fwd_plain(q, k, v, work, scale)
    torch.cuda.synchronize()
    ran = {v_: bs.VARIANT_LAUNCHES[f"blocksparse_fwd/{v_}"]
           - before[f"blocksparse_fwd/{v_}"] for v_ in ("wgmma", "simt")}
    if ran != {v_: 2 * int(v_ == expect) for v_ in ran}:
        fail(f"blocksparse {name} {case}: ran {ran}, expected {expect}")
    if got.shape != q.shape or not torch.isfinite(got).all():
        fail(f"blocksparse {name} {case}: wrong shape or non-finite")
    if not torch.equal(got, again):
        fail(f"blocksparse {name} {case}: two launches differ")
    pairs = bs.visible_pairs(work.layout_host, block, S, causal)
    res = {"variant": expect, "tile": tile, "bit_identical_rerun": True,
           "max_abs_err": (got.float() - plain.float()).abs().max().item(),
           "max_row_rel_err": row_rel_err(torch, got, plain),
           "layout_density": bs.layout_density(work.layout_host, causal),
           "pair_density": pairs / (S * (S + 1) // 2 if causal else S * S),
           "live_tiles": int(work.live.sum()), "tiles": work.live.size}
    if res["max_row_rel_err"] > BS_TOL_ROW[name]:
        fail(f"blocksparse {name} {case}: kernel vs plain {res} over "
             f"{BS_TOL_ROW[name]} of a row's largest entry")
    if mode == "custom":
        rows = slice(3 * block, 4 * block)
        if not (torch.all(got[:, rows] == 0) and torch.all(plain[:, rows]
                                                          == 0)):
            fail(f"blocksparse {name} {case}: the empty row is not 0")
        res["empty_row_zero"] = True
    else:
        masked = masked_by_heads(torch, attn, bs, q, k, v, sparsity, causal)
        res["masked_max_row_rel_err"] = row_rel_err(torch, got, masked)
        if res["masked_max_row_rel_err"] > BS_MASKED_TOL_ROW[name]:
            fail(f"blocksparse {name} {case}: kernel vs masked form "
                 f"{res['masked_max_row_rel_err']} over "
                 f"{BS_MASKED_TOL_ROW[name]} of a row's largest entry")
        del masked
    if not (dtype == torch.bfloat16 and case in BS_TIMED):
        return res
    itm = q.element_size()
    nbytes = 2 * S * NH * HD * itm + 2 * S * hkv * HD * itm
    flops = 4 * HD * NH * pairs
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, name)
    res["flops"] = flops
    res["ms"] = timer.ms(lambda: bs.blocksparse_attention_kernel(
        q, k, v, sparsity, causal=causal))
    res["tflops"] = flops / res["ms"] / 1e9
    res["first_version_ms"] = timer.ms(
        lambda: bs.blocksparse_attention_kernel(
            q, k, v, sparsity, causal=causal, variant="simt"),
        iters=3, warmup=1)
    res["plain_ms"] = timer.ms(lambda: bs.blocksparse_fwd_plain(
        q, k, v, work, scale), iters=3, warmup=1)
    # yardstick: SDPA on [B, H, S, D] copies with the KV heads expanded and
    # the layout (and causality) as a boolean mask: it computes every block
    mask = torch.from_numpy(np.repeat(np.repeat(
        work.layout_host, block, 0), block, 1)[:S, :S]).cuda()
    if causal:
        mask &= torch.ones((S, S), dtype=torch.bool, device="cuda").tril()
    kr, vr = attn.repeat_kv_heads(q, k, v)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kr, vr))
    res["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    res["shape"] = {"B": 1, "S": S, "Hq": NH, "Hkv": hkv, "D": HD,
                    "causal": causal, "mode": mode, "block": block,
                    "visible_pairs_per_head": pairs}
    del qt, kt, vt, kr, vr, mask
    return res


# -- phase 3: serve ----------------------------------------------------------


def prompts_for(seed, vocab=128256):
    """8 prompts of 64-512 tokens; uid 0 and uid 7 share their first 256
    tokens. uid 7 is submitted after uid 0's prefix is in the cache."""
    rng = np.random.default_rng(seed)
    lens = [448, 64, 96, 160, 224, 288, 512, 320]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    prompts[7][:256] = prompts[0][:256]
    return prompts


def serve_engine(torch, InferenceEngineV2, model, **engine_kw):
    return InferenceEngineV2(model, kv_blocks=KV_BLOCKS, kv_block_size=BS,
                             max_tokens_per_step=MAX_TOKENS,
                             max_seqs_per_step=MAX_SEQS,
                             max_blocks_per_seq=MAX_BLOCKS,
                             decode_steps=DECODE_STEPS, **engine_kw)


def start_profile(torch):
    from torch.profiler import ProfilerActivity
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def serve_workload(torch, eng, prompts, on_round=None):
    """The 8-request workload through ``put``, ``serve_step`` and
    ``generate_all``. ``on_round(eng, out)``, when given, runs after each
    ``serve_step`` round until it returns True; ``generate_all`` serves
    the rest. Returns (streams, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.put(list(range(7)), prompts[:7], max_new_tokens=NEW_TOKENS)
    out = {}

    def take(emitted):
        for uid, toks in emitted.items():
            out.setdefault(uid, []).extend(toks)

    # one round prefills uid 0's first 256 tokens (16 full blocks), which
    # the prefix cache then offers to uid 7
    take(eng.serve_step())
    eng.put([7], prompts[7:], max_new_tokens=NEW_TOKENS)
    if on_round is not None:
        while eng.state.seqs:
            take(eng.serve_step())
            if on_round(eng, out):
                break
    take(eng.generate_all())
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_once(torch, zoo, InferenceEngineV2, profile=False,
               preset="llama3-8b", vocab=128256, model=None, **over):
    if model is None:
        model = zoo.get_model(preset, device="cuda", seed=SEED, **over)
    eng = serve_engine(torch, InferenceEngineV2, model)
    prompts = prompts_for(SEED + 1, vocab)
    prof = start_profile(torch) if profile else None
    out, wall = serve_workload(torch, eng, prompts)
    if prof is not None:
        prof.__exit__(None, None, None)
        return out, wall, prof
    return model, eng, out, wall, prompts


def kernel_family(name):
    """A kernel's family by its name: each hand kernel, the library's
    matmuls, copies, and ``other`` (the elementwise passes and
    reductions)."""
    n = name.lower()
    grouped = "gmm_kernel" in n or "gmm_wgmma_kernel" in n
    return ("blocksparse_fwd" if "blocksparse_fwd" in n else
            "quantize_blockwise" if "quantize_blockwise_kernel" in n else
            "kv_quantize_append" if "kv_quantize_append_kernel" in n else
            "dequantize" if "dequantize_kernel" in n else
            "paged_decode" if "paged_decode" in n else
            "paged_prefill" if "paged_prefill" in n else
            "flash_fwd" if ("flash_fwd_kernel" in n
                            or "flash_fwd_wgmma_kernel" in n) else
            "flash_bwd_dkdv" if "flash_bwd_dkdv" in n else
            "flash_bwd_dq" if "flash_bwd_dq" in n else
            "tgmm" if "tgmm_kernel" in n or "tgmm_wgmma_kernel" in n else
            "gmm_transposed" if grouped and ", true>" in n else
            "gmm" if grouped else
            "matmul" if any(k in n for k in ("gemm", "xmma", "cutlass",
                                             "cublas", "matmul",
                                             "nvjet")) else
            "copy" if "memcpy" in n or "memset" in n else "other")


def device_breakdown(torch, prof, wall_s, units, unit="generated_token"):
    """Device time of a profiled run by kernel family, the union of busy
    intervals, and the idle share of the host wall time; ``units`` of
    ``unit`` (generated tokens, train steps) divide the kernel count."""
    from torch.autograd import DeviceType

    # kernels only: a record_function range (the model's region ranges,
    # utils/annotate.py) also leaves a device-side annotation spanning
    # the kernels it encloses
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in OBS_RANGES]
    if not kern:
        return {"device_time_measured": False}
    fams = {}
    spans = []
    for e in kern:
        fam = kernel_family(e.name)
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

    def union(spans):
        spans = sorted(spans)
        if not spans:
            return 0.0
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        return busy + cur_e - cur_s

    busy = union(spans)
    # the same union without the memcpy / memset engines' spans
    compute = union([(e.time_range.start, e.time_range.end) for e in kern
                     if "memcpy" not in e.name.lower()
                     and "memset" not in e.name.lower()])
    return {"device_time_measured": True, "wall_s": wall_s,
            "device_busy_s": busy / 1e6,
            "device_idle_share": 1.0 - busy / 1e6 / wall_s,
            "device_busy_without_copies_s": compute / 1e6,
            "device_idle_share_without_copies": 1.0 - compute / 1e6 / wall_s,
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


def fixed_batches(vocab, micro=TRAIN_MICRO):
    """Two fixed microbatches of TRAIN_SEQ + 1 tokens, cycled so that
    the loss can fall."""
    rng = np.random.default_rng(SEED + 2)
    fixed = [{"input_ids": rng.integers(0, vocab, (micro, TRAIN_SEQ + 1))
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
    variants = dict(fa.VARIANT_LAUNCHES)
    L, steps = TRAIN_LAYERS, TRAIN_MEASURED
    want = {"flash_fwd": steps * 2 * L * TRAIN_GAS,  # forward + remat replay
            "flash_bwd_dkdv": steps * L * TRAIN_GAS,
            "flash_bwd_dq": steps * L * TRAIN_GAS}
    if launches != want:
        fail(f"train: flash launches {launches}, remat implies {want}")
    check_tensor_core("train", launches, variants,
                      ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))
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
        "variant_launches": variants,
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
    return train, profile, {**launches, **variants}


# -- phase 9: checkpoint ----------------------------------------------------


def leaf_checksum(torch, t, chunk=1 << 26):
    """A bitwise checksum of a tensor on the card: the int64 sums (mod
    2**64) of its raw bits, plain and weighted by position (a swap of two
    elements changes the second)."""
    if t.dim() == 0:
        return [t.item()]
    bits = t.detach().contiguous().view(
        {2: torch.int16, 4: torch.int32}[t.element_size()]).flatten()
    s1 = s2 = 0
    for start in range(0, bits.numel(), chunk):
        c = bits[start:start + chunk].to(torch.int64)
        pos = torch.arange(start + 1, start + 1 + c.numel(),
                           device=c.device)
        s1 = (s1 + int(c.sum())) % 2 ** 64
        s2 = (s2 + int((c * pos).sum())) % 2 ** 64
    return [s1, s2]


def state_checksums(torch, engine):
    """Per leaf of the saved state: its checksum."""
    from deepspeed_tpu_torch.runtime.optimizer import leaves

    return {path: leaf_checksum(torch, t)
            for path, t in leaves(engine._ckpt_io._state())}


def ckpt_loader(DeepSpeedDataLoader, RepeatingLoader, vocab):
    """Seeded token rows, shuffled (seed 7) and repeated: 16 rows make 8
    microbatches an epoch, so the 5 steps restart the epoch."""
    rng = np.random.default_rng(SEED + 9)
    rows = [{"input_ids": rng.integers(0, vocab, (TRAIN_SEQ + 1,))
             .astype(np.int32)} for _ in range(CKPT_ROWS)]
    return RepeatingLoader(DeepSpeedDataLoader(rows, batch_size=1,
                                               shuffle=True, seed=7))


def timed_steps(torch, engine, it, n):
    losses, secs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(it)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return losses, secs


def checkpoint_phase(torch, zoo, initialize, fa, DeepSpeedDataLoader,
                     RepeatingLoader, validate_manifest):
    """Returns (checkpoint line, flash launches of the resumed steps)."""
    from deepspeed_tpu_torch.runtime.optimizer import leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = zoo.get_model("llama3-8b", num_layers=CKPT_LAYERS,
                          dtype=torch.float32, seed=SEED)
    cfg = model.config
    engine, *_ = initialize(model=model, config=dict(CKPT_CONFIG))
    it = ckpt_loader(DeepSpeedDataLoader, RepeatingLoader, cfg.vocab_size)
    before, _ = timed_steps(torch, engine, it, CKPT_BEFORE)
    state_bytes = sum(t.nbytes for _, t in leaves(engine._ckpt_io._state()))
    root = tempfile.mkdtemp(prefix="dstpu_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        if free < 1.1 * state_bytes:
            fail(f"checkpoint: {free / 1e9:.1f} GB free at {root}, the "
                 f"state needs {state_bytes / 1e9:.1f} GB")
        t0 = time.perf_counter()
        tag_dir = engine.save_checkpoint(root)
        save_s = time.perf_counter() - t0
        sums = state_checksums(torch, engine)
        ref, ref_s = timed_steps(torch, engine, it, CKPT_AFTER)
        del engine, model, it
        torch.cuda.empty_cache()

        model = zoo.get_model("llama3-8b", num_layers=CKPT_LAYERS,
                              dtype=torch.float32, seed=SEED + 1)
        engine, *_ = initialize(model=model, config=dict(CKPT_ASYNC_CONFIG))
        if state_checksums(torch, engine) == sums:
            fail("checkpoint: engine B starts from A's state")
        t0 = time.perf_counter()
        ckpt_dir, _ = engine.load_checkpoint(root)
        load_s = time.perf_counter() - t0
        parts = dict(engine._ckpt_io.last_load_s)
        if ckpt_dir != tag_dir or engine.global_steps != CKPT_BEFORE:
            fail(f"checkpoint: loaded {ckpt_dir} at step "
                 f"{engine.global_steps}")
        got = state_checksums(torch, engine)
        bad = sorted(p for p in sums if got.get(p) != sums[p])
        if bad or sorted(got) != sorted(sums):
            fail(f"checkpoint: restored leaves differ from the saved ones: "
                 f"{bad[:5]}")
        src = ckpt_loader(DeepSpeedDataLoader, RepeatingLoader,
                          cfg.vocab_size)
        it = engine.resume_data_iter(src, source=src)
        fa.reset_launch_counts()
        resumed, step_s = timed_steps(torch, engine, it, CKPT_AFTER)
        launches = dict(fa.LAUNCHES)
        variants = dict(fa.VARIANT_LAUNCHES)
        if resumed != ref:
            fail(f"checkpoint: resumed losses {resumed} are not the "
                 f"uninterrupted run's {ref}")
        L, steps, gas = CKPT_LAYERS, CKPT_AFTER, 2
        want = {"flash_fwd": steps * 2 * L * gas,  # forward + remat replay
                "flash_bwd_dkdv": steps * L * gas,
                "flash_bwd_dq": steps * L * gas}
        if launches != want:
            fail(f"checkpoint: flash launches {launches}, remat implies "
                 f"{want}")
        check_tensor_core("checkpoint", launches, variants,
                          ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))
        shutil.rmtree(tag_dir)
        os.remove(os.path.join(root, "latest"))

        # the async save: 'latest' only after the commit
        t0 = time.perf_counter()
        async_dir = engine.save_checkpoint(root)
        blocking_s = time.perf_counter() - t0
        if os.path.exists(os.path.join(root, "latest")):
            fail("checkpoint: the async save published 'latest' before "
                 "its commit")
        t0 = time.perf_counter()
        engine._ckpt_io.commit_pending()
        commit_s = time.perf_counter() - t0
        with open(os.path.join(root, "latest")) as f:
            latest = f.read().strip()
        t0 = time.perf_counter()
        doc = validate_manifest(async_dir)
        async_validate_s = time.perf_counter() - t0
        if latest != os.path.basename(async_dir) or doc is None or \
                doc["global_steps"] != CKPT_BEFORE + CKPT_AFTER:
            fail(f"checkpoint: async tag {async_dir}, latest {latest!r}, "
                 f"manifest {doc and doc['tag']}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del engine, model, it
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    gb = state_bytes / 1e9
    line = {
        "model": "llama3-8b", "layers": f"{CKPT_LAYERS} of 32",
        "params": cfg.num_params(), "dtype": "bfloat16 compute, fp32 masters",
        "micro": 1, "gas": 2, "seq": TRAIN_SEQ,
        "state_gb": gb, "leaves": len(sums),
        "save_s": save_s, "save_gb_per_s": gb / save_s,
        "load_s": load_s, "load_gb_per_s": gb / load_s,
        "load_validate_s": parts["validate"],
        "load_validate_gb_per_s": gb / parts["validate"],
        "load_read_s": parts["read"],
        "load_read_gb_per_s": parts["bytes_read"] / 1e9 / parts["read"],
        "async_blocking_s": blocking_s, "async_commit_s": commit_s,
        "async_save_gb_per_s": gb / (blocking_s + commit_s),
        "async_validate_s": async_validate_s,
        "resumed_bit_identical": True, "losses_before": before,
        "losses_reference": ref, "losses_resumed": resumed,
        "restored_leaves_bit_equal": len(sums),
        "step_ms_p50": float(np.median(step_s)) * 1e3,
        "reference_step_ms_p50": float(np.median(ref_s)) * 1e3,
        "peak_mem_gb": peak_gb, "launches": launches,
        "variant_launches": variants,
    }
    return line, {**launches, **variants}


# -- phase 10: offload ----------------------------------------------------------


def meminfo():
    """/proc/meminfo in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            parts = value.split()
            out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    return out


def rss_bytes():
    """(resident, peak resident) bytes of this process."""
    import resource

    with open("/proc/self/statm") as f:
        resident = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return resident, peak


def free_caches(torch):
    """Hand the card's and the pinned host allocator's cached blocks
    back, and the C heap's free pages to the host."""
    import ctypes
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    host_empty = getattr(torch._C, "_host_emptyCache", None)
    if host_empty is not None:
        host_empty()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc
    if trim is not None:
        trim(0)


def host_memory_room(mem):
    """Bytes the process may still allocate: MemAvailable, capped by the
    command's limit (HOST_LIMIT_BYTES, or a lower cgroup limit) less
    what the host already holds (MemTotal - MemAvailable)."""
    limit = min(HOST_LIMIT_BYTES, mem["MemTotal"])
    for path in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path) as f:
                limit = min(limit, int(f.read().strip()))
        except (OSError, ValueError):
            pass  # no such cgroup file, or "max"
    used = mem["MemTotal"] - mem["MemAvailable"]
    return min(mem["MemAvailable"], limit - used), limit


def offload_depth(zoo, off_mod, mem_available):
    """The deepest Llama-3-8B whose host optimizer state (12 bytes a
    parameter: the fp32 master, exp_avg and exp_avg_sq) and staging
    buffers fit in ``mem_available`` (the room ``host_memory_room``
    finds) less OFFLOAD_HOST_MARGIN. Returns (layers, the reckoning)."""
    n1 = zoo.get_config("llama3-8b", num_layers=1).num_params()
    n2 = zoo.get_config("llama3-8b", num_layers=2).num_params()
    per_layer, base = n2 - n1, 2 * n1 - n2
    c = off_mod.CHUNK_ELEMS
    # 4 fp32 grad buffers (buffer_count's default), an fp32 scratch and
    # two bf16 output buffers
    staging = 4 * c * 4 + c * 4 + 2 * c * 2
    room = mem_available - OFFLOAD_HOST_MARGIN - staging - 12 * base
    fits = int(max(0, min(32, room // (12 * per_layer))))
    layers = min(fits, OFFLOAD_MAX_LAYERS)
    full = 12 * (base + 32 * per_layer) + staging + OFFLOAD_HOST_MARGIN
    reason = ("the host holds the full depth" if fits == 32 else
              f"host room {mem_available / 1e9:.1f} GB < {full / 1e9:.1f}"
              f" GB needed at 32 layers (12 B a parameter of host state, "
              f"{staging / 1e9:.2f} GB of staging, "
              f"{OFFLOAD_HOST_MARGIN / 1e9:.0f} GB margin): "
              f"{fits} is the deepest that fits")
    if layers < fits:
        reason += f"; cut to {layers} for the smoke's time limit"
    return layers, {"params_base": base, "params_per_layer": per_layer,
                    "host_layers": fits, "max_layers": OFFLOAD_MAX_LAYERS,
                    "host_state_gb_at_32_layers": 12 * (base + 32 * per_layer)
                    / 1e9, "staging_gb": staging / 1e9,
                    "margin_gb": OFFLOAD_HOST_MARGIN / 1e9,
                    "host_room_gb": mem_available / 1e9,
                    "layers": layers, "reason": reason}


def step_split(wall_s, parts):
    """One offloaded step's seconds by part: the device forward and
    backward (the wall up to the optimizer's sync), the norm, the host's
    waits for the device->host copies, its scaling of bf16 grads, the
    native step, the NVMe swap and the waits for the host->device
    copies; the copies' own device time (CUDA events on the copy stream)
    beside them: they run under the host step."""
    return {"step_s": wall_s, "fwd_bwd_s": wall_s - parts["total"],
            "norm_s": parts["norm"], "d2h_wait_s": parts["d2h_wait"],
            "host_scale_s": parts["scale"],
            "host_optimizer_s": parts["host_step"],
            "swap_s": parts["swap"], "h2d_wait_s": parts["h2d_wait"],
            "d2h_copy_device_s": parts.get("d2h_copy"),
            "h2d_copy_device_s": parts.get("h2d_copy"),
            "optimizer_total_s": parts["total"]}


def offload_full_depth(torch, zoo, initialize, fa, builder, off_mod):
    """Phase 10a. Returns (offload line, its profile line, flash
    launches of the measured steps)."""
    import resource

    free_caches(torch)
    torch.cuda.reset_peak_memory_stats()
    mem = meminfo()
    room, limit = host_memory_room(mem)
    memlock = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    layers, reckoning = offload_depth(zoo, off_mod, room)
    reckoning.update(mem_available_gb=mem["MemAvailable"] / 1e9,
                     mem_total_gb=mem["MemTotal"] / 1e9,
                     host_limit_gb=limit / 1e9)
    log(f"offload: MemAvailable {mem['MemAvailable'] / 1e9:.1f} GB, "
        f"limit {limit / 1e9:.1f} GB, room {room / 1e9:.1f} GB, ulimit -l "
        f"{memlock}; {reckoning['reason']}")
    if layers < 1:
        fail(f"offload: the host holds no layer: {reckoning}")
    t0 = time.perf_counter()
    model = zoo.get_model("llama3-8b", num_layers=layers,
                          dtype=torch.float32, seed=SEED)
    cfg = model.config
    engine, *_ = initialize(model=model, config=dict(OFFLOAD_CONFIG))
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if engine._offload is None or builder.native_status() != "built":
        fail(f"offload: the native library is not in use: "
             f"{builder.native_status()}")
    native = {"status": builder.native_status(),
              "library": os.path.basename(builder.require_native_lib()._name)}
    _, data = fixed_batches(cfg.vocab_size, micro=OFFLOAD_MICRO)
    losses = [float(engine.train_batch(data))]  # warm-up step
    warm_split = step_split(float("nan"), engine._offload.last_step_s)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    step_s, parts = [], []
    for _ in range(OFFLOAD_MEASURED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(data)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        parts.append(dict(engine._offload.last_step_s))
    launches = dict(fa.LAUNCHES)
    variants = dict(fa.VARIANT_LAUNCHES)
    L, steps = layers, OFFLOAD_MEASURED
    want = {"flash_fwd": steps * 2 * L,  # forward + remat replay, GAS 1
            "flash_bwd_dkdv": steps * L, "flash_bwd_dq": steps * L}
    if launches != want:
        fail(f"offload: flash launches {launches}, remat implies {want}")
    check_tensor_core("offload", launches, variants,
                      ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail(f"offload: losses {losses} not finite and falling")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rss, hwm = rss_bytes()
    median = int(np.argsort(step_s)[len(step_s) // 2])
    log(f"offload: {L} layers, steps {step_s} s, losses {losses}, split "
        f"{step_split(step_s[median], parts[median])}")
    tokens = OFFLOAD_MICRO * TRAIN_SEQ
    p50 = float(np.median(step_s))
    flops_tok = 6 * cfg.num_params() + 12 * L * cfg.hidden_size * TRAIN_SEQ
    host_state = 12 * cfg.num_params()
    line = {
        "model": "llama3-8b", "layers": f"{L} of 32",
        "depth_reckoning": reckoning, "params": cfg.num_params(),
        "dtype": "bfloat16 compute, fp32 host masters",
        "offload_optimizer": OFFLOAD_CONFIG["zero_optimization"][
            "offload_optimizer"],
        "micro": OFFLOAD_MICRO, "gas": 1, "seq": TRAIN_SEQ,
        "tokens_per_step": tokens, "init_s": init_s,
        "step_s": step_s, "step_ms_p50": p50 * 1e3,
        "step_split_p50": step_split(step_s[median], parts[median]),
        "warmup_step_split": warm_split,
        "tokens_per_s": tokens / p50,
        "mfu": tokens / p50 * flops_tok / PEAK_FLOPS["bfloat16"],
        "flops_per_token": flops_tok,
        "host_adam_gparam_per_s": cfg.num_params() / 1e9
        / parts[median]["host_step"],
        # the copy stream's busy time (CUDA events), fp32 grads down and
        # bf16 params up
        "d2h_gb_per_s": cfg.num_params() * 4 / 1e9
        / parts[median].get("d2h_copy", float("nan")),
        "h2d_gb_per_s": cfg.num_params() * 2 / 1e9
        / parts[median].get("h2d_copy", float("nan")),
        "init_peak_mem_gb": init_peak_gb, "peak_mem_gb": peak_gb,
        "host_state_gb": host_state / 1e9, "host_rss_gb": rss / 1e9,
        "host_rss_peak_gb": hwm / 1e9,
        "mem_available_before_gb": mem["MemAvailable"] / 1e9,
        "ulimit_l": list(memlock), "native": native,
        "losses": losses, "grad_norm": float(engine.get_global_grad_norm()),
        "global_steps": engine.global_steps, "launches": launches,
        "launches_per_step": {k: v // steps for k, v in launches.items()},
        "variant_launches": variants,
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
    profile["step_split"] = step_split(wall, engine._offload.last_step_s)
    del prof, engine, model
    free_caches(torch)
    return line, profile, {**launches, **variants}


def offload_small(torch, zoo, initialize, fa, ckpt):
    """Phases 10b and 10c at phase 9's depth. Returns (parity line,
    checkpoint line, flash launches of the resumed steps)."""
    from deepspeed_tpu_torch.runtime.optimizer import leaves

    n = zoo.get_config("llama3-8b", num_layers=CKPT_LAYERS,
                       vocab_size=CKPT_SMALL_VOCAB).num_params()
    root = tempfile.mkdtemp(prefix="dstpu_offload_")

    def build(config, seed=SEED):
        free_caches(torch)
        model = zoo.get_model("llama3-8b", num_layers=CKPT_LAYERS,
                              vocab_size=CKPT_SMALL_VOCAB,
                              dtype=torch.float32, seed=seed)
        engine, *_ = initialize(model=model, config=config)
        return engine, model

    def batches(skip=0):
        _, it = fixed_batches(CKPT_SMALL_VOCAB, micro=OFFLOAD_MICRO)
        for _ in range(skip):
            next(it)
        return it

    try:
        free = shutil.disk_usage(root).free
        need = n * 12 + n * 14  # the NVMe tier's files and the checkpoint
        if free < 1.1 * need:
            fail(f"offload: {free / 1e9:.1f} GB free at {root}, the NVMe "
                 f"tier and the checkpoint need {need / 1e9:.1f} GB")
        # 10b: the device optimizer, then its states offloaded and back
        engine, model = build(dict(OFFLOAD_DEVICE_CONFIG))
        dev_losses, dev_s = timed_steps(torch, engine, batches(),
                                        OFFLOAD_SMALL_STEPS)
        sums = state_checksums(torch, engine)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        engine.offload_states()
        torch.cuda.synchronize()
        offload_s = time.perf_counter() - t0
        freed = before - torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        engine.reload_states()
        torch.cuda.synchronize()
        reload_s = time.perf_counter() - t0
        restored = state_checksums(torch, engine)
        bad = sorted(p for p in sums if restored.get(p) != sums[p])
        if bad or freed <= 0:
            fail(f"offload: offload_states freed {freed} bytes; leaves "
                 f"restored differently: {bad[:5]}")
        del engine, model
        # the cpu tier, saving through the pipelined AIO writer (10c)
        cpu_cfg = dict(OFFLOAD_CONFIG,
                       checkpoint={"parallel_write_pipeline": True})
        engine, model = build(dict(cpu_cfg))
        it = batches()
        cpu_losses, cpu_s = timed_steps(torch, engine, it,
                                        OFFLOAD_SMALL_STEPS)
        cpu_split = step_split(cpu_s[-1], engine._offload.last_step_s)
        state_bytes = sum(t.nbytes for _, t in
                          leaves(engine._ckpt_io._state()))
        ckpt_root = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        tag_dir = engine.save_checkpoint(ckpt_root)
        save_s = time.perf_counter() - t0
        ref, _ = timed_steps(torch, engine, it, OFFLOAD_RESUMED)
        del engine, model
        # the NVMe tier: the same steps, bit for bit
        nvme_cfg = dict(OFFLOAD_CONFIG, zero_optimization={
            "stage": 3, "offload_optimizer": {
                "device": "nvme", "nvme_path": os.path.join(root, "swap"),
                "pin_memory": True}})
        engine, model = build(nvme_cfg)
        nvme_losses, nvme_s = timed_steps(torch, engine, batches(),
                                          OFFLOAD_SMALL_STEPS)
        nvme_split = step_split(nvme_s[-1], engine._offload.last_step_s)
        folder = engine._offload.swap_folder
        swap_files = sorted(os.listdir(folder))
        swap_bytes = sum(os.path.getsize(os.path.join(folder, f))
                         for f in swap_files)
        engine._offload.close()
        del engine, model
        if not swap_files:
            fail(f"offload: the NVMe tier wrote nothing under {folder}")
        if nvme_losses != cpu_losses:
            fail(f"offload: nvme losses {nvme_losses} are not the cpu "
                 f"tier's {cpu_losses}")
        rel = float(np.max(np.abs(np.subtract(cpu_losses, dev_losses))
                           / np.abs(dev_losses)))
        if not rel <= OFFLOAD_TOL_REL:
            fail(f"offload: cpu tier {cpu_losses} vs device optimizer "
                 f"{dev_losses}: {rel:.2e} > {OFFLOAD_TOL_REL}")
        # 10c: a fresh engine from another seed resumes the saved tag
        engine, model = build(dict(cpu_cfg), seed=SEED + 1)
        t0 = time.perf_counter()
        ckpt_dir, _ = engine.load_checkpoint(ckpt_root)
        load_s = time.perf_counter() - t0
        parts = dict(engine._ckpt_io.last_load_s)
        if ckpt_dir != tag_dir or engine.global_steps != OFFLOAD_SMALL_STEPS:
            fail(f"offload: loaded {ckpt_dir} at step {engine.global_steps}")
        fa.reset_launch_counts()
        resumed, _ = timed_steps(torch, engine,
                                 batches(skip=OFFLOAD_SMALL_STEPS),
                                 OFFLOAD_RESUMED)
        launches = dict(fa.LAUNCHES)
        variants = dict(fa.VARIANT_LAUNCHES)
        if resumed != ref:
            fail(f"offload: resumed losses {resumed} are not the "
                 f"uninterrupted run's {ref}")
        L, steps = CKPT_LAYERS, OFFLOAD_RESUMED
        want = {"flash_fwd": steps * 2 * L, "flash_bwd_dkdv": steps * L,
                "flash_bwd_dq": steps * L}
        if launches != want:
            fail(f"offload checkpoint: flash launches {launches}, remat "
                 f"implies {want}")
        check_tensor_core("offload checkpoint", launches, variants,
                          ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))
        del engine, model
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_caches(torch)
    gb = state_bytes / 1e9
    parity = {
        "model": "llama3-8b", "layers": f"{CKPT_LAYERS} of 32", "params": n,
        "vocab": CKPT_SMALL_VOCAB,
        "micro": OFFLOAD_MICRO, "gas": 1, "seq": TRAIN_SEQ,
        "losses_device_optimizer": dev_losses, "losses_cpu": cpu_losses,
        "losses_nvme": nvme_losses, "cpu_equals_nvme": True,
        "cpu_vs_device_max_rel": rel, "tolerance_rel": OFFLOAD_TOL_REL,
        "step_s_device_optimizer": dev_s, "step_s_cpu": cpu_s,
        "step_s_nvme": nvme_s, "cpu_step_split": cpu_split,
        "nvme_step_split": nvme_split, "swap_files": len(swap_files),
        "swap_gb": swap_bytes / 1e9,
        "offload_states": {"freed_gb": freed / 1e9, "offload_s": offload_s,
                           "reload_s": reload_s,
                           "restored_leaves_bit_equal": len(sums)},
    }
    line = {
        "model": "llama3-8b", "layers": f"{CKPT_LAYERS} of 32",
        "vocab": CKPT_SMALL_VOCAB,
        "engine": "FastCheckpointEngine (parallel_write_pipeline)",
        "state_gb": gb, "save_s": save_s, "save_gb_per_s": gb / save_s,
        "load_s": load_s, "load_gb_per_s": gb / load_s,
        "load_validate_s": parts["validate"], "load_read_s": parts["read"],
        "phase9_sync_save_s": ckpt["save_s"],
        "phase9_sync_save_gb_per_s": ckpt["save_gb_per_s"],
        "resumed_bit_identical": True, "losses_reference": ref,
        "losses_resumed": resumed, "launches": launches,
        "variant_launches": variants,
    }
    return parity, line, {**launches, **variants}


# -- phase 11: ZenFlow and the optimizer sweep ---------------------------------


def zenflow_depth(zoo, off_mod, host_room, card_bytes):
    """The deepest Llama-3-8B whose ZenFlow state fits both the host
    (16 bytes a parameter, ZenFlow's four fp32 staging buffers and
    OFFLOAD_HOST_MARGIN) and the card (10 bytes a parameter at init, 8
    in training beside ZENFLOW_CARD_RESERVE). Returns (layers, the
    reckoning)."""
    n1 = zoo.get_config("llama3-8b", num_layers=1).num_params()
    n2 = zoo.get_config("llama3-8b", num_layers=2).num_params()
    per_layer, base = n2 - n1, 2 * n1 - n2
    staging = 4 * off_mod.CHUNK_ELEMS * 4

    def fit(room, per_param):
        return int(max(0, min(32, (room - per_param * base)
                              // (per_param * per_layer))))

    host = fit(host_room - OFFLOAD_HOST_MARGIN - staging, 16)
    card = min(fit(card_bytes, 10),
               fit(card_bytes - ZENFLOW_CARD_RESERVE, 8))
    layers = min(host, card, ZENFLOW_MAX_LAYERS)
    n32 = base + 32 * per_layer
    reason = ("host and card hold the full depth" if layers == 32 else
              f"the {'host' if host <= card else 'card'} holds "
              f"{min(host, card)} "
              f"layers: host room {host_room / 1e9:.1f} GB against "
              f"{(16 * n32 + staging + OFFLOAD_HOST_MARGIN) / 1e9:.1f} GB "
              f"at 32 layers (16 B a parameter, {staging / 1e9:.2f} GB of "
              f"staging, {OFFLOAD_HOST_MARGIN / 1e9:.0f} GB margin); card "
              f"{card_bytes / 1e9:.1f} GB against {10 * n32 / 1e9:.1f} GB at"
              f" init and {(8 * n32 + ZENFLOW_CARD_RESERVE) / 1e9:.1f} GB in"
              f" training at 32 layers")
    if layers < min(host, card):
        reason += (f"; cut to {layers} (from {min(host, card)}) for the "
                   "smoke's time limit")
    return layers, {"params_base": base, "params_per_layer": per_layer,
                    "host_bytes_per_param": 16, "staging_gb": staging / 1e9,
                    "margin_gb": OFFLOAD_HOST_MARGIN / 1e9,
                    "host_room_gb": host_room / 1e9, "host_layers": host,
                    "card_gb": card_bytes / 1e9,
                    "card_bytes_per_param": {"init": 10, "train": 8},
                    "card_reserve_gb": ZENFLOW_CARD_RESERVE / 1e9,
                    "card_layers": card, "max_layers": ZENFLOW_MAX_LAYERS,
                    "layers": layers, "reason": reason}


def profiled_steps(torch, engine, data, n):
    """``n`` steps under torch.profiler: (device breakdown, wall)."""
    from torch.profiler import ProfilerActivity

    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    prof.__enter__()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        engine.train_batch(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    return device_breakdown(torch, prof, wall, n, unit="step")


def step_kind(times):
    return ("fold+ship" if "fold" in times and "ship" in times else
            "fold" if "fold" in times else
            "ship" if "ship" in times else "steady")


def zenflow_full_depth(torch, zoo, initialize, fa, builder, off_mod):
    """Phase 11a. Returns (line, profile line, flash launches of the
    measured steps, the depth)."""
    free_caches(torch)
    torch.cuda.reset_peak_memory_stats()
    mem = meminfo()
    room, limit = host_memory_room(mem)
    card = torch.cuda.get_device_properties(0).total_memory
    layers, reckoning = zenflow_depth(zoo, off_mod, room, card)
    log(f"zenflow: MemAvailable {mem['MemAvailable'] / 1e9:.1f} GB, limit "
        f"{limit / 1e9:.1f} GB, room {room / 1e9:.1f} GB, card "
        f"{card / 1e9:.1f} GB; {reckoning['reason']}")
    if layers < 1:
        fail(f"zenflow: host and card hold no layer: {reckoning}")
    t0 = time.perf_counter()
    model = zoo.get_model("llama3-8b", num_layers=layers,
                          dtype=torch.float32, seed=SEED)
    cfg = model.config
    engine, *_ = initialize(model=model, config=dict(ZENFLOW_CONFIG))
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    zen = engine._zenflow
    if zen is None or engine._offload is not None or \
            builder.native_status() != "built":
        fail(f"zenflow: not the one host optimizer, or the native library "
             f"is not in use: {builder.native_status()}")
    native = {"status": builder.native_status(),
              "library": os.path.basename(builder.require_native_lib()._name)}
    ui = ZENFLOW_BLOCK["update_interval"]
    _, data = fixed_batches(cfg.vocab_size, micro=OFFLOAD_MICRO)
    # the first interval: the first selection and the first ship
    warm = [float(engine.train_batch(data)) for _ in range(ui)]
    # after the window's last fold: the host masters at the kept
    # coordinates hold the card's values (one leaf)
    leaf = zen.paths.index("/layers/attn/wq")
    folds = []
    real_fold = zen._fold

    def checked_fold(p_leaves):
        keep = zen._idx[leaf]
        if zen._protected[leaf] is not None:
            keep = torch.cat([keep, zen._protected[leaf]])
        real_fold(p_leaves)
        card_vals = p_leaves[leaf].view(-1)[keep].float().cpu()
        host_vals = zen._masters[leaf][keep.cpu()]
        flat = p_leaves[leaf].view(-1)[:1 << 24]
        cast = zen._masters[leaf][:1 << 24].to(flat.dtype).to(flat.device)
        mask = torch.ones_like(flat, dtype=torch.bool)
        mask[keep[keep < flat.numel()]] = False
        folds.append({
            "kept": int(keep.numel()),
            "kept_max_abs_diff": float((card_vals - host_vals).abs().max()),
            "others_equal_cast": bool(torch.equal(flat[mask], cast[mask]))})

    zen._fold = checked_fold
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    counts0, passes0 = dict(zen.counts), len(zen.pass_s)
    steps, losses = [], list(warm)
    for _ in range(ZENFLOW_INTERVALS * ui):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        times = dict(zen.last_times)
        steps.append({"step": engine.global_steps, "kind": step_kind(times),
                      "wall_s": wall, **times})
        losses.append(float(loss))
    zen._fold = real_fold
    launches = dict(fa.LAUNCHES)
    variants = dict(fa.VARIANT_LAUNCHES)
    counts = {k: zen.counts[k] - counts0[k] for k in ("ships", "folds")}
    L, n = layers, len(steps)
    want = {"flash_fwd": n * 2 * L,  # forward + remat replay, GAS 1
            "flash_bwd_dkdv": n * L, "flash_bwd_dq": n * L}
    if launches != want:
        fail(f"zenflow: flash launches {launches}, remat implies {want}")
    check_tensor_core("zenflow", launches, variants,
                      ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail(f"zenflow: losses {losses} not finite and falling")
    if counts != {"ships": ZENFLOW_INTERVALS, "folds": ZENFLOW_INTERVALS}:
        fail(f"zenflow: {counts} in the measured window, two intervals "
             f"imply {ZENFLOW_INTERVALS} of each")
    last = folds[-1] if folds else None
    if last is None or last["kept_max_abs_diff"] != 0.0 or \
            not last["others_equal_cast"]:
        fail(f"zenflow: after the last fold the masters and the card's "
             f"values disagree: {folds}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    zen.finalize()
    rss, hwm = rss_bytes()
    passes = zen.pass_s[passes0:passes0 + ZENFLOW_INTERVALS]
    by_kind = {}
    for st in steps:
        by_kind.setdefault(st["kind"], []).append(st["wall_s"])
    mean_s = float(np.mean([st["wall_s"] for st in steps]))
    tokens = OFFLOAD_MICRO * TRAIN_SEQ
    flops_tok = 6 * cfg.num_params() + 12 * L * cfg.hidden_size * TRAIN_SEQ
    fold_steps = [st for st in steps if "fold" in st]
    ship_steps = [st for st in steps if "ship" in st]
    line = {
        "model": "llama3-8b", "layers": f"{L} of 32",
        "depth_reckoning": reckoning, "params": cfg.num_params(),
        "dtype": "bfloat16 compute, fp32 host masters",
        "zenflow": ZENFLOW_BLOCK, "micro": OFFLOAD_MICRO, "gas": 1,
        "seq": TRAIN_SEQ, "tokens_per_step": tokens, "init_s": init_s,
        "warmup_steps": ui, "steps": steps,
        "step_s_mean": mean_s,
        "step_s_mean_by_kind": {k: float(np.mean(v))
                                for k, v in by_kind.items()},
        "tokens_per_s": tokens / mean_s,
        "mfu": tokens / mean_s * flops_tok / PEAK_FLOPS["bfloat16"],
        "flops_per_token": flops_tok,
        "host_pass_s": passes,
        "host_adam_gparam_per_s": [cfg.num_params() / 1e9 / s
                                   for s in passes],
        "collect_wait_s": [st["collect_wait"] for st in fold_steps],
        "ship_s": [st["ship"] for st in ship_steps],
        "ship_copy_device_s": [st["ship_copy"] for st in ship_steps],
        "fold_s": [st["fold"] for st in fold_steps],
        "fold_copy_device_s": [st["fold_copy"] for st in fold_steps],
        # the copy stream's busy time (CUDA events): fp32 grads down, bf16
        # params up
        "ship_d2h_gb_per_s": [cfg.num_params() * 4 / 1e9 / st["ship_copy"]
                              if st["ship_copy"] else None
                              for st in ship_steps],
        "fold_h2d_gb_per_s": [cfg.num_params() * 2 / 1e9 / st["fold_copy"]
                              if st["fold_copy"] else None
                              for st in fold_steps],
        "folds_checked": folds, "counts": counts,
        "init_peak_mem_gb": init_peak_gb, "peak_mem_gb": peak_gb,
        "host_state_gb": 16 * cfg.num_params() / 1e9,
        "host_rss_gb": rss / 1e9, "host_rss_peak_gb": hwm / 1e9,
        "native": native, "losses": losses,
        "grad_norm": float(engine.get_global_grad_norm()),
        "global_steps": engine.global_steps, "launches": launches,
        "launches_per_step": {k: v // n for k, v in launches.items()},
        "variant_launches": variants,
    }
    log(f"zenflow: {L} layers, steps "
        f"{[(st['kind'], round(st['wall_s'], 3)) for st in steps]}, "
        f"host passes {passes} s, losses {losses}")
    # one interval under the profiler: three steady steps and a
    # fold + ship
    profile = profiled_steps(torch, engine, data, ui)
    profile["steps"] = ui
    zen.close()
    del engine, model, zen
    free_caches(torch)
    return line, profile, {**launches, **variants}, layers


def zenflow_blocking(torch, zoo, initialize, fa, layers):
    """Phase 11b: PR 12's blocking offload step at 11a's depth. Returns
    (line, flash launches of the measured steps)."""
    free_caches(torch)
    model = zoo.get_model("llama3-8b", num_layers=layers,
                          dtype=torch.float32, seed=SEED)
    cfg = model.config
    engine, *_ = initialize(model=model, config=dict(OFFLOAD_CONFIG))
    _, data = fixed_batches(cfg.vocab_size, micro=OFFLOAD_MICRO)
    losses = [float(engine.train_batch(data))]
    fa.reset_launch_counts()
    more, step_s = timed_steps(torch, engine, data, ZENFLOW_BLOCKING_STEPS)
    losses += more
    launches = dict(fa.LAUNCHES)
    variants = dict(fa.VARIANT_LAUNCHES)
    n = ZENFLOW_BLOCKING_STEPS
    want = {"flash_fwd": n * 2 * layers, "flash_bwd_dkdv": n * layers,
            "flash_bwd_dq": n * layers}
    if launches != want:
        fail(f"zenflow blocking: flash launches {launches}, remat implies "
             f"{want}")
    check_tensor_core("zenflow blocking", launches, variants,
                      ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))
    if not all(np.isfinite(losses)):
        fail(f"zenflow blocking: losses {losses}")
    split = step_split(step_s[-1], engine._offload.last_step_s)
    profile = profiled_steps(torch, engine, data, 1)
    mean_s = float(np.mean(step_s))
    tokens = OFFLOAD_MICRO * TRAIN_SEQ
    flops_tok = 6 * cfg.num_params() + 12 * layers * cfg.hidden_size * \
        TRAIN_SEQ
    line = {"layers": f"{layers} of 32", "params": cfg.num_params(),
            "step_s": step_s, "step_s_mean": mean_s,
            "step_split_last": split, "tokens_per_s": tokens / mean_s,
            "mfu": tokens / mean_s * flops_tok / PEAK_FLOPS["bfloat16"],
            "losses": losses, "profile": profile, "launches": launches,
            "variant_launches": variants}
    del engine, model
    free_caches(torch)
    return line, {**launches, **variants}


def zenflow_checkpoint(torch, zoo, initialize, fa):
    """Phase 11c: saved at step 3 (the pass shipped at step 2 in
    flight), loaded by a fresh engine from another seed, 3 resumed
    losses equal to the uninterrupted run's. Returns (line, flash
    launches of the resumed steps)."""
    from deepspeed_tpu_torch.runtime.optimizer import leaves

    vocab = CKPT_SMALL_VOCAB

    def build(seed):
        free_caches(torch)
        model = zoo.get_model("llama3-8b", num_layers=CKPT_LAYERS,
                              vocab_size=vocab, dtype=torch.float32,
                              seed=seed)
        engine, *_ = initialize(model=model,
                                config=dict(ZENFLOW_CKPT_CONFIG))
        return engine, model

    def batches(skip=0):
        _, it = fixed_batches(vocab, micro=OFFLOAD_MICRO)
        for _ in range(skip):
            next(it)
        return it

    root = tempfile.mkdtemp(prefix="dstpu_zenflow_")
    try:
        engine, model = build(SEED)
        it = batches()
        before, _ = timed_steps(torch, engine, it, ZENFLOW_CKPT_BEFORE)
        in_flight = engine._zenflow._worker.busy
        n = model.config.num_params()
        need = 18 * n  # masters, moments, accumulators, bf16 params
        free = shutil.disk_usage(root).free
        if free < 1.1 * need:
            fail(f"zenflow checkpoint: {free / 1e9:.1f} GB free at {root}, "
                 f"the state needs {need / 1e9:.1f} GB")
        t0 = time.perf_counter()
        engine.save_checkpoint(root)
        save_s = time.perf_counter() - t0
        state_gb = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, files in os.walk(root) for f in files) / 1e9
        ref, _ = timed_steps(torch, engine, it, ZENFLOW_CKPT_AFTER)
        engine._zenflow.close()
        del engine, model
        engine, model = build(SEED + 1)
        t0 = time.perf_counter()
        engine.load_checkpoint(root)
        load_s = time.perf_counter() - t0
        fa.reset_launch_counts()
        resumed, step_s = timed_steps(
            torch, engine, batches(ZENFLOW_CKPT_BEFORE), ZENFLOW_CKPT_AFTER)
        launches = dict(fa.LAUNCHES)
        variants = dict(fa.VARIANT_LAUNCHES)
        if resumed != ref:
            fail(f"zenflow checkpoint: resumed losses {resumed} are not the "
                 f"uninterrupted run's {ref}")
        L, k = CKPT_LAYERS, ZENFLOW_CKPT_AFTER
        want = {"flash_fwd": k * 2 * L, "flash_bwd_dkdv": k * L,
                "flash_bwd_dq": k * L}
        if launches != want:
            fail(f"zenflow checkpoint: flash launches {launches}, remat "
                 f"implies {want}")
        check_tensor_core("zenflow checkpoint", launches, variants,
                          ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))
        leaves_n = len(list(leaves(engine.params)))
        engine._zenflow.close()
        del engine, model
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_caches(torch)
    return {"layers": f"{CKPT_LAYERS} of 32", "params": n, "vocab": vocab,
            "zenflow": ZENFLOW_CKPT_CONFIG["zero_optimization"]["zenflow"],
            "pass_in_flight_at_save": in_flight, "state_gb": state_gb,
            "save_s": save_s, "load_s": load_s, "leaves": leaves_n,
            "losses_before": before, "losses_reference": ref,
            "losses_resumed": resumed, "resumed_bit_identical": True,
            "resumed_step_ms_p50": float(np.median(step_s)) * 1e3,
            "launches": launches, "variant_launches": variants}, \
        {**launches, **variants}


def sweep_tree(torch, device, seed):
    rng = np.random.default_rng(seed)

    def make(shapes, scale):
        return {k: (make(v, scale) if isinstance(v, dict) else
                    torch.from_numpy((rng.standard_normal(v) * scale)
                                     .astype(np.float32)).to(device))
                for k, v in shapes.items()}

    return make(SWEEP_TREE, 1.0), make(SWEEP_TREE, 0.1)


def sweep_update_agrees(torch, opt_mod, name):
    """One update of a seeded tree on the card and on the CPU (fp32, the
    clip engaged): the largest error over rtol * |cpu| + atol, which
    must stay <= 1."""
    from deepspeed_tpu_torch.config.config import OptimizerConfig

    out = {}
    for device in ("cuda", "cpu"):
        params, grads = sweep_tree(torch, device, SEED + 11)
        tx, _ = opt_mod.get_base_optimizer(OptimizerConfig(
            type=name, params={"lr": SWEEP_LR[name]}))
        state = opt_mod.init_mixed_precision(params, tx)
        opt_mod.apply_mixed_precision_update(state, grads, tx, grad_clip=1.0)
        out[device] = dict(opt_mod.leaves(state.master))
    worst = 0.0
    for path, want in out["cpu"].items():
        got = out["cuda"][path].cpu()
        worst = max(worst, float(((got - want).abs() / (
            SWEEP_TOL_REL * want.abs() + SWEEP_TOL_ABS)).max()))
    return worst


def optimizer_sweep(torch, zoo, initialize):
    """Phase 11d: each optimizer 3 steps of the 2-layer model (finite
    losses, the last below the first) and one update of a small tree on
    the card against the CPU. Returns the line."""
    from deepspeed_tpu_torch.runtime import muon
    from deepspeed_tpu_torch.runtime import optimizer as opt_mod

    vocab = zoo.get_config("llama3-8b").vocab_size
    out = {}
    for name, lr in SWEEP_LR.items():
        worst = sweep_update_agrees(torch, opt_mod, name)
        if not worst <= 1.0:
            fail(f"optimizer sweep: {name} on the card vs the CPU: "
                 f"{worst:.3g} x (rtol {SWEEP_TOL_REL}, atol "
                 f"{SWEEP_TOL_ABS})")
        free_caches(torch)
        model = zoo.get_model("llama3-8b", num_layers=SWEEP_LAYERS,
                              dtype=torch.float32, seed=SEED)
        config = dict(OFFLOAD_DEVICE_CONFIG,
                      optimizer={"type": name, "params": {"lr": lr}})
        engine, *_ = initialize(model=model, config=config)
        _, data = fixed_batches(vocab, micro=OFFLOAD_MICRO)
        losses, step_s = timed_steps(torch, engine, data, SWEEP_STEPS)
        if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
            fail(f"optimizer sweep: {name} at lr {lr}: losses {losses} not "
                 f"finite and falling")
        row = {"lr": lr, "losses": losses, "step_s": step_s,
               "step_ms_mean_after_first": float(np.mean(step_s[1:])) * 1e3,
               "card_vs_cpu_worst_over_tol": worst,
               "state_trees": sorted(engine.opt_state.named_trees())}
        if name == "muon":
            # one more step with the Newton-Schulz calls timed (a
            # synchronize around each)
            real, ns = muon.newton_schulz, []

            def timed_ns(G, steps=5, eps=1e-7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = real(G, steps, eps)
                torch.cuda.synchronize()
                ns.append(time.perf_counter() - t0)
                return x

            muon.newton_schulz = timed_ns
            try:
                _, (wall,) = timed_steps(torch, engine, data, 1)
            finally:
                muon.newton_schulz = real
            row.update(ns_s=sum(ns), ns_calls=len(ns), ns_step_s=wall,
                       ns_share=sum(ns) / wall)
        out[name] = row
        del engine, model
    free_caches(torch)
    return {"layers": f"{SWEEP_LAYERS} of 32", "micro": OFFLOAD_MICRO,
            "gas": 1, "seq": TRAIN_SEQ, "optimizers": out}


# -- phases 5 and 6: MoE serve and train ----------------------------------------


# -- phase 12: speculative serving and the rest of the one-card engine ------


def repetitive_prompts(seed, vocab=128256):
    """Phase 3's lengths and shared prefix, each prompt a seeded 32-token
    motif repeated: a document or a code file being rewritten, the
    traffic prompt lookup exists for."""
    rng = np.random.default_rng(seed)
    lens = [448, 64, 96, 160, 224, 288, 512, 320]
    prompts = [np.tile(rng.integers(0, vocab, SPEC_MOTIF).astype(np.int32),
                       -(-n // SPEC_MOTIF))[:n] for n in lens]
    prompts[7][:256] = prompts[0][:256]
    return prompts


def verify_spy(pa, model_runner, eng):
    """Count the paged prefill launches of ``eng``'s verify rounds by
    variant, by the chunk's (S, Tq) and by the tensor-core kernel's
    template (``<1>``: one warpgroup, where Tq x group <= 64). Returns
    (the record, a function that removes the spy)."""
    rec = {"rounds": 0, "launches": {"wgmma": 0, "simt": 0},
           "by_chunk": {}, "by_template": {}}
    real_fwd = model_runner.ragged_prefill_forward
    real_spec = eng._try_spec_step
    inside = [False]

    def fwd(cfg, params, kv, seg_tokens, *rest):
        if not inside[0]:
            return real_fwd(cfg, params, kv, seg_tokens, *rest)
        before = dict(pa.VARIANT_LAUNCHES)
        out = real_fwd(cfg, params, kv, seg_tokens, *rest)
        ran = prefill_variants_ran(pa, before)
        S, tq = seg_tokens.shape
        g = cfg.num_heads // cfg.kv_heads
        rec["rounds"] += 1
        for v, n in ran.items():
            rec["launches"][v] += n
        key = f"S{S}xTq{tq}"
        rec["by_chunk"][key] = rec["by_chunk"].get(key, 0) + ran["wgmma"]
        tpl = ("paged_prefill_wgmma_kernel<1>" if tq * g <= 64
               else "paged_prefill_wgmma_kernel<2>")
        rec["by_template"][tpl] = rec["by_template"].get(tpl, 0) \
            + ran["wgmma"]
        return out

    def spec(eos_token_id):
        inside[0] = True
        try:
            return real_spec(eos_token_id)
        finally:
            inside[0] = False

    model_runner.ragged_prefill_forward = fwd
    eng._try_spec_step = spec

    def remove():
        model_runner.ragged_prefill_forward = real_fwd
        del eng._try_spec_step

    return rec, remove


def spec_run(torch, InferenceEngineV2, pa, model_runner, model, prompts,
             label, **engine_kw):
    """One serve of the 8-request workload with ``engine_kw``: the
    streams, the serve's numbers and the launches by variant (those of
    the verify rounds apart). Gates: 64 tokens a request; every paged
    prefill and decode launch on the fast kernels; with speculation on,
    every verify round on B5's tensor-core kernel and no gather
    fallback."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = serve_engine(torch, InferenceEngineV2, model, **engine_kw)
    spec_on = eng._drafter is not None
    pa.reset_launch_counts()
    rec, remove = verify_spy(pa, model_runner, eng)
    try:
        out, wall = serve_workload(torch, eng, prompts)
    finally:
        remove()
    launches, variants = dict(pa.LAUNCHES), dict(pa.VARIANT_LAUNCHES)
    if sorted(out) != list(range(8)) or any(len(v) != NEW_TOKENS
                                            for v in out.values()):
        fail(f"spec serve {label}: token counts "
             f"{[len(out.get(u, [])) for u in range(8)]}")
    check_tensor_core(f"spec serve {label}", launches, variants,
                      ("paged_prefill", "paged_decode"))
    st = eng.stats
    if spec_on:
        L = model.config.num_layers
        if (st["spec_verify_gather_fallbacks"] != 0
                or rec["launches"]["simt"] != 0
                or rec["launches"]["wgmma"]
                != L * st["spec_verify_kernel_rounds"]
                or rec["rounds"] != st["spec_verify_kernel_rounds"]
                or st["spec_verify_kernel_rounds"] != st["spec_steps"]):
            fail(f"spec serve {label}: verify rounds {rec}, stats {st}")
        if st["spec_accepted"] > st["spec_proposed"]:
            fail(f"spec serve {label}: accepted {st['spec_accepted']} > "
                 f"proposed {st['spec_proposed']}")
    gen = sum(len(v) for v in out.values())
    ttft = sorted(eng.latency["ttft_s"])
    res = {"wall_s": wall, "generated_tokens_per_s": gen / wall,
           "ttft_p50_s": ttft[len(ttft) // 2],
           "decode_token_p50_s": float(np.median(
               eng.latency["decode_token_s"])),
           "spec_steps": st["spec_steps"],
           "spec_proposed": st["spec_proposed"],
           "spec_accepted": st["spec_accepted"],
           "accepted_per_verify_round": (st["spec_accepted"]
                                         / max(1, st["spec_steps"])),
           "acceptance_rate": (st["spec_accepted"]
                               / max(1, st["spec_proposed"])),
           "spec_backoff_rounds": st["spec_backoff_rounds"],
           "spec_verify_kernel_rounds": st["spec_verify_kernel_rounds"],
           "spec_verify_gather_fallbacks":
               st["spec_verify_gather_fallbacks"],
           "verify_launches": rec,
           "burst_steps": st["burst_steps"],
           "decode_kernel_steps": st["decode_kernel_steps"],
           "prefill_kernel_steps": st["prefill_kernel_steps"],
           "launches": launches, "variant_launches": variants,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del eng
    torch.cuda.empty_cache()
    return out, res, {**launches, **variants}


def row_recorder(model_runner, eng, targets):
    """Record, for each ``uid: {P, ...}`` of ``targets``, the logits row
    that ``eng``'s forwards last computed at query position P of that
    sequence (the row whose argmax is the token after position P: later
    rounds never recompute a position behind the frontier). The
    sequence's row in each call is told by its block-table row. Returns
    (the rows by (uid, P), a function that removes the spies)."""
    rows = {}
    real = {n: getattr(model_runner, n) for n in (
        "ragged_decode_forward", "ragged_prefill_forward", "ragged_forward")}

    def slots(bt):
        bt_np = bt.cpu().numpy()
        out = {}
        for uid in targets:
            seq = eng.state.seqs.get(uid)
            if seq is None:
                continue
            blocks = np.asarray(seq.kv_blocks)
            for i in range(bt_np.shape[0]):
                if np.array_equal(bt_np[i, :len(blocks)], blocks):
                    out[uid] = i
                    break
        return out

    def decode(cfg, params, kv, tok, pos, bt, ctx):
        logits, kv = real["ragged_decode_forward"](cfg, params, kv, tok, pos,
                                                   bt, ctx)
        pos_np = pos.cpu().numpy()
        for uid, i in slots(bt).items():
            if pos_np[i] in targets[uid]:
                rows[(uid, int(pos_np[i]))] = logits[i].float().cpu()
        return logits, kv

    def prefill(cfg, params, kv, seg_tokens, pos0, nreal, bt):
        logits, kv = real["ragged_prefill_forward"](cfg, params, kv,
                                                    seg_tokens, pos0, nreal,
                                                    bt)
        pos0_np, nreal_np = pos0.cpu().numpy(), nreal.cpu().numpy()
        for uid, i in slots(bt).items():
            for P in targets[uid]:
                qi = P - pos0_np[i]
                if 0 <= qi < nreal_np[i]:
                    rows[(uid, P)] = logits[i, qi].float().cpu()
        return logits, kv

    def gather(cfg, params, kv, tok, seq, pos, bt, num_tokens):
        logits, kv = real["ragged_forward"](cfg, params, kv, tok, seq, pos,
                                            bt, num_tokens)
        seq_np = seq.cpu().numpy()[:int(num_tokens)]
        pos_np = pos.cpu().numpy()[:int(num_tokens)]
        for uid, i in slots(bt).items():
            for P in targets[uid]:
                hit = np.nonzero((seq_np == i) & (pos_np == P))[0]
                if len(hit):
                    rows[(uid, P)] = logits[hit[0]].float().cpu()
        return logits, kv

    model_runner.ragged_decode_forward = decode
    model_runner.ragged_prefill_forward = prefill
    model_runner.ragged_forward = gather

    def remove():
        for n, fn in real.items():
            setattr(model_runner, n, fn)

    return rows, remove


def parting_targets(prompts, plain_out, spec_out):
    """{uid: first parting index} of the streams that part (``plain_out``
    names them), and the query positions whose rows chose the parting
    tokens ({uid: {P}}: the row at P yields the token at P + 1)."""
    first = {}
    for uid in sorted(plain_out):
        a, b = plain_out[uid], spec_out[uid]
        if a != b:
            first[uid] = next(i for i, (x, y) in enumerate(zip(a, b))
                              if x != y)
    return first, {uid: {len(prompts[uid]) + p - 1}
                   for uid, p in first.items()}


def recorded_serve(torch, InferenceEngineV2, model_runner, model, prompts,
                   engine_kw, targets, expect, label):
    """Serve the workload again with ``engine_kw``, recording the logits
    rows of ``targets`` (``row_recorder``); the streams must come out as
    ``expect`` (the runs are deterministic). Returns (the rows, the
    wall)."""
    eng = serve_engine(torch, InferenceEngineV2, model, **engine_kw)
    rows, remove = row_recorder(model_runner, eng, targets)
    try:
        out, wall = serve_workload(torch, eng, prompts)
    finally:
        remove()
    if out != expect:
        fail(f"spec serve {label}: a rerun of the same engine config gave "
             "other streams")
    missing = {(u, P) for u, ps in targets.items() for P in ps} - set(rows)
    if missing:
        fail(f"spec serve {label}: rows {sorted(missing)} not seen")
    del eng
    torch.cuda.empty_cache()
    return rows, wall


class PartingGate:
    """The near-tie gate on speculative streams against the plain path's
    (phase 3's, or the repetitive set's spec-off run): identical, or each
    stream that parts does so at a near tie. Each run's rows at its first
    parting tokens come from a recorded rerun of that run, the plain
    rows from one recorded rerun of the plain run for every pending
    check (``check_pending``); the plain row's gap between the two chosen
    tokens must be no larger than the max-abs difference between the two
    rows. Any other parting fails."""

    def __init__(self, torch, InferenceEngineV2, model_runner, model,
                 ref_out=None):
        self.args = (torch, InferenceEngineV2, model_runner, model)
        self.ref_out = ref_out  # phase 3's streams
        self.pending = []

    def add(self, label, prompts, plain_out, spec_kw, spec_out, result,
            spec_rows=None):
        """Queue ``spec_out``'s check; ``spec_rows`` are rows recorded by
        a rerun already made (else one is made here). The check's result
        lands in ``result["vs_plain"]``."""
        first, targets = parting_targets(prompts, plain_out, spec_out)
        if first and spec_rows is None:
            spec_rows, _ = recorded_serve(*self.args, prompts, spec_kw,
                                          targets, spec_out, label)
        self.pending.append((label, prompts, plain_out, spec_out, first,
                             targets, spec_rows, result))
        return targets

    def check_pending(self, plain_kw, plain_rows=None):
        """Evaluate every queued check against one recorded rerun of the
        plain run (or ``plain_rows`` recorded already)."""
        if not self.pending:
            return
        _, prompts, plain_out = self.pending[0][:3]
        union = {}
        for entry in self.pending:
            for uid, ps in entry[5].items():
                union.setdefault(uid, set()).update(ps)
        if union and plain_rows is None:
            plain_rows, _ = recorded_serve(*self.args, prompts, plain_kw,
                                           union, plain_out, "plain rerun")
        for (label, prompts, plain_out, spec_out, first, targets, spec_rows,
             result) in self.pending:
            partings = check_partings(f"spec serve {label}", prompts, first,
                                      plain_out, spec_out, plain_rows,
                                      spec_rows)
            result["vs_plain"] = {"streams_parting": len(partings),
                                  "partings": partings}
        self.pending = []


def check_partings(label, prompts, first, plain_out, spec_out, plain_rows,
                   spec_rows, bound=None):
    """The near-tie rule at each stream's first parting (``first``, from
    ``parting_targets``): the rows recorded there (keyed (uid, P)) pick
    the two streams' tokens, and the plain row's gap between them is no
    larger than the max-abs difference between the two rows; with
    ``bound`` that difference must itself stay within it (so rows that
    are wrong cannot pass as a tie). Returns the partings."""
    partings = []
    for uid, p in first.items():
        key = (uid, len(prompts[uid]) + p - 1)
        plain, spec = plain_rows[key], spec_rows[key]
        a, b = plain_out[uid][p], spec_out[uid][p]
        gap = float(plain[a] - plain[b])
        diff = float((plain - spec).abs().max())
        partings.append({"uid": uid, "position": p, "plain_token": a,
                         "spec_token": b, "plain_gap": gap,
                         "rows_max_abs_diff": diff})
        if not (plain.argmax() == a and spec.argmax() == b):
            fail(f"{label}: stream {uid}'s recorded rows do not pick its "
                 f"tokens at {p}")
        if gap > diff:
            fail(f"{label}: stream {uid} parts at {p} with a plain-path gap "
                 f"{gap} > the paths' row difference {diff}")
        if bound is not None and diff > bound:
            fail(f"{label}: stream {uid}'s rows at {p} differ by {diff} > "
                 f"{bound}")
    return partings


def spec_serve_phase(torch, InferenceEngineV2, pa, model_runner, model,
                     prompts, gate):
    """12a: phase 3's requests with prompt-lookup speculation at fixed k
    (then a recorded rerun: identical streams) and adaptive k, queued on
    ``gate`` against phase 3's streams; the repetitive set spec off and
    on, gated against its own spec-off run here."""
    runs, paths = {}, {}
    kw = {"spec_decode": True, "spec_k": SPEC_K}
    out, runs["lookup_k4"], paths["spec_serve/lookup_k4"] = spec_run(
        torch, InferenceEngineV2, pa, model_runner, model, prompts,
        "lookup_k4", **kw)
    ref_out = gate.ref_out
    _, targets = parting_targets(prompts, ref_out, out)
    # the rerun records the rows the gate needs (its timing is not a
    # measurement: the recorder reads positions back every forward)
    rows, wall = recorded_serve(torch, InferenceEngineV2, model_runner,
                                model, prompts, kw, targets, out,
                                "lookup_k4 rerun")
    runs["lookup_k4"]["rerun_identical"] = True
    gate.add("lookup_k4", prompts, ref_out, kw, out, runs["lookup_k4"],
             spec_rows=rows)
    ada_kw = dict(kw, spec_adaptive_k=True)
    out, runs["lookup_adaptive"], paths["spec_serve/lookup_adaptive"] = \
        spec_run(torch, InferenceEngineV2, pa, model_runner, model, prompts,
                 "lookup_adaptive", **ada_kw)
    gate.add("lookup_adaptive", prompts, ref_out, ada_kw, out,
             runs["lookup_adaptive"])
    rep = repetitive_prompts(SEED + 5)
    rep_out = {}
    for label, engine_kw in (("repetitive_spec_off", {}),
                             ("repetitive_lookup_k4", kw)):
        rep_out[label], runs[label], paths[f"spec_serve/{label}"] = \
            spec_run(torch, InferenceEngineV2, pa, model_runner, model, rep,
                     label, **engine_kw)
    if runs["repetitive_lookup_k4"]["spec_steps"] <= 0:
        fail("spec serve: no verify round on the repetitive set")
    rep_gate = PartingGate(*gate.args)
    rep_gate.add("repetitive_lookup_k4", rep, rep_out["repetitive_spec_off"],
                 kw, rep_out["repetitive_lookup_k4"],
                 runs["repetitive_lookup_k4"])
    rep_gate.check_pending({})
    return runs, paths


def draft_model_phase(torch, InferenceEngineV2, pa, fa, attn, model_runner,
                      model, prompts, gate):
    """12b: ``TransformerDrafter.small`` (hidden 32 over 2 heads: head dim
    16, the dense attention path by C5) behind the same engine, before
    and after ``distill_from`` against the served model; each run queued
    on ``gate`` against phase 3's streams."""
    from deepspeed_tpu_torch.inference.spec_decode import TransformerDrafter

    if attn.auto_impl("cuda", torch.bfloat16, 16) != "xla":
        fail("draft model: impl='auto' at head dim 16 is not the dense path")
    drafter = TransformerDrafter.small(model.config.vocab_size,
                                       window=DRAFT_WINDOW, seed=SEED)
    timing = {"calls": 0, "s": 0.0}
    real_propose = drafter.propose

    def propose(tokens, k):
        t0 = time.perf_counter()
        ids = real_propose(tokens, k)
        timing["calls"] += 1
        timing["s"] += time.perf_counter() - t0
        return ids

    drafter.propose = propose
    runs, paths = {}, {}
    kw = {"drafter": drafter, "spec_k": SPEC_K}

    def serve(label):
        fa.reset_launch_counts()
        timing.update(calls=0, s=0.0)
        out, res, paths[f"spec_serve/{label}"] = spec_run(
            torch, InferenceEngineV2, pa, model_runner, model, prompts,
            label, **kw)
        if any(fa.LAUNCHES.values()):
            fail(f"draft model {label}: the drafter launched flash kernels "
                 f"{fa.LAUNCHES} (head dim 16 must take the dense path)")
        res["propose_calls"] = timing["calls"]
        res["propose_ms_per_call"] = 1e3 * timing["s"] / max(1,
                                                              timing["calls"])
        res["propose_ms_per_round"] = 1e3 * timing["s"] / max(
            1, res["spec_steps"] + res["burst_steps"])
        runs[label] = res
        gate.add(label, prompts, gate.ref_out, kw, out, res)

    serve("draft_untrained")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = drafter.distill_from(model, steps=DRAFT_STEPS,
                                   batch=DRAFT_BATCH, seed=SEED,
                                   prefix_len=DRAFT_PREFIX,
                                   resample_every=DRAFT_RESAMPLE)
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    serve("draft_distilled")
    return {"distill": dict(summary, seconds=distill_s),
            "runs": runs}, paths


def check_prefill_verify(torch, pa, timer):
    """12c: B5 at the verify shape: 8 segments x Tq 8 (5 real rows) over
    300-560-token paged histories, bf16. The tensor-core kernel (one
    warpgroup: Tq x group = 32) twice, bit for bit, against its plain
    version; then timed beside its first version, the plain version,
    SDPA on gathered K/V and the bound."""
    rng = np.random.default_rng(40)
    S, tq = VERIFY_S, VERIFY_TQ
    kv, bt = make_pool(torch, rng, torch.bfloat16, S)
    ctx_np = rng.integers(VERIFY_CTX[0], VERIFY_CTX[1] + 1,
                          S).astype(np.int32)
    pos0_np = (ctx_np - VERIFY_REAL).astype(np.int32)
    pos0 = torch.from_numpy(pos0_np).cuda()
    ctx = torch.from_numpy(ctx_np).cuda()
    q = torch.from_numpy(rng.standard_normal((S, tq, NH, HD),
                                             np.float32)).to("cuda",
                                                             torch.bfloat16)
    before = dict(pa.VARIANT_LAUNCHES)
    out = pa.paged_prefill_attention(q, kv, bt, pos0, ctx)
    again = pa.paged_prefill_attention(q, kv, bt, pos0, ctx)
    ref = pa.paged_prefill_attention_plain(q, kv, bt, pos0, ctx, HD ** -0.5)
    torch.cuda.synchronize()
    ran = prefill_variants_ran(pa, before)
    if ran != {"wgmma": 2, "simt": 0} or not torch.equal(out, again):
        fail(f"paged_prefill verify shape: ran {ran} or reruns differ")
    real = torch.arange(tq, device="cuda") < VERIFY_REAL
    err = (out.float() - ref.float())[:, real].abs().max().item()
    if err > TOL["bfloat16"] or not torch.isfinite(out[:, real]).all():
        fail(f"paged_prefill verify shape: max-abs {err}")
    res = {"variant": "wgmma", "max_abs_err": err,
           "kernel": ("paged_prefill_wgmma_kernel<1>"
                      if tq * (NH // NKV) <= 64 else
                      "paged_prefill_wgmma_kernel<2>"),
           "real_rows": VERIFY_REAL, "bit_identical_rerun": True}
    res.update(time_prefill(torch, pa, timer, q, kv, bt, pos0_np, ctx_np))
    return res


def a4_phase(torch, zoo, initialize, fa, tf):
    """12d: A4 on 2-layer full-width Llama-3-8B, micro 2 x GAS
    2 x 2048 over phase 4's fixed batches: the blocking loop and
    pipeline_depth 2 + prefetch_depth 2 (6 steps each, losses ``==``, a
    profiled window of 3 more each), the same model as a ``(loss_fn,
    params)`` pair over the functional forward (3 steps, within rtol 1e-5
    of the module engine) and a client ``torch.optim.AdamW`` against the
    config AdamW (3 steps, rtol 1e-4). Flash launches as remat implies,
    all on the tensor-core kernels."""
    L = A4_LAYERS

    def model_():
        return zoo.get_model("llama3-8b", num_layers=L, dtype=torch.float32,
                             seed=SEED)

    vocab = zoo.get_config("llama3-8b").vocab_size
    fixed, _ = fixed_batches(vocab)
    gas = TRAIN_GAS
    batches = [fixed[i % 2] for i in range((A4_STEPS + A4_PROFILED) * gas)]
    want = {"flash_fwd": 2 * L * TRAIN_GAS, "flash_bwd_dkdv": L * TRAIN_GAS,
            "flash_bwd_dq": L * TRAIN_GAS}
    launches_by_run = {}

    def run(label, steps, config, profile=False, **init_kw):
        torch.cuda.empty_cache()
        model = init_kw.pop("model", None)
        if model is None:
            model = model_()
        engine, *_ = initialize(model=init_kw.pop("loss_fn", model),
                                config=dict(config), **init_kw)
        fa.reset_launch_counts()
        it = iter(batches[:steps * gas])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks, losses = [], []
        for _ in range(steps):
            losses.append(engine.train_batch(it))
            marks.append(time.perf_counter())
        engine.synchronize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        launches = {**fa.LAUNCHES, **fa.VARIANT_LAUNCHES}
        got = {k: fa.LAUNCHES[k] for k in want}
        if got != {k: v * steps for k, v in want.items()}:
            fail(f"a4 {label}: flash launches {got}, remat implies "
                 f"{ {k: v * steps for k, v in want.items()} }")
        check_tensor_core(f"a4 {label}", fa.LAUNCHES, fa.VARIANT_LAUNCHES,
                          ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))
        if not all(np.isfinite(losses)):
            fail(f"a4 {label}: losses {losses}")
        gaps = np.diff([t0] + marks)
        res = {"losses": losses, "wall_s": wall,
               "step_s": [float(x) for x in gaps],
               # the first step carries the warm-up
               "step_ms_p50": float(np.median(gaps[1:])) * 1e3,
               "launches": launches}
        if profile:
            prof = start_profile(torch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pit = iter(batches[steps * gas:(steps + A4_PROFILED) * gas])
            for _ in range(A4_PROFILED):
                engine.train_batch(pit)
            engine.synchronize()
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t1
            prof.__exit__(None, None, None)
            res["profile"] = device_breakdown(torch, prof, pwall,
                                              A4_PROFILED, unit="step")
            del prof
        launches_by_run[label] = launches
        del engine, model
        torch.cuda.empty_cache()
        return res

    t_start = time.perf_counter()
    blocking = run("blocking", A4_STEPS, A4_CONFIG, profile=True)
    pipelined = run("pipelined", A4_STEPS, A4_PIPELINED, profile=True)
    if pipelined["losses"] != blocking["losses"]:
        fail(f"a4: pipelined losses {pipelined['losses']} != blocking "
             f"{blocking['losses']}")
    # the same model as a (loss_fn, params) pair over the functional
    # forward (the flash kernels through attn_impl "auto" at head dim 128)
    fn_model = model_()
    cfg_c = dataclasses.replace(fn_model.config, dtype=torch.bfloat16)
    fn = run("loss_fn_params", A4_SHORT, A4_CONFIG, model=fn_model,
             loss_fn=lambda p, b: tf.loss_fn(cfg_c, p, b),
             model_parameters=fn_model.params())
    del fn_model
    ref = np.asarray(blocking["losses"][:A4_SHORT])
    fn_rel = float(np.max(np.abs(np.asarray(fn["losses"]) - ref) / ref))
    if fn_rel > A4_FN_TOL_REL:
        fail(f"a4: (loss_fn, params) losses {fn['losses']} vs the module "
             f"engine's {ref.tolist()}: rel {fn_rel}")
    # a client torch AdamW at the config AdamW's hyperparameters (the JAX
    # mapping: weight decay 0.01, betas (0.9, 0.999), eps 1e-8)
    cl_model = model_()
    opt = torch.optim.AdamW(cl_model.parameters(), lr=A4_LR,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    client_cfg = {k: v for k, v in A4_CONFIG.items() if k != "optimizer"}
    client = run("client_adamw", A4_SHORT, client_cfg, model=cl_model,
                 optimizer=opt)
    del cl_model, opt
    cl_rel = float(np.max(np.abs(np.asarray(client["losses"]) - ref) / ref))
    if cl_rel > A4_CLIENT_TOL_REL:
        fail(f"a4: client AdamW losses {client['losses']} vs the config "
             f"AdamW's {ref.tolist()}: rel {cl_rel}")
    return {"model": "llama3-8b", "layers": f"{L} of 32",
            "micro": TRAIN_MICRO, "gas": TRAIN_GAS, "seq": TRAIN_SEQ,
            "blocking": blocking, "pipelined": pipelined,
            "pipelined_equals_blocking": True,
            "loss_fn_params": dict(fn, max_rel_vs_module=fn_rel),
            "client_adamw": dict(client, max_rel_vs_config_adamw=cl_rel),
            "wall_s": time.perf_counter() - t_start}, launches_by_run


def check_tensor_core(phase, launches, variants,
                      names=("gmm", "gmm_transposed")):
    """Every launch of the kernels ``names`` on a bf16 main path (K and N
    multiples of 8; flash, paged prefill, paged decode and B9 at head dim
    128; B9 at layout block 128) went through the fast kernel: the
    tensor-core one, or for paged decode the split one
    (``FAST_VARIANT``)."""
    for name in names:
        fast = FAST_VARIANT.get(name, "wgmma")
        if variants[f"{name}/simt"] or \
                variants[f"{name}/{fast}"] != launches[name]:
            fail(f"{phase}: {name} launches by variant {variants}: every "
                 f"one must take the {fast} kernel")


def moe_ffn_agrees(torch, moe, gm, tf, model, prompts):
    """Layer 0's MoE FFN on one 256-token prefill batch (the normed
    embeddings of uid 0's prompt) through the gmm kernel and through the
    plain gmm. The kernel path runs under CUDA's sync debug mode: the
    dispatch keeps the group sizes on the device, so it must not make
    the host wait."""
    import dataclasses
    import warnings

    import torch.nn.functional as F

    cfg, params = model.config, model.params()
    toks = torch.from_numpy(prompts[0][:256]).cuda()
    x = F.embedding(toks.long(), params["embed"]["tokens"])[None]
    y = tf._norm(x, {"scale": params["layers"]["ln2"]["scale"][0]}, cfg.norm,
                 cfg.norm_eps)
    args = (y, params["layers"]["moe"]["router"][0],
            {k: v[0] for k, v in params["layers"]["moe"]["experts"].items()},
            dataclasses.replace(cfg.gate, drop_tokens=False))
    def host_syncs(fn):
        """fn's result and the synchronizing operations it made."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [str(w.message)[:120] for w in caught
                     if "called a synchronizing" in str(w.message)]

    (got, aux), syncs = host_syncs(lambda: moe.moe_ffn(
        *args, activation=cfg.activation, train=False))
    if syncs:
        fail(f"moe serve: the MoE FFN made the host wait: {syncs}")
    # the detector itself: reading a value back must register
    _, control = host_syncs(lambda: y.sum().item())
    kernel_gmm = moe.gmm
    moe.gmm = lambda lhs, rhs, gs: gm.gmm_plain(lhs, rhs, gs)
    try:
        want, _ = moe.moe_ffn(*args, activation=cfg.activation, train=False)
    finally:
        moe.gmm = kernel_gmm
    torch.cuda.synchronize()
    if got.shape != (1, 256, cfg.hidden_size) or not (
            torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail("moe serve: MoE FFN wrong shape or non-finite")
    diff = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    if diff > MOE_FFN_TOL_REL * top:
        fail(f"moe serve: layer-0 MoE FFN kernel vs plain gmm: max-abs "
             f"{diff} > {MOE_FFN_TOL_REL} x {top}")
    return {"max_abs_diff": diff, "max_abs_out": top,
            "expert_load": aux["expert_load"].tolist(), "host_syncs": 0,
            "sync_detector_sees_item": bool(control)}


def moe_serve_phase(torch, zoo, InferenceEngineV2, pa, gm, moe, tf):
    """Returns (moe serve line, its profile line, launches on the main
    path)."""
    over = dict(preset="mixtral-8x7b", vocab=MOE_VOCAB,
                num_layers=MOE_SERVE_LAYERS)
    model, eng, ref_out, _, _ = serve_once(torch, zoo, InferenceEngineV2,
                                           **over)
    del model, eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    gm.reset_launch_counts()
    model, eng, out, wall, prompts = serve_once(torch, zoo,
                                                InferenceEngineV2, **over)
    launches = {**pa.LAUNCHES, **gm.LAUNCHES}
    variants = {**pa.VARIANT_LAUNCHES, **gm.VARIANT_LAUNCHES}
    if sorted(out) != list(range(8)) or any(len(v) != NEW_TOKENS
                                            for v in out.values()):
        fail(f"moe serve: token counts "
             f"{[len(out.get(u, [])) for u in range(8)]}")
    if out != ref_out:
        fail("moe serve: a second engine from the same seed gave other "
             "streams")
    per_forward = 3 * MOE_SERVE_LAYERS  # wg, wi, wo in every layer
    if min(launches["paged_decode"], launches["paged_prefill"],
           launches["gmm"]) <= 0 or launches["gmm"] % per_forward:
        fail(f"moe serve: launches {launches}: every kernel of the path "
             f"must run, gmm a multiple of {per_forward}")
    check_tensor_core("moe serve", launches, variants,
                      ("gmm", "gmm_transposed", "paged_prefill",
                       "paged_decode"))
    agree = moe_ffn_agrees(torch, moe, gm, tf, model, prompts)
    st = eng.stats
    ttft = sorted(eng.latency["ttft_s"])
    gen = sum(len(v) for v in out.values())
    prompt_tokens = sum(len(p) for p in prompts)
    serve = {
        "model": "mixtral-8x7b",
        "layers": f"{MOE_SERVE_LAYERS} of 32",
        "params": model.config.num_params(),
        "active_params": model.config.active_params(),
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
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "launches": launches, "variant_launches": variants,
        "model_forwards": launches["gmm"] // per_forward,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "moe_ffn_kernel_vs_plain": agree, "deterministic_rerun": True,
    }
    del model, eng
    torch.cuda.empty_cache()
    prof_out, prof_wall, prof = serve_once(torch, zoo, InferenceEngineV2,
                                           profile=True, **over)
    if prof_out != ref_out:
        fail("moe serve: the profiled run gave other streams")
    profile = device_breakdown(torch, prof, prof_wall, gen)
    del prof
    torch.cuda.empty_cache()
    return serve, profile, {**launches, **variants}


def moe_train_phase(torch, zoo, initialize, fa, gm):
    """Returns (moe train line, its profile line, launches on the main
    path)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = zoo.get_model("mixtral-8x7b", num_layers=MOE_TRAIN_LAYERS,
                          dtype=torch.float32, seed=SEED)
    cfg = model.config
    engine, *_ = initialize(model=model, config=dict(MOE_TRAIN_CONFIG))
    _, data = fixed_batches(cfg.vocab_size, MOE_TRAIN_MICRO)

    def losses_of(loss):
        m = engine.last_metrics
        return [float(loss), float(m["lm_loss"]), float(m["aux_loss"])]

    losses = [losses_of(engine.train_batch(data))]  # warm-up step
    fa.reset_launch_counts()
    gm.reset_launch_counts()
    step_s = []
    for _ in range(TRAIN_MEASURED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(data)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(losses_of(loss))
    launches = {**fa.LAUNCHES, **gm.LAUNCHES}
    variants = {**fa.VARIANT_LAUNCHES, **gm.VARIANT_LAUNCHES}
    L, steps, gas = MOE_TRAIN_LAYERS, TRAIN_MEASURED, MOE_TRAIN_GAS
    want = {"flash_fwd": steps * 2 * L * gas,  # forward + remat replay
            "flash_bwd_dkdv": steps * L * gas,
            "flash_bwd_dq": steps * L * gas,
            "gmm": steps * 6 * L * gas,  # wg, wi, wo, twice with remat
            "gmm_transposed": steps * 3 * L * gas,
            "tgmm": steps * 3 * L * gas}
    if launches != want:
        fail(f"moe train: launches {launches}, remat implies {want}")
    check_tensor_core("moe train", launches, variants,
                      ("gmm", "gmm_transposed", "tgmm", "flash_fwd",
                       "flash_bwd_dkdv", "flash_bwd_dq"))
    flat = np.asarray(losses)
    if not np.all(np.isfinite(flat)) or flat[-1, 0] >= flat[0, 0] \
            or flat[-1, 1] >= flat[0, 1]:
        fail(f"moe train: losses {losses} not finite and falling")
    gnorm = float(engine.get_global_grad_norm())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = MOE_TRAIN_MICRO * gas * TRAIN_SEQ
    p50 = float(np.median(step_s))
    flops_tok = 6 * cfg.active_params() + 12 * L * cfg.hidden_size * TRAIN_SEQ
    train = {
        "model": "mixtral-8x7b", "layers": f"{L} of 32",
        "params": cfg.num_params(), "active_params": cfg.active_params(),
        "dtype": "bfloat16 compute, fp32 masters", "micro": MOE_TRAIN_MICRO,
        "gas": gas, "seq": TRAIN_SEQ, "tokens_per_step": tokens,
        "step_s": step_s, "step_ms_p50": p50 * 1e3,
        "tokens_per_s": tokens / p50,
        "mfu": tokens / p50 * flops_tok / PEAK_FLOPS["bfloat16"],
        "flops_per_token": flops_tok, "peak_mem_gb": peak_gb,
        "losses_total_lm_aux": losses, "grad_norm": gnorm,
        "global_steps": engine.global_steps, "launches": launches,
        "launches_per_step": {k: v // steps for k, v in launches.items()},
        "variant_launches": variants,
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
    return train, profile, {**launches, **variants}


# -- phase 8: block-sparse forward and training --------------------------------


def sparse_forward_phase(torch, tf, attn, bs, model):
    """Phase 3's full-depth bf16 Llama-3-8B, ``loss_fn`` with
    ``attn_impl="blocksparse"`` and the fixed layout under no_grad at
    B 1 x S 8192. Returns (the line, its profile line, B9 launches of
    the main-path forward)."""
    cfg = dataclasses.replace(model.config, attn_impl="blocksparse",
                              remat=False)
    params = model.params()
    attn.set_sparse_config(bs.FixedSparsityConfig())
    rng = np.random.default_rng(SEED + 3)
    batch = {"input_ids": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, SPARSE_SEQ + 1)).astype(np.int32)).cuda()}

    def forward():
        with torch.no_grad():
            loss, _ = tf.loss_fn(cfg, params, batch)
        torch.cuda.synchronize()
        return loss

    forward()  # warm-up: builds the work list
    bs.reset_launch_counts()
    loss = forward()  # the main path
    launches = dict(bs.LAUNCHES)
    variants = dict(bs.VARIANT_LAUNCHES)
    L = cfg.num_layers
    if launches["blocksparse_fwd"] != L or not torch.isfinite(loss):
        fail(f"sparse forward: B9 launches {launches} (want {L}), loss "
             f"{loss.item()}")
    check_tensor_core("sparse forward", launches, variants,
                      ("blocksparse_fwd",))
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        forward()
        wall.append(time.perf_counter() - t0)
    if bs.LAUNCHES["blocksparse_fwd"] != 4 * L:
        fail(f"sparse forward: {bs.LAUNCHES} over 4 forwards")
    # layer 0's q, k, v of this batch: kernel vs the masked form
    seen = {}
    kernel_mha = tf.multi_head_attention

    def capture(q, k, v, **kw):
        seen.setdefault("qkv", (q, k, v))
        return kernel_mha(q, k, v, **kw)

    tf.multi_head_attention = capture
    try:
        forward()
    finally:
        tf.multi_head_attention = kernel_mha
    q, k, v = seen.pop("qkv")
    sparsity = attn._SPARSE_CONFIG
    got = bs.blocksparse_attention_kernel(q, k, v, sparsity)
    masked = masked_by_heads(torch, attn, bs, q, k, v, sparsity, True)
    err = row_rel_err(torch, got, masked)
    if err > BS_MASKED_TOL_ROW["bfloat16"]:
        fail(f"sparse forward: layer-0 kernel vs masked form {err} over "
             f"{BS_MASKED_TOL_ROW['bfloat16']} of a row's largest entry")
    del q, k, v, got, masked
    prof = start_profile(torch)
    t0 = time.perf_counter()
    forward()
    prof_wall = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    profile = device_breakdown(torch, prof, prof_wall, 1, unit="forward")
    del prof
    b9 = profile.get("by_family", {}).get("blocksparse_fwd", {"ms": 0.0})
    profile["blocksparse_fwd_share"] = (
        b9["ms"] / 1e3 / profile["device_busy_s"]
        if profile.get("device_time_measured") else None)
    work = bs.work_list(sparsity, SPARSE_SEQ, True, torch.device("cuda"))
    line = {
        "model": "llama3-8b", "layers": L, "dtype": "bfloat16",
        "attn_impl": "blocksparse", "layout": "fixed (block 128, 4 local, "
        "1 global)", "seq": SPARSE_SEQ, "batch": 1, "loss": loss.item(),
        "layout_density": bs.layout_density(work.layout_host, True),
        "forward_s": wall, "forward_ms_p50": float(np.median(wall)) * 1e3,
        "tokens_per_s": SPARSE_SEQ / float(np.median(wall)),
        "launches_per_forward": launches["blocksparse_fwd"],
        "variant_launches_per_forward": variants,
        "layer0_kernel_vs_masked_max_row_rel_err": err,
    }
    attn.set_sparse_config(None)
    return line, profile, {**launches, **variants}


def sparse_paths_at_lr3e4(torch, zoo, initialize, attn):
    """Phase 8b's model, data and loop for 5 steps from the same seed at
    phase 4's lr 3e-4 through the flash kernels and through the masked
    form on a dense layout. The two compute one function by independent
    code (the masked form's autograd, the flash forward and backward
    kernels), so their losses must agree at every step. Returns
    {run: [(mean loss, grad norm) per step]}."""
    runs = {"flash": ("flash", None), "dense_masked": ("blocksparse", "dense")}
    out = {}
    for name, (impl, mode) in runs.items():
        torch.cuda.empty_cache()
        model = zoo.get_model("llama3-8b", num_layers=TRAIN_LAYERS,
                              dtype=torch.float32, seed=SEED, attn_impl=impl)
        rng = np.random.default_rng(SEED + 4)
        rows = [rng.integers(0, model.config.vocab_size, SPARSE_TRAIN_SEQ + 1)
                .astype(np.int32) for _ in range(SPARSE_GAS)]
        cfg = dict(SPARSE_TRAIN_CONFIG, optimizer={
            "type": "adamw", "params": {"lr": 3e-4}})
        cfg["sparse_attention"] = None if mode is None else {"mode": mode}
        engine, _, loader, _ = initialize(
            model=model, config=cfg,
            training_data=[{"input_ids": r} for r in rows] * 5)
        steps, losses = [], []
        for batch in loader:
            loss = engine(batch)
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
            if engine.is_gradient_accumulation_boundary():
                steps.append((float(np.mean(losses)),
                              float(engine.get_global_grad_norm())))
                losses = []
        out[name] = steps
        del engine, model, loader
    attn.set_sparse_config(None)
    torch.cuda.empty_cache()
    diff = max(abs(a[0] - b[0]) / abs(b[0])
               for a, b in zip(out["dense_masked"], out["flash"]))
    if not np.isfinite(diff) or diff > TRAIN_LOSS_TOL_REL:
        fail(f"sparse train: the masked form (dense layout) and the flash "
             f"path disagree over 5 steps: {out}")
    out["dense_masked_vs_flash_max_loss_rel_diff"] = diff
    return out


def sparse_train_phase(torch, zoo, initialize, bs, attn):
    """``initialize`` with a ``sparse_attention`` block and
    ``training_data`` over 8-layer full-width Llama-3-8B; the micro-step
    loop at micro 1 x GAS 2 x S 4096 (the masked form carries the
    gradient, so no B9 launch), then ``eval_batch`` at S 8192 (one B9
    launch a layer). Returns (the line, B9 launches by path)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = zoo.get_model("llama3-8b", num_layers=TRAIN_LAYERS,
                          dtype=torch.float32, seed=SEED,
                          attn_impl="blocksparse")
    cfg = model.config
    rng = np.random.default_rng(SEED + 4)
    rows = [rng.integers(0, cfg.vocab_size, SPARSE_TRAIN_SEQ + 1)
            .astype(np.int32) for _ in range(SPARSE_GAS)]
    # the same microbatches every step, so the loss can fall
    data = [{"input_ids": r} for r in rows] * (1 + SPARSE_MEASURED)
    engine, _, loader, _ = initialize(model=model,
                                      config=dict(SPARSE_TRAIN_CONFIG),
                                      training_data=data)
    if not isinstance(attn._SPARSE_CONFIG, bs.FixedSparsityConfig):
        fail(f"sparse train: the engine installed {attn._SPARSE_CONFIG}")
    batches = iter(loader)

    def step():
        losses = []
        for _ in range(SPARSE_GAS):
            loss = engine(next(batches))
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
        return float(np.mean(losses))

    losses = [step()]  # warm-up
    bs.reset_launch_counts()
    step_s = []
    for _ in range(SPARSE_MEASURED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    train_launches = bs.LAUNCHES["blocksparse_fwd"]
    if train_launches != 0 or any(bs.VARIANT_LAUNCHES.values()):
        fail(f"sparse train: {train_launches} B9 launches while training "
             "(the masked form carries the gradient)")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail(f"sparse train: losses {losses} not finite and falling")
    if engine.global_steps != 1 + SPARSE_MEASURED or \
            engine.micro_steps != SPARSE_GAS * (1 + SPARSE_MEASURED):
        fail(f"sparse train: steps {engine.global_steps}, micro steps "
             f"{engine.micro_steps}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ev = {"input_ids": rng.integers(0, cfg.vocab_size, (1, SPARSE_SEQ + 1))
          .astype(np.int32)}
    engine.eval_batch(ev)  # warm-up: the S 8192 work list
    bs.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev_loss = engine.eval_batch(ev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = bs.LAUNCHES["blocksparse_fwd"]
    eval_variants = dict(bs.VARIANT_LAUNCHES)
    if eval_launches != TRAIN_LAYERS or not torch.isfinite(ev_loss):
        fail(f"sparse eval: {eval_launches} B9 launches (want "
             f"{TRAIN_LAYERS}), loss {ev_loss.item()}")
    check_tensor_core("sparse eval", dict(bs.LAUNCHES), eval_variants,
                      ("blocksparse_fwd",))
    tokens = SPARSE_GAS * SPARSE_TRAIN_SEQ
    p50 = float(np.median(step_s))
    line = {
        "model": "llama3-8b", "layers": f"{TRAIN_LAYERS} of 32",
        "params": cfg.num_params(), "dtype": "bfloat16 compute, fp32 masters",
        "loop": "engine(batch), engine.backward(loss), engine.step()",
        "micro": 1, "gas": SPARSE_GAS, "seq": SPARSE_TRAIN_SEQ,
        "layout": "fixed (block 128, 4 local, 1 global)",
        "step_s": step_s, "step_ms_p50": p50 * 1e3,
        "tokens_per_s": tokens / p50, "peak_mem_gb": peak_gb,
        "losses": losses, "global_steps": engine.global_steps,
        "micro_steps": engine.micro_steps,
        "b9_launches_training": train_launches,
        "lr": SPARSE_TRAIN_CONFIG["optimizer"]["params"]["lr"],
        "eval_seq": SPARSE_SEQ, "eval_ms": eval_s * 1e3,
        "eval_loss": ev_loss.item(), "b9_launches_eval": eval_launches,
        "b9_variant_launches_eval": eval_variants,
    }
    del engine, model, loader, batches
    attn.set_sparse_config(None)
    line["at_lr3e-4"] = sparse_paths_at_lr3e4(torch, zoo, initialize, attn)
    return line, {"engine_eval": eval_launches, "train": train_launches,
                  "engine_eval_by_variant": eval_variants}


# -- phase 14: ZeRO stages on a one-rank NCCL group ---------------------------


def zero_collectives(tf, cfg, stage, gas):
    """The collectives one step issues on a one-rank group at ``stage``,
    derived from the model's leaves (a leaf with an ``embed`` dim
    shards) and its remat setting: per leaf and microbatch (stage 2's
    gradient scatter, stage 3's gathers and scatters), or per leaf and
    step (the boundary's all-reduce, stages 1-2's gather of the updated
    params), plus the global norm's and the mean loss's all-reduces."""
    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    axes = dict(flat(tf.logical_axes(cfg)))
    sharded = [p for p, ax in axes.items() if "embed" in ax]
    rep = len(axes) - len(sharded)
    layer = sum(p.startswith("layers/") for p in sharded)
    top = len(sharded) - layer
    L, remat = cfg.num_layers, 2 if cfg.remat else 1
    return {0: {"all_reduce": len(axes) + 2},
            1: {"all_reduce": len(axes) + 2, "all_gather": len(sharded)},
            2: {"reduce_scatter": len(sharded) * gas,
                "all_reduce": rep + 2, "all_gather": len(sharded)},
            3: {"all_gather": (top + layer * L * remat) * gas,
                "reduce_scatter": (top + layer * L) * gas,
                "all_reduce": rep + 2}}[stage]


def zero_phase(torch, zoo, initialize, fa, tf, attn):
    """14a: a one-rank NCCL group through a file store; 14b: ZeRO stages
    0-3 on 2-layer full-width Llama-3-8B, each stage equal to stage 0
    bit for bit, its collectives those the plan implies. Returns (the
    phase's line, flash launches by stage)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.optimizer import leaves
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger

    t_start = time.perf_counter()
    L, gas, steps = A4_LAYERS, TRAIN_GAS, ZERO_STEPS
    cfg = zoo.get_config("llama3-8b", num_layers=L)
    fixed, _ = fixed_batches(cfg.vocab_size)
    batches = [fixed[i % 2] for i in range(steps * gas)]
    want_flash = {"flash_fwd": 2 * L * gas * steps,
                  "flash_bwd_dkdv": L * gas * steps,
                  "flash_bwd_dq": L * gas * steps}
    store = tempfile.mkdtemp(prefix="dstpu_pg_")
    stages, launches_by_stage = {}, {}
    ref_losses = ref_masters = None
    logger = get_comms_logger()
    try:
        t0 = time.perf_counter()
        comm.init_distributed(dist_backend="nccl",
                              init_method=f"file://{store}/store",
                              num_processes=1, process_id=0, timeout=600)
        init_s = time.perf_counter() - t0
        group = {"backend": comm.get_backend(),
                 "world_size": comm.get_world_size(),
                 "rank": comm.get_rank(), "init_s": init_s}
        if (group["backend"], group["world_size"], group["rank"]) != \
                ("nccl", 1, 0):
            fail(f"zero: process group {group}, want nccl, 1, 0")
        for stage in ZERO_STAGES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = zoo.get_model("llama3-8b", num_layers=L,
                                  dtype=torch.float32, seed=SEED)
            engine, *_ = initialize(model=model, config=dict(
                A4_CONFIG, zero_optimization={"stage": stage},
                comms_logger={"enabled": True}))
            if not engine.mesh.distributed or engine._zero is None:
                fail(f"zero: stage {stage} engine is not on the group")
            logger.reset()
            fa.reset_launch_counts()
            it = iter(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            marks, losses = [], []
            for _ in range(steps):
                losses.append(engine.train_batch(it))
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            losses = [float(x) for x in losses]
            counts = logger.counts()
            nbytes = logger.totals()
            launches = {**fa.LAUNCHES, **fa.VARIANT_LAUNCHES}
            dispatch = no_card_losses(attn, f"zero stage {stage}")
            got = {k: fa.LAUNCHES[k] for k in want_flash}
            if got != want_flash:
                fail(f"zero stage {stage}: flash launches {got}, remat "
                     f"implies {want_flash}")
            check_tensor_core(f"zero stage {stage}", fa.LAUNCHES,
                              fa.VARIANT_LAUNCHES,
                              ("flash_fwd", "flash_bwd_dkdv",
                               "flash_bwd_dq"))
            want = {k: v * steps for k, v in
                    zero_collectives(tf, cfg, stage, gas).items()}
            if counts != want:
                fail(f"zero stage {stage}: collectives {counts}, the plan "
                     f"implies {want}")
            if not all(np.isfinite(losses)):
                fail(f"zero stage {stage}: losses {losses}")
            masters = {p: m.detach().cpu() for p, m in
                       leaves(engine.opt_state.master)}
            if ref_losses is None:
                ref_losses, ref_masters = losses, masters
            else:
                if losses != ref_losses:
                    fail(f"zero stage {stage}: losses {losses} != stage "
                         f"0's {ref_losses}")
                bad = [p for p in ref_masters
                       if not torch.equal(masters[p], ref_masters[p])]
                if bad or sorted(masters) != sorted(ref_masters):
                    fail(f"zero stage {stage}: fp32 masters differ from "
                         f"stage 0's: {bad[:5]}")
            gaps = np.diff([t0] + marks)
            stages[str(stage)] = {
                "losses": losses,
                "step_s": [float(x) for x in gaps],
                # the first step carries the warm-up
                "step_ms_p50": float(np.median(gaps[1:])) * 1e3,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "collectives": counts, "collective_bytes": nbytes,
                "collectives_per_step": {k: v // steps
                                         for k, v in counts.items()},
                "bytes_per_step": {k: v / steps for k, v in nbytes.items()},
                "launches": launches, "dispatch": dispatch}
            launches_by_stage[f"zero/stage{stage}"] = launches
            log(f"zero stage {stage}: step p50 "
                f"{stages[str(stage)]['step_ms_p50']:.1f} ms, peak "
                f"{stages[str(stage)]['peak_mem_gb']:.1f} GB, "
                f"collectives {counts}, bytes "
                f"{ {k: round(v / 1e9, 3) for k, v in nbytes.items()} } GB")
            del engine, model, masters, it
        del ref_masters
    finally:
        comm.destroy()
        shutil.rmtree(store, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"model": "llama3-8b", "layers": f"{L} of 32",
            "micro": TRAIN_MICRO, "gas": gas, "seq": TRAIN_SEQ,
            "steps": steps, "group": group, "stages": stages,
            "stages_equal_stage0_bitwise": True,
            "collectives_match_plan": True,
            "wall_s": time.perf_counter() - t_start}, launches_by_stage


# -- phase 13: the kernel bench and the v1 inference engine -------------------


def kernel_bench_phase(torch, kb, table_path):
    """13a: ``run_kernel_bench()`` at the card tier (PERF.md's kernel-table
    shapes; flash at S 256-4096) into ``table_path``, a scratch table that
    no committed file shares. Fails on any gate violation (numerics, an
    arm whose kernels did not launch, the dispatch probe). Returns the
    payload with the kernels' launches summed over the arms."""
    knobs = ("KERNEL_BENCH_KERNELS", "KERNEL_BENCH_FULL",
             "KERNEL_BENCH_ITERS", "DSTPU_KERNEL_TABLE")
    saved = {k: os.environ.pop(k, None) for k in knobs}
    os.environ["KERNEL_BENCH_RECORD_PATH"] = table_path
    try:
        _, payload, ok = kb.run_kernel_bench()
    finally:
        del os.environ["KERNEL_BENCH_RECORD_PATH"]
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    torch.cuda.empty_cache()
    if not ok:
        fail(f"kernel bench: gate violations "
             f"{json.dumps(payload['violations'])[:3000]}")
    arms = [r["kernel"] for r in payload["entries"]]
    if sorted(set(arms)) != ["blocksparse_attention", "flash_attention",
                             "grouped_matmul", "paged_attention"]:
        fail(f"kernel bench: arms {arms}")
    launched = {}
    for r in payload["entries"]:
        for k, n in r["launches"].items():
            launched[k] = launched.get(k, 0) + n
    if any(launched.get(k, 0) <= 0 for k in BENCH_KERNELS):
        fail(f"kernel bench: a kernel never launched: {launched}")
    for r in payload["entries"]:
        log(f"kernel bench {r['kernel']} {r['bucket']}: kernel "
            f"{r['kernel_ms']} ms, dense fallback {r['xla_ms']} ms, ratio "
            f"{r['ratio']} ({'win' if r['ratio'] >= 1.0 else 'loss'}), "
            f"library {r['library_ms']} ms, template "
            f"{r['blocks']['template']}, row errors {r['row_rel_err']}")
    payload["launched"] = launched
    with open(table_path) as f:
        payload["table"] = json.load(f)
    return payload


def v1_prompts(prompts):
    """V1_BATCH of phase 3's prompts cut to V1_PROMPT tokens (the first
    ones at least that long)."""
    return np.stack([p[:V1_PROMPT] for p in prompts
                     if len(p) >= V1_PROMPT][:V1_BATCH])


def v1_spy(torch, eng_mod):
    """Record each of the v1 engine's sampled steps: its logits rows
    (fp32, on the card) and the host time once the token exists. Returns
    (rows, times, remove)."""
    rows, times = [], []
    real = eng_mod._sample

    def spy(logits, temperature, top_k, generator=None):
        tok = real(logits, temperature, top_k, generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        rows.append(logits.float().clone())
        return tok

    eng_mod._sample = spy

    def remove():
        eng_mod._sample = real

    return rows, times, remove


def v2_streams(torch, InferenceEngineV2, model_runner, model, prompts,
               targets=None):
    """The 4 prompts through ``InferenceEngineV2`` (phase 3's engine
    settings), V1_NEW greedy tokens each; with ``targets`` the logits rows
    there are recorded (``row_recorder``). Returns (streams, rows)."""
    eng = serve_engine(torch, InferenceEngineV2, model)
    rows, remove = ({}, None) if not targets else \
        row_recorder(model_runner, eng, targets)
    try:
        eng.put(list(range(len(prompts))), list(prompts),
                max_new_tokens=V1_NEW)
        out = eng.generate_all()
    finally:
        if remove is not None:
            remove()
    del eng
    torch.cuda.empty_cache()
    return {u: [int(t) for t in toks] for u, toks in out.items()}, rows


def v1_vs_v2_gate(torch, InferenceEngineV2, model_runner, model, prompts,
                  v1_out, v1_rows, bound):
    """Phase 12's near-tie rule (``check_partings``), the v2 engine as the
    plain path and the v1 engine as the other: each v1 stream equals the
    v2 engine's, or parts where the v2 row's gap between the two chosen
    tokens is no larger than the two engines' rows' max-abs difference,
    which stays within ``bound`` (the v2 rows from a recorded rerun, the
    v1 rows from the measured run)."""
    S = prompts.shape[1]
    v1 = {b: v1_out[b, S:].tolist() for b in range(len(prompts))}
    v2, _ = v2_streams(torch, InferenceEngineV2, model_runner, model,
                       prompts)
    first, targets = parting_targets(prompts, v2, v1)
    partings = []
    if first:
        again, v2_rows = v2_streams(torch, InferenceEngineV2, model_runner,
                                    model, prompts, targets)
        if again != v2:
            fail("v1 engine: a rerun of the v2 engine gave other streams")
        rows = {(b, S + p - 1): v1_rows[p][b].cpu() for b, p in first.items()}
        partings = check_partings("v1 engine against the v2 engine", prompts,
                                  first, v2, v1, v2_rows, rows, bound)
    return {"streams_parting": len(partings), "partings": partings,
            "agreement": sum(x == y for b in v1 for x, y in zip(v1[b], v2[b]))
            / (len(prompts) * V1_NEW)}


def teacher_forcing(torch, eng, out, v1_rows, S, bound, label):
    """JAX's check (tests/test_inference.py:79-93) under the near-tie
    rule: each generated token is the argmax of the full forward over
    everything before it, or a near tie there (the forward row's gap
    between its argmax and the token no larger than the max-abs
    difference between that row and the decode row that chose it, which
    stays within ``bound``)."""
    near = []
    for i in range(S, out.shape[1]):
        rows = eng.forward(out[:, :i])[:, -1].float()
        for b in range(out.shape[0]):
            tok, tf = int(out[b, i]), int(rows[b].argmax())
            if tok == tf:
                continue
            gap = float(rows[b, tf] - rows[b, tok])
            diff = float((rows[b] - v1_rows[i - S][b]).abs().max())
            near.append({"stream": b, "position": i - S, "gap": gap,
                         "rows_max_abs_diff": diff})
            if gap > diff or diff > bound:
                fail(f"{label} teacher forcing: stream {b} at {i - S}: "
                     f"forward's argmax {tf} beats the token {tok} by {gap},"
                     f" the rows differ by {diff} (at most {bound})")
    return near


def timed_generate(torch, eng, eng_mod, prompts):
    """One measured ``generate`` of V1_NEW tokens a prompt with the
    sample spy: (streams, rows, line of wall, tokens/s, TTFT, decode
    gap, peak memory)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, times, remove = v1_spy(torch, eng_mod)
    t0 = time.perf_counter()
    try:
        out = eng.generate(prompts, max_new_tokens=V1_NEW)
    finally:
        remove()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if out.shape != (len(prompts), prompts.shape[1] + V1_NEW) or \
            not np.array_equal(out[:, :prompts.shape[1]], prompts):
        fail(f"v1 engine: generate returned {out.shape}")
    gen = len(prompts) * V1_NEW
    return out, rows, {
        "wall_s": wall, "generated_tokens": gen,
        "generated_tokens_per_s": gen / wall,
        "ttft_s": times[0] - t0,
        "decode_token_s": (times[-1] - times[0]) / (len(times) - 1),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def dispatch_since(attn, before):
    """The impl="auto" counts since ``before`` (a ``dispatch_stats()``)."""
    return {k: v - before[k] for k, v in attn.dispatch_stats().items()}


def no_card_losses(attn, label):
    """The dispatch gate of the main-path phases: since the counts were
    last set to 0, impl="auto" sent no CUDA call to the dense path on a
    measured loss (a kernel that loses its bucket on the card is a
    failure to be fixed, not a route). Returns the counts and sets them
    to 0."""
    stats = attn.dispatch_stats()
    attn._reset_dispatch_stats()
    if stats["card_losses"]:
        fail(f"{label}: impl='auto' sent {stats['card_losses']} CUDA calls "
             f"to the dense path on a measured loss ({stats})")
    return stats


def v1_engine_phase(torch, InferenceEngineV2, init_inference, eng_mod,
                    model_runner, attn, fa, qz, wq, model, prompts,
                    row_bound):
    """13b and 13c on phase 3's model (DSTPU_KERNEL_TABLE names 13a's
    table); ``row_bound`` bounds the rows' difference at a near tie.
    Returns (the phase's line, launches by path)."""
    cfg, L = model.config, model.config.num_layers
    prompts = v1_prompts(prompts)
    eng = init_inference(model, dtype=torch.bfloat16, max_seq_len=V1_MAX_SEQ,
                         max_batch=V1_BATCH)
    # 13b forward: the dispatch decision for the bucket, then one forward
    # with the counts read around it
    decision = attn.auto_decision("cuda", torch.bfloat16, V1_FORWARD_SEQ,
                                  cfg.head_dim, True)
    log(f"v1 forward dispatch at S {V1_FORWARD_SEQ}: {decision.source} "
        f"({decision.reason})")
    toks = np.random.default_rng(SEED + 13).integers(
        0, cfg.vocab_size, (1, V1_FORWARD_SEQ)).astype(np.int32)
    eng.forward(toks)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    before = attn.dispatch_stats()
    t0 = time.perf_counter()
    logits = eng.forward(toks)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    fwd_launches = {**fa.LAUNCHES, **fa.VARIANT_LAUNCHES}
    stats = dispatch_since(attn, before)
    if tuple(logits.shape) != (1, V1_FORWARD_SEQ, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"v1 forward: logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    if decision.source != "kernel":
        fail(f"v1 forward: flash lost its bucket on the card "
             f"({decision.reason}): a kernel to fix, not a route to take")
    if not (fwd_launches["flash_fwd"] == L and stats["kernel"] == L
            and fwd_launches["flash_fwd/wgmma"] == L):
        fail(f"v1 forward: decision {decision.source}, flash launches "
             f"{fwd_launches}, dispatch {stats}")
    forward = {"S": V1_FORWARD_SEQ, "decision": decision.source,
               "reason": decision.reason, "ratio": decision.ratio,
               "forward_s": forward_s, "dispatch": stats,
               "launches": fwd_launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del logits
    torch.cuda.empty_cache()

    # 13b generate: a short warm-up, the measured run, the v2 engine's
    # streams, teacher forcing
    eng.generate(prompts, max_new_tokens=2)
    out, rows, gen = timed_generate(torch, eng, eng_mod, prompts)
    gen["dense_cache_bytes"] = (L * V1_BATCH * V1_MAX_SEQ * 2 * cfg.kv_heads
                                * cfg.head_dim * 2)
    gen["vs_v2"] = v1_vs_v2_gate(torch, InferenceEngineV2, model_runner,
                                 model, prompts, out, rows, row_bound)
    tf_launches0 = dict(fa.LAUNCHES)
    before = attn.dispatch_stats()
    gen["teacher_forcing_near_ties"] = teacher_forcing(
        torch, eng, out, rows, prompts.shape[1], row_bound, "v1 engine")
    gen["teacher_forcing_dispatch"] = dispatch_since(attn, before)
    gen["teacher_forcing_flash_fwd"] = (fa.LAUNCHES["flash_fwd"]
                                        - tf_launches0["flash_fwd"])
    del eng, rows
    torch.cuda.empty_cache()

    # 13c int8 weights: a copy of the tree is quantized (the engine frees
    # each copied leaf as its codes exist; phase 7 still needs the
    # model's), B6 at build, 6b at every use
    def copy(node):
        return ({k: copy(v) for k, v in node.items()}
                if isinstance(node, dict) else node.detach().clone())

    tree = copy(model.params())
    qz.reset_launch_counts()
    t0 = time.perf_counter()
    qeng = init_inference(model, params=tree, dtype=torch.bfloat16,
                          max_seq_len=V1_MAX_SEQ, max_batch=V1_BATCH,
                          quantize_weights="int8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del tree
    torch.cuda.empty_cache()
    build_launches = dict(qz.LAUNCHES)
    quantized = sorted(k for k, _ in wq_leaves(wq, qeng.params))
    if build_launches["quantize_blockwise"] != len(quantized) or \
            len(quantized) != 8 or build_launches["dequantize"]:
        fail(f"v1 int8 weights: build launches {build_launches} for "
             f"quantized leaves {quantized}")
    qz.reset_launch_counts()
    qout, qrows, qgen = timed_generate(torch, qeng, eng_mod, prompts)
    use_launches = dict(qz.LAUNCHES)
    forwards = 1 + V1_NEW  # the prefill and one forward a sampled token
    if use_launches["dequantize"] != (7 * L + 1) * forwards or \
            use_launches["quantize_blockwise"] or \
            use_launches["kv_quantize_append"]:
        fail(f"v1 int8 weights: launches {use_launches} over {forwards} "
             f"forwards: dequantize must run 7 x {L} + 1 times a forward")
    S = prompts.shape[1]
    # the int8 engine's streams against its own full forwards, as 13b's
    qgen["teacher_forcing_near_ties"] = teacher_forcing(
        torch, qeng, qout, qrows, S, row_bound, "v1 int8 weights")
    qgen.update({"build_s": build_s, "quantized_leaves": quantized,
                 "weight_bytes": sum(v.nbytes for _, v in
                                     wq_leaves(wq, qeng.params)),
                 "build_launches": build_launches,
                 "generate_launches": use_launches,
                 "agreement_with_bf16_streams": float(
                     (qout[:, S:] == out[:, S:]).mean())})
    del qeng, qrows
    torch.cuda.empty_cache()
    line = {"model": "llama3-8b", "layers": L, "dtype": "bfloat16",
            "prompts": [V1_BATCH, V1_PROMPT], "new_tokens": V1_NEW,
            "max_seq_len": V1_MAX_SEQ, "forward": forward,
            "generate": gen, "int8_weights": qgen}
    paths = {"v1_forward": fwd_launches,
             "v1_int8_weights_build": build_launches,
             "v1_int8_weights_generate": use_launches}
    return line, paths


# -- phase 7: quantized serve --------------------------------------------------


def agreement(out, ref):
    """Share of tokens equal, position by position, to ``ref``'s."""
    same = sum(a == b for u in ref for a, b in zip(out.get(u, []), ref[u]))
    return same / sum(len(v) for v in ref.values())


def model_forwards(st):
    """Forwards an engine ran: one per prefill (kernel or gather) step and
    per decode token step (a burst of K runs K)."""
    return (st["prefill_kernel_steps"] + st["prefill_gather_fallbacks"]
            + st["decode_kernel_steps"])


def quant_run(torch, InferenceEngineV2, pa, qz, model, prompts, ref_out,
              label, on_round=None, profile=False, **engine_kw):
    """One serve run of the phase-3 workload on ``model`` with the
    quantized knobs ``engine_kw``; the launch counts are set to 0 before
    the engine is built (weight quantization is part of the path) and
    read after the last token. Returns (line, streams, engine, profiler)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    qz.reset_launch_counts()
    t0 = time.perf_counter()
    eng = serve_engine(torch, InferenceEngineV2, model, **engine_kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prof = start_profile(torch) if profile else None
    out, wall = serve_workload(torch, eng, prompts, on_round)
    if prof is not None:
        prof.__exit__(None, None, None)
    launches = {**pa.LAUNCHES, **qz.LAUNCHES}
    variants = dict(pa.VARIANT_LAUNCHES)
    if sorted(out) != list(range(8)) or any(len(v) != NEW_TOKENS
                                            for v in out.values()):
        fail(f"quant serve {label}: token counts "
             f"{[len(out.get(u, [])) for u in range(8)]}")
    # a quantized pool reaches the paged kernels as the bf16 scratch
    check_tensor_core(f"quant serve {label}", launches, variants,
                      ("paged_prefill", "paged_decode"))
    st = eng.stats
    cfg = eng.kv_cache.config
    bf16_block = dataclasses.replace(cfg, quant_bits=None,
                                     dtype=torch.bfloat16).bytes_per_block
    pool_bytes = eng.kv_cache.data.nbytes + (
        0 if eng.kv_cache.scales is None else eng.kv_cache.scales.nbytes)
    ttft = sorted(eng.latency["ttft_s"])
    gen = sum(len(v) for v in out.values())
    prompt_tokens = sum(len(p) for p in prompts)
    line = {
        "run": label, **{k: str(v) for k, v in engine_kw.items()},
        "generated_tokens": gen, "wall_s": wall,
        "engine_build_s": build_s,
        "generated_tokens_per_s": gen / wall,
        "total_tokens_per_s": (gen + prompt_tokens) / wall,
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "decode_token_p50_s": float(np.median(eng.latency["decode_token_s"])),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "bytes_per_block": cfg.bytes_per_block,
        "bf16_bytes_per_block": bf16_block,
        "pool_bytes": pool_bytes,
        "bf16_pool_bytes": bf16_block * cfg.num_blocks,
        "pool_vs_bf16": pool_bytes / (bf16_block * cfg.num_blocks),
        "agreement_with_bf16_streams": agreement(out, ref_out),
        "model_forwards": model_forwards(st),
        "prefill_kernel_steps": st["prefill_kernel_steps"],
        "prefill_gather_fallbacks": st["prefill_gather_fallbacks"],
        "decode_kernel_steps": st["decode_kernel_steps"],
        "burst_steps": st["burst_steps"],
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "launches": launches, "variant_launches": variants,
    }
    return line, out, eng, prof


def quant_serve_phase(torch, InferenceEngineV2, pa, qz, wq, model, prompts,
                      ref_out):
    """Llama-3-8B (phase 3's model, built once) served with int8, int4 and
    fp8 KV pools, a second int8 engine (determinism; under the
    profiler), an int8 pool with the host tier and one request paged out
    and back, and last int8 weights over a bf16 pool, which quantizes
    the model in place. Returns (quant serve line, its profile line,
    launches by run)."""
    L = model.config.num_layers
    runs, streams = {}, {}

    def kv_gates(label, line):
        lc, fwd = line["launches"], line["model_forwards"]
        if lc["kv_quantize_append"] != L * fwd or \
                lc["dequantize"] != L * fwd or lc["quantize_blockwise"]:
            fail(f"quant serve {label}: launches {lc} over {fwd} forwards: "
                 f"kv_quantize_append and dequantize must run once per "
                 f"layer per forward ({L * fwd}), quantize_blockwise never")
        if min(lc["paged_decode"], lc["paged_prefill"]) <= 0:
            fail(f"quant serve {label}: a paged kernel never ran: {lc}")

    for label, bits in (("int8", 8), ("int4", 4), ("fp8", "fp8")):
        line, out, eng, _ = quant_run(torch, InferenceEngineV2, pa, qz,
                                      model, prompts, ref_out, label,
                                      kv_quant_bits=bits)
        kv_gates(label, line)
        runs[label], streams[label] = line, out
        del eng
    # determinism: a second int8 engine on the same model, profiled
    line, out, eng, prof = quant_run(torch, InferenceEngineV2, pa, qz,
                                     model, prompts, ref_out,
                                     "int8_rerun_profiled", profile=True,
                                     kv_quant_bits=8)
    if out != streams["int8"]:
        fail("quant serve: a second int8-pool engine on the same model "
             "gave other streams")
    profile = device_breakdown(torch, prof, line["wall_s"],
                               line["generated_tokens"])
    runs["int8_rerun_profiled"] = line
    del eng, prof

    # page-out and warm resume on an int8 pool with the host tier
    paged = {}

    def on_round(eng, out):
        uid, kv = PAGE_OUT_UID, eng.kv_cache
        if "sess" not in paged:
            settled = len(eng.state.seqs) == 8 and all(
                s.pending_prefill == 0 for s in eng.state.seqs.values())
            if len(out.get(uid, [])) < 16 or not settled:
                return False
            if not eng.page_out(uid):
                fail("quant serve page-out: page_out refused")
            paged["sess"] = kv.host_tier.peek_session(uid)
            paged["at_tokens"] = len(out[uid])
            paged["prefill_tokens"] = eng.scheduler.stats["prefill_tokens"]
            write = kv.write_blocks

            def read_back(block_ids, payload, scales=None):
                # the blocks as the restore left them, before any append
                write(block_ids, payload, scales)
                paged["read_back"] = kv.read_blocks_host(block_ids)
            kv.write_blocks = read_back
            return False
        # the round after the page-out paged the session back in
        sess = paged["sess"]
        if eng.stats["paged_in"] != 1 or "read_back" not in paged:
            fail(f"quant serve page-out: not resumed ({eng.stats})")
        payload, scales = paged.pop("read_back")
        paged["restored_bytes_equal"] = bool(
            np.array_equal(payload, sess.payload)
            and np.array_equal(scales, sess.scales))
        del kv.write_blocks
        return True

    line, out, eng, _ = quant_run(torch, InferenceEngineV2, pa, qz, model,
                                  prompts, ref_out, "int8_page_out",
                                  on_round=on_round, kv_quant_bits=8,
                                  host_kv_tier=True)
    kv_gates("int8_page_out", line)
    if "restored_bytes_equal" not in paged:
        fail("quant serve page-out: the request was never paged out")
    paged["paged_out"] = eng.stats["paged_out"]
    paged["paged_in"] = eng.stats["paged_in"]
    paged["warm_resume_tokens"] = eng.stats["warm_resume_tokens"]
    paged["prefill_tokens_after_resume"] = (
        eng.scheduler.stats["prefill_tokens"] - paged.pop("prefill_tokens"))
    sess = paged.pop("sess")
    paged["seen_tokens_at_page_out"] = sess.seen_tokens
    paged["blocks_paged"] = sess.n_blocks
    paged["bytes_paged"] = sess.nbytes
    paged["tokens"] = len(out[PAGE_OUT_UID])
    paged["stream_equals_unpaged_int8"] = (out[PAGE_OUT_UID]
                                           == streams["int8"][PAGE_OUT_UID])
    paged["all_streams_equal_unpaged_int8"] = out == streams["int8"]
    if not (paged["restored_bytes_equal"] and paged["paged_in"] == 1
            and paged["prefill_tokens_after_resume"] == 0
            and paged["tokens"] == NEW_TOKENS):
        fail(f"quant serve page-out: {paged}")
    line["page_out"] = paged
    runs["int8_page_out"] = line
    del eng

    # int8 weights over a bf16 pool: the model's last use
    line, out, eng, _ = quant_run(torch, InferenceEngineV2, pa, qz, model,
                                  prompts, ref_out, "int8_weights",
                                  quantize_weights="int8")
    quantized = sorted(
        k for k, v in wq_leaves(wq, eng.params))
    lc, fwd = line["launches"], line["model_forwards"]
    want_k3 = (7 * L + 1) * fwd
    if (lc["quantize_blockwise"] != len(quantized) or len(quantized) != 8
            or lc["dequantize"] != want_k3 or lc["kv_quantize_append"]):
        fail(f"quant serve int8 weights: launches {lc} over {fwd} forwards "
             f"(quantized leaves {quantized}): quantize_blockwise once per "
             f"leaf (8), dequantize {want_k3}")
    line["quantized_leaves"] = quantized
    line["quantized_fraction"] = wq.quantized_fraction(eng.params)
    line["weight_bytes"] = sum(v.nbytes for _, v in wq_leaves(wq, eng.params))
    runs["int8_weights"] = line
    del eng
    torch.cuda.empty_cache()
    launches = {label: {**r["launches"], **r["variant_launches"]}
                for label, r in runs.items()}
    return {"model": "llama3-8b", "layers": L, "runs": runs}, profile, \
        launches


# -- phase 15: observability ------------------------------------------------


def obs_rows(path):
    return [json.loads(l) for l in open(path).read().splitlines()]


def obs_trace_kernels(trace_path):
    """Launches of each flash wgmma kernel and the names of the ranges in
    a Chrome trace."""
    events = json.load(open(trace_path))["traceEvents"]
    kernels = {k: 0 for k in OBS_FLASH_KERNELS.values()}
    ranges = set()
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "kernel":
            for k in kernels:
                if k in name:
                    kernels[k] += 1
        elif e.get("cat") in ("user_annotation", "gpu_user_annotation"):
            ranges.add(name)
    return kernels, ranges


def obs_train_run(torch, zoo, initialize, fa, enabled, tmp):
    """Phase 15a's 8 steps of 2-layer Llama-3-8B with observability on
    (JSONL, Prometheus, the watchdog, the profiler over OBS_TRACE) or
    off. Steps 1-2 warm up, the window drains, then steps 3-8 run with
    the CUDA sync debug mode warning and are timed together. Returns the
    engine, the losses, the window's wall, its step gaps and its sync
    warnings."""
    import warnings

    model = zoo.get_model("llama3-8b", num_layers=A4_LAYERS,
                          dtype=torch.float32, seed=SEED)
    obs = {"enabled": enabled}
    if enabled:
        obs.update(jsonl_path=os.path.join(tmp, "metrics.jsonl"),
                   prometheus_path=os.path.join(tmp, "metrics.prom"),
                   prometheus_every_steps=1, watchdog={"enabled": True})
        os.environ["DSTPU_TRACE_STEPS"] = f"{OBS_TRACE[0]}:{OBS_TRACE[1]}"
        os.environ["DSTPU_TRACE_DIR"] = os.path.join(tmp, "trace")
    try:
        engine, *_ = initialize(model=model,
                                config=dict(OBS_CONFIG, observability=obs))
    finally:
        os.environ.pop("DSTPU_TRACE_STEPS", None)
        os.environ.pop("DSTPU_TRACE_DIR", None)
    del model
    fixed, _ = fixed_batches(zoo.get_config("llama3-8b").vocab_size)
    it = iter([fixed[i % 2] for i in range(OBS_STEPS * TRAIN_GAS)])
    fa.reset_launch_counts()
    losses = [engine.train_batch(it) for _ in range(OBS_WINDOW[0] - 1)]
    engine.synchronize()
    torch.cuda.synchronize()
    marks = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            for _ in range(OBS_WINDOW[1] - OBS_WINDOW[0] + 1):
                losses.append(engine.train_batch(it))
                marks.append(time.perf_counter())
            engine.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the Python line that called each synchronizing operation (the
    # mode's one-time notice that it is a prototype is not one)
    syncs = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    losses = [float(x) for x in losses]
    return engine, losses, wall, np.diff([t0] + marks), syncs


def obs_train_phase(torch, zoo, initialize, fa, attn, tf):
    """15a: the 2-layer train step with observability on and off: losses
    and fp32 masters ``==``, a step_trace row a step whose MFU the row
    recomputes, the hub's window MFU against the smoke's own within
    OBS_MFU_TOL, the same sync warnings, the Chrome trace of OBS_TRACE
    with the flash wgmma kernels as remat implies and the region ranges;
    device ms by range beside the counted regions; the roofline. 15b: two
    more steps on the on-engine with a small watchdog threshold, the
    second held past it by a post-step hook: one report with stacks and
    the device memory section, train.stalls 1, a flight dump with the
    step's entry and the previous step's drain. Returns (the phase's
    line, flash launches of the on and off runs)."""
    from deepspeed_tpu_torch.observability import (attribute_step,
                                                   device_ms_by_region,
                                                   get_hub, reset_hub)
    from deepspeed_tpu_torch.runtime.optimizer import leaves

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dstpu_obs_")
    flight_dir = os.path.join(tmp, "flight")
    os.environ["DSTPU_FLIGHT_DIR"] = flight_dir
    L, gas, steps = A4_LAYERS, TRAIN_GAS, OBS_STEPS
    want = {"flash_fwd": 2 * L * gas, "flash_bwd_dkdv": L * gas,
            "flash_bwd_dq": L * gas}
    try:
        torch.cuda.empty_cache()
        engine, losses_on, wall_on, gaps_on, syncs_on = obs_train_run(
            torch, zoo, initialize, fa, True, tmp)
        launches = {"on": {**fa.LAUNCHES, **fa.VARIANT_LAUNCHES}}
        got = {k: fa.LAUNCHES[k] for k in want}
        if got != {k: v * steps for k, v in want.items()}:
            fail(f"observability on: flash launches {got}, remat implies "
                 f"{ {k: v * steps for k, v in want.items()} }")
        check_tensor_core("observability on", fa.LAUNCHES,
                          fa.VARIANT_LAUNCHES, tuple(want))
        masters_on = {p: m.detach().to("cpu", copy=True)
                      for p, m in leaves(engine.opt_state.master)}
        hub = engine.hub
        rows = [r for r in obs_rows(os.path.join(tmp, "metrics.jsonl"))
                if r["kind"] == "step_trace"]
        if [r["step"] for r in rows] != list(range(1, steps + 1)):
            fail(f"observability: step_trace rows of steps "
                 f"{[r['step'] for r in rows]}, want 1..{steps}")
        fpt = engine.model.flops_per_token()
        cfg = engine.model_config
        tokens = TRAIN_MICRO * gas * TRAIN_SEQ
        for r in rows:
            again = (r["tokens_per_sec_per_chip"] * r["flops_per_token"]
                     / (r["peak_tflops"] * 1e12))
            if (r["tokens"] != tokens or r["flops_per_token"] != fpt
                    or r["peak_tflops"] != PEAK_FLOPS["bfloat16"] / 1e12
                    or abs(r["mfu"] - again) > 1e-12 * again):
                fail(f"observability: step row {r['step']} {r}")
        n_win = OBS_WINDOW[1] - OBS_WINDOW[0] + 1
        window_mfu = hub.window_mfu(last_n=n_win)
        smoke_mfu = n_win * tokens / wall_on * fpt / PEAK_FLOPS["bfloat16"]
        mfu_rel = abs(window_mfu - smoke_mfu) / smoke_mfu
        if mfu_rel > OBS_MFU_TOL:
            fail(f"observability: window MFU {window_mfu} vs the smoke's "
                 f"{smoke_mfu} (rel {mfu_rel})")
        flops_2048 = (6 * cfg.num_params()
                      + 12 * L * cfg.hidden_size * TRAIN_SEQ)
        # the dispatch export: one kernel_dispatch event per memoised
        # decision (the engine's set_kernel_config cleared the memo)
        events = obs_rows(os.path.join(tmp, "metrics.jsonl"))
        dispatch = [e for e in events if e["kind"] == "kernel_dispatch"]
        gauges = hub.snapshot()["gauges"]
        if (len(dispatch) != len(attn._DECISIONS) or not dispatch
                or gauges.get("kernel.attention.pallas") != 1.0):
            fail(f"observability: {len(dispatch)} kernel_dispatch events "
                 f"for {len(attn._DECISIONS)} decisions, gauge "
                 f"{gauges.get('kernel.attention.pallas')}")
        # the profiler window: whole steps, the flash kernels by name
        cap = engine._trace_capture
        if cap is None or not cap.done or not cap.trace_path:
            fail("observability: the DSTPU_TRACE_STEPS capture did not run")
        n_tr = OBS_TRACE[1] - OBS_TRACE[0] + 1
        traced, ranges = obs_trace_kernels(cap.trace_path)
        want_tr = {OBS_FLASH_KERNELS[k]: v * n_tr for k, v in want.items()}
        if traced != want_tr:
            fail(f"observability: the trace holds flash kernels {traced}, "
                 f"remat implies {want_tr}")
        need = {*OBS_RANGES, *(f"train_step#{s}" for s in
                               range(OBS_TRACE[0], OBS_TRACE[1] + 1))}
        if not need <= ranges:
            fail(f"observability: ranges missing from the trace: "
                 f"{sorted(need - ranges)}")
        by_range = device_ms_by_region(cap.profiler, family=kernel_family)
        busy = sum(by_range["ms"].values())
        regions = attribute_step(
            dataclasses.replace(cfg, dtype=torch.bfloat16), TRAIN_MICRO,
            TRAIN_SEQ)
        per_step = {k: v / n_tr for k, v in by_range["ms"].items()}
        row_of = {"attn": "attention", "mlp": "mlp",
                  "vocab_head": "vocab_head", "optimizer": "optimizer"}
        attribution = {}
        for r in regions:
            ms = per_step.get(row_of.get(r.region, ""), 0.0)
            flops = r.flops * (gas if r.region != "optimizer" else 1)
            attribution[r.region] = {
                "gflops_per_step": flops / 1e9,
                "gb_per_step": r.bytes_accessed
                * (gas if r.region != "optimizer" else 1) / 1e9,
                "range_device_ms_per_step": ms,
                "achieved_tflops": (flops / (ms / 1e3) / 1e12
                                    if ms > 0 else None), "note": r.note}
        roof = engine.roofline(step_seconds=wall_on / n_win)
        rows_win = rows[OBS_WINDOW[0] - 1:]
        line = {
            "model": "llama3-8b", "layers": f"{L} of 32",
            "micro": TRAIN_MICRO, "gas": gas, "seq": TRAIN_SEQ,
            "pipeline_depth": OBS_CONFIG["performance"]["pipeline_depth"],
            "losses": losses_on,
            "step_ms_p50_on": float(np.median(gaps_on)) * 1e3,
            "row_wall_ms": [r["wall_ms"] for r in rows],
            "host_gap_ms": [r["host_gap_ms"] for r in rows],
            "window_mfu": window_mfu, "smoke_mfu": smoke_mfu,
            "mfu_rel_diff": mfu_rel, "flops_per_token": fpt,
            "flops_per_token_s2048": flops_2048,
            "mfu_s2048": smoke_mfu * flops_2048 / fpt,
            "sync_warnings_on": len(syncs_on),
            "sync_sites": {site: syncs_on.count(site)
                           for site in sorted(set(syncs_on))},
            "dispatch_events": len(dispatch),
            "trace": {"steps": list(OBS_TRACE), "flash_kernels": traced,
                      "device_ms_by_range": by_range["ms"],
                      "kernels_by_range": by_range["kernels"],
                      "device_ms_by_range_and_family": by_range["by_family"],
                      "device_busy_ms": busy},
            "attribution": attribution, "roofline": roof,
            "device_mem": rows_win[-1].get("device_mem"),
            "compile_events": sum(r["compile_events"] for r in rows),
        }
        # 15b: the watchdog drill
        wd = engine.watchdog
        stalls_before = hub.snapshot()["counters"].get("train.stalls", 0.0)
        wd.factor, wd.min_seconds = OBS_WD_FACTOR, OBS_WD_MIN_S
        threshold = wd.threshold()
        calls = []

        def hang(_engine):
            calls.append(1)
            if len(calls) == 2:
                time.sleep(3 * threshold + 0.5)

        engine.register_post_step_hook(hang)
        t15b = time.perf_counter()
        it = iter(fixed_batches(cfg.vocab_size)[0] * gas)
        for _ in range(2):
            engine.train_batch(it)
        drill_s = time.perf_counter() - t15b
        stalls = hub.snapshot()["counters"].get("train.stalls", 0.0) \
            - stalls_before
        reports = [e for e in obs_rows(os.path.join(tmp, "metrics.jsonl"))
                   if e["kind"] == "stall_report"]
        dump_path = os.path.join(flight_dir, "flight_rank0_watchdog.json")
        dump = (json.load(open(dump_path)) if os.path.exists(dump_path)
                else {"events": []})
        kinds = [(e["kind"], e.get("step")) for e in dump["events"]]
        stalled = steps + 2
        if (wd.stalls != 1 or stalls != 1.0 or len(reports) != 1
                or "python stacks:" not in reports[0]["report"]
                or "device memory: {" not in reports[0]["report"]
                or ("step_entry", stalled) not in kinds
                or ("step_drain", stalled - 1) not in kinds):
            fail(f"watchdog drill: {wd.stalls} reports fired, train.stalls "
                 f"+{stalls}, {len(reports)} in the JSONL, dump events "
                 f"{kinds[-6:]}")
        line["watchdog_drill"] = {
            "threshold_s": threshold, "stalls": wd.stalls,
            "drill_s": drill_s, "dump_events": len(dump["events"]),
            "report_lines": reports[0]["report"].count("\n") + 1}
        wd.stop()
        del engine, hub
        reset_hub()  # the temporary JSONL and Prometheus sinks go
        torch.cuda.empty_cache()
        # the same 8 steps with observability off
        engine, losses_off, wall_off, gaps_off, syncs_off = obs_train_run(
            torch, zoo, initialize, fa, False, tmp)
        launches["off"] = {**fa.LAUNCHES, **fa.VARIANT_LAUNCHES}
        if engine.hub is not None or engine.flight is not None:
            fail("observability off: the engine built a hub or a recorder")
        if losses_off != losses_on:
            fail(f"observability: losses on {losses_on} != off "
                 f"{losses_off}")
        bad = [p for p, m in leaves(engine.opt_state.master)
               if not torch.equal(m.detach().cpu(), masters_on[p])]
        if bad:
            fail(f"observability: fp32 masters differ on and off: {bad}")
        if len(syncs_off) != len(syncs_on):
            fail(f"observability: {len(syncs_on)} sync warnings on, "
                 f"{len(syncs_off)} off: {syncs_on[:3]}")
        line.update(step_ms_p50_off=float(np.median(gaps_off)) * 1e3,
                    sync_warnings_off=len(syncs_off), wall_on_s=wall_on,
                    wall_off_s=wall_off, masters_equal=True,
                    losses_equal=True)
        del engine, masters_on
        torch.cuda.empty_cache()
    finally:
        os.environ.pop("DSTPU_FLIGHT_DIR", None)
        shutil.rmtree(tmp, ignore_errors=True)
    line["wall_s"] = time.perf_counter() - t_start
    return line, launches


class HostClock:
    """Stands in for one of the serve's observability objects (the hub,
    a histogram, the tracer, the flight recorder) and sums the host
    seconds and the count of its method calls into ``acc``."""

    def __init__(self, inner, acc):
        self._inner, self._acc = inner, acc

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr
        acc = self._acc

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return attr(*args, **kwargs)
            finally:
                acc[0] += time.perf_counter() - t0
                acc[1] += 1

        return timed


class NoObservability:
    """The serve's observability objects switched off: every call does
    nothing and the tracer reads as disabled."""

    enabled = False

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


OBS_SERVE_ATTRS = ("_hub", "_ttft_hist", "_decode_hist", "_step_hist",
                   "_admission_hist", "_spec_hist", "tracer", "_flight")


def swap_serve_observability(eng, wrap):
    """Put ``wrap(obj)`` in place of each of the serve's observability
    objects: the engine's, the scheduler's tracer, the prefix cache's
    hub."""
    for name in OBS_SERVE_ATTRS:
        setattr(eng, name, wrap(getattr(eng, name)))
    eng.scheduler.tracer = eng.tracer
    cache = eng.kv_cache.prefix_cache
    if cache is not None:
        cache._hub = wrap(cache._hub)


# 15c's serves after the gated one, from fresh engines
OBS_SERVE_AB = ("off", "on", "on", "off")
OBS_SNAPSHOT_KEYS = {
    "ttft", "decode_token_latency", "step_latency", "admission_wait",
    "queue_depth", "queue_wait_depth", "pending_prefill_tokens",
    "kv_free_blocks", "kv_quant_bits", "batch_seq_occupancy",
    "batch_token_occupancy", "scheduler", "stats", "request_trace",
    "burst_efficiency", "prefix_cache"}


def obs_serve_phase(torch, InferenceEngineV2, pa, model, prompts, ref_out,
                    phase3_wall):
    """15c: phase 3's 8 requests on its model with every request traced
    (sample rate 1.0) and the engine's series labelled: streams ``==``
    phase 3's, every trace's phases close, the labelled TTFT histogram
    counts 8 and the emitted tokens 512, ``snapshot()`` has JAX's keys
    (less ``handoff_wire``), the dispatch gauges are on the hub. The
    host seconds inside the observability objects are summed over that
    serve; then OBS_SERVE_AB serves it again from fresh engines with
    observability off and on, each stream ``==`` phase 3's. Returns (the
    phase's line, paged launches)."""
    from deepspeed_tpu_torch.observability import (check_phase_closure,
                                                   get_hub,
                                                   slo_attribution,
                                                   slo_attribution_markdown)

    t_start = time.perf_counter()
    label = {"phase": "15c"}
    eng = serve_engine(torch, InferenceEngineV2, model,
                       request_trace={"sample_rate": 1.0},
                       metric_labels=label)
    # the host seconds spent in the hub, the histograms, the tracer and
    # the flight recorder, as the serve calls them
    acc = [0.0, 0]
    swap_serve_observability(eng, lambda obj: HostClock(obj, acc))
    pa.reset_launch_counts()
    out, wall = serve_workload(torch, eng, prompts)
    obs_s, obs_calls = acc
    launches = {**pa.LAUNCHES, **pa.VARIANT_LAUNCHES}
    eng._hub = eng._hub._inner  # snapshot() and request_traces() below
    eng.tracer = eng.scheduler.tracer = eng.tracer._inner
    if out != ref_out:
        fail("observability serve: streams differ from phase 3's")
    traces = eng.request_traces()
    try:
        closure = check_phase_closure(traces)
    except AssertionError as e:
        fail(f"observability serve: a trace's phases do not close: {e}")
    snap = get_hub().snapshot()
    ttft = snap["histograms"].get('serve.ttft_seconds{phase="15c"}', {})
    emitted = snap["counters"].get('serve.tokens_emitted{phase="15c"}')
    keys = set(eng.snapshot())
    if (len(traces) != 8 or closure["checked"] != 8
            or ttft.get("count") != 8 or emitted != 8 * NEW_TOKENS
            or keys != OBS_SNAPSHOT_KEYS
            or "kernel.attention.pallas" not in snap["gauges"]
            or "kernel.flash_fallback_ratio" not in snap["gauges"]):
        fail(f"observability serve: {len(traces)} traces ({closure}), "
             f"ttft count {ttft.get('count')}, emitted {emitted}, snapshot "
             f"keys {sorted(keys ^ OBS_SNAPSHOT_KEYS)}, gauges "
             f"{sorted(k for k in snap['gauges'] if k.startswith('kernel'))}")
    report = slo_attribution(traces)
    hists = {name: {"p50": h["p50"], "p99": h["p99"], "count": h["count"]}
             for name, h in snap["histograms"].items()
             if name.endswith('{phase="15c"}')}
    steps = snap["histograms"]['serve.step_seconds{phase="15c"}']["count"]
    del eng
    # the same serve with observability off and on, alternated, from
    # fresh engines: the walls, the streams == phase 3's
    ab = {"off": [], "on": []}
    for i, mode in enumerate(OBS_SERVE_AB):
        eng = serve_engine(torch, InferenceEngineV2, model,
                           request_trace={"sample_rate": 1.0},
                           metric_labels={"phase": f"15c-{i}"})
        if mode == "off":
            swap_serve_observability(eng, lambda obj: NoObservability())
        got, ab_wall = serve_workload(torch, eng, prompts)
        del eng
        if got != ref_out:
            fail(f"observability serve, {mode}: streams differ from "
                 f"phase 3's")
        ab[mode].append(ab_wall)
    line = {"wall_s": wall, "phase3_wall_s": phase3_wall,
            "traces": len(traces), "closure": closure,
            "histograms": hists, "slo_attribution": {
                k: report[k] for k in ("phase_seconds", "ttft", "e2e")},
            "slo_markdown": slo_attribution_markdown(report),
            "snapshot_keys": sorted(keys), "launches": launches,
            "host_observability": {
                "seconds": obs_s, "calls": obs_calls, "serve_steps": steps,
                "us_per_step": obs_s / steps * 1e6,
                "share_of_wall": obs_s / wall},
            "walls_off_on": ab,
            "on_minus_off_ms_per_step": (np.mean(ab["on"])
                                         - np.mean(ab["off"])) / steps * 1e3,
            "phase_s": time.perf_counter() - t_start}
    torch.cuda.empty_cache()
    return line, launches


def wq_leaves(wq, params, path=""):
    """(path, QuantizedTensor) for every quantized leaf of ``params``."""
    for k, v in params.items():
        p = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            yield from wq_leaves(wq, v, p)
        elif isinstance(v, wq.QuantizedTensor):
            yield p, v


def main():
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device (torch.cuda.is_available() is False)")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch import (DeepSpeedDataLoader, RepeatingLoader,
                                     initialize)
    from deepspeed_tpu_torch.inference import (InferenceEngineV2,
                                              init_inference, model_runner)
    from deepspeed_tpu_torch.inference import engine as v1_engine
    from deepspeed_tpu_torch.inference import weight_quant as wq
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.ops import attention as attn
    from deepspeed_tpu_torch.ops import blocksparse_attention as bs
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import grouped_matmul as gm
    from deepspeed_tpu_torch.ops import kernel_table
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quantization as qz
    from deepspeed_tpu_torch.ops.native import builder as native_builder
    from deepspeed_tpu_torch.parallel import moe
    from deepspeed_tpu_torch.resilience import validate_manifest
    from deepspeed_tpu_torch.runtime import offload as off_mod
    from deepspeed_tpu_torch.tools import kernel_bench as kb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_identity()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    t_start = t0 = time.perf_counter()
    secs = build.build()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s)")
    ptxas = {src: ptxas_report(build.build_log(src))
             for src in build.SOURCES}
    for src, lines in ptxas.items():
        for line in lines:
            log(f"ptxas {src}: {line}")

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
    # 2c. grouped matmuls
    gmm = {(name, case): check_gmm(torch, gm, timer, dtype, case)
           for case in GMM_CASES
           for name, dtype in (("float32", torch.float32),
                               ("bfloat16", torch.bfloat16))}
    for case in ("train_wi", "train_wo", "decode"):
        for kern in ("gmm", "gmm_transposed", "tgmm"):
            r = gmm[("bfloat16", case)][kern]
            if "ms" in r:
                log(f"gmm {case} {kern}: {r['variant']} {r['ms']:.3f} ms "
                    f"({r['tflops']:.0f} TFLOP/s), bound {r['bound_ms']:.3f}"
                    f" ms ({r['bound_by']}), torch._grouped_mm "
                    f"{r['library_ms']} ms, first version (simt) "
                    f"{r['first_version_ms']:.2f} ms")
    for kern in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        r = flash[("bfloat16", "smoke")][kern]
        log(f"{kern} smoke: {r['variant']} {r['ms']:.3f} ms "
            f"({r['tflops']:.0f} TFLOP/s), bound {r['bound_ms']:.4f} ms, "
            f"SDPA {r['library_ms']:.3f} ms, first version (simt) "
            f"{r['first_version_ms']:.3f} ms, max row rel err "
            f"{r.get('max_row_rel_err')}")
    torch.cuda.empty_cache()
    # 2d. quantize kernels, bit for bit against their plain versions
    quant = {(name, block, bits): check_quantize(torch, qz, timer, dtype,
                                                 block, bits)
             for name, dtype in (("bfloat16", torch.bfloat16),
                                 ("float32", torch.float32))
             for block in (128, 256) for bits in (8, 4)}
    kv_app = {(bits, ntok): check_kv_append(torch, qz, timer, bits, ntok,
                                            torch.bfloat16)
              for bits in (8, 4, "fp8") for ntok in (16, 256)}
    kv_app[(8, 16, "float32")] = check_kv_append(torch, qz, timer, 8, 16,
                                                 torch.float32)
    deq = {case: check_dequant(torch, qz, wq, timer, case)
           for case in (8, 4, "fp8", "weight")}
    torch.cuda.empty_cache()
    # 2e. block-sparse forward against its plain version and the masked
    # form
    sparse = {}
    for case in BS_CASES:
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            sparse[(name, case)] = check_blocksparse(torch, bs, attn, timer,
                                                     dtype, case)
            torch.cuda.empty_cache()
    log("blocksparse: " + ", ".join(
        f"{c} density {sparse[('bfloat16', c)]['pair_density']:.3f}"
        for c in BS_CASES))
    for case, r in [("smoke", dec["bfloat16"]),
                    *dec["bfloat16"]["long_context"].items()]:
        log(f"paged_decode {case}: {r['variant']} {r['ms']:.4f} ms "
            f"({r['gb_per_s']:.0f} GB/s, span {r['span_pages']} pages), "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), SDPA "
            f"{r['library_ms']:.4f} ms, first version (simt) "
            f"{r['first_version_ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, "
            f"max-abs {r['max_abs_err']:.2e}, max row rel err "
            f"{r['max_row_rel_err']:.2e}")
    for tq in pre:
        r = pre[tq]["bfloat16"]
        log(f"paged_prefill tq={tq}: {r['variant']} {r['ms']:.4f} ms "
            f"({r['gb_per_s']:.0f} GB/s), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), SDPA {r['library_ms']:.4f} ms, first "
            f"version (simt) {r['first_version_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.2f} ms")
    for case in BS_TIMED:
        r = sparse[("bfloat16", case)]
        log(f"blocksparse_fwd {case}: {r['variant']} {r['ms']:.3f} ms "
            f"({r['tflops']:.0f} TFLOP/s), bound {r['bound_ms']:.4f} ms, "
            f"SDPA with a mask {r['library_ms']:.3f} ms, first version "
            f"(simt) {r['first_version_ms']:.3f} ms, plain "
            f"{r['plain_ms']:.2f} ms, max row rel err "
            f"{r['max_row_rel_err']:.2e}")
    del timer
    torch.cuda.empty_cache()
    log("kernels agree with their plain versions")
    attn._reset_dispatch_stats()  # the main paths' dispatch from here

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
    serve_variants = dict(pa.VARIANT_LAUNCHES)
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
    check_tensor_core("serve", launches, serve_variants,
                      ("paged_prefill", "paged_decode"))
    agree = check_paths_agree(torch, model_runner, model, prompts)
    ref_prompts = prompts
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
        "launches": launches, "variant_launches": serve_variants,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "prefill_vs_gather": agree,
        "deterministic_rerun": True,
    }
    # a third run of the same workload under torch.profiler, on the same
    # model: where the device time goes and how long the device sits idle
    del eng
    torch.cuda.empty_cache()
    prof_out, prof_wall, prof = serve_once(torch, zoo, InferenceEngineV2,
                                           profile=True, model=model)
    if prof_out != ref_out:
        fail("serve: the profiled run gave other streams")
    profile = device_breakdown(torch, prof, prof_wall, gen)
    del prof

    # 8a. the block-sparse forward at full depth on the same model, before
    # phase 7's weight run quantizes it
    torch.cuda.empty_cache()
    sparse_fwd, sparse_fwd_profile, sparse_fwd_launches = \
        sparse_forward_phase(torch, tf, attn, bs, model)
    torch.cuda.empty_cache()
    log(f"sparse forward: {sparse_fwd['forward_ms_p50']:.1f} ms at S "
        f"{SPARSE_SEQ}")

    # 12a-c. speculative serving on the same model, before phase 7's
    # weight run quantizes it: prompt lookup, the repetitive set, the
    # draft model, and B5 timed at the verify shape
    t12 = time.perf_counter()
    gate = PartingGate(torch, InferenceEngineV2, model_runner, model,
                       ref_out)
    spec_serve, spec_paths = spec_serve_phase(
        torch, InferenceEngineV2, pa, model_runner, model, ref_prompts, gate)
    draft, draft_paths = draft_model_phase(
        torch, InferenceEngineV2, pa, fa, attn, model_runner, model,
        ref_prompts, gate)
    # one recorded rerun of phase 3's serve for every queued check
    gate.check_pending({})
    timer = Timer(torch)
    pre_verify = check_prefill_verify(torch, pa, timer)
    del timer
    torch.cuda.empty_cache()
    phase12_serve_s = time.perf_counter() - t12
    log("spec serve: " + ", ".join(
        f"{k} {v['generated_tokens_per_s']:.0f} tok/s "
        f"({v['accepted_per_verify_round']:.2f} accepted a round)"
        for k, v in {**spec_serve, **draft["runs"]}.items())
        + f"; B5 at the verify shape {pre_verify['ms']:.4f} ms; "
        f"{phase12_serve_s:.0f} s")

    # 13. the kernel bench into a scratch table, then the v1 engine over
    # the same model with that table, before phase 7's weight run
    # quantizes it
    dispatch = {"3, 8a, 12a-c": no_card_losses(attn, "phases 3, 8a, 12a-c")}
    t13 = time.perf_counter()
    table_dir = tempfile.mkdtemp(prefix="dstpu_kernel_table_")
    table_path = os.path.join(table_dir, "kernel_table.json")
    bench = kernel_bench_phase(torch, kb, table_path)
    attn._reset_dispatch_stats()  # 13a's probe is not a main path
    t13b = time.perf_counter()
    os.environ["DSTPU_KERNEL_TABLE"] = table_path
    kernel_table.invalidate_cache()
    try:
        v1, v1_paths = v1_engine_phase(
            torch, InferenceEngineV2, init_inference, v1_engine,
            model_runner, attn, fa, qz, wq, model, ref_prompts,
            V1_ROW_DIFF_FACTOR * agree["max_abs_diff"])
    finally:
        del os.environ["DSTPU_KERNEL_TABLE"]
        kernel_table.invalidate_cache()
        shutil.rmtree(table_dir, ignore_errors=True)
    dispatch["13b-c"] = no_card_losses(attn, "phase 13b-c")
    phase13_s = time.perf_counter() - t13
    g = v1["generate"]
    log(f"v1 engine: forward {v1['forward']['forward_s'] * 1e3:.1f} ms "
        f"({v1['forward']['decision']}); generate {g['wall_s']:.2f} s, "
        f"{g['generated_tokens_per_s']:.0f} tok/s, TTFT "
        f"{g['ttft_s'] * 1e3:.1f} ms, decode gap "
        f"{g['decode_token_s'] * 1e3:.1f} ms, peak {g['peak_mem_gb']:.1f} "
        f"GB, dense cache {g['dense_cache_bytes'] / 1e9:.2f} GB, "
        f"{g['vs_v2']['streams_parting']} streams part from the v2 "
        f"engine's; int8 weights {v1['int8_weights']['wall_s']:.2f} s, "
        f"agreement {v1['int8_weights']['agreement_with_bf16_streams']:.3f}"
        f"; kernel bench {t13b - t13:.0f} s; phase 13 took "
        f"{phase13_s:.0f} s")

    # 15c. the same serve with every request traced, before phase 7's
    # weight run quantizes the model
    obs_serve, obs_serve_launches = obs_serve_phase(
        torch, InferenceEngineV2, pa, model, ref_prompts, ref_out,
        serve["wall_s"])
    log(f"observability serve: {obs_serve['wall_s']:.2f} s against phase "
        f"3's {serve['wall_s']:.2f} s; {obs_serve['traces']} traces close; "
        f"{obs_serve['host_observability']['us_per_step']:.0f} us of "
        f"observability host time a serve step; off / on walls "
        f"{obs_serve['walls_off_on']}; phase 15c took "
        f"{obs_serve['phase_s']:.0f} s\n"
        + obs_serve["slo_markdown"])

    # 7. quantized serve on the same model (its last use: the int8
    # weight run quantizes it in place)
    quant_serve, quant_profile, quant_launches = quant_serve_phase(
        torch, InferenceEngineV2, pa, qz, wq, model, ref_prompts, ref_out)
    del model
    torch.cuda.empty_cache()
    log("quant serve: " + ", ".join(
        f"{k} {v['wall_s']:.2f} s" for k, v in quant_serve["runs"].items()))

    # 4. train: the serve model is gone; the launch counts are read
    # around the measured steps
    train, train_profile, train_launches = train_phase(torch, zoo,
                                                       initialize, fa, tf)
    log(f"train: {train['step_ms_p50']:.1f} ms per step")

    # 9. checkpoint: save, load and a bit-identical resume; phase 4's
    # engine is gone
    ckpt, ckpt_launches = checkpoint_phase(
        torch, zoo, initialize, fa, DeepSpeedDataLoader, RepeatingLoader,
        validate_manifest)
    log(f"checkpoint: {ckpt['state_gb']:.1f} GB, save {ckpt['save_s']:.1f} "
        f"s, load {ckpt['load_s']:.1f} s (validate "
        f"{ckpt['load_validate_s']:.1f} s), async blocking "
        f"{ckpt['async_blocking_s']:.1f} s + commit "
        f"{ckpt['async_commit_s']:.1f} s; resumed bit-identical")

    # 12d. A4 on the card: the pipelined loop, a (loss_fn, params) model
    # and a client optimizer at 2 layers; phase 9's engines are
    # gone
    t0 = time.perf_counter()
    a4, a4_launches = a4_phase(torch, zoo, initialize, fa, tf)
    phase12_s = phase12_serve_s + time.perf_counter() - t0
    log(f"a4: blocking {a4['blocking']['step_ms_p50']:.1f} ms, pipelined "
        f"{a4['pipelined']['step_ms_p50']:.1f} ms a step, losses equal; "
        f"phase 12 took {phase12_s:.0f} s")

    # 14. ZeRO stages 0-3 on a one-rank NCCL group, at 12d's depth; the
    # group is gone before phase 10 (each stage gates its own dispatch)
    dispatch["7, 4, 9, 12d"] = no_card_losses(attn, "phases 7, 4, 9, 12d")
    zero, zero_launches = zero_phase(torch, zoo, initialize, fa, tf, attn)
    log(f"zero: stages {list(zero['stages'])} equal stage 0 bit for bit, "
        f"collectives as planned; phase 14 took {zero['wall_s']:.0f} s")

    # 15a-b. observability on the 2-layer step, on and off, and the
    # watchdog drill; phase 14's group is gone
    obs, obs_launches = obs_train_phase(torch, zoo, initialize, fa, attn, tf)
    log(f"observability: step p50 {obs['step_ms_p50_on']:.1f} ms on, "
        f"{obs['step_ms_p50_off']:.1f} off; window MFU "
        f"{obs['window_mfu']:.4f} vs the smoke's {obs['smoke_mfu']:.4f} "
        f"(at S 2048 {obs['mfu_s2048']:.4f}); sync warnings "
        f"{obs['sync_warnings_on']} / {obs['sync_warnings_off']}; device ms "
        f"by range {json.dumps(obs['trace']['device_ms_by_range'])}; "
        f"phase 15a-b took {obs['wall_s']:.0f} s")

    # 10. offload: full depth with the optimizer on the host, then the
    # tiers' parity and a checkpoint through the AIO writer; phase 9's
    # engines are gone
    t0 = time.perf_counter()
    offload, offload_profile, offload_launches = offload_full_depth(
        torch, zoo, initialize, fa, native_builder, off_mod)
    offload_parity, offload_ckpt, offload_ckpt_launches = offload_small(
        torch, zoo, initialize, fa, ckpt)
    offload_wall = time.perf_counter() - t0
    split = offload["step_split_p50"]
    log(f"offload: {offload['layers']} layers, step "
        f"{offload['step_ms_p50']:.0f} ms (fwd+bwd {split['fwd_bwd_s']:.2f} "
        f"s, host optimizer {split['host_optimizer_s']:.2f} s), cpu == "
        f"nvme, Fast save {offload_ckpt['save_s']:.1f} s; phase 10 took "
        f"{offload_wall:.0f} s")

    # 11. ZenFlow at full depth, the blocking step beside it, its
    # checkpoint, and the optimizer sweep; phase 10's engines are gone
    t0 = time.perf_counter()
    zenflow, zenflow_profile, zenflow_launches, zf_layers = \
        zenflow_full_depth(torch, zoo, initialize, fa, native_builder,
                           off_mod)
    zenflow_block, zenflow_block_launches = zenflow_blocking(
        torch, zoo, initialize, fa, zf_layers)
    zenflow_ckpt, zenflow_ckpt_launches = zenflow_checkpoint(
        torch, zoo, initialize, fa)
    sweep = optimizer_sweep(torch, zoo, initialize)
    zenflow_wall = time.perf_counter() - t0
    log(f"zenflow: {zenflow['layers']} layers, step mean "
        f"{zenflow['step_s_mean']:.3f} s "
        f"({zenflow['step_s_mean_by_kind']}) against the blocking "
        f"{zenflow_block['step_s_mean']:.3f} s; resumed bit-identical; "
        f"sweep {[(k, v['losses'][-1]) for k, v in sweep['optimizers'].items()]}"
        f"; phase 11 took {zenflow_wall:.0f} s")

    # 8b. the engine with a sparse_attention block: the micro-step loop
    # over the dataloader, then eval; phase 4's engine is gone
    sparse_train, sparse_launches = sparse_train_phase(
        torch, zoo, initialize, bs, attn)
    log(f"sparse train: {sparse_train['step_ms_p50']:.1f} ms per step, "
        f"eval {sparse_train['eval_ms']:.1f} ms")

    # 5. MoE serve, 6. MoE train: the Llama models are gone
    moe_serve, moe_serve_profile, moe_serve_launches = moe_serve_phase(
        torch, zoo, InferenceEngineV2, pa, gm, moe, tf)
    log(f"moe serve: {moe_serve['wall_s']:.2f} s")
    moe_train, moe_train_profile, moe_train_launches = moe_train_phase(
        torch, zoo, initialize, fa, gm)
    log(f"moe train: {moe_train['step_ms_p50']:.1f} ms per step; "
        f"{time.perf_counter() - t_start:.0f} s since the build began")
    dispatch["10, 11, 8b, 5, 6"] = no_card_losses(
        attn, "phases 10, 11, 8b, 5, 6")
    dispatch["14"] = {stage: line["dispatch"]
                      for stage, line in zero["stages"].items()}
    log(f"impl='auto' dispatch by phases, no measured loss on the card: "
        f"{json.dumps(dispatch)}")

    def entry(name, replaces, res, other, kernels, paths):
        b = res["bfloat16"]
        variant = b["variant"]
        return {"name": name, "route": "cuda",
                "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
                "kernel": kernels[variant], "variant": variant,
                "kernels": kernels,
                "replaces": replaces, "launches": launches[name],
                "launches_by_path": {path: lc[name]
                                     for path, lc in paths.items()},
                "kernel_bench_launches": bench["launched"].get(name, 0),
                "variant_launches_by_path": {
                    path: {k: v for k, v in lc.items()
                           if k.startswith(name + "/")}
                    for path, lc in paths.items()},
                "max_abs_err": b["max_abs_err"],
                "max_abs_err_fp32": res["float32"]["max_abs_err"],
                "ms": b["ms"], "gb_per_s": b["gb_per_s"],
                **({"max_row_rel_err": b["max_row_rel_err"]}
                   if "max_row_rel_err" in b else {}),
                "first_version_ms": b["first_version_ms"],
                "plain_ms": b["plain_ms"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": b["library_ms"],
                "library_call": "scaled_dot_product_attention on K/V "
                                "gathered dense beforehand (heads expanded, "
                                "boolean mask)",
                "dtype": "bfloat16", "shape": b["shape"],
                "ptxas": {v: kernel_lines(ptxas["paged_attention"], k)
                          for v, k in kernels.items()},
                "other": other}

    paged_paths = {"serve": {**launches, **serve_variants},
                   "observability_serve": obs_serve_launches,
                   **spec_paths, **draft_paths,
                   "moe_serve": moe_serve_launches,
                   **{f"quant_serve/{run}": lc
                      for run, lc in quant_launches.items()}}
    other_pre = {k: v for k, v in pre[16]["bfloat16"].items()}
    other_pre["max_abs_err_fp32"] = pre[16]["float32"]["max_abs_err"]
    other_pre["verify_shape"] = pre_verify

    def flash_entry(name, line):
        b = flash[("bfloat16", "smoke")][name]
        variant = b["variant"]
        kernel = FLASH_KERNELS[(name, variant)]
        lib = ("scaled_dot_product_attention(is_causal=True, enable_gqa="
               "True) on [B, H, S, D] copies" + (
                   "" if name == "flash_fwd" else
                   ", its backward through autograd (dQ, dK and dV in one "
                   "call)"))
        return {"name": name, "route": "cuda",
                "source": "deepspeed_tpu_torch/ops/csrc/flash_attention.cu",
                "kernel": kernel, "variant": variant,
                "replaces": f"deepspeed_tpu/ops/pallas/flash_attention.py:"
                            f"{line}",
                "launches": train_launches[name],
                "launches_by_path": {
                    "train": train_launches[name],
                    "moe_train": moe_train_launches[name],
                    "checkpoint": ckpt_launches[name],
                    "offload": offload_launches[name],
                    "offload_checkpoint": offload_ckpt_launches[name],
                    "zenflow": zenflow_launches[name],
                    "zenflow_blocking": zenflow_block_launches[name],
                    "zenflow_checkpoint": zenflow_ckpt_launches[name],
                    **{f"a4/{run}": lc[name]
                       for run, lc in a4_launches.items()},
                    **{run: lc[name] for run, lc in zero_launches.items()},
                    **{f"observability_{run}": lc[name]
                       for run, lc in obs_launches.items()},
                    "v1_forward": v1_paths["v1_forward"][name]},
                "kernel_bench_launches": bench["launched"][name],
                "variant_launches_by_path": {
                    path: {k: v for k, v in lc.items()
                           if k.startswith(name + "/")}
                    for path, lc in (("train", train_launches),
                                     ("moe_train", moe_train_launches),
                                     ("checkpoint", ckpt_launches),
                                     ("offload", offload_launches),
                                     ("offload_checkpoint",
                                      offload_ckpt_launches),
                                     ("zenflow", zenflow_launches),
                                     ("zenflow_blocking",
                                      zenflow_block_launches),
                                     ("zenflow_checkpoint",
                                      zenflow_ckpt_launches),
                                     *((f"a4/{run}", lc) for run, lc
                                       in a4_launches.items()),
                                     *zero_launches.items(),
                                     *((f"observability_{run}", lc) for run,
                                       lc in obs_launches.items()),
                                     ("v1_forward",
                                      v1_paths["v1_forward"]))},
                "max_abs_err": b["max_abs_err"],
                "max_row_rel_err": b.get("max_row_rel_err"),
                "ms": b["ms"], "tflops": b["tflops"],
                "first_version_ms": b["first_version_ms"],
                "plain_ms": b["plain_ms"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": b["library_ms"], "library_call": lib,
                "dtype": "bfloat16",
                "shape": flash[("bfloat16", "smoke")]["shape"],
                "ptxas": kernel_lines(ptxas["flash_attention"], kernel),
                "other": {f"{dt}/{case}": flash[(dt, case)][name]
                          for dt, case in flash
                          if (dt, case) != ("bfloat16", "smoke")}}

    def gmm_entry(name, line):
        b = gmm[("bfloat16", "train_wi")][name]
        variant = b["variant"]
        return {"name": name, "route": "cuda",
                "source": "deepspeed_tpu_torch/ops/csrc/grouped_matmul.cu",
                "kernel": GMM_KERNELS[(name, variant)], "variant": variant,
                "replaces": f"deepspeed_tpu/ops/pallas/grouped_matmul.py:"
                            f"{line}",
                "launches": moe_train_launches[name],
                "launches_by_path": {"moe_serve": moe_serve_launches[name],
                                     "moe_train": moe_train_launches[name]},
                "kernel_bench_launches": bench["launched"][name],
                "variant_launches_by_path": {
                    path: {k: v for k, v in lc.items()
                           if k.startswith(name + "/")}
                    for path, lc in (("moe_serve", moe_serve_launches),
                                     ("moe_train", moe_train_launches))},
                "max_abs_err": b["max_abs_err"],
                "max_rel_err": b["max_rel_err"],
                "ms": b["ms"], "tflops": b["tflops"],
                "first_version_ms": b.get("first_version_ms"),
                "plain_ms": b["plain_ms"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": b["library_ms"],
                "library_call": "torch._grouped_mm with offs = cumsum of "
                                "the group sizes (operand layouts prepared "
                                "outside the timed call)",
                "library_note": b.get("library_note"),
                "dtype": "bfloat16",
                "shape": gmm[("bfloat16", "train_wi")]["shape"],
                "ptxas": kernel_lines(
                    ptxas["grouped_matmul"],
                    GMM_KERNELS[(name, variant)].split("<")[0]),
                "train_wo": gmm[("bfloat16", "train_wo")][name],
                "decode": gmm[("bfloat16", "decode")][name],
                "other": {f"{dt}/{case}": gmm[(dt, case)][name]
                          for dt, case in gmm
                          if (dt, case) not in (("bfloat16", "train_wi"),
                                                ("bfloat16", "train_wo"))}}

    def quant_entry(name, line, res, other, main_run):
        note = {"quantize_blockwise":
                "the TPU _quant_kernel; on the path: weight-only int8 "
                "(one launch per eligible leaf)",
                "kv_quantize_append":
                "the same quantize at block = head_dim (kv_quantize :152), "
                "fused with kv_pack and the scatter into the pool",
                "dequantize":
                "the never-launched TPU _dequant_kernel and kv_dequantize "
                ":175"}[name]
        return {"name": name, "route": "cuda",
                "source": "deepspeed_tpu_torch/ops/csrc/quantization.cu",
                "replaces": f"deepspeed_tpu/ops/pallas/quantization.py:"
                            f"{line}",
                "replaces_note": note,
                "launches": quant_launches[main_run][name],
                "launches_by_path": {
                    **{run: lc[name] for run, lc in quant_launches.items()},
                    **{run: v1_paths[run][name] for run in (
                        "v1_int8_weights_build",
                        "v1_int8_weights_generate")}},
                "max_abs_err": res["max_abs_err"], "bit_equal": True,
                "variant": "simt", "ms": res["ms"],
                # one version: its first is itself
                "first_version_ms": res["ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                "library_ms": None,
                "library_call": "none: no single PyTorch call computes a "
                                "blockwise absmax quantize or a scaled "
                                "dequantize",
                "shape": res["shape"], "other": other}

    def sparse_entry():
        b = sparse[("bfloat16", "main")]
        kernel = BS_KERNELS[b["variant"]]
        return {"name": "blocksparse_fwd", "route": "cuda",
                "source": "deepspeed_tpu_torch/ops/csrc/"
                          "blocksparse_attention.cu",
                "kernel": kernel, "variant": b["variant"],
                "replaces": "deepspeed_tpu/ops/pallas/"
                            "blocksparse_attention.py:247",
                "launches": sparse_fwd_launches["blocksparse_fwd"],
                "launches_by_path": {
                    "full_depth_forward":
                        sparse_fwd_launches["blocksparse_fwd"],
                    **{k: v for k, v in sparse_launches.items()
                       if not isinstance(v, dict)}},
                "kernel_bench_launches": bench["launched"]["blocksparse_fwd"],
                "variant_launches_by_path": {
                    "full_depth_forward": {
                        k: v for k, v in sparse_fwd_launches.items()
                        if k.startswith("blocksparse_fwd/")},
                    "engine_eval": sparse_launches["engine_eval_by_variant"]},
                "max_abs_err": b["max_abs_err"],
                "max_row_rel_err": b["max_row_rel_err"],
                "masked_max_row_rel_err": b["masked_max_row_rel_err"],
                "ms": b["ms"], "tflops": b["tflops"],
                "first_version_ms": b["first_version_ms"],
                "plain_ms": b["plain_ms"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": b["library_ms"],
                "library_call": "scaled_dot_product_attention on [B, H, S, "
                                "D] copies, KV heads expanded, the layout "
                                "and causality as a boolean attn_mask (it "
                                "computes every block)",
                "dtype": "bfloat16", "shape": b["shape"],
                "ptxas": kernel_lines(ptxas["blocksparse_attention"],
                                      kernel),
                "other": {f"{dt}/{case}": sparse[(dt, case)]
                          for dt, case in sparse
                          if (dt, case) != ("bfloat16", "main")}}

    kernels = {"kernels": [
        entry("paged_decode",
              "deepspeed_tpu/ops/pallas/paged_attention.py:77", dec,
              {"long_context": dec["bfloat16"]["long_context"],
               "float32": dec["float32"]}, DECODE_KERNELS, paged_paths),
        entry("paged_prefill",
              "deepspeed_tpu/ops/pallas/paged_attention.py:117", pre[128],
              other_pre, PREFILL_KERNELS, paged_paths),
        flash_entry("flash_fwd", 150),
        flash_entry("flash_bwd_dkdv", 268),
        flash_entry("flash_bwd_dq", 326),
        gmm_entry("gmm", 129),
        gmm_entry("gmm_transposed", 129),
        gmm_entry("tgmm", 212),
        quant_entry("quantize_blockwise", 72, quant[("bfloat16", 128, 8)],
                    {f"{n}/block{b}/bits{q}": quant[(n, b, q)]
                     for n, b, q in quant if (n, b, q) != ("bfloat16", 128,
                                                           8)},
                    "int8_weights"),
        quant_entry("kv_quantize_append", 152, kv_app[(8, 16)],
                    {"/".join(map(str, k)): v for k, v in kv_app.items()
                     if k != (8, 16)}, "int8"),
        quant_entry("dequantize", 82, deq[8],
                    {str(k): v for k, v in deq.items() if k != 8}, "int8"),
        sparse_entry(),
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"serve_profile": profile}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"train_profile": train_profile}), flush=True)
    print(json.dumps({"moe_serve": moe_serve}), flush=True)
    print(json.dumps({"moe_serve_profile": moe_serve_profile}), flush=True)
    print(json.dumps({"moe_train": moe_train}), flush=True)
    print(json.dumps({"moe_train_profile": moe_train_profile}), flush=True)
    print(json.dumps({"quant_serve": quant_serve}), flush=True)
    print(json.dumps({"quant_serve_profile": quant_profile}), flush=True)
    print(json.dumps({"sparse_forward": sparse_fwd}), flush=True)
    print(json.dumps({"sparse_forward_profile": sparse_fwd_profile}),
          flush=True)
    print(json.dumps({"sparse_train": sparse_train}), flush=True)
    print(json.dumps({"checkpoint": ckpt}), flush=True)
    print(json.dumps({"offload": offload}), flush=True)
    print(json.dumps({"offload_profile": offload_profile}), flush=True)
    print(json.dumps({"offload_parity": offload_parity}), flush=True)
    print(json.dumps({"offload_checkpoint": offload_ckpt,
                      "phase10_wall_s": offload_wall}), flush=True)
    print(json.dumps({"zenflow": zenflow}), flush=True)
    print(json.dumps({"zenflow_profile": zenflow_profile}), flush=True)
    print(json.dumps({"zenflow_blocking": zenflow_block}), flush=True)
    print(json.dumps({"zenflow_checkpoint": zenflow_ckpt}), flush=True)
    print(json.dumps({"optimizer_sweep": sweep,
                      "phase11_wall_s": zenflow_wall}), flush=True)
    print(json.dumps({"spec_serve": spec_serve}), flush=True)
    print(json.dumps({"draft_model": draft}), flush=True)
    print(json.dumps({"paged_prefill_verify_shape": pre_verify}),
          flush=True)
    print(json.dumps({"a4": a4, "phase12_wall_s": phase12_s}), flush=True)
    print(json.dumps({"kernel_bench": bench}), flush=True)
    print(json.dumps({"v1_engine": v1, "phase13_wall_s": phase13_s,
                      "dispatch_by_phases": dispatch}),
          flush=True)
    print(json.dumps({"zero": zero}), flush=True)
    print(json.dumps({"observability": obs}), flush=True)
    print(json.dumps({"observability_serve": obs_serve}), flush=True)
    print(json.dumps({"run_seconds": time.perf_counter() - t_start}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
