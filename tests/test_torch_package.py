"""Package rules of the PyTorch port: no JAX, no optax and nothing of
the JAX package inside it, the card by default, and loud errors for what
is not ported yet."""

import ast
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import _device
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference.ragged import KVCacheConfig
from deepspeed_tpu_torch.models import zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__))
FORBIDDEN = ("jax", "jaxlib", "optax", "deepspeed_tpu")


def _port_files():
    for root, _, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = list(_port_files())
    assert len(files) >= 15
    # the quantized-serving, block-sparse, checkpoint, resilience,
    # offload, ZenFlow, optimizer, speculation, prefetch, dispatch, kernel
    # bench, report, v1 engine, ZeRO-across-ranks and observability modules
    # are among the files checked
    rel = {os.path.relpath(p, PKG) for p in files}
    assert {"ops/quantization.py", "ops/fp_quantizer.py",
            "inference/weight_quant.py",
            "inference/ragged/kv_tier.py", "ops/blocksparse_attention.py",
            "runtime/dataloader.py", "checkpoint/state.py",
            "runtime/checkpoint_engine.py", "utils/telemetry.py",
            "resilience/__init__.py", "resilience/chaos.py",
            "resilience/manifest.py", "resilience/policy.py",
            "resilience/preemption.py", "resilience/resume.py",
            "utils/memspace.py", "ops/native/builder.py",
            "ops/native/cpu_optimizer.py", "ops/native/aio.py",
            "runtime/swap_tensor/swapper.py", "runtime/offload.py",
            "io/fast_file_writer.py", "runtime/zenflow.py",
            "runtime/muon.py", "runtime/optimizer.py",
            "inference/spec_decode.py", "runtime/prefetch.py",
            "ops/kernel_table.py", "ops/registry.py",
            "tools/kernel_bench.py", "launcher/report.py",
            "inference/engine.py", "comm/comm.py", "comm/__init__.py",
            "parallel/topology.py", "runtime/sharding.py",
            "runtime/zero.py", "runtime/sparse_tensor.py",
            "utils/tensor_fragment.py", "utils/comms_logging.py",
            "observability/__init__.py", "observability/hub.py",
            "observability/sinks.py", "observability/histogram.py",
            "observability/step_trace.py", "observability/roofline.py",
            "observability/attribution.py",
            "observability/profile_trace.py", "observability/watchdog.py",
            "observability/flight_recorder.py",
            "observability/request_trace.py", "observability/clocksync.py",
            "utils/annotate.py", "utils/timer.py", "utils/memory.py",
            "utils/logging.py", "monitor/monitor.py"} <= rel
    bad = {os.path.relpath(p, REPO): sorted(set(_imported_roots(p))
                                            & set(FORBIDDEN))
           for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.get_model("tiny")
    assert not _device.kernels_available()
    assert _device.resolve_device("cpu") == torch.device("cpu")


def test_engine_refuses_weights_on_another_device():
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="weights live on"):
        InferenceEngineV2(model, device="meta")


def test_unported_options_raise():
    from deepspeed_tpu_torch.models.moe_transformer import (
        MoETransformerConfig)

    # the MoE presets build now (config only here: no full-size build)
    assert isinstance(zoo.get_config("mixtral-8x7b"), MoETransformerConfig)
    with pytest.raises(ValueError, match="unknown model"):
        zoo.get_config("no-such-model")
    # the quantized KV rungs and speculative decoding are ported; the
    # fleet's serving options are not
    for bits in (4, 8, "fp8"):
        assert KVCacheConfig(num_layers=1, kv_heads=1, head_dim=8,
                             quant_bits=bits).quant_bits == bits
    from deepspeed_tpu_torch.config.config import ServingConfig
    assert ServingConfig(spec_decode=True, spec_adaptive_k=True).spec_decode
    with pytest.raises(NotImplementedError, match="item 13"):
        ServingConfig(router={"replicas": 2})
    # the sparse_attention and kernels blocks are ported, the kernel
    # table's path too
    from deepspeed_tpu_torch.config.config import UNPORTED_BLOCKS, load_config
    assert not {"sparse_attention", "kernels"} & set(UNPORTED_BLOCKS)
    cfg = load_config({"sparse_attention": {"mode": "bigbird"},
                       "kernels": {"blocksparse_block": 64}})
    assert cfg.sparse_attention.mode == "bigbird"
    assert cfg.kernels.blocksparse_block == 64
    assert load_config({"kernels": {"table_path": "table.json"}}
                       ).kernels.table_path == "table.json"
    # the checkpoint and resilience blocks are ported, the AIO write
    # pipeline too; of the checkpoint block, universal checkpoints are not
    assert not {"checkpoint", "resilience"} & set(UNPORTED_BLOCKS)
    cfg = load_config({"checkpoint": {"async_save": True},
                       "resilience": {"manifest_checksums": False}})
    assert cfg.checkpoint.async_save
    assert not cfg.resilience.manifest_checksums
    with pytest.raises(NotImplementedError, match="item 16"):
        load_config({"checkpoint": {"load_universal": True}})
    assert load_config({"checkpoint": {"parallel_write_pipeline": True}}
                       ).checkpoint.parallel_write_pipeline


def test_seeded_init_is_reproducible_at_the_jax_scales():
    over = dict(dtype=torch.float32, num_layers=3, hidden_size=256,
                num_heads=4, pos_emb="rope", norm="rmsnorm",
                activation="swiglu", tie_embeddings=False, ffn_size=512)
    a = zoo.get_model("tiny", device="cpu", seed=3, **over).params()
    b = zoo.get_model("tiny", device="cpu", seed=3, **over).params()
    c = zoo.get_model("tiny", device="cpu", seed=4, **over).params()
    wq = a["layers"]["attn"]["wq"]
    assert torch.equal(wq, b["layers"]["attn"]["wq"])
    assert not torch.equal(wq, c["layers"]["attn"]["wq"])
    # JAX _dense_init scales: 1/sqrt(fan_in), 0.02 for the embeddings
    np.testing.assert_allclose(wq.std().item(), 1 / 16, rtol=0.05)
    np.testing.assert_allclose(a["layers"]["mlp"]["wo"].std().item(),
                               1 / np.sqrt(512), rtol=0.05)
    np.testing.assert_allclose(a["embed"]["tokens"].std().item(), 0.02,
                               rtol=0.05)
    assert torch.all(a["layers"]["ln1"]["scale"] == 1.0)
    assert wq.shape == (3, 256, 4, 64)


def test_llama3_8b_preset_is_full_width():
    cfg = zoo.get_config("llama3-8b")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.kv_heads,
            cfg.ffn, cfg.vocab_size, cfg.head_dim) == (
                4096, 32, 32, 8, 14336, 128256, 128)
    assert cfg.dtype == torch.bfloat16
    assert 8.0e9 < cfg.num_params() < 8.1e9
