"""Carry a JAX parameter tree across into a ``TransformerLM``, and a
tree of tensors back out as numpy.

The JAX runner keeps fp32 params and casts each to the compute type at
use (``.astype(dt)``); here every leaf is stored once, already in the
compute type. The numbers the runner multiplies are the same, and at 8B
the weights take half the memory (about 16 GB in bf16).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch._device import DeviceLike
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)


def params_from_jax(tree: Mapping[str, Any], cfg: TransformerConfig,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> TransformerLM:
    """Build a ``TransformerLM`` whose leaves are copies of ``tree`` (the
    JAX ``init_params`` tree, leaves as numpy arrays or anything
    ``np.asarray`` reads). ``dtype`` overrides ``cfg.dtype``. Raises on a
    missing or extra leaf, or a shape that differs."""
    if dtype is not None and dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = TransformerLM(cfg, device=device, seed=None)

    def copy(dst: Mapping[str, Any], src: Mapping[str, Any], path: str):
        if set(dst) != set(src):
            raise ValueError(f"param tree mismatch at '{path or '/'}': "
                             f"port {sorted(dst)} vs jax {sorted(src)}")
        for key, node in dst.items():
            where = f"{path}/{key}"
            if isinstance(node, torch.Tensor):
                arr = np.array(src[key], dtype=np.float32)  # writable copy
                if tuple(arr.shape) != tuple(node.shape):
                    raise ValueError(f"{where}: jax shape {arr.shape} vs "
                                     f"port {tuple(node.shape)}")
                with torch.no_grad():
                    node.copy_(torch.from_numpy(arr))
            else:
                copy(node, src[key], where)

    copy(model.params(), tree, "")
    return model


def params_to_numpy(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A tree of tensors (any device or float type) as nested dicts of
    fp32 numpy arrays, the layout of a JAX tree read with np.asarray."""
    return {k: (params_to_numpy(v) if isinstance(v, Mapping)
                else v.detach().float().cpu().numpy())
            for k, v in tree.items()}
