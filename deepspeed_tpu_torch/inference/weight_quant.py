"""Weight-only int8 serving (port of
``deepspeed_tpu/inference/weight_quant.py``).

Each eligible weight of the parameter tree becomes a ``QuantizedTensor``:
int8 codes plus one fp32 scale per block of the last dim, the symmetric
absmax formula of ``ops/quantization.py`` at block 128. The runner reads
every weight through one accessor (``model_runner._weight``) that
dequantizes a ``QuantizedTensor`` to the compute dtype at each use
(``QuantizedTensor.to``), one layer's slice at a time: the stacked
full-precision copy never exists again. On the card ``quantize_weight``
runs the blockwise quantize kernel and ``.to`` runs the dequantize
kernel; on the CPU both run their plain versions.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from deepspeed_tpu_torch.ops.quantization import (dequantize,
                                                  quantize_blockwise)

QUANT_BLOCK = 128
MIN_BLOCK = 16  # below this the fp32 scales eat the int8 savings


class QuantizedTensor:
    """int8 blockwise-quantized stand-in for a weight tensor.

    q [..., nblocks, block] int8 and scale [..., nblocks, 1] fp32 stand
    for a logical [..., nblocks * block] tensor of ``dtype``. Indexing
    the leading dims (the runner's per-layer ``leaf[l]``) slices q and
    scale alike; ``.to(dtype)`` is the dequantization point."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 like_dtype: Optional[torch.dtype] = None):
        self.q = q
        self.scale = scale
        self._dtype = like_dtype if like_dtype is not None else \
            torch.bfloat16

    @property
    def shape(self):
        qs = tuple(self.q.shape)
        return qs[:-2] + (qs[-2] * qs[-1],)

    @property
    def ndim(self) -> int:
        return self.q.dim() - 1

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * 4

    def __getitem__(self, idx) -> "QuantizedTensor":
        """Index the leading (stacked) dims only."""
        lead = idx if isinstance(idx, tuple) else (idx,)
        if len(lead) > self.ndim - 1:
            raise IndexError("a QuantizedTensor indexes its leading dims "
                             "only; dequantize first to index the last")
        return QuantizedTensor(self.q[idx], self.scale[idx], self._dtype)

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        """Dequantize: codes times their block's scale, one rounding to
        ``dtype`` (the dequantize kernel on the card)."""
        full = dequantize(self.q, self.scale[..., 0], dtype)
        return full.reshape(self.shape)


def pick_block(n: int, block: int = QUANT_BLOCK) -> Optional[int]:
    """Largest power-of-2 divisor of n up to ``block``; None when it
    would be so small that int8 + per-block fp32 scales exceed the
    original bytes (then the leaf stays exact)."""
    b = block
    while n % b:
        b //= 2
    return b if b >= MIN_BLOCK else None


def quantize_weight(w: torch.Tensor, block: int = QUANT_BLOCK
                    ) -> QuantizedTensor:
    """Blockwise symmetric int8 over the last dim (the one shared
    formula, ``ops/quantization.quantize_blockwise``)."""
    b = pick_block(w.shape[-1], block)
    if b is None:
        raise ValueError(
            f"last dim {w.shape[-1]} has no >= {MIN_BLOCK} power-of-2 "
            "block divisor; leaf is not worth quantizing")
    q, scale = quantize_blockwise(w.detach(), bits=8, block=b)
    q = q.reshape(*w.shape[:-1], w.shape[-1] // b, b)
    return QuantizedTensor(q, scale[..., None], w.dtype)


def _eligible(path: str, leaf) -> bool:
    """Quantize the big matmul weights; embeddings (lookup tables),
    norms, biases, the MoE router and experts stay exact."""
    if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
        return False
    if pick_block(leaf.shape[-1]) is None:
        return False  # degenerate blocks would GROW the leaf
    if "embed" in path and "unembed" not in path:
        return False  # token/position lookup tables stay exact
    # the MoE dispatch consumes expert weights directly
    for skip in ("ln1", "ln2", "norm", "['b", "router", "experts"):
        if skip in path:
            return False
    return True


def quantize_params(params: Any, block: int = QUANT_BLOCK) -> Any:
    """Params tree -> tree with eligible weights as QuantizedTensor
    (paths spelled as JAX's ``keystr``, so the same leaves qualify).

    The tree's eligible leaves are taken over: each one's full-precision
    storage is freed as soon as its codes exist (the tensor keeps its
    identity with zero elements), so peak memory is the full-precision
    tree plus one leaf's codes, never both trees. Whatever else holds
    those tensors (the model) can no longer compute with them."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}['{k}']") for k, v in node.items()}
        if not _eligible(path, node):
            return node
        qt = quantize_weight(node, block)
        node.data = torch.empty(0, dtype=node.dtype, device=node.device)
        return qt
    return walk(params, "")


def quantized_fraction(params: Any) -> float:
    """Fraction of the ORIGINAL weight bytes now held as int8."""
    qb = tb = 0

    def walk(node):
        nonlocal qb, tb
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, QuantizedTensor):
            n = 1
            for d in node.shape:
                n *= d
            orig = n * torch.empty((), dtype=node.dtype).element_size()
            qb += orig
            tb += orig
        elif isinstance(node, torch.Tensor):
            tb += node.numel() * node.element_size()
    walk(params)
    return qb / tb if tb else 0.0
