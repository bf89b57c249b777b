"""Blockwise int8 / int4 quantization, the int4 nibble codec, the KV-cache
quantize-on-append and the dequantize.

Port of ``deepspeed_tpu/ops/pallas/quantization.py`` :36-193: same
functions, signatures and layouts. Scheme: symmetric per-block scale
(absmax / qmax, 1.0 for an all-zero block) along the last dim, round
half to even, clip to [-qmax - 1, qmax]; int4 values live in int8
storage until ``pack_int4`` puts two in a byte (the even index in the
low nibble). ``kv_quantize`` uses one scale per head vector (block =
head_dim); its ``"fp8"`` rung stores e4m3 values (``fp_quantizer.py``).

Four hand-written Hopper kernels (``csrc/quantization.cu``) carry the
quantized serving path:

- ``quantize_blockwise`` (the TPU ``_quant_kernel``): int8 codes and one
  fp32 scale per block row; weight-only int8 runs it on every eligible
  weight (``inference/weight_quant.py``).
- ``kv_quantize_append``: quantize a step's K and V at block = head_dim,
  pack (int4) and write codes and scales straight into the paged pool,
  K and V of every token in one launch. Its plain version is, by
  definition, ``kv_quantize`` -> ``kv_pack`` -> scatter.
- ``dequantize``: codes (int8, packed int4 or e4m3) times their fp32
  scale, rounded once to the output type; it covers a layer pool, a
  gathered copy of pages and weight blocks. Its plain version is
  ``kv_dequantize(kv_unpack(...))``, which is also what JAX's
  ``_dequantize_ref`` and the never-launched TPU ``_dequant_kernel``
  compute.
- ``kv_append_dequantize``: ``kv_quantize_append`` and the layer's
  ``dequantize`` after it in one launch, the whole pool (the paged
  forwards) or a block table's pages (the gather forward) into a scratch
  in the compute dtype. The step's K and V are a few hundred KB, three
  orders of magnitude below what a launch costs, so no standalone append
  kernel comes near its bound: it rides in the dequantize launch that
  every quantized layer runs anyway. Its plain version is, by
  definition, the append's plain version then the dequantize's.

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs the plain PyTorch version beside it. Every operation is
one IEEE-rounded step in both, so they agree bit for bit. There is no
other path: no fallback when a build or a launch fails.

The quantized collectives of ZeRO++ (``quantized_all_gather``,
``quantized_psum_scatter``, ``quantized_all_reduce``; JAX :201-260) are
bodies over ``comm``: each quantizes with ``quantize_blockwise`` (the
kernel on the card), moves the codes (int8, or int4 packed two to a
byte) and the fp32 scales, and dequantizes with ``dequantize`` (the
kernel on the card; it unpacks int4 itself). As in JAX they quantize
at every group size, one rank included. The comms logger records the
codes' and the scales' bytes, the wire.

``LAUNCHES`` counts kernel launches per kernel (the plain versions never
count), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.fp_quantizer import fp_quantize

DEFAULT_BLOCK = 256
# the quantize kernel holds a block row in one warp's registers
MAX_KERNEL_BLOCK = 1024

LAUNCHES: Dict[str, int] = {"quantize_blockwise": 0,
                            "kv_quantize_append": 0, "dequantize": 0,
                            "kv_append_dequantize": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# payload storage dtype -> kernel kind (int8 codes, packed int4, e4m3)
_KIND = {torch.int8: 0, torch.uint8: 1, torch.float8_e4m3fn: 2}
_BITS_OF_KIND = {0: 8, 1: 4, 2: "fp8"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the JAX reference formulas)
# ---------------------------------------------------------------------------


def _quantize_ref(x: torch.Tensor, bits: int, block: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    orig_shape = x.shape
    n = x.shape[-1]
    assert n % block == 0, f"last dim {n} must divide block {block}"
    xb = x.reshape(*x.shape[:-1], n // block, block).float()
    qmax = (1 << (bits - 1)) - 1  # 127 / 7
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not JAX's (or the kernel's)
    # IEEE quotient
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, qmax))
    q = torch.clamp(torch.round(xb / scale), -qmax - 1, qmax).to(torch.int8)
    return q.reshape(orig_shape), scale[..., 0]


def _dequantize_ref(q: torch.Tensor, scale: torch.Tensor, bits: int,
                    block: int, dtype: torch.dtype) -> torch.Tensor:
    n = q.shape[-1]
    qb = q.reshape(*q.shape[:-1], n // block, block).float()
    out = qb * scale[..., None]
    return out.reshape(q.shape).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., N] int8 nibbles -> [..., N/2] packed bytes."""
    lo = q[..., 0::2].to(torch.uint8) & 0x0F
    hi = (q[..., 1::2].to(torch.uint8) & 0x0F) << 4
    return lo | hi


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)


def kv_quantize_plain(x: torch.Tensor, bits=8
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kv_quantize`` in plain PyTorch: (codes [..., hd], fp32 scales
    [...])."""
    hd = x.shape[-1]
    if bits == "fp8":
        q, s = fp_quantize(x, fmt="e4m3", group_size=hd)
    else:
        q, s = _quantize_ref(x, bits, hd)
    return q, s[..., 0]


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, bits=8,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of kv_quantize: (int8 / fp8 codes [..., head_dim], fp32
    [...]) -> dtype, value times scale in fp32 (fp8 codes upcast
    exactly). Plain PyTorch on every device; ``dequantize`` is the
    kernel's entry point."""
    del bits  # value-times-scale for every rung
    return (q.float() * scale[..., None].float()).to(dtype)


def kv_pack(q: torch.Tensor, bits) -> torch.Tensor:
    """Storage codec of the quantized KV pool: int8 / fp8 codes pass
    through; int4 packs two per byte (uint8, last dim head_dim // 2)."""
    return pack_int4(q) if bits == 4 else q


def kv_unpack(p: torch.Tensor, bits) -> torch.Tensor:
    """Inverse of kv_pack: uint8 nibbles -> int8 values in [-8, 7]; int8 /
    fp8 codes pass through."""
    return unpack_int4(p) if bits == 4 else p


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A one-byte view for index writes (fp8 has no index_put on every
    backend; the bytes are the payload either way)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def kv_quantize_append_plain(kv_layer, kv_scales, page, offset, k, v,
                             bits) -> None:
    """kv_quantize -> kv_pack -> scatter at (page, offset, plane 0 / 1),
    in place. k, v [..., nkv, hd]; page / offset with k's leading
    shape."""
    page, offset = page.long(), offset.long()
    for plane, x in ((0, k), (1, v)):
        q, s = kv_quantize_plain(x, bits)
        _bytes(kv_layer)[page, offset, plane] = _bytes(kv_pack(q, bits))
        kv_scales[page, offset, plane] = s


def dequantize_plain(payload: torch.Tensor, scales: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """``dequantize`` in plain PyTorch: kv_dequantize(kv_unpack(...))."""
    bits = _BITS_OF_KIND[_KIND[payload.dtype]]
    return kv_dequantize(kv_unpack(payload, bits), scales, bits, dtype)


def pool_pages(kv_layer: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``kv_layer[index]`` on the payload's bytes (indexing has no fp8
    kernel on every backend), viewed back in the payload's dtype."""
    return _bytes(kv_layer)[index].view(kv_layer.dtype)


def kv_append_dequantize_plain(kv_layer, kv_scales, page, offset, k, v, bits,
                               out, block_table=None) -> torch.Tensor:
    """``kv_append_dequantize`` in plain PyTorch: the append's plain
    version, then the layer pool (or ``block_table``'s pages) dequantized
    into ``out``."""
    kv_quantize_append_plain(kv_layer, kv_scales, page, offset, k, v, bits)
    if block_table is None:
        res = dequantize_plain(kv_layer, kv_scales, out.dtype)
    else:
        bt = block_table.long()
        res = dequantize_plain(pool_pages(kv_layer, bt), kv_scales[bt],
                               out.dtype)
    return out.copy_(res)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from deepspeed_tpu_torch.ops import build

        lib = build.load("quantization")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dstpu_quantize_blockwise.argtypes = [I, P, P, P, L, I, I, P]
        lib.dstpu_quantize_blockwise.restype = I
        lib.dstpu_kv_quantize_append.argtypes = [
            I, I, P, P, P, P, P, P, I, I, I, I, I, P]
        lib.dstpu_kv_quantize_append.restype = I
        lib.dstpu_dequantize.argtypes = [I, I, P, P, P, L, I, I, P]
        lib.dstpu_dequantize.restype = I
        lib.dstpu_kv_append_dequantize.argtypes = [
            I, I, P, P, P, P, P, P, P, P, L, I, I, I, I, I, P,
            ctypes.POINTER(ctypes.c_ulonglong), P]
        lib.dstpu_kv_append_dequantize.restype = I
        lib.dstpu_cuda_error_string.argtypes = [I]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().dstpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _on_card(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs), True for CUDA
    tensors (the kernel runs); anything else, or a mix, raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("kernel inputs must share a device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_blockwise(x: torch.Tensor, bits: int = 8,
                       block: int = DEFAULT_BLOCK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., N] -> (int8 values [..., N], fp32 scales [..., N/block]).

    INT4 values occupy int8 storage in [-8, 7]; pack with pack_int4 for
    storage or transport. A last dim that ``block`` does not divide
    takes ``block = min(block, N)``, as in JAX (a last dim longer than
    the block and not a multiple of it is an error there too)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    n = x.shape[-1]
    blk = block if n % block == 0 else min(block, n)
    if n % blk:
        raise ValueError(f"last dim {n} must divide block {blk}")
    if not _on_card(x):
        return _quantize_ref(x, bits, blk)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize kernel takes float32, bfloat16 or "
                        f"float16 input, got {x.dtype}")
    if blk > MAX_KERNEL_BLOCK:
        raise ValueError(f"quantize kernel takes blocks of at most "
                         f"{MAX_KERNEL_BLOCK} values, got {blk}")
    rows = x.numel() // blk
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], n // blk), dtype=torch.float32,
                        device=x.device)
    rc = _lib().dstpu_quantize_blockwise(
        _DTYPE_CODE[x.dtype], x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        rows, blk, bits, _stream(x))
    _raise_on(rc, "quantize_blockwise")
    LAUNCHES["quantize_blockwise"] += 1
    return q, scale


def dequantize(payload: torch.Tensor, scales: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Codes times their fp32 scale, one rounding to ``dtype``.

    payload [..., W]: int8 codes, uint8 packed int4 (two per byte, W =
    n / 2) or float8_e4m3fn codes; scales [...] fp32, one per row of n
    values. Returns [..., n] in ``dtype``, written into ``out`` when it
    is given (a scratch tensor reused across layers)."""
    if payload.dtype not in _KIND:
        raise TypeError(f"dequantize takes int8, uint8 (packed int4) or "
                        f"float8_e4m3fn codes, got {payload.dtype}")
    if scales.shape != payload.shape[:-1]:
        raise ValueError(f"scales {tuple(scales.shape)} must be the "
                         f"payload's leading shape "
                         f"{tuple(payload.shape[:-1])}")
    kind = _KIND[payload.dtype]
    W = payload.shape[-1]
    n = 2 * W if kind == 1 else W
    shape = (*payload.shape[:-1], n)
    if out is not None and (tuple(out.shape) != shape or out.dtype != dtype):
        raise ValueError(f"out must be {shape} {dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if not _on_card(payload, scales):
        res = dequantize_plain(payload, scales, dtype)
        if out is None:
            return res
        out.copy_(res)
        return out
    if dtype not in _DTYPE_CODE or scales.dtype != torch.float32:
        raise TypeError(f"dequantize kernel writes float32, bfloat16 or "
                        f"float16 from fp32 scales, got {dtype} and "
                        f"{scales.dtype}")
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=payload.device)
    elif out.device != payload.device or not out.is_contiguous():
        raise ValueError("out must be contiguous on the payload's device")
    rows = scales.numel()
    rc = _lib().dstpu_dequantize(kind, _DTYPE_CODE[dtype],
                                 payload.data_ptr(), scales.data_ptr(),
                                 out.data_ptr(), rows, n, W,
                                 _stream(payload))
    _raise_on(rc, "dequantize")
    LAUNCHES["dequantize"] += 1
    return out


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, bits: int = 8,
                         block: int = DEFAULT_BLOCK,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_blockwise (int8 storage, 4-bit values
    unpacked)."""
    del bits  # value-times-scale for both widths
    n = q.shape[-1]
    blk = block if n % block == 0 else min(block, n)
    qb = q.reshape(*q.shape[:-1], n // blk, blk)
    return dequantize(qb, scale, dtype).reshape(q.shape)


def _dequantize_rows(q: torch.Tensor, s: torch.Tensor, bits: int, n: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """Codes [..., n] (int8) or [..., n / 2] (packed int4) with their
    block scales [..., n / blk] back to ``dtype`` [..., n], in one
    ``dequantize`` (the unpack included)."""
    nb = s.shape[-1]
    w = q.shape[-1] // nb
    out = dequantize(q.reshape(*q.shape[:-1], nb, w), s, dtype)
    return out.reshape(*q.shape[:-1], n)


def _encode(x: torch.Tensor, bits: int, block: int):
    q, s = quantize_blockwise(x, bits=bits, block=block)
    return (pack_int4(q) if bits == 4 else q), s


def quantized_all_gather(x: torch.Tensor, axis, bits: int = 8,
                         block: int = DEFAULT_BLOCK,
                         log_name: str = "quantized_all_gather"
                         ) -> torch.Tensor:
    """qwZ: the all-gather along dim 0 with an int8 / int4 wire
    (reference quantized weight all-gather, partition_parameters.py:1446):
    quantize this rank's block, gather codes and scales, dequantize to
    ``x``'s dtype."""
    from deepspeed_tpu_torch import comm

    q, s = _encode(x, bits, block)
    qg = comm.all_gather(q, axis, gather_dim=0, log_name=log_name)
    sg = comm.all_gather(s, axis, gather_dim=0,
                         log_name=f"{log_name}_scales")
    return _dequantize_rows(qg, sg, bits, x.shape[-1], x.dtype)


def quantized_psum_scatter(x: torch.Tensor, axis, bits: int = 8,
                           block: int = DEFAULT_BLOCK,
                           log_name: str = "quantized_psum_scatter"
                           ) -> torch.Tensor:
    """qgZ: the mean-reducing scatter of dim 0 with a quantized wire
    (reference all_to_all_quant_reduce, coalesced_collectives.py:31):
    quantize, all-to-all codes and scales (block r of dim 0 to rank r),
    dequantize in fp32, sum over the source ranks in rank order, divide
    by the group size; returns this rank's block in ``x``'s dtype."""
    from deepspeed_tpu_torch import comm

    n = comm.axis_size(axis)
    shard = x.shape[0] // n
    q, s = _encode(x, bits, block)
    qt = comm.all_to_all(q, axis, split_dim=0, concat_dim=0,
                         log_name=log_name)
    st = comm.all_to_all(s, axis, split_dim=0, concat_dim=0,
                         log_name=f"{log_name}_scales")
    vals = _dequantize_rows(qt, st, bits, x.shape[-1], torch.float32)
    vals = vals.reshape(n, shard, *x.shape[1:])
    acc = vals[0].clone()
    for r in range(1, n):
        acc += vals[r]
    # a tensor divisor: CUDA's division by a Python scalar multiplies by
    # its reciprocal; ``full`` fills on the device (no host copy, no sync)
    n_t = torch.full((), float(n), dtype=torch.float32, device=acc.device)
    return (acc / n_t).to(x.dtype)


def quantized_all_reduce(x: torch.Tensor, axis, bits: int = 8,
                         block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """qar (EQuARX, arXiv:2506.17615): ``quantized_psum_scatter`` then
    ``quantized_all_gather`` of the reduced blocks, so both wire phases
    move codes; the full mean on every rank. Dim 0 is padded to a
    multiple of the group size and the padding stripped after."""
    from deepspeed_tpu_torch import comm

    n = comm.axis_size(axis)
    d0 = x.shape[0]
    pad = (-d0) % n
    xp = x if pad == 0 else torch.cat(
        [x, x.new_zeros((pad, *x.shape[1:]))], dim=0)
    shard = quantized_psum_scatter(xp, axis, bits=bits, block=block,
                                   log_name="qar_scatter")
    full = quantized_all_gather(shard, axis, bits=bits, block=block,
                                log_name="qar_gather")
    return full[:d0] if pad else full


def kv_quantize(x: torch.Tensor, bits=8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a KV tensor [..., head_dim] with one fp32 scale per head
    vector: (int8 codes [..., head_dim], fp32 scales [...]); ``bits="fp8"``
    gives e4m3 codes (scale = absmax / 448). The integer rungs go through
    ``quantize_blockwise`` (the kernel on the card)."""
    if bits == "fp8":
        return kv_quantize_plain(x, bits)
    q, s = quantize_blockwise(x, bits=bits, block=x.shape[-1])
    return q, s[..., 0]


def _check_append(kv_layer, kv_scales, page, offset, k, v, bits) -> int:
    """The pool, its scales and the step's K / V fit one another (the
    kind of ``bits`` is returned)."""
    if kv_layer.dim() != 5 or kv_layer.shape[2] != 2:
        raise ValueError(f"kv_layer must be [nb, bs, 2, nkv, W], got "
                         f"{tuple(kv_layer.shape)}")
    nb, bs, _, nkv, W = kv_layer.shape
    if kv_scales.shape != kv_layer.shape[:-1]:
        raise ValueError(f"kv_scales must be {tuple(kv_layer.shape[:-1])}, "
                         f"got {tuple(kv_scales.shape)}")
    hd = k.shape[-1]
    want_kind = {8: 0, 4: 1, "fp8": 2}.get(bits)
    if want_kind is None or _KIND.get(kv_layer.dtype) != want_kind:
        raise TypeError(f"bits={bits!r} does not match a pool of "
                        f"{kv_layer.dtype}")
    if (W != (hd // 2 if bits == 4 else hd) or k.shape != v.shape
            or tuple(k.shape) != (*page.shape, nkv, hd)
            or offset.shape != page.shape):
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} and "
                         f"page/offset {tuple(page.shape)} do not fit a "
                         f"pool of {tuple(kv_layer.shape)}")
    return want_kind


def _check_kernel_dtypes(name, k, v, kv_scales) -> None:
    if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise TypeError(f"{name} takes float32, bfloat16 or float16 K and "
                        f"V of one type, got {k.dtype} and {v.dtype}")
    if kv_scales.dtype != torch.float32:
        raise TypeError(f"kv_scales must be float32, got {kv_scales.dtype}")


def kv_quantize_append(kv_layer: torch.Tensor, kv_scales: torch.Tensor,
                       page: torch.Tensor, offset: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor, bits) -> None:
    """Quantize-on-append, in place: token i's K and V (one fp32 scale
    per head vector) land packed at (page[i], offset[i], plane 0 / 1) of
    one layer's pool.

    kv_layer  [nb, bs, 2, nkv, W] int8 (bits 8), uint8 (bits 4, W =
              head_dim / 2) or float8_e4m3fn (bits "fp8")
    kv_scales [nb, bs, 2, nkv] fp32
    page, offset  int64 (or int32), any shape; k, v [*page.shape, nkv,
              head_dim] in fp32, bf16 or fp16
    """
    want_kind = _check_append(kv_layer, kv_scales, page, offset, k, v, bits)
    nb, bs, _, nkv, W = kv_layer.shape
    hd = k.shape[-1]
    if not _on_card(kv_layer, kv_scales, page, offset, k, v):
        kv_quantize_append_plain(kv_layer, kv_scales, page, offset, k, v,
                                 bits)
        return
    _check_kernel_dtypes("kv_quantize_append", k, v, kv_scales)
    page = page.reshape(-1).long()
    offset = offset.reshape(-1).long()
    rc = _lib().dstpu_kv_quantize_append(
        _DTYPE_CODE[k.dtype], want_kind, k.data_ptr(), v.data_ptr(),
        page.data_ptr(), offset.data_ptr(), kv_layer.data_ptr(),
        kv_scales.data_ptr(), page.numel(), nkv, hd, bs, W, _stream(k))
    _raise_on(rc, "kv_quantize_append")
    LAUNCHES["kv_quantize_append"] += 1


# kv_append_dequantize's order (csrc/quantization.cu K4), per (device,
# stream): a uint64 count of released appender blocks that only grows,
# and the value the last launch made it reach
_RELEASED: Dict[Tuple[int, int],
                Tuple[torch.Tensor, ctypes.c_ulonglong]] = {}


def kv_append_dequantize(kv_layer: torch.Tensor, kv_scales: torch.Tensor,
                         page: torch.Tensor, offset: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor, bits,
                         out: torch.Tensor,
                         block_table: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``kv_quantize_append`` then the layer's ``dequantize``, in one
    launch: the step's K and V quantized into the pool in place (as
    ``kv_quantize_append``), then the pool read back into ``out`` in
    ``k``'s dtype (as ``dequantize``), bit for bit the two in sequence.

    out  [nb, bs, 2, nkv, head_dim] (the whole layer pool), or with
         ``block_table`` [S, Bm] that table's pages, [S, Bm, bs, 2, nkv,
         head_dim]
    The other arguments as ``kv_quantize_append``. Returns ``out``. Each
    launch waits for a count the host passes it, so it cannot be captured
    into a CUDA graph (a replay would wait for a stale count)."""
    kind = _check_append(kv_layer, kv_scales, page, offset, k, v, bits)
    nb, bs, _, nkv, W = kv_layer.shape
    hd = k.shape[-1]
    lead = (nb,) if block_table is None else tuple(block_table.shape)
    if tuple(out.shape) != (*lead, bs, 2, nkv, hd):
        raise ValueError(f"out must be {(*lead, bs, 2, nkv, hd)}, got "
                         f"{tuple(out.shape)}")
    table = () if block_table is None else (block_table,)
    if not _on_card(kv_layer, kv_scales, page, offset, k, v, out, *table):
        return kv_append_dequantize_plain(kv_layer, kv_scales, page, offset,
                                          k, v, bits, out, block_table)
    _check_kernel_dtypes("kv_append_dequantize", k, v, kv_scales)
    if out.dtype != k.dtype:
        raise TypeError(f"out must be K's dtype {k.dtype}, got {out.dtype}")
    if hd % 8 or hd > 256 or out.numel() >= 2 ** 31:
        raise ValueError(f"kv_append_dequantize takes a head_dim that is a "
                         f"multiple of 8, at most 256 (got {hd}), and an out "
                         f"of fewer than 2^31 values")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("kv_append_dequantize cannot be captured into a "
                           "CUDA graph")
    page = page.reshape(-1).long()
    offset = offset.reshape(-1).long()
    if block_table is not None:
        block_table = block_table.reshape(-1).long()
    stream = _stream(k)
    key = (k.device.index, stream)
    if key not in _RELEASED:
        _RELEASED[key] = (torch.zeros(1, dtype=torch.int64, device=k.device),
                          ctypes.c_ulonglong(0))
    released, target = _RELEASED[key]
    rc = _lib().dstpu_kv_append_dequantize(
        _DTYPE_CODE[k.dtype], kind, k.data_ptr(), v.data_ptr(),
        page.data_ptr(), offset.data_ptr(), kv_layer.data_ptr(),
        kv_scales.data_ptr(), out.data_ptr(),
        None if block_table is None else block_table.data_ptr(),
        out.numel() // hd, page.numel(), nkv, hd, bs, W,
        released.data_ptr(), ctypes.byref(target), stream)
    _raise_on(rc, "kv_append_dequantize")
    LAUNCHES["kv_append_dequantize"] += 1
    return out
