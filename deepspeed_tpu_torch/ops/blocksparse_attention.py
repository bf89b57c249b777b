"""Block-sparse attention (fixed / bigbird / longformer / variable).

Port of ``deepspeed_tpu/ops/pallas/blocksparse_attention.py``. The
layout classes (``SparsityConfig`` and its five modes, ``MODES``,
``make_sparsity_config``, ``from_config``) are pure numpy and are copied
as they are, so a layout here is the same boolean array as JAX's
(BigBird draws from ``np.random.default_rng(seed)`` in both).
``blocksparse_attention`` is the masked form with JAX's cast points,
differentiable through autograd, at any S. ``sparse_self_attention`` and
``layout_density`` are copied too.

``blocksparse_attention_kernel`` is the counterpart of
``blocksparse_attention_pallas`` (the TPU's forward-only no-grad fast
path, ``_sparse_fwd_kernel`` :247): on CUDA tensors it launches the
hand-written Hopper kernel (``csrc/blocksparse_attention.cu``), or
raises; on CPU tensors it runs ``blocksparse_fwd_plain``, which folds
the same key tiles in the kernel's order. What it does that the TPU
wrapper does not:
- Work list, not a gated grid. For each query tile the host lists the
  key tiles of the same width that hold a visible (row, column) pair,
  once per (layout, S, causal, tile, device), and keeps the list on the
  device. A kernel block walks only its tile's list, so the work scales
  with the layout's density and no block visits an absent pair.
- Two kernels, chosen by ``blocksparse_variant`` from type, head dim,
  layout block, strides and alignment alone: the tensor-core kernel
  (``wgmma`` fed by TMA, 128-wide tiles: JAX's own fold at its default
  block of 128) for bf16 with head dim 128, a layout block that is a
  multiple of 128, (batch, seq, head) strides that are positive
  multiples of 8 and 16-byte aligned data; the scalar kernel (``simt``,
  64-wide tiles) for the rest.
- Any layout block (16 in the JAX tests, 128 by default; the ``kernels``
  config block takes powers of two). A tile is live when it holds a
  visible pair of a live layout block; where the block is not a
  multiple of the tile, the scalar kernel takes the mask inside a tile
  from the layout element by element (the tensor-core kernel takes only
  blocks whose live tiles lie inside one live block).
- Any S: the layout is built from the block-padded length, as the masked
  form builds it, and columns at or past S get an exact-zero
  probability. For S a block multiple this is JAX's kernel; for any S it
  is the masked form on every row that sees a column. A row that sees
  no column gives 0 (the kernel's ``l_safe``); the masked form gives the
  mean of V there.
- GQA: q head h reads kv head h // (Hq / Hkv), exactly
  ``repeat_kv_heads`` followed by the MHA function, without the copy.

``LAUNCHES`` counts kernel launches (the plain version never counts);
``VARIANT_LAUNCHES`` splits them by variant.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

DEFAULT_BLOCK = 128
NEG_INF = -1e30
TILE = 64              # query rows and key columns per scalar-kernel tile
TC_TILE = 128          # the same for the tensor-core kernel
HEAD_DIMS = (64, 128)  # the head dims the kernel is built for

LAUNCHES: Dict[str, int] = {"blocksparse_fwd": 0}
VARIANT_LAUNCHES: Dict[str, int] = {"blocksparse_fwd/wgmma": 0,
                                    "blocksparse_fwd/simt": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# layout classes (reference sparsity_config.py)
# ---------------------------------------------------------------------------

class SparsityConfig:
    """Base layout class (reference SparsityConfig: num_heads, block)."""

    def __init__(self, block: int = DEFAULT_BLOCK):
        self.block = int(block)

    def num_blocks(self, seq_len: int) -> int:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} not a multiple of "
                             f"block {self.block}")
        return seq_len // self.block

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attended (sanity/testing)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        return np.ones((n, n), bool)


class FixedSparsityConfig(SparsityConfig):
    """Reference 'fixed' mode: each query block attends its local window
    of ``num_local_blocks`` and the last block of every window is global
    (attended by everyone)."""

    def __init__(self, block: int = DEFAULT_BLOCK, num_local_blocks: int = 4,
                 num_global_blocks: int = 1):
        super().__init__(block)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        layout = np.zeros((n, n), bool)
        for q in range(n):
            w0 = (q // self.num_local_blocks) * self.num_local_blocks
            layout[q, w0:w0 + self.num_local_blocks] = True
        # last num_global_blocks of each window are global columns
        for w0 in range(0, n, self.num_local_blocks):
            hi = min(w0 + self.num_local_blocks, n)
            lo = max(hi - self.num_global_blocks, 0)
            layout[:, lo:hi] = True
        return layout


class LongformerSparsityConfig(SparsityConfig):
    """Sliding window + global attention on the first blocks."""

    def __init__(self, block: int = DEFAULT_BLOCK,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1):
        super().__init__(block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        layout = np.zeros((n, n), bool)
        half = self.num_sliding_window_blocks // 2
        for q in range(n):
            lo, hi = max(0, q - half), min(n, q + half + 1)
            layout[q, lo:hi] = True
        g = min(self.num_global_blocks, n)
        layout[:, :g] = True  # everyone reads the globals
        layout[:g, :] = True  # globals read everyone
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding-window + global blocks (deterministic seed)."""

    def __init__(self, block: int = DEFAULT_BLOCK,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, seed: int = 0):
        super().__init__(block)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        layout = LongformerSparsityConfig(
            self.block, self.num_sliding_window_blocks,
            self.num_global_blocks).make_layout(seq_len)
        rng = np.random.default_rng(self.seed)
        for q in range(n):
            picks = rng.choice(n, size=min(self.num_random_blocks, n),
                               replace=False)
            layout[q, picks] = True
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Reference 'variable' mode: explicit local windows + global
    block indices."""

    def __init__(self, block: int = DEFAULT_BLOCK,
                 local_window_blocks: Sequence[int] = (4,),
                 global_block_indices: Sequence[int] = (0,)):
        super().__init__(block)
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        layout = np.zeros((n, n), bool)
        q = 0
        windows = list(self.local_window_blocks)
        while q < n:
            w = windows[0] if len(windows) == 1 else windows.pop(0)
            hi = min(q + w, n)
            layout[q:hi, q:hi] = True
            q = hi
        for g in self.global_block_indices:
            if g < n:
                layout[:, g] = True
                layout[g, :] = True
        return layout


MODES = {"dense": DenseSparsityConfig, "fixed": FixedSparsityConfig,
         "longformer": LongformerSparsityConfig,
         "bigbird": BigBirdSparsityConfig, "variable": VariableSparsityConfig}


def make_sparsity_config(mode: str, **kwargs) -> SparsityConfig:
    """Config-block entry (reference runtime/config.py:250-410 modes)."""
    if mode not in MODES:
        raise ValueError(f"unknown sparse attention mode '{mode}' "
                         f"(choose from {sorted(MODES)})")
    return MODES[mode](**kwargs)


def from_config(cfg) -> SparsityConfig:
    """Build a layout from the engine's ``sparse_attention`` config block
    (config.SparseAttentionConfig; 'bslongformer' is the reference's name
    for the longformer mode)."""
    mode = cfg.mode
    if mode == "dense":
        return DenseSparsityConfig(cfg.block)
    if mode == "fixed":
        return FixedSparsityConfig(cfg.block, cfg.num_local_blocks,
                                   cfg.num_global_blocks)
    if mode == "bslongformer":
        return LongformerSparsityConfig(cfg.block,
                                        cfg.num_sliding_window_blocks,
                                        cfg.num_global_blocks)
    if mode == "bigbird":
        return BigBirdSparsityConfig(cfg.block, cfg.num_random_blocks,
                                     cfg.num_sliding_window_blocks,
                                     cfg.num_global_blocks)
    if mode == "variable":
        return VariableSparsityConfig(cfg.block,
                                      cfg.local_window_blocks,
                                      cfg.global_block_indices)
    raise ValueError(f"unknown sparse attention mode '{mode}'")


# ---------------------------------------------------------------------------
# the masked form
# ---------------------------------------------------------------------------

def _padded_layout(sparsity: SparsityConfig, S: int) -> np.ndarray:
    """The layout of the block-padded length, checked square."""
    block = sparsity.block
    if block < 1:
        raise ValueError(f"layout block must be positive, got {block}")
    padded = -(-S // block) * block
    layout = np.asarray(sparsity.make_layout(padded), bool)
    n = padded // block
    if layout.shape != (n, n):
        raise ValueError(f"layout for S {S} (padded {padded}, block "
                         f"{block}) must be [{n}, {n}], got "
                         f"{list(layout.shape)}")
    return layout


def _expand_mask(layout: np.ndarray, block: int, seq_q: int,
                 seq_k: int) -> np.ndarray:
    m = np.repeat(np.repeat(layout, block, axis=0), block, axis=1)
    return m[:seq_q, :seq_k]


# (kind, id(sparsity), S, causal, device) -> (sparsity, value): layouts
# are static, so what is built from one is built once and kept
_CACHE: Dict[tuple, tuple] = {}


def _cached(kind, sparsity: SparsityConfig, S: int, causal: bool,
            device: torch.device, build):
    key = (kind, id(sparsity), S, bool(causal), str(device))
    hit = _CACHE.get(key)
    if hit is None or hit[0] is not sparsity:  # ids of dead objects recur
        if len(_CACHE) >= 32:
            _CACHE.clear()
        hit = _CACHE[key] = (sparsity, build())
    return hit[1]


def _element_mask(sparsity: SparsityConfig, S: int, causal: bool,
                  device: torch.device) -> torch.Tensor:
    """[S, S] bool on the device: the expanded layout, and causality."""
    def build():
        mask = torch.from_numpy(_expand_mask(_padded_layout(sparsity, S),
                                             sparsity.block, S, S))
        mask = mask.to(device)
        return mask.tril() if causal else mask

    return _cached("mask", sparsity, S, causal, device, build)


def blocksparse_attention(q, k, v, sparsity: SparsityConfig,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse attention, the masked form. q, k, v: [B, S, N, D]
    (model layout, MHA). Scores in fp32 times scale (products of bf16
    values are exact in fp32, as under JAX's fp32 preferred type),
    ``NEG_INF`` where the expanded layout (and causality) hide a column,
    fp32 softmax, probabilities cast to q's type before the product with
    V. Any S: the layout comes from the block-padded length and the mask
    is trimmed back to S. Differentiable through autograd."""
    D = q.shape[-1]
    mask = _element_mask(sparsity, q.shape[1], causal, q.device)
    scale = scale if scale is not None else D ** -0.5
    scores = torch.einsum("bsnd,btnd->bnst", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v).to(q.dtype)


def sparse_self_attention(q, k, v, mode: str = "fixed", causal: bool = True,
                          block: int = DEFAULT_BLOCK, **mode_kwargs):
    """One-call form: build the layout from (mode, kwargs) and run
    (reference SparseSelfAttention module)."""
    cfg = make_sparsity_config(mode, block=block, **mode_kwargs)
    return blocksparse_attention(q, k, v, cfg, causal=causal)


def layout_density(layout: np.ndarray, causal: bool = True) -> float:
    """Fraction of the dense score matrix actually computed — the
    compute/memory saving factor."""
    n = layout.shape[0]
    if causal:
        tri = np.tril(np.ones((n, n), bool))
        return float((layout & tri).sum() / tri.sum())
    return float(layout.mean())


def visible_pairs(layout: np.ndarray, block: int, S: int,
                  causal: bool) -> int:
    """(query row, key column) pairs of one head that the layout, S and
    causality let through: the work these inputs need."""
    total = 0
    for bq in range(layout.shape[0]):
        r0, r1 = bq * block, min((bq + 1) * block, S)
        if r0 >= r1:
            continue
        cols = np.repeat(layout[bq], block)[:S]
        if causal:
            total += int(np.cumsum(cols)[r0:r1].sum())
        else:
            total += int(cols.sum()) * (r1 - r0)
    return total


# ---------------------------------------------------------------------------
# the work list
# ---------------------------------------------------------------------------


class WorkList(NamedTuple):
    """Live key tiles of each query tile, ``tile`` rows and columns wide
    (64 for the scalar kernel, 128 for the tensor-core one).
    ``offsets`` [nt + 1] and ``tiles`` (ascending key tiles, query tile
    after query tile) are CSR; ``order`` lists the query tiles longest
    list first (the kernel's launch order); ``layout`` is the padded
    block layout as uint8 on the device, read element by element when a
    tile spans several layout blocks."""

    block: int
    causal: bool
    tile: int
    live: np.ndarray          # [nt, nt] bool, the host copy
    offsets: torch.Tensor     # int32 [nt + 1]
    tiles: torch.Tensor       # int32 [number of live pairs]
    order: torch.Tensor       # int32 [nt]
    layout: torch.Tensor      # uint8 [nb, nb]
    layout_host: np.ndarray   # bool [nb, nb]


def tile_layout(layout: np.ndarray, block: int, S: int, causal: bool,
                tile: int = TILE) -> np.ndarray:
    """[nt, nt] bool: key tile j of query tile i (tiles ``tile`` wide)
    holds a visible pair. Worked out on units of gcd(block, tile)
    positions, which lie inside one layout block and one tile each;
    causally, a unit pair holds a visible pair when its column unit is
    not after its row unit."""
    nt = -(-S // tile)
    g = math.gcd(block, tile)
    rep = block // g
    units = np.repeat(np.repeat(layout, rep, axis=0), rep, axis=1)
    units[-(-S // g):] = False     # units wholly at or past S
    units[:, -(-S // g):] = False
    if causal:
        units = units & np.tril(np.ones(units.shape, bool))
    f = tile // g
    pad = np.zeros((nt * f, nt * f), bool)
    n = min(units.shape[0], nt * f)
    pad[:n, :n] = units[:n, :n]
    return pad.reshape(nt, f, nt, f).any(axis=(1, 3))


def work_list(sparsity: SparsityConfig, S: int, causal: bool,
              device: torch.device, tile: int = TILE) -> WorkList:
    """The work list for (layout, S, causal) at tile width ``tile`` on
    ``device``, built on the host once per sparsity object and tile."""
    def build():
        layout = _padded_layout(sparsity, S)
        live = tile_layout(layout, sparsity.block, S, causal, tile)
        counts = live.sum(axis=1)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        tiles = np.nonzero(live)[1].astype(np.int32)
        order = np.argsort(-counts, kind="stable").astype(np.int32)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return WorkList(sparsity.block, bool(causal), tile, live,
                        dev(offsets), dev(tiles), dev(order),
                        dev(layout.astype(np.uint8)), layout)

    return _cached(("work", tile), sparsity, S, causal, device, build)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, S, H, D] -> fp32 [B, Hkv, H/Hkv, S, D] (q head h = kv head
    h // group, member h % group)."""
    B, S, H, D = x.shape
    return x.float().reshape(B, S, hkv, H // hkv, D).permute(0, 2, 3, 1, 4)


def blocksparse_fwd_plain(q, k, v, work: WorkList,
                          scale: float) -> torch.Tensor:
    """The kernels' function in PyTorch at the work list's tile width
    (``work.tile``: 64 folds as the scalar kernel does, 128 as the
    tensor-core one): for each key tile in ascending order, the query
    tiles whose list holds it fold it into their fp32 running max,
    denominator and accumulator (exact-zero probabilities where the
    layout, causality or S hide a column; p rounded to the input type
    before p @ V). Output acc / l, 0 where l == 0, in q's type."""
    B, S, hq, D = q.shape
    hkv = k.shape[2]
    qf, kf, vf = _grouped(q, hkv), _grouped(k, hkv), _grouped(v, hkv)
    shape = (B, hkv, hq // hkv, S, 1)
    m = torch.full(shape, NEG_INF, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(qf.shape, device=q.device)
    lay = torch.from_numpy(work.layout_host).to(q.device)
    block, tile = work.block, work.tile
    pos = torch.arange(S, device=q.device)
    for ik in range(work.live.shape[1]):
        qtiles = np.nonzero(work.live[:, ik])[0]
        if qtiles.size == 0:
            continue
        rows = torch.cat([pos[t * tile:(t + 1) * tile] for t in qtiles])
        cols = pos[ik * tile:(ik + 1) * tile]
        vis = lay[rows // block][:, cols // block]
        if work.causal:
            vis = vis & (cols[None, :] <= rows[:, None])
        s = torch.matmul(qf[..., rows, :], kf[..., cols, :].transpose(-1, -2))
        s = torch.where(vis, s * scale, torch.full_like(s, NEG_INF))
        m_r = m[..., rows, :]
        m_new = torch.maximum(m_r, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m_r - m_new)
        p = torch.where(vis, torch.exp(s - m_new), torch.zeros_like(s))
        l[..., rows, :] = alpha * l[..., rows, :] + p.sum(dim=-1, keepdim=True)
        if q.dtype != torch.float32:
            p = p.to(q.dtype).float()
        acc[..., rows, :] = acc[..., rows, :] * alpha + torch.matmul(
            p, vf[..., cols, :])
        m[..., rows, :] = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = acc / l_safe
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from deepspeed_tpu_torch.ops import build

        lib = build.load("blocksparse_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dstpu_blocksparse_fwd.argtypes = [I, I, P, P, P, P, P, P, P, P,
                                              P, I, I, I, I, I, I, I, F, P]
        lib.dstpu_blocksparse_fwd.restype = I
        lib.dstpu_blocksparse_fwd_wgmma.argtypes = [P, P, P, P, P, P, P, P,
                                                    I, I, I, I, I, F, P]
        lib.dstpu_blocksparse_fwd_wgmma.restype = I
        lib.dstpu_cuda_error_string.argtypes = [I]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _use_kernel(q, k, v) -> bool:
    """Check shapes for both paths; True for CUDA tensors (the kernel),
    False for CPU tensors (the plain version). Raises on what the kernel
    does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, S, Hq, D] and k, v [B, S, Hkv, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, hq, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"q heads ({hq}) not a multiple of kv heads "
                         f"({k.shape[2]})")
    if k.device != q.device or v.device != q.device:
        raise ValueError("blocksparse attention inputs must share a device")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"blocksparse kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"blocksparse kernel takes float32 or bfloat16 q, "
                        f"k, v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("blocksparse kernel needs unit stride over head_dim")
    return True


def blocksparse_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sparsity: SparsityConfig,
                        device_type: Optional[str] = None) -> str:
    """Which kernel runs: "plain" on the CPU; on the card "wgmma" (the
    tensor-core kernel) for bf16 q, k, v with head dim 128, a layout
    block that is a multiple of 128 (a live 128-wide tile then lies
    inside one live block), every (batch, seq, head) stride a positive
    multiple of 8 elements (TMA's 16-byte strides) and 16-byte aligned
    data, else "simt" (the scalar kernel). ``device_type`` stands in for
    q's device (tests ask the card's rule of CPU tensors)."""
    if (device_type or q.device.type) == "cpu":
        return "plain"
    ts = (q, k, v)
    if (all(t.dtype == torch.bfloat16 for t in ts) and q.shape[-1] == 128
            and sparsity.block % TC_TILE == 0
            and all(st > 0 and st % 8 == 0 for t in ts
                    for st in t.stride()[:3])
            and all(t.data_ptr() % 16 == 0 for t in ts)):
        return "wgmma"
    return "simt"


def _strides(*ts) -> ctypes.Array:
    """(batch, seq, head) element strides of q, k and v, as the kernel's
    int64 array of 9."""
    return (ctypes.c_longlong * 9)(*[s for t in ts for s in t.stride()[:3]])


def blocksparse_attention_kernel(q, k, v, sparsity: SparsityConfig,
                                 causal: bool = True,
                                 scale: Optional[float] = None,
                                 variant: Optional[str] = None
                                 ) -> torch.Tensor:
    """Block-sparse forward, the counterpart of JAX's
    ``blocksparse_attention_pallas`` (no gradient). q: [B, S, Hq, D];
    k, v: [B, S, Hkv, D] (GQA read in place); any S, any layout block.
    CUDA tensors launch the kernel :func:`blocksparse_variant` names:
    the tensor-core kernel where the layout block is a multiple of 128
    (bf16, head dim 128, aligned), the scalar kernel for every other
    block, which it masks element by element. ``variant`` ("wgmma" or
    "simt", CUDA tensors only) overrides that choice, so that the scalar
    kernel can run on inputs the tensor-core one takes; "wgmma" on
    inputs it does not take raises. CPU tensors run
    :func:`blocksparse_fwd_plain` at the scalar kernel's tile."""
    use = _use_kernel(q, k, v)
    B, S, hq, D = q.shape
    scale = float(scale if scale is not None else D ** -0.5)
    if not use:
        if variant is not None:
            raise ValueError("a blocksparse kernel variant runs on CUDA "
                             "tensors")
        return blocksparse_fwd_plain(
            q, k, v, work_list(sparsity, S, causal, q.device), scale)
    rule = blocksparse_variant(q, k, v, sparsity)
    variant = rule if variant is None else variant
    if variant not in ("wgmma", "simt"):
        raise ValueError(f"unknown blocksparse variant {variant!r}")
    if variant == "wgmma" and rule != "wgmma":
        raise ValueError("the tensor-core blocksparse forward takes bf16 q, "
                         "k, v of head dim 128 with a layout block that is "
                         "a multiple of 128 and 16-byte aligned data and "
                         "strides")
    tile = TC_TILE if variant == "wgmma" else TILE
    work = work_list(sparsity, S, causal, q.device, tile)
    o = torch.empty((B, S, hq, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "wgmma":
        rc = _lib().dstpu_blocksparse_fwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            work.offsets.data_ptr(), work.tiles.data_ptr(),
            work.order.data_ptr(), _strides(q, k, v), B, S, hq, k.shape[2],
            int(causal), scale, stream)
    else:
        rc = _lib().dstpu_blocksparse_fwd(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), work.offsets.data_ptr(),
            work.tiles.data_ptr(), work.order.data_ptr(),
            work.layout.data_ptr(), _strides(q, k, v), B, S, hq, k.shape[2],
            int(causal), work.block, work.layout.shape[0], scale, stream)
    if rc != 0:
        msg = _lib().dstpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"blocksparse_fwd kernel launch failed "
                           f"({variant}): {msg} ({rc})")
    LAUNCHES["blocksparse_fwd"] += 1
    VARIANT_LAUNCHES[f"blocksparse_fwd/{variant}"] += 1
    return o


__all__ = ["SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
           "LongformerSparsityConfig", "BigBirdSparsityConfig",
           "VariableSparsityConfig", "MODES", "make_sparsity_config",
           "from_config", "blocksparse_attention", "sparse_self_attention",
           "layout_density", "visible_pairs", "work_list", "tile_layout",
           "blocksparse_fwd_plain", "blocksparse_attention_kernel",
           "blocksparse_variant", "LAUNCHES", "VARIANT_LAUNCHES",
           "reset_launch_counts", "HEAD_DIMS", "TILE", "TC_TILE"]
