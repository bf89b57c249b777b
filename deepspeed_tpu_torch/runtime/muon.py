"""Muon: momentum orthogonalized by Newton-Schulz (port of
``deepspeed_tpu/runtime/muon.py``).

SGD momentum whose update, for the stacked hidden matrices of the
layers, is orthogonalized by JAX's quintic Newton-Schulz iteration and
scaled to Adam's RMS (``match_rms``); every other leaf (embeddings, the
unembedding, norms, biases) gets AdamW, as JAX's ``optax.multi_transform``
routes them. The Newton-Schulz products are ``torch.matmul`` in fp32,
batched over the stacked layer dim (JAX computes them outside any Pallas
kernel). Over ZeRO's fsdp blocks (``blocks``) a rank gathers its block
of each matrix's momentum update, orthogonalizes the whole matrix and
keeps its block; the AdamW leaves step their blocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from deepspeed_tpu_torch.runtime.optimizer import Adam, Optimizer

# quintic Newton-Schulz coefficients (reference original_muon.py / Keller
# Jordan's Muon): the iteration pushes singular values toward 1 without
# full convergence
NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz(G: torch.Tensor, steps: int = 5, eps: float = 1e-7
                  ) -> torch.Tensor:
    """Approximately orthogonalize the last two dims of ``G`` ([..., m,
    n], leading dims batched), in fp32."""
    a, b, c = NS_COEFFS
    x = G.float()
    transposed = x.shape[-2] > x.shape[-1]
    if transposed:
        x = x.transpose(-1, -2)
    norm = torch.sqrt(torch.sum(x * x, dim=(-2, -1), keepdim=True)) + eps
    x = x / norm
    for _ in range(steps):
        A = x @ x.transpose(-1, -2)          # [..., m, m]
        B = b * A + c * (A @ A)
        x = a * x + B @ x
    if transposed:
        x = x.transpose(-1, -2)
    return x


def is_matrix_path(path: str, ndim: int) -> bool:
    """JAX's ``_is_matrix_path`` on the port's paths (``/layers/attn/wq``):
    a stacked hidden matrix of the layers ([L, ...] with at least two
    trailing dims); norms and biases stay on AdamW. JAX tests substrings
    of ``keystr`` (``['layers']['attn']['wq']``), where ``['b`` marks a
    key that starts with ``b``: here ``/b``."""
    if "layers" not in path:
        return False
    for skip in ("ln1", "ln2", "norm", "bias", "/b"):
        if skip in path:
            return False
    return ndim >= 3


def matricize(x: torch.Tensor) -> torch.Tensor:
    """[L, d1, ..., dk] -> [L, m, n], at the split of the trailing dims
    that gives the most balanced matrix: (fan_in, fan_out) for every zoo
    layout (wq [L, h, nh, hd] -> (h, nh*hd), wo [L, nh, hd, h] ->
    (nh*hd, h), mlp [L, h, f] -> (h, f))."""
    dims = x.shape[1:]
    best_j, best_bal = 1, -1.0
    for j in range(1, len(dims)):
        m = 1
        for d in dims[:j]:
            m *= d
        n = 1
        for d in dims[j:]:
            n *= d
        bal = min(m, n) / max(m, n)
        if bal > best_bal:
            best_j, best_bal = j, bal
    m = 1
    for d in dims[:best_j]:
        m *= d
    return x.reshape(x.shape[0], m, -1)


@dataclass
class Muon(Optimizer):
    """JAX's ``muon``: the matrix branch on ``is_matrix_path`` leaves,
    optax ``adamw`` (``adam_b1``, ``adam_b2``, ``adam_eps``, the same
    weight decay) on the rest. Both follow one lr at one count."""

    beta: float = 0.95
    ns_steps: int = 5
    nesterov: bool = True
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    adam: Adam = field(init=False)

    def __post_init__(self):
        self.adam = Adam(lr=self.lr, b1=self.adam_b1, b2=self.adam_b2,
                         eps=self.adam_eps, weight_decay=self.weight_decay,
                         decoupled=True)

    def init_leaf(self, path, master):
        if is_matrix_path(path, master.dim()):
            return {"mu": torch.zeros_like(master)}
        return self.adam.init_leaf(path, master)

    def update_leaf(self, path, master, g, st, t, lr):
        if not is_matrix_path(path, master.dim()):
            self.adam.update_leaf(path, master, g, st, t, lr)
            return
        mom = st["mu"]
        mom.copy_(self.beta * mom + g)
        eff = self.beta * mom + g if self.nesterov else mom
        blocks = self.blocks
        if blocks is not None:
            # Newton-Schulz reads the whole matrix: the ranks' blocks of
            # the momentum update gathered, this rank's block kept
            eff = blocks.whole(path, eff)
        mats = matricize(eff)
        m, n = mats.shape[-2], mats.shape[-1]
        ortho = newton_schulz(mats, self.ns_steps)
        # JAX's match_rms: one lr drives both groups, so the orthogonal
        # update's RMS is scaled to Adam's typical step (reference /
        # Moonlight)
        ortho = ortho * (0.2 * torch.sqrt(torch.tensor(
            float(max(m, n)), dtype=torch.float32, device=g.device)))
        upd = ortho.reshape(eff.shape)
        if blocks is not None:
            upd = blocks.block(path, upd)
        if self.weight_decay:
            upd = upd + self.weight_decay * master
        master.add_(upd * -lr)


__all__ = ["Muon", "newton_schulz", "is_matrix_path", "matricize",
           "NS_COEFFS"]
