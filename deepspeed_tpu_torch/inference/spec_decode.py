"""Speculative decoding drafters for the ragged serving engine (port of
``deepspeed_tpu/inference/spec_decode.py``).

Decode spends one full forward per token; speculation proposes ``k``
candidate tokens per sequence and verifies them in ONE batched forward
(``InferenceEngineV2._try_spec_step``: each sequence's chunk is its last
real token followed by its drafts, run through the paged prefill kernel
over the sequence's paged history). With greedy sampling the engine keeps
the longest prefix of drafts that match the model's own argmax chain plus
one bonus token, so the emitted stream is the argmax chain itself:
speculative greedy is token-identical to plain greedy whatever the drafts
are, and drafts only change how many tokens one forward yields.

The default drafter is model-free prompt lookup (n-gram matching): the
continuation of the longest recent n-gram that already occurred earlier
in the sequence is proposed verbatim, which pays off on repetitive text
(code being rewritten, extraction, quoted context). ``Drafter`` is the
hook for a draft model: anything with ``propose(tokens, k) -> list[int]``
plugs into the engine; ``TransformerDrafter`` is a small ``TransformerLM``
behind it, with JAX's ``.npz`` artifact format (``save`` / ``load``) and
its KL distillation against the target (``distill_from``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Protocol, Sequence, \
    runtime_checkable

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch._device import DeviceLike
from deepspeed_tpu_torch.models import transformer
from deepspeed_tpu_torch.models.convert import fp32_tree
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
from deepspeed_tpu_torch.runtime.optimizer import Adam


@runtime_checkable
class Drafter(Protocol):
    """Draft-proposal interface (the draft-model hook).

    ``tokens`` is the sequence's full token history (prompt + generated)
    and the return value is up to ``k`` proposed next tokens. An empty
    list means "no proposal": the engine falls back to plain decode for
    that sequence this round.

    Drafters that also want acceptance feedback implement
    ``note_result(drafted, accepted)`` (see :class:`DrafterStats`; the
    engine calls it after every verify round when present). It is kept
    out of the runtime-checkable protocol so a bare ``propose``-only
    object still satisfies ``isinstance(x, Drafter)``."""

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        ...


class DrafterStats:
    """Counters every drafter keeps: proposal-side stats at ``propose``
    time, and ``drafted_tokens`` / ``accepted_tokens`` fed back by the
    engine through :meth:`note_result`, so the acceptance rate is
    readable per drafter."""

    def __init__(self):
        self.stats: Dict[str, int] = {
            "calls": 0, "proposals": 0, "proposed_tokens": 0, "empty": 0,
            "drafted_tokens": 0, "accepted_tokens": 0}

    def note_result(self, drafted: int, accepted: int) -> None:
        """Engine feedback after one verify round: ``drafted`` tokens of
        this drafter's proposal went through the verifier, ``accepted``
        of them matched the greedy chain."""
        self.stats["drafted_tokens"] += int(drafted)
        self.stats["accepted_tokens"] += int(accepted)

    @property
    def acceptance_rate(self) -> Optional[float]:
        if not self.stats["drafted_tokens"]:
            return None
        return self.stats["accepted_tokens"] / self.stats["drafted_tokens"]


class PromptLookupDrafter(DrafterStats):
    """N-gram / prompt-lookup drafter: match the last ``n`` tokens
    (``max_ngram`` down to ``min_ngram``) against earlier history and
    propose the tokens that followed the most recent match."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})")
        super().__init__()
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        self.stats["calls"] += 1
        toks = list(tokens)
        L = len(toks)
        if k <= 0 or L < self.min_ngram + 1:
            self.stats["empty"] += 1
            return []
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pattern = toks[L - n:]
            # the most recent earlier occurrence wins (local context beats
            # a stale match from the far prompt)
            for i in range(L - n - 1, -1, -1):
                if toks[i:i + n] == pattern:
                    cont = toks[i + n:i + n + k]
                    if cont:
                        self.stats["proposals"] += 1
                        self.stats["proposed_tokens"] += len(cont)
                        return cont
        self.stats["empty"] += 1
        return []


def jax_leaf_order(tree: Dict[str, Any], prefix: str = ""):
    """(path, leaf) pairs in the order ``jax.tree_util.tree_flatten``
    gives a dict tree: keys sorted at every level."""
    for key in sorted(tree):
        node = tree[key]
        path = f"{prefix}/{key}"
        if isinstance(node, dict):
            yield from jax_leaf_order(node, path)
        else:
            yield path, node


class TransformerDrafter(DrafterStats):
    """A draft model behind the ``Drafter`` protocol: a small
    ``TransformerLM`` rolled out greedily for ``k`` tokens.

    The engine's acceptance rule makes correctness independent of the
    draft, so a cheap model here only changes how many tokens one verify
    forward emits. The rollout runs the drafter densely over a fixed-size
    right-padded window (causal attention makes right padding inert for
    the position being read); history longer than the window keeps only
    its trailing ``window`` tokens. The k steps of one proposal queue on
    the device without a host read between them; the proposal is fetched
    once.

    The weights are fp32 masters (``params``, the JAX drafter's
    ``param_dtype``) and the forward runs in ``config.dtype`` (bf16 by
    default, JAX's ``dtype``), each leaf cast at its use, as the JAX model
    does. A head dim outside the flash kernels' (``small``'s is 16) takes
    the dense attention path on the card (``ops.attention.auto_impl``).

    A fresh ``small()`` drafter knows nothing about the target; earn its
    acceptance with :meth:`distill_from` and persist it with
    :meth:`save` / :meth:`load` (JAX's ``.npz`` layout: either package
    reads the other's files)."""

    def __init__(self, model: TransformerLM,
                 params: Optional[Dict[str, Any]] = None,
                 window: int = 64, seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window = int(window)
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.model = model
        self.device = model.device
        self.config = dataclasses.replace(
            model.config, dtype=dtype or model.config.dtype)
        self.params = fp32_tree(params if params is not None
                                else model.params(), self.device)
        self.seed = seed
        self.distill_summary: Optional[Dict[str, Any]] = None

    @classmethod
    def small(cls, vocab_size: int, window: int = 64, hidden: int = 32,
              layers: int = 1, heads: int = 2, seed: int = 0,
              device: DeviceLike = None) -> "TransformerDrafter":
        """A from-scratch tiny draft model sharing only the vocabulary
        with the target (JAX's ``TransformerConfig`` defaults otherwise:
        learned positions, layernorm, gelu, tied embeddings, bf16
        compute over fp32 weights), seeded by ``seed``."""
        cfg = TransformerConfig(
            vocab_size=int(vocab_size), hidden_size=hidden,
            num_layers=layers, num_heads=heads,
            max_seq_len=max(int(window), 16), remat=False)
        model = TransformerLM(dataclasses.replace(cfg, dtype=torch.float32),
                              device=device, seed=seed)
        return cls(model, window=window, seed=seed, dtype=cfg.dtype)

    def _logits(self, tokens: torch.Tensor) -> torch.Tensor:
        return transformer.apply(self.config, self.params, tokens)

    @torch.no_grad()
    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        self.stats["calls"] += 1
        if k <= 0 or not len(tokens):
            self.stats["empty"] += 1
            return []
        W = self.window
        hist = np.asarray(list(tokens)[-W:], np.int64) \
            % self.config.vocab_size
        buf = torch.zeros((1, W), dtype=torch.long)
        buf[0, :len(hist)] = torch.from_numpy(hist)
        buf = buf.to(self.device)
        n = len(hist)
        out = []
        for _ in range(int(k)):
            nxt = self._logits(buf)[0, n - 1].argmax()
            out.append(nxt)
            if n < W:
                buf[0, n] = nxt
                n += 1
            else:  # the window slides: the oldest token drops out
                buf = torch.cat([buf[:, 1:], nxt.view(1, 1)], dim=1)
        ids = [int(t) for t in torch.stack(out).cpu()]
        self.stats["proposals"] += 1
        self.stats["proposed_tokens"] += len(ids)
        return ids

    # -- distillation ---------------------------------------------------

    def distill_from(self, target_model, target_params=None,
                     steps: int = 150, batch: int = 16, lr: float = 1e-2,
                     seed: int = 0, prefix_len: int = 4,
                     temperature: float = 1.0,
                     resample_every: int = 50) -> Dict[str, Any]:
        """Short KL-distillation loop against the target's logits (JAX's
        ``distill_from``).

        The training data is the TARGET's own greedy rollouts from random
        prefixes whose length is drawn uniformly in ``[2, prefix_len]``,
        resampled every ``resample_every`` steps; the loss is the
        soft-label cross-entropy ``-sum softmax(target / T) *
        log_softmax(draft)`` over the rollout positions, minimised with
        Adam (the port's optax ``adam``) on the fp32 weights through
        autograd. The prefixes come from a ``torch.Generator`` seeded by
        ``seed``. Returns (and stores on ``distill_summary``) the last
        loss and the held-out top-1 agreement with the target, the
        offline proxy for acceptance."""
        W = self.window
        vocab = self.config.vocab_size
        prefix_len = max(2, min(int(prefix_len), W - 1))
        gen = torch.Generator().manual_seed(int(seed))
        tparams = (target_model.params() if target_params is None
                   else target_params)
        dev = self.device

        @torch.no_grad()
        def t_apply(toks: torch.Tensor) -> torch.Tensor:
            return target_model.apply(tparams, toks)

        @torch.no_grad()
        def make_batch(n: int):
            plens = torch.randint(2, prefix_len + 1, (n,), generator=gen)
            toks = torch.zeros((n, W), dtype=torch.long)
            toks[:, :prefix_len] = torch.randint(0, vocab, (n, prefix_len),
                                                 generator=gen)
            toks = toks.to(dev)
            plens_d = plens.to(dev)
            for t in range(int(plens.min()), W):
                greedy = t_apply(toks)[:, t - 1].argmax(-1)
                toks[:, t] = torch.where(plens_d <= t, greedy, toks[:, t])
            targets = t_apply(toks).float()
            soft = torch.softmax(targets[:, :-1] / max(temperature, 1e-6),
                                 dim=-1)
            labels = toks[:, 1:]
            # position t predicts token t+1: supervised iff t+1 is a
            # rollout position, i.e. t >= plen - 1
            mask = (torch.arange(W - 1, device=dev)[None, :]
                    >= (plens_d - 1)[:, None]).float()
            return toks, soft, labels, mask

        def loss_of(inputs, soft, mask):
            logits = self._logits(inputs).float()
            logp = F.log_softmax(logits[:, :-1], dim=-1)
            ce = -(soft * logp).sum(-1)
            return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)

        paths = [p for p, _ in jax_leaf_order(self.params)]
        flat = dict(jax_leaf_order(self.params))
        opt = Adam(lr=float(lr), weight_decay=0.0, decoupled=False)
        states = {p: opt.init_leaf(p, flat[p]) for p in paths}
        resample_every = max(1, int(resample_every))
        loss = torch.tensor(float("nan"))
        inputs = soft = mask = None
        for step in range(int(steps)):
            if step % resample_every == 0:
                inputs, soft, _labels, mask = make_batch(int(batch))
            for p in paths:
                flat[p].requires_grad_(True)
            try:
                loss = loss_of(inputs, soft, mask)
                grads = torch.autograd.grad(loss, [flat[p] for p in paths])
                loss = loss.detach()
            finally:
                for p in paths:
                    flat[p].requires_grad_(False)
            with torch.no_grad():
                for p, g in zip(paths, grads):
                    opt.update_leaf(p, flat[p], g.float(), states[p],
                                    step + 1, float(lr))
        # held-out agreement: fresh rollouts the training never saw
        inputs, soft, labels, mask = make_batch(int(batch))
        with torch.no_grad():
            hits = (self._logits(inputs)[:, :-1].argmax(-1)
                    == labels).float()
            agree = float((hits * mask).sum()
                          / torch.clamp(mask.sum(), min=1.0))
        self.distill_summary = {
            "steps": int(steps), "batch": int(batch), "lr": float(lr),
            "final_loss": float(loss), "top1_agreement": agree,
            "window": W, "vocab_size": int(vocab)}
        return self.distill_summary

    # -- persistence (JAX's .npz artifact) ----------------------------

    def save(self, path: str) -> None:
        """Weights and geometry as one ``.npz``: ``p0..pN`` fp32 in JAX's
        leaf order and ``__meta__`` (JSON bytes), JAX's layout."""
        cfg = self.config
        meta = {"vocab_size": int(cfg.vocab_size),
                "hidden": int(cfg.hidden_size),
                "layers": int(cfg.num_layers),
                "heads": int(cfg.num_heads),
                "window": int(self.window),
                "distill": self.distill_summary}
        arrays = {f"p{i}": leaf.detach().float().cpu().numpy()
                  for i, (_, leaf) in
                  enumerate(jax_leaf_order(self.params))}
        np.savez(path,
                 __meta__=np.frombuffer(json.dumps(meta).encode(),
                                        np.uint8), **arrays)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None
             ) -> "TransformerDrafter":
        """A drafter from a ``.npz`` that this class or JAX's saved."""
        data = np.load(path)
        meta = json.loads(bytes(bytearray(data["__meta__"])))
        d = cls.small(meta["vocab_size"], window=meta["window"],
                      hidden=meta["hidden"], layers=meta["layers"],
                      heads=meta["heads"], device=device)
        with torch.no_grad():
            for i, (where, leaf) in enumerate(jax_leaf_order(d.params)):
                arr = np.asarray(data[f"p{i}"], np.float32)
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{path}: p{i} ({where}) has shape "
                                     f"{arr.shape}, the drafter "
                                     f"{tuple(leaf.shape)}")
                leaf.copy_(torch.from_numpy(arr))
        d.distill_summary = meta.get("distill")
        return d


__all__ = ["Drafter", "DrafterStats", "PromptLookupDrafter",
           "TransformerDrafter", "jax_leaf_order"]
