"""v1-style inference engine: a dense KV cache on one device (port of
``deepspeed_tpu/inference/engine.py``).

``forward`` runs the model's own forward (``apply``), so attention at
``attn_impl="auto"`` goes through the measured kernel dispatch
(``ops/attention.py``). ``generate`` prefills the prompt, bucketed to a
power of two of at least 16 tokens, then decodes one token a step
through ``model_runner.forward_with_cache`` (the dense masked attention
JAX uses there too), greedy or sampled.

Tensor parallelism (``mesh`` with a tp axis, or
``init_inference(tensor_parallel={"tp_size": n})``): one process is one
rank; each keeps its tp slice of the weights (``tp_params``: JAX's
``TP_PARAM_RULES`` over the logical axes; a model built as one tp rank's
slice is taken as is), runs its heads, and the forwards issue the tp
collectives (``runtime/sharding.py``) under the engine's mesh, so every
rank gets the whole logits and samples the same tokens. As in JAX, tp
must divide both head counts and ``quantize_weights`` refuses tp > 1.

Differences from JAX: sampling draws from a ``torch.Generator`` seeded by ``seed`` (JAX's
``jax.random`` gives other draws; greedy decoding is the same); the
engine runs on the model's device and, as the v2 engine does,
``quantize_weights="int8"`` takes over the tree it quantizes (each
leaf's full-precision storage is freed once its codes exist).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference import model_runner
from deepspeed_tpu_torch.inference.weight_quant import (QuantizedTensor,
                                                        quantize_params)
from deepspeed_tpu_torch.parallel.topology import on_mesh


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def check_tp(cfg, mesh, quantize_weights: Optional[str]) -> int:
    """The mesh's tp size after JAX's checks (``engine.py:58-75``): tp
    divides both head counts, and weight-only int8 serves at tp 1 only."""
    tp = 1 if mesh is None else mesh.shape.get("tp", 1)
    for name, heads in (("num_heads", cfg.num_heads),
                        ("kv_heads", cfg.kv_heads)):
        if heads % tp:
            raise ValueError(
                f"tp={tp} does not divide {name}={heads}: the TP "
                "placement shards the head axes evenly (reference "
                "AutoTP has the same constraint); lower tp or use "
                "a model whose head counts divide")
    if quantize_weights is not None and quantize_weights != "int8":
        raise ValueError(
            f"quantize_weights supports 'int8', got {quantize_weights!r}")
    if quantize_weights is not None and tp > 1:
        raise ValueError(
            "quantize_weights does not compose with tp>1 yet "
            "(blockwise payloads have an extra rank the TP "
            "specs don't cover); serve unquantized or tp=1")
    return tp


def tp_params(model, params, mesh):
    """This rank's tp slice of ``params`` (the model's tree; a leaf that
    is the slice already is kept): each leaf that ``TP_RULES`` shards
    over the logical axes is narrowed to the mesh's tp index."""
    from deepspeed_tpu_torch.models.transformer import leaf_shapes, tp_dims
    from deepspeed_tpu_torch.runtime.sharding import tp_local

    n = mesh.shape["tp"]
    index = mesh.axis_index("tp")
    dims = tp_dims(model.logical_axes(model.config))
    full = leaf_shapes(model.param_shapes(model.config))

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        d = dims.get(path)
        return node if d is None else tp_local(node, d, full[path][d], n,
                                               index)

    return walk(params, "")


class InferenceEngine:
    """Generate-capable engine over a ``TransformerLM`` (or an
    ``MoETransformerLM``).

    API parity with JAX: ``forward`` (logits), ``generate``. ``params``
    is the port's tree (``model.params()``, the default) or a JAX tree
    read leaf by leaf as numpy (``models/convert.params_from_jax``);
    ``dtype`` is the dense cache's type, as in JAX. ``seed`` is accepted
    for JAX's signature (JAX initialises the weights from it when
    ``params`` is None; a port model carries its own seeded weights).
    ``mesh`` (default: the global mesh) with a tp axis serves this rank's
    tp slice."""

    def __init__(self, model, mesh: Optional[Any] = None,
                 params: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.bfloat16, max_batch: int = 8,
                 max_seq_len: Optional[int] = None, seed: int = 0,
                 quantize_weights: Optional[str] = None):
        from deepspeed_tpu_torch.parallel import topology as topo

        self.mesh = mesh if mesh is not None else topo._GLOBAL_MESH
        self.tp = check_tp(model.config, self.mesh, quantize_weights)
        self.model = model
        self.cfg = model.config
        self.device = model.device
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len or self.cfg.max_seq_len
        self._dtype = dtype
        del seed
        if params is None:
            params = model.params()
        elif not isinstance(_first_leaf(params),
                            (torch.Tensor, QuantizedTensor)):
            from deepspeed_tpu_torch.models.convert import params_from_jax

            params = params_from_jax(params, self.cfg,
                                     device=self.device).params()
        leaf = _first_leaf(params)
        where = leaf.q.device if isinstance(leaf, QuantizedTensor) \
            else leaf.device
        if where != self.device:
            raise ValueError(f"params live on {where}, the model on "
                             f"{self.device}")
        if self.tp > 1:
            params = tp_params(model, params, self.mesh)
        if quantize_weights is not None:
            # weight-only int8: eligible leaves become int8 blocks
            # (the blockwise quantize kernel on the card), dequantized
            # at each use (the dequantize kernel)
            params = quantize_params(params)
        self.params = params

    # -- API --------------------------------------------------------------

    @torch.no_grad()
    @on_mesh
    def forward(self, tokens) -> torch.Tensor:
        """Full-sequence logits [B, S, V] fp32 (no cache), through the
        model's forward."""
        tokens = torch.as_tensor(np.asarray(tokens, np.int32),
                                 device=self.device)
        if tokens.dim() == 1:
            tokens = tokens[None]
        return self.model.apply(self.params, tokens)

    __call__ = forward

    @on_mesh
    def generate(self, tokens, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, eos_token_id: Optional[int] = None
                 ) -> np.ndarray:
        """Greedy or top-k sampling with a dense KV cache.

        tokens: [B, S] prompt (list or array). Returns np.ndarray
        [B, S + max_new_tokens] int32 (right-padded with eos where every
        row stopped early)."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        B, S = tokens.shape
        if B > self.max_batch:
            raise ValueError(f"batch {B} > max_batch {self.max_batch}")
        total = S + max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(f"prompt + new tokens ({total}) > max_seq_len "
                             f"({self.max_seq_len})")

        # bucket the prompt length (JAX bounds its compilations so; here
        # the same padding keeps the prefill's shapes, and so its numbers,
        # those of the JAX engine)
        bucket = max(16, 1 << (S - 1).bit_length())
        bucket = min(bucket, self.max_seq_len)
        padded = np.zeros((B, bucket), np.int32)
        padded[:, :S] = tokens

        cache = model_runner.init_dense_cache(
            self.cfg, B, self.max_seq_len, self._dtype, self.device)
        logits, cache = model_runner.forward_with_cache(
            self.cfg, self.params, torch.from_numpy(padded).to(self.device),
            cache, 0)
        # rows past S hold the padding's K/V; decode overwrites row S
        # first and masks keys past each query, so they are never read
        next_logits = logits[:, S - 1]  # [B, V]

        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        out = [tokens]
        done = np.zeros(B, bool)
        cur_pos = S
        for _ in range(max_new_tokens):
            nxt_np = _sample(next_logits, temperature, top_k,
                             gen).cpu().numpy().astype(np.int32)
            if eos_token_id is not None:
                nxt_np = np.where(done, eos_token_id, nxt_np)
                done |= nxt_np == eos_token_id
            out.append(nxt_np[:, None].astype(np.int32))
            if eos_token_id is not None and done.all():
                break
            logits, cache = model_runner.forward_with_cache(
                self.cfg, self.params,
                torch.from_numpy(nxt_np[:, None]).to(self.device), cache,
                cur_pos)
            next_logits = logits[:, 0]
            cur_pos += 1

        result = np.concatenate(out, axis=1)
        if result.shape[1] < total and eos_token_id is not None:
            pad = np.full((B, total - result.shape[1]), eos_token_id,
                          np.int32)
            result = np.concatenate([result, pad], axis=1)
        return result


def _masked_logits(logits: torch.Tensor, temperature: float,
                   top_k: int) -> torch.Tensor:
    """JAX ``_sample``'s logits before the draw: divided by the
    temperature, and -1e30 below the k-th largest where top_k > 0."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    return logits


def _sample(logits: torch.Tensor, temperature: float, top_k: int,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature <= 0: the first maximum, as ``jnp.argmax``)
    or one categorical draw a row by the Gumbel-max rule that
    ``jax.random.categorical`` uses, with ``generator``'s uniforms."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _masked_logits(logits, temperature, top_k)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def init_inference(model=None, tensor_parallel: Optional[Dict] = None,
                   dtype: torch.dtype = torch.bfloat16, max_batch: int = 8,
                   max_seq_len: Optional[int] = None,
                   mesh: Optional[Any] = None, params=None,
                   **kwargs) -> InferenceEngine:
    """``deepspeed.init_inference`` counterpart (JAX ``init_inference``).

    model: a ``TransformerLM`` or a model-zoo name (built on the card).
    tensor_parallel: {"tp_size": N} builds a tp mesh over the world's
    ranks when neither ``mesh`` nor a global mesh is given, as in JAX."""
    from deepspeed_tpu_torch.parallel import topology as topo

    if isinstance(model, str):
        from deepspeed_tpu_torch.models.zoo import get_model

        model = get_model(model)
    tp_size = (tensor_parallel or {}).get("tp_size", 1)
    if mesh is None:
        mesh = topo._GLOBAL_MESH
    if mesh is None:
        mesh = topo.build_mesh(topo.TopologyConfig(dp=-1, tp=tp_size))
    return InferenceEngine(model, mesh=mesh, params=params, dtype=dtype,
                           max_batch=max_batch, max_seq_len=max_seq_len,
                           **kwargs)


__all__ = ["InferenceEngine", "init_inference", "check_tp", "tp_params"]
