"""Fragment APIs: access to the partitioned fp32 masters, optimizer
state and gradients (port of ``deepspeed_tpu/utils/tensor_fragment.py``;
reference ``deepspeed/utils/tensor_fragment.py``).

"Full" is the whole leaf, assembled from every rank's block: those
getters are collectives that every rank calls (ZeRO stages >= 1 on a
process group). "Local" is this rank's block, the slice JAX's device r
holds of the same leaf on an fsdp mesh. Params are addressed by path:
``"layers/attn/wq"``. Results are numpy arrays on the host, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.parallel import topology

# torch optimizer state names -> the port's (optax's) state trees
_STATE_ALIAS = {"exp_avg": ("mu", "trace", "momentum"),
                "exp_avg_sq": ("nu",),
                "momentum": ("trace", "mu")}


def _norm(path: str) -> str:
    return "/" + path.strip("/")


def _walk(tree, path: str):
    node = tree
    for key in path.strip("/").split("/"):
        if not isinstance(node, dict) or key not in node:
            raise KeyError(
                f"param path '{path}': no key '{key}'; available: "
                f"{sorted(node) if isinstance(node, dict) else node}")
        node = node[key]
    return node


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of the live state)."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def _host_tier(engine):
    return engine._zenflow or engine._offload


def _zero(engine):
    """The engine's ZeRO partition of its masters (None where they are
    whole: no process group, or a client optimizer's)."""
    if getattr(engine, "_client_opt", None) is not None:
        return None
    return engine._zero


def _whole(engine, path: str, block: torch.Tensor) -> torch.Tensor:
    """A host tier's block of ``path`` made whole across ranks (through
    the engine's device: NCCL gathers card tensors)."""
    if engine._zero is None:
        return block
    with topology.use_mesh(engine.mesh):
        return engine._zero.full(path, block.to(engine.device))


def safe_get_full_fp32_param(engine, path: str) -> np.ndarray:
    """The whole fp32 master of ``path`` (reference
    tensor_fragment.py:134); offloaded masters are read on the host."""
    path = _norm(path)
    if _host_tier(engine) is not None:
        return _host(_whole(engine, path,
                            _host_tier(engine).full_fp32_param(path)))
    master = _walk(engine.opt_state.master, path)
    if _zero(engine) is None:
        return _host(master)
    with topology.use_mesh(engine.mesh):
        return _host(engine._zero.full(path, master))


def safe_get_local_fp32_param(engine, path: str) -> np.ndarray:
    """This rank's block of the fp32 master of ``path`` (the whole leaf
    where it does not shard)."""
    path = _norm(path)
    if _host_tier(engine) is not None:
        return _host(_host_tier(engine).full_fp32_param(path))
    return _host(_walk(engine.opt_state.master, path))


def safe_set_full_fp32_param(engine, path: str, value) -> None:
    """Overwrite the master of ``path`` with a whole leaf (each rank keeps
    its block) and refresh the compute-dtype param from it."""
    path = _norm(path)
    param = _walk(engine.params, path)
    value = torch.as_tensor(np.asarray(value, dtype=np.float32))
    with torch.no_grad():
        if _host_tier(engine) is not None:
            if engine._zero is not None:
                with topology.use_mesh(engine.mesh):
                    _host_tier(engine).set_full_fp32_param(
                        path, engine._zero.block(path, value))
                    value = engine._zero.block(path, value, "param")
            else:
                _host_tier(engine).set_full_fp32_param(path, value)
            param.copy_(value.to(param.device))
            return
        master = _walk(engine.opt_state.master, path)
        value = value.to(master.device)
        if engine._zero is None:
            master.copy_(value)
            param.copy_(master)
            return
        with topology.use_mesh(engine.mesh):
            master.copy_(value if _zero(engine) is None
                         else engine._zero.block(path, value))
            param.copy_(engine._zero.block(path, value, "param"))


def safe_get_full_optimizer_state(engine, path: str, state_key: str
                                  ) -> Optional[np.ndarray]:
    """Optimizer state ``state_key`` of ``path`` (``exp_avg`` ->
    ``mu``, ``exp_avg_sq`` -> ``nu``, ``momentum`` -> the trace), the
    whole leaf; None when the optimizer keeps no such state."""
    path = _norm(path)
    if _host_tier(engine) is not None:
        got = _host_tier(engine).full_optimizer_state(path, state_key)
        return None if got is None else _host(_whole(engine, path, got))
    trees = engine.opt_state.named_trees()
    master = _walk(engine.opt_state.master, path)
    for name in _STATE_ALIAS.get(state_key, (state_key,)):
        if name not in trees:
            continue
        try:
            t = _walk(trees[name], path)
        except KeyError:
            continue
        if _zero(engine) is None or t.shape != master.shape:
            return _host(t)
        with topology.use_mesh(engine.mesh):
            return _host(engine._zero.full(path, t))
    return None


def safe_get_full_grad(engine, path: str) -> Optional[np.ndarray]:
    """The gradient accumulated between ``backward`` and ``step`` (the
    micro-step path; ``train_batch`` never exposes one), reduced over the
    data ranks as the update will see it. None when there is none."""
    g = engine.full_grad(_norm(path))
    return None if g is None else _host(g)


__all__ = ["safe_get_full_fp32_param", "safe_get_local_fp32_param",
           "safe_set_full_fp32_param", "safe_get_full_optimizer_state",
           "safe_get_full_grad"]
