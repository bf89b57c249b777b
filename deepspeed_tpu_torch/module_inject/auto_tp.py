"""AutoTP: tensor parallelism for parameter trees (port of
``deepspeed_tpu/module_inject/auto_tp.py``).

Reference: ``deepspeed/module_inject/auto_tp.py:194`` classifies each
Linear as column-parallel or row-parallel from its position in attention
or the MLP. Here, as in JAX, a parameter's parallelism is its spec: each
path of a tree (HF-style parameter trees, the zoo's trees, plain dicts)
is classified by the same name policy (q / k / v / gate / up -> column;
o_proj / down / fc2 -> row; embeddings -> vocab-sharded; norms and
biases -> replicated) into a spec, a tuple of mesh axis names (the port's
form of JAX's ``PartitionSpec``). ``AutoEP`` builds on it.
``tp_model_init`` applies the specs: where JAX ``device_put``s each leaf
onto the mesh with its spec, one process is one rank here, and it keeps
this rank's slice of each leaf (a leaf that does not divide stays whole,
with JAX's warning). The zoo models' own tp placement (the engines' TP
path) follows the logical axes and ``runtime/sharding.TP_RULES``, as
JAX's engines do.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

SEP = "."

# column-parallel: the output dim shards over tp
_COLUMN_PATTERNS = [
    r"\bw?q(_proj|_lin|kv)?\b", r"\bw?k(_proj|_lin)?\b",
    r"\bw?v(_proj|_lin)?\b", r"\bquery\b", r"\bkey\b", r"\bvalue\b",
    r"\bqkv\b", r"c_attn", r"\bgate(_proj)?\b", r"\bup(_proj)?\b",
    r"\bfc1\b", r"\bwi(_\d)?\b", r"intermediate", r"c_fc\b",
    r"\bw1\b", r"\bw3\b", r"lin1",
]
# row-parallel: the input dim shards over tp
_ROW_PATTERNS = [
    r"\bw?o(_proj|ut_proj)?\b", r"\bdense\b", r"c_proj", r"\bdown(_proj)?\b",
    r"\bfc2\b", r"\bwo\b", r"\bw2\b", r"lin2", r"attention.output",
    r"output.dense",
]
# vocab / position embeddings: the embedding (vocab) dim shards
_EMBED_PATTERNS = [r"embed", r"\bwte\b", r"\bwpe\b", r"lm_head",
                   r"word_embeddings", r"\btok\b", r"\bpos\b"]
_REPLICATED_PATTERNS = [r"norm", r"\bln\b", r"layernorm", r"\bbias\b",
                        r"\bscale\b", r"\bb\b"]

Spec = Tuple[Optional[str], ...]


class AutoTP:
    """Classify parameter paths into specs over a ``tp`` mesh axis;
    ``register_policy`` adds an architecture's pattern lists."""

    _policies: Dict[str, Dict[str, List[str]]] = {}

    def __init__(self, tp_axis: str = "tp", policy: Optional[str] = None):
        self.tp_axis = tp_axis
        self.column = list(_COLUMN_PATTERNS)
        self.row = list(_ROW_PATTERNS)
        self.embed = list(_EMBED_PATTERNS)
        self.replicated = list(_REPLICATED_PATTERNS)
        if policy is not None:
            extra = self._policies.get(policy.lower())
            if extra is None:
                import logging

                logging.getLogger(__name__).warning(
                    f"AutoTP: no policy '{policy}', using default")
            else:
                self.column += extra.get("column", [])
                self.row += extra.get("row", [])
                self.embed += extra.get("embed", [])
                self.replicated += extra.get("replicated", [])

    @classmethod
    def register_policy(cls, name: str, column=(), row=(), embed=(),
                        replicated=()):
        cls._policies[name.lower()] = {
            "column": list(column), "row": list(row),
            "embed": list(embed), "replicated": list(replicated)}

    @staticmethod
    def _match(path: str, patterns: Sequence[str]) -> bool:
        low = path.lower()
        return any(re.search(p, low) for p in patterns)

    def classify(self, path: str, shape: Tuple[int, ...]) -> str:
        """'column' | 'row' | 'embed' | 'replicated'."""
        if len(shape) < 2 or self._match(path, self.replicated):
            return "replicated"
        if self._match(path, self.embed):
            return "embed"
        if self._match(path, self.column):
            return "column"
        if self._match(path, self.row):
            return "row"
        return "replicated"

    def spec_for(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """The spec of one param: 2-D weights are [in, out]; a stacked
        tensor's leading dims stay whole."""
        kind = self.classify(path, shape)
        lead = (None,) * (len(shape) - 2)
        if kind == "column":
            return (*lead, None, self.tp_axis)
        if kind in ("row", "embed"):
            return (*lead, self.tp_axis, None)
        return (None,) * len(shape)

    def infer_specs(self, params) -> Any:
        """A spec tree mirroring ``params`` (dicts, lists and tuples)."""
        return _walk(params, lambda path, leaf: self.spec_for(
            path, _shape(leaf)))

    def summary(self, params) -> Dict[str, int]:
        counts = {"column": 0, "row": 0, "embed": 0, "replicated": 0}

        def count(path, leaf):
            counts[self.classify(path, _shape(leaf))] += 1

        _walk(params, count)
        return counts


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()) or ())


def _walk(tree, fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}{SEP}{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_walk(v, fn, f"{prefix}{SEP}{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
        return vals if isinstance(tree, list) else tuple(vals)
    return fn(prefix, tree)


def _divisible(shape: Tuple[int, ...], spec: Spec, mesh) -> bool:
    """Every sharded dim of ``shape`` splits over its mesh axis."""
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axis is not None and dim % mesh.shape[axis] != 0:
            return False
    return True


def tp_model_init(params, mesh=None, tp_size: int = 0,
                  policy: Optional[str] = None, dtype=None):
    """This rank's slice of a parameter tree for tensor-parallel
    execution (JAX ``tp_model_init``; reference ``deepspeed.tp_model_init``
    __init__.py:408). ``params`` holds tensors or numpy arrays (a JAX
    tree read as numpy); without ``mesh`` one is built from ``tp_size``
    as JAX does (tp = ``tp_size``, dp the rest of the world's ranks).

    Returns (local params as tensors, spec tree). A leaf whose shape does
    not divide the tp axis stays whole (replicated), with a warning."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.parallel import topology as topo
    from deepspeed_tpu_torch.utils.logging import log_dist, logger

    if mesh is None:
        if tp_size <= 0:
            raise ValueError("tp_model_init needs mesh or tp_size")
        mesh = topo.build_mesh(topo.TopologyConfig(tp=tp_size, dp=-1))
    atp = AutoTP(policy=policy)
    specs = atp.infer_specs(params)
    coords = mesh.coords()

    def place(path, x):
        shape = _shape(x)
        spec = atp.spec_for(path, shape)
        t = torch.from_numpy(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        if dtype is not None:
            t = t.to(dtype)
        if not _divisible(shape, spec, mesh):
            logger.warning(
                f"AutoTP: shape {shape} not divisible by tp axis for spec "
                f"{spec}; replicating")
            return t
        for dim, axis in enumerate(spec):
            if axis is not None and mesh.shape[axis] > 1:
                n = shape[dim] // mesh.shape[axis]
                t = t.narrow(dim, coords[axis] * n, n)
        return t.contiguous()

    local = _walk(params, place)
    log_dist(f"AutoTP over tp={mesh.shape.get('tp', 1)}: "
             f"{atp.summary(params)}", ranks=[0])
    return local, specs


__all__ = ["SEP", "AutoTP", "tp_model_init"]
