"""One rank of the port's multi-process CPU tests (gloo).

Usage: python torch_dist_worker.py MODES WORKDIR RANK WORLD

Joins a gloo process group of WORLD ranks through a file store under
WORKDIR (no TCP port), runs each mode of the comma-separated MODES on the
inputs the test wrote to ``WORKDIR/inputs.pt``, writes what it measured
to ``WORKDIR/out_<rank>.pt`` and leaves the group. It imports torch and
the port only (never JAX); the tests hold its results against JAX.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from deepspeed_tpu_torch import comm  # noqa: E402
from deepspeed_tpu_torch.runtime.optimizer import leaves  # noqa: E402

PG_TIMEOUT_S = 120


class WarningRecorder(logging.Handler):
    """The messages of the warnings logged while it is attached."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _port_model(inp):
    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.models.convert import params_from_jax

    if inp["preset"] is None:
        from deepspeed_tpu_torch.models.transformer import TransformerConfig

        cfg = TransformerConfig(dtype=torch.float32, **inp["model_kw"])
    else:
        cfg = zoo.get_config(inp["preset"], dtype=torch.float32,
                             **inp["model_kw"])
    return params_from_jax(inp["params"], cfg, device="cpu")


def _rows(batch, rank, world):
    from deepspeed_tpu_torch.parallel.topology import BatchSlice

    return BatchSlice(rank, world).take(batch)


def _engine(inp, stage, extra=None, **kw):
    import deepspeed_tpu_torch

    config = {**inp["config"], "zero_optimization": {"stage": stage},
              **(extra or {})}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=kw.pop("model", None) or _port_model(inp), config=config,
        device="cpu", **kw)
    return engine


def _masters(engine, paths):
    from deepspeed_tpu_torch.utils import tensor_fragment as tfr

    full = {p: tfr.safe_get_full_fp32_param(engine, p) for p in paths}
    local = {p: tfr.safe_get_local_fp32_param(engine, p) for p in paths}
    moments = {p: (tfr.safe_get_full_optimizer_state(engine, p, "exp_avg"),
                   tfr.safe_get_full_optimizer_state(engine, p,
                                                     "exp_avg_sq"))
               for p in paths}
    return full, local, moments


def _paths(engine):
    return [p.strip("/") for p, _ in leaves(engine.opt_state.master)]


def mode_zero(inp, rank, world, out):
    """Each stage over ``inp["stages"]`` on both APIs: losses, the full and
    local masters, the moments and the comms logger's counts."""
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger

    gas = inp["config"]["gradient_accumulation_steps"]
    batches = [_rows(b, rank, world) for b in inp["batches"]]
    steps = len(batches) // gas
    res = {}
    for stage in inp["stages"]:
        for api in ("train_batch", "micro"):
            engine = _engine(inp, stage,
                             extra={"comms_logger": {"enabled": True}})
            get_comms_logger().reset()
            losses = []
            for s in range(steps):
                mbs = batches[s * gas:(s + 1) * gas]
                if api == "train_batch":
                    losses.append(float(engine.train_batch(iter(mbs))))
                    continue
                for mb in mbs:
                    loss = engine(mb)
                    engine.backward(loss)
                    engine.step()
                losses.append(float(engine.last_metrics["loss"]))
            counts = dict(get_comms_logger().counts())
            full, local, moments = _masters(engine, _paths(engine))
            res[(stage, api)] = {"losses": losses, "full": full,
                                 "local": local, "moments": moments,
                                 "counts": counts}
            del engine
    if world == 2:  # a (loss_fn, params) model gathers its whole tree
        res[3, "loss_fn"] = _fn_run(inp, batches, gas, steps)
    out["zero"] = res


def _fn_run(inp, batches, gas, steps):
    """Stage 3 with the model as a ``(loss_fn, params)`` pair over the
    functional forward (JAX's fallback axes: dim 0 of each leaf)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf

    model = _port_model(inp)
    cfg = model.config
    config = {**inp["config"], "zero_optimization": {"stage": 3}}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=lambda p, b: tf.loss_fn(cfg, p, b),
        model_parameters=model.params(), config=config, device="cpu")
    losses = [float(engine.train_batch(iter(batches[s * gas:(s + 1) * gas])))
              for s in range(steps)]
    full, _, _ = _masters(engine, _paths(engine))
    return {"losses": losses, "full": full,
            "fetch": engine._fetch is not None}


def mode_raises(inp, rank, world, out):
    """What is not ported across ranks raises NotImplementedError naming
    its ROADMAP item."""
    from deepspeed_tpu_torch.models import zoo

    tp = {"tp": world, "dp": 1}
    # the host tiers and the whole-leaf optimizers run on dp x fsdp; at
    # tp they raise
    cases = {
        "offload": lambda: _engine(inp, 3, extra={"zero_optimization": {
            "stage": 3, "offload_optimizer": {"device": "cpu"}}},
            topology=tp),
        "zenflow": lambda: _engine(inp, 3, extra={"zero_optimization": {
            "stage": 3, "offload_optimizer": {"device": "cpu"},
            "zenflow": {"topk_ratio": 0.1}}}, topology=tp),
        "moe": lambda: _engine(inp, 3, model=zoo.get_model(
            "tiny-moe", device="cpu", dtype=torch.float32,
            vocab_size=256, hidden_size=64, num_layers=1, num_heads=4,
            max_seq_len=64), extra={"moe": {"enabled": True}},
            topology={"tp": world, "dp": 1}),
        "tp": lambda: _engine(inp, 3, topology={"tp": world, "dp": 1}),
        "qgz_offload": lambda: _engine(inp, 3, extra={"zero_optimization": {
            "stage": 3, "zero_quantized_gradients": True,
            "offload_optimizer": {"device": "cpu"}}}, topology=tp),
        "lamb": lambda: _engine(inp, 2, extra={"optimizer": {
            "type": "lamb", "params": {"lr": 1e-3}}}, topology=tp),
        "client": lambda: _client_engine(inp, topology=tp),
        "offload_sp": lambda: _engine(inp, 2, extra={"zero_optimization": {
            "stage": 2, "offload_optimizer": {"device": "cpu"}}},
            topology={"sp": world, "dp": 1}),
        "zenflow_pp": lambda: _engine(inp, 2, extra={"zero_optimization": {
            "stage": 2, "offload_optimizer": {"device": "cpu"},
            "zenflow": {"topk_ratio": 0.1}}},
            topology={"pp": world, "dp": 1}),
    }
    got = {}
    for name, build in cases.items():
        try:
            build()
            got[name] = None
        except NotImplementedError as e:
            got[name] = str(e)
    out["raises"] = got


def _client_engine(inp, **kw):
    model = _port_model(inp)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    return _engine(inp, 1, model=model, optimizer=opt, **kw)


def mode_ckpt(inp, rank, world, out):
    """Load the world-size-1 checkpoint (the masters and moments must be
    its own, bit for bit, and the load counted as a reshard), train one
    more step and save at this world size."""
    from deepspeed_tpu_torch.utils import telemetry

    ck = inp["ckpt"]
    engine = _engine(inp, ck["stage"])
    telemetry.reset()
    engine.load_checkpoint(ck["load_dir"])
    paths = _paths(engine)
    full, _, moments = _masters(engine, paths)
    loaded = {"full": full, "moments": moments,
              "resharded": telemetry.get("resilience.resharded_restore"),
              "global_steps": engine.global_steps}
    gas = inp["config"]["gradient_accumulation_steps"]
    mbs = [_rows(b, rank, world) for b in inp["batches"][:gas]]
    loaded["loss_after"] = float(engine.train_batch(iter(mbs)))
    engine.save_checkpoint(ck["save_dir"])
    full, _, moments = _masters(engine, paths)
    out["ckpt"] = {"loaded": loaded, "saved": {"full": full,
                                               "moments": moments}}


def mode_comm(inp, rank, world, out):
    """Each collective of ``comm`` on the inputs' per-rank arrays over the
    fsdp axis, the probes and the cross-process assert."""
    from deepspeed_tpu_torch.parallel import topology
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger

    topology.set_global_mesh(topology.build_mesh({"dp": 1, "fsdp": world}))
    logger = get_comms_logger()
    logger.enabled = True
    logger.reset()
    x = torch.as_tensor(inp["x"][rank])
    res = {
        "all_reduce_sum": comm.all_reduce(x, "fsdp"),
        "all_reduce_mean": comm.all_reduce(x, "fsdp", op="avg"),
        "all_reduce_max": comm.all_reduce(x, "fsdp", op="max"),
        "all_gather": comm.all_gather(x, "fsdp"),
        "all_gather_dim1": comm.all_gather(x, "fsdp", gather_dim=1),
        "all_gather_stacked": comm.all_gather(x, "fsdp", tiled=False),
        "reduce_scatter": comm.reduce_scatter(x, "fsdp"),
        "reduce_scatter_dim1": comm.reduce_scatter(x, "fsdp",
                                                   scatter_dim=1),
        "all_to_all": comm.all_to_all(x, "fsdp", split_dim=1,
                                      concat_dim=0),
        "ppermute": comm.ppermute(x, "fsdp", [(i, (i + 1) % world)
                                              for i in range(world)]),
        "broadcast": comm.broadcast(x, "fsdp", root=1),
        "logged": (dict(logger.counts()), dict(logger.totals())),
        "axis_index": comm.axis_index("fsdp"),
        "axis_size": comm.axis_size("fsdp"),
        "probes": (comm.has_all_gather_into_tensor(),
                   comm.has_reduce_scatter_tensor(),
                   comm.has_coalescing_manager()),
        "any_process": (comm.any_process(rank == world - 1),
                        comm.any_process(False)),
    }
    comm.assert_same_across_processes("same", [3, "tag"])
    try:
        comm.assert_same_across_processes("diverging", [rank])
        res["diverging"] = None
    except RuntimeError as e:
        res["diverging"] = str(e)
    comm.barrier()
    out["comm"] = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                   for k, v in res.items()}


def mode_sparse(inp, rank, world, out):
    """``sparse_allreduce`` of each rank's embedding gradient over dp."""
    from deepspeed_tpu_torch.parallel import topology
    from deepspeed_tpu_torch.runtime.sparse_tensor import sparse_allreduce

    topology.set_global_mesh(topology.build_mesh({"dp": world}))
    out["sparse"] = sparse_allreduce(
        torch.as_tensor(inp["grads"][rank]),
        torch.as_tensor(inp["tokens"][rank])).numpy()


def mode_fragments(inp, rank, world, out):
    """JAX's fragment cases (tests/test_fragments.py) at this world size."""
    from deepspeed_tpu_torch.utils import tensor_fragment as tfr

    engine = _engine(inp, 3)
    res = {"wq_full": tfr.safe_get_full_fp32_param(engine, "layers/attn/wq"),
           "wi_full": tfr.safe_get_full_fp32_param(engine, "layers/mlp/wi"),
           "wi_local": tfr.safe_get_local_fp32_param(engine,
                                                     "layers/mlp/wi")}
    tfr.safe_set_full_fp32_param(
        engine, "final_norm/scale",
        np.full(inp["model_kw"]["hidden_size"], 2.0, np.float32))
    res["scale_full"] = tfr.safe_get_full_fp32_param(engine,
                                                     "final_norm/scale")
    res["scale_param"] = engine.params["final_norm"]["scale"].detach() \
        .float().numpy().copy()
    batch = _rows(inp["batches"][0], rank, world)
    engine.train_batch(iter([batch]))
    res["mu"] = tfr.safe_get_full_optimizer_state(engine, "layers/attn/wq",
                                                  "exp_avg")
    res["nu"] = tfr.safe_get_full_optimizer_state(engine, "layers/attn/wq",
                                                  "exp_avg_sq")
    res["grad_before"] = tfr.safe_get_full_grad(engine, "layers/attn/wq")
    engine.backward(engine(batch))
    res["grad"] = tfr.safe_get_full_grad(engine, "layers/attn/wq")
    engine.step()
    res["grad_after"] = tfr.safe_get_full_grad(engine, "layers/attn/wq")
    try:
        tfr.safe_get_full_fp32_param(engine, "layers/nope/wq")
        res["bad_path"] = None
    except KeyError as e:
        res["bad_path"] = str(e)
    out["fragments"] = res


def mode_quant_coll(inp, rank, world, out):
    """The quantized collectives on this rank's ``coll_x`` over a dp mesh
    of the world, int8 and int4: their outputs and the wire bytes the
    comms logger recorded."""
    from deepspeed_tpu_torch.ops import quantization as qz
    from deepspeed_tpu_torch.parallel import topology
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger

    topology.set_global_mesh(topology.build_mesh({"dp": world}))
    log = get_comms_logger()
    log.enabled = True
    x = torch.as_tensor(inp["coll_x"][rank])
    res = {}
    for bits in (8, 4):
        log.reset()
        res[bits] = {
            "gather": qz.quantized_all_gather(x, "dp", bits=bits,
                                              block=inp["block"]),
            "scatter": qz.quantized_psum_scatter(x, "dp", bits=bits,
                                                 block=inp["block"]),
            "all_reduce": qz.quantized_all_reduce(x, "dp", bits=bits,
                                                  block=inp["block"]),
            "bytes": dict(log.totals())}
    log.enabled = False
    topology.set_global_mesh(None)
    out["quant_coll"] = res


def _run_model(inp, spec):
    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.models.convert import params_from_jax

    over = spec.get("model_over", {})
    if spec.get("seeded"):
        # the preset drawn from seed 0: whole, or ("tp") built as this
        # rank's tp slice of the same draw
        from deepspeed_tpu_torch.parallel.topology import build_mesh

        tp = None
        if spec["seeded"] == "tp":
            mesh = build_mesh(spec["topology"])
            tp = (mesh.axis_index("tp"), mesh.shape["tp"])
        return zoo.get_model(inp["preset"], device="cpu", seed=0, tp=tp,
                             dtype=torch.float32,
                             **{**inp["model_kw"], **over})
    if spec.get("model"):  # a model of the run's own (preset, kw, params)
        preset, kw, params = spec["model"]
        return _port_model(dict(inp, preset=preset, model_kw=kw,
                                params=inp["params_by"][params]))
    if spec.get("moe"):
        cfg = zoo.get_config("tiny-moe", dtype=torch.float32,
                             **{**inp["moe_kw"], **over})
        return params_from_jax(inp["moe_params"], cfg, device="cpu")
    if over or "params" in spec:
        return _port_model(dict(inp, model_kw={**inp["model_kw"], **over},
                                params=inp["params_by"][spec["params"]]
                                if "params" in spec else inp["params"]))
    return _port_model(inp)


def mode_engines(inp, rank, world, out):
    """Each run of ``inp["runs"]`` (a name, the config over the shared
    one, a topology, steps, and what else to do): its losses, the full
    params after, the telemetry counts, the comms logger's bytes and
    counts by log name, the warnings the package logged, and the
    quantize / dequantize launches (plain versions count none on the
    CPU). A run with ``raises`` records the exception its build or first
    step raised (type name, message) instead."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.topology import batch_sharding
    from deepspeed_tpu_torch.utils import telemetry
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger

    res = {}
    from deepspeed_tpu_torch.runtime import param_stream

    pkg_log = logging.getLogger("deepspeed_tpu_torch")
    for spec in inp["runs"]:
        if world not in spec.get("worlds", (world,)):
            continue
        if spec.get("raises"):
            try:
                _engine_run(inp, spec)
                res[spec["name"]] = {"raised": None}
            except (NotImplementedError, ValueError) as e:
                res[spec["name"]] = {"raised": (type(e).__name__, str(e))}
            continue
        from deepspeed_tpu_torch.runtime import zeropp

        # the flat step's collectives in chunks of this many elements
        chunk_elems = zeropp.CHUNK_ELEMS
        zeropp.CHUNK_ELEMS = spec.get("chunk_elems") or chunk_elems
        warned = WarningRecorder()
        pkg_log.addHandler(warned)
        telemetry.reset()
        param_stream.reset_fetch_stats()
        config = {**inp["config"], **spec["config"],
                  "comms_logger": {"enabled": True}}
        off = config.get("zero_optimization", {}).get("offload_optimizer")
        if off and off.get("nvme_path") == "@nvme":  # one path a run
            config["zero_optimization"] = dict(
                config["zero_optimization"], offload_optimizer=dict(
                    off, nvme_path=os.path.join(inp["workdir"],
                                                "nvme_" + spec["name"])))
        topology = spec.get("topology") or inp.get("topology")
        kw = {}
        if spec.get("client"):  # a client torch.optim.AdamW at this lr
            kw["optimizer"] = lambda ps: torch.optim.AdamW(
                ps, lr=spec["client"])
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=_run_model(inp, spec), config=config, device="cpu",
            topology=topology, **kw)
        get_comms_logger().reset()
        batches = inp[spec.get("batches", "moe_batches" if spec.get("moe")
                               else "batches")]
        mesh = engine.mesh
        # this rank's rows over the data axes (and its sequence block
        # over sp, cut after the next-token shift)
        rows = batch_sharding(mesh)
        gas = engine.gradient_accumulation_steps
        mine = [rows.take(b) for b in batches]
        steps = spec.get("steps", len(mine) // gas)
        losses, metrics = [], []
        for s in range(steps):
            if spec.get("set_lr_at") is not None and \
                    s == spec["set_lr_at"][0]:
                engine.set_lr(spec["set_lr_at"][1])
            mbs = mine[(s * gas) % len(mine):][:gas]
            losses.append(float(engine.train_batch(iter(mbs))))
            metrics.append({k: float(v) for k, v in
                            engine.last_metrics.items()
                            if isinstance(v, torch.Tensor) and v.numel() == 1})
        pkg_log.removeHandler(warned)
        zeropp.CHUNK_ELEMS = chunk_elems
        rec = {"losses": losses, "metrics": metrics,
               "warnings": warned.messages,
               "params": engine.module_state_dict(),
               "telemetry": telemetry.snapshot(),
               "bytes": dict(get_comms_logger().totals()),
               "counts": dict(get_comms_logger().counts()),
               "mesh": dict(mesh.shape),
               "flags": {k: bool(getattr(engine, k, False)) for k in
                         ("_zeropp", "_onebit", "_qwz_stage3",
                          "_qgz_stage3")}}
        if engine._quant_step is not None:  # the 1-bit momentum, whole
            part = engine._onebit_part
            rec["onebit_m"] = {
                path.strip("/"): (m if part is None else part.full(
                    path, m, "param")).numpy()
                for path, m in engine._quant_step.state.m.items()}
        rec["resident_gathers"] = param_stream.RESIDENT_STATS["gathers"]
        rec["local_shapes"] = {path: tuple(t.shape)
                               for path, t in leaves(engine.params)}
        if spec.get("masters"):  # the gathered fp32 masters
            from deepspeed_tpu_torch.utils import tensor_fragment as tfr

            rec["masters"] = {p.strip("/"): tfr.safe_get_full_fp32_param(
                engine, p) for p, _ in leaves(engine.params)}
        tier = engine._zenflow or engine._offload
        if tier is not None:
            rec["host"] = _host_tier_record(engine, tier)
        rec["model"] = {k: getattr(engine.model_config, k, None) for k in
                        ("sequence_parallel", "sp_mode", "attn_chunks")}
        if spec.get("moe"):
            rec["local_experts"] = int(
                engine.params["layers"]["moe"]["experts"]["wi"].shape[1])
        if spec.get("ckpt"):
            d = os.path.join(inp["workdir"], spec["name"])
            engine.save_checkpoint(d)
            more = [float(engine.train_batch(iter(mine[:gas])))
                    for _ in range(2)]
            fresh, *_ = deepspeed_tpu_torch.initialize(
                model=_run_model(inp, spec), config=config, device="cpu",
                topology=topology, **kw)
            fresh.load_checkpoint(d)
            again = [float(fresh.train_batch(iter(mine[:gas])))
                     for _ in range(2)]
            reseed, *_ = deepspeed_tpu_torch.initialize(
                model=_run_model(inp, spec), config=config, device="cpu",
                topology=topology, **kw)
            reseed.load_checkpoint(d, load_optimizer_states=False)
            rec["ckpt"] = {"more": more, "again": again,
                           "reseed_params": reseed.module_state_dict(),
                           "saved_params": rec["params"]}
            if spec.get("load_at"):  # the save onto another mesh
                other, *_ = deepspeed_tpu_torch.initialize(
                    model=_run_model(inp, spec), config=config,
                    device="cpu", topology=spec["load_at"])
                other.load_checkpoint(d)
                rec["ckpt"]["load_at_params"] = other.module_state_dict()
                rec["ckpt"]["load_at_mesh"] = dict(other.mesh.shape)
                rec["ckpt"]["files"] = sorted(os.listdir(os.path.join(
                    d, "global_step%d" % steps, "state", "params", "layers",
                    "attn")))
                del other
        res[spec["name"]] = rec
        del engine
    out["engines"] = res


def _engine_run(inp, spec):
    """Build ``spec``'s engine and train one step on this rank's rows of
    the first global batch."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.topology import batch_sharding

    kw = {}
    if spec.get("client"):
        kw["optimizer"] = lambda ps: torch.optim.AdamW(ps, lr=spec["client"])
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_run_model(inp, spec), config={**inp["config"],
                                             **spec["config"]},
        device="cpu", topology=spec.get("topology"), **kw)
    batches = inp[spec.get("batches", "batches")]
    rows = batch_sharding(engine.mesh)
    gas = engine.gradient_accumulation_steps
    engine.train_batch(iter([rows.take(b) for b in batches[:gas]]))


def _host_tier_record(engine, tier):
    """What a host tier holds on this rank: its blocks' shapes, the NVMe
    swap folder and its files, ZenFlow's counts and selections."""
    from deepspeed_tpu_torch.runtime import param_stream

    rec = {"step_s": dict(getattr(tier, "last_step_s", {}) or {}),
           "fetched_layers": param_stream.FETCH_STATS["layers"]}
    if engine._offload is not None:
        rec["shapes"] = {p: tuple(s) for p, s in tier.shapes.items()}
        folder = getattr(tier, "swap_folder", None)
        if folder is not None:
            rec["swap_folder"] = folder
            rec["swap_files"] = len(os.listdir(folder))
    else:
        rec["counts"] = dict(tier.counts)
        rec["shapes"] = dict(zip(tier.paths, tier.shapes))
        rec["idx"] = {p: tier.global_indices(i).cpu()
                      for i, p in enumerate(tier.paths)}
    return rec


def _attn_fn(topology, case, rank):
    """One attention case of ``mode_sp_fn`` on this rank's blocks: the
    output and the gradients of q, k and v against ``proj``."""
    from deepspeed_tpu_torch.parallel.ring_attention import ring_attention
    from deepspeed_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = topology._GLOBAL_MESH
    sp, tp = mesh.shape["sp"], mesh.shape["tp"]
    si, ti = mesh.axis_index("sp"), mesh.axis_index("tp")
    S = case["q"].shape[1]
    s_loc = -(-S // sp)

    def block(a, heads=True):
        a = np.asarray(a)
        if a.shape[1] < s_loc * sp:  # the padding to the ring size
            pad = [(0, 0)] * a.ndim
            pad[1] = (0, s_loc * sp - a.shape[1])
            a = np.pad(a, pad)
        a = a[:, si * s_loc:(si + 1) * s_loc]
        if heads and a.ndim == 4:
            n = a.shape[2] // tp
            a = a[:, :, ti * n:(ti + 1) * n]
        return np.ascontiguousarray(a)

    q, k, v = (torch.tensor(block(case[n]), requires_grad=True)
               for n in ("q", "k", "v"))
    seg = None if case.get("seg") is None else \
        torch.tensor(block(case["seg"], heads=False))
    if case["kind"] == "ulysses":
        out = ulysses_attention(q, k, v, causal=case["causal"], impl="xla",
                                segment_ids=seg)
    else:
        out = ring_attention(q, k, v, causal=case["causal"],
                             segment_ids=seg,
                             seq_len=S if S % sp else None)
    (out * torch.tensor(block(case["proj"]))).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy(), "sp_index": si,
            "tp_index": ti, "s_loc": s_loc}


def mode_sp_fn(inp, rank, world, out):
    """Ulysses and ring attention on each case's mesh (sp, or tp x sp) at
    this world size: each rank's output block and gradients, the comms
    logger's counts and the ring's dense-fallback count."""
    from deepspeed_tpu_torch.parallel import topology
    from deepspeed_tpu_torch.utils import telemetry
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger

    res = {}
    log = get_comms_logger()
    for case in inp["sp_cases"]:
        if world not in case.get("worlds", (world,)):
            continue
        topology.set_global_mesh(topology.build_mesh(case["mesh"]))
        log.enabled = True
        log.reset()
        telemetry.reset()
        res[case["name"]] = _attn_fn(topology, case, rank)
        res[case["name"]]["counts"] = dict(log.counts())
        res[case["name"]]["fallback"] = telemetry.get(
            "ring_attention.dense_fallback")
        log.enabled = False
        topology.set_global_mesh(None)
    out["sp_fn"] = res


def mode_pp_fn(inp, rank, world, out):
    """``pipelined_layers`` of JAX's test layer (tanh(c @ w) + c) over each
    case's pp mesh: the output and the gradients of this stage's
    layers and of x against ``proj``."""
    from deepspeed_tpu_torch.parallel import topology
    from deepspeed_tpu_torch.parallel.pipeline import pipelined_layers

    res = {}
    for case in inp["pp_cases"]:
        if world not in case.get("worlds", (world,)):
            continue
        topology.set_global_mesh(topology.build_mesh(case["mesh"]))
        mesh = topology._GLOBAL_MESH
        pp, stage = mesh.shape["pp"], mesh.axis_index("pp")
        L = case["w"].shape[0]
        w = torch.tensor(case["w"][stage * L // pp:(stage + 1) * L // pp],
                         requires_grad=True)
        rows = topology.batch_sharding(mesh)
        x = torch.tensor(rows.take(case["x"]), requires_grad=True)
        y = pipelined_layers(lambda c, wl: torch.tanh(c @ wl) + c, w, x,
                             **case["kw"])
        (y * torch.tensor(rows.take(case["proj"]))).sum().backward()
        res[case["name"]] = {"out": y.detach().numpy(),
                             "dw": w.grad.numpy(), "dx": x.grad.numpy(),
                             "stage": stage,
                             "data_index": mesh.axis_index(
                                 ("dp", "fsdp", "ep"))}
        topology.set_global_mesh(None)
    out["pp_fn"] = res


def mode_sp_raises(inp, rank, world, out):
    """What stays out at sp > 1 or pp > 1 raises: each case's exception
    type and message; a case that builds and trains a step records
    ("trained", the warnings the package logged, its ZeRO++ flags)."""
    import deepspeed_tpu_torch

    batch = inp["batches"][0]
    trained = {}

    def engine(over=None, extra=None, topology=None, optimizer=None):
        spec = {"model_over": over} if over else {}
        warned = WarningRecorder()
        log = logging.getLogger("deepspeed_tpu_torch")
        log.addHandler(warned)
        try:
            eng, *_ = deepspeed_tpu_torch.initialize(
                model=_run_model(inp, spec),
                config={**inp["config"], **(extra or {})}, device="cpu",
                topology=topology, optimizer=optimizer)
        finally:
            log.removeHandler(warned)
        from deepspeed_tpu_torch.parallel.topology import batch_sharding

        eng.train_batch(iter([batch_sharding(eng.mesh).take(batch)]))
        trained["last"] = ("trained", "\n".join(warned.messages), {
            k: bool(getattr(eng, k, False)) for k in
            ("_zeropp", "_onebit", "_qwz_stage3", "_qgz_stage3")})

    sp = {"sp": world, "dp": 1}
    pp = {"pp": world, "dp": 1}
    seq = {"sequence_parallel": True}
    cases = {
        "qwz_sp": lambda: engine(seq, {"zero_optimization": {
            "stage": 3, "zero_quantized_weights": True}}, sp),
        "qgz_pp": lambda: engine(None, {"zero_optimization": {
            "stage": 2, "zero_quantized_gradients": True}}, pp),
        "onebit_sp": lambda: engine(seq, {"optimizer": {
            "type": "onebitadam", "params": {"lr": 1e-3}}}, sp),
        "client_pp": lambda: engine(None, None, pp, optimizer=lambda p:
                                    torch.optim.SGD(p, lr=0.1)),
        "offload_param_pp": lambda: engine(None, {"zero_optimization": {
            "stage": 3, "offload_optimizer": {"device": "cpu"},
            "offload_param": {"device": "cpu"}}}, pp),
        "fpdt_host_kv_sp": lambda: engine(
            dict(seq, fpdt_host_kv=True, attn_chunks=2), None, sp),
        "dense_model_sp": lambda: engine(None, {"sequence_parallel": {
            "size": world, "auto_plan": False}}),
        "unshifted_sp": lambda: _unshifted(inp, world),
    }
    got = {}
    for name, build in cases.items():
        trained.pop("last", None)
        try:
            build()
            got[name] = trained.get("last")
        except (NotImplementedError, ValueError, AssertionError) as e:
            got[name] = (type(e).__name__, str(e))
    out["sp_raises"] = got


def _unshifted(inp, world):
    """An sp engine handed whole rows (not its sequence block)."""
    import deepspeed_tpu_torch

    eng, *_ = deepspeed_tpu_torch.initialize(
        model=_run_model(inp, {"model_over": {"sequence_parallel": True}}),
        config=inp["config"], device="cpu",
        topology={"sp": world, "dp": 1})
    eng.train_batch(iter([inp["batches"][0]]))


def mode_domino(inp, rank, world, out):
    """JAX's Domino layer at tp = world with 1 and 2 chunks, and a
    two-layer stack, on this rank's copy of the batch."""
    from deepspeed_tpu_torch.parallel import topology
    from deepspeed_tpu_torch.parallel.domino import (
        DominoTransformer, domino_transformer_layer)

    mesh = topology.build_mesh({"tp": world, "dp": 1})
    case = inp["domino"]
    params = {k: torch.tensor(v) for k, v in case["params"].items()}
    x = torch.tensor(case["x"])
    res = {c: domino_transformer_layer(params, x, num_heads=case["heads"],
                                       num_chunks=c, mesh=mesh).numpy()
           for c in (1, 2)}
    stack = DominoTransformer(2, x.shape[-1], case["params"]["w1"].shape[1],
                              case["heads"], dtype=torch.float32)
    res["stack"] = stack.apply([params, params], x, mesh=mesh).numpy()
    out["domino"] = res


def mode_moe_fn(inp, rank, world, out):
    """JAX's ``moe_ffn_dropless`` on an ep mesh of the world (or dp x ep)
    through the port's global-token mode: the output, the gradients of
    a fixed projection of it, the aux statistics and the replicated-token
    count, per case."""
    from deepspeed_tpu_torch.parallel import moe, topology
    from deepspeed_tpu_torch.utils import telemetry

    res = {}
    for case in inp["moe_cases"]:
        if world not in case.get("worlds", (world,)):
            continue
        topology.set_global_mesh(topology.build_mesh(case["mesh"]))
        mesh = topology._GLOBAL_MESH
        telemetry.reset()
        cfg = moe.GateConfig(**case["gate"])
        ep, tp = mesh.shape["ep"], mesh.shape["tp"]
        e_loc = cfg.num_experts // ep
        lo = mesh.axis_index("ep") * e_loc
        x = torch.tensor(case["x"], requires_grad=True)
        router = torch.tensor(case["router"], requires_grad=True)
        # each tp rank's F/tp of every expert (the mlp dim: last of wi /
        # wg, dim 1 of wo)
        f_loc = case["experts"]["wi"].shape[-1] // tp
        flo = mesh.axis_index("tp") * f_loc

        def local(k, v):
            v = v[lo:lo + e_loc]
            v = v[:, flo:flo + f_loc] if k == "wo" else \
                v[..., flo:flo + f_loc]
            return torch.tensor(np.ascontiguousarray(v), requires_grad=True)

        experts = {k: local(k, v) for k, v in case["experts"].items()}
        y, aux = moe.moe_ffn_dropless(x, router, experts, cfg,
                                      activation=case["activation"],
                                      global_tokens=True)
        (y * torch.tensor(case["proj"])).sum().backward()
        res[case["name"]] = {
            "out": y.detach().numpy(),
            "aux": {k: v.detach().numpy() for k, v in aux.items()},
            "dx": x.grad.numpy(), "drouter": router.grad.numpy(),
            "dexperts": {k: v.grad.numpy() for k, v in experts.items()},
            "lo": lo, "flo": flo, "replicated": telemetry.get(
                "moe.grouped_replicated_tokens")}
        topology.set_global_mesh(None)
    out["moe_fn"] = res


def _tp_mesh(world):
    from deepspeed_tpu_torch.parallel import topology

    topology.set_global_mesh(None)
    return topology.build_mesh({"tp": world, "dp": 1})


def _tp_vocab(inp, world):
    """``vocab_parallel_lookup`` on this rank's rows of the table: the
    rows and the gradient of sum(rows^2 * proj) in this rank's rows,
    fp32 and bf16."""
    from deepspeed_tpu_torch.parallel import topology
    from deepspeed_tpu_torch.runtime import sharding

    v = inp["vocab"]
    mesh = _tp_mesh(world)
    topology.set_global_mesh(mesh)
    rows_n = v["table"].shape[0] // world
    lo = mesh.axis_index("tp") * rows_n
    res = {"lo": lo}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        table = torch.tensor(v["table"][lo:lo + rows_n], requires_grad=True)
        rows = sharding.vocab_parallel_lookup(table.to(dt),
                                              torch.tensor(v["ids"]))
        loss = (rows.float() ** 2 * torch.tensor(v["proj"])).sum()
        loss.backward()
        res[name] = {"rows": rows.detach().float().numpy(),
                     "dtype": str(rows.dtype),
                     "grad": table.grad.numpy()}
    topology.set_global_mesh(None)
    return res


def _tp_serve(inp, world):
    """The v2 engine's greedy streams at tp = world (MHA and GQA), its
    pool's kv heads and the kernel steps; the v1 engine's generate
    through ``tensor_parallel``; JAX's refusals."""
    from deepspeed_tpu_torch.inference.engine import init_inference
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.parallel import topology

    res = {}
    for case in inp["serve"]:
        cfg = zoo.get_config(case["preset"], dtype=torch.float32,
                             **case["model_kw"])
        model = params_from_jax(case["params"], cfg, device="cpu")
        mesh = _tp_mesh(world)
        eng = InferenceEngineV2(model, device="cpu", mesh=mesh,
                                **inp["serve_kw"])
        prompts = case["prompts"]
        eng.put(list(prompts), [np.asarray(p) for p in prompts.values()],
                max_new_tokens=case["max_new"])
        got = eng.generate_all()
        rec = {"streams": {int(k): list(map(int, v))
                           for k, v in got.items()},
               "pool_kv_heads": int(eng.kv_cache.data.shape[4]),
               "kernel_steps": (eng.stats["decode_kernel_steps"],
                                eng.stats["prefill_kernel_steps"],
                                eng.stats["prefill_gather_fallbacks"]),
               "paged": eng._use_paged_kernel}
        # what JAX's v2 engine runs at tp runs here: speculation (prompt
        # lookup) and a quantized pool (the fused append and dequantize on
        # this rank's heads)
        rec["variants"] = {}
        for name, kw in inp["serve_variants"].items():
            eng = InferenceEngineV2(model, device="cpu", mesh=_tp_mesh(world),
                                    **inp["serve_kw"], **kw)
            eng.put(list(prompts), [np.asarray(p) for p in prompts.values()],
                    max_new_tokens=case["max_new"])
            rec["variants"][name] = {int(k): list(map(int, v)) for k, v in
                                     eng.generate_all().items()}
        topology.set_global_mesh(None)
        v1 = init_inference(model, tensor_parallel={"tp_size": world},
                            dtype=torch.float32, max_seq_len=64)
        rec["v1"] = v1.generate(np.asarray(case["v1_prompt"], np.int32),
                                max_new_tokens=3)
        topology.set_global_mesh(None)
        res[case["name"]] = rec
    errors = {}
    for name, kw, qw in (("kv1", {"num_kv_heads": 1}, None),
                         ("int8", {}, "int8")):
        cfg = zoo.get_config("tiny", dtype=torch.float32, **kw)
        model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                              **kw)
        try:
            InferenceEngineV2(model, device="cpu", mesh=_tp_mesh(world),
                              quantize_weights=qw, **inp["serve_kw"])
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
        del cfg
    topology.set_global_mesh(None)
    res["errors"] = errors
    return res


def _tp_grads(inp, world, partition: bool):
    """One microbatch's loss and full gradients of a tp = world engine
    (remat on), with ``partition_activations`` on or off."""
    import deepspeed_tpu_torch

    config = {**inp["config"], "zero_optimization": {"stage": 0},
              "activation_checkpointing": {
                  "partition_activations": partition}}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_port_model(inp), config=config, device="cpu",
        topology={"tp": world, "dp": 1})
    loss = engine(inp["batches"][0])
    engine.backward(loss)
    paths = [p for p, _ in leaves(engine.params)]
    grads = {p: engine.full_grad(p).numpy() for p in paths}
    return float(loss), grads


def _tp_ckpt(inp, world):
    """A tp = world stage-1 engine saves after two steps; the same mesh
    resumes bit for bit, and a tp = 1 mesh (fsdp = world) loads the same
    params."""
    import deepspeed_tpu_torch

    d = os.path.join(inp["workdir"], "tp_ckpt")
    config = {**inp["config"], "zero_optimization": {"stage": 1}}
    batches = inp["batches"]

    def build(topo):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=_port_model(inp), config=config, device="cpu",
            topology=topo)
        return eng

    tp_topo = {"tp": world, "dp": 1}
    eng = build(tp_topo)
    for b in batches[:2]:
        eng.train_batch(iter([b]))
    eng.save_checkpoint(d)
    saved = eng.module_state_dict()
    more = [float(eng.train_batch(iter([b]))) for b in batches[2:4]]
    fresh = build(tp_topo)
    fresh.load_checkpoint(d)
    again = [float(fresh.train_batch(iter([b]))) for b in batches[2:4]]
    flat = build({"fsdp": world, "dp": 1})
    flat.load_checkpoint(d)
    files = sorted(os.listdir(os.path.join(d, "global_step2", "state",
                                           "params", "layers", "attn")))
    return {"saved": saved, "more": more, "again": again,
            "tp1_params": flat.module_state_dict(), "files": files}


def mode_tp(inp, rank, world, out):
    """Tensor parallelism at tp = world: the vocab-parallel lookup,
    ``tp_model_init`` on JAX's AutoTP trees, the serving engines,
    ``partition_activations``' gradients and a checkpoint."""
    from deepspeed_tpu_torch.module_inject.auto_tp import tp_model_init

    res = {"vocab": _tp_vocab(inp, world)}
    trees = {}
    for name, tree in inp["autotp"].items():
        local, specs = tp_model_init(tree, tp_size=world)
        trees[name] = ({k: v.numpy() for k, v in _flat(local).items()},
                       specs)
    res["autotp"] = trees
    res["serve"] = _tp_serve(inp, world)
    res["grads"] = {part: _tp_grads(inp, world, part)
                    for part in (False, True)}
    res["ckpt"] = _tp_ckpt(inp, world)
    out["tp"] = res


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


MODES = {"zero": mode_zero, "raises": mode_raises, "ckpt": mode_ckpt,
         "comm": mode_comm, "sparse": mode_sparse,
         "fragments": mode_fragments, "quant_coll": mode_quant_coll,
         "engines": mode_engines, "moe_fn": mode_moe_fn, "tp": mode_tp,
         "sp_fn": mode_sp_fn, "pp_fn": mode_pp_fn, "domino": mode_domino,
         "sp_raises": mode_sp_raises}


class Ranks:
    """WORLD ranks of this script running ``modes`` on ``inputs`` (fresh
    interpreters, one thread each, never a fork). ``join`` waits for them
    and returns each rank's outputs; a rank that fails, or that outlives
    the deadline, fails the caller with the logs' tails."""

    def __init__(self, modes: str, workdir: str, world: int, inputs,
                 timeout: float = 300):
        os.makedirs(workdir, exist_ok=True)
        torch.save(inputs, os.path.join(workdir, "inputs.pt"))
        self.workdir, self.world = workdir, world
        self.deadline = time.monotonic() + timeout
        # MKL's COMPATIBLE branch gives the same bits on every x86-64
        # host, so the ranks' fp32 arithmetic (and a quantized engine's
        # rounding ties) does not depend on the host's instruction set
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   MKL_CBWR="COMPATIBLE", PYTHONPATH=REPO)
        self.procs, self.logs = [], []
        for rank in range(world):
            log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), modes, workdir,
                 str(rank), str(world)], env=env, stdout=log,
                stderr=subprocess.STDOUT))

    def join(self) -> list:
        failed = None
        try:
            for rank, p in enumerate(self.procs):
                try:
                    rc = p.wait(timeout=max(
                        1.0, self.deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed = f"rank {rank} still running at its deadline"
                    break
                if rc != 0 and failed is None:
                    failed = f"rank {rank} exited with {rc}"
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        if failed is not None:
            tails = []
            for rank in range(self.world):
                with open(os.path.join(self.workdir,
                                       f"rank{rank}.log")) as f:
                    tails.append(f"--- rank {rank}\n" + f.read()[-3000:])
            raise AssertionError(failed + "\n" + "\n".join(tails))
        return [torch.load(os.path.join(self.workdir, f"out_{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def main(argv):
    modes, workdir, rank, world = argv[1], argv[2], int(argv[3]), \
        int(argv[4])
    torch.set_num_threads(1)
    comm.init_distributed(
        init_method="file://" + os.path.join(workdir, "store"),
        num_processes=world, process_id=rank, device="cpu",
        timeout=PG_TIMEOUT_S)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    try:
        for mode in modes.split(","):
            MODES[mode](inp, rank, world, out)
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
        comm.destroy()


if __name__ == "__main__":
    main(sys.argv)
