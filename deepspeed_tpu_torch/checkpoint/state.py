"""Engine checkpoint save/load (port of
``deepspeed_tpu/checkpoint/state.py``).

The JAX on-disk contract with torch tensors: ``<save_dir>/latest`` names
the tag, and ``<save_dir>/<tag>/`` holds ``metadata.json`` (the JAX
keys; ``mesh_shape`` and ``world_size`` as a one-device JAX engine
writes them), ``manifest.json`` (``resilience/manifest.py``, the same
schema) and ``state/``, one torch file per leaf
(``runtime/checkpoint_engine.py``). The state is the compute-dtype
params, the loss-scale state, and the optimizer's fp32 masters, moments
and update count; the step counters travel in the metadata, as in JAX.

The publish order is JAX's: every payload durable, then the metadata,
the manifest and, last, ``latest``. Load validates the manifest before
any tensor is read, falls back to the previous good tag on corruption,
and copies into the engine's own tensors in place: the GAS > 1
accumulation hooks hang on the compute params, and an fp32 model shares
its tensors with the masters.

With the optimizer offloaded (``runtime/offload.py``) the optimizer
payload is JAX's offload branch: the host masters, moments and per-leaf
Adam step counts under ``state/offload_optim_rank0/`` (the stem of JAX's
``offload_optim_rank0.npz``), beside the params and ``opt_count``; on
the NVMe tier they are read from the swap store for the save and
written back after a load. Across ranks each rank writes its own blocks
under ``state/offload_optim_rank<r>/`` and resumes them at the same
world size (another world size raises; the params load at any). A load
that wants the optimizer state and finds no such payload raises
``FileNotFoundError`` (JAX's wording); with ``load_optimizer_states=
False`` the masters are re-seeded from the restored params.

With ZenFlow (``runtime/zenflow.py``) the optimizer payload is JAX's
ZenFlow branch: the whole importance-split state under
``state/zenflow_rank0/`` (the stem of JAX's ``zenflow_rank0.npy``), one
torch file per tensor under JAX's state-dict keys (``masters``,
``host_opt/exp_avg``, ``idx``, ``acc``, ``protected``, ... by leaf
path; ``steps``), and ``fold_due``, which JAX does not keep. The save
waits for a host pass in flight first (``state_dict`` finalizes); the
load reads the files with ``weights_only``, checks every shape before
anything changes, and raises ``FileNotFoundError`` with JAX's wording
when the payload is missing; ``load_optimizer_states=False`` rebuilds
ZenFlow from the restored params. Across ranks each rank writes its own
``state/zenflow_rank<r>/`` with JAX's ``shard_index`` of its blocks; a
load at the same world size reads its own, at another it reads every
saved rank's and reslices them to its blocks
(``runtime/zenflow.reslice_state``, JAX's reslice).

With a client ``torch.optim.Optimizer`` the optimizer payload is the
fp32 masters (``opt_master``) and the optimizer's ``state_dict``: its
tensors under ``state/opt_client/state/<param index>/<name>`` and its
``param_groups`` (and any state value that is not a tensor) in the
metadata's ``client_optimizer`` record; a load hands them back through
``load_state_dict``, so a resumed run steps bit for bit as the
uninterrupted one. Universal checkpoints raise at the config (item 16).

Under the 1-bit and ZeRO++ stage 1-2 steps (``runtime/onebit.py``,
``runtime/zeropp.py``) each rank writes its own optimizer state under
``state/quant_rank<r>/`` (the ZeRO++ step's flat master and moment
blocks, ``opt_master`` / ``opt_mu`` / ``opt_nu``; the 1-bit masters,
moments, step and this rank's error feedback, which JAX holds as one
array with a leading dp dim); a load reads it back at the same world
size. ``load_optimizer_states=False`` re-seeds the masters from the
restored params with zeroed moments.

Across ranks (ZeRO on a process group) every rank writes the blocks it
owns: a leaf that shards over the fsdp ranks is one file per block,
``<leaf>.block<j>of<n>.pt`` (the metadata's ``zero_blocks`` names each
such leaf and its dim), and rank 0 writes the replicated leaves under
their plain names, so no rank ever holds more than its own blocks. A
world-size-1 save is the one-file-a-leaf layout above. The ranks agree
that their writes are durable (``_agree``) before rank 0 publishes the
metadata, the manifest and ``latest``, between two barriers. A load
first asserts that every rank sees the same tag; each rank then maps
the files that overlap its block of each leaf and copies the overlap,
so a checkpoint loads at any world size and any stage. Under expert
parallelism each ep rank's experts of an expert leaf are files of their
own (``<leaf>.ep<e>of<n>``, then the block), and under tensor
parallelism each tp rank's slice of a leaf that shards over tp
(``<leaf>.tp<t>of<n>``, then the ep and block cuts), written by the rank
whose other mesh coordinates are 0; the metadata's ``zero_blocks``
records each cut (``ep``, ``tp``), so any tp and fsdp loads any other.
Under pipeline parallelism each stage's layers of a stacked layer leaf
are files of their own (``<leaf>.pp<s>of<n>``, before the other cuts),
so a pp save loads at any pp, pp 1 included; the sp ranks hold the same
state and the one at sp index 0 writes it.
A load onto
another mesh than the save's is legal and loud (JAX's
``_validate_tag``): a warning, ``resilience.resharded_restore`` counted
once, and ``checkpoint.tag_validation`` "Fail" refuses it. (The elastic
batch re-check waits for ROADMAP queue A item 16's elasticity.)
"""

from __future__ import annotations

import atexit
import itertools
import json
import logging
import os
import time
import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.resilience.manifest import (CheckpointCorruptError,
                                                     find_latest_valid_tag,
                                                     validate_manifest,
                                                     write_manifest)
from deepspeed_tpu_torch.resilience.resume import data_cursor
from deepspeed_tpu_torch.runtime.checkpoint_engine import (
    leaf_file, make_checkpoint_engine, read_files)
from deepspeed_tpu_torch.runtime.loss_scaler import LossScaleState
from deepspeed_tpu_torch.runtime.zenflow import reslice_state
from deepspeed_tpu_torch.runtime.optimizer import (leaves,
                                                   reset_optimizer_state,
                                                   set_leaf)
from deepspeed_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

LATEST_FILE = "latest"
METADATA_FILE = "metadata.json"
STATE_DIR = "state"
FRAMEWORK_VERSION = "0.1.0"  # the project's version (pyproject.toml)
# the mesh of a one-device JAX engine (its axes in parallel/topology.py)
MESH_SHAPE = {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1}
BLOCKS_KEY = "zero_blocks"  # metadata: {"count": n, "dims": {leaf: dim}}
# the per-rank payloads, by rank 0's name (``rank_key`` names a rank's)
OFFLOAD_KEY = "offload_optim_rank0"
ZENFLOW_KEY = "zenflow_rank0"
ZENFLOW_STEM = ZENFLOW_KEY[:-1]
QUANT_KEY = "quant_rank0"
CLIENT_KEY = "opt_client"
ZENFLOW_LEAF_KEYS = ("masters", "idx", "m", "v", "acc")


class CheckpointIO:
    """Bound to an Engine; owns its save/load. ``last_load_s`` holds the
    last load's seconds by part (``validate``, ``read``) and bytes read."""

    def __init__(self, engine):
        # weakly, as the accumulation hooks do: a cycle would keep the
        # engine's tensors until the garbage collector runs
        self._engine = weakref.ref(engine)
        self.ckpt_engine = make_checkpoint_engine(engine.config.checkpoint)
        self._pending_commit = None  # (tag, save_dir, ckpt_dir, meta, latest)
        self.last_load_s: Dict[str, float] = {}
        # a final async save with no later step/save/load would otherwise
        # never publish metadata + 'latest' — commit at interpreter exit
        ref = weakref.ref(self)

        def _commit_at_exit():
            obj = ref()  # bind once: the object can be collected mid-expr
            if obj is not None:
                obj.commit_pending()

        atexit.register(_commit_at_exit)

    @property
    def engine(self):
        return self._engine()

    # -- state tree ----------------------------------------------------
    def _state(self, optimizer: bool = True) -> Dict[str, Any]:
        """The saved tree: the engine's own tensors, and the host scalars
        as 0-dim host tensors (a load copies into all of them in
        place). ``optimizer=False`` leaves the optimizer payload out."""
        e = self.engine
        ls = e.loss_scale_state
        state = {
            "params": e.params,
            "loss_scale": {
                "scale": torch.tensor(ls.scale, dtype=torch.float64),
                "good_steps": torch.tensor(ls.good_steps)},
            "opt_count": torch.tensor(e.update_count),
        }
        if not optimizer:
            return state
        if e._zenflow is not None:
            state[rank_key(ZENFLOW_KEY)] = zenflow_tree(e._zenflow)
        elif e._offload is not None:
            state[rank_key(OFFLOAD_KEY)] = e._offload.state_dict()
        elif e._quant_step is not None:
            qs = e._quant_step.state
            state[quant_key()] = dict(qs.named_trees(),
                                      step=torch.tensor(qs.step))
        else:
            opt = {"opt_master": e.opt_state.master}
            for name, tree in e.opt_state.named_trees().items():
                opt[f"opt_{name}"] = tree
            if _per_rank(e):
                state[quant_key()] = opt
            else:
                state.update(opt)
        return state

    @staticmethod
    def _client_payload(opt) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """A client optimizer's ``state_dict`` as (a tree of its state
        tensors, the metadata record of the rest)."""
        sd = opt.state_dict()
        tensors: Dict[str, Any] = {}
        scalars: Dict[str, Any] = {}
        for idx, st in sd["state"].items():
            for name, value in st.items():
                where = tensors if isinstance(value, torch.Tensor) \
                    else scalars
                where.setdefault(str(idx), {})[name] = value
        return ({"state": tensors} if tensors else {},
                {"param_groups": sd["param_groups"], "scalars": scalars})

    @staticmethod
    def _load_client(opt, state_dir: str, record: Optional[Dict]) -> int:
        """Hand a saved client optimizer state back to ``opt`` (its
        tensors cloned out of the mapped files). Returns bytes read."""
        if record is None:
            raise FileNotFoundError(
                "client optimizer state missing from the checkpoint's "
                "metadata. Pass load_optimizer_states=False to knowingly "
                "re-seed the masters from the restored params")
        path = os.path.join(state_dir, CLIENT_KEY)
        tree = read_files(path) if os.path.isdir(path) else {}
        state: Dict[int, Dict[str, Any]] = {}
        nbytes = 0
        for idx, st in tree.get("state", {}).items():
            for name, t in st.items():
                state.setdefault(int(idx), {})[name] = t.clone()
                nbytes += t.nbytes
        for idx, st in record.get("scalars", {}).items():
            state.setdefault(int(idx), {}).update(st)
        # JSON gave lists where the optimizer keeps tuples (betas)
        groups = [{k: (tuple(v) if isinstance(mine.get(k), tuple) else v)
                   for k, v in saved.items()}
                  for saved, mine in zip(record["param_groups"],
                                         opt.param_groups)]
        opt.load_state_dict({"state": state, "param_groups": groups})
        return nbytes

    def _validate_tag(self, meta: Dict, tag: str) -> None:
        """A load onto another mesh than the save's (JAX
        ``_validate_tag``, reference ``_checkpoint_tag_validation``
        engine.py:4540) is legal, the state resharded, but never silent:
        a warning and ``resilience.resharded_restore`` counted once;
        ``checkpoint.tag_validation`` "Fail" refuses it."""
        if not meta:
            return
        e = self.engine
        saved_mesh = meta.get("mesh_shape")
        cur_mesh = {k: int(v) for k, v in e.mesh.shape.items()}
        if not saved_mesh or saved_mesh == cur_mesh:
            return
        telemetry.count("resilience.resharded_restore",
                        reason=f"{saved_mesh} -> {cur_mesh}")
        logger.warning(
            f"resharded restore: checkpoint '{tag}' was saved on mesh "
            f"{saved_mesh} (world_size {meta.get('world_size', '?')}), "
            f"loading onto {cur_mesh} (world_size "
            f"{comm.get_world_size()})")
        mode = e.config.checkpoint.tag_validation.lower()
        if mode == "ignore":
            return
        msg = (f"checkpoint '{tag}' was saved on mesh {saved_mesh}, "
               f"loading onto {cur_mesh}: state will be resharded")
        if mode == "fail":
            raise ValueError(msg)
        logger.warning(msg)

    def _rconfig(self) -> Tuple[bool, bool]:
        """(manifest on, checksums on) from the resilience block."""
        r = self.engine.config.resilience
        on = r.enabled and r.manifest
        return on, r.manifest_checksums

    # -- save ----------------------------------------------------------
    def save(self, save_dir: str, tag: Optional[str] = None,
             client_state: Optional[Dict] = None, save_latest: bool = True):
        e = self.engine
        self.commit_pending()  # at most one async save in flight
        tag = tag or f"global_step{e.global_steps}"
        ckpt_dir = os.path.join(os.path.abspath(save_dir), str(tag))
        os.makedirs(ckpt_dir, exist_ok=True)

        state = self._state()
        client_record = None
        if e._client_opt is not None:
            state[CLIENT_KEY], client_record = self._client_payload(
                e._client_opt)
        count, index, dims = self._blocks(state)
        ep = self._ep_blocks(state)
        tp = self._tp_blocks(state)
        pp = self._tp_blocks(state, "pp")
        self.ckpt_engine.save(os.path.join(ckpt_dir, STATE_DIR),
                              self._rank_tree(state, count, index, dims, ep,
                                              tp, pp))

        # data-pipeline cursor: consumed GAS boundaries + loader state,
        # snapshotted at this boundary so auto-resume replays the exact
        # remaining batch stream (resilience/resume.py)
        try:
            cursor = data_cursor(e)
        except Exception as err:
            logger.warning(f"data cursor snapshot failed: {err}")
            cursor = {}
        meta = {
            "tag": str(tag),
            "framework_version": FRAMEWORK_VERSION,
            "saved_at": time.time(),
            "global_steps": e.global_steps,
            "global_samples": e.global_samples,
            "skipped_steps": e.skipped_steps,
            "mesh_shape": {k: int(v) for k, v in e.mesh.shape.items()},
            "world_size": comm.get_world_size(),
            "zero_stage": e.config.zero_optimization.stage,
            "data_cursor": cursor,
            "config": e.config.to_dict(),
            "client_state": client_state or {},
        }
        if client_record is not None:
            meta["client_optimizer"] = client_record
        if count > 1 or ep[2] or tp[2] or pp[2]:
            meta[BLOCKS_KEY] = {"count": count, "dims": dims}
            for key, cut in (("ep", ep), ("tp", tp), ("pp", pp)):
                if cut[2]:
                    meta[BLOCKS_KEY][key] = {"count": cut[0],
                                             "dims": cut[2]}
        if e.config.checkpoint.async_save:
            # decoupled: 'latest' is published at commit (next GAS boundary
            # or the next save/load), reference engine.py:3273
            self._pending_commit = (str(tag), save_dir, ckpt_dir, meta,
                                    save_latest)
            logger.info(f"checkpoint save in flight: {ckpt_dir}")
            return ckpt_dir
        self._publish(str(tag), save_dir, ckpt_dir, meta, save_latest)
        logger.info(f"saved checkpoint: {ckpt_dir}")
        return ckpt_dir

    def _blocks(self, state) -> Tuple[int, int, Dict[str, int]]:
        """(blocks a sharded leaf has, this rank's block, leaf path -> its
        shard dim) for the engine's state tree: the params by their stage-3
        dims, the masters and the master-shaped optimizer state by their
        dims from stage 1."""
        zero = self.engine._zero
        if zero is None or zero.fsdp_n == 1:
            return 1, 0, {}
        masters = dict(leaves(self.engine.opt_state.master)) \
            if self.engine.opt_state is not None else {}
        dims: Dict[str, int] = {}
        for leaf_path, t in leaves(state):
            top, _, path = leaf_path.strip("/").partition("/")
            path = "/" + path
            if top == "params":
                d = zero.param_dim.get(path)
            elif top.startswith("opt_") and path in masters and \
                    self.engine._client_opt is None:
                d = getattr(self.engine.tx, "state_dim", lambda p, n, d: d)(
                    path, top[4:], zero.opt_dim.get(path)) \
                    if t.shape != masters[path].shape else \
                    zero.opt_dim.get(path)
            else:
                d = None
            if d is not None:
                dims[leaf_path] = d
        return zero.fsdp_n, zero.fsdp_index, dims

    def _ep_blocks(self, state) -> Tuple[int, int, Dict[str, int]]:
        """(ep ranks, this rank's ep index, leaf path -> its expert dim):
        under expert parallelism each ep rank holds its own E/ep experts
        of an expert leaf, in every role."""
        zero = self.engine._zero
        if zero is None or zero.ep_n == 1:
            return 1, 0, {}
        dims: Dict[str, int] = {}
        for leaf_path, t in leaves(state):
            top, _, path = leaf_path.strip("/").partition("/")
            e = zero.ep_dim.get("/" + path)
            if (top == "params" or top.startswith("opt_")) and e is not None:
                dims[leaf_path] = e
        return zero.ep_n, zero.ep_index, dims

    def _tp_blocks(self, state, axis: str = "tp"
                   ) -> Tuple[int, int, Dict[str, int]]:
        """(tp ranks, this rank's tp index, leaf path -> its tp dim): under
        tensor parallelism each tp rank holds its slice of a leaf that
        shards over tp, in every master-shaped role; the same for the
        stages of a stacked layer leaf with ``axis="pp"``."""
        zero = self.engine._zero
        if zero is None or getattr(zero, f"{axis}_n", 1) == 1:
            return 1, 0, {}
        masters = dict(leaves(self.engine.opt_state.master))
        dims: Dict[str, int] = {}
        for leaf_path, t in leaves(state):
            top, _, path = leaf_path.strip("/").partition("/")
            path = "/" + path
            d = getattr(zero, f"{axis}_dim").get(path)
            if d is not None and (top == "params" or (
                    top.startswith("opt_") and path in masters
                    and t.shape == masters[path].shape)):
                dims[leaf_path] = d
        return getattr(zero, f"{axis}_n"), getattr(zero, f"{axis}_index"), \
            dims

    def _rank_tree(self, state, count: int, index: int,
                   dims: Dict[str, int], ep=(1, 0, {}), tp=(1, 0, {}),
                   pp=(1, 0, {})):
        """What this rank writes: its slice of each sharded leaf, named by
        its cuts in order (``<leaf>.pp<s>of<n>``, ``.tp<t>of<n>``,
        ``.ep<e>of<n>``, ``.block<j>of<n>``), when its mesh coordinates off
        those cuts' axes are 0 (one writer a file), and, on rank 0, the
        replicated leaves."""
        if comm.get_world_size() == 1:
            return state
        coords = self.engine.mesh.coords()
        cuts = (("pp", "pp", pp), ("tp", "tp", tp), ("ep", "ep", ep),
                ("block", "fsdp", (count, index, dims)))
        out: Dict[str, Any] = {}
        own = tuple("/" + rank_key(k) + "/" for k in
                    (QUANT_KEY, OFFLOAD_KEY, ZENFLOW_KEY))
        for leaf_path, t in leaves(state):
            if leaf_path.startswith(own):  # this rank's own state
                set_leaf(out, leaf_path, t)
                continue
            axes, name = set(), leaf_path
            for tag, axis, (n, i, cut_dims) in cuts:
                if leaf_path in cut_dims:
                    axes.add(axis)
                    name += f".{tag}{i}of{n}"
            if all(v == 0 for a, v in coords.items() if a not in axes):
                set_leaf(out, name, t)
        return out

    @staticmethod
    def _agree(done: bool, failed: bool) -> Tuple[bool, bool]:
        """Every rank's (done, failed) folded: (all done, any failed).
        Every rank with a pending commit calls this in lockstep."""
        if comm.get_world_size() == 1:
            return done, failed
        return (not comm.any_process(not done),
                comm.any_process(failed))

    def _publish(self, tag, save_dir, ckpt_dir, meta, save_latest):
        """Barrier + metadata + manifest + 'latest' pointer, only after
        every rank's payload is durable. Ordering matters: the manifest
        (the durability witness) goes down before 'latest', so 'latest'
        never names a checkpoint without one."""
        comm.barrier()
        if comm.get_rank() == 0:
            self._write_published(tag, save_dir, ckpt_dir, meta, save_latest)
        comm.barrier()  # no rank reads 'latest' before it is written

    def _write_published(self, tag, save_dir, ckpt_dir, meta, save_latest):
        with open(os.path.join(ckpt_dir, METADATA_FILE), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        if self._rconfig()[0]:
            write_manifest(
                ckpt_dir, tag,
                global_steps=int(meta.get("global_steps", 0)),
                world={"mesh_shape": meta.get("mesh_shape", {}),
                       "process_count": meta.get("world_size", 1),
                       "device_count": meta.get("world_size", 1)},
                data_cursor=meta.get("data_cursor", {}))
        if save_latest:
            with open(os.path.join(os.path.abspath(save_dir),
                                   LATEST_FILE), "w") as f:
                f.write(str(tag))

    def commit_pending(self):
        """Block until an in-flight async save is durable, then publish;
        a failed write raises and publishes nothing."""
        if self._pending_commit is None:
            return
        tag, save_dir, ckpt_dir, meta, save_latest = self._pending_commit
        self._pending_commit = None
        err = None
        try:
            self.ckpt_engine.commit(tag)
        except Exception as e:  # noqa: BLE001 — agreed on below
            err = e
        _, any_failed = self._agree(True, err is not None)
        if any_failed:
            if err is not None:
                raise err
            raise RuntimeError(f"async checkpoint '{tag}' failed on "
                               "another rank; not publishing")
        self._publish(tag, save_dir, ckpt_dir, meta, save_latest)
        logger.info(f"saved checkpoint: {ckpt_dir}")

    def maybe_commit(self):
        """Polled at GAS boundaries (reference engine.py:3273): publish a
        finished async save; a failed write abandons it and raises."""
        if self._pending_commit is None:
            return
        err = None
        try:
            done = self.ckpt_engine.maybe_finalize()
        except Exception as e:  # noqa: BLE001 — agreed on below
            err, done = e, True
        # every rank must agree the save is done before any enters the
        # publish barrier (a rank-local error joins the agreement too)
        done, any_failed = self._agree(done, err is not None)
        if any_failed:
            self._pending_commit = None
            if err is not None:
                raise err
            raise RuntimeError("async checkpoint save failed on another "
                               "rank; pending save abandoned")
        if done:
            self.commit_pending()

    # -- load ----------------------------------------------------------
    def load(self, load_dir: str, tag: Optional[str] = None,
             load_optimizer_states: bool = True
             ) -> Tuple[Optional[str], Optional[Dict]]:
        e = self.engine
        self.commit_pending()
        load_dir = os.path.abspath(load_dir)
        if tag is None:
            latest = os.path.join(load_dir, LATEST_FILE)
            if os.path.exists(latest):
                with open(latest) as f:
                    tag = f.read().strip()
        ckpt_dir = os.path.join(load_dir, str(tag)) if tag else ""
        dir_ok = bool(tag) and os.path.isdir(ckpt_dir)
        meta: Dict[str, Any] = {}
        if dir_ok:
            meta_path = os.path.join(ckpt_dir, METADATA_FILE)
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
        # manifest validation: a torn or corrupt save is REFUSED here,
        # before any tensor restore — a silent bad restore is worse than
        # a failed one
        manifest_doc = manifest_err = None
        check_manifest, checksums = self._rconfig()
        t0 = time.perf_counter()
        if dir_ok and check_manifest:
            try:
                manifest_doc = validate_manifest(ckpt_dir,
                                                 check_checksums=checksums)
            except CheckpointCorruptError as err:
                manifest_err = err
        validate_s = time.perf_counter() - t0
        # every rank must see the SAME checkpoint; the collective runs
        # before any early return, or a disagreeing rank would leave its
        # peers hung inside it
        comm.assert_same_across_processes(
            "checkpoint_load",
            [str(tag) if tag else "<missing-latest>", int(dir_ok),
             int(meta.get("global_steps", -1)),
             int(load_optimizer_states), int(manifest_err is None)])
        if tag is None:
            logger.warning(f"no '{LATEST_FILE}' file at {load_dir}; "
                           "nothing loaded")
            return None, None
        if not dir_ok:
            raise FileNotFoundError(f"checkpoint not found: {ckpt_dir}")
        if manifest_err is not None:
            telemetry.count("resilience.corrupt_checkpoint",
                            reason=str(tag))
            fallback = find_latest_valid_tag(load_dir, exclude=[str(tag)],
                                             check_checksums=checksums)
            if fallback is None:
                raise manifest_err
            logger.error(
                f"checkpoint '{tag}' failed manifest validation "
                f"({manifest_err.reason}); falling back to the previous "
                f"good tag '{fallback}'")
            return self.load(load_dir, tag=fallback,
                             load_optimizer_states=load_optimizer_states)
        if manifest_doc is None and check_manifest:
            logger.warning(
                f"checkpoint '{tag}' has no manifest (saved before the "
                "resilience subsystem, or by a non-primary writer): "
                "accepting without integrity verification")
        self._validate_tag(meta, str(tag))

        t0 = time.perf_counter()
        state_dir = os.path.join(ckpt_dir, STATE_DIR)
        zen_sd = None
        saved_world = int(meta.get("world_size", 1))
        if e._zenflow is not None and load_optimizer_states:
            # a save at another world size: every saved rank's payload,
            # resliced to this rank's blocks (JAX's reslice)
            ranks = ([comm.get_rank()] if saved_world == comm.get_world_size()
                     else list(range(saved_world)))
            zen_dirs = [os.path.join(state_dir, f"{ZENFLOW_STEM}{r}")
                        for r in ranks]
            # agreed on by every rank: one rank raising alone would hang
            # its peers' next collective
            if comm.any_process(not all(map(os.path.isdir, zen_dirs))):
                raise FileNotFoundError(
                    "zenflow optimizer state missing on at least one "
                    f"process (this rank's paths: {zen_dirs}). Pass "
                    "load_optimizer_states=False to knowingly re-seed "
                    "fresh importance-split state from the restored params")
            zen_trees = [read_files(d) for d in zen_dirs]
            sds = [zenflow_state_dict(t, e._zenflow.paths)
                   for t in zen_trees]
            zen_sd = sds[0] if len(ranks) == 1 and ranks[0] == \
                comm.get_rank() else reslice_state(sds, e._zenflow.blocks)
            e._zenflow.check_state_dict(zen_sd)
        if (e._quant_step is not None or _per_rank(e)) and \
                load_optimizer_states and \
                comm.any_process(not os.path.isdir(
                    os.path.join(state_dir, quant_key()))):
            raise FileNotFoundError(
                "the 1-bit / ZeRO++ optimizer state of at least one rank "
                f"is missing (this rank's path: "
                f"{os.path.join(state_dir, quant_key())}); pass "
                "load_optimizer_states=False to re-seed the masters from "
                "the restored params")
        if e._offload is not None and load_optimizer_states:
            off_dir = os.path.join(state_dir, rank_key(OFFLOAD_KEY))
            if comm.any_process(not os.path.isdir(off_dir)):
                raise FileNotFoundError(
                    "offload optimizer state missing at "
                    f"{off_dir} (on at least one rank) — the host masters "
                    "would silently overwrite the restored params on the "
                    "next step. Pass load_optimizer_states=False to "
                    "rebuild masters (zeroed moments) from the checkpoint "
                    "params instead.")
            if saved_world != comm.get_world_size():
                raise ValueError(
                    f"offload optimizer state saved at world size "
                    f"{saved_world}, loaded at {comm.get_world_size()}: "
                    "each rank's host blocks resume at the same world "
                    "size only; pass load_optimizer_states=False to "
                    "rebuild the masters from the checkpoint params")
        # the optimizer payloads (~3x the param bytes) are not read at
        # all when they are not wanted
        state = self._state(optimizer=load_optimizer_states
                            and e._zenflow is None)
        skip = () if load_optimizer_states else ("opt_count",)
        count, index, dims = self._blocks(state)
        ep = self._ep_blocks(state)
        tp = self._tp_blocks(state)
        pp = self._tp_blocks(state, "pp")
        saved = meta.get(BLOCKS_KEY)
        if count == 1 and not ep[2] and not tp[2] and not pp[2] and \
                saved is None:
            nbytes, _ = self.ckpt_engine.load(state_dir, state, skip=skip)
        else:
            none = {"count": 1, "dims": {}}
            saved_ep = (saved or {}).get("ep", none)
            saved_tp = (saved or {}).get("tp", none)
            saved_pp = (saved or {}).get("pp", none)
            nbytes = read_blocks(
                state_dir, state, skip, (count, index, dims),
                (saved["count"], saved["dims"]) if saved else (1, {}),
                ep, (saved_ep["count"], saved_ep["dims"]),
                tp, (saved_tp["count"], saved_tp["dims"]),
                pp, (saved_pp["count"], saved_pp["dims"]))
        with torch.no_grad():
            if e._zenflow is not None:
                if zen_sd is not None:
                    e._zenflow.load_state_dict(zen_sd)
                    nbytes += sum(t.nbytes for tree in zen_trees
                                  for _, t in leaves(tree))
                else:
                    logger.warning("optimizer state not restored: ZenFlow "
                                   "rebuilt from the restored params")
                    e._zenflow.reinit(e._master_blocks_of_params())
            elif e._offload is not None:
                if load_optimizer_states:
                    e._offload.load_state_dict(state[rank_key(OFFLOAD_KEY)])
                    e._offload.count = int(state["opt_count"])
                    blocks = e._host_blocks()
                    e._offload.sync_params_from_masters(blocks)
                    if e._zero is not None:
                        e._publish_blocks(blocks)
                else:
                    logger.warning("optimizer state not restored: masters "
                                   "re-seeded from params, moments reset")
                    e._offload.reinit_masters(e._master_blocks_of_params())
            elif e._quant_step is not None:
                if load_optimizer_states:
                    e._quant_step.state.step = int(state[quant_key()]["step"])
                else:
                    logger.warning("optimizer state not restored: masters "
                                   "re-seeded from params, moments reset")
                    e.reseed_quant_masters()
            elif load_optimizer_states:
                e.opt_state.count = int(state["opt_count"])
                if e._client_opt is not None:
                    nbytes += self._load_client(
                        e._client_opt, state_dir,
                        meta.get("client_optimizer"))
            else:
                # masters drive the next update — re-seed them from the
                # restored params or the step rolls the model back to init
                logger.warning("optimizer state not restored: masters "
                               "re-seeded from params, moments reset")
                for (path, m), (_, p) in zip(leaves(e.opt_state.master),
                                             leaves(e.params)):
                    if e._zero is None:
                        m.copy_(p)
                    elif e._client_opt is not None:  # whole masters
                        m.copy_(e._zero.full(path, p, "param"))
                    else:
                        m.copy_(e._zero.master_of_param(path, p))
                if e._client_opt is not None:
                    e._client_opt.state.clear()
                    e.opt_state.count = 0
                else:
                    reset_optimizer_state(e.opt_state, e.tx)
        if e.device.type == "cuda":
            torch.cuda.synchronize(e.device)
        ls = state["loss_scale"]
        e.loss_scale_state = LossScaleState(float(ls["scale"]),
                                            int(ls["good_steps"]))
        e.global_steps = int(meta.get("global_steps", e.update_count))
        e.global_samples = int(meta.get("global_samples", 0))
        e.skipped_steps = int(meta.get("skipped_steps", 0))
        # data-pipeline cursor for deterministic auto-resume
        # (engine.resume_data_iter / resilience/resume.py); the manifest
        # copy wins — it is only written for fully-durable saves
        e.loaded_data_cursor = ((manifest_doc or {}).get("data_cursor")
                                or meta.get("data_cursor") or None)
        self.last_load_s = {"validate": validate_s,
                            "read": time.perf_counter() - t0,
                            "bytes_read": nbytes}
        logger.info(f"loaded checkpoint: {ckpt_dir} (tag={tag})")
        return ckpt_dir, meta.get("client_state", {})


def read_blocks(path: str, target, skip, layout, saved,
                ep_layout=(1, 0, {}), ep_saved=(1, {}),
                tp_layout=(1, 0, {}), tp_saved=(1, {}),
                pp_layout=(1, 0, {}), pp_saved=(1, {})) -> int:
    """Fill each leaf of ``target`` (this rank's blocks, or whole leaves)
    from the files under ``path`` that overlap it, whatever the save's
    world size: ``layout`` is (blocks, this rank's block, leaf -> dim) of
    the target, ``saved`` (blocks, leaf -> dim) of the save, and
    ``ep_layout`` / ``ep_saved`` and ``tp_layout`` / ``tp_saved`` the same
    for the expert dim of the expert leaves and the tp dim of the
    tp-sharded leaves, and ``pp_layout`` / ``pp_saved`` for the stages
    of the stacked layer leaves. Every file is mapped and checked (dtype,
    whole shape) before any tensor changes. Returns the bytes copied."""
    # in file-name order: pp, tp, ep, block
    cuts_t = [pp_layout, tp_layout, ep_layout, layout]
    cuts_s = [("pp", pp_saved), ("tp", tp_saved), ("ep", ep_saved),
              ("block", saved)]
    skip = {f"/{k}" for k in skip}
    pairs = []
    for leaf_path, dst in leaves(target):
        if any(leaf_path == s or leaf_path.startswith(s + "/")
               for s in skip):
            continue
        full = list(dst.shape)
        lo_t = [0] * dst.dim()
        for count, index, dims in cuts_t:
            d_t = dims.get(leaf_path)
            if d_t is not None:
                full[d_t] *= count
                lo_t[d_t] = index * dst.shape[d_t]
        # each saved cut of this leaf: (tag, count, dim)
        scut = [(tag, n, dims.get(leaf_path)) for tag, (n, dims) in cuts_s
                if dims.get(leaf_path) is not None]
        for idx in itertools.product(*(range(n) for _, n, _ in scut)):
            name = leaf_path + "".join(
                f".{tag}{i}of{n}" for (tag, n, _), i in zip(scut, idx))
            src = torch.load(leaf_file(path, name), map_location="cpu",
                             weights_only=True, mmap=True)
            whole = list(src.shape) if isinstance(src, torch.Tensor) else None
            lo_s = [0] * len(whole or ())
            for (_, n, d), i in zip(scut, idx):
                if whole is not None:
                    lo_s[d] = i * src.shape[d]
                    whole[d] *= n
            if whole != full or src.dtype != dst.dtype:
                got = (whole, src.dtype) if whole is not None \
                    else type(src).__name__
                raise ValueError(
                    f"checkpoint leaf {leaf_path}: saved {got}, the engine "
                    f"holds {(full, dst.dtype)}")
            dv, sv = dst, src
            for k in range(dst.dim()):
                a = max(lo_t[k], lo_s[k])
                b = min(lo_t[k] + dst.shape[k], lo_s[k] + src.shape[k])
                if a >= b:
                    break
                dv = dv.narrow(k, a - lo_t[k], b - a)
                sv = sv.narrow(k, a - lo_s[k], b - a)
            else:
                pairs.append((dv, sv))
    nbytes = 0
    with torch.no_grad():
        for dv, sv in pairs:
            dv.copy_(sv)
            nbytes += sv.numel() * sv.element_size()
    return nbytes


def zenflow_tree(zf) -> Dict[str, Any]:
    """ZenFlow's state dict (JAX's keys, and ``fold_due``) as a tree of
    tensors keyed by leaf path: the per-leaf lists become subtrees, the
    scalars 0-dim tensors; a leaf with no protected set has no
    ``protected`` file."""
    sd = zf.state_dict()
    tree: Dict[str, Any] = {
        "steps": torch.tensor(sd["steps"], dtype=torch.int64),
        "fold_due": torch.tensor(sd["fold_due"])}
    for i, path in enumerate(zf.paths):
        (master,), (opt,) = sd["masters"][i], sd["host_opt"][i]
        set_leaf(tree.setdefault("masters", {}), path, master)
        set_leaf(tree.setdefault("shard_index", {}), path,
                 torch.tensor(sd["shard_index"][i][0], dtype=torch.int64))
        for name in ("exp_avg", "exp_avg_sq"):
            set_leaf(tree.setdefault("host_opt", {}).setdefault(name, {}),
                     path, opt[name])
        set_leaf(tree["host_opt"].setdefault("step", {}), path,
                 torch.tensor(opt["step"], dtype=torch.int64))
        for key in ZENFLOW_LEAF_KEYS[1:]:
            set_leaf(tree.setdefault(key, {}), path, sd[key][i])
        set_leaf(tree.setdefault("sel_step", {}), path,
                 torch.tensor(sd["sel_step"][i], dtype=torch.int64))
        set_leaf(tree.setdefault("updated_since_foldin", {}), path,
                 torch.tensor(sd["updated_since_foldin"][i]))
        if sd["protected"][i] is not None:
            set_leaf(tree.setdefault("protected", {}), path,
                     sd["protected"][i])
    return tree


def zenflow_state_dict(tree: Dict[str, Any], paths) -> Dict[str, Any]:
    """Inverse of :func:`zenflow_tree`, for the leaves ``paths``."""
    def get(key, path, required=True):
        node = tree
        for k in (*key.split("/"), *path.strip("/").split("/")):
            node = node.get(k) if isinstance(node, dict) else None
        if node is None and required:
            raise ValueError(f"zenflow state has no '{key}' for leaf "
                             f"{path}: a payload of another model")
        return node

    return {
        "steps": int(tree["steps"]), "fold_due": bool(tree["fold_due"]),
        "masters": [[get("masters", p)] for p in paths],
        "shard_index": [[tuple(tuple(int(x) for x in row)
                               for row in get("shard_index", p))]
                        for p in paths],
        "host_opt": [[{"exp_avg": get("host_opt/exp_avg", p),
                       "exp_avg_sq": get("host_opt/exp_avg_sq", p),
                       "step": int(get("host_opt/step", p))}]
                     for p in paths],
        **{key: [get(key, p) for p in paths]
           for key in ZENFLOW_LEAF_KEYS[1:]},
        "sel_step": [int(get("sel_step", p)) for p in paths],
        "protected": [get("protected", p, required=False) for p in paths],
        "updated_since_foldin": [bool(get("updated_since_foldin", p))
                                 for p in paths],
    }


def rank_key(key: str) -> str:
    """This rank's name of a per-rank payload (``..._rank0`` at world
    size 1, JAX's file stems)."""
    return key[:key.rindex("rank") + 4] + str(comm.get_rank())


def quant_key() -> str:
    """The 1-bit / ZeRO++ payload of this rank."""
    return rank_key(QUANT_KEY)


def _per_rank(engine) -> bool:
    """Whether each rank's optimizer state is its own (the ZeRO++ stage
    1-2 step's flat blocks, ``runtime/zeropp.FlatPartition``)."""
    return engine._zero is not None and engine._zero.per_rank_state


def module_state_keys(tree) -> Dict[str, torch.Tensor]:
    """``"."``-joined tree paths to leaves: the keys of the JAX engine's
    ``module_state_dict`` for the same model."""
    return {path.strip("/").replace("/", "."): t
            for path, t in leaves(tree)}


__all__ = ["CheckpointIO", "LATEST_FILE", "METADATA_FILE", "STATE_DIR",
           "OFFLOAD_KEY", "ZENFLOW_KEY", "module_state_keys", "zenflow_tree",
           "zenflow_state_dict"]
