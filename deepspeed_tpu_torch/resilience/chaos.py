"""Chaos harness: injected faults with assertable outcomes (copy of
``deepspeed_tpu/resilience/chaos.py``, which imports no JAX).

In the port the engine calls ``on_step`` and ``on_input_batch``, and
``comm`` calls ``on_collective`` at each control-plane op (the barrier
and the cross-process asserts, as in JAX); the wire hooks wait for the
serving fleet's transport (ROADMAP queue A item 13), and the flight
recorder and journal records for item 14.

Fault tolerance that has never met a fault is a hypothesis. This module
injects the failures the resilience subsystem claims to survive — a rank
killed mid-run, a wedged or failing collective, a corrupted checkpoint,
a stalled input pipeline — deterministically enough that a test can
assert the *outcome*: elastic agent restarts the group, auto-resume
lands on the latest valid manifest, and the final losses are
bit-identical to a fault-free run (``make chaos``,
tests/test_resilience.py, tools/chaos_run.py).

Faults are declared in a :class:`ChaosSpec`, normally parsed from the
``DSTPU_CHAOS`` env var so the launcher's child processes inherit them
without config plumbing::

    DSTPU_CHAOS="kill_rank=1,kill_step=3,kill_signal=SIGKILL"
    DSTPU_CHAOS="collective_k=5,collective_mode=delay,collective_delay_s=2"
    DSTPU_CHAOS="stall_input_step=2,stall_input_s=1.5"
    DSTPU_CHAOS="net_drop_frac=0.05,net_seed=7"
    DSTPU_CHAOS="net_partition=r1:20"

The injector is process-global (:func:`get_chaos_injector`) and inert
unless a spec is armed — the hooks in the engine/comm hot paths cost one
``is None`` check when chaos is off. Every injected fault is recorded in
the flight ring first, so post-mortems show "chaos_kill step=3" instead
of an unexplained death.
"""

from __future__ import annotations

import logging
import os
import random
import signal
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

logger = logging.getLogger(__name__)

CHAOS_ENV = "DSTPU_CHAOS"
# a transport frame's header (magic, payload length, crc32 of the
# payload), which ``net_corrupt`` leaves intact so the receiver's CRC
# catches the damage (JAX ``serving/transport/framing.py``)
_FRAME_HEADER_BYTES = 12

_SIGNALS = {
    "SIGKILL": signal.SIGKILL,
    "SIGTERM": signal.SIGTERM,
    "KILL": signal.SIGKILL,
    "TERM": signal.SIGTERM,
}


class ChaosCollectiveError(RuntimeError):
    """Injected collective failure (chaos harness, not a real fault)."""


@dataclass
class ChaosSpec:
    """One process's fault plan. All fields optional; unset = no fault.

    kill_rank/kill_step/kill_signal: send ``kill_signal`` to self when
      this rank enters training step ``kill_step`` (1-based, the step
      about to run). SIGKILL models preemption without grace; SIGTERM
      exercises the PreemptionGuard drain path.
    collective_k/collective_mode: on the Kth traced collective (1-based)
      either ``fail`` (raise :class:`ChaosCollectiveError`) or ``delay``
      (sleep ``collective_delay_s`` — a straggler/wedge, which a
      configured ``collective_timeout_s`` should catch).
    stall_input_step/stall_input_s: sleep inside the input pipeline at
      the given batch pull (1-based) — models a slow data source.
    net_*: the transport fault family, evaluated inside the serving
      channels (serving/transport/channel.py) so faults hit real bytes
      on the wire. ``net_drop_frac`` drops that fraction of outbound
      frames (seeded by ``net_seed``); ``net_delay_ms`` sleeps before
      each outbound frame; ``net_dup`` duplicates every Nth frame;
      ``net_corrupt`` flips one payload byte of every Nth frame (the
      CRC catches it at the receiver); ``net_partition=rN:K`` blackholes
      both directions of peer N's link for its first K wire ops, then
      heals — the receiver's per-channel sequence numbers turn silent
      drops into a detectable gap.
    """

    kill_rank: Optional[int] = None
    kill_step: Optional[int] = None
    kill_signal: str = "SIGKILL"
    collective_k: Optional[int] = None
    collective_mode: str = "fail"
    collective_delay_s: float = 2.0
    collective_op: Optional[str] = None
    stall_input_step: Optional[int] = None
    stall_input_s: float = 0.0
    net_drop_frac: float = 0.0
    net_delay_ms: float = 0.0
    net_dup: Optional[int] = None
    net_corrupt: Optional[int] = None
    net_partition: Optional[str] = None
    net_seed: Optional[int] = None

    _INT_FIELDS = ("kill_rank", "kill_step", "collective_k",
                   "stall_input_step", "net_dup", "net_corrupt",
                   "net_seed")
    _FLOAT_FIELDS = ("collective_delay_s", "stall_input_s",
                     "net_drop_frac", "net_delay_ms")

    @classmethod
    def parse(cls, text: str) -> "ChaosSpec":
        """Parse ``k=v,k=v`` (the DSTPU_CHAOS format). Unknown keys are
        an error — a typoed fault that silently no-ops would make a
        chaos test pass vacuously."""
        spec = cls()
        valid = set(cls.__dataclass_fields__)
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"{CHAOS_ENV}: expected k=v, got {part!r}")
            key, val = (s.strip() for s in part.split("=", 1))
            if key not in valid or key.startswith("_"):
                raise ValueError(
                    f"{CHAOS_ENV}: unknown chaos key {key!r} "
                    f"(valid: {sorted(k for k in valid if not k.startswith('_'))})")
            if key in cls._INT_FIELDS:
                setattr(spec, key, int(val))
            elif key in cls._FLOAT_FIELDS:
                setattr(spec, key, float(val))
            else:
                setattr(spec, key, val)
        if spec.kill_signal.upper() not in _SIGNALS:
            raise ValueError(
                f"{CHAOS_ENV}: kill_signal must be SIGKILL or SIGTERM, "
                f"got {spec.kill_signal!r}")
        if spec.collective_mode not in ("fail", "delay"):
            raise ValueError(
                f"{CHAOS_ENV}: collective_mode must be fail|delay, got "
                f"{spec.collective_mode!r}")
        if not 0.0 <= spec.net_drop_frac < 1.0:
            raise ValueError(
                f"{CHAOS_ENV}: net_drop_frac must be in [0, 1), got "
                f"{spec.net_drop_frac}")
        spec.partition_target()  # validate rN:K early, not on the wire
        return spec

    def partition_target(self) -> Optional[tuple]:
        """``net_partition="rN:K"`` → (peer N, K wire ops blackholed)."""
        if not self.net_partition:
            return None
        text = self.net_partition.strip()
        try:
            peer_s, rounds_s = text.split(":", 1)
            if not peer_s.startswith("r"):
                raise ValueError
            peer, rounds = int(peer_s[1:]), int(rounds_s)
        except ValueError:
            raise ValueError(
                f"{CHAOS_ENV}: net_partition must look like rN:K "
                f"(e.g. r1:20), got {self.net_partition!r}") from None
        if rounds < 1:
            raise ValueError(
                f"{CHAOS_ENV}: net_partition rounds must be >= 1, got "
                f"{rounds}")
        return peer, rounds

    @property
    def has_net_faults(self) -> bool:
        return (self.net_drop_frac > 0.0 or self.net_delay_ms > 0.0
                or self.net_dup is not None
                or self.net_corrupt is not None
                or self.net_partition is not None)

    @classmethod
    def from_env(cls, env=None) -> Optional["ChaosSpec"]:
        text = (env or os.environ).get(CHAOS_ENV, "").strip()
        return cls.parse(text) if text else None

    def to_env(self) -> str:
        """Inverse of parse — for launchers exporting to children."""
        parts = []
        for key in self.__dataclass_fields__:
            if key.startswith("_"):
                continue
            val = getattr(self, key)
            default = self.__dataclass_fields__[key].default
            if val != default:
                parts.append(f"{key}={val}")
        return ",".join(parts)


class ChaosInjector:
    """Evaluates a :class:`ChaosSpec` at the engine/comm hook points."""

    def __init__(self, spec: Optional[ChaosSpec] = None,
                 rank: Optional[int] = None):
        self.spec = spec
        self.rank = rank
        self._collective_n = 0
        self._input_n = 0
        self._wire_n = 0
        self._partition_n = 0
        self._net_rng = random.Random(
            spec.net_seed if spec is not None
            and spec.net_seed is not None else 0)
        self.net_stats = {"dropped": 0, "duplicated": 0, "corrupted": 0,
                          "delayed": 0, "partitioned": 0}
        self._lock = threading.Lock()

    @property
    def armed(self) -> bool:
        return self.spec is not None

    def _resolve_rank(self) -> int:
        if self.rank is not None:
            return self.rank
        for var in ("RANK", "PROCESS_ID"):
            v = os.environ.get(var)
            if v is not None:
                try:
                    return int(v)
                except ValueError:
                    pass
        return 0

    # -- hooks ---------------------------------------------------------
    def on_step(self, step: int) -> None:
        """Engine calls at step entry (before dispatch)."""
        s = self.spec
        if s is None or s.kill_step is None:
            return
        if s.kill_rank is not None and self._resolve_rank() != s.kill_rank:
            return
        if step != s.kill_step:
            return
        sig = _SIGNALS[s.kill_signal.upper()]
        self._record("chaos_kill", step=step, sig=s.kill_signal,
                     rank=self._resolve_rank())
        logger.warning(f"chaos: killing rank {self._resolve_rank()} with "
                       f"{s.kill_signal} at step {step}")
        if sig == signal.SIGKILL:
            self._dump_flight("chaos_kill")  # SIGKILL leaves no handler
        os.kill(os.getpid(), sig)
        if sig == signal.SIGTERM:
            # SIGTERM is deliverable but deferred until the interpreter
            # checks — with a PreemptionGuard installed the handler just
            # flags; the step proceeds and the drain happens at the next
            # boundary, which is exactly the production sequence.
            time.sleep(0)

    def on_collective(self, op: str) -> None:
        """comm layer calls per traced collective."""
        s = self.spec
        if s is None or s.collective_k is None:
            return
        if s.collective_op and s.collective_op != op:
            return
        with self._lock:
            self._collective_n += 1
            n = self._collective_n
        if n != s.collective_k:
            return
        if s.collective_mode == "delay":
            self._record("chaos_collective_delay", op=op, k=n,
                         delay_s=s.collective_delay_s)
            logger.warning(f"chaos: delaying collective #{n} ({op}) by "
                           f"{s.collective_delay_s}s")
            time.sleep(s.collective_delay_s)
            return
        self._record("chaos_collective_fail", op=op, k=n)
        raise ChaosCollectiveError(
            f"chaos: injected failure of collective #{n} ({op})")

    def on_input_batch(self) -> None:
        """Input pipeline calls per microbatch pull."""
        s = self.spec
        if s is None or s.stall_input_step is None:
            return
        with self._lock:
            self._input_n += 1
            n = self._input_n
        if n != s.stall_input_step or s.stall_input_s <= 0:
            return
        self._record("chaos_input_stall", pull=n, stall_s=s.stall_input_s)
        logger.warning(f"chaos: stalling input pull #{n} by "
                       f"{s.stall_input_s}s")
        time.sleep(s.stall_input_s)

    # -- transport wire hooks ------------------------------------------
    def _partition_drops(self, peer: Optional[int]) -> bool:
        """True while ``peer``'s link is blackholed (counts one wire op
        against the partition window)."""
        target = self.spec.partition_target()
        if target is None or peer is None or peer != target[0]:
            return False
        with self._lock:
            if self._partition_n >= target[1]:
                return False
            self._partition_n += 1
        self.net_stats["partitioned"] += 1
        self._record("chaos_net_partition", peer=peer,
                     op=self._partition_n, window=target[1])
        return True

    def on_wire_tx(self, frame: bytes,
                   peer: Optional[int] = None) -> List[bytes]:
        """Channel send hook: one encoded frame in, the frames that
        actually hit the wire out ([] = dropped, two = duplicated)."""
        s = self.spec
        if s is None or not s.has_net_faults:
            return [frame]
        if self._partition_drops(peer):
            return []
        with self._lock:
            self._wire_n += 1
            n = self._wire_n
            dropped = (s.net_drop_frac > 0.0
                       and self._net_rng.random() < s.net_drop_frac)
        if dropped:
            self.net_stats["dropped"] += 1
            self._record("chaos_net_drop", peer=peer, frame=n)
            return []
        out = [frame]
        if s.net_dup and n % s.net_dup == 0:
            self.net_stats["duplicated"] += 1
            self._record("chaos_net_dup", peer=peer, frame=n)
            out = [frame, frame]
        if s.net_corrupt and n % s.net_corrupt == 0:
            body = len(frame) - _FRAME_HEADER_BYTES
            if body > 0:
                i = _FRAME_HEADER_BYTES + body // 2
                out = [fr[:i] + bytes([fr[i] ^ 0xFF]) + fr[i + 1:]
                       for fr in out]
                self.net_stats["corrupted"] += 1
                self._record("chaos_net_corrupt", peer=peer, frame=n)
        if s.net_delay_ms > 0.0:
            self.net_stats["delayed"] += 1
            time.sleep(s.net_delay_ms / 1e3)
        return out

    def on_wire_rx(self, chunk: bytes,
                   peer: Optional[int] = None) -> Optional[bytes]:
        """Channel recv hook: raw bytes in, bytes to feed the frame
        reader out (None = blackholed by a partition)."""
        s = self.spec
        if s is None or s.net_partition is None:
            return chunk
        return None if self._partition_drops(peer) else chunk

    # -- flight recorder + fleet journal (best-effort) ------------------
    def _record(self, kind: str, **fields) -> None:
        try:
            from deepspeed_tpu_torch.observability.flight_recorder import \
                get_flight_recorder

            get_flight_recorder().record(kind, **fields)
        except Exception:
            pass
        try:
            from deepspeed_tpu_torch.observability.journal import get_journal

            jr = get_journal()
            if jr is not None:
                # fault kind + seed + sequence position: everything a
                # replay needs to re-arm the injector and line the
                # injection up against the decisions around it
                spec = self.spec
                seed = (spec.net_seed if spec is not None else None)
                jr.chaos(kind, seed=seed, rank=self.rank, **fields)
        except Exception:
            pass

    @staticmethod
    def _dump_flight(reason: str) -> None:
        try:
            from deepspeed_tpu_torch.observability.flight_recorder import \
                dump_flight_recorder

            dump_flight_recorder(reason)
        except Exception:
            pass


_INJECTOR: Optional[ChaosInjector] = None
_INJECTOR_LOCK = threading.Lock()


def get_chaos_injector() -> ChaosInjector:
    """Process-global injector; arms itself from DSTPU_CHAOS on first
    use. Inert (spec=None) when the env var is unset."""
    global _INJECTOR
    with _INJECTOR_LOCK:
        if _INJECTOR is None:
            _INJECTOR = ChaosInjector(spec=ChaosSpec.from_env())
        return _INJECTOR


def set_chaos_injector(inj: Optional[ChaosInjector]) -> None:
    """Arm (or disarm with None) the process-global injector directly —
    the in-process alternative to DSTPU_CHAOS for harnesses that inject
    transport faults on their own side of the wire (run_chaos_fleet)."""
    global _INJECTOR
    with _INJECTOR_LOCK:
        _INJECTOR = inj


def reset_chaos_injector() -> None:
    """Drop the singleton so the next access re-reads DSTPU_CHAOS
    (tests)."""
    global _INJECTOR
    with _INJECTOR_LOCK:
        _INJECTOR = None


# -- checkpoint corruption ---------------------------------------------------

def corrupt_checkpoint(ckpt_dir: str, mode: str = "flip",
                       target: Optional[str] = None) -> str:
    """Damage a checkpoint tag directory for corruption tests.

    mode:
      flip      — XOR one byte in the middle of the target file
      truncate  — drop the second half of the target file
      manifest  — overwrite the manifest with syntactically-broken JSON

    ``target`` is a path relative to ``ckpt_dir``; default picks the
    largest non-manifest file (the payload most likely to be torn).
    Returns the path of the damaged file."""
    from deepspeed_tpu_torch.resilience.manifest import MANIFEST_FILE

    if mode == "manifest":
        path = os.path.join(ckpt_dir, MANIFEST_FILE)
        with open(path, "w") as f:
            f.write('{"kind": "dstpu_checkpoint_manifest", "truncated')
        return path
    if target is None:
        best, best_size = None, -1
        for root, _dirs, files in os.walk(ckpt_dir):
            for name in files:
                if name == MANIFEST_FILE:
                    continue
                p = os.path.join(root, name)
                size = os.path.getsize(p)
                if size > best_size:
                    best, best_size = p, size
        if best is None:
            raise FileNotFoundError(f"no files to corrupt in {ckpt_dir}")
        path = best
    else:
        path = os.path.join(ckpt_dir, target)
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(0, size // 2))
    elif mode == "flip":
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path
