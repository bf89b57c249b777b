"""ZeRO++, the 1-bit optimizers and a client optimizer at tp, sp and pp on
2 and 4 ranks (gloo) against JAX's engine on the same config and mesh of
CPU devices: each combination trains, disarms a quantized part with
JAX's warning and counter (then equal, ``==``, to the exact step on the
same mesh), or raises JAX's error, as JAX's engine does.

The model and the bounds are ``tests/torch_zeropp_3d_cases.py``'s. One
launch a world size serves the file; each JAX engine runs in a process of
its own.

JAX's 1-bit step fails at sp (a sharding constraint of the model's sp
path names the manual dp axis: ROADMAP C), while its design has tp and
sp under GSPMD; the port trains it, held to JAX's run at the same dp
without sp (the same global batch and step).
"""

import numpy as np
import pytest
import torch

import torch_zeropp_3d_cases as C

QW = dict(zero_quantized_weights=True)
QG = dict(zero_quantized_gradients=True)
QAR = dict(zero_quantized_allreduce=True)
F2T2 = {"fsdp": 2, "tp": 2, "dp": 1}
F2S2 = {"fsdp": 2, "sp": 2, "dp": 1}
F2P2 = {"fsdp": 2, "pp": 2, "dp": 1}
D2T2 = {"dp": 2, "tp": 2, "fsdp": 1}
SP2 = {"sp": 2, "dp": 1}
PP2 = {"pp": 2, "dp": 1}
WIRED = "ZeRO++ flags (qwZ/qgZ) are wired for"
ONEBIT = C.onebit(2, lr=1e-2)
QGZ_OFF = "ZeRO++ qgZ at stage 3 requires no optimizer offload"

RUNS = [
    # qgZ at pp: disarmed with JAX's warning and counter, == the exact
    # stage on the same mesh
    C.run("exact3_p2f2", C.z(3), F2P2),
    C.run("qgz3_p2f2", C.z(3, **QG), F2P2),
    # qgZ at stage 2 with tp, qwZ at sp, qar at tp
    C.run("qgz2_f2t2", C.z(2, **QG), F2T2),
    C.run("qwz3_f2s2", C.z(3, **QW), F2S2, over=C.SP),
    C.run("qar_d2t2", C.z(1, **QAR), D2T2),
    dict(C.run("qar_chunked", C.z(1, **QAR), D2T2), chunk_elems=2048),
    # the 1-bit optimizers through compression (freeze_step 2, 4 steps;
    # lr 1e-2, as tests/test_torch_zeropp.py's: at 1e-3 a compression
    # scale off by a few percent moves no weight past atol)
    C.run("onebit_d2t2", ONEBIT, D2T2, steps=4),
    C.run("onebitlamb_d2t2", C.onebit(2, "onebitlamb", lr=1e-2), D2T2,
          steps=4),
    C.run("onebit_d2s2", ONEBIT, {"dp": 2, "sp": 2}, steps=4, over=C.SP),
    C.run("onebit_d2p2", C.onebit(2), {"dp": 2, "pp": 2}, raises=True),
    # a client optimizer (torch AdamW; JAX: optax.adamw)
    C.run("client_f2t2", C.z(1), F2T2, client=1e-3),
    C.run("client_f2s2", C.z(1), F2S2, over=C.SP, client=1e-3),
    C.run("client_f2p2", C.z(1), F2P2, client=1e-3),
    # a model built as each rank's tp slice of a seeded draw against the
    # whole draw: the flat step, the 1-bit step and a client optimizer
    # take their whole-leaf state from the slices
    *[dict(C.run(f"{name}_{built}", cfg, D2T2, **kw), seeded=built)
      for name, cfg, kw in (
          ("seeded_flat", C.z(1, **QG, **QW), {}),
          ("seeded_onebit", C.onebit(1), {"steps": 3}),
          ("seeded_client", C.z(1), {"client": 1e-3}))
      for built in ("whole", "tp")],
    # item 17's other bullets still raise: the host tiers and the
    # whole-leaf optimizers at tp / sp / pp
    C.run("offload_t2", C.z(3, offload_optimizer={"device": "cpu"}), F2T2,
          raises=True),
    C.run("zenflow_s2", C.z(2, offload_optimizer={"device": "cpu"},
                            zenflow={"topk_ratio": 0.1}), F2S2,
          over=C.SP, raises=True),
    C.run("lamb_p2", {"optimizer": {"type": "lamb", "params": {
        "lr": 1e-3}}, **C.z(2)}, F2P2, raises=True),
]
# the ZeRO++ flags at sp 2 and pp 2, stages 1-2: the stage 1-2 step does
# not arm there, JAX warns and runs the standard step (qar alone: no
# warning)
FLAG_CASES = {
    "flat1_s2": (C.z(1, **QG, **QW), SP2, "exact1_s2", True),
    "flat2_s2": (C.z(2, **QG), SP2, "exact2_s2", True),
    "flat1_p2": (C.z(1, **QG), PP2, "exact1_p2", True),
    "flat2_p2": (C.z(2, **QG, **QW), PP2, "exact2_p2", True),
    "qar_s2": (C.z(1, **QAR), SP2, "exact1_s2", False),
}
for _name, (_cfg, _mesh, _exact, _) in FLAG_CASES.items():
    _over = C.SP if "sp" in _mesh else None
    RUNS.append(C.run(_name, _cfg, _mesh, over=_over))
    if not any(r["name"] == _exact for r in RUNS):
        RUNS.append(C.run(_exact, C.z(int(_exact[5])), _mesh, over=_over))
BY_NAME = {r["name"]: r for r in RUNS}
RAISES = ("offload_t2", "zenflow_s2", "lamb_p2")
JAX_SPECS = {n: r for n, r in BY_NAME.items()
             if n not in RAISES + ("qar_chunked",)
             and not n.startswith(("exact", "seeded"))}
# JAX's 1-bit step at sp raises (ROADMAP C); the same step at dp 2
JAX_SPECS["onebit_d2s2"] = C.run("onebit_d2s2", ONEBIT, {"dp": 2},
                                 steps=4)
JAX_SPECS["onebit_sp_fault"] = C.run("onebit_d2s2", C.onebit(2),
                                     {"dp": 2, "sp": 2}, over=C.SP,
                                     raises=True)


@pytest.fixture(scope="module")
def zs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zeropp_3d_small")
    ref, port = C.run_all(root, RUNS, JAX_SPECS, (2, 4))
    return {"jax": ref, "port": port}


def _runs(zs, name):
    world = BY_NAME[name]["worlds"][0]
    return [out["engines"][name] for out in zs["port"][world]]


def test_qgz_at_pp_disarms_as_jax(zs):
    """qgZ at stage 3 on pp 2 x fsdp 2: JAX's rule leaves it off, counts
    ``zeropp.qgz_disabled`` once and warns; the step equals the exact
    stage 3 on the same mesh."""
    ref = zs["jax"]["qgz3_p2f2"]
    assert ref["telemetry"]["zeropp.qgz_disabled"] == 1
    exact = _runs(zs, "exact3_p2f2")
    for got, want in zip(_runs(zs, "qgz3_p2f2"), exact):
        assert got["flags"] == ref["flags"]
        assert got["telemetry"].get("zeropp.qgz_disabled") == 1
        for words in (QGZ_OFF, WIRED):
            mine = [m for m in got["warnings"] if m.startswith(words)]
            theirs = [m for m in ref["warnings"] if m.startswith(words)]
            assert mine == theirs and len(mine) == 1, (mine, theirs)
        assert got["losses"] == want["losses"]
        for key, value in want["params"].items():
            np.testing.assert_array_equal(got["params"][key], value, key)
        C.follows_exactly(got, ref)


@pytest.mark.parametrize("name", ["qgz2_f2t2", "qwz3_f2s2", "qar_d2t2"])
def test_zeropp_part_follows_jax(zs, name):
    ref = zs["jax"][name]
    for got in _runs(zs, name):
        assert got["flags"] == ref["flags"], (got["flags"], ref["flags"])
        assert got["mesh"] == ref["mesh"]
        C.follows(got, ref)


def test_qar_in_chunks_equals_one_call(zs):
    """qar's two quantized hops over row ranges of the ranks' blocks give
    the bits of one call over each leaf."""
    for got, want in zip(_runs(zs, "qar_chunked"), _runs(zs, "qar_d2t2")):
        assert got["counts"]["qar_scatter"] > want["counts"]["qar_scatter"]
        assert got["losses"] == want["losses"]
        for key, value in want["params"].items():
            np.testing.assert_array_equal(got["params"][key], value, key)


@pytest.mark.parametrize("name", ["seeded_flat", "seeded_onebit",
                                  "seeded_client"])
def test_model_built_as_tp_slices_equals_the_whole_model(zs, name):
    """A model each rank builds as its tp slice of the seeded draw
    (``get_model(..., tp=(rank, 2))``, as the card's phase 21 does)
    trains bit for bit as the whole draw the engine slices itself."""
    for got, want in zip(_runs(zs, f"{name}_tp"), _runs(zs, f"{name}_whole")):
        assert got["losses"] == want["losses"]
        for key, value in want["params"].items():
            np.testing.assert_array_equal(got["params"][key], value, key)


@pytest.mark.parametrize("name", list(FLAG_CASES))
def test_zeropp_flags_at_sp_and_pp_warn_and_run_the_exact_step(zs, name):
    """JAX's "wired for" warning (``tests/test_zeropp.py:165``) where the
    flags have nothing to carry them, none for qar alone, and the
    standard step: ``==`` the exact run on the same mesh."""
    _, _, exact, warns = FLAG_CASES[name]
    ref = zs["jax"][name]
    theirs = [m for m in ref["warnings"] if m.startswith(WIRED)]
    assert len(theirs) == (1 if warns else 0)
    for got, want in zip(_runs(zs, name), _runs(zs, exact)):
        assert got["flags"] == ref["flags"] and not any(got["flags"].values())
        assert [m for m in got["warnings"] if m.startswith(WIRED)] == theirs
        assert got["losses"] == want["losses"]
        for key, value in want["params"].items():
            np.testing.assert_array_equal(got["params"][key], value, key)
        C.follows_exactly(got, ref)


@pytest.mark.parametrize("name", ["onebit_d2t2", "onebitlamb_d2t2",
                                  "onebit_d2s2"])
def test_onebit_follows_jax_through_compression(zs, name):
    """1-bit Adam / Lamb at tp 2 (the compression scale and the norms of
    the whole leaf) and 1-bit Adam at sp 2 (the sequence blocks'
    gradients summed first), through the freeze at step 2."""
    ref = zs["jax"][name]
    for got in _runs(zs, name):
        assert got["flags"]["_onebit"]
        C.follows(got, ref)
        # the compressed momentum: each element is a mean of the ranks'
        # sign x scale, so a scale of the rank's slice instead of the
        # whole leaf's shows here first (a sign may flip at c = 0)
        C.leaves_follow(got["onebit_m"], ref["onebit_m"], 1e-4, 1e-8,
                        bound=np.inf)


def test_onebit_at_sp_is_a_jax_fault(zs):
    """What ROADMAP C records: JAX's 1-bit step raises at dp 2 x sp 2 (so
    the port's run there is held to JAX's at dp 2)."""
    kind, words = zs["jax"]["onebit_sp_fault"]["raised"]
    assert kind == "ValueError" and "manual axes" in words


def test_onebit_at_pp_raises_jax_error(zs):
    kind, words = zs["jax"]["onebit_d2p2"]["raised"]
    assert kind == "ValueError"
    assert "should match the mesh passed to shard_map" in words
    for got in _runs(zs, "onebit_d2p2"):
        assert got["raised"][0] == "ValueError"
        assert "should match the mesh passed to shard_map" in \
            got["raised"][1]


@pytest.mark.parametrize("name", ["client_f2t2", "client_f2s2",
                                  "client_f2p2"])
def test_client_optimizer_follows_jax_optax(zs, name):
    """A client torch AdamW at tp, sp and pp steps the whole tree on every
    rank, as JAX's optax.adamw does under GSPMD."""
    ref = zs["jax"][name]
    for got in _runs(zs, name):
        C.follows_exactly(got, ref)


@pytest.mark.parametrize("name", RAISES)
def test_item_17_leftovers_raise(zs, name):
    for got in _runs(zs, name):
        kind, words = got["raised"]
        assert kind == "NotImplementedError" and "item 17" in words, words


class _ThreadComm:
    """The tp collectives ``zeropp.TpSlices`` issues, among threads (one
    a rank): each call waits for every rank's operand."""

    def __init__(self, n):
        import threading

        self.n, self.barrier = n, threading.Barrier(n)
        self.slots = [None] * n
        self.local = threading.local()

    def _exchange(self, x):
        self.slots[self.local.rank] = x.clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def broadcast(self, x, axis, root=0, log_name=None):
        return self._exchange(x)[root]

    def all_gather(self, x, axis, tiled=True, log_name=None):
        return torch.stack(self._exchange(x))


@pytest.mark.parametrize("shape,dim", [((6, 10), 0), ((6, 10), 1),
                                       ((3, 4, 6), 1), ((2, 3, 8), 2)])
def test_tp_slices_read_and_write_whole_ranges(monkeypatch, shape, dim):
    """Any flat range of a whole leaf read from the ranks' tp slices, and
    written back into them, ranges that straddle two ranks' slices
    included: what ``zeropp.FlatPartition`` does at tp > 1 instead of
    gathering the whole leaf."""
    import threading

    from deepspeed_tpu_torch.runtime import zeropp

    tp = 2
    fake = _ThreadComm(tp)
    monkeypatch.setattr(zeropp, "comm", fake)
    whole = torch.arange(float(np.prod(shape))).reshape(shape)
    n = whole.numel()
    ranges = [(0, n), (1, n - 1), (n // 2 - 3, n // 2 + 5), (0, 1),
              (n - 1, n), (n // 3, n // 3 + 7)]
    got, errors = {}, []

    def rank(r):
        try:
            fake.local.rank = r
            tps = zeropp.TpSlices(shape, dim, tp, r)
            local = whole.chunk(tp, dim)[r].contiguous()
            got[r, "read"] = [tps.read(local, lo, hi) for lo, hi in ranges]
            out = torch.zeros_like(local)
            for lo, hi in ranges[:1]:
                tps.write(out, lo, hi, -whole.reshape(-1)[lo:hi])
            got[r, "write"] = out
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            fake.barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    flat = whole.reshape(-1)
    for r in range(tp):
        for (lo, hi), x in zip(ranges, got[r, "read"]):
            assert torch.equal(x, flat[lo:hi]), (r, lo, hi)
        assert torch.equal(got[r, "write"], -whole.chunk(tp, dim)[r])
