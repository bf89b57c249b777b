"""ZeRO++ on 3D meshes at 8 ranks (gloo) against JAX's engine on the same
config and mesh of 8 CPU devices: dry-run config D (stage-3 qwZ at pp 2 x
fsdp 2 x tp 2, ``__graft_entry__.py:174-215``), qwZ's int8 gather at tp
and inside the pipeline's stages, qgZ at tp and sp, the stage 1-2 flat
step at tp, and hpZ / MiCS with tp or pp beside the group.

The model and the bounds are ``tests/torch_zeropp_3d_cases.py``'s: every
run trains config D's model from JAX's init (fp32) on the same global
batches; a quantized run follows JAX within ``test_torch_zeropp.py``'s
tie rule, an exact one at rtol 1e-5 / atol 1e-4. One launch of 8 ranks
serves the file; each JAX engine runs in a process of its own.
"""

import numpy as np
import pytest

import torch_zeropp_3d_cases as C

QW = dict(zero_quantized_weights=True)
QG = dict(zero_quantized_gradients=True)
TP2 = {"tensor_parallel": {"autotp_size": 2}}
PP2 = {"pipeline": {"stages": 2}}

RUNS = [
    # config D verbatim over the parity config (micro 1, GAS 2, AdamW lr
    # 1e-3, its model with remat off, 33-token rows)
    C.run("config_d", C.z(3, **QW), {"pp": 2, "fsdp": 2, "tp": 2, "dp": 1},
          micro=1, gas=2, masters=True),
    # qwZ stage 3 at fsdp 4 x tp 2 (JAX tests/test_zeropp.py:225) and
    # at pp 2 x fsdp 4 (tests/test_pipeline.py:273)
    C.run("qwz3_f4t2", C.z(3, **QW), {"fsdp": 4, "tp": 2, "dp": 1},
          masters=True),
    C.run("qwz3_p2f4", C.z(3, **QW), {"pp": 2, "fsdp": 4, "dp": 1},
          masters=True),
    # qgZ at stage 3: with qwZ at fsdp 4 x tp 2
    # (tests/test_qgz_stage3.py:72), at fsdp 4 x sp 2 (:123) and at
    # fsdp 2 x tp 2 x sp 2 (the card's phase 21b)
    C.run("qgz3_qwz_f4t2", C.z(3, **QW, **QG),
          {"fsdp": 4, "tp": 2, "dp": 1}),
    C.run("qgz3_f4s2", C.z(3, **QG), {"fsdp": 4, "sp": 2, "dp": 1},
          over=C.SP),
    C.run("qgz3_qwz_f2t2s2", C.z(3, **QW, **QG),
          {"fsdp": 2, "tp": 2, "sp": 2, "dp": 1}, over=C.SP),
    # the stage 1-2 flat step at dp 4 x tp 2 (tests/test_zeropp.py:274),
    # and stage 1 qgZ there against dp 8 (:287)
    C.run("flat2_qgz_qwz_d4t2", C.z(2, **QG, **QW),
          {"dp": 4, "tp": 2, "fsdp": 1}),
    # the same in chunks of 4096 elements a call (4 rows of each rank's
    # block): the values of one call over the leaf
    dict(C.run("flat2_chunked", C.z(2, **QG, **QW),
               {"dp": 4, "tp": 2, "fsdp": 1}), chunk_elems=4096),
    C.run("flat1_qgz_d4t2", C.z(1, **QG), {"dp": 4, "tp": 2, "fsdp": 1}),
    C.run("flat1_qgz_d8", C.z(1, **QG), {"dp": 8, "fsdp": 1}),
    # hpZ / MiCS: fsdp = the group, dp = the replicas, tp or pp beside
    # them (the engines' default mesh)
    C.run("hpz_t2", {**C.z(3, zero_hpz_partition_size=2), **TP2},
          {"fsdp": 2, "dp": 2, "tp": 2}, default_mesh=True),
    C.run("hpz_p2", {**C.z(3, zero_hpz_partition_size=2), **PP2},
          {"fsdp": 2, "dp": 2, "pp": 2}, default_mesh=True),
    C.run("mics_t2", {**C.z(2, mics_shard_size=2), **TP2},
          {"fsdp": 2, "dp": 2, "tp": 2}, default_mesh=True),
    C.run("mics_p2", {**C.z(2, mics_shard_size=2), **PP2},
          {"fsdp": 2, "dp": 2, "pp": 2}, default_mesh=True),
]
BY_NAME = {r["name"]: r for r in RUNS}
JAX_SPECS = {n: r for n, r in BY_NAME.items() if n != "flat2_chunked"}
QUANTIZED = ("config_d", "qwz3_f4t2", "qwz3_p2f4", "qgz3_qwz_f4t2",
             "qgz3_f4s2", "qgz3_qwz_f2t2s2", "flat2_qgz_qwz_d4t2",
             "flat1_qgz_d4t2", "flat1_qgz_d8")
EXACT = ("hpz_t2", "hpz_p2", "mics_t2", "mics_p2")


@pytest.fixture(scope="module")
def z3d(tmp_path_factory):
    root = tmp_path_factory.mktemp("zeropp_3d")
    ref, port = C.run_all(root, RUNS, JAX_SPECS, (8,))
    return {"jax": ref, "port": port[8]}


def _runs(z3d, name):
    return [out["engines"][name] for out in z3d["port"]]


def test_config_d_trains_and_follows_jax(z3d):
    """Dry-run config D: qwZ armed on pp x fsdp x tp with nothing
    disabled; the losses, the gathered fp32 masters and the params follow
    JAX's engine; the wire holds qwZ's int8 gathers and the stages'
    sends (JAX's s8 all-gather / collective-permute HLO check,
    ``tests/test_pipeline.py:305-343``)."""
    ref = z3d["jax"]["config_d"]
    assert ref["flags"]["_qwz_stage3"]
    assert ref["telemetry"]["zeropp.qwz_disabled"] == 0
    for got in _runs(z3d, "config_d"):
        assert got["flags"]["_qwz_stage3"] and not got["flags"]["_zeropp"]
        assert got["telemetry"].get("zeropp.qwz_disabled", 0) == 0
        assert got["mesh"] == ref["mesh"]
        C.follows(got, ref)
        C.follows(got, ref, key="masters")
        counts = got["counts"]
        assert counts.get("qwz_param_fetch", 0) > 0, counts
        assert counts.get("qwz_scales", 0) > 0, counts
        assert counts.get("pp_activation", 0) > 0, counts
        assert counts.get("pp_activation_grad", 0) > 0, counts


@pytest.mark.parametrize("name", [n for n in QUANTIZED if n != "config_d"])
def test_quantized_run_follows_jax(z3d, name):
    ref = z3d["jax"][name]
    for got in _runs(z3d, name):
        assert got["flags"] == ref["flags"], (got["flags"], ref["flags"])
        assert got["mesh"] == ref["mesh"]
        C.follows(got, ref)
        if "masters" in ref:
            C.follows(got, ref, key="masters")


@pytest.mark.parametrize("name", EXACT)
def test_hpz_and_mics_beside_tp_and_pp_follow_jax(z3d, name):
    """hpZ and MiCS are only JAX's mesh: fsdp = the group of 2, dp = the
    replicas, with tp or pp beside them; the step is the exact one."""
    ref = z3d["jax"][name]
    assert ref["mesh"] == {**{a: 1 for a in ref["mesh"]},
                           **BY_NAME[name]["mesh"]}
    for got in _runs(z3d, name):
        assert got["mesh"] == ref["mesh"]
        assert not any(got["flags"].values())
        C.follows_exactly(got, ref)


@pytest.mark.parametrize("name", ["qgz3_qwz_f4t2", "qgz3_f4s2",
                                  "qgz3_qwz_f2t2s2"])
def test_qgz_wire_is_int8_over_fsdp(z3d, name):
    """qgZ's level 1 moves int8 codes over fsdp at tp and at sp (the sp
    ranks' gradients summed full width first, not quantized)."""
    for got in _runs(z3d, name):
        assert got["flags"]["_qgz_stage3"]
        assert got["counts"].get("qgz_fsdp_int8", 0) > 0, got["counts"]


def test_flat_step_in_chunks_equals_one_call(z3d):
    """The flat step's collectives over row ranges of the ranks' blocks
    (``zeropp.flat_chunks``) give the bits of one call over each leaf:
    the same codes, scales and rank-order sums."""
    for got, want in zip(_runs(z3d, "flat2_chunked"),
                         _runs(z3d, "flat2_qgz_qwz_d4t2")):
        assert got["counts"]["qgz_dp"] > want["counts"]["qgz_dp"]
        assert got["losses"] == want["losses"]
        for key, value in want["params"].items():
            np.testing.assert_array_equal(got["params"][key], value, key)


def test_flat_step_at_tp_tracks_dp8(z3d):
    """Stage 1 qgZ at dp 4 x tp 2 follows the pure dp 8 trajectory on the
    same global batch within JAX's rtol 0.05 (a different dp degree
    groups the quantization differently)."""
    dp8 = _runs(z3d, "flat1_qgz_d8")[0]["losses"]
    for got in _runs(z3d, "flat1_qgz_d4t2"):
        assert got["flags"]["_zeropp"]
        np.testing.assert_allclose(got["losses"], dp8, rtol=C.TRACK_RTOL)


@pytest.mark.parametrize("name", [r["name"] for r in RUNS])
def test_ranks_agree(z3d, name):
    C.same_on_every_rank(z3d["port"], name)
