"""Port MoE dispatch (``parallel/moe.py``) against the JAX dropless
dispatch on the same inputs.

fp32 on the CPU: the port's grouped matmuls run their plain versions,
the JAX ones the Pallas kernel in interpret mode. Inputs come from numpy
seeds. Tolerances: outputs atol 2e-5 / rtol 2e-4 (the JAX tests'
dropless-vs-einsum bound: fp32 sums in other orders, and the port's
combine sums each token's k rows in a fixed order where JAX
scatter-adds), aux loss rtol 1e-5, gradients atol 1e-4 / rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.parallel import moe as jmoe
from deepspeed_tpu_torch.parallel import moe

OUT_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(E, activation, B=2, S=24, H=32, F=48, seed=0, router=None):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = normal(B, S, H)
    router = normal(H, E, scale=0.3) if router is None else router
    experts = {"wi": normal(E, H, F, scale=0.1),
               "wo": normal(E, F, H, scale=0.1)}
    if activation == "swiglu":
        experts["wg"] = normal(E, H, F, scale=0.1)
    return x, router, experts


def _jax(x, router, experts, gate, activation):
    out, aux = jmoe.moe_ffn_dropless(
        jnp.asarray(x), jnp.asarray(router),
        {k: jnp.asarray(v) for k, v in experts.items()},
        jmoe.GateConfig(**dataclasses.asdict(gate)), activation=activation)
    return np.asarray(out), {k: np.asarray(v) for k, v in aux.items()}


def _port(x, router, experts, gate, activation, grad=False):
    t = {k: torch.from_numpy(v).requires_grad_(grad)
         for k, v in dict(experts, x=x, router=router).items()}
    out, aux = moe.moe_ffn_dropless(
        t["x"], t["router"], {k: t[k] for k in experts}, gate,
        activation=activation)
    return out, aux, t


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (8, 2), (8, 4)])
def test_dropless_matches_jax(E, k, activation):
    gate = moe.GateConfig(num_experts=E, top_k=k)
    x, router, experts = _inputs(E, activation, seed=E + k)
    want, want_aux = _jax(x, router, experts, gate, activation)
    out, aux, _ = _port(x, router, experts, gate, activation)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), want, **OUT_TOL)
    np.testing.assert_allclose(aux["l_aux"].item(), want_aux["l_aux"],
                               rtol=1e-5)
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  want_aux["expert_load"])
    assert aux["expert_load"].sum().item() == pytest.approx(k)
    for key in ("ep_dropped_frac", "dispatch_digest_mismatch"):
        assert aux[key].item() == 0.0 == float(want_aux[key])


@pytest.mark.parametrize("activation,E,k", [("swiglu", 4, 2),
                                            ("gelu", 8, 4)])
def test_router_and_expert_gradients_match_jax(activation, E, k):
    gate = moe.GateConfig(num_experts=E, top_k=k, z_loss_weight=1e-3)
    x, router, experts = _inputs(E, activation, seed=11)
    cot = np.random.default_rng(12).standard_normal(x.shape).astype(
        np.float32)
    jgate = jmoe.GateConfig(**dataclasses.asdict(gate))

    def jloss(x, router, experts):
        out, aux = jmoe.moe_ffn_dropless(x, router, experts, jgate,
                                         activation=activation)
        return jnp.sum(out * cot) + aux["l_aux"] + aux["l_zloss"]

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(router),
        {n: jnp.asarray(v) for n, v in experts.items()})
    out, aux, t = _port(x, router, experts, gate, activation, grad=True)
    ((out * torch.from_numpy(cot)).sum() + aux["l_aux"]
     + aux["l_zloss"]).backward()
    np.testing.assert_allclose(t["x"].grad.numpy(), np.asarray(want[0]),
                               **GRAD_TOL)
    np.testing.assert_allclose(t["router"].grad.numpy(), np.asarray(want[1]),
                               **GRAD_TOL)
    for name in experts:
        np.testing.assert_allclose(t[name].grad.numpy(),
                                   np.asarray(want[2][name]), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("tie", ["all-equal", "duplicated-columns"])
def test_tied_router_picks_the_same_experts_as_jax(tie):
    """Ties go to the lower expert id first, as lax.top_k orders them."""
    E, k, H = 4, 2, 32
    if tie == "all-equal":
        router = np.zeros((H, E), np.float32)
    else:  # experts 1 and 3 always tie; 0 and 2 tie with each other
        base = np.random.default_rng(5).standard_normal((H, 2)).astype(
            np.float32)
        router = np.concatenate([base, base], axis=1)
    gate = moe.GateConfig(num_experts=E, top_k=k)
    x, _, experts = _inputs(E, "swiglu", router=router, seed=6)
    want, want_aux = _jax(x, router, experts, gate, "swiglu")
    out, aux, _ = _port(x, router, experts, gate, "swiglu")
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  want_aux["expert_load"])
    np.testing.assert_allclose(out.numpy(), want, **OUT_TOL)
    gates = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router),
                          -1)
    _, idx = moe.top_k(gates, k)
    if tie == "all-equal":
        assert torch.all(idx == torch.tensor([0, 1]))
    else:  # the pair's lower id comes first
        assert torch.all(idx[..., 0] < idx[..., 1])


def test_imbalanced_routing_drops_nothing():
    """Router biased hard toward expert 0: every token is still routed to
    k experts and gets a nonzero output (the JAX dropless test's
    analogue)."""
    E, k, H = 8, 2, 32
    router = np.zeros((H, E), np.float32)
    router[:, 0] = 1.0
    gate = moe.GateConfig(num_experts=E, top_k=k, capacity_factor=1.0)
    x, _, _ = _inputs(E, "swiglu", S=64, router=router, seed=7)
    x = np.abs(x)  # expert 0 scores highest for every token
    experts = {n: np.full(s, 0.05, np.float32) for n, s in
               (("wi", (E, H, 48)), ("wo", (E, 48, H)), ("wg", (E, H, 48)))}
    want, want_aux = _jax(x, router, experts, gate, "swiglu")
    out, aux, _ = _port(x, router, experts, gate, "swiglu")
    np.testing.assert_allclose(out.numpy(), want, **OUT_TOL)
    load = aux["expert_load"]
    assert load.sum().item() == pytest.approx(k)
    assert load[0].item() == 1.0  # every token, k / E = 0.25 if balanced
    assert int((out.reshape(-1, H).norm(dim=-1) < 1e-7).sum()) == 0


def test_moe_ffn_dispatch_and_unported_paths():
    E = 4
    gate = moe.GateConfig(num_experts=E, top_k=2)
    x, router, experts = _inputs(E, "swiglu", seed=8)
    args = (torch.from_numpy(x), torch.from_numpy(router),
            {n: torch.from_numpy(v) for n, v in experts.items()}, gate)
    a, _ = moe.moe_ffn(*args, impl="auto")
    b, _ = moe.moe_ffn(*args, impl="grouped")
    assert torch.equal(a, b)
    # the einsum dispatch is ported (tests/test_torch_moe_ep.py holds it
    # and top_k_gating against JAX)
    c, _ = moe.moe_ffn(*args, impl="einsum")
    assert c.shape == a.shape and bool(torch.isfinite(c).all())
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe_ffn(*args, impl="bogus")
    with pytest.raises(ValueError, match="experts per ep rank"):
        moe._dropless_shard_core(*args, "swiglu", ep=2)
    # tp-split experts: each tp rank's F/2 of every expert gives a
    # partial sum (one process has no tp ranks to reduce over, so the
    # core returns it), and the two partials sum to the whole FFN, as
    # JAX's psum over tp does; the ranks routed alike (digest 0)
    x_, router_, experts_, cfg_ = args
    F_ = experts_["wi"].shape[-1]
    halves = []
    for lo in (0, F_ // 2):
        part = {k: (v[..., lo:lo + F_ // 2] if k != "wo"
                    else v[:, lo:lo + F_ // 2]) for k, v in experts_.items()}
        y_, st_ = moe._dropless_shard_core(x_, router_, part, cfg_,
                                           "swiglu", tp=2)
        assert float(st_["dispatch_digest_mismatch"][0]) == 0.0
        halves.append(y_)
    np.testing.assert_allclose((halves[0] + halves[1]).numpy(), a.numpy(),
                               rtol=1e-5, atol=1e-5)
    for tokens, g, train in ((64, gate, True), (64, gate, False),
                             (3, gate, True),
                             (64, dataclasses.replace(gate, drop_tokens=False),
                              True)):
        assert moe.compute_capacity(tokens, g, train) == \
            jmoe.compute_capacity(
                tokens, jmoe.GateConfig(**dataclasses.asdict(g)), train)
