"""The port's expert-parallel MoE (``repro_torch.models.moe_ep``) against the
JAX package's ``moe_ffn_bsd_ep`` at p = 8, on the CPU.

The JAX side runs on 8 fake XLA host devices in one subprocess
(tests/_torch_distributed_main.py moe_ep); the port runs on 8 virtual
ranks of the CPU, where the router's wrapper takes its plain version. Both
take the same f32 inputs: the JAX package's own no-drop case
(tests/_distributed_main.py, capacity factor 8) and seeded cases at 1.25
and 0.5, where the per-(source rank, expert) capacity drops tokens.

Tolerances (f32): ``y`` 1e-5 absolute (the expert products summed in
another order: the port runs every rank's experts in one batched product,
the full F product in place of the JAX ``psum`` over "model"); ``aux``
1e-6 (a mean over 8 ranks); gradients 1e-5 absolute plus 1e-4 relative
(the same sums, back through the exchange)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_distributed_cases as cases  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, use_mesh  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402
from repro_torch.models.moe import MoE, capacity_for, moe_apply, moe_ffn_bsd  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
Y_ATOL = 1e-5
AUX_ATOL = 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
NAMES = ("router", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep") / "moe_ep.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(HERE, "_torch_distributed_main.py"),
                        "moe_ep", str(out)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and "TORCH_DISTRIBUTED_JAX_OK" in r.stdout, r.stderr[-3000:]
    z = np.load(out)
    return {k: z[k] for k in z.files}


def config(cf, **kw):
    E, K, D, F = cases.EP_DIMS
    over = dict(num_experts=E, experts_per_token=K, d_model=D, d_ff=F, moe_ep=True,
                capacity_factor=cf, param_dtype="float32")
    return get_config("phi3.5-moe-42b-a6.6b").reduced().with_overrides(**{**over, **kw})


def moe_params(cfg, z, prefix):
    m = MoE(cfg, torch.float32, "meta").to_empty(device="cpu")
    with torch.no_grad():
        for k in NAMES:
            getattr(m, k).copy_(torch.from_numpy(z[f"{prefix}|param|{k}"]))
    return m


def mesh8():
    return make_local_mesh(cases.P8, 1, device="cpu")


def run_ep(jax_ep, name, grad=False):
    cf = cases.EP_CASES[name][0]
    cfg = config(cf)
    m = moe_params(cfg, jax_ep, name)
    x = torch.from_numpy(jax_ep[f"{name}|x"]).requires_grad_(grad)
    with use_mesh(mesh8()):
        assert moe_ep.ep_applicable(cfg, x.shape[0])
        y, aux = moe_apply(x, m, cfg)
    if not grad:
        return cfg, m, x, y.detach(), aux.detach()
    loss = (y * torch.from_numpy(jax_ep[f"{name}|gy"])).sum() + cases.AUX_WEIGHT * aux
    grads = torch.autograd.grad(loss, [x] + [getattr(m, k) for k in NAMES])
    return dict(zip(("x",) + NAMES, grads))


@pytest.mark.parametrize("name", list(cases.EP_CASES))
def test_ep_forward_equals_the_reference(jax_ep, name):
    _cfg, _m, _x, y, aux = run_ep(jax_ep, name)
    np.testing.assert_allclose(y.numpy(), jax_ep[f"{name}|y"], rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(aux.numpy(), jax_ep[f"{name}|aux"], rtol=0, atol=AUX_ATOL)


@pytest.mark.parametrize("name", list(cases.EP_CASES))
def test_ep_gradients_equal_jax_grad(jax_ep, name):
    grads = run_ep(jax_ep, name, grad=True)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jax_ep[f"{name}|grad|{k}"],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_no_drop_ep_equals_the_flat_path(jax_ep):
    """At capacity factor 8 nothing drops, so EP's y is the flat path's, in
    both packages (the JAX package's own check)."""
    cfg, m, x, y, _aux = run_ep(jax_ep, "nodrop")
    y_flat, _ = moe_ffn_bsd(x, m, cfg)
    np.testing.assert_allclose(y.numpy(), y_flat.detach().numpy(), rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(jax_ep["nodrop|y"], jax_ep["nodrop|y_flat"], rtol=0,
                               atol=Y_ATOL)


def _dropped(cfg, x, m, p):
    """Assignments dropped by EP's per-source capacity and by the flat
    path's capacity over the whole batch."""
    from repro_torch.kernels.moe_route.ref import moe_route_ref

    E, K = cfg.num_experts, cfg.experts_per_token
    logits = x.reshape(-1, x.shape[-1]).float() @ m.router
    T = logits.shape[0]
    flat = int((~moe_route_ref(logits, K, capacity_for(cfg, T))[3]).sum())
    C = moe_ep.capacity_ep(cfg, T // p)
    ep = sum(int((~moe_route_ref(rows, K, C)[3]).sum()) for rows in logits.reshape(p, T // p, E))
    return ep, flat


@pytest.mark.parametrize("name", ["cf1.25", "cf0.5"])
def test_per_source_capacity_drops_other_tokens_than_the_flat_path(jax_ep, name):
    """Below the no-drop level EP drops by per-(source rank, expert)
    capacity: its y is not the flat path's, in either package, so a port
    that routed the whole batch at once would fail the reference check."""
    cfg, m, x, y, _aux = run_ep(jax_ep, name)
    ep_drops, flat_drops = _dropped(cfg, x.detach(), m, cases.P8)
    assert ep_drops > 0
    assert ep_drops != flat_drops
    y_flat, _ = moe_ffn_bsd(x.detach(), m, cfg)
    assert float((y - y_flat.detach()).abs().max()) > 100 * Y_ATOL
    assert float(np.abs(jax_ep[f"{name}|y"] - jax_ep[f"{name}|y_flat"]).max()) > 100 * Y_ATOL
    np.testing.assert_allclose(y_flat.detach().numpy(), jax_ep[f"{name}|y_flat"], rtol=0,
                               atol=Y_ATOL)


def test_router_runs_once_per_rank(jax_ep, monkeypatch):
    """The router's ordinals are the send slots only within one rank's
    rows, so each EP layer calls it once per data rank."""
    import repro_torch.kernels.moe_route as pkg

    calls = []
    real = pkg.moe_route

    def counting(logits, k, capacity, *a):
        calls.append(tuple(logits.shape))
        return real(logits, k, capacity, *a)

    monkeypatch.setattr(pkg, "moe_route", counting)
    cfg, _m, x, _y, _aux = run_ep(jax_ep, "cf1.25")
    T_loc = x.shape[0] // cases.P8 * x.shape[1]
    assert calls == [(T_loc, cfg.num_experts)] * cases.P8


@pytest.mark.parametrize("i", range(len(cases.EP_RULE)))
def test_ep_rule_equals_the_reference_at_a_divisible_batch(jax_ep, i):
    ep, shape, E = cases.EP_RULE[i]
    cfg = config(1.25, moe_ep=ep, num_experts=E)
    mesh = None if shape is None else make_local_mesh(*shape, device="cpu")
    with use_mesh(mesh):
        got = moe_ep.ep_applicable(cfg, cases.EP_RULE_BATCH)
    assert got == bool(jax_ep["rule"][i])


@pytest.mark.parametrize("i", range(len(cases.EP_FLAT_SHAPES)))
def test_batch_the_data_axis_cannot_split_takes_the_flat_path(jax_ep, i):
    """Batch 4 on 8 data ranks (a prefill, and decode at 4 slots): the JAX
    ``moe_apply`` tries EP, catches its error and runs flat; the port's rule
    takes flat without trying, with the same results."""
    cfg = config(1.25)
    m = moe_params(cfg, jax_ep, "flat")
    x = torch.from_numpy(jax_ep[f"flat{i}|x"])
    assert bool(jax_ep[f"flat{i}|same_as_flat"])
    with use_mesh(mesh8()):
        assert not moe_ep.ep_applicable(cfg, x.shape[0])
        y, aux = moe_apply(x, m, cfg)
    y_flat, aux_flat = moe_ffn_bsd(x, m, cfg)
    assert torch.equal(y, y_flat) and torch.equal(aux, aux_flat)
    np.testing.assert_allclose(y.detach().numpy(), jax_ep[f"flat{i}|y"], rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(aux.detach().numpy(), jax_ep[f"flat{i}|aux"], rtol=0,
                               atol=AUX_ATOL)


def test_an_error_inside_ep_raises(jax_ep, monkeypatch):
    """No fallback: an error inside the EP path reaches the caller."""
    def broken(ctx, x):
        raise RuntimeError("exchange lost")

    from repro_torch.core import comm

    monkeypatch.setattr(comm, "alltoall", broken)
    with pytest.raises(RuntimeError, match="exchange lost"):
        run_ep(jax_ep, "nodrop")


def test_ep_outside_its_rule_raises():
    cfg = config(1.25)
    m = MoE(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    x = torch.zeros(4, 2, cfg.d_model)
    with use_mesh(mesh8()), pytest.raises(ValueError, match="batch % p"):
        moe_ep.moe_ffn_bsd_ep(x, m, cfg)
    with pytest.raises(ValueError, match="ambient mesh"):
        moe_ep.moe_ffn_bsd_ep(torch.zeros(8, 2, cfg.d_model), m, cfg)


def test_moe_apply_has_no_fallback_handler():
    import inspect

    from repro_torch.models import moe

    assert "except" not in inspect.getsource(moe.moe_apply)
    assert "except" not in inspect.getsource(moe_ep)
