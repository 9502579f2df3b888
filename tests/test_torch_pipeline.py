"""The port's pipeline schedule (``repro_torch.distributed.pipeline``) against
the JAX package's ``pipeline_apply`` and against ``reference_apply``, on
the CPU.

The JAX side runs on fake XLA host devices in one subprocess
(tests/_torch_distributed_main.py pipeline): the JAX package's own case (4
stages x 8 microbatches, mb 2, d 16, ``tanh(x @ W)``), one stage and one
microbatch, fewer microbatches than stages, and a dict of stage params.
Tolerance: 1e-5 absolute (f32 products in another order)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_distributed_cases as cases  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_apply, reference_apply  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_pp_mesh  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ATOL = cases.PIPE_ATOL


@pytest.fixture(scope="module")
def jax_pipe(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline") / "pipeline.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(HERE, "_torch_distributed_main.py"),
                        "pipeline", str(out)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and "TORCH_DISTRIBUTED_JAX_OK" in r.stdout, r.stderr[-3000:]
    z = np.load(out)
    return {k: z[k] for k in z.files}


def inputs(z, name):
    x = torch.from_numpy(z[f"{name}|x"])
    if cases.PIPE_CASES[name][4]:
        prefix = f"{name}|param|"
        return {k[len(prefix):]: torch.from_numpy(z[k]) for k in z if k.startswith(prefix)}, x
    return torch.from_numpy(z[f"{name}|param"]), x


@pytest.mark.parametrize("name", list(cases.PIPE_CASES))
def test_pipeline_equals_jax_and_the_oracle(jax_pipe, name):
    S = cases.PIPE_CASES[name][0]
    params, x = inputs(jax_pipe, name)
    fn = cases.stage_fn(torch)
    got = pipeline_apply(params, x, fn, make_pp_mesh(S, device="cpu"))
    ref = reference_apply(params, x, fn)
    assert got.shape == x.shape
    assert torch.equal(got, ref)  # the same products on the same inputs
    np.testing.assert_allclose(got.numpy(), jax_pipe[f"{name}|got"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(ref.numpy(), jax_pipe[f"{name}|ref"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(jax_pipe[f"{name}|got"], jax_pipe[f"{name}|ref"], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("S,M", [(4, 8), (4, 2), (1, 3), (3, 3)])
def test_stage_fn_runs_once_per_stage_and_microbatch(S, M):
    """The bubble is skipped: stage s runs at tick t only while it holds a
    microbatch, so stage_fn runs M·S times, as in reference_apply (the JAX
    loop runs it S·(M + S − 1) times)."""
    params, x = cases.pipe_inputs("jax")
    params, x = torch.from_numpy(params[:S]), torch.from_numpy(x[:M])
    seen = []

    def fn(w, v):
        seen.append(v.clone())
        return torch.tanh(v @ w)

    pipeline_apply(params, x, fn, make_pp_mesh(S, device="cpu"))
    piped = list(seen)
    seen.clear()
    reference_apply(params, x, fn)
    assert len(piped) == len(seen) == M * S
    # every stage input the oracle saw, the pipeline saw too
    key = lambda v: v.numpy().tobytes()  # noqa: E731
    assert sorted(map(key, piped)) == sorted(map(key, seen))


def test_stage_params_as_a_module_list():
    """An ``nn.ModuleList`` of S stage modules is sliced by entry."""
    g = torch.Generator().manual_seed(0)
    stages = torch.nn.ModuleList(torch.nn.Linear(8, 8) for _ in range(3))
    x = torch.randn(4, 2, 8, generator=g)
    fn = lambda mod, v: torch.tanh(mod(v))  # noqa: E731
    with torch.no_grad():
        got = pipeline_apply(stages, x, fn, make_pp_mesh(3, device="cpu"))
        assert torch.equal(got, reference_apply(stages, x, fn))


def test_the_hop_is_the_comm_ring(monkeypatch):
    """Each tick's hop is one ``comm.ppermute`` by +1 over the stage axis."""
    from repro_torch.core import comm

    calls = []
    real = comm.ppermute

    def ring(ctx, x, shift=1):
        calls.append((ctx.axis, ctx.executors, shift))
        return real(ctx, x, shift)

    monkeypatch.setattr(comm, "ppermute", ring)
    params, x = cases.pipe_inputs("jax")
    pipeline_apply(torch.from_numpy(params), torch.from_numpy(x), cases.stage_fn(torch),
                   make_pp_mesh(4, device="cpu"))
    assert calls == [("stage", 4, 1)] * (8 + 4 - 1)


def test_stage_count_must_match_the_mesh():
    params, x = cases.pipe_inputs("jax")
    with pytest.raises(ValueError, match="stages"):
        pipeline_apply(torch.from_numpy(params), torch.from_numpy(x),
                       cases.stage_fn(torch), make_pp_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="stage"):
        pipeline_apply(torch.from_numpy(params), torch.from_numpy(x),
                       cases.stage_fn(torch), make_local_mesh(4, device="cpu"))
