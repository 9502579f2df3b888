"""The paper's evaluation apps in the port (``repro_torch.apps``) against
the JAX package's (``repro.apps``) on the same numpy inputs, on the CPU.

SHA-256 digests, Merkle roots, nonces, PageRank's vertex set, transitive
closures and assignments compare bit for bit. Float results carry the
tolerance stated at each test: K-Means centres 1e-4 absolute (the (k, d)
sums of a one-hot product in another order), PageRank ranks 1e-5 relative
(f32 sums over join results in another order), CG 1e-4 (dot products
summed in another order over 12 iterations); the stencil adds and scales
in the reference's order and compares exactly. The stencil and CG run at
p = 1 here and at p = 8 against the reference on 8 fake XLA devices
(tests/_torch_apps_main.py in a subprocess)."""
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_apps_cases as cases  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.apps import graph as jgraph  # noqa: E402
from repro.apps import kmeans as jkmeans  # noqa: E402
from repro.apps import minebench as jmine  # noqa: E402
from repro.apps import sha256 as jsha  # noqa: E402
from repro.apps import stencil as jstencil  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.apps import graph, kmeans, minebench, sha256, stencil  # noqa: E402
from repro_torch.core import comm  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
KMEANS_ATOL = 1e-4
PAGERANK_RTOL = 1e-5
CG_TOL = 1e-4


def tworker(p=1, kind="python", **props):
    return tcore.IWorker(tcore.ICluster(tcore.IProperties(
        {"ignis.device": "cpu", "ignis.executor.instances": str(p), **props})), kind)


def jworker(kind="python", **props):
    return jcore.IWorker(jcore.ICluster(jcore.IProperties(props)), kind)


# ---------------------------------------------------------------------------
# SHA-256 and Minebench
# ---------------------------------------------------------------------------

MESSAGES = [b"", b"abc", b"a" * 55, b"ignishpc-torch \xf0\x9f\x9a\x80"[:20],
            bytes(range(37))]


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: f"{len(m)}B")
def test_sha256_bit_exact_against_hashlib_and_the_reference(msg):
    buf = np.zeros(64, np.uint8)
    buf[: len(msg)] = np.frombuffer(msg, np.uint8)
    words = sha256.pack_bytes(buf[None])
    assert np.array_equal(words, jsha.pack_bytes(buf[None]))
    d = sha256.sha256_bytes_len(torch.from_numpy(words), len(msg)).numpy()[0]
    assert d.dtype == np.uint32  # the dtype the reference's digest collects as
    assert b"".join(int(x).to_bytes(4, "big") for x in d).hex() == \
        hashlib.sha256(msg).hexdigest()
    jd = np.asarray(jsha.sha256_bytes_len(jnp.asarray(words), len(msg)))[0]
    assert np.array_equal(d, jd) and d.dtype == jd.dtype


def test_sha256_words_on_random_chunks_matches_the_reference():
    w = np.random.default_rng(5).integers(0, 2**32, (3, 7, 16), dtype=np.uint32)
    got = sha256.sha256_words(torch.from_numpy(w)).numpy()
    want = np.asarray(jsha.sha256_words(jnp.asarray(w)))
    assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want)


@pytest.mark.parametrize("txs", [1, 4, 5])
def test_merkle_root_and_mine_bit_for_bit(txs):
    blocks = minebench.make_blocks(6, txs, seed=1)
    assert np.array_equal(blocks, jmine.make_blocks(6, txs, seed=1))
    roots = minebench.merkle_root(torch.from_numpy(blocks)).numpy()
    jroots = np.asarray(jax.vmap(jmine.merkle_root)(jnp.asarray(blocks)))
    assert roots.dtype == jroots.dtype and np.array_equal(roots, jroots)
    for iters, bits in ((48, 4), (16, 12)):  # mostly found; mostly not
        nonce, found = minebench.mine(torch.from_numpy(roots), iters, bits)
        jn, jf = jax.vmap(lambda r: jmine.mine(r, iters, bits))(jnp.asarray(jroots))
        assert nonce.numpy().dtype == np.asarray(jn).dtype
        assert np.array_equal(nonce.numpy(), np.asarray(jn))
        assert np.array_equal(found.numpy(), np.asarray(jf))


def _mine_rows(rows):
    return [(int(r["nonce"]), bool(r["found"])) for r in rows]


def test_minebench_single_and_two_workers_match_the_reference():
    """map₁ then map₂ on one worker; map₁ on one worker and map₂ on another
    with import_data between them (paper Fig. 14), also across a spark
    worker: every variant gives the reference's (nonce, found) per block."""
    blocks = minebench.make_blocks(12, 4, seed=0)
    m2 = minebench.make_map2_fn(24, 4)
    jw = jworker()
    want = _mine_rows(jw.parallelize(blocks).map(jmine.map1_fn)
                      .map(jmine.make_map2_fn(24, 4)).collect())
    w = tworker(8)
    single = w.parallelize(blocks).map(minebench.map1_fn).map(m2).collect()
    assert single[0]["nonce"].dtype == np.uint32 and single[0]["found"].dtype == np.bool_
    assert _mine_rows(single) == want
    for mode in ("ignis", "spark"):
        w1 = tworker(8, **{"ignis.mode": mode})
        w2 = tcore.IWorker(w1.cluster, "cpp")
        roots = w1.parallelize(blocks).map(minebench.map1_fn)
        assert _mine_rows(w2.import_data(roots).map(m2).collect()) == want, mode


def test_minebench_native_through_worker_call():
    blocks = minebench.make_blocks(8, 3, seed=2)
    w, jw = tworker(8, "cpp"), jworker("cpp")
    w.load_library("repro_torch.apps.minebench")
    jw.load_library("repro.apps.minebench")
    got = w.call("minebench_mpi", w.parallelize(blocks), iters=32,
                 difficulty_bits=4).collect()
    want = jw.call("minebench_mpi", jw.parallelize(blocks), iters=32,
                   difficulty_bits=4).collect()
    assert _mine_rows(got) == _mine_rows(want)
    # the native program equals the two maps of the dataflow form
    rows = tworker().parallelize(blocks).map(minebench.map1_fn).map(
        minebench.make_map2_fn(32, 4)).collect()
    assert _mine_rows(rows) == _mine_rows(got)


# ---------------------------------------------------------------------------
# K-Means
# ---------------------------------------------------------------------------


def test_kmeans_from_the_same_initial_centres():
    pts, _ = kmeans.make_points(512, 8, 4, 3)
    assert np.array_equal(pts, jkmeans.make_points(512, 8, 4, 3)[0])
    init = pts[[3, 100, 250, 400]]
    want = np.asarray(jkmeans.kmeans_on_device(jnp.asarray(pts), jnp.asarray(init), 5))
    on_dev = kmeans.kmeans_on_device(torch.from_numpy(pts), torch.from_numpy(init), 5)
    driver = kmeans.kmeans_driver_eval(torch.from_numpy(pts), torch.from_numpy(init), 5)
    np.testing.assert_allclose(on_dev.numpy(), want, atol=KMEANS_ATOL)
    np.testing.assert_allclose(driver.numpy(), on_dev.numpy(), atol=KMEANS_ATOL)
    asg = kmeans._assign(torch.from_numpy(pts), on_dev).numpy()
    jasg = np.asarray(jkmeans._assign(jnp.asarray(pts), jnp.asarray(want)))
    assert np.array_equal(asg, jasg)


def test_kmeans_assign_breaks_ties_as_the_reference():
    pts = np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 0.0]], np.float32)
    centers = np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    got = kmeans._assign(torch.from_numpy(pts), torch.from_numpy(centers)).numpy()
    want = np.asarray(jkmeans._assign(jnp.asarray(pts), jnp.asarray(centers)))
    assert np.array_equal(got, want)


def test_kmeans_native_through_worker_call():
    """The native form draws k distinct points with a torch.Generator seeded
    by ``seed`` (the reference draws with jax.random: other points), then
    runs the on-device loop from them."""
    pts, _ = kmeans.make_points(256, 4, 3, 1)
    w = tworker(8, "cpp")
    w.load_library("repro_torch.apps.kmeans")
    rows = w.call("kmeans_mpi", w.parallelize(pts), iters=6, k=3, seed=7).collect()
    got = np.stack([np.asarray(r) for r in rows])
    pick = torch.randperm(256, generator=torch.Generator().manual_seed(7))[:3]
    want = kmeans.kmeans_on_device(torch.from_numpy(pts), torch.from_numpy(pts)[pick], 6)
    assert got.shape == (3, 4) and np.array_equal(got, want.numpy())


# ---------------------------------------------------------------------------
# PageRank and transitive closure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("props", [{}, {"ignis.kernels": "interpret"},
                                   {"ignis.mode": "spark"}],
                         ids=["ignis", "kernel-tier", "spark"])
def test_pagerank_matches_the_reference(props):
    edges = graph.make_graph(40, 120, seed=1)
    assert np.array_equal(edges, jgraph.make_graph(40, 120, seed=1))
    want = jgraph.pagerank(jworker(), edges, iters=3)
    got = graph.pagerank(tworker(8, **props), edges, iters=3)
    assert sorted(got) == sorted(want)
    for v in want:
        assert abs(got[v] - want[v]) <= PAGERANK_RTOL * abs(want[v]), v
    ref = graph.pagerank_reference(edges, iters=3)
    assert ref == jgraph.pagerank_reference(edges, iters=3)
    assert max(abs(got[v] - ref[v]) for v in ref) < 1e-3


def test_pagerank_reduce_rides_the_kernel_tier():
    """With the kernel tier on (``interpret``: the kernels' plain stand-ins
    on the CPU), PageRank's f32 reduceByKey selects the segment-reduce tier
    and its joins the routed exchange."""
    w = tworker(8, **{"ignis.kernels": "interpret"})
    graph.pagerank(w, graph.make_graph(30, 90, seed=2), iters=2)
    k = w.metrics("kernels")
    assert k["kernel_hits"] > 0 and k["kernel_fallbacks"] == 0


@pytest.mark.parametrize("props", [{}, {"ignis.kernels": "interpret"}],
                         ids=["ignis", "kernel-tier"])
def test_transitive_closure_matches_the_reference(props):
    edges = graph.make_graph(12, 20, seed=2)
    jtc = jgraph.transitive_closure(jworker(), edges, max_rounds=8)
    want = {(int(np.asarray(a)), int(np.asarray(b))) for a, b in jtc.collect()}
    tc = graph.transitive_closure(tworker(8, **props), edges, max_rounds=8)
    got = {(int(np.asarray(a)), int(np.asarray(b))) for a, b in tc.collect()}
    assert got == want == graph.tc_reference(edges) == jgraph.tc_reference(edges)


def test_transitive_closure_stops_at_max_rounds_as_the_reference():
    """Fewer rounds than the fixed point needs: both packages stop there
    (one edge added a round), where tc_reference squares the relation."""
    edges = np.array([[i, i + 1] for i in range(9)], np.int32)  # a path
    jtc = jgraph.transitive_closure(jworker(), edges, max_rounds=2)
    tc = graph.transitive_closure(tworker(2), edges, max_rounds=2)
    got = {(int(a), int(b)) for a, b in tc.collect()}
    assert got == {(int(a), int(b)) for a, b in jtc.collect()}
    assert got == {(i, j) for i in range(10) for j in range(i + 1, min(i + 4, 10))}


# ---------------------------------------------------------------------------
# stencil and CG (native SPMD programs)
# ---------------------------------------------------------------------------


def _get(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _torch_apps(p):
    w = tworker(p, "cpp")
    w.load_library("repro_torch.apps.stencil")

    def call(app, x, iters):
        return _get(w.call(app, w.parallelize(x), iters=iters)._blocks()[0].data)

    return cases.spmd_apps(stencil, w.context.comm(), p, torch.from_numpy, _get, call)


def _compare(got, want):
    np.testing.assert_array_equal(got["stencil"], want["stencil"])
    np.testing.assert_allclose(got["cg"], want["cg"], rtol=CG_TOL, atol=CG_TOL)
    # framework-wrapped equals native bit for bit
    np.testing.assert_array_equal(got["stencil_app"], got["stencil"])
    np.testing.assert_array_equal(got["cg_app"], got["cg"])


def test_stencil_and_cg_at_p1_match_the_reference():
    got, g, b = _torch_apps(1)
    jw = jworker("cpp")
    mesh, axis = jw.context.comm()
    want = {"stencil": np.asarray(jstencil.stencil_native(mesh, axis, jnp.asarray(g), 7)),
            "cg": np.asarray(jstencil.cg_native(mesh, axis, jnp.asarray(b), 12))}
    _compare(got, want)


@pytest.fixture(scope="module")
def jax_p8(tmp_path_factory):
    out = tmp_path_factory.mktemp("apps") / "jax_p8.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(HERE, "_torch_apps_main.py"),
                        str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "TORCH_APPS_JAX_OK" in r.stdout, r.stderr[-3000:]
    z = np.load(out)
    return {k.split("|", 1)[1]: z[k] for k in z.files if k.startswith("app|")}


def test_stencil_and_cg_at_p8_match_the_reference(jax_p8):
    got, _g, _b = _torch_apps(8)
    _compare(got, jax_p8)
    np.testing.assert_array_equal(jax_p8["stencil_app"], jax_p8["stencil"])


def test_stencil_at_p8_is_the_periodic_jacobi():
    """Ring halos over the ranks and rolls over the columns: the periodic
    Jacobi step on the whole grid (np.roll on both axes)."""
    g = np.random.default_rng(3).normal(size=(32, 9)).astype(np.float32)
    ranks, axis = tworker(8).context.comm()
    got = stencil.stencil_native(ranks, axis, torch.from_numpy(g), 3).numpy()
    u = g.astype(np.float64)
    for _ in range(3):
        u = (np.roll(u, 1, 0) + np.roll(u, -1, 0) + np.roll(u, 1, 1) + np.roll(u, -1, 1)) / 4
    np.testing.assert_allclose(got, u, rtol=1e-5, atol=1e-6)


def test_cg_app_returns_a_handle_and_reuses_its_plan():
    """cg_app hands back a CollHandle, which worker.call chains; a second
    call with the same statics is a plan-cache hit (no rebuild)."""
    b = np.random.default_rng(1).normal(size=64).astype(np.float32)
    w = tworker(8, "cpp")
    w.load_library("repro_torch.apps.stencil")
    ctx = w.context
    h = stencil.cg_app(ctx.bind({"iters": 12}), torch.from_numpy(b),
                       torch.ones(64, dtype=torch.bool))
    assert comm.is_handle(h)
    x, valid = h.wait()
    assert x.shape == (64,) and bool(valid.all())
    np.testing.assert_allclose(stencil.laplacian_matvec_ref(x).numpy(),
                               np.asarray(jstencil.laplacian_matvec_ref(jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-6)
    before = comm.comm_stats()
    rows = w.call("cg_app", w.parallelize(b), iters=12)._blocks()[0].data
    after = comm.comm_stats()
    assert after["coll_plan_hits"] - before["coll_plan_hits"] == 1
    assert after["coll_plan_misses"] == before["coll_plan_misses"]
    assert torch.equal(rows, x)
    # 12 iterations of CG on a 64-row Laplacian reduce the residual
    r = b - stencil.laplacian_matvec_ref(x).numpy()
    assert np.linalg.norm(r) < 0.5 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the card run's host oracles (chip_smoke.py's apps phase) and the examples
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, os.path.join(HERE, ".."))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_host_oracles_match_the_reference(smoke):
    """The numpy oracles the apps phase holds the card to agree with the
    JAX package's apps on small inputs."""
    edges = jgraph.make_graph(60, 200, seed=4)
    verts, ranks = smoke.pagerank_oracle(edges, 60, 4)
    want = jgraph.pagerank_reference(edges, iters=4)
    assert [int(v) for v in verts] == sorted(want)
    np.testing.assert_allclose(ranks, [want[int(v)] for v in verts], rtol=1e-12)
    for rounds in (1, 3, 10):
        e = jgraph.make_graph(40, 60, seed=5)
        codes, _ = smoke.tc_oracle(e, 40, rounds)
        tc = graph.transitive_closure(tworker(), e, max_rounds=rounds)
        got = {(int(a), int(b)) for a, b in tc.collect()}
        assert {(int(c) // 40, int(c) % 40) for c in codes} == got
    pts, _ = jkmeans.make_points(300, 5, 3, 2)
    c = pts[:3]
    step, asg = smoke.kmeans_oracle_step(pts, c)
    jasg = np.asarray(jkmeans._assign(jnp.asarray(pts), jnp.asarray(c)))
    assert np.array_equal(asg, jasg)
    np.testing.assert_allclose(
        step, np.asarray(jkmeans._update(jnp.asarray(pts), jnp.asarray(jasg), 3)), atol=1e-5)
    blocks = jmine.make_blocks(5, 4, seed=3)
    roots, nonce, found = smoke.minebench_oracle(blocks, 40, 4)
    jroots = np.asarray(jax.vmap(jmine.merkle_root)(jnp.asarray(blocks)))
    jn, jf = jax.vmap(lambda r: jmine.mine(r, 40, 4))(jnp.asarray(jroots))
    assert np.array_equal(roots, jroots) and np.array_equal(nonce, np.asarray(jn))
    assert np.array_equal(found, np.asarray(jf))
    b = np.random.default_rng(2).normal(size=48).astype(np.float32)
    x = smoke.cg_oracle(b, 10)
    jx = np.asarray(jstencil.cg_native(*jworker().context.comm(), jnp.asarray(b), 10))
    np.testing.assert_allclose(x, jx, rtol=1e-4, atol=1e-4)


def test_chip_smoke_host_sha256_is_hashlibs(smoke):
    smoke._anchor_sha_to_hashlib()  # raises SmokeFailure on a mismatch


@pytest.mark.parametrize("example", [
    "torch_native_hpc_app.py", "torch_transitive_closure.py",
    "torch_quickstart.py", "torch_hybrid_job.py",
    # the hybrid training app at ignis-tiny, shortened: its loss must fall
    "torch_hybrid_train.py --steps 20 --batch 4 --seq-len 64"])
def test_torch_examples_run_on_the_cpu(example):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src")
    script, *extra = example.split()
    r = subprocess.run([sys.executable, os.path.join(HERE, "..", "examples", script),
                        "--device", "cpu", *extra], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "OK"
