"""The dry run (``repro_torch.launch.dryrun``) and the bundle's abstract
surface against the JAX package's, on the CPU.

Held against the JAX package: ``ArchConfig.shape_cells`` and ``ASSIGNED``;
the bundle's ``input_specs`` for every config and cell (JAX
``ShapeDtypeStruct``s against the port's fake tensors, shape and dtype)
and ``step_for_cell``'s arguments in the JAX tree (``interop.reference_tree``
and ``opt_tree``) against ``jax.eval_shape``'s; ``cell_key`` and
``_parse_override`` over a table; ``model_flops`` exactly, at full width;
and each rank's argument bytes against XLA's compiled
``memory_analysis().argument_size_in_bytes`` of the same specs on 8 fake
devices (one subprocess, tests/_torch_dryrun_main.py).

Held on the port alone: pricing by layer signature equals tracing the
unrolled step, for each family's reduced config — exactly in prefill and
decode, and in train up to one scalar product a MoE layer past the first
(below); ``run_cell`` on the production mesh for every ``ASSIGNED`` arch and
cell at reduced width; ``run_all``'s resume, retry and failure records;
``main``'s record and re-raise.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ASSIGNED as J_ASSIGNED  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.configs.base import ShapeCell as JCell  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import ASSIGNED, SHAPES, ShapeCell, get_config  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.interop import opt_tree, reference_tree  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.profile import cost  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = list_configs()


def _jax_dryrun():
    """The JAX package's dry-run module. Importing it sets XLA_FLAGS to 512
    host devices for its own process; the flag is put back before any JAX
    backend starts, so this process keeps the device count it had."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd

    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jd


def _flat(t, pre=()):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_flat(v, (*pre, k)))
        return out
    return {pre: t}


def _sig(leaf):
    """(shape, dtype name) of a JAX abstract value or a torch tensor."""
    dt = leaf.dtype
    name = str(dt).split(".")[-1] if isinstance(dt, torch.dtype) else str(dt)
    return tuple(int(d) for d in leaf.shape), name


def _reduced_overrides(name):
    """``run_cell``'s overrides that make ``name`` its ``reduced()`` config."""
    full = get_config(name)
    red = full.reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


# ---------------------------------------------------------------------------
# configs and the bundle's abstract surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_shape_cells_equal_the_reference(name):
    assert [c.name for c in get_config(name).shape_cells()] == [
        c.name for c in jget(name).shape_cells()]
    assert [dataclasses.astuple(c) for c in get_config(name).shape_cells()] == [
        dataclasses.astuple(c) for c in jget(name).shape_cells()]


def test_assigned_equals_the_reference():
    assert ASSIGNED == J_ASSIGNED
    assert sum(len(get_config(a).shape_cells()) for a in ASSIGNED) == 34


@pytest.mark.parametrize("name,cell", [(n, c.name) for n in CONFIGS
                                       for c in get_config(n).shape_cells()])
def test_input_specs_equal_the_reference(name, cell):
    want = _flat(jbuild(jget(name)).input_specs(SHAPES[cell]))
    got = _flat(build_model(get_config(name), device="cpu").input_specs(SHAPES[cell]))
    assert set(got) == set(want)
    for k in want:
        assert _sig(got[k]) == _sig(want[k]), (k, _sig(got[k]), _sig(want[k]))
        assert kernels.is_fake(got[k]) and got[k].device.type == "cpu"


@pytest.mark.parametrize("name", CONFIGS)
def test_step_for_cell_arguments_equal_the_reference(name):
    """The train cell's (params, opt, batch) in the JAX tree against
    ``jax.eval_shape``'s; the prefill and decode cells' argument arity and
    trees likewise; every argument a fake tensor on the bundle's device."""
    jb, tb = jbuild(jget(name)), build_model(get_config(name), device="cpu")
    train = SHAPES["train_4k"]
    _, (jp, jo, jbatch) = jb.step_for_cell(JCell(*dataclasses.astuple(train)))
    _, (tp, to, tbatch) = tb.step_for_cell(train)
    for want, got in ((jp, reference_tree(tp, leaf=lambda t: t)),
                      (jo, opt_tree(tp, to, leaf=lambda t: t)), (jbatch, tbatch)):
        fw, fg = _flat(want), _flat(got)
        assert set(fw) == set(fg)
        assert all(_sig(fg[k]) == _sig(fw[k]) for k in fw), [
            k for k in fw if _sig(fg[k]) != _sig(fw[k])]
    assert all(kernels.is_fake(t) and t.device.type == "cpu"
               for t in [*tp.parameters(), *tree.leaves(to), *tree.leaves(tbatch)])
    for cell in get_config(name).shape_cells()[1:3]:  # prefill, then decode: JAX's arity
        want = jb.input_specs(JCell(*dataclasses.astuple(cell)))
        _, targs = tb.step_for_cell(cell)
        if cell.kind == "prefill":
            assert len(targs) == 2 and _flat(targs[1]).keys() == _flat(want).keys()
        else:
            assert len(targs) == 3 and _flat(targs[1]).keys() == _flat(want["cache"]).keys()
            assert _sig(targs[2]) == _sig(want["tokens"])


OVERRIDES = ["attn_impl=flash", "remat=True", "moe_ep=False", "x=None", "lr=1e-3",
             "num_layers=3", "sharding_preset=fsdp_tp", "capacity_factor=1.25", "tag=",
             "key=a=b", "novalue", "n=-4", "f=1e30", "inf=inf", "s=True1"]


@pytest.mark.parametrize("s", OVERRIDES)
def test_parse_override_equals_the_reference(s):
    got, want = dryrun._parse_override(s), _jax_dryrun()._parse_override(s)
    assert got == want and type(got[1]) is type(want[1])


@pytest.mark.parametrize("args", [("olmo-1b", "train_4k", False, ""),
                                  ("jamba-1.5-large-398b", "long_500k", True, ""),
                                  ("yi-9b", "decode_32k", False, "flash"),
                                  ("whisper-tiny", "prefill_32k", True, "v2")])
def test_cell_key_equals_the_reference(args):
    assert dryrun.cell_key(*args) == _jax_dryrun().cell_key(*args)


@pytest.mark.parametrize("name,cell", [(a, c.name) for a in ASSIGNED
                                       for c in get_config(a).shape_cells()])
def test_model_flops_equal_the_formula_exactly(name, cell):
    """(6 in train, else 2) x active parameters x tokens, the JAX dry run's
    formula, with the JAX package's active parameter count, at full width."""
    c = SHAPES[cell]
    tokens = c.global_batch * (c.seq_len if c.kind in ("train", "prefill") else 1)
    want = (6 if c.kind == "train" else 2) * jget(name).active_param_count() * tokens
    assert dryrun.model_flops(get_config(name), c) == want


# ---------------------------------------------------------------------------
# pricing by signature against the unrolled trace
# ---------------------------------------------------------------------------

FAMILIES = ("olmo-1b", "gemma3-4b", "mixtral-8x7b", "mamba2-780m", "jamba-1.5-large-398b",
            "internvl2-1b", "whisper-tiny")
SMALL = {"train": ShapeCell("t", 32, 4, "train"), "prefill": ShapeCell("p", 96, 4, "prefill"),
         "decode": ShapeCell("d", 96, 4, "decode")}
#: in train the chunked attention's loop is traced chunk by chunk (its
#: backward is in the graph): whisper's 1500 encoder frames go in one
#: chunk, not in 47 of the reduced config's 32, and it keeps two of its
#: four decoder layers
TRAIN_CHUNK = {"whisper-tiny": 2048}


def _unrolled(bundle, cell):
    fn, args = bundle.step_for_cell(cell)
    if cell.kind == "train":
        gm = cost.trace(lambda o, b: fn(args[0], o, b)[1:], *args[1:])
    elif cell.kind == "prefill":
        gm = cost.trace(lambda i: fn(args[0], i), args[1])
    else:
        gm = cost.trace(lambda c, t: fn(args[0], c, t), *args[1:])
    calls = {}
    for c in gm.meta["kernel_calls"]:
        calls[c.kernel] = calls.get(c.kernel, 0) + c.count
    return args, cost.CostModel().price_graph(gm), calls


@pytest.mark.parametrize("kind", SMALL)
@pytest.mark.parametrize("name", FAMILIES)
def test_pricing_by_signature_equals_the_unrolled_trace(name, kind):
    """Prefill and decode: equal exactly (flops, bytes, dispatches, kernel
    calls). Train: equal but for the MoE aux loss's scale: the step adds
    ``0.01 x aux`` once, and the backward multiplies its gradient by 0.01
    once where the aux sum began; a one-layer piece begins that sum itself,
    so each MoE layer past the first prices one scalar product more (1
    FLOP, two f32 scalars, one dispatch) than the unrolled step has."""
    cfg = get_config(name).reduced()
    if kind == "train" and name in TRAIN_CHUNK:
        cfg = cfg.with_overrides(attn_chunk=TRAIN_CHUNK[name], num_layers=2)
    bundle = build_model(cfg, device="cpu")
    cell = SMALL[kind]
    args, unrolled, calls = _unrolled(bundle, cell)
    inputs = args[2] if kind == "train" else (
        args[1] if kind == "prefill" else {"cache": args[1], "tokens": args[2]})
    priced = dryrun.price_step(bundle, cell, args[0], inputs)
    total = priced["act"] + priced["opt"]
    moe = sum(n for sig, n in dryrun.plan(cfg, args[0])[0].items()
              if cfg.is_moe and (cfg.family != "hybrid" or sig[1] == "moe"))
    extra = moe - 1 if kind == "train" and moe else 0
    assert total == unrolled + cost.CostEstimate(extra, 8 * extra, 0.0, extra)
    assert priced["calls"] == calls


def test_collapsed_chunk_loop_prices_as_the_unrolled_one():
    """The plain attention's query-chunk loop traced once under
    ``collapsing_loops`` prices exactly as every chunk traced, and its
    memory walk counts each chunk's output once per chunk."""
    cfg = get_config("olmo-1b").reduced().with_overrides(attn_chunk=16)
    bundle = build_model(cfg, device="cpu")
    fn, (params, inputs) = bundle.step_for_cell(ShapeCell("p", 70, 2, "prefill"))
    full = cost.trace(lambda i: fn(params, i), inputs)
    with cost.collapsing_loops():
        once = cost.trace(lambda i: fn(params, i), inputs)
    assert len(once.graph.nodes) < len(full.graph.nodes) / 1.5
    assert cost.CostModel().price_graph(once) == cost.CostModel().price_graph(full)
    assert {n.meta.get("repeat", (1,))[0] for n in once.graph.nodes} == {1, 4}


def test_memory_walk_frees_after_the_last_use_and_skips_views():
    def f(x):
        a = x * 2  # 4 KiB, freed once c is made
        b = a.view(-1)  # a view: nothing
        c = b + 1  # 4 KiB
        d = torch.ones(1024)  # 4 KiB, never used
        return c + 0 * d.sum()

    gm = cost.trace(f, torch.zeros(32, 32))
    walk = cost.memory_walk(gm)
    assert walk["peak"] == 2 * 4096 + 4  # c and d, with d's sum
    assert walk["marks"] == {}


# ---------------------------------------------------------------------------
# run_cell
# ---------------------------------------------------------------------------


def _small_cell(cell):
    """The shape cell, its train cell cut to 64 tokens (the chunked
    attention's backward is unrolled: 32-token chunks of 4096 tokens would
    take minutes to trace); the others as they are (their chunk loops are
    traced once)."""
    return ShapeCell(cell.name, 64, cell.global_batch, "train") if cell.kind == "train" \
        else cell


#: the JAX dry run's record keys (its ``xla_cost`` is the port's ``graph_cost``)
RECORD_KEYS = ("key", "arch", "shape", "mesh", "chips", "kind", "tag", "overrides", "ok",
               "lower_s", "compile_s", "memory", "graph_cost", "parsed", "top_collectives",
               "roofline", "total_s")


def _check_record(rec, name, cell, cfg, mesh, trees):
    assert rec["ok"] and set(RECORD_KEYS) <= set(rec)
    assert rec["chips"] == mesh.size and rec["kind"] == cell.kind
    tokens = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
    assert rec["roofline"]["model_flops"] == (
        (6 if cell.kind == "train" else 2) * cfg.active_param_count() * tokens)
    assert rec["memory"]["argument_size_in_bytes"] == trees
    terms = [*rec["memory"].values(), *(rec["roofline"][k] for k in (
        "compute_s", "memory_s", "collective_s", "step_time_s"))]
    assert all(math.isfinite(v) and v >= 0 for v in terms)
    assert json.loads(json.dumps(rec)) == rec


def _argument_bytes(cfg, cell, mesh):
    from repro_torch.distributed import sharding as S

    _b, args, (ptree, otree) = dryrun.abstract_cell(cfg, cell, "cpu")
    psp = S.param_specs(ptree, cfg, mesh)
    trees = [S.to_named(psp, mesh, ptree)]
    if cell.kind == "train":
        trees += [S.to_named(S.opt_specs(otree, psp, cfg, mesh), mesh, otree),
                  S.to_named(S.input_specs_sharding(args[2], cfg, mesh), mesh, args[2])]
    elif cell.kind == "prefill":
        trees.append(S.to_named(S.input_specs_sharding(args[1], cfg, mesh), mesh, args[1]))
    else:
        trees += [S.to_named(S.cache_specs(args[1], cfg, mesh), mesh, args[1]),
                  S.to_named(S.input_specs_sharding({"tokens": args[2]}, cfg, mesh)["tokens"],
                             mesh, args[2])]
    return sum(p.rank_bytes for t in trees for p in tree.leaves(t))


#: one arch of each family also on the two-pod mesh
MULTI = ("olmo-1b", "mixtral-8x7b", "mamba2-780m", "jamba-1.5-large-398b", "internvl2-1b",
         "whisper-tiny")


@pytest.mark.parametrize("name,cell,multi", [
    (a, c.name, m) for a in ASSIGNED for c in get_config(a).shape_cells()
    for m in ((False, True) if a in MULTI else (False,))])
def test_run_cell_on_the_production_mesh_at_reduced_width(name, cell, multi):
    over = _reduced_overrides(name)
    if SHAPES[cell].kind == "train" and name in TRAIN_CHUNK:
        over["attn_chunk"] = TRAIN_CHUNK[name]
    cfg = get_config(name).with_overrides(**over)
    c = _small_cell(SHAPES[cell])
    rec = dryrun.run_cell(name, cell, multi, verbose=False, overrides=over, device="cpu",
                          cell=c)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    _check_record(rec, name, c, cfg, mesh, _argument_bytes(cfg, c, mesh))
    assert rec["key"] == dryrun.cell_key(name, cell, multi)
    assert rec["mesh"] == ("multi" if multi else "single") and rec["chips"] == (512 if multi
                                                                               else 256)


# ---------------------------------------------------------------------------
# argument bytes against XLA's, p = 8
# ---------------------------------------------------------------------------

#: one cell per family, each on (8, 1) and (4, 2), the reduced config with
#: its full config's sharding preset
ARG_CASES = [dict(id=f"{a}|{k}|{m[0]}x{m[1]}", arch=a, kind=k, batch=8, seq=64, mesh=list(m))
             for a, k in (("olmo-1b", "train"), ("mixtral-8x7b", "prefill"),
                          ("mamba2-780m", "decode"), ("jamba-1.5-large-398b", "prefill"),
                          ("internvl2-1b", "decode"), ("whisper-tiny", "decode"))
             for m in ((8, 1), (4, 2))]
#: leaves a step does not read, which XLA drops from its executable's
#: arguments (``jax.jit``'s ``keep_unused=False``): whisper's decode runs no
#: encoder, and its cross-attention reads the cached keys and values, not
#: the projections that made them; the VLM's decode takes no patches
UNUSED = {("whisper-tiny", "decode"): (("enc_layers",), ("enc_norm",), ("pos_enc",),
                                       ("dec_layers", "cross_attn", "wk"),
                                       ("dec_layers", "cross_attn", "wv")),
          ("internvl2-1b", "decode"): (("vit_proj",),)}


@pytest.fixture(scope="module")
def xla_argument_bytes(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_p8")
    cases, out = d / "cases.json", d / "out.json"
    cases.write_text(json.dumps([{**c, "preset": get_config(c["arch"]).sharding_preset}
                                 for c in ARG_CASES]))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, "..", "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(HERE, "_torch_dryrun_main.py"),
                        str(cases), str(out)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", ARG_CASES, ids=[c["id"] for c in ARG_CASES])
def test_argument_bytes_equal_xla_compiled_at_p8(case, xla_argument_bytes):
    """Each rank's argument bytes equal XLA's ``argument_size_in_bytes`` of
    the JAX dry run's ``in_shardings`` of the same specs (the reduced
    config with its full config's preset, so that weights split); a leaf
    the step does not read is an argument of the port's step and not of
    XLA's executable (``UNUSED``)."""
    from repro_torch.distributed import sharding as S

    name, kind = case["arch"], case["kind"]
    over = {**_reduced_overrides(name), "sharding_preset": get_config(name).sharding_preset}
    cfg = get_config(name).with_overrides(**over)
    cell = ShapeCell("case", case["seq"], case["batch"], kind)
    mesh = make_local_mesh(*case["mesh"], device="cpu")
    rec = dryrun.run_cell(name, "case", False, verbose=False, overrides=over, device="cpu",
                          mesh=mesh, cell=cell)
    _b, args, (ptree, _o) = dryrun.abstract_cell(cfg, cell, "cpu")
    place = S.to_named(S.param_specs(ptree, cfg, mesh), mesh, ptree)
    unused = 0
    for path in UNUSED.get((name, kind), ()):
        sub = place
        for k in path:
            sub = sub[k]
        unused += S.rank_bytes(sub)
    assert rec["memory"]["argument_size_in_bytes"] - unused == xla_argument_bytes[case["id"]]
    if cfg.sharding_preset != "dp":  # the specs split weights: fewer bytes than whole
        whole = sum(math.prod(t.shape) * t.element_size() for t in args[0].parameters())
        assert S.rank_bytes(place) < whole


# ---------------------------------------------------------------------------
# the sweep and the command line
# ---------------------------------------------------------------------------


class _FakeRun:
    """``subprocess.run`` for ``run_all``: a cell in ``fail`` exits 1, one in
    ``hang`` times out, any other appends its record, as the real child."""

    def __init__(self, fail=(), hang=()):
        self.fail, self.hang, self.cmds = set(fail), set(hang), []

    def __call__(self, cmd, env=None, timeout=None, capture_output=None, text=None):
        arch, shape = cmd[cmd.index("--arch") + 1], cmd[cmd.index("--shape") + 1]
        mp = "--multi-pod" in cmd
        self.cmds.append((arch, shape, mp))
        assert cmd[cmd.index("--device") + 1] == "cpu"
        if (arch, shape) in self.hang:
            raise subprocess.TimeoutExpired(cmd, timeout)
        if (arch, shape) in self.fail:
            return subprocess.CompletedProcess(cmd, 1, "", "boom: no such cell")
        dryrun.append_record(cmd[cmd.index("--jsonl") + 1],
                             {"key": dryrun.cell_key(arch, shape, mp), "ok": True})
        return subprocess.CompletedProcess(cmd, 0, "", "")


def test_run_all_resumes_records_failures_and_retries(tmp_path, monkeypatch):
    import repro_torch.configs as cfgs

    monkeypatch.setattr(cfgs, "ASSIGNED", ["olmo-1b", "mamba2-780m"])
    path = str(tmp_path / "sweep.jsonl")
    cells = [(a, c.name, mp) for mp in (False, True) for a in ("olmo-1b", "mamba2-780m")
             for c in get_config(a).shape_cells()]
    assert len(cells) == 14
    dryrun.append_record(path, {"key": dryrun.cell_key("olmo-1b", "train_4k", False),
                                "ok": True})
    fake = _FakeRun(fail={("mamba2-780m", "prefill_32k")}, hang={("olmo-1b", "decode_32k")})
    monkeypatch.setattr(dryrun.subprocess, "run", fake)
    dryrun.run_all(path, device="cpu")
    assert len(fake.cmds) == 13 and ("olmo-1b", "train_4k", False) not in fake.cmds
    done = dryrun.load_done(path)
    assert set(done) == {dryrun.cell_key(*c) for c in cells}
    failed = {k for k, r in done.items() if not r["ok"]}
    assert failed == {dryrun.cell_key(a, s, mp) for a, s in
                      (("mamba2-780m", "prefill_32k"), ("olmo-1b", "decode_32k"))
                      for mp in (False, True)}
    assert all("boom" in done[dryrun.cell_key("mamba2-780m", "prefill_32k", mp)]["error"]
               for mp in (False, True))
    assert done[dryrun.cell_key("olmo-1b", "decode_32k", True)]["error"] == "timeout"
    # a second sweep skips every recorded cell, failed ones too
    again = _FakeRun()
    monkeypatch.setattr(dryrun.subprocess, "run", again)
    dryrun.run_all(path, device="cpu")
    assert again.cmds == []
    # --retry-failed runs the failed cells only, single-pod ones with --single-pod-only
    retry = _FakeRun()
    monkeypatch.setattr(dryrun.subprocess, "run", retry)
    dryrun.main(["--all", "--retry-failed", "--single-pod-only", "--jsonl", path,
                 "--device", "cpu"])
    assert sorted(retry.cmds) == [("mamba2-780m", "prefill_32k", False),
                                  ("olmo-1b", "decode_32k", False)]
    done = dryrun.load_done(path)
    assert done[dryrun.cell_key("olmo-1b", "decode_32k", False)]["ok"]
    assert not done[dryrun.cell_key("olmo-1b", "decode_32k", True)]["ok"]


def test_main_appends_its_record_and_reraises_a_failure(tmp_path, capsys):
    path = str(tmp_path / "one.jsonl")
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--device", "cpu",
                 "--jsonl", path, "--override", "num_layers=2", "--tag", "two"])
    rec = dryrun.load_done(path)[dryrun.cell_key("whisper-tiny", "decode_32k", False, "two")]
    assert rec["ok"] and rec["overrides"] == {"num_layers": 2}
    assert rec["signatures"]["('dec_layers', None)"] == 2
    assert f'"key": "{rec['key']}"' in capsys.readouterr().out
    with pytest.raises(KeyError):
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k", "--device", "cpu",
                     "--jsonl", path])
    bad = dryrun.load_done(path)[dryrun.cell_key("no-such-arch", "train_4k", False)]
    assert not bad["ok"] and "no-such-arch" in bad["error"]


def test_the_default_records_go_under_build():
    root = os.path.normpath(os.path.join(HERE, ".."))
    assert os.path.normpath(dryrun.DEFAULT_JSONL) == os.path.join(root, "build", "dryrun",
                                                                  "dryrun.jsonl")


def test_prefetch_prices_pieces_in_workers_as_in_process():
    """Pieces priced in two worker processes equal those priced here."""
    cells = [("olmo-1b", _reduced_overrides("olmo-1b"), SMALL["prefill"]),
             ("mamba2-780m", _reduced_overrides("mamba2-780m"), SMALL["decode"])]
    saved = dict(dryrun._PIECES)
    dryrun._PIECES.clear()
    try:
        n = dryrun.prefetch(cells, 2, device="cpu")["pieces"]
        there = dict(dryrun._PIECES)
        dryrun._PIECES.clear()
        for name, over, cell in cells:
            cfg = get_config(name).with_overrides(**over)
            bundle = build_model(cfg, device="cpu")
            params, inputs = dryrun._cell_args(bundle, cell)
            dryrun.price_step(bundle, cell, params, inputs)
        assert n == len(there) == len(dryrun._PIECES) == 4
        for k, v in there.items():
            assert v["act"] == dryrun._PIECES[k]["act"]
            assert v["calls"] == dryrun._PIECES[k]["calls"]
            assert v["walk"] == dryrun._PIECES[k]["walk"]
    finally:
        dryrun._PIECES.clear()
        dryrun._PIECES.update(saved)
