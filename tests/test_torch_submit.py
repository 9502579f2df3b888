"""ignis-submit (``repro_torch.launch.submit``) against the JAX package's
(``repro.launch.submit``), and the port's module coverage.

Both packages' ``main`` take the same command line: the job spec written
to ``<jobs-dir>/<name>/job.json`` is equal but for the image, the driver
sees the same ``IGNIS_*`` environment, an attached driver's return code is
returned, and a detached one writes its output to ``driver.log``."""
import json
import os
import sys
import time

import pytest

from repro.launch import submit as jsubmit
from repro_torch.launch import submit as tsubmit

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGES = {"jax": (jsubmit, "ignishpc/jax"), "torch": (tsubmit, "ignishpc/torch")}


def _driver(tmp_path, body):
    path = tmp_path / "driver.py"
    path.write_text(body)
    return str(path)


def test_submit_writes_the_reference_jobspec(tmp_path):
    """The JAX package's own case (tests/test_native_and_lambdas.py), run
    through both packages: rc 0 and equal job specs but for the image."""
    driver = _driver(tmp_path, "print('hi from driver')\n")
    specs = {}
    for pkg, (mod, image) in PACKAGES.items():
        jobs = tmp_path / pkg
        rc = mod.main(["--name", "t1", "--properties", "ignis.driver.memory=1GB",
                       "--jobs-dir", str(jobs), "--attach", image, driver])
        assert rc == 0
        specs[pkg] = json.loads((jobs / "t1" / "job.json").read_text())
        assert specs[pkg]["properties"]["ignis.driver.memory"] == "1GB"
        assert specs[pkg].pop("image") == image
        assert (jobs / "t1" / "driver.log").exists()
    assert specs["jax"] == specs["torch"] == {
        "name": "t1", "driver": driver, "args": [], "properties": {
            "ignis.driver.memory": "1GB"}}


ENV_DRIVER = """import json, os, sys
with open(sys.argv[1], "w") as f:
    json.dump({k: v for k, v in os.environ.items() if k.startswith("IGNIS_")}, f)
"""


def test_the_driver_sees_the_properties_as_ignis_variables(tmp_path, monkeypatch):
    for k in [k for k in os.environ if k.startswith("IGNIS_")]:
        monkeypatch.delenv(k)
    driver = _driver(tmp_path, ENV_DRIVER)
    seen = {}
    for pkg, (mod, image) in PACKAGES.items():
        out = tmp_path / f"{pkg}.json"
        rc = mod.main(["--name", "envjob", "--properties", "ignis.device=cpu",
                       "--properties", "ignis.executor.instances=4",
                       "--properties", "ignis.modules.load=a=b", "--jobs-dir",
                       str(tmp_path / pkg), "--attach", image, driver, str(out)])
        assert rc == 0
        seen[pkg] = json.loads(out.read_text())
    assert seen["jax"] == seen["torch"] == {
        "IGNIS_IGNIS_DEVICE": "cpu", "IGNIS_IGNIS_EXECUTOR_INSTANCES": "4",
        "IGNIS_IGNIS_MODULES_LOAD": "a=b", "IGNIS_JOB_NAME": "envjob"}


@pytest.mark.parametrize("code", [0, 3, 17])
def test_an_attached_driver_returns_its_code(tmp_path, code):
    driver = _driver(tmp_path, f"import sys\nsys.exit({code})\n")
    for pkg, (mod, image) in PACKAGES.items():
        rc = mod.main(["--name", "rc", "--jobs-dir", str(tmp_path / pkg), "--attach", image,
                       driver])
        assert rc == code, pkg


def test_a_detached_driver_writes_its_log(tmp_path, capsys):
    """Detached, ``main`` returns 0 at once; the driver's output lands in
    ``driver.log``, and the driver (a child of this process, in a session
    of its own) is waited for here."""
    driver = _driver(tmp_path, "import os, sys, time\ntime.sleep(1.0)\n"
                               "print('detached', os.environ['IGNIS_JOB_NAME'], sys.argv[1:])\n")
    t0 = time.perf_counter()
    rc = tsubmit.main(["--name", "bg", "--jobs-dir", str(tmp_path), "img", driver, "x", "y"])
    assert rc == 0 and time.perf_counter() - t0 < 1.0
    out = capsys.readouterr().out
    pid = int(out.split("(pid ")[1].split(",")[0])
    log = tmp_path / "bg" / "driver.log"
    assert f"log {log})" in out
    status = None
    while time.perf_counter() - t0 < 30:
        try:
            done, st = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:  # reaped by subprocess' own clean-up
            done, st = pid, 0
        if done:
            status = st
            break
        time.sleep(0.05)
    assert status == 0
    assert log.read_text() == "detached bg ['x', 'y']\n"
    assert json.loads((tmp_path / "bg" / "job.json").read_text())["args"] == ["x", "y"]


def test_the_command_line_runs_as_a_module(tmp_path):
    import subprocess

    driver = _driver(tmp_path, "print('via -m')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, "..", "src"),
                                         env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.submit", "--name", "m",
                        "--jobs-dir", str(tmp_path), "--attach", "img", driver],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "via -m" in r.stdout and "[ignis-submit] job m finished rc=0" in r.stdout


def _modules(root):
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                out.add(os.path.relpath(os.path.join(d, f), root))
    return out


def test_every_reference_module_has_its_port():
    """Every module of the JAX package has a counterpart at the same path in
    the port, but ``core/compat.py``: JAX-version shims, which the port (no
    JAX) has no use for."""
    src = os.path.join(HERE, "..", "src")
    ref, port = _modules(os.path.join(src, "repro")), _modules(os.path.join(src, "repro_torch"))
    assert ref - port == {"core/compat.py"}
    assert {"launch/dryrun.py", "launch/submit.py"} <= port
