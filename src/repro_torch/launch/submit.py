"""ignis-submit analogue (the port of ``repro.launch.submit``; paper §3.7,
Fig. 5).

  python -m repro_torch.launch.submit [--name X] [--properties k=v ...] \
         [--attach] <image> <driver.py> [driver args...]

The "resource manager" is simulated: the job spec (image, properties, mesh
request) is written to <jobdir>/job.json, then the driver runs in a fresh
process with IGNIS_* env carrying the properties — unattached by default
(paper: ignis-submit launches and exits; the driver's output goes to
<jobdir>/driver.log), --attach streams output and returns the driver's
return code. A property ``k.x`` reaches the driver as ``IGNIS_K_X`` (so
``ignis.device`` is ``IGNIS_IGNIS_DEVICE``), as in the JAX package; nothing
in either package reads these variables: the driver does.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser("ignis-submit")
    ap.add_argument("--name", default=None)
    ap.add_argument("--properties", action="append", default=[])
    ap.add_argument("--attach", action="store_true")
    ap.add_argument("--jobs-dir", default="/tmp/ignis-jobs")
    ap.add_argument("image")
    ap.add_argument("driver")
    ap.add_argument("driver_args", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)

    props = {}
    for kv in a.properties:
        k, _, v = kv.partition("=")
        props[k] = v
    name = a.name or f"job-{int(time.time())}"
    jobdir = os.path.join(a.jobs_dir, name)
    os.makedirs(jobdir, exist_ok=True)
    spec = {"name": name, "image": a.image, "driver": a.driver,
            "args": a.driver_args, "properties": props}
    with open(os.path.join(jobdir, "job.json"), "w") as f:
        json.dump(spec, f, indent=2)

    env = dict(os.environ)
    for k, v in props.items():
        env["IGNIS_" + k.replace(".", "_").upper()] = v
    env["IGNIS_JOB_NAME"] = name
    cmd = [sys.executable, a.driver, *a.driver_args]
    with open(os.path.join(jobdir, "driver.log"), "w") as log:
        if a.attach:
            rc = subprocess.call(cmd, env=env, stdout=sys.stdout, stderr=sys.stderr)
            print(f"[ignis-submit] job {name} finished rc={rc}")
            return rc
        p = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                             start_new_session=True)
    print(f"[ignis-submit] launched job {name} (pid {p.pid}, log {log.name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
