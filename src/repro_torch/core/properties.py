"""IProperties — the ignis.* configuration system (paper §3.4, Fig. 6).

Dict-like with defaults, validation and prefix views. Property keys follow
the paper's naming (``ignis.executor.instances`` …) adapted to the torch
runtime: executors are virtual ranks on one device, and ``ignis.device``
names that device (``cuda`` by default; the CPU tests pass ``cpu``).

Every property lives in a typed registry (``PropSpec``: name,
type, default, validator, docstring — docs/properties.md). The runtime
behaviour is deliberately forgiving, matching the paper's
properties-file model:

* setting an **unknown** ``ignis.*`` key warns once per key (a misspelt
  scheduler knob should be loud, but third-party/app-private keys under
  other prefixes pass silently);
* setting an **invalid** value warns but stores it — consumers read with
  the typed getters whose defaults absorb garbage, and subsystems that
  must reject a value do so at use time (e.g. the kernel registry on an
  unparsable ``ignis.kernels.blocks`` list), never at assignment time;
* ``validate()`` reports every current violation for tools and tests,
  and ``tools/check_props.py`` gates that each registered property is
  documented.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class PropSpec:
    """One registered ``ignis.*`` property: its canonical string default,
    declared type (for docs/tools — storage stays stringly, as in the
    paper's properties files), optional validator (value → error string or
    None), and a docstring surfaced by ``describe()`` and docs tooling."""

    name: str
    type: str  # int | float | bool | str | bytes | enum
    default: str
    doc: str
    validator: Optional[Callable[[str], Optional[str]]] = None
    choices: tuple = field(default=())

    def check(self, value: str) -> Optional[str]:
        """Error message for an invalid ``value``, else None."""
        v = str(value).strip()
        if self.choices and v.lower() not in self.choices:
            return f"{self.name}={value!r}: expected one of {self.choices}"
        if self.type == "int":
            try:
                int(v)
            except ValueError:
                return f"{self.name}={value!r}: expected an integer"
        elif self.type == "float":
            try:
                float(v)
            except ValueError:
                return f"{self.name}={value!r}: expected a number"
        elif self.type == "bool":
            if v.lower() not in ("1", "0", "true", "false", "yes", "no",
                                 "on", "off"):
                return f"{self.name}={value!r}: expected a boolean"
        elif self.type == "bytes":
            s = v.upper()
            for suf in ("GB", "MB", "KB", "B"):
                if s.endswith(suf):
                    s = s[: -len(suf)]
                    break
            try:
                float(s)
            except ValueError:
                return f"{self.name}={value!r}: expected a size (e.g. 4GB)"
        if self.validator is not None:
            return self.validator(v)
        return None


REGISTRY: dict[str, PropSpec] = {}


def register(name: str, type: str, default: str, doc: str,
             validator=None, choices: tuple = ()) -> PropSpec:
    spec = PropSpec(name, type, default, doc, validator,
                    tuple(c.lower() for c in choices))
    REGISTRY[name] = spec
    return spec


def _auto_or_float(v: str) -> Optional[str]:
    if v.lower() == "auto":
        return None
    try:
        float(v)
    except ValueError:
        return f"expected a number of seconds or 'auto', got {v!r}"
    return None


# -- cluster / executor shape (paper §3.4) ----------------------------------
register("ignis.executor.image", "str", "ignishpc/torch",
         "Container image name (cosmetic under the torch runtime).")
register("ignis.device", "str", "cuda",
         "Torch device every executor rank lives on. A cluster asked for "
         "cuda raises where no card is visible; it never falls back.",
         choices=("cuda", "cpu"))
register("ignis.executor.instances", "int", "1",
         "Virtual executor ranks on the cluster device.")
register("ignis.executor.cores", "int", "1",
         "Model-axis devices per executor.")
register("ignis.executor.memory", "bytes", "16GB",
         "Per-executor memory budget for the capacity model.")
register("ignis.driver.memory", "bytes", "4GB",
         "Driver process memory budget.")
register("ignis.partition.type", "str", "memory",
         "Partition storage tier (paper §3.8).",
         choices=("memory", "rawmemory", "disk"))
register("ignis.partition.compression", "int", "6",
         "zlib level for the disk partition tier.")
register("ignis.partitions.per.executor", "int", "1",
         "Default partition count multiplier per executor.")
register("ignis.scheduler", "str", "local",
         "Job scheduler backend (launch/submit.py).",
         choices=("local", "slurm-sim"))
register("ignis.mode", "str", "ignis",
         "Execution mode: ignis, or spark for the round-trip baseline.",
         choices=("ignis", "spark"))
register("ignis.transport.compression", "int", "0",
         "zlib level for inter-process transport framing.")

# -- shuffle / join (DESIGN.md §6) ------------------------------------------
register("ignis.shuffle.capacity.factor", "float", "2.0",
         "Initial fan-out guess multiplier for the adaptive shuffle.")
register("ignis.shuffle.plan.cache.size", "int", "64",
         "Compiled wide-stage plan LRU entries.")
register("ignis.shuffle.memory.headroom", "float", "1.25",
         "Capacity-memory fit margin before overflow retry.")
register("ignis.join.max.matches", "int", "8",
         "Per-key match cap for the bounded join kernel.")

# -- fault tolerance (docs/fault_tolerance.md) ------------------------------
register("ignis.task.attempts", "int", "2",
         "Total scheduler attempts per job task (1 = never retry).")
register("ignis.task.speculative", "bool", "false",
         "Duplicate straggling gang tasks after the speculative timeout.")
register("ignis.task.speculative.timeout", "str", "30",
         "Straggler deadline in seconds, or 'auto' to derive it from the "
         "cost model's observed task history (docs/profiling.md §auto).",
         validator=_auto_or_float)
register("ignis.task.speculative.factor", "float", "3.0",
         "With timeout=auto: deadline = factor x the typical observed "
         "duration of tasks with the same signature.")

# -- stage fusion / cost model (DESIGN.md §5, §13) --------------------------
register("ignis.fusion.enabled", "bool", "true",
         "Fuse maximal narrow chains into compiled stages.")
register("ignis.fusion.mode", "str", "static",
         "Fusion boundary policy: static fuses every eligible chain; cost "
         "asks the cost model whether compiling a fused stage will pay for "
         "itself (docs/profiling.md §fusion).",
         choices=("static", "cost"))
register("ignis.fusion.plan.cache.size", "int", "128",
         "Compiled fused-stage plan LRU entries.")

# -- kernel tier (docs/kernels.md) ------------------------------------------
register("ignis.kernels", "str", "auto",
         "Kernel tier mode: auto picks the hand-written CUDA kernels on a "
         "cuda device; interpret forces the plain-torch stand-in on cpu.",
         choices=("auto", "on", "interpret", "off"))
register("ignis.kernels.blocks", "str", "128,256,512",
         "Autotune sweep block-size candidates (comma separated).")
register("ignis.kernels.tune.cache.size", "int", "512",
         "Autotune memo LRU entries.")

# -- elastic mesh (docs/elasticity.md) --------------------------------------
register("ignis.elastic.enabled", "bool", "false",
         "Let ElasticPolicy.poll()/on_admit() resize the worker mesh; off, "
         "the policy only reports what it WOULD do.")
register("ignis.elastic.min.executors", "int", "1",
         "Autoscaling floor: the policy never shrinks the world below this.")
register("ignis.elastic.max.executors", "int", "0",
         "Autoscaling ceiling (0 = every visible device).")
register("ignis.elastic.step", "int", "1",
         "Maximum ranks added/retired per policy decision.")
register("ignis.elastic.queue.per.executor", "int", "4",
         "Target scheduler queue depth per executor: desired world = "
         "ceil(queue / this), clamped to [min, max].")
register("ignis.elastic.cooldown.polls", "int", "1",
         "Consecutive same-direction polls required before the policy acts "
         "(deterministic hysteresis — no wall-clock cooldowns).")

# -- streaming / serving (docs/streaming.md) --------------------------------
register("ignis.stream.batch.rows", "int", "256",
         "Micro-batch size in rows.")
register("ignis.stream.max.inflight", "int", "8",
         "Global in-flight micro-batch cap.")
register("ignis.stream.tenant.quota", "int", "4",
         "Per-tenant in-flight micro-batch quota.")
register("ignis.stream.queue.depth", "int", "16",
         "Admission waiter queue depth.")
register("ignis.stream.shed.policy", "str", "block",
         "Overload policy: block applies backpressure (the only "
         "exactly-once-deterministic choice); shed drops and counts.")
register("ignis.stream.checkpoint.interval", "int", "0",
         "Micro-batches between offset/state checkpoints (0 = off).")
register("ignis.serve.queue.depth", "int", "64",
         "Serve front-door request queue bound.")

#: canonical {name: default} view of the registry — properties files and
#: tests seed from it
DEFAULTS = {name: spec.default for name, spec in REGISTRY.items()}

_warned_keys: set[str] = set()


def _warn_once(key: str, msg: str):
    if key in _warned_keys:
        return
    _warned_keys.add(key)
    warnings.warn(msg, stacklevel=3)


class IProperties:
    def __init__(self, base: dict | None = None):
        self._kv = dict(DEFAULTS)
        if base:
            for k, v in base.items():
                self[k] = v

    def __getitem__(self, k):
        return self._kv[k]

    def __setitem__(self, k, v):
        k, v = str(k), str(v)
        spec = REGISTRY.get(k)
        if spec is None:
            if k.startswith("ignis."):
                _warn_once(k, f"unknown property {k!r} — not in the ignis.* "
                              f"registry (docs/properties.md); stored as-is")
        else:
            err = spec.check(v)
            if err is not None:
                # stored anyway: typed getters absorb garbage via their
                # defaults, and use-time rejection stays with the subsystem
                _warn_once(f"{k}={v}", f"invalid property value: {err}")
        self._kv[k] = v

    def __contains__(self, k):
        return k in self._kv

    def get(self, k, default=None):
        return self._kv.get(k, default)

    def get_int(self, k, default=0):
        try:
            return int(self._kv.get(k, default))
        except ValueError:
            return default

    def get_bool(self, k, default=False):
        v = self._kv.get(k)
        if v is None:
            return default
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    def get_float(self, k, default=0.0):
        try:
            return float(self._kv.get(k, default))
        except ValueError:
            return default

    def get_bytes(self, k, default="0B"):
        s = self._kv.get(k, default).upper().strip()
        for suf, mul in (("GB", 2**30), ("MB", 2**20), ("KB", 2**10), ("B", 1)):
            if s.endswith(suf):
                return int(float(s[: -len(suf)]) * mul)
        return int(float(s))

    def view(self, prefix: str) -> dict:
        return {k: v for k, v in self._kv.items() if k.startswith(prefix)}

    def copy(self) -> "IProperties":
        c = IProperties.__new__(IProperties)
        c._kv = dict(self._kv)
        return c

    def validate(self) -> list[str]:
        """Every current violation: invalid values of registered props and
        unknown ``ignis.*`` keys. Reporting, not enforcement — see module
        docstring for why assignment never raises."""
        problems = []
        for k, v in sorted(self._kv.items()):
            spec = REGISTRY.get(k)
            if spec is None:
                if k.startswith("ignis."):
                    problems.append(f"unknown property {k!r}")
                continue
            err = spec.check(v)
            if err is not None:
                problems.append(err)
        return problems

    def describe(self, k: str) -> Optional[PropSpec]:
        """The registry spec for ``k`` (None when unregistered)."""
        return REGISTRY.get(k)

    def __repr__(self):
        return f"IProperties({len(self._kv)} keys)"
