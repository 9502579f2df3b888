"""Post-partitioning HLO cost model: FLOPs, HBM traffic, collective bytes (a
copy of the JAX package's ``repro.launch.hlo_cost``, which the port does not
import: a pure-text parser, so ``CostModel.price_hlo`` prices HLO text that
a JAX program lowered, e.g. to hold the port's graph pricing against it).


XLA's ``compiled.cost_analysis()`` visits while-loop bodies ONCE — a
scan-over-layers model under-reports by ~num_layers×. This parser walks the
optimized HLO text, memoizes per-computation costs, multiplies ``while``
bodies by their trip count (recovered from the loop-condition compare
constant), and attributes:

  flops      — 2·M·N·K for dots (contracting dims parsed from the attr),
               1/elem for everything else (negligible next to the dots)
  hbm_bytes  — per top-level op: operand bytes + result bytes (fusion nodes
               count their boundary buffers only — internals stay in VMEM)
  comm       — per collective kind: operand bytes (the §Roofline definition)
  wire_bytes — algorithm-modelled bytes on the wire per device:
               all-reduce 2·(n-1)/n · b ; all-gather / reduce-scatter /
               all-to-all (n-1)/n · b ; collective-permute 1·b

The module is partitioned (SPMD), so every number is PER DEVICE.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2,
    # the fp8 family has grown spellings across XLA releases; all are 1 byte
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
    "f8e4m3fnuz": 1, "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1, "f8e8m0fnu": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
    # sub-byte types round up: the parser prices HBM touches, and XLA packs
    # them per-buffer, so 1 byte is the honest ceiling at this granularity
    "s4": 1, "u4": 1, "s2": 1, "u2": 1, "f4e2m1fn": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
_NAME_EQ_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_OPCODE_RE = re.compile(r"^([\w\-]+)\((.*)$", re.DOTALL)
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")


def _split_instr(line: str):
    """'%x = TYPE opcode(operands), attrs' → (name, type_str, opcode, rest).

    TYPE may be a tuple type with nested parens and /*index=N*/ comments.
    Returns None if the line is not an instruction.
    """
    m = _NAME_EQ_RE.match(line)
    if not m:
        return None
    name, rest = m.group(1), m.group(2)
    if rest.startswith("("):
        depth = 0
        for i, ch in enumerate(rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    break
        type_str, remainder = rest[: i + 1], rest[i + 1 :].strip()
    else:
        type_str, _, remainder = rest.partition(" ")
    m2 = _OPCODE_RE.match(remainder)
    if not m2:
        return None
    return name, type_str, m2.group(1), m2.group(2)

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
)


def shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def shape_elems(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n
    return total


@dataclass
class Instr:
    name: str
    type_str: str
    opcode: str
    rest: str  # operand list + attrs (raw tail of the line)
    operands: list = field(default_factory=list)
    is_root: bool = False


@dataclass
class Cost:
    flops: float = 0.0
    hbm: float = 0.0
    comm: dict = field(default_factory=dict)
    wire: float = 0.0
    unknown_trips: int = 0

    def __iadd__(self, o):
        self.flops += o.flops
        self.hbm += o.hbm
        self.wire += o.wire
        self.unknown_trips += o.unknown_trips
        for k, v in o.comm.items():
            self.comm[k] = self.comm.get(k, 0.0) + v
        return self

    def scaled(self, f):
        return Cost(
            self.flops * f, self.hbm * f, {k: v * f for k, v in self.comm.items()},
            self.wire * f, self.unknown_trips,
        )


_OPERAND_NAME_RE = re.compile(r"%[\w.\-]+")
_CALLS_RE = re.compile(
    r"(?:calls|body|condition|to_apply|true_computation|false_computation)=(%?[\w.\-]+)"
)
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_CONST_INT_RE = re.compile(r"constant\((\d+)\)")

# ops that move no HBM bytes of their own
_FREE_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "partition-id", "replica-id", "iota", "copy-start", "copy-done",
}

# ops that move bytes but do no arithmetic — billing these 1 flop/elem (the
# generic fallback) triple-counted e.g. a bf16 add lowered as
# convert→add→convert; they cost HBM traffic only
_MOVE_OPS = {
    "convert", "broadcast", "reshape", "transpose", "slice", "concatenate",
    "pad", "gather", "copy", "reverse", "reduce-precision",
}


class HloModule:
    def __init__(self, text: str):
        self.computations: dict[str, list[Instr]] = {}
        self.entry: str | None = None
        self._parse(text)
        self._cost_cache: dict[str, Cost] = {}

    # ---- parsing -----------------------------------------------------------
    def _parse(self, text: str):
        cur = None
        for line in text.splitlines():
            if not line.strip() or line.startswith(("HloModule", "//", "#")):
                continue
            if not line.startswith(" ") and line.rstrip().endswith("{") and "->" in line:
                s = line.strip()
                is_entry = s.startswith("ENTRY")
                if is_entry:
                    s = s[len("ENTRY") :].strip()
                cur = s.split()[0].split("(")[0].lstrip("%")
                self.computations[cur] = []
                if is_entry:
                    self.entry = cur
                continue
            if line.strip() == "}":
                cur = None
                continue
            if cur is None:
                continue
            parsed = _split_instr(line)
            if parsed is None:
                continue
            name, type_str, opcode, rest = parsed
            ins = Instr(name, type_str, opcode, rest, is_root="ROOT" in line[:12])
            # operand names = %refs before any attr section in rest
            head = rest.split("),", 1)[0]
            ins.operands = [x.lstrip("%") for x in _OPERAND_NAME_RE.findall(head)]
            self.computations[cur].append(ins)
        if self.entry is None and self.computations:
            # entry is usually last
            self.entry = list(self.computations)[-1]

    def _symbols(self, comp: str) -> dict[str, Instr]:
        return {i.name: i for i in self.computations.get(comp, [])}

    def _root_of(self, comp: str):
        instrs = self.computations.get(comp, [])
        for i in instrs:
            if i.is_root:
                return i
        return instrs[-1] if instrs else None

    # ---- trip counts -------------------------------------------------------
    def _trip_count(self, cond_comp: str, body_comp: str) -> int | None:
        """Loop trip count from the condition's `compare(ind, const), LT`."""
        syms = self._symbols(cond_comp)
        for ins in self.computations.get(cond_comp, []):
            if ins.opcode != "compare":
                continue
            for op in ins.operands:
                ref = syms.get(op)
                if ref is not None and ref.opcode == "constant":
                    m = _CONST_INT_RE.search(ref.type_str + " constant(" + ref.rest)
                    m2 = re.search(r"constant\((\d+)\)", "constant(" + ref.rest)
                    if m2:
                        return int(m2.group(1))
                    if m:
                        return int(m.group(1))
        return None

    # ---- group size --------------------------------------------------------
    @staticmethod
    def _group_size(rest: str) -> int:
        m = _GROUPS_IOTA_RE.search(rest)
        if m:
            return max(int(m.group(2)), 1)
        m = _GROUPS_LIST_RE.search(rest)
        if m:
            return max(len(m.group(1).split(",")), 1)
        return 1

    # ---- dot flops ---------------------------------------------------------
    def _dot_flops(self, ins: Instr, syms: dict) -> float:
        out_elems = shape_elems(ins.type_str)
        k = 1
        m = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", ins.rest)
        if m and ins.operands:
            lhs = syms.get(ins.operands[0])
            if lhs is not None:
                dims_m = _SHAPE_RE.search(lhs.type_str)
                if dims_m:
                    dims = [int(d) for d in dims_m.group(2).split(",") if d]
                    for ci in m.group(1).split(","):
                        if ci and int(ci) < len(dims):
                            k *= dims[int(ci)]
        return 2.0 * out_elems * max(k, 1)

    # ---- per-computation cost ----------------------------------------------
    def computation_cost(self, comp: str) -> Cost:
        if comp in self._cost_cache:
            return self._cost_cache[comp]
        self._cost_cache[comp] = Cost()  # break recursion
        total = Cost()
        syms = self._symbols(comp)
        for ins in self.computations.get(comp, []):
            total += self._instr_cost(ins, syms)
        self._cost_cache[comp] = total
        return total

    def _operand_bytes(self, ins: Instr, syms: dict) -> float:
        b = 0
        for op in ins.operands:
            ref = syms.get(op)
            if ref is not None:
                b += shape_bytes(ref.type_str)
        return b

    def _instr_cost(self, ins: Instr, syms: dict) -> Cost:
        op = ins.opcode
        c = Cost()
        if op in _FREE_OPS:
            return c
        called = _CALLS_RE.findall(ins.rest)

        if op == "while":
            body = cond = None
            mb = re.search(r"body=(%?[\w.\-]+)", ins.rest)
            mc = re.search(r"condition=(%?[\w.\-]+)", ins.rest)
            if mb:
                body = mb.group(1).lstrip("%")
            if mc:
                cond = mc.group(1).lstrip("%")
            inner = Cost()
            if body:
                inner += self.computation_cost(body)
            if cond:
                inner += self.computation_cost(cond)
            # primary source: XLA records the analysed trip count on the op
            trip = None
            mt = re.search(r'known_trip_count[^}]*"n"\s*:\s*"(\d+)"', ins.rest)
            if mt:
                trip = int(mt.group(1))
            if trip is None and cond:
                trip = self._trip_count(cond, body)
            if trip is None:
                c += inner
                c.unknown_trips += 1
            else:
                c += inner.scaled(trip)
            return c

        if op == "conditional":
            names = list(called)
            mb = _BRANCHES_RE.search(ins.rest)
            if mb:
                names += [x.strip() for x in mb.group(1).split(",") if x.strip()]
            branches = [self.computation_cost(x.lstrip("%")) for x in names]
            if branches:
                c += max(branches, key=lambda b: b.flops + b.hbm)
            return c

        if op in ("fusion", "call", "async-start"):
            inner = Cost()
            for comp in called:
                inner += self.computation_cost(comp.lstrip("%"))
            c.flops += inner.flops
            c.wire += inner.wire
            c.unknown_trips += inner.unknown_trips
            for k, v in inner.comm.items():
                c.comm[k] = c.comm.get(k, 0.0) + v
            if op != "fusion":
                c.hbm += inner.hbm  # real calls execute their bodies
                return c
            # fusion: internals live in registers/VMEM — only boundary buffers
            # move. If the fused root is a dynamic-update-slice the big buffer
            # is updated in place: only the slice moves.
            root = self._root_of(called[0].lstrip("%")) if called else None
            if root is not None and root.opcode == "dynamic-update-slice":
                fsyms = self._symbols(called[0].lstrip("%"))
                upd = fsyms.get(root.operands[1]) if len(root.operands) > 1 else None
                slice_b = shape_bytes(upd.type_str) if upd is not None else 0
                ops_b = [shape_bytes(syms[o].type_str) for o in ins.operands if o in syms]
                big = max(ops_b) if ops_b else 0
                c.hbm += sum(ops_b) - big + 2 * slice_b
            else:
                c.hbm += shape_bytes(ins.type_str) + self._operand_bytes(ins, syms)
            return c

        base = op[:-6] if op.endswith("-start") else op
        if base in COLLECTIVES:
            if op.endswith("-done"):
                return c
            b = self._operand_bytes(ins, syms)
            if b == 0:  # e.g. operands not in scope table
                b = shape_bytes(ins.type_str)
            n = self._group_size(ins.rest)
            c.comm[base] = c.comm.get(base, 0.0) + b
            if base == "all-reduce":
                c.wire += 2.0 * b * (n - 1) / max(n, 1)
            elif base in ("all-gather",):
                c.wire += b * (n - 1)  # operand is the shard
            elif base in ("reduce-scatter", "all-to-all"):
                c.wire += b * (n - 1) / max(n, 1)
            else:  # collective-permute
                c.wire += b
            c.hbm += b + shape_bytes(ins.type_str)
            return c

        if op == "dynamic-update-slice":  # in-place: only the slice moves
            upd = syms.get(ins.operands[1]) if len(ins.operands) > 1 else None
            c.hbm += 2 * (shape_bytes(upd.type_str) if upd is not None else 0)
            return c
        if op == "dynamic-slice":
            c.hbm += 2 * shape_bytes(ins.type_str)
            return c

        # generic op
        rb = shape_bytes(ins.type_str)
        c.hbm += rb + self._operand_bytes(ins, syms)
        if op == "dot":
            c.flops += self._dot_flops(ins, syms)
        elif op == "convolution":
            c.flops += 2.0 * shape_elems(ins.type_str)  # rough (none expected)
        elif op not in _MOVE_OPS:
            c.flops += shape_elems(ins.type_str)  # 1 flop/elem elementwise-ish
        return c

    def entry_cost(self) -> Cost:
        return self.computation_cost(self.entry)


def analyze(hlo_text: str) -> dict:
    mod = HloModule(hlo_text)
    c = mod.entry_cost()
    return {
        "flops_per_device": c.flops,
        "hbm_bytes_per_device": c.hbm,
        "comm_bytes_per_device": dict(c.comm),
        "comm_bytes_total_per_device": sum(c.comm.values()),
        "wire_bytes_per_device": c.wire,
        "unknown_trip_loops": c.unknown_trips,
        "n_computations": len(mod.computations),
    }


def top_collectives(hlo_text: str, k: int = 15) -> list[dict]:
    """Diagnostic: the k largest collectives, trip-multiplied, with the loop
    nest they live in — the §Perf 'where is the wire time going' view."""
    mod = HloModule(hlo_text)
    # trip multiplier per computation (1 for entry, × for while bodies)
    mult: dict[str, float] = {}

    def fill(comp: str, m: float):
        if comp in mult and mult[comp] >= m:
            return
        mult[comp] = m
        for ins in mod.computations.get(comp, []):
            called = _CALLS_RE.findall(ins.rest)
            if ins.opcode == "while":
                trip = None
                mt = re.search(r'known_trip_count[^}]*"n"\s*:\s*"(\d+)"', ins.rest)
                if mt:
                    trip = int(mt.group(1))
                for c2 in called:
                    fill(c2.lstrip("%"), m * (trip or 1))
            else:
                for c2 in called:
                    fill(c2.lstrip("%"), m)

    fill(mod.entry, 1.0)
    out = []
    for comp, instrs in mod.computations.items():
        m = mult.get(comp, 0.0)
        if m == 0:
            continue
        syms = {i.name: i for i in instrs}
        for ins in instrs:
            base = ins.opcode[:-6] if ins.opcode.endswith("-start") else ins.opcode
            if base not in COLLECTIVES or ins.opcode.endswith("-done"):
                continue
            b = sum(shape_bytes(syms[o].type_str) for o in ins.operands if o in syms)
            if b == 0:
                b = shape_bytes(ins.type_str)
            meta = re.search(r'op_name="([^"]*)"', ins.rest)
            out.append({
                "op": base,
                "bytes_each": b,
                "trips": m,
                "bytes_total": b * m,
                "comp": comp[:60],
                "src": (meta.group(1)[:110] if meta else ""),
            })
    out.sort(key=lambda d: -d["bytes_total"])
    return out[:k]
