"""Optimized-HLO text analyzer with correct while-loop trip-count expansion.

XLA's built-in ``cost_analysis()`` counts each ``while`` body ONCE, which
under-counts scanned programs (layer scans, microbatch scans, chunked
attention) by orders of magnitude.  This walker parses the compiled HLO
text, reads ``known_trip_count`` from each while's backend_config, and
accumulates:

  flops            — dot/convolution (2*M*N*K-style) + 1/elem for elementwise
  hbm_bytes        — per *top-level kernel* (fusion boundary): operands + result
  collective_bytes — operand bytes of all-gather/all-reduce/reduce-scatter/
                     all-to-all/collective-permute, by kind and total
all multiplied by the product of enclosing trip counts.  Numbers are for the
per-device (partitioned) program.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")

_ELEMWISE = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "abs",
    "negate", "exponential", "exponential-minus-one", "log", "log-plus-one",
    "tanh", "rsqrt", "sqrt", "power", "cosine", "sine", "logistic",
    "select", "compare", "and", "or", "xor", "not", "floor", "ceil",
    "round-nearest-even", "sign", "clamp", "erf", "atan2", "remainder",
}

# "%name = TYPE opcode(operands), attrs"   (TYPE may be a tuple containing
# /*index=N*/ comments, so it is brace-matched, not regexed)
_LINE_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_OPCODE_RE = re.compile(r"\s*([\w\-]+)\(")
_SHAPE_RE = re.compile(r"\b([a-z]\w*)\[([\d,]*)\]")
_SCALAR_INT_CONST_RE = re.compile(r"[su]32\[\]\s+constant\((\d+)\)")
_CALL_ATTR_RE = re.compile(r"(?:calls|body)=%([\w.\-]+)")
_COND_ATTR_RE = re.compile(r"condition=%([\w.\-]+)")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\((.*?)\)\s*->")
_DIMS_ATTR = re.compile(r"(\w+_contracting_dims)=\{([\d,]*)\}")
_BATCH_ATTR = re.compile(r"(\w+_batch_dims)=\{([\d,]*)\}")


def _parse_shape(dtype: str, dims: str) -> Tuple[str, Tuple[int, ...]]:
    return dtype, tuple(int(d) for d in dims.split(",") if d)


def _shape_bytes(shapes: List[Tuple[str, Tuple[int, ...]]]) -> int:
    tot = 0
    for dt, dims in shapes:
        n = 1
        for d in dims:
            n *= d
        tot += n * _DTYPE_BYTES.get(dt, 4)
    return tot


def _numel(dims: Tuple[int, ...]) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


@dataclasses.dataclass
class Instr:
    name: str
    shapes: List[Tuple[str, Tuple[int, ...]]]   # result shapes (tuple-expanded)
    opcode: str
    operands: List[str]
    line: str


@dataclasses.dataclass
class Computation:
    name: str
    instrs: Dict[str, Instr]
    order: List[str]
    is_entry: bool


def _split_operands(s: str) -> List[str]:
    """Operand names from the call-paren region of an instruction line."""
    depth = 0
    out = []
    # operands region terminates at the matching ')' of the opcode '('
    buf = ""
    for ch in s:
        if ch == "(":
            depth += 1
            buf += ch
        elif ch == ")":
            if depth == 0:
                break
            depth -= 1
            buf += ch
        else:
            buf += ch
    for part in buf.split(","):
        part = part.strip()
        m = re.search(r"%([\w.\-]+)\s*$", part)
        if m:
            out.append(m.group(1))
    return out


def parse_module(text: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for raw in text.splitlines():
        line = raw.rstrip()
        if cur is None:
            if line.endswith("{") and ("->" in line):
                m = _COMP_HDR_RE.match(line.strip())
                if m:
                    cur = Computation(name=m.group(1), instrs={}, order=[],
                                      is_entry=line.startswith("ENTRY"))
            continue
        if line.startswith("}"):
            comps[cur.name] = cur
            cur = None
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        name, rest = m.groups()
        rest = rest.lstrip()
        # split "TYPE opcode(operands...)": TYPE may be a paren tuple with
        # embedded /*index=N*/ comments -> brace-match it.
        if rest.startswith("("):
            depth = 0
            end = 0
            for i, ch in enumerate(rest):
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                    if depth == 0:
                        end = i + 1
                        break
            type_str, after = rest[:end], rest[end:]
        else:
            sp = rest.find(" ")
            if sp < 0:
                continue
            type_str, after = rest[:sp], rest[sp:]
        mo = _OPCODE_RE.match(after)
        if not mo:
            continue
        opcode = mo.group(1)
        shapes = [_parse_shape(dt, dm) for dt, dm in _SHAPE_RE.findall(type_str)]
        operands = _split_operands(after[mo.end():])
        cur.instrs[name] = Instr(name=name, shapes=shapes, opcode=opcode,
                                 operands=operands, line=line)
        cur.order.append(name)
    return comps


_FREE_OPS = {"parameter", "tuple", "get-tuple-element", "bitcast", "constant",
             "iota", "after-all", "partition-id", "replica-id"}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "Costs", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0.0) + v * mult

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


class HloAnalyzer:
    def __init__(self, text: str):
        self.comps = parse_module(text)
        self.entry = next((c for c in self.comps.values() if c.is_entry), None)
        self._memo: Dict[Tuple[str, bool], Costs] = {}

    # ---------------------------------------------------------------- helpers
    def _operand_shapes(self, comp: Computation, instr: Instr):
        out = []
        for op in instr.operands:
            src = comp.instrs.get(op)
            if src is not None:
                out.extend(src.shapes)
        return out

    def _dot_flops(self, comp: Computation, instr: Instr) -> float:
        lhs = comp.instrs.get(instr.operands[0]) if instr.operands else None
        if lhs is None or not lhs.shapes:
            return 0.0
        lhs_dims = lhs.shapes[0][1]
        m = _DIMS_ATTR.findall(instr.line)
        lhs_c = []
        for key, idxs in m:
            if key.startswith("lhs"):
                lhs_c = [int(i) for i in idxs.split(",") if i]
        k = 1
        for i in lhs_c:
            if i < len(lhs_dims):
                k *= lhs_dims[i]
        out_elems = _numel(instr.shapes[0][1]) if instr.shapes else 0
        return 2.0 * out_elems * k

    def _conv_flops(self, comp: Computation, instr: Instr) -> float:
        # flops ~= 2 * out_elems * kernel_elems / out_channels
        rhs = comp.instrs.get(instr.operands[1]) if len(instr.operands) > 1 else None
        out_elems = _numel(instr.shapes[0][1]) if instr.shapes else 0
        k_elems = _numel(rhs.shapes[0][1]) if rhs and rhs.shapes else 1
        out_ch = instr.shapes[0][1][-1] if instr.shapes and instr.shapes[0][1] else 1
        return 2.0 * out_elems * k_elems / max(out_ch, 1)

    _PASSTHRU = {"parameter", "convert", "bitcast", "copy", "reshape",
                 "transpose", "tuple", "get-tuple-element"}

    def _is_dtype_artifact(self, callee: Optional[Computation]) -> bool:
        """Fusions containing only converts/copies/layout ops are XLA:CPU
        bf16->f32 promotion artifacts: TPU computes bf16 natively and these
        kernels do not exist in its lowering.  Charged zero."""
        if callee is None:
            return False
        return all(i.opcode in self._PASSTHRU
                   for i in callee.instrs.values())

    def _fusion_traffic(self, comp: Computation, instr: Instr,
                        called: Optional[str]) -> float:
        """HBM traffic of one fused kernel.

        Base model: operands + result.  Scan-critical refinements:
          * root = dynamic-update-slice: the big buffer is updated in place
            (XLA aliases it) — traffic is ~2x the update slice plus the other
            small operands, not the whole buffer per trip.
          * parameters consumed only by (dynamic-)slice ops: only the slice
            bytes move, not the whole source operand (scan xs indexing).
          * pure convert/copy fusions: zero (CPU dtype-promotion artifacts).
        """
        operand_shapes = []
        per_operand = []
        for opnd in instr.operands:
            src = comp.instrs.get(opnd)
            sh = src.shapes if src is not None else []
            per_operand.append(sh)
            operand_shapes.extend(sh)
        result_b = _shape_bytes(instr.shapes)
        callee = self.comps.get(called) if called else None
        if callee is None:
            return _shape_bytes(operand_shapes) + result_b
        if self._is_dtype_artifact(callee):
            return 0.0

        root_name = callee.order[-1] if callee.order else None
        root = callee.instrs.get(root_name) if root_name else None

        # map: parameter index -> set of consumer opcodes + slice result bytes
        param_names = {}
        for nm in callee.order:
            ins = callee.instrs[nm]
            if ins.opcode == "parameter":
                # "parameter(N)" — N from the line
                mnum = re.search(r"parameter\((\d+)\)", ins.line)
                if mnum:
                    param_names[nm] = int(mnum.group(1))
        # consumers of each instruction (to follow zero-cost bitcast chains)
        consumers_of: Dict[str, List[str]] = {}
        for nm in callee.order:
            for opnd in callee.instrs[nm].operands:
                consumers_of.setdefault(opnd, []).append(nm)

        def effective_consumers(nm: str, depth: int = 0) -> List[Instr]:
            out: List[Instr] = []
            if depth > 4:
                return out
            for cn in consumers_of.get(nm, []):
                ci = callee.instrs[cn]
                if ci.opcode == "bitcast":
                    out.extend(effective_consumers(cn, depth + 1))
                else:
                    out.append(ci)
            return out

        sliced_param_bytes: Dict[int, float] = {}
        param_consumers: Dict[str, List[str]] = {n: [] for n in param_names}
        for pname, pidx in param_names.items():
            for ci in effective_consumers(pname):
                param_consumers[pname].append(ci.opcode)
                if ci.opcode in ("dynamic-slice", "slice", "gather"):
                    sliced_param_bytes[pidx] = (
                        sliced_param_bytes.get(pidx, 0.0)
                        + _shape_bytes(ci.shapes))

        total = 0.0
        dus_inplace = root is not None and root.opcode == "dynamic-update-slice"
        for i, sh in enumerate(per_operand):
            b = _shape_bytes(sh)
            pname = [n for n, pi in param_names.items() if pi == i]
            consumers = param_consumers.get(pname[0], ["?"]) if pname else ["?"]
            if dus_inplace and sh and instr.shapes and sh == instr.shapes:
                continue  # aliased in-place buffer: charged via the update
            if pname and consumers and all(
                    c in ("dynamic-slice", "slice", "gather") for c in consumers):
                total += min(b, sliced_param_bytes.get(i, b))
            else:
                total += b
        if dus_inplace:
            upd = callee.instrs.get(root.operands[1]) if len(root.operands) > 1 else None
            upd_b = _shape_bytes(upd.shapes) if upd is not None else 0
            total += 2.0 * upd_b        # read-modify-write of the slice
        else:
            total += result_b
        return total

    def _while_trip(self, instr: Instr) -> int:
        """Trip count: backend_config known_trip_count, else the scalar int
        constant in the condition computation (jax scans: cond is `i < N`)."""
        mt = _TRIP_RE.search(instr.line)
        if mt:
            return int(mt.group(1))
        mc = _COND_ATTR_RE.search(instr.line)
        if mc:
            cond = self.comps.get(mc.group(1))
            if cond is not None:
                consts = []
                for nm in cond.order:
                    consts += [int(v) for v in
                               _SCALAR_INT_CONST_RE.findall(cond.instrs[nm].line)]
                if consts:
                    return max(consts)
        return 1

    # ------------------------------------------------------------------ walk
    def computation_costs(self, comp_name: str, top_level: bool) -> Costs:
        key = (comp_name, top_level)
        if key in self._memo:
            return self._memo[key]
        comp = self.comps.get(comp_name)
        costs = Costs()
        if comp is None:
            self._memo[key] = costs
            return costs
        for name in comp.order:
            instr = comp.instrs[name]
            op = instr.opcode
            if op == "while":
                trip = self._while_trip(instr)
                # scans marked "vmem_fused_*" are CPU stand-ins for Pallas
                # kernels whose intra-scan tiles live in VMEM scratch on TPU:
                # charge boundary traffic once, count flops/collectives fully
                fused = "vmem_fused" in instr.line
                mb = re.search(r"body=%([\w.\-]+)", instr.line)
                if mb:
                    costs.add(self.computation_costs(
                        mb.group(1), top_level and not fused), trip)
                if fused and top_level:
                    costs.hbm_bytes += (
                        _shape_bytes(self._operand_shapes(comp, instr))
                        + _shape_bytes(instr.shapes))
                continue
            if op in ("fusion", "call", "async-start"):
                mb = _CALL_ATTR_RE.search(instr.line)
                inner = (self.computation_costs(mb.group(1), False)
                         if mb else Costs())
                hbm = (self._fusion_traffic(comp, instr,
                                            mb.group(1) if mb else None)
                       if top_level else 0.0)
                kernel = Costs(flops=inner.flops, hbm_bytes=hbm,
                               coll_bytes=dict(inner.coll_bytes),
                               coll_counts=dict(inner.coll_counts))
                costs.add(kernel)
                continue
            if op == "conditional":
                # take the max-cost branch (upper bound)
                branches = re.findall(r"%([\w.\-]+)", instr.line)
                # heuristics: branch computations referenced via
                # true_computation=/false_computation=/branch_computations=
                bs = re.findall(r"computations?=\{?%?([\w.\-]+)", instr.line)
                best = Costs()
                for b in bs:
                    c = self.computation_costs(b, True)
                    if c.flops >= best.flops:
                        best = c
                costs.add(best)
                continue
            kind = op.replace("-start", "") if op.endswith("-start") else op
            if kind in _COLL_KINDS:
                b = _shape_bytes(self._operand_shapes(comp, instr))
                costs.coll_bytes[kind] = costs.coll_bytes.get(kind, 0.0) + b
                costs.coll_counts[kind] = costs.coll_counts.get(kind, 0.0) + 1
                if top_level:
                    costs.hbm_bytes += b + _shape_bytes(instr.shapes)
                continue
            if op in _FREE_OPS or op.endswith("-done") or op.endswith("-update"):
                continue
            # compute flops
            if op == "dot":
                costs.flops += self._dot_flops(comp, instr)
            elif op == "convolution":
                costs.flops += self._conv_flops(comp, instr)
            elif op in ("reduce", "reduce-window"):
                costs.flops += float(sum(_numel(s[1]) for s in
                                         self._operand_shapes(comp, instr)))
            elif op in _ELEMWISE:
                costs.flops += float(_numel(instr.shapes[0][1])
                                     if instr.shapes else 0)
            # memory: only top-level kernels touch HBM
            if top_level:
                if op in ("copy", "convert"):
                    continue  # CPU dtype-promotion / layout artifacts
                if op == "dynamic-update-slice":
                    upd = (comp.instrs.get(instr.operands[1])
                           if len(instr.operands) > 1 else None)
                    costs.hbm_bytes += 2.0 * (_shape_bytes(upd.shapes)
                                              if upd else 0)
                elif op in ("dynamic-slice", "slice", "gather"):
                    costs.hbm_bytes += 2.0 * _shape_bytes(instr.shapes)
                else:
                    costs.hbm_bytes += (
                        _shape_bytes(self._operand_shapes(comp, instr))
                        + _shape_bytes(instr.shapes))
        self._memo[key] = costs
        return costs

    def analyze(self) -> Costs:
        if self.entry is None:
            return Costs()
        return self.computation_costs(self.entry.name, True)


def analyze_text(text: str) -> Costs:
    return HloAnalyzer(text).analyze()
