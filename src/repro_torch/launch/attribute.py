"""Per-scope attribution of roofline terms — the profiling tool for the
hypothesis->change->measure loop (EXPERIMENTS.md §Perf).

Groups flops / HBM bytes / collective bytes by the jax named-scope prefix in
each instruction's op_name metadata, so a dominant term can be traced to the
owning subsystem (attention, moe, optimizer, grad-accum, ...).

  PYTHONPATH=src python -m repro_torch.launch.attribute --arch deepseek_v2_236b \
      --shape train_4k [--multi-pod] [--top 20] [--by coll|hbm|flops]
"""
import argparse
import re
import sys
from collections import Counter

from repro_torch.launch import hlo_parse


_OPNAME_RE = re.compile(r'op_name="([^"]*)"')


def _scope_of(line: str, depth: int = 3) -> str:
    m = _OPNAME_RE.search(line)
    if not m:
        return "(no-scope)"
    parts = [p for p in m.group(1).split("/") if not p.startswith("jit(")]
    keep = []
    for p in parts:
        keep.append(p.split("[")[0])
        if len(keep) >= depth:
            break
    return "/".join(keep) or "(root)"


def attribute(text: str, depth: int = 3):
    a = hlo_parse.HloAnalyzer(text)
    flops, hbm, coll = Counter(), Counter(), Counter()

    def walk(comp_name, mult, top):
        comp = a.comps.get(comp_name)
        if comp is None:
            return
        for name in comp.order:
            ins = comp.instrs[name]
            op = ins.opcode
            scope = _scope_of(ins.line, depth)
            if op == "while":
                trip = a._while_trip(ins)
                fused = "vmem_fused" in ins.line
                mb = re.search(r"body=%([\w.\-]+)", ins.line)
                if fused and top:
                    hbm[scope] += (hlo_parse._shape_bytes(
                        a._operand_shapes(comp, ins))
                        + hlo_parse._shape_bytes(ins.shapes)) * mult
                if mb:
                    walk(mb.group(1), mult * trip, top and not fused)
                continue
            if op in ("fusion", "call", "async-start"):
                mb = re.search(r"(?:calls|body)=%([\w.\-]+)", ins.line)
                inner = a.computation_costs(mb.group(1), False) if mb else None
                if inner:
                    flops[scope] += inner.flops * mult
                    for k, v in inner.coll_bytes.items():
                        coll[scope + f" [{k}]"] += v * mult
                if top:
                    hbm[scope] += a._fusion_traffic(
                        comp, ins, mb.group(1) if mb else None) * mult
                continue
            kind = op.replace("-start", "")
            if kind in hlo_parse._COLL_KINDS:
                b = hlo_parse._shape_bytes(a._operand_shapes(comp, ins))
                coll[scope + f" [{kind}]"] += b * mult
                if top:
                    hbm[scope] += (b + hlo_parse._shape_bytes(ins.shapes)) * mult
                continue
            if op in hlo_parse._FREE_OPS or op.endswith("-done"):
                continue
            if op == "dot":
                flops[scope] += a._dot_flops(comp, ins) * mult
            if top and op not in ("copy", "convert"):
                if op == "dynamic-update-slice":
                    upd = (comp.instrs.get(ins.operands[1])
                           if len(ins.operands) > 1 else None)
                    hbm[scope] += 2.0 * (hlo_parse._shape_bytes(upd.shapes)
                                         if upd else 0) * mult
                elif op in ("dynamic-slice", "slice", "gather"):
                    hbm[scope] += 2.0 * hlo_parse._shape_bytes(ins.shapes) * mult
                else:
                    hbm[scope] += (hlo_parse._shape_bytes(
                        a._operand_shapes(comp, ins))
                        + hlo_parse._shape_bytes(ins.shapes)) * mult

    walk(a.entry.name, 1, True)
    return flops, hbm, coll


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--hlo-file", default=None,
                    help="analyze a saved HLO text instead of lowering")
    args = ap.parse_args(argv)

    if args.hlo_file:
        text = open(args.hlo_file).read()
    else:
        from repro_torch.launch import dryrun
        lowered, meta = dryrun.lower_cell(args.arch, args.shape,
                                          multi_pod=args.multi_pod,
                                          microbatch=args.microbatch)
        text = lowered.compile().as_text()
    flops, hbm, coll = attribute(text, args.depth)
    for title, counter, unit, scale in (
            ("FLOPS", flops, "GF", 1e9), ("HBM", hbm, "GB", 1e9),
            ("COLLECTIVES", coll, "GB", 1e9)):
        total = sum(counter.values())
        print(f"== {title}: total {total/scale:.1f} {unit} (per device)")
        for scope, v in counter.most_common(args.top):
            print(f"  {v/scale:10.2f} {unit}  {v/total*100:5.1f}%  {scope}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
