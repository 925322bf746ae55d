#!/bin/bash
# chip_smoke.py of two trees on one card, in one call: parent, change,
# change, parent.  Each tree is a `git archive` unpacked into a directory
# that .gitignore lists (build/ here), and each run builds its kernels
# anew.  Prints each run's exit code and wall seconds, and each phase's
# seconds from chip_smoke.py's progress stamps on stderr (a phase runs
# from its first stamp to the next phase's; the last to the run's end).
#
#   git archive HEAD | tar -x -C build/arch_parent
#   git add -A && git archive $(git write-tree) | tar -x -C build/arch_change
#   bash benchmarks/chip_smoke_ab.sh build/arch_parent build/arch_change [OUT]
#
# on a machine with one card.  Each run's stdout and stderr go to
# OUT/ab_<run>.out and .err (OUT: build/ab by default).  A fourth
# argument runs that script of each tree instead of chip_smoke.py (one
# that prints progress stamps alike: benchmarks/sharded_phases.py).
set -u
parent=$1
change=$2
script=${4:-chip_smoke.py}
mkdir -p "${3:-build/ab}"
out=$(cd "${3:-build/ab}" && pwd)
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for run in parent1 change1 change2 parent2; do
  case $run in parent*) d=$parent;; *) d=$change;; esac
  rm -rf "$d/build"
  t0=$(date +%s.%N)
  (cd "$d" && timeout 1200 python3 "$script" > "$out/ab_$run.out" \
     2> "$out/ab_$run.err")
  rc=$?
  t1=$(date +%s.%N)
  echo "$run rc $rc seconds $(python3 -c "print($t1 - $t0)")"
  echo "$t0 $t1" > "$out/ab_$run.wall"
  tail -2 "$out/ab_$run.out" | cut -c1-300
done
python3 - "$out" <<'EOF'
import json, re, sys
out = sys.argv[1]
table = {}
for run in ("parent1", "change1", "change2", "parent2"):
    t0, t1 = map(float, open(f"{out}/ab_{run}.wall").read().split())
    starts = {}
    for line in open(f"{out}/ab_{run}.err"):
        m = re.match(r"\[\s*([\d.]+)s\] ([a-z_0-9]+)(:|$)", line.rstrip("\n"))
        if m and m.group(2) not in starts:
            starts[m.group(2)] = float(m.group(1))
    names = list(starts)
    ends = [starts[n] for n in names[1:]] + [t1 - t0]
    table[run] = {"wall_s": t1 - t0,
                  **{n: e - starts[n] for n, e in zip(names, ends)}}
print(json.dumps(table))
EOF
