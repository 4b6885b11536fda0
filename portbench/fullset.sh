#!/bin/sh
# The runs a cell's bounds are set from: two sets of six runs on the same
# six seeds, then three traced runs on other seeds, each run a process of
# its own at the manifest's run_seconds.  From the root of a checkout, on a
# machine with the CUDA devices the cell asks for:
#
#     sh portbench/fullset.sh <workload> <outdir>
#
# Writes each run's standard output and error to <outdir>, prints one line
# a run (exit code, wall time, result), then each set's spread of every
# end-to-end metric: the interquartile range over the median, with the
# quartiles of Python's statistics.quantiles(values, n=4).
set -u
W=$1
O=$2
mkdir -p "$O"
S=$(python3 -c 'import json; print(json.load(open("BENCHMARK.json"))["run_seconds"])')
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/card.txt"
SEEDS="2147483711 3000000037 4294967311 9007199254741017 1234567890123 5555555555"
i=0
for set in 1 2; do
  for s in $SEEDS; do
    i=$((i + 1))
    t=$(date +%s)
    python3 -m portbench.run --workload "$W" --seed "$s" --seconds "$S" \
      --trace 0 > "$O/run$i.out" 2> "$O/run$i.err"
    rc=$?
    echo "run$i set$set seed $s rc=$rc wall=$(( $(date +%s) - t ))s" \
      "$(tail -n 1 "$O/run$i.out" | cut -c1-600)"
  done
done
for s in 6100000003 6100000007 6100000009; do
  i=$((i + 1))
  t=$(date +%s)
  python3 -m portbench.run --workload "$W" --seed "$s" --seconds "$S" \
    --trace 1 > "$O/run$i.out" 2> "$O/run$i.err"
  rc=$?
  echo "run$i traced seed $s rc=$rc wall=$(( $(date +%s) - t ))s" \
    "$(tail -n 1 "$O/run$i.out" | cut -c1-900)"
done
python3 - "$O" <<'EOF'
import json
import statistics
import sys

out = sys.argv[1]
for first in (1, 7):
    runs = []
    for i in range(first, first + 6):
        try:
            with open(f"{out}/run{i}.out") as f:
                runs.append(json.loads(f.read().splitlines()[-1]))
        except (OSError, IndexError, ValueError):
            pass
    names = sorted({k for r in runs for k in r["metrics"]})
    for k in names:
        v = [r["metrics"][k]["value"] for r in runs if k in r["metrics"]]
        q1, q2, q3 = statistics.quantiles(v, n=4)
        print(f"set {1 + first // 7} {k}: median {q2!r} spread "
              f"{(q3 - q1) / q2!r} over {len(v)} runs; correct "
              f"{sum(r['correct'] for r in runs)}/{len(runs)}")
EOF
