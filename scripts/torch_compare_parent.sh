#!/bin/bash
# Time the port's suite rows, Europe's df64 query and the main path of
# this checkout beside another one (for example the parent commit,
# unpacked with `git archive <commit> | tar -x -C .scratch/parent`) on
# one GPU, in turns.  Run from the repo root on the GPU machine:
#
#     bash scripts/torch_compare_parent.sh .scratch/parent [OUT_DIR]
#
# Writes JSON lines under OUT_DIR (chiprun_out/measure by default): the
# card's name and power limit, bench_suite --only ba_1M_m10,stencil_2600,
# stencil_4000 in turns other, this, this, other (suite_*.jsonl),
# europe_df64 at its defaults in the same turns (europe_*.jsonl), and
# eval/main_path_times (main_path_times.jsonl).
# The graph, pack and oracle caches are shared (.bench_cache).
set -u
other=${1:?usage: torch_compare_parent.sh OTHER_CHECKOUT [OUT_DIR]}
out=${2:-chiprun_out/measure}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/smi.txt"
rows=ba_1M_m10,stencil_2600,stencil_4000
cache=$PWD/.bench_cache
top=$PWD
run () {  # module tag dir [args...]
  local mod=$1 tag=$2 dir=$3
  shift 3
  (cd "$dir" && python3 -m "tpu_lanczos_torch.eval.$mod" --cache "$cache" "$@" \
     > "$top/$out/${mod}_$tag.jsonl" 2> "$top/$out/${mod}_$tag.err")
  echo "$mod $tag rc=$?"
}
t0=$(date +%s)
run bench_suite other_1 "$other" --only $rows
run bench_suite this_1 . --only $rows
run bench_suite this_2 . --only $rows
run bench_suite other_2 "$other" --only $rows
run europe_df64 other_1 "$other"
run europe_df64 this_1 .
run europe_df64 this_2 .
run europe_df64 other_2 "$other"
python3 -m tpu_lanczos_torch.eval.main_path_times --other "$other" --tag other \
  > "$out/main_path_times.jsonl" 2> "$out/main_path_times.err"
echo "main_path_times rc=$?; $(( $(date +%s) - t0 )) s"
