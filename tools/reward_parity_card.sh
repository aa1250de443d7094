#!/bin/bash
# The kernel-path rows of tools/reward_parity.py on one CUDA card: for each
# of R1, R3, R4 and R5, the port's xla path and its kernel path, training
# seeds 0-2, at the row's budget. Lines go to chiprun_out/reward_parity_card.jsonl.
#   bash tools/reward_parity_card.sh [ROW ...] [-- extra tool arguments]
# With AT_ONCE=1 a row's six runs (two paths x three seeds) share the card
# at once, one CPU thread each; their lines say so and their train_wall_s
# is not a time of the path alone.
set -e
cd "$(dirname "$0")/.."
rows=()
while [ $# -gt 0 ] && [ "$1" != "--" ]; do rows+=("$1"); shift; done
[ "$1" = "--" ] && shift
[ ${#rows[@]} -eq 0 ] && rows=(R1 R3 R4 R5)
rc=0
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {
  python3 tools/reward_parity.py "$@" --card --log chiprun_out/reward_parity_card.jsonl
}
for row in "${rows[@]}"; do
  if [ "${AT_ONCE:-0}" = 1 ]; then
    # build the kernels once before the runs start
    python3 -c "from or_gym_inventory_torch.ops import _build; _build.build()"
    pids=()
    for path in xla kernel; do
      for seed in 0 1 2; do
        run "$row" --rollout "$path" --seeds "$seed" --threads 1 \
          --note "6 runs at once on one card" "$@" &
        pids+=($!)
      done
    done
    for p in "${pids[@]}"; do wait "$p" || rc=1; done
  else
    for path in xla kernel; do
      run "$row" --rollout "$path" --seeds 0 1 2 "$@"
    done
  fi
done
exit $rc
