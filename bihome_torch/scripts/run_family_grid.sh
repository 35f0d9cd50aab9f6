#!/usr/bin/env bash
# Training-quality grid of the non-flagship loss families on the port
# (counterpart of tools/run_family_grid.sh): detone-orig (supervised MSE),
# nguyen-orig S-COCO (PhotometricHead L1) and zhang-orig (TripletLoss).
#
# Each family trains its full reference schedule (EPOCHS epochs, batch 64)
# on the synthetic pool, then evaluates its final checkpoint. A family
# whose LOGGING.DIR already reached TARGET steps skips its training
# (bihome_torch.train resumes from LOGGING.DIR), so the script can be run
# again after an interruption. Every family runs even when one fails; the
# script then names the failed ones and exits 1.
#
#   bihome_torch/scripts/run_family_grid.sh [detone|nguyen|zhang]...
#   (default: all; DEVICE=cpu for the CPU, PYTHON for the interpreter,
#   LOG_ROOT for the runs' directories, default log)
set -uo pipefail
cd "$(dirname "$0")/../.."

EPOCHS="${EPOCHS:-25}"
TARGET="${TARGET:-90000}"
DEVICE="${DEVICE:-cuda}"
PYTHON="${PYTHON:-python}"
LOG_ROOT="${LOG_ROOT:-log}"

last_step() {
  [ -f "$1/metrics.jsonl" ] || { echo 0; return; }
  tail -1 "$1/metrics.jsonl" | grep -o '"step": [0-9]*' | grep -o '[0-9]*' \
    || echo 0
}

run_family() {
  local name="$1" config="$2" logdir="$3"
  local step
  step=$(last_step "$logdir")
  if [ "$step" -lt "$TARGET" ]; then
    echo "=== $name: training to $TARGET (at $step) ==="
    "$PYTHON" -m bihome_torch.train --config_file "$config" --synthetic \
        --epochs "$EPOCHS" --device "$DEVICE" \
        --set "LOGGING.DIR=$logdir" || return 1
  else
    echo "=== $name: already at step $step ==="
  fi
  echo "=== $name: eval at the final checkpoint ==="
  mkdir -p "$logdir"
  "$PYTHON" -m bihome_torch.eval --config_file "$config" --synthetic \
      --batch_size 64 --device "$DEVICE" \
      --ckpt "$logdir" > "$logdir/eval_final.txt" || return 1
  cat "$logdir/eval_final.txt"
}

FAMILIES=("$@")
[ ${#FAMILIES[@]} -eq 0 ] && FAMILIES=(detone nguyen zhang)
FAILED=()
for fam in "${FAMILIES[@]}"; do
  case "$fam" in
    detone)
      run_family detone-orig config/s-coco/detone-orig-lr-5e-3.yaml \
        "$LOG_ROOT/detone-orig-scoco-lr-5e-3" || FAILED+=("$fam") ;;
    nguyen)
      run_family nguyen-orig config/s-coco/nguyen-orig-lr-5e-3.yaml \
        "$LOG_ROOT/nguyen-orig-scoco-lr-5e-3" || FAILED+=("$fam") ;;
    zhang)
      run_family zhang-orig config/s-coco/zhang-orig-lr-1e-2.yaml \
        "$LOG_ROOT/zhang-orig-scoco-lr-1e-2" || FAILED+=("$fam") ;;
    *) echo "unknown family: $fam" >&2; exit 2 ;;
  esac
done
if [ ${#FAILED[@]} -gt 0 ]; then
  echo "failed families: ${FAILED[*]}" >&2
  exit 1
fi
