#!/usr/bin/env bash
# Predict-time knob sweep on a PDS-COCO flagship checkpoint, on the port
# (counterpart of tools/sweep_pds_predict.sh): the predict-only DSAC refine
# knobs over a trained checkpoint, one bihome_torch.eval run each over the
# whole protocol. Each result is appended to $OUT as "label<TAB>mace"
# ("FAILED" for a run that printed no mean MACE).
#
#   CKPT=log/zeng-bihome-pdscoco-clfbh AUX=aux_pdsclfbh.npz \
#     bihome_torch/scripts/sweep_pds_predict.sh
# DEVICE=cpu runs on the CPU; PYTHON names the interpreter.
set -uo pipefail
cd "$(dirname "$0")/../.."

CKPT="${CKPT:-log/zeng-bihome-pdscoco-clfbh}"
AUX="${AUX:-aux_pdsclfbh.npz}"
CFG="${CFG:-config/pds-coco/zeng-bihome-lr-1e-3.yaml}"
OUT="${OUT:-sweep_pds_predict.tsv}"
DEVICE="${DEVICE:-cuda}"
PYTHON="${PYTHON:-python}"

run() {
  local label="$1"; shift
  echo "=== $label ==="
  local mace
  mace=$("$PYTHON" -m bihome_torch.eval --config_file "$CFG" --synthetic \
      --batch_size 64 --ckpt "$CKPT" --skip_timing --device "$DEVICE" \
      --set "MODEL.HEAD.AUXILIARY_RESNET_PATH=$AUX" \
      --set MODEL.HEAD.TRIPLET_AGGREGATION=channel-aware \
      --set MODEL.HEAD.TRIPLET_MARGIN=0.02 \
      "$@" 2>&1 | grep '^Mean mace' | awk '{print $3}')
  echo -e "$label\t${mace:-FAILED}" | tee -a "$OUT"
}

R='--set MODEL.HEAD.DSAC_PREDICT_REFINE=true'
B='--set MODEL.HEAD.DSAC_PREDICT_BIDIRECTIONAL=true'

run base
run refine $R
run refine+bidir $R $B
for thr in 1.5 2.0 4.0; do
  run "refine+bidir thr=$thr" $R $B \
      --set "MODEL.HEAD.DSAC_PREDICT_REFINE_THRESHOLD=$thr"
done
# DSAC_PREDICT_REFINE_ITERS 1-3 run on the port (tests/
# test_torch_predict_refine.py); the sweep keeps JAX's knobs.
echo "sweep written to $OUT"
