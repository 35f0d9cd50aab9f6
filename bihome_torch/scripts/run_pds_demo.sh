#!/usr/bin/env bash
# PDS-COCO flagship training-quality demonstration (zeng-biHomE) on the
# port (counterpart of tools/run_pds_demo.sh).
#
# biHomE needs a frozen feature space that is alignment-sensitive and
# photometrically invariant. With no ImageNet weights, that space is
# distilled by bihome_torch.pretrain_aux (--pretext gradpds: invariance to
# the PDS distortion chain) over the synthetic pool.
#
# Stages (each skipped if its artifact already exists):
#   1. $AUX              frozen extractor (a pretext per AUX, below)
#   2. zeng-orig PDS     supervised warm start, 3 epochs
#   3. zeng-bihome PDS   biHomE loss only, frozen extractor, EPOCHS epochs
#
# TRIPLET_MARGIN sits at ~20% of the feature-distance scale (loss_comp/l3
# in metrics.jsonl); channel-aware aggregation; LR 1e-4; gradient clip 1.
# DEVICE=cpu runs on the CPU; PYTHON names the interpreter.
set -euo pipefail
cd "$(dirname "$0")/../.."

MARGIN="${MARGIN:-0.02}"
EPOCHS="${EPOCHS:-5}"
# SEED != 42 gives an independent run of the same recipe (datagen and
# sampler only; TEST_SEED stays 42, so eval MACE compares across seeds).
SEED="${SEED:-42}"
AUX="${AUX:-aux_pds.npz}"
LOGDIR="${LOGDIR:-log/zeng-bihome-pdscoco-lr-1e-3}"
DEVICE="${DEVICE:-cuda}"
PYTHON="${PYTHON:-python}"

if [ ! -f "$AUX" ]; then
  echo "=== stage 1: frozen extractor ($AUX) ==="
  case "$AUX" in
    aux_pds.npz)      # PDS-invariance distillation
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradpds --steps 2500 \
          --device "$DEVICE" --out "$AUX" ;;
    aux_pdscl.npz)    # + dense-correspondence InfoNCE
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradpdscl \
          --steps 2500 --device "$DEVICE" --out "$AUX" ;;
    aux_pdsclf.npz)   # + fine-negative (rex=0) term
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradpdscl \
          --steps 2500 --cl_fine_weight 0.15 --device "$DEVICE" \
          --out "$AUX" ;;
    aux_pdsclfb.npz)  # + basin-sharpening term
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradpdscl \
          --steps 2500 --cl_fine_weight 0.15 --basin_weight 0.3 \
          --device "$DEVICE" --out "$AUX" ;;
    aux_pdsclfbh.npz) # + hard-negative weighting (the clfbh recipe)
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradpdscl \
          --steps 2500 --cl_fine_weight 0.15 --basin_weight 0.3 \
          --cl_hard_beta 0.5 --device "$DEVICE" --out "$AUX" ;;
    *)
      echo "unknown AUX=$AUX: pretrain it first (bihome_torch.pretrain_aux)" >&2
      exit 1 ;;
  esac
fi

if [ ! -d log/zeng-orig-pdscoco-lr-1e-3 ]; then
  echo "=== stage 2: supervised warm start (zeng-orig PDS, 3 epochs) ==="
  "$PYTHON" -m bihome_torch.train \
      --config_file config/pds-coco/zeng-orig-lr-1e-3.yaml --synthetic \
      --epochs 3 --device "$DEVICE"
fi

echo "=== stage 3: zeng-bihome PDS from the warm start ==="
# A fresh start: MODEL.PRETRAINED applies only at step 0 (a checkpoint in
# LOGDIR would resume instead). RESUME=1 extends a run to a larger EPOCHS.
if [ "${RESUME:-0}" != "1" ]; then
  rm -rf "$LOGDIR"
fi
"$PYTHON" -m bihome_torch.train \
    --config_file config/pds-coco/zeng-bihome-lr-1e-3.yaml \
    --synthetic --epochs "$EPOCHS" --device "$DEVICE" \
    --set "LOGGING.DIR=$LOGDIR" \
    --set MODEL.PRETRAINED=log/zeng-orig-pdscoco-lr-1e-3 \
    --set "MODEL.HEAD.AUXILIARY_RESNET_PATH=$AUX" \
    --set MODEL.HEAD.TRIPLET_AGGREGATION=channel-aware \
    --set "MODEL.HEAD.TRIPLET_MARGIN=$MARGIN" \
    --set SOLVER.GRADIENT_CLIP=1.0 \
    --set SOLVER.LR=1e-4 \
    --set "DATA.SAMPLER.TRAIN_SEED=$SEED"
