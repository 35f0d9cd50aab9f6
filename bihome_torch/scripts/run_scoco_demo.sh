#!/usr/bin/env bash
# S-COCO flagship training-quality demonstration (zeng-biHomE) on the port
# (counterpart of tools/run_scoco_demo.sh): as run_pds_demo.sh, on the
# S-COCO protocol (no photometric distortion) with a 'grad'-family
# extractor. Stages skip when their artifact exists; stage 2 reuses the
# PDS supervised warm start if present.
# DEVICE=cpu runs on the CPU; PYTHON names the interpreter.
set -euo pipefail
cd "$(dirname "$0")/../.."

MARGIN="${MARGIN:-0.02}"
EPOCHS="${EPOCHS:-5}"
SEED="${SEED:-42}"
AUX="${AUX:-aux_gradnat.npz}"
LOGDIR="${LOGDIR:-log/zeng-bihome-scoco-lr-1e-3}"
DEVICE="${DEVICE:-cuda}"
PYTHON="${PYTHON:-python}"
# Layer-2 extractors (AUX ending in _l2.npz) need
# MODEL.HEAD.AUXILIARY_RESNET_OUTPUT_LAYER=2.
OUT_LAYER=1

if [ ! -f "$AUX" ]; then
  echo "=== stage 1: frozen extractor ($AUX) ==="
  case "$AUX" in
    aux_gradnat.npz) # pyramid distillation only
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext grad --steps 2500 \
          --device "$DEVICE" --out "$AUX" ;;
    aux_cl.npz)      # + dense-correspondence InfoNCE
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradcl --steps 2500 \
          --device "$DEVICE" --out "$AUX" ;;
    aux_clf.npz)     # + fine-negative (rex=0) term
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradcl \
          --cl_fine_weight 0.15 --steps 2500 --device "$DEVICE" --out \
          "$AUX" ;;
    aux_clfb.npz)    # + basin-sharpening term
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradcl \
          --cl_fine_weight 0.15 --basin_weight 0.3 --steps 2500 --device \
          "$DEVICE" --out "$AUX" ;;
    aux_clfr.npz)    # fine-negative + rich (rank-24) target
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradcl \
          --cl_fine_weight 0.15 --rich_target --steps 2500 --device \
          "$DEVICE" --out "$AUX" ;;
    aux_clfbr.npz)   # fine-negative + basin + rich target
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradcl \
          --cl_fine_weight 0.15 --basin_weight 0.3 --rich_target --steps \
          2500 --device "$DEVICE" --out "$AUX" ;;
    aux_clfh.npz)    # fine-negative + hard-negative weighting
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradcl \
          --cl_fine_weight 0.15 --cl_hard_beta 0.5 --steps 2500 --device \
          "$DEVICE" --out "$AUX" ;;
    aux_clfbh.npz)   # fine-negative + basin + hard negatives
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradcl \
          --cl_fine_weight 0.15 --basin_weight 0.3 --cl_hard_beta 0.5 \
          --steps 2500 --device "$DEVICE" --out "$AUX" ;;
    aux_clfb_l2.npz) # fine-negative + basin at layer2 (OUT_LAYER 2)
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradcl \
          --cl_fine_weight 0.15 --basin_weight 0.3 --layers 2 --steps 2500 \
          --device "$DEVICE" --out "$AUX" ;;
    aux_clfbh5k.npz) # the clfbh recipe on twice the steps
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradcl \
          --cl_fine_weight 0.15 --basin_weight 0.3 --cl_hard_beta 0.5 \
          --steps 5000 --device "$DEVICE" --out "$AUX" ;;
    aux_clfbhr.npz)  # clfbh + rich target
      "$PYTHON" -m bihome_torch.pretrain_aux --pretext gradcl \
          --cl_fine_weight 0.15 --basin_weight 0.3 --cl_hard_beta 0.5 \
          --rich_target --steps 2500 --device "$DEVICE" --out "$AUX" ;;
    *)
      echo "unknown AUX=$AUX: pretrain it first (bihome_torch.pretrain_aux)" >&2
      exit 1 ;;
  esac
fi
case "$AUX" in *_l2.npz) OUT_LAYER=2 ;; esac

if [ ! -d log/zeng-orig-pdscoco-lr-1e-3 ]; then
  echo "=== stage 2: supervised warm start (zeng-orig PDS, 3 epochs) ==="
  "$PYTHON" -m bihome_torch.train \
      --config_file config/pds-coco/zeng-orig-lr-1e-3.yaml --synthetic \
      --epochs 3 --device "$DEVICE"
fi

echo "=== stage 3: zeng-bihome S-COCO from the warm start ==="
# RESUME=1 extends a run to a larger EPOCHS instead of retraining it.
if [ "${RESUME:-0}" != "1" ]; then
  rm -rf "$LOGDIR"
fi
"$PYTHON" -m bihome_torch.train \
    --config_file config/s-coco/zeng-bihome-lr-1e-3.yaml \
    --synthetic --epochs "$EPOCHS" --device "$DEVICE" \
    --set "LOGGING.DIR=$LOGDIR" \
    --set MODEL.PRETRAINED=log/zeng-orig-pdscoco-lr-1e-3 \
    --set "MODEL.HEAD.AUXILIARY_RESNET_PATH=$AUX" \
    --set "MODEL.HEAD.AUXILIARY_RESNET_OUTPUT_LAYER=$OUT_LAYER" \
    --set MODEL.HEAD.TRIPLET_AGGREGATION=channel-aware \
    --set "MODEL.HEAD.TRIPLET_MARGIN=$MARGIN" \
    --set SOLVER.GRADIENT_CLIP=1.0 \
    --set SOLVER.LR=1e-4 \
    --set "DATA.SAMPLER.TRAIN_SEED=$SEED"
