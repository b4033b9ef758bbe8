#!/usr/bin/env bash
# The flagship recipe on cvm_tpu_torch, on one CUDA card: the reference's
# command (scripts/flagship_persist.sh:67-72) without --auto_restart, then
# the best checkpoint scored by cli.evaluate in six postures.
#
#   scripts/flagship_torch.sh OUT [WORKDIR]
#
# Writes into OUT: card.txt (nvidia-smi name, power limit), train.log,
# metrics.jsonl, best.json, eval.log and eval_<posture>.json. The
# checkpoints stay in WORKDIR (default: a new temporary directory), which a
# second call with the same WORKDIR resumes (--steps is a total).
# Compare with the reference's run: python3 scripts/compare_flagship.py OUT.
set -euo pipefail

OUT=${1:?usage: scripts/flagship_torch.sh OUT [WORKDIR]}
WORK=${2:-$(mktemp -d)}
mkdir -p "$OUT" "$WORK"
OUT=$(cd "$OUT" && pwd)
WORK=$(cd "$WORK" && pwd)
cd "$(dirname "$0")/.."

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python -m cvm_tpu_torch.cli.train --model centernet --data synthetic \
  --steps 5000 --eval_every 2500 --eval_batches 12 --keep_best mAP \
  --workdir "$WORK" --pad_hw 512,512 \
  --checkpoint_every 500 --log_every 100 \
  --num_classes 10 --max_objects 16 --batch_size 16 \
  --warmup_steps 250 --total_steps 5000 --device cuda 2>&1 | tee -a "$OUT/train.log"
cp "$WORK/metrics.jsonl" "$WORK/best/best.json" "$OUT/"

# FLAGSHIP_POSTURES (default: all six) picks the postures; empty skips them.
for posture in ${FLAGSHIP_POSTURES-fp fold_bn int8 w8a8_fused w8a8_fused_chain tta_hflip}; do
  case $posture in
    fp) flags=() ;;
    fold_bn) flags=(--fold_bn) ;;
    tta_hflip) flags=(--tta hflip) ;;
    *) flags=(--quantize "$posture") ;;
  esac
  start=$(date +%s.%N)
  python -m cvm_tpu_torch.cli.evaluate --model centernet --checkpoint_dir "$WORK/best" \
    --pad_hw 512,512 --batches 12 --device cuda --json_out "$OUT/eval_$posture.json" \
    ${flags[@]+"${flags[@]}"} 2>&1 | tee -a "$OUT/eval.log"
  seconds=$(python3 -c "print(round($(date +%s.%N) - $start, 2))")
  echo "[flagship_torch] $posture: $seconds s for the call" | tee -a "$OUT/eval.log"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$OUT/card.txt"
