#!/usr/bin/env bash
# The semseg flagship recipe on cvm_tpu_torch, on one CUDA card: the
# reference's command (scripts/flagship_semseg.sh:20-23; BASELINE config
# A's 256x640 SemsegParams defaults, 5 classes, batch 16, 4000 steps, an
# eval of 12 batches every 2000, --keep_best miou) without --auto_restart,
# then the best checkpoint scored by cli.evaluate in four postures.
#
#   scripts/flagship_semseg_torch.sh OUT [WORKDIR]
#
# Writes into OUT: card.txt (nvidia-smi name, power limit), train.log,
# metrics.jsonl, best.json, eval.log and eval_<posture>.json. The
# checkpoints stay in WORKDIR (default: a new temporary directory), which a
# second call with the same WORKDIR resumes (--steps is a total).
# Compare with the reference's run: python3 scripts/compare_flagship_semseg.py OUT.
set -euo pipefail

OUT=${1:?usage: scripts/flagship_semseg_torch.sh OUT [WORKDIR]}
WORK=${2:-$(mktemp -d)}
mkdir -p "$OUT" "$WORK"
OUT=$(cd "$OUT" && pwd)
WORK=$(cd "$WORK" && pwd)
cd "$(dirname "$0")/.."

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python -m cvm_tpu_torch.cli.train --model semseg --data synthetic \
  --steps 4000 --eval_every 2000 --eval_batches 12 --keep_best miou \
  --workdir "$WORK" --checkpoint_every 500 --log_every 100 \
  --batch_size 16 --warmup_steps 200 --total_steps 4000 --device cuda 2>&1 \
  | tee -a "$OUT/train.log"
cp "$WORK/metrics.jsonl" "$WORK/best/best.json" "$OUT/"

for posture in fp fold_bn w8a8_fused w8a8_fused_chain; do
  case $posture in
    fp) flags=() ;;
    fold_bn) flags=(--fold_bn) ;;
    *) flags=(--quantize "$posture") ;;
  esac
  start=$(date +%s.%N)
  python -m cvm_tpu_torch.cli.evaluate --model semseg --checkpoint_dir "$WORK/best" \
    --batches 12 --device cuda --json_out "$OUT/eval_$posture.json" \
    ${flags[@]+"${flags[@]}"} 2>&1 | tee -a "$OUT/eval.log"
  seconds=$(python3 -c "print(round($(date +%s.%N) - $start, 2))")
  echo "[flagship_semseg_torch] $posture: $seconds s for the call" | tee -a "$OUT/eval.log"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$OUT/card.txt"
