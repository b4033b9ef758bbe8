#!/usr/bin/env bash
# The int8 deployment recipe on cvm_tpu_torch, on one CUDA card: the fp
# flagship to step 5000 (scripts/flagship_torch.sh), post-training W8A8 on
# that checkpoint, the QAT fine-tune 5000 -> 6500 (the reference's
# flagship_512_qat run), and the QAT checkpoint exported as artifacts and
# scored (the reference's scripts/qat_artifacts.sh), beside direct evals of
# the same postures.
#
#   scripts/qat_torch.sh OUT [WORKDIR]
#
# Writes into OUT: card.txt, flagship/ (flagship_torch.sh's training records),
# eval_fp5000_<posture>.json (fp, w8a8, w8a8_static on the step-5000
# checkpoint), qat_train.log, qat_metrics.jsonl, qat_best.json,
# export_<posture>.json (cli.export's stats), eval_qat_artifact_<posture>.json
# and eval_qat_direct_<posture>.json, and steps.log (seconds per step of the
# script). Checkpoints and artifacts stay in WORKDIR (default: a new
# temporary directory). Compare with the reference: python3
# scripts/compare_qat.py OUT.
set -euo pipefail

OUT=${1:?usage: scripts/qat_torch.sh OUT [WORKDIR]}
WORK=${2:-$(mktemp -d)}
mkdir -p "$OUT" "$WORK"
OUT=$(cd "$OUT" && pwd)
WORK=$(cd "$WORK" && pwd)
cd "$(dirname "$0")/.."

EVAL=(--pad_hw 512,512 --batches 12 --device cuda)
timed() {  # NAME CMD...: run CMD, log its seconds and exit code; a failed
  # eval or export does not stop the later ones (a failed training run
  # stops the script at the copy of its records)
  local name=$1 start rc=0
  shift
  start=$(date +%s.%N)
  "$@" || rc=$?
  echo "[qat_torch] $name: $(python3 -c "print(round($(date +%s.%N) - $start, 2))") s," \
    "exit $rc" | tee -a "$OUT/steps.log" >&2
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"

# 1. The fp flagship to step 5000 (its posture evals are left out: step 2
#    scores the postures this recipe compares).
timed flagship env FLAGSHIP_POSTURES= bash scripts/flagship_torch.sh "$OUT/flagship" \
  "$WORK/fp"

# 2. Post-training W8A8 on the step-5000 checkpoint, beside fp.
for posture in fp w8a8 w8a8_static; do
  flags=()
  if [[ $posture != fp ]]; then flags=(--quantize "$posture"); fi
  timed "fp5000 $posture" python -m cvm_tpu_torch.cli.evaluate --model centernet \
    --checkpoint_dir "$WORK/fp/checkpoints" "${EVAL[@]}" \
    --json_out "$OUT/eval_fp5000_$posture.json" ${flags[@]+"${flags[@]}"} 2>&1 \
    | tee -a "$OUT/eval.log"
done

# 3. The QAT fine-tune, steps 5000 -> 6500, in a workdir seeded with the
#    step-5000 checkpoint (its config is the fp run's, with qat on).
mkdir -p "$WORK/qat/checkpoints"
cp "$WORK/fp/checkpoints/5000.pt" "$WORK/qat/checkpoints/"
timed "qat fine-tune" python -m cvm_tpu_torch.cli.train --model centernet --data synthetic \
  --qat true --steps 6500 --eval_every 500 --eval_batches 12 --keep_best mAP \
  --workdir "$WORK/qat" --pad_hw 512,512 \
  --checkpoint_every 500 --log_every 100 \
  --num_classes 10 --max_objects 16 --batch_size 16 \
  --warmup_steps 250 --total_steps 5000 --device cuda 2>&1 | tee "$OUT/qat_train.log"
cp "$WORK/qat/metrics.jsonl" "$OUT/qat_metrics.jsonl"
cp "$WORK/qat/best/best.json" "$OUT/qat_best.json"

# 4. The best QAT checkpoint as artifacts (as scripts/qat_artifacts.sh:
#    batch 16, 512x512 canvas, RGB), each scored as served, and the direct
#    eval of each posture on the same checkpoint and eval stream.
for posture in none w8a8 w8a8_fused w8a8_fused_chain; do
  timed "export $posture" python -m cvm_tpu_torch.cli.export --model centernet \
    --checkpoint_dir "$WORK/qat/best" --out "$WORK/art_$posture" --quantize "$posture" \
    --batch_size 16 --pad_hw 512,512 --device cuda | tee "$OUT/export_$posture.json"
  timed "artifact $posture" python -m cvm_tpu_torch.cli.evaluate \
    --artifact "$WORK/art_$posture" "${EVAL[@]}" \
    --json_out "$OUT/eval_qat_artifact_$posture.json" 2>&1 | tee -a "$OUT/eval.log"
done
for posture in fp fold_bn w8a8_static w8a8_fused w8a8_fused_chain; do
  case $posture in
    fp) flags=() ;;
    fold_bn) flags=(--fold_bn) ;;
    *) flags=(--quantize "$posture") ;;
  esac
  timed "direct $posture" python -m cvm_tpu_torch.cli.evaluate --model centernet \
    --checkpoint_dir "$WORK/qat/best" "${EVAL[@]}" \
    --json_out "$OUT/eval_qat_direct_$posture.json" ${flags[@]+"${flags[@]}"} 2>&1 \
    | tee -a "$OUT/eval.log"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$OUT/card.txt"
