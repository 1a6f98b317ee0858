#!/usr/bin/env bash
# One card call of the campaign's full 4x BD schedule through the port's
# CLI at the shipped defaults: FRVSR 40000 iterations, then TecoGAN 15000
# warm-started from its G_iter40000.npz, then the eval (see README.md).
#
#   bash docs/campaign_torch/run_full.sh {frvsr|tecogan} STOP[,STOP...] OUT_DIR [BUDGET_S]
#
# The workdir build/campaign_h100_full holds what the previous call carried
# (its logs, ymls, validation JSON and state_iter{N}.pth; for tecogan also
# FRVSR's G_iter40000.npz); the corpus is remade from the seed. The half's
# training CLI resumes from the state and is stopped by horizon.py stop_at
# once G_iter{STOP} is validated (STOP 0: run to the end), or at an earlier
# validated checkpoint when the call's BUDGET_S (default 3000) would not hold
# one more validation interval; with several STOPs the CLI resumes in the
# same call after each but the last (a resume without a new machine). Only
# the save cadence is set: a checkpoint at every validation (FRVSR 5000,
# TecoGAN 2500), as the JAX run validated. The
# call ends with horizon.py carry into OUT_DIR: the newest state (none once
# the half is done) and every G_iter{N}.npz of the half but the one the state
# holds (horizon.py restore remakes it). The call that ends TecoGAN also
# runs the eval of both models (EVAL_AT_STOP=1: also a call that stops it
# early, at its last checkpoint). SCORE_ON_CARD=1 scores every checkpoint of
# the half under the scorer on the card (horizon.py score_points) and
# carries the readings instead of the checkpoints.
set -euo pipefail
half=$1
stop=$2
out=$3
budget=${4:-3000}
wd=build/campaign_h100_full
horizon="python3 docs/campaign_torch/horizon.py"
campaign="python3 -m tecogan_tpu_torch.tools.run_synth_campaign"
case $half in
  frvsr) every=5000; total=40000; run=FRVSR ;;
  tecogan) every=2500; total=15000; run=TecoGAN ;;
  *) echo "unknown half $half" >&2; exit 2 ;;
esac
mkdir -p "$out"
{
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  python3 -c 'import sys, torch, cv2; print("python", sys.version.split()[0],
"torch", torch.__version__, "CUDA", torch.version.cuda, "cv2", cv2.__version__)'
} | tee "$out/card.txt"
start=$(date +%s)
$campaign data --workdir "$wd"
# the eval's share of the last TecoGAN call, carry's of every call
reserve=$([ "$half" = tecogan ] && echo 360 || echo 120)
rc=0
for n in ${stop//,/ }; do
  # each stop_at after the first resumes from the state the one before left
  left=$((budget - reserve - $(date +%s) + start))
  $horizon stop_at "$n" --ckpt_freq "$every" --budget "$left" -- "$half" \
    --workdir "$wd" || { rc=$?; break; }
done
trained=$(date +%s)
exp=$wd/${run}_Synth_4xSR
last=$(ls "$exp/train/ckpt" | sed -n 's/^G_iter\([0-9]*\)\.npz$/\1/p' | sort -n | tail -1)
state=(--state "$run")
if [ "$last" = "$total" ]; then
  state=(--state none)
fi
if [ "$half" = tecogan ] && { [ "$last" = "$total" ] || [ "${EVAL_AT_STOP:-0}" = 1 ]; }; then
  $campaign eval --workdir "$wd" --tecogan_iter "$last" || rc=$?
fi
done_s=$(date +%s)
ckpts=(--ckpts "$run")
if [ "${SCORE_ON_CARD:-0}" = 1 ]; then
  # the scorer's reading of every checkpoint of the half, here instead of
  # carrying the checkpoints (OUT_DIR's 64 MiB hold the state and few more)
  $horizon score_points "$wd" "$exp/train/ckpt" "$out/${half}_scores.json" \
    --device cuda || rc=$?
  ckpts=()
fi
scored=$(date +%s)
{ $horizon ms "$exp/train.log" "$every" || true; } | tee -a "$out/card.txt"
echo "seconds: data and training $((trained - start)), eval $((done_s - trained)), scoring $((scored - done_s)); last G_iter$last" \
  | tee -a "$out/card.txt"
$horizon carry "$wd" "$out" "${state[@]}" "${ckpts[@]}"
du -sh "$out"
exit $rc
