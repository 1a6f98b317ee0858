#!/usr/bin/env bash
# One FRVSR leg of the synthetic campaign on the card, end to end: the
# corpus, training through the port's CLI, the leg's checkpoint scored by
# the validation in fp32 and under horizon.py's TpuDefaultPrecision, and
# what the next steps need copied to OUT_DIR (see README.md).
#
#   bash docs/campaign_torch/run_leg.sh {bf16|fp32|bi|2x|bi_tpu_lr} OUT_DIR
#
# bf16, fp32: the training-precision twin, 4000 iterations of its own
# recipe (validation every 500). bi, 2x: the 40000-iteration recipe (its
# learning rate constant until 16000), stopped once G_iter5000 is
# validated, with checkpoints every 5000. bi_tpu_lr: bi with its LR frames
# made under horizon.py's TpuDefaultPrecision, as the JAX run's were.
set -euo pipefail
leg=$1
out=$2
wd=build/campaign_h100_$leg
horizon="python3 docs/campaign_torch/horizon.py"
campaign="python3 -m tecogan_tpu_torch.tools.run_synth_campaign"
case $leg in
  bf16) args=(--frvsr_iter 4000); n=4000; val=500; score=() ;;
  fp32) args=(--precision fp32 --frvsr_iter 4000); n=4000; val=500
        score=() ;;
  bi) args=(--degradation BI); n=5000; val=5000
      score=(--degradation BI) ;;
  2x) args=(--scale 2); n=5000; val=5000; score=(--scale 2) ;;
  bi_tpu_lr) args=(--degradation BI); n=5000; val=5000
             score=(--degradation BI) ;;
  *) echo "unknown leg $leg" >&2; exit 2 ;;
esac
mkdir -p "$out"
{
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  python3 -c 'import sys, torch, cv2; print("python", sys.version.split()[0],
"torch", torch.__version__, "CUDA", torch.version.cuda, "cv2", cv2.__version__)'
} | tee "$out/card.txt"
start=$(date +%s)
if [ "$leg" = bi_tpu_lr ]; then
  $horizon tpu_default_data -- data --workdir "$wd" "${args[@]}"
else
  $campaign data --workdir "$wd" "${args[@]}"
fi
if [ "$n" = 4000 ]; then
  $campaign frvsr --workdir "$wd" "${args[@]}"
else
  $horizon stop_at "$n" --ckpt_freq "$n" -- frvsr --workdir "$wd" "${args[@]}"
fi
trained=$(date +%s)
exp=$(ls -d "$wd"/FRVSR_Synth_*)
$horizon score "$wd" "$exp/train/ckpt/G_iter$n.npz" "$out/score.json" \
  "${score[@]}" > "$out/score.log" 2>&1 || { tail -40 "$out/score.log"; exit 1; }
scored=$(date +%s)
$horizon ms "$exp/train.log" "$val" | tee -a "$out/card.txt"
echo "seconds: data and training $((trained - start)), scoring $((scored - trained))" \
  | tee -a "$out/card.txt"
$horizon carry "$wd" "$out" --state none
cp "$exp/train/ckpt/G_iter$n.npz" "$out/"
python3 -c 'import json, sys; d = json.load(open(sys.argv[1]))
print({k: d[k] for k in ("fp32", "tpu_default", "seconds")})' "$out/score.json"
