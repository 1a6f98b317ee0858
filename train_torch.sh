#!/usr/bin/env bash
# Usage: bash ./train_torch.sh <degradation: BD|BI> <model: Model/ExpName> [start_iter]
# Train mode of the PyTorch/CUDA port (tecogan_tpu_torch), one process on
# one device; GPU_IDS=-1 runs on the CPU.
set -e

degradation=$1
model=$2
start_iter=${3:-0}

if [ -z "$degradation" ] || [ -z "$model" ]; then
  echo "Usage: bash ./train_torch.sh <BD|BI> <Model/ExpName> [start_iter]"
  exit 1
fi

exp_dir=./experiments_${degradation}/${model}

if [ "$start_iter" -eq 0 ] && [ -d "${exp_dir}/train" ]; then
  echo ">> Experiment dir exists: ${exp_dir}/train"
  echo ">> Please delete it, or pass a start_iter to resume"
  exit 1
fi

mkdir -p "${exp_dir}/train"

# optional code backup into the experiment dir (reference train.sh:35-38);
# enable with BACKUP_CODE=1
if [ "${BACKUP_CODE:-0}" != "0" ]; then
  suffix=""
  [ "$start_iter" -gt 0 ] && suffix="_iter${start_iter}"
  # refresh, don't nest: cp -r into an existing dir would copy the tree
  # inside it
  rm -rf "${exp_dir}/train/code_backup${suffix}"
  cp -r "$(dirname "$0")/tecogan_tpu_torch" \
    "${exp_dir}/train/code_backup${suffix}"
  echo ">> code tree backed up to ${exp_dir}/train/code_backup${suffix}"
fi

yml=train.yml
if [ "$start_iter" -gt 0 ]; then
  if [ -f "${exp_dir}/train_iter${start_iter}.yml" ]; then
    yml=train_iter${start_iter}.yml
  else
    # resuming relies on auto-resume from the latest state checkpoint
    # (state_iter{N}.pth); refuse a resume request that cannot be honoured
    if ! ls "${exp_dir}"/train/ckpt/state_iter*.pth >/dev/null 2>&1; then
      echo ">> start_iter=${start_iter} requested but no "
      echo ">> ${exp_dir}/train_iter${start_iter}.yml and no saved"
      echo ">> training state under ${exp_dir}/train/ckpt; refusing to"
      echo ">> restart from scratch over an existing experiment."
      exit 1
    fi
    echo ">> no train_iter${start_iter}.yml; auto-resuming from the"
    echo ">> latest state checkpoint under ${exp_dir}/train/ckpt"
  fi
fi

python -m tecogan_tpu_torch.main \
  --exp_dir "${exp_dir}" \
  --mode train \
  --opt "${exp_dir}/${yml}" \
  --gpu_ids "${GPU_IDS:-0}" \
  > "${exp_dir}/train/train.log" 2>&1 &
echo "training started: log at ${exp_dir}/train/train.log"
