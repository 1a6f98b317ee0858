#!/usr/bin/env bash
# Usage: bash ./profile_torch.sh <degradation: BD|BI> <model: Model/ExpName> <CxHxW>
# Profile mode of the PyTorch/CUDA port (tecogan_tpu_torch); GPU_IDS=-1
# runs on the CPU.
set -e

degradation=$1
model=$2
lr_size=${3:-3x134x320}

if [ -z "$degradation" ] || [ -z "$model" ]; then
  echo "Usage: bash ./profile_torch.sh <BD|BI> <Model/ExpName> <CxHxW>"
  exit 1
fi

exp_dir=./experiments_${degradation}/${model}

python -m tecogan_tpu_torch.main \
  --exp_dir "${exp_dir}" \
  --mode profile \
  --opt "${exp_dir}/train.yml" \
  --gpu_ids "${GPU_IDS:-0}" \
  --lr_size "${lr_size}" \
  --test_speed
