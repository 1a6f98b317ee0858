#!/usr/bin/env bash
# Usage: bash ./test_torch.sh <degradation: BD|BI> <model: Model/ExpName>
# Test mode of the PyTorch/CUDA port (tecogan_tpu_torch); GPU_IDS=-1 runs
# on the CPU.
set -e

degradation=$1
model=$2

if [ -z "$degradation" ] || [ -z "$model" ]; then
  echo "Usage: bash ./test_torch.sh <BD|BI> <Model/ExpName>"
  exit 1
fi

exp_dir=./experiments_${degradation}/${model}

python -m tecogan_tpu_torch.main \
  --exp_dir "${exp_dir}" \
  --mode test \
  --opt "${exp_dir}/test.yml" \
  --gpu_ids "${GPU_IDS:-0}"
