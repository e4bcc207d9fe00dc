#!/usr/bin/env bash
# Data-parallel training, one process a card, started by torchrun:
#   ioudet_torch/tools/dist_train.sh CONFIG GPUS [train.py options]
# (the PyTorch counterpart of tools/dist_train.sh).
CONFIG=$1
GPUS=$2
shift 2
PORT=${PORT:-29500}
exec torchrun --nproc_per_node="$GPUS" --master_port="$PORT" \
    -m ioudet_torch.tools.train "$CONFIG" "$@"
