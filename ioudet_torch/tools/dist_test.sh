#!/usr/bin/env bash
# Data-parallel evaluation, one process a card, started by torchrun:
#   ioudet_torch/tools/dist_test.sh CONFIG CHECKPOINT GPUS [test.py options]
# (the PyTorch counterpart of tools/dist_test.sh).
CONFIG=$1
CHECKPOINT=$2
GPUS=$3
shift 3
PORT=${PORT:-29500}
exec torchrun --nproc_per_node="$GPUS" --master_port="$PORT" \
    -m ioudet_torch.tools.test "$CONFIG" "$CHECKPOINT" "$@"
