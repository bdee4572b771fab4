#!/usr/bin/env bash
# Multi-card evaluation launcher for the PyTorch port (the twin of
# tools/dist_test.sh). torchrun starts one process per card and exports
# what attentionshift_torch/parallel/mesh.py::init_distributed reads:
# RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK.
#     GPUS=4 bash attentionshift_torch/tools/dist_test.sh CONFIG CHECKPOINT \
#         --gather-dir /shared/tmp [args...]
# Each rank evaluates its stride of the dataset; rank 0 merges the
# predictions through --gather-dir and prints the metric.
set -euo pipefail

CONFIG=$1
CHECKPOINT=$2
shift 2

exec torchrun --nnodes="${NNODES:-1}" --node_rank="${NODE_RANK:-0}" \
    --nproc_per_node="${GPUS:-1}" --master_addr="${MASTER_ADDR:-127.0.0.1}" \
    --master_port="${MASTER_PORT:-29500}" \
    -m attentionshift_torch.tools.test "$CONFIG" "$CHECKPOINT" "$@"
