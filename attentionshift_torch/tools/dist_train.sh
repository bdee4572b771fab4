#!/usr/bin/env bash
# Multi-card training launcher for the PyTorch port (the twin of
# tools/dist_train.sh). torchrun starts one process per card and exports
# what attentionshift_torch/parallel/mesh.py::init_distributed reads:
# RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK.
#     GPUS=4 bash attentionshift_torch/tools/dist_train.sh CONFIG [args...]
# Several hosts: the same command on each, with NNODES, NODE_RANK and
# MASTER_ADDR (host 0) set; MASTER_PORT defaults to 29500.
set -euo pipefail

CONFIG=$1
shift

exec torchrun --nnodes="${NNODES:-1}" --node_rank="${NODE_RANK:-0}" \
    --nproc_per_node="${GPUS:-1}" --master_addr="${MASTER_ADDR:-127.0.0.1}" \
    --master_port="${MASTER_PORT:-29500}" \
    -m attentionshift_torch.tools.train "$CONFIG" "$@"
