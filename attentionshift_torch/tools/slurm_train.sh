#!/usr/bin/env bash
# SLURM training launcher for the PyTorch port (the twin of
# tools/slurm_train.sh): one task per card, the rendezvous derived from
# SLURM's variables into what attentionshift_torch/parallel/mesh.py reads.
#     srun -N <hosts> --ntasks-per-node=<cards> --gpus-per-node=<cards> \
#         bash attentionshift_torch/tools/slurm_train.sh CONFIG [args...]
set -euo pipefail

CONFIG=$1
shift

export MASTER_ADDR="$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)"
export MASTER_PORT="${MASTER_PORT:-29500}"
export WORLD_SIZE="${SLURM_NTASKS}"
export RANK="${SLURM_PROCID}"
export LOCAL_RANK="${SLURM_LOCALID}"

exec python -m attentionshift_torch.tools.train "$CONFIG" "$@"
