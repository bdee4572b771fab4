"""Weight-only export of a training checkpoint: the port's twin of
``tools/publish_model.py``.

    python -m attentionshift_torch.tools.publish_model work_dirs/voc/epoch_12 out/voc_final

Reads a ``train.save_checkpoint`` file and writes its parameters and
buffers alone with ``train.save_params`` (no optimizer state, no
counters), which ``train.restore_params`` and ``tools.test`` read. It
handles the port's format only: the JAX tool reads orbax checkpoints,
and orbax is not part of the port's environment. An orbax checkpoint of
the JAX package is converted where JAX runs (README: ``restore_params``
-> ``convert.load_flax`` -> ``save_params``).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Strip a training checkpoint to its weights.")
    p.add_argument("checkpoint")
    p.add_argument("out")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Run the tool on ``argv``; returns the path it wrote."""
    from ..train.checkpoint import restore_params, save_params

    args = parse_args(argv)
    path = save_params(args.out, restore_params(args.checkpoint))
    print(f"published weights-only checkpoint to {path}")
    return path


if __name__ == "__main__":
    main()
