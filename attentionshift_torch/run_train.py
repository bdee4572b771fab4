"""Canonical launcher: train the VOC config, then its aug-test evaluation.

    python -m attentionshift_torch.run_train [TRAIN ARGS ...]

The port's twin of ``run_train.py``: runs
``python -m attentionshift_torch.tools.train CFG --work-dir WORK [TRAIN
ARGS]``, then ``python -m attentionshift_torch.tools.test CFG
WORK/epoch_12 --aug-test --out WORK/eval.json``, each as a subprocess
that must succeed, each command printed first with ``+``; a ``--device``
among the train arguments is handed to the evaluation too. For more than
one card, launch the train command itself with ``torchrun
--nproc_per_node N``.
"""

from __future__ import annotations

import os
import subprocess
import sys

CFG = "configs/attnshift_voc12aug.py"
WORK = "work_dirs/attnshift_voc12aug"


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else list(argv)
    train = [sys.executable, "-m", "attentionshift_torch.tools.train", CFG,
             "--work-dir", WORK] + args
    print("+", " ".join(train), flush=True)
    subprocess.run(train, check=True)

    epoch = 12
    test = [sys.executable, "-m", "attentionshift_torch.tools.test", CFG,
            os.path.join(WORK, f"epoch_{epoch}"), "--aug-test",
            "--out", os.path.join(WORK, "eval.json")]
    if "--device" in args:  # the evaluation runs where the training ran
        test += ["--device", args[args.index("--device") + 1]]
    print("+", " ".join(test), flush=True)
    subprocess.run(test, check=True)


if __name__ == "__main__":
    main()
