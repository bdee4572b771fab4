"""Per-step RPN losses of a ``learning_check`` run (fault 0, ROADMAP C0).

    python tests/fault0_rpn_trace.py --out F.jsonl [--from-step 450] -- \\
        --init-jax-key 0 --train-seed 2 --corpus lobes --det-eval ...

Runs ``attentionshift_torch.tools.analysis.learning_check.main`` on the
arguments after ``--`` as it is, with its train step wrapped: from step
``--from-step`` on, each step's ``loss_rpn_cls``, ``loss_rpn_bbox`` and
``loss_total`` (the train step's own metrics) are read and written to
``--out``, one JSON line per step. Reading a metric waits for the step;
it changes none of its values. Not collected by pytest (no ``test_``
prefix): a harness, not a test.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KEYS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_total")


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--from-step", type=int, default=450)
    args = ap.parse_args(argv[:split])

    import attentionshift_torch.train as train
    from attentionshift_torch.tools.analysis import learning_check

    make = train.make_train_step
    step = {"it": 0}

    def traced(model, *a, **kw):
        fn = make(model, *a, **kw)

        def run(state, batch, **kws):
            state, m = fn(state, batch, **kws)
            if step["it"] >= args.from_step:
                row = {"step": step["it"], **{k: float(m[k]) for k in KEYS}}
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            step["it"] += 1
            return state, m

        return run

    with mock.patch.object(train, "make_train_step", traced):
        return learning_check.main(argv[split + 1:])


if __name__ == "__main__":
    main()
