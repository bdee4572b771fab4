"""Print the resolved config: the port's twin of ``tools/misc/print_config.py``.

    python -m attentionshift_torch.tools.misc.print_config configs/attnshift_voc12aug.py \\
        [--cfg-options model.max_gt=10]

Resolves ``_base_`` inheritance with the port's ``config.Config``, applies
the ``--cfg-options`` dotted overrides and prints the final dict as JSON.
"""

from __future__ import annotations

import argparse
import json

from ...config import Config


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Print a resolved config.")
    ap.add_argument("config")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool on ``argv``; returns the dict it printed."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options).to_dict()
    print(json.dumps(cfg, indent=2, default=repr))
    return cfg


if __name__ == "__main__":
    main()
