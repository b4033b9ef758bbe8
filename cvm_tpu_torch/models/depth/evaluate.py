"""``python -m cvm_tpu_torch.models.depth.evaluate ...``: the reference's
per-model entry point (``cvm_tpu/models/depth/evaluate.py``), delegating
to ``cvm_tpu_torch.cli.evaluate`` with ``--model depth``."""

import sys

from cvm_tpu_torch.cli.evaluate import main as _main


def main(argv=None):
    return _main(["--model", "depth"] + list(argv if argv is not None else sys.argv[1:]))


if __name__ == "__main__":
    sys.exit(main())
