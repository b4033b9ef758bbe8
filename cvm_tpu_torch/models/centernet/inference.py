"""``python -m cvm_tpu_torch.models.centernet.inference ...``: the reference's
per-model entry point (``cvm_tpu/models/centernet/inference.py``), delegating
to ``cvm_tpu_torch.cli.infer`` with ``--model centernet``."""

import sys

from cvm_tpu_torch.cli.infer import main as _main


def main(argv=None):
    return _main(["--model", "centernet"] + list(argv if argv is not None else sys.argv[1:]))


if __name__ == "__main__":
    sys.exit(main())
