"""``python -m cvm_tpu_torch.models.semseg.inference ...``: the reference's
per-model entry point (``cvm_tpu/models/semseg/inference.py``), delegating
to ``cvm_tpu_torch.cli.infer`` with ``--model semseg``."""

import sys

from cvm_tpu_torch.cli.infer import main as _main


def main(argv=None):
    return _main(["--model", "semseg"] + list(argv if argv is not None else sys.argv[1:]))


if __name__ == "__main__":
    sys.exit(main())
