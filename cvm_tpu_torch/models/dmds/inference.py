"""``python -m cvm_tpu_torch.models.dmds.inference ...``: the reference's
per-model entry point (``cvm_tpu/models/dmds/inference.py``), which
delegates to ``cli.infer``; that CLI (decoding image and video files) is
not ported yet, so this exits with its ROADMAP item."""

import sys


def main(argv=None):
    raise SystemExit("cvm_tpu_torch.models.dmds.inference: cli.infer is not ported yet "
                     "(ROADMAP Queue 1 item 11); serve two-frame batches through "
                     "cvm_tpu_torch.infer.pipeline.InferencePipeline")


if __name__ == "__main__":
    sys.exit(main())
