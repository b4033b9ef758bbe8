"""Verify an exported artifact: ``python -m cvm_tpu_torch.cli.serve
--artifact ART --selftest [--device cuda]``.

Mirrors ``cvm_tpu/cli/serve.py::main`` in part: ``--selftest`` loads the
artifact as a server would (``infer/runtime.py::ServingModel``), runs it on
the inputs of its export-time fingerprint and exits 3 when the outputs have
drifted from it (a weights file from another run, a tampered or truncated
copy), 0 when they match. Serving images (``--images``), records
(``--records``) and the HTTP daemon (``--http``) are not ported yet: each
starts from the reference's JPEG decoder, and they wait with the record
data path (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--artifact", required=True, help="cli.export output directory")
    parser.add_argument("--selftest", action="store_true",
                        help="verify the artifact against its export-time fingerprint "
                             "(exit 3 on mismatch)")
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    parser.add_argument("--images", default=None, help="glob of image files (not ported yet)")
    parser.add_argument("--records", default=None, help=".cvrec glob (not ported yet)")
    parser.add_argument("--http", default=None, metavar="HOST:PORT",
                        help="serve over HTTP (not ported yet)")
    args = parser.parse_args(argv)
    for flag in ("images", "records", "http"):
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not ported yet (ROADMAP Queue 1 item 11)")
    if not args.selftest:
        parser.error("nothing to do: --selftest is the only ported mode")

    from cvm_tpu_torch.infer.runtime import ServingModel

    problems = ServingModel(args.artifact, device=args.device).selftest()
    if problems:
        for p in problems:
            print(f"[selftest] MISMATCH: {p}", file=sys.stderr)
        return 3
    print("[selftest] artifact verified against its export fingerprint", file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
