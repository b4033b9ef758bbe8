"""The control of a cell's check, read on the card (not run by the
benchmark's runs):

    python -m cvbench.control --workload <cell> --seeds 1,2,3

For each seed: the cell's weights and frames as a run of that seed makes
them, answered by the plain reference computed a precision below the
configuration's (the mix's ``check.control``: fp8 e4m3 below bfloat16,
int4 below int8; ``reference/lowprec.py``), and judged by the cell's own
comparison against the float32 reference. Prints one JSON line per seed
with every compared number beside the cell's limit. A sound limit lies
between the program's readings and these.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile


def readings(spec: dict, seed: int, device, precision: str, n_frames: int, fault=None) -> dict:
    """The cell's compared numbers with the control in the program's place."""
    from cvbench import program
    from cvbench.reference.lowprec import control_quant

    cfg, mix = program.cell_config(spec["config"], spec["mix"]), spec["mix"]
    check = importlib.import_module(
        f"cvbench.checks.{mix.get('check', {}).get('module', cfg['model'])}")
    _, model, weights = program.build(cfg, seed, device)
    del model
    rc = program.ref_cfg(cfg)
    quant = control_quant(precision)
    if hasattr(quant, "calibrate"):          # a static posture: its scales first
        quant.calibrate(weights, rc, device, tuple(mix["buffer_hw"]))
    with tempfile.TemporaryDirectory(prefix="cvbench-") as tmp:
        kw = {} if fault is None else {"fault": fault}
        samples = check.control(rc, mix, seed, weights, device, quant, tmp, n_frames, **kw)
        return check.compare(samples, weights, rc, device)


def main(argv=None) -> int:
    from cvbench import run

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.add_argument("--precision", default=None,
                   help="the reference's precision in place of the mix's control (e.g. "
                        "int8_static: the reference's own int8 in an export's calibrated "
                        "posture, a witness for the program's int8 errors)")
    p.add_argument("--fault", default=None, choices=["half_batch"],
                   help="in place of the control, the float32 reference with this fault "
                        "planted (a training cell's upper readings)")
    args = p.parse_args(argv)
    spec = run.cell_spec(args.workload, run.manifest())
    import torch

    precision = args.precision or spec["mix"]["check"]["control"]
    for seed in (int(s) for s in args.seeds.split(",")):
        vals = readings(spec, seed, torch.device(args.device), precision, args.frames, args.fault)
        print(json.dumps({"seed": seed, "control": precision, "fault": args.fault, **{k: {"value": v, "limit": spec["limits"].get(k)}
                                                         for k, v in vals.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
