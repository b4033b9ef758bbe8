"""``k2_roofline_pct``: K2 (``cvm_tpu_torch::fused_qconv``) against its
roofline in the traced stretch: the sum over its calls of each call's bound
(``reference/kernels.py::k2_bound_s``, from the call's recorded shapes and
dtypes) over the sum of the device time of the kernels the calls launched,
in %. None when the stretch holds no K2 call."""

import re

from cvbench.reference.kernels import k2_bound_s

OP = "cvm_tpu_torch::fused_qconv"
# element bytes by the names a trace gives dtypes and ScalarType arguments
_BYTES = (("bfloat16", 2), ("half", 2), ("float", 4), ("signed char", 1), ("int8", 1),
          ("char", 1))
_SCALAR = {"1": 1, "6": 4, "15": 2, "5": 2}          # torch ScalarType codes


def elem_bytes(name) -> int:
    s = str(name).lower().replace("c10::", "").replace("torch.", "")
    if s.strip() in _SCALAR:
        return _SCALAR[s.strip()]
    for key, n in _BYTES:
        if re.search(rf"\b{key}\b", s):
            return n
    raise ValueError(f"unknown dtype {name!r}")


def call_bound_s(args: dict) -> float:
    dims, types = args["Input Dims"], args["Input type"]
    concrete = args.get("Concrete Inputs") or [""] * len(dims)
    B, H, W, cin = dims[0]
    k, _, _, cout = dims[1]
    return k2_bound_s(B, H, W, cin, cout, k, elem_bytes(types[0]), elem_bytes(concrete[7]))


def read(ctx):
    if ctx.trace is None:
        return None
    calls = [op for op in ctx.trace.ops if op["name"] == OP]
    if not calls:
        return None
    bound = sum(call_bound_s(op["args"]) for op in calls)
    return 100.0 * bound / sum(op["device_s"] for op in calls)
