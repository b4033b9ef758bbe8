"""The benchmark's own tests: ``python -m pytest cvbench/tests``. Tests that
need a CUDA card carry the ``cuda`` marker and take the ``cuda_device``
fixture, which skips them without one (decided when the test runs, never at
import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# Cells whose runner, mix, check and limits are here but which BENCHMARK.json
# does not list yet (PERF.md, Open questions): their entries as a later
# manifest would add them, so that the tests keep their paths sound.
UNLISTED = [
    {"name": "centernet_b.train_records", "config": "centernet_b", "traffic": "records_coco",
     "chips": 1, "why": "training from a .cvrec shard of COCO-sized JPEGs, batch 8, from the seeded "
                        "init: RecordLoader, jitter, K1 heatmaps, bf16 forward and backward, AdamW"},
    {"name": "centernet_b.serve_int8", "config": "centernet_b", "traffic": "poisson_camera",
     "chips": 1, "why": "single COCO-sized YUV420 frames, Poisson at 100/s, into DynamicBatcher "
                        "(buckets 1/4/8, 5 ms) over the w8a8_fused_chain export: K2 and the batcher"},
]


@pytest.fixture
def cell_spec():
    """``cell_spec(name)``: the cell as ``run.cell_spec`` reads it, listed or
    not."""
    from cvbench import run

    bench = run.manifest()
    listed = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    bench = dict(bench, workloads=bench["workloads"] + [w for w in UNLISTED
                                                         if w["name"] not in listed],
                 configs=bench["configs"] + [
                     {"name": n, "file": f"cvbench/configs/{n}.json"}
                     for n in sorted({w["config"] for w in UNLISTED} - configs)])
    return lambda name: run.cell_spec(name, bench)
