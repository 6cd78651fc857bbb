"""Bytes counted from shapes: the least HBM traffic of every job of both
APIs and every lost count, and the object bytes each batch counts."""

import pytest
import torch

import harness
import yardstick


def test_gf_hbm_bytes_reads_k_rows_and_writes_r():
    assert yardstick.gf_hbm_bytes(8, 3, 1000) == 11000
    assert yardstick.gf_hbm_bytes(4, 1, 7) == 35


@pytest.mark.parametrize("api", ["planar", "bytes"])
@pytest.mark.parametrize("config_name", ["isa_k8m3", "jerasure_k4m2"])
def test_every_job_counts_its_shapes(config_name, api):
    spec = harness.load_cell(next(w for w in harness.load_json(
        f"{harness.ROOT}/BENCHMARK.json")["workloads"] if w["config"] == config_name)["name"])
    config = dict(spec.config)
    config["object_bytes"] = 4 * 64 * int(config["profile"]["k"])
    m = int(config["profile"]["m"])
    # 3 objects a call, encode and decode in turns, every lost count 1..m
    traffic = {"runner": "ec_codec", "api": api, "objects_per_call": 3, "in_flight": 1,
               "order": ["encode", "decode"], "lost_counts": list(range(1, m + 1)),
               "working_set_bytes": 2 * m * 3 * config["object_bytes"]}
    runner = harness.load_module(f"{harness.BENCH_DIR}/runners/ec_codec.py", "run_bytes")
    cell = runner.Cell(config, traffic, 11, torch.device("cpu"))
    k = cell.k
    row = 3 * config["object_bytes"] // k
    kinds = [job.name for job in cell.jobs]
    assert len(cell.jobs) == 2 * m, kinds
    for i, job in enumerate(cell.jobs):
        assert job.user_bytes == 3 * config["object_bytes"]
        if i % 2 == 0:
            assert job.name.startswith("encode")
            assert job.hbm_bytes == (k + m) * row
        else:
            lost = i // 2 + 1
            assert job.name.startswith(f"decode.lost{lost}.")
            assert len(job.inputs["targets"]) == lost
            assert job.hbm_bytes == (k + lost) * row
            shape = (k, 3 * config["object_bytes"] // k) if api == "planar" \
                else (3, k, config["object_bytes"] // k)
            assert tuple(job.inputs["survivors"].shape) == shape
            assert job.inputs["survivors"].is_contiguous()


def test_the_working_set_sets_the_distinct_jobs():
    spec = harness.load_cell("isa_k8m3.planar_encode")
    config = {**spec.config, "object_bytes": 4 * 64 * 8}
    runner = harness.load_module(f"{harness.BENCH_DIR}/runners/ec_codec.py", "run_ws")
    cell = runner.Cell(config, {**spec.traffic, "working_set_bytes": 5 * 4 * 64 * 8},
                       3, torch.device("cpu"))
    assert len(cell.jobs) == 5
    assert len({job.inputs["data"].data_ptr() for job in cell.jobs}) == 5
