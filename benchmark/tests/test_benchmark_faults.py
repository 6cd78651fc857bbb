"""The judge: a run of the harness on the CPU, at a small size, with the
timed path broken underneath, comes out not correct for each fault the
codec cells can have, and for the control; unbroken, it comes out correct.

The look for a card is the command's (run.py); these runs call the
harness below it, with the program's CPU codec (its kernels' plain
versions) or the control in its place. There is one chip a cell, so no
exchange between chips can be left out."""

import time

import pytest
import torch

import control
import harness

CELLS = [w["name"] for w in harness.load_json(
    f"{harness.ROOT}/BENCHMARK.json")["workloads"]]
SEED = 2**31 + 12345


def small(name):
    k = int(harness.load_cell(name).config["profile"]["k"])
    return {"object_bytes": 4 * 64 * k, "working_set_bytes": 4 * 4 * 64 * k}


def run(name, make_codec=None, seed=SEED):
    result = harness.run(name, seed, 0.2, False, torch.device("cpu"), time.perf_counter(),
                         make_codec=make_codec, override=small(name))
    assert "error" not in result
    return result


def program(plugin, profile, device):
    from ceph_tpu_torch.ec.registry import factory

    return factory(plugin, dict(profile), device=device)


class Faulty:
    """The program's codec with one fault where its outputs are produced."""

    def __init__(self, fault, plugin, profile, device):
        self.codec = program(plugin, profile, device)
        self.fault = fault
        self.get_chunk_size = self.codec.get_chunk_size

    def encode_words(self, words):
        return self.fault(self.codec.encode_words, (words,), words, self.codec.m, planar=True)

    def decode_words(self, present, targets, words):
        return self.fault(lambda w: self.codec.decode_words(present, targets, w), (words,),
                          words, len(targets), planar=True)

    def encode_array(self, data):
        return self.fault(self.codec.encode_array, (data,), data, self.codec.m, planar=False)

    def decode_array(self, present, targets, survivors):
        return self.fault(lambda s: self.codec.decode_array(present, targets, s),
                          (survivors,), survivors, len(targets), planar=False)


def unchanged(fn, args, data, rows, planar):
    """The step returns its state unchanged: the input rows, not computed."""
    return (data[:rows] if planar else data[:, :rows]).clone()


def half_batch(fn, args, data, rows, planar):
    """Half of the batch left out: only the first half of every chunk row
    (a call codes one object) computed, the rest left zero."""
    half = data.shape[-1] // 2
    out = torch.zeros((*data.shape[:-2], rows, data.shape[-1]), dtype=data.dtype)
    out[..., :half] = fn(data[..., :half].contiguous())
    return out


def altered(fn, args, data, rows, planar):
    """One answer altered where it is produced: a bit of one byte flipped."""
    out = fn(*args)
    out.view(torch.uint8).view(-1)[7] ^= 4
    return out


@pytest.mark.parametrize("name", CELLS)
def test_the_program_comes_out_correct(name):
    result = run(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 4
    assert all(c["value"] == 0 and c["limit"] == 0 for c in result["checks"].values())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(name):
    result = run(name, control.ControlCodec)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["encode_bad_bytes"]["value"] + checks["decode_bad_bytes"]["value"] > 0
    assert checks["reference_bad_bytes"]["value"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_comes_out_not_correct(name, fault):
    result = run(name, lambda plugin, profile, device: Faulty(fault, plugin, profile, device))
    assert not result["correct"], (fault.__name__, result["checks"])
    assert result["failed"] > 0
    assert result["checks"]["reference_bad_bytes"]["value"] == 0


def test_seeds_give_the_same_work_in_another_order():
    a = harness.load_module(f"{harness.BENCH_DIR}/runners/ec_codec.py", "run_seed")
    spec = harness.load_cell(CELLS[0])
    config = {**spec.config, **{"object_bytes": small(CELLS[0])["object_bytes"]}}
    traffic = {**spec.traffic, "working_set_bytes": 8 * config["object_bytes"],
               "order": ["encode", "decode"], "lost_counts": [1, 2]}
    one = a.Cell(config, traffic, 1, torch.device("cpu"))
    two = a.Cell(config, traffic, 2**40 + 3, torch.device("cpu"))
    assert [j.hbm_bytes for j in one.jobs] == [j.hbm_bytes for j in two.jobs]
    assert [j.user_bytes for j in one.jobs] == [j.user_bytes for j in two.jobs]
    assert [len(j.inputs.get("targets", ())) for j in one.jobs] == \
        [len(j.inputs.get("targets", ())) for j in two.jobs]
    assert not torch.equal(one.jobs[0].inputs["data"], two.jobs[0].inputs["data"])
    again = a.Cell(config, traffic, 1, torch.device("cpu"))
    assert torch.equal(one.jobs[0].inputs["data"], again.jobs[0].inputs["data"])
    assert one.jobs[1].inputs["targets"] == again.jobs[1].inputs["targets"]
