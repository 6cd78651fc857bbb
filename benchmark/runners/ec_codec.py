"""Runner of erasure-codec cells: objects held on the card, coded one call
at a time.

A cell is a codec profile (its configuration file) under a traffic mix
(its traffic file). The traffic names the codec entry that the window
drives:

  * `planar`: `encode_words` / `decode_words`, chunk j of every object of
    a call packed end to end in row j of a (k, N/4) int32 tensor;
  * `bytes`: `encode_array` / `decode_array` on (objects, k, L) uint8;

how many objects a call codes (`objects_per_call`), the operations in
turn (`order`: "encode", "decode"), the chunks a decode has lost
(`lost_counts`), and the bytes of objects held on the card
(`working_set_bytes`). The window cycles through as many distinct jobs as
fill the working set: job i is `order[i % len(order)]`, and the d-th
decode job lost `lost_counts[d % len(lost_counts)]` chunks, which ones
drawn from the seed among all k + m, as `ceph_erasure_code_benchmark
--erasures` draws them. Every input is made at set-up from the seed on
the device in one random call: an encode job's data chunks; a decode
job's codeword (data from the seed, parity from the reference), whose
first k surviving chunks are staged contiguously, so the window runs no
gather of the benchmark's own.

`judge` holds the outputs that the window kept against the reference: an
encode's parity against the reference's encode of the same data, a
decode's rebuilt chunks against the reference's decode of the same
survivors, and the reference's decode against the codeword's own chunks.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable

import torch

import reference
import yardstick


@dataclass
class Job:
    """One distinct call of the window."""

    name: str
    call: Callable[[], torch.Tensor]
    #: object bytes the call encodes or reads back degraded
    user_bytes: int
    #: least HBM bytes the call moves (`yardstick.gf_hbm_bytes`)
    hbm_bytes: int
    #: what judge() compares the output with, filled at set-up
    inputs: dict = field(default_factory=dict)


def program_codec(plugin: str, profile: dict, device: torch.device):
    """The codec under test, built by the program's plugin registry."""
    from ceph_tpu_torch.ec.registry import factory

    return factory(plugin, dict(profile), device=device)


def lost_counts(traffic: dict, m: int) -> list[int]:
    """The decode jobs' lost-chunk counts, each in 1..m."""
    counts = [int(c) for c in traffic.get("lost_counts", [1])]
    if not counts or any(not 1 <= c <= m for c in counts):
        raise ValueError(f"lost_counts {counts} outside 1..{m}")
    return counts


class Cell:
    """The jobs of one cell, their inputs, and the judge of their outputs."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 make_codec: Callable = program_codec):
        if traffic.get("in_flight", 1) != 1:
            raise ValueError("this runner keeps one call in flight")
        self.api = traffic["api"]
        if self.api not in ("planar", "bytes"):
            raise ValueError(f"unknown api {self.api!r}")
        order = traffic["order"]
        if not order or any(kind not in ("encode", "decode") for kind in order):
            raise ValueError(f"order {order!r} is not a list of 'encode' and 'decode'")
        self.ref = reference.Codec(config["plugin"], config["profile"])
        k, m = self.ref.k, self.ref.m
        self.k, self.m = k, m
        object_bytes = int(config["object_bytes"])
        if object_bytes % (4 * k):
            raise ValueError(f"object_bytes {object_bytes} is not k={k} rows of words")
        self.objects = int(traffic["objects_per_call"])
        self.chunk = object_bytes // k
        self.device = device
        self.codec = make_codec(config["plugin"], config["profile"], device)
        # the program's own cut of an object must be the harness's (the
        # control, which is no plugin, has none)
        cut = getattr(self.codec, "get_chunk_size", None)
        if cut is not None and cut(object_bytes) != self.chunk:
            raise ValueError(f"the codec cuts {object_bytes} B objects into chunks "
                             f"of {cut(object_bytes)} B, not {self.chunk}")
        call_bytes = self.objects * object_bytes
        n_jobs = max(len(order), -(-int(traffic["working_set_bytes"]) // call_bytes))
        counts = lost_counts(traffic, m)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed % (1 << 64))
        pick = random.Random(seed)
        # every job's data chunks in one call; a decode job's parity from the
        # reference, all decode jobs in one call
        data = self._random(n_jobs, k, gen)
        kinds = [order[i % len(order)] for i in range(n_jobs)]
        decodes = [i for i, kind in enumerate(kinds) if kind == "decode"]
        parity = self.ref.encode(data[decodes]) if decodes else None
        row_bytes = self.objects * self.chunk
        self.jobs: list[Job] = []
        for i, kind in enumerate(kinds):
            if kind == "encode":
                self.jobs.append(Job(
                    f"encode.{i}", self._encode_call(data[i]), call_bytes,
                    yardstick.gf_hbm_bytes(k, m, row_bytes), {"data": data[i]}))
                continue
            d = decodes.index(i)
            lost = counts[d % len(counts)]
            targets = sorted(pick.sample(range(k + m), lost))
            present = [c for c in range(k + m) if c not in targets][:k]
            codeword = torch.cat([data[i], parity[d]], dim=-2)
            survivors = codeword[..., present, :].contiguous()
            originals = codeword[..., targets, :].contiguous()
            self.jobs.append(Job(
                f"decode.lost{lost}.{i}", self._decode_call(present, targets, survivors),
                call_bytes, yardstick.gf_hbm_bytes(k, lost, row_bytes),
                {"present": present, "targets": targets, "survivors": survivors,
                 "originals": originals}))
        del parity

    def _random(self, jobs: int, rows: int, gen: torch.Generator) -> torch.Tensor:
        """`rows` chunk rows of random bytes for each of `jobs` calls: each
        job's (rows, N) for the planar API, (objects, rows, L) for the byte
        API, contiguous."""
        shape = ((jobs, rows, self.objects * self.chunk) if self.api == "planar"
                 else (jobs, self.objects, rows, self.chunk))
        return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                             device=self.device)

    def _encode_call(self, data: torch.Tensor) -> Callable[[], torch.Tensor]:
        codec = self.codec
        if self.api == "planar":
            words = data.view(torch.int32)
            return lambda: codec.encode_words(words)
        return lambda: codec.encode_array(data)

    def _decode_call(self, present, targets, survivors) -> Callable[[], torch.Tensor]:
        codec = self.codec
        if self.api == "planar":
            words = survivors.view(torch.int32)
            return lambda: codec.decode_words(present, targets, words)
        return lambda: codec.decode_array(present, targets, survivors)

    def release(self) -> None:
        """Drop the program's state: the codec and, with it, its tables."""
        self.codec = None
        for job in self.jobs:
            job.call = None

    def _as_bytes(self, out: torch.Tensor) -> torch.Tensor:
        if out.dtype == torch.uint8:
            return out
        return out.contiguous().view(torch.uint8)

    def judge(self, held: dict[int, list[torch.Tensor]]) -> tuple[dict, int, int]:
        """({check: (value, limit)}, outputs judged, outputs found wrong) for
        the distinct outputs that the window kept, job by job. Every check
        is exact: its limit is 0."""
        checks = {"encode_bad_bytes": 0, "decode_bad_bytes": 0,
                  "reference_bad_bytes": 0,
                  "jobs_unjudged": sum(1 for i in range(len(self.jobs)) if not held.get(i))}
        judged = wrong = 0
        for index, outs in held.items():
            job = self.jobs[index]
            if "data" in job.inputs:
                key = "encode_bad_bytes"
                want = self.ref.encode(job.inputs["data"])
            else:
                key = "decode_bad_bytes"
                want = self.ref.decode(job.inputs["present"], job.inputs["targets"],
                                       job.inputs["survivors"])
                checks["reference_bad_bytes"] += int(
                    (want != job.inputs["originals"]).sum())
            for out in outs:
                got = self._as_bytes(out)
                n = (int((got != want).sum()) if got.shape == want.shape
                     else want.numel())
                checks[key] += n
                judged += 1
                wrong += n > 0
            del want
        return {name: (value, 0) for name, value in checks.items()}, judged, wrong
