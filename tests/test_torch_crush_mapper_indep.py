"""The indep-family map shapes of tests/test_jax_mapper.py (positional
results with NONE holes, mixed firstn/indep EMIT blocks), the per-row result
lengths and the run-time weight-sets: the port's torch_mapper on a CPU map
against jax_mapper.map_rule and the scalar do_rule. Tolerance 0. The helpers
and the firstn-family shapes are in tests/test_torch_crush_mapper.py."""

import numpy as np
import pytest

from ceph_tpu.crush import builder as cb
from ceph_tpu.crush import jax_mapper as jm
from ceph_tpu.crush import mapper as cm
from ceph_tpu.crush.types import CRUSH_ITEM_NONE, BucketAlg, ChooseArg
from ceph_tpu_torch.crush import torch_mapper as tm
from tests.test_crush_mapper import build_two_level_map
from tests.test_torch_crush import to_port
from tests.test_torch_crush_mapper import (
    INDEP_CASES,
    N_X,
    _case,
    _choose_args_map,
    compare,
    port_map_rule,
)


@pytest.mark.parametrize("name", INDEP_CASES)
def test_map_rule_matches_jax_and_scalar(name):
    cmap, weight, result_max = _case(name)
    compare(cmap, 0, weight or [0x10000] * cmap.max_devices, result_max)


def test_return_lengths_and_chunks_match_jax():
    cmap, weight, result_max = _case("mixed-mode-multi-emit")
    xs = np.arange(N_X) * 7919
    got, lengths = port_map_rule(cmap, 0, xs, weight, result_max,
                                 return_lengths=True, chunk=100)
    want, want_lengths = jm.map_rule(jm.compile_map(cmap), 0, xs, weight,
                                     result_max, return_lengths=True)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(lengths, want_lengths)
    for i in range(0, N_X, 8):
        want_row = cm.do_rule(cmap, 0, int(xs[i]), weight, result_max, cm.Workspace())
        assert lengths[i] == len(want_row)
    # x is a uint32 in the reference: ids past 2^31 keep their bits
    big = np.array([2**31 + 5, 2**32 - 1], dtype=np.int64)
    got = port_map_rule(cmap, 0, big, weight, result_max)
    for row, x in zip(got, big):
        want_row = cm.do_rule(cmap, 0, int(x), weight, result_max, cm.Workspace())
        assert row[: len(want_row)].tolist() == want_row


def test_runtime_weights_match_compiled_choose_args_and_jax():
    """Weight-sets fed at run time equal the same weight-sets compiled in as
    choose_args, and the JAX package's runtime overlay."""
    with_args = _choose_args_map(31, 5)
    plain = build_two_level_map(BucketAlg.STRAW2, n_hosts=6, seed=31)
    cb.make_simple_rule(plain, 0, -1, 1, "firstn", 0)
    plain.choose_args[-1] = ChooseArg(ids=with_args.choose_args[-1].ids)
    sets = {bid: ca.weight_set for bid, ca in with_args.choose_args.items()}
    weight = [0x10000] * plain.max_devices
    xs = np.arange(N_X)

    compiled = tm.compile_map(to_port(plain), device="cpu")
    rt = tm.runtime_weight_arrays(compiled, sets)
    assert rt.shape == (2, compiled.items.shape[0])
    got = tm.map_rule(compiled, 0, xs, weight, 3, runtime_weights=rt)
    assert np.array_equal(got, port_map_rule(with_args, 0, xs, weight, 3))
    jcompiled = jm.compile_map(plain)
    want = jm.map_rule(jcompiled, 0, xs, weight, 3,
                       runtime_weights=jm.runtime_weight_arrays(jcompiled, sets))
    assert np.array_equal(got, np.asarray(want))
    for x in range(0, N_X, 8):
        assert [v for v in got[x] if v != CRUSH_ITEM_NONE] == cm.do_rule(
            with_args, 0, x, weight, 3, cm.Workspace())
