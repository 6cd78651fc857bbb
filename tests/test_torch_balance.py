"""The port's upmap balancer (ceph_tpu_torch/crush/balance.py) against the
JAX package's (ceph_tpu/crush/balance.py), on the CPU, tolerance 0.

* the move scorer: `score_chunk_plain` equals the jitted `_score_chunk` on
  the cases of tests/test_torch_upmap_cuda.py (random rows, massive gain
  ties, all-illegal rows, NONE slots, unreachable domains, 11-wide rows, a
  10,000-OSD cluster, float32 rounding ties between slots at S = 3, 4, 6
  and 11), gains compared as float32 bits;
* the kernel's procedure, emulated in numpy (persistent blocks whose warps
  take rows in a grid-stride loop; per row the hoisted source values and
  band bits, each lane's stride over the targets keeping per-slot first
  maxima (S = 3, 6) or one flat-index argmax (the generic kernel), then the
  shuffle-down reduction in its order) equals the plain version — the CPU's
  view of csrc/upmap_score.cu, which only a card can run;
* `calc_pg_upmaps` and `calc_pg_upmaps_scalar` commit the same
  pg_upmap_items and report the same BalanceResult (launches included: a
  CPU map scores in the JAX package's chunks) on test_balance.py's maps.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.crush import balance as jbalance
from ceph_tpu.crush.types import ChooseArg as JChooseArg
from ceph_tpu.sim import build_cluster as jbuild
from ceph_tpu_torch.crush import balance
from ceph_tpu_torch.crush.types import ChooseArg
from ceph_tpu_torch.sim import build_cluster
from tests.test_torch_upmap_cuda import CASES, SOURCE, as_tensors, rounding_ties, score_case

F32 = np.float32


def jax_score(case):
    up, dev, valid, dom, max_dev = case
    g, f, t = jbalance._score_chunk(jnp.asarray(up), jnp.asarray(dev),
                                    jnp.asarray(valid), jnp.asarray(dom),
                                    jnp.float32(max_dev))
    return np.asarray(g), np.asarray(f), np.asarray(t)


def assert_same(got, want):
    g, f, t = (np.asarray(v) for v in got)
    assert g.dtype == np.float32 and f.dtype == np.int32 and t.dtype == np.int32
    assert np.array_equal(g.view(np.int32), np.asarray(want[0]).view(np.int32))
    assert np.array_equal(f, want[1]) and np.array_equal(t, want[2])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_scorer_matches_jax(name):
    case = score_case(name)
    got = balance.score_chunk_plain(*as_tensors(case, "cpu"))
    want = jax_score(case)
    assert_same(got, want)
    if name.startswith("ties"):
        # the cases really are tie-heavy: many rows share their best gain
        # with another (slot, target) — the first one must win
        g = np.asarray(got[0])
        assert np.isfinite(g).sum() > len(g) // 2
    if name.startswith("ulp"):
        # sources less than one ulp of the gain apart do give equal gains
        assert rounding_ties(case) > 0


def _better(g, idx, best, best_idx):
    return g > best or (g == best and idx < best_idx)


def kernel_constants():
    """(threads per block, register widths) of csrc/upmap_score.cu."""
    with open(SOURCE) as f:
        src = f.read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    widths = tuple(int(w) for w in re.findall(r"if \(S == (\d+)\)", src))
    return threads, widths


def persistent_rows(c, resident, warps):
    """Rows in the order the kernel's persistent blocks take them: grid =
    min(blocks the rows need, blocks resident on the card); warp w of block
    b takes rows b * warps + w, then every grid * warps rows."""
    grid = min(-(-c // warps), resident)
    for block in range(grid):
        for warp in range(warps):
            yield from range(block * warps + warp, c, grid * warps)


def emulate_kernel_row(up_row, dev, valid, dom, max_dev):
    """One warp of csrc/upmap_score.cu on one row, statement for statement:
    the staged (tdev, tdom) pairs, the hoisted per-row source values and
    band bits, each lane's stride over the targets (per-slot first maxima
    in the register instantiations, which skip the in-row test on rows
    whose placed slots sit in distinct domains; one flat-index argmax in
    the generic kernel), then the shuffle-down reduction in its order."""
    n = dev.shape[0] - 1
    s_n = up_row.shape[0]
    max_dev, inf, one = F32(max_dev), F32(np.inf), F32(1.0)
    regs = s_n in kernel_constants()[1]
    # staged targets: +inf and domain -1 where no move to t is ever legal
    tgt = [(dev[t], int(dom[t])) if valid[t] and dom[t] >= 0 else (inf, -1)
           for t in range(n)]
    # hoisted per row: raw ids, occupied domains, source values, band bits
    frm = [int(f) for f in up_row]
    fc = [min(f, n) if f >= 0 else n for f in frm]
    odom = [int(dom[c]) if f >= 0 else -1 for f, c in zip(frm, fc)]
    src = [dev[c] if f >= 0 and dom[c] >= 0 else -inf for f, c in zip(frm, fc)]
    over = [dev[c] > max_dev for c in fc]
    # the register instantiations leave out the in-row test where the row's
    # placed slots sit in distinct domains
    distinct = all(odom[a] < 0 or odom[a] != odom[b]
                   for a in range(s_n) for b in range(a + 1, s_n))
    in_row_test = not (regs and distinct)
    lanes = []
    for lane in range(32):
        best, best_t = [-inf] * s_n, [0] * s_n
        bg, bi = -inf, 0x7FFFFFFF
        for t in range(lane, n, 32):
            tdev, tdom = tgt[t]
            occ = any(o == tdom for o in odom)
            if in_row_test and any(f == t for f in frm):
                tdev = inf
            under = tdev < -max_dev
            for s in range(s_n):
                d = F32(src[s] - tdev)
                g = F32(d - one)
                ok = d > one and (over[s] or under) and (not occ or odom[s] == tdom)
                if regs:
                    if ok and g > best[s]:
                        best[s], best_t[s] = g, t
                elif ok and _better(g, s * n + t, bg, bi):
                    bg, bi = g, s * n + t
        if regs:
            for s in range(s_n):
                if best[s] > bg:
                    bg, bi = best[s], s * n + best_t[s]
        lanes.append((bg, bi))
    for off in (16, 8, 4, 2, 1):
        # __shfl_down_sync: a source lane past 31 returns the caller's own
        lanes = [
            (lanes[i] if not _better(*lanes[i + off if i + off < 32 else i], *lanes[i])
             else lanes[i + off if i + off < 32 else i])
            for i in range(32)
        ]
    best, best_idx = lanes[0]
    if best_idx == 0x7FFFFFFF:
        best_idx = 0
    return best, frm[best_idx // n], best_idx % n


@pytest.mark.parametrize("c,resident", [(96, 3), (5, 132), (1000, 7)])
def test_persistent_rows_cover_each_row_once(c, resident):
    warps = kernel_constants()[0] // 32
    rows = list(persistent_rows(c, resident, warps))
    assert sorted(rows) == list(range(c))


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_kernel_matches_plain(name):
    up, dev, valid, dom, max_dev = score_case(name)
    # a few resident blocks, so that warps take several rows each
    order = list(persistent_rows(up.shape[0], 2, kernel_constants()[0] // 32))
    rows = order if dev.shape[0] <= 128 else order[:4]
    plain = balance.score_chunk_plain(*as_tensors((up, dev, valid, dom, max_dev), "cpu"))
    with np.errstate(invalid="ignore"):  # inf - inf in a never-legal candidate
        for row in rows:
            g, f, t = emulate_kernel_row(up[row], dev, valid, dom, max_dev)
            assert F32(g).view(np.int32) == plain[0][row].numpy().view(np.int32), (name, row)
            assert (f, t) == (int(plain[1][row]), int(plain[2][row])), (name, row)


# -- calc_pg_upmaps against the JAX package, on test_balance.py's maps --------


def skew(m, seed=5):
    rng = np.random.default_rng(seed)
    for o in range(0, m.max_osd, 3):
        m.osd_weight[o] = int((0.4 + 0.5 * rng.random()) * 0x10000)


def install_choose_args(m, arg_type, seed=11):
    rng = np.random.default_rng(seed)
    for bid, b in m.crush.buckets.items():
        if b.type == 1:
            m.crush.choose_args[bid] = arg_type(weight_set=[
                [int(rng.integers(0x8000, 2 * 0x10000)) for _ in range(b.size)]])


#: name -> (build_cluster args, prepare, calc_pg_upmaps kwargs); the map
#: shapes are test_balance.py's, so the JAX side compiles few map_rules
BALANCE_CASES = {
    "skewed-both-pools": (dict(n_osd=32, rep_pg_num=128, ec_pg_num=64), "skew",
                          dict(max_deviation=1.0, max_changes=64)),
    "tight-budget": (dict(n_osd=32, rep_pg_num=128, ec_pg_num=64), "skew",
                     dict(max_deviation=0.5, max_changes=7)),
    "converge": (dict(n_osd=32, rep_pg_num=128, ec_pg_num=0), None,
                 dict(max_deviation=1.0, max_changes=4096)),
    "choose-args-4-per-host": (dict(n_osd=32, rep_pg_num=128, ec_pg_num=64, osds_per_host=4),
                               "choose_args", dict(max_changes=32)),
    "indep-pool-only": (dict(n_osd=32, rep_pg_num=0, ec_pg_num=128), "skew",
                        dict(max_changes=32, pools={2})),
    "small": (dict(n_osd=16, rep_pg_num=64, ec_pg_num=0), None, dict(max_changes=8)),
    "big": (dict(n_osd=16, rep_pg_num=256, ec_pg_num=0), None, dict(max_changes=8)),
}


def build_pair(name):
    kw, prep, _ = BALANCE_CASES[name]
    port = build_cluster(device="cpu", **kw)
    ref = jbuild(**kw)
    for m, arg_type in ((port, ChooseArg), (ref, JChooseArg)):
        if prep == "skew":
            skew(m)
        elif prep == "choose_args":
            install_choose_args(m, arg_type)
    return port, ref


RESULT_FIELDS = ("changes", "launches", "rounds", "spread_before", "spread_after", "pgs")


@pytest.mark.parametrize("name", list(BALANCE_CASES))
def test_calc_pg_upmaps_matches_jax(name):
    port, ref = build_pair(name)
    kw = BALANCE_CASES[name][2]
    got = balance.calc_pg_upmaps(port, **kw)
    want = jbalance.calc_pg_upmaps(ref, **kw)
    for field in RESULT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert port.pg_upmap_items == ref.pg_upmap_items
    assert port.epoch == ref.epoch
    if name in ("skewed-both-pools", "converge"):
        assert got.changes > 0
    # the committed rows equal the JAX package's batched rows
    for pid in port.pools:
        assert np.array_equal(port.pool_mappings(pid), np.asarray(ref.pool_mappings(pid)))


@pytest.mark.parametrize("name", ["skewed-both-pools", "small"])
def test_calc_pg_upmaps_scalar_matches_jax(name):
    port, ref = build_pair(name)
    got = balance.calc_pg_upmaps_scalar(port, max_changes=16)
    want = jbalance.calc_pg_upmaps_scalar(ref, max_changes=16)
    assert got == want and got > 0
    assert port.pg_upmap_items == ref.pg_upmap_items


def test_failure_domains_match_jax():
    port, ref = build_pair("choose-args-4-per-host")
    for ruleno in port.crush.rules:
        assert balance.rule_failure_domain_type(port.crush, ruleno) == \
            jbalance.rule_failure_domain_type(ref.crush, ruleno)
        dom = balance.rule_failure_domains(port.crush, ruleno, port.max_osd)
        assert np.array_equal(dom, jbalance.rule_failure_domains(ref.crush, ruleno, ref.max_osd))
        assert np.array_equal(balance._dense_domains(dom), jbalance._dense_domains(dom))


def test_osdmap_method_records_last_balance():
    port, ref = build_pair("small")
    assert port.calc_pg_upmaps(max_changes=8) == ref.calc_pg_upmaps(max_changes=8)
    for field in RESULT_FIELDS:
        assert getattr(port.last_balance, field) == getattr(ref.last_balance, field)
