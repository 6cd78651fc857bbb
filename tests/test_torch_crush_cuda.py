"""The CRUSH choose kernel (csrc/crush_choose.cu, wrapper ops/crush_cuda.py).

No CUDA compiler or card here, so the kernel's per-thread procedure is
emulated below one x at a time, as the source writes it: uint32 rjenkins
hash, crush_ln with a uint64 product and the tables read as the kernel's
shared-memory copy, the int64 division of -ln by the 16.16 weight, and
out/out2 local arrays bounded by CRUSH_MAX_SLOTS. The emulation is held
against the port's scalar mapper and the plain torch stage on the CPU. The
`gpu` test compares the kernel itself with the plain version on a card and
skips without one. Tolerance 0: placements are integers. This file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_crush_cuda.py -q
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import builder as cb
from ceph_tpu_torch.crush import mapper as sm
from ceph_tpu_torch.crush import torch_mapper as tm
from ceph_tpu_torch.crush.types import (
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    BucketAlg,
    ChooseArg,
    CrushMap,
    RuleOp,
    RuleStep,
    Tunables,
)
from ceph_tpu_torch.ops import crush_cuda, cuda_build

SOURCE = os.path.join(cuda_build.CSRC_DIR, "crush_choose.cu")
U32 = np.uint32


def _mix(a, b, c):
    a -= b; a -= c; a ^= c >> U32(13)
    b -= c; b -= a; b ^= a << U32(8)
    c -= a; c -= b; c ^= b >> U32(13)
    a -= b; a -= c; a ^= c >> U32(12)
    b -= c; b -= a; b ^= a << U32(16)
    c -= a; c -= b; c ^= b >> U32(5)
    a -= b; a -= c; a ^= c >> U32(3)
    b -= c; b -= a; b ^= a << U32(10)
    c -= a; c -= b; c ^= b >> U32(15)
    return a, b, c


@np.errstate(over="ignore")  # uint32 arithmetic wraps, as in C
def k_hash32_3(a, b, c):
    a, b, c = U32(a & 0xFFFFFFFF), U32(b & 0xFFFFFFFF), U32(c & 0xFFFFFFFF)
    h = U32(1315423911) ^ a ^ b ^ c
    x, y = U32(231232), U32(1232)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return int(h)


@np.errstate(over="ignore")
def k_hash32_2(a, b):
    a, b = U32(a & 0xFFFFFFFF), U32(b & 0xFFFFFFFF)
    h = U32(1315423911) ^ a ^ b
    x, y = U32(231232), U32(1232)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return int(h)


class Kernel:
    """One thread of crush_choose_kernel, statement for statement."""

    def __init__(self, cm, weight, slots_max=crush_cuda.MAX_SLOTS):
        self.tbl = cm.ln_tables.numpy()
        self.offsets = cm.offsets.numpy()
        self.sizes = cm.sizes.numpy()
        self.items = cm.items.numpy()
        self.ids = cm.ids.numpy()
        self.weights = cm.weights.numpy()
        self.row_of = cm.row_of.numpy()
        self.types = cm.type_of_bucket.numpy()
        self.dev_weight = np.asarray(weight, dtype=np.int64)
        self.max_devices, self.depth = cm.max_devices, cm.depth
        self.slots_max = slots_max
        self.draws = 0

    def crush_ln(self, xin):
        x = U32(xin + 1)
        iexpon = 15
        if not (int(x) & 0x18000):
            bits = (32 - int(x & U32(0x1FFFF)).bit_length()) - 16  # __clz - 16
            x = U32(x << U32(bits))
            iexpon = 15 - bits
        index1 = (int(x) >> 8) << 1
        rh = np.uint64(self.tbl[index1 - 256])
        lh = np.int64(self.tbl[index1 + 1 - 256])
        xl64 = (np.uint64(x) * rh) >> np.uint64(48)
        lh += self.tbl[258 + int(xl64 & np.uint64(0xFF))]
        return (np.int64(iexpon) << np.int64(44)) + (lh >> np.int64(4))

    def straw2_choose(self, row, x, r, pos):
        off, size = int(self.offsets[row]), int(self.sizes[row])
        p = min(pos, self.weights.shape[0] - 1)
        best, best_draw = 0, np.int64(0)
        for i in range(size):
            wi = self.weights[p, off + i]
            draw = np.int64(tm._S64_MIN)
            if wi > 0:
                u = k_hash32_3(x, int(self.ids[off + i]), r) & 0xFFFF
                ln = self.crush_ln(u) - np.int64(0x1000000000000)
                draw = -((-ln) // wi)  # both operands >= 0: C truncation
            if i == 0 or draw > best_draw:
                best, best_draw = i, draw
        self.draws += size
        return int(self.items[off + best])

    def row_of_item(self, item):
        if item >= 0:
            return -1
        idx = -1 - item
        return int(self.row_of[idx]) if idx < len(self.row_of) else -1

    def is_out(self, item, x):
        if item >= len(self.dev_weight):
            return True
        w = int(self.dev_weight[max(item, 0)])
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (k_hash32_2(x, item) & 0xFFFF) >= w

    def descend(self, row, x, r, want_type, pos):
        """-> ("reached" | "not_reached" | "skip", item, item_row)."""
        if row < 0:
            return "not_reached", 0, -1
        for _ in range(self.depth):
            if self.sizes[row] == 0:
                return "not_reached", 0, -1
            it = self.straw2_choose(row, x, r, pos)
            if it >= self.max_devices:
                return "skip", 0, -1
            nrow = self.row_of_item(it)
            t = 0 if it >= 0 else (int(self.types[nrow]) if nrow >= 0 else -1)
            if t == want_type:
                return "reached", it, nrow
            if nrow < 0:
                return "skip", 0, -1
            row = nrow
        return "not_reached", 0, -1

    def leaf_firstn(self, s, row, x, outpos, sub_r, out2):
        rep0 = 0 if s["stable"] else outpos
        for ft in range(s["recurse_tries"]):
            st, it, _ = self.descend(row, x, rep0 + sub_r + ft, 0, outpos)
            if st == "skip":
                return None
            if st == "reached" and it not in out2[:outpos] and not self.is_out(it, x):
                return it
        return None

    def choose_firstn(self, s, start_row, x, out, out2):
        outpos = 0
        for rep in range(s["numrep"]):
            for ftotal in range(s["tries"]):
                r = rep + ftotal
                st, it, itrow = self.descend(start_row, x, r, s["want_type"], outpos)
                if st == "skip":
                    break
                if st != "reached" or it in out[:outpos]:
                    continue
                leaf = 0
                if s["recurse"]:
                    leaf = it
                    if it < 0:
                        sub_r = r >> (s["vary_r"] - 1) if s["vary_r"] else 0
                        leaf = self.leaf_firstn(s, itrow, x, outpos, sub_r, out2)
                        if leaf is None:
                            continue
                if s["want_type"] == 0 and self.is_out(it, x):
                    continue
                if outpos < s["out_slots"]:
                    out[outpos], out2[outpos] = it, leaf
                    outpos += 1
                break
        for j in range(outpos, s["out_slots"]):
            out[j] = out2[j] = CRUSH_ITEM_NONE

    def choose_indep(self, s, start_row, x, out, out2):
        n_slots = s["out_slots"]
        left = n_slots
        for j in range(n_slots):
            out[j] = out2[j] = CRUSH_ITEM_UNDEF
        ftotal = 0
        while ftotal < s["tries"] and left > 0:
            for rep in range(n_slots):
                if out[rep] != CRUSH_ITEM_UNDEF:
                    continue
                r = rep + s["numrep"] * ftotal
                st, it, itrow = self.descend(start_row, x, r, s["want_type"], 0)
                if st == "skip":
                    out[rep] = out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    continue
                if st != "reached" or it in out[:n_slots]:
                    continue
                leaf = it
                if s["recurse"] and it < 0:
                    leaf = None
                    for ft2 in range(s["recurse_tries"]):
                        st2, lf, _ = self.descend(
                            itrow, x, rep + r + s["numrep"] * ft2, 0, rep)
                        if st2 == "skip":
                            break
                        if st2 == "reached" and not self.is_out(lf, x):
                            leaf = lf
                            break
                    if leaf is None:
                        continue
                if s["want_type"] == 0 and self.is_out(it, x):
                    continue
                out[rep] = it
                if s["recurse"]:
                    out2[rep] = leaf
                left -= 1
            ftotal += 1
        for j in range(n_slots):
            if out[j] == CRUSH_ITEM_UNDEF:
                out[j] = CRUSH_ITEM_NONE
            if out2[j] == CRUSH_ITEM_UNDEF:
                out2[j] = CRUSH_ITEM_NONE

    def stage(self, x, start, **s):
        """The kernel's outputs for one lane: (out, out2) rows."""
        if s["out_slots"] > self.slots_max:
            raise ValueError("stage wider than CRUSH_MAX_SLOTS")
        out = [0] * self.slots_max
        out2 = [0] * self.slots_max
        start_row = self.row_of_item(start)
        if s["firstn"]:
            self.choose_firstn(s, start_row, x, out, out2)
        else:
            self.choose_indep(s, start_row, x, out, out2)
        return out[: s["out_slots"]], out2[: s["out_slots"]]


def two_level(n_hosts=8, osds_per_host=4, tunables=None, seed=0):
    local = np.random.default_rng(seed)
    cmap = CrushMap(tunables=tunables or Tunables.jewel())
    ids, ws = [], []
    for h in range(n_hosts):
        items = list(range(h * osds_per_host, (h + 1) * osds_per_host))
        weights = [int(local.integers(1, 8 * 0x10000)) for _ in items]
        b = cb.make_bucket(cmap, -(h + 2), BucketAlg.STRAW2, 1, items, weights)
        ids.append(b.id)
        ws.append(b.weight)
    cb.make_bucket(cmap, -1, BucketAlg.STRAW2, 10, ids, ws)
    return cmap


def stage_params(cmap, firstn, numrep, want_type, recurse, out_slots=None):
    t = cmap.tunables
    tries = t.choose_total_tries + 1
    if not firstn:
        recurse_tries = 1
    else:
        recurse_tries = 1 if t.chooseleaf_descend_once else tries
    return dict(firstn=firstn, numrep=numrep, want_type=want_type,
                recurse=recurse, tries=tries, recurse_tries=recurse_tries,
                vary_r=t.chooseleaf_vary_r, stable=t.chooseleaf_stable,
                out_slots=numrep if out_slots is None else out_slots)


def choose_args_map():
    cmap = two_level(n_hosts=6, seed=31)
    local = np.random.default_rng(5)
    root = cmap.buckets[-1]
    cmap.choose_args[-1] = ChooseArg(
        ids=[i + 100 for i in range(root.size)],
        weight_set=[[int(local.integers(1, 8 * 0x10000)) for _ in range(root.size)]
                    for _ in range(2)])
    for h in range(6):
        b = cmap.buckets[-(h + 2)]
        cmap.choose_args[b.id] = ChooseArg(
            weight_set=[[int(local.integers(1, 8 * 0x10000)) for _ in range(b.size)]])
    return cmap


def rack_map():
    cmap = CrushMap(tunables=Tunables.firefly())
    local = np.random.default_rng(61)
    osd, bid, racks, rack_w = 0, -2, [], []
    for _ in range(4):
        hosts, host_w = [], []
        for _ in range(3):
            ws = [int(local.integers(1, 6 * 0x10000)) for _ in range(2)]
            b = cb.make_bucket(cmap, bid, BucketAlg.STRAW2, 1, [osd, osd + 1], ws)
            osd, bid = osd + 2, bid - 1
            hosts.append(b.id)
            host_w.append(b.weight)
        rb = cb.make_bucket(cmap, bid, BucketAlg.STRAW2, 2, hosts, host_w)
        bid -= 1
        racks.append(rb.id)
        rack_w.append(rb.weight)
    cb.make_bucket(cmap, -1, BucketAlg.STRAW2, 10, racks, rack_w)
    return cmap


def reweights(n, out=(), partial=()):
    weight = [0x10000] * n
    for i in out:
        weight[i] = 0
    for i in partial:
        weight[i] = 0x6000
    return weight


#: (name, map, weight, stage parameters, result_max) of the single-stage
#: rules: take root, one choose step, emit
STAGE_CASES = [
    ("chooseleaf-firstn", lambda: two_level(seed=41), None, (True, 3, 1, True), 3),
    ("chooseleaf-indep-out-host", lambda: two_level(n_hosts=4, seed=53),
     lambda n: reweights(n, out=range(4)), (False, 6, 1, True), 6),
    ("choose-osd-firstn-reweighted", lambda: two_level(seed=47),
     lambda n: reweights(n, out=(2,), partial=(7, 11)), (True, 4, 0, False), 4),
    ("choose-host-indep", lambda: two_level(seed=43), None, (False, 5, 1, False), 5),
    ("firefly-chooseleaf", lambda: two_level(tunables=Tunables.firefly(), seed=67),
     None, (True, 3, 1, True), 3),
    ("choose-args-positions", choose_args_map, None, (True, 3, 1, True), 3),
]


def _rule_for(cmap, firstn, numrep, want_type, recurse):
    op = {(True, True): RuleOp.CHOOSELEAF_FIRSTN, (True, False): RuleOp.CHOOSE_FIRSTN,
          (False, True): RuleOp.CHOOSELEAF_INDEP, (False, False): RuleOp.CHOOSE_INDEP}
    cb.make_rule(cmap, 0, [RuleStep(RuleOp.TAKE, -1),
                           RuleStep(op[firstn, recurse], numrep, want_type),
                           RuleStep(RuleOp.EMIT)])


@pytest.mark.parametrize("name,build,reweight,stage,result_max", STAGE_CASES,
                         ids=[c[0] for c in STAGE_CASES])
def test_emulated_kernel_matches_scalar_and_plain(name, build, reweight, stage,
                                                  result_max):
    cmap = build()
    firstn, numrep, want_type, recurse = stage
    _rule_for(cmap, firstn, numrep, want_type, recurse)
    weight = reweight(cmap.max_devices) if reweight else [0x10000] * cmap.max_devices
    cm = tm.compile_map(cmap, device="cpu")
    params = stage_params(cmap, firstn, numrep, want_type, recurse)
    kernel = Kernel(cm, weight)
    xs = np.arange(96) * 40503
    plain = tm.choose_stage_plain(
        cm, torch.from_numpy(xs.astype(np.int32)), -1,
        torch.tensor(weight, dtype=torch.int64), **params)
    for i, x in enumerate(xs):
        out, out2 = kernel.stage(int(x), -1, **params)
        assert out == plain[0][i].tolist() and out2 == plain[1][i].tolist(), x
        picked = out2 if recurse else out
        want = sm.do_rule(cmap, 0, int(x), weight, result_max, sm.Workspace())
        got = [v for v in picked if v != CRUSH_ITEM_NONE] if firstn else picked
        assert got == want, (x, got, want)
    assert kernel.draws > 0


def test_emulated_chained_stage_and_runtime_weights():
    """A chained stage (per-lane start items) and run-time weight-sets."""
    cmap = rack_map()
    cm = tm.compile_map(cmap, device="cpu")
    weight = [0x10000] * cmap.max_devices
    wv = torch.tensor(weight, dtype=torch.int64)
    xs = np.arange(64) * 7
    txs = torch.from_numpy(xs.astype(np.int32))
    racks = stage_params(cmap, True, 2, 2, False)
    out, _ = tm.choose_stage_plain(cm, txs, -1, wv, **racks)
    leaf = stage_params(cmap, True, 2, 1, True)
    start = out[:, 1].contiguous()
    plain = tm.choose_stage_plain(cm, txs, start, wv, **leaf)
    kernel = Kernel(cm, weight)
    for i, x in enumerate(xs):
        assert kernel.stage(int(x), -1, **racks)[0] == out[i].tolist()
        got = kernel.stage(int(x), int(start[i]), **leaf)
        assert got == (plain[0][i].tolist(), plain[1][i].tolist())

    args = choose_args_map()
    cm = tm.compile_map(args, device="cpu")
    # reordered weights, and more positions than the map compiled (4 > 2)
    sets = {bid: [[(w * (i + 3)) % (8 << 16) + 1 for i, w in enumerate(row)]
                  for row in ca.weight_set] * 2
            for bid, ca in args.choose_args.items()}
    rt = tm.runtime_weight_arrays(cm, sets)
    assert rt.shape == (4, cm.items.shape[0])
    kernel = Kernel(cm, [0x10000] * args.max_devices)
    kernel.weights = rt.numpy()
    params = stage_params(args, True, 3, 1, True)
    plain = tm.choose_stage_plain(cm, txs, -1, torch.full((args.max_devices,), 0x10000),
                                  rt=rt, **params)
    for i, x in enumerate(xs):
        assert kernel.stage(int(x), -1, **params) == (
            plain[0][i].tolist(), plain[1][i].tolist())


def test_kernel_source_and_binding_agree():
    """The wrapper's constants and ctypes signature match the source."""
    with open(SOURCE) as f:
        src = f.read()
    assert int(re.search(r"#define CRUSH_MAX_SLOTS (\d+)", src).group(1)) == crush_cuda.MAX_SLOTS
    assert re.search(r"#define LN_RH_LH (\d+)", src).group(1) == "258"
    assert tm.ln_tables_np().shape == (258 + 256,)
    launch = re.search(r'extern "C" int crush_choose_launch\((.*?)\)\s*\{', src, re.S)
    n_params = len([p for p in launch.group(1).split(",") if p.strip()])

    class FakeFn:
        argtypes = None

    class FakeLib:
        crush_choose_launch = FakeFn()
        crush_cuda_error_string = FakeFn()

    orig = cuda_build.load
    cuda_build.load = lambda name: FakeLib()
    try:
        lib = crush_cuda._lib()
    finally:
        cuda_build.load = orig
    argtypes = lib.crush_choose_launch.argtypes
    assert len(argtypes) == n_params
    pointer_params = [p for p in launch.group(1).split(",") if "*" in p]
    assert argtypes.count(ctypes.c_void_p) == len(pointer_params)


def test_wide_stage_and_foreign_device_raise():
    cmap = two_level(seed=1)
    _rule_for(cmap, True, 3, 1, True)
    cm = tm.compile_map(cmap, device="cpu")
    xs = torch.arange(4, dtype=torch.int32)
    wv = torch.full((cmap.max_devices,), 0x10000)
    wide = stage_params(cmap, True, crush_cuda.MAX_SLOTS + 1, 0, False)
    with pytest.raises(ValueError, match="CRUSH_MAX_SLOTS"):
        crush_cuda.crush_choose(cm, xs, -1, wv, **wide)
    with pytest.raises(ValueError, match="stage wider"):
        Kernel(cm, [0x10000] * cmap.max_devices).stage(0, -1, **wide)
    with pytest.raises(ValueError, match="kernel only"):
        crush_cuda.crush_choose(cm, xs, -1, wv, draws=torch.zeros(4, dtype=torch.int32),
                                **stage_params(cmap, True, 3, 1, True))
    with pytest.raises(ValueError, match="unsupported device"):
        crush_cuda.crush_choose(cm, xs.to("meta"), -1, wv,
                                **stage_params(cmap, True, 3, 1, True))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_card():
    """The kernel against the plain version on the card, stage by stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    before = crush_cuda.crush_choose.launches
    for name, build, reweight, stage, _ in STAGE_CASES:
        cmap = build()
        cm = tm.compile_map(cmap, device="cuda")
        weight = reweight(cmap.max_devices) if reweight else [0x10000] * cmap.max_devices
        wv = torch.tensor(weight, dtype=torch.int64, device="cuda")
        xs = torch.arange(1 << 14, dtype=torch.int32, device="cuda") * 3
        params = stage_params(cmap, *stage)
        got = crush_cuda.crush_choose(cm, xs, -1, wv, **params)
        torch.cuda.synchronize()
        want = tm.choose_stage_plain(cm, xs, -1, wv, **params)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
    assert crush_cuda.crush_choose.launches == before + len(STAGE_CASES)
