"""K6/K7's launch plans (``ops/launch_plan.py::FusedPlan``, ``ops/sgns.py``):
the host side of a micro-step recorded as one CUDA graph and replayed.

What the CPU can reach of it: the plan key (entry, device, stream, tied,
d, TP, KP, n_tiles, and nothing a call changes), one plan serving calls
whose pools, ``lr`` and table addresses change, the scratch allocated once
and ``stats`` zeroed every call, each call's result in storage of its own,
the arguments each call hands its C entry (in the order of
``build.SIGNATURES``), and the packing: the plan's ids and mask equal
``_tiles``' packing with its 128 extra rows, and its per-tile masks ``nt``
(what the kernels read) equal the packed mask tile by tile with rows TP..
zero, also in a reused plan after a call with more pairs.  The wrappers on
CPU tensors run their plain versions and never reach a plan.  The card runs the graphs in
``tests/test_torch_cuda.py::test_fused_plan_steps_follow_every_step``.
"""

import pytest
import torch

from come_tpu_torch.ops import build, launch_plan, sgns
from come_tpu_torch.ops.sgns import (
    fused_entry_args,
    fused_plan,
    fused_sgns_step,
    fused_sgns_step_tied,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_plans():
    launch_plan.release_plans()
    yield
    launch_plan.release_plans()


class _Counts:
    recordings = instantiations = updates = replays = 0


def _pairs(seed, P, V=40, KP=16, int64=False):
    g = torch.Generator().manual_seed(seed)
    dt = torch.int64 if int64 else torch.int32
    c = torch.randint(0, V, (P,), generator=g, dtype=dt)
    x = torch.randint(0, V, (P,), generator=g, dtype=dt)
    # a mask of any nonzero values: valid is m != 0
    m = torch.randint(-1, 2, (P,), generator=g).float() * 0.5
    pool = torch.randint(0, V, (KP,), generator=g, dtype=dt)
    return c, x, m, pool


@pytest.mark.parametrize("field,other", [
    ("entry", "fused_sgns_tied"), ("device", "meta"), ("stream", 7),
    ("tied", 1), ("d", 16), ("TP", 64), ("KP", 32), ("n_tiles", 3),
])
def test_fused_plan_key_holds_tied_d_tp_kp_and_tiles(field, other):
    base = dict(entry="fused_sgns", device="cpu", stream=0, tied=0, d=8,
                TP=100, KP=16, n_tiles=2)

    def key(entry, device, stream, tied, d, TP, KP, n_tiles):
        return launch_plan.plan_key(entry, device, stream, (tied,),
                                    (d, TP, KP, n_tiles))

    assert key(**base) == ("fused_sgns", "cpu", 0, (0,), (8, 100, 16, 2))
    assert key(**base) != key(**dict(base, **{field: other}))
    plan = launch_plan.fused_plan_for(**base)
    assert plan.key == key(**base)
    assert launch_plan.fused_plan_for(**base) is plan
    assert launch_plan.fused_plan_for(**dict(base, **{field: other})) \
        is not plan


@pytest.mark.parametrize("tied", [0, 1])
def test_one_fused_plan_serves_calls_with_new_pools_lr_and_tables(tied):
    """Three calls on tables at other addresses, with other pairs, pools
    and lr: one plan, its buffers, scratch and argument block in every
    call's arguments, each call's own tables, pairs, pool, ``lr`` and
    result beside them; the first call instantiates, the others (whose
    tables moved) update."""
    counts = _Counts()
    args, plans, outs = [], [], []
    for step, lr in enumerate([0.025, 0.0125, 0.04]):
        tabs = [torch.randn(40, 8) for _ in range(1 if tied else 2)]
        c, x, m, pool = _pairs(step, 250 - 20 * step, int64=step == 1)
        plan = fused_plan("cpu", 0, tied, 8, 100, 16, 3)
        inst = plan.begin(sgns._recorded(tabs, 0.3))
        assert inst == (launch_plan.RECORD_INSTANTIATE if step == 0 else
                        launch_plan.RECORD_UPDATE)
        a = fused_entry_args(plan, inst, tabs, c, x, m, pool, lr, 0.3, 123)
        plan.done(inst, counts)
        n = len(tabs)
        assert a[2:2 + n] == tuple(t.data_ptr() for t in tabs)
        assert a[2 + n:9 + n] == (c.data_ptr(), x.data_ptr(), m.data_ptr(),
                                  pool.data_ptr(), 250 - 20 * step,
                                  int(step == 1), int(step == 1))
        assert a[-3:] == (lr, 0.3, 123)
        args.append(a[9 + n:-3])
        plans.append(plan)
        outs.append(plan.out)  # kept alive: a freed out's address recurs
    assert plans[0] is plans[1] is plans[2]
    # ids, nt, pool, stats, cneg, dneg, dphi, dcpos, args and the shape: the
    # same buffers; out is each call's own
    for a in args[1:]:
        assert a[:4] == args[0][:4] and a[5:] == args[0][5:]
    assert args[0][:3] == (plan.ids.data_ptr(), plan.nt.data_ptr(),
                           plan.pool.data_ptr())
    assert args[0][9] == plan.args.data_ptr()
    assert args[0][-4:] == (8, 3, 100, 16)  # d, n_tiles, TP, KP
    assert len({o.data_ptr() for o in outs}) == 3
    assert (counts.recordings, counts.instantiations, counts.updates,
            counts.replays) == (3, 1, 2, 3)
    assert (plans[0].instantiations, plans[0].updates) == (1, 2)
    entry = "fused_sgns_tied" if tied else "fused_sgns"
    assert launch_plan.used_plans(entry) == 1


def test_fused_scratch_is_allocated_once_and_stats_zeroed_each_call():
    plan = fused_plan("cpu", 0, 0, 8, 100, 16, 3)
    assert plan.cneg.shape == plan.dneg.shape == (16, 8)
    assert plan.dphi.shape == (2, 128, 8) and plan.dctx.shape == (128, 8)
    assert plan.nt.shape == (3, 128) and plan.ids.shape == (3, 3 * 100 + 128)
    assert plan.pool.shape == (16,) and plan.pool.dtype == torch.int32
    bufs = (plan.ids, plan.nt, plan.pool) + tuple(
        getattr(plan, n) for n in ("stats", "cneg", "dneg", "dphi", "dctx"))
    ptrs = [b.data_ptr() for b in bufs]
    results = []
    for step in range(3):
        plan.stats.fill_(3.5)
        c, x, m, pool = _pairs(step, 300 - 40 * step)
        plan.pack(c, x, m, pool)
        plan.begin()  # on the CPU, the stage kernel's zeroing
        assert torch.equal(plan.stats, torch.zeros(2, dtype=torch.float64))
        plan.out.copy_(torch.tensor([4.0 + step, 2.0]))
        results.append(plan.result())
    assert [b.data_ptr() for b in bufs] == ptrs
    # the next call's begin never touches an earlier call's result
    assert [(float(lo), float(n)) for lo, n in results] == [
        (4.0, 2.0), (5.0, 2.0), (6.0, 2.0)]
    assert results[0][0].dim() == 0 and results[0][0].dtype == torch.float32


@pytest.mark.parametrize("TP,sizes", [
    (100, (300, 300)),   # whole tiles
    (100, (300, 201)),   # a ragged last tile after a whole one
    (64, (128, 100, 65)),  # karate's tiles, shrinking tails
    (777, (1500, 778)),  # a tile past several 128-row chunks
])
def test_fused_plan_packs_as_tiles_with_the_extra_rows(TP, sizes):
    """The plan's ids equal ``_tiles(..., extra=128)``, also after a call
    with more pairs left a longer tail; ``nt`` holds each tile's mask
    != 0 as f32 with rows TP.. zero."""
    n = -(-sizes[0] // TP)
    plan = fused_plan("cpu", 0, 0, 8, TP, 16, n)
    TPr = -(-TP // 128) * 128
    for step, P in enumerate(sizes):
        assert -(-P // TP) == n
        c, x, m, pool = _pairs(step, P, int64=step % 2 == 1)
        plan.pack(c, x, m, pool)
        want, nw = sgns._tiles(c, x, m, TP, extra=launch_plan.BLK)
        assert nw == n
        assert torch.equal(plan.ids, want)
        assert plan.nt.shape == (n, TPr)
        assert torch.equal(plan.nt[:, :TP],
                           want[2, :n * TP].view(n, TP).float())
        assert not plan.nt[:, TP:].any()
        assert torch.equal(plan.pool, pool.int())


@pytest.mark.parametrize("tied", [0, 1])
def test_fused_entry_arguments_follow_the_c_signature(tied):
    plan = fused_plan("cpu", 0, tied, 8, 100, 16, 2)
    c, x, m, pool = _pairs(0, 200)
    assert plan.begin() == 1
    tabs = [torch.zeros(40, 8) for _ in range(1 if tied else 2)]
    a = fused_entry_args(plan, 1, tabs, c, x, m, pool, 0.05, 0.3, 99)
    name = "come_fused_sgns_step_tied" if tied else "come_fused_sgns_step"
    assert len(a) == len(build.SIGNATURES[name])
    assert a[0] is None and a[1] == 1 and a[-1] == 99
    # pointers, ints and floats where the C signature has them
    for v, t in zip(a[2:], build.SIGNATURES[name][2:]):
        if t is build._I:
            assert isinstance(v, int)
        elif t is build._F:
            assert isinstance(v, float)


def test_cpu_calls_never_reach_a_fused_plan():
    c, x, m, pool = _pairs(0, 130)
    before = (fused_sgns_step.launches, fused_sgns_step_tied.launches)
    fused_sgns_step(torch.randn(40, 8), torch.randn(40, 8), c, x, pool, m,
                    0.05, 0.3, tile_pairs=64)
    fused_sgns_step_tied(torch.randn(40, 8), c, x, pool, m, 0.05, 0.3,
                         tile_pairs=64)
    assert not launch_plan.plans()
    assert (fused_sgns_step.launches, fused_sgns_step_tied.launches) == before
