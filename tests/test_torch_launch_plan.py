"""Launch plans (``ops/launch_plan.py``): the host side of a macro step
recorded as one CUDA graph and replayed.

What the CPU can reach of it: the plan keys (entry, device, stream, mode,
shape, and nothing a step changes), one plan serving steps whose
addresses, ``lr`` and seed change, the scratch reused and ``stats`` zeroed
between steps, a result that never aliases the buffer the next step
zeroes, the arguments each step hands its C entry (the step's own tensors,
``lr`` and seed with the plan's slot and scratch, in the order of
``build.SIGNATURES``), and the counters.  The wrappers on CPU tensors still
run their plain versions: a two-step sequence whose ``lr`` changes between
the steps, held against the JAX Pallas kernels in interpret mode with
``tests/test_torch_kernels.py``'s tolerance (rtol 1e-3, atol 3e-5 on the
tables: f32 sums in another order; rtol 1e-4 on the loss; exact pairs).
The card runs the graphs in ``tests/test_torch_cuda.py::
test_graph_steps_follow_every_step``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.ops.pallas_star_sgns import fused_star_sgns_step
from come_tpu.ops.pallas_walk_sgns import fused_walk_sgns_step
from come_tpu_torch.ops import build, launch_plan
from come_tpu_torch.ops.star_sgns import (
    star_entry_args,
    star_plan,
    star_sgns_step,
)
from come_tpu_torch.ops.walk_sgns import (
    NWL,
    walk_entry_args,
    walk_plan,
    walk_sgns_step,
)
from come_tpu_torch.sampling.stars import PAD_META, build_star_layout

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 3e-5  # tests/test_torch_kernels.py's


@pytest.fixture(autouse=True)
def _no_plans():
    launch_plan.release_plans()
    yield
    launch_plan.release_plans()


class _Counts:
    recordings = instantiations = updates = replays = 0


def _walk_inputs(seed, V=50, d=8, B=16, L=12, KP=16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((V, d), generator=g), torch.randn((V, d), generator=g),
            torch.randint(0, V, (B * NWL // 8,), generator=g,
                          dtype=torch.int32),
            torch.randint(1, 4, (B * NWL // 8,), generator=g,
                          dtype=torch.int32),
            torch.randint(0, V, (2, KP), generator=g, dtype=torch.int32))


@pytest.mark.parametrize("field,other", [
    ("entry", "walk_sgns_gen"), ("device", "meta"), ("stream", 7),
    ("mode", (1, 0, 0, 0)), ("shape", (8, 2, 12, 3, 16, 2)),
])
def test_plan_key_holds_entry_device_stream_mode_and_shape(field, other):
    base = dict(entry="walk_sgns", device="cpu", stream=0,
                mode=(0, 0, 0, 0), shape=(8, 2, 12, 3, 16, 1))
    key = launch_plan.plan_key(**base)
    assert key == launch_plan.plan_key(**base)
    assert key != launch_plan.plan_key(**dict(base, **{field: other}))
    assert key == ("walk_sgns", "cpu", 0, (0, 0, 0, 0), (8, 2, 12, 3, 16, 1))


def test_one_plan_serves_steps_with_new_addresses_lr_and_seed():
    """Two steps on tables at other addresses, with other walks, draws,
    pools, lr and seed: one plan, its scratch in both steps' arguments,
    each step's own tensors and scalars beside it; the first step
    instantiates, the second updates."""
    counts = _Counts()
    args, plans = [], []
    for step, (lr, seed) in enumerate([(0.025, 11), (0.0125, 12)]):
        ei, eo, slots, wrow, pools = _walk_inputs(step)
        plan = walk_plan("walk_sgns", "cpu", 0, (1, 0, 1, 1), 8, 2, 12, 3,
                         16, 1)
        inst = plan.begin((ei.data_ptr(), eo.data_ptr(), 0.3))
        assert inst == (launch_plan.RECORD_INSTANTIATE if step == 0 else
                        launch_plan.RECORD_UPDATE)
        a = walk_entry_args(plan, inst, ei, eo, slots, wrow, pools, 8, 2, 12,
                            3, 16, 1, 1, 0, 1, 1, seed, lr, 0.3, 123)
        plan.done(inst, counts)
        assert a[2:7] == (ei.data_ptr(), eo.data_ptr(), slots.data_ptr(),
                          wrow.data_ptr(), pools.data_ptr())
        assert a[-4:] == (seed, lr, 0.3, 123)
        args.append(a)
        plans.append(plan)
    assert plans[0] is plans[1]
    assert args[0][2] != args[1][2] and args[0][-3] != args[1][-3]
    # stats, cneg, dneg, dphi, dctx, nt, the staged walks, draws and pools,
    # the argument block and the chains (K3: the pools' and the slots'):
    # the plan's
    assert args[0][7:18] == args[1][7:18]
    assert args[0][13:18] == plan.staged("walks", "wrow", "pools") + (
        plan.args.data_ptr(), plan.chains.data_ptr())
    # the chains: 3 int32 a pool draw (2 pools of 16), then 3 a slot, then
    # the f32 block ends' fold chains, 1 a slot and 1 a pool draw
    assert plan.chains.numel() == 4 * (2 * 16 + 2 * NWL)
    assert (counts.recordings, counts.instantiations, counts.updates,
            counts.replays) == (2, 1, 1, 2)
    assert (plans[0].instantiations, plans[0].updates) == (1, 1)
    assert launch_plan.used_plans("walk_sgns") == 1


def test_scratch_is_reused_and_zeroed_and_results_own_their_storage():
    plan = star_plan("cpu", 0, 0, 8, 3, 16, 1)
    assert plan is star_plan("cpu", 0, 0, 8, 3, 16, 1)
    assert plan.dctx is None and plan.walks is None
    assert plan.cneg.shape == plan.dneg.shape == (16, 8)
    assert plan.dphi.shape == (2, NWL, 8) and plan.nt.shape == (NWL,)
    ptrs = plan.scratch()
    assert {k: v.numel() for k, v in plan.inputs.items()} == {
        "slots": 3 * NWL, "meta": 3 * NWL, "pools": 3 * 16}
    plan.stats.fill_(3.5)
    plan.begin()  # a CPU plan zeroes stats, as the head kernel does
    assert torch.equal(plan.stats, torch.zeros(2, dtype=torch.float64))
    plan.stats.copy_(torch.tensor([4.0, 2.0], dtype=torch.float64))
    loss, pairs = plan.result()
    plan.begin()  # the next step zeroes stats: the result keeps its values
    assert (float(loss), float(pairs)) == (4.0, 2.0)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert plan.scratch() == ptrs


@pytest.mark.parametrize("entry", ["walk_sgns", "walk_sgns_gen", "star_sgns"])
def test_entry_arguments_follow_the_c_signatures(entry):
    """Each step's argument tuple has one value per declared C argument,
    the plan's graph slot and the record flag first, the stream last."""
    ei, eo, slots, wrow, pools = _walk_inputs(0)
    if entry == "star_sgns":
        plan = star_plan("cpu", 0, 1, 8, 2, 16, 1)
        a = star_entry_args(plan, 1, ei, slots, wrow, pools, 8, 2, 16, 1, 1,
                            0.05, 0.3, 99)
        name = "come_star_sgns_step"
    else:
        mode = (0, 0, 0, 0) if entry == "walk_sgns" else (0, 0, 0)
        plan = walk_plan(entry, "cpu", 0, mode, 8, 2, 12, 3, 16, 1)
        gen = (slots, wrow, slots, slots) if entry == "walk_sgns_gen" \
            else None
        a = walk_entry_args(plan, 1, ei, eo, slots, wrow, pools, 8, 2, 12, 3,
                            16, 1, 0, 0, 0, 0, 0, 0.05, 0.3, 99, gen=gen)
        name = "come_" + entry + "_step"
        if gen is not None:  # K4's walks go to the plan's buffer
            assert a[8] == plan.walks.data_ptr()
            assert plan.walks.numel() == 2 * NWL
            assert a[17:22] == plan.staged("starts", "bits", "wrow",
                                           "pools") + (plan.args.data_ptr(),)
            assert plan.inputs["starts"].numel() == 2 * 8
    assert len(a) == len(build.SIGNATURES[name])
    assert a[0] is None and a[1] == 1 and a[-1] == 99


@pytest.mark.parametrize("entry", ["walk_sgns", "walk_sgns_gen", "star_sgns",
                                   "fused_sgns", "fused_scan"])
def test_a_plan_records_once_and_again_only_when_a_table_moves(entry):
    """Five calls with new inputs, lr and seed on tables that stay put:
    one recording (the instantiation) and five replays; then a call on a
    moved table records again, counted as an update, and the calls after it
    only replay.  Each call's result stays its own after the next call."""
    if entry == "star_sgns":
        plan = star_plan("cpu", 0, 0, 8, 2, 16, 1)
    elif entry.startswith("fused"):
        plan = launch_plan.fused_plan_for(entry, "cpu", 0, 0, 8, 100, 16, 3)
    else:
        mode = (0, 0, 0, 0) if entry == "walk_sgns" else (0, 0, 0)
        plan = walk_plan(entry, "cpu", 0, mode, 8, 2, 12, 3, 16, 1)
    counts = _Counts()
    tabs = [torch.zeros(50, 8), torch.zeros(50, 8)]
    hows, results = [], []
    for step in range(8):
        if step == 5:
            tabs[1] = tabs[1].clone()  # the context table moves
        how = plan.begin(tuple(t.data_ptr() for t in tabs) + (0.3,))
        plan.done(how, counts)
        hows.append(how)
        if entry.startswith("fused"):
            plan.out.copy_(torch.tensor([float(step), 1.0]))
        else:
            plan.stats.copy_(torch.tensor([float(step), 1.0],
                                          dtype=torch.float64))
        results.append(plan.result())
    R = launch_plan
    assert hows == [R.RECORD_INSTANTIATE] + [R.RECORD_NONE] * 4 + [
        R.RECORD_UPDATE] + [R.RECORD_NONE] * 2
    assert (counts.recordings, counts.instantiations, counts.updates,
            counts.replays) == (2, 1, 1, 8)
    assert [float(loss) for loss, _ in results] == list(range(8))
    # the first five calls alone: what a single-device phase holds
    one = {"recordings": 1, "instantiations": 1, "updates": 0, "replays": 5,
           "shapes": 1}
    launch_plan.check_counts(entry, {entry: one}, once=True)
    with pytest.raises(AssertionError):
        launch_plan.check_counts(entry, {entry: dict(
            one, recordings=2, updates=1, replays=8)}, once=True)
    launch_plan.check_counts(entry, {entry: dict(
        one, recordings=2, updates=1, replays=8)})


def test_used_plans_count_shapes_since_reset():
    for G in (1, 2, 2, 3):
        star_plan("cpu", 0, 0, 8, G, 16, 1).begin()
    assert launch_plan.used_plans("star_sgns") == 3
    assert launch_plan.used_plans("walk_sgns") == 0
    launch_plan.reset_used()
    star_plan("cpu", 0, 0, 8, 2, 16, 1).begin()
    assert launch_plan.used_plans() == 1
    assert len(launch_plan.plans("star_sgns")) == 3


def test_walk_two_steps_with_a_new_lr_match_the_pallas_kernel():
    V, L, W, KP = 60, 20, 2, 16
    rng = np.random.default_rng(5)
    emb_in = (rng.normal(size=(V, 128)) * 0.1).astype(np.float32)
    emb_out = (rng.normal(size=(V, 128)) * 0.1).astype(np.float32)
    ji, jo = jnp.asarray(emb_in), jnp.asarray(emb_out)
    ti, to = torch.tensor(emb_in), torch.tensor(emb_out)
    for lr in (0.05, 0.02):
        walks = rng.integers(0, V, (16, L)).astype(np.int32)
        pools = rng.integers(0, V, (2, KP)).astype(np.int32)
        ji, jo, jl, jn = fused_walk_sgns_step(
            ji, jo, jnp.asarray(walks), jnp.asarray(pools), lr, 5.0 / KP,
            seed=0, window=W, interpret=True, reduced_window=False)
        wrow = torch.full((2 * NWL,), W, dtype=torch.int32)  # full window
        ti, to, tl, tn = walk_sgns_step(
            ti, to, torch.tensor(walks), wrow, torch.tensor(pools), lr,
            5.0 / KP, window=W)
        assert float(tn) == float(jn)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=ATOL)
    assert not launch_plan.plans()  # CPU tensors never reach a plan


def test_star_two_steps_with_a_new_lr_match_the_pallas_kernel():
    V, KP = 90, 8
    rng = np.random.default_rng(9)
    emb = (rng.normal(size=(V, 128)) * 0.1).astype(np.float32)
    je, te = jnp.asarray(emb), torch.tensor(emb)
    for lr in (0.05, 0.02):
        u = rng.integers(0, V, 280)
        v = rng.integers(0, V, 280)
        keep = u != v
        s, m = build_star_layout(u[keep], v[keep], V)
        assert s.shape[0] <= NWL
        s = np.pad(s, (0, NWL - s.shape[0]))
        m = np.pad(m, (0, NWL - m.shape[0]), constant_values=PAD_META)
        pools = rng.integers(0, V, (1, KP)).astype(np.int32)
        je, jl, jn = fused_star_sgns_step(
            je, jnp.asarray(s), jnp.asarray(m), jnp.asarray(pools), lr,
            5.0 / KP, seed=0, interpret=True)
        te, tl, tn = star_sgns_step(te, torch.tensor(s), torch.tensor(m),
                                    torch.tensor(pools), lr, 5.0 / KP)
        assert float(tn) == float(jn)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=RTOL,
                                   atol=ATOL)
    assert not launch_plan.plans()
