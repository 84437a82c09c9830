"""The one-step-stale row prefetch of the row-sharded walk tier at the
blogcatalog preset on a (2, 2) mesh: the JAX package's own behaviour, and
the port's on the same inputs.

The JAX ``ShardedComETrainer`` runs on 4 devices of the 8-device CPU mesh
with ``pallas="always"``, so O1 takes ``walk-kernel-rowsharded`` with the
Pallas kernel in interpret mode, which trains every window full
(``come_tpu/parallel/sharded.py:525-531``).  The preset is cut to one walk
a node (41 macro steps of 256 walks instead of 403); nothing else changes:
V 10312, d 128, L 80, W 10, KP 512, lr 0.025.

* With ``overlap_exchange=True`` JAX's loss passes 1e6 (10.5 a pair, from
  6 ln 2 = 4.16) within the first 25 steps; with it off this cut stays
  under 5 a pair.  The bound without the prefetch holds at the cut only:
  at the full preset (403 steps, a slower learning-rate decay) JAX's full
  windows pass 1e6 without the prefetch too, at step 40, and the prefetch
  brings that divergence forward to step 19.  The divergence is the
  reference's: the port resolves "auto" to off
  (``come_tpu_torch/parallel/sharded.py::_overlap_on``) as a documented
  deviation.
* The port's trainer (4 gloo ranks, ``tests/_torch_rs.py::prefetch_curve``)
  on the JAX trainer's initial tables, walks and pools with full windows
  follows JAX's per-step loss within rtol 1e-3 until the divergence sets
  in, and passes 1e6 at the same step.

The JAX per-step losses, walks and pools are read with ``jax.debug.callback``
from the trainer's own calls of ``fused_walk_step_prepped`` and
``plan_walk_macro_steps`` (patched for the test; the package is unchanged).
"""

import sys

import jax
import numpy as np
import pytest

from _torch_dp import spawn
from _torch_rs import prefetch_curve
from come_tpu.config import PRESETS as J_PRESETS
from come_tpu.graphs import get_dataset as j_get_dataset
from come_tpu.parallel import ShardedComETrainer as JSharded
from come_tpu.parallel import make_mesh as j_make_mesh
from come_tpu.parallel import walk_exchange as jwe

CUT = dict(walks_per_node=1)
PASSES = 1e6  # a worker's summed loss of one step, 95 360 pairs
FIRST = 25    # the step by which JAX's prefetched run passes it
MATCH = 1e-3  # port against JAX before the divergence


def _jax_run(overlap: bool, cut=CUT):
    """One O1 epoch of the JAX trainer at the preset cut by ``cut``: its
    initial tables, each worker's walks and pools, and each worker's
    (loss, pairs) per step."""
    rec, inputs = [], {}
    step0, plan0 = jwe.fused_walk_step_prepped, jwe.plan_walk_macro_steps

    def axes():
        return jax.lax.axis_index("data"), jax.lax.axis_index("model")

    def step(*a, **k):
        out = step0(*a, **k)
        jax.debug.callback(
            lambda di, mi, lr, loss, n: rec.append(
                (int(di), int(mi), float(lr), float(loss), float(n))),
            *axes(), a[7], out[2], out[3])
        return out

    def plan(walks, pools, *a, **k):
        jax.debug.callback(
            lambda di, mi, w, s: inputs.__setitem__(
                (int(di), int(mi)), (np.asarray(w), np.asarray(s))),
            *axes(), walks, pools)
        return plan0(walks, pools, *a, **k)

    ds = j_get_dataset("blogcatalog")
    cfg = J_PRESETS["blogcatalog"].replace(
        num_communities=ds.num_communities, pallas="always",
        overlap_exchange=overlap, **cut)
    mesh = j_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwe, "fused_walk_step_prepped", step)
        mp.setattr(jwe, "plan_walk_macro_steps", plan)
        t = JSharded(ds.graph, cfg, mesh)
        assert t.o1_tier() == "walk-kernel-rowsharded"
        ne = np.asarray(t.state.params.node_emb)
        ce = np.asarray(t.state.params.ctx_emb)
        t.o1_epoch()
    curves = {}
    for di, mi, lr, loss, n in rec:
        curves.setdefault((di, mi), []).append((lr, loss, n))
    # a worker's steps in order: the learning rate falls every step
    curves = {k: np.array(sorted(v, key=lambda r: -r[0]))[:, 1:]
              for k, v in curves.items()}
    return ne, ce, inputs, curves


def _first_past(losses) -> int:
    """The first step whose loss passes :data:`PASSES` (or is not
    finite); len(losses) when none does."""
    bad = ~(np.asarray(losses) <= PASSES)
    return int(np.argmax(bad)) if bad.any() else len(losses)


@pytest.fixture(scope="module")
def jax_prefetch():
    return _jax_run(True)


def test_jax_prefetch_diverges_at_blogcatalog_2x2(jax_prefetch):
    """The reference's own divergence: every worker's loss passes 1e6
    within :data:`FIRST` steps of the first epoch, from 6 ln 2 a pair."""
    _, _, _, curves = jax_prefetch
    assert sorted(curves) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for c in curves.values():
        assert len(c) == 41
        np.testing.assert_allclose(c[0, 0] / c[0, 1], 6 * np.log(2),
                                   rtol=1e-3)
        assert _first_past(c[:, 0]) <= FIRST


def test_jax_without_prefetch_stays_bounded():
    """The same cut without the prefetch: no step passes 5 a pair.  Only
    at this cut: at the full preset JAX's full windows pass 1e6 without
    the prefetch too (step 40; ``python tests/test_torch_prefetch.py 10``
    prints it), which is too long a run for this suite."""
    _, _, _, curves = _jax_run(False)
    for c in curves.values():
        assert len(c) == 41
        assert np.all(c[:, 0] / c[:, 1] < 5.0)


def test_port_prefetch_follows_jax_divergence(jax_prefetch, tmp_path):
    """The port's trainer on the same tables, walks, pools and (full)
    windows: the per-step loss within rtol :data:`MATCH` of JAX's until
    the first step past 10 a pair, and past 1e6 at JAX's step (within
    one); pair counts exact."""
    ne, ce, inputs, curves = jax_prefetch
    data = {"cfg": dict(CUT, overlap_exchange=True), "ne": ne, "ce": ce,
            "walks": [[inputs[(d, m)][0] for m in range(2)]
                      for d in range(2)],
            "pools": [[inputs[(d, m)][1] for m in range(2)]
                      for d in range(2)]}
    res = spawn(prefetch_curve, 4, tmp_path, 2, 2, data)
    for r, got in enumerate(res):
        assert got["overlap"] is True
        want = curves[divmod(r, 2)]
        port = np.array(got["losses"])
        assert port.shape == want.shape
        np.testing.assert_array_equal(port[:, 1], want[:, 1])
        calm = int(np.argmax(want[:, 0] / want[:, 1] > 10.0))
        assert calm > 10
        np.testing.assert_allclose(port[:calm, 0], want[:calm, 0],
                                   rtol=MATCH)
        assert abs(_first_past(port[:, 0]) - _first_past(want[:, 0])) <= 1


if __name__ == "__main__":
    # XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
    #     PYTHONPATH=. python tests/test_torch_prefetch.py [WALKS_PER_NODE]
    # prints worker (0, 0)'s loss a pair per step: JAX with and without the
    # prefetch, the port with it, and each worker's first step past 1e6 and
    # the port's largest relative error before the divergence; the default
    # is the tests' cut (1 walk a node), 10 is the full preset
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    cut = dict(walks_per_node=int(sys.argv[1]) if len(sys.argv) > 1 else 1)
    ne, ce, inputs, on = _jax_run(True, cut)
    _, _, _, off = _jax_run(False, cut)
    data = {"cfg": dict(cut, overlap_exchange=True), "ne": ne, "ce": ce,
            "walks": [[inputs[(d, m)][0] for m in range(2)]
                      for d in range(2)],
            "pools": [[inputs[(d, m)][1] for m in range(2)]
                      for d in range(2)]}
    with tempfile.TemporaryDirectory() as tmp:
        res = spawn(prefetch_curve, 4, tmp, 2, 2, data)
    for name, c in (("jax on", on[0, 0]), ("jax off", off[0, 0]),
                    ("port on", np.array(res[0]["losses"]))):
        print(name, " ".join(f"{x:.4g}" for x in c[:, 0] / c[:, 1]))
    for r, got in enumerate(res):
        want, port = on[divmod(r, 2)], np.array(got["losses"])
        calm = int(np.argmax(want[:, 0] / want[:, 1] > 10.0))
        err = np.abs(port[:calm, 0] / want[:calm, 0] - 1).max()
        print(f"worker {divmod(r, 2)}: first past {PASSES:g} jax on "
              f"{_first_past(want[:, 0])} off "
              f"{_first_past(off[divmod(r, 2)][:, 0])} port on "
              f"{_first_past(port[:, 0])} of {len(want)} steps; max rel err "
              f"over the {calm} steps before 10 a pair {err:.3e}")
