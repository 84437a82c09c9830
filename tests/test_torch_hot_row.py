"""The hot-row shape's f32 check (``chip_smoke.py`` phase 4h) on the CPU:
``tools/hot_row.py``'s ratios and ``chip_smoke.compare`` against a plain
step in float64."""

import pytest
import torch

import chip_smoke
from come_tpu_torch.tools import hot_row


def test_hot_row_spread_on_cpu():
    """On the CPU the wrapper is the plain version, so kernel and plain
    agree exactly; the plain f32 step lies inside the f32 bound of the
    float64 step."""
    out = hot_row.spread(torch.device("cpu"), kernels=1, plains=1)
    assert out["kernel_vs_plain"] == 0.0 and out["kernel_vs_kernel"] == 0.0
    assert out["kernel_vs_plain_over_1"] == 0 and out["pairs"] == 1
    assert 0.0 < out["plain_vs_f64"] < 1.0
    assert out["kernel_vs_f64"] == out["plain_vs_f64"]


@pytest.mark.parametrize("scale,ok", [(0.5, True), (2.0, False)])
def test_compare_against_float64_plain(scale, ok):
    """A float64 plain step is compared in float64: an f32 step whose
    updates sit ``scale`` times the bound away passes below 1 and raises
    above it."""
    init = torch.full((4, 8), 0.1)
    du = torch.linspace(-1.0, 1.0, 32, dtype=torch.float64).view(4, 8)
    exact = init.double() + du
    err = scale * (1e-6 + 1e-4 * du.abs())
    kern = (init.double() + du + err).float()
    loss = torch.tensor(2.0, dtype=torch.float64)
    pairs = torch.tensor(10.0)
    if ok:
        max_abs = chip_smoke.compare("f64", (init,), (kern, loss, pairs),
                                     (exact, loss, pairs))[0]
        assert max_abs <= 1e-4
    else:
        with pytest.raises(AssertionError, match="table updates past"):
            chip_smoke.compare("f64", (init,), (kern, loss, pairs),
                               (exact, loss, pairs))
