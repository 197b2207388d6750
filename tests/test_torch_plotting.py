"""The port's plots against tuna_tpu's.

Each plot keyword writes its file under SAVEPLOT.  The data each package
hands matplotlib -- the scan curve, the vibrational levels and
wavefunctions, the broadened absorbance spectrum and the 2D fields on the
160 x 160 plane (the port's from dft.grid.basis_on_grid and
density_on_grid, K7a and K7b on the card, their plain versions here) --
agree within 1e-10 (an orbital's field up to its sign, which the
eigensolver picks).  Without matplotlib a plot raises where it was asked
for.
"""

import contextlib
import io
import sys

import jax
import numpy as np
import pytest
import torch

from tuna_tpu import plotting as jax_plotting
from tuna_tpu.cli import run as jax_run

from tuna_tpu_torch import plotting
from tuna_tpu_torch.cli import run

torch.set_num_threads(2)

PLOT_TOLERANCE = 1e-10


class _Recorder:
    """Stands in for matplotlib.pyplot: records the arrays of each call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args, **kwargs):
            arrays = [np.asarray(a, dtype=float) for a in args
                      if isinstance(a, (np.ndarray, list, float, np.floating))]
            self.calls.append((name, arrays))
        return call


def _plotted(runner, module, line, monkeypatch, **kwargs):
    recorder = _Recorder()
    monkeypatch.setattr(module, "_pyplot", lambda calculation: recorder)
    with contextlib.redirect_stdout(io.StringIO()):
        runner(line, **kwargs)
    return recorder.calls


@pytest.mark.parametrize("line", [
    "SCAN : H H 0.74 : HF STO-3G : NUM 3 STEP 0.1 SCANPLOT",
    "ANHARM : H H 0.74 : HF STO-3G : VIBPLOT",
    "SPE : H H 0.74 : CIS 6-31G : ABSPLOT",
    "SPE : H H 0.74 : HF 6-31G : DENSPLOT",
    "SPE : H H 0.74 : HF 6-31G : PLOTHOMO",
    "SPE : H H 0.74 : HF 6-31G : PLOTLUMO",
    "SPE : H H 0.74 : HF 6-31G : PLOTMO 3",
    "SPE : H H 0.74 : CIS 6-31G : DIFFDENSPLOT",
    "SPE : H H 0.74 : UHF 6-31G : ML 3 SPINDENSPLOT",
    "SPE : H H 0.74 : CIS 6-31G : ML 3 DIFFSPINDENSPLOT",
])
def test_plotted_data_match_tuna_tpu(line, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    expected = _plotted(jax_run, jax_plotting, line, monkeypatch)
    got = _plotted(run, plotting, line, monkeypatch, device="cpu")
    assert [name for name, _ in got] == [name for name, _ in expected]
    orbital = "PLOTHOMO" in line or "PLOTLUMO" in line or "PLOTMO" in line
    for (name, arrays), (_, jax_arrays) in zip(got, expected):
        assert len(arrays) == len(jax_arrays), name
        for a, b in zip(arrays, jax_arrays):
            if orbital and name == "contourf" and a.shape == (160, 160):
                a = a * np.sign(np.sum(a * b))
            assert a.shape == b.shape and np.max(np.abs(a - b), initial=0.0) <= (
                PLOT_TOLERANCE * max(1.0, np.max(np.abs(b), initial=0.0))), name


@pytest.mark.parametrize("line, file_name", [
    ("SCAN : H H 0.74 : HF STO-3G : NUM 3 STEP 0.1 SCANPLOT SAVEPLOT SCAN.PNG", "SCAN.PNG"),
    ("ANHARM : H H 0.74 : HF STO-3G : VIBPLOT SAVEPLOT VIB.PDF", "VIB.PDF"),
    ("SPE : H H 0.74 : CIS 6-31G : ABSPLOT SAVEPLOT ABS.PNG", "ABS.PNG"),
    ("SPE : H H 0.74 : HF 6-31G : DENSPLOT SAVEPLOT DENS.PNG", "DENS.PNG"),
])
def test_saveplot_writes_the_file(line, file_name, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        run(line, device="cpu")
    saved = [p for p in tmp_path.iterdir() if p.name.upper() == file_name]
    assert len(saved) == 1 and saved[0].stat().st_size > 1000
    assert "Plot saved to" in printed.getvalue()


def test_plot_without_matplotlib_raises(monkeypatch, tmp_path):
    """matplotlib is imported where a plot is asked for, and its absence
    raises there: the calculation stops rather than skip the plot."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        run("SPE : H H 0.74 : CIS STO-3G : ABSPLOT", suppress_output=True, device="cpu")
