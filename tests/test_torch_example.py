"""The port's scale example (examples/example_scale_torch.py) end to end on
the CPU at 2,000 points / 40 images / 6 views: the point-major part (f32
`solve`, `refine.converge`, f64 `cov_all`) and the file-order part (f32
`solve` and `refine.converge` on `synthetic.thin_views` in its file
order, blocks on demand) both reach
max|dx| <= 1e-6, with sigma0 within 2% of the injected 5e-4: three
standard deviations of its estimate at ~1.8e4 degrees of freedom are
1.6%.  Without a GPU and without --cpu it exits 2."""

import importlib.util
from pathlib import Path

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _example():
    path = ROOT / "examples" / "example_scale_torch.py"
    spec = importlib.util.spec_from_file_location("example_scale_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_runs_on_the_cpu():
    out = _example().main(["--cpu", "2000", "40", "6"])
    assert out["device"] == "cpu"
    for part in ("point_major", "file"):
        r = out[part]
        assert r["converged"] and r["max_dx"] <= 1e-6, part
        assert abs(r["sigma0"] / 5e-4 - 1.0) < 0.02, part
    assert len(out["point_major"]["rms_sigma"]) == 3
    assert len(out["file"]["point_sigmas"]) == 2


def test_example_needs_a_gpu_or_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the example runs there")
    with pytest.raises(SystemExit) as exc:
        _example().main(["2000", "40", "6"])
    assert exc.value.code == 2
