"""`python -m mcpt_tpu_torch.bench`'s wavefront mode (MCPT_BENCH_WAVEFRONT=1,
as in bench.py), on the CPU at a tiny size: the switch times one wavefront
render through the same JSON line, and without a card the bench raises and
prints no result (no CPU fallback)."""

import json

import pytest
import torch

from mcpt_tpu_torch import bench


def test_measure_times_one_wavefront_render(monkeypatch):
    calls = []
    render = bench.render_radiance

    def counted(*a, **kw):
        calls.append(kw)
        out = render(*a, **kw)
        calls[-1]["stats"] = out[1]
        return out

    monkeypatch.setattr(bench, "render_radiance", counted)
    rate = bench.measure("cpu", 1, 2, wavefront=True, width=8, height=8)
    assert len(calls) == 1 and calls[0]["device"] == "cpu" and calls[0]["max_bounces"] == 2
    assert rate == calls[0]["stats"]["rays_per_s"] > 0


@pytest.mark.parametrize("wavefront", ["1", "0"])
def test_main_prints_one_json_line(monkeypatch, capsys, wavefront):
    seen = {}
    measure = bench.measure

    def tiny(dev, spp, max_bounces, n_rep=3, n_dir=None, wavefront=False, **_):
        seen.update(wavefront=wavefront, spp=spp)
        return measure(dev, spp, max_bounces, n_rep, n_dir, wavefront, width=8, height=8)

    monkeypatch.setenv("MCPT_BENCH_WAVEFRONT", wavefront)
    monkeypatch.setenv("BENCH_SPP", "1")
    monkeypatch.setenv("BENCH_MB", "2")
    monkeypatch.setenv("BENCH_REPEATS", "1")
    monkeypatch.setattr(bench, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(bench.torch.cuda, "get_device_name", lambda d: "cpu")
    monkeypatch.setattr(bench, "card", lambda: "cpu, 0 W")
    monkeypatch.setattr(bench, "measure", tiny)
    bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "rays_per_s" and out["unit"] == "rays/s" and out["value"] > 0
    assert out["vs_baseline"] == round(out["value"] / bench.BASELINE_RAYS_PER_S, 2)
    assert seen == {"wavefront": wavefront == "1", "spp": 1}


def test_wavefront_bench_needs_a_card(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    monkeypatch.setenv("MCPT_BENCH_WAVEFRONT", "1")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main()
    assert capsys.readouterr().out == ""
