import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavelets_tpu import B3SPLINE
from wavelets_tpu.core.transform import decompose
from wavelets_tpu.utils.profiling import (
    PEAKS,
    Cost,
    StageTimer,
    decompose_cost,
    peak_for,
    roofline,
    wow_cost,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_cost_model():
    c = decompose_cost((1024, 1024), 6, B3SPLINE)
    assert c.flops > 0 and c.hbm_bytes > 1024 * 1024 * 4 * 7
    w = wow_cost((1024, 1024), 6, B3SPLINE, denoise=True)
    assert w.flops > c.flops and w.hbm_bytes > c.hbm_bytes
    total = c + w
    assert total.flops == c.flops + w.flops
    assert c.bound_ms(peak_for(H100)) > 0


def test_stage_timer(rng):
    x = jnp.asarray(rng.normal(size=(128, 128)).astype(np.float32))
    t = StageTimer()
    with t.stage("decompose") as box:
        box["out"] = decompose(x, 3, B3SPLINE)
    assert "decompose" in t.times
    assert t.times["decompose"][0] > 0
    assert "decompose" in t.report()


def test_roofline(rng):
    """The arithmetic against an explicit peak; with no peak given the
    running device's is required, and the CPU has none."""
    x = jnp.asarray(rng.normal(size=(256, 256)).astype(np.float32))
    f = jax.jit(lambda a: a * 2 + 1)
    cost = Cost(flops=x.size * 2, hbm_bytes=2 * x.size * 4)
    r = roofline(f, (x,), cost, iters=3, peak=peak_for(H100))
    assert r["measured_ms"] > 0
    assert r["achieved_gbps"] > 0
    assert r["bound_ms"] == pytest.approx(cost.bound_ms(peak_for(H100)))
    with pytest.raises(ValueError, match="no published peaks"):
        roofline(f, (x,), cost, iters=1)


def test_peak_table_h100():
    p = peak_for(H100)
    assert p.hbm_gbps == 3350.0 and p.f32_gflops == 67000.0
    assert "data sheet" in p.source


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100"])
def test_peak_table_unknown_kind_raises(kind):
    assert kind not in PEAKS
    with pytest.raises(ValueError, match="no published peaks"):
        peak_for(kind)


def test_peak_for_running_device_raises_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(ValueError):
        peak_for()


def test_trace_raises_when_profiler_cannot_start(tmp_path, monkeypatch):
    from wavelets_tpu.utils import profiling

    def refuse(log_dir):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(profiling.jax.profiler, "start_trace", refuse)
    with pytest.raises(RuntimeError, match="profiler busy"):
        with profiling.trace(str(tmp_path)):
            pass
