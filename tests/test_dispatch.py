"""The one dispatch rule (curvis_tpu/dispatch.py) and every renderer's
``backend='auto'`` choice under it, with the platform monkeypatched:
gpu + float32 -> the kernel; cpu -> XLA (interpret only where a kernel is
the only implementation); float64 -> XLA anywhere."""
import jax.numpy as jnp
import pytest

from curvis_tpu import dispatch

F32, F64 = jnp.float32, jnp.float64


@pytest.fixture
def on(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(dispatch, "platform", lambda: name)
    return set_platform


@pytest.mark.parametrize("platform,dtype,kernel_only,want", [
    ("gpu", F32, False, "kernel"),
    ("gpu", F64, False, "xla"),
    ("cpu", F32, False, "xla"),
    ("cpu", F64, False, "xla"),
    ("gpu", F32, True, "kernel"),
    ("gpu", F64, True, "kernel"),
    ("cpu", F32, True, "interpret"),
    ("cpu", F64, True, "interpret"),
])
def test_choose(on, platform, dtype, kernel_only, want):
    on(platform)
    assert dispatch.choose(dtype, kernel_only=kernel_only) == want


def test_no_kernel_route_elsewhere(on):
    on("metal")
    assert dispatch.choose(F32) == "xla"
    with pytest.raises(NotImplementedError):
        dispatch.choose(F32, kernel_only=True)


def _fast(dtype):
    from curvis_tpu.render.fast import _auto_backend
    return _auto_backend(dtype, "euler")


def _fast_rk45(dtype):
    from curvis_tpu.render.fast import _auto_backend
    return _auto_backend(dtype, "rk45")


def _kerr(dtype):
    from curvis_tpu.render.kerr import _auto_backend
    return _auto_backend(dtype)


def _disk(dtype):
    from curvis_tpu.render.disk import _auto_backend
    return _auto_backend(dtype)


def _adjoint(dtype):
    # every adjoint front door asks use_kernel; the planar one is typical
    from curvis_tpu.dispatch import use_kernel
    return "pallas" if use_kernel(dtype) else "xla"


RENDERERS = {
    "fast_euler": (_fast, "pallas", "tiled"),
    "fast_rk45": (_fast_rk45, "pallas", "tiled"),
    "kerr": (_kerr, "pallas", "xla"),
    "disk": (_disk, "pallas", "while"),
    "adjoint": (_adjoint, "pallas", "xla"),
}


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("renderer", sorted(RENDERERS))
def test_renderer_auto(on, platform, dtype, renderer):
    fn, kernel, xla = RENDERERS[renderer]
    on(platform)
    want = kernel if (platform == "gpu" and dtype == F32) else xla
    assert fn(dtype) == want


@pytest.mark.parametrize("platform,want", [("gpu", "device"),
                                           ("cpu", "adaptive")])
def test_symmetric_sampler_auto(on, monkeypatch, platform, want):
    """render_symmetric(sampler='auto') keeps the refinement loop on the
    device wherever a device is present."""
    import curvis_tpu.render.symmetric as sym
    seen = {}

    def fake_device(*a, **k):
        seen["sampler"] = "device"
        raise StopIteration

    def fake_host(*a, **k):
        seen["sampler"] = "adaptive"
        raise StopIteration

    monkeypatch.setattr(sym, "_render_symmetric_device", fake_device)
    monkeypatch.setattr(sym, "sample_deflection_function", fake_host)
    on(platform)
    import curvis_tpu as cv
    cam = cv.make_camera([0.0, 5.0, 1.5707963, 0.0], [-1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 8, 4)
    with pytest.raises(StopIteration):
        sym.render_symmetric(cv.EllisMetric(rho=1.0), cam, None, None,
                             dt=0.05, max_steps=10, escape_radius=10.0)
    assert seen["sampler"] == want


def test_launcher_interprets_only_on_cpu(on, monkeypatch):
    """The kernel launcher asks the dispatch rule whether to interpret."""
    import curvis_tpu.ops.launch as launch
    calls = []

    def fake_pallas_call(body, **kw):
        calls.append(kw["interpret"])
        assert kw["backend"] == "triton"
        return lambda *args: [jnp.zeros(s.shape, s.dtype)
                              for s in kw["out_shape"]]

    monkeypatch.setattr(launch.pl, "pallas_call", fake_pallas_call)
    for platform in ("cpu", "gpu"):
        on(platform)
        launch.launch(lambda *r: None, jnp.zeros(3), [jnp.zeros(5)],
                      [F32], name="probe")
    assert calls == [True, False]
