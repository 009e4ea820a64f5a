"""ctypes bindings for the C++ runtime library (native/curvis_native.cc).

Loads (and if necessary builds with g++) libcurvis_native.so.  Every entry
point has a pure-Python fallback, so the framework works without a compiler;
`available()` reports which path is active.

Components (see native/curvis_native.cc):
  - load_path_native    : CSV camera-path loader
  - march_planar_f64    : double-precision CPU oracle march (parity gates)
  - doubly_sample_native: the adaptive-sampling driver loop in C++, calling
                          back into a batched (jitted device) evaluator
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libcurvis_native.so"
_lib = None
_tried = False

_KINDS = {"ellis": 0, "interstellar": 1, "dneg": 1, "flat": 2}

_EVAL_FN = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_double),
                            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_double), ctypes.c_void_p)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR),
                            "libcurvis_native.so"],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.cn_load_path.restype = ctypes.c_int
    lib.cn_load_path.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.c_int]
    lib.cn_march_planar_f64.restype = None
    lib.cn_march_planar_f64.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.cn_doubly_sample.restype = ctypes.c_int
    lib.cn_doubly_sample.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, _EVAL_FN, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    lib.cn_render_naive_f64.restype = None
    lib.cn_render_naive_f64.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_path_native(path):
    """CSV camera path -> (positions (N,4), forwards (N,3), ups (N,3)).
    Falls back to the Python loader when the library is unavailable."""
    lib = _load()
    if lib is None:
        from curvis_tpu.camera.path import load_path
        p = load_path(path)
        return p.positions, p.forwards, p.ups
    n = lib.cn_load_path(str(path).encode(), None, 0)
    if n < 0:
        raise IOError(f"cn_load_path failed on {path} (code {n})")
    out = np.zeros((n, 10), dtype=np.float64)
    got = lib.cn_load_path(str(path).encode(), _dp(out), n)
    if got != n:
        raise IOError(f"cn_load_path inconsistent ({got} != {n})")
    return out[:, 0:4].copy(), out[:, 4:7].copy(), out[:, 7:10].copy()


def march_planar_f64(kind: str, params, l, psi, p_l, b, *, dt, max_steps,
                     escape_radius, stepper="euler"):
    """f64 CPU oracle march. Returns (l, psi, p_l, sign, steps) numpy arrays.

    ``params``: (rho,) for ellis, (m, a, rho) for interstellar, () for flat.
    """
    kind_i = _KINDS[kind]
    prm = np.zeros(4, dtype=np.float64)
    if kind_i == 0:
        prm[0] = params[0]
    elif kind_i == 1:
        prm[0], prm[1], prm[2] = params[:3]
    l = np.ascontiguousarray(np.asarray(l, np.float64)).copy()
    psi = np.ascontiguousarray(np.asarray(psi, np.float64)).copy()
    p_l = np.ascontiguousarray(np.asarray(p_l, np.float64)).copy()
    b = np.ascontiguousarray(np.asarray(b, np.float64))
    n = l.size
    sign = np.zeros(n, dtype=np.int32)
    steps = np.zeros(n, dtype=np.int32)
    lib = _load()
    st = {"euler": 0, "rk4": 1}[stepper]
    if lib is None:
        # Python fallback
        from curvis_tpu.metrics.base import make_metric
        import jax.numpy as jnp
        from curvis_tpu.physics import planar as pl
        metric = make_metric(kind, **_param_dict(kind, params))
        rays = pl.PlanarRays(jnp.asarray(l), jnp.asarray(psi),
                             jnp.asarray(p_l), jnp.asarray(b),
                             jnp.zeros((1, 3)), jnp.zeros((1, 3)))
        res = pl.march_planar_while(metric, rays, dt=dt, max_steps=max_steps,
                                    escape_radius=escape_radius,
                                    stepper=stepper)
        return (np.asarray(res.l), np.asarray(res.psi), np.asarray(res.p_l),
                np.asarray(res.sign), np.asarray(res.steps))
    lib.cn_march_planar_f64(kind_i, _dp(prm), n, _dp(l), _dp(psi), _dp(p_l),
                            _dp(b), dt, max_steps, escape_radius, st,
                            _ip(sign), _ip(steps))
    return l, psi, p_l, sign, steps


def _param_dict(kind, params):
    if _KINDS[kind] == 0:
        return {"rho": params[0]}
    if _KINDS[kind] == 1:
        return {"m": params[0], "a": params[1], "rho": params[2]}
    return {}


def render_naive_f64(kind: str, params, camera, bg_positive, bg_negative, *,
                     dt, max_steps, escape_radius):
    """Independent f64 C++ render of the reference's EXACT naive pixel chain
    (identity-frame spawn, Euler A7 march, ff22-bug readout, minimal-rotation
    embedding, nearest flip lookup; systems.rs:307-330,531-561) ->
    (H, W, 3) float64.  No JAX in the loop — the end-to-end golden oracle.

    ``camera``: a curvis_tpu Camera (only its pose/optics are read; its
    rotation matrix is evaluated once with the tested geometry module).
    ``bg_*``: (H, W, 3) float arrays or SphericalImage (identity orientation).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ required)")
    kind_i = _KINDS[kind]
    prm = np.zeros(4, dtype=np.float64)
    p = list(params)
    prm[:len(p)] = p
    from curvis_tpu.camera.camera import camera_rotation
    R = np.ascontiguousarray(np.asarray(camera_rotation(camera), np.float64))
    pos = np.asarray(camera.position, np.float64)
    cam = np.ascontiguousarray(np.array(
        [pos[1], pos[2], pos[3], float(camera.focal_length),
         float(camera.sensor_diagonal)], np.float64))

    def tex(bg):
        t = getattr(bg, "texture", bg)
        return np.ascontiguousarray(np.asarray(t, np.float64))

    tp, tn = tex(bg_positive), tex(bg_negative)
    W, H = int(camera.resolution_x), int(camera.resolution_y)
    out = np.zeros((H, W, 3), dtype=np.float64)
    lib.cn_render_naive_f64(
        kind_i, _dp(prm), _dp(cam), _dp(R), W, H,
        _dp(tp), tp.shape[0], tp.shape[1],
        _dp(tn), tn.shape[0], tn.shape[1],
        float(dt), int(max_steps), float(escape_radius), _dp(out))
    return out


def doubly_sample_native(a_min, a_max, n0, max_iter, thr1, thr2, batch_fn,
                         cap=1_000_000):
    """C++-driven adaptive sampling; ``batch_fn`` as in
    sampling/adaptive.doubly_sample_function.  Falls back to the numpy
    implementation without the library."""
    lib = _load()
    if lib is None:
        from curvis_tpu.sampling.adaptive import doubly_sample_function
        return doubly_sample_function(a_min, a_max, n0, max_iter, thr1, thr2,
                                      batch_fn)

    @_EVAL_FN
    def cb(alphas_p, n, out_e, out_s, _ctx):
        alphas = np.ctypeslib.as_array(alphas_p, shape=(n,)).copy()
        e, s = batch_fn(alphas)
        np.ctypeslib.as_array(out_e, shape=(n,))[:] = e
        np.ctypeslib.as_array(out_s, shape=(n,))[:] = s

    out = np.zeros((cap, 3), dtype=np.float64)
    n = lib.cn_doubly_sample(a_min, a_max, n0, max_iter, thr1, thr2, cb,
                             None, _dp(out), cap)
    if n == -2:
        raise ValueError("bipoints list has length < 3; cannot refine")
    if n < 0:
        raise RuntimeError(f"cn_doubly_sample failed (code {n})")
    pts = out[:n]
    return pts[:, 0].copy(), pts[:, 1].copy(), pts[:, 2].copy()
