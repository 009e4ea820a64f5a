"""The one launcher of every ray-march kernel (Pallas, Triton route).

Each kernel takes a scalar row plus k per-ray arrays and writes m per-ray
arrays, on a 1-D grid of ray blocks.  On the GPU the ray state of a block
lives in registers for the whole march, with 1-4 rays per thread; a block
exits its step loop when all of its rays have terminated.

The scalar row (dt, escape radius, metric and disk parameters, table
coefficients; layout in ops/march_pallas.py) is an ordinary operand,
padded to a power of two, and every scalar is loaded once per program at
kernel entry: the kernel body indexes ``row[0, k]`` and gets that value.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from curvis_tpu import dispatch

# rays per program and warps per program: one ray per thread.  Chosen by a
# sweep on the H100 (CHANGES.md): the Euler march is flat over 128-512
# rays with 4 warps, while the register-heavy Kerr DP5(4) kernel spills
# at two or more rays per thread (2.3x slower at 256 rays / 4 warps).
BLOCK = 128
NUM_WARPS = 4


class _Row:
    """The scalar row, loaded once at kernel entry; ``row[0, k]`` is
    scalar k."""

    def __init__(self, ref, width):
        self._v = [ref[0, k] for k in range(width)]

    def __getitem__(self, key):
        return self._v[key[1]]


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def launch(kernel, row, rays, out_dtypes, *, name):
    """Run ``kernel(row, *in_refs, *out_refs)`` over 1-D ray blocks.

    ``row``: (1, W) or (W,) scalars.  ``rays``: 1-D arrays of one length n
    (padded to a block multiple with copies of their first ray, which the
    outputs drop).  Returns one (n,) array per entry of ``out_dtypes``.
    Interpret mode is the dispatch rule's choice (CPU only)."""
    block = BLOCK
    if block & (block - 1):
        raise ValueError(f"BLOCK must be a power of two, got {block}")
    row = jnp.asarray(row).reshape(1, -1)
    width = row.shape[1]
    row = jnp.pad(row, ((0, 0), (0, _pow2(width) - width)))
    n = rays[0].shape[0]
    n_pad = -(-n // block) * block
    rays = [a if n_pad == n else
            jnp.concatenate([a, jnp.full((n_pad - n,), a[0], a.dtype)])
            for a in rays]

    def body(row_ref, *refs):
        kernel(_Row(row_ref, width), *refs)

    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    interpret = (dispatch.choose(row.dtype, kernel_only=True)
                 == dispatch.INTERPRET)
    outs = pl.pallas_call(
        body,
        grid=(n_pad // block,),
        in_specs=[pl.BlockSpec(row.shape, lambda i: (0, 0))]
        + [ray_spec] * len(rays),
        out_specs=[ray_spec] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), d) for d in out_dtypes],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name=name,
    )(row, *rays)
    return [o[:n] for o in outs]


def any_alive(sign):
    """Loop predicate "some ray of the block is still marching".  Triton's
    lowering has reduce_max but no reduce_or, so the test is a max."""
    return jnp.max(jnp.where(sign == 0.0, 1.0, 0.0)) > 0.0

