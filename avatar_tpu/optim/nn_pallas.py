"""Pallas kernel (Triton route): part-ranged masked nearest-neighbor argmin.

The plain XLA search in correspond.find_nn_stats materialises an [N, chunk]
distance tile in device memory for every model chunk and scans the whole
model axis.  This kernel reads the two clouds once: each data tile of
``tile_n`` part-sorted rows scans only its own model chunk range
[cstart, cend) (the chunks holding the tile's part labels, see
correspond.make_nn_plan), carrying the running (min, argmin) in registers.
The model is stored as separate x / y / z / part rows so chunk loads are
coalesced; at ~100 KB it stays resident in L2.

Ranges are very uneven: a tile of wildcard rows scans the whole model, a
tile of one part a few chunks.  So each tile's range is cut into SPLITS
programs (a second grid axis) that run in parallel on separate SMs, and a
small XLA reduction over the splits picks the winner.  Without the split
the wildcard tiles alone set the kernel's time, each on one SM with a
handful of warps and nothing to hide their latency.

Squared distances are the direct difference in fp32 (no matrix-product
cross term), so no TF32 rounding is involved.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Python literals: a traced module constant cannot be captured by a kernel
_INF = 3.0e38
# model part label of padding and invisible columns: matches no data label
UNMATCHABLE = 2 ** 30

# Chosen by a sweep on an H100 (tile 32-128, chunk 64-256, splits 1-32,
# 4 or 8 warps, 1 or 2 stages; PERF.md): the fastest at the bench widths.
TILE_N = 32     # data rows per program (power of two)
CHUNK = 256     # model columns per loop step (power of two)
SPLITS = 8      # programs per data tile, each a slice of its chunk range
NUM_WARPS = 4


def _kernel(cstart_ref, cend_ref, dx_ref, dy_ref, dz_ref, dpart_ref,
            mx_ref, my_ref, mz_ref, mpart_ref, best_d_ref, best_i_ref, *,
            chunk: int, wild: int):
    """One data tile against slice ``program_id(1)`` of its chunk range.

    d*_ref / dpart_ref [tile_n]   data tile (dpart < 0 = padding row)
    m*_ref / mpart_ref [Pp]       whole model, part-sorted; mpart is
                                  UNMATCHABLE on padding/invisible columns
    best_d_ref / best_i_ref [tile_n]  min squared distance / argmin (-1 if
                                  no candidate)
    """
    i = pl.program_id(0)
    c1 = cend_ref[i]
    per = (c1 - cstart_ref[i] + SPLITS - 1) // SPLITS
    c0 = jnp.minimum(cstart_ref[i] + pl.program_id(1) * per, c1)
    c1 = jnp.minimum(c0 + per, c1)
    dx = dx_ref[...][:, None]
    dy = dy_ref[...][:, None]
    dz = dz_ref[...][:, None]
    dpart = dpart_ref[...][:, None]
    tn = dx.shape[0]

    def body(c, carry):
        best_d, best_i = carry
        cols = pl.ds(pl.multiple_of(c * chunk, chunk), chunk)
        mp = mpart_ref[cols][None, :]
        d2 = ((dx - mx_ref[cols][None, :]) ** 2
              + (dy - my_ref[cols][None, :]) ** 2
              + (dz - mz_ref[cols][None, :]) ** 2)          # [tn, chunk]
        # wildcard rows (dpart == wild) match any real, visible column
        ok = (dpart == mp) | ((dpart == wild) & (mp < UNMATCHABLE))
        d2 = jnp.where(ok, d2, _INF)
        cmin = jnp.min(d2, axis=1)
        idx = jax.lax.broadcasted_iota(jnp.int32, (tn, chunk), 1) + c * chunk
        cidx = jnp.min(jnp.where(d2 == cmin[:, None], idx, UNMATCHABLE),
                       axis=1)
        take = cmin < best_d
        return jnp.where(take, cmin, best_d), jnp.where(take, cidx, best_i)

    init = (jnp.full((tn,), _INF, jnp.float32), jnp.full((tn,), -1, jnp.int32))
    best_d, best_i = jax.lax.fori_loop(c0, c1, body, init)
    best_d_ref[...] = best_d
    best_i_ref[...] = jnp.where(best_d < _INF, best_i, -1)


@functools.partial(jax.jit, static_argnames=("tile_n", "chunk", "wild",
                                              "interpret"))
def nn_argmin_ranges(data_pts, data_part, model_pts, model_part, cstart,
                     cend, tile_n: int = TILE_N, chunk: int = CHUNK,
                     wild: int = -1000, interpret: bool = False):
    """(best_d [N], best_i [N]): nearest same-part model point per datum.

    data_pts [N, 3] / data_part [N] sorted by part (N a multiple of tile_n);
    model_pts [Pp, 3] / model_part [Pp] sorted by part (Pp a multiple of
    chunk; padding and invisible columns carry UNMATCHABLE); cstart / cend
    [N // tile_n] int32 give each data tile's model chunk range.
    ``interpret=True`` runs the Pallas interpreter (CPU tests only).
    """
    N = data_pts.shape[0]
    rows = pl.BlockSpec((tile_n,), lambda i, s: (i,))
    split_rows = pl.BlockSpec((None, tile_n), lambda i, s: (s, i))

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i, s: (0,))

    d_s, i_s = pl.pallas_call(
        functools.partial(_kernel, chunk=chunk, wild=wild),
        grid=(N // tile_n, SPLITS),
        in_specs=[whole(cstart), whole(cend), rows, rows, rows, rows,
                  whole(model_part), whole(model_part), whole(model_part),
                  whole(model_part)],
        out_specs=(split_rows, split_rows),
        out_shape=(jax.ShapeDtypeStruct((SPLITS, N), jnp.float32),
                   jax.ShapeDtypeStruct((SPLITS, N), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="nn_argmin_ranges",
    )(cstart, cend, data_pts[:, 0], data_pts[:, 1], data_pts[:, 2],
      data_part, model_pts[:, 0], model_pts[:, 1], model_pts[:, 2],
      model_part)
    # splits cover increasing chunk ranges, so the first minimal split holds
    # the lowest index among equal distances (first index wins, as in XLA)
    k = jnp.argmin(d_s, axis=0)[None]
    return (jnp.take_along_axis(d_s, k, 0)[0],
            jnp.take_along_axis(i_s, k, 0)[0])
