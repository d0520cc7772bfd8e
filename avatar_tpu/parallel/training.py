"""Multi-device scaling: data-parallel synthetic generation + forest training.

The reference is a single-process CPU program; its only cross-worker
reduction is the per-thread count-tensor accumulate-then-mutex-add of
TrainerV2 (RTree.cpp:1700-1704, SURVEY.md section 5.8).  The multi-device
equivalent implemented here:

  * the synthetic render batch and its pixel samples shard over a 1-D
    ``data`` mesh axis (each device renders and scores its own shard of
    images);
  * the (node, feature, bucket, part) count tensor and the per-(node,
    feature) score min/max reduce across devices with psum / pmin / pmax
    (NCCL all-reduces on GPUs) — the all-reduce analogue of the
    mutex-reduce;
  * independent tracking/eval streams vmap inside each device and shard
    across devices (the batched multi-stream story).

Everything compiles against any 1-D `jax.sharding.Mesh` (GPUs of one host
are joined all to all, so the mesh follows the algorithm alone); the tests
validate on a virtual 8-device CPU mesh, chip_smoke.py --multi on 4 GPUs.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from avatar_tpu.train import forest as forest_mod
from avatar_tpu.train import synth


def make_mesh(n_devices: int = 0, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def sharded_render_batch(mesh: Mesh, src: synth.SynthSource, parents,
                         image_ids: jnp.ndarray, seed: int, height: int,
                         width: int, n_keys: int, axis: str = "data"):
    """Render a batch of synthetic frames with the image axis sharded over
    the mesh.  image_ids length must divide by the mesh size."""

    def local(ids):
        return synth.render_batch(src, parents, ids, seed, height, width,
                                  n_keys)

    fn = shard_map(local, mesh=mesh, in_specs=P(axis),
                   out_specs=(P(axis), P(axis), P(axis)),
                   )
    return fn(image_ids)


def sharded_count_step(mesh: Mesh, parents, src: synth.SynthSource,
                       image_ids, sx, sy, part, valid, node_local, fu, fv,
                       n_chunk: int, n_buckets: int, n_parts: int,
                       seed: int, height: int, width: int, n_keys: int,
                       axis: str = "data"):
    """One full distributed forest-training count step: render the sharded
    image batch, compute per-(node, feature) score min/max (pmin/pmax), then
    histogram counts (psum).  Returns replicated (counts, smin, smax).

    This is the complete multi-chip training inner loop; the host-side tree
    bookkeeping consumes its (replicated) outputs identically to the
    single-chip path.
    """

    def local(ids, sx_, sy_, part_, valid_, node_local_):
        depth, _, _ = synth.render_batch(src, parents, ids, seed, height,
                                         width, n_keys)
        smin, smax = forest_mod.pass_minmax(
            depth, sx_, sy_, valid_, node_local_, fu, fv, n_chunk)
        smin = jax.lax.pmin(smin, axis)
        smax = jax.lax.pmax(smax, axis)
        counts = forest_mod.pass_counts(
            depth, sx_, sy_, part_, valid_, node_local_, fu, fv, smin, smax,
            n_chunk, n_buckets, n_parts)
        counts = jax.lax.psum(counts, axis)
        return counts, smin, smax

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()))
    return fn(image_ids, sx, sy, part, valid, node_local)


def sharded_pass_minmax(mesh: Mesh, depth, sx, sy, valid, node_local, fu,
                        fv, n_chunk: int, axis: str = "data"):
    """Mesh-sharded per-(node, feature) score min/max over one image batch:
    each chip scores its image shard, then pmin/pmax over ICI replicate the
    result.  Bitwise-equal to the single-device pass (min/max are
    order-independent)."""

    def local(d, sx_, sy_, v_, nl_, fu_, fv_):
        mn, mx = forest_mod.pass_minmax(d, sx_, sy_, v_, nl_, fu_, fv_,
                                        n_chunk)
        return jax.lax.pmin(mn, axis), jax.lax.pmax(mx, axis)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis),) * 5 + (P(), P()),
                   out_specs=(P(), P()))
    return jax.jit(fn)(depth, sx, sy, valid, node_local, fu, fv)


def sharded_pass_counts(mesh: Mesh, depth, sx, sy, part, valid, node_local,
                        fu, fv, smin, smax, n_chunk: int, n_buckets: int,
                        n_parts: int, axis: str = "data"):
    """Mesh-sharded histogram counts: per-chip partial counts psum over ICI
    — the all-reduce analogue of TrainerV2's per-thread accumulate-then-
    mutex-add (RTree.cpp:1700-1704).  Counts are integer-valued f32, so the
    reduction is exact and the trained tree is identical to single-device."""

    def local(d, sx_, sy_, part_, v_, nl_, fu_, fv_, mn_, mx_):
        c = forest_mod.pass_counts(d, sx_, sy_, part_, v_, nl_, fu_, fv_,
                                   mn_, mx_, n_chunk, n_buckets, n_parts)
        return jax.lax.psum(c, axis)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis),) * 6 + (P(),) * 4, out_specs=P())
    return jax.jit(fn)(depth, sx, sy, part, valid, node_local, fu, fv,
                       smin, smax)


def sharded_pass_assign(mesh: Mesh, depth, sx, sy, valid, node, best_u,
                        best_v, best_thresh, lchild, rchild, is_split,
                        axis: str = "data"):
    """Mesh-sharded split routing (embarrassingly parallel over images)."""

    def local(d, sx_, sy_, v_, n_, bu, bv, bt, bl, br, isp):
        return forest_mod.pass_assign(d, sx_, sy_, v_, n_, bu, bv, bt,
                                      bl, br, isp)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis),) * 5 + (P(),) * 6, out_specs=P(axis))
    return jax.jit(fn)(depth, sx, sy, valid, node, best_u, best_v,
                       best_thresh, lchild, rchild, is_split)


def sharded_multistream_lbs(mesh: Mesh, lbs_params, parents, w, p, rots,
                            axis: str = "data"):
    """Batched multi-stream LBS forward sharded over chips (the vmapped
    multi-sequence tracking/eval pattern of SURVEY.md section 2.7)."""
    from avatar_tpu.core.lbs import lbs_batched

    def local(w_, p_, r_):
        return lbs_batched(lbs_params, parents, w_, p_, r_)

    fn = shard_map(local, mesh=mesh, in_specs=(P(axis), P(axis), P(axis)),
                   out_specs=(P(axis), P(axis), P(axis), P(axis)),
                   )
    return fn(w, p, rots)


def sharded_track_step(mesh: Mesh, ctx, ctx_fit, tree, parents,
                       depth_b, labels_b, bg_depth, intrin4, thetas_b,
                       com_b, frame_kwargs, axis: str = "data"):
    """One fused tracking step for S independent camera streams, sharded
    over the mesh (multi-camera serving: each chip runs its shard of
    streams through the whole-frame program; no cross-stream collectives).

    depth_b [S, Hs, Ws], labels_b [S, Hs, Ws] u8, thetas_b: a Theta pytree
    with leading stream axis, com_b [S, 2, G].  frame_kwargs carries the
    scalar/static arguments of tracking_fused._fused_frame_impl (beta_pose
    ... boost_groups).  S must divide by the mesh size.  Returns a FrameOut
    pytree with the stream axis (labels_strided included, for per-stream
    postprocessing).
    """
    from avatar_tpu.tracking_fused import _fused_frame_impl

    def one(d, l, th, com):
        return _fused_frame_impl(ctx, ctx_fit, tree, parents, d, l,
                                 bg_depth, intrin4, th, com,
                                 **frame_kwargs)

    def local(d, l, th, com):
        return jax.vmap(one)(d, l, th, com)

    # check_vma off: the per-stream program creates unvarying literal
    # carries inside its scans/while loops (it has no cross-shard
    # collectives at all, so the varying-axes analysis adds nothing here)
    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis), P(axis), P(axis), P(axis)),
                   out_specs=P(axis), check_vma=False)
    return fn(depth_b, labels_b, thetas_b, com_b)
