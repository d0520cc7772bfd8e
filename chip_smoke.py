"""Chip smoke test: the tracker's main path on an NVIDIA GPU, end to end.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # four cards: the multi-device paths only

One card, in one process, at the production size of bench.py (1280x720
uint16 depth at the Azure Kinect intrinsics, the detail-6 synthetic model,
the committed 3-tree forest, 8192-point fit buckets, part groups):

  1. device: JAX's devices and the card's name and power limit;
  2. NN: the part-ranged Pallas kernel (Triton route) against the plain XLA
     search and a float64 brute force at N = 8192 data points, P = 6624
     model vertices, 24 parts plus the wildcard label; timings of the NN
     alone and of one fused batch of 16 frames with each route;
  3. tracker: warmup, synchronous, pipelined and batched dispatch of 22
     ground-truth frames rendered on the device; every frame must track,
     the mean joint error must stay under its bound, the converged
     fit_refine probe must reach sub-millimeter vertex RMSE, and the
     compiled frame must contain the NN route the backend chose.

``--multi`` (four cards) runs only the multi-device paths: the sharded
forest trainer against the single-card one at 1280x720, and the sharded
4-stream tracking step against each stream run alone.

Any failed check exits non-zero.  So does a machine without a GPU, and a
directory without the avatar_tpu package beside this script: in every such
case no result line is printed.  On success the last line of standard
output is one JSON object naming the device.
"""

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Tolerances, stated before the run:
# the kernel takes the direct difference in fp32 on recentered coordinates
# (|x| ~ 1 m, fp32 epsilon ~1.2e-7), so its min squared distance is within
# 1e-7 m^2 of the float64 value
BEST_D_ATOL = 1e-7
# two routes may pick different points only where float64 cannot tell the
# candidates apart within 1e-6 relative ...
TIE_RTOL = 1e-6
# ... or, for the plain XLA route, within its cross-term rounding
# (|d|^2 - 2 d.x + |x|^2 in fp32 at |d|, |x| ~ 1 m: a few 1e-7 m^2)
XLA_TIE_ATOL = 1e-6
JOINT_ERR_MM = 20.0     # mean joint error over the tracked frames
FIT_RMSE_MM = 1.0       # converged fit_refine vertex RMSE (BASELINE.md)
# sharded vs single-stream tracking (--multi), each stream starting 1-2 cm
# off its true pose: bounds on (root m, posed joint mm, posed vertex mm,
# rotation matrix entry) by LM step count; None is reported, not gated.
# The two programs compile to different fusions (another summation order).
# After one step, a linear solve from identical inputs, they agree to
# rounding and everything is gated (4 virtual CPU devices at 160x90 read
# 2.4e-7 m, 0.0018 mm, 0.0022 mm, 6e-6; one stream's hand or head turned
# by 1 degree reads |dR| 0.016 and fails).  Over the production frame's
# eight steps the LM loop carries rounding into rotations the data barely
# constrains: three runs on 4 H100s read 0.01-0.28 mm of joint but |dR|
# 2.9e-5 to 2.9e-2 and 3.6 mm of vertex, and the single-stream program
# run twice on one card differed by |dR| 5e-4.  A stream given another
# stream's frame is off by centimeters.
SHARDED_BOUNDS = {1: (1e-5, 0.05, 0.1, 3e-4), 8: (5e-5, 1.0, None, None)}
BATCH = 16
# 3 synchronous + 3 pipelined + one batch, all forward in time: a camera
# never plays a sequence backwards, and a reversal defeats the tracker's
# constant-velocity warm start
N_FRAMES = 3 + 3 + BATCH
NUM_PARTS = 24          # SMPL parts; label NUM_PARTS is the wildcard
SIZE = (720, 1280)      # Azure Kinect depth frames
FIT_BUCKET = 8192       # the bench window's fit bucket at SIZE
DETAIL = 6              # synthetic model: 6624 vertices, 12420 faces


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def ms_per_call(fn, reps: int) -> float:
    """Host clock over ``reps`` back-to-back calls ending in one block."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def device_ms_per_call(fn, reps: int) -> float:
    """Device busy time per call, from a profiler trace of ``reps`` calls."""
    from avatar_tpu.profiling import trace_calls

    return trace_calls(fn, reps)["total_ms"]


@contextlib.contextmanager
def nn_route_forced(route: str):
    """Trace every program in the block with the fit's NN search forced to
    ``route`` (compiled caches are dropped on entry and exit)."""
    import jax

    from avatar_tpu.optim import correspond

    chosen = correspond.nn_route
    correspond.nn_route = lambda backend=None: route
    jax.clear_caches()
    try:
        yield
    finally:
        correspond.nn_route = chosen
        jax.clear_caches()


# --------------------------------------------------------------------------
# phase 2: the NN kernel against its references at real widths


def nn_case(seed: int = 0):
    """Data and model clouds as one fit step sees them: the detail-6 model
    posed at 2.6 m, part-sorted, with backface visibility; 7200 labeled
    samples of visible vertices (+5 mm noise), 992 wildcards, 0 padding up
    to 8192, sorted by label like the NN plan.  Both clouds are recentered
    on the model centroid (as the search does) on the host, in fp32."""
    import jax.numpy as jnp

    from avatar_tpu.core.model import Avatar
    from avatar_tpu.optim import correspond
    from avatar_tpu.testing import synthetic_model

    model = synthetic_model(detail=DETAIL)
    ava = Avatar(model)
    ava.randomize(seed=3)
    ava.w *= 0.3
    ava.p = np.array([0.0, 0.1, 2.6])
    ava.r[0] = np.diag([-1.0, 1.0, -1.0])
    ava.update()
    vis = np.asarray(correspond.backface_visibility(
        jnp.asarray(ava.cloud, jnp.float32),
        jnp.asarray(model.faces, jnp.int32)))
    part = np.asarray(model.main_joint, np.int32)
    order = np.argsort(part, kind="stable")
    cloud = np.asarray(ava.cloud, np.float32)[order]
    part, vis = part[order], vis[order]

    rng = np.random.default_rng(seed)
    n, n_lab, n_wild = 8192, 7200, 992
    pick = rng.choice(np.flatnonzero(vis), n_lab + n_wild)
    data = np.zeros((n, 3), np.float32)
    data[:n_lab + n_wild] = cloud[pick] + rng.normal(
        0, 0.005, (n_lab + n_wild, 3))
    dpart = np.full(n, -1, np.int32)
    dpart[:n_lab] = part[pick[:n_lab]]
    dpart[n_lab:n_lab + n_wild] = NUM_PARTS
    s = np.argsort(dpart, kind="stable")
    center = cloud.mean(0)
    return dict(data=(data[s] - center).astype(np.float32), dpart=dpart[s],
                cloud=(cloud - center).astype(np.float32), part=part,
                vis=vis)


def nn_float64(case):
    """Brute-force nearest same-part (or any-part, for wildcards) visible
    model point in float64: (best_d [N], best_i [N])."""
    d = case["data"].astype(np.float64)
    m = case["cloud"].astype(np.float64)
    ok_cols = case["vis"][None, :]
    best_d = np.full(d.shape[0], np.inf)
    best_i = np.full(d.shape[0], -1)
    for s in range(0, d.shape[0], 512):
        d2 = ((d[s:s + 512, None, :] - m[None]) ** 2).sum(-1)
        lab = case["dpart"][s:s + 512, None]
        ok = ((lab == case["part"][None, :]) | (lab == NUM_PARTS)) & ok_cols
        d2 = np.where(ok, d2, np.inf)
        best_d[s:s + 512] = d2.min(1)
        best_i[s:s + 512] = np.where(np.isfinite(d2.min(1)), d2.argmin(1),
                                     -1)
    return best_d, best_i


def d2_of(case, rows, idx):
    """float64 squared distance of data ``rows`` to model points ``idx``."""
    d = case["data"][rows].astype(np.float64)
    m = case["cloud"][np.maximum(idx, 0)].astype(np.float64)
    return ((d - m) ** 2).sum(-1)


def check_corr(name, case, corr, ref_i, ref_d, atol):
    """corr equals the float64 argmin wherever the two candidates differ
    by more than TIE_RTOL relative (or ``atol``); elsewhere their float64
    distances must agree within that margin."""
    if not np.array_equal(corr < 0, ref_i < 0):
        fail(f"{name}: matched set differs from float64 "
             f"({int(((corr < 0) != (ref_i < 0)).sum())} rows)")
    diff = np.flatnonzero(corr != ref_i)
    gap = np.abs(d2_of(case, diff, corr[diff]) - ref_d[diff])
    allowed = np.maximum(TIE_RTOL * ref_d[diff], atol)
    if (gap > allowed).any():
        k = int(np.argmax(gap - allowed))
        fail(f"{name}: {int((gap > allowed).sum())} rows pick a farther "
             f"point (worst gap {gap[k]:.3g} m^2 at row {diff[k]})")
    return len(diff)


def phase_nn(dev_kind):
    import jax
    import jax.numpy as jnp

    from avatar_tpu.optim import correspond
    from avatar_tpu.optim.nn_pallas import UNMATCHABLE, nn_argmin_ranges
    from avatar_tpu.profiling import roofline_share

    case = nn_case()
    ref_d, ref_i = nn_float64(case)
    j = {k: jnp.asarray(v) for k, v in case.items()}
    plan = correspond.make_nn_plan(j["data"], j["dpart"], j["part"],
                                   num_parts=NUM_PARTS, model_sorted=True)
    pad = plan.mpart_s.shape[0] - case["cloud"].shape[0]
    cloud_p = jnp.concatenate([j["cloud"], jnp.zeros((pad, 3))])
    mpart_p = jnp.where(jnp.concatenate([j["vis"], jnp.zeros(pad, bool)]),
                        plan.mpart_s, UNMATCHABLE)

    kd, ki = nn_argmin_ranges(j["data"], j["dpart"], cloud_p, mpart_p,
                              plan.cstart, plan.cend, wild=NUM_PARTS)
    kd, ki = np.asarray(kd), np.asarray(ki)
    fin = np.isfinite(ref_d)
    err = float(np.abs(kd[fin] - ref_d[fin]).max())
    print(f"[nn] kernel vs float64: max |best_d - ref| = {err:.3g} m^2 "
          f"(tolerance {BEST_D_ATOL:g})")
    if err > BEST_D_ATOL:
        fail("kernel best_d outside tolerance")
    n_tie_k = check_corr("kernel", case, ki, ref_i, ref_d, BEST_D_ATOL)

    def kernel_fn():
        return correspond.find_nn_stats_planned(
            plan, j["cloud"], j["vis"], wild=NUM_PARTS).corr

    def xla_fn():
        return correspond.find_nn_stats(
            j["data"], j["dpart"], j["cloud"], j["part"], j["vis"],
            wild=NUM_PARTS).corr

    kernel_jit, xla_jit = jax.jit(kernel_fn), jax.jit(xla_fn)
    corr_k = np.asarray(kernel_jit())
    corr_x = np.asarray(xla_jit())
    n_tie_kp = check_corr("find_nn_stats_planned", case, corr_k, ref_i,
                          ref_d, BEST_D_ATOL)
    n_tie_x = check_corr("find_nn_stats (XLA)", case, corr_x, ref_i, ref_d,
                         XLA_TIE_ATOL)
    print(f"[nn] corr vs float64: kernel {n_tie_k}, planned search "
          f"{n_tie_kp}, plain XLA {n_tie_x} rows resolved a near tie "
          f"differently (all within tolerance)")

    t = {}
    for name, fn in (("kernel", kernel_jit), ("xla", xla_jit)):
        t[name] = (ms_per_call(fn, 200), device_ms_per_call(fn, 20))
        print(f"[nn] {name} route, NN alone: {t[name][0] * 1e3:.1f} us "
              f"per call (host clock, 200 back-to-back), "
              f"{t[name][1] * 1e3:.1f} us device busy (trace)")
    # the kernel's own work: the pairs its tiles scan, at 8 fp32 operations
    # each, and the two clouds read once
    cs, ce = np.asarray(plan.cstart), np.asarray(plan.cend)
    pairs = float(((ce - cs) * plan.chunk * plan.tile_n).sum())
    share, bound = roofline_share(
        8 * pairs, (case["data"].size + cloud_p.size) * 4 + 8 * 8192,
        t["kernel"][1] * 1e-3, dev_kind)
    print(f"[nn] kernel scans {pairs / 1e6:.2f}M pairs "
          f"({pairs / (8192 * cloud_p.shape[0]):.1%} of all); "
          f"{share:.2%} of the {bound} roofline")
    return t


# --------------------------------------------------------------------------
# phase 3: the tracker through its entry points


def tracker_setup():
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.testing import (K4A_INTRIN, bench_sequence,
                                    bench_tracker_kwargs, load_forest,
                                    synthetic_model)
    from avatar_tpu.tracking import TrackerConfig
    from avatar_tpu.tracking_fused import FusedTracker

    size = SIZE
    intrin = CameraIntrin(**K4A_INTRIN)
    model = synthetic_model(detail=DETAIL)
    t0 = time.perf_counter()
    seq = bench_sequence(model, intrin, size, N_FRAMES)
    print(f"[tracker] rendered {N_FRAMES} ground-truth frames at "
          f"{size[1]}x{size[0]} on the device in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({model.num_points()} vertices, {model.faces.shape[0]} faces)")
    forest = load_forest(os.path.join(HERE, "data", "bench_forest_r5.srtr"))
    cfg = TrackerConfig(**bench_tracker_kwargs())
    tracker = FusedTracker(model, intrin, size, rtree=forest, config=cfg)
    tracker.set_background(seq["background"])
    return model, intrin, cfg, tracker, seq


def phase_tracker(model, intrin, cfg, tracker, seq):
    import jax

    from avatar_tpu.core.lbs import lbs
    from avatar_tpu.testing import converged_fit_rmse_mm

    frames = seq["frames"]
    pad_n = tracker._frame_args(*frame_inputs(tracker, seq, cfg))[1]["pad_n"]
    if pad_n != FIT_BUCKET:
        fail(f"steady-state fit bucket {pad_n}, expected {FIT_BUCKET}")

    t0 = time.perf_counter()
    tracker.warmup(frames[0][0], batch=BATCH)
    print(f"[tracker] warmup (reinit, steady, shape-refit and batch-{BATCH} "
          f"programs) took {time.perf_counter() - t0:.1f} s")

    def joint_err(theta, fi):
        _, joints, _, _ = lbs(model.params, model.parents, theta.w, theta.p,
                              theta.rots)
        return float(np.linalg.norm(np.asarray(joints) - seq["joints"][fi],
                                    axis=1).mean() * 1e3)

    errs = []
    for k in range(3):
        res = tracker.track(frames[k][0])
        if not res.ok:
            fail(f"track: frame {k} not ok ({res})")
        if k > 0:     # frame 0 is the cold initialization
            errs.append(joint_err(tracker._theta, k))
    print(f"[tracker] track x3: ok; joint error {errs[0]:.2f}, "
          f"{errs[1]:.2f} mm")
    results = [tracker.track_async(frames[k][0]) for k in (3, 4, 5)]
    results.append(tracker.flush())
    if not all(r is None or r.ok for r in results) or results[-1] is None:
        fail("track_async: a frame did not track")
    print(f"[tracker] track_async x3 + flush: ok "
          f"({sum(r is not None for r in results)} results resolved)")
    batch = [f for f, _ in frames[6:6 + BATCH]]
    resolved = tracker.track_batch_async(batch)
    resolved += tracker.flush_batches()
    res_b = [r for rs, _ in resolved for r in rs]
    if len(res_b) != BATCH or not all(r.ok for r in res_b):
        fail(f"track_batch_async: {sum(r.ok for r in res_b)} of "
             f"{len(res_b)} frames ok")
    thetas = resolved[-1][1]
    for b in range(BATCH):
        errs.append(joint_err(jax.tree.map(lambda a: a[b], thetas),
                              6 + b))
    mean_err = float(np.mean(errs))
    print(f"[tracker] track_batch_async({BATCH}) + flush_batches: all ok; "
          f"mean joint error over {len(errs)} frames {mean_err:.2f} mm "
          f"(bound {JOINT_ERR_MM} mm)")
    if mean_err > JOINT_ERR_MM:
        fail("joint error above its bound")

    rmse = converged_fit_rmse_mm(tracker, model, intrin, frames[0][0],
                                 frames[0][1], seq["theta0"], seq["verts"][0],
                                 cfg.data_interval)
    print(f"[tracker] converged fit_refine probe: fit_rmse_mm {rmse:.3f} "
          f"(bound {FIT_RMSE_MM})")
    if not rmse < FIT_RMSE_MM:
        fail("converged fit RMSE above 1 mm")


def frame_inputs(tracker, seq, cfg):
    import jax.numpy as jnp

    xyz = jnp.asarray(tracker._pre_stride(seq["frames"][5][0]))
    lab = jnp.zeros(tracker._proc_size, jnp.uint8)
    steps = cfg.frame_icp_iters * cfg.iters_per_icp
    return xyz, lab, steps


def check_route_in_program(tracker, seq, cfg, want_triton: bool) -> None:
    xyz, lab, steps = frame_inputs(tracker, seq, cfg)
    txt = tracker.lower_frame(xyz, lab, steps).as_text()
    has = "xla.gpu.triton" in txt and "nn_argmin_ranges" in txt
    print(f"[route] fused frame program {'contains' if has else 'lacks'} "
          f"the Triton NN kernel call")
    if has != want_triton:
        fail("the fused frame does not run the NN route it should")


def batch_ms(tracker, seq, cfg):
    import jax.numpy as jnp

    xyz, lab, steps = frame_inputs(tracker, seq, cfg)
    xyz_b = jnp.stack([xyz] * BATCH)
    lab_b = jnp.stack([lab] * BATCH)

    def run():
        return tracker._run_batch(xyz_b, lab_b, steps)[1]

    return ms_per_call(run, 5) / BATCH, device_ms_per_call(run, 3) / BATCH


def single_card(dev_kind):
    from avatar_tpu.optim import correspond

    nn_t = phase_nn(dev_kind)
    model, intrin, cfg, tracker, seq = tracker_setup()
    route = correspond.nn_route()
    print(f"[route] nn_route() on this backend: {route}")
    if route != "triton":
        fail("the GPU backend must choose the Triton kernel")
    check_route_in_program(tracker, seq, cfg, want_triton=True)
    phase_tracker(model, intrin, cfg, tracker, seq)

    fb = {"kernel": batch_ms(tracker, seq, cfg)}
    with nn_route_forced("xla"):
        check_route_in_program(tracker, seq, cfg, want_triton=False)
        fb["xla"] = batch_ms(tracker, seq, cfg)
    for name in ("kernel", "xla"):
        print(f"[nn] {name} route, fused batch of {BATCH} frames: "
              f"{fb[name][0]:.3f} ms per frame (host clock), "
              f"{fb[name][1]:.3f} ms device busy per frame (trace)")
    print("[summary] NN alone, device busy per call: kernel "
          f"{nn_t['kernel'][1] * 1e3:.1f} us, plain XLA "
          f"{nn_t['xla'][1] * 1e3:.1f} us; fused batch of {BATCH}, per "
          f"frame: kernel {fb['kernel'][0]:.3f} ms, plain XLA "
          f"{fb['xla'][0]:.3f} ms (host clock)")


# --------------------------------------------------------------------------
# --multi: the paths that exist only across cards


def multi_card():
    import jax
    import jax.numpy as jnp

    from avatar_tpu.core.model import Avatar
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.optim.gauss_newton import Theta
    from avatar_tpu.parallel import training as ptrain
    from avatar_tpu.render.renderer import AvatarRenderer
    from avatar_tpu.testing import K4A_INTRIN, synthetic_model
    from avatar_tpu.tracking import TrackerConfig
    from avatar_tpu.tracking_fused import FusedTracker
    from avatar_tpu.train.forest import ForestTrainer

    n_dev = 4
    if len(jax.devices()) < n_dev:
        fail(f"--multi needs {n_dev} GPUs, found {len(jax.devices())}")
    mesh = ptrain.make_mesh(n_dev)
    size = SIZE
    intrin = CameraIntrin(**K4A_INTRIN)
    model = synthetic_model(detail=DETAIL)

    # the rtree_train --devices path: the mesh trainer must grow the same
    # tree (pmin/pmax are order-free, psum'd counts are integer-valued f32)
    kw = dict(num_parts=24, num_images=16, num_points_per_image=1500,
              num_features=32, max_probe_offset=220.0, min_samples=48,
              max_tree_depth=8, image_batch=8, seed=9, pass_mode="batch")
    t0 = time.perf_counter()
    fd_1 = ForestTrainer(model, intrin, size, **kw).train()
    t1 = time.perf_counter()
    fd_m = ForestTrainer(model, intrin, size, mesh=mesh, **kw).train()
    t2 = time.perf_counter()
    same = (np.array_equal(fd_m.lnode, fd_1.lnode)
            and np.array_equal(fd_m.leafid, fd_1.leafid)
            and np.array_equal(fd_m.u, fd_1.u)
            and np.array_equal(fd_m.v, fd_1.v)
            and np.allclose(fd_m.thresh, fd_1.thresh, rtol=1e-6)
            and np.allclose(fd_m.leaf_data, fd_1.leaf_data, atol=1e-7))
    print(f"[multi] forest at {size[1]}x{size[0]}: 1 card "
          f"{fd_1.num_nodes} nodes in "
          f"{t1 - t0:.1f} s, {n_dev} cards {fd_m.num_nodes} nodes in "
          f"{t2 - t1:.1f} s; identical: {same}")
    if not same:
        fail("the mesh trainer grew a different tree")
    if fd_1.num_nodes < 3:
        fail("the tree never split: the comparison would prove nothing")
    ids = jnp.arange(2 * n_dev, dtype=jnp.int32)
    from avatar_tpu.train import synth

    src = synth.make_source(model, intrin, n_images=2 * n_dev, seed=0)
    depth, _, _ = ptrain.sharded_render_batch(
        mesh, src, model.parents, ids, 0, size[0], size[1],
        model.num_shape_keys())
    n_render = len(depth.sharding.device_set)

    # sharded 4-stream tracking step vs each stream alone
    cfg = TrackerConfig(data_interval=6, rtree_interval=3, seg_window=None,
                        iters_per_icp=4)
    tr = FusedTracker(model, intrin, size, config=cfg)
    ava = Avatar(model)
    ava.randomize(seed=5)
    ava.w *= 0.2
    ava.r[0] = np.diag([-1.0, 1.0, -1.0])
    depths, labels = [], []
    for s in range(n_dev):
        ava.p = np.array([0.05 * s - 0.08, 0.1, 2.4])
        ava.update()
        rend = AvatarRenderer(ava, intrin)
        depths.append(tr._pre_stride(np.asarray(rend.render_depth(size))))
        labels.append(tr._pre_stride(np.asarray(
            rend.render_part_mask(size))))
    depth_b = jnp.asarray(np.stack(depths))
    labels_b = jnp.asarray(np.stack(labels))
    # each stream starts 1-2 cm off its true pose, as in steady tracking
    thetas_b = Theta(
        p=jnp.asarray([[0.05 * s - 0.07, 0.09, 2.41] for s in range(n_dev)],
                      jnp.float32),
        rots=jnp.asarray(np.tile(ava.r, (n_dev, 1, 1, 1)), jnp.float32),
        w=jnp.asarray(np.tile(ava.w, (n_dev, 1)), jnp.float32))
    com_b = jnp.tile(jnp.asarray(np.concatenate(
        [np.full((1, tr.num_parts), -1.0), np.zeros((1, tr.num_parts))]),
        jnp.float32), (n_dev, 1, 1))
    consts = tr._consts()
    kwargs = dict(
        beta_pose=consts["beta_pose"], beta_shape=consts["beta_shape"],
        nn_t=consts["nn_t"], nb_t=consts["nb_t"],
        min_cc_pts=consts["min_cc"], dist_to_pre_weight=consts["d2p"],
        seg_stride=1, data_substride=tr._data_substride,
        num_parts=tr.num_parts, max_depth=0, use_forest=False,
        use_bgsub=False, use_jsr=model.use_joint_shape_regressor,
        pad_n=tr._pad_n, seg_window=None,
        point_weight=consts["point_weight"],
        plane_weight=consts["plane_weight"], huber_k=consts["huber_k"],
        fit_sorted=tr._fit_sorted)
    n_track = 0
    for n_steps, bounds in SHARDED_BOUNDS.items():
        kwargs["n_steps"] = n_steps
        worst, floor, n_track = sharded_vs_alone(
            model, tr, mesh, depth_b, labels_b, thetas_b, com_b, kwargs)
        for name, v in (("sharded vs alone", worst),
                        ("alone, run twice", floor)):
            print(f"[multi] {n_dev} streams, {n_steps} LM steps, {name}: "
                  f"max |dp| {v[0]:.3g} m, joint {v[1]:.3g} mm, vertex "
                  f"{v[2]:.3g} mm, |dR| {v[3]:.3g}")
        print(f"[multi] {n_steps} LM steps, bounds (|dp| m, joint mm, "
              f"vertex mm, |dR|; None: reported only): {bounds}; labels "
              f"and sampled-point counts identical")
        if any(b is not None and w > b for w, b in zip(worst, bounds)):
            fail(f"sharded tracking ({n_steps} LM steps) differs from the "
                 "single-stream result")
    print(f"[multi] outputs span {n_track} devices, sharded render spans "
          f"{n_render}")
    if n_track != n_dev or n_render != n_dev:
        fail("outputs do not span every device")


def sharded_vs_alone(model, tr, mesh, depth_b, labels_b, thetas_b, com_b,
                     kwargs):
    """One sharded tracking step over every stream, and each stream through
    the single-stream program twice.  Returns the largest (|dp| m, posed
    joint mm, posed vertex mm, rotation entry) difference of sharded vs
    alone, the same of alone vs alone, and the number of devices holding
    the sharded output.  The labels and sampled-point count of each stream
    (integer work on its own frame, before the fit) must be identical."""
    import jax

    from avatar_tpu.core.lbs import lbs
    from avatar_tpu.parallel import training as ptrain
    from avatar_tpu.tracking_fused import _fused_frame_impl

    out = ptrain.sharded_track_step(
        mesh, tr._ctx, tr._ctx_fit, None, model.parents, depth_b, labels_b,
        tr._bg, tr._intrin4, thetas_b, com_b, kwargs)
    jax.block_until_ready(out)
    one = jax.jit(lambda d, l, th, c: _fused_frame_impl(
        tr._ctx, tr._ctx_fit, None, model.parents, d, l, tr._bg,
        tr._intrin4, th, c, **kwargs))

    def diff(a, b):
        va, ja = lbs(model.params, model.parents, a.w, a.p, a.rots)[:2]
        vb, jb = lbs(model.params, model.parents, b.w, b.p, b.rots)[:2]
        return np.array([
            np.abs(np.asarray(a.p) - np.asarray(b.p)).max(),
            np.linalg.norm(np.asarray(ja) - np.asarray(jb), axis=1).max()
            * 1e3,
            np.linalg.norm(np.asarray(va) - np.asarray(vb), axis=1).max()
            * 1e3,
            np.abs(np.asarray(a.rots) - np.asarray(b.rots)).max()])

    worst = np.zeros(4)
    floor = np.zeros(4)
    for s in range(depth_b.shape[0]):
        args_s = (depth_b[s], labels_b[s],
                  jax.tree.map(lambda a: a[s], thetas_b), com_b[s])
        ref = one(*args_s)
        again = one(*args_s)
        got = jax.tree.map(lambda a: a[s], out)
        if not (np.array_equal(np.asarray(got.labels_strided),
                               np.asarray(ref.labels_strided))
                and int(got.host_diag[0]) == int(ref.host_diag[0])):
            fail(f"stream {s}: the sharded step saw another frame")
        worst = np.maximum(worst, diff(got.theta, ref.theta))
        floor = np.maximum(floor, diff(again.theta, ref.theta))
    return worst, floor, len(out.theta.p.sharding.device_set)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: only the multi-device paths")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "avatar_tpu")):
        print("chip_smoke.py: the avatar_tpu package is not beside this "
              "script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py: no GPU ({dev.platform}); nothing to check",
              file=sys.stderr)
        return 1
    from avatar_tpu.profiling import nvidia_smi
    from avatar_tpu.utils import enable_compile_cache

    print(f"[device] compile cache: {enable_compile_cache()}")
    print(f"[device] {jax.devices()}")
    print(f"[device] device_kind: {dev.device_kind}")
    smi = nvidia_smi()
    print(f"[device] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    if args.multi:
        multi_card()
    else:
        single_card(dev.device_kind)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.0f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
