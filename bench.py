"""End-to-end tracking benchmark.

Mirrors the reference's production configuration (live-demo.cpp:60-120:
1280x720 frames, forest inference at stride 2, optimization samples at
stride 12, 3 ICP iterations per frame) over a synthetic sequence: a
ground-truth avatar moving smoothly in front of a wall, rendered to depth
frames on device.  The full pipeline runs per frame — background
subtraction, random-forest part segmentation (a 3-tree forest trained by
this repo's trainer, committed under data/), blob postprocessing, stride
sampling,
and the fused ICP/LM fit — and the benchmark reports end-to-end fps plus
per-stage latencies and tracking quality vs the known ground truth.

Prints ONE JSON line:
  {"metric": "end_to_end_fps", "value": ..., "unit": "fps",
   "vs_baseline": ...}   (+ diagnostic extras)
vs_baseline is against the reference's ~15 fps heavy-path CPU tracking
(BASELINE.md: ~3 ICP x ~40 ms + segmentation).  The line names the device
(platform, device_kind, count) and the card's name and power limit as
nvidia-smi reports them.  Without --quick it refuses to run off a GPU.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small CPU-runnable configuration")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--oracle-labels", action="store_true",
                    help="use ground-truth part masks instead of the forest")
    ap.add_argument("--forest-cache", default="data/bench_forest_r5.srtr")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--no-part-groups", action="store_true",
                    help="strict per-part matching (reference semantics) "
                         "instead of group-level correspondence")
    ap.add_argument("--profile-dir", default="",
                    help="capture a jax.profiler device trace of the "
                         "throughput pass into this directory")
    ap.add_argument("--no-batch", action="store_true",
                    help="use per-frame track_async for the throughput "
                         "pass instead of 8-frame batch dispatches")
    ap.add_argument("--batch", type=int, default=16,
                    help="frames per device dispatch in the throughput "
                         "pass; batches amortize per-dispatch overhead "
                         "while keeping >1 batch in flight so upload "
                         "overlaps compute (dispatch latency is reported "
                         "separately as latency_ms)")
    ap.add_argument("--tp-frames", type=int, default=352,
                    help="minimum frames in the steady-state throughput "
                         "pass: the GT sequence is ping-ponged (forward/"
                         "backward, motion stays continuous) until this "
                         "long, so pipeline fill/drain (first upload + "
                         "last resolve) amortizes to its steady-state "
                         "share; 0 = single pass over the GT frames")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VAL", help="TrackerConfig override "
                    "(repeatable), e.g. --set refine_every=1")
    args = ap.parse_args()

    if args.quick:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    if args.quick:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        # device numbers come only from the card: no CPU fallback
        print(f"bench.py: no GPU found ({jax.devices()[0].platform}); run "
              "with --quick for the small CPU configuration",
              file=sys.stderr)
        sys.exit(2)
    from avatar_tpu.utils import enable_compile_cache

    enable_compile_cache()
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.perception.rtree import RTree
    from avatar_tpu.testing import (K4A_INTRIN, bench_sequence,
                                    bench_tracker_kwargs, load_forest,
                                    synthetic_model)
    from avatar_tpu.tracking import TrackerConfig
    from avatar_tpu.tracking_fused import FusedTracker

    if args.quick:
        H, W = 256, 256
        intrin = CameraIntrin(fx=220.0, fy=220.0, cx=128.0, cy=128.0)
        detail = 2
        n_frames = args.frames or 8
        use_forest = False
    else:
        H, W = 720, 1280
        intrin = CameraIntrin(**K4A_INTRIN)
        detail = 6
        n_frames = args.frames or 40
        use_forest = not args.oracle_labels

    model = synthetic_model(detail=detail)
    print(f"[bench] rendering {n_frames} GT frames at {W}x{H} "
          f"({model.num_points()} verts)...", file=sys.stderr)
    seq = bench_sequence(model, intrin, (H, W), n_frames)
    frames = seq["frames"]
    gts = seq["joints"]
    gt_verts = seq["verts"]
    gt_theta0 = seq["theta0"]
    bg_depth = seq["background"]

    forest = None
    if use_forest:
        cache = args.forest_cache
        if os.path.exists(cache):
            forest = load_forest(cache)
            trees = forest if isinstance(forest, list) else [forest]
            print(f"[bench] loaded forest {cache} x{len(trees)} "
                  f"({trees[0].forest.num_nodes} nodes)", file=sys.stderr)
        else:
            from avatar_tpu.train.forest import ForestTrainer

            print("[bench] training bench forest (one-time, cached)...",
                  file=sys.stderr)
            t0 = time.time()
            trainer = ForestTrainer(
                model, intrin, (H, W), num_parts=24, num_images=192,
                num_points_per_image=1500, num_features=96,
                max_probe_offset=220.0, min_samples=48, max_tree_depth=13,
                image_batch=8, seed=11, verbose=True)
            fd = trainer.train()
            forest = RTree(24)
            forest.set_forest(fd)
            os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
            forest.export_file(cache)
            print(f"[bench] forest trained in {time.time() - t0:.0f}s, "
                  f"{fd.num_nodes} nodes", file=sys.stderr)
            forest.partmap_type = 0  # contiguous body parts

    cfg_kw = bench_tracker_kwargs(quick=args.quick,
                                  part_groups=not args.no_part_groups)
    for ov in args.set:
        k, v = ov.split("=", 1)
        try:
            v = eval(v)  # numeric / tuple literals
        except Exception:
            pass
        cfg_kw[k] = v
    cfg = TrackerConfig(**cfg_kw)
    data_interval = cfg.data_interval
    tracker = FusedTracker(model, intrin, (H, W), rtree=forest, config=cfg)
    tracker.set_background(bg_depth)

    # warmup: compile EVERY dispatchable program variant up front (reinit,
    # steady, refine, shape refit, batch) so the latency loop below and the
    # throughput pass measure steady-state execution, not first-use jits
    BATCH = max(1, args.batch)
    use_batch = not args.no_batch
    scene0, mask0 = frames[0]
    tracker.warmup(scene0, labels_override=None if use_forest else mask0,
                   batch=BATCH if use_batch else 0)
    # prime the tracker state machine on real frames (async plumbing incl.)
    tracker.track(scene0, labels_override=None if use_forest else mask0)
    for i in range(1, min(3, n_frames)):
        scene, mask = frames[i]
        tracker.track_async(scene,
                            labels_override=None if use_forest else mask)
    tracker.flush()

    # latency: synchronous per-frame wall time
    lat = []
    pc = []
    hov = []
    for i in range(1, min(6, n_frames)):
        scene, mask = frames[i]
        t0 = time.perf_counter()
        res = tracker.track(scene,
                            labels_override=None if use_forest else mask)
        lat.append(time.perf_counter() - t0)
        if res.ok and res.fit_info and "part_counts" in res.fit_info:
            pc.append(res.fit_info["part_counts"])
            hov.append(res.fit_info.get("hard_overflow", 0.0))
    latency_ms = float(np.mean(lat) * 1e3) if lat else 0.0
    if pc:
        # per-part correspondence diagnostics (starved parts = drift risk)
        mean_pc = np.mean(np.asarray(pc), axis=0)
        starved = np.argsort(mean_pc)[:6]
        print("[bench] per-part match counts (mean, 6 lowest): " +
              " ".join(f"p{p}={mean_pc[p]:.0f}" for p in starved),
              file=sys.stderr)

    # throughput: pipelined pass (the headline metric); per-frame poses are
    # collected as device arrays and evaluated after the clock stops.  The
    # pass is cheap next to GT rendering, so it runs 3 times and the best
    # sample is reported
    tracker.timer.stats.clear()
    best_wall = np.inf
    import contextlib

    # steady-state frame list: ping-pong the GT sequence (forward, then
    # backward from the second-to-last frame, ...) until it reaches
    # --tp-frames.  Motion stays continuous across the reversals, so the
    # tracker never reinitializes at a seam, and the first n_frames entries
    # are exactly the GT sequence — accuracy is evaluated on those alone.
    tp_frames = list(frames)
    if not args.quick and args.tp_frames > len(frames) > 1:
        fwd = frames[1:]
        bwd = frames[-2::-1]
        nxt = bwd
        while len(tp_frames) < args.tp_frames:
            tp_frames.extend(nxt)
            nxt = fwd if nxt is bwd else bwd
    n_tp = len(tp_frames)

    from avatar_tpu.profiling import device_trace
    prof = (device_trace(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    import jax as _jxx
    with prof:
        for _rep in range(1 if args.profile_dir else
                          (3 if not args.quick else 1)):
            thetas = []
            tracked = 0
            t_all0 = time.perf_counter()
            if use_batch:
                # max-throughput mode: BATCH frames per device dispatch,
                # pipelined two deep — batch k+1's frames stride/stack/
                # upload while batch k computes on device, so steady-state
                # cost is max(upload, device) instead of their sum
                batches = []
                for i in range(0, n_tp, BATCH):
                    chunk = tp_frames[i:i + BATCH]
                    for res, bt in tracker.track_batch_async(
                            [s for s, m in chunk],
                            None if use_forest else [m for s, m in chunk]):
                        tracked += sum(1 for r in res if r.ok)
                        batches.append((len(res), bt))
                for res, bt in tracker.flush_batches():
                    tracked += sum(1 for r in res if r.ok)
                    batches.append((len(res), bt))
                wall = time.perf_counter() - t_all0
                for nb, bt in batches:
                    for k in range(nb):
                        thetas.append(_jxx.tree.map(lambda a: a[k], bt))
            else:
                for i, (scene, mask) in enumerate(tp_frames):
                    res = tracker.track_async(
                        scene, labels_override=None if use_forest else mask)
                    if res is None or res.ok:
                        tracked += 1
                    thetas.append(tracker._theta)
                tracker.flush()
                wall = time.perf_counter() - t_all0
            best_wall = min(best_wall, wall)
    wall = best_wall

    fps = n_tp / wall
    frame_ms = np.asarray([wall / n_tp * 1e3])
    stages = {k: float(np.mean(v)) for k, v in tracker.timer.stats.items()}

    # device time per fused frame (chained dispatches, one block at the
    # end) and the frame-upload cost.  device_fps is what the pipeline
    # would do if the host never held the device back
    import jax as _jx
    import jax.numpy as _jn
    _scene0 = frames[min(5, n_frames - 1)][0]
    _dn = tracker._pre_stride(np.asarray(_scene0))
    _xyz = _jn.asarray(_dn)
    _lab0 = _jn.zeros(tracker._proc_size, _jn.uint8)
    _steps = cfg.frame_icp_iters * cfg.iters_per_icp
    if use_batch:
        # measure the dispatch mode the throughput pass actually uses:
        # BATCH frames per device call (lax.scan over the fused frame)
        _xyz_b = _jn.stack([_xyz] * BATCH)
        _lab_b = _jn.stack([_lab0] * BATCH)
        _, _dg, _thf, *_rest = tracker._run_batch(_xyz_b, _lab_b, _steps)
        _jx.block_until_ready(_dg)
        # dispatches queue asynchronously, so the final sync is paid once
        # per timed loop of NREP x BATCH frames.  Best of 3 loops.
        _NREP = 12
        device_ms = np.inf
        _dms = []
        for _ in range(3):
            _t0 = time.perf_counter()
            for _ in range(_NREP):
                _, _dg, _thf, *_rest = tracker._run_batch(_xyz_b, _lab_b, _steps)
            _jx.block_until_ready(_dg)
            _dms.append((time.perf_counter() - _t0) / (_NREP * BATCH) * 1e3)
            device_ms = min(device_ms, _dms[-1])
        device_ms_mean = float(np.mean(_dms))
    else:
        _o = tracker._run(_xyz, _lab0, _steps)
        _jx.block_until_ready(_o.host_diag)
        _t0 = time.perf_counter()
        _NREP = 20
        for _ in range(_NREP):
            _o = tracker._run(_xyz, _lab0, _steps)
            tracker._theta = _o.theta
        _jx.block_until_ready(_o.host_diag)
        device_ms = (time.perf_counter() - _t0) / _NREP * 1e3
        device_ms_mean = device_ms
    _t0 = time.perf_counter()
    for _ in range(10):
        _jn.asarray(_dn).block_until_ready()
    upload_ms = (time.perf_counter() - _t0) / 10 * 1e3

    # device-stage attribution: a short profiler trace of the fused frame
    # (outside the timed passes); each GPU kernel is bucketed by the named
    # scope (fit / refine / walk / blob_cc / bgsub) of the HLO instruction
    # it runs, read from the compiled program.  A failure here fails the
    # run.
    attribution = None
    if not args.quick:
        from avatar_tpu.profiling import hlo_op_scopes, trace_calls
        scopes = hlo_op_scopes(
            tracker.lower_frame(_xyz, _lab0, _steps).compile().as_text())
        attribution = trace_calls(
            lambda: tracker._run(_xyz, _lab0, _steps).host_diag, 6, scopes)
        print(f"[bench] device attribution: {attribution}", file=sys.stderr)

    # standalone GN/LM fit latency with device-resident inputs (the
    # BASELINE.md "per-frame fit < 8 ms" target; excludes transfers)
    import jax as _jax
    import jax.numpy as _jnp

    from avatar_tpu.optim.gauss_newton import fit as _fit

    # steady-state operating point: refit points sampled from the tracked
    # model surface (+2 mm noise) starting at the tracked pose — this is the
    # per-frame fit cost during stable tracking (deterministic early-exit,
    # unlike fitting unmatched random blobs whose step count varies run to
    # run)
    _ava = tracker.sync_avatar()
    _rng0 = np.random.default_rng(0)
    _ns = min(4096, _ava.cloud.shape[0])
    _idx = _rng0.choice(_ava.cloud.shape[0], _ns, replace=False)
    _mp = np.asarray(tracker._ctx.model_part)
    _pts = _jnp.zeros((8192, 3), _jnp.float32)
    _parts = _jnp.full((8192,), -1, _jnp.int32)
    _parts = _parts.at[:_ns].set(_jnp.asarray(_mp[_idx], _jnp.int32))
    _pts = _pts.at[:_ns].set(_jnp.asarray(
        _ava.cloud[_idx] + _rng0.normal(0, 0.002, (_ns, 3)), _jnp.float32))
    _th = tracker._theta
    # measure the fit exactly as the steady-state tracker dispatches it:
    # part-sorted fit context, frozen shape keys, sorted-model NN kernel
    _ctxf = tracker._ctx_fit if tracker._ctx_fit is not None else tracker._ctx
    _fit_kw = dict(n_steps=12, freeze_shape=True,
                   model_sorted=tracker._fit_sorted,
                   num_parts=tracker.num_parts,
                   plane_weight=cfg.plane_weight,
                   point_weight=cfg.point_weight, huber_k=cfg.huber_k,
                   robust_per_part=cfg.robust_per_part,
                   beta_temp=cfg.beta_temp)
    _out = _fit(_ctxf, model.parents, _pts, _parts, _th,
                _jnp.asarray(0.05, _jnp.float32),
                _jnp.asarray(0.12, _jnp.float32), **_fit_kw)
    _jax.block_until_ready(_out)
    _t0 = time.perf_counter()
    for _ in range(10):
        _out = _fit(_ctxf, model.parents, _pts, _parts, _th,
                    _jnp.asarray(0.05, _jnp.float32),
                    _jnp.asarray(0.12, _jnp.float32), **_fit_kw)
    _jax.block_until_ready(_out)
    fit_device_ms = (time.perf_counter() - _t0) / 10 * 1e3

    # converged-fit exactness (BASELINE.md "<1 mm fitted-mesh vertex
    # RMSE"); gate: tests/test_surface.py asserts < 1 mm
    from avatar_tpu.core.lbs import lbs as _lbs
    from avatar_tpu.testing import converged_fit_rmse_mm

    fit_rmse_mm = converged_fit_rmse_mm(
        tracker, model, intrin, frames[0][0], frames[0][1], gt_theta0,
        gt_verts[0], data_interval)

    errs = []
    vrms = []
    for i, th in enumerate(thetas[:n_frames]):
        verts, joints, _, _ = _lbs(model.params, model.parents, th.w, th.p,
                                   th.rots)
        errs.append(np.linalg.norm(np.asarray(joints) - gts[i],
                                   axis=1).mean())
        vrms.append(np.sqrt(np.mean(np.sum(
            (np.asarray(verts) - gt_verts[i]) ** 2, axis=1))))
    joint_err_mm = float(np.mean(errs[1:]) * 1e3) if len(errs) > 1 else -1.0
    # BASELINE.md acceptance metric: fitted-mesh vertex RMSE (vs the known
    # ground-truth mesh — strictly harder than "vs the CPU reference's fit",
    # which carries its own error against GT)
    vertex_rmse_mm = float(np.mean(vrms[1:]) * 1e3) if len(vrms) > 1 else -1.0

    # decomposition: tracking vertex RMSE with the GT shape substituted for
    # the tracked one isolates how much of the error is the frozen
    # reinit-frame shape estimate (shape keys are only fit on reinit frames,
    # tracking_fused.py freeze_shape=not is_reinit) vs per-frame pose error
    _gw = _jnp.asarray(gt_theta0[0], _jnp.float32)
    vrms_gtw = []
    for i, th in enumerate(thetas[:n_frames]):
        verts, _, _, _ = _lbs(model.params, model.parents, _gw, th.p, th.rots)
        vrms_gtw.append(np.sqrt(np.mean(np.sum(
            (np.asarray(verts) - gt_verts[i]) ** 2, axis=1))))
    vertex_rmse_gtshape_mm = (float(np.mean(vrms_gtw[1:]) * 1e3)
                              if len(vrms_gtw) > 1 else -1.0)
    # shape-only contribution: shaped rest cloud, tracked w vs GT w
    _zp = _jnp.zeros(3, _jnp.float32)
    _zr = _jnp.tile(_jnp.eye(3, dtype=_jnp.float32),
                    (model.num_joints(), 1, 1))
    _rest_trk, _, _, _ = _lbs(model.params, model.parents,
                              thetas[min(1, len(thetas) - 1)].w, _zp, _zr)
    _rest_gt, _, _, _ = _lbs(model.params, model.parents, _gw, _zp, _zr)
    shape_rest_rmse_mm = float(np.sqrt(np.mean(np.sum(
        (np.asarray(_rest_trk) - np.asarray(_rest_gt)) ** 2, axis=1))) * 1e3)
    print(f"[bench] vertex RMSE decomposition: tracked-shape "
          f"{vertex_rmse_mm:.2f} mm, GT-shape {vertex_rmse_gtshape_mm:.2f} "
          f"mm, rest-shape delta {shape_rest_rmse_mm:.2f} mm",
          file=sys.stderr)

    result = {
        "metric": "end_to_end_fps",
        "value": round(float(fps), 2),
        "unit": "fps",
        "vs_baseline": round(float(fps) / 15.0, 2),
        "latency_ms": round(latency_ms, 3),
        "fit_device_ms": round(float(fit_device_ms), 3),
        "frame_ms": round(float(frame_ms.mean()), 3) if len(frame_ms) else 0,
        "joint_err_mm": round(joint_err_mm, 2),
        "vertex_rmse_mm": round(vertex_rmse_mm, 2),
        # error decomposition (see computation above): tracking vertex RMSE
        # with the GT shape substituted, and the rest-pose shape delta
        "vertex_rmse_gtshape_mm": round(vertex_rmse_gtshape_mm, 2),
        "shape_rest_rmse_mm": round(shape_rest_rmse_mm, 2),
        "fit_rmse_mm": round(fit_rmse_mm, 2),
        "device_ms": round(float(device_ms), 2),
        # min over 3 timing loops AND their mean: both are reported so
        # methodology changes stay auditable
        "device_ms_mean": round(float(device_ms_mean), 2),
        "upload_ms": round(float(upload_ms), 2),
        "device_fps": round(1e3 / max(float(device_ms), 1e-6), 1),
        "frames": n_frames,
        # steady-state pass length (GT sequence ping-ponged to amortize
        # pipeline fill/drain); accuracy is still scored on the n_frames
        # first-cycle poses only
        "tp_frames": n_tp,
        "tracked": tracked,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "labels": "forest" if use_forest else "oracle",
        # selective-walk hard-bucket overflow: fraction of low-confidence
        # pixels that silently degraded to the gated single-tree label
        # (should be ~0 in steady state)
        "hard_overflow_frac": round(float(np.mean(hov)), 4) if hov else 0.0,
    }
    if attribution:
        result["device_busy_ms"] = attribution["total_ms"]
        # "<stage>?" buckets: library kernels staged by their CUDA-graph
        # neighbour (a guess, kept apart from stages read from op names)
        result["stages_device_ms"] = attribution["stages"]
    if args.quick:
        # a CPU run's times are not device metrics: keep them off the line
        result = {k: v for k, v in result.items()
                  if not k.startswith(("device_", "fit_device_"))}
    else:
        from avatar_tpu.profiling import nvidia_smi

        result["nvidia_smi"] = nvidia_smi()
    line = json.dumps(result)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
