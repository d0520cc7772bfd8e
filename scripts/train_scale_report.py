#!/usr/bin/env python
"""Reference-scale forest-training demonstration + throughput report.

The reference anchors real training runs at 1M images x 2000 px/image x
depth 20 x >=129 probe features (rtree-train.cpp:32-46, the Kinect-paper
recipe) but ships no timing for them (multi-week CPU jobs, per the paper).
This script runs the tensorized breadth-first trainer at a substantial,
*measured* scale on one device, reports its throughput in
hardware-independent units, and extrapolates those rates to the
reference-recipe workload — including what it takes to hold the frame
cache at that scale (the actual ceiling).

Metrics reported:
  render_images_per_s   device render + foreground-sample throughput
  probe_evals_per_s     feature-probe evaluations/s across the level
                        sweep (each level reads every live sample twice —
                        min/max pass + histogram pass — at F features and
                        2 depth probes each; the V2 filter stage's sparse
                        reads are counted at their subsample rate)
  nodes_per_s           split decisions/s
  heldout_acc           per-pixel part accuracy on held-out renders
  per_part_recall       recall for each of the 24 parts on held-out data
  ref_recipe_*          extrapolation to 1M x 2000 x depth 20 x 129

Run (GPU):   python scripts/train_scale_report.py --images 2048
Run (CPU ~): python scripts/train_scale_report.py --cpu --images 96 \
                 --pixels 200 --features 64 --depth 8
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=2048)
    ap.add_argument("--pixels", type=int, default=1000)
    ap.add_argument("--features", type=int, default=512)
    ap.add_argument("--filtered", type=int, default=64,
                    help="V2 filter survivors per node (0 = single stage)")
    ap.add_argument("--depth", type=int, default=15)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, nargs=2, default=(256, 256),
                    metavar=("H", "W"))
    ap.add_argument("--heldout", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--save", default="",
                    help="also export the trained tree (.srtr) here")
    ap.add_argument("--json-out", default="data/train_scale.json")
    args = ap.parse_args()

    if args.cpu:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.perception.rtree import RTree
    from avatar_tpu.testing import synthetic_model
    from avatar_tpu.train import synth
    from avatar_tpu.train.forest import ForestTrainer

    H, W = args.size
    model = synthetic_model(detail=4)
    intrin = CameraIntrin(fx=0.43 * W, fy=0.43 * W, cx=W / 2, cy=H / 2)

    tr = ForestTrainer(
        model, intrin, (H, W), num_parts=24,
        num_images=args.images, num_points_per_image=args.pixels,
        num_features=args.features, num_features_filtered=args.filtered,
        max_tree_depth=args.depth, image_batch=args.batch,
        seed=11, verbose=True)

    # time the level sweep from outside _train_level (wall includes the
    # host-side split bookkeeping, which is honest: it is part of training)
    levels = []
    orig_level = tr._train_level

    def timed_level():
        t0 = time.time()
        live = int((tr.node_of >= 0).sum())
        n_nodes = len(tr.frontier)
        orig_level()
        levels.append({"level": tr.level, "nodes": n_nodes,
                       "live_samples": live,
                       "wall_s": round(time.time() - t0, 3)})

    tr._train_level = timed_level

    t_all = time.time()
    fd = tr.train()
    t_all = time.time() - t_all
    t_levels = sum(lv["wall_s"] for lv in levels)
    t_init = t_all - t_levels

    # probe-evaluation accounting (see module docstring)
    F_dense = args.filtered or args.features
    evals = 0.0
    for lv in levels:
        dense = lv["live_samples"] * F_dense * 2 * 2      # minmax + counts
        sparse = 0.0
        if args.filtered:
            sparse = (lv["live_samples"] * args.features * 2
                      / max(tr.filter_subsample, 1))
        evals += dense + sparse
    n_nodes_total = int(fd.lnode.shape[0])

    # --- held-out evaluation ------------------------------------------------
    rt = RTree(24)
    rt.set_forest(fd)
    rt.partmap_type = 0
    if args.save:
        rt.export_file(args.save)
    src = synth.make_source(model, intrin, None, None,
                            n_images=args.images + args.heldout, seed=11)
    ids = jnp.arange(args.images, args.images + args.heldout, dtype=jnp.int32)
    depth_b, mask_b, _ = synth.render_batch(
        src, model.parents, ids, 11, H, W, model.num_shape_keys())
    depth_b = np.asarray(depth_b)
    mask_b = np.asarray(mask_b)
    hits = np.zeros(24)
    gts = np.zeros(24)
    correct = total = 0
    for k in range(args.heldout):
        pred = rt.predict_best(depth_b[k])
        fg = mask_b[k] < 255
        pv = pred[fg]
        gv = mask_b[k][fg]
        correct += int((pv == gv).sum())
        total += int(fg.sum())
        for p in range(24):
            gts[p] += int((gv == p).sum())
            hits[p] += int(((gv == p) & (pv == p)).sum())
    recall = np.where(gts > 0, hits / np.maximum(gts, 1), np.nan)

    # --- extrapolation to the reference recipe -------------------------------
    # 1M images x 2000 px, depth 20, F=129 single-stage: per level every
    # live sample is read twice at 129 features x 2 probes.  Assume the
    # usual ~1/3 sample attrition per level after level ~8 (leaves absorb
    # samples); a conservative straight-line bound keeps ALL samples live
    # at every level.
    R_IMG, R_PX, R_DEPTH, R_F = 1_000_000, 2000, 20, 129
    ref_evals_bound = R_IMG * R_PX * R_DEPTH * R_F * 2 * 2
    rate = evals / max(t_levels, 1e-9)
    ref_train_h = ref_evals_bound / rate / 3600
    ref_render_h = R_IMG / (args.images / max(t_init, 1e-9)) / 3600
    # frame cache at uint16 mm (the trainer's native cache format)
    ref_cache_gb = R_IMG * H * W * 2 / 2**30

    report = {
        "platform": jax.devices()[0].platform,
        "scale": {"images": args.images, "pixels": args.pixels,
                  "features": args.features, "filtered": args.filtered,
                  "max_depth": args.depth, "image_size": [H, W]},
        "wall_s": round(t_all, 1),
        "init_render_s": round(t_init, 1),
        "levels_s": round(t_levels, 1),
        "render_images_per_s": round(args.images / max(t_init, 1e-9), 1),
        "probe_evals_per_s": round(rate, 0),
        "nodes_total": n_nodes_total,
        "nodes_per_s": round(n_nodes_total / max(t_levels, 1e-9), 1),
        "levels": levels,
        "heldout_acc": round(correct / max(total, 1), 4),
        "per_part_recall": [round(float(r), 3) if r == r else None
                            for r in recall],
        "ref_recipe": {
            "anchor": "1M imgs x 2000 px x depth 20 x 129 feats "
                      "(rtree-train.cpp:32-46)",
            "render_hours_one_chip": round(ref_render_h, 1),
            "train_hours_one_chip_upper_bound": round(ref_train_h, 1),
            "train_hours_8chip_psum": round(ref_train_h / 8, 1),
            "frame_cache_gb_uint16": round(ref_cache_gb, 1),
            "note": "cache exceeds one chip's HBM at 1M images: shard "
                    "frames over the mesh (parallel/training.py count-step "
                    "psum) or stream from a FileFrameSource",
        },
    }
    line = json.dumps(report, indent=1)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
