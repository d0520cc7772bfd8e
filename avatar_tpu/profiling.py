"""Device-stage profiling helpers (SURVEY §5.1).

The host-side StageTimer (utils.py) measures wall time per pipeline stage,
which conflates device compute with host dispatch and transfers.  These
helpers capture a jax.profiler device trace so device time is attributable
to the fused frame's named stages:

    from avatar_tpu.profiling import device_trace
    with device_trace("/tmp/trace"):          # view with xprof/tensorboard
        tracker.track(frame)

    stats = time_jitted(fn, *args)            # blocking per-call timing

The reference's equivalent is the printf timing scattered through
AvatarOptimizer.cpp (e.g. 1390-1393, 1486) — here a single context manager
produces a full kernel-level timeline instead.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Callable


@contextlib.contextmanager
def device_trace(log_dir: str, host_tracer_level: int = 2):
    """Capture a jax.profiler trace into ``log_dir`` (xprof format).

    View with ``tensorboard --logdir <log_dir>`` or the xprof UI.  Safe to
    nest around jitted calls; adds no overhead outside the context.
    """
    import jax

    opts = jax.profiler.ProfileOptions()
    opts.host_tracer_level = host_tracer_level
    jax.profiler.start_trace(log_dir, profiler_options=opts)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def trace_calls(fn: Callable, reps: int, scopes: dict | None = None) -> dict:
    """trace_attribution of ``reps`` back-to-back calls of ``fn()``, traced
    into a temporary directory that is removed afterwards.  One untraced
    call first keeps compilation out of the trace."""
    import shutil
    import tempfile

    import jax

    jax.block_until_ready(fn())
    tdir = tempfile.mkdtemp(prefix="avatar_trace_")
    try:
        with device_trace(tdir):
            for _ in range(reps):
                out = fn()
            jax.block_until_ready(out)
        return trace_attribution(tdir, reps, scopes or {})
    finally:
        shutil.rmtree(tdir, ignore_errors=True)


def nvidia_smi() -> str:
    """The cards' names and power limits as ``nvidia-smi`` reports them
    (one ``name, power.limit`` line per card).  A card set below its
    maximum runs slower under load, so device numbers are read beside
    this."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def time_jitted(fn: Callable, *args, iters: int = 20, warmup: int = 2,
                **kwargs) -> dict:
    """Time a jitted callable's device execution (blocking each call).

    Returns {"mean_ms", "min_ms", "p50_ms", "iters"}.  The first ``warmup``
    calls (compile + autotune) are excluded.
    """
    import jax
    import numpy as np

    for _ in range(warmup):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) * 1e3)
    arr = np.asarray(samples)
    return {"mean_ms": float(arr.mean()), "min_ms": float(arr.min()),
            "p50_ms": float(np.median(arr)), "iters": iters}


# Published dense peaks, keyed by JAX's ``device_kind`` (NVIDIA H100 SXM
# data sheet: rates at the 700 W power limit, without sparsity).  A card
# set below 700 W cannot hold them, so report its power limit beside any
# share of them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_flops=989e12, tf32_flops=495e12,
                                  fp32_flops=67e12,
                                  hbm_bytes_per_s=3.35e12),
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``.  A device missing from PEAKS is
    an error: no peak is assumed."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add them "
            "to profiling.PEAKS with their source") from None


def roofline_share(flops: float, nbytes: float, seconds: float,
                   device_kind: str) -> tuple:
    """(share, bound): the least time the card needs for ``flops`` fp32
    operations and ``nbytes`` of device-memory traffic, over ``seconds``,
    and which of the two bounds it ("fp32" or "hbm").  The program
    computes in fp32 (HIGHEST precision), so fp32 is the compute peak."""
    pk = device_peaks(device_kind)
    t_flops = flops / pk["fp32_flops"]
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    bound = "fp32" if t_flops >= t_bytes else "hbm"
    return max(t_flops, t_bytes) / seconds, bound


# ``op_name="..."`` of one instruction line in compiled (optimized) HLO
_HLO_OP = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
# a Triton custom call's GPU kernel is named after the Pallas kernel (its
# ``name``), not after the instruction
_TRITON_NAME = re.compile(r'xla\.gpu\.triton.*?\bname\W{1,6}(\w+)')

# named scopes of the fused frame (tracking_fused.py) -> stage bucket, in
# match order ("refine" and "fit" scopes both sit inside jit(fit) names)
_STAGES = (("refine", "refine"), ("fit", "fit"), ("forest_walk", "walk"),
           ("blob_suppress", "blob_cc"), ("bgsub", "bgsub"))


def hlo_op_scopes(hlo_text: str) -> dict:
    """{instruction name: op_name} from a compiled program's HLO text
    (``jax.jit(f).lower(...).compile().as_text()``).  GPU kernels are named
    after the fusion or instruction they run (with '.' and '-' turned into
    '_'), so this maps trace events back to the named scopes the program
    was traced under."""
    scopes = {}
    for line in hlo_text.splitlines():
        m = _HLO_OP.match(line)
        if m:
            scopes[m.group(1)] = m.group(2)
            scopes[re.sub(r"[.\-]", "_", m.group(1))] = m.group(2)
            k = _TRITON_NAME.search(line)
            if k:
                scopes[k.group(1)] = m.group(2)
    return scopes


def _stage(path: str) -> str:
    for key, bucket in _STAGES:
        if re.search(r"(^|/)" + key + r"(/|$)", path):
            return bucket
    return "frame_glue" if path else "other"


def _op_name(ev: dict, scopes: dict):
    """op_name of the HLO instruction a GPU trace event ran, or None."""
    args = ev.get("args") or {}
    if args.get("name"):            # events outside command buffers
        return args["name"]
    op = args.get("hlo_op")
    if op in scopes:                # copies, library calls by instruction
        return scopes[op]
    return scopes.get(ev.get("name", ""))   # kernels by their fusion name


def trace_attribution(log_dir: str, reps: int, scopes: dict) -> dict:
    """Per-frame device time of a jax.profiler trace, by stage.

    Reads the ``*.trace.json.gz`` files under ``log_dir`` and keeps the
    events of ``/device:GPU:N`` processes (one lane per CUDA stream; the
    events are kernels and copies).  Each event is bucketed by the named
    scope of the HLO instruction it runs: its own ``name`` argument where
    the profiler gives one, else the instruction or kernel name looked up
    in ``scopes`` (from hlo_op_scopes).  A library kernel inside a command
    buffer (a cuBLAS gemm, say) names no instruction; its stage is guessed
    as that of the kernel before it in the same CUDA graph, and its time
    goes to a bucket of its own, that stage with a "?" ("fit?"), so a guess
    never mixes with a reading.  Events with no stage land in "other".
    ``total_ms`` is the union of busy intervals per device, so overlapping
    streams are not counted twice.

    Returns {"total_ms": per-frame device busy ms, "stages": {bucket: ms}}.
    Raises ValueError when the trace holds no GPU device events.
    """
    import glob
    import gzip
    import json
    import os
    from collections import defaultdict

    files = glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                      recursive=True)
    stages = defaultdict(float)
    total = 0.0
    n_events = 0
    for f in files:
        with gzip.open(f, "rt") as fh:
            data = json.load(fh)
        gpu_pids = {
            ev["pid"] for ev in data.get("traceEvents", [])
            if ev.get("ph") == "M" and ev.get("name") == "process_name"
            and re.match(r"/device:GPU:\d+", ev["args"].get("name", ""))}
        lanes = defaultdict(list)
        for ev in data.get("traceEvents", []):
            if ev.get("ph") == "X" and ev.get("pid") in gpu_pids:
                lanes[(ev["pid"], ev.get("tid"))].append(ev)
        per_dev = defaultdict(list)
        for (pid, _), evs in lanes.items():
            evs.sort(key=lambda e: float(e["ts"]))
            graph_stage = (None, "other")   # last named kernel's graph
            for ev in evs:
                n_events += 1
                dur = float(ev.get("dur", 0.0))
                per_dev[pid].append((float(ev["ts"]), dur))
                graph = (ev.get("args") or {}).get("cuda_graph_id")
                path = _op_name(ev, scopes)
                if path is not None:
                    stage = _stage(path)
                    graph_stage = (graph, stage)
                elif graph is not None and graph == graph_stage[0]:
                    stage = graph_stage[1] + "?"
                else:
                    stage = "other"
                stages[stage] += dur / 1e3
        for spans in per_dev.values():
            spans.sort()
            end = -1.0
            for ts, dur in spans:      # union of busy intervals
                if ts + dur > end:
                    total += (ts + dur - max(ts, end)) / 1e3
                    end = ts + dur
    if not n_events:
        raise ValueError(f"no GPU device events in the trace under {log_dir}")
    reps = max(reps, 1)
    return {
        "total_ms": round(total / reps, 4),
        "stages": {k: round(v / reps, 4)
                   for k, v in sorted(stages.items(), key=lambda x: -x[1])},
    }
