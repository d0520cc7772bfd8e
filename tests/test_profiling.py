"""Device profiling helpers, the compile-cache placement, and the entry
points' refusal to report device numbers off a GPU."""

import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile

import jax
import pytest

from avatar_tpu import profiling, utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def test_peaks_of_the_h100():
    pk = profiling.device_peaks(H100)
    assert pk == dict(bf16_flops=989e12, tf32_flops=495e12,
                      fp32_flops=67e12, hbm_bytes_per_s=3.35e12)


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X",
                                  "NVIDIA A100-SXM4"])
def test_peaks_of_an_unknown_device_are_an_error(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.device_peaks(kind)


def test_roofline_share_names_its_bound():
    # 67 GFLOP at 67 TFLOP/s takes 1 ms: half the roofline in 2 ms
    share, bound = profiling.roofline_share(67e9, 1e3, 2e-3, H100)
    assert bound == "fp32" and share == pytest.approx(0.5)
    # 3.35 GB at 3.35 TB/s takes 1 ms
    share, bound = profiling.roofline_share(1.0, 3.35e9, 1e-3, H100)
    assert bound == "hbm" and share == pytest.approx(1.0)


HLO = """\
HloModule jit_fused_frame, entry_computation_layout={()->f32[]}

%fused_computation (p0: f32[8]) -> f32[8] {
  ROOT %m = f32[8]{0} multiply(f32[8]{0} %p0, f32[8]{0} %p0)
}

ENTRY %main.1 () -> f32[] {
  %loop_multiply_fusion = f32[8]{0} fusion(), kind=kLoop, calls=%fc, metadata={op_name="jit(fused_frame)/bgsub/mul" source_file="bgsub.py" source_line=3}
  %input_reduce_fusion.2 = f32[] fusion(), kind=kInput, calls=%fr, metadata={op_name="jit(fused_frame)/fit/while/body/reduce_min" source_file="correspond.py"}
  %triton_nn = (f32[8]{0}, s32[8]{0}) custom-call(), custom_call_target="__gpu$xla.gpu.triton", metadata={op_name="jit(fused_frame)/fit/while/body/pallas_call"}, backend_config={"name":"nn_argmin_ranges","num_warps":4}
  fusion.7 = f32[8]{0} fusion(), kind=kLoop, calls=%f7, metadata={op_name="jit(fused_frame)/forest_walk/gather"}
  ROOT %copy.3 = f32[] copy(f32[] %input_reduce_fusion.2), metadata={op_name="jit(fused_frame)/concatenate"}
}
"""


def test_hlo_op_scopes_reads_instruction_names():
    scopes = profiling.hlo_op_scopes(HLO)
    assert scopes["loop_multiply_fusion"] == "jit(fused_frame)/bgsub/mul"
    assert scopes["input_reduce_fusion.2"].endswith("reduce_min")
    assert scopes["fusion.7"] == "jit(fused_frame)/forest_walk/gather"
    assert scopes["copy.3"] == "jit(fused_frame)/concatenate"
    # the Triton kernel is found under its own name, and GPU kernel names
    # ('.' -> '_') find their instruction
    assert scopes["nn_argmin_ranges"] == scopes["triton_nn"]
    assert scopes["input_reduce_fusion_2"] == scopes["input_reduce_fusion.2"]


def _write_trace(tmp_path, events, processes):
    """A trace.json.gz shaped like jax.profiler's on a GPU machine: one
    process per device plane, one thread per CUDA stream."""
    meta = []
    for pid, name in processes.items():
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "args": {"name": name}})
    meta.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": 13,
                 "args": {"name": "Stream #13(Compute,MemcpyD2D)"}})
    meta.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": 14,
                 "args": {"name": "Stream #14(MemcpyH2D)"}})
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": meta + events}, f)


def _ev(pid, tid, kernel, ts, dur, graph=None, **args):
    """A kernel run by a command buffer (CUDA graph ``graph``), or with
    ``hlo_op``/``name`` arguments, one run on its own."""
    a = {"hlo_module": "jit_fused_frame", "hlo_op": "command_buffer"}
    if graph is not None:
        a["cuda_graph_id"] = graph
    a.update(args)
    return {"ph": "X", "pid": pid, "tid": tid, "name": kernel, "ts": ts,
            "dur": dur, "args": a}


def test_trace_attribution_on_a_gpu_trace(tmp_path):
    events = [
        # two frames (reps=2) on stream 13, a copy overlapping on stream 14
        _ev(1, 13, "loop_multiply_fusion", 0.0, 100.0),     # bgsub
        _ev(1, 13, "nn_argmin_ranges", 100.0, 300.0),       # fit (kernel)
        _ev(1, 13, "input_reduce_fusion_2", 400.0, 200.0),  # fit
        _ev(1, 13, "fusion_7", 600.0, 100.0),               # walk
        _ev(1, 13, "sm90_xmma_gemm_f32f32", 700.0, 50.0),   # other
        _ev(1, 14, "memcpy32_post", 650.0, 150.0),          # overlaps
        _ev(1, 13, "loop_multiply_fusion", 1000.0, 100.0),
        _ev(1, 13, "input_reduce_fusion.2", 1100.0, 500.0),
        # a host event: not device time
        _ev(2, 1, "PjitFunction(fused_frame)", 0.0, 5000.0),
    ]
    _write_trace(tmp_path, events, {1: "/device:GPU:0", 2: "/host:CPU"})
    scopes = profiling.hlo_op_scopes(HLO)
    att = profiling.trace_attribution(str(tmp_path), 2, scopes)
    # busy = [0, 800) + [1000, 1600) = 1400 us over 2 frames
    assert att["total_ms"] == pytest.approx(0.7)
    st = att["stages"]
    assert st["fit"] == pytest.approx((300 + 200 + 500) / 2e3)
    assert st["bgsub"] == pytest.approx(0.1)
    assert st["walk"] == pytest.approx(0.05)
    assert st["other"] == pytest.approx((50 + 150) / 2e3)
    assert list(st)[0] == "fit"          # sorted by time
    assert not [k for k in st if k.endswith("?")]   # nothing guessed


def test_trace_attribution_stages_unnamed_kernels_by_their_graph(tmp_path):
    events = [
        # CUDA graph 7: a cuBLAS gemm after a fit kernel takes its stage
        _ev(1, 13, "loop_multiply_fusion", 0.0, 100.0, graph="7"),   # bgsub
        _ev(1, 13, "nn_argmin_ranges", 100.0, 300.0, graph="7"),     # fit
        _ev(1, 13, "sm80_xmma_gemm_f32f32", 400.0, 250.0, graph="7"),
        # a library call outside any graph, named by the profiler
        _ev(1, 13, "getrf_kernel", 650.0, 50.0, hlo_op="cholesky.3",
            name="jit(fused_frame)/fit/while/body/cholesky"),
        # a copy named by its instruction
        _ev(1, 13, "MemcpyD2D", 700.0, 20.0, hlo_op="fusion.7"),     # walk
        # a gemm first in its graph: nothing to take a stage from
        _ev(1, 13, "sm80_xmma_gemm_f32f32", 800.0, 40.0, graph="8"),
    ]
    _write_trace(tmp_path, events, {1: "/device:GPU:0"})
    att = profiling.trace_attribution(str(tmp_path), 1,
                                      profiling.hlo_op_scopes(HLO))
    st = att["stages"]
    # read from op names, and guessed from the graph neighbour, kept apart
    assert st["fit"] == pytest.approx((300 + 50) / 1e3)
    assert st["fit?"] == pytest.approx(0.25)
    assert st["bgsub"] == pytest.approx(0.1)
    assert st["walk"] == pytest.approx(0.02)
    assert st["other"] == pytest.approx(0.04)
    assert sum(st.values()) == pytest.approx(att["total_ms"])


def test_trace_attribution_without_gpu_events_is_an_error(tmp_path):
    _write_trace(tmp_path, [_ev(2, 1, "PjitFunction(f)", 0.0, 10.0)],
                 {1: "/device:GPU:0", 2: "/host:CPU"})
    with pytest.raises(ValueError, match="no GPU device events"):
        profiling.trace_attribution(str(tmp_path), 1, {})


def test_trace_calls_off_a_gpu_is_an_error(tmp_path, monkeypatch):
    """A CPU trace holds no GPU device events: trace_calls raises instead
    of reporting a device time, and removes its trace directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    calls = []
    f = jax.jit(lambda x: x * 2.0)

    def fn():
        calls.append(1)
        return f(jax.numpy.ones(8))

    with pytest.raises(ValueError, match="no GPU device events"):
        profiling.trace_calls(fn, 3)
    assert len(calls) == 4          # one untraced call, then three traced
    assert os.listdir(tmp_path) == []


@pytest.fixture()
def cache_dir_restored():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, cache_dir_restored):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    jax.config.update("jax_compilation_cache_dir", None)
    assert utils.enable_compile_cache() == "/elsewhere/cache"
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_inside_the_checkout(monkeypatch,
                                                    cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = utils.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


def _run(args, cwd):
    return subprocess.run([sys.executable] + args, cwd=cwd, env=_cpu_env(),
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_to_run_without_a_gpu():
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_to_run_without_a_gpu():
    r = _run(["bench.py"], REPO)
    assert r.returncode == 2
    assert "no GPU" in r.stderr
    assert r.stdout == ""
