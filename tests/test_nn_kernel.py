"""The part-ranged NN kernel's wrapper: route choice, GPU lowering, batching.

The kernel's arithmetic is checked in interpret mode against the float64
oracle in test_optimizer.py; these tests cover what surrounds it on the CPU
(which search each backend gets, that the GPU program really contains the
Triton kernel call) and, on a GPU only, the compiled kernel itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avatar_tpu.optim import correspond
from avatar_tpu.optim.nn_pallas import UNMATCHABLE, nn_argmin_ranges

TRITON_CALL = "xla.gpu.triton"


def _clouds(rng, N=256, P=300, num_parts=6):
    model_cloud = rng.normal(size=(P, 3)).astype(np.float32)
    model_part = np.sort(rng.integers(0, num_parts, P)).astype(np.int32)
    visible = rng.random(P) < 0.7
    data = rng.normal(size=(N, 3)).astype(np.float32)
    data_part = np.full(N, -1, np.int32)
    data_part[:200] = rng.integers(0, num_parts, 200)
    return data, data_part, model_cloud, model_part, visible, num_parts


@pytest.mark.parametrize("backend,route", [("cpu", "xla"),
                                           ("gpu", "triton")])
def test_nn_route_by_backend(backend, route):
    assert correspond.nn_route(backend) == route


@pytest.mark.parametrize("backend", ["rocm", "metal", "neuron"])
def test_nn_route_unknown_backend_is_an_error(backend):
    with pytest.raises(ValueError, match=backend):
        correspond.nn_route(backend)


def test_nn_route_default_is_this_backend():
    assert jax.default_backend() == "cpu"
    assert correspond.nn_route() == "xla"


def test_kernel_lowers_to_triton_for_cuda(rng):
    """Cross-lowered for CUDA on the CPU, the kernel is one Triton custom
    call carrying its name (what the GPU compiler receives)."""
    data, data_part, cloud, part, vis, num_parts = _clouds(rng)
    plan = correspond.make_nn_plan(
        jnp.asarray(data), jnp.asarray(data_part), jnp.asarray(part),
        num_parts=num_parts, model_sorted=True)
    f = jax.jit(lambda x, v: correspond.find_nn_stats_planned(
        plan, x, v, wild=num_parts).corr)
    txt = f.trace(jnp.asarray(cloud), jnp.asarray(vis)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert txt.count(TRITON_CALL) == 1
    assert "nn_argmin_ranges" in txt


def test_fit_gpu_program_runs_the_kernel():
    """With the route the GPU backend chooses, the fit's program for CUDA
    contains the Triton kernel call; with the CPU route it does not."""
    from avatar_tpu.optim.gauss_newton import FitContext, PriorData, Theta, fit
    from avatar_tpu.testing import synthetic_model

    model = synthetic_model(detail=1)
    ctx = FitContext(
        lbs=model.params,
        anc_mask=jnp.asarray(model.ancestor_mask, jnp.float32),
        faces=jnp.asarray(model.faces, jnp.int32),
        model_part=jnp.asarray(model.main_joint, jnp.int32),
        prior=PriorData(model.pose_prior.means, model.pose_prior.prec_cho,
                        model.pose_prior.consts_log))
    theta = Theta(p=jnp.asarray([0.0, 0.0, 2.5]),
                  rots=jnp.tile(jnp.eye(3), (24, 1, 1)),
                  w=jnp.zeros(model.num_shape_keys()))
    pts = jnp.zeros((1024, 3))
    parts = jnp.full((1024,), -1, jnp.int32).at[:500].set(3)

    def program_text():
        return fit.trace(ctx, model.parents, pts, parts, theta,
                         jnp.asarray(0.05), jnp.asarray(0.12),
                         n_steps=2).lower(
            lowering_platforms=("cuda",)).as_text()

    assert TRITON_CALL not in program_text()
    chosen = correspond.nn_route
    try:
        correspond.nn_route = lambda backend=None: "triton"
        jax.clear_caches()   # the route is read while tracing
        assert TRITON_CALL in program_text()
    finally:
        correspond.nn_route = chosen
        jax.clear_caches()   # no later test may reuse the GPU-route trace


def test_planned_search_under_vmap(rng):
    """The sharded multi-stream step vmaps the fit: the kernel's batching
    rule (an extra grid axis) must give each stream its own result."""
    data, data_part, cloud, part, vis, num_parts = _clouds(rng)
    clouds = np.stack([cloud, cloud + 0.05, cloud[::-1].copy()])
    plan = correspond.make_nn_plan(
        jnp.asarray(data), jnp.asarray(data_part), jnp.asarray(part),
        num_parts=num_parts, tile_n=32, chunk=64, model_sorted=True)

    def one(x):
        return correspond.find_nn_stats_planned(
            plan, x, jnp.asarray(vis), interpret=True).corr

    batched = np.asarray(jax.vmap(one)(jnp.asarray(clouds)))
    for b in range(len(clouds)):
        np.testing.assert_array_equal(batched[b],
                                      np.asarray(one(jnp.asarray(clouds[b]))))


@pytest.mark.parametrize("tile_n,chunk", [(32, 64), (64, 128)])
def test_kernel_ranges_skip_foreign_chunks(rng, tile_n, chunk):
    """A tile scans only [cstart, cend): a wrong range is visible (no
    candidate, -1), the plan's range finds every same-part candidate."""
    data, data_part, cloud, part, vis, num_parts = _clouds(rng, N=256,
                                                           P=512)
    plan = correspond.make_nn_plan(
        jnp.asarray(data), jnp.asarray(data_part), jnp.asarray(part),
        num_parts=num_parts, tile_n=tile_n, chunk=chunk, model_sorted=True)
    mpart = jnp.where(jnp.asarray(vis), plan.mpart_s, UNMATCHABLE)
    args = (plan.dpts, plan.dpart, jnp.asarray(cloud), mpart)
    _, bi = nn_argmin_ranges(*args, plan.cstart, plan.cend, tile_n=tile_n,
                             chunk=chunk, interpret=True)
    _, bi0 = nn_argmin_ranges(*args, plan.cstart, plan.cstart,
                              tile_n=tile_n, chunk=chunk, interpret=True)
    assert (np.asarray(bi0) == -1).all()
    bi = np.asarray(bi)
    dp = np.asarray(plan.dpart)
    has_cand = np.array([(dp[n] >= 0) and (vis & (part == dp[n])).any()
                         for n in range(len(dp))])
    np.testing.assert_array_equal(bi >= 0, has_cand)
    assert (part[bi[bi >= 0]] == dp[bi >= 0]).all()


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(rng):
    """The compiled kernel (no interpret mode) against the plain XLA search
    on the card; chip_smoke.py runs the same check at production widths."""
    data, data_part, cloud, part, vis, num_parts = _clouds(rng, N=1024,
                                                           P=2048)
    plan = correspond.make_nn_plan(
        jnp.asarray(data), jnp.asarray(data_part), jnp.asarray(part),
        num_parts=num_parts, model_sorted=True)
    got = correspond.find_nn_stats_planned(plan, jnp.asarray(cloud),
                                           jnp.asarray(vis))
    ref = correspond.find_nn_stats(plan.dpts, plan.dpart, jnp.asarray(cloud),
                                   jnp.asarray(part), jnp.asarray(vis))
    np.testing.assert_array_equal(np.asarray(got.corr) >= 0,
                                  np.asarray(ref.corr) >= 0)
    assert (np.asarray(got.corr) == np.asarray(ref.corr)).mean() > 0.999
