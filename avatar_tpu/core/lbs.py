"""Linear-blend-skinning forward pass as a pure jitted function.

This is the jitted rebuild of ``Avatar::update`` (reference Avatar.cpp:22-75):

  1. shape keys:      shaped   = v_template + shapedirs . w          (einsum)
  2. joint regress:   j_init   = j_base + j_shape_reg . w  (or J_reg . shaped)
  3. forward kinematics over the 24-joint kinematic tree — unrolled at trace
     time (parents are static), 3x3 matrix chains
  4. skinning:        x_p = sum_j W[p,j] (Rg_j (shaped_p - j_init_j) + t_j)
     regrouped as  x_p = A_p shaped_p + b_p  with A = W . Rg (one matmul)

Reference semantics preserved exactly:
  * The root joint's global translation is the avatar position ``p`` itself
    ("root position at center (non-standard!)", Avatar.cpp:49) — i.e. the
    pelvis joint lands exactly at ``p`` regardless of shape.
  * Joint positions returned are the *posed* joint positions (reference
    rebases jointPos in the same pass, Avatar.cpp:59-64).

Everything takes/returns row-major arrays: verts [P,3], joints [J,3],
rotations [J,3,3].  vmap over a leading batch axis for batched synthesis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# All LBS contractions are tiny (P x 24 x 9 at most); run them at full f32
# precision — reduced-precision passes (bf16, TF32) cost ~1 mm of vertex
# accuracy, which would alone consume the <1 mm end-to-end RMSE budget.
_HI = jax.lax.Precision.HIGHEST


class LBSParams(NamedTuple):
    """Static per-model tensors consumed by the LBS kernel (a frozen pytree).

    Mirrors the data members of reference ``AvatarModel`` (Avatar.h:64-151)
    with sparse matrices densified (J=24 makes dense strictly better here).
    """

    v_template: jnp.ndarray        # [P, 3]   baseCloud
    shapedirs: jnp.ndarray         # [P, 3, K] keyClouds
    weights: jnp.ndarray           # [P, J]   LBS weights (dense)
    joint_reg: jnp.ndarray         # [J, P]   SMPL joint regressor (dense)
    joint_shape_reg_base: jnp.ndarray  # [J, 3] jointShapeRegBase
    joint_shape_reg: jnp.ndarray   # [J, 3, K] jointShapeReg


def shape_fwd(params: LBSParams, w: jnp.ndarray, use_jsr: bool = True
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Apply shape keys: returns (shaped verts [P,3], rest joints [J,3]).

    Reference Avatar.cpp:26-39 / AvatarOptimizer.cpp:249-267 (CalcShape).
    """
    shaped = params.v_template + jnp.einsum(
        "pck,k->pc", params.shapedirs, w, precision=_HI)
    if use_jsr:
        j_init = params.joint_shape_reg_base + jnp.einsum(
            "jck,k->jc", params.joint_shape_reg, w, precision=_HI)
    else:
        j_init = jnp.einsum("jp,pc->jc", params.joint_reg, shaped,
                            precision=_HI)
    return shaped, j_init


def shaped_dtype(params: LBSParams):
    return params.v_template.dtype


@functools.lru_cache(maxsize=32)
def _lifting_pointers(parents: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """Pointer-doubling tables for batched forward kinematics.

    Invariant: after round k, joint j's accumulated affine covers the chain
    segment [j, ptr_k[j]) and ptr_{k+1}[j] = ptr_k[ptr_k[j]].  Slot J is the
    identity sentinel (covers nothing, points to itself); the root's pointer
    starts at the sentinel since its own transform is already included.
    Returns the per-round pointer arrays (static data), enough rounds to
    cover the deepest chain.
    """
    J = len(parents)
    ptr = [J] + [0] * (J - 1) + [J]   # ptr[0] = sentinel; ptr[J] = sentinel
    for j in range(1, J):
        ptr[j] = parents[j]
    rounds = []
    while any(ptr[j] != J for j in range(J)):
        rounds.append(tuple(ptr[:J]))
        ptr = [ptr[ptr[j]] if ptr[j] != J else J for j in range(J)] + [J]
    return tuple(rounds)


def fk(parents: Tuple[int, ...], rots: jnp.ndarray, p: jnp.ndarray,
       j_init: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward kinematics along the (static) kinematic tree.

    Args:
      parents: static tuple, parents[0] == -1, topologically sorted.
      rots:   [J, 3, 3] local joint rotations.
      p:      [3] root position (becomes the pelvis joint's global position).
      j_init: [J, 3] rest joint positions (shape applied).

    Returns (Rg [J,3,3] global rotations, tg [J,3] posed joint positions).
    Reference Avatar.cpp:43-64 composes 23 affines sequentially; on a device
    that lowers to 23 serialized tiny matmuls, each a kernel launch, so we
    compose by *pointer doubling* instead:
    ceil(log2(max chain length)) = 4 batched [J+1,3,3] matmul rounds.
    Everything stays at full f32 precision — bf16 chains accumulate ~1.6%
    orthogonality error, which breaks the optimizer's retraction frames.
    """
    J = len(parents)
    dtype = rots.dtype
    # local affine per joint (root: rots[0], p — pelvis lands exactly at p)
    t_local = j_init - j_init[jnp.asarray(
        [parents[i] if parents[i] >= 0 else i for i in range(J)])]
    t_local = t_local.at[0].set(p)
    # append the identity sentinel slot
    R = jnp.concatenate([rots, jnp.eye(3, dtype=dtype)[None]], axis=0)
    t = jnp.concatenate([t_local, jnp.zeros((1, 3), dtype)], axis=0)
    for ptr in _lifting_pointers(parents):
        a = jnp.asarray(ptr + (J,), jnp.int32)   # sentinel keeps pointing J
        Ra = R[a]
        ta = t[a]
        R = jnp.einsum("jab,jbc->jac", Ra, R, precision=_HI)
        t = jnp.einsum("jab,jb->ja", Ra, t, precision=_HI) + ta
    return R[:J], t[:J]


@functools.partial(jax.jit, static_argnames=("parents", "use_jsr"))
def lbs(params: LBSParams, parents: Tuple[int, ...], w: jnp.ndarray,
        p: jnp.ndarray, rots: jnp.ndarray, use_jsr: bool = True):
    """Full LBS forward: (w, p, R[J]) -> (cloud [P,3], joints [J,3], Rg, j_init).

    Equivalent to reference ``Avatar::update`` (Avatar.cpp:22-75); the
    0.3-0.6 ms CPU pass becomes a handful of fused einsums.
    """
    shaped, j_init = shape_fwd(params, w, use_jsr)
    Rg, tg = fk(parents, rots, p, j_init)
    # x_p = sum_j W[p,j] (Rg_j (shaped_p - j_init_j) + tg_j)
    #     = (sum_j W[p,j] Rg_j) shaped_p + sum_j W[p,j] (tg_j - Rg_j j_init_j)
    J = len(parents)
    Rg_flat = Rg.reshape(J, 9)
    A = jnp.einsum("pj,jk->pk", params.weights, Rg_flat,
                   precision=_HI).reshape(-1, 3, 3)            # [P,3,3]
    t_eff = tg - jnp.einsum("jab,jb->ja", Rg, j_init, precision=_HI)  # [J,3]
    b = jnp.einsum("pj,jc->pc", params.weights, t_eff, precision=_HI)  # [P,3]
    cloud = jnp.einsum("pab,pb->pa", A, shaped, precision=_HI) + b
    return cloud, tg, Rg, j_init


def lbs_batched(params: LBSParams, parents: Tuple[int, ...], w, p, rots,
                use_jsr: bool = True):
    """vmapped LBS over leading batch axis of (w, p, rots)."""
    fn = lambda w_, p_, r_: lbs(params, parents, w_, p_, r_, use_jsr)
    return jax.vmap(fn)(w, p, rots)
