"""tests/test_torch_diff.py's checks of the port's differentiable rendering
against `mcpt_tpu/diff.py`, on the DEMO Cornell box (32 triangles, 3
spheres, glass and rough dielectrics) at 8x8, spp 2, mb 3, with that
module's bounds. A module of its own: its JAX side costs a minute.
"""

import dataclasses

import pytest
from test_torch_diff import (  # noqa: F401 (one_thread is an autouse fixture)
    Reference,
    check_against_jax,
    check_hybrid_step,
    check_train_step,
    one_thread,
)

import mcpt_tpu.builtin_scenes as JB


@pytest.fixture(scope="module")
def ref():
    sc = JB.demo_scene()
    return Reference(sc, dataclasses.replace(sc.camera, width=8, height=8), seed=4)


@pytest.mark.parametrize("method", ["dense", "kernel"])
def test_gradients_match_jax(ref, method):
    check_against_jax(ref, method)


def test_train_step_matches_optax(ref):
    check_train_step(ref)


def test_hybrid_step_matches_jax_vjp(ref):
    check_hybrid_step(ref)
