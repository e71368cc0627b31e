"""The port's C++ substructure library (multimodal_particles_tpu_torch/native)
against the JAX package's library and both packages' numpy versions on the
CPU, and against the analytic and frozen goldens of
tests/test_data/test_substructure.py.

Tolerances: the port's library and the JAX package's compute each jet with
the same arithmetic, so they agree exactly (also when the port splits a
large batch over threads); against the numpy versions rtol 1e-6 (atol 1e-9),
the bound the JAX tests hold their library to
(tests/test_data/test_substructure.py:34-42).
"""

import importlib.util
import os

import numpy as np
import pytest

from multimodal_particles_tpu.data.particle_clouds import substructure as jax_substructure
from multimodal_particles_tpu.native import substructure_batch_native as jax_native
from multimodal_particles_tpu_torch import native
from multimodal_particles_tpu_torch.data.particle_clouds import jets, particles, substructure

KEYS = ("tau1", "tau2", "tau3", "tau21", "tau32", "d2")
RTOL, ATOL = 1e-6, 1e-9

_spec = importlib.util.spec_from_file_location(
    "jax_substructure_goldens",
    os.path.join(os.path.dirname(__file__), "test_data", "test_substructure.py"))
goldens = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(goldens)


def test_library_builds_from_the_source_into_the_ignored_build_dir():
    lib = native.load_substructure_lib()
    assert lib is not None, "g++ build of the port's substructure library failed"
    path = native.build_library()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.stat().st_mtime >= native.SRC.stat().st_mtime
    with open(os.path.join(os.path.dirname(__file__), "..", ".gitignore")) as f:
        assert "multimodal_particles_tpu_torch/native/build/" in f.read().split()


@pytest.mark.parametrize("B", [20, 1200])  # 1200 jets: the batch split over threads
def test_library_matches_the_jax_library_exactly(B):
    pt, eta, phi, mask = goldens._random_jets(B=B, N=64, seed=B)
    got = native.substructure_batch_native(pt, eta, phi, mask)
    ref = jax_native(pt, eta, phi, mask)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    for key in ("tau1", "tau2", "tau3", "d2"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_library_takes_non_finite_kinematics():
    """Generated jets of an undertrained model can carry inf and NaN: no pair
    of constituents then has a finite kt distance, the clustering stops with
    more subjets than axes, and the library wrote past its axes (a heap
    overrun that aborted the process). Now such a jet's τ is NaN and the
    other jets hold the JAX library's bits."""
    pt, eta, phi, mask = goldens._random_jets(B=6, N=32, seed=3)
    eta[2, :] = np.inf
    phi[4, :] = np.nan
    got = native.substructure_batch_native(pt, eta, phi, mask)
    assert np.isnan(got["tau1"][[2, 4]]).all() and np.isnan(got["tau3"][[2, 4]]).all()
    finite = [0, 1, 3, 5]
    ref = jax_native(pt[finite], eta[finite], phi[finite], mask[finite])
    for key in ("tau1", "tau2", "tau3", "d2"):
        np.testing.assert_array_equal(got[key][finite], ref[key], err_msg=key)


def test_native_matches_both_numpy_versions():
    pt, eta, phi, mask = goldens._random_jets()
    mask[3, 2:] = 0  # a jet below min_constituents
    got = substructure.substructure_observables(pt, eta, phi, mask)
    numpy_port = substructure.substructure_observables(pt, eta, phi, mask, use_native=False)
    numpy_jax = jax_substructure.substructure_observables(pt, eta, phi, mask, use_native=False)
    assert got["native"] and not numpy_port["native"]
    assert not got["selection"][3]
    for ref in (numpy_port, numpy_jax):
        np.testing.assert_array_equal(got["selection"], ref["selection"])
        for key in KEYS:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=ATOL, err_msg=key)
    raw = native.substructure_batch_native(pt, eta, phi, mask)
    np.testing.assert_array_equal(raw["valid"], got["selection"])


def test_without_the_library_the_numpy_version_runs_and_says_so(monkeypatch):
    pt, eta, phi, mask = goldens._random_jets(B=6)
    cloud = particles.ParticleClouds(np.stack([pt, eta, phi, mask], axis=-1))
    assert jets.JetClassHighLevelFeatures(cloud).substructure_native is True
    monkeypatch.setattr(substructure, "substructure_batch_native", lambda *a, **k: None)
    assert jets.JetClassHighLevelFeatures(cloud).substructure_native is False
    got = substructure.substructure_observables(pt, eta, phi, mask)
    ref = jax_substructure.substructure_observables(pt, eta, phi, mask, use_native=False)
    assert got["native"] is False
    for key in KEYS:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12, err_msg=key)


def test_library_refuses_mismatched_shapes():
    pt, eta, phi, mask = goldens._random_jets(B=4)
    with pytest.raises(ValueError):
        native.substructure_batch_native(pt, eta[:, :10], phi, mask)


def _analytic_case():
    """tests/test_data/test_substructure.py::test_analytic_three_particle_goldens:
    pts (2, 1, 1) at (η, φ) = (0, 0), (0, 0.6), (0.6, 0); hand-derived."""
    pt = np.array([[2.0, 1.0, 1.0]])
    eta = np.array([[0.0, 0.0, 0.6]])
    phi = np.array([[0.0, 0.6, 0.0]])
    expected = {"tau1": [0.4318637065371404], "tau2": [0.24914094871353507],
                "d2": [1.1405617953974279]}
    return (pt, eta, phi, np.ones((1, 3), np.int64)), expected, None


def _frozen_case():
    """tests/test_data/test_substructure.py::test_frozen_batch_goldens: the
    first five jets and the batch mean of each observable."""
    return goldens._random_jets(), goldens._BATCH_GOLDENS, goldens._BATCH_GOLDEN_MEANS


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("case", [_analytic_case, _frozen_case], ids=["analytic", "frozen"])
def test_goldens(case, use_native):
    """The JAX tests' goldens, at their tolerances: 1e-9 (native) / 1e-12
    (numpy) for the analytic jet, 1e-6 / 1e-10 for the frozen batch."""
    (pt, eta, phi, mask), expected, means = case()
    obs = substructure.substructure_observables(pt, eta, phi, mask, use_native=use_native)
    assert obs["native"] is use_native
    assert obs["selection"].all()
    if means is None:
        rtol = 1e-9 if use_native else 1e-12
    else:
        rtol = 1e-6 if use_native else 1e-10
    for key, values in expected.items():
        np.testing.assert_allclose(obs[key][: len(values)], values, rtol=rtol, err_msg=key)
        if means is not None:
            np.testing.assert_allclose(float(np.nanmean(obs[key])), means[key], rtol=rtol,
                                       err_msg=f"mean {key}")
