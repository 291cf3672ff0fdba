"""PyTorch port, the engine's knob variants through whole layers: each
`TNQS_*` route that `tests/test_torch_slice.py` does not reach, in
complex128 against the JAX package with the same knob set.  Both sides run
the same algorithm in double on the CPU, so ⟨Z⟩ and the truncation errors
agree to 1e-8."""

import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from test_torch_slice import _KNOBS, _Z, _run_jax, _run_torch, _tfim_layer

torch.set_num_threads(1)
_BAND = 1e-4  # max site |Δ⟨Z⟩| of the fast stack (bench.py:166-175)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


_VARIANTS = {
    "qr_defer": {"TNQS_QR_ALG": "defer"},
    "qr_cholqr1": {"TNQS_QR_ALG": "cholqr1"},
    "qr_polar": {"TNQS_QR_ALG": "polar"},
    "svd_gram": {"TNQS_SVD_ALG": "gram"},
    "per_bucket": {"TNQS_FUSE_BUCKETS": "0"},
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_knob_variant_matches_jax_complex128(variant, monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in _VARIANTS[variant].items():
        monkeypatch.setenv(k, v)
    z_j, e_j = _run_jax("kicked_heavyhex2x2", np.complex128, 2, 1e-12)
    z_t, e_t = _run_torch("kicked_heavyhex2x2", torch.complex128, 2, 1e-12)
    np.testing.assert_allclose(z_t, z_j, atol=1e-8)
    np.testing.assert_allclose(e_t, e_j, atol=1e-8)



def _chi6_trajectory(pkg, graphs, lattices, dtype):
    """examples/ising_2d_dynamics.py at χ=6: every site's ⟨Z⟩ after its 20
    layers on the 5×5 grid (complex64, cutoff 1e-10, BP at its defaults),
    through ``pkg``'s batched engine."""
    g = lattices.named_grid((5, 5))
    spec, state = pkg.batched_product_state(g, chi=6, dtype=dtype)
    layer_fn = pkg.make_layer_fn(
        pkg.BatchedCircuit(_tfim_layer(graphs, g), g, spec=spec), chi=6,
        cutoff=1e-10)
    for _ in range(20):
        state, _ = layer_fn(state)
    return np.real(np.asarray(pkg.local_expectations(spec, state, _Z)))


def test_fast_stack_split_at_chi6_moves_z_as_the_reference_does(monkeypatch):
    """The fast stack's split and QR (TNQS_SVD_ALG=gram, TNQS_QR_ALG=
    cholqr2; on the CPU the eighs are the library's) against the default
    knobs, on examples/ising_2d_dynamics.py at χ=6 over its 20 layers, in
    each package in one process (one edge colouring).  The gram split
    itself moves ⟨Z⟩ by well under the band of bench.py (1e-4) in the
    reference, and by about as much in the port: over hash seeds 0-7 the
    reference read 6.3e-6 to 1.1e-5 and the port 0.7-1.5× as much.  So a
    larger move on the card comes from what the card adds to the split,
    the Jacobi eigh K2."""
    import tensornetworkquantumsimulator_torch as tt
    from tensornetworkquantumsimulator_tpu import parallel as jp
    from tensornetworkquantumsimulator_tpu.utils import graphs as j_graphs
    from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    runs = {}
    for knobs in ("default", "fast"):
        if knobs == "fast":
            monkeypatch.setenv("TNQS_SVD_ALG", "gram")
            monkeypatch.setenv("TNQS_QR_ALG", "cholqr2")
        runs["jax", knobs] = _chi6_trajectory(jp, j_graphs, j_lat,
                                              np.complex64)
        runs["torch", knobs] = _chi6_trajectory(tt, tt, tt, torch.complex64)
    moved = {pkg: float(np.abs(runs[pkg, "fast"] - runs[pkg, "default"]).max())
             for pkg in ("jax", "torch")}
    print(f"max site |dZ|, fast stack's split vs default knobs: {moved}")
    assert all(np.isfinite(z).all() for z in runs.values())
    assert 0 < moved["jax"] <= _BAND, moved
    assert moved["torch"] <= min(_BAND, 3 * moved["jax"]), moved
