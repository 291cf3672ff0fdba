"""PyTorch port, the engine's knob variants through whole layers: each
`TNQS_*` route that `tests/test_torch_slice.py` does not reach, in
complex128 against the JAX package with the same knob set.  Both sides run
the same algorithm in double on the CPU, so ⟨Z⟩ and the truncation errors
agree to 1e-8."""

import json

import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.parallel.cuda_linalg import (
    EIGH_NOISE_FLOOR, ROOTS_NOISE_FLOOR)
from test_torch_jacobi import eigh_emulated
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


def _emulated_k2(noise_floor):
    """``engine.jacobi_eigh`` as K2 computes it (the float32 emulation of
    csrc/jacobi.cu in tests/test_torch_jacobi.py), with ``noise_floor``."""
    def jacobi_eigh(h, *args, **kwargs):
        w, v, _ = eigh_emulated(h.resolve_conj().numpy(),
                                noise_floor=noise_floor)
        return torch.from_numpy(w), torch.from_numpy(v)
    return jacobi_eigh


def _fast_stack_moves(noise_floors):
    """{noise floor: max site |Δ⟨Z⟩|} of the port's χ=6 trajectory on the
    full fast stack (TNQS_EIGH_ALG=jacobi, TNQS_SVD_ALG=gram,
    TNQS_QR_ALG=cholqr2) with K2 emulated at each noise floor, against the
    default knobs, in one process (one edge colouring).  On the CPU K1's
    shape gate keeps the roots (6x6) on the library path, as on the card
    at this χ only K1 runs them; K2 runs the Gram split at [9-11, 24, 24]."""
    import tensornetworkquantumsimulator_torch as tt
    from tensornetworkquantumsimulator_torch.parallel import engine as te

    with pytest.MonkeyPatch.context() as mp:
        for k in _KNOBS:
            mp.delenv(k, raising=False)
        z0 = _chi6_trajectory(tt, tt, tt, torch.complex64)
        mp.setenv("TNQS_EIGH_ALG", "jacobi")
        mp.setenv("TNQS_SVD_ALG", "gram")
        mp.setenv("TNQS_QR_ALG", "cholqr2")
        moves = {}
        for floor in noise_floors:
            mp.setattr(te, "jacobi_eigh", _emulated_k2(floor))
            z = _chi6_trajectory(tt, tt, tt, torch.complex64)
            assert np.isfinite(z).all()
            moves[floor] = float(np.abs(z - z0).max())
    return moves


def test_fast_stack_with_emulated_k2_at_chi6_stays_within_half_the_band():
    """K2 in the Gram split resolves the eigenpairs the split keeps:
    examples/ising_2d_dynamics.py at χ=6 (20 layers, complex64) on the full
    fast stack, K2 emulated in float32 as the kernel computes it, moves
    every site's ⟨Z⟩ from the default knobs' by at most half the band of
    bench.py.  Read over hash seeds 0-7 (``python tests/test_torch_knobs.py``
    once per PYTHONHASHSEED): 6.3e-6 to 1.0e-5, the port's own library
    split's move; with K1's noise floor (4·ε·‖A‖_F, K2's skip before it
    was dropped) 1.8e-4 at seed 0, as the card read (1.7e-4 to 1.9e-4)."""
    moved = _fast_stack_moves((EIGH_NOISE_FLOOR,))[EIGH_NOISE_FLOOR]
    print(f"max site |dZ|, full fast stack with K2 emulated vs default "
          f"knobs: {moved:.2e}")
    assert moved <= _BAND / 2, moved


if __name__ == "__main__":
    # PYTHONHASHSEED=s PYTHONPATH=. python tests/test_torch_knobs.py
    # [--reference]: the χ=6 readings behind the test above for one hash
    # seed, K2 emulated with no noise floor and with K1's; --reference adds
    # the JAX package's fast stack with its Pallas jacobi_eigh in interpret
    # mode (about 100 s on a CPU core).
    import os
    import sys

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    set_default_device("cpu")
    out = {"PYTHONHASHSEED": os.environ.get("PYTHONHASHSEED"),
           **{f"k2_noise_floor_{f:g}": m for f, m in _fast_stack_moves(
               (EIGH_NOISE_FLOOR, ROOTS_NOISE_FLOOR)).items()}}
    if "--reference" in sys.argv:
        from tensornetworkquantumsimulator_tpu import parallel as jp
        from tensornetworkquantumsimulator_tpu.utils import graphs as j_graphs
        from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

        with pytest.MonkeyPatch.context() as mp:
            for k in _KNOBS:
                mp.delenv(k, raising=False)
            z0 = _chi6_trajectory(jp, j_graphs, j_lat, np.complex64)
            for k, v in (("TNQS_EIGH_ALG", "jacobi"), ("TNQS_SVD_ALG", "gram"),
                         ("TNQS_QR_ALG", "cholqr2")):
                mp.setenv(k, v)
            z = _chi6_trajectory(jp, j_graphs, j_lat, np.complex64)
        out["reference_pallas_interpret"] = float(np.abs(z - z0).max())
    print(json.dumps(out))
