"""PyTorch port, the engine's knob variants through whole layers: each
`TNQS_*` route that `tests/test_torch_slice.py` does not reach, in
complex128 against the JAX package with the same knob set.  Both sides run
the same algorithm in double on the CPU, so ⟨Z⟩ and the truncation errors
agree to 1e-8."""

import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
from test_torch_slice import _KNOBS, _run_jax, _run_torch

torch.set_num_threads(1)


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
