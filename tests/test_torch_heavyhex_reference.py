"""PyTorch port, the field layer on a heavy-hex piece against the
benchmark's plain reference (``portbench/reference``: plain PyTorch, no
JAX, written apart from the package).

The piece is two rows of Eagle's heavy hex, 9 qubits each, bridged at
columns 0, 4 and 8: 21 qubits, 22 edges, two 12-cycles, sites of degree 2
and 3 (so the state's tensors carry padded legs, as Eagle's do).  The
program runs the Eagle configuration's stack (the Jacobi eigh, the Gram
split, CholeskyQR2, K3's route) in complex64; the reference runs complex128,
both in the program's colour-group order, from |0…0⟩ with seeded random
angles: Rx(θ_v) per site, Rzz(θ_e) per edge, new angles each step."""

import numpy as np
import pytest
import torch

from portbench import check, lattices
from portbench.reference import Lattice
from portbench.systems.field_layer import Program
from tensornetworkquantumsimulator_torch import set_default_device

torch.set_num_threads(1)

STEPS = 6
# The widest ⟨Z⟩ gap allowed over the steps.  In complex64 the Gram split
# resolves singular values only to √ε·σmax (~3.5e-4 σmax), and the
# truncation (χ = 4 binds from step 3) keeps what it resolves: two
# complex64 programs doing the same thing differ by up to ~1e-4 (the
# repo's band for them), and the benchmark's χ=10 grid reads up to
# 1.6e-5 against the complex128 reference over 20 steps.  Here the
# program reads up to 1.14e-5 (χ=4) and 5.8e-6 (χ=8) under hash seeds 0-3.
# A wrong split, gate order or environment moves ⟨Z⟩ by 1e-2 or more.
BAND = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _piece():
    vertices, edges = lattices.ibm_eagle()
    keep = {v for v in vertices if v[0] in (0, 1, 0.5) and v[1] <= 8}
    return ([v for v in vertices if v in keep],
            [e for e in edges if e[0] in keep and e[1] in keep])


class _Angles:
    """One experiment's angles: site [1, 1, V], bond [1, B], float32."""

    def __init__(self, rng, num_vertices, num_edges):
        self.site = rng.uniform(0.1, 1.5, (1, 1, num_vertices)).astype(
            np.float32)
        self.bond = rng.uniform(-1.6, 1.6, (1, num_edges)).astype(np.float32)


@pytest.mark.parametrize("chi", [4, 8])
def test_the_field_layer_follows_the_reference_on_heavy_hex(monkeypatch,
                                                             chi):
    for knob, value in (("TNQS_EIGH_ALG", "jacobi"), ("TNQS_SVD_ALG", "gram"),
                        ("TNQS_QR_ALG", "cholqr2"), ("TNQS_BP_KERNEL", "1")):
        monkeypatch.setenv(knob, value)
    vertices, edges = _piece()
    assert (len(vertices), len(edges)) == (21, 22)
    degrees = {v: sum(v in e for e in edges) for v in vertices}
    assert set(degrees.values()) == {2, 3}
    config = {"chi": chi, "dtype": "complex64", "cutoff": 1e-10,
              "bp_maxiter": 25, "bp_tolerance": 1e-5,
              "normalize_tensors": True, "site_rotations": [["X", []]],
              "bond_rotation": ["ZZ", []]}
    program = Program(config, vertices, edges, 1, "cpu")
    lattice = Lattice(vertices, edges)
    lattice.check_schedule(program.schedule)
    ref = check.reference_for(config, lattice, "cpu")
    rng = np.random.default_rng(2024 + chi)
    gaps = []
    state = program.state0
    T, M = ref.product_state(1)
    for _ in range(STEPS):
        ex = _Angles(rng, len(vertices), len(edges))
        state = program.step(state, *program.angles(ex))
        z = program.to_bench(program.readout(state).to(torch.float64).numpy())
        g, bond = check.gates(config, lattice, program.schedule, ex, "cpu")
        T, M = ref.step(T, M, g, program.schedule, bond)
        gaps.append(check.widest_gap([z], [ref.z(T, M).numpy()]))
    assert max(gaps) <= BAND, gaps
