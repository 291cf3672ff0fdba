"""PyTorch port, host side: the jax-free import, the vendored lattice /
colouring / slot tables, gate matrices, the product state and the state
carry-across, each against the JAX package on the same inputs."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tensornetworkquantumsimulator_torch import set_default_device
import tensornetworkquantumsimulator_torch as tt
from tensornetworkquantumsimulator_torch.models import gates as t_gates
from tensornetworkquantumsimulator_torch.models import sites as t_sites
from tensornetworkquantumsimulator_torch.parallel import convert as t_convert
from tensornetworkquantumsimulator_torch.parallel import structure as t_structure
from tensornetworkquantumsimulator_torch.utils import lattices as t_lat
from tensornetworkquantumsimulator_tpu.models import gates as j_gates
from tensornetworkquantumsimulator_tpu.models import sites as j_sites
from tensornetworkquantumsimulator_tpu.parallel import convert as j_convert
from tensornetworkquantumsimulator_tpu.parallel import structure as j_structure
from tensornetworkquantumsimulator_tpu.utils import graphs as j_graphs
from tensornetworkquantumsimulator_tpu.utils import lattices as j_lat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


_REPO = Path(__file__).resolve().parents[1]

_LATTICES = {
    "grid5x5": lambda lat: lat.named_grid((5, 5)),
    "heavyhex3x3": lambda lat: lat.heavy_hexagonal_lattice(3, 3),
    "eagle127": lambda lat: lat.ibm_eagle_lattice(),
}


def test_port_imports_without_jax():
    code = (
        "import sys, tensornetworkquantumsimulator_torch as t\n"
        "import tensornetworkquantumsimulator_torch.parallel.cuda_linalg\n"
        "import tensornetworkquantumsimulator_torch.parallel.cuda_bp\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _tables(spec):
    """Every field of a spec as plain tuples (the two packages' classes
    differ, so dataclass equality would be False)."""
    return dataclasses.astuple(spec)


def _edge_tuples(groups):
    return [[(e.src, e.dst) for e in grp] for grp in groups]


@pytest.mark.parametrize("name", sorted(_LATTICES))
def test_compile_graph_and_colouring_match_reference(name):
    g_t = _LATTICES[name](t_lat)
    g_j = _LATTICES[name](j_lat)
    assert g_t.vertices() == g_j.vertices()
    assert [tuple(e) for e in g_t.edges()] == [tuple(e) for e in g_j.edges()]
    ncol = g_j.max_degree()
    assert _edge_tuples(tt.edge_color(g_t, ncol)) == _edge_tuples(
        j_graphs.edge_color(g_j, ncol)
    )
    # the spec is a frozen dataclass of tuples: equal iff every table is
    assert _tables(t_structure.compile_graph(g_t)) == _tables(
        j_structure.compile_graph(g_j))


@pytest.mark.parametrize(
    "name,param", [("Rx", 0.37), ("Rz", -1.2), ("Rzz", 0.5), ("Rxx", 0.9)]
)
def test_gate_matrix_matches_reference(name, param):
    np.testing.assert_array_equal(
        t_gates.gate_matrix(name, param), j_gates.gate_matrix(name, param)
    )


@pytest.mark.parametrize("name,dim", [("Z", 2), ("X", 2), ("Y", 2), ("Sz", 3)])
def test_op_matrix_matches_reference(name, dim):
    np.testing.assert_array_equal(
        t_sites.op_matrix(name, dim), j_sites.op_matrix(name, dim)
    )


def test_batched_product_state_matches_reference():
    g = t_lat.heavy_hexagonal_lattice(2, 2)
    gj = j_lat.heavy_hexagonal_lattice(2, 2)
    states = ["↑", "X+", "y-", "↓"]
    fn = lambda v: states[hash(v) % 4]  # noqa: E731
    spec_t, st_t = t_convert.batched_product_state(
        g, chi=4, state_fn=fn, dtype=torch.complex128)
    spec_j, st_j = j_convert.batched_product_state(
        gj, chi=4, state_fn=fn, dtype=np.complex128)
    assert _tables(spec_t) == _tables(spec_j)
    np.testing.assert_array_equal(st_t.tensors.numpy(), np.asarray(st_j.tensors))
    np.testing.assert_array_equal(st_t.messages.numpy(),
                                  np.asarray(st_j.messages))


def test_state_carry_across_round_trips():
    rng = np.random.default_rng(3)
    t = (rng.standard_normal((7, 3, 3, 3, 2))
         + 1j * rng.standard_normal((7, 3, 3, 3, 2))).astype(np.complex64)
    m = (rng.standard_normal((7, 3, 3, 3))
         + 1j * rng.standard_normal((7, 3, 3, 3))).astype(np.complex64)
    state = t_convert.state_from_numpy(t, m, device="cpu")
    assert state.tensors.dtype == torch.complex64
    assert state.chi == 3 and state.degree == 3
    t2, m2 = t_convert.state_to_numpy(state)
    np.testing.assert_array_equal(t2, t)
    np.testing.assert_array_equal(m2, m)
