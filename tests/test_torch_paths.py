"""PyTorch port, contraction-order search (``ops/paths.py`` and the native
DP ``csrc/pathopt.cpp``) against the JAX package's search on the cases of
``tests/test_paths.py``: the small native cases, the n=48 ring, and the
dense grid that the native DP declines (the JAX package sends it to
opt_einsum's "dp", the port to its own exact DP).  A path never changes a
value, so what is compared is its cost: Σ over the steps of the product of
both operands' dimensions, the measure every search here minimises.

The port must not need ``opt_einsum`` (the machine with the card has none):
its modules are read for imports, and a process in which ``opt_einsum``
and ``jax`` cannot be imported runs the search."""

import ast
import math
import random
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import opt_einsum
import pytest
import torch

from tensornetworkquantumsimulator_torch import native as t_native
from tensornetworkquantumsimulator_torch import ops as to
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch.ops import paths as t_paths
from tensornetworkquantumsimulator_tpu import native as j_native
from tensornetworkquantumsimulator_tpu import ops as jo

import native_prebuild

torch.set_num_threads(1)

# Every xdist worker collects this file before it runs a test: build the
# JAX package's native libraries here, whole and under a file lock, so that
# no worker's JAX loader finds one half-written.  A worker whose loader had
# already failed on a half-written file (while collecting an earlier file)
# is told to load the library again, now that it is complete.
native_prebuild.prebuild()
for _stem in native_prebuild.STEMS:
    j_native._failed.discard(_stem)
_REPO = Path(__file__).resolve().parents[1]
_PORT = _REPO / "tensornetworkquantumsimulator_torch"


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _random_net(rng, n):
    """``tests/test_paths.py``'s random network: a spanning chain, extra
    shared bonds and one dangling leg per tensor (index = int)."""
    inputs = [[] for _ in range(n)]
    dims = {}
    si = 0
    for i in range(n - 1):
        inputs[i].append(si)
        inputs[i + 1].append(si)
        dims[si] = rng.choice([2, 3, 4])
        si += 1
    for _ in range(rng.randint(0, n)):
        i, j = rng.sample(range(n), 2)
        inputs[i].append(si)
        inputs[j].append(si)
        dims[si] = rng.choice([2, 3])
        si += 1
    for i in range(n):
        inputs[i].append(si)
        dims[si] = rng.choice([2, 3])
        si += 1
    return inputs, dims


def _ring(n, bond=3, leg=2):
    inputs = [[] for _ in range(n)]
    dims = {}
    for i in range(n):
        inputs[i].append(2 * i)
        inputs[(i + 1) % n].append(2 * i)
        dims[2 * i] = bond
        inputs[i].append(2 * i + 1)
        dims[2 * i + 1] = leg
    return inputs, dims


def _grid(nx, ny, bond=2):
    inputs = [[] for _ in range(nx * ny)]
    dims = {}
    k = 0
    for x in range(nx):
        for y in range(ny):
            for (u, v) in (((x, y), (x + 1, y)), ((x, y), (x, y + 1))):
                if u[0] < nx and v[0] < nx and u[1] < ny and v[1] < ny:
                    inputs[u[0] * ny + u[1]].append(k)
                    inputs[v[0] * ny + v[1]].append(k)
                    dims[k] = bond
                    k += 1
    return inputs, dims


def _tensors(inputs, dims):
    """The same network as tensors of both packages (equal ids)."""
    jinds = {c: jo.Index(d) for c, d in dims.items()}
    tinds = {c: to.Index(j.dim, id=j.id) for c, j in jinds.items()}
    jt, tt_ = [], []
    for sub in inputs:
        shape = tuple(dims[c] for c in sub)
        jt.append(jo.Tensor(np.zeros(shape), [jinds[c] for c in sub]))
        tt_.append(to.Tensor(torch.zeros(shape, dtype=torch.float64),
                             [tinds[c] for c in sub]))
    return jt, tt_


def _path_cost(tensors, sequence) -> float:
    """Σ over the steps of ``sequence`` of the product of the dimensions of
    both operands' indices: the measure the searches minimise."""
    pool = [frozenset(t.inds) for t in tensors]
    dims = {i: i.dim for t in tensors for i in t.inds}
    counts = Counter(i for t in tensors for i in t.inds)
    out = {i for i, c in counts.items() if c == 1}
    cost = 0.0
    for (i, j) in sequence:
        a, b = pool[i], pool[j]
        cost += math.prod(dims[c] for c in (a | b))
        rest = [p for k, p in enumerate(pool)
                if p is not None and k not in (i, j)]
        outside = set().union(*rest) if rest else set()
        pool[i] = pool[j] = None
        pool.append(frozenset(c for c in (a | b) if c in outside or c in out))
    return cost


def _costs(inputs, dims):
    jt, tt_ = _tensors(inputs, dims)
    t_paths._PATH_CACHE.clear()
    seq_t = to.contraction_sequence(tt_, alg="optimal")
    seq_j = jo.contraction_sequence(jt, alg="optimal")
    assert len(seq_t) == len(inputs) - 1
    return _path_cost(tt_, seq_t), _path_cost(tt_, seq_j)


def _oe_dp_cost(inputs, dims):
    sym = opt_einsum.get_symbol
    eq = ",".join("".join(sym(c) for c in s) for s in inputs)
    shapes = [tuple(dims[c] for c in s) for s in inputs]
    _, info = opt_einsum.contract_path(eq, *shapes, shapes=True, optimize="dp")
    return float(info.opt_cost) / 2  # opt_einsum counts mul+add


def _jax_native_loaded():
    """Where g++ exists the JAX package's native DP must have loaded: a
    comparison against its Python fallback would test the wrong search."""
    if not native_prebuild.have_compiler():
        pytest.skip("no C++ toolchain")
    assert j_native.get_pathopt() is not None, (
        "g++ exists but the JAX package's libpathopt.so did not load")


def test_both_native_libraries_build_and_load():
    """The port's loader builds ``pathopt`` and ``subgraphs`` from ``csrc/``
    into ``build/native/``, never into the package."""
    _jax_native_loaded()
    for get, stem in ((t_native.get_pathopt, "pathopt"),
                      (t_native.get_subgraphs, "subgraphs")):
        assert get() is not None, stem
        so = t_native.library_path(stem)
        assert so.is_file() and "build" in so.parts and _PORT not in so.parents


@pytest.mark.parametrize("seed", range(6))
def test_small_native_cases_equal_cost(seed):
    _jax_native_loaded()
    rng = random.Random(7 + seed)
    for _ in range(5):
        inputs, dims = _random_net(rng, rng.randint(3, 10))
        cost_t, cost_j = _costs(inputs, dims)
        assert cost_t == pytest.approx(cost_j)
        native = t_native.optimal_path_native([tuple(s) for s in inputs], dims)
        if native is not None:
            ref = j_native.optimal_path_native([tuple(s) for s in inputs], dims)
            assert native == ref


def test_n48_ring_equal_cost():
    _jax_native_loaded()
    cost_t, cost_j = _costs(*_ring(48))
    assert cost_t == pytest.approx(cost_j)


def test_dense_grid_exact_dp_equals_opt_einsum_dp():
    """A dense 4x5 grid overflows the native DP's budget: the JAX package
    runs opt_einsum's exact "dp", the port its own exact DP; the costs
    agree, and both equal opt_einsum's optimum."""
    inputs, dims = _grid(4, 5)
    assert t_native.optimal_path_native([tuple(s) for s in inputs], dims) is None
    cost_t, cost_j = _costs(inputs, dims)
    assert cost_t == pytest.approx(cost_j)
    assert cost_t == pytest.approx(_oe_dp_cost(inputs, dims))


@pytest.mark.parametrize("seed", range(4))
def test_python_dp_is_exact(seed):
    """The port's Python DP alone (the path taken where the native library
    is missing) against opt_einsum's exact DP."""
    rng = random.Random(100 + seed)
    for _ in range(4):
        inputs, dims = _random_net(rng, rng.randint(3, 9))
        sets = [frozenset(s) for s in inputs]
        counts = {}
        for s in inputs:
            for c in s:
                counts[c] = counts.get(c, 0) + 1
        out = frozenset(c for c, k in counts.items() if k == 1)
        seq = t_paths._dp_path(sets, out, dims)
        _, tt_ = _tensors(inputs, dims)
        assert _path_cost(tt_, seq) == pytest.approx(
            _oe_dp_cost(inputs, dims))


@pytest.mark.parametrize("shape", [(3, 3), (2, 6)])
def test_greedy_and_value(shape):
    """The greedy search (and the exact one) give valid orders: the value
    of a random grid contraction equals a dense einsum's."""
    inputs, dims = _grid(*shape, bond=3)
    rng = np.random.default_rng(0)
    _, tt_ = _tensors(inputs, dims)
    tt_ = [to.Tensor(torch.from_numpy(rng.normal(size=t.shape)), t.inds)
           for t in tt_]
    sym = opt_einsum.get_symbol
    eq = ",".join("".join(sym(c) for c in s) for s in inputs) + "->"
    ref = opt_einsum.contract(eq, *[t.numpy() for t in tt_])
    for alg in ("greedy", "optimal"):
        seq = to.contraction_sequence(tt_, alg=alg)
        np.testing.assert_allclose(to.contract(tt_, seq).scalar(), ref,
                                   rtol=1e-10)


def test_paths_memoised_on_structure():
    inputs, dims = _ring(8)
    _, a = _tensors(inputs, dims)
    _, b = _tensors(inputs, dims)  # other ids, same structure
    t_paths._PATH_CACHE.clear()
    sa = to.contraction_sequence(a)
    assert to.contraction_sequence(b) is sa


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_port_imports_no_opt_einsum_or_jax():
    banned = {"opt_einsum", "jax", "jaxlib", "tensornetworkquantumsimulator_tpu"}
    files = sorted(_PORT.rglob("*.py")) + [_REPO / "chip_smoke.py"]
    bad = {str(f.relative_to(_REPO)): sorted(_imports(f) & banned)
           for f in files if _imports(f) & banned}
    assert not bad, bad


def test_generic_engine_runs_without_opt_einsum():
    """In a process where ``opt_einsum`` and ``jax`` cannot be imported, the
    package imports and the generic engine searches, contracts and runs BP."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('opt_einsum', 'jax', 'jaxlib',\n"
        "                'tensornetworkquantumsimulator_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "import tensornetworkquantumsimulator_torch as tt\n"
        "tt.set_default_device('cpu')\n"
        "g = tt.named_grid((3, 3))\n"
        "psi = tt.random_tensornetworkstate(torch.float64, g, bond_dimension=2)\n"
        "z = tt.expect(psi, ('Z', [(2, 2)]), alg='exact')\n"
        "b = tt.expect(psi, ('Z', [(2, 2)]), alg='bp')\n"
        "assert abs(z) <= 1 and abs(b) <= 1\n"
        "assert 'opt_einsum' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
