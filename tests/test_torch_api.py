"""PyTorch port, the public surface: the names of the port's root,
``utils`` and ``parallel`` equal the JAX package's, less only
``shard_map_novma`` (a switch of JAX's own checker, not ported) and plus a
stated list of the port's own; module by module, every public function and
class of a JAX module, every public method of its classes and every
argument name, is in the module's counterpart, less a stated list of
exceptions; the reference's export list resolves; and the ``api.py``
delegates behave as the JAX package's do."""

import importlib
import inspect
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import tensornetworkquantumsimulator_torch as tt
import tensornetworkquantumsimulator_tpu as tnqs
from tensornetworkquantumsimulator_torch import parallel as tp
from tensornetworkquantumsimulator_torch import set_default_device
from tensornetworkquantumsimulator_torch import utils as tu
from tensornetworkquantumsimulator_tpu import parallel as jp
from tensornetworkquantumsimulator_tpu import utils as ju

torch.set_num_threads(1)

# JAX's names with no counterpart in the port
_NOT_PORTED = {"shard_map_novma"}
# the port's own names: device selection, names the batched port
# re-exports one level up, and the sharded engine's device mesh, sharded
# state and traffic counter
_PORT_ONLY = {
    "root": {"BatchedCircuit", "BatchedState", "batched_product_state",
             "bp_update", "compile_graph", "gate_matrix",
             "ibm_eagle_lattice", "local_expectations",
             "make_expectation_fn", "make_layer_fn", "op_matrix",
             "select_device", "set_default_device", "state_vector"},
    "utils": set(),
    "parallel": {"FieldLayer", "GraphTables", "GridBMPSSpec", "TrotterLayer",
                 "bond_rdms", "edge_scalars",
                 "energy", "graph_tables", "identity_strand", "loop_weights",
                 "loopcorrected_partitionfunction", "rescale",
                 "sandwich_logz", "sandwich_sweeps", "ShardMesh",
                 "ShardedState", "state_from_numpy", "state_to_numpy",
                 "Traffic", "vertex_scalars"},
}


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _names(m):
    """Public names, less submodules (which of those show depends on what
    the process has imported)."""
    return {n for n in dir(m) if not n.startswith("_")
            and not isinstance(getattr(m, n), types.ModuleType)}


@pytest.mark.parametrize("where,jm,tm", [("root", tnqs, tt),
                                         ("utils", ju, tu),
                                         ("parallel", jp, tp)])
def test_public_names_equal_jax_less_sharded(where, jm, tm):
    want = _names(jm) - _NOT_PORTED
    assert _names(tm) - _PORT_ONLY[where] == want
    assert _PORT_ONLY[where] <= _names(tm)
    assert not _NOT_PORTED & _names(tm)


J_PKG, T_PKG = tnqs.__name__, tt.__name__


def _module_names(pkg) -> list:
    """Every ``.py`` module of a package, dotted below it (``""`` is the
    package itself; ``native/`` is a package in JAX, a module in the port,
    and both import as ``native``)."""
    root = Path(importlib.import_module(pkg).__file__).parent
    names = []
    for f in sorted(root.rglob("*.py")):
        parts = f.relative_to(root).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return names


# a Pallas module's counterpart is the CUDA module that holds the kernel
_COUNTERPART = {"parallel.pallas_linalg": "parallel.cuda_linalg",
                "parallel.pallas_bp": "parallel.cuda_bp",
                "parallel.pallas_kernels": "parallel.cuda_matmul"}

_PALLAS_ARGS = ("Pallas' tiling, interpret mode and polish switches; the "
                "CUDA kernel has its own launch shape")
_KEY = ("a JAX PRNG key; the port draws from a torch.Generator "
        "(`generator`)")
_PYTREE = "a JAX pytree hook; a torch tensor needs none"
# what of a JAX module's public surface its counterpart leaves out, each
# with its reason: "module:name", "module:Class.method" or "module:name(arg)"
_SURFACE_EXCEPTIONS = {
    "parallel.sharding:shard_map_novma":
        "a switch of JAX's varying-manual-axes checker, no counterpart",
    "parallel.pallas_linalg:default_sweeps":
        "the reference kernels' fixed sweep count; the port's stop each "
        "matrix on a convergence test",
    "parallel.pallas_linalg:jacobi_eigh(block)": _PALLAS_ARGS,
    "parallel.pallas_linalg:jacobi_eigh(interpret)": _PALLAS_ARGS,
    "parallel.pallas_linalg:jacobi_eigh(polish)": _PALLAS_ARGS,
    "parallel.pallas_linalg:jacobi_pseudo_roots(block)": _PALLAS_ARGS,
    "parallel.pallas_linalg:jacobi_pseudo_roots(interpret)": _PALLAS_ARGS,
    "parallel.pallas_linalg:jacobi_pseudo_roots(polish)": _PALLAS_ARGS,
    "parallel.pallas_bp:bp_outgoing_d3(interpret)": _PALLAS_ARGS,
    "parallel.pallas_kernels:complex_matmul(interpret)": _PALLAS_ARGS,
    "ops.tensor:random_tensor(key)": _KEY,
    "models.tensornetwork:random_tensornetwork(key)": _KEY,
    "models.tensornetwork:random_tensornetworkstate(key)": _KEY,
    "ops.tensor:Tensor.tree_flatten": _PYTREE,
    "ops.tensor:Tensor.tree_unflatten": _PYTREE,
    "utils.checkpoint:load_sharded_state(sharding)":
        "a JAX sharding; the port's shards live on a ShardMesh (`mesh`)",
    "models.gates:to_tensor(dtype)":
        "the JAX function accepts it and never reads it; the port's third "
        "argument is `device`",
}


# shared arguments whose default values differ between a JAX function and
# its counterpart, each with its reason: "module:name(arg)" or
# "module:Class.method(arg)"
_DEFAULT_EXCEPTIONS: dict = {}


def _own_public(mod) -> dict:
    """The public functions and classes a module defines itself (jitted
    functions keep their module)."""
    return {n: o for n, o in vars(mod).items()
            if not n.startswith("_") and callable(o)
            and getattr(o, "__module__", None) == mod.__name__}


def _arg_names(f):
    """The argument names a caller can write (``*args``/``**kwargs`` name
    none); None where there is no signature."""
    try:
        params = inspect.signature(f).parameters.values()
    except (TypeError, ValueError):
        return None
    return [p.name for p in params
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _public_methods(cls, pkg) -> dict:
    """Public attributes the package's own classes in ``cls``'s MRO define
    (inherited ones from ``tuple`` or ``object`` are no part of it)."""
    out = {}
    for k in reversed(cls.__mro__):
        if k.__module__.split(".")[0] == pkg:
            out.update({n: o for n, o in vars(k).items()
                        if not n.startswith("_")})
    return out


def _surface_gaps(name) -> list:
    """What of JAX module ``name``'s public surface its counterpart lacks,
    as keys of ``_SURFACE_EXCEPTIONS``."""
    jm = importlib.import_module(".".join(filter(None, (J_PKG, name))))
    tm = importlib.import_module(
        ".".join(filter(None, (T_PKG, _COUNTERPART.get(name, name)))))
    gaps = []

    def args(key, jf, tf):
        ja, ta = _arg_names(jf), _arg_names(tf)
        if ja is not None and ta is not None:
            gaps.extend(f"{key}({a})" for a in ja if a not in ta)

    for n, jo in sorted(_own_public(jm).items()):
        key = f"{name}:{n}"
        if not hasattr(tm, n):
            gaps.append(key)
            continue
        to = getattr(tm, n)
        args(key, jo, to)
        if not inspect.isclass(jo):
            continue
        for mn, jmeth in sorted(_public_methods(jo, J_PKG).items()):
            if not hasattr(to, mn):
                gaps.append(f"{key}.{mn}")
            elif callable(getattr(jo, mn)):
                args(f"{key}.{mn}", getattr(jo, mn), getattr(to, mn))
    return gaps


@pytest.mark.parametrize("name", _module_names(J_PKG),
                         ids=lambda n: n or "root")
def test_module_surface_matches_jax(name):
    """The JAX module's public functions and classes, its classes' public
    methods and every argument name are in the port's counterpart, less
    the stated exceptions."""
    gaps = [g for g in _surface_gaps(name) if g not in _SURFACE_EXCEPTIONS]
    assert gaps == []


def test_surface_exceptions_are_live():
    """Every stated exception names something JAX has and the port lacks."""
    modules = {k.split(":")[0] for k in _SURFACE_EXCEPTIONS}
    live = {g for m in modules for g in _surface_gaps(m)}
    assert set(_SURFACE_EXCEPTIONS) <= live


def test_all_lists_jax_names():
    assert set(tnqs.__all__) <= set(tt.__all__)
    assert all(hasattr(tt, n) for n in tt.__all__)


def test_reference_export_list_resolves():
    """Every symbol the reference exports
    (`src/TensorNetworkQuantumSimulator.jl:36-113`) has a top-level
    counterpart (as ``tests/test_api_surface.py`` checks for JAX)."""
    reference_exports = """
        vertices edges add_edge degree apply_gates apply_circuit rem_vertex
        truncate expect is_tree expect_boundarymps expect_loopcorrect
        make_hermitian ket_network maxvirtualdim siteinds edge_color
        zerostate named_grid sample TensorNetworkState tensornetworkstate
        random_tensornetworkstate BeliefPropagationCache rescale message
        network update symmetric_gauge messages gauge_and_scale
        paulitensornetworkstate identitytensornetworkstate
        random_tensornetwork inner named_comb_tree
        named_hexagonal_lattice_graph named_path_graph neighbors center
        NamedGraph graph datatype scalartype BoundaryMPSCache TensorNetwork
        AbstractTensorNetwork partitionfunction contract norm_sqr
        map_virtualinds map_tensors normalize QuadraticForm BilinearForm
        sample_certified sample_directly_certified vertextype virtualind
        virtualinds nv heavy_hexagonal_lattice entanglement
        build_graph_from_circuit reduced_density_matrix rdm
    """.split()
    assert [s for s in reference_exports if not hasattr(tt, s)] == []


def test_free_function_delegates():
    g = tt.named_grid((3, 2))
    psi = tt.random_tensornetworkstate(torch.float64, g, bond_dimension=2)
    assert set(tt.vertices(psi)) == set(psi.vertices())
    assert tt.nv(g) == 6 and tt.degree(g, (1, 1)) == 2
    assert not tt.is_tree(g) and tt.vertextype(g) is tuple
    assert tt.scalartype(psi) == tt.datatype(psi) == torch.float64
    assert set(tt.neighbors(g, (1, 1))) == set(g.neighbors((1, 1)))
    assert tt.center(tt.named_path_graph(5)) == [3]
    cache = tt.update(tt.BeliefPropagationCache(psi), maxiter=30,
                      tolerance=1e-12)
    np.testing.assert_allclose(complex(tt.partitionfunction(cache)),
                               complex(tt.norm_sqr(psi, alg="bp")), rtol=1e-8)
    e = tt.edges(psi)[0]
    assert tt.message(cache, e) is not None and len(tt.messages(cache)) > 0
    assert tt.network(cache) is not None
    np.testing.assert_allclose(
        complex(tt.partitionfunction(tt.rescale(cache))), 1.0, rtol=1e-8)
    g2 = tt.rem_vertex(g, (1, 1))
    assert g.nv() == 6 and g2.nv() == 5
    g3 = tt.add_edge(tt.named_path_graph(3), tt.NamedEdge(1, 3))
    assert g3.ne() == 3
    np.testing.assert_allclose(
        np.real(tt.expect_boundarymps(psi, ("Z", [(2, 1)]),
                                      mps_bond_dimension=8)),
        np.real(tt.expect(psi, ("Z", [(2, 1)]), alg="exact")), atol=1e-10)
    psi2 = tt.map_tensors(lambda t: t * 2.0, psi)
    np.testing.assert_allclose(tt.norm_sqr(psi2, alg="exact"),
                               tt.norm_sqr(psi, alg="exact") * 2.0 ** 12,
                               rtol=1e-9)
    psi3 = tt.map_virtualinds(lambda i: i.prime(), psi)
    assert all(i.plev == 1 for ee in psi3.edges()
               for i in psi3.virtualinds(ee))
    assert tt.maxvirtualdim(psi) == 2 and tt.virtualind(psi, e).dim == 2
    assert len(tt.virtualinds(psi, e)) == 1
    qf = tt.QuadraticForm(psi)
    assert tt.ket_network(qf) is qf.ket() and tt.graph(qf) == psi.graph()


def _default(p):
    """A parameter's default, comparable across the packages: a dtype by
    its name (``jnp.complex64``, ``np.complex64`` and ``torch.complex64``
    all read ``"complex64"``), a numpy or JAX scalar by its value."""
    d = p.default
    if isinstance(d, torch.dtype):
        return ("dtype", str(d).split(".")[-1])
    if isinstance(d, (type, np.dtype)) or type(d).__name__ == "_ScalarMeta":
        try:
            return ("dtype", np.dtype(d).name)
        except TypeError:
            return d
    if isinstance(d, np.generic) or (hasattr(d, "shape") and d.shape == ()):
        return np.asarray(d).item()
    return d


def _same(a, b) -> bool:
    try:
        return bool(np.all(np.asarray(a == b)))
    except Exception:
        return False


def _default_gaps(name) -> list:
    """The arguments both JAX module ``name`` and its counterpart take
    whose default values differ, as keys of ``_DEFAULT_EXCEPTIONS``."""
    jm = importlib.import_module(".".join(filter(None, (J_PKG, name))))
    tm = importlib.import_module(
        ".".join(filter(None, (T_PKG, _COUNTERPART.get(name, name)))))
    gaps = []

    def compare(key, jf, tf):
        try:
            jp_, tp_ = (inspect.signature(f).parameters for f in (jf, tf))
        except (TypeError, ValueError):
            return
        for a, p in jp_.items():
            if a in tp_ and not _same(_default(p), _default(tp_[a])):
                gaps.append(f"{key}({a})")

    for n, jo in sorted(_own_public(jm).items()):
        if not hasattr(tm, n):
            continue
        to = getattr(tm, n)
        compare(f"{name}:{n}", jo, to)
        if not inspect.isclass(jo):
            continue
        for mn, jmeth in sorted(_public_methods(jo, J_PKG).items()):
            if hasattr(to, mn) and callable(getattr(jo, mn)):
                compare(f"{name}:{n}.{mn}", getattr(jo, mn), getattr(to, mn))
    return gaps


@pytest.mark.parametrize("name", _module_names(J_PKG),
                         ids=lambda n: n or "root")
def test_module_defaults_match_jax(name):
    """Every argument a JAX module's function, class or method shares with
    its counterpart in the port has the same default value there, less the
    stated exceptions."""
    gaps = [g for g in _default_gaps(name) if g not in _DEFAULT_EXCEPTIONS]
    assert gaps == []


def test_default_exceptions_are_live():
    """Every stated default exception names a default that differs."""
    modules = {k.split(":")[0] for k in _DEFAULT_EXCEPTIONS}
    live = {g for m in modules for g in _default_gaps(m)}
    assert set(_DEFAULT_EXCEPTIONS) <= live
