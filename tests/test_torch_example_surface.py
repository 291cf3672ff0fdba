"""The port's examples as a surface: one module of
``tensornetworkquantumsimulator_torch.examples`` per file of ``examples/``,
each ``main()`` with the JAX example's argument names and default values
plus ``device``, none importing JAX; and with no ``device`` an example
runs on CUDA, so on a box without one it raises and names CUDA."""

import ast
import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest

from tensornetworkquantumsimulator_torch import examples, set_default_device

_REPO = Path(__file__).resolve().parents[1]
_NAMES = sorted(p.stem for p in (_REPO / "examples").glob("*.py"))


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's entry points default to CUDA: these tests ask for the CPU."""
    prev = set_default_device("cpu")
    yield
    set_default_device(prev)


def _jax_main_params(name) -> list:
    """(name, default) of the JAX example's ``main()``, read from its source
    (importing it would configure JAX for the example)."""
    tree = ast.parse((_REPO / "examples" / f"{name}.py").read_text())
    (main,) = [n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "main"]
    args = main.args
    defaults = [None] * (len(args.args) - len(args.defaults)) + [
        ast.literal_eval(d) for d in args.defaults]
    return [(a.arg, d) for a, d in zip(args.args, defaults)]


def test_every_example_has_a_port_module():
    """One port module per file of ``examples/``, and no other."""
    port = Path(examples.__file__).parent
    assert len(_NAMES) == 17
    assert sorted(p.stem for p in port.glob("*.py")
                  if p.stem != "__init__") == _NAMES


# One process imports the port's package (which loads no JAX, as
# tests/test_torch_structure.py checks), then forks one child per example
# module: each child imports its module and reports the JAX modules it
# finds loaded.  A fresh interpreter per module would cost a torch import
# each.
_FORKED_IMPORTS = """
import importlib, json, os, sys
import tensornetworkquantumsimulator_torch
def jax_loaded():
    return sorted(m for m in sys.modules if m.split('.')[0] == 'jax')
assert not jax_loaded(), jax_loaded()
found = {}
for name in sys.argv[1:]:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        importlib.import_module(
            'tensornetworkquantumsimulator_torch.examples.' + name)
        os.write(w, json.dumps(jax_loaded()).encode())
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        found[name] = json.loads(f.read() or '"the import failed"')
    os.waitpid(pid, 0)
print(json.dumps(found))
"""


@pytest.fixture(scope="module")
def jax_after_import():
    """{example: the JAX modules loaded after importing its port module}."""
    proc = subprocess.run([sys.executable, "-c", _FORKED_IMPORTS, *_NAMES],
                          cwd=_REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", _NAMES)
def test_example_main_matches_jax(name, jax_after_import):
    """The port module exists, and its ``main()`` takes the JAX example's
    arguments with their default values, in order, then ``device=None``;
    importing it in a new process loads no JAX."""
    mod = importlib.import_module(
        f"tensornetworkquantumsimulator_torch.examples.{name}")
    params = inspect.signature(mod.main).parameters.values()
    got = [(p.name, p.default) for p in params]
    assert got == _jax_main_params(name) + [("device", None)]
    assert jax_after_import[name] == []


def test_example_without_device_raises_naming_cuda():
    """Without CUDA an example called with no ``device`` raises, naming
    CUDA, before it runs anything; asked for the CPU it runs there (a fresh
    process, without this file's CPU default)."""
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from tensornetworkquantumsimulator_torch.examples import "
        "loschmidt_echo as ex\n"
        "try:\n"
        "    ex.main(steps=1, chi=2)\n"
        "except RuntimeError as err:\n"
        "    assert 'CUDA' in str(err), err\n"
        "else:\n"
        "    raise SystemExit('main() ran without CUDA')\n"
        "ex.main(steps=1, chi=2, device='cpu')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("log|echo|=") == 1  # the CPU run's one step


def test_example_command_line_runs_on_the_cpu():
    """``python -m ...examples.<name> --device cpu`` runs the example at its
    defaults on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "tensornetworkquantumsimulator_torch.examples.ising_3d_dynamics",
         "--device", "cpu"], cwd=_REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("Sigma z = ") == 10
