"""The examples of ``examples/``, as modules of the port.

One module per example, under the same name, each with the example's
``main()`` (its argument names and default values, plus ``device``): it
prints the example's lines in the same format and returns what the
example returns, as torch tensors on the run's device or as Python
floats.  Run one as::

    python -m tensornetworkquantumsimulator_torch.examples.ising_2d_dynamics
    python -m tensornetworkquantumsimulator_torch.examples.ising_2d_dynamics \
        --device cpu

Each module's ``read(text)`` returns the numbers ``main`` printed, by
name; the JAX example prints the same lines, so it reads that output too.

``device=None`` is the package's default device, CUDA: with no CUDA
device visible the example raises, and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import re

import numpy as np

from ..devices import resolve_device, set_default_device


# a printed number, real or complex (``0.5``, ``-1.2e-03``, ``(0.1-2e-08j)``)
FLOAT = r"[-+]?[0-9.]+(?:e[-+]?[0-9]+)?"
NUMBER = r"\(?(" + FLOAT + r"(?:[-+][0-9.]+(?:e[-+]?[0-9]+)?j)?)\)?"


def numbers(pattern, text) -> np.ndarray:
    """Every match of ``pattern``'s one group in ``text``, as complex; real
    where every value is."""
    out = np.array([complex(m) for m in re.findall(pattern, text)])
    return out.real if not np.iscomplex(out).any() else out


def table(text, ncols) -> np.ndarray:
    """The lines of ``text`` that are ``ncols`` numbers, as rows."""
    rows = []
    for line in text.splitlines():
        try:
            row = [float(p) for p in line.split()]
        except ValueError:
            continue
        if len(row) == ncols:
            rows.append(row)
    return np.array(rows).reshape(-1, ncols)


@contextlib.contextmanager
def on_device(device):
    """Run the region with ``device`` (None: the package default, CUDA) as
    the package's default device, so every entry point the example reaches
    builds its tensors there; yields the device."""
    dev = resolve_device(device)
    prev = set_default_device(dev)
    try:
        yield dev
    finally:
        set_default_device(prev)


def cli(main, argv=None):
    """The command line of an example module: ``--device`` (default: the
    package default, CUDA) and nothing else; the example runs at its
    default arguments."""
    parser = argparse.ArgumentParser(description=main.__module__)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    return main(device=args.device)
