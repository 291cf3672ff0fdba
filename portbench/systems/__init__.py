"""The systems under test, one module each, found by a configuration's
``system`` key.  A module gives ``Program`` (the package's objects for one
configuration: ``state0``, ``angles``, ``step``, ``readout``,
``to_bench``, ``schedule``, ``bucket_sizes``) and ``compare`` (the numbers
its check compares).

Both configurations today run ``field_layer``.  The cells kept for later
in ``PERF.md`` that drive another entry of the package each bring a module
of their own here: the boundary-MPS all-site ⟨Z⟩ cell (the readout
through ``BoundaryMPSCache``), the certified sampler, and the variational
steps."""

from __future__ import annotations

import importlib


def load(config: dict):
    return importlib.import_module(f"{__name__}.{config['system']}")
