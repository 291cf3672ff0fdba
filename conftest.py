"""Repository-wide pytest setup: build the JAX package's native libraries
once, whole, before any test file is collected.

``tensornetworkquantumsimulator_tpu.native`` builds ``libpathopt.so`` and
``libsubgraphs.so`` with g++ on first use, onto their final paths under a
thread lock only.  Under pytest-xdist a worker that collects a file whose
``skipif`` asks for a library (``tests/test_paths.py``) can load one that
another worker's linker is still writing, and then skips those tests.
``pytest_configure`` runs in the controller and in every worker before
collection, and ``tests/native_prebuild.py`` builds each missing or stale
library under a file lock and renames it into place, so no worker finds a
half-written file.

This file imports neither JAX nor torch: ``tests/conftest.py`` configures
JAX before its first import.
"""

import importlib.util
from pathlib import Path


def pytest_configure(config):
    path = Path(__file__).resolve().parent / "tests" / "native_prebuild.py"
    spec = importlib.util.spec_from_file_location("native_prebuild", path)
    prebuild = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prebuild)
    prebuild.prebuild()
