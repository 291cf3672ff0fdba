"""The one generator: seeded, stratified as the mixes state, and angles as
the configurations define them."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import lattices, traffic
from portbench.tests.helpers import SEED

ROOT = Path(traffic.__file__).resolve().parent


def _config(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def _gen(mix_name, config_name, seed=SEED):
    config = _config(config_name)
    v, e = lattices.build(config["lattice"])
    return traffic.Generator(traffic.load(mix_name), config, len(v), len(e),
                             seed), config


@pytest.mark.parametrize("mix,config", [
    ("theta_h_sweep", "eagle127_kicked_ising_chi64"),
    ("hx_quench", "grid5x5_tfim_chi10"),
    ("disorder32", "grid5x5_tfim_chi10")])
def test_the_same_seed_gives_the_same_experiments(mix, config):
    a, _ = _gen(mix, config)
    b, _ = _gen(mix, config)
    c, _ = _gen(mix, config, seed=SEED + 1)
    for i in (0, 3, 11):
        ea, eb, ec = a.experiment(i), b.experiment(i), c.experiment(i)
        assert np.array_equal(ea.site, eb.site)
        assert np.array_equal(ea.bond, eb.bond)
        assert ea.site.dtype == np.float32 and ea.bond.dtype == np.float32
        assert not np.array_equal(ea.site, ec.site)


@pytest.mark.parametrize("mix,config,param,lo,hi", [
    ("theta_h_sweep", "eagle127_kicked_ising_chi64", "theta_h", 0.0,
     np.pi / 2),
    ("hx_quench", "grid5x5_tfim_chi10", "hx", 0.5, 1.5)])
def test_each_seed_runs_every_stratum_once_a_cycle(mix, config, param, lo, hi):
    for seed in (SEED, 7, 2**40 + 3):
        gen, _ = _gen(mix, config, seed)
        vals = [json.loads(gen.experiment(i).label)[param] for i in range(16)]
        strata = np.floor((np.array(vals) - lo) / ((hi - lo) / 8)).astype(int)
        assert sorted(strata[:8]) == list(range(8))
        assert vals[:8] == vals[8:]  # cycled


def test_sweep_angles_follow_the_configuration():
    gen, config = _gen("theta_h_sweep", "eagle127_kicked_ising_chi64")
    ex = gen.experiment(2)
    theta = json.loads(ex.label)["theta_h"]
    assert ex.site.shape == (1, 1, 127) and ex.bond.shape == (1, 144)
    assert np.allclose(ex.site, theta, atol=1e-6)
    assert np.allclose(ex.bond, -np.pi / 2)
    gen, config = _gen("hx_quench", "grid5x5_tfim_chi10")
    ex = gen.experiment(0)
    hx = json.loads(ex.label)["hx"]
    assert ex.site.shape == (1, 2, 25) and ex.bond.shape == (1, 40)
    assert np.allclose(ex.site[0, 0], 2 * hx * 0.25)
    assert np.allclose(ex.site[0, 1], 2 * 0.8 * 0.25)
    assert np.allclose(ex.bond, 2 * 0.5 * 0.25)


def test_disorder_draws_per_member_site_and_edge_anew_each_experiment():
    gen, _ = _gen("disorder32", "grid5x5_tfim_chi10")
    a, b = gen.experiment(0), gen.experiment(1)
    assert a.site.shape == (32, 2, 25) and a.bond.shape == (32, 40)
    hx = a.site[:, 0] / (2 * 0.25)
    J = a.bond / (2 * 0.25)
    assert hx.min() >= 0.5 and hx.max() <= 1.5 and np.unique(hx).size > 700
    assert J.min() >= 0.8 and J.max() <= 1.2 and np.unique(J).size > 1200
    assert np.allclose(a.site[:, 1], 2 * 0.8 * 0.25)
    assert not np.array_equal(a.site, b.site)


def test_a_lattice_given_as_data_equals_the_builder():
    v, e = lattices.grid((2, 3))
    spec = {"kind": "edges", "vertices": [list(x) for x in v],
            "edges": [[list(a), list(b)] for a, b in e]}
    assert lattices.build(spec) == (v, e)
