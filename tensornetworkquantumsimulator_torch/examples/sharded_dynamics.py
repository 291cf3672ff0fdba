"""Multi-device SPMD demo: the full op pipeline on a vertex-sharded state.

The port of ``examples/sharded_dynamics.py``.  Kicked-Ising dynamics on an
S x 4 grid with the vertex axis split over the S shards of a
``ShardMesh``: evolve (halo-exchange Trotter layers), gauge (sharded Vidal
gauge -> entanglement spectra), truncate, and measure (sharded BP site and
bond expectations, sharded boundary-MPS norm, the plaquette loop series);
the state is never gathered to one shard.

The JAX example takes one shard per device, eight virtual devices on a
host.  Here S is ``SHARDS`` (8), and the mesh places shard i on card
i mod the card count: with one card every shard sits on it, so the run
says nothing of scaling over cards.  On the CPU every shard is a ``cpu``
device.

    python -m tensornetworkquantumsimulator_torch.examples.sharded_dynamics
"""

import numpy as np
import torch

from tensornetworkquantumsimulator_torch import (
    gate_matrix,
    named_grid,
    op_matrix,
)
from tensornetworkquantumsimulator_torch.examples import (
    cli,
    numbers,
    on_device,
)
from tensornetworkquantumsimulator_torch.parallel import (
    ShardMesh,
    batched_product_state,
    make_sharded_bond_expectations,
    make_sharded_gauge,
    make_sharded_grid_bmps,
    make_sharded_layer,
    make_sharded_loopcorrections,
    make_sharded_site_expectations,
    make_sharded_truncate,
    shard_spec,
)
from tensornetworkquantumsimulator_torch.utils.lattices import (
    ibm_eagle_lattice,
)

SHARDS = 8  # the JAX example's eight virtual host devices


def main(n_layers=10, chi=4, device=None):
    with on_device(device):
        S = SHARDS
        nx, ny = S, 4
        g = named_grid((nx, ny))
        sspec = shard_spec(g, S)
        spec = sspec.spec
        mesh = ShardMesh(S, ("v",))
        where = ", ".join(sorted({str(d) for d in mesh.devices}))

        print(f"{nx}x{ny} grid over {S} devices ({where})")

        _, state = batched_product_state(g, chi=chi, spec=spec)
        state = mesh.shard(state)

        dt, hx, J = 0.25, 1.0, 0.5
        gate2 = np.asarray(gate_matrix("Rzz", 2 * J * dt)).reshape(2, 2, 2, 2)
        gate1 = np.asarray(gate_matrix("Rx", 2 * hx * dt))
        layer = make_sharded_layer(sspec, mesh, gate2, gate1, chi=chi,
                                   cutoff=1e-12, bp_maxiter=25)
        z = np.asarray(op_matrix("Z", 2))
        site_fn = make_sharded_site_expectations(sspec, mesh, z)
        bond_fn = make_sharded_bond_expectations(sspec, mesh, z, z)

        for l in range(n_layers):
            state, errs = layer(state)
            zs = site_fn(state).real.cpu().numpy()
            err = max(float(e.max()) for e in errs)
            print(f"layer {l + 1:2d}: max trunc err {err:.3e}"
                  f"  <Z>center "
                  f"{zs[spec.vertex_position((nx // 2, ny // 2))]:+.6f}")

        zz = bond_fn(state).real.cpu().numpy()
        print(f"<ZZ> over {len(spec.edges)} edges: mean {zz.mean():+.6f}")

        gauge_fn = make_sharded_gauge(sspec, mesh)
        state_g, spectra = gauge_fn(state)
        ent = spectra.cpu().numpy()
        ent = ent / ent.sum(axis=1, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            sv = -np.nansum(np.where(ent > 0, ent * np.log(ent), 0.0), axis=1)
        print(f"entanglement entropy across edges: max {sv.max():.4f}")

        trunc = make_sharded_truncate(sspec, mesh, chi=chi, cutoff=1e-8)
        state_t, terrs = trunc(state_g)
        print(f"truncate: max err "
              f"{max(float(e.max()) for e in terrs):.3e}")

        norm_fn, _ = make_sharded_grid_bmps(spec, nx, ny, ShardMesh(S, ("r",)),
                                            kmps=4, niters=3)
        lz, _ = norm_fn(state_t)
        print(f"sharded boundary-MPS log|Z| (unnormalized): "
              f"{float(lz.real):.6f}")

        zlc_fn = make_sharded_loopcorrections(sspec, mesh, g,
                                              max_configuration_size=4)
        # max size 3 admits no cycle, so that run returns plain Z_BP; the
        # ratio is the plaquette-series correction factor 1 + Σ_configs Π w
        zbp_fn = make_sharded_loopcorrections(sspec, mesh, g,
                                              max_configuration_size=3)
        zlc = complex(zlc_fn(state_t))
        zbp = complex(zbp_fn(state_t))
        print(f"sharded loop correction factor Z_lc/Z_BP (plaquette series): "
              f"{zlc / zbp:+.8f}")

        # the Eagle-127 lattice through the same pipeline: V=127 does not
        # divide the shard count, so shard_spec(pad=True) appends inert
        # product rows (V -> S x 16); evolve + measure at chi=4 with the
        # state never gathered
        g_eg = ibm_eagle_lattice()
        sspec_eg = shard_spec(g_eg, S, pad=True)
        print(f"\nEagle-127 over {S} devices "
              f"(padded to V={sspec_eg.spec.num_vertices})")
        _, st_eg = batched_product_state(g_eg, chi=4, spec=sspec_eg.spec)
        st_eg = mesh.shard(st_eg)
        layer_eg = make_sharded_layer(
            sspec_eg, mesh,
            np.asarray(gate_matrix("Rzz", 2 * (3.14159 / 4))).reshape(
                2, 2, 2, 2),
            np.asarray(gate_matrix("Rx", 0.4)),
            chi=4, cutoff=1e-12, bp_maxiter=25,
        )
        site_eg = make_sharded_site_expectations(sspec_eg, mesh, z)
        for _ in range(3):
            st_eg, _errs_eg = layer_eg(st_eg)
        zs_eg = site_eg(st_eg).real.cpu().numpy()
        real_rows = [i for i, v in enumerate(sspec_eg.spec.vertices)
                     if g_eg.has_vertex(v)]
        print(f"kicked-Ising <Z> after 3 layers: mean over 127 qubits "
              f"{zs_eg[real_rows].mean():+.6f}")


def read(text) -> dict:
    """The printed numbers: per layer the largest truncation error ``err``
    and the centre's ⟨Z⟩ ``z``, mean ⟨ZZ⟩, the largest bond entropy, the
    truncation error, the boundary-MPS log|Z|, the loop-correction factor
    and the Eagle-127 mean ⟨Z⟩."""
    return dict(
        err=numbers(r"max trunc err (\S+)", text),
        z=numbers(r"<Z>center (\S+)", text),
        zz=numbers(r"<ZZ> over \d+ edges: mean (\S+)", text),
        ent=numbers(r"edges: max (\S+)", text),
        trunc=numbers(r"truncate: max err (\S+)", text),
        lz=numbers(r"\(unnormalized\): (\S+)", text),
        lc=numbers(r"series\): (\S+)", text),
        eagle=numbers(r"127 qubits (\S+)", text))


if __name__ == "__main__":
    cli(main)
