"""Heavy-hex kicked-Ising dynamics with certified sampling.

The port of ``examples/heavyhex_ising_dynamics.py`` (the IBM-Eagle-style
workload).  The certified sampler draws from a ``torch.Generator`` seeded
0 where the JAX example splits ``PRNGKey(0)``, so the samples differ."""

import time

import numpy as np
import torch

from tensornetworkquantumsimulator_torch import (
    edge_color,
    heavy_hexagonal_lattice,
    op_matrix,
)
from tensornetworkquantumsimulator_torch.examples import (
    cli,
    numbers,
    on_device,
)
from tensornetworkquantumsimulator_torch.parallel import (
    BatchedCircuit,
    batched_product_state,
    batched_symmetric_gauge,
    make_expectation_fn,
    make_layer_fn,
    make_planar_bmps,
    make_planar_certified_sampler,
)


def main(hx=5, hy=5, no_trotter_steps=20, chi=8, nsamples=10, device=None):
    with on_device(device) as dev:
        g = heavy_hexagonal_lattice(hx, hy)
        print(f"heavy-hex lattice with {g.nv()} qubits")
        J, theta_h = 3.14159 / 4, 0.4

        layer = [("Rx", [v], theta_h) for v in g.vertices()]
        for edge_group in edge_color(g, 3):
            layer += [("Rzz", pair, 2 * J) for pair in edge_group]

        spec, state = batched_product_state(g, chi=chi, dtype=torch.complex64,
                                            device=dev)
        circuit = BatchedCircuit(layer, g, spec=spec)
        layer_fn = make_layer_fn(circuit, chi=chi, cutoff=1e-12, device=dev)

        fidelities = []
        for i in range(1, no_trotter_steps + 1):
            t0 = time.perf_counter()
            state, errs = layer_fn(state)
            fid = float(np.prod(1.0 - errs.cpu().numpy()))
            fidelities.append(fid)
            print(f"Trotter step {i}: layer fidelity {fid:.6f} "
                  f"({time.perf_counter() - t0:.3f}s)")

        total_fid = 1.0
        for f in fidelities:
            total_fid *= f
        print(f"Total final fidelity {total_fid:.6f}")

        central = sorted(g.vertices())[len(g.vertices()) // 2]
        z_fn = make_expectation_fn(spec, op_matrix("Z", 2), real_output=True)
        sz_bp = z_fn(state).cpu().numpy()[spec.vertex_position(central)]
        print(f"BP magnetisation on {central}: {sz_bp:.6f}")

        # boundary-MPS measurement + certified sampling in the batched
        # engine (heavy-hex rows are path partitions with pseudo-planar
        # fill-in; wires handle them)
        gauged, _spectra = batched_symmetric_gauge(spec, state)
        _, z_bmps_fn = make_planar_bmps(spec, kmps=10, niters=20)
        sz_bmps = z_bmps_fn(gauged.tensors, torch.as_tensor(
            op_matrix("Z", 2), device=dev)).cpu().numpy()
        print(f"Boundary-MPS magnetisation on {central}: "
              f"{sz_bmps[spec.vertex_position(central)]:.6f}")

        sampler = make_planar_certified_sampler(
            spec, norm_rank=10, projected_rank=10, niters=12)
        generator = torch.Generator(device=dev).manual_seed(0)
        bits, logq, log_poverq = sampler(gauged.tensors, nsamples, generator)
        pq = np.exp(log_poverq.cpu().numpy().astype(np.float64))
        print(f"Std of p(x)/q(x): {float(pq.std()):.4f}")
        c = spec.vertex_position(central)
        zbits = 1.0 - 2.0 * bits.cpu().numpy().astype(float)[:, c]
        sampled_sz = float((pq * zbits).sum() / pq.sum())
        print(f"Importance sampled magnetisation: {sampled_sz:.6f}")


def read(text) -> dict:
    """The printed numbers: per step the layer fidelity ``fid``, the total
    ``total``, the centre's BP and boundary-MPS ⟨Z⟩, the spread of the
    samples' p/q and their importance-sampled ⟨Z⟩."""
    return dict(
        fid=numbers(r"layer fidelity (\S+)", text),
        total=numbers(r"Total final fidelity (\S+)", text),
        bp=numbers(r"BP magnetisation on .*: (\S+)", text),
        bmps=numbers(r"Boundary-MPS magnetisation on .*: (\S+)", text),
        pq_std=numbers(r"Std of p\(x\)/q\(x\): (\S+)", text),
        sampled=numbers(r"Importance sampled magnetisation: (\S+)", text))


if __name__ == "__main__":
    cli(main)
