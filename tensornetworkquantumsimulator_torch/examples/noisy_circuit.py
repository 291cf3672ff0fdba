"""Noisy kicked-Ising dynamics in the density-matrix picture.

The port of ``examples/noisy_circuit.py``.  Evolves ρ(t) for a 4×4 kicked
transverse-field Ising circuit with per-site depolarizing +
amplitude-damping noise after every layer, as a Pauli-coefficient tensor
network over "PauliRho" sites (``density_matrix_tensornetworkstate``).
Tracks the noise-driven decay of the magnetization and the global purity
Tr[ρ²].  The same circuit then runs on the batched engine through
``BatchedCircuit(picture="rho")``.  The samplers draw from the port's
generators, so the samples differ from the JAX example's.

    python -m tensornetworkquantumsimulator_torch.examples.noisy_circuit
"""

import re

import numpy as np
import torch

from tensornetworkquantumsimulator_torch import (
    apply_circuit,
    density_matrix_tensornetworkstate,
    edge_color,
    named_grid,
    pauli_expectation,
    purity,
    sample_density_matrix,
)
from tensornetworkquantumsimulator_torch.examples import (
    cli,
    numbers,
    on_device,
    table,
)
from tensornetworkquantumsimulator_torch.parallel import (
    BatchedCircuit,
    batched_from_tns,
    batched_purity,
    ensemble_fn,
    make_layer_fn,
    make_noisy_field_layer_fn,
    make_pauli_expectation_fn,
    make_rho_sampler,
    stack_states,
    unstack_states,
)


def main(nx=4, ny=4, layers=5, dt=0.15, h=1.0, J=1.0, p_dep=0.02, gam=0.03,
         device=None):
    with on_device(device) as dev:
        g = named_grid((nx, ny))
        layer = [("Rx", [v], 2 * h * dt) for v in g.vertices()]
        for group in edge_color(g, 4):
            layer += [("Rzz", pair, 2 * J * dt) for pair in group]
        layer += [("depolarizing", [v], p_dep) for v in g.vertices()]
        layer += [("amplitude_damping", [v], gam) for v in g.vertices()]

        rho = density_matrix_tensornetworkstate(torch.float64, lambda v: "0",
                                                g, device=dev)
        obs = [("Z", [v]) for v in g.vertices()]
        print("layer  <Z>_mean    purity")
        for t in range(layers):
            rho, _ = apply_circuit(
                layer, rho,
                apply_kwargs=dict(maxdim=8, cutoff=1e-12,
                                  normalize_tensors=False),
            )
            z = np.real(pauli_expectation(rho, obs, alg="bp"))
            p2 = purity(rho, alg="bp")
            print(f"{t + 1:5d}  {np.mean(z):+.6f}  {p2:.6f}")

        samples = sample_density_matrix(rho, 5)
        print("samples from the noisy state (bit fraction, logp):")
        for s in samples:
            bits = s["bitstring"]
            frac = sum(bits.values()) / len(bits)
            print(f"    {frac:.3f}  {s['logp']:+.3f}")

        # the same circuit on the batched engine: evolve + measure as
        # compiled layers (BatchedCircuit(picture="rho") + one sandwich-BP
        # expectation program for every site)
        chi = 8
        spec, state = batched_from_tns(density_matrix_tensornetworkstate(
            torch.complex64, lambda v: "0", g, device=dev), chi=chi,
            device=dev)
        bc = BatchedCircuit(layer, g, spec=spec, d=4, picture="rho")
        layer_fn = make_layer_fn(bc, chi=chi, cutoff=1e-10,
                                 normalize_tensors=False, device=dev)
        expect_fn = make_pauli_expectation_fn(spec, chi, torch.complex64)
        for _ in range(layers):
            state, _ = layer_fn(state)
        zb = expect_fn(state)["Z"]
        print(f"batched engine <Z>_mean after {layers} layers: "
              f"{float(zb.mean()):+.6f}")

        # batched counterparts of purity + sampling
        p2_b = float(batched_purity(spec, state))
        print(f"batched engine purity after {layers} layers: {p2_b:.6f}")
        sampler = make_rho_sampler(spec, chi, torch.complex64, refresh_iters=6)
        bits, logps = sampler(state, 5,
                              torch.Generator(device=dev).manual_seed(0))
        print("batched samples (bit fraction, logp):")
        for i in range(5):
            frac = float(bits[i].double().mean())
            print(f"    {frac:.3f}  {float(logps[i]):+.3f}")

        # noise-rate sweep: E depolarizing strengths advance in ONE folded
        # program (make_noisy_field_layer_fn: rates are runtime inputs)
        _, noisy_layer = make_noisy_field_layer_fn(
            g, chi, noise=("depolarizing",), spec=spec, jit=False, device=dev)
        rates = torch.tensor([0.0, p_dep, 2 * p_dep, 4 * p_dep], device=dev)
        _, st0 = batched_from_tns(density_matrix_tensornetworkstate(
            torch.complex64, lambda v: "0", g, device=dev), chi=chi,
            device=dev)
        estate = stack_states([st0] * len(rates))
        sweep = ensemble_fn(noisy_layer, in_axes=(0, None, None, 0))
        for _ in range(layers):
            estate, _ = sweep(estate, 2 * h * dt, 2 * J * dt, rates)
        z_sweep = [expect_fn(st)["Z"] for st in unstack_states(estate)]
        print("noise-rate sweep <Z>_mean per rate:",
              [f"{float(z.mean()):+.4f}" for z in z_sweep])
        return rho


def read(text) -> dict:
    """The printed numbers: the generic engine's table (layer, ⟨Z⟩ mean,
    purity) and samples (bit fraction, logp), the batched engine's ⟨Z⟩
    mean ``zb``, purity ``pb`` and samples, and the noise-rate sweep."""
    generic, _, rest = text.partition("samples from")
    samples, _, rest = rest.partition("batched engine")
    batched = rest.partition("batched samples")[2]
    return dict(
        table=table(generic, 3), samples=table(samples, 2),
        zb=numbers(r"batched engine <Z>_mean after \d+ layers: (\S+)", text),
        pb=numbers(r"batched engine purity after \d+ layers: (\S+)", text),
        batched_samples=table(batched.partition("noise-rate")[0], 2),
        sweep=np.array([float(x) for x in re.findall(
            r"'([-+0-9.]+)'", text.partition("noise-rate sweep")[2])]))


if __name__ == "__main__":
    cli(main)
