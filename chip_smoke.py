#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``tensornetworkquantumsimulator_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

Phases, each printing its checks and seconds:

1. device: a product state and a layer built with no ``device=`` argument
   (the entry points default to CUDA), the card's name and power limit
   (``nvidia-smi``), the ``nvcc`` version, the colour-group bucket sizes of
   each grid configuration and the process's ``PYTHONHASHSEED`` (the
   vendored edge colouring follows string hashing); then the CUDA kernels
   are built from ``csrc/``, one ``nvcc`` per source, all started together;
2. each kernel against its plain PyTorch version on the card, inputs made
   from a numpy seed, at the main path's shapes among others: K1
   ``jacobi_pseudo_roots`` at [72,10,10] and the rolled path's [6,10,10] and
   [36,10,10], K2 ``jacobi_eigh`` on full-rank and rank-deficient PSD
   batches at [12,40,40], [200,64,64], the rolled path's [1,40,40],
   [3,40,40], [7,40,40] and, in a cluster of 8 CTAs per matrix, [4,128,128],
   [6,256,256] and [48,256,256], K3
   ``bp_outgoing_d3`` at [127,8,8,8,2] and [127,64,64,64,2], K4
   ``complex_matmul`` against its plain version and a complex128 numpy A@B
   on six shapes (a ragged one and [8,512,512] among them);
3. main path, ``chi10``: 5x5 TFIM at χ=10, five layers on the fast stack
   (Jacobi eigh, gram split, CholeskyQR2); K1 and K2 must launch, and ⟨Z⟩
   must agree with the same layers on the library eigh to 1e-4.  The
   inputs the layers handed each kernel are recorded, and each kernel is
   then held against its plain version on them;
4. main path, ``chi64``: IBM-Eagle 127-qubit kicked Ising at χ=64, two
   layers, plus ``TNQS_BP_KERNEL=1``; K2 and K3 must launch, K2 also on the
   Gram split's n=256 batches, ⟨Z⟩ must agree with the kernels-off run to
   1e-4, and the recorded inputs are checked as in phase 3;
5. physics: 3x3 TFIM at χ=8, cutoff 0, complex64, BP ⟨Z⟩ against the
   dense-statevector oracle (``tests/dense_oracle.py``) to 1e-4;
6. ``rolled``: the bench's headline ``chi10_rolled`` (bench.py:219-262),
   the parametric field layer on the 5x5 grid at χ=10 with 64 rolled angle
   sets, 10 layers; K1 and K2 must launch, ⟨Z⟩ kernels on vs off to 1e-4,
   the recorded kernel inputs checked as in phase 3;
7. ``bonds``: on the rolled state, ⟨Z⊗Z⟩ per edge from
   ``bond_expectations`` against the trace of ``bond_rdms`` with Z⊗Z, 1e-5;
8. ``ensemble``: 8 rolled realizations with distinct angles (member e
   scaled by (1 + e)/2) in one folded program at the default BP tolerance;
   K1 and K2 must launch; ⟨Z⟩ to 1e-5 against the same fold with each
   member in all 8 slots, and to 1e-4 against single runs (per layer from
   the same inputs, and from the start) wherever the member's BP stopped
   at the same sweeps as its single run's; where it did not, the two
   distances at the earlier stop must straddle the tolerance within 0.1 x
   tolerance, and the flip is printed; the sweep at which each member's
   BP stopped is reported, and some refresh must stop members apart;
9. ``noisy``: the parametric noisy layer (d=4 Pauli sites, depolarizing +
   amplitude damping) on the 5x5 grid at χ=8 against
   ``BatchedCircuit(picture="rho")`` + ``make_layer_fn`` at the same rates,
   through the sandwich-BP readout: ⟨Z⟩ and ⟨X⟩ to 1e-4; K1 must launch;
   it runs the fast stack with the SVD split (``SVD_STACK``); then ``qr``:
   the chi10, chi64 and noisy layers from their product states with no
   ``TNQS_*`` knob set (the package default), every matrix handed to
   ``engine._qr_split`` recorded; each batch must split into finite Q and
   R, |QR - A|/|A| <= 1e-5, |diag R| within 1e-4 of ``library_qr``'s (one
   matrix per call); a NaN fails the run;
10. ``microbench``: every op of ``tensornetworkquantumsimulator_torch.
   microbench`` at its sweep shapes (16,40) and (8,128), with small M
   points; ``cpallas`` must launch K4;
11. ``measure``: the measurement half, every step asserting.  On the 5x5
   TFIM χ=10 complex64 state the chi10 path leaves: the Vidal gauge (⟨Z⟩
   unchanged to 1e-5, messages diagonal and a BP fixed point, spectra
   descending); ``batched_truncate`` on the fast stack, the counted path of
   this phase (K1 and K2 must launch, ⟨Z⟩ within 1e-4 of kernels off, the
   recorded kernel inputs checked as in phase 3); the Loschmidt echo (1 at
   t=0 to 1e-5, at most 1 after the layers) and ``batched_inner(psi, psi)``
   against the BP norm; the 24 ⟨ZZ⟩ path correlators from vertex (1,1),
   distance 1 against ``bond_expectations`` to 1e-5; mutual information ≥
   -1e-5; 32 BP samples (site means within 4σ plus one count of
   (1-⟨Z⟩)/2); the grid boundary MPS at rank 16 (all-site ⟨Z⟩ within 2e-4
   of rank 24, 2e-2 of BP and 5e-5 of the same call on the CPU); 32
   certified samples at ranks 8 (finite, the spread of ``log_poverq``
   printed, four samples recontracted on the CPU, padded and equal-column
   strands through ``_single_truncate``).  On the Eagle 127-qubit χ=8 state
   after two kicked-Ising layers: the planar boundary MPS against BP to
   1e-3.  On the noisy path's d=4 state: purity in (0, 1] and 32
   density-matrix samples with finite ``logps``.  Times (CUDA events after
   one warm-up call) stand beside the card's name and power limit;
12. ``loops``: on the measure phase's 5x5 χ=10 and Eagle χ=8 states, with
   the native subgraph enumerator (``csrc/subgraphs.cpp``, built with g++;
   the run fails if it does not load): Z_BP against the Bethe free energy
   at the state's messages to 1e-4; loop-corrected Z at
   max_configuration_size 4, 6, 8 (16, 40, 221 configurations) on the grid
   and 12 (18 heavy-hex 12-cycles) on Eagle, each against the same call on
   the CPU; loop-corrected ⟨Z⟩ on all 25 grid sites at size 4, closer to
   the rank-24 boundary MPS than BP's, and on 8 Eagle sites at size 12;
   times (CUDA events after one warm-up) and the host-side enumeration's
   apart.  No kernel launches here;
13. ``variational``: 3x3 TFIM χ=4 complex64, 400 Adam steps, within 5% of
   the dense ground energy; 5x5 TFIM at χ=4, 100 steps timed and the first
   gradient in complex128 against the CPU to 1e-8; Eagle-127 Heisenberg at
   χ=4 with ``TNQS_BP_KERNEL=1``: K3 0 launches under grad with the
   gradient equal to the kernel-off one, K3 > 0 under ``torch.no_grad()``
   with the same energy; an ensemble of 4 disorder realizations, 20 steps,
   each member within 1e-5 of its single run;
14. ``generic``: the generic named-index engine (``TensorNetworkState``,
   ``apply_circuit``, ``BeliefPropagationCache``, ``expect``), with both
   native host libraries (``csrc/pathopt.cpp``, ``csrc/subgraphs.cpp``,
   built with g++) loaded or the run fails.  (a) the chi10 configuration
   at full width: 5x5 TFIM, χ=10, cutoff 1e-10, complex64, 5 layers of
   ``apply_circuit`` (counted: K1-K4 must launch 0 times), BP ⟨Z⟩ on all 25
   sites within 1e-4 of the batched layer started from the same state
   through ``batched_from_tns``, with the BP sweeps of both printed; the
   batched state brought back through ``batched_to_tns`` and
   ``batched_messages_to_cache`` and read by ``expect`` within 1e-5 of
   ``local_expectations``.  (b) the port's ising_2d_heisenberg module
   (``tensornetworkquantumsimulator_torch.examples``) at its defaults (4x4,
   χ=4, 5 steps, Pauli basis): Frobenius norm and both traces as it
   prints them.  (c) the port's thermal_states (4x4, χ=8, d=4, float64, 8
   of its 16 Strang steps): E/site, ⟨X⟩, S2/site as it prints them, the
   largest bond recorded at each ``apply_circuit``.  (d) one more chi10
   layer timed with CUDA
   events and its host syncs counted (CUDA sync debug mode); (a)-(c)
   again on the CPU in this process, card against CPU within 1e-4 in (a),
   1e-5 relative in (b), and in (c) 1e-5 relative on the steps before the
   χ=8 cap binds and 1e-2 after it (from there the run amplifies rounding;
   a second CPU run on one thread prints the CPU's own spread), the times
   side by side.  (e) ``ops.linalg.eigendecomp_hermitian`` of a random
   16x16 complex64 PSD matrix on the card: w and U diag(w) U^H within 1e-5
   relative of the CPU's;
15. ``generic_bmps``: the generic engine's second half, each check run
   again on the CPU in this process with times (CUDA events and the host
   clock) side by side.  The card factorizes with cuSOLVER, the CPU with
   numpy's LAPACK; where a factorization may pick its basis (a boundary
   MPS's rank-1 starting strand, a degenerate spectrum), a truncated fit
   depends on that pick, so each such check runs a third time on the CPU
   with torch's LAPACK (MKL) and holds card against CPU within 1e-5, or 10x
   the spread of the CPU's two LAPACKs where that is larger (printed).
   Each of (a)-(c) runs the port's example module, its standard output
   read by the module's ``read``.  (a) ising_2d_dynamics at its defaults
   (5x5, χ=5, 20 batched layers, complex64; counted: K1-K4 launch 0
   times), the state it hands ``batched_to_tns`` recorded, the
   boundary-MPS ⟨Z⟩ at (3, 3) at rank 4 beside BP's: the fit on the
   card's state, card against CPU; the two runs' BP and BMPS ⟨Z⟩ within
   1e-5 relative, or 10x the CPU's spread between its thread count and one
   thread, or twice its complex64 run's distance from complex128 (the
   rounding each complex64 run carries; the complex128 run widens the
   example's product state), whichever is largest (printed), the BMPS
   reading plus 10x the fit's two-LAPACK spread.  (b)
   boundarymps_convergence on its three lattices (line, 3x3 hexagonal,
   5x5 square; χ=2): centre ⟨Z⟩ by BP, at ranks 1-16 and exactly, card
   against CPU per value within 1e-5, 10x the two-LAPACK spread or twice
   the complex64 run's distance from complex128 (the drawn states widened),
   whichever is largest; the rank-16 error against "exact" below BP's on
   the two lattices with loops.  (c) loopcorrections (line, 2x2
   hexagonal and 4x4 square at χ=3, then 3x3 at χ=2): BP, loop-corrected
   and exact norms and the 3x3 centre ⟨Z⟩, recorded where the example
   computes them, card against CPU within 1e-5, the loop series closer to
   exact than BP on the two lattices with loops and on ⟨Z⟩.  (d) a 4x4
   χ=4 complex128
   state: ``sample`` ("bp"), ``sample_directly_certified`` and
   ``sample_certified`` ("boundarymps", ranks 8), the card's draws forced
   on the CPU runs through the draw hook, logq and p/q card against CPU,
   and samples/s.  (e) ``truncate`` to χ=2 by "bp" and "boundarymps":
   fidelity and exact ⟨Z⟩ card against CPU.  (f) (a)'s state through
   ``save_state`` / ``load_state`` onto the card: equal tensors;
16. ``examples``: the twelve examples of ``examples/`` that no earlier
   phase runs (ising_3d_dynamics, heavyhex_ising_dynamics,
   disorder_ensemble, noisy_circuit, lindblad_dynamics, loschmidt_echo,
   correlation_functions, batched_gauge_loopcorrections,
   tfim_ground_state, variational_ground_state, excited_states,
   sharded_dynamics), each through the port's module at its defaults
   (full width; the depth cuts of ``EXAMPLE_CUTS`` printed), counted as
   the ``examples`` path (default knobs: K1-K4 launch 0 times), timed with
   CUDA events, every printed number finite and held to the example's own
   check where it prints one (heavy-hex BP against boundary-MPS ⟨Z⟩,
   noisy_circuit's generic against its batched engine, the ground and
   excited energies against the dense ones); then each at its CPU test's
   reduced arguments on the card and on the CPU, card against CPU at the
   test's bars (unless a batched BP refresh stopped one sweep apart at the
   tolerance, decided by rounding: then they are printed only); then
   ising_2d_dynamics on the fast stack at its defaults
   (χ=5, whose 5x5 environment roots K1's shape gate, the reference's,
   leaves to the library) and at χ=6 with the library SVD split
   (``SVD_STACK``, as the noisy check; the ``examples_fast_stack`` path):
   K1 and K2 must launch, every site's ⟨Z⟩ within 1e-4 of the same run at
   default knobs ((15) (a)'s at the defaults); χ=6 on the full fast stack
   is printed, not held: K2 in the gram split moves it beyond 1e-4, an
   open fault (ROADMAP Queue 3);
17. ``sharded``: the multi-device engine (``parallel/sharding.py`` and
   the modules built on it), every shard on this one card, so the times
   say nothing of scaling over cards.  (a) the chi32 configuration, 5x5
   TFIM at χ=32 complex64 on the fast stack, one row a strip
   (``shard_spec(g, 5)``), 3 layers of ``make_sharded_layer`` against the
   unsharded ``make_layer_fn`` in the same colour-group order with the
   kernels off: max site |dZ| <= 1e-4, K1 and K2 must launch, each kernel
   against its plain version on the inputs the sharded layers gave it (as
   in 3-4), no ``all_gather`` in a layer; the
   ppermute calls and bytes of a layer, and ms per layer (CUDA events, 2
   layers after one warm-up) unsharded, S=1 and S=5.  (b) 6x6 χ=32 in
   (2, 2) blocks, 2 layers of ``make_sharded_layer_2d``, 1e-4.  (c)
   heavy-hex (3, 3), V=68, χ=16 in 4 strips with ``TNQS_BP_KERNEL=1``, 2
   layers, 1e-4, K3 must launch; (b) and (c) are held against the
   unsharded layer and their kernels against their plain versions as (a)
   is.  (d) on (a)'s state at the package
   defaults, each sharded function against its single-device counterpart
   on the gathered state: site and bond ⟨Z⟩, the gauge's spectra and ⟨Z⟩,
   truncation (cutoff 1e-6) errors and ⟨Z⟩, the Loschmidt echo from the
   product state and four path correlators, within 1e-5; the grid boundary
   MPS at rank 16 (on the truncated state, its χ buffer cut to the bond
   dimension it uses, checked to be zero beyond it) within 5e-5;
   loop-corrected Z and three ⟨O⟩ at size 4 within 1e-4; the certified
   sampler (on the truncated state) and the density-matrix sampler (on the
   noisy phase's state) over 5 shards with the draws forced to the
   single-device run's: equal bitstrings, logq / log p/q / logps within
   5e-3; a sharded checkpoint round trip bit for bit.  Every reading is
   printed before a bar is held;
18. times: layers/s of chi10, chi64 and chi10_rolled with the kernels on
   and off (CUDA events, after warm-up), chi64 with K3 off / on / on / off;
   then each kernel on the batches of phase 2 that have the main path's
   shapes (K4: the microbenchmark's and [8,512,512]): its call time (host
   and device, CUDA events around back-to-back calls), its device time
   alone (a CUDA graph of the calls replayed between two events), its
   plain version's call time, the one PyTorch call that computes the same
   function where there is one (K4 ``a @ b``; K2 ``torch.linalg.eigh`` in
   complex64 on full-rank batches, and in complex128, the port's library
   eigh, on the n=256 batch the chi64 layers recorded, which the kernel
   must not lose to) with its call and device time, and its bound (see
   ``bound``, with the counts); K1 and K2 also the Jacobi sweeps per matrix
   (min / median / max), K4 the host path of its call and of ``a @ b``, K3
   its peak memory.

At the very end ``torch.profiler`` reads the device's busy share of the
BMPS evaluation, of the two samplers, of the all-site loop-corrected ⟨Z⟩,
of one variational step, of one chi10 layer of the generic engine (with
its count of device operations) and of one rank-4 boundary-MPS ⟨Z⟩ of the
generic engine.

Each main path (chi10, chi64, rolled, ensemble, noisy, qr, microbench,
measure, loops, variational and its no-grad energy, generic,
generic_bmps, examples, examples_fast_stack, sharded_chi32, sharded_2d,
sharded_heavyhex) runs with
every launch
counter set to 0 just before it and read just after.  The line before the last is ``{"kernels": [...]}`` (with launches per path
and per layer, ``ms``, ``device_ms``, ``plain_ms``, ``bound_ms``,
``bound_by``, ``library_ms`` and ``library_device_ms`` per kernel); the
last line is ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero and prints no result; it also exits non-zero
when no CUDA device is visible.

Two diagnostic modes print one JSON line instead:
``--time-bmps ROOT`` times the boundary-MPS calls of ``measure`` with the
package of the tree at ROOT (run it on two trees, alternating, to compare
them on one card), and ``--fast-stack CHI`` prints how far each knob
stack moves ising_2d_dynamics' ⟨Z⟩ at χ=CHI from the default knobs.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FAST_STACK = {"TNQS_EIGH_ALG": "jacobi", "TNQS_SVD_ALG": "gram",
              "TNQS_QR_ALG": "cholqr2", "TNQS_BP_KERNEL": "0"}
KERNELS_OFF = dict(FAST_STACK, TNQS_EIGH_ALG="default")
# The fast stack with the library SVD split in place of the gram split, for
# the noisy check, which holds two equivalent complex64 programs to each
# other.  The gram split squares the condition number, so it resolves
# singular values only to about sqrt(eps) of the largest: on an H100 it
# reads the noisy d=4 layer's truncation errors as 1e-10 where they are
# 5.9e-12, and moves <Z> by 1.2e-4 to 2.5e-4 between the noisy field layer
# and the equivalent compiled circuit (2e-6 to 4.5e-6 with the SVD split).
# K1 runs on both stacks; K2 serves only the gram split.
SVD_STACK = dict(FAST_STACK, TNQS_SVD_ALG="default")
BAND = 1e-4  # max site |Δ⟨Z⟩| of the Jacobi path (bench.py:166-175)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


@contextlib.contextmanager
def knobs(env: dict):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_us(fn, reps: int) -> float:
    """Host microseconds per call to enqueue ``reps`` calls back to back
    (host clock, no synchronize inside): the call's host path alone."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device_ms(fn, reps: int) -> tuple:
    """(mean device milliseconds per call, how it was measured): a CUDA
    graph of ``reps`` calls replayed between two events, so no host work
    sits between the launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "graph"


# H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor cores,
# TF32 on the tensor cores, device memory
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def bound(k: str, args) -> dict:
    """The least time the card could take for kernel k's work on ``args``,
    on the unit the kernel runs on: the larger of its bytes (each input
    read once, each output written once) over 3.35 TB/s and its operations
    over the unit's peak.  K1 and K2 run in fp32 outside the tensor cores:
    real flops over 67 TFLOP/s, eigh counted as 9 n^3 real flops, times 4
    for complex (the Hermitian QR algorithm with vectors), K1 adding its two
    reconstructions U f(w) U†.  K3 and K4 run on the tensor cores with a
    3xTF32 split: their least work is the Gauss form's, three real products
    of three TF32 products each, 18 TF32 flops per complex multiply-add,
    over 495 TFLOP/s.  For those two, ``fp32_bound_ms`` is the same product
    at the reference's fp32 outside the tensor cores (8 real flops per
    complex multiply-add, the 4-product form, over 67 TFLOP/s)."""
    macs = None
    if k == "K4":
        a, b = args
        B, N, K = a.shape
        macs = B * N * K * b.shape[2]
        nbytes = 8 * B * (N * K + K * b.shape[2] + N * b.shape[2])
    elif k == "K3":
        t, m = args
        V, chi, d = t.shape[0], t.shape[1], t.shape[-1]
        macs = 8 * V * chi**4 * d  # five absorbs, three contractions
        nbytes = t.numel() * 8 + m.numel() * 8 + V * 3 * chi * chi * 8
    else:
        (a,) = args
        B, n = a.shape[0], a.shape[-1]
        if k == "K2":
            flops, nbytes = 36 * B * n**3, B * (2 * n * n * 8 + n * 4)
        else:
            flops, nbytes = (36 + 16) * B * n**3, 3 * B * n * n * 8
    t_bytes = nbytes / PEAK_BYTES * 1e3
    if macs is None:
        unit, t_ops = "fp32", flops / PEAK_FP32 * 1e3
        out = {}
    else:
        flops = 18 * macs
        unit, t_ops = "3xTF32", flops / PEAK_TF32 * 1e3
        out = {"fp32_bound_ms": max(8 * macs / PEAK_FP32 * 1e3, t_bytes)}
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "unit": unit, "flops": flops, "bytes": nbytes, **out}


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def to_np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().resolve_conj().numpy().astype(np.complex128)


def psd(q: np.ndarray, w: np.ndarray) -> np.ndarray:
    a = (q * w[:, None, :]) @ np.conj(np.swapaxes(q, -1, -2))
    return ((a + np.conj(np.swapaxes(a, -1, -2))) / 2).astype(np.complex64)


def gram(rng, B, n, r) -> np.ndarray:
    """X·X† of a random complex [B, n, r] factor: PSD of rank min(n, r),
    the kind of batch the gram split and the environment roots feed the
    kernels (rank-deficient while bonds are still padded)."""
    x = rng.standard_normal((B, n, r)) + 1j * rng.standard_normal((B, n, r))
    a = x @ np.conj(np.swapaxes(x, -1, -2))
    return ((a + np.conj(np.swapaxes(a, -1, -2))) / 2).astype(np.complex64)


def random_unitaries(rng, B, n):
    q, _ = np.linalg.qr(rng.standard_normal((B, n, n))
                        + 1j * rng.standard_normal((B, n, n)))
    return q


def rel(x: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def assert_rank_parity(root, inv, proot, pinv, what, expect=None):
    """Kernel and plain path keep the same number of eigen-directions."""
    rank = np.real(np.trace(root @ inv, axis1=-2, axis2=-1))
    prank = np.real(np.trace(proot @ pinv, axis1=-2, axis2=-1))
    assert np.abs(rank - prank).max() < 0.05, f"{what}: rank {rank} vs {prank}"
    if expect is not None:
        assert np.abs(rank - expect).max() < 0.05, f"{what}: rank {rank}"


def compared(label, args, got, ref) -> dict:
    """One main-path-shape comparison: the kernel's gauge-free outputs
    ``got`` against the plain version's ``ref`` (pairs of tensors).
    ``abs`` is max |kernel - plain| over all elements; ``rel`` divides each
    output's error by that output's max |plain| first."""
    e_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    e_rel = max(float((g - r).abs().max() / r.abs().max())
                for g, r in zip(got, ref))
    return {"shape": label, "args": args, "abs": e_abs, "rel": e_rel}


def check_k1(dev, rng, cl) -> list:
    """Bars of tests/test_pallas_linalg.py:338-383, at the chi10 main
    path's largest batch (B=72) and n = 8, 10, 32, 40.  Returns the
    main-path-shape comparison (n=10, well-conditioned)."""
    B = 72  # 12 edges x 6 environments: the largest chi10 colour group
    entries = []
    for b in (6, 36):  # chi10_rolled's slot-pair buckets
        q = random_unitaries(rng, b, 10)
        at = torch.from_numpy(psd(q, (0.1 + np.linspace(0, 1, 10))[None, :]
                                  * np.ones((b, 1)))).to(dev)
        entry = compared(f"{b}x10x10 well-conditioned", (at,),
                         cl.jacobi_pseudo_roots(at), cl.pseudo_roots_plain(at))
        assert entry["abs"] < 2e-4, f"K1 {entry['shape']}: {entry['abs']:.3e}"
        entries.append(entry)
    for n in (8, 10, 32, 40):
        q = random_unitaries(rng, B, n)
        ones = np.ones((B, 1))
        ill = psd(q, np.concatenate([np.logspace(0, -5, n - 2), [1e-9, 1e-9]])
                  [None, :] * ones)
        ill[-1] = np.eye(n)  # a padded/dummy slot
        well = psd(q, (0.1 + np.linspace(0, 1, n))[None, :] * ones)
        deficient = gram(rng, B, n, 3)
        out = {}
        for name, a in (("ill", ill), ("well", well), ("deficient", deficient)):
            at = torch.from_numpy(a).to(dev)
            root, inv = cl.jacobi_pseudo_roots(at)
            proot, pinv = cl.pseudo_roots_plain(at)
            if name == "well" and n == 10:
                entries.insert(0, compared(f"{B}x{n}x{n} well-conditioned",
                                           (at,), (root, inv), (proot, pinv)))
            out[name] = [to_np(x) for x in (root, inv, proot, pinv)]
            r = out[name][0]
            rec = rel(r @ r, a.astype(np.complex128))
            assert rec < 2e-5, f"K1 n={n} {name}: |root^2-A|/|A| = {rec:.3e}"
        root, inv, proot, pinv = out["well"]
        e_root = float(np.abs(root - proot).max())
        e_inv = float(np.abs(inv - pinv).max())
        assert e_root < 2e-5 and e_inv < 2e-4, (
            f"K1 n={n} well-conditioned vs plain: root {e_root:.3e}, "
            f"inv {e_inv:.3e}")
        root, inv, proot, pinv = out["ill"]
        e_id = max(np.abs(root[-1] - np.eye(n)).max(),
                   np.abs(inv[-1] - np.eye(n)).max())
        assert e_id < 1e-6, f"K1 n={n}: identity env gives roots off by {e_id:.3e}"
        rng_id = rel(root @ inv @ root, root)  # root*inv is I on the range
        assert rng_id < 1e-4, f"K1 n={n} ill: |r s r - r|/|r| = {rng_id:.3e}"
        assert_rank_parity(root, inv, proot, pinv, f"K1 n={n} ill")
        root, inv, proot, pinv = out["deficient"]
        assert_rank_parity(root, inv, proot, pinv, f"K1 n={n} deficient", 3)
        piv = rel(root @ inv @ root, root)
        assert piv < 1e-4, f"K1 n={n} deficient: |r s r - r|/|r| = {piv:.3e}"
        log("k1", f"B={B} n={n}: well-conditioned vs plain root {e_root:.2e} "
                  f"inv {e_inv:.2e}; identity {e_id:.1e}; rank parity ok")
    return entries


def check_eigh(a, w, v, tol):
    """Bars of tests/test_pallas_linalg.py:21-32."""
    n = a.shape[-1]
    w = w.detach().cpu().numpy().astype(np.float64)
    v = to_np(v)
    w_ref = np.linalg.eigvalsh(a.astype(np.complex128))
    scale = np.abs(w_ref).max()
    e_w = float(np.max(np.abs(w - w_ref)) / scale)
    recon = np.einsum("bij,bj,bkj->bik", v, w, np.conj(v))
    e_rec = rel(recon, a.astype(np.complex128))
    e_unit = float(np.abs(np.einsum("bji,bjk->bik", np.conj(v), v)
                          - np.eye(n)).max())
    ok = (np.all(np.diff(w, axis=-1) >= -tol) and e_w < tol
          and e_rec < tol and e_unit < tol)
    return ok, e_w, e_rec, e_unit


def assert_eigh(cl, at, tol, what) -> dict:
    """K2 on one batch: the `_check` bars, and eigenvalues against the
    plain version (relative to the largest).  Returns the comparison."""
    w, v = cl.jacobi_eigh(at)
    ok, e_w, e_rec, e_unit = check_eigh(to_np(at), w, v, tol)
    assert ok, (f"K2 {what}: eigenvalues {e_w:.3e}, reconstruction "
                f"{e_rec:.3e}, unitarity {e_unit:.3e} (bar {tol})")
    pw, _ = cl.eigh_plain(at)
    entry = compared(what, (at,), (w,), (pw,))
    assert entry["rel"] < tol, (
        f"K2 {what}: eigenvalues vs plain {entry['rel']:.3e} (bar {tol})")
    entry["log"] = (f"eigenvalues {e_w:.2e}, reconstruction {e_rec:.2e}, "
                    f"unitarity {e_unit:.2e}; vs plain {entry['rel']:.2e}")
    return entry


def check_k2(dev, rng, cl) -> list:
    """Random hermitian batches at n = 32, 40, 64, 88 (one CTA a matrix) and
    128, 256 (a cluster of 8 CTAs a matrix), then PSD batches at the main
    path's shapes, full rank and rank-deficient: the chi10 gram split
    [12,40,40], the chi64 environment roots [200,64,64], the chi64 gram
    split's size [6,256,256] / [48,256,256], [4,128,128], and the rolled
    path's buckets of 1, 3 and 7 matrices.  Returns the main-path-shape
    comparisons."""
    entries = []
    for n in (32, 40, 64, 88, 128, 256):
        assert cl.eigh_kernel_supported(n, 8), n
        m = rng.standard_normal((8, n, n)) + 1j * rng.standard_normal((8, n, n))
        a = ((m + np.conj(np.swapaxes(m, -1, -2))) / 2).astype(np.complex64)
        at = torch.from_numpy(a).to(dev)
        entry = assert_eigh(cl, at, 2e-4, f"8x{n}x{n} hermitian")
        # the raw kernel, before the wrapper's Newton-Schulz pass: how far
        # the accumulated rotations drift from unitary with IEEE div/sqrt
        _, v_raw = cl.jacobi_eigh_raw(at)
        vr = to_np(v_raw)
        raw_unit = float(np.abs(np.einsum("bji,bjk->bik", np.conj(vr), vr)
                                - np.eye(n)).max())
        log("k2", f"{entry['shape']}: {entry['log']} (raw kernel unitarity "
                  f"{raw_unit:.2e})")
    for B, n, r in ((12, 40, 40), (12, 40, 10), (200, 64, 64), (200, 64, 16),
                    (1, 40, 10), (3, 40, 10), (7, 40, 10), (4, 128, 128),
                    (4, 128, 32), (6, 256, 256), (48, 256, 64)):
        at = torch.from_numpy(gram(rng, B, n, r)).to(dev)
        entry = assert_eigh(cl, at, 2e-4, f"{B}x{n}x{n} gram rank {r}")
        log("k2", f"{entry['shape']}: {entry['log']}")
        entries.append(entry)
    return entries


def random_vertex_state(rng, V, chi, d):
    shape = (V, chi, chi, chi, d)
    t = (rng.standard_normal(shape, dtype=np.float32)
         + 1j * rng.standard_normal(shape, dtype=np.float32)).astype(
        np.complex64) / chi
    m = (rng.standard_normal((V, 3, chi, chi), dtype=np.float32)
         + 1j * rng.standard_normal((V, 3, chi, chi), dtype=np.float32)
         ).astype(np.complex64)
    return t, m + np.conj(np.swapaxes(m, -1, -2))


def check_k3(dev, rng, cb) -> list:
    """Scaled atol 2e-5 (tests/test_pallas_bp.py:55) at V=127, χ = 8 and
    64, d=2.  Returns the main-path-shape comparison (χ=64)."""
    entries = []
    for chi in (8, 64):
        t, m = random_vertex_state(rng, 127, chi, 2)
        tt_, mt = torch.from_numpy(t).to(dev), torch.from_numpy(m).to(dev)
        entry = compared(f"127x{chi}x{chi}x{chi}x2", (tt_, mt),
                         (cb.bp_outgoing_d3(tt_, mt),),
                         (cb.bp_outgoing_plain(tt_, mt),))
        assert entry["rel"] < 2e-5, (
            f"K3 chi={chi}: scaled error {entry['rel']:.3e} (bar 2e-5)")
        log("k3", f"V=127 chi={chi} d=2: scaled max error vs plain "
                  f"{entry['rel']:.2e}")
        if chi == 64:
            entries.append(entry)
    return entries


K4_SHAPES = (((8, 128, 128), (8, 128, 128)), ((16, 40, 40), (16, 40, 40)),
             ((3, 128, 128), (3, 128, 128)), ((2, 64, 128), (2, 128, 256)),
             ((5, 33, 17), (5, 17, 65)), ((8, 512, 512), (8, 512, 512)))
# timed: the microbenchmark's shapes, and a batch whose device time is above
# launch scale
K4_TIMED = ("8x128x128@8x128x128", "16x40x40@16x40x40", "8x512x512@8x512x512")


def check_k4(dev, rng, cm) -> list:
    """Bar of tests/test_pallas_kernels.py:24,39, max|C - A@B| / max|A@B|
    < 1e-5, against a complex128 numpy A@B and against the plain version,
    on the reference tests' shapes, the microbenchmark's, a ragged one and
    [8,512,512].  Returns the comparisons at the timed shapes."""
    entries = []
    for sa, sb in K4_SHAPES:
        a = (rng.standard_normal(sa) + 1j * rng.standard_normal(sa)).astype(
            np.complex64)
        b = (rng.standard_normal(sb) + 1j * rng.standard_normal(sb)).astype(
            np.complex64)
        ref = a.astype(np.complex128) @ b.astype(np.complex128)
        at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        c = cm.complex_matmul(at, bt)
        p = cm.complex_matmul_plain(at, bt)
        scale = np.abs(ref).max()
        e_ref = float(np.abs(to_np(c) - ref).max() / scale)
        e_plain_ref = float(np.abs(to_np(p) - ref).max() / scale)
        label = "x".join(map(str, sa)) + "@" + "x".join(map(str, sb))
        entry = compared(label, (at, bt), (c,), (p,))
        entry["ref"] = e_ref
        assert e_ref < 1e-5 and entry["rel"] < 1e-5, (
            f"K4 {label}: vs complex128 {e_ref:.3e}, vs plain "
            f"{entry['rel']:.3e} (bar 1e-5)")
        log("k4", f"{label}: scaled error vs complex128 {e_ref:.2e} (plain "
                  f"{e_plain_ref:.2e}), vs plain {entry['rel']:.2e} (bar 1e-5)")
        if label in K4_TIMED:
            entries.append(entry)
    return entries


@contextlib.contextmanager
def recording(targets: dict):
    """Record what the main path hands each kernel wrapper: for every
    input shape, the first and the latest arguments.  ``targets`` maps a
    kernel to the (module, attribute) its caller looks the wrapper up in."""
    seen = {k: {} for k in targets}
    saved = {k: getattr(mod, attr) for k, (mod, attr) in targets.items()}

    def wrap(k, fn):
        def recorded(*args):
            copy = tuple(a.clone() for a in args)
            calls = seen[k].setdefault(tuple(args[0].shape), [copy])
            if calls[0] is not copy:
                calls[1:] = [copy]
            return fn(*args)
        return recorded

    for k, (mod, attr) in targets.items():
        setattr(mod, attr, wrap(k, saved[k]))
    try:
        yield seen
    finally:
        for k, (mod, attr) in targets.items():
            setattr(mod, attr, saved[k])


def check_recorded(name, seen, cl, cb) -> None:
    """Each kernel against its plain version on the main path's own
    inputs.  K1: root² = A to 2e-5 and root·inv·root = root to 1e-4 (the
    keep/zero decision of an eigenvalue at the 10·ε·λmax clip may differ
    between two correct paths, so roots are not compared element-wise
    here); K2: the `_check` bars and eigenvalues vs plain at 2e-4; K3:
    scaled atol 2e-5."""
    worst = {}
    for shape, calls in seen.get("K1", {}).items():
        for (h,) in calls:
            root, inv = (to_np(x) for x in cl.jacobi_pseudo_roots(h))
            a = to_np(h)
            rec = rel(root @ root, a)
            piv = rel(root @ inv @ root, root)
            assert rec < 2e-5 and piv < 1e-4, (
                f"{name} K1 {shape}: |root^2-A|/|A| {rec:.3e}, "
                f"|r s r - r|/|r| {piv:.3e}")
            worst["K1"] = max(worst.get("K1", 0.0), rec)
    for shape, calls in seen.get("K2", {}).items():
        if not cl.eigh_kernel_supported(shape[-1], shape[0]):
            continue  # routed to the library eigh, no kernel
        for (h,) in calls:
            entry = assert_eigh(cl, h, 2e-4, f"{name} {shape}")
            worst["K2"] = max(worst.get("K2", 0.0), entry["rel"])
    for shape, calls in seen.get("K3", {}).items():
        for t, m in calls:
            entry = compared(str(shape), (), (cb.bp_outgoing_d3(t, m),),
                             (cb.bp_outgoing_plain(t, m),))
            assert entry["rel"] < 2e-5, (
                f"{name} K3 {shape}: scaled error {entry['rel']:.3e}")
            worst["K3"] = max(worst.get("K3", 0.0), entry["rel"])
    shapes = {k: sorted(v) for k, v in seen.items()}
    log(name, f"kernels vs plain on the main path's own inputs (first and "
              f"last call of each shape {shapes}): worst K1 |root^2-A|/|A|, "
              f"K2 / K3 relative error vs plain: "
              f"{ {k: f'{e:.2e}' for k, e in worst.items()} }")


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------


def tfim_layer(tt, g, dt=0.25, hx=1.0, hz=0.8, J=0.5):
    """The bench's 5x5 TFIM layer (bench.py:273-279)."""
    layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
    layer += [("Rz", [v], 2 * hz * dt) for v in g.vertices()]
    for ce in tt.edge_color(g, 4):
        layer += [("Rzz", pair, 2 * J * dt) for pair in ce]
    return layer


def eagle_layer(tt, g):
    """The bench's Eagle kicked-Ising layer (bench.py:264-271)."""
    layer = [("Rx", [v], 0.4) for v in g.vertices()]
    for group in tt.edge_color(g, 3):
        layer += [("Rzz", pair, 2 * (3.14159 / 4)) for pair in group]
    return layer


def build_config(tt, dev, name):
    """(spec, initial state, layer module) of a bench configuration, with
    the bench's layer settings (bench.py:286-299)."""
    if name == "chi10":
        g, chi = tt.named_grid((5, 5)), 10
        layer = tfim_layer(tt, g)
    else:  # the Eagle lattice: "chi64", or "heavyhex" at χ=8
        g, chi = tt.ibm_eagle_lattice(), 64 if name == "chi64" else 8
        layer = eagle_layer(tt, g)
    spec, state = tt.batched_product_state(g, chi=chi, dtype=torch.complex64,
                                           device=dev)
    layer_fn = tt.make_layer_fn(
        tt.BatchedCircuit(layer, g, spec=spec), chi=chi, cutoff=1e-10,
        normalize_tensors=True, bp_maxiter=25, device=dev,
    )
    return spec, state, layer_fn


def run_layers(tt, dev, name, n, env):
    with knobs(env):
        spec, state, layer_fn = build_config(tt, dev, name)
        z_fn = tt.make_expectation_fn(spec, tt.op_matrix("Z", 2),
                                      real_output=True)
        for _ in range(n):
            state, errs = layer_fn(state)
        z = z_fn(state).cpu().numpy()
        torch.cuda.synchronize()
    assert np.isfinite(z).all(), f"{name}: non-finite <Z>"
    assert torch.isfinite(errs).all(), f"{name}: non-finite truncation error"
    return z


def counted(counters, name, required, run):
    """Run one main path with every launch counter at 0 just before it;
    return (launches just after, what ``run`` returned), and fail if a
    required kernel never launched."""
    for c in counters.values():
        c.reset()
    out = run()
    launches = {k: c.count for k, c in counters.items()}
    for k in required:
        assert launches[k] > 0, f"{name}: kernel {k} was never launched"
    return launches, out


def main_path(counters, name, run, env, required, targets):
    """Run the main path once (``run(env)`` returns per-site ⟨Z⟩), counted
    and recording what it hands each kernel; assert ⟨Z⟩ agrees with the
    kernels-off path.  Returns (launches, recorded, ⟨Z⟩)."""
    with recording(targets) as seen:
        launches, z_on = counted(counters, name, required, lambda: run(env))
    z_off = run(KERNELS_OFF)
    dz = float(np.abs(z_on - z_off).max())
    assert dz <= BAND, f"{name}: max site |dZ| kernels on/off {dz:.3e} > {BAND}"
    log(name, f"launches {launches}; <Z> finite, mean {z_on.mean():.6f}; "
              f"max site |dZ| vs kernels off {dz:.2e} (bar {BAND})")
    return launches, seen, z_on


def physics_check(tt, dev):
    sys.path.insert(0, str(REPO / "tests"))
    from dense_oracle import dense_z_trajectory

    g = tt.named_grid((3, 3))
    layer = tfim_layer(tt, g)
    golden = dense_z_trajectory(g, layer, 3, (2, 2))
    spec, state = tt.batched_product_state(g, chi=8, dtype=torch.complex64,
                                           device=dev)
    layer_fn = tt.make_layer_fn(
        tt.BatchedCircuit(layer, g, spec=spec), chi=8, cutoff=0.0,
        normalize_tensors=False, bp_maxiter=100, bp_tolerance=1e-14,
        device=dev,
    )
    z_fn = tt.make_expectation_fn(spec, tt.op_matrix("Z", 2), real_output=True)
    pos = spec.vertex_position((2, 2))
    traj = []
    for _ in range(3):
        state, _ = layer_fn(state)
        traj.append(float(z_fn(state)[pos]))
    dz = float(np.abs(np.array(traj) - np.array(golden)).max())
    assert dz <= 1e-4, f"3x3 dense oracle: max |dZ| {dz:.3e} > 1e-4"
    log("physics", f"3x3 TFIM chi=8 c64, 3 layers: BP <Z> {traj} vs dense "
                   f"{[round(x, 7) for x in golden]}: max |dZ| {dz:.2e} (bar 1e-4)")


# ---------------------------------------------------------------------------
# phases 6-10: the rolled, bond, ensemble, noisy and microbenchmark paths
# ---------------------------------------------------------------------------

ROLLS = 64  # distinct angle sets of chi10_rolled (bench.py:240)


def rolled_angles(spec, dev):
    """The bench's 64 rolled angle sets (bench.py:240-252): site angles
    [64, 2, V] for the (X, Z) rotations, bond angles [64, E], float32."""
    V, E = spec.num_vertices, len(spec.edges)
    rr = np.arange(ROLLS, dtype=np.float32)
    site = np.stack([
        0.5 * (1.0 + 0.05 * np.sin(rr)[:, None] + np.zeros((ROLLS, V))),
        0.4 * (1.0 + 0.05 * np.cos(rr)[:, None] + np.zeros((ROLLS, V))),
    ], axis=1).astype(np.float32)
    bond = (0.25 * (1.0 + 0.05 * np.sin(2.0 * rr)[:, None]
                    + np.zeros((ROLLS, E)))).astype(np.float32)
    return torch.from_numpy(site).to(dev), torch.from_numpy(bond).to(dev)


def build_rolled(tt, dev):
    """(spec, state, field layer, site rolls, bond rolls) of chi10_rolled:
    5x5 grid, χ=10, site_pauli=(X, Z), bond_pauli=ZZ, cutoff 1e-10,
    bp_maxiter=25, complex64 (bench.py:228-239)."""
    g, chi = tt.named_grid((5, 5)), 10
    spec, state = tt.batched_product_state(g, chi=chi, dtype=torch.complex64,
                                           device=dev)
    _, layer = tt.parallel.make_field_layer_fn(
        g, chi=chi, site_pauli=("X", "Z"), bond_pauli="ZZ", cutoff=1e-10,
        bp_maxiter=25, spec=spec, device=dev,
    )
    return (spec, state, layer) + rolled_angles(spec, dev)


def run_rolled(tt, dev, n, env):
    """n rolled layers (layer i takes angle set i mod 64); returns the
    spec, the state and per-site ⟨Z⟩."""
    with knobs(env):
        spec, state, layer, site, bond = build_rolled(tt, dev)
        for i in range(n):
            state, errs = layer(state, site[i % ROLLS], bond[i % ROLLS])
        z = tt.local_expectations(spec, state, tt.op_matrix("Z", 2)
                                  ).real.cpu().numpy()
        torch.cuda.synchronize()
    assert np.isfinite(z).all(), "rolled: non-finite <Z>"
    assert torch.isfinite(errs).all(), "rolled: non-finite truncation error"
    return spec, state, z


def bonds_check(tt, spec, state):
    """⟨Z⊗Z⟩ on every edge two ways: ``bond_expectations`` and the trace
    of ``bond_rdms`` against Z⊗Z."""
    z = tt.op_matrix("Z", 2)
    zz = tt.parallel.bond_expectations(spec, state, z, z).real.cpu().numpy()
    rho = tt.parallel.bond_rdms(spec, state).cpu().numpy()
    zz_rdm = np.real(np.einsum("esxcy,xs,yc->e", rho, z, z))
    assert zz.shape == (len(spec.edges),) and np.isfinite(zz).all()
    diff = float(np.abs(zz - zz_rdm).max())
    assert diff <= 1e-5 and np.abs(zz).max() <= 1 + 1e-5, (
        f"bonds: |ZZ - Tr(rho ZZ)| {diff:.3e}")
    log("bonds", f"{len(zz)} edges: <ZZ> in [{zz.min():.5f}, {zz.max():.5f}]; "
                 f"max |bond_expectations - Tr(bond_rdms ZZ)| {diff:.2e} "
                 f"(bar 1e-5)")


ENSEMBLE = 8
ENSEMBLE_LAYERS = 6
# Where a member's BP stops at another sweep than its single run's, the two
# distances read at that sweep must lie on either side of the tolerance and
# within this fraction of it of each other: the states that feed a flip
# differ only by rounding.  On an H100 the one flip in twelve runs (one per
# PYTHONHASHSEED 0-11) read 1.0009e-5 in the fold and 9.9912e-6 alone.
FLIP_MARGIN = 0.1


def member_angles(site, bond, layer, members=None):
    """Member e's angles at a layer: the roll 8·e ahead of the layer's,
    scaled by (1 + e)/2, so that stronger members need more BP sweeps (in
    12 of the 30 refreshes of this run, members stop at different sweeps).
    At the bench's own angles every refresh stops all members together."""
    e = torch.arange(ENSEMBLE, device=site.device)
    if members is not None:
        e = e[members]
    j = (layer + 8 * e) % ROLLS
    f = (0.5 * (1 + e)).to(site.dtype)
    return site[j] * f[:, None, None], bond[j] * f[:, None]


@contextlib.contextmanager
def bp_decisions(engine):
    """Record every flooding-BP refresh the batched engine runs inside
    (``engine._fixed_point``): yields a list that gains, per refresh, (its
    tolerance, one [members] array of message distances per sweep)."""
    refreshes, open_ = [], []
    fixed, measure = engine._fixed_point, engine._message_distance

    def recorded_fixed(iterate, m, mask, maxiter, tolerance, *rest):
        refreshes.append((tolerance, []))
        open_.append(refreshes[-1][1])
        try:
            return fixed(iterate, m, mask, maxiter, tolerance, *rest)
        finally:
            open_.pop()

    def recorded_distance(*args, **kwargs):
        out = measure(*args, **kwargs)
        if open_:
            open_[-1].append(out.detach().cpu().numpy())
        return out

    engine._fixed_point, engine._message_distance = (recorded_fixed,
                                                     recorded_distance)
    try:
        yield refreshes
    finally:
        engine._fixed_point, engine._message_distance = fixed, measure


def bp_flip(one, other, member=None):
    """None where every refresh stopped each member's BP at the same sweep
    in both runs (``bp_decisions``' records); else (refresh, member, the
    two runs' distances at the earlier of the two stops, the tolerance) of
    the first refresh where they did not.  With ``member`` set, only that
    member of ``one`` is compared, with ``other``'s single member (its run
    alone)."""
    assert len(one) == len(other), (len(one), len(other))
    for i, ((tol, a), (_, b)) in enumerate(zip(one, other)):
        pairs = ([(member, 0)] if member is not None else
                 [(e, e) for e in range(a[0].shape[0] if a else 0)])
        for e, f in pairs:
            sa, sb = stop_sweep(a, tol, e), stop_sweep(b, tol, f)
            if sa != sb:
                k = min(x for x in (sa, sb) if x is not None)
                return i, e, float(a[k][e]), float(b[k][f]), tol
    return None


def stop_sweep(sweeps, tol, e=0):
    """The sweep at which member e's BP stopped in one refresh: the first
    whose distance fell to the tolerance (None: it ran to maxiter)."""
    return next((s for s, d in enumerate(sweeps) if d[e] <= tol), None)


def straddles(d_a, d_b, tol):
    """Whether two runs' BP distances at a sweep where one stopped and the
    other went on lie on either side of the tolerance, within FLIP_MARGIN
    x tolerance of each other: a decision taken apart by rounding."""
    lo, hi = sorted((d_a, d_b))
    return lo <= tol < hi and hi - lo <= FLIP_MARGIN * tol


def ensemble_check(tt, dev, engine, counters, required):
    """8 rolled realizations, distinct angles, in one folded program at the
    default BP tolerance (counted), held to 1e-5 against the same fold run
    with each member's angles in all 8 slots: the batches then have the
    same shapes, so the kernels and libraries round alike, and what is
    compared is the fold itself (indices, per-member BP stopping).

    Each member is also held against its single run of each layer from the
    same input state, and against its single runs left to themselves from
    the start.  Those are complex64 programs with other batch sizes, whose
    other rounding a strongly driven, truncated layer amplifies, so they
    are held to the band of two equivalent complex64 programs (BAND), as
    long as the member's BP stopped at the same sweep as its single run's
    in every refresh.  Where it did not, the two runs took a different
    decision, not a different path to the same one: one more sweep moves
    the messages by up to a fidelity distance of the tolerance, which a
    driven layer turns into |d<Z>| of 1e-4 and more.  Such a flip must
    straddle the tolerance: the two runs' distances at the earlier stop
    lie on either side of it and within FLIP_MARGIN x tolerance of each
    other.  Flips are counted and printed, with their |d<Z>|.
    Returns (launches, ensemble seconds per layer, single seconds per
    member-layer)."""
    ens_mod = tt.parallel.ensemble
    spec, s0, layer, site, bond = build_rolled(tt, dev)
    z_fn = ens_mod.make_ensemble_expectation_fn(spec, tt.op_matrix("Z", 2),
                                                True)
    tol = engine.default_batched_tolerance(s0.tensors.dtype)
    elayer = ens_mod.ensemble_fn(layer)

    def run():
        states = [ens_mod.stack_states([s0] * ENSEMBLE)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ENSEMBLE_LAYERS):
            states.append(elayer(states[-1], *member_angles(site, bond, i))[0])
        torch.cuda.synchronize()
        return states, (time.perf_counter() - t0) / ENSEMBLE_LAYERS

    with bp_decisions(engine) as fold:
        launches, (states, t_ens) = counted(counters, "ensemble", required,
                                            run)
    R = len(fold) // ENSEMBLE_LAYERS  # BP refreshes per layer
    assert R * ENSEMBLE_LAYERS == len(fold), len(fold)
    stops = [tuple(stop_sweep(sw, t, e) for e in range(ENSEMBLE))
             for t, sw in fold]
    z_ens = [z_fn(st).cpu().numpy() for st in states[1:]]
    assert all(np.isfinite(z).all() for z in z_ens), "ensemble: non-finite <Z>"

    def single(st, i, e):
        s_e, b_e = member_angles(site, bond, i, [e])
        with bp_decisions(engine) as sweeps:
            out = layer(st, s_e[0], b_e[0])[0]
        return out, sweeps

    flips = []

    def held(where, e, fold_sweeps, single_sweeps, dz):
        """|d<Z>| of member e, held to BAND unless BP stopped apart; then
        the flip must straddle the tolerance.  Returns the |d<Z>| held."""
        flip = bp_flip(fold_sweeps, single_sweeps, member=e)
        if flip is None:
            assert dz <= BAND, (
                f"ensemble: member {e} {where}: max site |dZ| vs its single "
                f"run {dz:.3e} (bar {BAND}), BP stopped alike")
            return dz
        _, _, d_f, d_s, _ = flip
        assert straddles(d_f, d_s, tol), (
            f"ensemble: member {e} {where}: BP stopped apart from its single "
            f"run at distances {d_f:.6e} / {d_s:.6e}, which do not straddle "
            f"the tolerance {tol} within {FLIP_MARGIN} x tolerance")
        flips.append(f"{where}, member {e}: distances {d_f:.4e} / {d_s:.4e}, "
                     f"|dZ| {dz:.2e}")
        return 0.0

    per_layer = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ENSEMBLE_LAYERS):
        inputs = ens_mod.unstack_states(states[i])
        outs, sweeps = zip(*(single(inputs[e], i, e)
                             for e in range(ENSEMBLE)))
        dz = np.abs(z_fn(ens_mod.stack_states(list(outs))).cpu().numpy()
                    - z_ens[i]).max(axis=1)
        for e in range(ENSEMBLE):
            per_layer = max(per_layer, held(
                f"layer {i} from the same input", e,
                fold[i * R:(i + 1) * R], sweeps[e], float(dz[e])))
    t_single = (time.perf_counter() - t0) / (ENSEMBLE * ENSEMBLE_LAYERS)
    free, free_sweeps = [s0] * ENSEMBLE, [[] for _ in range(ENSEMBLE)]
    for i in range(ENSEMBLE_LAYERS):
        for e in range(ENSEMBLE):
            free[e], sweeps = single(free[e], i, e)
            free_sweeps[e] += sweeps
    dz = np.abs(z_fn(ens_mod.stack_states(free)).cpu().numpy()
                - z_ens[-1]).max(axis=1)
    drift = max(held("from the start", e, fold, free_sweeps[e], float(dz[e]))
                for e in range(ENSEMBLE))
    same = 0.0
    for e in range(ENSEMBLE):
        st = states[0]
        for i in range(ENSEMBLE_LAYERS):
            st = elayer(st, *member_angles(site, bond, i, [e] * ENSEMBLE))[0]
        same = max(same, float(np.abs(z_fn(st).cpu().numpy()
                                      - z_ens[-1][e]).max()))
    assert same <= 1e-5, (
        f"ensemble: max site |dZ| vs the fold of each member alone {same:.3e} "
        f"(bar 1e-5)")
    apart = sum(len(set(s)) > 1 for s in stops)
    assert apart > 0, f"ensemble: every member stopped together: {stops}"
    log("ensemble", f"E={ENSEMBLE}, {ENSEMBLE_LAYERS} layers: launches "
                    f"{launches}; max site |dZ| vs the fold of each member in "
                    f"all {ENSEMBLE} slots {same:.2e} (bar 1e-5); vs the "
                    f"single runs of each layer from the same inputs "
                    f"{per_layer:.2e}, vs single runs from the start "
                    f"{drift:.2e} (bar {BAND}, members whose BP stopped "
                    f"alike); members stopped at different sweeps in {apart} "
                    f"of {len(stops)} BP refreshes; per-member stop sweep "
                    f"(None = ran to maxiter) of each refresh: {stops}")
    log("ensemble", f"{len(flips)} of {ENSEMBLE * (ENSEMBLE_LAYERS + 1)} "
                    f"member comparisons stopped BP at another sweep than the "
                    f"single run, straddling the tolerance {tol} within "
                    f"{FLIP_MARGIN} x tolerance (fold / single distance): "
                    f"{flips}")
    return launches, t_ens, t_single


def rho_circuit(tt, g, th, phi, p_dep, gam):
    circuit = [("Rx", [v], th) for v in g.vertices()]
    for grp in tt.edge_color(g, 4):
        circuit += [("Rzz", pair, phi) for pair in grp]
    circuit += [("depolarizing", [v], p_dep) for v in g.vertices()]
    circuit += [("amplitude_damping", [v], gam) for v in g.vertices()]
    return circuit


NOISY = dict(th=0.31, phi=0.22, p_dep=0.05, gam=0.08)
NOISY_LAYERS = 2


def noisy_layers(tt, dev, counters):
    """The parametric noisy layer on the 5x5 grid at χ=8 (d=4 Pauli sites,
    complex64, fast stack with the SVD split), counted; then the same layers compiled from
    the tuple circuit in the density-matrix picture; both read out through
    the sandwich-BP Pauli expectations.  Returns (launches, spec, the noisy
    layer's final state)."""
    g, chi = tt.named_grid((5, 5)), 8
    spec, s0 = tt.batched_product_state(g, chi=chi, state_fn=lambda v: "0",
                                        dtype=torch.complex64, d=4,
                                        device=dev)
    kw = dict(cutoff=1e-10, normalize_tensors=False, bp_maxiter=25)
    rates = torch.tensor([NOISY["p_dep"], NOISY["gam"]], device=dev)
    with knobs(SVD_STACK):
        _, noisy = tt.parallel.make_noisy_field_layer_fn(
            g, chi, site_pauli="X", bond_pauli="ZZ",
            noise=("depolarizing", "amplitude_damping"), spec=spec,
            device=dev, **kw)

        def run():
            st = s0
            for _ in range(NOISY_LAYERS):
                st, errs = noisy(st, NOISY["th"], NOISY["phi"], rates)
            torch.cuda.synchronize()
            return st, errs

        launches, (state_a, errs) = counted(counters, "noisy", ("K1",), run)
        ref = tt.make_layer_fn(
            tt.BatchedCircuit(rho_circuit(tt, g, **NOISY), g, spec=spec, d=4,
                              picture="rho"), chi=chi, device=dev, **kw)
        state_b = s0
        for _ in range(NOISY_LAYERS):
            state_b, _ = ref(state_b)
        fn = tt.parallel.make_pauli_expectation_fn(spec, chi, torch.complex64,
                                                   ops=("Z", "X"))
        va, vb = fn(state_a), fn(state_b)
    worst = {}
    for op in ("Z", "X"):
        a, b = va[op].cpu().numpy(), vb[op].cpu().numpy()
        assert np.isfinite(a).all() and np.abs(a).max() <= 1 + 1e-4, (
            f"noisy: <{op}> out of range")
        worst[op] = float(np.abs(a - b).max())
        assert worst[op] <= BAND, (
            f"noisy: max site |d<{op}>| vs the rho circuit {worst[op]:.3e}")
    assert torch.isfinite(errs).all(), "noisy: non-finite truncation error"
    log("noisy", f"{NOISY_LAYERS} layers: launches {launches}; <Z> mean "
                 f"{va['Z'].mean():.6f}, <X> mean {va['X'].mean():.6f}; max "
                 f"site |d<Z>| {worst['Z']:.2e}, |d<X>| {worst['X']:.2e} vs "
                 f"BatchedCircuit(picture='rho') (bar {BAND})")
    return launches, spec, state_a


@contextlib.contextmanager
def package_defaults():
    """Every ``TNQS_*`` knob unset: the stack a user gets (library eigh,
    library SVD split, the library QR of ``engine._qr_split``, no K3)."""
    old = {k: v for k, v in os.environ.items() if k.startswith("TNQS_")}
    for k in old:
        del os.environ[k]
    try:
        yield
    finally:
        os.environ.update(old)


@contextlib.contextmanager
def every_call(module, attr):
    """Record every first argument handed to ``module.attr`` (a clone)."""
    calls, fn = [], getattr(module, attr)

    def recorded(a, *args):
        calls.append(a.detach().clone())
        return fn(a, *args)

    setattr(module, attr, recorded)
    try:
        yield calls
    finally:
        setattr(module, attr, fn)


def qr_phase(tt, dev, engine, cl, counters):
    """The default QR split on the card: the chi10 (5 layers), chi64 (2)
    and noisy (2) layers from their product states with no ``TNQS_*`` knob
    set, every matrix handed to ``engine._qr_split`` recorded (the first
    layers' padded bonds are zero columns, i.e. equal columns).  Each batch
    must split into finite Q and R with |QR - A|/|A| <= 1e-5 per matrix,
    and |diag R| must match ``library_qr`` (one matrix per call) to 1e-4 of
    the matrix's largest.  Returns the launches (counted over the three
    runs)."""
    def noisy_run():
        g = tt.named_grid((5, 5))
        spec, st = tt.batched_product_state(g, chi=8, state_fn=lambda v: "0",
                                            dtype=torch.complex64, d=4,
                                            device=dev)
        rates = torch.tensor([NOISY["p_dep"], NOISY["gam"]], device=dev)
        _, noisy = tt.parallel.make_noisy_field_layer_fn(
            g, 8, site_pauli="X", bond_pauli="ZZ",
            noise=("depolarizing", "amplitude_damping"), spec=spec,
            device=dev, cutoff=1e-10, normalize_tensors=False, bp_maxiter=25)
        for _ in range(NOISY_LAYERS):
            st, errs = noisy(st, NOISY["th"], NOISY["phi"], rates)
        assert torch.isfinite(errs).all(), "qr: noisy layer not finite"

    recorded = {}

    def run():
        for name, n in (("chi10", LAYERS["chi10"]), ("chi64", LAYERS["chi64"]),
                        ("noisy", NOISY_LAYERS)):
            with every_call(engine, "_qr_split") as calls:
                if name == "noisy":
                    noisy_run()
                else:
                    run_layers(tt, dev, name, n, {})
            recorded[name] = calls

    with package_defaults():
        launches, _ = counted(counters, "qr", (), run)
        for name, calls in recorded.items():
            worst, zero_cols, shapes = {"recon": 0.0, "diag": 0.0}, 0, set()
            for a in calls:
                q, r = engine._qr_split(a)
                finite = bool(torch.isfinite(torch.view_as_real(q)).all()
                              and torch.isfinite(torch.view_as_real(r)).all())
                assert finite, f"qr {name} {tuple(a.shape)}: Q or R not finite"
                na = torch.linalg.matrix_norm(a)
                recon = float((torch.linalg.matrix_norm(q @ r - a)
                               / torch.where(na == 0, torch.ones_like(na), na)
                               ).max())
                _, r_lib = cl.library_qr(a)
                d, d_lib = (torch.diagonal(x, dim1=-2, dim2=-1).abs()
                            for x in (r, r_lib))
                scale = d_lib.max(-1, keepdim=True).values
                scale = torch.where(scale == 0, torch.ones_like(scale), scale)
                diag = float(((d - d_lib).abs() / scale).max())
                assert recon <= 1e-5 and diag <= 1e-4, (
                    f"qr {name} {tuple(a.shape)}: |QR-A|/|A| {recon:.3e} (bar "
                    f"1e-5), |diag R| vs library_qr {diag:.3e} (bar 1e-4)")
                worst = {"recon": max(worst["recon"], recon),
                         "diag": max(worst["diag"], diag)}
                zero_cols += int((a.abs().sum(-2) == 0).sum())
                shapes.add(tuple(a.shape))
            assert calls, f"qr: {name} never reached _qr_split"
            log("qr", f"{name} with no TNQS_* knob: {len(calls)} batches to "
                      f"_qr_split, shapes {sorted(shapes)}, {zero_cols} zero "
                      f"(padded) columns in all; every Q and R finite; worst "
                      f"|QR-A|/|A| {worst['recon']:.2e} (bar 1e-5), |diag R| "
                      f"vs library_qr {worst['diag']:.2e} (bar 1e-4)")
        del recorded
    log("qr", f"launches {launches} (the default stack takes no kernel)")
    return launches


MICRO_M_POINTS = (4, 16)


def microbench_phase(counters):
    """Every op at the reference sweep shapes, counted; ``cpallas`` is the
    K4 path.  Prints each slope record."""
    from tensornetworkquantumsimulator_torch import microbench as mb

    buf = io.StringIO()
    launches, records = counted(
        counters, "microbench", ("K4",),
        lambda: mb.sweep(mb.SWEEP_SHAPES, mb.OPS, MICRO_M_POINTS, out=buf))
    for line in buf.getvalue().splitlines():
        log("microbench", line)
    bad = [(r["op"], r["B"], r["N"]) for r in records if not r["valid"]]
    assert not bad, f"microbench: non-finite z for {bad}"
    log("microbench", f"{len(records)} (op, shape) pairs at M = "
                      f"{MICRO_M_POINTS}; launches {launches}")
    # the point long chains converge to: equal complex columns, on which
    # torch's batched QR returns NaN (microbench.library_qr)
    for b, n in mb.SWEEP_SHAPES:
        fixed = torch.full((b, n, n), 0.0088 + 0.0088j, dtype=torch.complex64,
                           device="cuda")
        out = mb.step("qr", fixed)
        assert torch.isfinite(torch.view_as_real(out)).all(), (
            f"microbench: qr step non-finite on the [{b},{n},{n}] fixed point")
    log("microbench", "qr step finite on the chains' fixed point (equal "
                      "complex columns) at both shapes")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the measurement half, on the states the paths above leave
# ---------------------------------------------------------------------------

MEASURE_SAMPLES = 32  # per sampler call (scripts/measure_bench.py:35)
BMPS_RANK, BMPS_SWEEPS = 16, 8  # scripts/measure_bench.py:90
BMPS_RANK_WIDE = 24  # the rank the grid evaluation must have converged by
# complex64 through ~40 QR-gauged column fits whose sweeps stop on a
# threshold: three runs on an H100 read 1.8e-5 to 3.9e-5 between the ranks
# and 2.6e-6 to 9.6e-6 between the card and the CPU
BMPS_RANK_BAND, BMPS_CPU_BAND = 2e-4, 5e-5
CERT_RANK = 8  # scripts/measure_bench.py:111-113
CPU_SAMPLES = 4  # certified samples recontracted on the CPU
CERT_BAND = 5e-3  # log_poverq, card vs CPU on the same bitstrings
PROFILED_SAMPLES = 8  # certified samples under the profiler


class ForcedDraws:
    """Stands in for the samplers' draw hook: hands out the given
    bitstrings [S, n] one column per call, in call order."""

    def __init__(self, bits):
        self.bits, self.calls = bits, 0

    def __call__(self, probs, generator=None):
        out = self.bits[:, self.calls].to(probs.device)
        self.calls += 1
        return out


def evolved(tt, dev, name, n, env):
    """(spec, initial state, the state after n layers of a configuration at
    its BP fixed point, its BP ⟨Z⟩ [V] on the card)."""
    with knobs(env):
        spec, psi0, layer_fn = build_config(tt, dev, name)
        state = psi0
        for _ in range(n):
            state, _ = layer_fn(state)
        state = tt.bp_update(spec, state, maxiter=100)
        z = tt.local_expectations(spec, state, tt.op_matrix("Z", 2)).real
    assert torch.isfinite(z).all(), f"{name}: non-finite <Z>"
    return spec, psi0, state, z


def call_ms(fn, reps: int = 3) -> float:
    """Milliseconds per call between two CUDA events, after one warm-up
    call: the host's dispatch and its syncs included, as a user waits."""
    return time_ms(fn, reps, warmup=1)


def measure_grid(tt, dev, engine, counters, targets, cl, cb, card):
    """The 5x5 TFIM χ=10 complex64 state the chi10 path leaves, measured
    every way the port offers; each step asserts.  ``batched_truncate`` on
    the fast stack is the counted path (K1 and K2 must launch).  Returns
    (launches, the calls whose device busy share is read at the end, the
    state with its BP ⟨Z⟩ and rank-24 BMPS ⟨Z⟩ for the loop
    corrections)."""
    tp = tt.parallel
    cert_mod = tp.certified_sampling
    z_op = tt.op_matrix("Z", 2)
    spec, psi0, state, z_bp = evolved(tt, dev, "chi10", LAYERS["chi10"],
                                      FAST_STACK)
    V = spec.num_vertices
    times = {}

    def z_of(st):
        return tt.local_expectations(spec, st, z_op).real

    # Vidal gauge: the state is unchanged, the messages are diag(spectrum)
    # and a BP fixed point, the spectra descend and sum to one
    gauged, spectra = tp.batched_symmetric_gauge(spec, state)
    dz = float((z_of(gauged) - z_bp).abs().max())
    m = gauged.messages
    off = float((m - torch.diag_embed(torch.diagonal(m, dim1=-2, dim2=-1))
                 ).abs().max())
    tables = engine.graph_tables(spec, dev)
    drift = float(engine._message_distance(
        m, engine.bp_iteration(spec, gauged, tables), tables.mask))
    descending = float(torch.diff(spectra, dim=-1).max())
    total = float((spectra.sum(-1) - 1).abs().max())
    assert dz <= 1e-5 and off <= 1e-7 and drift <= 1e-5, (
        f"gauge: max site |dZ| {dz:.3e}, off-diagonal {off:.3e}, BP drift "
        f"{drift:.3e}")
    # the function returns the singular values as they come: they sum to
    # one as far as the messages it was handed are diagonal (entry sum =
    # trace), which the simple update leaves them to ~1e-3
    assert descending <= 1e-6 and total <= 1e-2 and float(spectra.min()) >= 0, (
        f"gauge: spectra ascend by {descending:.3e}, sums off by {total:.3e}")
    times["gauge"] = call_ms(lambda: tp.batched_symmetric_gauge(spec, state))
    log("measure", f"gauge: max site |dZ| {dz:.2e} (bar 1e-5); messages "
                   f"diagonal (off-diagonal {off:.1e}) and a BP fixed point "
                   f"(distance after one sweep {drift:.2e}); {len(spectra)} "
                   f"spectra descending, |sum - 1| {total:.2e} (bar 1e-2); largest "
                   f"Schmidt weight per bond "
                   f"{float(spectra[:, 0].min()):.4f}-"
                   f"{float(spectra[:, 0].max()):.4f}")

    # truncation: the counted path of this phase
    def run_truncate(env):
        with knobs(env):
            out, errs = tp.batched_truncate(spec, state, chi=state.chi,
                                            cutoff=1e-10)
            z = z_of(out).cpu().numpy()
        assert np.isfinite(z).all() and torch.isfinite(errs).all(), (
            "truncate: non-finite output")
        return z

    launches, seen, z_tr = main_path(counters, "measure", run_truncate,
                                     FAST_STACK, ("K1", "K2"), targets)
    check_recorded("measure", seen, cl, cb)
    del seen
    moved = float(np.abs(z_tr - z_bp.cpu().numpy()).max())
    assert moved <= 1e-3, f"truncate at the state's own chi moved <Z> by {moved:.3e}"
    with knobs(FAST_STACK):
        times["truncate"] = call_ms(
            lambda: tp.batched_truncate(spec, state, chi=state.chi,
                                        cutoff=1e-10))
    log("measure", f"truncate(chi={state.chi}, cutoff=1e-10): launches per call "
                   f"{launches}; <Z> moved by {moved:.2e} from the input's")

    # overlaps
    echo0, _ = tp.batched_loschmidt_echo(spec, psi0, psi0)
    echo, phase = tp.batched_loschmidt_echo(spec, psi0, state)
    assert abs(float(echo0)) <= 1e-5 and float(echo) <= 1e-5, (
        f"echo: log|echo| {float(echo0):.3e} at t=0, {float(echo):.3e} after")
    log_norm, norm_phase = tp.batched_inner(spec, state, state)
    bp_norm, _ = tp.overlap.sandwich_logz(
        spec, state.tensors, state.tensors.conj(), state.messages)
    d_norm = abs(float(log_norm) - float(bp_norm))
    assert d_norm <= 1e-4 and abs(np.expm1(1j * float(norm_phase))) <= 1e-4, (
        f"inner(psi, psi): log differs from the BP norm by {d_norm:.3e}, "
        f"phase {float(norm_phase):.3e}")
    times["echo"] = call_ms(
        lambda: tp.batched_loschmidt_echo(spec, psi0, state))
    log("measure", f"echo: log|<psi0|psi0>| {float(echo0):.2e}, after "
                   f"{LAYERS['chi10']} layers log|echo| {float(echo):.5f} "
                   f"phase {float(phase):.5f}; log<psi|psi> "
                   f"{float(log_norm):.6f} vs Z_BP at the state's messages: "
                   f"{d_norm:.2e} (bar 1e-4)")

    # correlators from the corner vertex, at every distance
    corner = (1, 1)
    pairs = [(corner, v) for v in spec.vertices if v != corner]
    corr_fn = tp.make_path_correlation_fn(spec, pairs, z_op, real_output=True)
    zz = corr_fn(state)
    bonds = tp.bond_expectations(spec, state, z_op, z_op).real
    ic = spec.vertex_position(corner)
    worst, near = 0.0, 0
    for e, (iu, iv, _, _) in enumerate(spec.edges):
        if ic in (iu, iv):
            other = spec.vertices[iv if iu == ic else iu]
            worst = max(worst, abs(float(zz[pairs.index((corner, other))])
                                   - float(bonds[e])))
            near += 1
    assert near == 2 and worst <= 1e-5 and torch.isfinite(zz).all(), (
        f"correlator: distance-1 pairs differ from bond_expectations by "
        f"{worst:.3e}")
    mi = tp.make_mutual_information_fn(spec, pairs)(state)
    assert float(mi.min()) >= -1e-5 and torch.isfinite(mi).all(), (
        f"mutual information {float(mi.min()):.3e} < 0")
    times["correlator"] = call_ms(lambda: corr_fn(state))
    log("measure", f"{len(pairs)} <ZZ> pairs from {corner}: in "
                   f"[{float(zz.min()):.5f}, {float(zz.max()):.5f}], "
                   f"distance-1 pairs vs bond_expectations {worst:.2e} (bar "
                   f"1e-5); mutual information in [{float(mi.min()):.2e}, "
                   f"{float(mi.max()):.5f}] (bar >= -1e-5)")

    # BP sampler: the site means against BP's own marginals
    S = MEASURE_SAMPLES
    gen = torch.Generator(device=dev).manual_seed(2024)
    bp_sampler = tp.make_bp_sampler(spec)
    bits = bp_sampler(state, S, gen)
    assert bits.shape == (S, V) and int(bits.min()) >= 0 and int(bits.max()) <= 1
    p1 = (1 - z_bp) / 2
    sigma = torch.sqrt(p1 * (1 - p1) / S)
    excess = ((bits.double().mean(0) - p1).abs() - 4 * sigma).max()
    assert float(excess) <= 1 / S, (
        f"BP sampler: a site mean is {float(excess):.3f} beyond 4 sigma of "
        f"(1 - <Z>)/2 (one count, {1 / S:.3f}, allowed)")
    times["bp_samples"] = call_ms(lambda: bp_sampler(state, S, gen), reps=1)
    log("measure", f"BP sampler: {S} samples of {V} bits in {{0,1}}; site "
                   f"means within 4 sigma (+ one count) of (1-<Z>)/2, worst "
                   f"excess over 4 sigma {float(excess):+.3f}")

    # boundary MPS: converged in its rank, near BP, and equal to the CPU's.
    # BP misses the grid's short loops (7e-3 in <Z> on this state on an
    # H100, at ranks 8, 16 and 24 alike), so the band against BP is wide
    # and the check of the contraction is the larger rank
    _, expect = tp.make_grid_bmps(spec, 5, 5, kmps=BMPS_RANK,
                                  niters=BMPS_SWEEPS)
    z_bmps = expect(state.tensors, z_op)
    d_bp = float((z_bmps - z_bp).abs().max())
    assert torch.isfinite(z_bmps).all() and d_bp <= 2e-2, (
        f"BMPS: max site |dZ| vs BP {d_bp:.3e} (bar 2e-2)")
    z_wide = tp.make_grid_bmps(spec, 5, 5, kmps=BMPS_RANK_WIDE,
                               niters=BMPS_SWEEPS)[1](state.tensors, z_op)
    d_rank = float((z_bmps - z_wide).abs().max())
    assert d_rank <= BMPS_RANK_BAND, (
        f"BMPS: rank {BMPS_RANK} vs {BMPS_RANK_WIDE}: max site |dZ| "
        f"{d_rank:.3e} (bar {BMPS_RANK_BAND})")
    t0 = time.perf_counter()
    z_cpu = expect(state.tensors.cpu(), z_op)
    t_cpu = time.perf_counter() - t0
    d_cpu = float((z_bmps.cpu() - z_cpu).abs().max())
    assert d_cpu <= BMPS_CPU_BAND, (
        f"BMPS: max site |dZ| card vs CPU {d_cpu:.3e} (bar {BMPS_CPU_BAND})")
    times["bmps"] = call_ms(lambda: expect(state.tensors, z_op))
    log("measure", f"grid BMPS (rank {BMPS_RANK}, up to {BMPS_SWEEPS} sweeps): "
                   f"all-site <Z> vs rank {BMPS_RANK_WIDE} {d_rank:.2e} (bar "
                   f"{BMPS_RANK_BAND}), vs BP {d_bp:.2e} (bar 2e-2), vs the "
                   f"same call on the CPU {d_cpu:.2e} (bar {BMPS_CPU_BAND}; "
                   f"the CPU call took "
                   f"{t_cpu:.1f} s)")

    # certified sampler; the first samples recontracted on the CPU
    cert = tp.make_grid_certified_sampler(spec, 5, 5, norm_rank=CERT_RANK,
                                          projected_rank=CERT_RANK)
    cbits, logq, lpq = cert(state.tensors, S, gen)
    assert cbits.shape == (S, 5, 5) and int(cbits.min()) >= 0 and (
        int(cbits.max()) <= 1)
    assert torch.isfinite(logq).all() and torch.isfinite(lpq).all(), (
        "certified sampler: non-finite logq / log_poverq")
    draw = cert_mod._draw
    cert_mod._draw = ForcedDraws(cbits[:CPU_SAMPLES].reshape(CPU_SAMPLES, -1))
    try:
        cbits_c, logq_c, lpq_c = cert(state.tensors.cpu(), CPU_SAMPLES)
    finally:
        cert_mod._draw = draw
    d_q = float((logq[:CPU_SAMPLES].cpu() - logq_c).abs().max())
    d_pq = float((lpq[:CPU_SAMPLES].cpu() - lpq_c).abs().max())
    assert torch.equal(cbits_c, cbits[:CPU_SAMPLES].cpu())
    # both runs truncate to rank 8, which leaves the certificate a spread
    # of its own (std 4e-4 over the samples on an H100); two correct
    # truncations differ by as much (9.8e-4 measured)
    assert d_q <= 1e-3 and d_pq <= CERT_BAND, (
        f"certified sampler: card vs CPU on the same bitstrings: logq "
        f"{d_q:.3e} (bar 1e-3), log_poverq {d_pq:.3e} (bar {CERT_BAND})")
    # zero-padded strands and one of exactly equal columns, the inputs a
    # batched QR of small complex matrices turns to NaN on CUDA
    rng = np.random.default_rng(7)
    strand = (rng.standard_normal((3, 5, 2, 10, 2))
              + 1j * rng.standard_normal((3, 5, 2, 10, 2))).astype(np.complex64)
    strand[1] = 1.0
    padded, ln = cert_mod._single_truncate(torch.from_numpy(strand).to(dev),
                                           CERT_RANK)
    _, ln_c = cert_mod._single_truncate(torch.from_numpy(strand), CERT_RANK)
    d_ln = float((ln.cpu() - ln_c).abs().max())
    assert torch.isfinite(torch.view_as_real(padded)).all() and d_ln <= 1e-4, (
        f"_single_truncate on padded strands: log norm card vs CPU {d_ln:.3e}")
    times["cert_samples"] = call_ms(lambda: cert(state.tensors, S, gen),
                                    reps=1)
    log("measure", f"certified sampler (ranks {CERT_RANK}): {S} samples; logq "
                   f"in [{float(logq.min()):.3f}, {float(logq.max()):.3f}]; "
                   f"log_poverq mean {float(lpq.mean()):.5f}, spread (std) "
                   f"{float(lpq.std()):.2e}, range "
                   f"[{float(lpq.min()):.5f}, {float(lpq.max()):.5f}]; "
                   f"{CPU_SAMPLES} samples recontracted on the CPU: logq "
                   f"{d_q:.2e} (bar 1e-3), log_poverq {d_pq:.2e} (bar "
                   f"{CERT_BAND}); padded and "
                   f"equal-column strands finite, log norm vs CPU {d_ln:.2e}")

    log("measure", f"{card}: 5x5 chi=10 complex64, per call after one "
                   f"warm-up (CUDA events, host dispatch included): BMPS "
                   f"all-site <Z> {times['bmps']:.1f} ms per evaluation; "
                   f"certified sampler {S / times['cert_samples'] * 1e3:.1f} "
                   f"samples/s ({times['cert_samples']:.1f} ms per {S}); BP "
                   f"sampler {S / times['bp_samples'] * 1e3:.1f} samples/s "
                   f"({times['bp_samples']:.1f} ms per {S}); gauge "
                   f"{times['gauge']:.2f} ms; truncate {times['truncate']:.1f} "
                   f"ms; echo {times['echo']:.1f} ms; {len(pairs)}-pair "
                   f"correlator {times['correlator']:.2f} ms")
    # (the call, its time without the profiler in ms): the certified
    # sampler launches ~7000 device operations a sample, which the profiler
    # takes seconds each to digest, so it is traced at fewer samples
    few = PROFILED_SAMPLES
    profiled = {
        "BMPS all-site <Z>": (lambda: expect(state.tensors, z_op),
                              times["bmps"]),
        f"certified sampler, {few} samples": (
            lambda: cert(state.tensors, few, gen),
            call_ms(lambda: cert(state.tensors, few, gen), reps=1)),
        f"BP sampler, {S} samples": (lambda: bp_sampler(state, S, gen),
                                     times["bp_samples"]),
    }
    grid = {"spec": spec, "state": state, "z_bp": z_bp, "z_bmps": z_wide}
    return launches, profiled, grid


def measure_eagle(tt, dev, card):
    """IBM Eagle, 127 qubits, χ=8, two kicked-Ising layers: the planar
    boundary MPS (identity wires on the column grid) against BP.  Returns
    the state with its BP and BMPS ⟨Z⟩ for the loop corrections."""
    spec, _, state, z_bp = evolved(tt, dev, "heavyhex", 2, FAST_STACK)
    _, expect = tt.parallel.make_planar_bmps(spec, kmps=BMPS_RANK)
    z_op = tt.op_matrix("Z", 2)
    z = expect(state.tensors, z_op)
    d = float((z - z_bp).abs().max())
    assert z.shape == (127,) and torch.isfinite(z).all() and d <= 1e-3, (
        f"Eagle planar BMPS: max site |dZ| vs BP {d:.3e} (bar 1e-3)")
    ms = call_ms(lambda: expect(state.tensors, z_op), reps=1)
    log("measure", f"{card}: Eagle-127 chi=8 after 2 layers, planar BMPS "
                   f"(rank {BMPS_RANK}): all-site <Z> mean {float(z.mean()):.6f}, "
                   f"max site |dZ| vs BP {d:.2e} (bar 1e-3); {ms:.1f} ms per "
                   f"evaluation")
    return {"spec": spec, "state": state, "z_bp": z_bp, "z_bmps": z}


def measure_noisy(tt, dev, spec, state, card):
    """The noisy path's d=4 state (5x5, χ=8): purity and the density-matrix
    sampler."""
    tp = tt.parallel
    purity = float(tp.batched_purity(spec, state))
    log2p = float(tp.batched_purity(spec, state, log2=True))
    assert 0.0 < purity <= 1.0 + 1e-5 and abs(2.0 ** log2p - purity) <= 1e-5, (
        f"noisy: purity {purity}, log2 {log2p}")
    S = MEASURE_SAMPLES
    gen = torch.Generator(device=dev).manual_seed(2025)
    sampler = tp.make_rho_sampler(spec, state.chi, state.tensors.dtype)
    bits, logps = sampler(state, S, gen)
    assert bits.shape == (S, spec.num_vertices) and int(bits.min()) >= 0 and (
        int(bits.max()) <= 1)
    assert torch.isfinite(logps).all() and float(logps.max()) <= 1e-6, (
        "noisy: rho sampler logps not finite or positive")
    ms = call_ms(lambda: sampler(state, S, gen), reps=1)
    log("measure", f"{card}: noisy 5x5 d=4 chi=8 state: purity {purity:.6f} "
                   f"(log2 {log2p:.5f}); rho sampler {S} samples, logps in "
                   f"[{float(logps.min()):.3f}, {float(logps.max()):.3f}], "
                   f"{S / ms * 1e3:.1f} samples/s ({ms:.1f} ms per {S})")


# ---------------------------------------------------------------------------
# phases 12-13: loop corrections and the variational path
# ---------------------------------------------------------------------------

# configurations of the 5x5 grid by max_configuration_size (at 8, 78 of the
# 221 are two disjoint components), and Eagle's heavy-hex 12-cycles
GRID_LOOPS = {4: 16, 6: 40, 8: 221}
GRID_PAIRS_AT_8 = 78
EAGLE_LOOP_SIZE, EAGLE_LOOPS = 12, 18
EAGLE_LC_SITES = 8
# loop-corrected Z and <Z>, card vs CPU, relative: two runs on an H100 read
# Z 1.5e-5 / 7.7e-6 on the grid and 1.6e-5 / 1.5e-5 on Eagle, <Z> 1.9e-6 /
# 2.3e-6 on the grid
LOOP_CPU_BAND = 1e-4


def rel_err(a, b) -> float:
    a, b = (torch.as_tensor(x).detach().cpu().to(torch.complex128)
            for x in (a, b))
    return float((a - b).abs().max() / b.abs().max())


def loops_phase(tt, dev, counters, grid, eagle, card):
    """Loop corrections on the 5x5 χ=10 state of the measure phase and on
    its Eagle-127 χ=8 state, counted (no kernel of the port runs here).
    log Z_BP (Π z_v / Π s_e) against the Bethe free energy of
    ``overlap.sandwich_logz`` at the same messages; loop-corrected Z at
    max_configuration_size 4, 6, 8 on the grid and 12 on Eagle, each
    against the same call on the CPU (Eagle's Z_BP, e^(log Z_BP), is below
    complex64's normal range, so its series runs on the rescaled state, whose
    Z_BP is 1); loop-corrected ⟨Z⟩ on all 25 grid sites at size 4, closer
    to the rank-24 boundary MPS than BP's, and on 8 Eagle sites at size 12.
    Times: CUDA events after one warm-up call; the host-side enumeration
    (``LoopConfigurations``) timed apart.  Returns the launches and the
    grid's all-site ⟨Z⟩ call for the busy-share read at the end."""
    from tensornetworkquantumsimulator_torch import native

    tp = tt.parallel
    assert native.get_subgraphs() is not None, (
        "loops: the native subgraph enumerator did not build or load")
    log("loops", f"enumerator: native, csrc/subgraphs.cpp built with g++ "
                 f"into {native.library_path().relative_to(REPO)}")
    times, host = {}, {}
    cases = {"grid": (grid, tt.named_grid((5, 5)), sorted(GRID_LOOPS)),
             "eagle": (eagle, tt.ibm_eagle_lattice(), [EAGLE_LOOP_SIZE])}

    def run():
        out = {}
        for name, (c, g, sizes) in cases.items():
            spec, state = c["spec"], c["state"]
            zstate = state if name == "grid" else tp.rescale(spec, state)
            log_zbp = (torch.log(tp.vertex_scalars(spec, state)).sum()
                       - torch.log(tp.edge_scalars(spec, state)).sum())
            zbp = tp.batched_partitionfunction(spec, zstate)
            cfgs = {}
            for n in sizes:
                t0 = time.perf_counter()
                cfgs[n] = tp.LoopConfigurations(spec, g, n)
                host[(name, n)] = time.perf_counter() - t0
            z = {n: tp.batched_loopcorrected_partitionfunction(
                spec, zstate, g, configurations=cfgs[n]) for n in sizes}
            step = len(spec.vertices) // EAGLE_LC_SITES
            sites = (list(spec.vertices) if name == "grid"
                     else list(spec.vertices)[::step][:EAGLE_LC_SITES])
            t0 = time.perf_counter()
            fn = tp.make_loopcorrected_expectations(
                spec, g, [("Z", [v]) for v in sites],
                max_configuration_size=sizes[0])
            host[(name, "expect")] = time.perf_counter() - t0
            out[name] = (zstate, log_zbp, zbp, cfgs, z, sites, fn, fn(state))
        torch.cuda.synchronize()
        return out

    launches, out = counted(counters, "loops", (), run)
    assert not any(launches.values()), f"loops: kernels launched {launches}"
    for name, (zstate, log_zbp, zbp, cfgs, z, sites, fn, lc) in out.items():
        c, g, sizes = cases[name]
        spec, state = c["spec"], c["state"]

        def on_cpu(st):
            return st._replace(tensors=st.tensors.cpu(),
                               messages=st.messages.cpu())

        m = state.messages
        bethe = float(tp.overlap.sandwich_logz(
            spec, state.tensors, state.tensors.conj(), m)[0])
        d_log = abs(float(log_zbp.real) - bethe) / max(abs(bethe), 1.0)
        assert torch.isfinite(torch.view_as_real(zbp)).all() and (
            float(zbp.abs()) > 0) and d_log <= 1e-4, (
            f"loops {name}: log|Z_BP| {float(log_zbp.real):.6f} vs "
            f"sandwich_logz {bethe:.6f}: {d_log:.3e} (bar 1e-4), Z_BP "
            f"{complex(zbp)}")
        head = (f"log|Z_BP| {float(log_zbp.real):.6f} vs sandwich_logz "
                f"{bethe:.6f} ({d_log:.2e}, bar 1e-4)")
        if name == "grid":
            d_z = abs(float(torch.log(zbp.abs())) - bethe) / max(abs(bethe), 1)
            assert d_z <= 1e-4, f"loops grid: log|batched_partitionfunction| {d_z:.3e}"
            counts = {n: cfgs[n].n_configurations for n in sizes}
            pairs = len(cfgs[8].groups.get(2, ()))
            assert counts == GRID_LOOPS and pairs == GRID_PAIRS_AT_8, (
                f"loops grid: configurations {counts}, pairs at 8 {pairs}")
            head += (f", log|batched_partitionfunction| off by {d_z:.2e}; "
                     f"configurations {counts}, {pairs} of them two-component "
                     f"at 8")
        else:
            n = cfgs[EAGLE_LOOP_SIZE].n_configurations
            assert n == EAGLE_LOOPS, f"loops eagle: {n} configurations"
            head += (f"; {n} heavy-hex {EAGLE_LOOP_SIZE}-cycles, on the "
                     f"rescaled state (Z_BP = {complex(zbp):.6f})")
        parts = []
        for n in sizes:
            assert torch.isfinite(torch.view_as_real(z[n])).all(), (
                f"loops {name}: Z at size {n} not finite")
            z_cpu = tp.batched_loopcorrected_partitionfunction(
                spec, on_cpu(zstate), g, configurations=cfgs[n])
            d = rel_err(z[n], z_cpu)
            assert d <= LOOP_CPU_BAND, (
                f"loops {name}: Z at size {n} card vs CPU {d:.3e} (bar "
                f"{LOOP_CPU_BAND})")
            times[(name, n)] = call_ms(
                lambda n=n: tp.batched_loopcorrected_partitionfunction(
                    spec, zstate, g, configurations=cfgs[n]))
            parts.append(f"size {n}: Z/Z_BP - 1 = "
                         f"{complex(z[n] / zbp - 1):.4e}, card vs CPU {d:.2e}")
            if name == "eagle":
                # the series' correction term itself (Z = Z_BP (1 + it)),
                # which 1 + it cannot resolve in complex64 on this state
                corr = [complex(cfgs[n].correction_sum(
                    tp.loopcorrection._configuration_weights(
                        spec, tp.rescale(spec, st), cfgs[n])))
                    for st in (zstate, on_cpu(zstate))]
                parts.append(f"correction sum {corr[0]:.4e} (CPU "
                             f"{corr[1]:.4e}; not compared: terms this small "
                             f"carry no complex64 digits)")
        log("loops", f"{name}: {head}; " + "; ".join(parts)
                     + f" (bar {LOOP_CPU_BAND})")

        assert lc.shape == (len(sites),) and torch.isfinite(
            torch.view_as_real(lc)).all(), f"loops {name}: <Z> not finite"
        d_cpu = rel_err(lc, fn(on_cpu(state)))
        assert d_cpu <= LOOP_CPU_BAND, (
            f"loops {name}: loop-corrected <Z> card vs CPU {d_cpu:.3e}")
        times[(name, "expect")] = call_ms(lambda fn=fn: fn(state))
        idx = [spec.vertex_position(v) for v in sites]
        z_lc = lc.real.cpu().double()
        z_bp = c["z_bp"][idx].cpu().double()
        z_bmps = c["z_bmps"][idx].cpu().double()
        d_lc = float((z_lc - z_bmps).abs().max())
        d_bp = float((z_bp - z_bmps).abs().max())
        if name == "grid":
            assert d_lc < d_bp, (
                f"loops grid: loop-corrected <Z> {d_lc:.3e} from the rank-"
                f"{BMPS_RANK_WIDE} BMPS, BP {d_bp:.3e}")
        log("loops", f"{name}: loop-corrected <Z> (size {sizes[0]}) on "
                     f"{len(sites)} sites: max site |LC - BMPS| {d_lc:.3e} "
                     f"beside |BP - BMPS| {d_bp:.3e}"
                     + (" (LC must be the closer)" if name == "grid" else "")
                     + f"; card vs CPU {d_cpu:.2e} (bar {LOOP_CPU_BAND})")
    log("loops", f"{card}: per call after one warm-up (CUDA events): "
                 + "; ".join(f"{name} Z at size {n} {times[(name, n)]:.2f} ms"
                             for (name, n) in times if n != "expect")
                 + "; " + "; ".join(
                     f"{name} loop-corrected <Z> on {len(out[name][5])} sites "
                     f"{times[(name, 'expect')]:.2f} ms" for name in out)
                 + ". Host enumeration (LoopConfigurations, host clock): "
                 + "; ".join(f"{name} size {n} {host[(name, n)] * 1e3:.1f} ms"
                             for (name, n) in host if n != "expect")
                 + "; " + "; ".join(
                     f"{name} expectation factory {host[(name, 'expect')] * 1e3:.1f} ms"
                     for name in out))
    fn, state = out["grid"][6], grid["state"]
    return launches, {"loop-corrected <Z>, 25 sites, size 4": (
        lambda: fn(state), times[("grid", "expect")])}


VAR_STEPS, VAR_SWEEPS, VAR_DAMPING = 400, 12, 0.1  # tests/test_variational.py:65-79
VAR_TIMED_STEPS = 100
ENSEMBLE_GS, ENSEMBLE_GS_STEPS = 4, 20


def noised(spec, state, eps, seed):
    """Symmetry-breaking complex noise on the valid block (dummy slots keep
    bond dimension 1), as tests/test_variational.py's ``_noised``."""
    rng = np.random.default_rng(seed)
    t = state.tensors.cpu().numpy()
    noise = rng.normal(size=t.shape) + 1j * rng.normal(size=t.shape)
    mask = spec.mask_array()
    for k in range(spec.degree):
        idx = [slice(None)] * t.ndim
        idx[1 + k] = slice(1, None)
        noise[tuple(idx)] *= mask[:, k][(slice(None),) + (None,) * (t.ndim - 1)]
    return state._replace(tensors=torch.from_numpy(
        (t + eps * noise).astype(t.dtype)).to(state.tensors.device))


def variational_phase(tt, dev, counters, card):
    """Variational ground states on the card.  3x3 TFIM (J=1, hx=3) at χ=4
    complex64, 400 Adam steps of 12 damped BP sweeps: within 5% of the
    dense ground energy (tests/dense_oracle.py), finite, below the first
    energy.  5x5 TFIM at χ=4: 100 steps timed (steps/s), and the first
    step's gradient in complex128 against the CPU's to 1e-8.  Eagle-127
    Heisenberg at χ=4 complex64 with ``TNQS_BP_KERNEL=1``: under grad K3
    launches 0 times and the gradient equals the ``TNQS_BP_KERNEL=0`` one
    to 1e-5; under ``torch.no_grad()`` K3 launches and the energy equals
    the grad path's to 1e-4.  An ensemble of 4 disorder realizations on
    the 5x5 grid, 20 steps, each member within 1e-5 of its single run.
    Returns {path: launches} (the grad runs, and the no-grad energy) and a
    one-step 5x5 call for the busy-share read at the end."""
    sys.path.insert(0, str(REPO / "tests"))
    from dense_oracle import exact_tfim_levels

    tp = tt.parallel
    ham = tp.tfim_hamiltonian(J=1.0, hx=3.0)
    opt = dict(learning_rate=3e-2, bp_sweeps_per_eval=VAR_SWEEPS,
               damping=VAR_DAMPING)

    def start(g, seed, dtype=torch.complex64, device=dev):
        spec, s0 = tt.batched_product_state(g, chi=4, dtype=dtype,
                                            device=device)
        return spec, noised(spec, s0, 0.1, seed)

    spec3, s3 = start(tt.named_grid((3, 3)), 1)
    spec5, s5 = start(tt.named_grid((5, 5)), 2)
    eagle_g = tt.ibm_eagle_lattice()
    spec_e, s_e = start(eagle_g, 3)
    heis = tp.heisenberg_hamiltonian()
    efn_e = tp.make_energy_fn(spec_e, heis, VAR_SWEEPS)

    def eagle_grad(env):
        with knobs({"TNQS_BP_KERNEL": env}):
            params = s_e.tensors.clone().requires_grad_(True)
            e, _ = efn_e(params, s_e.messages)
            e.backward()
        return e.detach(), params.grad

    res = {}

    def run():
        t0 = time.perf_counter()
        res["3x3"] = tp.ground_state(spec3, s3, ham, steps=VAR_STEPS, **opt)
        res["3x3"][1].sum().item()
        res["3x3 s"] = time.perf_counter() - t0
        res["eagle grad"] = eagle_grad("1")
        torch.cuda.synchronize()

    launches, _ = counted(counters, "variational", (), run)
    assert launches["K3"] == 0, f"variational: K3 ran under grad {launches}"
    _, en3 = res["3x3"]
    e3 = en3.cpu().numpy()
    e0 = float(exact_tfim_levels(spec3, 1.0, 3.0, 1)[0])
    gap = abs(float(e3[-1]) - e0) / abs(e0)
    assert np.isfinite(e3).all() and gap < 0.05 and e3[-1] < e3[0], (
        f"variational 3x3: final {e3[-1]:.6f} vs dense {e0:.6f} ({gap:.3e}, "
        f"bar 5e-2), first {e3[0]:.6f}")
    log("variational", f"3x3 TFIM chi=4 c64, {VAR_STEPS} steps: E {e3[0]:.5f}"
                       f" -> {e3[-1]:.5f}, dense {e0:.5f}: {gap:.3e} off (bar "
                       f"5e-2); {VAR_STEPS / res['3x3 s']:.1f} steps/s (host "
                       f"clock, first call)")

    # Eagle: K3 under grad and without it
    e_g, g_on = res["eagle grad"]
    e_off, g_off = eagle_grad("0")
    d_grad = rel_err(g_on, g_off)
    assert d_grad <= 1e-5, f"variational Eagle: grad K3 on/off {d_grad:.3e}"

    def no_grad():
        with knobs({"TNQS_BP_KERNEL": "1"}), torch.no_grad():
            e, _ = efn_e(s_e.tensors, s_e.messages)
            return float(e)

    ng_launches, e_ng = counted(counters, "variational no_grad", ("K3",),
                                no_grad)
    d_e = abs(e_ng - float(e_g)) / abs(float(e_g))
    assert d_e <= 1e-4, f"variational Eagle: no_grad energy {d_e:.3e} off"
    log("variational", f"Eagle-127 Heisenberg chi=4 c64, {VAR_SWEEPS} sweeps, "
                       f"TNQS_BP_KERNEL=1: under grad launches {launches} "
                       f"(K3 0), gradient vs TNQS_BP_KERNEL=0 {d_grad:.2e} "
                       f"(bar 1e-5); under no_grad launches {ng_launches}, "
                       f"energy {e_ng:.6f} vs the grad path's {float(e_g):.6f}:"
                       f" {d_e:.2e} (bar 1e-4)")

    # 5x5: steps/s, and the first gradient in complex128 against the CPU
    tp.ground_state(spec5, s5, ham, steps=2, **opt)  # warm-up
    ms5 = time_ms(lambda: tp.ground_state(spec5, s5, ham,
                                          steps=VAR_TIMED_STEPS, **opt),
                  reps=1, warmup=0)
    efn5 = tp.make_energy_fn(spec5, ham, VAR_SWEEPS, VAR_DAMPING)
    grads = []
    for d in (dev, torch.device("cpu")):
        params = s5.tensors.to(d, torch.complex128).requires_grad_(True)
        e, _ = efn5(params, s5.messages.to(d, torch.complex128))
        e.backward()
        grads.append(params.grad)
    d_g5 = rel_err(*grads)
    assert d_g5 <= 1e-8, f"variational 5x5: c128 gradient card vs CPU {d_g5:.3e}"
    log("variational", f"{card}: 5x5 TFIM chi=4 c64, {VAR_SWEEPS} sweeps per "
                       f"step: {VAR_TIMED_STEPS / ms5 * 1e3:.2f} steps/s "
                       f"({ms5 / VAR_TIMED_STEPS:.2f} ms per step, CUDA events "
                       f"around {VAR_TIMED_STEPS} steps after a 2-step warm-up"
                       f" call); first-step gradient in c128 card vs CPU "
                       f"{d_g5:.2e} (bar 1e-8)")

    # ensemble of disorder realizations in one folded program
    E, V = ENSEMBLE_GS, spec5.num_vertices
    hx = np.random.default_rng(6).uniform(2.0, 4.0, (E, V))
    X, Z = tt.op_matrix("X", 2), tt.op_matrix("Z", 2)
    kw = dict(steps=ENSEMBLE_GS_STEPS, **opt)
    t0 = time.perf_counter()
    _, en = tp.ensemble_ground_state(
        spec5, tp.stack_states([s5] * E),
        tp.Hamiltonian(((X, -hx),), ((Z, Z, -1.0),)), **kw)
    en = en.cpu()
    t_ens = time.perf_counter() - t0
    worst = 0.0
    t0 = time.perf_counter()
    for e in range(E):
        _, en_e = tp.ground_state(
            spec5, s5, tp.Hamiltonian(((X, -hx[e]),), ((Z, Z, -1.0),)), **kw)
        worst = max(worst, rel_err(en[e], en_e))
    t_single = (time.perf_counter() - t0) / E
    assert worst <= 1e-5, f"variational ensemble: member vs single {worst:.3e}"
    log("variational", f"ensemble of {E} (5x5, per-site hx), "
                       f"{ENSEMBLE_GS_STEPS} steps: each member's energies vs "
                       f"its single run {worst:.2e} (bar 1e-5); {t_ens:.2f} s "
                       f"folded vs {t_single:.2f} s per single run (host clock)")
    def one_step():
        return tp.ground_state(spec5, s5, ham, steps=1, **opt)

    return ({"variational": launches, "variational no_grad": ng_launches},
            {"variational step, 5x5 chi=4": (one_step, call_ms(one_step))})


# ---------------------------------------------------------------------------
# phase 14: the generic named-index engine
# ---------------------------------------------------------------------------

GENERIC_LAYERS = 5  # (a): the chi10 configuration, 5x5 TFIM at χ=10
GENERIC_APPLY = dict(maxdim=10, cutoff=1e-10, normalize_tensors=True)


@contextlib.contextmanager
def generic_sweeps(bp):
    """Sweeps run by each BP update of the generic engine inside: yields a
    list that gains one count per ``update()`` call."""
    cls = bp.AbstractBeliefPropagationCache
    update, sweep = cls.update, cls.update_iteration_inplace
    refreshes = []

    def recorded_update(self, *args, **kwargs):
        refreshes.append(0)
        return update(self, *args, **kwargs)

    def recorded_sweep(self, *args, **kwargs):
        refreshes[-1] += 1
        return sweep(self, *args, **kwargs)

    cls.update, cls.update_iteration_inplace = recorded_update, recorded_sweep
    try:
        yield refreshes
    finally:
        cls.update, cls.update_iteration_inplace = update, sweep


def count_syncs(fn):
    """(fn(), the host syncs it made): CUDA's sync debug mode warns at each
    synchronizing call (a device-to-host copy, ``.item()``, a library call
    that reads its status), and the warnings are counted."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def generic_tfim(tt, dev, layers):
    """(a): the chi10 configuration (bench.py:272-279) through the generic
    engine: a product state, ``apply_circuit`` of the 5x5 TFIM layer at
    χ=10, cutoff 1e-10, complex64, then BP ⟨Z⟩ on all 25 sites."""
    g = tt.named_grid((5, 5))
    layer = tfim_layer(tt, g)
    psi0 = tt.tensornetworkstate(torch.complex64, lambda v: "↑", g,
                                 device=dev)
    psi = psi0
    for _ in range(layers):
        psi, errs = tt.apply_circuit(layer, psi, apply_kwargs=GENERIC_APPLY)
    z = np.real(np.array(tt.expect(psi, [("Z", [v]) for v in g.vertices()],
                                   alg="bp")))
    assert np.isfinite(z).all() and np.isfinite(errs).all(), "generic: non-finite"
    return g, layer, psi0, psi, z


def example(name):
    """The port's module of examples/<name>.py."""
    import importlib

    return importlib.import_module(
        f"tensornetworkquantumsimulator_torch.examples.{name}")


def run_example(name, device, **kw):
    """(what ``main`` returned, its numbers as its module's ``read`` finds
    them in what it printed): the port's example ``name`` run on ``device``
    at arguments ``kw``, its standard output captured."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = example(name).main(**kw, device=device)
    return out, example(name).read(buf.getvalue())


@contextlib.contextmanager
def recorded(module, name, factory=False, caller=None):
    """Replace ``module.name`` (a module's function or a class's method) by
    a wrapper that records what each call returns (with ``factory``: what
    each call of each function it builds returns); with ``caller`` (a
    module), only the calls made from that module's own code.  Yields the
    list of records."""
    seen = []
    fn = getattr(module, name)

    def made(*args, **kwargs):
        out = fn(*args, **kwargs)
        if caller is not None and (sys._getframe(1).f_globals.get("__name__")
                                   != caller.__name__):
            return out
        if not factory:
            seen.append(out)
            return out

        def inner(*a, **k):
            res = out(*a, **k)
            seen.append(res)
            return res
        return inner

    with patched(module, name, made):
        yield seen


def print_holds(printed, values, step):
    """Whether each printed number is its unrounded value to within the
    print's last digit ``step``."""
    printed, values = (np.asarray(x, dtype=np.complex128)
                       for x in (printed, values))
    return printed.shape == values.shape and bool(
        (np.abs(printed - values) <= step).all())


def heisenberg_example(dev):
    """(b): the port's ising_2d_heisenberg at its defaults (4x4, χ=4, 5
    steps, Pauli basis, complex64): per step the Frobenius norm of O(t),
    Tr O(t) and Tr O(t)O(0), recorded unrounded where the example computes
    them (its print, 1e-6 for the norm, checked against them)."""
    mod = example("ising_2d_heisenberg")
    with recorded(mod.BeliefPropagationCache, "partitionfunction",
                  caller=mod) as norms, recorded(mod, "inner") as traces:
        _, r = run_example("ising_2d_heisenberg", dev)
    got = np.array([[complex(n), complex(t), complex(t0)] for n, t, t0 in
                    zip(norms, traces[::2], traces[1::2])])
    assert len(got) == len(r["norm"]) == len(traces) // 2, (len(got), r)
    assert print_holds(r["norm"], got[:, 0], 1e-6), (r["norm"], got[:, 0])
    return got


THERMAL_STEPS = 8  # (c): 8 of the example's 16 Strang steps (beta 0.8)


def thermal_example(dev):
    """(c): the port's thermal_states (4x4, χ=8, d=4, float64) for
    THERMAL_STEPS Strang steps: per step E/site, ⟨X⟩, S2/site, from the
    expectations and the purity recorded unrounded where the example
    computes them (its print, to 1e-6, checked against them), and the
    largest bond (recorded at each ``apply_circuit``)."""
    import inspect

    mod = example("thermal_states")
    with recorded(mod, "apply_circuit") as steps, \
            recorded(mod, "pauli_expectation") as paulis, \
            recorded(mod, "purity") as purities:
        _, r = run_example("thermal_states", dev,
                           beta_max=2 * 0.05 * THERMAL_STEPS)
    args = inspect.signature(mod.main).parameters
    h, J = args["h"].default, args["J"].default
    rows = []
    for xs, zzs, p2 in zip(paulis[::2], paulis[1::2], purities):
        xs, zzs = np.real(xs), np.real(zzs)
        rows.append([(-J * np.sum(zzs) - h * np.sum(xs)) / len(xs),
                     np.mean(xs), -np.log2(float(p2)) / len(xs)])
    bonds = [rho.maxvirtualdim() for rho, _ in steps]
    assert print_holds(r["table"][:, 1:4], rows, 1e-6), (r["table"], rows)
    return np.column_stack([rows, bonds])


def generic_phase(tt, dev, engine, counters, card):
    """The generic engine on the card, (a)-(e); returns (launches of the
    counted (a) run, {name: (call, ms)} for the busy share)."""
    from tensornetworkquantumsimulator_torch import native
    from tensornetworkquantumsimulator_torch import parallel as tp
    from tensornetworkquantumsimulator_torch.engines import beliefpropagation

    libs = {stem: get() for stem, get in (("pathopt", native.get_pathopt),
                                          ("subgraphs", native.get_subgraphs))}
    assert all(lib is not None for lib in libs.values()), (
        f"generic: a native library failed to build or load: {libs}")
    log("generic", "native libraries loaded: " + ", ".join(
        str(native.library_path(stem).relative_to(REPO)) for stem in libs))

    # (a) counted: no kernel of the batched engine may launch
    t0 = time.perf_counter()
    with generic_sweeps(beliefpropagation) as g_sweeps:
        launches, (g, layer, psi0, psi, z_g) = counted(
            counters, "generic", (),
            lambda: generic_tfim(tt, dev, GENERIC_LAYERS))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    assert not any(launches.values()), f"generic: kernels launched {launches}"
    assert psi.device().type == "cuda", psi.device()
    spec, state = tp.batched_from_tns(psi0, chi=10, device=dev)
    layer_fn = tp.make_layer_fn(tp.BatchedCircuit(layer, g, spec=spec),
                                chi=10, cutoff=1e-10, normalize_tensors=True,
                                bp_maxiter=25, device=dev)
    with bp_decisions(engine) as refreshes:
        for _ in range(GENERIC_LAYERS):
            state, _ = layer_fn(state)
    b_sweeps = [len(sweeps) for _, sweeps in refreshes]
    pos = [spec.vertex_position(v) for v in g.vertices()]
    z_b = tp.local_expectations(spec, state, tt.op_matrix("Z", 2)).real
    z_b = z_b.cpu().numpy()[pos]
    dz = float(np.abs(z_g - z_b).max())
    assert dz <= 1e-4, f"generic: <Z> generic vs batched {dz:.3e} > 1e-4"
    log("generic", f"(a) 5x5 TFIM chi=10 c64, {GENERIC_LAYERS} layers of "
                   f"apply_circuit: launches {launches}; BP <Z> on 25 sites, "
                   f"mean {z_g.mean():.6f}, vs the batched layer from "
                   f"batched_from_tns: max |dZ| {dz:.2e} (bar 1e-4); max "
                   f"bond {psi.maxvirtualdim()}")
    log("generic", f"(a) BP sweeps per update, generic (sequential, "
                   f"{len(g_sweeps)} updates): {g_sweeps}; batched "
                   f"(flooding, {len(b_sweeps)} refreshes): {b_sweeps}")
    psi_b = tp.batched_to_tns(spec, state, g, psi0.siteinds())
    cache = tp.batched_messages_to_cache(spec, state, psi_b)
    z_c = np.real(np.array(tt.expect(cache, [("Z", [v])
                                             for v in g.vertices()])))
    dzc = float(np.abs(z_c - z_b).max())
    assert dzc <= 1e-5, f"generic: bridged <Z> vs local_expectations {dzc:.3e}"
    log("generic", f"(a) batched_to_tns + batched_messages_to_cache read by "
                   f"expect vs local_expectations: max |dZ| {dzc:.2e} "
                   f"(bar 1e-5)")

    # (d) one more layer, timed, then one with its host syncs counted
    def one_layer():
        return tt.apply_circuit(layer, psi, apply_kwargs=GENERIC_APPLY)

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    one_layer()
    end.record()
    end.synchronize()
    layer_ms, layer_host_ms = start.elapsed_time(end), (
        time.perf_counter() - t0) * 1e3
    _, syncs = count_syncs(one_layer)
    two_site = sum(gate[0] == "Rzz" for gate in layer)

    # (a)-(c) again on the CPU, in this process
    t0 = time.perf_counter()
    _, _, _, psi_cpu, z_cpu = generic_tfim(tt, "cpu", GENERIC_LAYERS)
    t_cpu = time.perf_counter() - t0
    dz_cpu = float(np.abs(z_g - z_cpu).max())
    assert dz_cpu <= 1e-4, f"generic: (a) card vs CPU {dz_cpu:.3e} > 1e-4"
    t0 = time.perf_counter()
    one_cpu = tt.apply_circuit(layer, psi_cpu, apply_kwargs=GENERIC_APPLY)
    cpu_layer_ms = (time.perf_counter() - t0) * 1e3
    del one_cpu
    log("generic", f"(a) card vs CPU: max |dZ| {dz_cpu:.2e} (bar 1e-4)")
    log("generic", f"(d) {card}: one chi10 layer ({len(layer)} gates, "
                   f"{two_site} two-site) {layer_ms:.1f} ms between CUDA "
                   f"events ({layer_host_ms:.1f} ms host clock) on the card, "
                   f"{cpu_layer_ms:.1f} ms on the CPU ({torch.get_num_threads()} "
                   f"threads); host syncs per layer {syncs} (CUDA sync debug "
                   f"mode); (a) in all {t_card:.1f} s on the card, "
                   f"{t_cpu:.1f} s on the CPU (host clock)")

    t0 = time.perf_counter()
    heis = heisenberg_example(dev)
    t_heis = time.perf_counter() - t0
    t0 = time.perf_counter()
    heis_cpu = heisenberg_example("cpu")
    t_heis_cpu = time.perf_counter() - t0
    r_heis = rel_err(heis, heis_cpu)
    assert r_heis <= 1e-5, f"generic: (b) card vs CPU {r_heis:.3e} > 1e-5"
    for k, (nrm, tr, tr0) in enumerate(heis):
        log("generic", f"(b) ising_2d_heisenberg step {k + 1}: Frobenius norm "
                       f"{nrm.real:.6f}, |Tr O(t)| {abs(tr):.3e}, Tr O(t)O(0) "
                       f"{tr0.real:.6f}")
    log("generic", f"(b) card vs CPU: {r_heis:.2e} relative to the largest "
                   f"value (bar 1e-5); {t_heis:.1f} s on the card, "
                   f"{t_heis_cpu:.1f} s on the CPU")

    # (c): once the χ=8 cap truncates, the run amplifies rounding step by
    # step (the kept subspace of a near-degenerate spectrum is
    # ill-conditioned), so 1e-5 holds only for the steps before the cap
    # binds; a second CPU run on one thread shows the CPU's own spread
    t0 = time.perf_counter()
    therm = thermal_example(dev)
    t_therm = time.perf_counter() - t0
    t0 = time.perf_counter()
    therm_cpu = thermal_example("cpu")
    t_therm_cpu = time.perf_counter() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        therm_cpu1 = thermal_example("cpu")
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(therm).all(), "generic: (c) non-finite"
    scale = np.abs(therm_cpu[:, :3]).max(axis=0)
    card_vs_cpu = (np.abs(therm[:, :3] - therm_cpu[:, :3]) / scale).max(axis=1)
    cpu_vs_cpu = (np.abs(therm_cpu1[:, :3] - therm_cpu[:, :3]) / scale).max(
        axis=1)
    at_cap = therm_cpu[:, 3] >= 8
    capped = int(np.argmax(at_cap)) if at_cap.any() else len(at_cap)
    assert (card_vs_cpu[:capped] <= 1e-5).all(), (
        f"generic: (c) card vs CPU before the cap {card_vs_cpu[:capped]}")
    assert (card_vs_cpu <= 1e-2).all(), f"generic: (c) card vs CPU {card_vs_cpu}"
    for k, (en, x, s2, bond) in enumerate(therm):
        log("generic", f"(c) thermal_states beta {0.1 * (k + 1):.1f}: "
                       f"E/site {en:+.6f}, <X> {x:+.6f}, S2/site {s2:.6f}, "
                       f"max bond {int(bond)}; card vs CPU {card_vs_cpu[k]:.2e}, "
                       f"CPU {threads} threads vs 1 {cpu_vs_cpu[k]:.2e}")
    log("generic", f"(c) card vs CPU relative per column: steps 1-{capped} "
                   f"(bond below the cap) within 1e-5, all within 1e-2; "
                   f"{t_therm:.1f} s on the card, {t_therm_cpu:.1f} s on the "
                   f"CPU")

    # (e) ops.linalg.eigendecomp_hermitian on the card against the CPU, on
    # a random 16x16 complex64 PSD matrix
    from tensornetworkquantumsimulator_torch.ops import linalg as ops_linalg

    gen = torch.Generator().manual_seed(16)
    b = torch.randn(16, 16, dtype=torch.complex64, generator=gen)
    i = tt.Index(16)
    eig = {}
    for where in (dev, "cpu"):
        m = tt.ops.from_array((b @ b.mH).to(where), (i, i.prime()))
        u, w, odt = ops_linalg.eigendecomp_hermitian(m, regularization=0.0)
        assert odt == torch.complex64 and u.device == w.device == m.device, (
            f"generic: (e) eigendecomp_hermitian on {u.device}, {odt}")
        eig[where] = (w, (u * w.to(u.dtype)) @ u.mH)
    r_w = rel_err(eig[dev][0], eig["cpu"][0])
    r_m = rel_err(eig[dev][1], eig["cpu"][1])
    log("generic", f"(e) eigendecomp_hermitian 16x16 complex64 PSD on "
                   f"{eig[dev][0].device}: w {r_w:.2e}, U diag(w) U^H "
                   f"{r_m:.2e} relative to the CPU's (bar 1e-5)")
    assert max(r_w, r_m) <= 1e-5, (
        f"generic: (e) eigendecomp_hermitian card vs CPU {r_w:.3e} {r_m:.3e}")
    return launches, {"generic chi10 layer": (one_layer, layer_ms)}


# ---------------------------------------------------------------------------
# phase 15: the generic engine's second half (boundary MPS, loops, sampling,
# truncation, checkpoints)
# ---------------------------------------------------------------------------

GBMPS_LAYERS = 20  # (a): examples/ising_2d_dynamics.py at its defaults


def ising_2d_example(dev, dtype=torch.complex64, **kw):
    """(a): the port's ising_2d_dynamics at its defaults (5x5, χ=5, 20
    batched layers, complex64, boundary-MPS rank 4); ``dtype`` widens its
    product state (the CPU's complex128 run, which ``main`` does not
    offer); ``kw`` are ``main``'s arguments.  Returns (BP ⟨Z⟩(3, 3) of
    the last layer, the boundary-MPS
    ⟨Z⟩(3, 3), each recorded unrounded where the example computes it (its
    print, to 1e-6, checked against them), the largest gate error as it
    prints it; the generic state and the batched (spec, state) it handed
    ``batched_to_tns``)."""
    mod = example("ising_2d_dynamics")
    product = mod.batched_product_state
    handed = []
    to_tns = mod.batched_to_tns

    def unpacked(spec, state, *args, **kwargs):
        psi = to_tns(spec, state, *args, **kwargs)
        handed.append((psi, (spec, state)))
        return psi

    with patched(mod, "batched_product_state",
                 lambda *a, **k: product(*a, **dict(k, dtype=dtype))), \
            patched(mod, "batched_to_tns", unpacked), \
            recorded(mod, "make_expectation_fn", factory=True) as zs, \
            recorded(mod, "expect") as bmps:
        _, r = run_example("ising_2d_dynamics", dev, **kw)
    ((psi, batched),) = handed
    at = batched[0].vertex_position((3, 3))
    z = [float(x[at]) for x in zs]
    z_bmps = complex(bmps[0])
    assert print_holds(r["z"], z, 1e-6) and print_holds(
        r["bmps"], [z_bmps], 1e-6), (r, z, z_bmps)
    return z[-1], z_bmps, float(r["err"].max()), psi, batched


BMPS_RANKS = (1, 2, 4, 8, 16)


def bmps_convergence_example(dev, dtype=torch.complex64):
    """(b): the port's boundarymps_convergence (complex64, χ=2; the line,
    the 3x3 hexagonal and the 5x5 square lattice, the port's generator
    seeded 1634): per lattice the centre ⟨Z⟩ by BP, by the boundary MPS at
    ranks 1-16 and exactly, as it prints them, one row per lattice.
    ``dtype`` widens each drawn state (the CPU's complex128 run)."""
    mod = example("boundarymps_convergence")
    draw = mod.random_tensornetworkstate

    def widened(*args, **kwargs):
        return draw(*args, **kwargs).map_tensors(lambda t: t.astype(dtype))

    with patched(mod, "random_tensornetworkstate", widened):
        _, r = run_example("boundarymps_convergence", dev)
    return np.array(r["z"], dtype=np.complex128)


def loopcorrections_example(dev):
    """(c): the port's loopcorrections (complex64; the line, the 2x2
    hexagonal and the 4x4 square lattice at χ=3, BP-normalized; then the
    3x3 grid at χ=2): per lattice the BP, loop-corrected and exact norm,
    then the 3x3 centre ⟨Z⟩ exactly, by BP and loop-corrected (size 6),
    each recorded unrounded where the example computes it."""
    mod = example("loopcorrections")
    with recorded(mod, "norm") as norms, recorded(mod, "expect") as zs:
        _, r = run_example("loopcorrections", dev)
    assert len(r["norm"]) == 9 and len(r["centre"]) == 4, r
    return np.array([complex(v) for v in norms + zs])


SAMPLE_N = 4


def sampling_state(tt, dev):
    """(d)-(e): a random 4x4 χ=4 complex128 state (seed 7)."""
    tt.seed(7)
    return tt.random_tensornetworkstate(torch.complex128, tt.named_grid((4, 4)),
                                        bond_dimension=4, device=dev)


@contextlib.contextmanager
def draws(sampling, forced=None):
    """Record the sampler's draws (and, with ``forced``, hand those out in
    their place): yields the list of outcomes."""
    drawn = []
    draw = sampling._draw

    def hook(probs, generator=None):
        out = forced[len(drawn)] if forced is not None else draw(probs,
                                                                 generator)
        drawn.append(out)
        return out

    sampling._draw = hook
    try:
        yield drawn
    finally:
        sampling._draw = draw


def generic_samples(tt, psi, forced=None):
    """(d): ``sample`` by "bp", ``sample_directly_certified`` and
    ``sample_certified`` by "boundarymps" (ranks 8), SAMPLE_N each; returns
    (the draws, logq and p/q of the first, p/q of the second, samples/s of
    each sampler)."""
    from tensornetworkquantumsimulator_torch import sampling

    gen = torch.Generator().manual_seed(11)
    kw = dict(alg="boundarymps", projected_mps_bond_dimension=8,
              norm_mps_bond_dimension=8, generator=gen)
    rates, numbers = {}, []
    with draws(sampling, forced) as drawn:
        for name, run in (
                ("bp", lambda: tt.sample(psi, SAMPLE_N, alg="bp",
                                         generator=gen)),
                ("boundarymps", lambda: tt.sample_directly_certified(
                    psi, SAMPLE_N, **kw)),
                ("certified", lambda: tt.sample_certified(
                    psi, SAMPLE_N, certification_mps_bond_dimension=8,
                    **kw))):
            if psi.device().type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            rates[name] = SAMPLE_N / (time.perf_counter() - t0)
            if name == "boundarymps":
                numbers += [r["logq"] for r in out]
            if name != "bp":
                numbers += [complex(r["poverq"]).real for r in out]
    return list(drawn), np.array(numbers, dtype=np.float64), rates


def generic_truncations(tt, psi):
    """(e): ``truncate`` by "bp" and by "boundarymps" (rank 8) to χ=2; per
    result its fidelity with ``psi`` and exact ⟨Z⟩ at two sites."""
    out = []
    for kw in (dict(alg="bp"), dict(alg="boundarymps", mps_bond_dimension=8,
                                    gauge_state=False)):
        phi = tt.truncate(psi, maxdim=2, cutoff=1e-10,
                          normalize_tensors=False, **kw)
        assert phi.maxvirtualdim() == 2, phi.maxvirtualdim()
        f = tt.inner(phi, psi, alg="exact") / np.sqrt(
            abs(tt.norm_sqr(phi, alg="exact") * tt.norm_sqr(psi, alg="exact")))
        z = tt.expect(phi, [("Z", [(1, 1)]), ("Z", [(3, 2)])], alg="exact")
        out += [abs(f) ** 2] + [complex(v).real for v in z]
    return np.array(out)


GBMPS_REL = 1e-5  # card vs CPU, relative, where the CPU's spread is less


@contextlib.contextmanager
def torch_lapack():
    """The CPU's factorizations through torch's LAPACK (MKL) in place of
    numpy's, which the port calls on host tensors.  A rank-deficient QR (a
    boundary MPS's rank-1 starting strand) or an SVD with a degenerate
    spectrum may pick its basis; the two libraries pick differently, and
    so does cuSOLVER on the card.  The spread between a CPU run on each
    measures how far an output depends on that choice."""
    from tensornetworkquantumsimulator_torch import gauge
    from tensornetworkquantumsimulator_torch.ops import linalg

    saved = linalg.svd, linalg.qr, gauge.svd
    linalg.svd = gauge.svd = lambda m: torch.linalg.svd(m,
                                                        full_matrices=False)
    linalg.qr = lambda m: torch.linalg.qr(m, mode="reduced")
    try:
        yield
    finally:
        linalg.svd, linalg.qr, gauge.svd = saved


def free_bar(spread):
    """The card-vs-CPU bar of outputs whose CPU runs on the two LAPACKs
    read ``spread`` apart: GBMPS_REL, or 10x the spread where larger."""
    return np.maximum(GBMPS_REL, 10 * np.asarray(spread))


def moved(psi, device):
    """A copy of a generic state with its tensors on ``device``."""
    out = psi.copy()
    for v in out.vertices():
        out.setindex_preserve(out[v].to(device), v)
    return out


def generic_bmps_phase(tt, dev, counters, card):
    """The generic engine's second half on the card, (a)-(f), each check
    run again on the CPU in this process; every reading is printed before
    any bar is held.  Returns (launches of the counted (a) run, {name:
    (call, ms)} for the busy share)."""
    import tempfile

    failed = []

    def bar(ok, what):
        if not ok:
            failed.append(what)

    def timed(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3

    def cpu_timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    # (a) counted: the batched layers run with no TNQS_* knob, so no kernel
    launches, ((z_bp, z_bmps, err, psi, batched), ms, host_ms) = counted(
        counters, "generic_bmps", (), lambda: timed(
            lambda: ising_2d_example(dev)))
    bar(not any(launches.values()), f"(a) kernels launched {launches}")
    assert psi.device().type == "cuda", psi.device()
    (z_bp_c, z_bmps_c, err_c, _, _), cpu_ms = cpu_timed(
        lambda: ising_2d_example("cpu"))
    # the CPU's own spreads: on one thread, and against complex128 (the
    # rounding a complex64 run carries, which two such runs may each hold)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = ising_2d_example("cpu")[:2]
    finally:
        torch.set_num_threads(threads)
    wide = ising_2d_example("cpu", dtype=torch.complex128)[:2]
    run_c = np.array([z_bp_c, z_bmps_c])
    r_run = np.abs(np.array([z_bp, z_bmps]) - run_c) / np.abs(run_c)
    thr = np.abs(np.array(one) - run_c) / np.abs(run_c)
    c64 = np.abs(run_c - np.array(wide)) / np.abs(np.array(wide))
    # the fit alone: the card's state measured on the CPU, on both LAPACKs
    psi_c = moved(psi, "cpu")

    def fit():
        return complex(tt.expect(psi_c, ("Z", [(3, 3)]), alg="boundarymps",
                                 mps_bond_dimension=4))

    z_fit_c = fit()
    with torch_lapack():
        z_fit_m = fit()
    r_fit = abs(z_bmps - z_fit_c) / abs(z_fit_c)
    s_fit = abs(z_fit_m - z_fit_c) / abs(z_fit_c)
    # the BMPS reading of the two runs carries the fit's free choice too
    bar_run = np.maximum(np.maximum(GBMPS_REL, 10 * thr), 2 * c64)
    bar_run[1] += 10 * s_fit
    bar(np.isfinite([z_bp, z_bmps.real, err]).all(), "(a) non-finite")
    bar(r_fit <= free_bar(s_fit), f"(a) the fit card vs CPU {r_fit:.3e} > "
                                  f"{free_bar(s_fit):.1e}")
    bar((r_run <= bar_run).all(), f"(a) card vs CPU (BP, BMPS) {r_run} > "
                                  f"{bar_run}")
    log("generic_bmps", f"(a) ising_2d_dynamics 5x5 chi=5 c64, "
                        f"{GBMPS_LAYERS} batched layers: launches {launches};"
                        f" max gate error {err:.3e}; <Z>(3,3) BP {z_bp:.6f},"
                        f" boundary MPS rank 4 {z_bmps.real:.6f}"
                        f"{z_bmps.imag:+.1e}j; the fit on the card's state, "
                        f"card vs CPU {r_fit:.2e}, the CPU's two LAPACKs "
                        f"{s_fit:.2e} (bar {free_bar(s_fit):.1e}); card's run"
                        f" vs CPU's run (BP, BMPS) {r_run[0]:.2e}, "
                        f"{r_run[1]:.2e}, the CPU on 1 vs {threads} threads "
                        f"{thr[0]:.2e}, {thr[1]:.2e}, its complex64 vs "
                        f"complex128 {c64[0]:.2e}, {c64[1]:.2e} (bars "
                        f"{bar_run[0]:.1e}, {bar_run[1]:.1e}); {ms:.0f} ms "
                        f"between CUDA events ({host_ms:.0f} ms host) on the "
                        f"card, {cpu_ms:.0f} ms on the CPU")

    # (b) rank convergence, card vs CPU per rank, on each lattice
    (conv, ms, host_ms) = timed(lambda: bmps_convergence_example(dev))
    conv_c, cpu_ms = cpu_timed(lambda: bmps_convergence_example("cpu"))
    with torch_lapack():
        conv_m = bmps_convergence_example("cpu")
    wide = bmps_convergence_example("cpu", torch.complex128)
    per_rank = np.abs(conv - conv_c) / np.abs(conv_c)
    spread = np.abs(conv_m - conv_c) / np.abs(conv_c)
    # as in (a): the rounding each complex64 run carries, twice its CPU
    # run's distance from complex128 on the same states
    c64 = np.abs(conv_c - wide) / np.abs(wide)
    bar_b = np.maximum(free_bar(spread), 2 * c64)
    err_bp, err16 = (np.abs(conv[:, k] - conv[:, -1]) for k in (0, -2))
    bar(conv.shape == (3, 7) and np.isfinite(conv).all()
        and (per_rank <= bar_b).all(), f"(b) card vs CPU {per_rank} > {bar_b}")
    # on the two lattices with loops, rank 16 is closer to exact than BP
    bar((err16[1:] < err_bp[1:]).all(),
        f"(b) rank 16 {err16} vs BP {err_bp}")

    def e1(x):
        return [float(f"{v:.1e}") for v in np.ravel(x)]

    sq = conv[-1]
    log("generic_bmps", f"(b) boundarymps_convergence c64 chi=2, 5x5 square "
                        f"centre <Z>: BP {sq[0].real:+.6f}, ranks {BMPS_RANKS} "
                        f"{[f'{v.real:+.6f}{v.imag:+.1e}j' for v in sq[1:-1]]}"
                        f", exact {sq[-1].real:+.6f}; |rank 16 - exact| "
                        f"(line, hexagonal, square) {e1(err16)} vs |BP - "
                        f"exact| {e1(err_bp)}; card vs CPU per value, the "
                        f"largest of each lattice {e1(per_rank.max(axis=1))}"
                        f", the CPU's two LAPACKs {e1(spread.max(axis=1))}, "
                        f"its complex64 vs complex128 {e1(c64.max(axis=1))} "
                        f"(bars from {e1(bar_b.min(axis=1))}); "
                        f"{ms:.0f} ms on the card ({host_ms:.0f} ms host), "
                        f"{cpu_ms:.0f} ms on the CPU")

    # (c) loop corrections: card vs CPU, and the loop series closer to
    # exact than BP on the hexagonal and square norms and the 3x3 <Z>
    (loops, ms, host_ms) = timed(lambda: loopcorrections_example(dev))
    loops_c, cpu_ms = cpu_timed(lambda: loopcorrections_example("cpu"))
    r_loops = np.abs(loops - loops_c) / np.abs(loops_c)
    bar(len(loops) == 12 and np.isfinite(loops).all()
        and (r_loops <= GBMPS_REL).all(), f"(c) card vs CPU {r_loops}")
    # (BP, loops, exact) per lattice, then the 3x3 <Z> (exact, BP, loops)
    triples = [loops[3 * k:3 * k + 3] for k in range(3)]
    triples.append(loops[[10, 11, 9]])
    err_bp = [abs(t[0] - t[2]) for t in triples]
    err_lc = [abs(t[1] - t[2]) for t in triples]
    bar(all(err_lc[k] < err_bp[k] for k in (1, 2, 3)),
        f"(c) loops vs BP against exact {err_lc} vs {err_bp}")
    def r6(t, part=abs):
        return [round(float(part(x)), 6) for x in t]

    log("generic_bmps", f"(c) loopcorrections c64: norms BP / loops / exact "
                        f"line {r6(triples[0])}, hex 2x2 {r6(triples[1])}, "
                        f"4x4 {r6(triples[2])}; 3x3 centre <Z> BP / loops(6)"
                        f" / exact {r6(triples[3], np.real)}; card "
                        f"vs CPU max {r_loops.max():.2e} (bar 1e-5); {ms:.0f} "
                        f"ms on the card ({host_ms:.0f} ms host), {cpu_ms:.0f}"
                        f" ms on the CPU (its contraction orders cached by "
                        f"the card's run)")

    # (d) sampling: the card draws, the CPU run takes the card's draws
    psi_s = sampling_state(tt, dev)
    ((drawn, nums, rates), ms, host_ms) = timed(
        lambda: generic_samples(tt, psi_s))
    (drawn_c, nums_c, rates_c), cpu_ms = cpu_timed(
        lambda: generic_samples(tt, sampling_state(tt, "cpu"), forced=drawn))
    with torch_lapack():
        _, nums_m, _ = generic_samples(tt, sampling_state(tt, "cpu"),
                                       forced=drawn)
    r_s = np.abs(nums - nums_c) / np.maximum(np.abs(nums_c), 1.0)
    s_s = np.abs(nums_m - nums_c) / np.maximum(np.abs(nums_c), 1.0)
    bar(drawn_c == drawn and np.isfinite(nums).all()
        and (r_s <= free_bar(s_s)).all(),
        f"(d) card vs CPU {r_s} > {free_bar(s_s)}")
    log("generic_bmps", f"(d) 4x4 chi=4 c128, {SAMPLE_N} samples each, card "
                        f"draws forced on the CPU ({len(drawn)} draws): logq "
                        f"and p/q card vs CPU {e1(r_s)}, the CPU's two "
                        f"LAPACKs {e1(s_s)} (relative, floor 1; bars "
                        f"{e1(free_bar(s_s))}); samples/s card "
                        f"{ {k: round(v, 2) for k, v in rates.items()} }, "
                        f"CPU { {k: round(v, 2) for k, v in rates_c.items()} }"
                        f"; {ms:.0f} ms on the card ({host_ms:.0f} ms host)")

    # (e) truncation
    (trunc, ms, host_ms) = timed(lambda: generic_truncations(tt, psi_s))
    trunc_c, cpu_ms = cpu_timed(
        lambda: generic_truncations(tt, sampling_state(tt, "cpu")))
    with torch_lapack():
        trunc_m = generic_truncations(tt, sampling_state(tt, "cpu"))
    d_tr, s_tr = np.abs(trunc - trunc_c), np.abs(trunc_m - trunc_c)
    bar(np.isfinite(trunc).all() and (d_tr <= free_bar(s_tr)).all(),
        f"(e) card vs CPU {d_tr} > {free_bar(s_tr)}")
    log("generic_bmps", f"(e) truncate 4x4 chi=4 -> 2: fidelity, <Z>(1,1), "
                        f"<Z>(3,2) by bp {np.round(trunc[:3], 6).tolist()}, "
                        f"by boundarymps {np.round(trunc[3:], 6).tolist()}; "
                        f"card vs CPU {e1(d_tr)}, the CPU's two LAPACKs "
                        f"{e1(s_tr)} (bars {e1(free_bar(s_tr))}); {ms:.0f} ms on "
                        f"the card ({host_ms:.0f} ms host), {cpu_ms:.0f} ms "
                        f"on the CPU")

    # (f) a checkpoint round trip from and onto the card
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        tt.save_state(path, psi)
        back = tt.load_state(path, device=dev)
    bar(all(back[v].device.type == "cuda" for v in back.vertices())
        and all(torch.equal(back[v].data, psi[v].data)
                for v in psi.vertices()), "(f) tensors differ")
    z_back, z_kept = (complex(tt.expect(st, ("Z", [(3, 3)]),
                                        alg="boundarymps",
                                        mps_bond_dimension=4))
                      for st in (back, psi))
    bar(abs(z_back - z_kept) <= 1e-6, f"(f) {z_back} vs {z_kept}")
    log("generic_bmps", f"(f) save_state / load_state of (a)'s state through "
                        f"the host, onto the card: tensors equal, rank-4 "
                        f"<Z>(3,3) {z_back.real:.6f}")
    assert not failed, f"generic_bmps: {failed}"

    def one_bmps():
        return tt.expect(psi, ("Z", [(3, 3)]), alg="boundarymps",
                         mps_bond_dimension=4)

    _, bmps_ms, _ = timed(one_bmps)
    spec, state = batched
    z_sites = tt.local_expectations(spec, state, tt.op_matrix(
        "Z", 2)).real.cpu().numpy()
    return (launches, {"generic rank-4 BMPS <Z>": (one_bmps, bmps_ms)},
            z_sites)


def busy_shares(profiled: dict, card, phase: str = "measure") -> None:
    """The device's busy share of each call in ``profiled`` (name → (call,
    its milliseconds without the profiler)): the device time of every
    kernel and copy ``torch.profiler`` traced, over the call's time
    without the profiler (the trace stretches the host's part of the wall,
    not the kernels).  Run last: the profiler stays attached and slows
    later launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, (fn, plain_ms) in profiled.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only: a host operator's entry repeats the
        # device time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        ops = sum(e.count for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
        share = (f"{100 * busy_ms / plain_ms:.1f}%" if busy_ms > 0
                 else "not measured")
        log(phase, f"{card}: {name}: device busy {share} ({busy_ms:.1f} "
                       f"ms in {ops} device operations, over {plain_ms:.1f} "
                       f"ms per call without the profiler; {traced_ms:.1f} ms "
                       f"under it); most device time: "
                       f"{[(e.key[:48], round(e.self_device_time_total / 1e3, 1)) for e in top]}")


def layers_per_second(tt, dev, name, nlayers, env) -> float:
    """Layers/s over ``nlayers`` layers after one warm-up layer, between two
    CUDA events."""
    with knobs(env):
        if name == "chi10_rolled":
            _, state, layer, site, bond = build_rolled(tt, dev)

            def step(st, i):
                return layer(st, site[i % ROLLS], bond[i % ROLLS])[0]
        else:
            _, state, layer_fn = build_config(tt, dev, name)

            def step(st, i):
                return layer_fn(st)[0]
        state = step(state, 0)  # warm-up layer
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(nlayers):
            state = step(state, 1 + i)
        end.record()
        end.synchronize()
    return nlayers / (start.elapsed_time(end) / 1e3)


def colour_groups(tt) -> None:
    """The colour-group bucket sizes of each grid configuration, with the
    process's PYTHONHASHSEED: the vendored edge colouring walks
    hash-ordered sets, so the grouping (and the batch each kernel sees)
    can change between runs."""
    seed = os.environ.get("PYTHONHASHSEED", "unset (random per process)")
    for name, g in (("5x5 grid (chi10, chi10_rolled, noisy)",
                     tt.named_grid((5, 5))),
                    ("Eagle-127 (chi64)", tt.ibm_eagle_lattice())):
        sizes = [[len(b.u_idx) for b in grp]
                 for grp in tt.compile_graph(g).color_groups]
        log("groups", f"{name}: edges per (slot pair) bucket, per colour "
                      f"group: {sizes}; PYTHONHASHSEED {seed}")


# ---------------------------------------------------------------------------
# phase 16: the examples that no earlier phase runs, through the port's
# example modules
# ---------------------------------------------------------------------------

# each example's arguments in its test (tests/test_torch_examples.py); the
# card's run at these is held against the CPU's in this process
EXAMPLE_REDUCED = {
    "ising_3d_dynamics": dict(no_trotter_steps=1, chi=2),
    "heavyhex_ising_dynamics": dict(hx=2, hy=2, no_trotter_steps=2, chi=3,
                                    nsamples=2),
    "disorder_ensemble": dict(nx=3, ny=3, chi=2, n_layers=2, n_ensemble=3),
    "noisy_circuit": dict(nx=3, ny=3, layers=2),
    "lindblad_dynamics": dict(t_final=0.15, dt=0.05, chi=8),
    "loschmidt_echo": dict(steps=2, chi=3),
    "correlation_functions": dict(steps=2, chi=3),
    "batched_gauge_loopcorrections": dict(nl=5, nx=4, ny=4, chi=4),
    "tfim_ground_state": dict(nsteps=50),
    "variational_ground_state": dict(steps=10),
    "excited_states": dict(steps=10),
    "sharded_dynamics": dict(n_layers=2, chi=2),
}
# the full-size runs' depth cuts (steps or layers; the lattice and χ stay
# the example's), each printed on the example's line: the two optimizers
# took 52.7 s (600 steps) and 72.7 s (500 + 1000 steps) at their defaults
# on an H100, the other ten 49 s together
EXAMPLE_CUTS = {"variational_ground_state": dict(steps=200),
                "excited_states": dict(steps=150)}
# ising_2d_dynamics on the fast stack at its defaults (χ=5): the
# environment roots are 5x5, which K1's shape gate (the reference's: even
# 4 <= n <= 40) sends to the library, so only K2 (the Gram split's 10x10)
# launches.  K1 runs at χ=6 (6x6 roots), on the fast stack with the
# library SVD split.  On the full fast stack χ=6 moves <Z> by 1.7e-4 to
# 1.9e-4 (hash seeds 0-4, H100, `--fast-stack 6`), and by 1.3e-5 to 2.3e-5
# with K2 replaced by the library eigh (KERNELS_OFF): an open fault of K2
# (ROADMAP Queue 3), printed each run by examples_phase, not held here
FAST_STACK_RUNS = ((5, FAST_STACK), (6, SVD_STACK))
# card against CPU at the reduced arguments, the tests' bars: (number,
# columns or None, rtol, atol)
EXAMPLE_BARS = {
    "ising_3d_dynamics": [("z0", None, 0, 1e-4), ("z", None, 0, 1e-4),
                          ("err", None, 2e-2, 1e-7)],
    "heavyhex_ising_dynamics": [("fid", None, 0, 2e-5),
                                ("bp", None, 0, 1e-4),
                                ("bmps", None, 0, 1e-4)],
    "disorder_ensemble": [("zbar", None, 0, 1e-4), ("zstd", None, 0, 1e-4),
                          ("returned", None, 0, 1e-4)],
    "noisy_circuit": [("table", None, 0, 2e-6), ("zb", None, 0, 1e-4),
                      ("pb", None, 0, 1e-4), ("sweep", None, 0, 1.5e-4)],
    "lindblad_dynamics": [("table", slice(0, 3), 0, 2e-6),
                          ("table", slice(3, 4), 1e-2, 1e-12)],
    "loschmidt_echo": [("log_echo", None, 0, 1e-4), ("rate", None, 0, 1e-4)],
    "correlation_functions": [("corr", None, 0, 1e-4),
                              ("bmps", None, 0, 1e-4)],
    "batched_gauge_loopcorrections": [("plaquettes", None, 0, 0),
                                      ("rel", None, 2e-3, 0),
                                      ("ent", None, 0, 2e-4)],
    "tfim_ground_state": [("energy", None, 1e-4, 0),
                          ("returned", None, 1e-4, 0)],
    "variational_ground_state": [("returned", None, 1e-4, 0)],
    "excited_states": [("returned", slice(0, 2), 1e-4, 0),
                       ("returned", slice(2, 3), 1e-2, 1e-5)],
    "sharded_dynamics": [("err", None, 0, 1e-6), ("z", None, 0, 1e-5),
                         ("zz", None, 0, 1e-5), ("ent", None, 0, 1e-4),
                         ("trunc", None, 0, 1e-6), ("lz", None, 0, 1e-4),
                         ("lc", None, 0, 1e-6), ("eagle", None, 0, 1e-5)],
}
REDUCED_SHARDS = 4  # sharded_dynamics at its test's 4 shards
# the full-size runs' own checks: heavy-hex BP against boundary-MPS <Z>
# (BP's loop error, as the grid's in [measure]); noisy_circuit's generic
# engine against its batched one (float64 against complex64, each capped
# at χ=8); ground energies against the dense ones (the bar of
# [variational]); excited_states' final overlap penalty
EXAMPLE_BP_BMPS = 2e-2
EXAMPLE_ENGINES = 1e-3
EXAMPLE_GROUND = 5e-2
EXAMPLE_PENALTY = 1e-2


def bond_entropy_max(spectra) -> float:
    """The largest bond entropy, as sharded_dynamics computes it from the
    sharded gauge's spectra."""
    ent = spectra.cpu().numpy()
    ent = ent / ent.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.nansum(np.where(ent > 0, -ent * np.log(ent), 0.0),
                               axis=1).max())


def examples_run(name, device, kw, shards=None):
    """The port's example ``name`` at arguments ``kw`` on ``device``: its
    printed numbers by name, plus what ``main`` returned (``returned``,
    numbers only).  Where a number prints as coarse as its test's bar
    (log|echo| to 1e-4, the largest bond entropy to 1e-4) it is recorded
    unrounded where the example computes it and replaces the printed
    one, as do noisy_circuit's batched ⟨Z⟩ means (the sweep's print to
    1e-4); the samples' bits, logq and p/q are recorded too."""
    mod = example(name)
    with contextlib.ExitStack() as stack:
        if shards is not None:
            stack.enter_context(patched(mod, "SHARDS", shards))
        records = {attr: stack.enter_context(recorded(mod, attr, factory))
                   for attr, factory in (
                       ("batched_loschmidt_echo", False),
                       ("make_sharded_gauge", True),
                       ("make_planar_certified_sampler", True),
                       ("make_rho_sampler", True),
                       ("sample_density_matrix", False),
                       ("make_pauli_expectation_fn", True))
                   if hasattr(mod, attr)}
        out, r = run_example(name, device, **kw)
    if isinstance(out, tuple):  # excited_states: E0, E1, penalty, levels
        r["returned"] = np.array([float(x) for x in out[:3]])
        r["levels"] = out[3].cpu().numpy()
    elif isinstance(out, float):
        r["returned"] = np.array([out])
    elif isinstance(out, torch.Tensor):
        r["returned"] = out.cpu().numpy()
    if "batched_loschmidt_echo" in records:
        r["log_echo"] = np.array([float(e[0]) for e in
                                  records["batched_loschmidt_echo"]])
    if "make_pauli_expectation_fn" in records:  # noisy_circuit
        means = [float(x["Z"].real.mean())
                 for x in records["make_pauli_expectation_fn"]]
        r["zb"], r["sweep"] = np.array(means[:1]), np.array(means[1:])
    if "make_sharded_gauge" in records:
        ((_, spectra),) = records["make_sharded_gauge"]
        r["ent"] = np.array([bond_entropy_max(spectra)])
    for attr in ("make_planar_certified_sampler", "make_rho_sampler"):
        for bits, *logs in records.get(attr, []):
            assert bits.dim() == 2 and all(torch.isfinite(x).all()
                                           for x in logs), (name, attr)
            assert all((x <= 1e-5).all() for x in logs[:1]), (name, "logq")
    for samples in records.get("sample_density_matrix", []):
        assert all(s["logp"] <= 1e-12 for s in samples), (name, "logp")
    return out, r


def examples_full_checks(name, r, out, kw) -> list:
    """The example's own checks at full size, each (what, ok): every
    printed number finite, and where the example prints what to hold a
    result to, that."""
    checks = [("every printed number finite", all(
        np.isfinite(np.asarray(v, dtype=np.complex128)).all() and np.size(v)
        for k, v in r.items() if k != "lattice"))]
    if name == "ising_3d_dynamics":
        checks.append(("|Z| <= 1", np.all(np.abs(r["z"]) <= 1 + 1e-6)))
    elif name == "heavyhex_ising_dynamics":
        d = float(abs(r["bp"][0] - r["bmps"][0]))
        checks += [(f"BP vs boundary-MPS <Z> {d:.2e} <= "
                    f"{EXAMPLE_BP_BMPS:.0e}", d <= EXAMPLE_BP_BMPS),
                   ("fidelities in (0, 1]", np.all((r["fid"] > 0)
                                                   & (r["fid"] <= 1))),
                   ("|sampled Z| <= 1", abs(r["sampled"][0]) <= 1 + 1e-6)]
    elif name == "disorder_ensemble":
        checks.append(("|zbar| <= 1 and returned as printed",
                       np.all(np.abs(r["zbar"]) <= 1) and np.allclose(
                           r["returned"], r["zbar"], atol=1e-6)))
    elif name == "noisy_circuit":
        t = r["table"]
        dz = float(abs(t[-1, 1] - r["zb"][0]))
        dp = float(abs(t[-1, 2] - r["pb"][0]))
        purities = np.append(t[:, 2], r["pb"])
        checks += [("purities in (0, 1]", np.all((purities > 0)
                                                 & (purities <= 1))),
                   (f"generic vs batched engine <Z> {dz:.2e}, purity "
                    f"{dp:.2e} <= {EXAMPLE_ENGINES:.0e}",
                    max(dz, dp) <= EXAMPLE_ENGINES)]
    elif name == "lindblad_dynamics":
        t = r["table"]
        checks.append(("purity in (0, 1], |Z| <= 1", np.all(
            (t[:, 2] > 0) & (t[:, 2] <= 1) & (np.abs(t[:, 1]) <= 1))))
    elif name == "loschmidt_echo":
        checks.append(("log|echo| <= 0", np.all(r["log_echo"] <= 1e-6)))
    elif name == "correlation_functions":
        checks.append(("|C|, |<ZZ>| <= 1", np.all(np.abs(r["corr"]) <= 1)
                       and np.all(np.abs(r["bmps"]) <= 1)))
    elif name == "batched_gauge_loopcorrections":
        checks.append(("loop correction > 0, 0 <= entropies",
                       r["rel"][0] > 0 and 0 <= r["ent"][0] <= r["ent"][1]))
    elif name in ("tfim_ground_state", "variational_ground_state"):
        e, e0 = float(r["returned"][0]), tfim_ground_energy(3, 3)
        off = abs(e - e0) / abs(e0)
        checks.append((f"E {e:.6f} vs dense {e0:.6f}: {off:.2e} <= "
                       f"{EXAMPLE_GROUND:.0e}", off <= EXAMPLE_GROUND))
    elif name == "excited_states":
        (e0, e1, pen), levels = r["returned"], r["levels"]
        off = [abs(e0 - levels[0]) / abs(levels[0]),
               abs(e1 - levels[1]) / abs(levels[1])]
        checks += [("variational bounds", e0 >= levels[0] - 1e-4
                    and e1 >= levels[0] - 1e-4),
                   (f"E0, E1 vs dense {off[0]:.2e}, {off[1]:.2e} <= "
                    f"{EXAMPLE_GROUND:.0e}", max(off) <= EXAMPLE_GROUND),
                   (f"penalty {pen:.2e} <= {EXAMPLE_PENALTY:.0e}",
                    pen <= EXAMPLE_PENALTY)]
    elif name == "sharded_dynamics":
        checks.append(("|Z| <= 1", np.all(np.abs(r["z"]) <= 1 + 1e-6)
                       and abs(r["eagle"][0]) <= 1))
    return checks


def tfim_ground_energy(nx, ny, J=1.0, hx=3.0) -> float:
    """The dense ground energy of the nx×ny TFIM (tests/dense_oracle.py)."""
    sys.path.insert(0, str(REPO / "tests"))
    import tensornetworkquantumsimulator_torch as tt
    from dense_oracle import exact_tfim_levels

    spec, _ = tt.batched_product_state(tt.named_grid((nx, ny)), chi=1,
                                       device="cpu")
    return float(exact_tfim_levels(spec, J, hx, 1)[0])


def examples_held(name, got, ref) -> list:
    """Card (``got``) against CPU (``ref``) at the reduced arguments, per
    number at its test's bar: (what, worst |d|, bar, ok)."""
    out = []
    for key, cols, rtol, atol in EXAMPLE_BARS[name]:
        a, b = (np.asarray(x[key]) for x in (got, ref))
        if cols is not None:
            a, b = a[..., cols], b[..., cols]
        ok = a.shape == b.shape and a.size > 0 and np.allclose(
            a, b, rtol=rtol, atol=atol)
        worst = float(np.abs(a - b).max()) if a.shape == b.shape else np.inf
        out.append((key if cols is None else f"{key}[{cols.start}:"
                    f"{cols.stop}]", worst, f"rtol {rtol:g} atol {atol:g}",
                    ok))
    return out


def examples_phase(tt, dev, engine, counters, card, z_default=None):
    """The twelve examples no earlier phase runs, on the card: each at its
    defaults (full width; depth cut where EXAMPLE_CUTS says), counted as
    the ``examples`` path (default knobs: no kernel launches), timed with
    CUDA events and held to its own checks; then each at its test's
    reduced arguments on the card and on the CPU, card against CPU at the
    test's bars, except after a BP refresh that stopped one sweep apart at
    the tolerance (``straddles``).  Then ising_2d_dynamics at its defaults
    again under
    FAST_STACK, and at χ=6 under SVD_STACK (FAST_STACK_RUNS), as the
    ``examples_fast_stack`` path: K1 and K2 must launch, and every site's
    ⟨Z⟩ stays within BAND of the same run at default knobs (at its
    defaults ``z_default``, from ``[generic_bmps]`` (a), computed here when
    None).  χ=6 on the full FAST_STACK, K2's open fault, is printed.
    Every reading is printed before a bar is held.  Returns {path:
    launches}."""
    failed = []
    times = {}

    def full_runs():
        for name in EXAMPLE_REDUCED:
            kw = EXAMPLE_CUTS.get(name, {})
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out, r = examples_run(name, dev, kw)
            end.record()
            end.synchronize()
            times[name] = (start.elapsed_time(end),
                           (time.perf_counter() - t0) * 1e3)
            checks = examples_full_checks(name, r, out, kw)
            failed.extend(f"{name}: {what}" for what, ok in checks if not ok)
            cut = (f"depth cut {kw}" if kw else "no cut")
            log("examples", f"{name} at its defaults ({cut}): "
                            f"{times[name][0]:.0f} ms between CUDA events "
                            f"({times[name][1]:.0f} ms host); "
                            + "; ".join(f"{what} {'ok' if ok else 'FAILED'}"
                                        for what, ok in checks))

    launches, _ = counted(counters, "examples", (), full_runs)
    failed.extend(f"kernel {k} launched {n} times under default knobs"
                  for k, n in launches.items() if n)

    for name, kw in EXAMPLE_REDUCED.items():
        shards = REDUCED_SHARDS if name == "sharded_dynamics" else None
        with bp_decisions(engine) as bp_card:
            _, got = examples_run(name, dev, kw, shards)
        with bp_decisions(engine) as bp_cpu:
            _, ref = examples_run(name, "cpu", kw, shards)
        held = examples_held(name, got, ref)
        flip = bp_flip(bp_card, bp_cpu)
        readings = ", ".join(f"{key} {worst:.2e} ({bar})"
                             for key, worst, bar, _ in held)
        misses = [f"{name} reduced: {key} card vs CPU {worst:.3e} ({bar})"
                  for key, worst, bar, ok in held if not ok]
        if flip is None:
            failed.extend(misses)
            log("examples", f"{name} at {kw} card vs CPU ({len(bp_card)} BP "
                            f"refreshes, each stopped at the same sweeps): "
                            f"{readings}")
            continue
        # a BP refresh stopped one sweep apart.  Where rounding decided it
        # (the distances straddle the tolerance, as in [ensemble]), the
        # readings past it may leave their bars and are printed only.
        # Where the distances lie far apart, the two runs entered the
        # refresh apart by more than rounding (noisy_circuit under some
        # colourings: one member's first sweep moves its messages by 2e-5
        # on an H100 and by 7e-8 on the CPU), and the readings are held
        i, e, d_card, d_cpu, tol = flip
        at_tol = straddles(d_card, d_cpu, tol)
        if not at_tol:
            failed.extend(misses)
        log("examples", f"{name} at {kw} card vs CPU: BP refresh {i} of "
                        f"{len(bp_card)}, member {e}, stopped one sweep apart"
                        f" (distances card {d_card:.6e}, CPU {d_cpu:.6e}, "
                        f"tolerance {tol:.1e}, "
                        + ("at the tolerance); readings after it, not held: "
                           if at_tol else "not at the tolerance); readings "
                           "held: ") + readings)

    # ising_2d_dynamics on the fast stack against the default knobs, at
    # its defaults and at an even χ (FAST_STACK_RUNS)
    def sites(batched):
        return ising_2d_sites(tt, batched)

    plain = {}
    for chi, _ in FAST_STACK_RUNS:
        if chi == 5 and z_default is not None:
            plain[chi] = z_default  # (15) (a): the defaults, default knobs
        else:
            plain[chi] = sites(ising_2d_example(dev, chi=chi)[4])

    def fast_runs():
        out = {}
        for chi, env in FAST_STACK_RUNS:
            with knobs(env):
                out[chi] = sites(ising_2d_example(dev, chi=chi)[4])
        return out

    fast, z_fast = counted(counters, "examples_fast_stack", ("K1", "K2"),
                           fast_runs)
    for chi, env in FAST_STACK_RUNS:
        dz = float(np.abs(z_fast[chi] - plain[chi]).max())
        stack = "the fast stack" if env is FAST_STACK else (
            "the fast stack with the library SVD split")
        log("examples", f"ising_2d_dynamics (20 layers, 5x5) at chi={chi} on "
                        f"{stack}: max site |dZ| vs the default knobs "
                        f"{dz:.2e} (bar {BAND})")
        if dz > BAND:
            failed.append(f"ising_2d_dynamics chi={chi} |dZ| {dz:.3e}")
    log("examples", f"the fast-stack runs (chi 5 and 6) launched {fast}")
    # the open fault of K2 in the gram split at χ=6 (FAST_STACK_RUNS)
    with knobs(FAST_STACK):
        dz6 = float(np.abs(sites(ising_2d_example(dev, chi=6)[4])
                           - plain[6]).max())
    log("examples", f"OPEN FAULT (ROADMAP Queue 3, not held): "
                    f"ising_2d_dynamics at chi=6 on the full fast stack: max "
                    f"site |dZ| vs the default knobs {dz6:.2e} (band {BAND}); "
                    f"the same split with the library eigh stays inside it")

    log("examples", f"{card}: ms per example at its defaults (CUDA events): "
                    + ", ".join(f"{k} {v[0]:.0f}" for k, v in times.items()))
    assert not failed, f"examples: {failed}"
    return {"examples": launches, "examples_fast_stack": fast}


# ---------------------------------------------------------------------------
# phase 17: the multi-device engine, S shards timesharing cuda:0
# ---------------------------------------------------------------------------

# layers each sharded main path runs
SHARDED_LAYERS = {"sharded_chi32": 3, "sharded_2d": 2, "sharded_heavyhex": 2}
SHARD_CHI = 32  # (a), (b): the chi32 configuration's χ
SHARD_HEX_CHI = 16  # (c)
SHARD_BAND = 1e-4  # sharded layer vs unsharded, max site |dZ|
SHARD_MEASURE_BAND = 1e-5  # readouts, gauge, truncate, echo, correlators
SHARD_BMPS_RANK = 16
SHARD_BMPS_BAND = 5e-5
SHARD_LOOP_BAND = 1e-4
SHARD_LOGQ_BAND = 5e-3
SHARD_SAMPLES = 10  # per sampler call, split over the 5 shards
SHARD_TRUNC_CUTOFF = 1e-6
TFIM = dict(dt=0.25, hx=1.0, hz=0.8, J=0.5)  # bench.py:272-279


def ordered_circuit(spec, one_site, two_site):
    """A tuple circuit: the named 1-site gates ``one_site`` on every vertex,
    then the named 2-site gate ``two_site`` on every edge in the spec's
    colour groups and their order.  Each group's first gate touches a
    vertex of the group before, or follows an identity gate where no gate
    does, so ``BatchedCircuit`` splits its matchings exactly at the groups
    (checked by :func:`unsharded_layer`)."""
    verts = spec.vertices
    circ = [(name, [v], a) for name, a in one_site for v in verts]
    prev = set()
    for group in spec.color_groups:
        pairs = [(iu, iv) for b in group for iu, iv in zip(b.u_idx, b.v_idx)]
        pairs.sort(key=lambda p: not (p[0] in prev or p[1] in prev))
        if prev and not prev & set(pairs[0]):
            circ.append(("I", [verts[pairs[0][0]]]))
        circ += [(two_site[0], [verts[iu], verts[iv]], two_site[1])
                 for iu, iv in pairs]
        prev = {i for p in pairs for i in p}
    return circ


def layer_gates(tt, one_site, two_site):
    """The same circuit as one uniform 1-site gate (the product of
    ``one_site`` in order) and one 2-site gate, for the sharded layers."""
    gate1 = np.eye(2, dtype=np.complex128)
    for name, a in one_site:
        gate1 = tt.gate_matrix(name, a) @ gate1
    return tt.gate_matrix(*two_site).reshape(2, 2, 2, 2), gate1


def unsharded_layer(tt, g, spec, one_site, two_site, chi, dev):
    """The port's unsharded ``make_layer_fn`` on the same spec and Trotter
    order as the sharded layer, with the bench's layer settings."""
    bc = tt.BatchedCircuit(ordered_circuit(spec, one_site, two_site), g,
                           spec=spec)
    def edges(buckets):
        return sorted((b.slot_u, b.slot_v, iu, iv) for b in buckets
                      for iu, iv in zip(b.u_idx, b.v_idx))

    groups = [edges(grp) for grp in spec.color_groups]
    segs = [edges(s.buckets) for s in bc.segments if hasattr(s, "buckets")]
    assert segs == groups, "circuit segments differ from the colour groups"
    return tt.make_layer_fn(bc, chi=chi, cutoff=1e-10, normalize_tensors=True,
                            bp_maxiter=25, device=dev)


def sharded_layer_fn(tt, make, sspec, mesh, one_site, two_site, chi):
    gate2, gate1 = layer_gates(tt, one_site, two_site)
    return make(sspec, mesh, gate2, gate1, chi, cutoff=1e-10,
                normalize_tensors=True, bp_maxiter=25)


def sharded_vs_unsharded(tt, dev, counters, targets, cl, cb, name, g, sspec,
                         mesh, make, one_site, two_site, chi, required, env):
    """Run ``SHARDED_LAYERS[name]`` sharded layers under ``env`` (counted,
    and recording what they hand each kernel) and as many unsharded ones
    with the kernels off, from the same product state; returns (launches,
    recorded kernel inputs, sharded state, max site |dZ|, ppermute calls /
    bytes of the last layer, all_gather calls over the layers)."""
    tp = tt.parallel
    spec = sspec.spec
    n = SHARDED_LAYERS[name]
    z = tt.op_matrix("Z", 2)
    with knobs(env):
        _, psi0 = tt.batched_product_state(g, chi=chi, dtype=torch.complex64,
                                           spec=spec, device=dev)
        layer = sharded_layer_fn(tt, make, sspec, mesh, one_site, two_site,
                                 chi)

        def run():
            st = mesh.shard(psi0)
            mesh.traffic.reset()
            gathers = 0
            for _ in range(n):
                snap = dict(mesh.traffic.calls), dict(mesh.traffic.bytes)
                st, errs = layer(st)
                gathers += mesh.traffic.calls["all_gather"] - snap[0].get(
                    "all_gather", 0)
            calls, moved = mesh.traffic.calls, mesh.traffic.bytes
            last = (calls["ppermute"] - snap[0].get("ppermute", 0),
                    moved["ppermute"] - snap[1].get("ppermute", 0))
            torch.cuda.synchronize()
            assert all(torch.isfinite(e).all() for e in errs)
            return st, last, gathers

        with recording(targets) as seen:
            launches, (st, last, gathers) = counted(counters, name, required,
                                                    run)
        z_sh = tp.local_expectations(spec, mesh.gather(st), z).real
    with knobs(KERNELS_OFF):
        ref_fn = unsharded_layer(tt, g, spec, one_site, two_site, chi, dev)
        ref = psi0
        for _ in range(n):
            ref, _ = ref_fn(ref)
        z_un = tp.local_expectations(spec, ref, z).real
    assert torch.isfinite(z_sh).all() and torch.isfinite(z_un).all()
    dz = float((z_sh - z_un).abs().max())
    return launches, seen, st, dz, last, gathers


def layer_ms(fn, state, reps=2):
    """ms per layer between CUDA events after one warm-up layer (host
    dispatch and the BP stop tests' syncs included)."""
    state, _ = fn(state)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        state, _ = fn(state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def effective_bond(state) -> int:
    """The largest bond index any tensor uses: the χ buffer beyond it holds
    exact zeros after a truncation that kept a prefix of each spectrum."""
    t = state.tensors
    r = 1
    for k in range(1, t.ndim - 1):
        norms = torch.linalg.vector_norm(
            torch.movedim(t, k, 0).reshape(t.shape[k], -1), dim=1)
        r = max(r, int(torch.nonzero(norms).max()) + 1)
    return r


def compacted(tp, state, r):
    """The state with its χ buffer cut to ``r`` (exact where the buffer
    beyond r is zero; checked by the caller)."""
    D = state.tensors.ndim - 2
    t = state.tensors[(slice(None),) + (slice(0, r),) * D]
    return tp.BatchedState(t.contiguous(),
                           state.messages[..., :r, :r].contiguous())


class ShardDraws:
    """Replays recorded draws [n, calls] to a sharded sampler: each
    shard's generator gets its own block of samples, one column per
    call."""

    def __init__(self, drawn, gens):
        n = drawn.shape[0] // len(gens)
        self.blocks = {id(g): drawn[s * n:(s + 1) * n]
                       for s, g in enumerate(gens)}
        self.calls = {id(g): 0 for g in gens}

    def __call__(self, probs, generator=None):
        k = id(generator)
        out = self.blocks[k][:, self.calls[k]].to(probs.device)
        self.calls[k] += 1
        return out


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` set to ``value`` inside (a class attribute it only
    inherits is removed again after)."""
    own = name in vars(module)
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        if own:
            setattr(module, name, old)
        else:
            delattr(module, name)


def sharded_phase(tt, dev, counters, targets, cl, cb, card, noisy):
    """(a) chi32 in 5 strips, (b) 6x6 χ=32 in (2, 2) blocks, (c) heavy-hex
    χ=16 in 4 strips with K3, each against the unsharded layer; (d) the
    sharded measurements on (a)'s state against their single-device
    counterparts.  Every shard lives on ``dev``.  Returns the launches per
    counted path."""
    tp = tt.parallel
    from tensornetworkquantumsimulator_torch.parallel import (
        certified_sampling as cert_mod,
    )
    from tensornetworkquantumsimulator_torch.parallel import (
        sampling as smp_mod,
    )
    from tensornetworkquantumsimulator_torch.utils import checkpoint

    paths = {}
    dt, hx, hz, J = (TFIM[k] for k in ("dt", "hx", "hz", "J"))
    tfim_one = [("Rx", 2 * hx * dt), ("Rz", 2 * hz * dt)]
    tfim_two = ("Rzz", 2 * J * dt)

    # (a) full width: the chi32 configuration, one row a strip, 5 shards
    g = tt.named_grid((5, 5))
    sspec = tp.shard_spec(g, 5)
    spec = sspec.spec
    mesh = tp.ShardMesh(5, devices=[dev] * 5)
    paths["sharded_chi32"], seen, st_a, dz, (pp_calls, pp_bytes), gathers = (
        sharded_vs_unsharded(tt, dev, counters, targets, cl, cb,
                             "sharded_chi32", g, sspec, mesh,
                             tp.make_sharded_layer, tfim_one, tfim_two,
                             SHARD_CHI, ("K1", "K2"), FAST_STACK))
    with knobs(FAST_STACK):
        mesh1 = tp.ShardMesh(1, devices=[dev])
        sspec1 = tp.shard_spec(g, 1)
        assert sspec1.spec.vertices == spec.vertices
        _, psi0 = tt.batched_product_state(g, chi=SHARD_CHI,
                                           dtype=torch.complex64, spec=spec,
                                           device=dev)
        ms_un = layer_ms(unsharded_layer(tt, g, spec, tfim_one, tfim_two,
                                         SHARD_CHI,
                                         dev), psi0)
        ms_1 = layer_ms(sharded_layer_fn(tt, tp.make_sharded_layer, sspec1,
                                         mesh1, tfim_one, tfim_two, SHARD_CHI),
                        mesh1.shard(psi0))
        ms_5 = layer_ms(sharded_layer_fn(tt, tp.make_sharded_layer, sspec,
                                         mesh, tfim_one, tfim_two, SHARD_CHI),
                        mesh.shard(psi0))
    log("sharded", f"(a) chi32 5x5 TFIM χ={SHARD_CHI} c64, 5 strips on "
                   f"{dev}, "
                   f"{SHARDED_LAYERS['sharded_chi32']} layers: launches "
                   f"{paths['sharded_chi32']}; max site |dZ| vs unsharded "
                   f"make_layer_fn, kernels off, {dz:.2e} (bar "
                   f"{SHARD_BAND}); per layer {pp_calls} ppermute calls, "
                   f"{pp_bytes} bytes; all_gather calls over the layers "
                   f"{gathers}")
    log("sharded", f"{card}: (a) ms per layer (CUDA events, 2 layers after "
                   f"one warm-up): unsharded {ms_un:.1f}, S=1 {ms_1:.1f}, "
                   f"S=5 {ms_5:.1f} (all 5 shards timeshare one card)")
    check_recorded("sharded_chi32", seen, cl, cb)
    del seen
    assert dz <= SHARD_BAND, f"sharded (a): |dZ| {dz:.3e} > {SHARD_BAND}"
    assert gathers == 0, f"sharded (a): {gathers} all_gather calls in layers"

    # (b) blocks: 6x6 χ=32 in (2, 2) blocks
    g6 = tt.named_grid((6, 6))
    sspec2 = tp.shard2d_spec(g6, 2, 2)
    mesh2 = tp.ShardMesh((2, 2), ("x", "y"), devices=[dev] * 4)
    paths["sharded_2d"], seen2, _, dz2, (pp2, pb2), gathers2 = (
        sharded_vs_unsharded(tt, dev, counters, targets, cl, cb,
                             "sharded_2d", g6, sspec2, mesh2,
                             tp.make_sharded_layer_2d, tfim_one, tfim_two,
                             SHARD_CHI, ("K1", "K2"), FAST_STACK))
    log("sharded", f"(b) 6x6 TFIM χ={SHARD_CHI} c64 in (2, 2) blocks, "
                   f"{SHARDED_LAYERS['sharded_2d']} layers: launches "
                   f"{paths['sharded_2d']}; max site |dZ| vs unsharded, kernels "
                   f"off, "
                   f"{dz2:.2e} (bar {SHARD_BAND}); last layer {pp2} ppermute "
                   f"calls, {pb2} bytes; all_gather calls {gathers2}")
    check_recorded("sharded_2d", seen2, cl, cb)
    del seen2
    assert dz2 <= SHARD_BAND and gathers2 == 0, f"sharded (b): |dZ| {dz2:.3e}"

    # (c) degree 3 with K3 on: heavy-hex (3, 3), V = 68, in 4 strips, χ=16
    gh = tt.heavy_hexagonal_lattice(3, 3)
    sspec3 = tp.shard_spec(gh, 4)
    mesh3 = tp.ShardMesh(4, devices=[dev] * 4)
    k3_env = dict(FAST_STACK, TNQS_BP_KERNEL="1")
    paths["sharded_heavyhex"], seen3, _, dz3, (pp3, pb3), gathers3 = (
        sharded_vs_unsharded(tt, dev, counters, targets, cl, cb,
                             "sharded_heavyhex", gh, sspec3, mesh3,
                             tp.make_sharded_layer,
                             [("Rx", 0.4)], ("Rzz", 2 * (3.14159 / 4)),
                             SHARD_HEX_CHI,
                             ("K3",), k3_env))
    log("sharded", f"(c) heavy-hex (3, 3) V={sspec3.spec.num_vertices} "
                   f"kicked Ising χ={SHARD_HEX_CHI} c64 in 4 strips, "
                   f"TNQS_BP_KERNEL=1, "
                   f"{SHARDED_LAYERS['sharded_heavyhex']} layers: launches "
                   f"{paths['sharded_heavyhex']}; max site |dZ| vs unsharded, "
                   f"kernels off, "
                   f"{dz3:.2e} (bar {SHARD_BAND}); last layer {pp3} ppermute "
                   f"calls, {pb3} bytes; all_gather calls {gathers3}")
    check_recorded("sharded_heavyhex", seen3, cl, cb)
    del seen3
    assert dz3 <= SHARD_BAND and gathers3 == 0, f"sharded (c): |dZ| {dz3:.3e}"

    # (d) measurement on (a)'s state, package defaults, each against its
    # single-device counterpart on the same (gathered) state
    t0 = time.perf_counter()
    z, x = tt.op_matrix("Z", 2), tt.op_matrix("X", 2)
    st = tp.make_sharded_bp_update(sspec, mesh, maxiter=100,
                                   tolerance=1e-5)(st_a)
    one = mesh.gather(st)
    read = {}
    read["site <Z>"] = (tp.make_sharded_site_expectations(sspec, mesh, z)(st),
                        tp.local_expectations(spec, one, z))
    read["bond <ZZ>"] = (tp.make_sharded_bond_expectations(sspec, mesh, z, z)(
        st), tp.bond_expectations(spec, one, z, z))
    st_g, spectra = tp.make_sharded_gauge(sspec, mesh)(st)
    one_g, spectra1 = tp.batched_symmetric_gauge(spec, one)
    read["gauge spectra"] = (spectra, spectra1)
    read["gauge <Z>"] = (tp.make_sharded_site_expectations(sspec, mesh, z)(
        st_g), tp.local_expectations(spec, one_g, z))
    st_t, terrs = tp.make_sharded_truncate(sspec, mesh, SHARD_CHI,
                                           cutoff=SHARD_TRUNC_CUTOFF)(st)
    one_t, terrs1 = tp.batched_truncate(spec, one, SHARD_CHI,
                                        cutoff=SHARD_TRUNC_CUTOFF)
    e_sh = torch.sort(torch.cat(terrs))[0][-len(terrs1):]
    read["truncate errors"] = (e_sh, torch.sort(terrs1)[0])
    read["truncate <Z>"] = (tp.make_sharded_site_expectations(sspec, mesh, z)(
        st_t), tp.local_expectations(spec, one_t, z))
    _, psi0 = tt.batched_product_state(g, chi=SHARD_CHI, dtype=torch.complex64,
                                       spec=spec, device=dev)
    inner = tp.make_sharded_inner(sspec, mesh)
    s0 = mesh.shard(psi0)
    l01, p01 = inner(st, s0)
    l00, _ = inner(s0, s0)
    ltt, _ = inner(st, st)
    echo_sh = torch.stack([l01 - 0.5 * l00 - 0.5 * ltt, p01])
    echo_1 = torch.stack(list(tp.batched_loschmidt_echo(spec, psi0, one)))
    read["echo (log|.|, phase)"] = (echo_sh, echo_1)
    pairs = [((1, 1), (5, 5)), ((3, 1), (3, 5)), ((2, 2), (4, 3)),
             ((1, 5), (5, 1))]
    read["path <Z Z>"] = (
        tp.make_sharded_path_correlations(sspec, mesh, pairs, z, z)(st),
        tp.make_path_correlation_fn(spec, pairs, z, z)(one))
    bars = {k: SHARD_MEASURE_BAND for k in read}

    # BMPS and the certified sampler on the truncated state, its χ buffer
    # cut to the bond dimension it uses (the rest is exact zeros)
    r = effective_bond(one_t)
    small = compacted(tp, one_t, r)
    pad = small.tensors.new_zeros(one_t.tensors.shape)
    pad[(slice(None),) + (slice(0, r),) * 4] = small.tensors
    assert torch.equal(pad, one_t.tensors), "the χ buffer beyond r is not 0"
    rmesh = tp.ShardMesh(5, ("r",), devices=[dev] * 5)
    small_sh = mesh.shard(small)
    bn, be = tp.make_sharded_grid_bmps(spec, 5, 5, rmesh,
                                       kmps=SHARD_BMPS_RANK, niters=8)
    un, ue = tp.make_grid_bmps(spec, 5, 5, kmps=SHARD_BMPS_RANK, niters=8)
    read["grid BMPS <Z>"] = (be(small_sh, z), ue(small.tensors, z))
    read["grid BMPS log|Z|"] = (bn(small_sh)[0], un(small.tensors)[0])
    bars["grid BMPS <Z>"] = bars["grid BMPS log|Z|"] = SHARD_BMPS_BAND

    # loop corrections at size 4 on (a)'s state
    zlc = tp.make_sharded_loopcorrections(sspec, mesh, g,
                                          max_configuration_size=4)(st)
    zlc1 = tp.loopcorrected_partitionfunction(spec, one, g,
                                              max_configuration_size=4)
    read["loop Z / Z (relative)"] = (zlc / zlc1 - 1,
                                     torch.zeros((), device=dev))
    obs = [("Z", [(3, 3)]), ("Z", [(1, 1)]), ("ZZ", [(2, 2), (2, 3)])]
    read["loop-corrected <O>"] = (
        tp.make_sharded_loopcorrected_expectations(sspec, mesh, g, obs, 4)(st),
        tp.make_loopcorrected_expectations(spec, g, obs,
                                           max_configuration_size=4)(one))
    bars["loop Z / Z (relative)"] = bars["loop-corrected <O>"] = \
        SHARD_LOOP_BAND

    # the samplers split over the sample axis, draws forced to the
    # single-device sampler's
    smesh = tp.ShardMesh(5, ("s",), devices=[dev] * 5)
    gens = [torch.Generator(device=dev).manual_seed(s) for s in range(5)]
    cert = tp.make_grid_certified_sampler(spec, 5, 5, norm_rank=CERT_RANK,
                                          projected_rank=CERT_RANK)
    gen = torch.Generator(device=dev).manual_seed(7)
    with draws(cert_mod) as drawn:
        cbits, clogq, clpq = cert(small.tensors, SHARD_SAMPLES, gen)
    with patched(cert_mod, "_draw", ShardDraws(torch.stack(drawn, 1), gens)):
        sbits, slogq, slpq = tp.make_sharded_sampler(cert, smesh)(
            small.tensors, SHARD_SAMPLES, gens)
    same_cert = torch.equal(sbits, cbits)
    read["certified logq"] = (slogq, clogq)
    read["certified log p/q"] = (slpq, clpq)
    nspec, nstate = noisy
    rho = tp.make_rho_sampler(nspec, nstate.chi, nstate.tensors.dtype)
    with draws(smp_mod) as rdrawn:
        rbits, rlogp = rho(nstate, SHARD_SAMPLES, gen)
    with patched(smp_mod, "_draw", ShardDraws(torch.stack(rdrawn, 1), gens)):
        sr_bits, sr_logp = tp.make_sharded_rho_sampler(rho, smesh)(
            nstate, SHARD_SAMPLES, gens)
    same_rho = torch.equal(sr_bits, rbits)
    read["rho sampler logps"] = (sr_logp, rlogp)
    for k in ("certified logq", "certified log p/q", "rho sampler logps"):
        bars[k] = SHARD_LOGQ_BAND

    # a sharded checkpoint round trip, bit for bit
    ckpt = REPO / "build" / f"sharded_ckpt_{os.getpid()}"
    checkpoint.save_sharded_state(str(ckpt), st, mesh)
    back = checkpoint.load_sharded_state(str(ckpt), mesh)
    same_ckpt = all(torch.equal(a.tensors, b.tensors)
                    and torch.equal(a.messages, b.messages)
                    for a, b in zip(back.shards, st.shards))
    import shutil

    shutil.rmtree(ckpt)
    torch.cuda.synchronize()

    errs = {k: float((a - b.to(a.device)).abs().max()) for k, (a, b) in
            read.items()}
    for k, e in errs.items():
        log("sharded", f"(d) {k}: sharded vs single-device max |diff| "
                       f"{e:.2e} (bar {bars[k]:g})")
    log("sharded", f"(d) truncated state's bond dimension {r} of "
                   f"{SHARD_CHI} (the "
                   f"BMPS at rank {SHARD_BMPS_RANK} and the certified sampler "
                   f"run on it); samplers: {SHARD_SAMPLES} samples over 5 "
                   f"shards, bitstrings equal: certified {same_cert}, rho "
                   f"{same_rho}; checkpoint round trip bit for bit: "
                   f"{same_ckpt}; traffic {mesh.traffic}; phase (d) took "
                   f"{time.perf_counter() - t0:.1f} s")
    for k, e in errs.items():
        assert e <= bars[k], f"sharded (d) {k}: {e:.3e} > {bars[k]}"
    assert same_cert and same_rho and same_ckpt
    return paths


# layers each counted main path runs (the ensemble's of 8 members; the
# measure path is one call of ``batched_truncate``)
LAYERS = {"chi10": 5, "chi64": 2, "rolled": 10, "ensemble": ENSEMBLE_LAYERS,
          "noisy": NOISY_LAYERS, "measure": 1, "generic": GENERIC_LAYERS,
          "generic_bmps": GBMPS_LAYERS,
          "examples_fast_stack": GBMPS_LAYERS * len(FAST_STACK_RUNS)}
TIMES_KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
              "unit", "fp32_bound_ms", "flops", "bytes", "library_ms",
              "library_device_ms", "host_us", "library_host_us",
              "peak_extra_mib", "sweeps")


def ising_2d_sites(tt, batched):
    """Every site's ⟨Z⟩ of ising_2d_dynamics' final batched (spec, state)."""
    spec, state = batched
    return tt.local_expectations(spec, state, tt.op_matrix(
        "Z", 2)).real.cpu().numpy()


def fast_stack_moves(chi) -> int:
    """``python3 chip_smoke.py --fast-stack CHI``: ising_2d_dynamics at its
    defaults but χ=CHI on the card, under the default knobs and then under
    FAST_STACK, KERNELS_OFF (its gram split and CholeskyQR2 with the
    library eigh) and SVD_STACK (K1 with the library SVD split); prints one
    JSON line of each stack's max site |Δ⟨Z⟩| from the default knobs', and
    the K1 and K2 launches under FAST_STACK.  Run it once per
    PYTHONHASHSEED to see the edge colouring's spread."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import tensornetworkquantumsimulator_torch as tt
    from tensornetworkquantumsimulator_torch.parallel import cuda_linalg as cl

    dev = torch.device("cuda")
    z0 = ising_2d_sites(tt, ising_2d_example(dev, chi=chi)[4])
    out = {"card": card_line(), "chi": chi,
           "PYTHONHASHSEED": os.environ.get("PYTHONHASHSEED")}
    for name, env in (("FAST_STACK", FAST_STACK), ("KERNELS_OFF", KERNELS_OFF),
                      ("SVD_STACK", SVD_STACK)):
        cl.roots_launches.reset()
        cl.eigh_launches.reset()
        with knobs(env):
            z = ising_2d_sites(tt, ising_2d_example(dev, chi=chi)[4])
        out[name] = float(np.abs(z - z0).max())
        out[name + "_K1_K2"] = [cl.roots_launches.count,
                                cl.eigh_launches.count]
    print(json.dumps(out), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them (empty
    if it prints nothing)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return smi[0] if smi else ""


def time_bmps(root) -> int:
    """``python3 chip_smoke.py --time-bmps ROOT``: the boundary-MPS calls of
    ``[measure]`` timed with the port's package imported from the tree at
    ROOT, so that two trees compare in one call on one card (run it on
    each, alternating).  On the 5x5 χ=10 complex64 state (the chi10 path's
    layers with the kernels off): the all-site ⟨Z⟩ at rank 16 and log|Z|,
    the certified sampler's MEASURE_SAMPLES samples (ranks 8), and the
    planar ⟨Z⟩ on the Eagle-127 χ=8 state; milliseconds per call between
    CUDA events after one warm-up (``call_ms``), the mean of 10 calls (2
    of the sampler, 5 of the planar ⟨Z⟩).  Prints one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import tensornetworkquantumsimulator_torch as tt

    assert Path(tt.__file__).resolve().is_relative_to(root), tt.__file__
    dev = torch.device("cuda")
    tp, z_op = tt.parallel, tt.op_matrix("Z", 2)
    spec, _, state, _ = evolved(tt, dev, "chi10", LAYERS["chi10"],
                                KERNELS_OFF)
    norm, expect = tp.make_grid_bmps(spec, 5, 5, kmps=BMPS_RANK,
                                     niters=BMPS_SWEEPS)
    cert = tp.make_grid_certified_sampler(spec, 5, 5, norm_rank=CERT_RANK,
                                          projected_rank=CERT_RANK)
    gen = torch.Generator(device=dev).manual_seed(2024)
    hspec, _, hstate, _ = evolved(tt, dev, "heavyhex", 2, KERNELS_OFF)
    _, planar = tp.make_planar_bmps(hspec, kmps=BMPS_RANK)
    out = {"root": str(root), "card": card_line(),
           "bmps_z_ms": call_ms(lambda: expect(state.tensors, z_op), 10),
           "bmps_log_z_ms": call_ms(lambda: norm(state.tensors), 10),
           "cert_ms": call_ms(lambda: cert(state.tensors, MEASURE_SAMPLES,
                                           gen), 2),
           "cert_samples": MEASURE_SAMPLES,
           "planar_z_ms": call_ms(lambda: planar(hstate.tensors, z_op), 5)}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import tensornetworkquantumsimulator_torch as tt
    from tensornetworkquantumsimulator_torch.parallel import cuda_bp as cb
    from tensornetworkquantumsimulator_torch.parallel import cuda_build
    from tensornetworkquantumsimulator_torch.parallel import cuda_linalg as cl
    from tensornetworkquantumsimulator_torch.parallel import cuda_matmul as cm
    from tensornetworkquantumsimulator_torch.parallel import engine

    t_phase = time.perf_counter()

    def done(phase):
        nonlocal t_phase
        now = time.perf_counter()
        log(phase, f"phase seconds {now - t_phase:.1f}")
        t_phase = now

    # 1. device, the entry points' default device, colour groups and build
    g = tt.named_grid((2, 2))
    _, st = tt.batched_product_state(g, chi=2)
    layer = tt.make_layer_fn(tt.BatchedCircuit(
        [("Rx", [v], 0.1) for v in g.vertices()], g), chi=2)
    assert st.tensors.is_cuda and layer.mask.is_cuda, (
        st.tensors.device, layer.mask.device)
    log("device", f"built with no device= argument: state on "
                  f"{st.tensors.device}, layer module on {layer.mask.device}")
    dev = tt.select_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = card_line()
    print(smi or "nvidia-smi: no output", flush=True)
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    log("device", f"{kind}; torch {torch.__version__} (CUDA "
                  f"{torch.version.cuda}); {nvcc.stdout.strip().splitlines()[-1]}")
    colour_groups(tt)
    cuda_build.library()
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("ptxas", line.strip())
    log("build", f"kernels built in {cuda_build.build_seconds or 0.0:.1f} s "
                 f"(0 = reused an existing build)")
    done("device")

    # 2. kernels against their plain versions; the comparisons at the
    # main path's shapes are kept for the times phase, which times them
    rng = np.random.default_rng(2024)
    shaped = {"K1": check_k1(dev, rng, cl), "K2": check_k2(dev, rng, cl),
              "K3": check_k3(dev, rng, cb), "K4": check_k4(dev, rng, cm)}
    torch.cuda.synchronize()
    done("kernels")

    # 3-4. the main path, counted; then each kernel against its plain
    # version on the inputs the main path gave it (launches not counted)
    counters = {"K1": cl.roots_launches, "K2": cl.eigh_launches,
                "K3": cb.bp_launches, "K4": cm.matmul_launches}
    targets = {"K1": (engine, "jacobi_pseudo_roots"),
               "K2": (engine, "jacobi_eigh"),
               "K3": (cb, "bp_outgoing_d3")}
    paths = {}
    for name, n, env, required in (
            ("chi10", LAYERS["chi10"], FAST_STACK, ("K1", "K2")),
            ("chi64", LAYERS["chi64"], dict(FAST_STACK, TNQS_BP_KERNEL="1"),
             ("K2", "K3"))):
        paths[name], seen, _ = main_path(
            counters, name,
            lambda env, name=name, n=n: run_layers(tt, dev, name, n, env),
            env, required, targets)
        check_recorded(name, seen, cl, cb)
        if name == "chi64":
            # the Gram split's n=256 batches took the kernel; the latest
            # one is kept for the times phase (kernel beside the library)
            gram_shapes = [sh for sh in seen["K2"] if sh[-1] == 256]
            assert gram_shapes and all(
                cl.eigh_kernel_supported(sh[-1], sh[0]) for sh in gram_shapes
            ), f"chi64: no n=256 batch reached K2: {sorted(seen['K2'])}"
            (h,) = seen["K2"][max(gram_shapes)][-1]
            entry = assert_eigh(
                cl, h, 2e-4, "x".join(map(str, h.shape)) + " recorded on chi64")
            entry["library"] = cl.eigh_plain  # what the port called before
            shaped["K2"].append(entry)
            log(name, f"K2 took the gram split's batches {gram_shapes}; the "
                      f"largest, recorded: {entry['log']}")
        del seen
        done(name)

    # 5. absolute physics
    physics_check(tt, dev)
    done("physics")

    # 6-7. the rolled headline and the bond observables on its state
    rolled = {}

    def run_rolled_z(env):
        rolled[env["TNQS_EIGH_ALG"]] = run_rolled(tt, dev, LAYERS["rolled"],
                                                  env)
        return rolled[env["TNQS_EIGH_ALG"]][2]

    paths["rolled"], seen, _ = main_path(counters, "rolled", run_rolled_z,
                                         FAST_STACK, ("K1", "K2"), targets)
    check_recorded("rolled", seen, cl, cb)
    del seen
    done("rolled")
    spec, state, _ = rolled["jacobi"]
    bonds_check(tt, spec, state)
    del rolled, state
    done("bonds")

    # 8-10. the ensemble, the noisy layer and the microbenchmark
    with knobs(FAST_STACK):
        paths["ensemble"], t_ens, t_single = ensemble_check(
            tt, dev, engine, counters, ("K1", "K2"))
    done("ensemble")
    paths["noisy"], noisy_spec, noisy_state = noisy_layers(tt, dev, counters)
    done("noisy")
    paths["qr"] = qr_phase(tt, dev, engine, cl, counters)
    done("qr")
    paths["microbench"] = microbench_phase(counters)
    done("microbench")

    # 11. the measurement half
    card = smi or kind
    paths["measure"], profiled, grid = measure_grid(
        tt, dev, engine, counters, targets, cl, cb, card)
    eagle = measure_eagle(tt, dev, card)
    measure_noisy(tt, dev, noisy_spec, noisy_state, card)
    done("measure")

    # 12-13. loop corrections on the measured states, the variational path
    paths["loops"], more = loops_phase(tt, dev, counters, grid, eagle, card)
    profiled.update(more)
    del grid, eagle
    done("loops")
    more_paths, more = variational_phase(tt, dev, counters, card)
    paths.update(more_paths)
    profiled.update(more)
    done("variational")

    # 14. the generic named-index engine
    paths["generic"], generic_profiled = generic_phase(tt, dev, engine,
                                                       counters, card)
    done("generic")
    paths["generic_bmps"], bmps_profiled, z_default = generic_bmps_phase(
        tt, dev, counters, card)
    done("generic_bmps")

    # the examples no earlier phase runs, and ising_2d_dynamics on the fast
    # stack against (a)'s default-knob run
    paths.update(examples_phase(tt, dev, engine, counters, card, z_default))
    done("examples")

    # 17. the multi-device engine, every shard on this card
    paths.update(sharded_phase(tt, dev, counters, targets, cl, cb, card,
                               (noisy_spec, noisy_state)))
    del noisy_state
    done("sharded")
    launches = {k: sum(p[k] for p in paths.values()) for k in counters}

    # 18. times
    for name, n, on in (("chi10", 20, FAST_STACK),
                        ("chi64", 2, dict(FAST_STACK, TNQS_BP_KERNEL="1")),
                        ("chi10_rolled", 20, FAST_STACK)):
        rate_on = layers_per_second(tt, dev, name, n, on)
        rate_off = layers_per_second(tt, dev, name, n, KERNELS_OFF)
        rate_on2 = layers_per_second(tt, dev, name, n, on)
        log("times", f"{name}: {rate_on:.2f} / {rate_on2:.2f} layers/s kernels "
                     f"on, {rate_off:.2f} layers/s kernels off ({n} layers "
                     f"after one warm-up)")
    log("times", f"ensemble of {ENSEMBLE} rolled members: {t_ens * 1e3:.1f} "
                 f"ms per ensemble layer vs {t_single * 1e3:.1f} ms per "
                 f"single-member layer (host clock, distance recording on)")
    # chi64 with K3 against the same stack without it, in turns
    k3_on = dict(FAST_STACK, TNQS_BP_KERNEL="1")
    ab = [layers_per_second(tt, dev, "chi64", 2, env)
          for env in (FAST_STACK, k3_on, k3_on, FAST_STACK)]
    log("times", f"chi64 K3 off / on / on / off: "
                 f"{' / '.join(f'{r:.3f}' for r in ab)} layers/s (2 layers "
                 f"after one warm-up, fast stack otherwise)")
    plain = {"K1": cl.pseudo_roots_plain, "K2": cl.eigh_plain,
             "K3": cb.bp_outgoing_plain, "K4": cm.complex_matmul_plain}
    wrapper = {"K1": cl.jacobi_pseudo_roots, "K2": cl.jacobi_eigh,
               "K3": cb.bp_outgoing_d3, "K4": cm.complex_matmul}
    # the one PyTorch call that computes the same function, where there is
    # one (K2: complex64 on full-rank batches only, where cuSOLVER converges;
    # on the recorded n=256 batch the complex128 call the port made before)
    library = {"K2": torch.linalg.eigh, "K4": torch.matmul}
    reps = {"K1": 50, "K2": 20, "K3": 5, "K4": 500}
    for k, entries in shaped.items():
        for e in entries:
            args = e["args"]
            big = k == "K2" and args[0].shape[-1] > cl.ONE_CTA_MAX_N
            n_reps = 3 if big else reps[k]
            e.update(bound(k, args))
            call = lambda: wrapper[k](*args)  # noqa: E731
            e["ms"] = time_ms(call, n_reps)
            e["device_ms"], how = device_ms(call, n_reps)
            e["plain_ms"] = time_ms(lambda: plain[k](*args), n_reps)
            e["library_ms"] = e["library_device_ms"] = None
            lib = "none"
            full_rank = k != "K2" or e["shape"].endswith(
                f"rank {args[0].shape[-1]}")
            lib_fn = e.get("library", library.get(k) if full_rank else None)
            if lib_fn is not None:
                lib_call = lambda: lib_fn(*args)  # noqa: E731
                try:  # the library calls alone: cuSOLVER may not converge
                    e["library_ms"] = time_ms(lib_call, n_reps)
                    if k == "K2":
                        # the call synchronizes, so no graph can hold it:
                        # events around three calls, which each wait for the
                        # device, are its device time and its host gaps
                        e["library_device_ms"] = time_ms(lib_call, 3, 1)
                        lib_how = "events around 3 synchronizing calls"
                    else:
                        e["library_device_ms"], lib_how = device_ms(
                            lib_call, n_reps)
                        e["library_host_us"] = enqueue_us(lib_call, n_reps)
                    lib = (f"{e['library_ms']:.4f} ms call, "
                           f"{fmt_ms(e['library_device_ms'])} device "
                           f"({lib_how})")
                except RuntimeError as err:
                    lib = f"failed ({str(err).splitlines()[0][:60]})"
            if k == "K4":
                e["host_us"] = enqueue_us(call, n_reps)
                lib += (f"; host path per call {e['host_us']:.1f} us (a @ b "
                        f"{e.get('library_host_us', float('nan')):.1f} us)")
            extra = ""
            if k in ("K1", "K2"):
                sweeps = torch.zeros(args[0].shape[0], dtype=torch.int32,
                                     device=dev)
                wrapper[k](*args, sweeps=sweeps)
                sw = np.sort(sweeps.cpu().numpy())
                e["sweeps"] = [int(sw[0]), int(sw[len(sw) // 2]), int(sw[-1])]
                extra = (f"; sweeps per matrix min/median/max "
                         f"{'/'.join(map(str, e['sweeps']))}")
            if k == "K2":
                raw = time_ms(lambda: cl.jacobi_eigh_raw(*args), n_reps)
                extra += f"; kernel without polish {raw:.4f} ms"
            if "library" in e:
                # the gate admits n=256 only while the kernel is no slower
                # than the complex128 library call it replaced there
                assert e["device_ms"] <= e["library_device_ms"], (
                    f"K2 {e['shape']}: kernel {e['device_ms']:.3f} ms, "
                    f"library {e['library_device_ms']:.3f} ms")
            if k == "K3":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                call()
                torch.cuda.synchronize()
                e["peak_extra_mib"] = (torch.cuda.max_memory_allocated()
                                       - base) / 2**20
                V, chi, d = (args[0].shape[i] for i in (0, 1, -1))
                extra = (f"; peak memory above its inputs "
                         f"{e['peak_extra_mib']:.1f} MiB; (chunk, splits) "
                         f"{cb.launch_plan(V, chi, d)}")
            fp32 = (f", {e['fp32_bound_ms']:.3g} ms at fp32 outside the "
                    f"tensor cores" if "fp32_bound_ms" in e else "")
            log("times", f"{k} {e['shape']}: call {e['ms']:.4f} ms, device "
                         f"{fmt_ms(e['device_ms'])} ({how}); plain call "
                         f"{e['plain_ms']:.4f} ms; library {lib}; bound "
                         f"{e['bound_ms']:.3g} ms by {e['bound_by']} "
                         f"({e['flops']:.3g} {e['unit']} flops, "
                         f"{e['bytes']:.3g} B){fp32}{extra}")
    done("times")
    busy_shares(profiled, card)
    busy_shares(generic_profiled, card, "generic")
    busy_shares(bmps_profiled, card, "generic_bmps")
    done("busy")

    meta = {
        "K1": ("jacobi_pseudo_roots",
               "tensornetworkquantumsimulator_torch/csrc/jacobi.cu",
               "tensornetworkquantumsimulator_tpu/parallel/pallas_linalg.py:428"),
        "K2": ("jacobi_eigh",
               "tensornetworkquantumsimulator_torch/csrc/jacobi.cu",
               "tensornetworkquantumsimulator_tpu/parallel/pallas_linalg.py:220"),
        "K3": ("bp_outgoing_d3",
               "tensornetworkquantumsimulator_torch/csrc/bp_outgoing_d3.cu",
               "tensornetworkquantumsimulator_tpu/parallel/pallas_bp.py:166"),
        "K4": ("complex_matmul",
               "tensornetworkquantumsimulator_torch/csrc/complex_matmul.cu",
               "tensornetworkquantumsimulator_tpu/parallel/pallas_kernels.py:38"),
    }
    # max_abs_err: max |kernel - plain| over the gauge-free outputs (K1 root
    # and inverse root, K2 eigenvalues, K3 messages, K4 products) on the
    # main-path-shape batches that were checked and timed; max_rel_err
    # divides each output's error by its own max |plain| first
    what = {"K1": "root and inverse root", "K2": "eigenvalues",
            "K3": "outgoing messages", "K4": "C = A @ B"}
    kernels = []
    for k, (name, source, replaces) in meta.items():
        entries = shaped[k]
        first = entries[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[k],
            "paths": {p: counts[k] for p, counts in paths.items()},
            "per_layer": {p: paths[p][k] / n for p, n in
                          (LAYERS | SHARDED_LAYERS).items()},
            "max_abs_err": max(e["abs"] for e in entries),
            "max_rel_err": max(e["rel"] for e in entries),
            "compared": what[k],
            **({"max_rel_err_vs_complex128": max(e["ref"] for e in entries)}
               if k == "K4" else {}),
            "shape": first["shape"],
            **{key: first.get(key) for key in TIMES_KEYS},
            "times": [{key: e[key] for key in ("shape",) + TIMES_KEYS
                       if key in e} | {"max_abs_err": e["abs"]}
                      for e in entries],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time-bmps"]:
        sys.exit(time_bmps(sys.argv[2]))
    if sys.argv[1:2] == ["--fast-stack"]:
        sys.exit(fast_stack_moves(int(sys.argv[2])))
    sys.exit(main())
