#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``tensornetworkquantumsimulator_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

Phases, each printing its checks and seconds:

1. device: the card's name and power limit (``nvidia-smi``), the ``nvcc``
   version; then the CUDA kernels are built from ``csrc/``;
2. each kernel against its plain PyTorch version on the card, inputs made
   from a numpy seed, at the main path's shapes among others: K1
   ``jacobi_pseudo_roots`` at [72,10,10], K2 ``jacobi_eigh`` on full-rank
   and rank-deficient PSD batches at [12,40,40] and [200,64,64], K3
   ``bp_outgoing_d3`` at [127,64,64,64,2];
3. main path, ``chi10``: 5x5 TFIM at χ=10, five layers on the fast stack
   (Jacobi eigh, gram split, CholeskyQR2); K1 and K2 must launch, and ⟨Z⟩
   must agree with the same layers on the library eigh to 1e-4.  The
   inputs the layers handed each kernel are recorded, and each kernel is
   then held against its plain version on them;
4. main path, ``chi64``: IBM-Eagle 127-qubit kicked Ising at χ=64, two
   layers, plus ``TNQS_BP_KERNEL=1``; K2 and K3 must launch, ⟨Z⟩ must
   agree with the kernels-off run to 1e-4, and the recorded inputs are
   checked as in phase 3;
5. physics: 3x3 TFIM at χ=8, cutoff 0, complex64, BP ⟨Z⟩ against the
   dense-statevector oracle (``tests/dense_oracle.py``) to 1e-4;
6. times (CUDA events, after warm-up): layers/s of both configurations
   with the kernels on and off, and each kernel against its plain version
   on the main-path-shape batches of phase 2.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; it also exits non-zero when no CUDA
device is visible.
"""

from __future__ import annotations

import contextlib
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
                entries.append(compared(f"{B}x{n}x{n} well-conditioned", (at,),
                                        (root, inv), (proot, pinv)))
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
    """Random hermitian batches at n = 32, 40, 64, 88, then PSD batches at
    the main path's shapes, full rank and rank-deficient: the chi10 gram
    split [12,40,40] and the chi64 environment roots [200,64,64].  Returns
    the main-path-shape comparisons."""
    entries = []
    for n in (32, 40, 64, 88):
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
    for B, n, r in ((12, 40, 40), (12, 40, 10), (200, 64, 64), (200, 64, 16)):
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
    else:
        g, chi = tt.ibm_eagle_lattice(), 64
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


def main_path(tt, dev, counters, name, nlayers, env, required, targets):
    """Run the main path once with every launch counter at 0, recording
    what it hands each kernel; assert the required kernels ran and ⟨Z⟩
    agrees with the kernels-off path.  Returns (launches, recorded)."""
    for c in counters.values():
        c.reset()
    with recording(targets) as seen:
        z_on = run_layers(tt, dev, name, nlayers, env)
    launches = {k: c.count for k, c in counters.items()}
    for k in required:
        assert launches[k] > 0, f"{name}: kernel {k} was never launched"
    z_off = run_layers(tt, dev, name, nlayers, KERNELS_OFF)
    dz = float(np.abs(z_on - z_off).max())
    assert dz <= BAND, f"{name}: max site |dZ| kernels on/off {dz:.3e} > {BAND}"
    log(name, f"{nlayers} layers: launches {launches}; <Z> finite, mean "
              f"{z_on.mean():.6f}; max site |dZ| vs kernels off {dz:.2e} "
              f"(bar {BAND})")
    return launches, seen


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


def layers_per_second(tt, dev, name, nlayers, env) -> float:
    with knobs(env):
        _, state, layer_fn = build_config(tt, dev, name)
        state, _ = layer_fn(state)  # warm-up layer
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(nlayers):
            state, _ = layer_fn(state)
        end.record()
        end.synchronize()
    return nlayers / (start.elapsed_time(end) / 1e3)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import tensornetworkquantumsimulator_torch as tt
    from tensornetworkquantumsimulator_torch.parallel import cuda_bp as cb
    from tensornetworkquantumsimulator_torch.parallel import cuda_build
    from tensornetworkquantumsimulator_torch.parallel import cuda_linalg as cl
    from tensornetworkquantumsimulator_torch.parallel import engine

    t_phase = time.perf_counter()

    def done(phase):
        nonlocal t_phase
        now = time.perf_counter()
        log(phase, f"phase seconds {now - t_phase:.1f}")
        t_phase = now

    # 1. device and build
    dev = tt.select_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    log("device", f"{kind}; torch {torch.__version__} (CUDA "
                  f"{torch.version.cuda}); {nvcc.stdout.strip().splitlines()[-1]}")
    cuda_build.library()
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("ptxas", line.strip())
    log("build", f"kernels built in {cuda_build.build_seconds or 0.0:.1f} s "
                 f"(0 = reused an existing build)")
    done("device")

    # 2. kernels against their plain versions; the comparisons at the
    # main path's shapes are kept for phase 6, which times them
    rng = np.random.default_rng(2024)
    shaped = {"K1": check_k1(dev, rng, cl), "K2": check_k2(dev, rng, cl),
              "K3": check_k3(dev, rng, cb)}
    torch.cuda.synchronize()
    done("kernels")

    # 3-4. the main path, counted; then each kernel against its plain
    # version on the inputs the main path gave it (launches not counted)
    counters = {"K1": cl.roots_launches, "K2": cl.eigh_launches,
                "K3": cb.bp_launches}
    targets = {"K1": (engine, "jacobi_pseudo_roots"),
               "K2": (engine, "jacobi_eigh"),
               "K3": (cb, "bp_outgoing_d3")}
    c10, seen = main_path(tt, dev, counters, "chi10", 5, FAST_STACK,
                          ("K1", "K2"), targets)
    check_recorded("chi10", seen, cl, cb)
    done("chi10")
    c64, seen = main_path(tt, dev, counters, "chi64", 2,
                          dict(FAST_STACK, TNQS_BP_KERNEL="1"), ("K2", "K3"),
                          targets)
    check_recorded("chi64", seen, cl, cb)
    del seen
    done("chi64")
    launches = {k: c10[k] + c64[k] for k in counters}

    # 5. absolute physics
    physics_check(tt, dev)
    done("physics")

    # 6. times
    for name, n, on in (("chi10", 20, FAST_STACK),
                        ("chi64", 2, dict(FAST_STACK, TNQS_BP_KERNEL="1"))):
        rate_on = layers_per_second(tt, dev, name, n, on)
        rate_off = layers_per_second(tt, dev, name, n, KERNELS_OFF)
        rate_on2 = layers_per_second(tt, dev, name, n, on)
        log("times", f"{name}: {rate_on:.2f} / {rate_on2:.2f} layers/s kernels "
                     f"on, {rate_off:.2f} layers/s kernels off ({n} layers "
                     f"after one warm-up)")
    plain = {"K1": cl.pseudo_roots_plain, "K2": cl.eigh_plain,
             "K3": cb.bp_outgoing_plain}
    wrapper = {"K1": cl.jacobi_pseudo_roots, "K2": cl.jacobi_eigh,
               "K3": cb.bp_outgoing_d3}
    reps = {"K1": 50, "K2": 20, "K3": 5}
    for k, entries in shaped.items():
        for e in entries:
            e["ms"] = time_ms(lambda: wrapper[k](*e["args"]), reps[k])
            e["plain_ms"] = time_ms(lambda: plain[k](*e["args"]), reps[k])
            extra = ""
            if k == "K2":
                raw = time_ms(lambda: cl.jacobi_eigh_raw(*e["args"]), reps[k])
                extra = f" (kernel alone {raw:.4f} ms)"
            log("times", f"{k} {e['shape']}: kernel {e['ms']:.4f} ms{extra}, "
                         f"plain {e['plain_ms']:.4f} ms")
    done("times")

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
    }
    # max_abs_err: max |kernel - plain| over the gauge-free outputs (K1 root
    # and inverse root, K2 eigenvalues, K3 messages) on the main-path-shape
    # batches that were checked and timed; max_rel_err divides each
    # output's error by its own max |plain| first
    what = {"K1": "root and inverse root", "K2": "eigenvalues",
            "K3": "outgoing messages"}
    kernels = []
    for k, (name, source, replaces) in meta.items():
        entries = shaped[k]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": max(e["abs"] for e in entries),
            "max_rel_err": max(e["rel"] for e in entries),
            "compared": what[k],
            "ms": entries[0]["ms"], "plain_ms": entries[0]["plain_ms"],
            "shape": entries[0]["shape"],
            "times": [{"shape": e["shape"], "ms": e["ms"],
                       "plain_ms": e["plain_ms"], "max_abs_err": e["abs"]}
                      for e in entries],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
