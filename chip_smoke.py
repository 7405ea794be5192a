#!/usr/bin/env python3
"""Smoke run of the exact kernel -> SVM path on one NVIDIA GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --chips 4    # four cards: the mesh path only

Phases (one process; each prints its own lines):

1. the card (``nvidia-smi``, from a child that stays off JAX), JAX's
   version and ``device_kind``;
2. compile: the fused pairs sweep and the SMO solve at the KAT2B widths,
   with ``compiled.memory_analysis()``;
3. exact DNA on the in-repo KAT2B split (7,020 x 200) at g=13 m=7: the
   host path and the device-resident path, ``fit(C=1)`` and
   ``score("auc")``, the ``fastsk`` CLI on the same files, the kernel
   route against ``pairs_backend="xla"`` on the full matrix, a sampled
   block against ``tests/oracle.py``; then g=16 m=10, kernel against XLA;
4. ragged 20-letter corpus (seeded, N=3,000, lengths 50-800, g=8 m=4):
   the packed engine against ``exact_engine="theta"``, plus the oracle;
5. in-repo EP300 (4,000 x 100): the theta engine at g=10 m=4 against the
   pairs engine, then approx mode at g=10 m=6;
6. a homopolymer in which each k-mer occurs 2,995 times, a count TF32
   cannot hold (the count dots must not run in TF32), against the oracle.

Counts are compared bit for bit. Any failed check ends the run with a
non-zero exit and no result line. The last line of a passing run is
``{"ok": true, "device": {...}}``. It refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(REPO, ".smoke")  # listed in .gitignore


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, read by a child
    process (it never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def write_labeled(path: str, X, Y, reader) -> None:
    """FASTA with ``>label`` headers, the format the CLI reads."""
    inv = {code: ch for ch, code in reader.vocab._token2idx.items()}
    with open(path, "w") as f:
        for seq, y in zip(X, Y):
            f.write(f">{y}\n{''.join(inv[c] for c in seq)}\n")


def ragged_corpus(n: int, lmin: int, lmax: int, alphabet: int, seed: int):
    """Seeded ragged corpus: lengths uniform in [lmin, lmax], codes
    uniform in 1..alphabet."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(lmin, lmax + 1, size=n)
    return [rng.integers(1, alphabet + 1, size=int(L)).tolist() for L in lengths]


def oracle_block(X, K, g: int, m: int, size: int, seed: int) -> bool:
    """Whether ``K`` restricted to a seeded sample of ``size`` sequences
    equals the numpy oracle's counts on those sequences."""
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle

    idx = np.sort(
        np.random.default_rng(seed).choice(len(X), size=size, replace=False)
    )
    want = oracle.exact_counts([X[i] for i in idx], g, m)
    return bool(np.array_equal(np.asarray(K)[np.ix_(idx, idx)], want))


def timed_counts(fn, reps: int):
    """(first-call seconds, steady seconds, result) of a device program
    returning an array; every timing ends in ``block_until_ready``."""
    t0 = time.perf_counter()
    out = fn()
    out.block_until_ready()
    first = time.perf_counter() - t0
    steady = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        steady = min(steady, time.perf_counter() - t0)
    return first, steady, out


def kernel_vs_xla(X, g: int, m: int, reps: int = 3) -> dict:
    """The pairs engine's ``auto`` route against ``pairs_backend="xla"``
    on the full matrix: both walls and bit-equality."""
    import numpy as np

    from fastsk_jax import KernelConfig
    from fastsk_jax.kernel.pairs_engine import PairsGkmEngine
    from fastsk_jax.ops.encode import encode_sequences

    enc = encode_sequences(X)
    auto = PairsGkmEngine(enc, g, m, KernelConfig())
    xla = PairsGkmEngine(enc, g, m, KernelConfig(pairs_backend="xla"))
    walls = {}
    counts = {}
    for name, eng in (("auto", auto), ("xla", xla)):
        first, steady, out = timed_counts(lambda: eng.exact_device().lo, reps)
        walls[name] = (first, steady)
        counts[name] = np.asarray(out)
        log(f"  pairs sweep g={g} m={m} route={eng.backend}: first call "
            f"{first:.3f} s, steady {steady:.4f} s")
    check(np.array_equal(counts["auto"], counts["xla"]),
          f"g={g} m={m}: {auto.backend} route bit-equal to xla "
          f"({counts['auto'].shape[0]}^2 counts)")
    return {"route": auto.backend, "walls": walls, "counts": counts["auto"]}


# ------------------------------------------------------------------ phases


def phase_compile(Xtr, Ytr, Xte, g: int, m: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fastsk_jax import KernelConfig
    from fastsk_jax.kernel.pairs_engine import (
        PairsGkmEngine,
        _pairs_full_device_jit,
    )
    from fastsk_jax.ops.encode import encode_sequences
    from fastsk_jax.svm.kernel_svm import _smo_solve_general

    log("[2] compile")
    eng = PairsGkmEngine(encode_sequences(Xtr + Xte), g, m, KernelConfig())
    if eng.backend == "pallas":
        t0 = time.perf_counter()
        compiled = _pairs_full_device_jit.lower(
            eng._build_x(), g=eng.g, k=eng.k, p_pad=eng.p_pad, sj=eng.sj,
            n=eng.n,
        ).compile()
        log(f"  pairs sweep (fused kernel) compiled in "
            f"{time.perf_counter() - t0:.2f} s: {compiled.memory_analysis()}")
    n = len(Ytr)
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    t0 = time.perf_counter()
    compiled = _smo_solve_general.lower(
        jax.ShapeDtypeStruct((n, n), jnp.float32), f32, f32, f32, f32,
        np.float32(1e-3), 10_000_000,
    ).compile()
    log(f"  SMO solve (n={n}) compiled in {time.perf_counter() - t0:.2f} s: "
        f"{compiled.memory_analysis()}")


def phase_exact_dna(Xtr, Ytr, Xte, Yte, reader, g: int, m: int,
                    auc_min: float, oracle_size: int, reps: int = 3) -> dict:
    """Phase 3 at (g, m): both paths, fit, AUC, CLI, kernel vs XLA,
    oracle block. Returns the counts and SMO figures."""
    import numpy as np

    from fastsk_jax import FastSK, KernelConfig
    from fastsk_jax.cli import main as cli_main
    from fastsk_jax.svm.kernel_svm import KernelSVC

    log(f"[3] exact DNA: {len(Xtr)} + {len(Xte)} sequences, g={g} m={m}")
    X = Xtr + Xte
    sweep = kernel_vs_xla(X, g, m, reps)

    t0 = time.perf_counter()
    host = FastSK(g=g, m=m)
    host.compute_kernel(Xtr, Xte, Ytr, Yte)
    host_counts = host.kernel_counts
    log(f"  host path: kernel {time.perf_counter() - t0:.3f} s")
    check(np.array_equal(host_counts, sweep["counts"]),
          "host path counts equal the sweep's")

    dev = FastSK(g=g, m=m, config=KernelConfig(device_resident=True))
    t0 = time.perf_counter()
    dev.compute_kernel(Xtr, Xte, Ytr, Yte)
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev.fit(C=1.0)
    t_fit = time.perf_counter() - t0
    auc = dev.score("auc")
    log(f"  device-resident path: kernel {t_kernel:.3f} s, fit(C=1) "
        f"{t_fit:.3f} s, AUC {auc:.4f}")
    check(np.array_equal(dev.kernel_counts, host_counts),
          "device-resident counts identical to the host path")
    check(np.isfinite(auc) and auc > auc_min, f"AUC {auc:.4f} > {auc_min}")
    host.fit(C=1.0)
    host_auc = host.score("auc")
    log(f"  host path: AUC {host_auc:.4f}")
    check(abs(host_auc - auc) < 1e-3, "host and device AUC agree within 1e-3")

    # the main solve alone: iterations and time per iteration (warm)
    ntr = dev.n_str_train
    rows = dev._K_dev[:ntr, :ntr]
    gram = dev._build_gram(rows, rows, "linear")
    KernelSVC(C=1.0, probability=False).fit(gram, np.asarray(Ytr))
    t0 = time.perf_counter()
    svc = KernelSVC(C=1.0, probability=False).fit(gram, np.asarray(Ytr))
    t_solve = time.perf_counter() - t0
    us_per_iter = 1e6 * t_solve / max(svc.iters_, 1)
    log(f"  SMO main solve: {svc.iters_} iterations in {t_solve:.3f} s = "
        f"{us_per_iter:.1f} us/iteration (sweep steady "
        f"{sweep['walls']['auto'][1]:.4f} s)")

    os.makedirs(SCRATCH, exist_ok=True)
    tr = os.path.join(SCRATCH, "train.fasta")
    te = os.path.join(SCRATCH, "test.fasta")
    write_labeled(tr, Xtr, Ytr, reader)
    write_labeled(te, Xte, Yte, reader)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["-g", str(g), "-m", str(m), "-C", "1", "-q",
                       "--json", tr, te])
    cli = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"  CLI: {cli}")
    check(rc == 0 and abs(cli["auc"] - host_auc) < 1e-3,
          "CLI main() AUC matches the API's")

    check(oracle_block(X, host_counts, g, m, oracle_size, seed=0),
          f"{oracle_size}-sequence block equals tests/oracle.py")
    return {"counts": host_counts, "iters": svc.iters_,
            "us_per_iter": us_per_iter, "sweep": sweep["walls"]}


def phase_ragged(n: int, lmin: int, lmax: int, g: int, m: int,
                 oracle_size: int, seed: int = 0) -> None:
    import numpy as np

    from fastsk_jax import FastSK, KernelConfig

    log(f"[4] ragged 20-letter corpus: N={n}, lengths {lmin}-{lmax}, "
        f"g={g} m={m}")
    X = ragged_corpus(n, lmin, lmax, 20, seed)
    runs = {}
    for name, cfg in (("auto", KernelConfig()),
                      ("theta", KernelConfig(exact_engine="theta"))):
        fsk = FastSK(g=g, m=m, config=cfg)
        t0 = time.perf_counter()
        engine = fsk._make_exact_engine(_encode(X))
        fsk.compute_train(X)
        runs[name] = fsk.kernel_counts
        log(f"  {name}: {type(engine).__name__}, "
            f"{time.perf_counter() - t0:.3f} s (first call)")
        if name == "auto":
            check(type(engine).__name__ == "PackedPairsEngine",
                  "auto routes the ragged corpus to the packed engine")
    check(np.array_equal(runs["auto"], runs["theta"]),
          "packed engine bit-equal to exact_engine='theta' (full matrix)")
    check(oracle_block(X, runs["auto"], g, m, oracle_size, seed=1),
          f"{oracle_size}-sequence block equals tests/oracle.py")


def _encode(X):
    from fastsk_jax.ops.encode import encode_sequences

    return encode_sequences(X)


def phase_theta_approx(Xtr, Ytr, Xte, Yte, g: int, m_exact: int,
                       m_approx: int, max_iters: int, auc_min: float) -> None:
    import numpy as np

    from fastsk_jax import FastSK, KernelConfig

    log(f"[5] dense theta and approx: {len(Xtr)} + {len(Xte)} sequences")
    counts = {}
    for name, eng in (("theta", "theta"), ("pairs", "pairs")):
        fsk = FastSK(g=g, m=m_exact, config=KernelConfig(exact_engine=eng))
        t0 = time.perf_counter()
        fsk.compute_kernel(Xtr, Xte, Ytr, Yte)
        counts[name] = fsk.kernel_counts
        log(f"  {name} g={g} m={m_exact}: {time.perf_counter() - t0:.3f} s "
            f"(first call)")
    check(np.array_equal(counts["theta"], counts["pairs"]),
          "theta engine bit-equal to the pairs engine")
    fsk = FastSK(g=g, m=m_approx, approx=True, max_iters=max_iters, seed=0)
    t0 = time.perf_counter()
    fsk.compute_kernel(Xtr, Xte, Ytr, Yte)
    t_kernel = time.perf_counter() - t0
    fsk.fit(C=1.0)
    auc = fsk.score("auc")
    log(f"  approx g={g} m={m_approx}: {fsk.iterations} iterations, kernel "
        f"{t_kernel:.3f} s, AUC {auc:.4f}")
    check(np.isfinite(auc) and auc_min < auc <= 1.0,
          f"approx AUC finite, > {auc_min}")


def phase_tf32(length: int, n_random: int, g: int, m: int) -> None:
    """A homopolymer of ``length``: each of its C(g, k) gapped k-mers
    occurs ``length - g + 1`` times. Past 2048 that count needs more than
    TF32's 11 significant bits, so a TF32 count dot would round it; the
    theta engine must stay exact. Also prints what a default-precision
    dot of that count gives on this card."""
    import jax.numpy as jnp
    import numpy as np

    from fastsk_jax import FastSK, KernelConfig

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle

    log(f"[6] homopolymer: length {length}, g={g} m={m}")
    rng = np.random.default_rng(6)
    X = [[1] * length] + [
        rng.integers(1, 5, size=int(rng.integers(20, 60))).tolist()
        for _ in range(n_random)
    ]
    count = length - g + 1
    c = jnp.eye(128, dtype=jnp.float32) * count
    log(f"  control: default-precision f32 dot {count} * {count} = "
        f"{int(jnp.dot(c, c)[0, 0])} (exact {count * count})")
    fsk = FastSK(g=g, m=m, config=KernelConfig(exact_engine="theta"))
    fsk.compute_train(X)
    want = oracle.exact_counts(X, g, m)
    log(f"  K[0,0] = {int(fsk.kernel_counts[0, 0])} "
        f"(C(g, k) * {count}^2 = {want[0, 0]})")
    check(np.array_equal(fsk.kernel_counts, want),
          f"theta engine equals tests/oracle.py ({count} per k-mer)")


def phase_mesh(Xtr, Ytr, Xte, Yte, Xe_tr, Ye_tr, Xe_te, Ye_te, n_dev: int,
               g: int, m: int, g_theta: int, m_theta: int) -> None:
    """The mesh path against one card: KAT2B exact over ``n_dev`` cards
    (auto routes to the packed ring) and the rows-sharded dense-theta
    device-resident fit on EP300."""
    import jax
    import numpy as np

    from fastsk_jax import FastSK, KernelConfig
    from fastsk_jax.parallel.sharding import make_mesh

    log(f"[mesh] {n_dev} cards")
    mesh = make_mesh(n_dev, 1)
    one = FastSK(g=g, m=m)
    one.compute_kernel(Xtr, Xte, Ytr, Yte)
    multi = FastSK(g=g, m=m, config=KernelConfig(mesh=mesh))
    t0 = time.perf_counter()
    multi.compute_kernel(Xtr, Xte, Ytr, Yte)
    log(f"  exact g={g} m={m} on the mesh: "
        f"{time.perf_counter() - t0:.3f} s (first call)")
    check(np.array_equal(multi.kernel_counts, one.kernel_counts),
          f"{n_dev}-card packed ring bit-equal to one card")

    one_t = FastSK(g=g_theta, m=m_theta)
    one_t.compute_kernel(Xe_tr, Xe_te, Ye_tr, Ye_te)
    dev = FastSK(g=g_theta, m=m_theta, config=KernelConfig(
        mesh=mesh, device_resident=True, exact_engine="theta"))
    t0 = time.perf_counter()
    dev.compute_kernel(Xe_tr, Xe_te, Ye_tr, Ye_te)
    dev.fit(C=1.0)
    auc = dev.score("auc")
    log(f"  rows-sharded dense theta g={g_theta} m={m_theta}: kernel + fit "
        f"{time.perf_counter() - t0:.3f} s, AUC {auc:.4f}")
    lo = dev._counts_dev.lo
    check(len(lo.sharding.device_set) == n_dev,
          f"counts sharded over {n_dev} cards")
    check(np.array_equal(dev.kernel_counts, one_t.kernel_counts),
          "rows-sharded device-resident counts bit-equal to one card")
    for d in jax.devices()[:n_dev]:
        stats = d.memory_stats() or {}
        log(f"  {d}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card mesh path")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, found {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: needs {args.chips} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from fastsk_jax import FastaUtility
    from fastsk_jax.harness.runner import CORPORA, read_split

    log(card_line())
    log(f"jax {jax.__version__}, {devices[0].device_kind}, "
        f"{len(devices)} device(s)")
    reader = FastaUtility()
    # the in-repo pos/neg splits; labels come from the file names
    kat = read_split("KAT2B", (CORPORA,), reader)
    ep300 = read_split("EP300", (CORPORA,), reader)
    if args.chips == 4:
        phase_mesh(*kat, *ep300, n_dev=4, g=13, m=7, g_theta=10, m_theta=4)
        count = 4
    else:
        phase_compile(kat[0], kat[1], kat[2], g=13, m=7)
        phase_exact_dna(*kat, reader, g=13, m=7, auc_min=0.85,
                        oracle_size=32)
        X = kat[0] + kat[2]
        kernel_vs_xla(X, 16, 10)
        phase_ragged(3000, 50, 800, g=8, m=4, oracle_size=32)
        phase_theta_approx(*ep300, g=10, m_exact=4, m_approx=6,
                           max_iters=50, auc_min=0.85)
        phase_tf32(3000, 5, g=6, m=3)
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
