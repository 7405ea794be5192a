"""Real 2-process jax.distributed execution on CPU.

Round 1 only compile-checked ``parallel/multihost.py`` on a virtual mesh;
this spawns two actual processes with a local TCP coordinator, builds the
global mesh through ``multihost.initialize()/global_mesh()``, computes a
sharded exact kernel, and asserts integer equality with the single-process
result — the closest a single machine gets to a multi-host run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")

coord = sys.argv[1]
pid = int(sys.argv[2])
out_path = sys.argv[3]

# distributed init MUST precede anything that touches the XLA backend —
# including importing modules that query jax.devices()
from fastsk_jax.parallel import multihost

multihost.initialize(
    coordinator_address=coord, num_processes=2, process_id=pid
)

import numpy as np
from fastsk_jax import FastSK, KernelConfig
assert jax.process_count() == 2, jax.process_count()
# 2 processes x 2 local devices = 4 global devices
mesh = multihost.global_mesh(rows=2, theta=2)

rng = np.random.default_rng(42)
X = [rng.integers(1, 5, size=int(rng.integers(12, 20))).tolist()
     for _ in range(10)]
fsk = FastSK(g=5, m=2, config=KernelConfig(mesh=mesh, exact_engine="theta"))
fsk.compute_train(X)
if pid == 0:
    np.save(out_path, fsk.kernel_counts)
jax.distributed.shutdown()
"""


@pytest.mark.slow
def test_two_process_distributed_kernel(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    out = str(tmp_path / "k0.npy")
    script = str(tmp_path / "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, script, coord, str(pid), out],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout.decode(errors="replace"))
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o[-3000:]

    # single-process oracle
    from fastsk_jax import FastSK, KernelConfig

    rng = np.random.default_rng(42)
    X = [rng.integers(1, 5, size=int(rng.integers(12, 20))).tolist()
         for _ in range(10)]
    single = FastSK(g=5, m=2, config=KernelConfig(exact_engine="theta"))
    single.compute_train(X)
    np.testing.assert_array_equal(np.load(out), single.kernel_counts)


WORKER_8X1 = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")

coord = sys.argv[1]
pid = int(sys.argv[2])
out_path = sys.argv[3]

from fastsk_jax.parallel import multihost

multihost.initialize(
    coordinator_address=coord, num_processes=8, process_id=pid
)

import numpy as np
from fastsk_jax import FastSK, KernelConfig
assert jax.process_count() == 8, jax.process_count()
# 8 processes x 1 local device = the multi-host shape: every host owns exactly
# one device and one kernel row block; all collectives cross processes
mesh = multihost.global_mesh(rows=8, theta=1)

rng = np.random.default_rng(42)
X = [rng.integers(1, 5, size=int(rng.integers(10, 16))).tolist()
     for _ in range(16)]
fsk = FastSK(g=5, m=2, config=KernelConfig(mesh=mesh, exact_engine="theta"))
fsk.compute_train(X)
if pid == 0:
    np.save(out_path, fsk.kernel_counts)
jax.distributed.shutdown()
"""


@pytest.mark.slow
def test_eight_process_single_device_kernel(tmp_path):
    """8 processes x 1 device each (VERDICT r4 item 9): the multi-HOST
    shape where no process sees more than one device, so every mesh
    collective crosses a process boundary. Integer-exact vs the
    single-process engine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    out = str(tmp_path / "k8.npy")
    script = str(tmp_path / "worker8.py")
    with open(script, "w") as f:
        f.write(WORKER_8X1)
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=1",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, script, coord, str(pid), out],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(8)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=560)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout.decode(errors="replace"))
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o[-3000:]

    from fastsk_jax import FastSK, KernelConfig

    rng = np.random.default_rng(42)
    X = [rng.integers(1, 5, size=int(rng.integers(10, 16))).tolist()
         for _ in range(16)]
    single = FastSK(g=5, m=2, config=KernelConfig(exact_engine="theta"))
    single.compute_train(X)
    np.testing.assert_array_equal(np.load(out), single.kernel_counts)


WORKER_DEVRES = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")

coord = sys.argv[1]
pid = int(sys.argv[2])
out_path = sys.argv[3]

from fastsk_jax.parallel import multihost

multihost.initialize(
    coordinator_address=coord, num_processes=2, process_id=pid
)

import numpy as np
from fastsk_jax import FastSK, KernelConfig
assert jax.process_count() == 2, jax.process_count()
# 2 processes x 4 local devices = 8 global devices, (rows=4, theta=2)
mesh = multihost.global_mesh(rows=4, theta=2)

rng = np.random.default_rng(42)
X = [rng.integers(1, 5, size=14).tolist() for _ in range(24)]
y = (np.arange(24) % 2).astype(int).tolist()
fsk = FastSK(
    g=5, m=2,
    config=KernelConfig(
        mesh=mesh, exact_engine="theta", device_resident=True
    ),
)
fsk.compute_kernel(X[:18], X[18:], y[:18], y[18:])
assert fsk._counts_dev is not None, "must stay device-resident under the mesh"
# the counts are ROWS-SHARDED: every DEVICE holds a strict row block
# (a process can still see all rows when its devices span a full theta
# column — the per-device shard is what must shrink)
max_dev_rows = max(
    s.data.shape[0] for s in fsk._counts_dev.lo.addressable_shards
)
assert max_dev_rows < fsk._counts_dev.lo.shape[0], (
    "per-device state must be a strict row block",
    max_dev_rows, fsk._counts_dev.lo.shape,
)
fsk.fit(C=1.0, kernel_type="fastsk")
acc = fsk.score("accuracy")
if pid == 0:
    np.save(out_path, np.array([acc], dtype=np.float64))
jax.distributed.shutdown()
"""


@pytest.mark.slow
def test_two_process_device_resident_fit_score(tmp_path):
    """2 processes x 4 local devices: a rows-sharded device-resident
    kernel + fit + score runs across process boundaries and lands on the
    single-process score exactly (VERDICT r3 item 8 — the closest this
    environment gets to the multi-host story)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    out = str(tmp_path / "acc0.npy")
    script = str(tmp_path / "worker_devres.py")
    with open(script, "w") as f:
        f.write(WORKER_DEVRES)
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, script, coord, str(pid), out],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout.decode(errors="replace"))
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o[-3000:]

    from fastsk_jax import FastSK, KernelConfig

    rng = np.random.default_rng(42)
    X = [rng.integers(1, 5, size=14).tolist() for _ in range(24)]
    y = (np.arange(24) % 2).astype(int).tolist()
    single = FastSK(g=5, m=2, config=KernelConfig(exact_engine="theta"))
    single.compute_kernel(X[:18], X[18:], y[:18], y[18:])
    single.fit(C=1.0, kernel_type="fastsk")
    acc_single = single.score("accuracy")
    acc_multi = float(np.load(out)[0])
    assert acc_multi == acc_single, (acc_multi, acc_single)
