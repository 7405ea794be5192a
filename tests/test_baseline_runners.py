"""Baseline subprocess runners vs stub executables.

The real gkmSVM/LSGKM/GaKCo/JVM binaries aren't in this environment, so
the runners are driven against stub shell scripts that validate the
command line they receive and emit synthetic outputs with known
statistics — covering command construction, file conversion, output
parsing, and scoring end to end (the reference's oracle-runner surface,
test/utils.py:448-856).
"""

import os
import stat

import numpy as np
import pytest

from fastsk_jax.harness.baselines import (
    BaselineNotInstalled,
    BlendedSpectrumRunner,
    GaKCoRunner,
    GkmRunner,
    LsgkmRunner,
    split_pos_neg,
)


def _write_exec(path, body):
    with open(path, "w") as f:
        f.write("#!/bin/bash\n" + body)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


def _write_fasta(path, labels, seqs):
    with open(path, "w") as f:
        for y, s in zip(labels, seqs):
            f.write(f">{y}\n{s}\n")


@pytest.fixture
def data_dir(tmp_path, rng):
    d = tmp_path / "data"
    d.mkdir()
    seqs = ["".join("acgt"[c] for c in rng.integers(0, 4, size=30))
            for _ in range(24)]
    labels = [1, 0] * 6 + [1] * 6 + [0] * 6
    _write_fasta(str(d / "toy.train.fasta"), labels[:16], seqs[:16])
    _write_fasta(str(d / "toy.test.fasta"), labels[16:], seqs[16:])
    with open(d / "dna.dictionary.txt", "w") as f:
        f.write("a\nc\ng\nt\n")
    return str(d)


def test_split_pos_neg(data_dir, tmp_path):
    n_pos, n_neg = split_pos_neg(
        os.path.join(data_dir, "toy.train.fasta"),
        str(tmp_path / "p.fasta"), str(tmp_path / "n.fasta"),
    )
    assert (n_pos, n_neg) == (10, 6)
    pos = open(tmp_path / "p.fasta").read()
    neg = open(tmp_path / "n.fasta").read()
    # the gkm tools key sequences by name: every header must be UNIQUE
    # (duplicate headers silently collapse the dataset; gkmify.py:45-46)
    names = [
        ln[1:] for ln in (pos + neg).splitlines() if ln.startswith(">")
    ]
    assert len(names) == 16 and len(set(names)) == 16
    assert pos.count(">") == 10


def test_gkm_runner_pipeline(data_dir, tmp_path):
    exec_dir = tmp_path / "bin"
    exec_dir.mkdir()
    log = str(tmp_path / "cmds.log")
    # stubs validate flag order loosely by logging argv; classify writes
    # scores making pos all-positive and neg all-negative
    _write_exec(exec_dir / "gkmsvm_kernel",
                f'echo kernel "$@" >> {log}\ntouch "${{@: -1}}"\n')
    _write_exec(exec_dir / "gkmsvm_train",
                f'echo train "$@" >> {log}\ntouch "$4_svalpha.out" "$4_svseq.fa"\n')
    _write_exec(
        exec_dir / "gkmsvm_classify",
        f'echo classify "$@" >> {log}\n'
        'out="${@: -1}"; in="${@: -4:1}"\n'
        'case "$in" in *pos*) s=0.9;; *) s=-0.4;; esac\n'
        'i=0; grep -c ">" "$in" | while read n; do :; done\n'
        'for x in $(grep ">" "$in"); do echo "seq$i $s" >> "$out"; i=$((i+1)); done\n',
    )
    runner = GkmRunner(str(exec_dir), data_dir, "toy", g=6, k=4,
                       approx=True, outdir=str(tmp_path / "out"))
    runner.ensure_split_data(
        os.path.join(data_dir, "toy.train.fasta"),
        os.path.join(data_dir, "toy.test.fasta"),
    )
    acc, auc = runner.train_and_test(t=2)
    assert acc == 1.0 and auc == 1.0  # separable synthetic scores
    cmds = open(log).read()
    assert "-l 6" in cmds and "-k 4" in cmds and "-d 3" in cmds  # approx d=3
    assert "-T 2" in cmds and "-R" in cmds


def test_lsgkm_runner_pipeline(data_dir, tmp_path):
    exec_dir = tmp_path / "bin"
    exec_dir.mkdir()
    log = str(tmp_path / "cmds.log")
    _write_exec(exec_dir / "gkmtrain",
                f'echo train "$@" >> {log}\ntouch "${{@: -1}}.model.txt"\n')
    _write_exec(
        exec_dir / "gkmpredict",
        f'echo predict "$@" >> {log}\n'
        'out="${@: -1}"; in="${@: -3:1}"\n'
        'case "$in" in *pos*) s=1.5;; *) s=-2.0;; esac\n'
        'for x in $(grep ">" "$in"); do echo "seq $s" >> "$out"; done\n',
    )
    runner = LsgkmRunner(str(exec_dir), data_dir, "toy", g=10, m=3,
                         outdir=str(tmp_path / "out"))
    split_pos_neg(os.path.join(data_dir, "toy.train.fasta"),
                  runner.train_pos_file, runner.train_neg_file)
    split_pos_neg(os.path.join(data_dir, "toy.test.fasta"),
                  runner.test_pos_file, runner.test_neg_file)
    acc, auc = runner.train_and_test(t=4)
    assert acc == 1.0 and auc == 1.0
    cmds = open(log).read()
    assert "-t 2" in cmds and "-l 10" in cmds and "-k 7" in cmds
    assert "-d 3" in cmds and "-T 4" in cmds


def test_gakco_runner_pipeline(data_dir, tmp_path):
    log = str(tmp_path / "cmds.log")
    gakco = tmp_path / "GaKCo"
    # stub emits an identity-ish EKM kernel in the i:value format
    _write_exec(
        gakco,
        f'echo gakco "$@" >> {log}\n'
        'data="$5"; out="$8"\n'
        'n=$(grep -c ">" "$data")\n'
        'for i in $(seq 1 $n); do\n'
        '  row=""\n'
        '  for j in $(seq 1 $n); do\n'
        '    if [ $i -eq $j ]; then v=1.0; else v=0.1; fi\n'
        '    row="$row$j:$v "\n'
        '  done\n'
        '  echo "$row" >> "$out"\ndone\n',
    )
    runner = GaKCoRunner(str(gakco), data_dir, "dna", "toy",
                         outdir=str(tmp_path / "out"))
    acc, auc = runner.train_and_test(g=6, m=2)
    assert 0.0 <= acc <= 1.0 and 0.0 <= auc <= 1.0
    cmds = open(log).read()
    assert "-g 6" in cmds and "-k 4" in cmds
    assert runner.num_train == 16 and runner.num_test == 8
    xtr, xte = runner.read_kernel()
    assert xtr.shape == (16, 16) and xte.shape == (8, 16)


def test_blended_spectrum_writes_and_parses(data_dir, tmp_path, monkeypatch):
    runner = BlendedSpectrumRunner(str(tmp_path / "jar"), data_dir, "toy",
                                   outdir=str(tmp_path / "out"))
    runner.write_sequences()
    lines = open(runner.seq_file).read().strip().splitlines()
    assert len(lines) == 24 and lines[0].islower()
    # fake the JVM output and exercise parse + scoring
    n = 24
    k = np.full((n, n), 0.2)
    np.fill_diagonal(k, 1.0)
    with open(runner.kernel_file, "w") as f:
        for row in k:
            f.write(" ".join(f"{v:.3f}" for v in row) + "\n")
    xtr, xte = runner.read_kernel()
    assert xtr.shape == (16, 16) and xte.shape == (8, 16)


def test_missing_binary_raises(data_dir, tmp_path):
    runner = GkmRunner(str(tmp_path / "nowhere"), data_dir, "toy", g=6, k=4,
                       outdir=str(tmp_path / "out"))
    runner.ensure_split_data(
        os.path.join(data_dir, "toy.train.fasta"),
        os.path.join(data_dir, "toy.test.fasta"),
    )
    with pytest.raises(BaselineNotInstalled):
        runner.compute_train_kernel()
