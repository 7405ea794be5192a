"""Count matmuls stay exact on a GPU: a default-precision f32 dot may run
in TF32 there, which holds integers only up to 2048. Every dot whose
operands are f32 counts must ask for HIGHEST precision; 0/1 one-hots and
8-bit digits are bf16 operands (exact at any precision)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastsk_jax import KernelConfig
from fastsk_jax.kernel.engine import DenseGkmEngine
from fastsk_jax.ops import gkm
from fastsk_jax.ops.combinatorics import enumerate_combinations
from fastsk_jax.ops.encode import encode_sequences

HIGHEST = jax.lax.Precision.HIGHEST


def _dots(jaxpr):
    """Every dot_general equation in a (closed) jaxpr, sub-jaxprs included."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for val in eqn.params.values():
            subs = val if isinstance(val, (tuple, list)) else (val,)
            for sub in subs:
                if hasattr(sub, "eqns") or hasattr(sub, "jaxpr"):
                    out += _dots(sub)
    return out


def _engine(long_len: int, mesh=None):
    """Dense engine whose counts are f32 (a sequence with > 256 windows)
    or bf16 (all sequences short)."""
    rng = np.random.default_rng(3)
    X = [rng.integers(1, 5, size=long_len).tolist()] + [
        rng.integers(1, 5, size=30).tolist() for _ in range(7)
    ]
    return DenseGkmEngine(encode_sequences(X), 6, 3, KernelConfig(mesh=mesh))


def _exact_jaxpr(eng):
    thetas = jnp.asarray(enumerate_combinations(eng.g, eng.k)[:4], jnp.int32)
    k_acc = jnp.zeros((eng.n, eng.n), jnp.int32)
    return jax.make_jaxpr(
        lambda k, i, l, t: gkm.exact_batch_update(
            k, i, l, t, **eng._static_kwargs()
        )
    )(k_acc, eng._ids, eng._lengths, thetas)


def _approx_jaxpr(eng):
    thetas = jnp.asarray(enumerate_combinations(eng.g, eng.k)[:4], jnp.int32)
    n = eng.n
    state = (
        jnp.zeros((n, n), jnp.int32), jnp.zeros((n, n), jnp.float32),
        jnp.int32(0), jnp.bool_(False),
    )
    return jax.make_jaxpr(
        lambda s, i, l, t: gkm.approx_batch_update(
            s, i, l, t, n_train=n, check_variance=True, conv_delta=0.025,
            max_iters=4, **eng._static_kwargs(),
        )
    )(state, eng._ids, eng._lengths, thetas)


def _sharded_jaxpr(eng):
    from fastsk_jax.parallel import sharding as shd

    thetas, live = shd.pad_theta_batch(
        np.asarray(enumerate_combinations(eng.g, eng.k)[:4]),
        eng.mesh.shape[shd.THETA_AXIS],
    )
    n = eng.n_padded
    k_acc = jnp.zeros((n, n), jnp.int32)
    return jax.make_jaxpr(
        lambda k, i, l: shd.exact_batch_update_sharded(
            k, i, l, jnp.asarray(thetas), jnp.asarray(live),
            mesh=eng.mesh, **eng._static_kwargs(),
        )
    )(k_acc, eng._ids, eng._lengths)


@pytest.mark.parametrize("site", ["exact", "approx", "sharded_exact"])
def test_f32_count_dots_ask_for_highest(site):
    if site == "sharded_exact":
        from fastsk_jax.parallel.sharding import make_mesh

        eng = _engine(400, mesh=make_mesh(2, 2))
        jaxpr = _sharded_jaxpr(eng)
    else:
        eng = _engine(400)
        jaxpr = (_exact_jaxpr if site == "exact" else _approx_jaxpr)(eng)
    assert eng.count_dtype == jnp.float32 and not eng.count_split
    dots = _dots(jaxpr)
    f32 = [e for e in dots if e.invars[0].aval.dtype == jnp.float32]
    assert f32, "the f32 count Gram must appear in the traced program"
    for eqn in f32:
        assert eqn.params["precision"] == (HIGHEST, HIGHEST), eqn
    # the one-hot histogram contraction runs on exact bf16 operands
    assert any(e.invars[0].aval.dtype == jnp.bfloat16 for e in dots)


def test_bf16_counts_keep_default_precision():
    eng = _engine(60)
    assert eng.count_dtype == jnp.bfloat16
    dots = _dots(_exact_jaxpr(eng))
    assert dots and all(e.invars[0].aval.dtype == jnp.bfloat16 for e in dots)
    assert gkm.count_precision(jnp.zeros(2, jnp.bfloat16)) is None
    assert gkm.count_precision(jnp.zeros(2, jnp.float32)) == HIGHEST


def test_split_counts_multiply_bf16_digits():
    """Counts beyond the f32-exact range split into 8-bit digits, which
    are exact bf16 operands."""
    a = np.random.default_rng(0).integers(0, 9000, (5, 7))
    a = jnp.asarray(a, jnp.float32)
    dots = _dots(jax.make_jaxpr(gkm._cross_gram_int32_split)(a, a))
    assert len(dots) == 4
    assert all(e.invars[0].aval.dtype == jnp.bfloat16 for e in dots)
    got = np.asarray(gkm._cross_gram_int32_split(a, a), np.int64)
    want = np.asarray(a, np.int64) @ np.asarray(a, np.int64).T
    np.testing.assert_array_equal(got, want)
