"""PyTorch port vs JAX reference: the VITS building blocks.

Every case feeds the same numpy inputs and the same weights (the JAX
package's own initializers, carried across by
``sonata_tpu_torch.models.weights.params_from_numpy``) to
``sonata_tpu.models.modules`` and to ``sonata_tpu_torch.models.modules``, in
float32 on the CPU.

Tolerance: atol 1e-5 on every output the model uses — float32 sums taken
in another order by XLA's and PyTorch's CPU convolutions and matmuls differ
by a few 1e-7 at these widths; 1e-5 leaves room without hiding a wrong tap
or sign.  The spline's log-determinant (which inference discards) is a
difference of logs of near-cancelling terms and is held to atol 1e-5
plus rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonata_tpu.models import modules as jm
from sonata_tpu.models.config import VitsHyperParams
from sonata_tpu_torch.models import modules as tm
from sonata_tpu_torch.models.weights import params_from_numpy

ATOL = 1e-5
HP = VitsHyperParams()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    """A sub-tree of reference parameters as port parameters."""
    return params_from_numpy({"p": _np_tree(tree)}, HP)["p"]


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _mask(b, t, lengths):
    m = np.zeros((b, t, 1), np.float32)
    for i, n in enumerate(lengths):
        m[i, :n] = 1.0
    return m


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("k,dilation", [(3, 1), (3, 3), (5, 5), (1, 1),
                                         (4, 1)])
def test_conv1d(k, dilation):
    p = jm._conv_init(jax.random.PRNGKey(k * 10 + dilation), k, 6, 10)
    x = _x((2, 23, 6), seed=dilation)
    want = jm.conv1d(jnp.asarray(x), p, dilation=dilation)
    got = tm.conv1d(torch.from_numpy(x), _port(p), dilation=dilation)
    _close(got, want)


@pytest.mark.parametrize("arm", ["subpixel", "naive"])
@pytest.mark.parametrize("k,stride", [(8, 4), (16, 8), (4, 2)])
def test_conv_transpose1d(monkeypatch, arm, k, stride):
    monkeypatch.setenv("SONATA_TCONV", arm)
    p = jm._conv_init(jax.random.PRNGKey(k + stride), k, 8, 6)
    x = _x((2, 9, 8), seed=k)
    pad = (k - stride) // 2
    want = jm.conv_transpose1d(jnp.asarray(x), p, stride=stride, padding=pad)
    port = params_from_numpy({"ups": [_np_tree(p)]}, HP)["ups"][0]
    got = tm.conv_transpose1d(torch.from_numpy(x), port, stride=stride,
                              padding=pad)
    assert tuple(got.shape) == tuple(want.shape) == (2, 9 * stride, 6)
    _close(got, want)


def test_layer_norm():
    p = {"gamma": jnp.asarray(_x((12,), 1)), "beta": jnp.asarray(_x((12,), 2))}
    x = _x((3, 7, 12), seed=3, scale=4.0)
    _close(tm.layer_norm(torch.from_numpy(x), _port(p)),
           jm.layer_norm(jnp.asarray(x), p))


@pytest.mark.parametrize("t,window", [(11, 4), (3, 4), (6, 2)])
def test_rel_attention_masked_rows(t, window):
    p = jm.init_rel_attention(jax.random.PRNGKey(t), 16, 2, window)
    x = _x((2, t, 16), seed=t)
    mask = _mask(2, t, [t, max(t - 4, 1)])  # second row padded
    want = jm.rel_attention(jnp.asarray(x), jnp.asarray(mask), p, n_heads=2,
                            window=window)
    got = tm.rel_attention(torch.from_numpy(x), torch.from_numpy(mask),
                           _port(p), n_heads=2, window=window)
    _close(got, want)


def test_ffn():
    p = jm.init_ffn(jax.random.PRNGKey(1), 16, 32, 3)
    x = _x((2, 10, 16), seed=4)
    mask = _mask(2, 10, [10, 6])
    _close(tm.ffn(torch.from_numpy(x), torch.from_numpy(mask), _port(p)),
           jm.ffn(jnp.asarray(x), jnp.asarray(mask), p))


def test_transformer():
    p = jm.init_transformer(jax.random.PRNGKey(2), channels=16,
                            filter_channels=32, n_heads=2, n_layers=2,
                            kernel=3, window=4)
    x = _x((2, 13, 16), seed=5)
    mask = _mask(2, 13, [13, 8])
    want = jm.transformer(jnp.asarray(x), jnp.asarray(mask), p, n_heads=2,
                          window=4)
    got = tm.transformer(torch.from_numpy(x), torch.from_numpy(mask),
                         _port(p), n_heads=2, window=4)
    _close(got, want)


@pytest.mark.parametrize("with_g", [False, True])
def test_wn(with_g):
    gin = 8 if with_g else 0
    p = jm.init_wn(jax.random.PRNGKey(3), hidden=12, kernel=5,
                   dilation_rate=1, n_layers=3, gin_channels=gin)
    x = _x((2, 17, 12), seed=6)
    mask = _mask(2, 17, [17, 11])
    g = _x((2, 1, 8), seed=7) if with_g else None
    want = jm.wn(jnp.asarray(x), jnp.asarray(mask), p, kernel=5,
                 dilation_rate=1, n_layers=3,
                 g=None if g is None else jnp.asarray(g))
    got = tm.wn(torch.from_numpy(x), torch.from_numpy(mask), _port(p),
                kernel=5, dilation_rate=1, n_layers=3,
                g=None if g is None else torch.from_numpy(g))
    _close(got, want)


@pytest.mark.parametrize("with_g", [False, True])
def test_dds_conv(with_g):
    p = jm.init_dds_conv(jax.random.PRNGKey(4), channels=12, kernel=3,
                         n_layers=3)
    x = _x((2, 15, 12), seed=8)
    mask = _mask(2, 15, [15, 9])
    g = _x((2, 15, 12), seed=9) if with_g else None
    want = jm.dds_conv(jnp.asarray(x), jnp.asarray(mask), p, kernel=3,
                       g=None if g is None else jnp.asarray(g))
    got = tm.dds_conv(torch.from_numpy(x), torch.from_numpy(mask), _port(p),
                      kernel=3, g=None if g is None else torch.from_numpy(g))
    _close(got, want)


def test_rational_quadratic_spline_inverse_inside_and_outside_tail():
    bins, tail = 10, 5.0
    y = np.concatenate([np.linspace(-7.0, 7.0, 57, dtype=np.float32),
                        np.asarray([-5.0, 5.0, 0.0], np.float32)])
    y = np.stack([y, -y])  # [2, 60]; |y| > tail takes the identity path
    uw = _x((2, 60, bins), seed=10)
    uh = _x((2, 60, bins), seed=11)
    ud = _x((2, 60, bins - 1), seed=12)
    want_x, want_ld = jm.rational_quadratic_spline_inverse(
        jnp.asarray(y), jnp.asarray(uw), jnp.asarray(uh), jnp.asarray(ud),
        tail_bound=tail)
    got_x, got_ld = tm.rational_quadratic_spline_inverse(
        torch.from_numpy(y), torch.from_numpy(uw), torch.from_numpy(uh),
        torch.from_numpy(ud), tail_bound=tail)
    _close(got_x, want_x)
    np.testing.assert_allclose(got_ld.numpy(), np.asarray(want_ld),
                               rtol=1e-5, atol=ATOL)
    outside = np.abs(y) > tail
    assert outside.any() and (~outside).any()
    np.testing.assert_array_equal(got_x.numpy()[outside], y[outside])
