"""PyTorch port vs JAX reference: VITS stage by stage.

The tiny voice dims of ``tests/voices.py`` with the reference's own
``vits.init_vits`` weights, carried across to the port.  Each stage is fed
the reference's inputs (its ``w_ceil``, its latent ``z``), so one frame
flipped by ``ceil(exp(logw))`` upstream cannot hide a difference
downstream.  The noise is the reference's: ``vits.per_row_normal`` under
the reference's own key split (``vits.infer``), handed to the port as
explicit tensors.

The layers ``init_vits`` starts at zero (each flow layer's ``post``, each
duration flow's ``proj``) are given random values first: at zero the flow's
WaveNet and coupling, and the duration flows' spline, would reach no output
that is compared.

Tolerance: atol 1e-4 on every float output (float32 on the CPU; several
stacked layers of differently ordered sums), exact equality on the integer
durations, frame counts and the alignment path.
"""

import jax
import numpy as np
import pytest
import torch

from sonata_tpu.models import vits as jv
from sonata_tpu.models.config import VitsHyperParams
from sonata_tpu_torch.models import vits as tv
from sonata_tpu_torch.models.weights import params_from_numpy
from voices import TINY_MODEL

ATOL = 1e-4
HP = VitsHyperParams(**TINY_MODEL)
N_VOCAB = 40
B, T, F = 2, 16, 64


def _fill_zero_init_layers(params, rng, std=0.1):
    """Random values in the layers ``init_vits`` starts at zero."""
    convs = ([layer["post"] for layer in params["flow"]["layers"]]
             + [flow["proj"] for flow in params["dp"]["flows"]])
    for conv in convs:
        for key in ("w", "b"):
            conv[key] = jax.numpy.asarray(
                rng.standard_normal(conv[key].shape).astype(np.float32) * std)
    return params


@pytest.fixture(scope="module", params=[1, 4], ids=["single", "multi"])
def setup(request):
    n_speakers = request.param
    params = _fill_zero_init_layers(
        jv.init_vits(jax.random.PRNGKey(0), HP, n_vocab=N_VOCAB,
                     n_speakers=n_speakers), np.random.default_rng(11))
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), HP)
    rng = np.random.default_rng(1)
    ids = rng.integers(3, N_VOCAB, size=(B, T)).astype(np.int32)
    lens = np.asarray([T, 9], np.int32)
    sid = np.asarray([1, 3], np.int32) if n_speakers > 1 else None
    rng_dur, rng_noise = jax.random.split(jax.random.PRNGKey(7))
    return dict(params=params, port=port, ids=ids, lens=lens, sid=sid,
                rng_dur=rng_dur, rng_noise=rng_noise,
                dur_noise=np.asarray(jv.per_row_normal(rng_dur, (B, T, 2))))


def _t(a, dtype=None):
    return None if a is None else torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _g(s):
    """The speaker conditioning of both packages, or None."""
    if s["sid"] is None:
        return None, None
    return (s["params"]["emb_g"][s["sid"]][:, None, :],
            tv.speaker_embedding(s["port"], _t(s["sid"], torch.long)))


def test_text_encoder(setup):
    s = setup
    mask = jv.sequence_mask(s["lens"], T)
    want = jv.text_encoder(s["params"]["enc_p"], HP, s["ids"], mask)
    got = tv.text_encoder(s["port"]["enc_p"], HP, _t(s["ids"], torch.long),
                          _t(mask))
    for g_, w_ in zip(got, want):
        _close(g_, w_)


def test_duration_predictor_and_encode_text(setup):
    s = setup
    jg, tg = _g(s)
    mask = jv.sequence_mask(s["lens"], T)
    x, _, _ = jv.text_encoder(s["params"]["enc_p"], HP, s["ids"], mask)
    want_logw = jv.duration_predictor_reverse(
        s["params"]["dp"], HP, x, mask, s["rng_dur"], 0.8, g=jg)
    got_logw = tv.duration_predictor_reverse(
        s["port"]["dp"], HP, _t(x), _t(mask), _t(s["dur_noise"]), 0.8, g=tg)
    _close(got_logw, want_logw)

    want = jv.encode_text(s["params"], HP, s["ids"], s["lens"], s["rng_dur"],
                          noise_w=0.8, length_scale=1.3, sid=s["sid"])
    got = tv.encode_text(s["port"], HP, _t(s["ids"], torch.long),
                         _t(s["lens"]), _t(s["dur_noise"]), noise_w=0.8,
                         length_scale=1.3, sid=_t(s["sid"], torch.long))
    _close(got[0], want[0])  # m_p
    _close(got[1], want[1])  # logs_p
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[3], want[3])  # x_mask
    if s["sid"] is not None:
        _close(got[4], want[4])  # g


def test_generate_path():
    w = np.asarray([[3, 0, 2, 5, 1], [1, 1, 4, 0, 0]], np.float32)
    mask = jv.sequence_mask(np.asarray([5, 3]), 5)
    want = jv.generate_path(w, mask, 16)
    got = tv.generate_path(_t(w), _t(mask), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_acoustics_fed_reference_durations(setup):
    s = setup
    m_p, logs_p, w_ceil, x_mask, jg = jv.encode_text(
        s["params"], HP, s["ids"], s["lens"], s["rng_dur"], noise_w=0.8,
        length_scale=1.0, sid=s["sid"])
    want_z, want_mask, want_len = jv.acoustics(
        s["params"], HP, m_p, logs_p, w_ceil, x_mask, s["rng_noise"],
        noise_scale=0.667, max_frames=F, g=jg)
    prior = np.asarray(jv.per_row_normal(s["rng_noise"],
                                         (B, F, HP.inter_channels)))
    _, tg = _g(s)
    got_z, got_mask, got_len = tv.acoustics(
        s["port"], HP, _t(m_p), _t(logs_p), _t(w_ceil), _t(x_mask),
        _t(prior), noise_scale=0.667, max_frames=F, g=tg)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    _close(got_mask, want_mask)
    _close(got_z, want_z)


def test_flow_reverse(setup):
    s = setup
    rng = np.random.default_rng(3)
    z = rng.standard_normal((B, F, HP.inter_channels)).astype(np.float32)
    mask = jv.sequence_mask(np.asarray([F, 41]), F)
    jg, tg = _g(s)
    want = jv.flow_reverse(s["params"]["flow"], HP, z, mask, g=jg)
    got = tv.flow_reverse(s["port"]["flow"], HP, _t(z), _t(mask), g=tg)
    _close(got, want)


def test_decode_with_fed_reference_z(setup):
    s = setup
    rng = np.random.default_rng(4)
    z = rng.standard_normal((B, F, HP.inter_channels)).astype(np.float32)
    jg, tg = _g(s)
    want = jv.decode_with(s["params"], HP, z, g=jg)
    got = tv.decode_with(s["port"], HP, _t(z), g=tg)
    assert tuple(got.shape) == (B, F * HP.hop_length)
    _close(got, want)


@pytest.mark.parametrize("n_speakers", [1, 4])
def test_random_tree_has_the_reference_shapes(n_speakers):
    """``weights.random_tree`` (the port's random voices) builds the tree
    of ``vits.init_vits``: same keys, same shapes, and the same zero-init
    of the duration-flow ``proj`` and the flow ``post`` layers."""
    from sonata_tpu.models.serialization import flatten_params
    from sonata_tpu_torch.models import serialization as tser
    from sonata_tpu_torch.models.weights import random_tree

    want = flatten_params(jv.init_vits(jax.random.PRNGKey(0), HP,
                                       n_vocab=N_VOCAB,
                                       n_speakers=n_speakers))
    got = tser.flatten_params(random_tree(
        HP, n_vocab=N_VOCAB, n_speakers=n_speakers,
        generator=torch.Generator().manual_seed(0)))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        zero_init = (key.startswith("dp/flows/") and "/proj/" in key
                     or key.startswith("flow/") and "/post/" in key)
        if zero_init:
            assert not got[key].any() and not np.asarray(value).any(), key


def test_serialization_round_trips_the_reference_format(tmp_path):
    """The port's ``.npz`` reader/writer and the JAX package's agree on
    the flat key format, both ways."""
    from sonata_tpu.models import serialization as jser
    from sonata_tpu_torch.models import serialization as tser

    params = jv.init_vits(jax.random.PRNGKey(1), HP, n_vocab=N_VOCAB,
                          n_speakers=2)
    jser.save_params(tmp_path / "jax.npz", params)
    loaded = tser.load_params(tmp_path / "jax.npz")
    tser.save_params(tmp_path / "port.npz", loaded)
    back = jser.load_params(tmp_path / "port.npz")
    want = jser.flatten_params(params)
    for flat in (tser.flatten_params(loaded), jser.flatten_params(back)):
        assert sorted(flat) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(flat[key], np.asarray(value))
