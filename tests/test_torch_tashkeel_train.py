"""PyTorch port vs JAX reference: training the Arabic tagger.

The port's training surface (``models/tashkeel.py``: ``init_tashkeel``,
``apply_tashkeel``, ``TashkeelModel.random``/``save``) and its trainer
(``models/tashkeel_train.py``) against the JAX package's ``tashkeel``
module and ``tools/train_tashkeel.py``, at a small width (hidden 32,
filter 64, 2 heads, 2 layers, window 4), batch 8 at the tool's ``T = 48``:

- (a) the initial tree: the reference's keys, shapes and dtypes, and its
  distributions (std within 10%, conv bounds, layer norms);
- (b) batches: equal to the tool's ``make_batch`` for the same seed;
- (c) loss and gradients on the same parameters: loss rtol 1e-6, every
  gradient leaf in the reference's layout atol 1e-6 (float32 sums in
  another order);
- (d) Adam alone on the same gradients: parameters atol 1e-7 plus two
  float32 steps of their size (rtol 2**-22) after 3 steps;
- (e) ten training steps against the tool's jitted step: loss rtol 1e-4 at
  every step, then logits atol 1e-4 and equal strings (Adam turns
  near-zero gradients into ±lr steps, so the parameters are not held
  bitwise);
- (f) files both ways: the port's ``save`` loads in the JAX ``from_path``
  (logits atol 1e-5), writes the JAX ``save``'s keys, arrays and
  ``__meta__``, and round-trips bit for bit;
- (g) ``main``: under the gate it exits 1 and writes nothing; without CUDA
  and without ``--device`` it raises.

And the gold-corpus scores of ``tools/eval_tashkeel.py``: the port's
``score`` of the port's outputs equals the tool's ``score`` of the JAX
package's, sentence by sentence, and the totals give ``TASHKEEL_EVAL.json``.

The tools are loaded from their files; their ``main`` is never called
(the training tool's rewrites the bundled model).
"""

import copy
import dataclasses
import importlib.util
import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sonata_tpu.models import tashkeel as jtag
from sonata_tpu.models.serialization import flatten_params as jflatten
from sonata_tpu.text import tashkeel_rules as jrules
from sonata_tpu_torch.core import OperationError
from sonata_tpu_torch.models import tashkeel as ttag
from sonata_tpu_torch.models import tashkeel_train as tt
from sonata_tpu_torch.models.serialization import flatten_params
from sonata_tpu_torch.models.weights import params_to_numpy
from sonata_tpu_torch.text import tashkeel_rules as trules
from sonata_tpu_torch.utils.buckets import bucket_for

REPO = Path(__file__).resolve().parent.parent
HP = ttag.TashkeelHyperParams(hidden=32, filter=64, n_heads=2, n_layers=2,
                              kernel=3, window=4)
JHP = jtag.TashkeelHyperParams(**dataclasses.asdict(HP))
N_VOCAB = len(ttag._DEFAULT_VOCAB) + 1
BATCH = 8
SENTENCES = ["مرحبا بالعالم", "السلام عليكم", "الشمس والقمر", "كتاب",
             "ذهب الولد إلى المدرسة، وقرأ 3 كتب.",
             "هل تتكلم العربية؟ نعم، قليلا!"]


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"{name}_tool", REPO / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def train_tool():
    return _load_tool("train_tashkeel")


@pytest.fixture(scope="module")
def eval_tool():
    return _load_tool("eval_tashkeel")


def _jax_tree(seed: int = 1):
    return jax.tree_util.tree_map(
        np.asarray, jtag.init_tashkeel(jax.random.PRNGKey(seed), JHP,
                                       N_VOCAB))


def _models(tree):
    """The same parameters as a JAX model and a port model on the CPU."""
    jax_model = jtag.TashkeelModel(
        jax.tree_util.tree_map(jnp.asarray, tree), JHP)
    return jax_model, ttag.TashkeelModel(tree, HP, device="cpu")


def _jax_loss(params, xs, ys, mask, lens):
    """The loss of ``tools/train_tashkeel.py``'s step."""
    logits = jtag.apply_tashkeel(params, JHP, xs, lens)
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, ys)
    return (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)


def _jax_logits(params, base: str, model):
    ids = [model._char_to_id.get(ch, 0) for ch in base]
    padded = np.zeros((1, bucket_for(len(ids))), np.int32)
    padded[0, :len(ids)] = ids
    return np.asarray(jtag.apply_tashkeel(
        params, JHP, jnp.asarray(padded),
        jnp.asarray([len(ids)], jnp.int32)))[0, :len(ids)]


def _flat(tree):
    return {k: np.asarray(v) for k, v in jflatten(tree).items()}


# -- (a) the initial tree --------------------------------------------------------

def test_init_tree_matches_the_reference():
    want = _flat(jtag.init_tashkeel(jax.random.PRNGKey(0), JHP, N_VOCAB))
    got = flatten_params(ttag.init_tashkeel(
        HP, N_VOCAB, generator=torch.Generator().manual_seed(0)))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        assert got[key].dtype == value.dtype == np.float32, key

    # the reference's distributions: std within 10%, uniform bounds
    assert abs(got["emb"].std() / 0.02 - 1) < 0.1
    head = HP.hidden // HP.n_heads
    rel = np.concatenate([v.ravel() for k, v in got.items()
                          if "emb_rel_" in k])
    assert abs(rel.std() / head ** -0.5 - 1) < 0.1
    for key, value in got.items():
        if key.endswith(("/w", "/b")):
            w = got[key[:-1] + "w"]
            k, c_in = w.shape[0], w.shape[1]
            assert np.abs(value).max() <= 1 / np.sqrt(c_in * k), key
        elif key.endswith("/gamma"):
            assert (value == 1).all(), key
        elif key.endswith("/beta"):
            assert (value == 0).all(), key
    assert got["proj/w"].shape == (1, HP.hidden, len(ttag.DIACRITICS))


def test_init_is_a_function_of_the_seed():
    def tree(seed):
        return flatten_params(ttag.init_tashkeel(
            HP, N_VOCAB, generator=torch.Generator().manual_seed(seed)))

    a, b, c = tree(5), tree(5), tree(6)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(a["emb"], c["emb"])
    assert not np.array_equal(a["proj/w"], c["proj/w"])
    # TashkeelModel.random draws the same tree, frozen
    model = ttag.TashkeelModel.random(HP, seed=5, device="cpu")
    got = flatten_params(params_to_numpy(model.module))
    for key in a:
        np.testing.assert_array_equal(got[key], a[key])
    assert not any(p.requires_grad for p in model.module.parameters())


# -- (b) batches ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_equals_the_tool(train_tool, seed):
    jax_model, port_model = _models(_jax_tree())
    want = train_tool.make_batch(jax_model, random.Random(seed), BATCH)
    got = tt.make_batch(port_model, random.Random(seed), BATCH)
    for w, g in zip(want, got):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tt.T == train_tool.T and tt.LETTERS == train_tool.LETTERS
    assert tt.COMMON == train_tool.COMMON


# -- (c) loss and gradients ------------------------------------------------------------

def test_loss_and_gradients_match_the_tools(train_tool):
    tree = _jax_tree()
    jax_model, port_model = _models(tree)
    batch = train_tool.make_batch(jax_model, random.Random(0), BATCH)
    want_loss, want_grads = jax.value_and_grad(_jax_loss)(
        jax_model.params, *batch)
    port_batch = tt.make_batch(port_model, random.Random(0), BATCH)
    loss, grads = tt.loss_and_grads(port_model.module, *port_batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)

    # the gradients in the reference's layout, by the parameters' carrier
    carrier = copy.deepcopy(port_model.module)
    for name, p in carrier.named_parameters():
        p.data = grads[name]
    got = flatten_params(params_to_numpy(carrier))
    want = _flat(want_grads)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=1e-6, rtol=0,
                                   err_msg=key)
    assert max(np.abs(v).max() for v in want.values()) > 1e-2
    assert not any(p.requires_grad for p in port_model.module.parameters())


# -- (d) the optimiser alone -------------------------------------------------------------

def test_adam_matches_optax_adam():
    flat = _flat(_jax_tree())
    rng = np.random.default_rng(3)
    grads = [{k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
              for k, v in flat.items()} for _ in range(3)]
    # a few near-zero and exactly-zero gradients too
    for g in grads:
        g["emb"][:4] *= 1e-7
        g["emb"][4:6] = 0.0

    opt = optax.adam(3e-3)
    params = {k: jnp.asarray(v) for k, v in flat.items()}
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, params)
        params = optax.apply_updates(params, updates)

    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in flat.items()}
    port_opt = tt.make_optimizer(list(tensors.values()), lr=3e-3)
    for g in grads:
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k])
        port_opt.step()
    # atol 1e-7, and two float32 steps of the parameter's own size: torch
    # fuses ``p - lr/bc1 * m / (sqrt(v)/sqrt(bc2) + eps)`` where optax
    # rounds each factor, so the last add can round apart at |p| >= 0.5
    for k, p in tensors.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   atol=1e-7, rtol=2 ** -22, err_msg=k)


# -- (e) ten steps end to end ---------------------------------------------------------------

def test_ten_steps_match_the_tools_jitted_step(train_tool):
    tree = _jax_tree()
    jax_model, port_model = _models(tree)
    opt = optax.adam(3e-3)

    @jax.jit
    def step(params, opt_state, xs, ys, mask, lens):
        loss, grads = jax.value_and_grad(_jax_loss)(params, xs, ys, mask,
                                                    lens)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    params, opt_state = jax_model.params, opt.init(jax_model.params)
    rng = random.Random(0)
    want_losses = []
    for _ in range(10):
        batch = train_tool.make_batch(jax_model, rng, BATCH)
        params, opt_state, loss = step(params, opt_state, *batch)
        want_losses.append(float(loss))
    jax_model.params = params

    run = tt.train(HP, steps=10, batch=BATCH, lr=3e-3, model=port_model,
                   log=None)
    assert run.model is port_model and run.step_clock == "host"
    assert len(run.step_ms) == 10
    np.testing.assert_allclose(run.losses, want_losses, rtol=1e-4)
    assert want_losses[-1] < want_losses[0]
    assert not any(p.requires_grad or p.grad is not None
                   for p in port_model.module.parameters())
    for text in SENTENCES:
        base = ttag.strip_diacritics(text)
        np.testing.assert_allclose(port_model.logits(base).numpy(),
                                   _jax_logits(params, base, jax_model),
                                   atol=1e-4, rtol=0)
        assert port_model.diacritize(text) == jax_model.diacritize(text)


# -- (f) files, both ways -------------------------------------------------------------------

def test_port_save_loads_in_the_reference(tmp_path):
    port_model = ttag.TashkeelModel.random(HP, seed=3, device="cpu")
    port_model.save(tmp_path / "port.npz")
    jax_model = jtag.TashkeelModel.from_path(tmp_path / "port.npz")
    assert jax_model.hp == JHP and jax_model.vocab == port_model.vocab
    for text in SENTENCES:
        base = ttag.strip_diacritics(text)
        np.testing.assert_allclose(
            port_model.logits(base).numpy(),
            _jax_logits(jax_model.params, base, jax_model), atol=1e-5,
            rtol=0)
        assert port_model.diacritize(text) == jax_model.diacritize(text)


def test_port_save_writes_what_the_reference_writes(tmp_path):
    tree = _jax_tree(seed=2)
    jax_model, port_model = _models(tree)
    jax_model.save(tmp_path / "jax.npz")
    port_model.save(tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as want, \
            np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        assert bytes(got["__meta__"]) == bytes(want["__meta__"])
        assert got["__meta__"].dtype == want["__meta__"].dtype == np.uint8
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # and the port reads what the reference writes
    back = ttag.TashkeelModel.from_path(tmp_path / "jax.npz", device="cpu")
    got = flatten_params(params_to_numpy(back.module))
    for key, value in _flat(tree).items():
        np.testing.assert_array_equal(got[key], value)


def test_port_save_round_trips_bit_for_bit(tmp_path):
    model = ttag.TashkeelModel.random(HP, seed=4, device="cpu")
    tt.train(HP, steps=2, batch=4, model=model, log=None)  # off the init
    model.save(tmp_path / "a.npz")
    back = ttag.TashkeelModel.from_path(tmp_path / "a.npz", device="cpu")
    assert back.hp == model.hp and back.vocab == model.vocab
    want = flatten_params(params_to_numpy(model.module))
    got = flatten_params(params_to_numpy(back.module))
    assert list(got) == list(want)
    for key in want:
        assert got[key].tobytes() == want[key].tobytes(), key
    for text in SENTENCES:
        assert torch.equal(back.logits(text), model.logits(text))


# -- (g) main -------------------------------------------------------------------------------

def test_main_under_the_gate_writes_nothing(tmp_path, capsys):
    out = tmp_path / "trained.npz"
    assert tt.main(["--steps", "3", "--device", "cpu", "--out",
                    str(out)]) == 1
    assert not out.exists() and not list(tmp_path.iterdir())
    printed = capsys.readouterr().out
    assert "step 0: loss" in printed and "step 2: loss" in printed
    assert "FAILED" in printed


def test_main_refuses_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "trained.npz"
    with pytest.raises(OperationError):
        tt.main(["--steps", "3", "--out", str(out)])
    assert not out.exists()
    assert tt.DEFAULT_OUT.parts[-3:-1] == ("build", "sonata_tpu_torch")


# -- the gold corpus --------------------------------------------------------------------------

def test_gold_scores_equal_the_eval_tools(eval_tool):
    gold = [ln.strip() for ln in
            (REPO / "tools" / "tashkeel_gold.txt").read_text(
                encoding="utf-8").splitlines() if ln.strip()]
    jax_bundled = jtag.TashkeelModel.from_path(
        REPO / "sonata_tpu" / "data" / "tashkeel_default.npz")
    port_bundled = ttag.TashkeelModel.from_path(
        REPO / "sonata_tpu_torch" / "data" / "tashkeel_default.npz",
        device="cpu")
    systems = {"rules": (trules.diacritize, jrules.diacritize),
               "bundled_tagger": (port_bundled.diacritize,
                                  jax_bundled.diacritize)}
    expected = json.loads((REPO / "TASHKEEL_EVAL.json").read_text(
        encoding="utf-8"))["systems"]
    for name, (port_fn, jax_fn) in systems.items():
        want_totals: dict = {}
        for line in gold:
            bare = jtag.strip_diacritics(line)
            assert tt.split_letters(line) == eval_tool.split_letters(line)
            want = eval_tool.score(jax_fn(bare), line)
            assert tt.score(port_fn(bare), line) == want, line
            eval_tool.accumulate(want_totals, want)
        report = tt.gold_report(port_fn, gold)
        assert report["letters"] == want_totals["letters"]
        assert report["words"] == want_totals["finals"]
        for key in ("der", "der_no_case_endings", "case_ending_accuracy"):
            assert round(report[key], 4) == expected[name][key], (name, key)
