"""Train the Arabic tagger (:mod:`.tashkeel`) with PyTorch, on the card.

The counterpart of the JAX package's ``tools/train_tashkeel.py``: the
tagger learns to reproduce the rule engine
(:mod:`sonata_tpu_torch.text.tashkeel_rules`) on random sentences, with
Adam at 3e-3 on a masked cross-entropy, 400 steps of batch 32 at the
training bucket ``T = 48`` by default, and a held-out class-accuracy gate
of 0.97 before anything is written.  The batches are the tool's: the same
``random.Random`` gives the same arrays.

It also carries the gold-corpus scoring of ``tools/eval_tashkeel.py``
(:func:`score`, :func:`gold_report`): diacritic error rate with and
without case endings, and case-ending accuracy.

Run::

    python -m sonata_tpu_torch.models.tashkeel_train            # on the card
    python -m sonata_tpu_torch.models.tashkeel_train --device cpu

``--steps`` (default ``TASHKEEL_STEPS`` or 400), ``--seed`` (the initial
weights; the batches always come from ``random.Random(0)``) and ``--out``
(default ``build/sonata_tpu_torch/tashkeel_trained.npz``).  It exits with
1 and writes nothing when the held-out accuracy stays under the gate.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import sys
import time
import unicodedata
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..text import tashkeel_rules as rules
from .tashkeel import (
    DIACRITICS,
    TashkeelHyperParams,
    TashkeelModel,
    apply_tashkeel,
    strip_diacritics,
)

#: the bundled tagger's width (``__meta__`` of ``data/tashkeel_default.npz``)
BUNDLED_HP = TashkeelHyperParams(hidden=96, filter=256, n_heads=2,
                                 n_layers=2, kernel=3, window=8)
LETTERS = sorted(rules.ARABIC_LETTERS)
# a sprinkling of real common words keeps the distribution non-uniform
COMMON = ["السلام", "عليكم", "مرحبا", "العالم", "كتاب", "مدرسة", "الشمس",
          "القمر", "بيت", "ولد", "بنت", "يوم", "ليل", "صباح", "مساء",
          "الله", "محمد", "عربي", "لغة", "كلمة", "جملة", "صوت", "كلام"]
T = 48  # training sequence bucket
#: the held-out accuracy a trained tagger must reach to be written
ACCURACY_GATE = 0.97
DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "sonata_tpu_torch" / "tashkeel_trained.npz")
_CLASS_OF = {d: i for i, d in enumerate(DIACRITICS)}
_DIACRITIC_CHARS = set("".join(DIACRITICS))


# ---------------------------------------------------------------------------
# data: the tool's sentences and batches
# ---------------------------------------------------------------------------

def random_sentence(rng: random.Random) -> str:
    words = []
    for _ in range(rng.randint(2, 5)):
        if rng.random() < 0.35:
            words.append(rng.choice(COMMON))
        else:
            n = rng.randint(2, 6)
            w = "".join(rng.choice(LETTERS) for _ in range(n))
            if rng.random() < 0.25:
                w = "ال" + w
            words.append(w)
    return " ".join(words)


def encode_pair(model: TashkeelModel, plain: str, marked: str):
    """(ids, classes) for one sentence; classes index DIACRITICS."""
    ids, classes = [], []
    i = 0
    for ch in plain:
        ids.append(model._char_to_id.get(ch, 0))
        # collect the diacritic run following this char in `marked`
        if marked[i] != ch:
            raise ValueError(f"{marked!r} does not mark {plain!r} at {i}")
        i += 1
        run = ""
        while i < len(marked) and marked[i] in _DIACRITIC_CHARS:
            run += marked[i]
            i += 1
        classes.append(_CLASS_OF.get(run, 0))
    return ids, classes


def make_batch(model: TashkeelModel, rng: random.Random, batch: int):
    """``(ids, classes, mask, lengths)`` of ``batch`` random sentences
    labelled by the rule engine: ``[batch, T]`` int32, int32, float32 and
    ``[batch]`` int32, on the model's device."""
    xs = np.zeros((batch, T), np.int32)
    ys = np.zeros((batch, T), np.int32)
    mask = np.zeros((batch, T), np.float32)
    lens = np.zeros((batch,), np.int32)
    for b in range(batch):
        s = random_sentence(rng)[:T]
        ids, classes = encode_pair(model, s, rules.diacritize(s))
        n = len(ids)
        xs[b, :n], ys[b, :n] = ids, classes
        mask[b, :n] = 1.0
        lens[b] = n
    return tuple(torch.from_numpy(a).to(model.device)
                 for a in (xs, ys, mask, lens))


# ---------------------------------------------------------------------------
# loss, gradients, optimiser
# ---------------------------------------------------------------------------

def masked_cross_entropy(logits, classes, mask):
    """optax's ``softmax_cross_entropy_with_integer_labels``, summed over
    the unmasked positions and divided by ``max(mask.sum(), 1)``."""
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         classes.reshape(-1).long(), reduction="none")
    ce = ce.reshape(classes.shape)
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def batch_loss(tagger, xs, ys, mask, lens):
    return masked_cross_entropy(apply_tashkeel(tagger, xs, lens), ys, mask)


def loss_and_grads(tagger, xs, ys, mask, lens):
    """The loss of one batch and the gradient of every parameter, by name
    (``named_parameters``); the tagger's parameters stay frozen."""
    names, params = zip(*tagger.named_parameters())
    for p in params:
        p.requires_grad_(True)
    try:
        loss = batch_loss(tagger, xs, ys, mask, lens)
        grads = torch.autograd.grad(loss, params)
    finally:
        for p in params:
            p.requires_grad_(False)
    return loss.detach(), dict(zip(names, grads))


def make_optimizer(params, lr: float = 3e-3) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainRun:
    """One training run: the trained model, each step's loss, and where
    the wall time went.  ``step_ms`` is each step's time on the card (CUDA
    events around its queued work, gaps inside the step included) or, on
    the CPU, on the host clock; ``batch_s`` is host time making batches."""
    model: TashkeelModel
    losses: list
    wall_s: float
    batch_s: float
    step_ms: list
    step_clock: str


def train(hp: TashkeelHyperParams = BUNDLED_HP, *, steps: int = 400,
          batch: int = 32, lr: float = 3e-3, seed: int = 0, device=None,
          model: Optional[TashkeelModel] = None,
          log: Optional[Callable[[str], None]] = print) -> TrainRun:
    """Train a tagger on the rule engine's labels.

    Starts from ``model`` (trained in place) or from
    ``TashkeelModel.random(hp, seed, device=device)``.  The batches come
    from ``random.Random(0)``, as the tool's do.  ``log`` gets the loss at
    steps 0, 50, … and the last step."""
    if model is None:
        model = TashkeelModel.random(hp, seed=seed, device=device)
    tagger = model.module
    params = list(tagger.parameters())
    on_card = model.device.type == "cuda"
    rng = random.Random(0)
    losses, step_ms, events = [], [], []
    batch_s = 0.0
    for p in params:
        p.requires_grad_(True)
    try:
        opt = make_optimizer(params, lr)
        t_wall = time.perf_counter()
        for it in range(steps):
            t0 = time.perf_counter()
            xs, ys, mask, lens = make_batch(model, rng, batch)
            t1 = time.perf_counter()
            batch_s += t1 - t0
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            opt.zero_grad(set_to_none=True)
            loss = batch_loss(tagger, xs, ys, mask, lens)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if on_card:
                end.record()
                events.append((start, end))
            else:
                step_ms.append((time.perf_counter() - t1) * 1e3)
            if log is not None and (it % 50 == 0 or it == steps - 1):
                log(f"step {it}: loss {float(losses[-1]):.4f}")
        if on_card:
            torch.cuda.synchronize(model.device)
        wall_s = time.perf_counter() - t_wall
    finally:
        for p in params:
            p.requires_grad_(False)
            p.grad = None
    step_ms += [s.elapsed_time(e) for s, e in events]
    return TrainRun(model=model,
                    losses=torch.stack(losses).cpu().tolist() if losses
                    else [],
                    wall_s=wall_s, batch_s=batch_s, step_ms=step_ms,
                    step_clock="cuda_events" if on_card else "host")


def held_out_sentences(n: int = 50, seed: int = 999) -> list:
    rng = random.Random(seed)
    return [random_sentence(rng)[:T] for _ in range(n)]


def held_out_accuracy(model: TashkeelModel, n: int = 50,
                      seed: int = 999) -> float:
    """Exact-class accuracy against the rule engine on ``n`` held-out
    sentences, compared class by class through a re-encode (the tool's)."""
    correct = total = 0
    for s in held_out_sentences(n, seed):
        golden = rules.diacritize(s)
        got = model.diacritize(s)
        _, want = encode_pair(model, s, golden)
        _, have = encode_pair(model, strip_diacritics(got), got)
        correct += sum(int(a == b) for a, b in zip(want, have))
        total += len(want)
    return correct / max(total, 1)


# ---------------------------------------------------------------------------
# the gold corpus (tools/eval_tashkeel.py)
# ---------------------------------------------------------------------------

HARAKAT = set("ًٌٍَُِّْٰ")


def split_letters(text: str) -> list[tuple[str, str]]:
    """[(base letter, attached diacritic string)] for Arabic letters."""
    out: list[tuple[str, str]] = []
    for ch in text:
        if ch in HARAKAT:
            if out:
                base, marks = out[-1]
                # normalized order: shadda first, then the vowel
                out[-1] = (base, "".join(sorted(marks + ch,
                                                key=lambda c: c != "ّ")))
        elif unicodedata.category(ch).startswith("L"):
            out.append((ch, ""))
        else:
            out.append((ch, ""))  # punctuation/space: alignment anchor
    return out


def word_spans(letters: list[tuple[str, str]]) -> list[tuple[int, int]]:
    spans, start = [], None
    for i, (base, _m) in enumerate(letters):
        is_arabic = "؀" <= base <= "ۿ"
        if is_arabic and start is None:
            start = i
        elif not is_arabic and start is not None:
            spans.append((start, i))
            start = None
    if start is not None:
        spans.append((start, len(letters)))
    return spans


def score(pred: str, gold: str) -> dict:
    pl, gl = split_letters(pred), split_letters(gold)
    if [b for b, _ in pl] != [b for b, _ in gl]:
        raise ValueError("base-letter skeletons diverge:\n"
                         f"  pred: {pred}\n  gold: {gold}")
    spans = word_spans(gl)
    finals = {hi - 1 for _lo, hi in spans}
    stats = {"letters": 0, "errors": 0, "letters_no_ce": 0,
             "errors_no_ce": 0, "finals": 0, "final_errors": 0}
    for i, ((_b, pm), (_b2, gm)) in enumerate(zip(pl, gl)):
        if not ("؀" <= _b <= "ۿ"):
            continue
        stats["letters"] += 1
        err = pm != gm
        stats["errors"] += err
        if i in finals:
            stats["finals"] += 1
            stats["final_errors"] += err
        else:
            stats["letters_no_ce"] += 1
            stats["errors_no_ce"] += err
    return stats


def accumulate(total: dict, s: dict) -> None:
    for k, v in s.items():
        total[k] = total.get(k, 0) + v


def gold_report(diacritize: Callable[[str], str], gold_lines) -> dict:
    """One system's scores over fully vocalized gold sentences, as
    ``tools/eval_tashkeel.py`` reports them (unrounded)."""
    totals: dict = {}
    for gold in gold_lines:
        accumulate(totals, score(diacritize(strip_diacritics(gold)), gold))
    return {"der": totals["errors"] / totals["letters"],
            "der_no_case_endings": (totals["errors_no_ce"]
                                    / totals["letters_no_ce"]),
            "case_ending_accuracy": 1 - (totals["final_errors"]
                                         / totals["finals"]),
            "letters": totals["letters"], "words": totals["finals"]}


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sonata_tpu_torch.models.tashkeel_train",
        description="Train the Arabic tagger at the bundled width on the "
                    "rule engine's labels (on the card unless --device).")
    parser.add_argument("--steps", type=int,
                        default=int(os.environ.get("TASHKEEL_STEPS", 400)))
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA "
                             "device; 'cpu' to train on the CPU)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the initial weights")
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args(argv)

    run = train(BUNDLED_HP, steps=args.steps, seed=args.seed,
                device=args.device)
    model = run.model
    print(f"{args.steps} steps in {run.wall_s:.1f} s on {model.device} "
          f"({run.batch_s:.1f} s making batches)")
    acc = held_out_accuracy(model)
    print(f"held-out class accuracy: {acc:.4f}")
    if acc < ACCURACY_GATE:
        print(f"FAILED: accuracy below {ACCURACY_GATE} — model NOT written")
        return 1
    args.out.parent.mkdir(parents=True, exist_ok=True)
    model.save(args.out)
    print(f"saved {args.out} ({args.out.stat().st_size / 1e6:.2f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
