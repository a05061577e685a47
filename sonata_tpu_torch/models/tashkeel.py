"""Tashkeel: Arabic diacritization as a character tagger, on PyTorch.

Port of ``sonata_tpu/models/tashkeel.py``.  The reference delegates this to
the ``libtashkeel`` Rust crate whenever a voice's eSpeak language is ``ar``
(``crates/sonata/models/piper/src/lib.rs:63-77,270-281``); the JAX package
runs it as a character embedding → relative-position transformer encoder →
per-character diacritic classifier, built from the VITS text encoder's
blocks.  Here the same blocks come from :mod:`.modules`, in a
:class:`TashkeelTagger` module whose parameters are the JAX package's tree
(``emb``, ``encoder``, ``proj``) carried across by :func:`tagger_from_numpy`,
or drawn by :func:`init_tashkeel`.  Its parameters are frozen: only the
trainer (:mod:`.tashkeel_train`) makes them trainable, for its own run.

The tagger predicts one of 16 diacritic combinations (haraka ± shadda,
tanwin forms, sukun, or none) to insert after each base character.

File format: ``.npz`` of the flat parameter tree plus a ``__meta__`` JSON
blob (vocab + hyperparameters), as the JAX package's ``TashkeelModel.save``
writes it: :meth:`TashkeelModel.save` writes it, and
:meth:`TashkeelModel.from_path` reads it.
"""

from __future__ import annotations

import dataclasses
import json
import zipfile
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..core import FailedToLoadResource
from ..device import resolve_device
from ..utils.buckets import bucket_for, pad_to
from . import modules as m
from .serialization import flatten_params, unflatten_params
from .vits import sequence_mask
from .weights import ParamTree, _Init, fill_tree, params_to_numpy

# diacritic classes: index 0 = none; combinations a trained model can emit
DIACRITICS = [
    "",        # none
    "َ",  # fatha
    "ُ",  # damma
    "ِ",  # kasra
    "ْ",  # sukun
    "ً",  # fathatan
    "ٌ",  # dammatan
    "ٍ",  # kasratan
    "ّ",          # shadda
    "َّ",    # shadda + fatha
    "ُّ",    # shadda + damma
    "ِّ",    # shadda + kasra
    "ًّ",    # shadda + fathatan
    "ٌّ",    # shadda + dammatan
    "ٍّ",    # shadda + kasratan
    "ـ",  # tatweel (rare; kept for class-count parity)
]
_DIACRITIC_CHARS = set("".join(DIACRITICS))

_DEFAULT_VOCAB = list(
    " !\"#$%&'()*+,-./0123456789:;<=>?@[]^_`{|}~"
    "ءآأؤإئابةتثجحخدذرزسشصضطظعغفقكلمنهوىي"
    "،؛؟"
)


@dataclasses.dataclass(frozen=True)
class TashkeelHyperParams:
    hidden: int = 128
    filter: int = 512
    n_heads: int = 4
    n_layers: int = 3
    kernel: int = 3
    window: int = 16


def init_tashkeel(hp: TashkeelHyperParams, n_vocab: int, *,
                  generator: torch.Generator) -> dict:
    """A tagger tree (numpy leaves) with the keys, shapes, dtypes and
    distributions of the reference's ``init_tashkeel``: ``emb`` normal with
    std 0.02, the encoder as ``modules.init_transformer``, ``proj`` a
    fan-in uniform 1×1 conv to the 16 classes.  The draws come from
    ``generator``, not the reference's bits."""
    r = _Init(generator)
    return {
        "emb": r.normal((n_vocab, hp.hidden), 0.02),
        "encoder": r.transformer(
            channels=hp.hidden, filter_channels=hp.filter,
            n_heads=hp.n_heads, n_layers=hp.n_layers, kernel=hp.kernel,
            window=hp.window),
        "proj": r.conv(1, hp.hidden, len(DIACRITICS)),
    }


def apply_tashkeel(tagger: "TashkeelTagger", ids, lengths):
    """``ids [B, T]`` → diacritic class logits ``[B, T, n_classes]``.

    Differentiable: the trainer runs it under autograd."""
    hp = tagger.hp
    mask = sequence_mask(lengths, ids.shape[1])
    x = tagger.emb[ids]
    x = m.transformer(x, mask, tagger.encoder, n_heads=hp.n_heads,
                      window=hp.window)
    return m.conv1d(x, tagger.proj) * mask


def strip_diacritics(text: str) -> str:
    return "".join(ch for ch in text if ch not in _DIACRITIC_CHARS)


def tag_characters(base: str, classes, id_to_diacritic) -> str:
    """Insert each Arabic letter's predicted diacritic after it; other
    characters take none."""
    out = []
    for ch, cls in zip(base, classes):
        out.append(ch)
        if "ء" <= ch <= "ي":  # only Arabic letters take diacritics
            out.append(id_to_diacritic[int(cls)])
    return "".join(out)


class TashkeelTagger(ParamTree):
    """The tagger's parameters (``emb``, ``encoder``, ``proj``) and its
    forward pass, :func:`apply_tashkeel`."""

    def __init__(self, hp: TashkeelHyperParams):
        super().__init__()
        self.hp = hp

    def forward(self, ids, lengths):
        """``ids [B, T]`` → diacritic class logits ``[B, T, n_classes]``."""
        return apply_tashkeel(self, ids, lengths)


def tagger_from_numpy(tree: dict, hp: TashkeelHyperParams) -> TashkeelTagger:
    """The JAX package's tagger tree (numpy leaves: ``emb``, ``encoder``,
    ``proj``) → a :class:`TashkeelTagger` on the CPU."""
    return fill_tree(TashkeelTagger(hp), tree).eval()


class TashkeelModel:
    """Inference wrapper with text bucketing, on one device."""

    def __init__(self, params, hp: TashkeelHyperParams,
                 vocab: Optional[list[str]] = None, *, device=None):
        self.device = resolve_device(device)
        self.hp = hp
        if not isinstance(params, TashkeelTagger):
            params = tagger_from_numpy(params, hp)
        self.module = params.to(self.device)
        self.vocab = vocab or list(_DEFAULT_VOCAB)
        self._char_to_id = {c: i + 1 for i, c in enumerate(self.vocab)}  # 0=pad

    @property
    def n_vocab(self) -> int:
        return len(self.vocab) + 1

    @classmethod
    def random(cls, hp: Optional[TashkeelHyperParams] = None, seed: int = 0,
               *, device=None) -> "TashkeelModel":
        """A tagger of random weights (:func:`init_tashkeel`, drawn from
        ``seed``) over the default vocabulary."""
        hp = hp or TashkeelHyperParams()
        vocab = list(_DEFAULT_VOCAB)
        tree = init_tashkeel(hp, len(vocab) + 1,
                             generator=torch.Generator().manual_seed(seed))
        return cls(tree, hp, vocab, device=device)

    @classmethod
    def from_path(cls, path: Union[str, Path], *, device=None
                  ) -> "TashkeelModel":
        try:
            with np.load(Path(path), allow_pickle=False) as data:
                flat = {k: data[k] for k in data.files if k != "__meta__"}
                meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
            raise FailedToLoadResource(
                f"cannot load tashkeel model {path}: {e}") from e
        hp = TashkeelHyperParams(**meta.get("hyper", {}))
        return cls(unflatten_params(flat), hp, meta.get("vocab"),
                   device=device)

    def save(self, path: Union[str, Path]) -> None:
        """Write the reference's format: the flat tree in its layouts
        (float32) and ``__meta__``, the UTF-8 JSON of the hyperparameters
        and the vocabulary, as uint8."""
        flat = flatten_params(params_to_numpy(self.module))
        meta = json.dumps({
            "hyper": dataclasses.asdict(self.hp),
            "vocab": self.vocab,
        }).encode("utf-8")
        np.savez(Path(path), __meta__=np.frombuffer(meta, dtype=np.uint8),
                 **flat)

    @torch.inference_mode()
    def logits(self, base: str) -> torch.Tensor:
        """Class logits ``[len(base), n_classes]`` of undiacritized text,
        run at its text bucket, on the model's device."""
        ids = [self._char_to_id.get(ch, 0) for ch in base]
        t = bucket_for(len(ids))
        ids_t = torch.tensor([pad_to(ids, t)], dtype=torch.long,
                             device=self.device)
        lengths = torch.tensor([len(ids)], dtype=torch.int32,
                               device=self.device)
        return self.module(ids_t, lengths)[0, :len(ids)]

    def diacritize(self, text: str) -> str:
        """Insert predicted diacritics after each Arabic character."""
        base = strip_diacritics(text)
        if not base:
            return text
        classes = self.logits(base).argmax(dim=-1).cpu().numpy()
        return tag_characters(base, classes, DIACRITICS)
