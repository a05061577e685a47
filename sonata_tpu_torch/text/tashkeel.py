"""Arabic diacritization (tashkeel) stage.

In the reference, ``libtashkeel`` (a Rust crate running its own bundled ONNX
seq-tagging model) is auto-enabled whenever the voice's eSpeak language is
``ar`` (``crates/sonata/models/piper/src/lib.rs:63-77,253-258,270-281``).

The port's copy of the JAX package's engine.  The same rule applies (see
``PiperVoice.phonemize_text``), and the engine resolves in the same order:
an explicit model artifact (CBHG ``.onnx`` or native ``.npz`` tagger via
``SONATA_TASHKEEL_MODEL``; the literal value ``bundled`` selects the port's
own copy of the bundled tagger), falling back to the heuristic rule engine
(:mod:`.tashkeel_rules`), which is also the default.  A model runs on the
engine's device (``None`` → the GPU, as a voice resolves it); the rule
engine needs none.
"""

from __future__ import annotations

import logging
import os
import threading
from pathlib import Path
from typing import Optional

from ..core import FailedToLoadResource, OperationError

#: the port's own copy of the bundled tagger
BUNDLED_MODEL = Path(__file__).resolve().parent.parent / "data" / \
    "tashkeel_default.npz"


class TashkeelEngine:
    """Diacritize Arabic text.  Falls back to the heuristic rule engine
    when no model is loaded (non-Arabic text passes through either way)."""

    def __init__(self, model_path: Optional[str] = None, *, device=None):
        self._model = None
        self._lock = threading.Lock()
        if model_path is None:
            return
        if str(model_path).endswith(".ort"):
            raise FailedToLoadResource(
                f"{model_path}: ORT-format models are flatbuffers, "
                "not ONNX protobuf — convert to .onnx "
                "(python -m onnxruntime.tools.convert_onnx_models_"
                "to_ort reverses with the original .onnx kept)")
        if str(model_path).endswith(".onnx"):
            # libtashkeel-family CBHG artifact (ONNX export)
            from ..models.tashkeel_cbhg import TashkeelCBHGModel

            self._model = TashkeelCBHGModel.from_path(model_path,
                                                      device=device)
        else:
            from ..models.tashkeel import TashkeelModel

            self._model = TashkeelModel.from_path(model_path, device=device)

    @property
    def has_model(self) -> bool:
        return self._model is not None

    @property
    def model(self):
        """The loaded diacritizer model, or None for the rule engine."""
        return self._model

    def diacritize(self, text: str) -> str:
        if self._model is None:
            # no model: heuristic rules rather than an identity pass, so
            # the auto-enabled Arabic chain always diacritizes something
            from . import tashkeel_rules

            return tashkeel_rules.diacritize(text)
        with self._lock:
            return self._model.diacritize(text)


_ENGINES: dict[str, TashkeelEngine] = {}
_ENGINES_LOCK = threading.Lock()


def get_default_engine(device=None) -> TashkeelEngine:
    """Lazy module-global engine, one per ``device`` (parity: the Python
    frontend's lazy global tashkeel instance,
    ``crates/frontends/python/src/lib.rs:17-18``).

    ``SONATA_TASHKEEL_MODEL`` names the model artifact (`.onnx` CBHG export
    or `.npz` native tagger), or the literal ``bundled`` for the bundled
    tagger (:data:`BUNDLED_MODEL`).  Unset ⇒ the heuristic rule engine,
    which the JAX package's gold-corpus eval (``TASHKEEL_EVAL.json``)
    scores ahead of the bundled tagger.  An explicit model that cannot be
    read raises; an unreadable or missing bundled file falls back to the
    rules with a warning.
    """
    key = str(device)
    with _ENGINES_LOCK:
        engine = _ENGINES.get(key)
        if engine is not None:
            return engine
        log = logging.getLogger("sonata.tashkeel")
        path = os.environ.get("SONATA_TASHKEEL_MODEL") or None
        bundled = path == "bundled"
        if bundled:
            if BUNDLED_MODEL.exists():
                path = str(BUNDLED_MODEL)
            else:
                # the operator asked for the bundled tagger by name; a
                # missing file must not pass silently
                log.warning("SONATA_TASHKEEL_MODEL=bundled but %s is "
                            "missing; falling back to the rule engine",
                            BUNDLED_MODEL)
                path = None
        try:
            engine = TashkeelEngine(path, device=device)
        except OperationError:
            raise  # no device to run on is not an unreadable model
        except Exception:
            if not bundled:
                raise  # an explicit model must not be silently ignored
            log.warning("bundled tashkeel model unreadable; falling back "
                        "to the rule engine", exc_info=True)
            engine = TashkeelEngine()
        _ENGINES[key] = engine
        return engine
