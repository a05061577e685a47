"""Piper voice configuration: JSON schema, synthesis params, phoneme-id
encoding, and VITS architecture hyper-parameters.

Parity targets (reference ``crates/sonata/models/piper/src/lib.rs``):

- ``ModelConfig`` fields mirror the Piper ``*.json`` sidecar the reference
  deserializes (``:144-158``): audio.sample_rate/quality, num_speakers,
  speaker_id_map, streaming flag, espeak.voice, inference scales,
  num_symbols, phoneme_id_map.
- ``SynthesisConfig`` mirrors ``PiperSynthesisConfig{speaker, noise_scale,
  length_scale, noise_w}`` (``:161-166``), seeded from the file (``:54-59``)
  and mutable at runtime behind a lock (``:215-231``).
- ``phonemes_to_ids`` reproduces the interleaved-pad encoding exactly
  (``:232-250``): ``[bos]``, then ``[id, pad]`` per IPA char, then
  ``[eos]``; unknown chars silently dropped (``:243``); BOS/EOS/PAD are the
  characters ``^ $ _`` resolved through the map (``:20-22,173-179``).

The architecture section has no reference counterpart — the reference runs a
black-box ONNX graph; we instantiate the graph natively, so the dims live in
:class:`VitsHyperParams` (quality presets match Piper's training configs).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path
from typing import Optional, Union

from ..core import FailedToLoadResource

BOS_CHAR = "^"
EOS_CHAR = "$"
PAD_CHAR = "_"


@dataclasses.dataclass
class SynthesisConfig:
    """Runtime-tunable synthesis parameters (``piper/src/lib.rs:161-166``)."""

    speaker: Optional[tuple[str, int]] = None  # (name, sid)
    noise_scale: float = 0.667
    length_scale: float = 1.0
    noise_w: float = 0.8

    def copy(self) -> "SynthesisConfig":
        return dataclasses.replace(self)


@dataclasses.dataclass(frozen=True)
class VitsHyperParams:
    """VITS graph dimensions.  Defaults = Piper medium/high quality
    (22.05 kHz, hop 256)."""

    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    attn_window: int = 4
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5),
    )
    upsample_rates: tuple[int, ...] = (8, 8, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: tuple[int, ...] = (16, 16, 4, 4)
    gin_channels: int = 512
    # stochastic duration predictor
    dp_filter_channels: int = 192
    dp_kernel_size: int = 3
    dp_n_flows: int = 4
    dp_num_bins: int = 10
    dp_tail_bound: float = 5.0
    # flow
    flow_n_layers: int = 4
    flow_wn_layers: int = 4
    flow_kernel_size: int = 5

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.upsample_rates:
            h *= r
        return h


# Piper quality presets.  "x_low" voices are 16 kHz with a slimmer decoder;
# low/medium/high share the 22.05 kHz geometry (quality differs by training).
QUALITY_PRESETS: dict[str, dict] = {
    "x_low": dict(
        hidden_channels=96, inter_channels=96, filter_channels=384,
        upsample_initial_channel=256,
    ),
    "low": {},
    "medium": {},
    "high": {},
}


@dataclasses.dataclass
class ModelConfig:
    """Parsed Piper voice config (``piper/src/lib.rs:144-158``)."""

    sample_rate: int
    quality: Optional[str]
    num_speakers: int
    speaker_id_map: dict[str, int]
    streaming: bool
    espeak_voice: str
    num_symbols: int
    phoneme_id_map: dict[str, list[int]]
    inference: SynthesisConfig
    hyper: VitsHyperParams
    language: Optional[str] = None
    path: Optional[Path] = None

    @classmethod
    def from_dict(cls, d: dict, path: Optional[Path] = None) -> "ModelConfig":
        audio = d.get("audio", {})
        espeak = d.get("espeak", {})
        inference = d.get("inference", {})
        quality = audio.get("quality")
        lang = d.get("language")
        if isinstance(lang, dict):
            lang = lang.get("code") or lang.get("family")
        preset = dict(QUALITY_PRESETS.get(quality or "", {}))
        preset.update(d.get("model", {}))  # our extension: explicit dims
        hyper = VitsHyperParams(**preset)
        sc = SynthesisConfig(
            noise_scale=float(inference.get("noise_scale", 0.667)),
            length_scale=float(inference.get("length_scale", 1.0)),
            noise_w=float(inference.get("noise_w", 0.8)),
        )
        return cls(
            sample_rate=int(audio.get("sample_rate", 22050)),
            quality=quality,
            num_speakers=int(d.get("num_speakers", 1)),
            speaker_id_map={str(k): int(v)
                            for k, v in (d.get("speaker_id_map") or {}).items()},
            streaming=bool(d.get("streaming", False)),
            espeak_voice=str(espeak.get("voice", "en-us")),
            num_symbols=int(d.get("num_symbols", 256)),
            phoneme_id_map={str(k): [int(i) for i in v]
                            for k, v in (d.get("phoneme_id_map") or {}).items()},
            inference=sc,
            hyper=hyper,
            language=lang,
            path=path,
        )

    @classmethod
    def from_path(cls, config_path: Union[str, Path]) -> "ModelConfig":
        p = Path(config_path)
        try:
            data = json.loads(p.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError) as e:
            raise FailedToLoadResource(f"cannot load voice config {p}: {e}") from e
        return cls.from_dict(data, path=p)

    # -- speaker helpers (reference core/src/lib.rs:95-113) -----------------
    def reversed_speaker_map(self) -> dict[int, str]:
        return {v: k for k, v in self.speaker_id_map.items()}

    # -- phoneme-id encoding (piper/src/lib.rs:232-250) ---------------------
    def phonemes_to_ids(self, phonemes: str) -> list[int]:
        ids, _dropped = self.phonemes_to_ids_diag(phonemes)
        return ids

    def phonemes_to_ids_diag(
            self, phonemes: str) -> tuple[list[int], list[str]]:
        """Encode, also returning the symbols the map could not encode.

        The reference drops unknown symbols silently (``:243``) — for a
        G2P-produced string that can delete load-bearing phonemes (e.g. a
        tone letter the voice's map lacks), so the drop list is surfaced
        here and aggregated by ``SpeechSynthesizer.phonemize_text``
        diagnostics; encoding behavior itself stays reference-identical.
        """
        id_map = self.phoneme_id_map
        pad = id_map.get(PAD_CHAR, [0])
        ids: list[int] = list(id_map.get(BOS_CHAR, [1]))
        dropped: list[str] = []
        for ch in phonemes:
            mapped = id_map.get(ch)
            if not mapped:
                # unknown symbol — or a present-but-EMPTY map entry in a
                # user-supplied config, which must degrade like unknown
                # rather than crash the encode path: dropped (:243)
                dropped.append(ch)
                continue
            # multi-id map entries contribute only their FIRST id — the
            # reference pushes ``id.first()`` per phoneme
            # (piper/src/lib.rs phonemes_to_input_ids), so extending with
            # the whole list would desynchronize sequences (and their
            # interleaved pads) from what the voice was trained on
            ids.append(mapped[0])
            ids.extend(pad)  # interleaved pad after every phoneme
        ids.extend(id_map.get(EOS_CHAR, [2]))
        return ids, dropped


def default_phoneme_id_map() -> dict[str, list[int]]:
    """The vendored piper-phonemize symbol table for voices created
    without a Piper JSON (tests, randomly-initialized voices).

    Ids 0-153 reproduce piper-phonemize's ``DEFAULT_PHONEME_ID_MAP``
    (``src/phoneme_ids.cpp``, a public ~154-entry constant) exactly, so
    phoneme-id sequences computed against this map are bit-identical to
    what a Piper voice trained with the default map expects.  Ids 154+
    are a documented extension block: IPA the hermetic G2P packs emit
    that the upstream table cannot encode (Chao tone letters carrying
    the entire zh/vi tone system, the glottalized-tone mark, secondary
    articulations, and combining diacritics).  A voice loaded from its
    own config JSON never sees this map.  Structural conventions:
    ``_`` pad=0, ``^`` bos=1, ``$`` eos=2.
    """
    upstream = (
        "_", "^", "$", " ", "!", "'", "(", ")", ",", "-", ".", ":",
        ";", "?",
        "a", "b", "c", "d", "e", "f", "h", "i", "j", "k", "l", "m",
        "n", "o", "p", "q", "r", "s", "t", "u", "v", "w", "x", "y",
        "z",
        "\u00e6", "\u00e7", "\u00f0", "\u00f8", "\u0127", "\u014b",
        "\u0153",
        "\u01c0", "\u01c1", "\u01c2", "\u01c3",
        "\u0250", "\u0251", "\u0252", "\u0253", "\u0254", "\u0255",
        "\u0256", "\u0257", "\u0258", "\u0259", "\u025a", "\u025b",
        "\u025c", "\u025e", "\u025f", "\u0260", "\u0261", "\u0262",
        "\u0263", "\u0264", "\u0265", "\u0266", "\u0267", "\u0268",
        "\u026a", "\u026b", "\u026c", "\u026d", "\u026e", "\u026f",
        "\u0270", "\u0271", "\u0272", "\u0273", "\u0274", "\u0275",
        "\u0276", "\u0278", "\u0279", "\u027a", "\u027b", "\u027d",
        "\u027e", "\u0280", "\u0281", "\u0282", "\u0283", "\u0284",
        "\u0288", "\u0289", "\u028a", "\u028b", "\u028c", "\u028d",
        "\u028e", "\u028f", "\u0290", "\u0291", "\u0292", "\u0294",
        "\u0295", "\u0298", "\u0299", "\u029b", "\u029c", "\u029d",
        "\u029f", "\u02a1", "\u02a2", "\u02b2",
        "\u02c8", "\u02cc", "\u02d0", "\u02d1", "\u02de",
        "\u03b2", "\u03b8", "\u03c7", "\u1d7b", "\u2c71",
        "0", "1", "2", "3", "4", "5", "6", "7", "8", "9",
        "\u0327", "\u0303", "\u032a", "\u032f", "\u0329",
        "\u02b0", "\u02e4", "\u03b5", "\u2193", "#", '"', "\u2191",
        "\u033a", "\u033b",
    )
    # extension block (ids 154+): hermetic-pack symbols upstream lacks
    extension = (
        "\u02e5", "\u02e6", "\u02e7", "\u02e8", "\u02e9",  # Chao tones
        "\u02c0",                                   # glottalized tone (vi)
        "\u02b7", "\u02bc",                        # labialized, ejective
        "\u02b1",                       # breathy-voice aspiration (ne/hi)
        "\u0325", "\u030a", "\u0306", "\u031d",  # voiceless/ring/breve/
        "\u0320", "\u0339", "\u031e", "\u0308",  # raised + retr/round/
        "\u032c",                                   # lowered/central/voiced
    )
    symbols = upstream + extension
    assert len(symbols) == len(set(symbols))
    return {s: [i] for i, s in enumerate(symbols)}
