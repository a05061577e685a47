"""Wire messages for the Sonata gRPC service.

Hand-written against the reference's proto contract
(``crates/frontends/grpc/proto/sonata_grpc.proto``) so existing Sonata gRPC
clients interoperate unchanged: same package (``sonata_grpc``), same service
and method names, same message field numbers and types.  Encoding rides
:mod:`sonata_tpu_torch.utils.protowire` (no protoc plugin in this environment).

A copy of the contract as ``.proto`` source lives in
``proto/sonata_grpc.proto`` for client codegen.
"""

from __future__ import annotations

from ..utils.protowire import Field, Message

PACKAGE = "sonata_grpc"
SERVICE = "sonata_grpc"


# enums (proto: SynthesisMode, Quality)
class SynthesisMode:
    UNSPECIFIED = 0
    LAZY = 1
    PARALLEL = 2
    BATCHED = 3


class Quality:
    UNSPECIFIED = 0
    X_LOW = 1
    LOW = 2
    MEDIUM = 3
    HIGH = 4

    _FROM_STR = {"x_low": X_LOW, "low": LOW, "medium": MEDIUM, "high": HIGH}

    @classmethod
    def from_string(cls, s) -> int:
        return cls._FROM_STR.get((s or "").lower(), cls.UNSPECIFIED)


class Empty(Message):
    FIELDS = {}


class Version(Message):
    FIELDS = {"version": Field(1, "string")}


class VoiceIdentifier(Message):
    FIELDS = {"voice_id": Field(1, "string")}


class VoicePath(Message):
    FIELDS = {"config_path": Field(1, "string")}


class SynthesisOptions(Message):
    FIELDS = {
        "speaker": Field(1, "string"),
        "length_scale": Field(2, "float"),
        "noise_scale": Field(3, "float"),
        "noise_w": Field(4, "float"),
    }


class AudioInfo(Message):
    FIELDS = {
        "sample_rate": Field(1, "uint32"),
        "num_channels": Field(2, "uint32"),
        "sample_width": Field(3, "uint32"),
    }


class VoiceInfo(Message):
    FIELDS = {
        "voice_id": Field(1, "string"),
        "synth_options": Field(2, "message", SynthesisOptions),
        "speakers": Field(3, "map_int64_string"),
        "audio": Field(4, "message", AudioInfo),
        "language": Field(5, "string"),
        "quality": Field(6, "enum"),
        "supports_streaming_output": Field(7, "bool"),
    }


class SpeechArgs(Message):
    FIELDS = {
        "rate": Field(1, "uint32"),
        "volume": Field(2, "uint32"),
        "pitch": Field(3, "uint32"),
        "appended_silence_ms": Field(4, "uint32"),
    }


class Utterance(Message):
    FIELDS = {
        "voice_id": Field(1, "string"),
        "text": Field(2, "string"),
        "speech_args": Field(3, "message", SpeechArgs),
        "synthesis_mode": Field(4, "enum"),
        # sonata-tpu extensions: per-request realtime chunk scheduling
        # (0/absent ⇒ the reference's hardcoded 55/3)
        "realtime_chunk_size": Field(5, "uint32"),
        "realtime_chunk_padding": Field(6, "uint32"),
    }


class VoiceList(Message):
    """sonata-tpu extension: catalog of loaded voices."""

    FIELDS = {
        "voices": Field(1, "message", VoiceInfo, repeated=True),
    }


class VoiceSynthesisOptions(Message):
    FIELDS = {
        "voice_id": Field(1, "string"),
        "synthesis_options": Field(2, "message", SynthesisOptions),
    }


class SynthesisResult(Message):
    FIELDS = {
        "wav_samples": Field(1, "bytes"),
        "rtf": Field(2, "float"),
    }


class WaveSamples(Message):
    FIELDS = {
        "wav_samples": Field(1, "bytes"),
    }


class HealthStatus(Message):
    """sonata-tpu extension: liveness/readiness over the serving protocol
    (mirrors the HTTP /healthz + /readyz plane, ``serving/health.py``)."""

    FIELDS = {
        "live": Field(1, "bool"),
        "ready": Field(2, "bool"),
        "reason": Field(3, "string"),
        "version": Field(4, "string"),
        # stable node identity (SONATA_NODE_ID, default host:port) so a
        # fleet router health-checking over gRPC names the backend
        "node_id": Field(5, "string"),
    }
