"""PiperVoice on PyTorch: the concrete TTS model behind the ``Model``
protocol.

Port of ``sonata_tpu/models/piper.py``: the batch path, streaming through
the stream coalescers and the iteration loop, and the backend-adaptive
dispatch policy.  The stages are the reference's (``vits.encode_text`` →
``vits.acoustics`` → ``vits.decode_with``), run eagerly on one device:

- **Batch** (:meth:`PiperVoice.speak_batch`): sentences are planned into
  dispatch groups exactly as the reference plans them
  (:meth:`_plan_dispatch_groups`), each group padded to batch and text
  buckets, encoded, run through acoustics at its frame bucket, decoded and
  quantized to peak-scaled int16 on the device (:func:`_quantize_rows`),
  then dequantized on the host.
- **Streaming** (:meth:`PiperVoice.stream_synthesis`): a stream's encode and
  acoustics ride the shared :class:`_StreamStageCoalescer` (stream starts
  that arrive together become one batched dispatch), then its windows of
  the reference's chunk plan ride the active window-decode engine — the
  dispatch-mode :class:`_StreamDecodeCoalescer` or the persistent
  :class:`_IterationStreamDecoder` (``SONATA_BATCH_MODE``) — whose batched
  decodes end in the fused taper + quantize epilogue over ``[B,
  width·hop]`` (the CUDA kernel on the GPU).  A CPU voice with
  ``SONATA_FUSED_EPILOGUE=off`` tapers on the host instead; a GPU voice
  refuses ``off``, so its windows never leave the card untapered.
- **Dispatch policy** (:attr:`PiperVoice.dispatch_policy`): a CPU voice
  serves each request alone (batch 1, no gather window); a GPU voice takes
  the coalescing defaults (:mod:`..utils.dispatch_policy`).

The frame budget is exact.  The JAX package estimates the frame bucket
before its single jitted program runs and retries on overflow, because the
whole batch is one device program whose shapes must be fixed up front.
PyTorch runs eagerly, so the port reads the frame counts ``sum(w_ceil)``
after ``encode_text`` (one ``[B]`` device-to-host copy per group, batch or
stream stage) and runs acoustics at the bucket of the real rows' largest
count: no estimator, no retry.

The device is explicit: ``device=None`` means the GPU, and a host without
one raises :class:`OperationError` unless the caller passes
``device="cpu"``.  A GPU voice never falls back to the CPU or to a plain
kernel: an engine's failure reaches the caller through the stream's
future.  Noise comes from :attr:`PiperVoice.sampler`, by default the
per-row generator sampler :func:`vits.per_row_normal`; a row's noise
depends on its row index, so a stream's slot in a coalesced group changes
its draws unless the noise scales are zero.

**A device mesh** (``mesh=``, :mod:`..parallel`): the batch rounds up to a
multiple of the mesh's data axis (:meth:`_pad_batch`; the warm-up lattice
enumerates the rounded shapes), and every stage of both paths — encode,
acoustics, the batch decode and quantize, the window decodes with their
epilogue — splits its rows over the data groups, each group running the
sequence-parallel or tensor-parallel stages of :mod:`.vits` on its
devices.  The voice's own tensors stay on the mesh's first device; int8
weights and a replica pool are refused beside a mesh, as in the reference.

Weights load from every format the JAX package reads
(:meth:`PiperVoice.from_config_path`), and an ``ar*`` voice diacritizes
its text before G2P (:mod:`..text.tashkeel`, on the voice's device).

Precision arms, as the reference's: ``compute_dtype`` /
``SONATA_COMPUTE_DTYPE=bfloat16`` runs the HiFi-GAN conv stack in
bfloat16 (each conv's weights cast at the call, as the reference does;
the waveform returns to float32 before ``tanh``), and ``decode_quant`` /
``SONATA_DECODE_QUANT=int8`` keeps the decoder's weights in int8
(:func:`.decode_opts.quantize_decoder` at load).  Neither changes a
kernel's input: the gate is in the flow, which stays float32, and the
epilogue receives float32.

**Warm-up.**  There is no compile on the card; what a first request pays
is cuDNN building its execution plans the first time a *thread* runs a
convolution shape (PyTorch keeps that cache per thread).  So the lattice
of :meth:`lattice_shapes` (the JAX voice's enumeration) is warmed by
:meth:`warm_shape` on the threads that will serve it: a zero-valued dummy
goes through the stage coalescer, the window-decode engine and each
attached batch worker (:meth:`attach_batch_worker`: a scheduler, or the
voice's own batch thread, :meth:`serve_batches_on_thread`), never
through the caller's thread.  Every dispatch path notes whether its
(shape, thread) pair is new (:attr:`first_uses`); the batch path and the
iteration loop annotate their dispatches ``compile="cold"`` or
``"cached"`` on that, which the serving scope counts.
"""

from __future__ import annotations

import contextvars
import logging
import os
import threading
import time
import weakref
from concurrent.futures import Future
from pathlib import Path
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np
import torch

from ..audio import Audio, AudioSamples
from ..core import (
    AudioInfo,
    BaseModel,
    FailedToLoadResource,
    OperationError,
    Phonemes,
)
from ..device import resolve_device
from ..parallel.mesh import device_scope, map_rows
from ..serving import scope, tracing
from ..synth.batching import (
    BatchingCore,
    IterationLoop,
    WorkItem,
    effective_batch_mode,
    resolve_batch_mode,
    try_set_exception,
    try_set_result,
)
from ..text import text_to_phonemes
from ..text.rule_g2p import arabic_number_to_words, expand_numbers
from ..text.tashkeel import TashkeelEngine, get_default_engine
from ..utils.buckets import (
    BATCH_BUCKETS,
    FRAME_BUCKETS,
    TEXT_BUCKETS,
    bucket_for,
    pad_to,
)
from ..utils.dispatch_policy import (
    COALESCING_DEFAULTS,
    DispatchPolicy,
    resolve_policy,
)
from . import decode_opts, vits
from .chunker import CROSSFADE_SAMPLES, plan_chunks
from .config import ModelConfig, SynthesisConfig, default_phoneme_id_map
from .import_onnx import import_onnx_weights
from .import_torch import import_torch_checkpoint
from .serialization import load_params
from .weights import (
    VitsModel,
    build_subtree,
    params_from_numpy,
    params_to_numpy,
    random_tree,
)

#: noise streams of one dispatch: the duration predictor's, the prior's
DUR_NOISE, PRIOR_NOISE = 0, 1

Sampler = Callable[[int, int, tuple], torch.Tensor]

COMPUTE_DTYPE_ENV = "SONATA_COMPUTE_DTYPE"


def resolve_compute_dtype(setting: Optional[str] = None):
    """``torch.bfloat16`` or None (float32): explicit > ``SONATA_COMPUTE_
    DTYPE``; anything else fails loudly, as in the reference."""
    setting = setting or os.environ.get(COMPUTE_DTYPE_ENV)
    if setting in (None, "", "float32", "f32"):
        return None
    if setting in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise OperationError(f"unsupported compute_dtype {setting!r} "
                         "(use float32 or bfloat16)")


def _quantized_params(params, hp):
    """``params`` (a reference tree or a :class:`VitsModel`) with its
    decoder in int8; an already-quantized decoder is shared as it is."""
    if isinstance(params, VitsModel):
        if decode_opts.decoder_is_quantized(params.dec):
            return params
        dec = build_subtree(decode_opts.quantize_decoder(
            params_to_numpy(params.dec)), ("dec",))
        model = VitsModel(hp)
        for name, prm in params.named_parameters(recurse=False):
            model.register_parameter(name, prm)
        for name, child in params.named_children():
            model.add_module(name, dec if name == "dec" else child)
        return model
    if decode_opts.decoder_is_quantized(params["dec"]):
        return params
    params = dict(params)
    params["dec"] = decode_opts.quantize_decoder(params["dec"])
    return params


class _WarmShape(str):
    """A zero-valued warm-up request for one (b, t, f) shape: submitted
    through a batch worker (a scheduler) as if it were a sentence, so the
    worker's own thread runs the dummy (:meth:`PiperVoice.speak_batch`)."""

    def __new__(cls, shape):
        obj = super().__new__(cls, "")
        obj.shape = tuple(shape)
        return obj


class _BatchThread:
    """The one thread a voice's batch synthesis runs on when no scheduler
    serves it (:meth:`PiperVoice.serve_batches_on_thread`).

    A ``speak_batch`` from any other thread is carried here whole, in the
    caller's context (its trace), so the warm-up lattice, which reaches
    this thread as an attached batch worker, warms the thread that serves.
    Each call is reported to the scope as one dispatch, annotated
    ``compile="cold"`` when one of its groups met its shape here for the
    first time, as a scheduler's dispatch is."""

    def __init__(self, voice: "PiperVoice"):
        self._voice_ref = weakref.ref(voice)
        self._local = threading.local()
        self._core = BatchingCore(
            dispatch=self._dispatch, max_batch=1, max_wait_s=0.0,
            name="sonata_batch_thread",
            alive=lambda: self._voice_ref() is not None,
            closed_reason="batch thread closed (voice unloaded)", poll_s=5.0)

    def on_thread(self) -> bool:
        return getattr(self._local, "active", False)

    def close(self) -> None:
        self._core.shutdown(join_timeout_s=10.0)

    def call(self, phoneme_batches, speakers=None, scales=None) -> list:
        """Blocking: ``speak_batch`` on this thread."""
        return self._put(lambda v: v.speak_batch(
            phoneme_batches, speakers=speakers, scales=scales)).result()

    def submit(self, phonemes, speaker=None, scales=None,
               deadline=None) -> Future:
        """One sentence, as a scheduler takes it (the warm-up's dummies)."""
        return self._put(lambda v: v.speak_batch(
            [phonemes], speakers=None if speaker is None else [speaker],
            scales=None if scales is None else [scales])[0])

    def _put(self, fn) -> Future:
        item = WorkItem((fn, contextvars.copy_context()))
        self._core.put(item)
        return item.future

    def _dispatch(self, group: list) -> None:
        v = self._voice_ref()
        for item in group:
            fn, ctx = item.payload
            attrs = {} if v is None or v.scope_voice is None else {
                "voice": v.scope_voice}
            t0 = time.monotonic()
            try:
                if v is None:
                    raise OperationError("voice was garbage-collected")
                out = ctx.run(self._run, fn, v, attrs)
            except Exception as e:
                try_set_exception(item.future, e)
                continue
            scope.note_dispatch(time.monotonic() - t0, attrs)
            try_set_result(item.future, out)

    def _run(self, fn, v, attrs):
        self._local.active = True
        try:
            with tracing.dispatch_scope(attrs):
                return fn(v)
        finally:
            self._local.active = False


class PiperVoice(BaseModel):
    """A loaded Piper voice: config + parameters on one device."""

    # dispatch-group sizing, as the reference plans it
    MAX_DISPATCH_BATCH = 64
    MIN_DISPATCH_BATCH = 8

    def __init__(self, config: ModelConfig, params, *, device=None,
                 seed: int = 0, sampler: Optional[Sampler] = None,
                 tashkeel: Optional[TashkeelEngine] = None,
                 dispatch_policy: Optional[DispatchPolicy] = None,
                 compute_dtype: Optional[str] = None,
                 decode_quant: Optional[str] = None, mesh=None):
        #: a :class:`~..parallel.mesh.Mesh`: every stage's rows split over
        #: its data axis, the sequence over its seq axis and the decoder's
        #: channels over its model axis; the voice's own tensors live on
        #: its first device
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.lead
        self.device = resolve_device(device)
        if mesh is not None and self.device != mesh.lead:
            raise OperationError(
                f"a voice on a mesh lives on the mesh's first device "
                f"({mesh.lead}), not {self.device}")
        self.config = config
        self.hp = config.hyper
        # int8 weight-only decoder (SONATA_DECODE_QUANT=int8): quantized
        # once, here, in numpy; QConv rescales before each conv
        self.decode_quant = decode_opts.resolve_decode_quant(decode_quant)
        if self.decode_quant == "int8":
            if mesh is not None:
                raise OperationError(
                    "SONATA_DECODE_QUANT=int8 does not compose with a "
                    "device mesh (the decoder's placements assume float32 "
                    "weights)")
            params = _quantized_params(params, self.hp)
        # bfloat16 conv stack for the decoder (SONATA_COMPUTE_DTYPE)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.fused_epilogue = decode_opts.resolve_fused_epilogue()
        if self.fused_epilogue == "off" and self.device.type == "cuda":
            raise OperationError(
                f"{decode_opts.FUSED_EPILOGUE_ENV}=off tapers the stream on "
                "the host; a voice on the GPU always runs the epilogue "
                "kernel")
        if not isinstance(params, VitsModel):
            params = params_from_numpy(params, self.hp)
        self.model = params.to(self.device).eval()
        if mesh is not None:  # one copy of the parameters per device
            for dev in mesh.distinct_devices():
                mesh.put(self.model, dev)
        self.multi_speaker = config.num_speakers > 1
        self._synth_lock = threading.RLock()
        self._synth_config = config.inference.copy()
        self._seed = seed
        self._rng_lock = threading.Lock()
        self._rng_counter = 0
        #: ``sampler(counter, stream, shape)`` → standard-normal CPU tensor;
        #: ``counter`` numbers the dispatches from 1, ``stream`` is
        #: :data:`DUR_NOISE` or :data:`PRIOR_NOISE`
        self.sampler: Sampler = sampler or (
            lambda counter, stream, shape: vits.per_row_normal(
                self._seed, counter, stream, shape))
        self.drop_stats = {"symbols_total": 0, "symbols_dropped": 0,
                           "dropped": {}}
        self._warned_drops: set = set()
        # the streaming engines, spawned at first use under _engine_lock:
        # the stage coalescer, and the window-decode engine of each batch
        # mode (both may exist at once: the degradation ladder can force
        # new streams to dispatch mode while resident ones finish)
        self._engine_lock = threading.Lock()
        self._stage_coalescer: "Optional[_StreamStageCoalescer]" = None
        self._stream_coalescer: "Optional[_StreamDecodeCoalescer]" = None
        self._iter_decoder: "Optional[_IterationStreamDecoder]" = None
        self._voice_closed = False
        #: voice id the serving runtime registered this voice under (the
        #: iteration loop's scope attribution names it)
        self.scope_voice: Optional[str] = None
        # warm-up bookkeeping: the (engine, shape) pairs each thread has
        # run (thread-local: the cuDNN plans they stand for die with the
        # thread), every first use in order, the pairs a warm-up ran, and
        # the batch workers warm_shape sends the full pipeline through
        self._shapes_seen = threading.local()
        self._shape_lock = threading.Lock()
        #: (engine, shape, thread name) of every first use, in order
        self.first_uses: list = []
        #: the (engine, shape) pairs :meth:`warm_shape` has run
        self.warmed_shapes: set = set()
        self._batch_workers: list = []
        self._batch_thread: Optional[_BatchThread] = None
        # frames-per-id estimate (the reference's decaying upper bound):
        # the port's frame budget is exact, so this only sizes the lattice
        self._frames_per_id = 2.5
        self._fpi_observed = False
        self._fpi_lock = threading.Lock()
        # None resolves lazily at first use (env overrides, then the
        # device's fast path or probe), so construction never probes
        self._dispatch_policy = dispatch_policy
        self._policy_lock = threading.Lock()
        # Arabic voices get the diacritizer automatically, on the voice's
        # device (parity: piper/src/lib.rs:63-77)
        self._tashkeel = tashkeel
        if tashkeel is None and config.espeak_voice.startswith("ar"):
            self._tashkeel = get_default_engine(device=self.device)

    # ------------------------------------------------------------------
    # factories
    # ------------------------------------------------------------------

    @classmethod
    def from_config_path(cls, config_path: Union[str, Path], *, device=None,
                         **kwargs) -> "PiperVoice":
        """Load a voice from a Piper ``*.json`` config.

        Weight resolution, in the JAX package's order (the reference loads
        ``config path minus .json`` as ONNX, ``piper/src/lib.rs:98-108``):
        the sidecar ``<stem>.npz`` (native), the ``encoder.onnx`` +
        ``decoder.onnx`` siblings of a streaming voice, ``<stem>.onnx``,
        then a torch checkpoint ``<stem>.pt`` / ``.ckpt`` / ``.pth``.
        """
        if device is None and kwargs.get("mesh") is not None:
            device = kwargs["mesh"].lead
        device = resolve_device(device)
        config = ModelConfig.from_path(config_path)
        stem = Path(config_path)
        stem = stem.with_suffix("") if stem.suffix == ".json" else stem
        n_vocab = max(config.num_symbols,
                      1 + max((max(v) for v in config.phoneme_id_map.values()),
                              default=0))
        # Piper convention: "voice.onnx" + "voice.onnx.json", so the config
        # path minus ".json" may itself be the ONNX file
        onnx_path = stem if stem.suffix == ".onnx" else stem.with_suffix(".onnx")
        # streaming ("rt") voice directories split the exported graph into
        # encoder.onnx + decoder.onnx siblings of the config
        # (piper/src/lib.rs:90-96); the two initializer sets partition the
        # same VITS weights and merge into one tree
        enc_path = Path(config_path).with_name("encoder.onnx")
        dec_path = Path(config_path).with_name("decoder.onnx")
        ckpt = next((stem.with_suffix(s) for s in (".pt", ".ckpt", ".pth")
                     if stem.with_suffix(s).exists()), None)
        shapes = dict(n_vocab=n_vocab, n_speakers=config.num_speakers)
        if stem.with_suffix(".npz").exists():  # native format stays first
            params = load_params(stem.with_suffix(".npz"))
        elif config.streaming and enc_path.exists() and dec_path.exists():
            params = import_onnx_weights((enc_path, dec_path), config.hyper,
                                         **shapes)
        elif onnx_path.exists():
            params = import_onnx_weights(onnx_path, config.hyper, **shapes)
        elif ckpt is not None:
            params = import_torch_checkpoint(ckpt, config.hyper, **shapes)
        else:
            raise FailedToLoadResource(
                f"no weights found next to {config_path} "
                f"(looked for {stem}.npz/.onnx/.pt/.ckpt)")
        return cls(config, params, device=device, **kwargs)

    @classmethod
    def random(cls, config: Optional[ModelConfig] = None, *, seed: int = 0,
               device=None, tashkeel: Optional[TashkeelEngine] = None,
               dispatch_policy: Optional[DispatchPolicy] = None,
               compute_dtype: Optional[str] = None,
               decode_quant: Optional[str] = None, mesh=None,
               **config_overrides) -> "PiperVoice":
        """A randomly-initialized voice (tests, benchmarks, dry runs): the
        reference's ``init_vits`` shapes, drawn from a ``torch.Generator``
        seeded with ``seed``."""
        device = resolve_device(mesh.lead if device is None and mesh
                                is not None else device)
        if config is None:
            d = {
                "audio": {"sample_rate": 22050, "quality": "medium"},
                "num_speakers": 1,
                "espeak": {"voice": "en-us"},
                "phoneme_id_map": default_phoneme_id_map(),
            }
            d.update(config_overrides)
            d["num_symbols"] = len(d["phoneme_id_map"])
            config = ModelConfig.from_dict(d)
        tree = random_tree(config.hyper, n_vocab=config.num_symbols,
                           n_speakers=config.num_speakers,
                           generator=torch.Generator().manual_seed(seed))
        return cls(config, tree, device=device, seed=seed, tashkeel=tashkeel,
                   dispatch_policy=dispatch_policy,
                   compute_dtype=compute_dtype, decode_quant=decode_quant,
                   mesh=mesh)

    def replica_for_device(self, device, *,
                           seed_offset: int = 0) -> "PiperVoice":
        """A copy of this voice on ``device`` (replica-pool serving): its
        own engines, noise stream (``seed_offset`` keeps replica draws
        distinct) and warm-up state, with the same precision arms.  The
        parameters move with ``.to(device)``, which shares them when the
        device is the voice's own (an int8 decoder is shared, never
        quantized again).  Refused on a mesh voice: a mesh spans its
        devices as one dispatch, a pool makes each device its own failure
        domain."""
        if self.mesh is not None:
            raise OperationError(
                "replica pools and device meshes are mutually exclusive "
                "(a mesh already spans its devices as one dispatch)")
        replica = PiperVoice(
            self.config, self.model, device=device,
            seed=self._seed + seed_offset, tashkeel=self._tashkeel,
            dispatch_policy=self._dispatch_policy,
            compute_dtype=("bfloat16" if self.compute_dtype is not None
                           else "float32"),
            decode_quant=self.decode_quant or "off")
        replica.scope_voice = self.scope_voice
        return replica

    # ------------------------------------------------------------------
    # Model protocol
    # ------------------------------------------------------------------

    def audio_output_info(self) -> AudioInfo:
        return AudioInfo(sample_rate=self.config.sample_rate)

    def get_language(self) -> Optional[str]:
        return self.config.language or self.config.espeak_voice

    def get_speakers(self) -> Optional[dict[int, str]]:
        if not self.multi_speaker:
            return None
        return self.config.reversed_speaker_map()

    def properties(self) -> dict[str, str]:
        return {"quality": self.config.quality or "unknown",
                "device": str(self.device)}

    def supports_streaming_output(self) -> bool:
        return True

    def get_default_synthesis_config(self) -> SynthesisConfig:
        return self.config.inference.copy()

    def get_fallback_synthesis_config(self) -> SynthesisConfig:
        with self._synth_lock:
            return self._synth_config.copy()

    def set_fallback_synthesis_config(self, config: Any) -> None:
        if not isinstance(config, SynthesisConfig):
            raise OperationError(
                "invalid synthesis config type "
                f"{type(config).__name__}")
        with self._synth_lock:
            self._synth_config = config.copy()

    def phonemize_text(self, text: str) -> Phonemes:
        # Arabic: diacritize first (piper/src/lib.rs:253-258,270-281).
        # Digits expand to MSA number words BEFORE diacritization so the
        # inserted words receive harakat like any other Arabic word.
        if self._tashkeel is not None:
            text = expand_numbers(text, arabic_number_to_words)
            text = self._tashkeel.diacritize(text)
        return text_to_phonemes(text, voice=self.config.espeak_voice,
                                remove_lang_switch_flags=True)

    def _encode_phonemes(self, phonemes: str) -> list[int]:
        """Encode one sentence (unknown symbols dropped, as the reference
        does), counting the drops and warning once per symbol."""
        ids, dropped = self.config.phonemes_to_ids_diag(phonemes)
        stats = self.drop_stats
        stats["symbols_total"] += len(phonemes)
        if dropped:
            stats["symbols_dropped"] += len(dropped)
            for ch in dropped:
                stats["dropped"][ch] = stats["dropped"].get(ch, 0) + 1
                if ch not in self._warned_drops and not ch.isspace():
                    self._warned_drops.add(ch)
                    logging.getLogger("sonata").warning(
                        "phoneme %r (U+%04X) is not in this voice's "
                        "phoneme_id_map and was dropped at encoding",
                        ch, ord(ch))
        return ids

    def speak_one_sentence(self, phonemes: str) -> Audio:
        return self.speak_batch([phonemes])[0]

    # ------------------------------------------------------------------
    # warm-up: the bucket lattice, run on the threads that serve it
    # ------------------------------------------------------------------

    def _first_use(self, engine: str, shape: tuple) -> bool:
        """Whether this thread runs ``engine`` at ``shape`` for the first
        time (then it is noted in :attr:`first_uses`): the first run of a
        convolution shape on a thread builds cuDNN's plans, later runs
        reuse them."""
        seen = getattr(self._shapes_seen, "pairs", None)
        if seen is None:
            seen = self._shapes_seen.pairs = set()
        if (engine, shape) in seen:
            return False
        seen.add((engine, shape))
        with self._shape_lock:
            self.first_uses.append(
                (engine, shape, threading.current_thread().name))
        return True

    def attach_batch_worker(self, worker: Callable[[], Any]) -> None:
        """Register a batch worker: ``worker()`` returns the scheduler (or
        anything with ``submit(phonemes)``) whose thread runs this voice's
        ``speak_batch`` — called per warm-up, since a replica's breaker can
        rebuild its scheduler.  :meth:`warm_shape` sends each
        full-pipeline shape through every attached worker."""
        self._batch_workers.append(worker)

    def serve_batches_on_thread(self) -> None:
        """Run every later ``speak_batch`` on one thread of this voice's own
        (a server's voice that no scheduler serves: its gRPC handler
        threads would each meet every shape cold).  The thread is attached
        as a batch worker, so the lattice warms it; :meth:`close` stops it,
        and a closed voice synthesizes on the caller's thread again."""
        with self._engine_lock:
            if self._batch_thread is not None:
                return
            self._batch_thread = _BatchThread(self)
        self.attach_batch_worker(lambda: self._batch_thread)

    def _warm_full(self, shape) -> None:
        """The batch path's dummy at ``(b, t, f)``, on this thread: encode,
        acoustics at frame bucket ``f``, decode and quantize, zeros in."""
        b, t, f = shape
        sc = self.get_fallback_synthesis_config()
        with self._device_scope():
            z, y_lengths, _c, f, g, _sid = self._encode_and_acoustics(
                [[0] * t] * b, sc, frames=f)
            self._decode_quantize(z, y_lengths, g)
            if self.device.type == "cuda":
                torch.cuda.current_stream().synchronize()
        b = z.shape[0]  # the batch as dispatched (a mesh rounds it up)
        self._first_use("batch", (b, t, f))
        with self._shape_lock:
            self.warmed_shapes.add(("batch", (b, t, f)))

    # Representative prewarm texts: short / medium / long sentences cover
    # the common text buckets (and, batched together, the common group
    # shapes).
    _PREWARM_TEXTS = [
        "Hello there.",
        "This server compiles its executables before the first request.",
        "A longer sentence exercises the larger text and frame buckets so "
        "that real traffic arriving right after startup never waits on a "
        "fresh compilation of the synthesis pipeline.",
    ]

    def prewarm(self, texts: Optional[list[str]] = None, *,
                streaming: bool = False, chunk_size: int = 55,
                chunk_padding: int = 3) -> int:
        """Warm the common shapes before serving traffic (the reference's
        ``prewarm``, on the serving threads): a representative batch
        through every attached batch worker, then the neighbour frame
        buckets of the shapes it met; with ``streaming=True`` one streamed
        drain per text bucket (through the stream engines, on their
        threads) and then the other coalesced batch size of every stream
        shape.  Returns the number of batch-path shapes warm."""
        phonemes = [p for t in (texts or self._PREWARM_TEXTS)
                    for p in self.phonemize_text(t)]
        if not phonemes:  # e.g. caller texts of pure punctuation
            return self._batch_shapes_warm()
        for worker in self._batch_workers:
            sched = worker()
            for fut in [sched.submit(p) for p in phonemes]:
                fut.result()
        self.prewarm_neighbor_buckets()
        if streaming:
            by_bucket: dict[int, str] = {}
            for p in phonemes:
                tb = bucket_for(len(self.config.phonemes_to_ids(p)),
                                TEXT_BUCKETS)
                if tb not in by_bucket or len(p) > len(by_bucket[tb]):
                    by_bucket[tb] = p
            for p in by_bucket.values():
                for _chunk in self.stream_synthesis(p, chunk_size,
                                                    chunk_padding):
                    pass
            self._prewarm_stream_batches()
        return self._batch_shapes_warm()

    def _batch_shapes_warm(self) -> int:
        with self._shape_lock:
            return len({s for e, s, _n in self.first_uses if e == "batch"})

    def _prewarm_stream_batches(self) -> None:
        """Warm the other coalesced batch size of every stream shape met so
        far: the stage coalescer runs at {1, max} rows, the dispatch-mode
        decode coalescer at {1, max}, the iteration loop at every rung of
        the ladder up to its max (the reference's rule)."""
        with self._shape_lock:
            met = [(e, s) for e, s, _n in self.first_uses]
        co = self._stream_decoder
        if isinstance(co, _IterationStreamDecoder):
            rungs = [b for b in BATCH_BUCKETS if b <= co._max_batch]
        else:
            rungs = sorted({1, co._max_batch})
        for width, has_sid in sorted({(s[0], s[2]) for e, s in met
                                      if e == "window"}):
            for b in rungs:
                self.warm_shape(("wdec", width, b, has_sid))
        stage_max = self._stream_stages._max_batch
        for t, f in sorted({(s[1], s[2]) for e, s in met if e == "stage"}):
            for b in sorted({1, stage_max}):
                self._stream_stages.warm(b, t, f)

    def prewarm_neighbor_buckets(self) -> None:
        """Warm the frame buckets adjacent to every batch-path shape met so
        far (one :meth:`warm_shape` each)."""
        with self._shape_lock:
            met = sorted({s for e, s, _n in self.first_uses if e == "batch"})
        for (b, t, f) in met:
            if f not in FRAME_BUCKETS:
                continue  # beyond-table bucket: no neighbor schedule
            i = FRAME_BUCKETS.index(f)
            for nf in {FRAME_BUCKETS[max(i - 1, 0)],
                       FRAME_BUCKETS[min(i + 1, len(FRAME_BUCKETS) - 1)]
                       } - {f}:
                self.warm_shape((b, t, nf))

    def lattice_shapes(self, mode: str = "full") -> list:
        """Enumerate the (batch, text, frame) shapes a restart must warm:
        the reference's enumeration, unchanged.

        - text axis: every :data:`TEXT_BUCKETS` entry;
        - frame axis: the range of buckets the frames-per-id estimate
          gives across the text bucket's id-length span — run one real
          calibration utterance first, so the estimate is an observed one
          — plus the next bucket up in every mode, and the one below the
          range in ``full`` mode;
        - batch axis: 1, plus in ``full`` mode the canonical coalesced
          batch of the scheduler (if the policy coalesces).

        ``minimal`` is the batch-1 subset of ``full``; ``off`` returns
        [].  In iteration mode the window-decode shapes follow
        (:meth:`_iteration_lattice_shapes`).  Ordered smallest-first."""
        if mode == "off":
            return []
        batches = {self._batch_rows(1)}
        if mode == "full":
            try:
                kw = self.dispatch_policy.scheduler_kwargs()
                from ..utils.buckets import canonical_dispatch_batch

                canonical = canonical_dispatch_batch(kw["max_batch"])
            except Exception:  # policy probe failure must not block boot
                canonical = 1
            if canonical > 1:
                batches.add(self._batch_rows(canonical))
        ls = float(self.get_fallback_synthesis_config().length_scale)
        shapes: list = []
        n_fb = len(FRAME_BUCKETS)
        for ti, t in enumerate(TEXT_BUCKETS):
            lo_ids = TEXT_BUCKETS[ti - 1] + 1 if ti > 0 else 1
            f_lo = self._estimate_frame_bucket(lo_ids * max(ls, 0.05))
            f_hi = self._estimate_frame_bucket(t * max(ls, 0.05))
            frames = {f_lo, f_hi}
            if f_lo in FRAME_BUCKETS:
                i_lo = FRAME_BUCKETS.index(f_lo)
                i_hi = (FRAME_BUCKETS.index(f_hi)
                        if f_hi in FRAME_BUCKETS else n_fb - 1)
                if mode == "full":
                    i_lo = max(i_lo - 1, 0)
                frames.update(
                    FRAME_BUCKETS[i]
                    for i in range(i_lo, min(i_hi + 2, n_fb)))
            for b in sorted(batches):
                for f in sorted(frames):
                    shapes.append((b, t, f))
        shapes.sort(key=lambda s: (s[1], s[0], s[2]))
        shapes.extend(self._iteration_lattice_shapes(mode))
        return shapes

    def _iteration_lattice_shapes(self, mode: str) -> list:
        """Iteration-mode window-decode shapes ``("wdec", width, batch,
        has_sid)``, when ``SONATA_BATCH_MODE`` resolves to iteration: every
        rung of the loop's batch ladder (``minimal``: batch 1) at every
        window width a chunk plan can produce (the reference's rule)."""
        try:
            policy = self.dispatch_policy
            if resolve_batch_mode(policy) != "iteration":
                return []
            kwargs = policy.stream_decode_kwargs()
        except Exception:  # policy probe failure must not block boot
            return []
        max_b = kwargs["max_batch"]
        if max_b <= 1:
            max_b = COALESCING_DEFAULTS["stream_decode_max_batch"]
        ladder = [b for b in BATCH_BUCKETS if b <= max_b]
        if mode == "minimal":
            ladder = [1]
        # the batch as the engines dispatch it (a mesh rounds it up)
        ladder = sorted({self._mesh_rows(b) for b in ladder})
        widths = [w for w in FRAME_BUCKETS if w <= 1536]
        has_sid = bool(self.multi_speaker)
        return [("wdec", w, b, has_sid) for w in widths for b in ladder]

    def warm_shape(self, shape: tuple) -> None:
        """Make one lattice shape warm on the threads that serve it.

        - ``("wdec", width, b, has_sid)``: a zero-valued window decode of
          ``b`` rows (with the epilogue when it is on), run by the
          window-decode engine that new streams use, on its thread;
        - ``(b, t, f)``: the full pipeline's dummy at ``(b, t, f)`` through
          every attached batch worker (:meth:`attach_batch_worker`), on its
          thread; and for ``b == 1``, encode + acoustics at ``(t, f)`` on
          the stage coalescer's thread at both batch sizes it dispatches
          (1 and its canonical max).

        Blocks until the dummies ran.  Nothing runs on the caller's
        thread: a thread that never serves would keep plans no request
        uses.  The dummies feed no estimate and move no noise counter."""
        if shape and shape[0] == "wdec":
            _tag, width, b, has_sid = shape
            self._stream_decoder.warm(width, b, has_sid).result()
            with self._shape_lock:
                self.warmed_shapes.add(
                    ("window", (width, self._mesh_rows(b), has_sid,
                                self.fused_epilogue != "off")))
            return
        b, t, f = shape
        futures = [worker().submit(_WarmShape((b, t, f)))
                   for worker in self._batch_workers]
        if b == 1:
            stages = self._stream_stages
            for sb in sorted({1, stages._max_batch}):
                stages.warm(sb, t, f)
        for fut in futures:
            fut.result()

    # ------------------------------------------------------------------
    # batch synthesis
    # ------------------------------------------------------------------

    def speak_batch(self, phoneme_batches: list[str],
                    speakers: Optional[list[Optional[int]]] = None,
                    scales: "Optional[list[Optional[SynthesisConfig]]]"
                    = None) -> list[Audio]:
        """Batched synthesis on the device, in dispatch groups planned as
        the reference plans them; results in input order.

        ``speakers``: optional per-sentence speaker ids (None entries fall
        back to the config speaker); ``scales``: optional per-sentence
        synthesis configs (None entries fall back likewise)."""
        if not phoneme_batches:
            return []
        bt = self._batch_thread
        if bt is not None and not bt.on_thread():
            return bt.call(phoneme_batches, speakers, scales)
        if any(isinstance(p, _WarmShape) for p in phoneme_batches):
            return self._speak_warm(phoneme_batches, speakers, scales)
        sc = self.get_fallback_synthesis_config()
        ids_list = [self._encode_phonemes(p) for p in phoneme_batches]
        n = len(ids_list)
        if speakers is not None and len(speakers) != n:
            raise OperationError(
                f"speakers list has {len(speakers)} entries for {n} sentences")
        if scales is not None and len(scales) != n:
            raise OperationError(
                f"scales list has {len(scales)} entries for {n} sentences")

        wavs: list[Optional[np.ndarray]] = [None] * n
        row_ms = [0.0] * n
        # the caller may be a scheduler's worker thread
        with self._device_scope():
            for group in self._plan_dispatch_groups(ids_list, sc, scales):
                t0 = time.perf_counter()
                w = self._infer_batch(
                    [ids_list[i] for i in group], sc,
                    speakers=([speakers[i] for i in group]
                              if speakers is not None else None),
                    scales=([scales[i] for i in group]
                            if scales is not None else None))
                ms = (time.perf_counter() - t0) * 1000.0 / len(group)
                for row, i in enumerate(group):
                    wavs[i] = w[row]
                    row_ms[i] = ms
        info = self.audio_output_info()
        return [Audio(AudioSamples(wavs[i]), info, inference_ms=row_ms[i])
                for i in range(n)]

    def _speak_warm(self, phoneme_batches, speakers, scales) -> list[Audio]:
        """A batch worker's dispatch holding warm-up requests: each runs
        its dummy shape here, on the worker's thread (silence comes back
        for it); real sentences batched beside them synthesize as usual."""
        out: list = [None] * len(phoneme_batches)
        real = [i for i, p in enumerate(phoneme_batches)
                if not isinstance(p, _WarmShape)]
        for i, p in enumerate(phoneme_batches):
            if isinstance(p, _WarmShape):
                self._warm_full(p.shape)
                out[i] = Audio(AudioSamples(np.zeros(0, np.float32)),
                               self.audio_output_info())
        if real:
            audios = self.speak_batch(
                [phoneme_batches[i] for i in real],
                speakers=([speakers[i] for i in real]
                          if speakers is not None else None),
                scales=([scales[i] for i in real]
                        if scales is not None else None))
            for i, a in zip(real, audios):
                out[i] = a
        return out

    def _plan_dispatch_groups(self, ids_list: list[list[int]],
                              sc: SynthesisConfig,
                              scales=None) -> list[list[int]]:
        """Partition sentence indices into device-dispatch groups (the
        reference's plan, unchanged).

        Rows sort by estimated frame count, then split into contiguous
        groups whose sizes are exact batch buckets.  Group sizes cap at
        half the batch (min 8); sorted order keeps each group's frame
        bucket tight."""
        n = len(ids_list)

        def est_frames(i) -> float:
            ls = (scales[i].length_scale
                  if scales is not None and i < len(scales)
                  and scales[i] is not None else sc.length_scale)
            return len(ids_list[i]) * max(float(ls), 0.05)

        def split_by_text_bucket(group: list[int]) -> list[list[int]]:
            """Split where a row's text bucket jumps past 2x the current
            subgroup head's, so a text-length-wild mix does not pad every
            short row to the outlier's size."""
            out: list[list[int]] = []
            for i in group:
                tb = bucket_for(len(ids_list[i]), TEXT_BUCKETS)
                if not out or tb > 2 * bucket_for(
                        len(ids_list[out[-1][0]]), TEXT_BUCKETS):
                    out.append([i])
                else:
                    out[-1].append(i)
            return out

        order = sorted(range(n), key=est_frames)
        if n < 2 * self.MIN_DISPATCH_BATCH:
            return split_by_text_bucket(order)
        half = max((n + 1) // 2, self.MIN_DISPATCH_BATCH)
        cap = next(s for s in reversed(BATCH_BUCKETS) if s <= half)
        cap = min(cap, self.MAX_DISPATCH_BATCH)
        sizes: list[int] = []
        rest = n
        while rest:
            take = min(cap, rest)
            sizes.append(next((s for s in reversed(BATCH_BUCKETS)
                               if s <= take), BATCH_BUCKETS[0]))
            rest -= sizes[-1]
        sizes.sort()
        while len(sizes) > 1 and sizes[0] < self.MIN_DISPATCH_BATCH:
            merged = sizes[0] + sizes[1]
            if (merged > self.MAX_DISPATCH_BATCH
                    or bucket_for(merged, BATCH_BUCKETS) - merged
                    > self.MIN_DISPATCH_BATCH):
                break
            small = sizes.pop(0)
            sizes[0] += small
        groups, pos = [], 0
        for s in sizes:
            groups.extend(split_by_text_bucket(order[pos:pos + s]))
            pos += s
        return groups

    # ------------------------------------------------------------------
    # staged inference
    # ------------------------------------------------------------------

    def _next_counter(self) -> int:
        with self._rng_lock:
            self._rng_counter += 1
            return self._rng_counter

    def _noise(self, counter: int, stream: int, shape: tuple):
        noise = self.sampler(counter, stream, tuple(shape))
        return noise.to(device=self.device, dtype=torch.float32)

    def _scale_arrays(self, sc: SynthesisConfig, batch: int,
                      scales: "Optional[list[Optional[SynthesisConfig]]]"
                      = None):
        """Per-row (noise_w, length_scale, noise_scale) [B] tensors;
        ``scales`` entries override the shared config row-wise."""
        def row(i, attr):
            if scales is not None and i < len(scales) and scales[i] is not None:
                return float(getattr(scales[i], attr))
            return float(getattr(sc, attr))

        return tuple(
            torch.tensor([row(i, attr) for i in range(batch)],
                         dtype=torch.float32, device=self.device)
            for attr in ("noise_w", "length_scale", "noise_scale"))

    def _sid_array(self, sc: SynthesisConfig, batch: int,
                   speakers: Optional[list[Optional[int]]] = None):
        if not self.multi_speaker:
            # single-speaker voice: only speaker 0 (or None) is honorable
            for sid in speakers or []:
                if sid not in (None, 0):
                    raise OperationError(
                        f"speaker id {sid} requested on a single-speaker "
                        "voice")
            return None
        default = sc.speaker[1] if sc.speaker else 0
        rows = [default if s is None else s
                for s in (speakers or [])] or [default]
        rows = rows + [default] * (batch - len(rows))
        for sid in rows:
            if not 0 <= sid < self.config.num_speakers:
                raise OperationError(
                    f"speaker id {sid} out of range "
                    f"(voice has {self.config.num_speakers} speakers)")
        return torch.tensor(rows[:batch], dtype=torch.long,
                            device=self.device)

    def _mesh_rows(self, b: int) -> int:
        """``b`` rounded up to a multiple of the mesh's data axis (so the
        rows split evenly on any mesh, a non-power-of-two one included);
        ``b`` itself without a mesh."""
        if self.mesh is None:
            return b
        from ..parallel.mesh import DATA_AXIS

        d = self.mesh.shape[DATA_AXIS]
        return ((max(b, d) + d - 1) // d) * d

    def _batch_rows(self, n: int) -> int:
        """The padded batch of ``n`` sentences: its batch bucket, rounded
        to the mesh's data axis."""
        return self._mesh_rows(bucket_for(n, BATCH_BUCKETS))

    def _pad_batch(self, ids_list: list[list[int]]):
        """Pad a sentence batch to (batch, text) buckets; dummy rows are
        length 1 and dropped by callers.  With a mesh the batch rounds up
        to a multiple of its data axis, as in the reference."""
        n_real = len(ids_list)
        b = self._batch_rows(n_real)
        t = bucket_for(max(len(i) for i in ids_list), TEXT_BUCKETS)
        padded = ids_list + [[0]] * (b - n_real)
        ids = torch.tensor([pad_to(i, t) for i in padded], dtype=torch.long,
                           device=self.device)
        lens = torch.tensor([len(i) for i in ids_list] + [1] * (b - n_real),
                            dtype=torch.int32, device=self.device)
        return ids, lens, b, t

    def _device_scope(self):
        """The per-thread torch state of work on the voice's device:
        inference mode and, on the card, the voice's device as the current
        one.  Both are thread-local, so the engines' worker threads enter
        this around every dispatch (a voice on ``cuda:1`` would otherwise
        launch on device 0)."""
        return device_scope(self.device)

    @staticmethod
    def _row_length_scales(sc, n: int, scales=None) -> list:
        return [float(scales[i].length_scale
                      if scales is not None and i < len(scales)
                      and scales[i] is not None else sc.length_scale)
                for i in range(n)]

    @torch.inference_mode()
    def _encode_and_acoustics(self, ids_list, sc, speakers=None,
                              scales=None, n_real: Optional[int] = None,
                              *, frames: Optional[int] = None):
        """Stages 1 and 2 for one padded group: returns (z [B, f, C],
        y_lengths [B], per-row frame counts (host), f, g, sid).

        ``n_real``: how many leading rows are real (default: all); the frame
        bucket is taken from their largest count, which also feeds the
        frames-per-id estimate the warm-up lattice is enumerated with.
        ``frames``: a warm-up dummy's frame bucket; it runs on zero noise
        (the voice's noise counter does not move) and reads no count."""
        n_real = len(ids_list) if n_real is None else n_real
        ids, lens, b, t = self._pad_batch(ids_list)
        sid = self._sid_array(sc, b, speakers)
        nw, ls, ns = self._scale_arrays(sc, b, scales)
        c = self.hp.inter_channels
        if frames is None:
            counter = self._next_counter()
            dur_noise = self._noise(counter, DUR_NOISE, (b, t, 2))
        else:
            dur_noise = torch.zeros((b, t, 2), device=self.device)
        m_p, logs_p, w_ceil, x_mask, g = vits.encode_text(
            self.model, self.hp, ids, lens, dur_noise,
            noise_w=nw, length_scale=ls, sid=sid, mesh=self.mesh)
        if frames is None:
            # exact frame budget: one [B] device→host copy, then the bucket
            counts = w_ceil.sum(dim=1).cpu().numpy().astype(np.int64)
            actual = max(int(counts[:n_real].max()), 1)
            f = bucket_for(actual, FRAME_BUCKETS)
            row_ls = self._row_length_scales(sc, n_real, scales)
            self._observe_frames(max(len(ids_list[i]) * max(row_ls[i], 0.05)
                                     for i in range(n_real)), actual)
            prior = self._noise(counter, PRIOR_NOISE, (b, f, c))
        else:
            counts = np.ones((b,), np.int64)
            f = frames
            prior = torch.zeros((b, f, c), device=self.device)
        z, _y_mask, y_lengths = vits.acoustics(
            self.model, self.hp, m_p, logs_p, w_ceil, x_mask, prior,
            noise_scale=ns, max_frames=f, g=g, mesh=self.mesh)
        return z, y_lengths, counts, f, g, sid

    # -- the frames-per-id estimate (sizes the lattice's frame axis) ----------
    def _estimate_frame_bucket(self, weighted_ids: float) -> int:
        """The reference's estimate: ``weighted_ids`` (``len(ids) *
        length_scale``) × frames-per-id × 1.08, bucketed."""
        with self._fpi_lock:
            fpi = self._frames_per_id
        est = weighted_ids * fpi * 1.08
        return bucket_for(max(int(est), 1), FRAME_BUCKETS)

    def _observe_frames(self, weighted_ids: float, frames: int) -> None:
        """The reference's update: the first observation replaces the prior
        (with a 15% margin), later ones form a decaying upper bound."""
        ratio = frames / max(weighted_ids, 1.0)
        with self._fpi_lock:
            if not self._fpi_observed:
                self._frames_per_id = ratio * 1.15
            else:
                self._frames_per_id = max(self._frames_per_id * 0.995, ratio)
            self._fpi_observed = True

    def _decode(self, z, g=None, mesh=None):
        """HiFi-GAN under the voice's precision arms → float32 [B, S]."""
        return vits.decode(self.model, self.hp, z, g=g, mesh=mesh,
                           compute_dtype=self.compute_dtype)

    def _decode_quantize(self, z, y_lengths, g):
        """HiFi-GAN decode + on-device peak-scaled int16 quantization
        (:func:`_quantize_rows`); the peak goes out beside the samples so
        the host restores the amplitudes (the reference's
        ``_decode_quantize``, in plain torch).  On a mesh each data group
        decodes and quantizes its own rows."""
        def run(mesh, z, y_lengths, g):
            wav = self._decode(z, g, mesh)
            wav_lengths = y_lengths * self.hp.hop_length
            wav_i16, peak = _quantize_rows(wav, wav_lengths)
            return wav_i16, wav_lengths, peak

        if self.mesh is None:
            return run(None, z, y_lengths, g)
        return map_rows(self.mesh, run, z, y_lengths, g)

    @torch.inference_mode()
    def _infer_batch(self, ids_list: list[list[int]], sc: SynthesisConfig,
                     speakers: Optional[list[Optional[int]]] = None,
                     scales: "Optional[list[Optional[SynthesisConfig]]]"
                     = None) -> list[np.ndarray]:
        """One dispatch group: ids → float32 waveforms (host), one per
        real row, at their true lengths."""
        n_real = len(ids_list)
        z, y_lengths, _frames, f, g, _sid = self._encode_and_acoustics(
            ids_list, sc, speakers=speakers, scales=scales)
        b, t = z.shape[0], bucket_for(max(len(i) for i in ids_list),
                                      TEXT_BUCKETS)
        cold = self._first_use("batch", (b, t, f))
        # dispatch attribution for a scheduler around speak_batch (a no-op
        # without one): the padded shape, its padding, whether this thread
        # met the shape for the first time, and (the reference's rule) a
        # non-default length scale, whose frame bucket the lattice's
        # coverage promise leaves out
        scaled = any(abs(ls - sc.length_scale) > 1e-9 for ls in
                     self._row_length_scales(sc, n_real, scales))
        tracing.annotate_dispatch_group(
            batch_bucket=b, text_bucket=t, frame_bucket=f, rows=n_real,
            padding_rows=b - n_real,
            padding_ratio=round((b - n_real) / b, 3),
            compile="cold" if cold else "cached",
            **({"scaled": True} if scaled else {}))
        wav_i16, wav_lengths, peaks = self._decode_quantize(z, y_lengths, g)
        wav_i16 = wav_i16[:n_real].cpu().numpy()
        wav_lengths = wav_lengths[:n_real].cpu().numpy()
        peaks = np.maximum(peaks[:n_real, None].cpu().numpy(), 0.01)
        # dequantize back to the model's original amplitudes
        wav = wav_i16.astype(np.float32) * (peaks / 32767.0)
        return [wav[i, :int(wav_lengths[i])] for i in range(n_real)]

    @torch.inference_mode()
    def _decode_windows(self, windows, sid, lo, hi):
        """One batched window decode: ``windows`` [B, width, C] (``sid`` [B]
        or None) through HiFi-GAN, ending in the fused taper + quantize
        epilogue over [B, width·hop] with each row's emitted range ``lo``,
        ``hi`` [B] int32 → (int16 [B, width·hop], peak [B]).  With ``lo``
        None (a CPU voice with ``SONATA_FUSED_EPILOGUE=off``) the plain
        waveform ``(wav,)`` instead.  The counterpart of the reference's
        ``_decode_windows_fused_fn``."""
        def run(mesh, windows, sid, lo, hi):
            g = vits.speaker_embedding(
                self.model if mesh is None else mesh.put(self.model), sid)
            wav = self._decode(windows, g, mesh)
            if lo is None:
                return (wav,)
            return decode_opts.fused_epilogue(wav, lo, hi, CROSSFADE_SAMPLES)

        if self.mesh is None:
            return run(None, windows, sid, lo, hi)
        # each data group decodes its rows and runs the epilogue on them
        return map_rows(self.mesh, run, windows, sid, lo, hi)

    # ------------------------------------------------------------------
    # dispatch policy and the streaming engines
    # ------------------------------------------------------------------

    @property
    def dispatch_policy(self) -> DispatchPolicy:
        """The resolved dispatch policy (lazy, cached): a policy passed to
        the constructor, else :func:`resolve_policy` for this voice's
        device (env overrides, then the CPU fast path or the card's
        probe)."""
        with self._policy_lock:
            if self._dispatch_policy is None:
                self._dispatch_policy = resolve_policy(
                    shape_key=(self.hp.inter_channels, self.hp.hop_length),
                    device=self.device)
                logging.getLogger("sonata").info(
                    self._dispatch_policy.describe())
            return self._dispatch_policy

    def dispatch_stats(self) -> dict:
        """The policy decision plus each streaming engine's counters and
        coalescing ratio (requests per device dispatch; 1.0 = none).
        Engines that never ran report None."""
        def view(engine):
            if engine is None:
                return None
            s = engine.stats_snapshot()
            s["coalescing_ratio"] = round(
                s["requests"] / max(s["dispatches"], 1), 3)
            return s

        with self._engine_lock:
            decode, stage = self._stream_coalescer, self._stage_coalescer
            iteration = self._iter_decoder
        pol = self._dispatch_policy
        try:
            mode = resolve_batch_mode(pol)
        except OperationError:
            mode = None  # a typo'd SONATA_BATCH_MODE fails at stream time
        return {"policy": pol.as_dict() if pol is not None else None,
                "batch_mode": mode,
                "stream_decode": view(decode),
                "stream_stage": view(stage),
                "iteration": view(iteration)}

    @property
    def _stream_decoder(self):
        """The window-decode engine for NEW streams: the dispatch-mode
        coalescer or the iteration loop, by ``SONATA_BATCH_MODE`` (default:
        iteration iff the policy coalesces) after the degradation ladder's
        override, resolved once per stream."""
        policy = self.dispatch_policy
        mode = effective_batch_mode(policy)
        kwargs = policy.stream_decode_kwargs()
        with self._engine_lock:
            if self._voice_closed:
                raise OperationError(
                    "voice is closed; streaming is unavailable")
            if mode == "iteration":
                if self._iter_decoder is None:
                    # the loop shares iterations across streams, so a
                    # per-request policy (batch 1) still gets a batch axis
                    b = kwargs["max_batch"]
                    if b <= 1:
                        b = COALESCING_DEFAULTS["stream_decode_max_batch"]
                    self._iter_decoder = _IterationStreamDecoder(
                        self, max_batch=b)
                return self._iter_decoder
            if self._stream_coalescer is None:
                self._stream_coalescer = _StreamDecodeCoalescer(self,
                                                                **kwargs)
            return self._stream_coalescer

    @property
    def _stream_stages(self) -> "_StreamStageCoalescer":
        kwargs = self.dispatch_policy.stream_stage_kwargs()
        with self._engine_lock:
            if self._voice_closed:
                raise OperationError(
                    "voice is closed; streaming is unavailable")
            if self._stage_coalescer is None:
                self._stage_coalescer = _StreamStageCoalescer(self, **kwargs)
            return self._stage_coalescer

    def start_draining(self) -> None:
        """Graceful drain: the iteration loop refuses new streams while
        resident ones finish, then exits at an iteration boundary.
        Idempotent."""
        with self._engine_lock:
            iteration = self._iter_decoder
        if iteration is not None:
            iteration.start_draining()

    def close(self) -> None:
        """Stop the streaming engines' and the batch thread's threads and
        fail their queued work.
        Idempotent and terminal for streaming (a closed voice still
        synthesizes batches; a stream raises :class:`OperationError`)."""
        with self._engine_lock:
            self._voice_closed = True
            engines = (self._stream_coalescer, self._stage_coalescer,
                       self._iter_decoder, self._batch_thread)
            self._stream_coalescer = self._stage_coalescer = None
            self._iter_decoder = self._batch_thread = None
        for engine in engines:
            if engine is not None:
                engine.close()

    # ------------------------------------------------------------------
    # streaming (reference stream_synthesis, piper/src/lib.rs:652-668)
    # ------------------------------------------------------------------

    #: window decodes one stream keeps in flight: an abandoned stream
    #: wastes at most this many decodes and batch slots
    LOOKAHEAD = 3

    def stream_synthesis(self, phonemes: str, chunk_size: int,
                         chunk_padding: int,
                         deadline=None) -> Iterator[Audio]:
        """One sentence → chunks of audio, following the reference's chunk
        plan; each chunk is one window of a batched window decode.

        Encode and acoustics ride the stage coalescer; the windows ride the
        active decode engine, :attr:`LOOKAHEAD` at a time.  ``deadline``:
        an optional :class:`~sonata_tpu_torch.serving.deadlines.Deadline`
        that the iteration loop holds the stream to (expiry fails this
        stream alone at an iteration boundary)."""
        sc = self.get_fallback_synthesis_config()
        ids = self._encode_phonemes(phonemes)
        info = self.audio_output_info()
        hop = self.hp.hop_length
        t_enc0 = time.perf_counter()
        z_row, total_frames, f, sid0 = self._stream_stages.start(ids, sc)
        total_frames = min(total_frames, f)
        enc_ms = (time.perf_counter() - t_enc0) * 1000.0

        # one engine per stream, so a ladder flip mid-stream cannot split
        # a stream across engines
        decoder = self._stream_decoder
        join = getattr(decoder, "join", None)
        handle = join(deadline) if join is not None else None
        plans = list(plan_chunks(total_frames, chunk_size, chunk_padding))
        fused = self.fused_epilogue != "off"

        def submit(plan):
            width = bucket_for(plan.width, FRAME_BUCKETS)
            start = min(plan.win_start, max(f - width, 0))
            shift = plan.win_start - start  # window moved left by pad
            lo = (shift + plan.trim_left) * hop
            hi = (shift + plan.width - plan.trim_right) * hop
            return lo, hi, decoder.submit(
                z_row, start, width, sid0, stream=handle,
                epilogue=(lo, hi) if fused else None)

        try:
            submitted = [submit(p) for p in plans[:self.LOOKAHEAD]]
            next_i = len(submitted)
            while submitted:
                lo, hi, fut = submitted.pop(0)
                t0 = time.perf_counter()
                out = fut.result()
                if fused:
                    q, peak = out
                    # slice before dequantizing: everything outside
                    # [lo, hi) is zero, tapered on the device
                    samples = AudioSamples(
                        decode_opts.dequantize_chunk(q[lo:hi], peak))
                else:  # a CPU voice: the GPU refuses "off"
                    samples = AudioSamples(out[lo:hi])
                    samples.crossfade(CROSSFADE_SAMPLES)  # taper (:838)
                ms = (time.perf_counter() - t0) * 1000.0 + enc_ms
                enc_ms = 0.0  # encoder cost attributed to the first chunk
                if next_i < len(plans):  # top up the look-ahead first
                    submitted.append(submit(plans[next_i]))
                    next_i += 1
                yield Audio(samples, info, inference_ms=ms)
        finally:
            # stream end or abandonment: leave the running batch at the
            # next iteration boundary; pending look-ahead rows are cancelled
            if handle is not None:
                decoder.retire(handle)


def _quantize_rows(wav, wav_lengths):
    """Peak-scaled int16 quantization of decoded rows, as the reference's
    ``_decode_quantize`` writes it: each row's peak over its valid samples
    (``< wav_lengths``), floored at 0.01, and the scale by a true division
    (``32767.0 / tensor`` would be ``reciprocal(tensor) * 32767``, an ulp
    off the reference for about a quarter of peaks).  ``wav`` [B, S]
    float32 → (int16 [B, S], peak [B])."""
    valid = (torch.arange(wav.shape[1], device=wav.device)[None, :]
             < wav_lengths[:, None])
    peak = torch.amax(torch.abs(wav) * valid, dim=1, keepdim=True)
    floor = torch.clamp(peak, min=0.01)
    scale = torch.full_like(floor, 32767.0) / floor
    wav_i16 = torch.clamp(wav * scale, -32768.0, 32767.0).to(torch.int16)
    return wav_i16, peak[:, 0]


# ---------------------------------------------------------------------------
# the streaming engines
# ---------------------------------------------------------------------------

class _HostCopy:
    """The device→host copies of one dispatch's outputs, started as soon as
    the dispatch is enqueued; :meth:`wait` returns them as numpy arrays.

    On the card each output is copied into a pinned host buffer with
    ``non_blocking=True`` and an event is recorded behind the copies on the
    dispatching thread's current stream; :meth:`wait` (the finisher's
    thread) blocks on that event alone.  A non-blocking copy into pageable
    memory would synchronise silently, and a pinned buffer read before its
    event completes holds garbage.  On the CPU the outputs are already
    final."""

    def __init__(self, tensors):
        self._event = None
        if tensors[0].device.type != "cuda":
            self._host = list(tensors)
            return
        self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                      for t in tensors]
        for host, t in zip(self._host, tensors):
            host.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(tensors[0].device))

    def wait(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [t.numpy() for t in self._host]


def _assemble_window_dispatch(v: PiperVoice, key, payloads: list,
                              b: int) -> _HostCopy:
    """Run one window-decode group padded to ``b`` rows (padding rows
    repeat the first) and start its copy to the host — the one place the
    (window, sid[, lo, hi]) payload layout is read, shared by both
    engines.  Runs on an engine's worker thread."""
    _width, has_sid, fused = key
    rows = payloads + [payloads[0]] * (b - len(payloads))
    with v._device_scope():
        windows = torch.stack([p[0] for p in rows])
        sid = (torch.tensor([p[1] for p in rows], dtype=torch.long,
                            device=v.device) if has_sid else None)
        lo = hi = None
        if fused:
            bounds = torch.tensor([[p[2] for p in rows], [p[3] for p in rows]],
                                  dtype=torch.int32, device=v.device)
            lo, hi = bounds[0], bounds[1]
        return _HostCopy(v._decode_windows(windows, sid, lo, hi))


def _warm_window_dispatch(v: PiperVoice, width: int, b: int,
                          has_sid: bool):
    """A warm-up window decode: ``b`` zero windows of ``width`` frames,
    through the same assembly as real ones (with the epilogue when the
    voice runs it).  Runs on an engine's worker thread; returns the copy
    and whether this thread met the shape for the first time."""
    fused = v.fused_epilogue != "off"
    b = v._mesh_rows(b)
    window = torch.zeros((width, v.hp.inter_channels), device=v.device)
    sid = 0 if has_sid else None
    payload = ((window, sid, 0, width * v.hp.hop_length) if fused
               else (window, sid))
    cold = v._first_use("window", (width, b, has_sid, fused))
    return _assemble_window_dispatch(v, (width, has_sid, fused), [payload],
                                     b), cold


def _fetch_window_results(copy: _HostCopy, n: int, fused: bool) -> list:
    """The finisher's half: wait for the copy, one result per real row —
    an ``(int16 row, peak)`` pair when fused, else a float32 row."""
    host = copy.wait()
    if fused:
        q, peaks = host
        return [(q[i], float(peaks[i])) for i in range(n)]
    return list(host[0][:n])


def _window_payload(z_row, start: int, width: int, sid, epilogue):
    """A window submission's payload and group key: the [width, C] window
    of ``z_row`` (a view: behind the queue every window has the same shape,
    whatever the utterance's frame bucket), the speaker, and with
    ``epilogue=(lo, hi)`` the emitted range.  Fused and plain submissions
    never share a group."""
    window = z_row[start:start + width]
    fused = epilogue is not None
    payload = ((window, sid, epilogue[0], epilogue[1]) if fused
               else (window, sid))
    return payload, (width, sid is not None, fused)


class _StreamDecodeCoalescer:
    """Shared dispatcher for streaming window decodes (dispatch mode).

    Every stream's window decodes funnel through one queue; the batching
    core groups those of equal key that arrive within ``max_wait_ms`` and
    this class issues ONE batched decode for them, padded to ``max_batch``
    rows when it holds more than one (the decode runs at {1, max} rows).
    Two-phase: the worker enqueues the decode and its copy to the host,
    the finisher waits for the copy and resolves the futures."""

    def __init__(self, voice: PiperVoice, *, max_batch: int = 8,
                 max_wait_ms: float = 2.0):
        # weak: the voice owns the coalescer, whose threads must not pin it
        self._voice_ref = weakref.ref(voice)
        self._max_batch = max_batch
        self._reason = "stream-decode coalescer closed (voice unloaded)"
        self._core = BatchingCore(
            dispatch=self._dispatch, finish=self._finish,
            max_batch=max_batch, max_wait_s=max_wait_ms / 1000.0,
            name="sonata_stream_decoder", keyed=True,
            alive=lambda: self._voice_ref() is not None,
            closed_reason=self._reason, poll_s=5.0)
        self.stats_snapshot = self._core.stats_snapshot

    def close(self) -> None:
        self._core.shutdown(join_timeout_s=10.0)

    def submit(self, z_row, start: int, width: int, sid: Optional[int],
               stream=None, epilogue=None) -> Future:
        """Queue a window decode; a Future of the [width·hop] waveform, or
        with ``epilogue=(lo, hi)`` of an ``(int16 samples, peak)`` pair
        tapered on the device.  ``stream`` (the iteration loop's handle) is
        ignored: dispatch mode holds no resident stream."""
        payload, key = _window_payload(z_row, start, width, sid, epilogue)
        return self._put(WorkItem(payload, key=key))

    def warm(self, width: int, b: int, has_sid: bool) -> Future:
        """A warm-up decode of ``b`` zero windows on this engine's thread
        (the batch sizes it dispatches are 1 and its max)."""
        return self._put(WorkItem(None, key=("warm", width, b, has_sid)))

    def _put(self, item: WorkItem) -> Future:
        if self._core.closed:
            try_set_exception(item.future, OperationError(self._reason))
            return item.future
        self._core.put(item)
        return item.future

    def _dispatch(self, group: list):
        v = self._voice_ref()
        if v is None:
            raise OperationError("voice was garbage-collected")
        key = group[0].key
        if key[0] == "warm":
            return _warm_window_dispatch(v, *key[1:])[0], "warm"
        n = len(group)
        b = v._mesh_rows(self._max_batch if n > 1 else 1)
        v._first_use("window", (key[0], b, key[1], key[2]))
        copy = _assemble_window_dispatch(
            v, key, [item.payload for item in group], b)
        for stat, count in (("requests", n), ("dispatches", 1),
                            ("rows", n), ("padded_rows", b - n)):
            self._core.bump(stat, count)
        return copy, group[0].key[2]

    def _finish(self, group: list, ticket) -> None:
        copy, fused = ticket
        if fused == "warm":
            copy.wait()
            results = [None] * len(group)
        else:
            results = _fetch_window_results(copy, len(group), fused)
        for item, res in zip(group, results):
            try_set_result(item.future, res)


class _IterationStreamDecoder:
    """Iteration-mode window decoder (``SONATA_BATCH_MODE=iteration``).

    The engine underneath is the persistent :class:`IterationLoop`: a
    stream joins the running batch once its encode lands, its window
    decodes ride each iteration beside every other resident stream's rows
    (padded to the next batch bucket: 1, 2, 4, 8), and it retires at an
    iteration boundary when it ends.  Two-phase like the coalescer: with
    ``SONATA_ITER_PIPELINE`` (the default) the loop's finisher waits for
    iteration k's copy while the worker dispatches k+1."""

    def __init__(self, voice: PiperVoice, *, max_batch: int = 8):
        self._voice_ref = weakref.ref(voice)
        self._max_batch = max_batch
        self._loop = IterationLoop(
            self._dispatch, max_batch=max_batch, name="sonata_iter_decode",
            attrs={"device": str(voice.device)}, finish=self._finish)
        self.stats_snapshot = self._loop.stats_snapshot

    def join(self, deadline=None):
        return self._loop.join(deadline)

    def retire(self, handle) -> None:
        self._loop.retire(handle)

    def start_draining(self) -> None:
        self._loop.start_draining()

    def close(self) -> None:
        self._loop.close()

    def submit(self, z_row, start: int, width: int, sid: Optional[int],
               stream=None, epilogue=None) -> Future:
        """As :meth:`_StreamDecodeCoalescer.submit`, for the stream whose
        :meth:`join` handle is ``stream``."""
        payload, key = _window_payload(z_row, start, width, sid, epilogue)
        return self._loop.submit(stream, key, payload)

    def warm(self, width: int, b: int, has_sid: bool) -> Future:
        """A warm-up decode of ``b`` zero windows on the loop's thread: a
        stream of its own joins, rides one iteration and retires."""
        handle = self._loop.join()
        fut = self._loop.submit(handle, ("warm", width, b, has_sid), None)
        fut.add_done_callback(lambda _f: self._loop.retire(handle))
        return fut

    def _dispatch(self, key, payloads, b: int):
        """Enqueue one iteration's decode and its copy to the host, and
        say whether this thread met its shape before (``compile``)."""
        v = self._voice_ref()
        if v is None:
            raise OperationError("voice was garbage-collected")
        b = v._mesh_rows(b)
        if key[0] == "warm":
            width = key[1]
            copy, cold = _warm_window_dispatch(v, *key[1:])
            ticket = (copy, len(payloads), "warm")
        else:
            width, has_sid, fused = key
            cold = v._first_use("window", (width, b, has_sid, fused))
            copy = _assemble_window_dispatch(v, key, payloads, b)
            ticket = (copy, len(payloads), fused)
        attrs = {"frame_bucket": width, "text_bucket": 0,
                 "compile": "cold" if cold else "cached"}
        if v.scope_voice is not None:
            attrs["voice"] = v.scope_voice
        return ticket, attrs

    @staticmethod
    def _finish(ticket):
        """Wait for the copy: the only host sync of an iteration."""
        copy, n, fused = ticket
        if fused == "warm":
            copy.wait()
            return [None] * n
        return _fetch_window_results(copy, n, fused)


class _StreamStageCoalescer:
    """Shared dispatcher for streaming encode + acoustics.

    Stream starts that arrive within ``max_wait_ms`` and share a text
    bucket become one batched encode and one batched acoustics dispatch,
    padded to ``max_batch`` rows when the group holds more than one; per-row
    scales and speakers ride row-wise.  The frame bucket is exact: the
    group's frame counts are copied to the host after the encode (one [B]
    copy) and acoustics runs at the bucket of the real rows' largest
    count, where the reference estimates it and retries on overflow.  So
    the group is done when its acoustics is enqueued: one phase, the
    worker resolves each stream's future with its [f, C] latent row on the
    device."""

    def __init__(self, voice: PiperVoice, *, max_batch: int = 8,
                 max_wait_ms: float = 8.0):
        self._voice_ref = weakref.ref(voice)
        self._max_batch = max_batch
        self._reason = "stream-stage coalescer closed (voice unloaded)"
        self._core = BatchingCore(
            dispatch=self._dispatch, max_batch=max_batch,
            max_wait_s=max_wait_ms / 1000.0, name="sonata_stream_stages",
            keyed=True, alive=lambda: self._voice_ref() is not None,
            closed_reason=self._reason, poll_s=5.0)
        self.stats_snapshot = self._core.stats_snapshot

    def close(self) -> None:
        self._core.shutdown(join_timeout_s=10.0)

    def start(self, ids: list, sc: SynthesisConfig):
        """Blocking: encode + acoustics for one stream, possibly batched
        with others.  Returns ``(z_row, total_frames, f, sid0)``: the
        [f, C] latent on the device, the true frame count, the frame
        bucket, and the row's speaker id (None on single-speaker
        voices)."""
        if self._core.closed:
            raise OperationError(self._reason)
        item = WorkItem((ids, sc), key=(bucket_for(len(ids), TEXT_BUCKETS),))
        self._core.put(item)
        return item.future.result()

    def warm(self, b: int, t: int, f: int) -> None:
        """Blocking: a warm-up encode + acoustics of ``b`` zero rows at text
        bucket ``t`` and frame bucket ``f``, on this engine's thread."""
        if self._core.closed:
            raise OperationError(self._reason)
        item = WorkItem(None, key=("warm", b, t, f))
        self._core.put(item)
        item.future.result()

    def _dispatch(self, group: list) -> None:
        v = self._voice_ref()
        if v is None:
            raise OperationError("voice was garbage-collected")
        if group[0].key[0] == "warm":
            _tag, b, t, f = group[0].key
            sc = v.get_fallback_synthesis_config()
            with v._device_scope():
                v._encode_and_acoustics([[0] * t] * b, sc, frames=f)
                if v.device.type == "cuda":
                    torch.cuda.current_stream().synchronize()
            b = v._batch_rows(b)  # the batch as dispatched
            v._first_use("stage", (b, t, f))
            with v._shape_lock:
                v.warmed_shapes.add(("stage", (b, t, f)))
            for item in group:
                try_set_result(item.future, None)
            return
        n = len(group)
        ids_list = [item.payload[0] for item in group]
        scs = [item.payload[1] for item in group]
        if n > 1:
            pad = self._max_batch - n
            ids_list += [[0]] * pad
            scs += [scs[0]] * pad
        speakers = ([sc.speaker[1] if sc.speaker else 0 for sc in scs]
                    if v.multi_speaker else None)
        with v._device_scope():
            z, _y, frames, f, _g, _sid = v._encode_and_acoustics(
                ids_list, scs[0], speakers=speakers, scales=scs, n_real=n)
        v._first_use("stage", (z.shape[0], group[0].key[0], f))
        for stat, count in (("requests", n), ("dispatches", 1),
                            ("rows", n), ("padded_rows", z.shape[0] - n)):
            self._core.bump(stat, count)
        for i, item in enumerate(group):
            try_set_result(item.future, (
                z[i], int(frames[i]), f,
                speakers[i] if speakers is not None else None))
