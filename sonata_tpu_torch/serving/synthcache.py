"""sonata-synthcache: content-addressed request-level synthesis cache.

At consumer scale TTS traffic is dominated by repeated strings
(notification templates, IVR prompts, UI text), yet every request runs
the full phonemize→VITS→epilogue pipeline even when the engine
synthesized the identical utterance milliseconds ago.  This module turns
the hottest requests into a memcpy:

- **Content-addressed.**  Entries are keyed by :func:`request_key` — a
  blake2b digest of the canonical request identity: the
  whitespace/casing-normalized text (:func:`canonical_text`), voice id,
  speaker id, length/noise/noise-w scales, output sample-rate/format,
  and the stream-shape fields (RPC kind, synthesis mode, realtime chunk
  schedule).  Never Python ``hash()`` — the key is pinned stable across
  processes so a fleet of replicas agrees on identity.
- **Chunk-exact replay.**  An entry stores the finished stream as its
  ordered i16 chunk list (the exact wire payloads the miss produced), so
  a hit replays the same chunk sequence byte for byte: clients, the
  crossfade seams, and the trace shape are indistinguishable from the
  synthesis that filled the entry.
- **Write-through LRU bounded by bytes.**  ``SONATA_SYNTH_CACHE_MB``
  (0 = off, the default — the pre-cache request path is byte-for-byte
  unchanged) bounds the committed chunk bytes; inserting past the budget
  evicts least-recently-used entries first.  An entry is inserted only
  on FULLY-successful synthesis — a failed, cancelled, or
  deadline-expired stream never caches a truncated result.
- **Single-flight dedup.**  N concurrent identical requests admit ONE
  synthesizer (the leader, who fills the entry); the other N−1 stream
  chunks from the filling entry as they land.  Follower waits are
  bounded per chunk by ``SONATA_SYNTH_CACHE_WAIT_S``; on leader failure
  (or a stalled leader) a follower that has not yet emitted audio falls
  back to independent synthesis — a leader error must not fan out.  A
  follower the leader fails MID-stream raises
  :class:`LeaderFailed` typed instead (the mesh rule: re-sending audio
  from an independent — differently-noised — synthesis is worse than
  failing).
- **Failpoint.**  Every :meth:`SynthCache.lookup` fires the
  ``cache.lookup`` site; an injected (or real) lookup error degrades to
  a normal miss that bypasses the cache entirely — a broken cache can
  never fail a request.
- **Observability.**  ``sonata_synth_cache_{hits,misses,inserts,
  evictions}_total`` and ``sonata_synth_cache_bytes`` on the metrics
  plane (counter semantics via scrape-time callbacks — the hot path
  bumps plain ints under the cache lock), plus hit-ratio rows on the
  scope plane (``/debug/quantiles`` ``synth_cache`` section and the
  flight recorder's ``cache_hit_ratio`` probe).

The cache is owned by the
:class:`~sonata_tpu_torch.serving.ServingRuntime` and wired into the request
path in ``frontends/grpc_server.py`` AHEAD of pool/iteration-loop
admission: hits bypass queue wait entirely and stamp a ``cache-hit``
trace span.  Nothing here imports gRPC or jax.
"""

from __future__ import annotations

import hashlib
import logging
import os
import struct
import threading
import time
import unicodedata
from collections import OrderedDict
from typing import Iterator, Optional, Tuple

from ..core import OperationError
from . import faults

log = logging.getLogger("sonata.serving")

CACHE_MB_ENV = "SONATA_SYNTH_CACHE_MB"
CACHE_WAIT_S_ENV = "SONATA_SYNTH_CACHE_WAIT_S"
CASEFOLD_ENV = "SONATA_SYNTH_CACHE_CASEFOLD"

DEFAULT_WAIT_S = 10.0
#: per-chunk bookkeeping estimate added to the payload length so a
#: thousand tiny chunks cannot hide from the byte budget
CHUNK_OVERHEAD_BYTES = 64

#: key-schema version: bump whenever the canonical tuple changes shape,
#: so stale cross-process assumptions about identity fail to collide
#: instead of colliding wrong.  v2: the voice scales are canonicalized
#: through float32 (the wire precision of SynthesisOptions), so a key
#: derived at the mesh router from wire-learned options is byte-identical
#: to the node's key derived from its float64 config.
KEY_VERSION = "v2"

#: how many LRU-head keys :meth:`SynthCache.cache_view` advertises for
#: fleet hot-set replication (sonata-fleetcache) — a view shape, not a
#: replication policy (``SONATA_FLEETCACHE_REPLICATE_K`` bounds how many
#: the router actually replicates)
HOT_KEYS_MAX = 16

_FILLING, _COMPLETE, _FAILED = "filling", "complete", "failed"

#: one chunk as stored and replayed: (wire payload bytes, aux float) —
#: aux carries the per-sentence RTF for SynthesizeUtterance results and
#: is None for realtime wave chunks
Chunk = Tuple[bytes, Optional[float]]


class LeaderFailed(OperationError):
    """The single-flight leader failed (or stalled past the bounded
    wait) while this follower was streaming from its filling entry."""


def resolve_casefold() -> bool:
    """``SONATA_SYNTH_CACHE_CASEFOLD`` (the one default-defining read):
    1 / unset / unparseable = casefold (the behavior), 0 = keep
    case as part of textual identity.  Read at canonicalization time so
    the trade-off can be flipped per process without a restart dance in
    tests."""
    raw = os.environ.get(CASEFOLD_ENV, "").strip()
    if not raw:
        return True
    try:
        return int(raw) != 0
    except ValueError:
        log.warning("ignoring non-numeric %s=%r (casefold stays on)",
                    CASEFOLD_ENV, raw)
        return True


def canonical_text(text: str) -> str:
    """The cache's one definition of textual identity: Unicode NFC,
    casefolded, whitespace runs collapsed to single spaces, stripped.
    ``" Hello\\n\\tWORLD "`` and ``"hello world"`` address one entry.

    Casefolding is a documented trade-off (DEPLOY.md): eSpeak can
    pronounce casing ("US" vs "us"), so case-divergent texts share the
    entry of whoever synthesized first — template traffic is
    case-stable, which is what this cache exists for.  Deployments whose
    traffic IS case-sensitive opt out with
    ``SONATA_SYNTH_CACHE_CASEFOLD=0``: case-divergent texts then
    address separate entries (no key-schema change needed — the texts
    simply stop collapsing)."""
    normalized = unicodedata.normalize("NFC", text)
    if resolve_casefold():
        normalized = normalized.casefold()
    return " ".join(normalized.split())


def _num(v) -> str:
    """Canonical numeric rendering (``repr`` floats round-trip exactly;
    ints stay ints) so 1.0 and 1 cannot split an identity."""
    if v is None:
        return "-"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _f32(v: Optional[float]) -> Optional[float]:
    """Round-trip a scale through IEEE float32 — the precision the
    SynthesisOptions wire fields carry.  The node configures scales as
    float64 (``0.667``) but the mesh router learns them from protobuf
    floats (``0.6669999957…``); canonicalizing BOTH sides through
    float32 makes the router-derived affinity key byte-identical to the
    node-derived cache key (pinned by tests/test_fleetcache.py)."""
    if v is None:
        return None
    return struct.unpack("<f", struct.pack("<f", float(v)))[0]


def request_key(*, rpc: str, text: str, voice_id: str,
                speaker: Optional[int],
                length_scale: float, noise_scale: float, noise_w: float,
                sample_rate: int, sample_width: int, channels: int,
                mode: int = 0, chunk_size: int = 0, chunk_padding: int = 0,
                speech_args: Optional[tuple] = None) -> str:
    """Content address of one synthesis request.

    A blake2b digest of the canonical tuple — NOT Python ``hash()``
    (whose strings are salted per process): the derivation is pinned
    stable across processes by test_synthcache's golden digest.
    ``speech_args`` is the raw (rate, volume, pitch,
    appended_silence_ms) tuple or None; any prosody post-processing
    changes the audio, so it is part of identity.
    """
    sa = "-" if speech_args is None else ",".join(
        _num(x) for x in speech_args)
    parts = (KEY_VERSION, rpc, canonical_text(text), voice_id,
             _num(speaker), _num(_f32(length_scale)),
             _num(_f32(noise_scale)), _num(_f32(noise_w)),
             _num(sample_rate), _num(sample_width),
             _num(channels), _num(mode), _num(chunk_size),
             _num(chunk_padding), sa)
    blob = "\x1f".join(parts).encode("utf-8")
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def utterance_key(kind: str, request, *, voice_id: str,
                  speaker: Optional[int], length_scale: float,
                  noise_scale: float, noise_w: float, sample_rate: int,
                  sample_width: int, channels: int) -> str:
    """:func:`request_key` for one decoded ``pb.Utterance`` plus the
    per-voice identity fields the caller holds.

    This is THE shared derivation for the request-shape half of the key
    (synthesis mode, realtime chunk-schedule defaults, speech-args
    flattening): the node frontend (``grpc_server._cache_key_for``) and
    the mesh router (``serving/fleetcache.py``) both call it, so the
    two sides cannot drift on how an Utterance maps into the canonical
    tuple — only on the per-voice fields, which the key-parity tests
    pin separately."""
    sa = request.speech_args
    realtime = kind == "realtime"
    return request_key(
        rpc=kind, text=request.text, voice_id=voice_id, speaker=speaker,
        length_scale=length_scale, noise_scale=noise_scale,
        noise_w=noise_w, sample_rate=sample_rate,
        sample_width=sample_width, channels=channels,
        mode=request.synthesis_mode or 0,
        chunk_size=(request.realtime_chunk_size or 55) if realtime else 0,
        chunk_padding=(request.realtime_chunk_padding or 3) if realtime
        else 0,
        speech_args=None if sa is None else (
            sa.rate, sa.volume, sa.pitch, sa.appended_silence_ms))


def resolve_cache_mb() -> float:
    """``SONATA_SYNTH_CACHE_MB`` (the one default-defining read): 0 /
    unset / unparseable = off.  Fractional megabytes are honored — the
    smoke lanes size the budget below one entry-set on purpose."""
    raw = os.environ.get(CACHE_MB_ENV, "").strip()
    if not raw:
        return 0.0
    try:
        mb = float(raw)
    except ValueError:
        log.warning("ignoring non-numeric %s=%r (cache stays off)",
                    CACHE_MB_ENV, raw)
        return 0.0
    return max(mb, 0.0)


def resolve_wait_s() -> float:
    """``SONATA_SYNTH_CACHE_WAIT_S``: the bounded per-chunk follower
    wait before a stalled leader is treated as failed."""
    try:
        return max(0.1, float(os.environ.get(CACHE_WAIT_S_ENV,
                                             DEFAULT_WAIT_S)))
    except ValueError:
        return DEFAULT_WAIT_S


def from_env() -> Optional["SynthCache"]:
    """The runtime's construction gate: a :class:`SynthCache` when
    ``SONATA_SYNTH_CACHE_MB`` > 0, else None (the default — every cache
    hook then costs one ``is None`` branch)."""
    mb = resolve_cache_mb()
    if mb <= 0:
        return None
    return SynthCache(max_bytes=int(mb * 1024 * 1024),
                      wait_s=resolve_wait_s())


class _Entry:
    """One cached (or filling) stream.  ``chunks`` is append-only while
    filling and frozen after the terminal transition; readers and the
    filling writer synchronize on ``cond``.  ``tag`` groups entries for
    invalidation (the frontends tag by voice id, so :meth:`SynthCache.
    drop_tag` can purge a voice's streams on unload/reload)."""

    __slots__ = ("key", "chunks", "bytes", "state", "cond", "tag",
                 "invalidated", "owner")

    def __init__(self, key: str, tag: Optional[str] = None,
                 owner: Optional[str] = None):
        self.key = key
        self.chunks: list = []          # [(payload, aux), ...]
        self.bytes = 0
        self.state = _FILLING
        self.cond = threading.Condition()
        self.tag = tag
        #: the tenant whose miss filled this entry (sonata-tenancy).
        #: Ownership bounds the tenant's INSERT budget only — the key
        #: is tenant-free, so other tenants' identical requests hit
        #: this entry without charging anyone's share twice.
        self.owner = owner
        #: set (under the registry lock) by drop_tag while this entry
        #: is still filling: the fill keeps streaming to its clients,
        #: but its commit must not insert — the tag's voice was
        #: unloaded mid-fill, and a reload at the same id would hit
        #: stale audio
        self.invalidated = False

    def view(self) -> dict:
        return {"key": self.key, "chunks": len(self.chunks),
                "bytes": self.bytes, "state": self.state,
                "tag": self.tag, "owner": self.owner}


class FillHandle:
    """The single-flight leader's handle: tee every emitted chunk in,
    then exactly one of :meth:`commit_fill` (fully-successful stream →
    write-through insert) or :meth:`abort_fill` (any other exit — the
    truncated result is discarded and waiting followers are released
    into their fallback)."""

    __slots__ = ("_cache", "_entry", "_done")

    def __init__(self, cache: "SynthCache", entry: _Entry):
        self._cache = cache
        self._entry = entry
        self._done = False

    def add_chunk(self, payload: bytes, aux: Optional[float] = None
                  ) -> None:
        entry = self._entry
        with entry.cond:
            entry.chunks.append((payload, aux))
            entry.bytes += len(payload) + CHUNK_OVERHEAD_BYTES
            entry.cond.notify_all()

    def commit_fill(self) -> None:
        if self._done:
            return
        self._done = True
        self._cache._commit(self._entry)

    def abort_fill(self) -> None:
        if self._done:
            return
        self._done = True
        self._cache._abort(self._entry)


class FollowerStream:
    """A deduplicated request streaming chunks from a filling entry as
    the leader lands them.  Iteration yields :data:`Chunk` tuples;
    exhaustion means the leader committed.  :class:`LeaderFailed` is
    raised when the leader aborted or stalled past the bounded per-chunk
    wait — the caller falls back to independent synthesis if (and only
    if) it has not emitted audio yet."""

    __slots__ = ("_cache", "_entry", "_i", "_wait_s", "_resolved")

    def __init__(self, cache: "SynthCache", entry: _Entry, wait_s: float):
        self._cache = cache
        self._entry = entry
        self._i = 0
        self._wait_s = wait_s
        self._resolved = False

    def __iter__(self) -> Iterator[Chunk]:
        return self

    def __next__(self) -> Chunk:
        entry = self._entry
        with entry.cond:
            deadline = time.monotonic() + self._wait_s
            while True:
                if self._i < len(entry.chunks):
                    chunk = entry.chunks[self._i]
                    self._i += 1
                    return chunk
                if entry.state == _COMPLETE:
                    self._resolve(hit=True)
                    raise StopIteration
                if entry.state == _FAILED:
                    self._resolve(hit=False)
                    raise LeaderFailed(
                        "synthesis cache leader failed while filling "
                        f"entry {entry.key[:12]}")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._resolve(hit=False)
                    raise LeaderFailed(
                        "synthesis cache leader stalled past the "
                        f"{self._wait_s:g}s follower wait "
                        f"({CACHE_WAIT_S_ENV})")
                entry.cond.wait(timeout=remaining)

    def abandon(self) -> None:
        """Resolve a follower the caller walked away from mid-follow
        (client disconnect) as a miss, so every follower lookup reaches
        exactly one terminal count.  No-op once resolved."""
        self._resolve(hit=False)

    def _resolve(self, hit: bool) -> None:
        """Count this follower exactly once at its terminal state: a
        follower served whole from the entry is a hit; one that must
        fall back (or fail, or is abandoned) is a miss."""
        if self._resolved:
            return
        self._resolved = True
        self._cache._note_follower(hit)


class SynthCache:
    """Byte-bounded write-through LRU of finished synthesis streams
    with single-flight fill dedup.  Thread-safe; the registry lock is
    held only for dict bookkeeping (never across a wait or a chunk
    copy)."""

    def __init__(self, max_bytes: int, wait_s: float = DEFAULT_WAIT_S):
        if max_bytes <= 0:
            raise ValueError("SynthCache needs a positive byte budget "
                             "(use from_env() for the 0=off gate)")
        self.max_bytes = int(max_bytes)
        self.wait_s = float(wait_s)
        self._lock = threading.Lock()
        #: committed entries, LRU order (oldest first)
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        #: single-flight: key -> the entry a leader is filling
        self._filling: dict = {}
        self._bytes = 0
        self._closed = False
        self._stats = {"hits": 0, "misses": 0, "inserts": 0,
                       "evictions": 0, "follower_joins": 0,
                       "lookup_errors": 0, "oversize_skips": 0,
                       "invalidations": 0, "share_evictions": 0}
        #: sonata-tenancy insert budgets: owner tenant -> committed
        #: bytes, and the resolver mapping an owner to its fraction of
        #: max_bytes (None = unshared).  Wired by the runtime when both
        #: planes are enabled; absent, nothing below changes behavior.
        self._owner_bytes: dict = {}
        self._share_of = None

    def set_share_resolver(self, share_of) -> None:
        """Attach the tenancy plane's ``cache_share`` resolver: owner →
        fraction of ``max_bytes`` that owner's committed entries may
        hold (None = unshared).  Enforced at commit time — one tenant's
        template churn then evicts its OWN least-recent entries first
        and can never flush another tenant's hot set."""
        self._share_of = share_of

    # -- the request-path surface --------------------------------------------
    def lookup(self, key: str, tag: Optional[str] = None,
               owner: Optional[str] = None):
        """Probe the cache for ``key``.  Returns one of:

        - ``("hit", chunks)`` — a committed entry; ``chunks`` is its
          frozen ordered chunk list, replayable without further locking
          (eviction only unlinks the entry, the list stays alive with
          its readers);
        - ``("follow", FollowerStream)`` — another identical request is
          filling the entry right now (counted at the follower's
          terminal state, not here);
        - ``("fill", FillHandle)`` — a miss; the caller is the
          single-flight leader and must commit or abort the handle;
        - ``("bypass", None)`` — the lookup itself failed (the
          ``cache.lookup`` failpoint, or any unexpected internal
          error): degrade to a normal miss that leaves the cache alone
          — a broken cache can never fail a request.

        ``tag`` labels a new fill's entry for group invalidation
        (:meth:`drop_tag`); the frontends tag by voice id.  ``owner``
        names the tenant whose miss fills the entry (sonata-tenancy:
        commit-time insert budgets) — NEVER part of the key, so
        identical requests across tenants still dedup to one entry.
        """
        try:
            faults.fire("cache.lookup")
            with self._lock:
                if self._closed:
                    return ("bypass", None)
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self._stats["hits"] += 1
                    return ("hit", entry.chunks)
                filling = self._filling.get(key)
                if filling is not None:
                    self._stats["follower_joins"] += 1
                    return ("follow",
                            FollowerStream(self, filling, self.wait_s))
                entry = _Entry(key, tag=tag, owner=owner)
                self._filling[key] = entry
                self._stats["misses"] += 1
                return ("fill", FillHandle(self, entry))
        except Exception:
            # injected or real: one probe degrades, the request lives
            with self._lock:
                self._stats["lookup_errors"] += 1
                self._stats["misses"] += 1
            log.debug("synth-cache lookup degraded to a miss",
                      exc_info=True)
            return ("bypass", None)

    # -- fill resolution (FillHandle calls these) ----------------------------
    def _owner_budget_locked(self, owner: Optional[str]) -> Optional[int]:
        """The owner tenant's committed-byte ceiling, or None (unshared
        — the pre-tenancy behavior, and the behavior for any tenant
        with no configured ``cache_share``)."""
        if owner is None or self._share_of is None:
            return None
        try:
            share = self._share_of(owner)
        except Exception:
            return None
        if share is None or share <= 0:
            return None
        return int(min(1.0, share) * self.max_bytes)

    def _unlink_locked(self, key: str) -> "_Entry":
        old = self._entries.pop(key)
        self._bytes -= old.bytes
        if old.owner is not None:
            left = self._owner_bytes.get(old.owner, 0) - old.bytes
            if left > 0:
                self._owner_bytes[old.owner] = left
            else:
                self._owner_bytes.pop(old.owner, None)
        return old

    def _commit(self, entry: _Entry) -> None:
        evicted = []
        with self._lock:
            self._filling.pop(entry.key, None)
            budget = self._owner_budget_locked(entry.owner)
            if entry.invalidated:
                # the tag was dropped mid-fill (voice unload/reload):
                # the stream served its clients, the entry must not land
                self._stats["invalidations"] += 1
            elif (not self._closed and entry.bytes <= self.max_bytes
                    and (budget is None or entry.bytes <= budget)):
                # per-tenant insert budget (sonata-tenancy): the owner's
                # committed bytes stay under its share by evicting the
                # owner's OWN least-recent entries first — a churning
                # tenant can never flush another tenant's hot set
                if budget is not None:
                    while (self._owner_bytes.get(entry.owner, 0)
                           + entry.bytes > budget):
                        doomed = next(
                            (k for k, e in self._entries.items()
                             if e.owner == entry.owner), None)
                        if doomed is None:
                            break
                        evicted.append(self._unlink_locked(doomed).key[:12])
                        self._stats["evictions"] += 1
                        self._stats["share_evictions"] += 1
                self._entries[entry.key] = entry
                self._entries.move_to_end(entry.key)
                self._bytes += entry.bytes
                if entry.owner is not None:
                    self._owner_bytes[entry.owner] = (
                        self._owner_bytes.get(entry.owner, 0) + entry.bytes)
                self._stats["inserts"] += 1
                while self._bytes > self.max_bytes:
                    k = next(iter(self._entries))
                    evicted.append(self._unlink_locked(k).key[:12])
                    self._stats["evictions"] += 1
            elif not self._closed:
                # one stream bigger than the whole budget (or the
                # owner's whole share): caching it would evict
                # everything it is allowed to hold and immediately
                # evict itself
                self._stats["oversize_skips"] += 1
        with entry.cond:
            entry.state = _COMPLETE
            entry.cond.notify_all()
        if evicted:
            log.debug("synth-cache evicted %d entr%s (budget %d bytes)",
                      len(evicted), "y" if len(evicted) == 1 else "ies",
                      self.max_bytes)

    def _abort(self, entry: _Entry) -> None:
        with self._lock:
            self._filling.pop(entry.key, None)
        with entry.cond:
            entry.state = _FAILED
            entry.cond.notify_all()

    def _note_follower(self, hit: bool) -> None:
        with self._lock:
            self._stats["hits" if hit else "misses"] += 1

    # -- invalidation --------------------------------------------------------
    def drop_tag(self, tag: Optional[str]) -> int:
        """Drop every committed entry filed under ``tag`` (the frontends
        tag by voice id: UnloadVoice must purge the voice's streams, or
        a model reloaded at the same config path — same voice id —
        would replay the OLD model's audio as hits).  A fill still in
        flight keeps streaming to its clients, but its entry is marked
        invalidated so its commit refuses to insert.  Returns the number
        of committed entries dropped."""
        if tag is None:
            return 0
        with self._lock:
            doomed = [k for k, e in self._entries.items() if e.tag == tag]
            for k in doomed:
                self._unlink_locked(k)
            self._stats["invalidations"] += len(doomed)
            for e in self._filling.values():
                if e.tag == tag:
                    e.invalidated = True
            return len(doomed)

    # -- introspection / metrics ---------------------------------------------
    def stat(self, name: str) -> float:
        with self._lock:
            return float(self._stats[name])

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def hit_ratio(self) -> Optional[float]:
        """hits / (hits + misses), or None before any lookup resolved."""
        with self._lock:
            total = self._stats["hits"] + self._stats["misses"]
            if total == 0:
                return None
            return self._stats["hits"] / total

    def cache_view(self) -> dict:
        """One snapshot for the scope plane's ``synth_cache`` rows.

        ``hot_keys`` is the LRU head — up to :data:`HOT_KEYS_MAX` keys,
        most-recently-used first.  It rides the scope export so the mesh
        router's fleetcache can see each node's hot set and replicate it
        to the rendezvous peer (sonata-fleetcache)."""
        with self._lock:
            ratio = None
            total = self._stats["hits"] + self._stats["misses"]
            if total:
                ratio = round(self._stats["hits"] / total, 6)
            hot = list(self._entries)[-HOT_KEYS_MAX:]
            hot.reverse()
            view = {**self._stats, "hit_ratio": ratio,
                    "bytes": self._bytes, "entries": len(self._entries),
                    "max_bytes": self.max_bytes,
                    "filling": len(self._filling),
                    "hot_keys": hot}
            if self._owner_bytes:
                # per-tenant resident bytes (chargeback rows; absent
                # pre-tenancy — importers use .get, no shape break)
                view["owner_bytes"] = dict(sorted(
                    self._owner_bytes.items()))
            return view

    def bind_metrics(self, registry) -> None:
        """Attach the cache's series as scrape-time callbacks.  The
        series exist only on cache-enabled processes (the knob/metric
        pair appears and disappears together); they are process-lifetime
        like the failpoint counters, so there is no per-voice teardown
        to record — :meth:`close` ends the process's cache story whole."""
        registry.counter(
            "sonata_synth_cache_hits_total",
            "Synthesis-cache lookups served from a committed entry "
            "(including single-flight followers served whole from a "
            "filling entry)."
        ).set_function(lambda: self.stat("hits"))
        registry.counter(
            "sonata_synth_cache_misses_total",
            "Synthesis-cache lookups that ran a real synthesis "
            "(including degraded lookups and follower fallbacks)."
        ).set_function(lambda: self.stat("misses"))
        registry.counter(
            "sonata_synth_cache_inserts_total",
            "Fully-successful synthesis streams committed into the "
            "cache (write-through; failed/cancelled streams never "
            "insert)."
        ).set_function(lambda: self.stat("inserts"))
        registry.counter(
            "sonata_synth_cache_evictions_total",
            "Entries evicted LRU-first to hold the "
            "SONATA_SYNTH_CACHE_MB byte budget."
        ).set_function(lambda: self.stat("evictions"))
        registry.gauge(
            "sonata_synth_cache_bytes",
            "Committed synthesis-cache bytes (chunk payloads + "
            "per-chunk overhead) currently resident."
        ).set_function(lambda: float(self.bytes_used))

    def close(self) -> None:
        """Drop every committed entry and refuse further inserts.
        In-flight fills resolve against their own entry objects; their
        commit lands on a closed registry and is discarded."""
        with self._lock:
            self._closed = True
            self._entries.clear()
            self._owner_bytes.clear()
            self._bytes = 0
