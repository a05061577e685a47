"""sonata-fleetcache: cache-affinity routing, router single-flight, and
hot-set replication over the mesh.

The synthesis cache (``serving/synthcache.py``) is strictly
per-node: behind the mesh router, least-outstanding routing sprays
identical requests across N backends, so the fleet pays up to N misses
per template and the effective hit ratio divides by fleet size.  This
module makes the cache a fleet property:

- **Cache-affinity routing.**  The router derives the canonical
  cache key itself — every key input is in the decoded request plus the
  per-voice options it learns from ``VoiceInfo``/``SetSynthesisOptions``
  responses (:class:`VoiceKeyInfo`) — and rendezvous-hashes (HRW,
  blake2b) *cacheable* requests over the routable membership, so
  repeats of a template land on the node already holding its entry.
  The derivation is byte-identical to the node's
  (``synthcache.utterance_key`` is shared; the scales are canonicalized
  through float32, the wire precision — pinned by
  tests/test_fleetcache.py).  A **load-skew guard** keeps a hot
  template from wedging one node: when the affinity target's
  outstanding count exceeds the fleet minimum by more than
  ``SONATA_FLEETCACHE_SKEW`` slots, the request falls back to plain
  least-outstanding routing.  Non-cacheable requests (unknown voice,
  unresolvable speaker) and cache-off deployments keep routing
  byte-for-byte.
- **Router single-flight.**  N concurrent identical requests fleet-wide
  admit ONE backend synthesis: the leader's chunks are teed through a
  router-side fill handle; followers stream from it with the
  bounded-wait / leader-failure semantics (``synthcache``'s
  ``FillHandle``/``FollowerStream`` are reused against this class —
  the router never *stores* committed streams, the backend caches do).
- **Hot-set replication.**  Each node's synthcache advertises its LRU
  head (``hot_keys`` in the scope export, scraped by the fleetscope);
  riding the per-node prober threads on its own cadence (the placement
  reconciler's anti-entropy pattern, shared via
  :class:`~.placement.ProbeCadence`), the router replays up to
  ``SONATA_FLEETCACHE_REPLICATE_K`` hot templates to the key's next
  rendezvous peer — so a SIGKILLed node's hot set survives its
  restart, and affinity failover (HRW over the remaining nodes IS the
  peer preference order) finds a warm peer instead of a cold miss.
- **Failure posture.**  The whole tier is advisory: the
  ``mesh.cache_affinity`` failpoint fires inside key derivation, and
  ANY error there (injected or real) degrades that request to plain
  least-outstanding routing — a broken affinity tier can never fail a
  request.  Replication failures are counted, never raised.
- **Observability.**  ``sonata_fleetcache_{affinity_hits,
  skew_fallbacks,replications}_total`` on the metrics plane, and a
  fleet cache rollup (fleet hit ratio, per-node affinity share,
  cache-byte totals) on ``/debug/fleet`` via the fleetscope.

Nothing here imports gRPC or jax; the replication transport is a
callable supplied by the frontend (``mesh_server``), like the
placement plane's ``apply_*`` ops.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional

from . import faults, synthcache
from .placement import ProbeCadence

log = logging.getLogger("sonata.serving")

FLEETCACHE_ENV = "SONATA_FLEETCACHE"
SKEW_ENV = "SONATA_FLEETCACHE_SKEW"
REPLICATE_K_ENV = "SONATA_FLEETCACHE_REPLICATE_K"

DEFAULT_SKEW = 4
#: how often (per node) the prober-riding replication pass runs; a
#: constant like the fleetscope's scrape cadence floor, not a knob —
#: replication is anti-entropy, not a latency path
DEFAULT_REPLICATE_INTERVAL_S = 2.0
#: bounded memory of key -> (rpc, encoded request) for replication
#: replay (digest keys are not invertible, so the router remembers the
#: payloads it derived keys from, LRU-bounded)
PAYLOAD_MEMORY_MAX = 512

#: fleet-cache counter families, loop-registered like the mesh
#: router's MESH_COUNTER_FAMILIES so the sonata-lint metricsdoc pass
#: resolves the names
FLEETCACHE_COUNTER_FAMILIES = (
    ("sonata_fleetcache_affinity_hits_total", "affinity_hits",
     "Cacheable requests routed to their rendezvous affinity node "
     "(repeats of a template land on the node holding its entry)."),
    ("sonata_fleetcache_skew_fallbacks_total", "skew_fallbacks",
     "Cacheable requests that fell back to least-outstanding routing "
     "because the affinity target's outstanding count exceeded the "
     "fleet minimum by more than SONATA_FLEETCACHE_SKEW slots."),
    ("sonata_fleetcache_replications_total", "replications",
     "Hot cache templates replayed to their next rendezvous peer by "
     "the prober-riding hot-set replication pass."),
)


def resolve_enabled() -> bool:
    """``SONATA_FLEETCACHE`` (the one default-defining read): 0 / unset
    / unparseable = off — the router's request path is then
    byte-for-byte the one."""
    raw = os.environ.get(FLEETCACHE_ENV, "").strip()
    if not raw:
        return False
    try:
        return int(raw) != 0
    except ValueError:
        log.warning("ignoring non-numeric %s=%r (fleetcache stays off)",
                    FLEETCACHE_ENV, raw)
        return False


def resolve_skew() -> int:
    """``SONATA_FLEETCACHE_SKEW``: how many outstanding slots above the
    fleet minimum the affinity target may carry before a cacheable
    request falls back to least-outstanding routing."""
    try:
        return max(0, int(os.environ.get(SKEW_ENV, DEFAULT_SKEW)))
    except ValueError:
        return DEFAULT_SKEW


def resolve_replicate_k() -> int:
    """``SONATA_FLEETCACHE_REPLICATE_K``: how many LRU-head templates
    per node the replication pass keeps warm on the next rendezvous
    peer.  0 / unset = replication off (affinity + single-flight still
    run)."""
    try:
        return max(0, int(os.environ.get(REPLICATE_K_ENV, "0")))
    except ValueError:
        return 0


def hrw_score(key: str, addr: str) -> int:
    """Rendezvous (highest-random-weight) score of ``addr`` for
    ``key``: a blake2b draw, not Python ``hash()`` — every router in a
    fleet must agree on the preference order, across processes and
    restarts.  Hashed over the node's configured ``host:port`` (stable
    for the router's lifetime), never the scraped node id (which
    mutates when a probe learns the backend's real id)."""
    blob = f"{key}\x1f{addr}".encode("utf-8")
    return int.from_bytes(
        hashlib.blake2b(blob, digest_size=8).digest(), "big")


class VoiceKeyInfo:
    """The per-voice half of the cache-key derivation, learned from the
    wire: current speaker (resolved to its id like the node resolves
    it), scales at wire (float32) precision, and the output audio
    format.  ``cacheable`` is False when the router could not resolve
    the speaker name — such a voice routes style rather than risk
    a key that disagrees with the node's."""

    __slots__ = ("voice_id", "speaker", "length_scale", "noise_scale",
                 "noise_w", "sample_rate", "sample_width", "channels",
                 "name_to_id", "cacheable")

    def __init__(self, voice_id: str):
        self.voice_id = voice_id
        self.speaker: Optional[int] = None
        self.length_scale = 1.0
        self.noise_scale = 0.667
        self.noise_w = 0.8
        self.sample_rate = 0
        self.sample_width = 0
        self.channels = 0
        #: speaker name -> id, inverted from the wire's id -> name map
        self.name_to_id: Dict[str, int] = {}
        self.cacheable = True

    def resolve_speaker(self, name: Optional[str]) -> None:
        """Mirror the node's ``SetSynthesisOptions`` resolution: map
        name -> id, fall back to a literal numeric name, and mark the
        voice non-cacheable when neither works (the node knows speakers
        the wire map does not; guessing would split identity)."""
        if not name:
            self.speaker = None
            self.cacheable = True
            return
        sid = self.name_to_id.get(name)
        if sid is None and name.isdigit():
            sid = int(name)
        self.speaker = sid
        self.cacheable = sid is not None


class FleetCache:
    """The router-side fleet cache tier over a
    :class:`~sonata_tpu_torch.serving.mesh.MeshRouter`.

    Lock discipline: :meth:`affinity_choice_locked` runs under the
    ROUTER lock (called from ``pick``); this class's own lock is a leaf
    — it is never held while acquiring the router lock, so the nesting
    order router -> fleetcache can never invert."""

    def __init__(self, router, *, fleet=None,
                 skew: Optional[int] = None,
                 replicate_k: Optional[int] = None,
                 replicate_interval_s: float = DEFAULT_REPLICATE_INTERVAL_S,
                 wait_s: Optional[float] = None,
                 clock=None):
        self.router = router
        #: the fleetscope (scrape plane) — where node hot-set
        #: advertisements come from; None disables replication only
        self.fleet = fleet
        self.skew = (skew if skew is not None else resolve_skew())
        self.replicate_k = (replicate_k if replicate_k is not None
                            else resolve_replicate_k())
        self.wait_s = (wait_s if wait_s is not None
                       else synthcache.resolve_wait_s())
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._closed = False
        #: voice_id -> VoiceKeyInfo (the wire-learned key inputs)
        self._voices: Dict[str, VoiceKeyInfo] = {}
        #: router-side single-flight: key -> the entry a leader fills
        self._flight: Dict[str, synthcache._Entry] = {}
        #: key -> (rpc name, encoded request) for replication replay,
        #: LRU-bounded at PAYLOAD_MEMORY_MAX
        self._payloads: "OrderedDict[str, tuple]" = OrderedDict()
        #: key -> addr it was last replicated to (re-replicated when
        #: the rendezvous target moves after membership change)
        self._replicated: Dict[str, str] = {}
        #: addr -> cacheable requests affinity-routed there
        self._affinity_share: Dict[str, int] = {}
        self._cadence = ProbeCadence(replicate_interval_s,
                                     clock=self._clock)
        self._transport: Optional[Callable] = None
        self.stats = {"affinity_hits": 0, "skew_fallbacks": 0,
                      "replications": 0, "replication_failures": 0,
                      "affinity_errors": 0, "uncacheable": 0,
                      "singleflight_leads": 0, "singleflight_follows": 0,
                      "follower_hits": 0, "follower_fallbacks": 0}

    # -- voice registry (the wire-learned key inputs) --------------------------
    def learn_voice(self, info) -> None:
        """Record a voice's key inputs from a ``VoiceInfo`` response
        (LoadVoice fan-out, placement replay).  Duck-typed on the
        message object so this module never imports the codec."""
        try:
            opts, audio = info.synth_options, info.audio
            if not info.voice_id or opts is None or audio is None:
                return
            vki = VoiceKeyInfo(info.voice_id)
            vki.name_to_id = {name: int(sid) for sid, name
                              in (info.speakers or {}).items()}
            vki.length_scale = float(opts.length_scale)
            vki.noise_scale = float(opts.noise_scale)
            vki.noise_w = float(opts.noise_w)
            vki.sample_rate = int(audio.sample_rate)
            vki.sample_width = int(audio.sample_width)
            vki.channels = int(audio.num_channels)
            vki.resolve_speaker(opts.speaker or None)
            with self._lock:
                self._voices[info.voice_id] = vki
        except Exception:
            log.debug("fleetcache: unusable VoiceInfo ignored",
                      exc_info=True)

    def update_options(self, voice_id: str, opts) -> None:
        """Fold a node-resolved ``SetSynthesisOptions`` response (the
        full post-update option set) into the voice's record."""
        try:
            with self._lock:
                vki = self._voices.get(voice_id)
            if vki is None or opts is None:
                return
            vki.length_scale = float(opts.length_scale)
            vki.noise_scale = float(opts.noise_scale)
            vki.noise_w = float(opts.noise_w)
            vki.resolve_speaker(opts.speaker or None)
        except Exception:
            log.debug("fleetcache: unusable SynthesisOptions ignored",
                      exc_info=True)

    def forget_voice(self, voice_id: str) -> None:
        with self._lock:
            self._voices.pop(voice_id, None)

    # -- key derivation + affinity choice --------------------------------------
    def routing_key(self, kind: str, request) -> Optional[str]:
        """The router-derived cache key for one decoded request, or
        None when the request is not cacheable (unknown voice,
        unresolvable speaker) — None keeps routing byte-for-byte.
        Fires the ``mesh.cache_affinity`` failpoint; ANY error (injected
        or real) degrades to None — a broken affinity tier can never
        fail a request."""
        try:
            faults.fire("mesh.cache_affinity")
            with self._lock:
                vki = self._voices.get(request.voice_id or "")
            if vki is None or not vki.cacheable:
                with self._lock:
                    self.stats["uncacheable"] += 1
                return None
            return synthcache.utterance_key(
                kind, request, voice_id=vki.voice_id,
                speaker=vki.speaker, length_scale=vki.length_scale,
                noise_scale=vki.noise_scale, noise_w=vki.noise_w,
                sample_rate=vki.sample_rate,
                sample_width=vki.sample_width, channels=vki.channels)
        except Exception:
            with self._lock:
                self.stats["affinity_errors"] += 1
            log.debug("fleetcache: key derivation degraded to "
                      "least-outstanding routing", exc_info=True)
            return None

    def affinity_choice_locked(self, key: str, routable: list):
        """The rendezvous owner of ``key`` among ``routable`` (CLOSED,
        healthy nodes — the caller's candidate list), or None to fall
        back to least-outstanding: skew guard tripped, empty list, or
        any internal error.  Runs under the router lock."""
        try:
            if not routable:
                return None
            owner = max(routable,
                        key=lambda n: hrw_score(key, n.spec.addr))
            floor = min(n.outstanding for n in routable)
            if owner.outstanding - floor > self.skew:
                with self._lock:
                    self.stats["skew_fallbacks"] += 1
                return None
            with self._lock:
                self.stats["affinity_hits"] += 1
                self._affinity_share[owner.spec.addr] = \
                    self._affinity_share.get(owner.spec.addr, 0) + 1
            return owner
        except Exception:
            with self._lock:
                self.stats["affinity_errors"] += 1
            log.debug("fleetcache: affinity pick degraded",
                      exc_info=True)
            return None

    # -- router-side single-flight ---------------------------------------------
    def begin_stream(self, key: Optional[str]):
        """Single-flight admission for one cacheable request.  Returns
        ``("fill", FillHandle)`` for the leader (tee every forwarded
        chunk in; commit on clean completion, abort on any other exit),
        ``("follow", FollowerStream)`` when an identical request is in
        flight (bounded-wait / leader-failure semantics), or
        ``("bypass", None)``.  Unlike the node cache there is no
        committed store: a commit just releases the followers — the
        backend caches hold the streams."""
        if key is None:
            return ("bypass", None)
        with self._lock:
            if self._closed:
                return ("bypass", None)
            entry = self._flight.get(key)
            if entry is not None:
                self.stats["singleflight_follows"] += 1
                return ("follow",
                        synthcache.FollowerStream(self, entry,
                                                  self.wait_s))
            entry = synthcache._Entry(key)
            self._flight[key] = entry
            self.stats["singleflight_leads"] += 1
            return ("fill", synthcache.FillHandle(self, entry))

    # FillHandle/FollowerStream owner surface (duck-typed SynthCache)
    def _commit(self, entry) -> None:
        with self._lock:
            self._flight.pop(entry.key, None)
        with entry.cond:
            entry.state = synthcache._COMPLETE
            entry.cond.notify_all()

    def _abort(self, entry) -> None:
        with self._lock:
            self._flight.pop(entry.key, None)
        with entry.cond:
            entry.state = synthcache._FAILED
            entry.cond.notify_all()

    def _note_follower(self, hit: bool) -> None:
        with self._lock:
            self.stats["follower_hits" if hit
                       else "follower_fallbacks"] += 1

    # -- hot-set replication ---------------------------------------------------
    def set_replicate_transport(self, fn: Callable) -> None:
        """``fn(node, rpc_name, payload, key)`` replays one encoded
        request against ``node`` and drains the response stream (the
        frontend supplies real gRPC; tests supply fakes)."""
        self._transport = fn

    def note_payload(self, key: Optional[str], rpc_name: str,
                     payload: bytes) -> None:
        """Remember the encoded request behind ``key`` so the
        replication pass can replay it (keys are digests — not
        invertible).  LRU-bounded; eviction forgets the replication
        memory too so a re-hot key re-replicates."""
        if key is None:
            return
        with self._lock:
            self._payloads[key] = (rpc_name, payload)
            self._payloads.move_to_end(key)
            while len(self._payloads) > PAYLOAD_MEMORY_MAX:
                old, _ = self._payloads.popitem(last=False)
                self._replicated.pop(old, None)

    def on_probe_cycle(self, node) -> None:
        """Called by the router's prober after every health cycle; runs
        one replication pass for ``node`` on the slower cadence."""
        if (self.replicate_k <= 0 or self._transport is None
                or self.fleet is None or self._closed):
            return
        if self._cadence.due(node.index):
            self.replicate_for_node(node)

    def replicate_for_node(self, node) -> None:
        """Keep ``node``'s advertised hot set warm on each key's next
        rendezvous peer: at most ONE replay per cycle (anti-entropy,
        not a bulk copy — the placement reconciler's pacing).  Only
        keys ``node`` actually OWNS (HRW-max among routable) are
        pushed; the peer for a key is the first routable node after
        ``node`` in the key's HRW preference order — exactly where
        affinity failover lands when ``node`` dies."""
        try:
            view = self.fleet.node_cache_view(node)
            hot = (view or {}).get("hot_keys") or ()
            if not hot:
                return
            routable = self.router.routable_nodes()
            peers = [n for n in routable
                     if n.spec.addr != node.spec.addr]
            if not peers:
                return
            for key in hot[: self.replicate_k]:
                owner = max(routable,
                            key=lambda n: hrw_score(key, n.spec.addr))
                if owner.spec.addr != node.spec.addr:
                    # a key this node merely RECEIVED (by replication
                    # or skew spillover) — replicating it onward would
                    # ping-pong the copy between holders every cycle
                    # and starve the keys this node actually owns
                    continue
                target = max(peers,
                             key=lambda n: hrw_score(key, n.spec.addr))
                with self._lock:
                    if self._replicated.get(key) == target.spec.addr:
                        continue
                    payload = self._payloads.get(key)
                if payload is None:
                    continue
                rpc_name, body = payload
                try:
                    self._transport(target, rpc_name, body, key)
                    with self._lock:
                        self.stats["replications"] += 1
                        self._replicated[key] = target.spec.addr
                    log.debug(
                        "fleetcache: replicated hot entry %s from node "
                        "%s to %s", key[:12], node.node_id,
                        target.node_id)
                except Exception as e:
                    with self._lock:
                        self.stats["replication_failures"] += 1
                    log.debug("fleetcache: replication of %s to %s "
                              "failed: %s", key[:12], target.node_id, e)
                return  # one replay per cycle
        except Exception:
            log.debug("fleetcache: replication pass skipped",
                      exc_info=True)

    # -- introspection / metrics -----------------------------------------------
    def stat(self, name: str) -> float:
        with self._lock:
            return float(self.stats[name])

    def snapshot(self) -> dict:
        """One view for ``/debug/fleet``'s cache section."""
        with self._lock:
            return {"skew": self.skew,
                    "replicate_k": self.replicate_k,
                    "stats": dict(self.stats),
                    "affinity_share": dict(self._affinity_share),
                    "voices": sorted(self._voices),
                    "in_flight": len(self._flight),
                    "payload_memory": len(self._payloads)}

    def bind_metrics(self, registry) -> None:
        """Attach the fleet-cache counters as scrape-time callbacks.
        Unlabeled and process-lifetime (the failpoint-counter idiom) —
        no per-node teardown to record."""
        for name, key, help_text in FLEETCACHE_COUNTER_FAMILIES:
            registry.counter(name, help_text).set_function(
                lambda k=key: self.stat(k))

    def close(self) -> None:
        """Refuse new single-flight admissions and fail the entries in
        flight (their leaders' own streams finish through the
        transport; followers fall back or fail typed)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            doomed = list(self._flight.values())
            self._flight.clear()
        for entry in doomed:
            with entry.cond:
                if entry.state == synthcache._FILLING:
                    entry.state = synthcache._FAILED
                entry.cond.notify_all()
