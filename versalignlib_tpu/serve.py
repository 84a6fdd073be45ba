"""Microbatching alignment server (production serving surface).

ADDITIVE over the reference, which ships only a batch CLI
(/root/reference/src/impl/main.cpp:74-215). A production deployment serves
concurrent online requests, and the accelerator wants LARGE batches (the
GPU score kernel puts one pair on each thread): the two are reconciled the
way model servers do it — request coalescing.

Design:

- **One dispatcher thread owns the device.** One process per card (a JAX
  process reserves most of the card's memory); funnelling all kernel
  dispatch through one thread serializes device access by construction,
  no locks around JAX.
- **Deadline microbatching.** Requests queue up; the dispatcher drains the
  queue, waits at most ``max_wait_ms`` from the first pending request
  (latency bound) or until ``max_batch`` pairs accumulate (throughput
  bound), then groups compatible requests — same (algorithm, mode) — into
  one engine call each. The engine's own chunking handles oversized groups.
- **Shape bucketing.** Sequence lengths are padded up to power-of-two
  buckets (min 32) so XLA's compile cache sees a bounded set of shapes
  instead of one compile per novel request length. Padding scores zero in
  the DP (reference tail-fill semantics), so bucketing is free of
  semantics.
- **Backpressure.** The queue is bounded; a full queue rejects immediately
  (HTTP 503) instead of building an unbounded latency tail.

The HTTP layer is intentionally stdlib-only (``http.server`` threading
server): zero deployment dependencies, JSON in/out. For multi-host serving
put a load balancer in front of one server per GPU.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Sequence

import numpy as np

from versalignlib_tpu.dispatch import AlignmentEngine, supports_raw
from versalignlib_tpu.types import Algorithm, Alignment
from versalignlib_tpu.utils.logging import get_logger

_log = get_logger("serve")

#: Request modes: score-only (int per pair), full traceback, or
#: CIGAR-only traceback (no gapped strings — the native walk skips their
#: emission entirely; smaller responses for SAM-bound clients).
MODES = ("score", "align", "align_cigar")

_ALGO_NAMES = {
    "sw": Algorithm.SMITH_WATERMAN,
    "smith_waterman": Algorithm.SMITH_WATERMAN,
    "nw": Algorithm.NEEDLEMAN_WUNSCH,
    "needleman_wunsch": Algorithm.NEEDLEMAN_WUNSCH,
}


def parse_algorithm(name) -> Algorithm:
    """'sw'/'nw' (or full names / Algorithm values) -> Algorithm."""
    if isinstance(name, Algorithm):
        return name
    if isinstance(name, str):
        try:
            return _ALGO_NAMES[name.lower()]
        except KeyError:
            raise ValueError(
                f"unknown algorithm {name!r}; expected one of "
                f"{sorted(_ALGO_NAMES)}") from None
    return Algorithm(name)


def _resolve(fut: Future, value=None, exc=None) -> None:
    """set_result/set_exception tolerant of a concurrent fut.cancel():
    cancelled() can flip between a check and the set (the HTTP side cancels
    on timeout), and an InvalidStateError would kill the dispatcher."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except Exception:  # cancelled/already-resolved: result is abandoned
        pass


def _bucket(n: int, floor: int = 32) -> int:
    """Next power of two >= max(n, floor) — the shape-bucketing rule."""
    b = floor
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class _Pending:
    reads: list[str]
    refs: list[str]
    algorithm: Algorithm
    mode: str
    future: Future
    enqueued_at: float
    fn: object = None  # mode == "call": closure run on the dispatcher


class BatchingAligner:
    """Coalesces concurrent align/score requests into device microbatches.

    ``submit`` is thread-safe and returns a ``concurrent.futures.Future``;
    the dispatcher thread groups pending requests by (algorithm, mode),
    pads each group to a common power-of-two length bucket, runs ONE engine
    call per group, and scatters results back per request.

    Parameters
    ----------
    engine: the AlignmentEngine to dispatch on (its params/tie/backend are
        fixed for the server's lifetime, like weights in a model server).
    max_batch: pair-count high-water mark — the dispatcher stops waiting
        and fires as soon as this many pairs are pending.
    max_wait_ms: latency bound — a batch fires at most this long after its
        oldest request arrived, full or not.
    max_queue: bound on queued REQUESTS; beyond it ``submit`` raises
        ``queue.Full`` (surfaced as HTTP 503 by the server).
    start: tests pass False to enqueue deterministically before starting
        the dispatcher.
    """

    def __init__(
        self,
        engine: AlignmentEngine,
        max_batch: int = 4096,
        max_wait_ms: float = 5.0,
        max_queue: int = 1024,
        start: bool = True,
    ) -> None:
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self._queue: queue.Queue[_Pending | None] = queue.Queue(
            maxsize=int(max_queue))
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0, "pairs": 0, "batches": 0, "batched_pairs": 0,
            "errors": 0, "max_batch_pairs": 0, "latency_sum_s": 0.0,
            "latency_max_s": 0.0,
            # split: how long requests sat in the queue before their batch
            # fired (dispatcher behavior) vs how long the device batch took
            # (device + transfers) — conflating the two makes device time
            # look like dispatcher latency.
            "queue_wait_sum_s": 0.0, "queue_wait_max_s": 0.0,
            "device_sum_s": 0.0, "device_max_s": 0.0,
        }
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="versalign-dispatch", daemon=True)
        if start:
            self._thread.start()

    # -- client side -------------------------------------------------------

    def submit(self, reads: Sequence[str], refs: Sequence[str],
               algorithm="sw", mode: str = "score") -> Future:
        """Enqueue one request; returns a Future resolving to
        ``list[int]`` (score mode) or ``list[Alignment]`` (align mode)."""
        if self._closed:
            raise RuntimeError("BatchingAligner is closed")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        reads = list(reads)
        refs = list(refs)
        if len(reads) != len(refs):
            raise ValueError(
                f"read/ref counts differ: {len(reads)} vs {len(refs)}")
        algorithm = parse_algorithm(algorithm)
        fut: Future = Future()
        if not reads:  # empty request: resolve immediately, skip the device
            fut.set_result([])
            return fut
        req = _Pending(reads, refs, algorithm, mode, fut, time.monotonic())
        self._queue.put_nowait(req)  # raises queue.Full on backpressure
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["pairs"] += len(reads)
        return fut

    def submit_call(self, fn) -> Future:
        """Run an arbitrary device-using closure ON the dispatcher thread.

        The dispatcher is the only thread that touches the device, so
        non-batchable work (e.g. a panel-mapping request, which carries its
        own panel and cannot coalesce with other requests) enqueues here
        and executes serialized with the microbatches, in arrival order.
        """
        if self._closed:
            raise RuntimeError("BatchingAligner is closed")
        fut: Future = Future()
        self._queue.put_nowait(_Pending([], [], Algorithm.SMITH_WATERMAN,
                                        "call", fut, time.monotonic(), fn))
        with self._stats_lock:
            self._stats["requests"] += 1
        return fut

    def score(self, reads, refs, algorithm="sw") -> list[int]:
        """Blocking convenience wrapper around ``submit(mode='score')``."""
        return self.submit(reads, refs, algorithm, "score").result()

    def align(self, reads, refs, algorithm="sw") -> list[Alignment]:
        """Blocking convenience wrapper around ``submit(mode='align')``.

        The dispatcher resolves align futures with an
        :class:`~versalignlib_tpu.types.AlignmentBatch` slice when the raw
        column-store path is available; this wrapper materializes
        ``Alignment`` objects either way."""
        out = self.submit(reads, refs, algorithm, "align").result()
        return out if isinstance(out, list) else list(out)

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
        s["queue_depth"] = self._queue.qsize()
        if s["batches"]:
            s["mean_batch_pairs"] = s["batched_pairs"] / s["batches"]
            s["mean_latency_s"] = s["latency_sum_s"] / s["batches"]
            s["mean_device_s"] = s["device_sum_s"] / s["batches"]
        if s["requests"]:
            s["mean_queue_wait_s"] = s["queue_wait_sum_s"] / s["requests"]
        return s

    def close(self, timeout: float = 10.0) -> None:
        """Drain outstanding work and stop the dispatcher."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)  # sentinel
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher side ----------------------------------------------------

    def start(self) -> None:
        """Start the dispatcher (only needed with ``start=False``)."""
        if not self._thread.is_alive():
            self._thread.start()

    def _run(self) -> None:
        while True:
            try:
                first = self._queue.get()
            except Exception:  # interpreter shutdown
                return
            if first is None:
                self._drain_after_close()
                return
            batch = [first]
            pairs = len(first.reads)
            deadline = first.enqueued_at + self.max_wait
            # Accumulate until the deadline or the pair high-water mark.
            while pairs < self.max_batch:
                timeout = deadline - time.monotonic()
                try:
                    nxt = (self._queue.get_nowait() if timeout <= 0
                           else self._queue.get(timeout=timeout))
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(batch)
                    self._drain_after_close()
                    return
                batch.append(nxt)
                pairs += len(nxt.reads)
            self._dispatch(batch)

    def _drain_after_close(self) -> None:
        """Fail any request that raced past the ``_closed`` check and
        landed behind the shutdown sentinel — its submitter would
        otherwise block until its own timeout."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                _resolve(req.future, exc=RuntimeError(
                    "BatchingAligner closed during submit"))

    def _dispatch(self, batch: list[_Pending]) -> None:
        groups: dict[tuple[Algorithm, str], list[_Pending]] = {}
        for req in batch:
            if req.mode == "call":
                # Exclusive device closures run individually, in order.
                t0 = time.monotonic()
                try:
                    result = req.fn()
                except Exception as exc:
                    with self._stats_lock:
                        self._stats["errors"] += 1
                    _resolve(req.future, exc=exc)
                    continue
                with self._stats_lock:
                    s = self._stats
                    s["batches"] += 1
                    dt = time.monotonic() - t0
                    s["latency_sum_s"] += dt
                    s["device_sum_s"] += dt
                    s["device_max_s"] = max(s["device_max_s"], dt)
                    w = t0 - req.enqueued_at
                    s["queue_wait_sum_s"] += w
                    s["queue_wait_max_s"] = max(s["queue_wait_max_s"], w)
                _resolve(req.future, result)
                continue
            groups.setdefault((req.algorithm, req.mode), []).append(req)
        for (algorithm, mode), reqs in groups.items():
            self._run_group(algorithm, mode, reqs)

    def _run_group(self, algorithm: Algorithm, mode: str,
                   reqs: list[_Pending]) -> None:
        from versalignlib_tpu.alphabet import pad_and_encode

        t0 = time.monotonic()
        try:
            all_reads = [s for r in reqs for s in r.reads]
            all_refs = [s for r in reqs for s in r.refs]
            n_pairs = len(all_reads)
            # Bucket the pair COUNT as well as the lengths: the jit cache
            # keys on the full batch shape, so unbucketed counts would
            # compile once per distinct coalesced batch size. Padding
            # pairs are all-0 codes (score 0, per-pair independent) and
            # their results are sliced off.
            pad = _bucket(n_pairs, floor=8) - n_pairs
            all_reads = all_reads + [""] * pad
            all_refs = all_refs + [""] * pad
            reads_enc = pad_and_encode(
                all_reads, _bucket(max(len(s) for s in all_reads)))
            refs_enc = pad_and_encode(
                all_refs, _bucket(max(len(s) for s in all_refs)))
            if mode == "score":
                out = self.engine.score_alignments(
                    algorithm, reads_enc, refs_enc)
                results = [int(v) for v in out[:n_pairs]]
            else:
                # Raw column-store path (device backend + native
                # decoder): no per-pair Alignment objects on the serving
                # hot path — futures resolve to AlignmentBatch slices and
                # the HTTP layer serializes straight from the columns.
                # Materialized objects otherwise. "align_cigar" decodes
                # CIGAR-only (gapped=False): the walk never emits gapped
                # strings.
                if supports_raw(self.engine.backend):
                    results = self.engine.compute_alignments(
                        algorithm, reads_enc, refs_enc, raw=True,
                        gapped=(mode == "align")).slice(0, n_pairs)
                else:
                    results = self.engine.compute_alignments(
                        algorithm, reads_enc, refs_enc)[:n_pairs]
        except Exception as exc:
            _log.error("batch of %d requests failed: %s", len(reqs), exc)
            with self._stats_lock:
                self._stats["errors"] += len(reqs)
            for r in reqs:
                _resolve(r.future, exc=exc)
            return
        dt = time.monotonic() - t0
        with self._stats_lock:
            s = self._stats
            s["batches"] += 1
            s["batched_pairs"] += n_pairs
            s["max_batch_pairs"] = max(s["max_batch_pairs"], n_pairs)
            s["latency_sum_s"] += dt
            s["latency_max_s"] = max(s["latency_max_s"], dt)
            s["device_sum_s"] += dt
            s["device_max_s"] = max(s["device_max_s"], dt)
            for r in reqs:
                w = t0 - r.enqueued_at
                s["queue_wait_sum_s"] += w
                s["queue_wait_max_s"] = max(s["queue_wait_max_s"], w)
        raw_batch = not isinstance(results, list)
        lo = 0
        for r in reqs:
            hi = lo + len(r.reads)
            _resolve(r.future,
                     results.slice(lo, hi) if raw_batch else results[lo:hi])
            lo = hi


# ---------------------------------------------------------------------------
# HTTP front end (stdlib-only)
# ---------------------------------------------------------------------------

def _alignment_json(a: Alignment, gapped: bool = True) -> dict:
    row = {
        "score": a.score, "cigar": a.cigar,
        "read_start": a.read_start, "read_end": a.read_end,
        "ref_start": a.ref_start, "ref_end": a.ref_end,
    }
    if gapped:
        row["read"] = a.read
        row["ref"] = a.ref
    return row


class AlignServer:
    """HTTP JSON server over a :class:`BatchingAligner`.

    Endpoints::

        POST /v1/score  {"reads": [...], "refs": [...], "algorithm": "sw"}
            -> {"scores": [...]}
        POST /v1/align  (same body; optional "fields": "cigar" skips the
                         gapped read/ref strings — CIGAR-only native decode)
            -> {"alignments": [{read, ref, score, cigar, ...}, ...]}
        POST /v1/map    {"reads": [...], "panel": [...], "algorithm": "sw",
                         "both_strands": true, "align": false}
            -> {"hits": [{index, score, strand, mapq[, alignment]}, ...]}
        GET  /healthz   -> {"ok": true, "backend": ..., "platform": ...}
        GET  /stats     -> batching counters

    Concurrent requests ride the threading HTTP server; the device sees
    only the dispatcher's coalesced batches. 400 = malformed request,
    413 = request exceeds ``max_request_pairs``, 503 = backpressure.
    """

    MAX_BODY_BYTES = 64 << 20

    def __init__(self, aligner: BatchingAligner, host: str = "127.0.0.1",
                 port: int = 0, max_request_pairs: int = 100_000,
                 max_map_cross: int = 10_000_000,
                 request_timeout_s: float = 300.0) -> None:
        import http.server

        self.aligner = aligner
        self.max_request_pairs = max_request_pairs
        #: /v1/map work bound: reads x panel x strands per request — a map
        #: request runs exclusively on the dispatcher, so this is the
        #: head-of-line blocking budget, not a memory bound.
        self.max_map_cross = max_map_cross
        self.request_timeout_s = request_timeout_s
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through our logger
                _log.info("%s %s", self.address_string(), fmt % args)

            def _reply(self, code: int, payload: dict,
                       close: bool = False) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if close:
                    # Replying without consuming the request body desyncs a
                    # kept-alive HTTP/1.1 connection; close it instead.
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(body)

            def _read_json(self):
                """Parse the request body; replies and returns None on
                errors (bad length, oversized, malformed JSON)."""
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    self._reply(400, {"error": "bad Content-Length"},
                                close=True)
                    return None
                if length > AlignServer.MAX_BODY_BYTES:
                    self._reply(413, {"error": "request body too large"},
                                close=True)
                    return None
                try:
                    return json.loads(self.rfile.read(length))
                except json.JSONDecodeError as exc:
                    self._reply(400, {"error": str(exc)})
                    return None

            def _await(self, fut):
                """Resolve a dispatcher future into (ok, result); replies
                on timeout/error."""
                try:
                    return True, fut.result(timeout=outer.request_timeout_s)
                except (TimeoutError, FutureTimeout):
                    # both names: futures.TimeoutError only aliases the
                    # builtin from 3.11
                    fut.cancel()
                    self._reply(503, {"error": "batch timed out"})
                except Exception as exc:
                    self._reply(500, {"error": str(exc)})
                return False, None

            def _do_map(self):
                req = self._read_json()
                if req is None:
                    return
                try:
                    reads = req["reads"]
                    panel = req["panel"]
                    algorithm = parse_algorithm(req.get("algorithm", "sw"))
                    both = bool(req.get("both_strands", True))
                    want_align = bool(req.get("align", False))
                    if not isinstance(reads, list) or not isinstance(
                            panel, list):
                        raise ValueError("reads/panel must be lists")
                    if not all(isinstance(s, str) for s in reads + panel):
                        raise ValueError("sequences must be strings")
                except (KeyError, ValueError) as exc:
                    self._reply(400, {"error": str(exc)})
                    return
                cross = len(reads) * len(panel) * (2 if both else 1)
                if cross > outer.max_map_cross:
                    self._reply(413, {
                        "error": f"{len(reads)} reads x {len(panel)} panel "
                                 f"entries x {2 if both else 1} strand(s) "
                                 f"= {cross} pairs exceeds the per-request "
                                 f"limit {outer.max_map_cross} (split it)"})
                    return
                engine = outer.aligner.engine

                def run():
                    import dataclasses as _dc

                    from versalignlib_tpu.alphabet import pad_and_encode
                    from versalignlib_tpu.search import map_reads

                    # Shape bucketing, like the score/align paths: pad read
                    # count and both length axes to power-of-two buckets so
                    # novel request shapes don't each compile fresh XLA
                    # programs while holding the dispatcher. Padding reads
                    # are all-0 codes (score 0, per-read independent) and
                    # are sliced off. Panel COUNT stays exact — a panel is
                    # usually a fixed database, and padded entries would
                    # perturb MAPQ's second-best.
                    if not reads or not panel:
                        # Degenerate request: the search layer's empty-
                        # input path handles it without touching the device.
                        return map_reads(
                            reads, panel, engine.params, algorithm,
                            backend=engine.backend.name, tie=engine.tie,
                            both_strands=both, align=want_align)
                    n_r = len(reads)
                    b_pad = _bucket(n_r, floor=8)
                    reads_enc = pad_and_encode(
                        reads + [""] * (b_pad - n_r),
                        _bucket(max(len(s) for s in reads)))
                    panel_enc = pad_and_encode(
                        panel, _bucket(max(len(s) for s in panel)))
                    hits = map_reads(
                        reads_enc, panel_enc, engine.params, algorithm,
                        backend=engine.backend.name, tie=engine.tie,
                        both_strands=both, align=want_align)
                    return _dc.replace(
                        hits, index=hits.index[:n_r],
                        score=hits.score[:n_r], strand=hits.strand[:n_r],
                        mapq=hits.mapq[:n_r],
                        alignments=(hits.alignments[:n_r]
                                    if hits.alignments is not None
                                    else None))

                try:
                    fut = outer.aligner.submit_call(run)
                except queue.Full:
                    self._reply(503, {"error": "server overloaded; retry"})
                    return
                ok, hits = self._await(fut)
                if not ok:
                    return
                out = []
                for i in range(len(hits)):
                    h = {"index": int(hits.index[i]),
                         "score": int(hits.score[i]),
                         "strand": int(hits.strand[i]),
                         "mapq": int(hits.mapq[i])}
                    if want_align:
                        h["alignment"] = _alignment_json(hits.alignments[i])
                    out.append(h)
                self._reply(200, {"hits": out})

            def do_GET(self):
                if self.path == "/healthz":
                    import jax

                    self._reply(200, {
                        "ok": True,
                        "backend": outer.aligner.engine.backend.name,
                        "platform": jax.devices()[0].platform,
                    })
                elif self.path == "/stats":
                    self._reply(200, outer.aligner.stats())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/v1/map":
                    self._do_map()
                    return
                mode = {"/v1/score": "score", "/v1/align": "align"}.get(
                    self.path)
                if mode is None:
                    self._reply(404, {"error": "not found"})
                    return
                req = self._read_json()
                if req is None:
                    return
                if mode == "align" and req.get("fields") == "cigar":
                    mode = "align_cigar"
                try:
                    reads = req["reads"]
                    refs = req["refs"]
                    algorithm = parse_algorithm(req.get("algorithm", "sw"))
                    if not isinstance(reads, list) or not isinstance(
                            refs, list):
                        raise ValueError("reads/refs must be lists")
                    if len(reads) != len(refs):
                        raise ValueError(
                            f"read/ref counts differ: {len(reads)} vs "
                            f"{len(refs)}")
                    if not all(isinstance(s, str) for s in reads + refs):
                        raise ValueError("sequences must be strings")
                except (KeyError, ValueError) as exc:
                    self._reply(400, {"error": str(exc)})
                    return
                if len(reads) > outer.max_request_pairs:
                    self._reply(413, {
                        "error": f"request has {len(reads)} pairs; limit is "
                                 f"{outer.max_request_pairs} (split it)"})
                    return
                try:
                    fut = outer.aligner.submit(reads, refs, algorithm, mode)
                except queue.Full:
                    self._reply(503, {"error": "server overloaded; retry"})
                    return
                ok, result = self._await(fut)
                if not ok:
                    return
                if mode == "score":
                    self._reply(200, {"scores": result})
                elif isinstance(result, list):
                    self._reply(200, {"alignments": [
                        _alignment_json(a, gapped=(mode == "align"))
                        for a in result]})
                else:
                    self._reply(200, {"alignments": result.to_json_rows()})

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None
        self._serving = False

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> None:
        """Serve in a background thread (tests / embedding)."""
        self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="versalign-http",
            daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        _log.info("serving on %s:%d", *self.address)
        self._serving = True
        self._httpd.serve_forever()

    def close(self) -> None:
        if self._serving:
            # shutdown() waits on an event only serve_forever() sets on
            # exit — calling it on a never-started server deadlocks.
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.aligner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def main(argv=None) -> int:
    """``python -m versalignlib_tpu.serve`` — stand up a server."""
    import argparse

    from versalignlib_tpu.params import AlignmentParameters
    from versalignlib_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(
        prog="versalignlib_tpu.serve", description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8472)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--match", type=int, default=2)
    ap.add_argument("--mismatch", type=int, default=-1)
    ap.add_argument("--gap-read", type=int, default=-3)
    ap.add_argument("--gap-ref", type=int, default=-3)
    ap.add_argument("--gap-open", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=4096,
                    help="pair high-water mark per microbatch")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="latency bound: fire a batch at most this long "
                         "after its oldest request")
    ap.add_argument("--warm", default="",
                    help="comma-separated mxn shapes to pre-compile before "
                         "serving (e.g. '128x256,512x512') — first compiles "
                         "take seconds to minutes; warm them off the "
                         "request path")
    args = ap.parse_args(argv)
    params = AlignmentParameters(
        score_match=args.match, score_mismatch=args.mismatch,
        score_gap_read=args.gap_read, score_gap_ref=args.gap_ref,
        gap_open_read=args.gap_open, gap_open_ref=args.gap_open)
    engine = AlignmentEngine(params=params, backend=args.backend)
    for shape in filter(None, args.warm.split(",")):
        m, n = (int(v) for v in shape.lower().split("x"))
        _log.info("warming %dx%d (score + align buckets)", m, n)
        from versalignlib_tpu.types import Algorithm as _Alg

        for algo in (_Alg.SMITH_WATERMAN, _Alg.NEEDLEMAN_WUNSCH):
            engine.score_alignments(algo, ["A" * _bucket(m)],
                                    ["A" * _bucket(n)])
            engine.compute_alignments(algo, ["A" * _bucket(m)],
                                      ["A" * _bucket(n)])
    aligner = BatchingAligner(engine, max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms)
    with AlignServer(aligner, host=args.host, port=args.port) as server:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
