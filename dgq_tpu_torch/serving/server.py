"""Serving daemon: a JSON-lines TCP front end over a batcher.

Port of ``dgq_tpu/serving/server.py`` (``BatcherServer``, host-only code:
stdlib sockets and threads).  It fronts any batcher with
``check_request``, ``add_request``, ``step``, ``cancel``, ``metrics`` and
the ``queue``/``slots``/``finished``/``has_work`` state: the dense
``serving/scheduler.ContinuousBatcher`` or the paged
``serving/paged.PagedBatcher``.  One change from JAX's server: ``submit``
queues the request for the scheduler loop, as ``cancel`` does, instead of
waiting for the
loop's lock, which the loop holds for nearly all of every step; a
connection that pipelines requests would otherwise hand them over one per
several steps (on one H100, 24 pipelined requests to a 7B-shaped engine
waited a median of 15 s for their first token, 0.16 s of it after
admission).

Protocol: one JSON object per line, one response line per request.

  request  {"prompt_ids": [...], "max_new_tokens": 32,
            "eos_token_id": 2,          # optional
            "stream": true,             # optional: stream tokens as produced
            "temperature": 0.8, "top_k": 40, "top_p": 0.95}   # optional
  response {"uid": 7, "output_ids": [...], "done": true}

  With "stream": true, partial lines arrive as tokens are decoded:
  response {"uid": 7, "token_ids": [a, b], "done": false}    # 0+ times
  response {"uid": 7, "token_ids": [c], "output_ids": [a, b, c],
            "done": true}                                     # final

  request  {"op": "cancel", "uid": 7}
  response {"uid": 7, "cancelled_ok": true}      # plus the final reply for
                                                 # uid 7 with "cancelled": true
  request  {"op": "metrics"}
  response {... the batcher's metrics() ...}

A connection may pipeline multiple requests; responses arrive in
completion order tagged by uid.  Each connection has a dedicated writer
thread draining an outbound queue, so a slow client never stalls the
scheduler loop.
"""

from __future__ import annotations

import itertools
import json
import queue
import socket
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from dgq_tpu_torch.serving.scheduler import Request


class BatcherServer:
    """TCP front end over one batcher — or over N independent batcher
    REPLICAS for data-parallel serving scale-out: each replica owns its own
    device placement (e.g. a per-replica tp submesh) and scheduler loop;
    requests route to the replica with the fewest outstanding requests.
    Greedy outputs are placement-independent, so routing is invisible to
    clients."""

    def __init__(self, batcher, host: str = "127.0.0.1",
                 port: int = 0, *, idle_sleep_s: float = 0.002):
        self.replicas = list(batcher) if isinstance(batcher, (list, tuple)) else [batcher]
        self.batcher = self.replicas[0]  # the one replica of a single-batcher server
        n = len(self.replicas)
        self._locks = [threading.Lock() for _ in range(n)]  # batchers are not thread-safe
        self._uid = itertools.count()
        # uid -> (send_fn, n_tokens_already_sent); single-writer per uid
        # (the owning replica's loop), registered under that replica's lock
        self._streams: Dict[int, Tuple[Callable, int]] = {}
        # cancels are queued and drained by the owning scheduler loop: a
        # loop holds its lock nearly continuously while work exists, so a
        # cancel() that contended for the lock directly could starve until
        # the request it wants to stop has already finished
        self._cancel_qs = [queue.Queue() for _ in range(n)]
        # submissions are queued the same way, drained before the cancels
        self._submit_qs = [queue.Queue() for _ in range(n)]
        self._uid_replica: Dict[int, int] = {}
        self._outstanding = [0] * n
        # replica failover: a replica whose scheduler loop dies beyond the
        # batcher's own device recovery is marked dead and its unfinished
        # requests migrate to the survivors as continuations (prompt =
        # original prompt + tokens generated so far); _carry holds the
        # already-generated prefix to splice back at finish/stream time
        self._dead = [False] * n
        self._carry: Dict[int, list] = {}
        self._done: Dict[int, Request] = {}
        self._done_cv = threading.Condition()
        self._fatal: Optional[str] = None
        self._stop = threading.Event()
        self._idle_sleep_s = idle_sleep_s
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.2)
        self.host, self.port = self._sock.getsockname()[:2]
        self._threads = [
            threading.Thread(target=self._scheduler_loop, args=(r,), daemon=True)
            for r in range(n)
        ] + [threading.Thread(target=self._accept_loop, daemon=True)]
        for t in self._threads:
            t.start()

    # -- client-facing --------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int,
               eos_token_id: Optional[int] = None, sampling=None,
               stream_send: Optional[Callable] = None,
               stop_sequences=None) -> int:
        """``stream_send``: a callable receiving one JSON-able dict per
        partial-token update; registered before the request is queued so no
        tokens are missed.  A request the batcher can never serve raises
        ValueError here; the others go to the chosen replica's submit queue,
        which its scheduler loop drains at its next step."""
        uid = next(self._uid)
        req = Request(uid=uid, prompt_ids=np.asarray(prompt_ids, np.int32),
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id, sampling=sampling,
                      stop_sequences=stop_sequences)
        live = [i for i in range(len(self.replicas)) if not self._dead[i]]
        if not live:
            raise RuntimeError(f"all replicas dead: {self._fatal}")
        r = min(live, key=lambda i: self._outstanding[i])  # least loaded
        self.replicas[r].check_request(req)
        req.t_submit = time.time()
        if stream_send is not None:
            self._streams[uid] = (stream_send, 0)
        with self._done_cv:
            self._uid_replica[uid] = r
            self._outstanding[r] += 1
        self._submit_qs[r].put(req)
        return uid

    def cancel(self, uid: int, timeout: float = 60.0) -> bool:
        """Cancel a queued or running request; its waiter receives the final
        reply with ``cancelled: true``.  Processed by the scheduler loop
        within one step (returns False if the request already finished)."""
        r = self._uid_replica.get(uid)
        if r is None:
            return False  # unknown or already reaped
        ev = threading.Event()
        holder: list = []
        self._cancel_qs[r].put((uid, holder, ev))
        if not ev.wait(timeout):
            if self._fatal is not None:
                raise RuntimeError(f"serving loop died: {self._fatal}")
            raise TimeoutError(f"cancel({uid}) not processed in {timeout}s")
        return holder[0]

    def wait(self, uid: int, timeout: Optional[float] = None) -> Request:
        with self._done_cv:
            ok = self._done_cv.wait_for(
                lambda: uid in self._done or self._fatal is not None, timeout
            )
            if self._fatal is not None and uid not in self._done:
                raise RuntimeError(f"serving loop died: {self._fatal}")
            if not ok:
                raise TimeoutError(f"request {uid} not finished in {timeout}s")
            return self._done.pop(uid)

    def metrics(self) -> dict:
        """Thread-safe batcher metrics (the batchers themselves are not).
        With replicas, numeric fields aggregate and per-replica dicts ride
        under "replicas"."""
        per = []
        for r, b in enumerate(self.replicas):
            with self._locks[r]:
                per.append(b.metrics())
        if len(per) == 1:
            return per[0]
        agg: dict = {"replicas": per, "num_replicas": len(per),
                     "replicas_dead": sum(self._dead)}
        for key in ("tokens_generated", "requests_finished", "requests_queued",
                    "slots_active", "prefills_pending", "recoveries",
                    "tokens_per_s"):
            vals = [m.get(key) for m in per if m.get(key) is not None]
            if vals:
                agg[key] = round(sum(vals), 3) if isinstance(vals[0], float) else sum(vals)
        return agg

    def close(self, drain: bool = False, drain_timeout: float = 300.0):
        """Stop the server.  ``drain=True`` first waits (up to
        ``drain_timeout``) for every outstanding request to finish, so an
        orderly shutdown never drops accepted work."""
        if drain:
            deadline = time.time() + drain_timeout
            while (sum(self._outstanding) > 0 and self._fatal is None
                   and time.time() < deadline):
                time.sleep(0.01)
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals ------------------------------------------------------------

    def _scheduler_loop(self, ridx: int):
        b = self.replicas[ridx]
        lock = self._locks[ridx]
        while not self._stop.is_set():
            stepped = False
            try:
                with lock:
                    self._drain_submits(ridx)
                    self._drain_cancels(ridx)
                    if b.has_work:
                        b.step()
                        stepped = True
                    if self._streams:
                        self._send_stream_deltas(b)
                    finished = b.finished
                    if finished:
                        with self._done_cv:
                            for r in finished:
                                carry = self._carry.pop(r.uid, None)
                                if carry:
                                    # continuation after failover: splice the
                                    # pre-failover tokens back in front
                                    r.output_ids = list(carry) + list(r.output_ids)
                                self._done[r.uid] = r
                                self._uid_replica.pop(r.uid, None)
                                self._outstanding[ridx] -= 1
                            self._done_cv.notify_all()
                        b.finished = []
            except Exception as e:  # noqa: BLE001 — a dead loop must not strand waiters
                self._failover(ridx, e)
                return
            if not stepped:
                self._stop.wait(self._idle_sleep_s)

    def _failover(self, ridx: int, err: Exception):
        """Migrate a dead replica's unfinished requests to the survivors.

        The batcher already retries device failures internally
        (max_recoveries); landing here means the replica is beyond
        recovery.  Each orphaned request continues on another replica from
        its full token history (prompt + generated so far) — the same
        re-prefill contract the batcher's own recovery uses — so greedy
        outputs are unchanged.  With no survivors, waiters get the fatal
        error (previous behavior)."""
        self._dead[ridx] = True
        self._drain_cancels(ridx, dead=True)
        survivors = [i for i in range(len(self.replicas)) if not self._dead[i]]
        b = self.replicas[ridx]
        orphans = [r for r in list(b.queue) + list(b.slots)
                   if r is not None and not r.done] + self._take_submits(ridx)
        if not survivors:
            with self._done_cv:
                self._fatal = repr(err)
                self._done_cv.notify_all()
            return
        for req in orphans:
            prior = list(self._carry.pop(req.uid, [])) + [int(t) for t in req.output_ids]
            remaining = req.max_new_tokens - len(req.output_ids)
            with self._done_cv:
                self._outstanding[ridx] -= 1
            if remaining <= 0:  # nothing left to generate: deliver as-is
                req.output_ids = prior
                with self._done_cv:
                    self._done[req.uid] = req
                    self._uid_replica.pop(req.uid, None)
                    self._done_cv.notify_all()
                continue
            cont = Request(
                uid=req.uid,
                prompt_ids=np.concatenate([
                    np.asarray(req.prompt_ids, np.int32),
                    np.asarray(prior, np.int32),
                ]) if prior else np.asarray(req.prompt_ids, np.int32),
                max_new_tokens=remaining,
                eos_token_id=req.eos_token_id,
                sampling=req.sampling,
                stop_sequences=req.stop_sequences,
            )
            cont.t_submit = req.t_submit
            if prior:
                self._carry[req.uid] = prior
            target = min(survivors, key=lambda i: self._outstanding[i])
            with self._locks[target]:
                self.replicas[target].add_request(cont)
                self._uid_replica[req.uid] = target
                self._outstanding[target] += 1
        print(f"[dgq_tpu_torch.serve] replica {ridx} FAILED ({repr(err)[:120]}); "
              f"{len(orphans)} request(s) migrated to replicas {survivors}",
              flush=True)

    def _take_submits(self, ridx: int) -> list:
        out = []
        while True:
            try:
                out.append(self._submit_qs[ridx].get_nowait())
            except queue.Empty:
                return out

    def _drain_submits(self, ridx: int):
        """Hand queued submissions to the replica's batcher (caller holds
        its lock)."""
        for req in self._take_submits(ridx):
            self.replicas[ridx].add_request(req)

    def _drain_cancels(self, ridx: int, dead: bool = False):
        """Apply queued cancels (caller holds the replica's lock unless
        ``dead``)."""
        while True:
            try:
                uid, holder, ev = self._cancel_qs[ridx].get_nowait()
            except queue.Empty:
                return
            holder.append(False if dead else self.replicas[ridx].cancel(uid))
            ev.set()

    def _send_stream_deltas(self, b):
        """Push newly-decoded tokens of streaming requests (caller holds
        the replica's lock).  Finished requests get their tail in the final
        reply (_finish_and_reply) — here only live slots are walked."""
        for req in b.slots:
            if req is None:
                continue
            entry = self._streams.get(req.uid)
            if entry is None:
                continue
            send, sent = entry
            # `sent` counts EFFECTIVE tokens: after a replica failover the
            # continuation's output_ids restart at 0 while the already-
            # streamed prefix lives in _carry
            full = self._carry.get(req.uid, []) + list(req.output_ids)
            if len(full) > sent:
                delta = [int(t) for t in full[sent:]]
                try:
                    send({"uid": req.uid, "token_ids": delta, "done": False})
                except Exception:  # noqa: BLE001 — dead client: stop streaming
                    self._streams.pop(req.uid, None)
                    continue
                self._streams[req.uid] = (send, len(full))

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        # dedicated writer thread: the scheduler loop streams tokens through
        # send(), and must never block on a slow client's socket
        out_q: "queue.Queue" = queue.Queue()

        def writer():
            while True:
                obj = out_q.get()
                if obj is None:
                    return
                try:
                    conn.sendall((json.dumps(obj) + "\n").encode())
                except (ConnectionError, OSError):
                    return

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()

        def send(obj):
            out_q.put(obj)

        def finish_and_reply(uid):
            req = self.wait(uid)
            # by the time wait() returns, the owning replica's loop no
            # longer touches this uid; dict pop is GIL-atomic
            entry = self._streams.pop(uid, None)
            final = {"uid": uid,
                     "output_ids": [int(t) for t in req.output_ids],
                     "done": True}
            if entry is not None:  # streaming: include the unsent tail
                final["token_ids"] = [int(t) for t in req.output_ids[entry[1]:]]
            if req.cancelled:
                final["cancelled"] = True
            if req.t_submit is not None and req.t_done is not None:
                final["e2e_ms"] = round((req.t_done - req.t_submit) * 1e3, 1)
                if req.t_first is not None:
                    final["ttft_ms"] = round((req.t_first - req.t_submit) * 1e3, 1)
            send(final)

        try:
            f = conn.makefile("r", encoding="utf-8")
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError as e:
                    send({"error": f"bad json: {e}"})
                    continue
                if msg.get("op") == "metrics":
                    send(self.metrics())
                    continue
                if msg.get("op") == "cancel":
                    try:
                        uid = int(msg["uid"])
                        send({"uid": uid, "cancelled_ok": self.cancel(uid)})
                    except (KeyError, TypeError, ValueError) as e:
                        send({"error": f"bad cancel: {e}"})
                    continue
                if "prompt_ids" not in msg:
                    send({"error": "missing prompt_ids"})
                    continue
                try:
                    sampling = None
                    if any(k in msg for k in ("temperature", "top_k", "top_p")):
                        from dgq_tpu_torch.serving.sampling import SamplingParams

                        sampling = SamplingParams(
                            temperature=float(msg.get("temperature", 0.0)),
                            top_k=int(msg.get("top_k", 0)),
                            top_p=float(msg.get("top_p", 1.0)),
                        )
                    stops = msg.get("stop_sequences")
                    if stops is not None:
                        stops = [[int(t) for t in seq] for seq in stops]
                    uid = self.submit(msg["prompt_ids"],
                                      msg.get("max_new_tokens", 32),
                                      eos_token_id=msg.get("eos_token_id"),
                                      sampling=sampling,
                                      stream_send=send if msg.get("stream") else None,
                                      stop_sequences=stops)
                except Exception as e:  # noqa: BLE001 — malformed fields get an error reply
                    send({"error": f"bad request: {e}"})
                    continue
                # resolve asynchronously so pipelined requests interleave
                threading.Thread(target=finish_and_reply, args=(uid,),
                                 daemon=True).start()
        except (ConnectionError, OSError):
            pass
        finally:
            out_q.put(None)
            wt.join(timeout=5)
            conn.close()
