"""Thin sheepd client and the ``submit`` verb (the port's counterpart of
``sheep_tpu/server/client.py``, without its fleet mode).

    from sheep_tpu_torch.server.client import SheepClient

    with SheepClient("/run/sheepd.sock") as c:
        jid = c.submit("graph.bin64", k=64, tenant="alice")["job_id"]
        job = c.wait(jid, timeout_s=600)
        print(job["results"][0]["edge_cut"])

Addressing: a string containing ``/`` (or ending in ``.sock``) is a
unix socket path; ``host:port`` is TCP. One request per call,
synchronous; the wire format is the reference's, so this client talks
to either package's daemon, and the reference's client to this
package's. The client is sockets and json only: it imports no torch
module of the engine.

CLI (``python -m sheep_tpu_torch.cli submit ...``)::

    submit --server /run/sheepd.sock --input g.edges --k 8,64 \\
        --wait [--output parts.pbin] [--tenant alice] [--deadline 60]
    submit --server ... --input g.edges --k 64 --watch
    submit --server ... --input g.edges --k 64 --resident --wait
    submit --server ... --update JOB --deltas g.dlog [--wire] [--score]
    submit --server ... --epoch-of JOB | --compact JOB
    submit --server ... --status JOB | --cancel JOB | --stats \\
        | --ping | --metrics | --profile DIR | --shutdown

``--resident`` holds the finished partition in the daemon; ``--update
JOB --deltas LOG`` applies the log's epochs past the resident epoch (a
daemon-side path by default; ``--wire`` reads the log here and sends
each epoch inline, idempotent by its explicit epoch number);
``--epoch-of`` and ``--compact`` query and repair; ``--cancel`` on the
DONE job releases the residency (``update JOB ...`` from the CLI is
sugar for ``--update``). ``--watch`` polls ``status`` and prints a
progress line on stderr at each change, then the final descriptor.
``--metrics`` prints the daemon's Prometheus text; ``--profile DIR``
arms a ``torch.profiler`` capture of the next ``--profile-steps``
dispatch steps into the daemon-side DIR.

``SheepClient(..., reconnect=N)`` survives a daemon bounce: transport
errors reconnect with bounded exponential backoff and re-send the
request when that is safe (everything but a plain ``submit``, an
un-epoched ``update``, ``compact`` and ``shutdown``; a submit with
``reattach=True`` is idempotent, matched to the journaled job by spec
digest). ``--reconnect N`` arms it, 8 by default with ``--watch``.
Every submit mints a traceparent-shaped trace context and re-sends it
on each later request naming the job. Updates too large for one 1 MiB
request line go as one ``begin`` / ``chunk`` / ``commit`` transaction,
applied as ONE epoch at commit.

Exit codes: 0 op succeeded (for --wait/--watch: job DONE), 1 usage/
transport, 2 daemon answered ok=false, 3 job reached a non-done
terminal state (failed / cancelled / deadline_exceeded / rejected),
4 --wait's/--watch's --timeout elapsed with the job still queued/
running (not terminal — do not resubmit).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time
from typing import Optional

from sheep_tpu_torch.server import protocol

# chunked-update slicing: 32768 edges base64-encode to
# ~700 KiB — comfortably under protocol.MAX_REQUEST_BYTES per line
UPDATE_CHUNK_EDGES = 32768


def _connect(server: str, timeout_s: float) -> socket.socket:
    server = str(server)
    if "/" in server or server.endswith(".sock"):
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(timeout_s)
        s.connect(server)
        return s
    host, _, port = server.rpartition(":")
    try:
        port_n = int(port)
    except ValueError:
        raise ServerError(
            f"bad --server address {server!r}: want a unix socket path "
            f"(contains '/') or host:port") from None
    s = socket.create_connection((host or "127.0.0.1", port_n),
                                 timeout=timeout_s)
    return s


class SheepClient:
    """One connection to a sheepd; methods mirror the protocol ops and
    return the daemon's response body (raising :class:`ServerError`
    on ok=false). ``reconnect`` arms bounded transport failover (see
    module docstring); 0 keeps the classic fail-fast behavior."""

    def __init__(self, server: str, timeout_s: float = 600.0,
                 reconnect: int = 0, reconnect_base_s: float = 0.2):
        self.server = server
        self.timeout_s = timeout_s
        self.reconnect = int(reconnect)
        self._reconnect_base_s = float(reconnect_base_s)
        self._sock = None
        self._rf = None
        # job_id -> the traceparent minted at submit: every
        # later wait/status/cancel/update on that job re-sends the
        # SAME trace context, so the whole logical request correlates
        self._job_traces: dict = {}
        pol = self._policy()
        while True:
            try:
                self._open()
                return
            except OSError as e:
                # the restart window starts before the first connect:
                # a client launched while the daemon bounces should
                # wait for it, not die on ECONNREFUSED
                self._retry_or_raise(pol, e, "connect")

    def _policy(self):
        from sheep_tpu_torch.utils import retry as retry_mod

        return retry_mod.RetryPolicy(max_retries=self.reconnect,
                                     base_delay_s=self._reconnect_base_s,
                                     max_delay_s=5.0)

    def _retry_or_raise(self, policy, exc, where: str) -> None:
        from sheep_tpu_torch.utils import retry as retry_mod

        if policy is None or not policy.admit(retry_mod.TRANSIENT):
            raise exc
        policy.backoff(retry_mod.TRANSIENT, exc,
                       where=f"sheep-client.{where}")

    def _open(self) -> None:
        self._sock = _connect(self.server, self.timeout_s)
        self._rf = self._sock.makefile("rb")

    def _drop(self) -> None:
        try:
            if self._rf is not None:
                self._rf.close()
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._rf = None
        self._sock = None

    def close(self) -> None:
        self._drop()

    def __enter__(self) -> "SheepClient":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @staticmethod
    def _retriable(doc: dict) -> bool:
        """Safe to blindly re-send after a transport error: everything
        except a plain submit (double-build risk — reattach makes it
        idempotent and thus retriable), an un-epoched update (a blind
        resend could double-fold; explicit epochs and the log form are
        idempotent — the daemon answers applied=false for an epoch it
        already holds), compact (double-compacting is observable), and
        shutdown."""
        op = doc.get("op")
        if op == "submit":
            return bool(doc.get("reattach"))
        if op == "update":
            if doc.get("stream") is not None:
                # chunked sub-verbs are transaction-scoped: resending
                # one on a FRESH connection can only hit "unknown
                # txn" — the whole-transaction retry in
                # _update_chunked owns recovery instead
                return False
            return doc.get("epoch") is not None \
                or doc.get("log") is not None
        return op not in ("shutdown", "compact")

    def request(self, doc: dict) -> dict:
        if "trace" not in doc:
            tp = self._job_traces.get(doc.get("job_id"))
            if tp is not None:
                doc = dict(doc, trace=tp)
        pol = self._policy() if self.reconnect > 0 \
            and self._retriable(doc) else None
        while True:
            try:
                if self._sock is None:
                    self._open()
                self._sock.sendall(protocol.dumps(doc))
                line = self._rf.readline()
                if not line:
                    raise ConnectionResetError(
                        "connection closed by daemon")
                resp = json.loads(line)
            except (OSError, json.JSONDecodeError) as e:
                self._drop()
                if isinstance(e, ConnectionResetError) and pol is None:
                    # the classic (reconnect=0) contract: a daemon
                    # that hangs up mid-request answers as a daemon
                    # error, not a transport one
                    raise ServerError(str(e)) from None
                self._retry_or_raise(pol, e,
                                     str(doc.get("op", "request")))
                continue
            if not resp.get("ok"):
                raise ServerError(resp.get("error",
                                           "unknown daemon error"))
            return resp

    # -- ops -----------------------------------------------------------
    def ping(self) -> dict:
        return self.request({"op": "ping"})

    def _mint_trace(self) -> str:
        """One fresh wire trace context per logical request, parented
        to the calling thread's current obs span when one is open:
        the daemon's job span then stitches under it
        (``trace_report --stitch``)."""
        from sheep_tpu_torch import obs

        return protocol.make_traceparent(protocol.mint_trace_id(),
                                         obs.current_span_id())

    def submit(self, input: str, k, tenant: str = "default",
               reattach: bool = False, trace: Optional[str] = None,
               **job_fields) -> dict:
        """``reattach=True`` makes the submit idempotent: the daemon
        matches the spec digest against existing jobs (journaled ones
        included) and returns the live/completed twin — with
        ``"reattached": true`` in the response — instead of building
        again. The safe shape for retried submits across a daemon
        restart.

        ``trace`` overrides the wire trace context; by default a
        fresh one is minted per submit and re-sent on every later
        request naming the returned job id."""
        job = {"input": input, "k": k, **job_fields}
        req = {"op": "submit", "tenant": tenant, "job": job,
               "trace": trace or self._mint_trace()}
        if reattach:
            req["reattach"] = True
        resp = self.request(req)
        jid = resp.get("job_id")
        if jid:
            self._job_traces[jid] = req["trace"]
        return resp

    def status(self, job_id: str) -> dict:
        return self.request({"op": "status", "job_id": job_id})["job"]

    def wait(self, job_id: str,
             timeout_s: Optional[float] = None) -> dict:
        return self.request({"op": "wait", "job_id": job_id,
                             "timeout_s": timeout_s})["job"]

    def cancel(self, job_id: str) -> str:
        return self.request({"op": "cancel",
                             "job_id": job_id})["state"]

    def list(self) -> list:
        return self.request({"op": "list"})["jobs"]

    def stats(self) -> dict:
        return self.request({"op": "stats"})["stats"]

    def metrics(self) -> str:
        """The daemon's live Prometheus exposition text (same document
        as HTTP GET /metrics on --metrics-port)."""
        return self.request({"op": "metrics"})["text"]

    def lookup(self, digest: str) -> bool:
        """Advisory result-cache probe: True when the
        daemon can answer a submit with this spec digest straight
        from its result store — zero build steps, zero compiles. The
        digest is ``journal.job_digest`` of the request's ``JobSpec``."""
        return bool(self.request({"op": "lookup",
                                  "digest": digest})["hit"])

    # -- resident-partition verbs ---------------------------
    def update(self, job_id: str, adds=None, dels=None,
               epoch: Optional[int] = None, score: bool = False,
               compact: str = "auto", log: Optional[str] = None,
               chunk_edges: Optional[int] = None) -> dict:
        """Stream one delta epoch at a resident partition: ``adds`` /
        ``dels`` are (m, 2) edge arrays (base64 on the wire), or
        ``log`` names a DAEMON-side delta log whose epochs past the
        resident epoch all apply. Explicit ``epoch`` numbers make the
        call idempotent (an already-applied epoch answers
        ``applied: false``).

        Payloads too large for the 1 MiB request line switch to the
        chunked wire form automatically: one begin /
        chunk* / commit transaction over this connection, applied by
        the daemon as ONE epoch at commit — so a single call streams
        an arbitrarily large epoch. ``chunk_edges`` overrides the
        per-chunk edge count (default ``UPDATE_CHUNK_EDGES``)."""
        ce = int(chunk_edges) if chunk_edges else UPDATE_CHUNK_EDGES
        n = (0 if adds is None else len(adds)) \
            + (0 if dels is None else len(dels))
        if log is None and n > ce:
            return self._update_chunked(job_id, adds, dels, epoch,
                                        score, compact, ce)
        req = {"op": "update", "job_id": job_id,
               "score": bool(score), "compact": compact}
        if adds is not None:
            req["adds"] = protocol.encode_edges(adds)
        if dels is not None:
            req["dels"] = protocol.encode_edges(dels)
        if epoch is not None:
            req["epoch"] = int(epoch)
        if log is not None:
            req["log"] = log
        return self.request(req)

    def _update_chunked(self, job_id: str, adds, dels, epoch,
                        score: bool, compact: str,
                        chunk_edges: int) -> dict:
        """One chunked update transaction. Retries (when armed AND the
        epoch is explicit, i.e. idempotent) restart from ``begin``:
        transactions are connection-scoped, so a transport drop
        anywhere mid-stream discards the staged chunks server-side
        and the only safe resume point is a fresh transaction."""
        pol = self._policy() if self.reconnect > 0 \
            and epoch is not None else None
        while True:
            try:
                txn = self.request({"op": "update", "job_id": job_id,
                                    "stream": "begin"})["txn"]
                for key, arr in (("adds", adds), ("dels", dels)):
                    if arr is None:
                        continue
                    for lo in range(0, len(arr), chunk_edges):
                        part = arr[lo:lo + chunk_edges]
                        self.request({
                            "op": "update", "stream": "chunk",
                            "txn": txn,
                            key: protocol.encode_edges(part)})
                commit = {"op": "update", "stream": "commit",
                          "txn": txn, "score": bool(score),
                          "compact": compact}
                if epoch is not None:
                    commit["epoch"] = int(epoch)
                return self.request(commit)
            except (OSError, ServerError) as e:
                if isinstance(e, ServerError) \
                        and "connection closed" not in str(e) \
                        and "unknown update txn" not in str(e):
                    raise  # a real daemon answer, not a torn stream
                if pol is None:
                    raise
                self._drop()
                self._retry_or_raise(pol, e, "update.stream")

    def epoch(self, job_id: str) -> dict:
        """Resident-partition epoch/staleness descriptor."""
        return self.request({"op": "epoch", "job_id": job_id})

    def compact(self, job_id: str, mode: str = "auto",
                score: bool = False) -> dict:
        """Run tombstone compaction on a resident partition."""
        return self.request({"op": "compact", "job_id": job_id,
                             "mode": mode, "score": bool(score)})

    def profile(self, dir: str, steps: int = 8) -> dict:
        """Arm an on-demand torch.profiler capture of the next ``steps``
        dispatch steps into daemon-side directory ``dir``; completion
        is queryable via :meth:`stats`'s ``profile`` field."""
        return self.request({"op": "profile", "dir": dir,
                             "steps": steps})["profile"]

    def shutdown(self, drain: bool = False) -> dict:
        return self.request({"op": "shutdown", "drain": drain})

    def result_assignment(self, job: dict, k: Optional[int] = None):
        """Decode the packed assignment for part count ``k`` (default:
        the job's first) from a wait/status descriptor — only present
        when the job was submitted with ``return_assignment``."""
        for row in job.get("results") or []:
            if k is None or row.get("k") == k:
                if "assignment" not in row:
                    break
                return protocol.decode_assignment(row["assignment"])
        raise ServerError(
            f"job {job.get('job_id')} carries no assignment for k={k} "
            f"(submit with return_assignment=true)")


class ServerError(RuntimeError):
    """The daemon answered ok=false (or went away mid-request)."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sheep-submit",
        description="submit partition jobs to a running sheepd")
    p.add_argument("--server",
                   help="daemon address: unix socket path or host:port")
    p.add_argument("--input", help="graph path or synthetic spec "
                                   "(as the main CLI's --input)")
    p.add_argument("--k", help="part count, or comma list for multi-k "
                               "from one shared tree")
    p.add_argument("--tenant", default="default")
    p.add_argument("--chunk-edges", type=int, default=None)
    p.add_argument("--dispatch-batch", type=int, default=None)
    p.add_argument("--h2d-ring", type=int, default=None,
                   help="staged H2D ring depth for host-format inputs "
                        "(0 = auto; device-generated specs skip "
                        "staging)")
    p.add_argument("--inflight", type=int, default=None,
                   help="in-job dispatch pipeline depth: confirmed "
                        "executions in flight per engine step (0 = "
                        "auto: 1 on cpu, 2 on accelerators)")
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--weights", choices=["unit", "degree"], default=None)
    p.add_argument("--comm-volume", action="store_true")
    p.add_argument("--num-vertices", type=int, default=None)
    p.add_argument("--deadline", type=float, default=None, metavar="S",
                   help="seconds from submit until the job must be "
                        "done (expired -> deadline_exceeded)")
    p.add_argument("--output", default=None,
                   help="daemon-side partition map path (.parts/.pbin)")
    p.add_argument("--wait", action="store_true",
                   help="block until the job is terminal; print its "
                        "descriptor; exit 0 only on done")
    p.add_argument("--watch", action="store_true",
                   help="like --wait but poll status and render live "
                        "progress lines (state/phase/steps) on stderr "
                        "instead of blocking silently")
    p.add_argument("--poll", type=float, default=0.5, metavar="S",
                   help="with --watch: poll interval (default 0.5s)")
    p.add_argument("--reconnect", type=int, default=None, metavar="N",
                   help="survive a daemon bounce: retry transport "
                        "errors up to N times with exponential "
                        "backoff, re-sending idempotent requests "
                        "(submits reattach to the journaled job by "
                        "digest instead of double-building). Default: "
                        "8 with --watch, else 0")
    p.add_argument("--timeout", type=float, default=None,
                   help="with --wait/--watch: give up after this many "
                        "seconds")
    p.add_argument("--resident", action="store_true",
                   help="with --input: hold the finished partition "
                        "RESIDENT in the daemon so delta epochs can "
                        "stream at it (--update); the admission "
                        "reservation stays charged until --cancel "
                        "releases it")
    p.add_argument("--update", metavar="JOB", default=None,
                   help="apply delta epochs to a resident partition; "
                        "needs --deltas LOG (daemon-side path by "
                        "default, --wire streams each epoch inline)")
    p.add_argument("--deltas", metavar="LOG", default=None,
                   help="with --update: the delta log "
                        "(io/deltalog.py) whose epochs past the "
                        "resident epoch apply")
    p.add_argument("--wire", action="store_true",
                   help="with --update: read the log CLIENT-side and "
                        "stream each epoch as an inline update "
                        "request (the remote-tenant path; default "
                        "sends the daemon-side log path)")
    p.add_argument("--score", action="store_true",
                   help="with --update/--compact: refresh + return "
                        "the scored results after applying")
    p.add_argument("--epoch-of", metavar="JOB", default=None,
                   help="print a resident partition's epoch/staleness "
                        "descriptor")
    p.add_argument("--compact", metavar="JOB", default=None,
                   help="compact a resident partition's tombstones")
    p.add_argument("--compact-mode", default="auto",
                   choices=["auto", "full", "subtree", "rebase"],
                   help="with --compact: full re-anchors and rebuilds "
                        "everything (exact), subtree repairs only the "
                        "dirty tree-split parts (score-bounded), "
                        "rebase additionally rewrites base+deltas "
                        "into a fresh on-disk artifact (durable "
                        "daemons only; explicit opt-in), auto picks "
                        "between full/subtree (default)")
    p.add_argument("--status", metavar="JOB")
    p.add_argument("--cancel", metavar="JOB")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--ping", action="store_true")
    p.add_argument("--metrics", action="store_true",
                   help="print the daemon's live Prometheus text")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="arm an on-demand torch.profiler capture into "
                        "daemon-side DIR")
    p.add_argument("--profile-steps", type=int, default=8, metavar="K",
                   help="with --profile: capture the next K dispatch "
                        "steps (default 8)")
    p.add_argument("--shutdown", action="store_true")
    p.add_argument("--drain", action="store_true",
                   help="with --shutdown: finish accepted jobs first")
    return p


def _watch_job(c: "SheepClient", job, poll_s: float,
               timeout_s: Optional[float]) -> dict:
    """Poll status until terminal (or timeout), rendering one progress
    line per change on stderr; returns the last descriptor. Daemon
    bounces are absorbed below in ``request`` when the client was
    built with ``reconnect`` (the --watch default): each poll
    retries transports with backoff, so a restarting daemon shows up
    as a few stderr retry notes and then the resumed job's progress —
    not a dead watch."""
    t0 = time.monotonic()
    deadline = None if timeout_s is None else t0 + timeout_s
    last_line = None
    while True:
        desc = c.status(job)
        job_id = desc.get("job_id") or job
        state = desc.get("state")
        bits = [f"{time.monotonic() - t0:7.1f}s", job_id, state]
        if desc.get("phase"):
            bits.append(f"phase={desc['phase']}")
        if desc.get("steps"):
            bits.append(f"steps={desc['steps']}")
        if state == "done" and desc.get("results"):
            r = desc["results"][0]
            bits.append(f"cut_ratio={r.get('cut_ratio')}")
        if desc.get("error"):
            bits.append(f"error={desc['error'][:120]}")
        line = " ".join(bits)
        if line != last_line:
            print(f"sheep-submit: {line}", file=sys.stderr, flush=True)
            last_line = line
        if state in protocol.TERMINAL_STATES:
            return desc
        if deadline is not None and time.monotonic() >= deadline:
            return desc
        time.sleep(max(0.05, poll_s))


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    modes = [bool(args.input), bool(args.status), bool(args.cancel),
             args.stats, args.ping, args.shutdown, args.metrics,
             bool(args.profile), bool(args.update),
             bool(args.epoch_of), bool(args.compact)]
    if sum(modes) != 1:
        p.error("pass exactly one of --input (submit), --status, "
                "--cancel, --stats, --ping, --metrics, --profile, "
                "--update, --epoch-of, --compact, --shutdown")
    if not args.server:
        p.error("pass --server (the daemon's socket path or host:port)")
    if args.update and not args.deltas:
        p.error("--update needs --deltas LOG")
    reconnect = args.reconnect if args.reconnect is not None \
        else (8 if args.watch else 0)
    if reconnect < 0:
        p.error("--reconnect must be >= 0")
    try:
        with SheepClient(args.server, reconnect=reconnect) as c:
            if args.ping:
                print(json.dumps(c.ping()))
                return 0
            if args.stats:
                print(json.dumps(c.stats(), indent=1))
                return 0
            if args.metrics:
                sys.stdout.write(c.metrics())
                return 0
            if args.profile:
                print(json.dumps(c.profile(args.profile,
                                           steps=args.profile_steps)))
                return 0
            if args.shutdown:
                print(json.dumps(c.shutdown(drain=args.drain)))
                return 0
            if args.epoch_of:
                print(json.dumps(c.epoch(args.epoch_of)))
                return 0
            if args.compact:
                print(json.dumps(c.compact(args.compact,
                                           mode=args.compact_mode,
                                           score=args.score)))
                return 0
            if args.update:
                if args.wire:
                    # remote-tenant path: read the log HERE, stream
                    # each epoch inline (idempotent: explicit epoch
                    # numbers — an already-applied epoch is a no-op)
                    from sheep_tpu_torch.io.deltalog import DeltaLogReader

                    cur = int(c.epoch(args.update)["epoch"])
                    resp = {"job_id": args.update, "epoch": cur,
                            "applied": False, "epochs_applied": 0}
                    applied = 0
                    reader = DeltaLogReader(args.deltas)
                    mx = reader.max_epoch  # records() cached: 1 read
                    for ep, adds, dels in reader.epochs(
                            start_epoch=cur):
                        resp = c.update(args.update, adds=adds,
                                        dels=dels, epoch=ep,
                                        score=args.score and ep == mx)
                        applied += resp.get("epochs_applied", 0)
                    resp["epochs_applied"] = applied
                    resp["applied"] = applied > 0
                else:
                    resp = c.update(args.update, log=args.deltas,
                                    score=args.score)
                print(json.dumps(resp))
                return 0
            if args.status:
                print(json.dumps(c.status(args.status)))
                return 0
            if args.cancel:
                print(json.dumps({"job_id": args.cancel,
                                  "state": c.cancel(args.cancel)}))
                return 0
            # submit
            if not args.k:
                p.error("--input needs --k")
            try:
                ks = [int(x) for x in str(args.k).split(",") if x != ""]
            except ValueError:
                ks = []
            if not ks or any(k < 1 for k in ks):
                p.error(f"--k must be a positive int or comma list "
                        f"(got {args.k!r})")
            job = {"k": ks}
            for field, val in (("chunk_edges", args.chunk_edges),
                               ("dispatch_batch", args.dispatch_batch),
                               ("h2d_ring", args.h2d_ring),
                               ("inflight", args.inflight),
                               ("alpha", args.alpha),
                               ("weights", args.weights),
                               ("num_vertices", args.num_vertices),
                               ("deadline_s", args.deadline),
                               ("output", args.output)):
                if val is not None:
                    job[field] = val
            if args.comm_volume:
                job["comm_volume"] = True
            if args.resident:
                job["resident"] = True
            # with failover armed the submit itself must be idempotent
            # (the retried submit against a restarted daemon reattaches
            # to the journaled job instead of double-building)
            resp = c.submit(args.input, tenant=args.tenant,
                            reattach=reconnect > 0, **job)
            if not (args.wait or args.watch):
                print(json.dumps(resp))
                return 0
            handle = resp["job_id"]
            if args.watch:
                desc = _watch_job(c, handle, args.poll, args.timeout)
            else:
                desc = c.wait(handle, timeout_s=args.timeout)
            print(json.dumps(desc))
            if desc.get("state") == "done":
                return 0
            if desc.get("state") in ("queued", "running"):
                # --timeout elapsed with the job still in flight: NOT a
                # terminal failure — a supervisor must not resubmit
                print(f"sheep-submit: wait timed out; job "
                      f"{desc.get('job_id')} is still "
                      f"{desc.get('state')}", file=sys.stderr)
                return 4
            return 3
    except (ServerError, OSError, json.JSONDecodeError) as e:
        kind = "daemon" if isinstance(e, ServerError) else "transport"
        print(f"sheep-submit: {kind} error: {e}", file=sys.stderr)
        return 2 if isinstance(e, ServerError) else 1


if __name__ == "__main__":
    sys.exit(main())
