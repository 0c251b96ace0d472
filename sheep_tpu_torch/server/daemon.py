"""sheepd, the resident partition daemon (the port's counterpart of
``sheep_tpu/server/daemon.py``).

    python -m sheep_tpu_torch.cli serve --socket /run/sheepd.sock
    python -m sheep_tpu_torch.cli serve --port 7433 [--host 127.0.0.1]
    ... --metrics-port 9090              # + HTTP GET /metrics
    ... --state-dir DIR                  # journal, checkpoints, results
    ... --device cpu                     # the CPU (default: CUDA)

One process holds the loaded kernels, the shared chunk cache and the
admission scheduler (:mod:`sheep_tpu_torch.server.scheduler`);
connections speak the newline-JSON protocol
(:mod:`sheep_tpu_torch.server.protocol`), the reference's, so either
package's client talks to it. Thread model: one accept loop, one handler
thread per connection (handlers take the scheduler's lock and touch no
tensor), and one dispatch thread, this process's main thread, that runs
every job step and every delta fold: the only thread that calls CUDA.

A fault in a served job degrades THAT job; a handler or protocol error
is answered on the wire; only a failure of the daemon's own bring-up
(socket bind, trace sink) is fatal. ``shutdown`` (or SIGINT) cancels or
drains the jobs, ends every span, stops the heartbeat and closes the
tracer.

Durability: ``--state-dir`` arms the job journal, per-job checkpoints
and the result store. Kill -9 the daemon mid-build, start it again on
the same state dir, and its jobs come back: queued ones queue again,
running ones resume from their last checkpoint, bit-identical to an
uninterrupted build. SIGTERM on a durable daemon is the graceful drain
(``--drain-grace-s``): stop admitting, checkpoint the running jobs at
their next boundary, journal the handoff, exit 0. An exclusive flock'd
pidfile under the state dir (or beside the unix socket) keeps two
daemons off one socket and journal. The signal handlers are installed
by :func:`main` alone: a :class:`Daemon` or a scheduler built in
another program leaves that program's handlers as they were.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import threading
from typing import Optional

from sheep_tpu_torch.server import protocol


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sheepd",
        description="resident partition server: warm compiled programs, "
                    "device chunk cache, membudget-aware multi-tenant "
                    "job queue")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="unix socket path to listen on")
    p.add_argument("--port", type=int, default=None,
                   help="TCP port to listen on (local use; no auth)")
    p.add_argument("--host", default="127.0.0.1",
                   help="TCP bind address (default 127.0.0.1)")
    p.add_argument("--device", default=None,
                   help="where the jobs run: cuda (the default; raises "
                        "without a GPU) or cpu")
    p.add_argument("--budget-bytes", type=int, default=None,
                   help="admission budget in device bytes (default: "
                        "SHEEP_CACHE_BYTES, else 90%% of the card's "
                        "memory, else unlimited on the CPU)")
    p.add_argument("--trace", default=None, metavar="FILE",
                   help="append the obs trace (manifest, per-job span "
                        "trees, heartbeats) to FILE")
    p.add_argument("--heartbeat-secs", type=float, default=None,
                   metavar="S",
                   help="with --trace: periodic progress heartbeats "
                        "(inside sheepd they carry queue depth + "
                        "active-job service pressure)")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="N",
                   help="serve Prometheus text on HTTP GET /metrics "
                        "at this port (0 = pick a free one; the bound "
                        "port is printed on stderr)")
    p.add_argument("--metrics-host", default="127.0.0.1",
                   help="metrics HTTP bind address (default "
                        "127.0.0.1)")
    p.add_argument("--state-dir", default=None, metavar="DIR",
                   help="durability root: arms the crash-"
                        "safe job journal (DIR/journal.jsonl), the "
                        "exclusive daemon lockfile, and per-job "
                        "checkpoints (DIR/ckpt unless "
                        "--checkpoint-dir); on startup the journal "
                        "replays, queued jobs re-admit and running "
                        "jobs RESUME from their checkpoints")
    p.add_argument("--result-cache-bytes", type=int,
                   default=256 << 20, metavar="N",
                   help="with --state-dir: byte cap of the content-"
                        "addressed result store (STATE_DIR/results) — "
                        "repeat submits for an identical spec+input "
                        "digest answer from it with zero build steps "
                        "and zero recompiles; entries evict oldest-"
                        "first (default 256 MiB; 0 disables)")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="with --state-dir: per-job checkpoint root "
                        "(default STATE_DIR/ckpt)")
    p.add_argument("--checkpoint-every", type=int, default=16,
                   metavar="N",
                   help="with --state-dir: served checkpoint cadence "
                        "in chunks/groups (default 16)")
    p.add_argument("--drain-grace-s", type=float, default=10.0,
                   metavar="S",
                   help="SIGTERM grace (durable daemons): stop "
                        "admitting, checkpoint running jobs at their "
                        "next flush barrier, journal the handoff, "
                        "exit 0 (default 10s); without --state-dir "
                        "SIGTERM cancels jobs as before")
    return p


class Daemon:
    def __init__(self, args):
        self.args = args
        self._sock: socket.socket = None
        self._threads: list = []
        self._shutdown_evt = threading.Event()
        self.scheduler = None
        self._root_span = None
        self._metrics_httpd = None
        self.metrics_port = None  # actual bound port, once listening
        self._lock_fd = None
        self._lock_path = None
        self._early_signal = None

    # -- exclusive daemon lock --------------------
    def _acquire_lock(self) -> None:
        """Serialize daemon startup per state-dir/socket with an
        exclusive flock'd pidfile. The stale-socket probe alone RACES
        a concurrent starter (two probes can both see a dead socket,
        both unlink, both bind — and then share one journal); the
        kernel lock is race-free and self-releasing on any death,
        including SIGKILL. Held for the daemon's lifetime."""
        import fcntl

        a = self.args
        if a.state_dir is not None:
            self._lock_path = os.path.join(a.state_dir, "sheepd.lock")
        elif a.socket is not None:
            self._lock_path = a.socket + ".lock"
        else:
            return  # TCP without state: the port bind is exclusive
        fd = os.open(self._lock_path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            try:
                held_by = os.read(fd, 64).decode("ascii",
                                                 "replace").strip()
            except OSError:
                held_by = "?"
            os.close(fd)
            raise SystemExit(
                f"sheepd: {self._lock_path} is held by a live sheepd "
                f"(pid {held_by or '?'}); two daemons must not share "
                f"one socket/journal")
        os.ftruncate(fd, 0)
        os.write(fd, f"{os.getpid()}\n".encode("ascii"))
        os.fsync(fd)
        self._lock_fd = fd

    def _release_lock(self) -> None:
        # close releases the flock; the file itself stays (unlinking
        # it would re-open the open/lock race for waiters holding the
        # old inode — a stale lockFILE is harmless, only the kernel
        # lock matters and that dies with the fd/process)
        if self._lock_fd is None:
            return
        try:
            os.close(self._lock_fd)
        except OSError:
            pass
        self._lock_fd = None

    # -- telemetry HTTP listener ----------------------------
    def _start_metrics_http(self):
        """Minimal scrape endpoint: GET /metrics answers the same
        Prometheus text as the `metrics` protocol verb, so any scraper
        (or a future replica router) can poll a running sheepd without
        speaking the line protocol. Serves nothing else; runs on its
        own daemon threads; never touches the dispatch chain beyond
        the scheduler's locked render."""
        import http.server

        from sheep_tpu_torch.obs import metrics as metrics_mod

        daemon = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.rstrip("/") not in ("/metrics", ""):
                    self.send_error(404, "only /metrics lives here")
                    return
                try:
                    body = daemon.scheduler.render_metrics() \
                        .encode("utf-8")
                except Exception as e:  # noqa: BLE001 — answered
                    self.send_error(
                        500, f"render failed: {type(e).__name__}")
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 metrics_mod.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are not log traffic
                pass

        httpd = http.server.ThreadingHTTPServer(
            (self.args.metrics_host, self.args.metrics_port), Handler)
        httpd.daemon_threads = True
        self._metrics_httpd = httpd
        self.metrics_port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever,
                             daemon=True, name="sheepd-metrics-http")
        t.start()
        print(f"sheepd: metrics on http://{self.args.metrics_host}:"
              f"{self.metrics_port}/metrics",
              file=sys.stderr, flush=True)

    # -- wire ----------------------------------------------------------
    def _bind(self) -> socket.socket:
        a = self.args
        if (a.socket is None) == (a.port is None):
            raise SystemExit("sheepd: pass exactly one of --socket PATH "
                             "or --port N")
        if a.socket is not None:
            # a stale socket file from a dead daemon would fail the
            # bind; connect-probe it so we never steal a live one
            if os.path.exists(a.socket):
                probe = socket.socket(socket.AF_UNIX)
                try:
                    probe.settimeout(0.5)
                    probe.connect(a.socket)
                except OSError:
                    os.unlink(a.socket)
                else:
                    probe.close()
                    raise SystemExit(f"sheepd: {a.socket} already has a "
                                     f"live daemon")
                finally:
                    probe.close()
            s = socket.socket(socket.AF_UNIX)
            s.bind(a.socket)
        else:
            s = socket.socket(socket.AF_INET)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((a.host, a.port))
        s.listen(64)
        return s

    def _accept_loop(self) -> None:
        while not self._shutdown_evt.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by shutdown
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True, name="sheepd-conn")
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        with conn:
            rf = conn.makefile("rb")
            # chunked-update staging: transactions live on
            # THIS connection's stack frame and nowhere else — a client
            # dying mid-stream (no commit) drops its uncommitted chunks
            # with the frame, leaving the resident at its prior epoch
            txns: dict = {}
            try:
                while True:
                    try:
                        line = protocol.read_line(rf)
                    except protocol.ProtocolError as e:
                        conn.sendall(protocol.dumps(
                            {"ok": False, "error": str(e)}))
                        return
                    if line is None:
                        return
                    if not line.strip():
                        continue
                    verb = "malformed"
                    try:
                        req = protocol.parse_request(line)
                        verb = req["op"]
                        resp = self._dispatch(req, txns=txns)
                    except protocol.ProtocolError as e:
                        resp = {"ok": False, "error": str(e)}
                    except Exception as e:  # noqa: BLE001 — answered
                        resp = {"ok": False,
                                "error": f"internal: {type(e).__name__}: "
                                         f"{str(e)[:300]}"}
                    # SLO denominators: every answered wire
                    # request lands on sheepd_requests_total{verb,
                    # outcome} — what fleet error-rate bounds divide by
                    sched = self.scheduler
                    if sched is not None:
                        sched.record_request(
                            verb, "ok" if resp.get("ok") else "error")
                    try:
                        conn.sendall(protocol.dumps(resp))
                    except OSError:
                        return  # peer went away mid-answer
            finally:
                rf.close()

    # -- ops -----------------------------------------------------------
    def _dispatch(self, req: dict,
                  txns: Optional[dict] = None) -> dict:
        op = req["op"]
        sched = self.scheduler
        # propagated trace context: validated here so a
        # malformed traceparent is answered loudly, never silently
        # mis-correlated; threaded into the job's detached span +
        # flight ring at submit
        trace = None
        if req.get("trace") is not None:
            trace = protocol.parse_traceparent(req["trace"])
        if op == "update" and req.get("stream") is not None:
            return self._update_stream(req, txns)
        if op == "ping":
            return {"ok": True, "pid": os.getpid(),
                    "uptime_s": sched.stats()["uptime_s"]}
        if op == "submit":
            spec = protocol.JobSpec.from_request(
                req.get("job"), tenant=req.get("tenant", "default"))
            if req.get("reattach"):
                # idempotent resubmission: a retried submit
                # reattaches to the journaled/live twin by spec digest
                # instead of double-building
                job, reattached = sched.reattach_or_submit(
                    spec, trace=trace)
            else:
                job, reattached = sched.submit(spec,
                                               trace=trace), False
            return {"ok": True, "job_id": job.id, "state": job.state,
                    **({"reattached": True} if reattached else {}),
                    **({"error": job.error} if job.error else {})}
        if op in ("status", "wait", "cancel"):
            job_id = req.get("job_id")
            if not job_id:
                raise protocol.ProtocolError(f"{op} needs job_id")
            if op == "cancel":
                state = sched.cancel(job_id)
                if state is None:
                    raise protocol.ProtocolError(
                        f"unknown job {job_id!r}")
                return {"ok": True, "job_id": job_id, "state": state}
            if op == "wait":
                job = sched.wait(job_id,
                                 timeout_s=req.get("timeout_s"))
            else:
                job = sched.get(job_id)
            if job is None:
                raise protocol.ProtocolError(f"unknown job {job_id!r}")
            return {"ok": True, "job": job.descriptor(with_results=True)}
        if op == "list":
            return {"ok": True,
                    "jobs": [j.descriptor() for j in sched.jobs()]}
        if op == "stats":
            return {"ok": True, "stats": sched.stats()}
        if op == "metrics":
            from sheep_tpu_torch.obs import metrics as metrics_mod

            return {"ok": True,
                    "content_type": metrics_mod.CONTENT_TYPE,
                    "text": sched.render_metrics()}
        if op == "lookup":
            # fleet verb: does this replica's result store
            # hold the digest? A multi-endpoint client probes every
            # replica; any hit short-circuits headroom routing.
            digest = req.get("digest")
            if not digest or not isinstance(digest, str):
                raise protocol.ProtocolError(
                    "lookup needs a 'digest' string")
            return {"ok": True, "digest": digest,
                    "hit": bool(sched.lookup_digest(digest))}
        if op in ("update", "epoch", "compact"):
            # resident-partition verbs: executed on the
            # dispatch thread; this handler just parks on the answer
            job_id = req.get("job_id")
            if not job_id:
                raise protocol.ProtocolError(f"{op} needs job_id")
            if op == "epoch":
                return {"ok": True, **sched.epoch_info(job_id)}
            if op == "compact":
                return {"ok": True, **sched.compact_resident(
                    job_id, mode=req.get("mode", "auto"),
                    score=bool(req.get("score", False)))}
            adds = protocol.decode_edges(req.get("adds")) \
                if req.get("adds") is not None else None
            dels = protocol.decode_edges(req.get("dels")) \
                if req.get("dels") is not None else None
            log = req.get("log")
            if log is not None and not isinstance(log, str):
                raise protocol.ProtocolError(
                    "update.log must be a daemon-side path")
            if log is None and adds is None and dels is None:
                raise protocol.ProtocolError(
                    "update needs adds/dels payloads or a log path")
            epoch = req.get("epoch")
            if epoch is not None:
                try:
                    epoch = int(epoch)
                except (TypeError, ValueError):
                    raise protocol.ProtocolError(
                        "update.epoch must be an integer") from None
            return {"ok": True, **sched.update(
                job_id, adds=adds, dels=dels, epoch=epoch,
                score=bool(req.get("score", False)),
                compact=str(req.get("compact", "auto")), log=log)}
        if op == "profile":
            pdir = req.get("dir")
            if not pdir or not isinstance(pdir, str):
                raise protocol.ProtocolError(
                    "profile needs a daemon-side directory in 'dir'")
            info = sched.arm_profile(pdir, steps=req.get("steps", 8))
            return {"ok": True, "profile": info}
        if op == "shutdown":
            if req.get("suspend"):
                # the SIGTERM graceful drain, reachable on the wire:
                # checkpoint + journal the running jobs, then exit 0
                if sched.journal is None:
                    raise protocol.ProtocolError(
                        "shutdown suspend needs a durable daemon "
                        "(--state-dir)")
                sched.shutdown_suspend(
                    float(req.get("grace_s",
                                  self.args.drain_grace_s)))
                self._shutdown_evt.set()
                return {"ok": True, "suspending": True}
            drain = bool(req.get("drain", False))
            sched.shutdown(drain=drain)
            self._shutdown_evt.set()
            return {"ok": True, "draining": drain}
        raise protocol.ProtocolError(f"unhandled op {op!r}")

    def _update_stream(self, req: dict,
                       txns: Optional[dict]) -> dict:
        """Chunked ``update`` framing.

        Staged payloads live in ``txns`` — the calling connection's
        dict — so a torn stream (client death, no commit) is discarded
        with the connection and changes nothing server-side. Only
        ``commit`` touches the scheduler, and it does so through the
        exact same ``sched.update`` path as a single-shot update.
        """
        import numpy as np

        if txns is None:
            raise protocol.ProtocolError(
                "chunked update is connection-scoped")
        verb = req.get("stream")
        if verb not in protocol.UPDATE_STREAM_VERBS:
            raise protocol.ProtocolError(
                f"update.stream must be one of "
                f"{protocol.UPDATE_STREAM_VERBS}, got {verb!r}")
        if verb == "begin":
            job_id = req.get("job_id")
            if not job_id:
                raise protocol.ProtocolError(
                    "update stream begin needs job_id")
            txns["seq"] = txns.get("seq", 0) + 1
            txn = f"u{txns['seq']}"
            txns.setdefault("open", {})[txn] = {
                "job_id": job_id, "adds": [], "dels": [], "bytes": 0}
            return {"ok": True, "txn": txn, "job_id": job_id}
        txn = req.get("txn")
        st = txns.get("open", {}).get(txn)
        if st is None:
            raise protocol.ProtocolError(
                f"unknown update txn {txn!r} (transactions are "
                f"connection-scoped: begin/chunk/commit must share "
                f"one connection)")
        if verb == "abort":
            del txns["open"][txn]
            return {"ok": True, "txn": txn, "aborted": True}
        if verb == "chunk":
            adds = protocol.decode_edges(req.get("adds")) \
                if req.get("adds") is not None else None
            dels = protocol.decode_edges(req.get("dels")) \
                if req.get("dels") is not None else None
            if adds is None and dels is None:
                raise protocol.ProtocolError(
                    "update stream chunk needs adds and/or dels")
            nbytes = 16 * ((0 if adds is None else len(adds)) +
                           (0 if dels is None else len(dels)))
            if st["bytes"] + nbytes > protocol.MAX_UPDATE_TXN_BYTES:
                del txns["open"][txn]  # poisoned — force a fresh begin
                raise protocol.ProtocolError(
                    f"update txn {txn} exceeds "
                    f"{protocol.MAX_UPDATE_TXN_BYTES} staged bytes; "
                    f"txn aborted")
            if adds is not None and len(adds):
                st["adds"].append(adds)
            if dels is not None and len(dels):
                st["dels"].append(dels)
            st["bytes"] += nbytes
            return {"ok": True, "txn": txn,
                    "adds": int(sum(len(a) for a in st["adds"])),
                    "dels": int(sum(len(d) for d in st["dels"]))}
        # commit: fold every staged chunk as ONE epoch
        del txns["open"][txn]
        adds = np.concatenate(st["adds"]) if st["adds"] else None
        dels = np.concatenate(st["dels"]) if st["dels"] else None
        if adds is None and dels is None:
            raise protocol.ProtocolError(
                f"update txn {txn} committed with no staged edges")
        epoch = req.get("epoch")
        if epoch is not None:
            try:
                epoch = int(epoch)
            except (TypeError, ValueError):
                raise protocol.ProtocolError(
                    "update.epoch must be an integer") from None
        return {"ok": True, "txn": txn, **self.scheduler.update(
            st["job_id"], adds=adds, dels=dels, epoch=epoch,
            score=bool(req.get("score", False)),
            compact=str(req.get("compact", "auto")))}

    # -- lifecycle -----------------------------------------------------
    def serve(self) -> int:
        from sheep_tpu_torch import obs
        from sheep_tpu_torch.server.scheduler import Scheduler

        a = self.args
        journal_path = None
        ckpt_dir = a.checkpoint_dir
        result_store = None
        if a.state_dir is not None:
            os.makedirs(a.state_dir, exist_ok=True)
            journal_path = os.path.join(a.state_dir, "journal.jsonl")
            if ckpt_dir is None:
                ckpt_dir = os.path.join(a.state_dir, "ckpt")
            if getattr(a, "result_cache_bytes", 0) > 0:
                # fleet warm path: the content-addressed
                # result store shares the durability root — entries
                # publish only after the journal terminal lands
                from sheep_tpu_torch.server.resultstore import ResultStore

                result_store = ResultStore(
                    os.path.join(a.state_dir, "results"),
                    max_bytes=a.result_cache_bytes)
        elif ckpt_dir is not None:
            raise SystemExit("sheepd: --checkpoint-dir needs "
                             "--state-dir (checkpoints cannot resume "
                             "jobs a lost journal forgot)")
        # the exclusive lock comes BEFORE the stale-socket probe: two
        # concurrent starters must serialize on the kernel lock, not
        # race the probe/unlink/bind window
        self._acquire_lock()
        tracer = None
        if a.trace:
            tracer = obs.install(obs.Tracer(a.trace))
            obs.emit_manifest(tracer, config=vars(a), backend="sheepd",
                              device=a.device or "cuda")
        root_span = obs.begin("serve")
        self._root_span = root_span
        try:
            self.scheduler = Scheduler(
                device=a.device, budget_bytes=a.budget_bytes,
                root_span_id=getattr(root_span, "id", None),
                journal=journal_path, checkpoint_dir=ckpt_dir,
                checkpoint_every=a.checkpoint_every,
                result_store=result_store)
            if self._early_signal is not None:
                # a signal that came while the journal replayed
                self._early_signal()
            if tracer is not None and a.heartbeat_secs:
                # started after the scheduler exists so each beat can
                # sample its queue depth / active jobs: soak logs show
                # SERVICE pressure, not just per-run progress
                tracer.heartbeat = obs.Heartbeat(
                    tracer, a.heartbeat_secs, device=self.scheduler.device,
                    service=self.scheduler.service_pressure).start()
            if a.metrics_port is not None:
                self._start_metrics_http()
            self._sock = self._bind()
            addr = a.socket if a.socket is not None \
                else f"{a.host}:{a.port}"
            print(f"sheepd: listening on {addr} (budget="
                  f"{self.scheduler.budget or 'unlimited'})",
                  file=sys.stderr, flush=True)

            acceptor = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="sheepd-accept")
            acceptor.start()
            # the dispatch loop runs on THIS thread until shutdown
            self.scheduler.run()
            self._shutdown_evt.set()
            return 0
        finally:
            if self._metrics_httpd is not None:
                try:
                    self._metrics_httpd.shutdown()
                    self._metrics_httpd.server_close()
                except OSError:
                    pass
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            if a.socket and os.path.exists(a.socket):
                try:
                    os.unlink(a.socket)
                except OSError:
                    pass
            root_span.end()
            if tracer is not None:
                if tracer.heartbeat is not None:
                    tracer.heartbeat.stop()
                obs.uninstall()
                tracer.close()
            self._release_lock()
            print("sheepd: shut down cleanly", file=sys.stderr,
                  flush=True)


    # -- signals (installed by main() alone) -----------------------------
    def on_sigint(self, _num=None, _frame=None) -> None:
        if self.scheduler is not None:
            self.scheduler.shutdown(drain=False)
        else:
            self._early_signal = self.on_sigint
        self._shutdown_evt.set()

    def on_sigterm(self, _num=None, _frame=None) -> None:
        # SIGTERM on a durable daemon is the graceful drain: checkpoint
        # the running jobs at their next boundary, journal the handoff,
        # exit 0, and the next incarnation resumes them. A daemon without
        # a journal cancels its jobs.
        sched = self.scheduler
        if sched is None:
            self._early_signal = self.on_sigterm
        elif sched.journal is not None:
            sched.shutdown_suspend(self.args.drain_grace_s)
        else:
            sched.shutdown(drain=False)
        self._shutdown_evt.set()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    daemon = Daemon(args)
    signal.signal(signal.SIGTERM, daemon.on_sigterm)
    signal.signal(signal.SIGINT, daemon.on_sigint)
    return daemon.serve()


if __name__ == "__main__":
    sys.exit(main())
