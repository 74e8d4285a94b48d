"""``tf.train.Server`` parity handle (an adapted copy of
``distributed_tensorflow_example_tpu/runtime/server.py``).

Constructed from ``(cluster, job_name, task_index)`` as the reference's.
A worker's constructor brings up the ``torch.distributed`` process group through :mod:`.distributed`: rank
``task_index`` of as many ranks as worker hosts, worker 0 the
rendezvous; one worker initializes nothing. A ``ps`` task's ``join()``
logs the no-PS notice and returns, so the reference's ``if job_name ==
"ps": server.join()`` pattern exits 0; a worker has nothing to join.

``profiler_port``: the reference starts ``jax.profiler.start_server`` on
``port + process_index`` (a failed bind warns and training goes on).
Torch has no profiler service, so the counterpart is
:class:`ProfilerService`, a loopback HTTP listener on the same port:
``POST /capture?steps=N`` arms the training loop's ``ProfilerHook`` for
its next N steps and answers, once the trace is written, with the Chrome
trace's path. The server's ``profiler`` goes to the ``Trainer``
(``profiler_service=``); :meth:`Server.close` takes the listener down.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..cluster import ClusterSpec, resolve_legacy_role
from ..utils.logging import get_logger
from . import distributed

log = get_logger("server")

#: the most steps one capture may ask for
MAX_CAPTURE_STEPS = 10_000
#: seconds a capture request waits for its trace unless it asks otherwise
CAPTURE_TIMEOUT_S = 600.0


class CaptureRequest:
    """One capture: the steps it asks for, then the trace's path and the
    steps it holds, or the reason it got none. A ``POST /capture`` traces
    the next ``steps`` steps; a configured window (``--profile_steps``)
    sets ``start``, the step after which its trace begins."""

    def __init__(self, steps: int, start: int | None = None):
        self.steps = steps
        self.start = start
        self.result: dict | None = None
        self.error: str | None = None
        self._done = threading.Event()

    def finish(self, *, path: str, steps: list[int]) -> None:
        self.result = {"path": path, "steps": steps}
        self._done.set()

    def fail(self, why: str) -> None:
        self.error = why
        self._done.set()

    def wait(self, timeout: float) -> bool:
        return self._done.wait(timeout)


class ProfilerService:
    """The loopback capture listener of ``--profiler_port``.

    ``POST /capture?steps=N[&timeout_s=T]`` queues a capture and waits up
    to T seconds for it: 200 ``{"path": <Chrome trace>, "steps": [first,
    last]}`` once the hook has traced N steps, 504 if no step took it in
    time, 409 if training ended before it was taken. ``GET /healthz``
    answers 200. The training thread polls :meth:`take` between steps, so
    the profiler starts and stops on the thread that runs the steps."""

    def __init__(self, port: int):
        self._pending: deque[CaptureRequest] = deque()
        self._lock = threading.Lock()
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          self._handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="profiler-service",
                                        daemon=True)
        self._thread.start()

    def take(self) -> CaptureRequest | None:
        """The oldest waiting capture request (the hook's poll)."""
        with self._lock:
            return self._pending.popleft() if self._pending else None

    def _submit(self, steps: int, timeout: float) -> tuple[int, dict]:
        req = CaptureRequest(steps)
        with self._lock:
            self._pending.append(req)
        if not req.wait(timeout):
            with self._lock:
                taken = req not in self._pending
                if not taken:
                    self._pending.remove(req)
            if not taken:
                return 504, {"error": f"no training step took the capture "
                                      f"within {timeout:g} s"}
            req.wait(None)          # tracing: it finishes or fails
        if req.error is not None:
            return 409, {"error": req.error}
        return 200, req.result

    def close(self) -> None:
        """Listener down; captures still waiting fail (409)."""
        self._httpd.shutdown()
        self._thread.join(timeout=5)
        self._httpd.server_close()
        with self._lock:
            pending, self._pending = list(self._pending), deque()
        for req in pending:
            req.fail("training ended before the capture was taken")

    def _handler(self):
        service = self

        class Handler(BaseHTTPRequestHandler):
            timeout = 30

            def log_message(self, *a):
                pass

            def _send(self, code: int, obj: dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "live"})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                url = urllib.parse.urlparse(self.path)
                if url.path != "/capture":
                    self._send(404, {"error": f"unknown path {url.path}"})
                    return
                q = urllib.parse.parse_qs(url.query)
                try:
                    steps = int(q.get("steps", ["1"])[0])
                    timeout = float(q.get("timeout_s",
                                          [CAPTURE_TIMEOUT_S])[0])
                    if not 1 <= steps <= MAX_CAPTURE_STEPS or timeout <= 0:
                        raise ValueError
                except ValueError:
                    self._send(400, {"error": f"steps must be an integer "
                                              f"in [1, {MAX_CAPTURE_STEPS}]"
                                              f" and timeout_s > 0"})
                    return
                self._send(*service._submit(steps, timeout))

        return Handler


class Server:
    """In-process runtime handle with the reference Server's surface.
    ``device`` picks the process group's backend (NCCL for ``cuda``, the
    default; gloo for ``cpu``) and ``init_method`` overrides worker 0's
    address as the rendezvous."""

    def __init__(self,
                 cluster: ClusterSpec | dict | None = None,
                 job_name: str = "worker",
                 task_index: int = 0,
                 profiler_port: int | None = None,
                 *,
                 device: str | torch.device | None = None,
                 init_method: str | None = None):
        self.cluster = (ClusterSpec(cluster) if cluster
                        and not isinstance(cluster, ClusterSpec)
                        else cluster)
        self.role = resolve_legacy_role(self.cluster, job_name, task_index)
        self._context: distributed.DistributedContext | None = None
        self.profiler: ProfilerService | None = None
        if self.role.should_run:
            self._context = distributed.initialize(
                self.cluster, job_name, task_index, device=device,
                init_method=init_method)
            if profiler_port:
                self._start_profiler(profiler_port)

    def _start_profiler(self, base_port: int) -> None:
        """The capture listener on ``base_port + process_index`` (workers
        sharing a host must not collide), as the reference's service. A
        failed bind warns and training goes on: profiling is auxiliary."""
        port = base_port + (self._context.process_index
                            if self._context else 0)
        try:
            self.profiler = ProfilerService(port)
        except OSError as e:
            log.warning("profiler service failed to start on port %d: %s "
                        "— continuing without it", port, e)
            return
        log.info("profiler service listening on http://127.0.0.1:%d "
                 "(POST /capture?steps=N)", port)

    def close(self) -> None:
        """Take the profiler service down (a no-op without one)."""
        if self.profiler is not None:
            self.profiler.close()
            self.profiler = None

    @property
    def context(self) -> distributed.DistributedContext | None:
        return self._context

    @property
    def target(self) -> str:
        """Session-target parity string: this process's coordinates."""
        idx = (self._context.process_index if self._context
               else self.role.process_index)
        return f"cuda://process/{idx}"

    def join(self) -> None:
        """A ps task logs the notice and returns; a worker has no service
        thread to wait on."""
        if not self.role.should_run:
            log.warning(self.role.notice)
