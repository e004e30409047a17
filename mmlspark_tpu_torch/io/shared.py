"""Worker-singleton cells + reverse port forwarding.

A copy of the reference's `io/shared.py`, which imports no JAX (role:
the reference's SharedVariable/SharedSingleton, io/http/
SharedVariable.scala — one lazily-constructed instance per executor
JVM, used to share HTTP servers/clients across partition closures — and
PortForwarding, io/http/PortForwarding.scala:12-86 — jsch SSH tunnels so
workers behind NAT expose serving ports to a gateway VM).

A "worker" is a process, so SharedVariable is a process-level
lazily-constructed singleton keyed by name, safe under the thread pools
the HTTP/serving stack uses. Port forwarding shells out to the system
`ssh -R` with the same walk over remote ports as the reference."""
from __future__ import annotations

import subprocess
import threading
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")

_REGISTRY: dict = {}
_REGISTRY_LOCK = threading.Lock()


class SharedVariable(Generic[T]):
    """One lazily-constructed instance per process (reference:
    SharedVariable.scala — @transient lazy val per JVM).

        client = SharedVariable(lambda: build_expensive_client())
        client.get  # constructed once, shared by every pipeline closure
    """

    def __init__(self, constructor: Callable[[], T],
                 name: Optional[str] = None):
        self._constructor = constructor
        self._name = name
        self._lock = threading.Lock()
        self._instance: Optional[T] = None
        self._built = False

    @property
    def get(self) -> T:
        if not self._built:
            with self._lock:
                if not self._built:
                    if self._name is not None:
                        # named cells dedupe across SharedVariable objects,
                        # like the reference's SharedSingleton per uid
                        with _REGISTRY_LOCK:
                            if self._name not in _REGISTRY:
                                _REGISTRY[self._name] = self._constructor()
                            self._instance = _REGISTRY[self._name]
                    else:
                        self._instance = self._constructor()
                    self._built = True
        return self._instance


def shared_singleton(name: str, constructor: Callable[[], T]) -> T:
    """Functional form: the process-wide instance registered under `name`."""
    return SharedVariable(constructor, name=name).get


class ForwardedPort:
    """Handle for one `ssh -R` reverse tunnel; stop() tears it down."""

    def __init__(self, process: subprocess.Popen, remote_port: int,
                 local_port: int):
        self.process = process
        self.remote_port = remote_port
        self.local_port = local_port

    def stop(self) -> None:
        if self.process.poll() is None:
            self.process.terminate()
            try:
                self.process.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.process.kill()


def forward_port_to_remote(username: str, ssh_host: str, local_port: int,
                           remote_port_start: int, ssh_port: int = 22,
                           bind_address: str = "*",
                           local_host: str = "127.0.0.1",
                           key_file: Optional[str] = None,
                           max_attempts: int = 50,
                           settle_timeout: float = 1.5,
                           _runner=None) -> ForwardedPort:
    """Expose a local serving port on a remote gateway via `ssh -R`,
    walking remote ports upward until one binds (reference:
    PortForwarding.forwardPortToRemote's attempt loop). `_runner` injects a
    fake ssh for tests.

    `settle_timeout` is how long ssh gets to REJECT the forward before we
    declare the tunnel live; raise it for slow gateways. Even then the check
    is a heuristic — long-running callers must watch
    ``ForwardedPort.process.poll()`` for liveness."""
    runner = _runner or _start_ssh
    last_err = None
    for attempt in range(max_attempts):
        remote_port = remote_port_start + attempt
        try:
            proc = runner(username, ssh_host, ssh_port, bind_address,
                          remote_port, local_host, local_port, key_file,
                          settle_timeout)
        except OSError as e:  # ssh binary missing etc.
            raise RuntimeError(f"could not launch ssh: {e}") from e
        if proc is not None:
            return ForwardedPort(proc, remote_port, local_port)
        last_err = f"remote port {remote_port} unavailable"
    raise RuntimeError(
        f"failed to forward port after {max_attempts} attempts: {last_err}")


_PORT_BUSY_MARKERS = ("remote port forwarding failed",
                      "address already in use", "forwarding failed")


def _start_ssh(username, ssh_host, ssh_port, bind_address, remote_port,
               local_host, local_port, key_file, settle_timeout=1.5):
    cmd = ["ssh", "-N", "-o", "ExitOnForwardFailure=yes",
           "-o", "BatchMode=yes", "-p", str(ssh_port),
           "-R", f"{bind_address}:{remote_port}:{local_host}:{local_port}",
           f"{username}@{ssh_host}"]
    if key_file:
        cmd[1:1] = ["-i", key_file]
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        # ExitOnForwardFailure makes ssh exit promptly when the remote
        # port is taken; give it `settle_timeout` to fail. (Heuristic: a
        # gateway slower than this to REJECT the forward is reported as
        # bound; callers should treat ForwardedPort.process liveness as the
        # source of truth for long-running tunnels.)
        proc.wait(timeout=settle_timeout)
    except subprocess.TimeoutExpired:
        # one more poll after the wait: catches a rejection that landed in
        # the narrow window between wait() raising and us returning
        if proc.poll() is None:
            # still running -> tunnel established; drain stderr forever so
            # a chatty gateway can't fill the pipe and stall ssh mid-session
            threading.Thread(target=_drain, args=(proc.stderr,),
                             daemon=True).start()
            return proc
    err = (proc.stderr.read() or b"").decode(errors="replace").strip()
    proc.stderr.close()
    if any(m in err.lower() for m in _PORT_BUSY_MARKERS):
        return None  # this remote port is taken -> walk to the next
    # auth/DNS/unreachable failures repeat identically on every port:
    # surface the real error instead of walking 50 ports
    detail = err or f"exit {proc.returncode}"
    raise RuntimeError(f"ssh tunnel to {ssh_host} failed: {detail}")


def _drain(stream):
    try:
        while stream.read(65536):
            pass
    except Exception:  # noqa: BLE001 - reader dies with the process
        pass
