"""Minimal RESP (REdis Serialization Protocol) client — port of
``analytics_zoo_tpu/serving/resp.py``, the wire layer under
``RedisBackend`` when the ``redis`` package is not installed (pure
Python, sockets and threads).

It covers the command subset the serving contract uses: XADD / XLEN /
XREAD / XDEL (the input stream), XGROUP / XREADGROUP / XACK / XPENDING /
XCLAIM (consumer-group fleet serving), HSET / HGETALL / HDEL / DEL / KEYS
(``result:<uri>`` hashes and the fleet heartbeat hash), PING. RESP2
framing: arrays of bulk strings out; simple, bulk, integer and array
replies in. Connections come from a small shared pool (made on demand,
bounded by peak concurrency), so the serve loop's blocking read never
holds up a producer's ``xadd``; a connection that errors mid-command is
discarded, never returned to the pool — a desynced socket would answer
the next command with the previous command's late reply.

Transparent reconnect: a transport error (``ConnectionError``/
``OSError``) discards the socket and, for idempotent commands, retries
on a fresh connection under the client's ``RetryPolicy``, counting each
round in ``zoo_backend_reconnects_total{backend="resp"}``. Every command
of the contract is idempotent in effect except ``XADD`` (a blind retry
could enqueue a record twice) and ``XREADGROUP`` (a lost reply's
deliveries already sit in the PEL): both stay at most once and the error
propagates — the producer owns the re-enqueue, the consumer's reclaim
sweep recovers a lost delivery. A pipeline retries as a unit only when
every buffered command is idempotent, and a retry drops every partial
reply read off the dead socket. Fault sites: ``resp.send`` and
``resp.recv``, once a command (or pipeline) attempt.
"""

from __future__ import annotations

import itertools
import logging
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common import faults
from ..common.reliability import RetryPolicy

log = logging.getLogger("analytics_zoo_tpu_torch.serving.resp")

__all__ = ["RespClient", "RespError", "RespPipeline"]

#: commands whose blind re-execution changes observable state — everything
#: else in the serving contract may retry transparently (see module doc).
#: XREADGROUP joins XADD: with ``>`` it DELIVERS new entries into the
#: group's PEL — a reply lost in transit leaves them owned by this
#: consumer, and a blind retry would pull a fresh set on top. The
#: originals are not lost (the consumer's own reclaim sweep re-claims
#: them once idle), so one attempt + propagate is the safe contract.
#: XCLAIM stays retryable: an applied-then-dropped claim just means the
#: retry finds nothing idle — the entries sit in OUR pel until the next
#: sweep; nothing is double-applied.
_NON_IDEMPOTENT = frozenset({"XADD", "XREADGROUP"})


class RespError(RuntimeError):
    """Server returned an error reply (``-ERR ...``)."""


def _frame(parts) -> bytes:
    """One RESP command frame: an array of bulk strings. Values may be
    str (utf-8 encoded), int/float (decimal text), or bytes (sent raw —
    RESP bulk strings are length-prefixed, so binary payloads like the
    v2 tensor bytes pass untouched)."""
    out = [b"*%d\r\n" % len(parts)]
    for p in parts:
        if isinstance(p, str):
            p = p.encode()
        elif isinstance(p, (int, float)):
            p = str(p).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(p), p))
    return b"".join(out)


class _Conn:
    """One socket + read buffer (single-thread use). The buffer is read
    at an offset (``pos``): a reply's bytes are copied once a ``recv``,
    not once a line — a 32-record read of 2 KB rows is hundreds of lines,
    and re-slicing the rest of the buffer for each cost milliseconds."""

    def __init__(self, host: str, port: int, timeout: float):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.buf = b""
        self.pos = 0

    def send(self, *parts) -> None:
        self.sock.sendall(_frame(parts))

    def _fill(self) -> None:
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("redis connection closed")
        self.buf = self.buf[self.pos:] + chunk
        self.pos = 0

    def _read_line(self) -> bytes:
        while True:
            end = self.buf.find(b"\r\n", self.pos)
            if end >= 0:
                break
            self._fill()
        line = self.buf[self.pos:end]
        self.pos = end + 2
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self.buf) - self.pos < n + 2:
            self._fill()
        data = self.buf[self.pos:self.pos + n]
        self.pos += n + 2                   # strip \r\n
        return data

    def read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n == -1 else [self.read_reply()
                                         for _ in range(n)]
        raise RespError(f"unparseable reply start {line!r}")

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class RespClient:
    def __init__(self, host: str = "localhost", port: int = 6379,
                 timeout: float = 30.0, retry: Optional[RetryPolicy] = None,
                 registry=None):
        self._host, self._port, self._timeout = host, port, timeout
        #: reconnect/retry schedule for idempotent commands; pass a seeded
        #: policy for deterministic backoff in tests
        self._retry = retry if retry is not None else RetryPolicy(
            max_attempts=4, base_delay=0.05, max_delay=1.0)
        self._pool: List[_Conn] = []
        self._pool_lock = threading.Lock()
        self._closed = False
        self._m_reconnects = None
        if registry is None:
            from ..observability import default_registry
            registry = default_registry()
        self._m_reconnects = registry.counter(
            "zoo_backend_reconnects_total",
            "transport errors answered with a reconnect + retry",
            labels={"backend": "resp"})
        self._release(_Conn(host, port, timeout))  # eager: bad host fails now

    def _acquire(self) -> _Conn:
        if self._closed:
            raise RuntimeError("RespClient is closed")
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return _Conn(self._host, self._port, self._timeout)

    def _release(self, c: _Conn) -> None:
        with self._pool_lock:
            if self._closed:
                c.close()
            else:
                self._pool.append(c)

    def close(self):
        with self._pool_lock:
            self._closed = True
            for c in self._pool:
                c.close()
            self._pool.clear()

    @staticmethod
    def _op_name(parts) -> str:
        op = parts[0] if parts else ""
        if isinstance(op, bytes):
            op = op.decode("ascii", "replace")
        return str(op).upper()

    def _retries(self, retryable: bool):
        """The reconnect schedule for one logical command: a leading None
        (the first attempt sleeps nothing), then the policy's backoff
        delays — empty for non-idempotent ops, which get ONE attempt."""
        if not retryable:
            return iter((None,))
        return itertools.chain((None,), self._retry.delays())

    def _run_with_reconnect(self, label: str, retryable: bool, attempt):
        """The one reconnect-retry scaffold both surfaces share:
        acquire a connection, run ``attempt(conn)``, release on success.
        A transport error (connect refused / timeout / partial read /
        loss) DISCARDS the socket — it may hold a late reply that would
        answer the next command — and, for retryable work only, retries
        fresh under the backoff schedule, counting each round in the
        reconnect metric. ``attempt`` raising :class:`RespError` means
        the reply stream stayed in sync: the connection is released and
        the error propagates without a retry. Any other exception
        discards the connection and propagates."""
        last: Optional[BaseException] = None
        for delay in self._retries(retryable):
            if delay is not None:
                self._m_reconnects.inc()
                log.warning("resp %s hit %s; reconnecting in %.3fs",
                            label, last, delay)
                if delay > 0:
                    time.sleep(delay)
            c: Optional[_Conn] = None
            try:
                c = self._acquire()     # may itself fail: server down
                result = attempt(c)
            except RespError:
                self._release(c)
                raise
            except (ConnectionError, OSError) as e:
                if c is not None:
                    c.close()
                last = e
                continue
            except Exception:
                if c is not None:
                    c.close()
                raise
            self._release(c)
            return result
        assert last is not None
        raise last

    def command(self, *parts):
        op = self._op_name(parts)

        def attempt(c: _Conn):
            # chaos sites: one fire per logical command attempt, before
            # the socket op it models — a `disconnect` here exercises the
            # reconnect and idempotency rules a dropped TCP connection
            # would
            faults.inject("resp.send")
            c.send(*parts)
            faults.inject("resp.recv")
            return c.read_reply()

        return self._run_with_reconnect(op, op not in _NON_IDEMPOTENT,
                                        attempt)

    def execute_many(self, commands):
        """Pipelined execution: write every command frame in ONE socket
        send, then read the replies back in order — one network round
        trip for the whole batch (how the async publisher lands a
        batch's result hashes). An error REPLY keeps the stream in sync
        (remaining replies are still read, the first error raises after
        the pass). A transport error discards the connection and — when
        every command in the batch is idempotent — retries the WHOLE
        batch on a fresh one, dropping any partial replies read off the
        dead socket (a reply that might pair with an un-applied command
        must never be surfaced). A batch containing a non-idempotent
        command (XADD) never retries: the error propagates with the
        stream state at most once-applied."""
        commands = list(commands)
        if not commands:
            return []
        retryable = all(self._op_name(c) not in _NON_IDEMPOTENT
                        for c in commands)

        def attempt(c: _Conn):
            faults.inject("resp.send")   # once per pipeline attempt
            c.sock.sendall(b"".join(_frame(parts) for parts in commands))
            faults.inject("resp.recv")
            replies, first_err = [], None
            for _ in commands:
                try:
                    replies.append(c.read_reply())
                except RespError as e:
                    # an error REPLY: the stream stays in sync — keep
                    # reading so later replies pair with their commands
                    replies.append(e)
                    if first_err is None:
                        first_err = e
            return replies, first_err

        replies, first_err = self._run_with_reconnect(
            f"pipeline({len(commands)} cmds)", retryable, attempt)
        if first_err is not None:
            raise first_err
        return replies

    def pipeline(self) -> "RespPipeline":
        """A command buffer matching the slice of redis-py's pipeline
        surface ``RedisBackend`` uses (``hset`` + ``execute``)."""
        return RespPipeline(self)

    # -- the redis-py surface RedisBackend uses ------------------------------
    def ping(self) -> bool:
        return self.command("PING") in (b"PONG", "PONG")

    def xadd(self, stream: str, fields: Dict) -> bytes:
        args: List = ["XADD", stream, "*"]
        for k, v in fields.items():
            args += [k, v]
        return self.command(*args)

    def xlen(self, stream: str) -> int:
        return int(self.command("XLEN", stream))

    def xread(self, streams: Dict[str, str], count: Optional[int] = None,
              block: Optional[int] = None):
        args: List = ["XREAD"]
        if count is not None:
            args += ["COUNT", count]
        if block is not None:
            args += ["BLOCK", block]
        args += ["STREAMS"] + list(streams.keys()) + list(streams.values())
        resp = self.command(*args)
        if resp is None:
            return []
        out = []
        for name, entries in resp:
            decoded = []
            for eid, kv in entries:
                fields = {kv[i]: kv[i + 1] for i in range(0, len(kv), 2)}
                decoded.append((eid, fields))
            out.append((name, decoded))
        return out

    def xdel(self, stream: str, *entry_ids: str) -> int:
        return int(self.command("XDEL", stream, *entry_ids))

    # -- consumer groups (docs/guides/SERVING.md) ----------------------------
    def xgroup_create(self, stream: str, group: str) -> None:
        """XGROUP CREATE from id 0 with MKSTREAM; raises RespError
        (BUSYGROUP) when the group exists — ``RedisBackend`` swallows
        that one, making creation idempotent at its layer."""
        self.command("XGROUP", "CREATE", stream, group, "0", "MKSTREAM")

    def xreadgroup(self, group: str, consumer: str,
                   streams: Dict[str, str], count: Optional[int] = None,
                   block: Optional[int] = None):
        """Same reply shape as :meth:`xread`, read through a group
        (non-idempotent: one attempt, see ``_NON_IDEMPOTENT``)."""
        args: List = ["XREADGROUP", "GROUP", group, consumer]
        if count is not None:
            args += ["COUNT", count]
        if block is not None:
            args += ["BLOCK", block]
        args += ["STREAMS"] + list(streams.keys()) + list(streams.values())
        resp = self.command(*args)
        if resp is None:
            return []
        out = []
        for name, entries in resp:
            decoded = []
            for eid, kv in entries or []:
                if kv is None:      # a deleted entry still in the PEL
                    continue
                fields = {kv[i]: kv[i + 1] for i in range(0, len(kv), 2)}
                decoded.append((eid, fields))
            out.append((name, decoded))
        return out

    def xack(self, stream: str, group: str, *entry_ids: str) -> int:
        return int(self.command("XACK", stream, group, *entry_ids))

    def xpending_range(self, stream: str, group: str, min_idle_ms: int,
                       count: int) -> List[tuple]:
        """Extended XPENDING, idle-filtered: ``[(id, consumer,
        delivery_count), ...]`` for up to ``count`` entries idle at
        least ``min_idle_ms`` — the reclaim sweep's candidate list."""
        resp = self.command("XPENDING", stream, group, "IDLE",
                            int(min_idle_ms), "-", "+", count) or []
        return [(eid, consumer, int(times))
                for eid, consumer, _idle, times in resp]

    def xpending_summary(self, stream: str, group: str) -> Dict[str, int]:
        """Summary XPENDING: per-consumer pending counts."""
        resp = self.command("XPENDING", stream, group)
        if not resp or resp[3] is None:
            return {}
        out: Dict[str, int] = {}
        for consumer, n in resp[3]:
            key = consumer.decode() if isinstance(consumer, bytes) \
                else str(consumer)
            out[key] = int(n)
        return out

    def xclaim(self, stream: str, group: str, consumer: str,
               min_idle_ms: int, entry_ids: List[str]):
        """``[(id, fields_or_None), ...]`` for the entries actually
        transferred; ids whose idle clock was reset by a racing claimer
        are simply absent from the reply."""
        resp = self.command("XCLAIM", stream, group, consumer,
                            int(min_idle_ms), *entry_ids) or []
        out = []
        for item in resp:
            if item is None:
                continue
            eid, kv = item
            fields = None if kv is None else \
                {kv[i]: kv[i + 1] for i in range(0, len(kv), 2)}
            out.append((eid, fields))
        return out

    def hset(self, key: str, mapping: Dict) -> int:
        args: List = ["HSET", key]
        for k, v in mapping.items():
            args += [k, v]
        return int(self.command(*args))

    def hgetall(self, key: str) -> Dict[bytes, bytes]:
        resp = self.command("HGETALL", key) or []
        return {resp[i]: resp[i + 1] for i in range(0, len(resp), 2)}

    def hdel(self, key: str, *fields: str) -> int:
        return int(self.command("HDEL", key, *fields))

    def delete(self, key: str) -> int:
        return int(self.command("DEL", key))

    def keys(self, pattern: str) -> List[bytes]:
        return self.command("KEYS", pattern) or []


class RespPipeline:
    """Buffered commands flushed through :meth:`RespClient.execute_many`
    in one round trip. Only the commands ``RedisBackend.set_results``
    queues are implemented; extend as the backend grows."""

    def __init__(self, client: RespClient):
        self._client = client
        self._commands: List[tuple] = []

    def hset(self, key: str, mapping: Dict) -> "RespPipeline":
        args: List = ["HSET", key]
        for k, v in mapping.items():
            args += [k, v]
        self._commands.append(tuple(args))
        return self

    def execute(self) -> List:
        commands, self._commands = self._commands, []
        return self._client.execute_many(commands)
