"""A small HTTP/1.1 client on the standard library's ``http.client``.

The reference's store client rides ``requests`` (one ``Session`` a
thread, ``learningorchestra_tpu/core/store_service.py:911-918``); the
machine with the card has no ``requests``, so the port's
:class:`~learningorchestra_tpu_torch.core.store_service.RemoteStore`
rides this instead. A :class:`Session` keeps one persistent connection
for each host it talks to and is used by one thread at a time. Before a
kept-alive connection is reused it is checked for a close by the server
(a socket that reads as ready holds an end of stream, not an answer),
and opened again: a request is never sent twice.

The errors follow ``requests``' names, which the store's failover logic
tells apart: :class:`ConnectionError` (refused, reset, closed mid
answer: the request may or may not have landed), :class:`Timeout` (no
answer in time) and :class:`HTTPError` (:meth:`Response.raise_for_status`
on a 4xx or 5xx, with the response).
"""

from __future__ import annotations

import http.client
import json as _json
import select
import socket
from typing import Any, Optional
from urllib.parse import urlencode, urlsplit


class RequestException(OSError):
    """Any failure of a request."""

    def __init__(self, *args, response: "Optional[Response]" = None):
        super().__init__(*args)
        self.response = response


class ConnectionError(RequestException):  # noqa: A001 — requests' name
    """The connection was refused, reset or closed before a whole answer."""


class Timeout(RequestException):
    """No answer within the request's timeout."""


class HTTPError(RequestException):
    """A 4xx or 5xx answer (:meth:`Response.raise_for_status`)."""


class Response:
    """One answer: its status, headers (looked up without regard to
    case) and whole body."""

    def __init__(self, url: str, status: int, reason: str, headers, content: bytes):
        self.url = url
        self.status_code = status
        self.reason = reason
        self.headers = headers
        self.content = content

    def json(self) -> Any:
        return _json.loads(self.content)

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            kind = "Client" if self.status_code < 500 else "Server"
            raise HTTPError(
                f"{self.status_code} {kind} Error: {self.reason} for url: {self.url}",
                response=self,
            )


def _closed_by_peer(sock: socket.socket) -> bool:
    """True when an idle kept-alive socket reads as ready: the server
    closed it (or sent what no request asked for), so it cannot carry
    the next request."""
    poller = select.poll()
    poller.register(sock, select.POLLIN)
    return bool(poller.poll(0))


class Session:
    """Persistent connections, one a host; one thread at a time."""

    def __init__(self):
        self._connections: dict = {}

    def _connection(self, host: str, port: int, timeout: Optional[float]):
        key = (host, port)
        connection = self._connections.get(key)
        if connection is not None and (
            connection.sock is None or _closed_by_peer(connection.sock)
        ):
            connection.close()
            connection = None
        if connection is None:
            connection = http.client.HTTPConnection(host, port, timeout=timeout)
            self._connections[key] = connection
        else:
            connection.timeout = timeout
            connection.sock.settimeout(timeout)
        return connection

    def request(
        self,
        method: str,
        url: str,
        params: Optional[dict] = None,
        data=None,
        json: Any = None,
        headers: Optional[dict] = None,
        timeout: Optional[float] = None,
    ) -> Response:
        parts = urlsplit(url)
        if parts.scheme != "http":
            raise ValueError(f"only http:// URLs are served, not {url!r}")
        path = parts.path or "/"
        query = parts.query
        if params:
            query = (query + "&" if query else "") + urlencode(params)
        if query:
            path += "?" + query
        headers = dict(headers or {})
        if json is not None:
            data = _json.dumps(json)
            headers.setdefault("Content-Type", "application/json")
        if isinstance(data, str):
            data = data.encode()
        if data is None and method in ("POST", "PUT", "PATCH"):
            data = b""
        host, port = parts.hostname, parts.port or 80
        connection = self._connection(host, port, timeout)
        try:
            connection.request(method, path, body=data, headers=headers)
            answer = connection.getresponse()
            content = answer.read()
        except (socket.timeout, TimeoutError) as error:
            self._drop(host, port)
            raise Timeout(f"{method} {url}: {error}") from error
        except (OSError, http.client.HTTPException) as error:
            self._drop(host, port)
            raise ConnectionError(f"{method} {url}: {error!r}") from error
        if answer.will_close:
            self._drop(host, port)
        return Response(url, answer.status, answer.reason, answer.headers, content)

    def _drop(self, host: str, port: int) -> None:
        connection = self._connections.pop((host, port), None)
        if connection is not None:
            connection.close()

    def get(self, url: str, **kwargs) -> Response:
        return self.request("GET", url, **kwargs)

    def post(self, url: str, **kwargs) -> Response:
        return self.request("POST", url, **kwargs)

    def delete(self, url: str, **kwargs) -> Response:
        return self.request("DELETE", url, **kwargs)

    def close(self) -> None:
        for key in list(self._connections):
            self._drop(*key)


def request(method: str, url: str, **kwargs) -> Response:
    """One request on a connection of its own, closed after."""
    session = Session()
    try:
        return session.request(method, url, **kwargs)
    finally:
        session.close()


def get(url: str, **kwargs) -> Response:
    return request("GET", url, **kwargs)


def post(url: str, **kwargs) -> Response:
    return request("POST", url, **kwargs)
