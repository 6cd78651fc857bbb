"""Swift REST frontend: the second rgw dialect (src/rgw/rgw_rest_swift.cc).

The reference serves the SAME buckets/objects through two protocols —
S3 and OpenStack Swift — from one gateway. This module is the Swift
floor over the shared ObjectGateway:

    GET  /auth/v1.0                      TempAuth: X-Auth-User/X-Auth-Key
                                         -> X-Auth-Token + X-Storage-Url
    GET  /v1/AUTH_<acct>                 list containers (text; ?format=json)
    PUT  /v1/AUTH_<acct>/<cont>          create container (201)
    DELETE /v1/AUTH_<acct>/<cont>        delete (204; 409 if non-empty)
    GET  /v1/AUTH_<acct>/<cont>          list objects (text; ?format=json,
                                         ?prefix=, ?marker=)
    PUT  /v1/AUTH_<acct>/<cont>/<obj>    store (201, ETag header)
    GET/HEAD /v1/.../<obj>               fetch/stat
    DELETE /v1/.../<obj>                 remove (204)

Containers ARE buckets: an object PUT through Swift is read back
byte-identical through S3 and vice versa (the reference's defining
property for the dual-protocol gateway; tested in
tests/test_swift_rest.py). TempAuth tokens are per-process state, like
the reference's rgw_swift_auth TempURL-less default.
"""

from __future__ import annotations

import asyncio
import json
import secrets
import urllib.parse

from ceph_tpu_torch.rados.client import ObjectNotFound
from ceph_tpu_torch.rgw.gateway import GatewayError, ObjectGateway


class SwiftFrontend:
    def __init__(
        self, gateway: ObjectGateway,
        users: dict[str, str] | None = None,
    ):
        self.gw = gateway
        #: "account:user" -> key (the rgw swift user/subuser database)
        self.users = dict(users or {})
        #: token -> account
        self.tokens: dict[str, str] = {}
        self._server: asyncio.AbstractServer | None = None
        self.port: int | None = None

    def add_user(self, user: str, key: str) -> None:
        self.users[user] = key

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(
            self._serve, host, port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- HTTP plumbing --------------------------------------------------------

    async def _serve(self, reader, writer) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
                try:
                    method, target, _v = (
                        line.decode().strip().split(" ", 2)
                    )
                except ValueError:
                    break
                headers: dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    name, _, value = h.decode().partition(":")
                    headers[name.strip().lower()] = value.strip()
                body = b""
                n = int(headers.get("content-length", "0") or "0")
                if n:
                    body = await reader.readexactly(n)
                status, rhdrs, rbody = await self._handle(
                    method, target, headers, body
                )
                if method == "HEAD":
                    rbody = b""
                reason = {200: "OK", 201: "Created", 202: "Accepted",
                          204: "No Content", 401: "Unauthorized",
                          404: "Not Found", 409: "Conflict",
                          400: "Bad Request"}.get(status, "OK")
                out = [f"HTTP/1.1 {status} {reason}"]
                rhdrs.setdefault("Content-Length", str(len(rbody)))
                rhdrs.setdefault("Connection", "keep-alive")
                for k, v in rhdrs.items():
                    out.append(f"{k}: {v}")
                writer.write(
                    ("\r\n".join(out) + "\r\n\r\n").encode() + rbody
                )
                await writer.drain()
        except (
            asyncio.IncompleteReadError, ConnectionError,
            asyncio.CancelledError,
        ):
            pass
        finally:
            writer.close()

    # -- routing --------------------------------------------------------------

    async def _handle(self, method, target, headers, body):
        url = urllib.parse.urlsplit(target)
        path = urllib.parse.unquote(url.path)
        query = dict(
            urllib.parse.parse_qsl(url.query, keep_blank_values=True)
        )
        if path == "/auth/v1.0":
            return self._auth(method, headers)
        account = self._verify_token(headers)
        if account is None:
            return 401, {}, b"Unauthorized"
        parts = [p for p in path.split("/") if p]
        # /v1/AUTH_<acct>[/container[/object...]]
        if len(parts) < 2 or parts[0] != "v1" or (
            parts[1] != f"AUTH_{account}"
        ):
            return 404, {}, b"Not Found"
        container = parts[2] if len(parts) > 2 else ""
        obj = "/".join(parts[3:]) if len(parts) > 3 else ""
        try:
            if not container:
                return await self._account(method, query)
            if not obj:
                return await self._container(method, container, query)
            return await self._object(method, container, obj, body)
        except ObjectNotFound:
            return 404, {}, b"Not Found"
        except GatewayError as e:
            msg = str(e)
            if "no bucket" in msg:
                return 404, {}, b"Not Found"
            if "not empty" in msg:
                return 409, {}, b"Conflict"
            if "exists" in msg:
                # swift PUT of an existing container is a 202 no-op
                return 202, {}, b""
            return 400, {}, msg.encode()

    def _auth(self, method, headers):
        if method != "GET":
            return 400, {}, b""
        user = headers.get("x-auth-user", "")
        key = headers.get("x-auth-key", "")
        if self.users.get(user) != key or ":" not in user:
            return 401, {}, b"Unauthorized"
        account = user.split(":", 1)[0]
        token = "AUTH_tk" + secrets.token_hex(16)
        self.tokens[token] = account
        return 200, {
            "X-Auth-Token": token,
            "X-Storage-Url": f"/v1/AUTH_{account}",
        }, b""

    def _verify_token(self, headers) -> str | None:
        return self.tokens.get(headers.get("x-auth-token", ""))

    async def _account(self, method, query):
        if method not in ("GET", "HEAD"):
            return 400, {}, b""
        names = await self.gw.list_buckets()
        if query.get("format") == "json":
            out = json.dumps(
                [{"name": n} for n in names]
            ).encode()
            return 200, {"Content-Type": "application/json"}, out
        return 200, {"Content-Type": "text/plain"}, (
            "".join(f"{n}\n" for n in names).encode()
        )

    async def _container(self, method, container, query):
        if method == "PUT":
            await self.gw.create_bucket(container)
            return 201, {}, b""
        if method == "DELETE":
            await self.gw.delete_bucket(container)
            return 204, {}, b""
        if method in ("GET", "HEAD"):
            page = await self.gw.list_objects(
                container,
                prefix=query.get("prefix", ""),
                marker=query.get("marker", ""),
                max_entries=int(query.get("limit", "1000")),
            )
            entries = {
                k: m for k, m in page["entries"].items()
                if not m.get("delete_marker")
            }
            if query.get("format") == "json":
                out = json.dumps([
                    {"name": k, "bytes": m.get("size", 0),
                     "hash": m.get("etag", "")}
                    for k, m in sorted(entries.items())
                ]).encode()
                return 200, {"Content-Type": "application/json"}, out
            return 200, {"Content-Type": "text/plain"}, (
                "".join(f"{k}\n" for k in sorted(entries)).encode()
            )
        return 400, {}, b""

    async def _object(self, method, container, obj, body):
        if method == "PUT":
            etag, _vid = await self.gw.put_object2(container, obj, body)
            return 201, {"ETag": etag}, b""
        if method == "GET":
            data = await self.gw.get_object(container, obj)
            meta = await self.gw.head_object(container, obj)
            return 200, {
                "Content-Type": "application/octet-stream",
                "ETag": meta.get("etag", ""),
            }, data
        if method == "HEAD":
            meta = await self.gw.head_object(container, obj)
            if meta.get("delete_marker"):
                return 404, {}, b""
            return 200, {
                "Content-Length": str(meta.get("size", 0)),
                "ETag": meta.get("etag", ""),
            }, b""
        if method == "DELETE":
            await self.gw.delete_object(container, obj)
            return 204, {}, b""
        return 400, {}, b""
