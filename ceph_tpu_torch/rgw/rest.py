"""S3 REST frontend: the rgw HTTP surface over ObjectGateway.

The reference's defining RGW surface is the S3 wire protocol
(src/rgw/rgw_rest_s3.cc) behind AWS Signature V4 auth
(src/rgw/rgw_auth_s3.cc): XML bodies, path-style bucket/key routing,
multipart via ?uploads/?uploadId query ops. This module serves that
protocol from an asyncio HTTP/1.1 server so any S3-wire-format client
can talk to the cluster:

    PUT    /bucket                    create bucket
    DELETE /bucket                    delete bucket (409 if non-empty)
    GET    /bucket?prefix=&marker=    ListBucketResult XML
    PUT    /bucket/key                put object (ETag header)
    GET    /bucket/key                get object
    HEAD   /bucket/key                stat (Content-Length/ETag)
    DELETE /bucket/key                delete object
    POST   /bucket/key?uploads        InitiateMultipartUploadResult XML
    PUT    /bucket/key?partNumber=N&uploadId=U   upload part
    POST   /bucket/key?uploadId=U     CompleteMultipartUpload (XML body)
    DELETE /bucket/key?uploadId=U     abort multipart

Auth is AWS SigV4 (the reference's AWS4-HMAC-SHA256 verifier) in all
three spec flavors: header signing, query-string signing (presigned
URLs, expiry-honored), and STREAMING-AWS4-HMAC-SHA256-PAYLOAD chunked
uploads whose per-chunk signature chain is verified. The canonical
request is rebuilt from the wire, the signing key derived from the
registered secret, and a mismatched signature or unknown access key is
refused with the S3 XML error envelope. Anonymous requests reach only
public-read resources (canned-ACL floor: private | public-read via
x-amz-acl / the ?acl subresource, rgw_acl_s3.cc role).
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import re
import time
import urllib.parse
from xml.etree import ElementTree
from xml.sax.saxutils import escape

from ceph_tpu_torch.rados.client import ObjectNotFound
from ceph_tpu_torch.rgw.gateway import GatewayError, ObjectGateway

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED = "UNSIGNED-PAYLOAD"
STREAMING = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"


class S3Error(Exception):
    def __init__(self, status: int, code: str, message: str = ""):
        super().__init__(message or code)
        self.status = status
        self.code = code


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _uri_encode(s: str, keep_slash: bool = False) -> str:
    safe = "-_.~" + ("/" if keep_slash else "")
    return urllib.parse.quote(s, safe=safe)


def signing_key(secret: str, date: str, region: str) -> bytes:
    """The SigV4 key-derivation chain (rgw_auth_s3 get_v4_signing_key)."""
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, "s3")
    return _hmac(k, "aws4_request")


def canonical_request(
    method: str, path: str, query: dict[str, str],
    headers: dict[str, str], signed_headers: list[str],
    payload_hash: str,
) -> str:
    cq = "&".join(
        f"{_uri_encode(k)}={_uri_encode(v)}"
        for k, v in sorted(query.items())
    )
    ch = "".join(
        f"{h}:{headers.get(h, '').strip()}\n" for h in signed_headers
    )
    return "\n".join([
        method,
        _uri_encode(path, keep_slash=True),
        cq,
        ch,
        ";".join(signed_headers),
        payload_hash,
    ])


def string_to_sign(
    amz_date: str, scope: str, creq: str
) -> str:
    return "\n".join([
        ALGORITHM, amz_date, scope, _sha256(creq.encode())
    ])


_AUTH_RE = re.compile(
    r"AWS4-HMAC-SHA256\s+"
    r"Credential=(?P<ak>[^/]+)/(?P<date>\d{8})/(?P<region>[^/]+)"
    r"/s3/aws4_request,\s*"
    r"SignedHeaders=(?P<sh>[^,]+),\s*Signature=(?P<sig>[0-9a-f]+)"
)


class S3Frontend:
    """asyncio HTTP server speaking the S3 protocol over a gateway."""

    def __init__(
        self, gateway: ObjectGateway,
        users: dict[str, str] | None = None,
        region: str = "us-east-1",
        dns_name: str | None = None,
    ):
        self.gw = gateway
        #: access_key -> secret_key (the rgw user database role)
        self.users = dict(users or {})
        self.region = region
        #: rgw_dns_name: when set, Host "<bucket>.<dns_name>" addresses
        #: the bucket virtual-host style (rgw_rest.cc's
        #: hostnames_set handling); path-style always works too
        self.dns_name = dns_name
        self._server: asyncio.AbstractServer | None = None
        self.port: int | None = None

    def add_user(self, access_key: str, secret_key: str) -> None:
        self.users[access_key] = secret_key

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
                    method, target, _version = (
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
                    # HEAD responses never carry an entity (a body here
                    # would desynchronize keep-alive clients); 200s set
                    # their Content-Length explicitly in the handler
                    rbody = b""
                reason = {200: "OK", 204: "No Content",
                          403: "Forbidden", 404: "Not Found",
                          409: "Conflict", 400: "Bad Request"}.get(
                    status, "OK"
                )
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

    @staticmethod
    def _error_xml(code: str, message: str) -> bytes:
        return (
            "<?xml version=\"1.0\" encoding=\"UTF-8\"?>"
            f"<Error><Code>{escape(code)}</Code>"
            f"<Message>{escape(message)}</Message></Error>"
        ).encode()

    async def _handle(self, method, target, headers, body):
        url = urllib.parse.urlsplit(target)
        path = urllib.parse.unquote(url.path)
        query = dict(
            urllib.parse.parse_qsl(url.query, keep_blank_values=True)
        )
        try:
            auth = self._authenticate(method, url, query, headers, body)
            if auth.get("streaming"):
                body = self._decode_aws_chunks(body, auth)
            return await self._route(
                method, path, query, headers, body, auth
            )
        except ElementTree.ParseError as e:
            return (
                400, {"Content-Type": "application/xml"},
                self._error_xml("MalformedXML", str(e)),
            )
        except S3Error as e:
            return (
                e.status,
                {"Content-Type": "application/xml"},
                self._error_xml(e.code, str(e)),
            )
        except ObjectNotFound as e:
            return (
                404, {"Content-Type": "application/xml"},
                self._error_xml("NoSuchKey", str(e)),
            )
        except GatewayError as e:
            msg = str(e)
            code = "NoSuchBucket" if "no bucket" in msg else (
                "BucketAlreadyExists" if "exists" in msg else
                "InvalidRequest"
            )
            status = 404 if code == "NoSuchBucket" else 409
            return (
                status, {"Content-Type": "application/xml"},
                self._error_xml(code, msg),
            )

    # -- SigV4 verification (rgw_auth_s3.cc role) ------------------------------

    def _authenticate(self, method, url, query, headers, body) -> dict:
        """Three ways in (rgw_auth_s3.cc): header SigV4 (+ the
        STREAMING-AWS4-HMAC-SHA256-PAYLOAD chunked flavor), query-string
        SigV4 (presigned URLs, expiry-honored), or anonymous — which the
        router only admits to public-read resources."""
        if query.get("X-Amz-Algorithm") == ALGORITHM:
            return self._auth_presigned(method, url, query, headers)
        auth = headers.get("authorization", "")
        if not auth:
            return {"anonymous": True}
        m = _AUTH_RE.match(auth)
        if m is None:
            raise S3Error(
                403, "AccessDenied", "missing/malformed authorization"
            )
        secret = self.users.get(m["ak"])
        if secret is None:
            raise S3Error(
                403, "InvalidAccessKeyId",
                f"unknown access key {m['ak']!r}",
            )
        payload_hash = headers.get("x-amz-content-sha256", "")
        if not payload_hash:
            raise S3Error(
                400, "InvalidRequest", "x-amz-content-sha256 required"
            )
        streaming = payload_hash == STREAMING
        if (
            not streaming
            and payload_hash != UNSIGNED
            and payload_hash != _sha256(body)
        ):
            raise S3Error(
                400, "XAmzContentSHA256Mismatch",
                "payload hash does not match body",
            )
        amz_date = headers.get("x-amz-date", "")
        if not amz_date.startswith(m["date"]):
            raise S3Error(
                403, "AccessDenied", "credential date mismatch"
            )
        signed = m["sh"].split(";")
        creq = canonical_request(
            method, urllib.parse.unquote(url.path), query, headers,
            signed, payload_hash,
        )
        scope = f"{m['date']}/{m['region']}/s3/aws4_request"
        sts = string_to_sign(amz_date, scope, creq)
        key = signing_key(secret, m["date"], m["region"])
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, m["sig"]):
            raise S3Error(
                403, "SignatureDoesNotMatch",
                "the request signature we calculated does not match",
            )
        return {
            "anonymous": False, "access_key": m["ak"],
            "streaming": streaming, "signing_key": key,
            "amz_date": amz_date, "scope": scope, "seed_sig": want,
        }

    def _auth_presigned(self, method, url, query, headers) -> dict:
        """Query-string SigV4 (presigned URLs): the signature covers
        every query param EXCEPT X-Amz-Signature, the payload is
        unsigned, and X-Amz-Date + X-Amz-Expires bound the lifetime."""
        cred = query.get("X-Amz-Credential", "")
        parts = cred.split("/")
        if len(parts) != 5 or parts[3:] != ["s3", "aws4_request"]:
            raise S3Error(403, "AccessDenied", "malformed credential")
        ak, date, region = parts[0], parts[1], parts[2]
        secret = self.users.get(ak)
        if secret is None:
            raise S3Error(
                403, "InvalidAccessKeyId", f"unknown access key {ak!r}"
            )
        amz_date = query.get("X-Amz-Date", "")
        if not amz_date.startswith(date):
            raise S3Error(
                403, "AccessDenied", "credential date mismatch"
            )
        try:
            expires = int(query.get("X-Amz-Expires", "0"))
            import calendar

            # UTC arithmetic: mktime + timezone is off by an hour
            # whenever local DST is in effect
            t0 = calendar.timegm(
                time.strptime(amz_date, "%Y%m%dT%H%M%SZ")
            )
        except ValueError as e:
            raise S3Error(403, "AccessDenied", "bad date") from e
        if time.time() > t0 + expires:
            raise S3Error(
                403, "AccessDenied", "Request has expired"
            )
        sig = query.get("X-Amz-Signature", "")
        signed = query.get("X-Amz-SignedHeaders", "host").split(";")
        q = {k: v for k, v in query.items() if k != "X-Amz-Signature"}
        creq = canonical_request(
            method, urllib.parse.unquote(url.path), q, headers,
            signed, UNSIGNED,
        )
        scope = f"{date}/{region}/s3/aws4_request"
        sts = string_to_sign(amz_date, scope, creq)
        key = signing_key(secret, date, region)
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise S3Error(
                403, "SignatureDoesNotMatch",
                "the request signature we calculated does not match",
            )
        return {"anonymous": False, "access_key": ak,
                "streaming": False}

    _CHUNK_HEAD_RE = re.compile(
        rb"^([0-9a-fA-F]+);chunk-signature=([0-9a-f]{64})$"
    )

    def _decode_aws_chunks(self, body: bytes, auth: dict) -> bytes:
        """STREAMING-AWS4-HMAC-SHA256-PAYLOAD: per-chunk signature chain
        seeded by the header signature; every chunk must verify, and the
        stream must end with the signed zero-length chunk."""
        out = bytearray()
        prev = auth["seed_sig"]
        empty = _sha256(b"")
        off = 0
        while True:
            nl = body.find(b"\r\n", off)
            if nl < 0:
                raise S3Error(
                    400, "IncompleteBody", "truncated chunk header"
                )
            m = self._CHUNK_HEAD_RE.match(body[off:nl])
            if m is None:
                raise S3Error(
                    400, "InvalidChunkSizeError", "bad chunk header"
                )
            size = int(m[1], 16)
            off = nl + 2
            data = body[off: off + size]
            if len(data) != size or body[off + size: off + size + 2] \
                    != b"\r\n":
                raise S3Error(
                    400, "IncompleteBody", "truncated chunk body"
                )
            off += size + 2
            sts = "\n".join([
                "AWS4-HMAC-SHA256-PAYLOAD", auth["amz_date"],
                auth["scope"], prev, empty, _sha256(data),
            ])
            want = hmac.new(
                auth["signing_key"], sts.encode(), hashlib.sha256
            ).hexdigest()
            if not hmac.compare_digest(want, m[2].decode()):
                raise S3Error(
                    403, "SignatureDoesNotMatch",
                    "chunk signature does not match",
                )
            prev = want
            out += data
            if size == 0:
                return bytes(out)

    # -- routing --------------------------------------------------------------

    @staticmethod
    def _acl_xml(acl: str) -> bytes:
        grants = [
            "<Grant><Grantee>owner</Grantee>"
            "<Permission>FULL_CONTROL</Permission></Grant>"
        ]
        if acl == "public-read":
            grants.append(
                "<Grant><Grantee>AllUsers</Grantee>"
                "<Permission>READ</Permission></Grant>"
            )
        return (
            "<?xml version=\"1.0\" encoding=\"UTF-8\"?>"
            "<AccessControlPolicy><AccessControlList>"
            + "".join(grants)
            + "</AccessControlList></AccessControlPolicy>"
        ).encode()

    @staticmethod
    def _canned_acl(headers) -> str | None:
        acl = headers.get("x-amz-acl")
        if acl is None:
            return None
        if acl not in ("private", "public-read"):
            raise S3Error(
                400, "InvalidArgument", f"unsupported ACL {acl!r}"
            )
        return acl

    async def _anonymous_allowed(self, method, bucket, key, query):
        """The rgw_acl_s3 floor: anonymous requests reach public-read
        resources read-only; everything else is AccessDenied."""
        if method not in ("GET", "HEAD") or "acl" in query:
            return False
        try:
            bacl = await self.gw.get_bucket_acl(bucket)
        except GatewayError:
            bacl = "private"
        if not key:
            return bacl == "public-read" and not (
                set(query) & {"versioning", "versions"}
            )
        if bacl == "public-read":
            return True
        try:
            return (
                await self.gw.get_object_acl(bucket, key)
                == "public-read"
            )
        except (ObjectNotFound, GatewayError):
            return False

    def _vhost_bucket(self, headers) -> str | None:
        """Virtual-host addressing: Host '<bucket>.<rgw_dns_name>'."""
        if not self.dns_name:
            return None
        host = headers.get("host", "").split(":", 1)[0]
        suffix = "." + self.dns_name
        if host.endswith(suffix) and host != self.dns_name:
            return host[: -len(suffix)]
        return None

    async def _route(self, method, path, query, headers, body, auth):
        vbucket = self._vhost_bucket(headers)
        if vbucket is not None:
            bucket, key = vbucket, path.lstrip("/")
        else:
            parts = path.lstrip("/").split("/", 1)
            bucket = parts[0]
            key = parts[1] if len(parts) > 1 else ""
        if not bucket:
            raise S3Error(400, "InvalidRequest", "bucket required")
        if auth.get("anonymous") and not await self._anonymous_allowed(
            method, bucket, key, query
        ):
            raise S3Error(
                403, "AccessDenied", "anonymous access denied"
            )
        ok_xml = {"Content-Type": "application/xml"}
        if not key:
            if method == "PUT" and "acl" in query:
                await self.gw.set_bucket_acl(
                    bucket, self._canned_acl(headers) or "private"
                )
                return 200, {}, b""
            if method == "GET" and "acl" in query:
                return 200, ok_xml, self._acl_xml(
                    await self.gw.get_bucket_acl(bucket)
                )
            if method == "PUT" and "lifecycle" in query:
                root = ElementTree.fromstring(body.decode())
                ns = ""
                if root.tag.startswith("{"):
                    ns = root.tag[: root.tag.index("}") + 1]
                rules = []
                for rule in root.findall(f"{ns}Rule"):
                    status = rule.find(f"{ns}Status")
                    exp = rule.find(f"{ns}Expiration")
                    days = (
                        exp.find(f"{ns}Days") if exp is not None
                        else None
                    )
                    if days is None:
                        raise S3Error(
                            400, "MalformedXML",
                            "Rule needs Expiration/Days",
                        )
                    prefix_el = rule.find(f"{ns}Filter/{ns}Prefix")
                    if prefix_el is None:
                        prefix_el = rule.find(f"{ns}Prefix")
                    rid = rule.find(f"{ns}ID")
                    rules.append({
                        "id": rid.text if rid is not None else "",
                        "status": (
                            status.text if status is not None
                            else "Enabled"
                        ),
                        "days": int(days.text),
                        "prefix": (
                            prefix_el.text or ""
                            if prefix_el is not None else ""
                        ),
                    })
                await self.gw.set_lifecycle(bucket, rules)
                return 200, {}, b""
            if method == "GET" and "lifecycle" in query:
                rules = await self.gw.get_lifecycle(bucket)
                if not rules:
                    raise S3Error(
                        404, "NoSuchLifecycleConfiguration", bucket
                    )
                xml = ["<?xml version=\"1.0\" encoding=\"UTF-8\"?>",
                       "<LifecycleConfiguration>"]
                for r in rules:
                    xml.append(
                        "<Rule>"
                        f"<ID>{escape(r.get('id', ''))}</ID>"
                        f"<Status>{escape(r['status'])}</Status>"
                        "<Filter><Prefix>"
                        f"{escape(r.get('prefix', ''))}"
                        "</Prefix></Filter>"
                        f"<Expiration><Days>{r['days']}</Days>"
                        "</Expiration></Rule>"
                    )
                xml.append("</LifecycleConfiguration>")
                return 200, ok_xml, "".join(xml).encode()
            if method == "DELETE" and "lifecycle" in query:
                await self.gw.delete_lifecycle(bucket)
                return 204, {}, b""
            if method == "GET" and "uploads" in query:
                ups = await self.gw.list_multipart_uploads(
                    bucket, prefix=query.get("prefix", "")
                )
                xml = [
                    "<?xml version=\"1.0\" encoding=\"UTF-8\"?>",
                    "<ListMultipartUploadsResult>",
                    f"<Bucket>{escape(bucket)}</Bucket>",
                ]
                for u in ups:
                    xml.append(
                        "<Upload>"
                        f"<Key>{escape(u['key'])}</Key>"
                        f"<UploadId>{escape(u['upload_id'])}"
                        "</UploadId></Upload>"
                    )
                xml.append("</ListMultipartUploadsResult>")
                return 200, ok_xml, "".join(xml).encode()
            if method == "PUT" and "versioning" in query:
                root = ElementTree.fromstring(body.decode())
                ns = ""
                if root.tag.startswith("{"):
                    ns = root.tag[: root.tag.index("}") + 1]
                status = root.find(f"{ns}Status")
                await self.gw.set_versioning(
                    bucket,
                    status is not None and status.text == "Enabled",
                )
                return 200, {}, b""
            if method == "GET" and "versioning" in query:
                enabled = await self.gw.get_versioning(bucket)
                xml = (
                    "<?xml version=\"1.0\" encoding=\"UTF-8\"?>"
                    "<VersioningConfiguration>"
                    f"<Status>{'Enabled' if enabled else 'Suspended'}"
                    "</Status></VersioningConfiguration>"
                )
                return 200, ok_xml, xml.encode()
            if method == "GET" and "versions" in query:
                page = await self.gw.list_versions(
                    bucket, prefix=query.get("prefix", ""),
                    marker=query.get("key-marker", ""),
                    max_keys=int(query.get("max-keys", "1000")),
                )
                xml = [
                    "<?xml version=\"1.0\" encoding=\"UTF-8\"?>",
                    "<ListVersionsResult>",
                    f"<Name>{escape(bucket)}</Name>",
                    f"<IsTruncated>{str(bool(page['truncated'])).lower()}"
                    "</IsTruncated>",
                ]
                if page["truncated"]:
                    xml.append(
                        f"<NextKeyMarker>{escape(page['next_marker'])}"
                        "</NextKeyMarker>"
                    )
                for k, versions in sorted(page["versions"].items()):
                    for v in reversed(versions):  # newest first
                        latest = str(
                            v is versions[-1]
                        ).lower()
                        if v["delete_marker"]:
                            xml.append(
                                "<DeleteMarker>"
                                f"<Key>{escape(k)}</Key>"
                                f"<VersionId>{v['version_id']}"
                                "</VersionId>"
                                f"<IsLatest>{latest}</IsLatest>"
                                "</DeleteMarker>"
                            )
                        else:
                            xml.append(
                                "<Version>"
                                f"<Key>{escape(k)}</Key>"
                                f"<VersionId>{v['version_id']}"
                                "</VersionId>"
                                f"<IsLatest>{latest}</IsLatest>"
                                f"<Size>{v['size']}</Size>"
                                f"<ETag>&quot;{v['etag']}&quot;</ETag>"
                                "</Version>"
                            )
                xml.append("</ListVersionsResult>")
                return 200, ok_xml, "".join(xml).encode()
            if method == "PUT":
                await self.gw.create_bucket(bucket)
                acl = self._canned_acl(headers)
                if acl:
                    await self.gw.set_bucket_acl(bucket, acl)
                return 200, {}, b""
            if method == "DELETE":
                try:
                    await self.gw.delete_bucket(bucket)
                except GatewayError as e:
                    if "not empty" in str(e):
                        raise S3Error(
                            409, "BucketNotEmpty", str(e)
                        ) from e
                    raise
                return 204, {}, b""
            if method in ("GET", "HEAD"):
                if not await self.gw.bucket_exists(bucket):
                    raise S3Error(
                        404, "NoSuchBucket", f"no bucket {bucket!r}"
                    )
                if method == "HEAD":
                    return 200, {}, b""
                entries = await self.gw.list_objects(
                    bucket,
                    prefix=query.get("prefix", ""),
                    marker=query.get("marker", ""),
                    max_entries=int(query.get("max-keys", "1000")),
                )
                xml = [
                    "<?xml version=\"1.0\" encoding=\"UTF-8\"?>",
                    "<ListBucketResult>",
                    f"<Name>{escape(bucket)}</Name>",
                    f"<Prefix>{escape(query.get('prefix', ''))}"
                    "</Prefix>",
                    f"<IsTruncated>{str(bool(entries.get('truncated'))).lower()}"
                    "</IsTruncated>",
                ]
                for k, meta in sorted(entries["entries"].items()):
                    if meta.get("delete_marker"):
                        continue  # current is a marker: hidden from ls
                    xml.append(
                        "<Contents>"
                        f"<Key>{escape(k)}</Key>"
                        f"<Size>{meta.get('size', 0)}</Size>"
                        f"<ETag>&quot;{meta.get('etag', '')}&quot;"
                        "</ETag></Contents>"
                    )
                xml.append("</ListBucketResult>")
                return 200, ok_xml, "".join(xml).encode()
            raise S3Error(400, "MethodNotAllowed", method)

        # object-scoped ops (+ multipart query dialect)
        if method == "GET" and "uploadId" in query:
            parts = await self.gw.list_parts(
                bucket, key, query["uploadId"]
            )
            xml = [
                "<?xml version=\"1.0\" encoding=\"UTF-8\"?>",
                "<ListPartsResult>",
                f"<Bucket>{escape(bucket)}</Bucket>",
                f"<Key>{escape(key)}</Key>",
                f"<UploadId>{escape(query['uploadId'])}</UploadId>",
            ]
            for p_ in parts:
                xml.append(
                    "<Part>"
                    f"<PartNumber>{p_['part']}</PartNumber>"
                    f"<Size>{p_['size']}</Size>"
                    f"<ETag>&quot;{p_['etag']}&quot;</ETag>"
                    "</Part>"
                )
            xml.append("</ListPartsResult>")
            return 200, ok_xml, "".join(xml).encode()
        if method == "POST" and "uploads" in query:
            upload_id = await self.gw.initiate_multipart(bucket, key)
            xml = (
                "<?xml version=\"1.0\" encoding=\"UTF-8\"?>"
                "<InitiateMultipartUploadResult>"
                f"<Bucket>{escape(bucket)}</Bucket>"
                f"<Key>{escape(key)}</Key>"
                f"<UploadId>{escape(upload_id)}</UploadId>"
                "</InitiateMultipartUploadResult>"
            )
            return 200, ok_xml, xml.encode()
        if method == "PUT" and "uploadId" in query:
            etag = await self.gw.upload_part(
                bucket, key, query["uploadId"],
                int(query["partNumber"]), body,
            )
            return 200, {"ETag": f'"{etag}"'}, b""
        if method == "POST" and "uploadId" in query:
            root = ElementTree.fromstring(body.decode())
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            part_nums = [
                int(p.find(f"{ns}PartNumber").text)
                for p in root.findall(f"{ns}Part")
            ]
            if not part_nums or part_nums != sorted(part_nums):
                raise S3Error(
                    400, "InvalidPartOrder",
                    "parts must be ascending and non-empty",
                )
            etag = await self.gw.complete_multipart(
                bucket, key, query["uploadId"], part_nums
            )
            xml = (
                "<?xml version=\"1.0\" encoding=\"UTF-8\"?>"
                "<CompleteMultipartUploadResult>"
                f"<Bucket>{escape(bucket)}</Bucket>"
                f"<Key>{escape(key)}</Key>"
                f"<ETag>&quot;{etag}&quot;</ETag>"
                "</CompleteMultipartUploadResult>"
            )
            return 200, ok_xml, xml.encode()
        if method == "DELETE" and "uploadId" in query:
            await self.gw.abort_multipart(
                bucket, key, query["uploadId"]
            )
            return 204, {}, b""

        if method == "PUT" and "acl" in query:
            await self.gw.set_object_acl(
                bucket, key, self._canned_acl(headers) or "private"
            )
            return 200, {}, b""
        if method == "GET" and "acl" in query:
            return 200, ok_xml, self._acl_xml(
                await self.gw.get_object_acl(bucket, key)
            )
        if method == "PUT":
            etag, vid = await self.gw.put_object2(
                bucket, key, body, acl=self._canned_acl(headers)
            )
            hdrs = {"ETag": f'"{etag}"'}
            if vid is not None:
                hdrs["x-amz-version-id"] = vid
            return 200, hdrs, b""
        if method == "GET":
            if "versionId" in query:
                data = await self.gw.get_object_version(
                    bucket, key, query["versionId"]
                )
                return (
                    200,
                    {"Content-Type": "application/octet-stream",
                     "x-amz-version-id": query["versionId"]},
                    data,
                )
            data = await self.gw.get_object(bucket, key)
            meta = await self.gw.head_object(bucket, key)
            return (
                200,
                {"Content-Type": "application/octet-stream",
                 "ETag": f'"{meta.get("etag", "")}"'},
                data,
            )
        if method == "HEAD":
            meta = await self.gw.head_object(bucket, key)
            if meta.get("delete_marker"):
                raise S3Error(404, "NoSuchKey", key)
            return (
                200,
                {"Content-Length": str(meta.get("size", 0)),
                 "ETag": f'"{meta.get("etag", "")}"'},
                b"",
            )
        if method == "DELETE":
            if "versionId" in query:
                await self.gw.delete_object_version(
                    bucket, key, query["versionId"]
                )
                return 204, {}, b""
            marker = await self.gw.delete_object(bucket, key)
            hdrs = {}
            if marker is not None:
                hdrs = {"x-amz-delete-marker": "true",
                        "x-amz-version-id": marker}
            return 204, hdrs, b""
        raise S3Error(400, "MethodNotAllowed", method)
