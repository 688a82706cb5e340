"""RGW-lite: an S3-style object gateway over RADOS.

Condensed analog of the reference's RGW tier (src/rgw/rgw_op.cc
request ops + cls_rgw bucket indexes + the multipart machinery),
reshaped for this framework:

* every bucket has an INDEX object (``bidx.<bucket>``) whose omap is
  maintained by in-OSD cls_rgw methods — PUT/DELETE/LIST are
  index-consistent under concurrency, exactly the property the
  reference built cls_rgw for;
* object data lives in ``obj.<bucket>.<key>`` (striped across
  ``.N`` parts when larger than one RADOS object);
* multipart uploads stage parts as first-class objects and COMPLETE
  writes a manifest head (the RGW manifest model) that reads follow;
* a minimal asyncio HTTP front (S3Server) speaks path-style S3:
  PUT/GET/HEAD/DELETE on /bucket and /bucket/key plus ListObjects
  XML — enough for curl/boto-style smoke traffic.  Auth headers are
  accepted and ignored (the AuthMonitor registry is where identities
  live; request signing is out of this slice).
"""

from __future__ import annotations

import asyncio
import hashlib
import time

from ..utils import denc

MAX_RADOS_OBJ = 4 << 20          # split bodies bigger than this
IDX_PREFIX = "bidx."
BUCKETS_OID = "rgw_buckets"


class RGWError(Exception):
    def __init__(self, code: str, status: int = 400):
        super().__init__(code)
        self.code = code
        self.status = status


def _check_bucket_name(bucket: str) -> None:
    """S3 bucket grammar subset: no '/' (the oid separator), nonempty
    — which makes every oid below unambiguous."""
    if not bucket or "/" in bucket:
        raise RGWError("InvalidBucketName", 400)


def _idx(bucket: str) -> str:
    return IDX_PREFIX + bucket


def _obj(bucket: str, key: str, part: int = 0) -> str:
    """Unambiguous data oid: bucket names cannot contain '/', so the
    first '/' always splits bucket from key; part numbers live in a
    DISTINCT prefix (a key ending '.00000001' can never collide with
    another object's part)."""
    if part == 0:
        return "obj.%s/%s" % (bucket, key)
    return "objp.%06d.%s/%s" % (part, bucket, key)


class RGW:
    """Gateway core (the rgw_op execute() layer)."""

    def __init__(self, ioctx):
        self.io = ioctx

    # -- buckets ------------------------------------------------------------

    async def create_bucket(self, bucket: str) -> None:
        from ..client.rados import RadosError

        _check_bucket_name(bucket)
        try:
            await self.io.exec(_idx(bucket), "rgw", "bucket_init", {})
        except RadosError as e:
            if e.code == -17:
                raise RGWError("BucketAlreadyExists", 409) from None
            raise
        await self.io.omap_set(BUCKETS_OID,
                               {bucket.encode(): b"1"})

    async def delete_bucket(self, bucket: str) -> None:
        from ..client.rados import RadosError

        out = await self._index_list(bucket, max=1)
        if out["entries"]:
            raise RGWError("BucketNotEmpty", 409)
        try:
            await self.io.remove(_idx(bucket))
        except RadosError as e:
            if e.code == -2:
                raise RGWError("NoSuchBucket", 404) from None
            raise       # transient faults must NOT read as 404
        await self.io.omap_rm(BUCKETS_OID, [bucket.encode()])

    async def list_buckets(self) -> list[str]:
        try:
            kv = await self.io.omap_get(BUCKETS_OID)
        except Exception:
            return []
        return sorted(k.decode() for k in kv)

    async def _index_list(self, bucket: str, **kw) -> dict:
        from ..client.rados import RadosError

        try:
            return await self.io.exec(_idx(bucket), "rgw",
                                      "index_list", kw)
        except RadosError as e:
            if e.code == -2:
                raise RGWError("NoSuchBucket", 404) from None
            raise

    # -- objects ------------------------------------------------------------

    def _data_oids(self, bucket: str, key: str, meta: dict) -> list:
        if "manifest" in meta:
            return list(meta["manifest"])
        return [_obj(bucket, key, p)
                for p in range(int(meta.get("parts", 1)))]

    async def put_object(self, bucket: str, key: str,
                         data: bytes) -> str:
        # bucket check BEFORE the data lands (a failed index_put must
        # not strand orphan parts), and the PREVIOUS version's oids
        # are captured so an overwrite can reap its surplus parts
        await self.head_bucket(bucket)
        try:
            old_oids = self._data_oids(
                bucket, key, await self.head_object(bucket, key))
        except RGWError:
            old_oids = []
        etag = hashlib.md5(data).hexdigest()
        nparts = max(1, -(-len(data) // MAX_RADOS_OBJ))
        for p in range(nparts):
            chunk = data[p * MAX_RADOS_OBJ:(p + 1) * MAX_RADOS_OBJ]
            await self.io.write_full(_obj(bucket, key, p), chunk)
        meta = {"size": len(data), "etag": etag,
                "mtime": time.time(), "parts": nparts}
        from ..client.rados import RadosError

        try:
            await self.io.exec(_idx(bucket), "rgw", "index_put",
                               {"key": key, "meta": meta})
        except RadosError as e:
            if e.code == -2:
                raise RGWError("NoSuchBucket", 404) from None
            raise
        new = {_obj(bucket, key, p) for p in range(nparts)}
        await self._reap([o for o in old_oids if o not in new])
        return etag

    async def _reap(self, oids: list) -> None:
        async def rm(oid):
            try:
                await self.io.remove(oid)
            except Exception:
                pass

        await asyncio.gather(*[rm(o) for o in oids])

    async def get_object(self, bucket: str, key: str) -> bytes:
        meta = await self.head_object(bucket, key)
        oids = self._data_oids(bucket, key, meta)
        parts = await asyncio.gather(
            *[self.io.read(oid) for oid in oids])
        return b"".join(parts)

    async def head_object(self, bucket: str, key: str) -> dict:
        from ..client.rados import RadosError

        try:
            out = await self.io.exec(_idx(bucket), "rgw",
                                     "index_get", {"key": key})
            return out["entry"]
        except RadosError as e:
            if e.code == -2:
                # bucket or key: disambiguate for correct S3 errors
                await self.head_bucket(bucket)
                raise RGWError("NoSuchKey", 404) from None
            raise

    async def delete_object(self, bucket: str, key: str) -> None:
        from ..client.rados import RadosError

        meta = await self.head_object(bucket, key)
        try:
            await self.io.exec(_idx(bucket), "rgw", "index_rm",
                               {"key": key})
        except RadosError as e:
            if e.code == -2:
                raise RGWError("NoSuchKey", 404) from None
            raise
        await self._reap(self._data_oids(bucket, key, meta))

    async def list_objects(self, bucket: str, prefix: str = "",
                           marker: str = "",
                           max_keys: int = 1000) -> dict:
        return await self._index_list(bucket, prefix=prefix,
                                      marker=marker, max=max_keys)

    # -- multipart (the RGW manifest model) ---------------------------------

    async def initiate_multipart(self, bucket: str,
                                 key: str) -> str:
        await self.head_bucket(bucket)
        upload_id = hashlib.md5(
            ("%s/%s/%f" % (bucket, key, time.time())).encode()
        ).hexdigest()[:16]
        return upload_id

    async def head_bucket(self, bucket: str) -> None:
        await self._index_list(bucket, max=0)

    def _part_oid(self, bucket, key, upload_id, n) -> str:
        # fixed-width fields before the bucket, '/' after it: no key
        # or bucket spelling can collide with another upload's part
        return "mp.%06d.%s.%s/%s" % (n, upload_id, bucket, key)

    async def upload_part(self, bucket: str, key: str,
                          upload_id: str, part_num: int,
                          data: bytes) -> str:
        oid = self._part_oid(bucket, key, upload_id, part_num)
        await self.io.write_full(oid, data)
        return hashlib.md5(data).hexdigest()

    async def complete_multipart(self, bucket: str, key: str,
                                 upload_id: str,
                                 part_nums: list[int]) -> str:
        from ..client.rados import RadosError

        manifest = [self._part_oid(bucket, key, upload_id, n)
                    for n in sorted(part_nums)]
        total = 0
        sigs = []
        for oid in manifest:
            try:
                sz = await self.io.stat(oid)
            except Exception:
                raise RGWError("InvalidPart", 400) from None
            total += sz
            sigs.append(oid.encode())
        # like put_object: a completed upload REPLACING an existing
        # key must reap the previous version's data objects
        try:
            old_oids = self._data_oids(
                bucket, key, await self.head_object(bucket, key))
        except RGWError:
            old_oids = []
        etag = hashlib.md5(b"".join(sigs)).hexdigest() + "-%d" % \
            len(manifest)
        meta = {"size": total, "etag": etag, "mtime": time.time(),
                "manifest": manifest}
        try:
            await self.io.exec(_idx(bucket), "rgw", "index_put",
                               {"key": key, "meta": meta})
        except RadosError as e:
            if e.code == -2:
                raise RGWError("NoSuchBucket", 404) from None
            raise
        await self._reap([o for o in old_oids if o not in manifest])
        return etag


class S3Server:
    """Minimal path-style S3 HTTP front (the rgw frontend role)."""

    def __init__(self, rgw: RGW):
        self.rgw = rgw
        self._server: asyncio.AbstractServer | None = None
        self.addr = ""

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> str:
        self._server = await asyncio.start_server(self._handle, host,
                                                  port)
        h, p = self._server.sockets[0].getsockname()[:2]
        self.addr = "%s:%d" % (h, p)
        return self.addr

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader, writer) -> None:
        try:
            line = await reader.readline()
            parts = line.decode().split()
            if len(parts) < 2:
                return
            method, target = parts[0], parts[1]
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _s, v = h.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", 0) or 0)
            if n:
                body = await reader.readexactly(n)
            status, ctype, payload = await self._route(
                method, target, body)
            writer.write(
                b"HTTP/1.1 %d %s\r\nContent-Type: %s\r\n"
                b"Content-Length: %d\r\nConnection: close\r\n\r\n"
                % (status, _reason(status).encode(), ctype.encode(),
                   len(payload)))
            writer.write(payload)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _route(self, method: str, target: str,
                     body: bytes) -> tuple[int, str, bytes]:
        path, _q, query = target.partition("?")
        parts = [p for p in path.split("/") if p]
        try:
            if not parts:
                if method == "GET":       # ListBuckets
                    from xml.sax.saxutils import escape

                    names = await self.rgw.list_buckets()
                    xml = "".join("<Bucket><Name>%s</Name></Bucket>"
                                  % escape(n) for n in names)
                    return (200, "application/xml",
                            ("<ListAllMyBucketsResult><Buckets>%s"
                             "</Buckets></ListAllMyBucketsResult>"
                             % xml).encode())
                return 405, "text/plain", b"method not allowed"
            bucket = parts[0]
            key = "/".join(parts[1:])
            if not key:
                if method == "PUT":
                    await self.rgw.create_bucket(bucket)
                    return 200, "application/xml", b""
                if method == "DELETE":
                    await self.rgw.delete_bucket(bucket)
                    return 204, "application/xml", b""
                if method in ("GET", "HEAD"):
                    prefix = ""
                    for kv in query.split("&"):
                        if kv.startswith("prefix="):
                            prefix = kv[len("prefix="):]
                    out = await self.rgw.list_objects(bucket,
                                                      prefix=prefix)
                    from xml.sax.saxutils import escape

                    rows = "".join(
                        "<Contents><Key>%s</Key><Size>%d</Size>"
                        "<ETag>%s</ETag></Contents>"
                        % (escape(e["key"]), e["size"],
                           escape(e["etag"]))
                        for e in out["entries"])
                    return (200, "application/xml",
                            ("<ListBucketResult><Name>%s</Name>%s"
                             "<IsTruncated>%s</IsTruncated>"
                             "</ListBucketResult>"
                             % (escape(bucket), rows,
                                str(out["truncated"]).lower())
                             ).encode())
                return 405, "text/plain", b"method not allowed"
            if method == "PUT":
                etag = await self.rgw.put_object(bucket, key, body)
                return 200, "application/xml", \
                    ('"%s"' % etag).encode()
            if method == "GET":
                data = await self.rgw.get_object(bucket, key)
                return 200, "application/octet-stream", data
            if method == "HEAD":
                await self.rgw.head_object(bucket, key)
                return 200, "application/octet-stream", b""
            if method == "DELETE":
                await self.rgw.delete_object(bucket, key)
                return 204, "application/xml", b""
            return 405, "text/plain", b"method not allowed"
        except RGWError as e:
            return (e.status, "application/xml",
                    ("<Error><Code>%s</Code></Error>"
                     % e.code).encode())


def _reason(status: int) -> str:
    return {200: "OK", 204: "No Content", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed",
            409: "Conflict"}.get(status, "Error")
